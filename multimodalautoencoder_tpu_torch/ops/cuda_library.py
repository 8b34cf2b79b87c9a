"""Build and load a CUDA C++ source as a shared library with a plain C
interface (nvcc -> ``ctypes``), at first use.

Each kernel module of the port (``ops/dense_kernels.py``,
``ops/train_kernels.py``) subclasses :class:`NvccLibrary` and binds its
symbols in :meth:`NvccLibrary._bind`.  The library is compiled for
``sm_90a`` into :func:`build_dir` and rebuilt when its source or one of
its headers is newer.  The build needs no PyTorch headers, so it takes
seconds.  A failed build raises with the compiler's output; nothing falls
back.

:func:`build_dir` is named by a hash of the package's ``csrc/`` sources,
under the package's own ``_build/`` where the package can be written (a
checkout, a virtual environment) and otherwise (an installed wheel in a
read-only site-packages) under a per-user cache directory.  A wheel's
files carry the times of its zip, and an upgrade leaves the old
``_build/`` in place, so the rebuild-when-newer rule alone could not tell
one release's sources from another's; the hash does.  The rule stays for
a library whose source lies outside ``csrc/``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
import weakref
from typing import Dict, Optional, Sequence

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def writable(directory: str) -> bool:
    """Whether files can be made in ``directory``: it exists, this process
    may write it, and its mode does not mark it read-only (root may write
    any directory, so a read-only install is known by its mode)."""
    return (os.path.isdir(directory)
            and os.access(directory, os.W_OK | os.X_OK)
            and bool(os.stat(directory).st_mode & 0o222))


def sources_key(csrc: str = CSRC_DIR) -> str:
    """A hash of every file in ``csrc`` (names and contents)."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(csrc)):
        path = os.path.join(csrc, name)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                h.update(name.encode() + b"\0" + f.read() + b"\0")
    return h.hexdigest()[:16]


def resolve_build_dir(pkg_dir: str = PKG_DIR) -> str:
    """``<sources_key>`` under the package's ``_build/`` where that (or,
    before the first build, the package directory) is writable, else under
    the per-user cache, ``$XDG_CACHE_HOME`` (else ``~/.cache``)
    ``/multimodalautoencoder_tpu_torch/``, made if need be.  Raises naming
    both when neither can be written."""
    key = sources_key(os.path.join(pkg_dir, "csrc"))
    own_root = os.path.join(pkg_dir, "_build")
    own = os.path.join(own_root, key)
    if writable(own_root if os.path.isdir(own_root) else pkg_dir):
        return own
    root = (os.environ.get("XDG_CACHE_HOME")
            or os.path.join(os.path.expanduser("~"), ".cache"))
    cache = os.path.join(root, "multimodalautoencoder_tpu_torch", key)
    try:
        os.makedirs(cache, exist_ok=True)
    except OSError:
        pass
    if writable(cache):
        return cache
    raise RuntimeError(
        "no writable directory to build the port's libraries in: neither "
        f"the package's {own} nor the per-user cache {cache}")


@functools.lru_cache(maxsize=None)
def build_dir() -> str:
    """Where this process builds and loads the libraries:
    :func:`resolve_build_dir`, resolved once."""
    return resolve_build_dir()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


class NvccLibrary:
    """A compiled kernel library: built at first use, loaded once, and
    counting its launches.

    ``launches`` goes up by one for each kernel launch and nowhere else,
    so a caller can zero it, drive a path, and read how often the path
    went through the kernels.  Wrappers add to it with :meth:`count`,
    which holds a lock: chunks of a split bucket launch from several
    threads at once.  A launch recorded into a CUDA graph that is being
    captured runs only when the graph is replayed: :meth:`count` then adds
    to ``captured`` instead, and ``ops/step_graph.StepGraph`` adds the
    launches its graph holds to ``launches`` at each replay.
    ``NvccLibrary.instances`` holds every library made, weakly.
    ``library`` is a path, or a bare file name that lies in
    :func:`build_dir`.
    """

    instances: "weakref.WeakSet[NvccLibrary]" = weakref.WeakSet()

    def __init__(self, source: str, library: str,
                 headers: Sequence[str] = ()):
        self.source = source
        self.library = library
        self.headers = tuple(headers)
        self.launches = 0
        self.captured = 0
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self._count_lock = threading.Lock()
        NvccLibrary.instances.add(self)

    @property
    def library(self) -> str:
        if os.path.dirname(self._library):
            return self._library
        return os.path.join(build_dir(), self._library)

    @library.setter
    def library(self, path: str) -> None:
        self._library = path

    def count(self, launches: int) -> None:
        """Add ``launches`` to :attr:`launches`, or to :attr:`captured`
        while the current stream is capturing a CUDA graph."""
        capturing = (torch.cuda.is_available()
                     and torch.cuda.is_current_stream_capturing())
        with self._count_lock:
            if capturing:
                self.captured += int(launches)
            else:
                self.launches += int(launches)

    def stale(self) -> bool:
        library = self.library
        if not os.path.exists(library):
            return True
        built = os.path.getmtime(library)
        return any(os.path.getmtime(p) > built
                   for p in (self.source,) + self.headers)

    def command(self, out: str) -> list:
        """The compiler's command line that builds the library as ``out``."""
        return [nvcc(), *NVCC_FLAGS, "-o", out, self.source]

    def build(self) -> None:
        """Compile the source (:meth:`command`) into ``library``; raises
        with the compiler's output if it fails.  ``build_log`` keeps what
        the compiler reported (ptxas: registers, shared memory, spills)."""
        library = self.library
        os.makedirs(os.path.dirname(library), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so",
                                   dir=os.path.dirname(library))
        os.close(fd)
        cmd = self.command(tmp)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{os.path.basename(cmd[0])} failed ({proc.returncode}):"
                    f" {' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, library)  # atomic: no half-written .so
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr

    def resources(self) -> Dict[str, str]:
        """Kernel (mangled) name -> ptxas' registers / shared memory /
        spill line, from the last build's log."""
        out, name = {}, None
        for line in self.build_log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                continue
            m = re.search(r"(\d+ bytes spill stores.*|Used \d+ registers.*)",
                          line)
            if m and name:
                out[name] = (out.get(name, "") + " " + m.group(0)).strip()
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                if self.stale():
                    self.build()
                lib = ctypes.CDLL(self.library)
                self._bind(lib)
                self._lib = lib
            return self._lib

    def _bind(self, lib: ctypes.CDLL) -> None:
        raise NotImplementedError
