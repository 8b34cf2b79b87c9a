"""A wheel of a checkout, installed read-only, as a system-wide or
container install of the port is: the check that an installed copy runs,
builds its libraries outside the install, and imports nothing of the
checkout.

    with read_only_install(repo, root) as (site, env):
        subprocess.run([sys.executable, "-c", probe], env=env,
                       cwd=another_directory)

``root`` gets ``src/`` (the copy the wheel is built from), ``dist/`` (the
wheel), ``site/`` (the install, read-only inside the block) and
``cache/`` (``XDG_CACHE_HOME``: where the install builds its libraries).
Nothing is fetched: pip builds with the installed setuptools and no
index.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import subprocess
import sys
from typing import Dict, Iterator, Tuple

# what the wheel is built from: pyproject.toml's packages and its files
PACKAGES = ("multimodalautoencoder_tpu", "multimodalautoencoder_tpu_torch")
FILES = ("pyproject.toml", "MANIFEST.in", "README.md")


def _pip(args, timeout: float) -> None:
    cmd = [sys.executable, "-m", "pip", "--disable-pip-version-check",
           *args]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if r.returncode:
        raise RuntimeError(f"pip {args[0]} failed ({r.returncode}): "
                           f"{r.stdout[-2000:]}{r.stderr[-2000:]}")


def _set_write(site: str, on: bool) -> None:
    for d, dirs, files in os.walk(site):
        for p in [os.path.join(d, n) for n in dirs + files] + [d]:
            mode = os.stat(p).st_mode
            os.chmod(p, mode | 0o200 if on else mode & ~0o222)


@contextlib.contextmanager
def read_only_install(repo: str, root: str,
                      timeout: float = 300
                      ) -> Iterator[Tuple[str, Dict[str, str]]]:
    """Build a wheel of ``repo`` in ``root``, install it with ``pip
    --target`` into ``root/site`` and make that read-only; yields the
    install's directory and the environment of an interpreter whose
    imports resolve there alone (``PYTHONPATH`` the install, no bytecode
    written, ``XDG_CACHE_HOME`` ``root/cache``).  The write bits come back
    at the end, so ``root`` can be removed."""
    src, dist, site = (os.path.join(root, d) for d in ("src", "dist",
                                                       "site"))
    os.makedirs(src)
    for name in FILES:
        shutil.copy(os.path.join(repo, name), src)
    for pkg in PACKAGES:
        shutil.copytree(os.path.join(repo, pkg), os.path.join(src, pkg),
                        ignore=shutil.ignore_patterns("__pycache__",
                                                      "_build"))
    _pip(["wheel", "--no-index", "--no-deps", "--no-build-isolation", "-q",
          "-w", dist, src], timeout)
    wheels = os.listdir(dist)
    if len(wheels) != 1:
        raise RuntimeError(f"the build made {wheels}, not one wheel")
    _pip(["install", "--no-index", "--no-deps", "-q", "--target", site,
          os.path.join(dist, wheels[0])], timeout)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=site, PYTHONDONTWRITEBYTECODE="1",
               XDG_CACHE_HOME=os.path.join(root, "cache"))
    _set_write(site, False)
    try:
        yield site, env
    finally:
        _set_write(site, True)
