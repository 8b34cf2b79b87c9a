"""The port's packaging: its console entry point resolves to the port's
CLI; the package data and the sdist manifest carry every source the
kernels and the CSV parser are built from at first use; the build
directory is keyed by the sources, under the package's ``_build/`` where
that can be written and under a per-user cache otherwise; and a read-only
wheel install reads with the native engine."""

import fnmatch
import glob
import importlib
import json
import os
import tomllib

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "multimodalautoencoder_tpu_torch"


def pyproject():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def test_entry_point_resolves_to_the_port_cli():
    target = pyproject()["project"]["scripts"]["mmae-tpu-torch"]
    module, func = target.split(":")
    assert module == f"{PKG}.cli"
    from multimodalautoencoder_tpu_torch import cli

    assert getattr(importlib.import_module(module), func) is cli.main
    assert cli.build_parser().prog == PKG


def sources():
    csrc = os.path.join(REPO, PKG, "csrc")
    out = sorted(os.path.relpath(p, os.path.join(REPO, PKG))
                 for p in glob.glob(os.path.join(csrc, "*")))
    assert out, "no CUDA sources"
    return out


def test_package_data_covers_every_cuda_source():
    globs = pyproject()["tool"]["setuptools"]["package-data"][PKG]
    for rel in sources():
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
    packages = pyproject()["tool"]["setuptools"]["packages"]["find"]
    assert any(fnmatch.fnmatch(PKG, g) for g in packages["include"])


def test_manifest_covers_every_cuda_source():
    with open(os.path.join(REPO, "MANIFEST.in")) as f:
        rules = [line.split() for line in f if line.startswith(
            "recursive-include")]
    for rel in sources():
        path = f"{PKG}/{rel}"
        assert any(path.startswith(r[1].rstrip("/") + "/")
                   and any(fnmatch.fnmatch(os.path.basename(path), p)
                           for p in r[2:]) for r in rules), path


def test_native_parser_ships_byte_equal_to_the_jax_packages():
    """The port carries its own copy of the C++ CSV parser, so a wheel has
    it; the copy stays the JAX package's source byte for byte (and
    ``sources()`` above holds it to the package data and the manifest)."""
    with open(os.path.join(REPO, "native", "csv_loader.cpp"), "rb") as f:
        theirs = f.read()
    with open(os.path.join(REPO, PKG, "csrc", "csv_loader.cpp"), "rb") as f:
        assert f.read() == theirs
    assert "csrc/csv_loader.cpp" in sources()
    from multimodalautoencoder_tpu_torch.data import fast_csv

    assert fast_csv.SOURCE == os.path.join(REPO, PKG, "csrc",
                                           "csv_loader.cpp")


def fake_package(root, text="int k;\n"):
    pkg = root / "pkg"
    (pkg / "csrc").mkdir(parents=True)
    (pkg / "csrc" / "k.cu").write_text(text)
    return pkg


def read_only(path):
    path.chmod(path.stat().st_mode & ~0o222)


def test_build_dir_is_the_package_s_where_it_can_be_written(tmp_path,
                                                            monkeypatch):
    from multimodalautoencoder_tpu_torch.ops import cuda_library as cl

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    pkg = fake_package(tmp_path)
    own = str(pkg / "_build" / cl.sources_key(str(pkg / "csrc")))
    assert cl.resolve_build_dir(str(pkg)) == own
    (pkg / "_build").mkdir()
    assert cl.resolve_build_dir(str(pkg)) == own
    assert not (tmp_path / "cache").exists()


def test_an_upgraded_writable_install_rebuilds_its_libraries(tmp_path):
    """Upgrading a writable install (a virtual environment) replaces the
    package's sources and leaves its ``_build/`` as it was, and the new
    sources carry the wheel's file times, older than the old library.  The
    build directory follows the sources' hash, so the new version builds a
    library of its own instead of loading the old one."""
    import ctypes
    import shutil

    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        pytest.skip("needs g++ to build a library")
    from multimodalautoencoder_tpu_torch.ops import cuda_library as cl

    class Version(cl.NvccLibrary):
        def command(self, out):
            return [cxx, "-shared", "-fPIC", "-o", out, self.source]

        def _bind(self, lib):
            lib.version.restype = ctypes.c_int

    pkg = tmp_path / "site" / "pkg"
    (pkg / "csrc").mkdir(parents=True)
    src = pkg / "csrc" / "version.cpp"

    def install(version):
        src.write_text(f'extern "C" int version() {{ return {version}; }}\n')
        os.utime(src, (1e9, 1e9))   # a zip's time, long before any build
        build = cl.resolve_build_dir(str(pkg))
        lib = Version(str(src), os.path.join(build, "libversion.so"))
        return lib.load().version(), build

    one, first = install(1)
    two, second = install(2)
    assert (one, two) == (1, 2)
    assert second != first
    assert os.path.dirname(first) == os.path.dirname(second) == str(
        pkg / "_build")
    assert os.path.isfile(os.path.join(first, "libversion.so"))


def test_build_dir_of_a_read_only_install_is_keyed_by_the_sources(
        tmp_path, monkeypatch):
    """A package that cannot be written builds in the per-user cache, in a
    directory named by the hash of its csrc/ sources: another version's
    sources get another directory, whatever the files' times say."""
    from multimodalautoencoder_tpu_torch.ops import cuda_library as cl

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    pkg = fake_package(tmp_path)
    read_only(pkg)
    try:
        first = cl.resolve_build_dir(str(pkg))
        assert first == os.path.join(str(tmp_path / "cache"),
                                     "multimodalautoencoder_tpu_torch",
                                     cl.sources_key(str(pkg / "csrc")))
        assert os.path.isdir(first) and cl.writable(first)
        assert cl.resolve_build_dir(str(pkg)) == first
        src = pkg / "csrc" / "k.cu"
        stamp = src.stat().st_mtime
        src.write_text("int k2;\n")
        os.utime(src, (stamp, stamp))
        second = cl.resolve_build_dir(str(pkg))
        assert second != first
        assert os.path.dirname(second) == os.path.dirname(first)
    finally:
        pkg.chmod(0o755)
    # the key covers every file's name and contents, nothing else
    a, b = fake_package(tmp_path / "a"), fake_package(tmp_path / "b")
    assert cl.sources_key(str(a / "csrc")) == cl.sources_key(str(b / "csrc"))
    (b / "csrc" / "extra.cuh").write_text("")
    assert cl.sources_key(str(a / "csrc")) != cl.sources_key(str(b / "csrc"))


def test_build_dir_raises_naming_both_when_neither_can_be_written(
        tmp_path, monkeypatch):
    from multimodalautoencoder_tpu_torch.ops import cuda_library as cl

    blocker = tmp_path / "not_a_directory"
    blocker.write_text("")
    monkeypatch.setenv("XDG_CACHE_HOME", str(blocker / "cache"))
    pkg = fake_package(tmp_path)
    read_only(pkg)
    try:
        with pytest.raises(RuntimeError) as e:
            cl.resolve_build_dir(str(pkg))
    finally:
        pkg.chmod(0o755)
    assert str(pkg / "_build") in str(e.value)
    assert str(blocker / "cache") in str(e.value)


def test_library_names_resolve_in_the_build_dir(tmp_path):
    from multimodalautoencoder_tpu_torch.ops import cuda_library as cl

    lib = cl.NvccLibrary("k.cu", "libk.so")
    assert lib.library == os.path.join(cl.build_dir(), "libk.so")
    lib.library = str(tmp_path / "libk.so")
    assert lib.library == str(tmp_path / "libk.so")


WHEEL_PROBE = """
import json, sys
import numpy as np
import multimodalautoencoder_tpu_torch as port
from multimodalautoencoder_tpu_torch.data import fast_csv
from multimodalautoencoder_tpu_torch.data.preprocess import \\
    get_wanted_feats_from_df
from multimodalautoencoder_tpu_torch.ops import cuda_library

frame = fast_csv.read_csv(sys.argv[1])
np.save(sys.argv[2], frame.matrix(get_wanted_feats_from_df(frame.names)))
print(json.dumps({"package": port.__file__,
                  "build_dir": cuda_library.build_dir(),
                  "library": fast_csv.LIB.library,
                  "jax": "jax" in sys.modules}))
"""


def test_read_only_wheel_reads_with_the_native_engine(tmp_path):
    """A wheel of this checkout, installed with ``pip --target`` into a
    directory made read-only, reads a CSV with ``engine="native"`` in a
    fresh interpreter whose imports resolve to the install: the values of
    this checkout's reading, the parser built in the per-user cache."""
    import shutil
    import subprocess
    import sys

    import numpy as np

    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("needs g++ to build the native CSV parser")
    from multimodalautoencoder_tpu_torch.data import fast_csv, synthetic
    from multimodalautoencoder_tpu_torch.data.preprocess import \
        get_wanted_feats_from_df
    from multimodalautoencoder_tpu_torch.tools import wheel_check

    csv_path = synthetic.write_csv(str(tmp_path / "study.csv"),
                                   num_rows=40, seed=3)
    run = tmp_path / "run"
    run.mkdir()
    with wheel_check.read_only_install(REPO, str(tmp_path)) as (site, env):
        assert os.path.isfile(os.path.join(site, PKG, "csrc",
                                           "csv_loader.cpp"))
        assert not os.stat(site).st_mode & 0o222
        r = subprocess.run([sys.executable, "-c", WHEEL_PROBE, csv_path,
                            str(tmp_path / "values.npy")], env=env,
                           cwd=str(run), capture_output=True, text=True,
                           timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    install = site + os.sep
    assert got["package"].startswith(install)
    assert not got["build_dir"].startswith(install)
    assert got["build_dir"].startswith(str(tmp_path / "cache") + os.sep)
    assert got["library"] == os.path.join(got["build_dir"],
                                          "libcsvloader.so")
    assert os.path.isfile(got["library"]) and not got["jax"]
    frame = fast_csv.read_csv(csv_path)
    want = frame.matrix(get_wanted_feats_from_df(frame.names))
    theirs = np.load(tmp_path / "values.npy")
    np.testing.assert_array_equal(theirs.view(np.int64), want.view(np.int64))
