"""The port's packaging: its console entry point resolves to the port's
CLI, and the package data and the sdist manifest carry every CUDA source
the kernels are built from at first use."""

import fnmatch
import glob
import importlib
import os
import tomllib

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
