"""The port's end-to-end demo (``multimodalautoencoder_tpu_torch/examples/
acii_pipeline.py``) beside the JAX package's (``examples/acii_pipeline.py``),
both on the CPU at ``--rows 200 --steps 20 --folds 2``.

The JAX demo runs once for the module, as a subprocess into a directory of
its own, while the port's runs in this process with ``--device cpu``: once
with the default SVM baseline and once with ``--baseline nn``.  Training
draws from other generators in the two packages, so what must agree is
the pipeline: the synthetic study byte for byte, the ledgers' files,
columns and row counts (the MMAE sweep's 12 settings), the printed
sections, and a repaired file of the same shape whose observed cells are
the input's.  Every metric the port prints is finite."""

import contextlib
import csv
import io
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from multimodalautoencoder_tpu_torch.data.loader import read_csv
from multimodalautoencoder_tpu_torch.data.preprocess import \
    get_wanted_feats_from_df
from multimodalautoencoder_tpu_torch.examples import acii_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--rows", "200", "--steps", "20", "--folds", "2"]


def run_port(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = acii_pipeline.main(argv)
    return out, buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jdir = tmp_path_factory.mktemp("jax_demo")
    pdir = tmp_path_factory.mktemp("port_demo")
    ndir = tmp_path_factory.mktemp("port_demo_nn")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    jax_demo = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples", "acii_pipeline.py"),
         *ARGS, "--out", str(jdir)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=str(jdir))
    try:
        port, port_text = run_port(ARGS + ["--device", "cpu", "--out",
                                           str(pdir)])
        nn, nn_text = run_port(ARGS + ["--device", "cpu", "--baseline", "nn",
                                       "--out", str(ndir)])
        jax_text, jax_err = jax_demo.communicate(timeout=600)
    finally:
        if jax_demo.poll() is None:
            jax_demo.kill()
            jax_demo.wait()
    assert jax_demo.returncode == 0, jax_err[-4000:]
    return types.SimpleNamespace(
        jdir=str(jdir), pdir=str(pdir), ndir=str(ndir), port=port,
        port_text=port_text, nn=nn, nn_text=nn_text, jax_text=jax_text)


def headers(text, out):
    return [line.replace(out, "<out>") for line in text.splitlines()
            if line.startswith("== ")]


def ledger(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_synthetic_study_is_byte_equal(runs):
    for d in (runs.pdir, runs.ndir):
        with open(os.path.join(d, "wearables.csv"), "rb") as a, \
                open(os.path.join(runs.jdir, "wearables.csv"), "rb") as b:
            assert a.read() == b.read()


def test_same_files_ledgers_columns_and_rows(runs):
    for sub in ("", "results"):
        assert sorted(os.listdir(os.path.join(runs.pdir, sub))) == sorted(
            os.listdir(os.path.join(runs.jdir, sub))), sub
    results = os.path.join(runs.pdir, "results")
    ledgers = sorted(f for f in os.listdir(results) if f.endswith(".csv"))
    assert ledgers == ["MMAE-wearables.csv",
                       "MMAE_NN_classifier-wearables.csv",
                       "SVM-MMAE_filled-wearables-happiness.csv"]
    for name in ledgers:
        cols, rows = ledger(os.path.join(results, name))
        jcols, jrows = ledger(os.path.join(runs.jdir, "results", name))
        assert cols == jcols, name
        assert len(rows) == len(jrows), name
    cols, rows = ledger(os.path.join(results, "MMAE-wearables.csv"))
    assert len(rows) == 12
    backend = cols.index("backend_used")
    assert {r[backend] for r in rows} == {"xla"}
    assert runs.port["settings"] == 12


def test_same_section_headers(runs):
    want = headers(runs.jax_text, runs.jdir)
    assert len(want) == 4
    assert headers(runs.port_text, runs.pdir) == want
    nn = headers(runs.nn_text, runs.ndir)
    assert nn[:3] == want[:3]
    assert nn[3] == want[3].replace("-> SVM", "-> NN")


@pytest.mark.parametrize("route", ["svm", "nn"])
def test_every_printed_metric_is_finite(runs, route):
    out, text = (runs.port, runs.port_text) if route == "svm" else (
        runs.nn, runs.nn_text)
    numbers = acii_pipeline.printed_numbers(text)
    # loss, probe acc, val / noisy / clean acc, 5 RMSEs, the baseline's acc
    assert len(numbers) == 11, text
    assert all(math.isfinite(x) for x in numbers), text
    for key in ("best_loss", "probe_acc", "cls_val_acc",
                "cls_noisy_val_acc", "cls_clean_val_acc",
                "baseline_val_acc"):
        assert math.isfinite(out[key]), key
    assert all(math.isfinite(r) for r in out["rmse"].values())


@pytest.mark.parametrize("route", ["svm", "nn"])
def test_repaired_file_keeps_the_observed_cells(runs, route):
    out = runs.port if route == "svm" else runs.nn
    assert out["filled"] == os.path.join(
        runs.pdir if route == "svm" else runs.ndir,
        "MMAE_filled-wearables.csv")
    before, after = read_csv(out["csv"]), read_csv(out["filled"])
    theirs = read_csv(os.path.join(runs.jdir, "MMAE_filled-wearables.csv"))
    assert after.names == theirs.names == before.names
    assert len(after) == len(theirs) == len(before)
    feats = get_wanted_feats_from_df(before.names)
    x, y = before.matrix(feats), after.matrix(feats)
    seen = ~np.isnan(x)
    # the default reader is pandas' parser, which is not round-trip exact
    np.testing.assert_allclose(y[seen], x[seen], rtol=0, atol=1e-12)
    # the same cells filled as by the JAX package (rows with a raw NaN
    # elsewhere reconstruct to NaN and stay empty in both: the reference
    # reads the file raw, multimodal_autoencoder.py:1172)
    np.testing.assert_array_equal(np.isnan(y),
                                  np.isnan(theirs.matrix(feats)))


def test_nn_route_trains_one_nn_setting(runs):
    cols, rows = ledger(runs.nn["baseline_ledger"])
    assert os.path.basename(runs.nn["baseline_ledger"]) == \
        "NN-MMAE_filled-wearables-happiness.csv"
    assert len(rows) == 1
    assert rows[0][cols.index("architecture")] == "[128, 64]"


def test_cuda_device_without_a_card_exits(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the demo would run on it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        acii_pipeline.main(ARGS + ["--out", str(tmp_path)])
