"""The port's last utilities against the JAX package's: the operation
counts of ``utils/flops.py`` (equal, over tests/test_flops.py's
configurations) and its byte counts (the JAX package's XLA count without
the TPU's lane padding), the job runner and ``cli jobs``, the profiling
helpers, the parity band of the reference recipe, and the probe
agreement at scale."""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from multimodalautoencoder_tpu.config import MMAEConfig as JaxConfig
from multimodalautoencoder_tpu.config import TrainConfig as JaxTrainConfig
from multimodalautoencoder_tpu.ops import train_kernel as tk
from multimodalautoencoder_tpu.sweep import probe_parity as jax_probe_parity
from multimodalautoencoder_tpu.utils import flops as jax_flops
from multimodalautoencoder_tpu.utils import parity as jax_parity
from multimodalautoencoder_tpu_torch import cli
from multimodalautoencoder_tpu_torch.config import MMAEConfig, TrainConfig
from multimodalautoencoder_tpu_torch.sweep import probe_parity
from multimodalautoencoder_tpu_torch.utils import flops, jobs, parity, \
    profiling

BAND_PATH = os.path.join(os.path.dirname(__file__), "fixtures",
                         "parity_band.json")

# tests/test_flops.py's configurations
BASE = dict(num_feats=300, layer_sizes=(300, 100), tie_weights=True,
            loss="sigmoid_cross_entropy")
CONFIGS = [{}, dict(num_feats=1000, layer_sizes=(1000, 100)),
           dict(tie_weights=False), dict(tie_weights=False, variational=True),
           dict(num_feats=1000, layer_sizes=(1000, 100), tie_weights=False),
           dict(classification_layer_sizes=(50, 20), num_labels=1),
           dict(tie_weights=False, variational=True,
                classification_layer_sizes=(50, 20), num_labels=1)] + [
    dict(num_feats=w, layer_sizes=(w, 100), classification_layer_sizes=(50,
                                                                        20),
         num_labels=1) for w in (1000, 500, 300, 200)]
TRAIN = [dict(learning_rate=1e-3, batch_size=20, num_steps=15000,
              clip_gradients=False, optimizer_state_dtype=dt)
         for dt in ("bfloat16", "float32")] + [
    dict(learning_rate=1e-4, batch_size=100, num_steps=15000,
         clip_gradients=False, optimizer_state_dtype=dt)
    for dt in ("bfloat16", "float32")]


def both(kw, tkw):
    c = dict(BASE, **kw)
    return ((MMAEConfig(**c).validate(), TrainConfig(**tkw)),
            (JaxConfig(**c).validate(), JaxTrainConfig(**tkw)))


@pytest.mark.parametrize("tkw", TRAIN)
@pytest.mark.parametrize("kw", CONFIGS)
def test_flops_equal_jax(kw, tkw):
    (c, t), (jc, jt) = both(kw, tkw)
    assert flops.train_step_flops(c, t) == jax_flops.train_step_flops(jc, jt)
    if c.classification_layer_sizes is not None:
        assert flops.cls_train_step_flops(c, t) == \
            jax_flops.cls_train_step_flops(jc, jt)


@pytest.mark.parametrize("tkw", TRAIN)
@pytest.mark.parametrize("kw", CONFIGS)
def test_hbm_bytes_are_the_unpadded_xla_count(kw, tkw):
    """Phase 1: the JAX package's XLA count (parameters and both moments
    read and written, the batch read once) without its 128-lane padding
    of the features.  Phase 2: the same for the trained encoder and head
    and the batch's rows and labels."""
    (c, t), (jc, jt) = both(kw, tkw)
    F, B = c.num_feats, t.batch_size
    pad = B * (tk._pad_to(F, tk.LANE) - F) * 4
    if c.classification_layer_sizes is None:
        assert flops.train_step_hbm_bytes(c, t) == \
            jax_flops.train_step_hbm_bytes(jc, jt, "xla") - pad
        row = flops.utilization_row("x", c, t, 1000.0)
        assert row["useful_gflops_per_s"] == pytest.approx(
            flops.train_step_flops(c, t)["total"] * 1e-6)
        assert row["pct_hbm_peak"] == pytest.approx(
            100 * flops.train_step_hbm_bytes(c, t) * 1000 / 3.35e12)
        assert row["pct_f32_peak"] == pytest.approx(
            100 * row["useful_gflops_per_s"] * 1e9 / 67e12)
        return
    H1, H2 = c.layer_sizes
    dims = [H2, *c.classification_layer_sizes, c.num_labels]
    head = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    enc = F * H1 + H1 * H2 + (H1 * H2 if c.variational else 0)
    params = enc + head + H1 + H2 + (H2 if c.variational else 0) \
        + sum(dims[1:])
    state = 2 if t.optimizer_state_dtype == "bfloat16" else 4
    assert flops.cls_train_step_hbm_bytes(c, t) == \
        params * (8 + 4 * state) + 4 * B * (F + c.num_labels)


# ------------------------------------------------------------------ jobs

def test_job_runner(tmp_path):
    out1, out2 = tmp_path / "o1.txt", tmp_path / "o2.txt"
    job_file = tmp_path / "jobs.txt"
    job_file.write_text(f"EchoJob\necho hello-world\n{out1}\n\n"
                        f"FailJob\nexit 3\n{out2}\n")
    msgs = []
    results = jobs.run_jobs(str(job_file),
                            notify=lambda s, t: msgs.append(s),
                            minimum_seconds=0.0)
    assert [r.status for r in results] == [jobs.SUCCESS, jobs.ERROR]
    assert out1.read_text().strip() == "hello-world"
    assert any("ALL JOBS FINISHED" in m for m in msgs)
    # no clobbering (run_jobs.py:123-129)
    results2 = jobs.run_jobs(str(job_file),
                             notify=lambda s, t: msgs.append(s),
                             minimum_seconds=0.0)
    assert results2[0].status == jobs.ERROR
    assert "SKIPPED" in [m for m in msgs if "EchoJob" in m][-1]


def test_job_runner_fast_warning(tmp_path):
    job_file = tmp_path / "jobs.txt"
    job_file.write_text(f"Quick\ntrue\n{tmp_path / 'o.txt'}\n")
    results = jobs.run_jobs(str(job_file), notify=lambda s, t: None,
                            minimum_seconds=600)
    assert results[0].status == jobs.WARNING


def test_job_file_nonblank_separator_is_loud(tmp_path):
    job_file = tmp_path / "jobs.txt"
    job_file.write_text("Job1\ntrue\nout1.txt\nNOTE: not blank\n"
                        "Job2\ntrue\nout2.txt\n")
    with pytest.raises(ValueError, match="blank separator"):
        jobs.load_job_file(str(job_file))


def test_cli_jobs(tmp_path, capsys):
    ok, bad = tmp_path / "ok.txt", tmp_path / "bad.txt"
    job_file = tmp_path / "jobs.txt"
    job_file.write_text(f"Ok\necho fine\n{ok}\n")
    assert cli.main(["jobs", str(job_file), "--min-seconds", "0"]) == 0
    assert ok.read_text().strip() == "fine"
    assert "ALL JOBS FINISHED" in capsys.readouterr().out
    job_file.write_text(f"Bad\nexit 2\n{bad}\n")
    assert cli.main(["jobs", str(job_file), "--min-seconds", "0"]) == 1


# ------------------------------------------------------------- profiling

def test_blocking_time():
    x = torch.ones((64, 64))
    dt = profiling.blocking_time(lambda: [x * 2, {"y": (x + 1,)}])
    assert dt > 0


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "prof")
    with profiling.trace(d):
        with profiling.span("region", rows=8):
            (torch.ones((8, 8)) + 1).sum()
    path = os.path.join(d, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "region" for e in events)
    (rec,) = profiling.take_spans()
    assert (rec["name"], rec["parent"], rec["counts"]) == (
        "region", None, {"rows": 8})


def test_annotate_noop_safe():
    """``span`` (the annotation of a trace) outside any profiler."""
    with profiling.span("region") as sp:
        sp.count(rows=8)
    assert profiling.take_spans() == []


# ---------------------------------------------------------------- parity

def load_band():
    with open(BAND_PATH) as f:
        return json.load(f)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_recipe_inside_band(backend):
    """Three runs of the reference recipe as one bucket of the grid
    trainer on the CPU (the plain trainer, or the kernel's twin) land
    inside the band the JAX package's XLA runs set."""
    band = load_band()
    obs = parity.reference_recipe_observables(
        backend=backend, num_runs=3, num_steps=band["recipe"]["num_steps"],
        device="cpu")
    assert obs["noisy_val_loss"].shape == (3,)
    assert obs["per_modality_rmse"].shape == (3, 5)
    problems = parity.check_band(obs, band)
    assert not problems, "\n".join(problems)


def test_band_rejects_untrained_model():
    obs = parity.reference_recipe_observables(backend="xla", num_runs=1,
                                              num_steps=1, device="cpu")
    assert any("noisy_val_loss" in p
               for p in parity.check_band(obs, load_band()))


def test_band_helpers_match_jax():
    rng = np.random.default_rng(3)
    obs = {"noisy_val_loss": 17 + rng.random(8),
           "per_modality_rmse": 0.3 + 0.1 * rng.random((8, 5))}
    band = parity.derive_band(obs)
    assert band == jax_parity.derive_band(obs)
    assert band == parity.derive_band(obs, rel_margin=0.10, n_sigma=6.0)
    assert parity.check_band(obs, band) == []
    off = {k: v * 2 for k, v in obs.items()}
    assert parity.check_band(off, band) == jax_parity.check_band(off, band)
    assert (parity.FIXTURE_SEED, parity.FIXTURE_ROWS, parity.RECIPE_STEPS,
            parity.RECIPE_ARCH) == (jax_parity.FIXTURE_SEED,
                                    jax_parity.FIXTURE_ROWS,
                                    jax_parity.RECIPE_STEPS,
                                    jax_parity.RECIPE_ARCH)


# ------------------------------------------------------ probe agreement

def test_probe_agreement_at_scale_keys(tmp_path):
    """One tiny architecture (36 settings), 2 folds, 60 rows, 2 steps on
    the CPU: the JAX function's keys, a finished coverage, and the partial
    file holding what was returned."""
    pytest.importorskip("sklearn")
    partial = str(tmp_path / "agree.json")
    out = probe_parity.measure_probe_agreement_at_scale(
        num_steps=2, folds=2, num_rows=60, workdir=str(tmp_path / "w"),
        partial_out=partial, device="cpu", layer_sizes=((16, 8),))
    frame = pd.DataFrame([{"architecture": "[16, 8]", "dropout_prob": i,
                           "svm_val_acc": i / 10, "svm_val_auc": 1 - i / 10}
                          for i in range(3)])
    keys = jax_probe_parity.ranking_agreement(frame, frame)
    assert set(out) == set(keys) | {"_coverage"}
    for col in keys:
        assert set(out[col]) == set(keys[col])
        assert out[col]["n_settings"] == 36
    cov = out["_coverage"]
    assert cov["partial"] is False
    assert cov["settings_done"] == cov["settings_total"] == 36
    with open(partial) as f:
        assert json.load(f) == json.loads(json.dumps(out))


def test_probe_agreement_at_scale_names_missing_sklearn(tmp_path,
                                                        monkeypatch):
    """Without scikit-learn (the H100 machine has none) the at-scale run
    raises the ImportError that names it before it trains anything."""
    import sys

    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        probe_parity.measure_probe_agreement_at_scale(
            num_steps=1, folds=2, num_rows=40, workdir=str(tmp_path / "w"),
            device="cpu", layer_sizes=((16, 8),))
