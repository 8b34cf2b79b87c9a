"""The port's ``MMAESweep`` and ``cli sweep-mmae`` against the JAX package:
a tiny grid on the CPU through both sweeps on the same study (the same
settings, buckets and ledger columns), the port's ledger resumed by the
JAX ``ResultsLedger``, a resumed run that skips every setting, the export
of the tracked winner, the SVM probe (``probe="svm"``) on the same
parameters, and the options the port refuses."""

import functools
import os
import sys

import jax  # noqa: F401  (the JAX package runs on the CPU here)
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalautoencoder_tpu.data.loader import DataLoader as JaxLoader
from multimodalautoencoder_tpu.sweep import engine as jax_engine
from multimodalautoencoder_tpu.sweep import wrappers as jax_wrappers
from multimodalautoencoder_tpu_torch import cli
from multimodalautoencoder_tpu_torch.data import synthetic
from multimodalautoencoder_tpu_torch.data.loader import DataLoader
from multimodalautoencoder_tpu_torch.sweep import wrappers
from multimodalautoencoder_tpu_torch.train import checkpoint as ckpt

LABELS = ("happy_label", "calm_label")
# 2 architectures (one deep) x tied/untied x 2 penalties, and a VAE per
# architecture and penalty: 12 settings in 6 buckets, 3 of them deep
GRID = dict(layer_sizes=[[12, 6], [12, 8, 6]], tie_weights=[True, False],
            dropout_probs=[1.0], weight_penalties=[0.0, 0.01],
            activation_funcs=["softsign"], test_variational=True,
            labels_to_predict=["happy_label", "calm_label"],
            svm_Cs=[1.0, 10.0], svm_gammas=[0.01], probe_rff_dim=32)


def study(tmp_path, name="m.csv", rows=120):
    path = str(tmp_path / name)
    synthetic.make_frame(num_rows=rows, seed=4,
                         label_names=LABELS).to_csv(path)
    return path


def loaders(path, jax_side=False):
    kw = dict(cross_validation=True, normalize_and_fill=True,
              fill_gaps_with=-1.0, suppress_output=True)
    cls = JaxLoader if jax_side else DataLoader
    return cls(path, supervised=False, **kw), cls(path, supervised=True,
                                                  **kw)


def test_cli_sweep_mmae_matches_jax_ledger(tmp_path, monkeypatch, capsys):
    """The tiny grid through ``cli sweep-mmae --device cpu`` and the JAX
    ``MMAESweep`` on the same study: the same settings and ledger columns,
    a ledger the JAX engine resumes, and a resumed run that skips every
    setting."""
    path = study(tmp_path)
    monkeypatch.setattr(wrappers, "MMAESweep",
                        functools.partial(wrappers.MMAESweep, verbose=False,
                                          **GRID))
    args = ["sweep-mmae", path, path, "--num-steps", "4", "--folds", "2",
            "--device", "cpu", "--normalize-and-fill", "--results-path",
            str(tmp_path / "port")]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    ledger = str(tmp_path / "port" / "MMAE-m.csv")
    port = pd.read_csv(ledger, index_col=0)
    assert len(port) == 12 and set(port["backend_used"]) == {"xla"}
    assert np.isfinite(port["val_sigmoid_cross_entropy"]).all()
    assert port["svm_val_acc"].between(0, 1).all()
    assert "best by svm_val_acc:" in out

    unsup, sup = loaders(path, jax_side=True)
    js = jax_wrappers.MMAESweep(
        unsup, classification_data_loader=sup, num_steps=2,
        num_cross_folds=2, results_path=str(tmp_path / "jax"),
        verbose=False, backend="xla", **GRID)
    js.sweep_all_parameters()
    jax_df = pd.read_csv(js.ledger.path, index_col=0)
    assert list(port.columns) == list(jax_df.columns)
    for key in ("architecture", "tie_weights", "variational",
                "weight_penalty"):
        assert list(map(str, port[key])) == list(map(str, jax_df[key]))

    # the JAX ledger resumes from the port's file: every setting done
    jled = jax_engine.ResultsLedger(str(tmp_path / "port"), "MMAE-m",
                                    cont=True)
    assert all(jled.already_done(s) for s in js.list_of_param_settings)

    assert cli.main(args + ["--continue"]) == 0
    assert len(pd.read_csv(ledger, index_col=0)) == 12
    capsys.readouterr()
    # --check-test retrains the winner on fold 0 and scores the test set
    assert cli.main(args + ["--check-test"]) == 0
    held_out = [line for line in capsys.readouterr().out.splitlines()
                if line.startswith("held-out test:")]
    assert len(held_out) == 1 and np.isfinite(float(held_out[0].split()[-1]))
    # --process-shard: two ledger shards whose merge holds every setting
    sharded = str(tmp_path / "shards")
    for i in ("0", "1"):
        assert cli.main(args[:-1] + [sharded, "--process-shard", i,
                                     "2"]) == 0
    shards = [pd.read_csv(os.path.join(sharded, f"MMAE-m.shard{i}of2.csv"),
                          index_col=0) for i in (0, 1)]
    assert [len(d) for d in shards] == [6, 6]
    assert cli.main(["merge-shards", sharded, "MMAE-m",
                     "--num-shards", "2"]) == 0
    merged = pd.read_csv(os.path.join(sharded, "MMAE-m.csv"), index_col=0)
    assert len(merged) == 12
    assert sorted(map(str, zip(merged["architecture"],
                               merged["tie_weights"],
                               merged["variational"],
                               merged["weight_penalty"]))) == sorted(
        map(str, zip(port["architecture"], port["tie_weights"],
                     port["variational"], port["weight_penalty"])))


def test_mmae_sweep_settings_and_buckets_match_jax(tmp_path):
    """The same grid in the same order, the VAE settings appended, and the
    recipe (lr 1e-3, batch 20, decay 1000 / 0.95, bf16 moments)."""
    path = study(tmp_path)
    ju, js_ = loaders(path, jax_side=True)
    pu, ps = loaders(path)
    kw = dict(results_path=str(tmp_path / "r"), verbose=False,
              optimizers=("adam", "sgd"), **GRID)
    jax_sweep = jax_wrappers.MMAESweep(ju, classification_data_loader=js_,
                                       **kw)
    port = wrappers.MMAESweep(pu, classification_data_loader=ps,
                              device="cpu", **kw)
    assert port.list_of_param_settings == jax_sweep.list_of_param_settings
    assert port.num_settings == 24
    for name in ("learning_rate", "batch_size", "decay", "decay_steps",
                 "decay_rate", "num_steps", "optimizer_state_dtype",
                 "clip_gradients"):
        assert getattr(port.tcfg, name) == getattr(jax_sweep.tcfg, name)
    assert port.optimize_for == jax_sweep.optimize_for
    assert port.probe == "device"


def test_mmae_sweep_exports_tracked_winner(tmp_path):
    """save_best_params: the winner (lowest mean val loss) is exported as
    best_mmae with its setting, and the checkpoint serves on the CPU."""
    path = study(tmp_path)
    unsup, sup = loaders(path)
    sweep = wrappers.MMAESweep(
        unsup, classification_data_loader=sup, num_steps=3,
        num_cross_folds=2, results_path=str(tmp_path / "r"), verbose=False,
        save_best_params=True, backend="pallas", device="cpu",
        **dict(GRID, layer_sizes=[[12, 8, 6]], test_variational=False))
    best, test_score, extras = sweep.run()
    assert test_score is None and set(extras) == {"svm_val_acc",
                                                 "svm_val_auc"}
    rows = sweep.ledger.rows
    assert len(rows) == 4 and {r["backend_used"] for r in rows} == {"pallas"}
    losses = [r["val_sigmoid_cross_entropy"] for r in rows]
    assert best["val_sigmoid_cross_entropy"] == min(losses)
    ck = os.path.join(str(tmp_path / "r"), "best_mmae-3.npz")
    assert os.path.exists(ck)
    meta = ckpt.checkpoint_meta(ck)
    won = {k: best[k] for k in ("tie_weights", "weight_penalty")}
    assert {k: meta["extra"]["setting"][k] for k in won} == won
    params, cfg, _, _ = ckpt.load_checkpoint_auto(
        ck, sweep.base_cfg, verbose=False, device="cpu")
    assert cfg.layer_sizes == (12, 8, 6)
    assert all(torch.isfinite(t).all() for t in params.enc_w)


def test_mmae_sweep_without_probe_and_resume(tmp_path):
    """probe=None writes no probe columns; cont=True skips every setting
    without training."""
    path = study(tmp_path)
    unsup, _ = loaders(path)
    kw = dict(num_steps=2, num_cross_folds=2, probe=None, verbose=False,
              results_path=str(tmp_path / "r"), device="cpu",
              **dict(GRID, layer_sizes=[[12, 6]], tie_weights=[True],
                     test_variational=False))
    s1 = wrappers.MMAESweep(unsup, **kw)
    s1.sweep_all_parameters()
    assert len(s1.ledger) == 2
    assert not any(c.startswith("svm_") for c in s1.ledger.columns)
    s2 = wrappers.MMAESweep(unsup, cont=True, **kw)
    assert s2.ledger.started_from == 2
    s2.sweep_all_parameters()
    assert len(s2.ledger) == 2
    assert s2.phase_seconds["train"] == 0.0


def test_mmae_sweep_refuses_unported_options(tmp_path, monkeypatch):
    path = study(tmp_path)
    unsup, sup = loaders(path)
    kw = dict(results_path=str(tmp_path / "r"), device="cpu")
    # check_test is taken now: it retrains with the single-run trainer
    assert wrappers.MMAESweep(unsup, check_test=True, **kw).check_test
    # process_shard is ported: the even settings into a shard ledger
    whole = wrappers.MMAESweep(unsup, **kw).list_of_param_settings
    shard = wrappers.MMAESweep(unsup, process_shard=(0, 2), **kw)
    assert shard.list_of_param_settings == whole[0::2]
    assert shard.ledger.path.endswith(".shard0of2.csv")
    with pytest.raises(ValueError, match="0-based"):
        wrappers.MMAESweep(unsup, process_shard=(2, 2), **kw)
    # probe='svm' is ported; without scikit-learn it names what is missing
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        wrappers.MMAESweep(unsup, classification_data_loader=sup,
                           probe="svm", **kw)
    monkeypatch.undo()
    sweep = wrappers.MMAESweep(unsup, num_steps=3, **kw)
    setting = sweep.list_of_param_settings[0]
    assert np.isfinite(sweep.test_on_test(setting))
    state, cfg, arr = sweep._retrain_fold0(setting)
    assert int(state.step) == 3 and cfg.layer_sizes == (1000, 100)
    assert arr["test_x"].shape[0] == len(unsup.test_X)


def test_loader_defaults_to_supervised(tmp_path):
    """The port's DataLoader defaults to supervised=True, as the JAX
    package's does: labels are read unless the caller says otherwise."""
    path = study(tmp_path)
    dl = DataLoader(path, suppress_output=True)
    jl = JaxLoader(path, suppress_output=True)
    assert dl.supervised and jl.supervised
    assert dl.wanted_labels == jl.wanted_labels == list(LABELS)
    np.testing.assert_array_equal(dl.train_Y, np.asarray(jl.train_Y))
    assert DataLoader(path, supervised=False,
                      suppress_output=True).train_Y is None


def test_nan_objective_never_wins_the_export(tmp_path, monkeypatch):
    """A diverged setting (a NaN objective in one fold) is never the
    tracked winner: the export holds the ledger's best, as
    find_best_setting skips NaN."""
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt

    real = gt.train_grid_sharded

    def first_diverges(*args, **kwargs):
        params, losses = real(*args, **kwargs)
        losses = losses.clone()
        losses[0, 0] = float("nan")
        return params, losses

    monkeypatch.setattr(gt, "train_grid_sharded", first_diverges)
    path = study(tmp_path)
    unsup, _ = loaders(path)
    sweep = wrappers.MMAESweep(
        unsup, num_steps=2, num_cross_folds=2, probe=None, verbose=False,
        results_path=str(tmp_path / "r"), save_best_params=True,
        device="cpu", **dict(GRID, layer_sizes=[[12, 6]], tie_weights=[True],
                             test_variational=False))
    best, _, _ = sweep.run()
    rows = sweep.ledger.rows
    assert np.isnan(rows[0]["val_sigmoid_cross_entropy"])
    assert best["weight_penalty"] == rows[1]["weight_penalty"]
    meta = ckpt.checkpoint_meta(os.path.join(str(tmp_path / "r"),
                                             "best_mmae-2.npz"))
    assert meta["extra"]["setting"]["weight_penalty"] == \
        rows[1]["weight_penalty"]
    assert np.isfinite(meta["extra"]["score"])


def test_check_test_retrains_as_jax_and_scores_as_jax(tmp_path):
    """check_test's retrain config equals the JAX ``_retrain_fold0``'s
    field for field (a whole ledger row, with an optimizer axis), and the
    test score of the retrained parameters equals the JAX ``predict`` loss
    on the same parameters within f32 tolerance."""
    import dataclasses

    import jax.numpy as jnp

    from multimodalautoencoder_tpu.models import mmae as jax_mmae
    from multimodalautoencoder_tpu.train import trainer as jax_trainer
    from multimodalautoencoder_tpu_torch.models import mmae

    path = study(tmp_path)
    kw = dict(num_steps=4, num_cross_folds=2, verbose=False,
              optimizers=("adam", "sgd"),
              **dict(GRID, layer_sizes=[[12, 6]], test_variational=False))
    pu, ps = loaders(path)
    ju, js_ = loaders(path, jax_side=True)
    port = wrappers.MMAESweep(pu, classification_data_loader=ps,
                              results_path=str(tmp_path / "p"),
                              device="cpu", check_test=True, **kw)
    jsw = jax_wrappers.MMAESweep(ju, classification_data_loader=js_,
                                 results_path=str(tmp_path / "j"), **kw)
    row = dict(port.list_of_param_settings[-1], architecture="[12, 6]",
               val_sigmoid_cross_entropy=1.0)
    state, cfg, arr = port._retrain_fold0(row)
    _, jcfg, _ = jsw._retrain_fold0(row)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert int(state.step) == 4

    score = port.test_score(state.params, cfg, arr["test_x"])
    template = jax_mmae.init(jax.random.PRNGKey(0), jcfg)
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [jnp.asarray(a) for a in mmae.params_to_numpy(state.params)])
    _, want = jax_trainer.predict(params, jcfg,
                                  jnp.asarray(ju.test_X, jnp.float32))
    assert score == pytest.approx(float(want), rel=1e-5)

    best, test_score, _ = port.run()
    assert np.isfinite(test_score)
    assert test_score == pytest.approx(port.test_on_test(best), rel=1e-6)


def test_svm_probe_ledger_matches_jax(tmp_path):
    """probe='svm': ``cli sweep-mmae --probe svm`` writes the JAX SVM-probe
    sweep's ledger columns and settings on the same tiny grid, and on the
    same trained parameters (a bucket of the port's, copied into the JAX
    package's tree) the two probes' rows agree within 1e-6: the same
    embeddings, SVC grid and best-(acc and auc) rule."""
    from multimodalautoencoder_tpu.models import mmae as jax_mmae
    from multimodalautoencoder_tpu.parallel import grid_trainer as jax_gt
    from multimodalautoencoder_tpu_torch.models import mmae as port_mmae

    path = study(tmp_path)
    grid = dict(GRID, layer_sizes=[[12, 6]], tie_weights=[True],
                test_variational=False)
    unsup, sup = loaders(path, jax_side=True)
    js = jax_wrappers.MMAESweep(
        unsup, classification_data_loader=sup, num_steps=2,
        num_cross_folds=2, results_path=str(tmp_path / "jax"),
        verbose=False, backend="xla", probe="svm", **grid)
    js.sweep_all_parameters()
    jax_df = pd.read_csv(js.ledger.path, index_col=0)

    pu, ps = loaders(path)
    port = wrappers.MMAESweep(
        pu, classification_data_loader=ps, num_steps=2, num_cross_folds=2,
        results_path=str(tmp_path / "port"), verbose=False, backend="xla",
        probe="svm", device="cpu", **grid)
    port.sweep_all_parameters()
    assert port.ledger.columns == list(jax_df.columns)
    assert [r["weight_penalty"] for r in port.ledger.rows] == list(
        jax_df["weight_penalty"])
    assert port.svm_probe_errors == 0
    for col in ("svm_val_acc", "svm_val_auc"):
        assert all(0.0 <= r[col] <= 1.0 for r in port.ledger.rows)

    bucket = port.list_of_param_settings
    st = port._launch_bucket(0, bucket)
    cfg = js._cfg_for_bucket(bucket[0])
    # the port's trained (configs, folds) stack in the JAX package's tree
    treedef = jax.tree_util.tree_structure(
        jax_mmae.init(jax.random.PRNGKey(0), cfg))
    jparams = jax.tree_util.tree_unflatten(
        treedef, port_mmae.params_to_numpy(st["params"]))
    jhyper = jax_gt.HyperStack.from_settings(bucket, cfg, js.tcfg)
    want = js._svm_probe_bucket(jparams, cfg, jhyper, len(bucket))
    got = port._svm_probe_bucket(st["params"], st["cfg"], st["hyper"],
                                 len(bucket))
    assert len(got) == len(want) == len(bucket)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        np.testing.assert_allclose([g[k] for k in g], [w[k] for k in w],
                                   rtol=0, atol=1e-6)
