"""The port's classification sweep against the JAX package: the supervised
DataLoader, the results ledger in both directions, and a small
``cli sweep-classification`` run on the CPU beside the JAX sweep on the
same study."""

import functools
import math

import jax  # the JAX package runs on the CPU here
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from multimodalautoencoder_tpu.data.loader import DataLoader as JaxLoader
from multimodalautoencoder_tpu.sweep import engine as jax_engine
from multimodalautoencoder_tpu.sweep import wrappers as jax_wrappers
from multimodalautoencoder_tpu_torch import cli
from multimodalautoencoder_tpu_torch.data import synthetic
from multimodalautoencoder_tpu_torch.data.loader import DataLoader
from multimodalautoencoder_tpu_torch.sweep import engine, wrappers

LABELS = ("happy_label", "calm_label")


def study(tmp_path, name="s.csv", rows=120, blank_label_rows=()):
    path = str(tmp_path / name)
    frame = synthetic.make_frame(num_rows=rows, seed=3, label_names=LABELS)
    for r in blank_label_rows:
        frame.columns["calm_label"] = frame.columns["calm_label"].copy()
        frame.columns["calm_label"][r] = float("nan")
    frame.to_csv(path)
    return path


@pytest.mark.parametrize("kw", [
    dict(),
    dict(wanted_label="calm_label"),
    dict(labels_to_sign=True),
    dict(cross_validation=False),
])
def test_supervised_loader_matches_jax(tmp_path, kw):
    """Same labels, noisy/clean splits and fold splits as the JAX loader
    on one CSV (two rows lack a label and are dropped)."""
    path = study(tmp_path, blank_label_rows=(3, 17))
    common = dict(supervised=True, cross_validation=True,
                  fill_gaps_with=-1.0, suppress_output=True)
    common.update(kw)
    jl = JaxLoader(path, **common)      # persists the folds first
    pl = DataLoader(path, **common)
    assert pl.wanted_labels == jl.wanted_labels
    assert (pl.num_labels, pl.num_classes) == (jl.num_labels, jl.num_classes)
    pairs = [("test_X", "test_Y"), ("clean_test_X", "clean_test_Y"),
             ("noisy_test_X", "noisy_test_Y")]
    if kw.get("cross_validation", True):
        for f in range(5):
            for a, b in zip(pl.get_cross_val_data_for_fold(f),
                            jl.get_cross_val_data_for_fold(f)):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(
                pl.get_cross_val_noisy_flags_for_fold(f),
                jl.get_cross_val_noisy_flags_for_fold(f))
        pl.set_to_cross_validation_fold(2)
        jl.set_to_cross_validation_fold(2)
    pairs += [("train_X", "train_Y"), ("val_X", "val_Y"),
              ("noisy_val_X", "noisy_val_Y"), ("clean_train_X",
                                               "clean_train_Y")]
    for names in pairs:
        for name in names:
            np.testing.assert_array_equal(getattr(pl, name),
                                          getattr(jl, name), err_msg=name)


def ledger_rows():
    return [
        {"mmae_architecture": [16, 6], "classification_layers": [],
         "tie_weights": True, "weight_penalty": 0, "dropout_prob": 0.5,
         "activation_func": "relu", "val_acc": 0.75, "val_auc": float("nan"),
         "note": None},
        {"mmae_architecture": [16, 6], "classification_layers": [8, 4],
         "tie_weights": False, "weight_penalty": 0.001, "dropout_prob": 1.0,
         "activation_func": "relu", "val_acc": 0.8125, "val_auc": 0.5},
    ]


def jax_row_dict(series):
    return {k: (None if isinstance(v, float) and math.isnan(v) else v)
            for k, v in series.to_dict().items()}


def test_ledger_written_by_port_reads_in_jax(tmp_path):
    led = engine.ResultsLedger(str(tmp_path), "L")
    for r in ledger_rows():
        led.append(r)
    back = jax_engine.ResultsLedger(str(tmp_path), "L", cont=True)
    assert len(back) == 2 and list(back.df.columns) == led.columns
    for r in ledger_rows():
        setting = {k: r.get(k) for k in ("mmae_architecture",
                                     "classification_layers", "tie_weights",
                                     "weight_penalty", "dropout_prob",
                                     "activation_func", "note")}
        assert back.already_done(setting)
    assert not back.already_done({"dropout_prob": 0.25})
    best = back.find_best_setting("val_acc", "max")
    assert best["val_acc"] == 0.8125
    assert jax_row_dict(back.df.iloc[0])["classification_layers"] == "[]"
    pd.testing.assert_frame_equal(back.df, pd.read_csv(led.path,
                                                       index_col=0))


def test_ledger_written_by_jax_reads_in_port(tmp_path):
    led = jax_engine.ResultsLedger(str(tmp_path), "L")
    for r in ledger_rows():
        led.append(r)
    back = engine.ResultsLedger(str(tmp_path), "L", cont=True)
    assert back.started_from == 2 and back.columns == list(led.df.columns)
    for r in ledger_rows():
        setting = {k: v for k, v in r.items()
                   if k not in ("val_acc", "val_auc")}
        assert back.already_done(setting)
        assert back.lookup(setting)["val_acc"] == r["val_acc"]
    assert back.find_best_setting("val_auc", "max")["val_acc"] == 0.8125
    assert back.find_best_setting("val_acc", "min")["dropout_prob"] == 0.5
    # resuming and flushing again keeps the file the JAX ledger reads
    back.append({"dropout_prob": 0.25, "val_acc": 0.5})
    again = jax_engine.ResultsLedger(str(tmp_path), "L", cont=True)
    assert len(again) == 3
    assert again.already_done({"dropout_prob": 0.25})
    assert again.already_done({"classification_layers": [8, 4]})


GRID = dict(mmae_layer_sizes=[[16, 6]],
            classification_layer_sizes=[[8], [8, 4]], tie_weights=[True],
            mmae_dropout_probs=[1.0, 0.5], mmae_weight_penalties=[0.01],
            mmae_test_variational=[False], weight_penalties=[0.0],
            dropout_probs=[0.5])


def test_cli_sweep_classification_matches_jax_ledger(tmp_path, monkeypatch,
                                                     capsys):
    """A tiny two-bucket sweep through ``cli sweep-classification --device
    cpu --backend xla``: the JAX sweep's ledger columns on the same study,
    a resumed run that skips every setting, and the best setting."""
    path = study(tmp_path)
    monkeypatch.setattr(
        wrappers, "MMAEClassificationSweep",
        functools.partial(wrappers.MMAEClassificationSweep, verbose=False,
                          **GRID))
    args = ["sweep-classification", path, path, "--num-steps", "5",
            "--folds", "2", "--device", "cpu", "--backend", "xla",
            "--normalize-and-fill", "--results-path",
            str(tmp_path / "port")]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    ledger = str(tmp_path / "port" / "MMAE_NN_classifier-s.csv")
    port = pd.read_csv(ledger, index_col=0)
    assert len(port) == 4 and set(port["backend_used"]) == {"xla"}
    assert np.isfinite(port["val_acc"]).all()
    best = port.loc[port["val_acc"].idxmax()]
    assert f"val_acc -> {float(best['val_acc'])}" in out

    unsup = JaxLoader(path, supervised=False, cross_validation=True,
                      normalize_and_fill=True, fill_gaps_with=-1.0,
                      suppress_output=True)
    sup = JaxLoader(path, supervised=True, cross_validation=True,
                    normalize_and_fill=True, fill_gaps_with=-1.0,
                    suppress_output=True)
    js = jax_wrappers.MMAEClassificationSweep(
        unsup, sup, mmae_num_steps=2, classification_num_steps=2,
        num_cross_folds=2, results_path=str(tmp_path / "jax"),
        verbose=False, backend="xla", **GRID)
    js.sweep_all_parameters()
    jax_df = pd.read_csv(js.ledger.path, index_col=0)
    assert list(port.columns) == list(jax_df.columns)
    for key in ("mmae_architecture", "classification_layers",
                "mmae_dropout_prob", "dropout_prob"):
        assert sorted(map(str, port[key])) == sorted(map(str, jax_df[key]))

    # the JAX ledger resumes from the port's file: every setting done
    jled = jax_engine.ResultsLedger(str(tmp_path / "port"),
                                    "MMAE_NN_classifier-s", cont=True)
    assert all(jled.already_done(s) for s in js.list_of_param_settings)

    assert cli.main(args + ["--continue"]) == 0
    assert len(pd.read_csv(ledger, index_col=0)) == 4
    capsys.readouterr()
    # --check-test retrains the best val_acc setting on fold 0 and prints
    # its held-out metric battery
    assert cli.main(args + ["--check-test"]) == 0
    tested = dict(line.split(" -> ") for line in
                  capsys.readouterr().out.splitlines()
                  if line.startswith("test "))
    assert 0.0 <= float(tested["test test_acc"]) <= 1.0


def _cls_loaders(path, jax_side=False):
    kw = dict(cross_validation=True, normalize_and_fill=True,
              fill_gaps_with=-1.0, suppress_output=True)
    cls = JaxLoader if jax_side else DataLoader
    return cls(path, supervised=False, **kw), cls(path, supervised=True,
                                                  **kw)


def test_unshared_phase1_matches_jax_settings_and_columns(tmp_path,
                                                          monkeypatch):
    """share_phase1=False: every setting pretrains its own MMAE through
    ``grid_trainer.train_two_phase_sharded`` (no family is shared), with
    the JAX sweep's settings and ledger columns."""
    from multimodalautoencoder_tpu_torch.parallel import grid_trainer

    path = study(tmp_path)
    calls = []
    inner = grid_trainer.train_two_phase_sharded

    def counting(*args, **kwargs):
        calls.append(args[7].num_configs)        # hyper
        return inner(*args, **kwargs)

    monkeypatch.setattr(grid_trainer, "train_two_phase_sharded", counting)
    kw = dict(mmae_num_steps=3, classification_num_steps=3,
              num_cross_folds=2, verbose=False, backend="xla",
              share_phase1=False, **GRID)
    unsup, sup = _cls_loaders(path)
    port = wrappers.MMAEClassificationSweep(
        unsup, sup, results_path=str(tmp_path / "port"), device="cpu", **kw)
    port.sweep_all_parameters()
    assert calls == [2, 2] and port._families == {}
    ju, js_ = _cls_loaders(path, jax_side=True)
    jax_sweep = jax_wrappers.MMAEClassificationSweep(
        ju, js_, results_path=str(tmp_path / "jax"), **kw)
    jax_sweep.sweep_all_parameters()
    assert port.list_of_param_settings == jax_sweep.list_of_param_settings
    assert port.ledger.columns == list(jax_sweep.ledger.df.columns)
    rows = port.ledger.rows
    assert len(rows) == 4 and {r["backend_used"] for r in rows} == {"xla"}
    assert all(np.isfinite(float(r["val_acc"])) for r in rows)
    # the pretraining differs per setting: two settings that share MMAE
    # hyperparameters still get their own phase-1 runs
    shared = wrappers.MMAEClassificationSweep(
        unsup, sup, results_path=str(tmp_path / "shared"), device="cpu",
        **dict(kw, share_phase1=True))
    calls.clear()
    shared.sweep_all_parameters()
    assert calls == []


def test_check_test_retrains_as_jax_and_scores_as_jax(tmp_path):
    """check_test's retrain config equals the JAX ``_retrain_fold0``'s field
    for field, and the test metrics of the retrained parameters equal the
    JAX package's forward, classify and metric battery on the same
    parameters."""
    import dataclasses

    from multimodalautoencoder_tpu.models import losses as jax_losses
    from multimodalautoencoder_tpu.models import mmae as jax_mmae
    from multimodalautoencoder_tpu.ops import metrics as jax_metrics
    from multimodalautoencoder_tpu_torch.models import mmae

    path = study(tmp_path)
    kw = dict(mmae_num_steps=4, classification_num_steps=4,
              num_cross_folds=2, verbose=False, backend="xla", **GRID)
    unsup, sup = _cls_loaders(path)
    port = wrappers.MMAEClassificationSweep(
        unsup, sup, results_path=str(tmp_path / "p"), device="cpu",
        check_test=True, **kw)
    ju, js_ = _cls_loaders(path, jax_side=True)
    jsw = jax_wrappers.MMAEClassificationSweep(
        ju, js_, results_path=str(tmp_path / "j"), **kw)
    setting = dict(port.list_of_param_settings[-1], val_acc=0.5)
    state, cfg, arr = port._retrain_fold0(setting)
    _, jcfg, _ = jsw._retrain_fold0(setting)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert int(state.step) == 4 and arr["test_x"].shape[0] == len(sup.test_X)

    got = port.test_metrics(state.params, cfg)
    params = jax.tree_util.tree_map(
        jnp.asarray, jax_mmae_params(mmae.params_to_numpy(state.params),
                                     jcfg))
    want = {}
    for name, X, Y in (("test", js_.test_X, js_.test_Y),
                       ("noisy_test", js_.noisy_test_X, js_.noisy_test_Y),
                       ("clean_test", js_.clean_test_X, js_.clean_test_Y)):
        out = jax_mmae.forward(params, jcfg, jnp.asarray(X, jnp.float32),
                               rng=jax.random.PRNGKey(1), keep_prob=1.0,
                               train=False)
        logits = jax_mmae.classify(params, jcfg, out.embedding,
                                   keep_prob=1.0, train=False)
        preds = np.asarray(jax_losses.classification_predictions(
            jcfg.classification_loss, logits)).reshape(-1)
        m = jax_metrics.all_classification_metrics(
            jnp.asarray(preds, jnp.float32),
            jnp.asarray(np.asarray(Y, float).reshape(-1), jnp.float32))
        if name == "test":
            want.update({f"test_{k}": float(v) for k, v in m.items()})
        else:
            want[f"{name.split('_')[0]}_test_acc"] = float(m["acc"])
            want[f"{name.split('_')[0]}_test_auc"] = float(m["auc"])
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k

    results = port.run()
    assert set(results["test"]) == set(want)


def jax_mmae_params(leaves, cfg):
    """A JAX params tree of ``cfg``'s structure holding ``leaves``."""
    from multimodalautoencoder_tpu.models import mmae as jax_mmae

    template = jax_mmae.init(jax.random.PRNGKey(0), cfg)
    treedef = jax.tree_util.tree_structure(template)
    return jax.tree_util.tree_unflatten(treedef, list(leaves))
