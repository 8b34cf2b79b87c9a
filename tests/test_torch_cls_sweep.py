"""The port's classification sweep against the JAX package: the supervised
DataLoader, the results ledger in both directions, and a small
``cli sweep-classification`` run on the CPU beside the JAX sweep on the
same study."""

import functools
import math

import jax  # noqa: F401  (the JAX package runs on the CPU here)
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
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        cli.main(args + ["--check-test"])
