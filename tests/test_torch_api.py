"""The port's ``MultimodalAutoencoder`` facade and ``cli train`` against the
JAX package's, on the CPU.

- curves, predict, embeddings and per-modality RMSE: the port's facade on
  the JAX facade's parameters gives the JAX facade's numbers (f32
  tolerance, 1e-5);
- checkpoints with optimizer state cross-load both ways (Adam moments and
  step restored exactly), and a port run resumes step for step: N steps,
  save, load, N steps equals 2N steps, bit for bit;
- the two-phase path, the predictions frame, the headless plots, and
  ``cli train``;
- the loader's getters and ``device_arrays``, and the missing-modality
  fill, against the JAX package's.

Inputs come from seeded synthetic studies (``data/synthetic``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalautoencoder_tpu import api as jax_api
from multimodalautoencoder_tpu.data.loader import DataLoader as JaxLoader
from multimodalautoencoder_tpu.ops import masking as jax_masking
from multimodalautoencoder_tpu_torch import api, cli
from multimodalautoencoder_tpu_torch.config import MMAEConfig
from multimodalautoencoder_tpu_torch.data import synthetic
from multimodalautoencoder_tpu_torch.data.loader import DataLoader
from multimodalautoencoder_tpu_torch.models import mmae
from multimodalautoencoder_tpu_torch.ops import masking, optim
from multimodalautoencoder_tpu_torch.train import checkpoint as ckpt

LABELS = ("happy_label", "calm_label")
KW = dict(layer_sizes=(16, 8), variational=False, tie_weights=True,
          learning_rate=1e-3, batch_size=8, verbose=False,
          normalize_and_fill=True, fill_gaps_with=-1.0)


def study(tmp_path, name="f.csv", rows=160):
    path = str(tmp_path / name)
    synthetic.make_frame(num_rows=rows, seed=9,
                         label_names=LABELS).to_csv(path)
    return path


def facades(path, tmp_path, head=None, **kw):
    """The port's and the JAX package's facade on one study, each with its
    own checkpoint directory; ``head`` adds a classification head and
    loader."""
    kw = dict(KW, **kw)
    out = []
    for mod, loader, sub in ((api, DataLoader, "port"),
                             (jax_api, JaxLoader, "jax")):
        extra = {"device": "cpu"} if mod is api else {}
        if head is not None:
            extra.update(classification_layer_sizes=head,
                         classification_data_loader=loader(
                             path, supervised=True, normalize_and_fill=True,
                             fill_gaps_with=-1.0, suppress_output=True))
        out.append(mod.MultimodalAutoencoder(
            filename=path, checkpoint_dir=str(tmp_path / sub), **kw,
            **extra))
    return out


def jax_params_into_port(jm, pm):
    """The port facade takes the JAX facade's parameters."""
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jm.params)]
    pm.state = pm.state._replace(params=mmae.params_from_numpy(
        leaves, pm.cfg, device="cpu"))


def test_facade_evaluations_match_jax_on_the_same_params(tmp_path):
    path = study(tmp_path)
    pm, jm = facades(path, tmp_path)
    assert pm.cfg == type(pm.cfg)(**{
        f: getattr(jm.cfg, f) for f in pm.cfg.__dataclass_fields__})
    jm.train(num_steps=30, record_every_nth=10)
    jax_params_into_port(jm, pm)
    X = pm.data_loader.val_X
    np.testing.assert_array_equal(X, jm.data_loader.val_X)
    recon, loss = pm.predict(X)
    j_recon, j_loss = jm.predict(X)
    np.testing.assert_allclose(recon, j_recon, rtol=1e-5, atol=1e-5)
    assert loss == pytest.approx(j_loss, rel=1e-5)
    np.testing.assert_allclose(pm.get_reconstruction_loss_per_modality(X),
                               jm.get_reconstruction_loss_per_modality(X),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pm.get_embedding(X), jm.get_embedding(X),
                               rtol=1e-5, atol=1e-5)
    assert pm.test_on_validation() == pytest.approx(jm.test_on_validation(),
                                                    rel=1e-5)
    noisy = pm.get_performance_on_data_with_noise(X)
    again = pm.get_performance_on_data_with_noise(X)
    assert np.isfinite(noisy) and noisy != again


def test_facade_curves_follow_the_record_cadence(tmp_path):
    path = study(tmp_path)
    pm, jm = facades(path, tmp_path)
    for m in (pm, jm):
        m.train(num_steps=25, record_every_nth=10)
        m.train(num_steps=10)
    assert len(pm.train_loss) == len(jm.train_loss) == 3 + 1
    assert len(pm.val_loss) == len(jm.val_loss)
    assert np.isfinite(pm.val_loss).all()
    assert int(pm.state.step) == int(jm.state.step) == 35


def test_port_checkpoint_restores_moments_in_the_jax_facade(tmp_path):
    """Phase-1 and phase-2 Adam moments and steps of a port checkpoint
    restore in the JAX facade's load_saved_model; so do params and
    curves."""
    path = study(tmp_path)
    pm, jm = facades(path, tmp_path, head=(4,))
    pm.train(num_steps=20, record_every_nth=10)
    pm.train_classification(num_steps=12)
    saved = pm.save_model(directory=str(tmp_path / "ck"))
    names = ckpt.saved_state_names(saved)
    assert names == ("cls_opt", "cls_opt_generator", "opt",
                     "opt_generator")
    jm.load_saved_model(directory=str(tmp_path / "ck"))
    for port_state, jax_state in ((pm.state, jm.state),
                                  (pm._cls_state, jm._cls_state)):
        assert int(jax_state.step) == int(port_state.step)
        want = [t.numpy() for t in optim.tree_leaves(port_state.opt_state)]
        got = [np.asarray(a)
               for a in jax.tree_util.tree_leaves(jax_state.opt_state)]
        assert len(want) == len(got)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(mmae.params_to_numpy(pm.params),
                    jax.tree_util.tree_leaves(jm.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert jm.train_loss == pytest.approx(pm.train_loss)
    assert jm.val_acc == pytest.approx(pm.val_acc)
    jm.train(num_steps=10)     # and training goes on from it
    assert int(jm.state.step) == 30


def test_jax_checkpoint_restores_moments_in_the_port(tmp_path):
    """A JAX checkpoint's moments and step restore in the port; its key
    cannot drive the port's generator, which starts from the seed."""
    path = study(tmp_path)
    pm, jm = facades(path, tmp_path)
    jm.train(num_steps=20, record_every_nth=10)
    jm.save_model()
    pm.load_saved_model(directory=jm.checkpoint_dir)
    assert int(pm.state.step) == int(jm.state.step) == 20
    for a, b in zip(jax.tree_util.tree_leaves(jm.state.opt_state),
                    optim.tree_leaves(pm.state.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    fresh = torch.Generator().manual_seed(pm.seed)
    assert torch.equal(pm.state.generator.get_state(), fresh.get_state())
    assert pm.val_loss == pytest.approx(jm.val_loss)


def test_port_resume_is_step_exact(tmp_path):
    """N steps, save, load into a fresh facade, N steps: the same
    parameters, moments and curves as 2N steps in one go, bit for bit, in
    both phases."""
    path = study(tmp_path)
    kw = dict(KW, checkpoint_dir=str(tmp_path / "ck"), device="cpu",
              classification_layer_sizes=(4,))

    def make():
        return api.MultimodalAutoencoder(
            filename=path, classification_data_loader=DataLoader(
                path, supervised=True, normalize_and_fill=True,
                fill_gaps_with=-1.0, suppress_output=True), **kw)

    whole = make()
    whole.train(num_steps=40, record_every_nth=10)
    whole.train_classification(num_steps=20)
    whole.train_classification(num_steps=20)
    half = make()
    half.train(num_steps=20, record_every_nth=10)
    half.save_model()
    resumed = make()
    resumed.load_saved_model()
    resumed.train(num_steps=20, record_every_nth=10)
    resumed.train_classification(num_steps=20)
    resumed.save_model()
    again = make()
    again.load_saved_model()
    again.train_classification(num_steps=20, record_every_nth=10)
    for a, b in zip(mmae.params_to_numpy(whole.params),
                    mmae.params_to_numpy(again.params)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(optim.tree_leaves(whole._cls_state.opt_state),
                    optim.tree_leaves(again._cls_state.opt_state)):
        assert torch.equal(a, b)
    assert whole.train_loss == again.train_loss
    assert whole.val_loss == again.val_loss
    assert whole.classification_val_loss == again.classification_val_loss
    assert whole.val_acc == again.val_acc


def test_restore_refuses_another_optimizer_or_moment_dtype(tmp_path):
    """A state saved under another optimizer tag, structure or moment
    dtype is refused (ValueError), and the facade falls back to fresh
    slots around the loaded parameters."""
    path = study(tmp_path)
    pm = api.MultimodalAutoencoder(filename=path, device="cpu",
                                   checkpoint_dir=str(tmp_path / "ck"), **KW)
    pm.train(num_steps=10)
    saved = pm.save_model()
    template = (pm.state.opt_state, pm.state.step, torch.zeros(2, dtype=torch.uint32))
    assert ckpt.restore_state(saved, "missing", template) is None
    with pytest.raises(ValueError, match="tag"):
        ckpt.restore_state(saved, "opt", template, expect_tag="sgd")
    bf16 = optim.opt_init("adam", pm.params, torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        ckpt.restore_state(saved, "opt", (bf16, pm.state.step,
                                          torch.zeros(2, dtype=torch.uint32)))
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_state(saved, "opt", (pm.state.opt_state,))
    restored = ckpt.restore_state(saved, "opt", template, expect_tag="adam")
    for a, b in zip(optim.tree_leaves(restored[0]),
                    optim.tree_leaves(pm.state.opt_state)):
        assert torch.equal(a, b)
    other = api.MultimodalAutoencoder(filename=path, device="cpu",
                                      checkpoint_dir=str(tmp_path / "ck"),
                                      **KW)
    other.tcfg = other.tcfg.replace(optimizer="sgd")
    other.load_saved_model()
    assert int(other.state.step) == 0


def test_bf16_moments_round_trip(tmp_path):
    """bfloat16 Adam moments are stored as uint16 views, as the JAX package
    stores them, and come back bit for bit."""
    path = study(tmp_path)
    pm = api.MultimodalAutoencoder(filename=path, device="cpu",
                                   checkpoint_dir=str(tmp_path / "ck"), **KW)
    pm.tcfg = pm.tcfg.replace(optimizer_state_dtype="bfloat16")
    pm.rebuild_reinitialize()
    pm.train(num_steps=10)
    saved = pm.save_model()
    meta = ckpt.checkpoint_meta(saved)
    assert meta["states"]["opt"]["bf16"]
    restored = ckpt.restore_state(saved, "opt", (
        pm.state.opt_state, pm.state.step, torch.zeros(2, dtype=torch.uint32)))
    for a, b in zip(optim.tree_leaves(restored[0]),
                    optim.tree_leaves(pm.state.opt_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_two_phase_predictions_and_frame(tmp_path):
    path = study(tmp_path)
    pm, jm = facades(path, tmp_path, head=(4,))
    pm.train(num_steps=10)
    pm.train_classification(num_steps=30, record_every_nth=10)
    assert len(pm.val_acc) == len(pm.classification_train_loss) == 3
    assert np.isfinite(pm.classification_val_loss).all()
    jm.train(num_steps=10)
    jm.train_classification(num_steps=10)
    jax_params_into_port(jm, pm)
    X = pm.classification_data_loader.val_X
    np.testing.assert_array_equal(pm.get_classification_predictions(X),
                                  jm.get_classification_predictions(X))
    frame = pm.get_classification_predictions_from_df()
    df = jm.get_classification_predictions_from_df()
    for label in LABELS:
        np.testing.assert_array_equal(
            frame.columns["predictions_" + label],
            df["predictions_" + label].to_numpy(dtype=float))
    assert frame.names[-2:] == [f"predictions_{lb}" for lb in LABELS]


def test_headless_plots(tmp_path):
    path = study(tmp_path)
    pm = api.MultimodalAutoencoder(
        filename=path, device="cpu", checkpoint_dir=str(tmp_path / "ck"),
        classification_layer_sizes=(4,),
        classification_data_loader=DataLoader(
            path, supervised=True, normalize_and_fill=True,
            fill_gaps_with=-1.0, suppress_output=True), **KW)
    pm.train(num_steps=20, record_every_nth=5)
    pm.train_classification(num_steps=10, record_every_nth=5)
    for name, call in (
            ("curves", pm.plot_training_progress),
            ("cls", pm.plot_classification_training_progress),
            ("recon", lambda **kw: pm.view_reconstruction(
                pm.data_loader.val_X, **kw))):
        out = str(tmp_path / f"{name}.png")
        call(show=False, save_path=out)
        assert os.path.getsize(out) > 0


def test_cli_train_on_the_cpu_and_its_refusal(tmp_path, monkeypatch,
                                              capsys):
    path = study(tmp_path)
    args = ["train", path, "--arch", "16", "8", "--num-steps", "20",
            "--normalize-and-fill", "--checkpoint-dir",
            str(tmp_path / "ck")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(args)
    assert cli.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    saved = out.strip().splitlines()[-1].split("checkpoint: ")[-1]
    params, cfg, curves, step = ckpt.load_checkpoint_auto(
        saved, MMAEConfig(), verbose=False, device="cpu")
    assert cfg.layer_sizes == (16, 8) and not cfg.variational
    assert step == 50 and len(curves["val_loss"]) == 1
    assert ckpt.saved_state_names(saved) == ("opt", "opt_generator")


# -- data for the facade ---------------------------------------------------

def test_loader_getters_match_jax(tmp_path):
    path = study(tmp_path)
    kw = dict(supervised=True, normalize_and_fill=True, fill_gaps_with=-1.0,
              suppress_output=True, seed=4)
    pl, jl = DataLoader(path, **kw), JaxLoader(path, **kw)
    for a, b in zip(pl.get_noisy_clean_data_for_dataset("Test"),
                    jl.get_noisy_clean_data_for_dataset("Test")):
        np.testing.assert_array_equal(a, b)
    for noisy in (True, False):
        for a, b in zip(pl.get_noisy_or_clean_data_matrices(pl.frame, noisy),
                        jl.get_noisy_or_clean_data_matrices(jl.df, noisy)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(pl.get_val_data(), jl.get_val_data()):
        np.testing.assert_array_equal(a, b)
    assert pl.get_feature_size() == jl.get_feature_size() == 30
    # the batch getters draw from the same numpy stream as the JAX loader's
    np.testing.assert_array_equal(pl.get_unsupervised_train_batch(7),
                                  jl.get_unsupervised_train_batch(7))
    for a, b in zip(pl.get_supervised_val_batch(5),
                    jl.get_supervised_val_batch(5)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pl.get_supervised_train_batch(3),
                    jl.get_supervised_train_batch(3)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pl.get_unsupervised_val_batch(4),
                                  jl.get_unsupervised_val_batch(4))
    got, want = pl.device_arrays("cpu"), jl.device_arrays()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_missing_modality_fill_matches_jax():
    rng = np.random.default_rng(3)
    masks = np.zeros((3, 9), bool)
    masks[0, :3], masks[1, 3:5], masks[2, 5:] = True, True, True
    x = rng.random((6, 9)).astype(np.float32)
    x[1, :3] = -1.0
    x[4, 5:] = -1.0
    x[2, 3] = -1.0          # one -1 cell is not a missing modality
    recon = rng.random((6, 9)).astype(np.float32)
    want_m = jax_masking.missing_modality_matrix(jnp.asarray(x),
                                                 jnp.asarray(masks))
    got_m = masking.missing_modality_matrix(torch.from_numpy(x),
                                            torch.from_numpy(masks))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    want = jax_masking.fill_missing_with_reconstruction(
        jnp.asarray(x), jnp.asarray(recon), jnp.asarray(masks))
    got = masking.fill_missing_with_reconstruction(
        torch.from_numpy(x), torch.from_numpy(recon), torch.from_numpy(masks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_m.sum() == 2
