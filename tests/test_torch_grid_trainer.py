"""The port's phase-1 grid trainer and the modules it needs, against the
JAX package: the plain ``train_grid`` against ``train_grid_jit`` in the
deterministic harness, CV folds from the same CSV, backend resolution,
corruption statistics, row-masked losses and the optimizers."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalautoencoder_tpu.config import MMAEConfig as JaxConfig
from multimodalautoencoder_tpu.config import TrainConfig as JaxTrainConfig
from multimodalautoencoder_tpu.data import synthetic as jax_synthetic
from multimodalautoencoder_tpu.data.loader import DataLoader as JaxLoader
from multimodalautoencoder_tpu.data.modalities import \
    ModalityTable as JaxTable
from multimodalautoencoder_tpu.models import mmae as jax_mmae
from multimodalautoencoder_tpu.models.corruption import \
    NoiseSpec as JaxNoiseSpec
from multimodalautoencoder_tpu.ops import masking as jax_masking
from multimodalautoencoder_tpu.ops import optim as jax_optim
from multimodalautoencoder_tpu.ops import train_kernel as tk
from multimodalautoencoder_tpu.parallel import grid_trainer as jgt
from multimodalautoencoder_tpu_torch.config import MMAEConfig, TrainConfig
from multimodalautoencoder_tpu_torch.data.loader import DataLoader
from multimodalautoencoder_tpu_torch.data.modalities import ModalityTable
from multimodalautoencoder_tpu_torch.models import mmae
from multimodalautoencoder_tpu_torch.models.corruption import (
    NoiseSpec, add_noise_to_batch)
from multimodalautoencoder_tpu_torch.ops import masking, optim
from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk
from multimodalautoencoder_tpu_torch.parallel import grid_trainer as pgt

NAMES = ("call", "location", "screen", "sms", "survey")


# ------------------------------------------------- plain train_grid

def test_plain_train_grid_matches_train_grid_jit_tied_bf16():
    check_train_grid(True, "bfloat16")


@pytest.mark.parametrize("tied, state_dtype", [(True, "float32"),
                                               (False, "float32")])
def test_plain_train_grid_matches_train_grid_jit(tied, state_dtype):
    check_train_grid(tied, state_dtype)


@pytest.mark.parametrize("tied, layer_sizes", [(True, (16, 10, 6)),
                                               (False, (20, 14, 10, 6))])
def test_plain_train_grid_matches_train_grid_jit_deep(tied, layer_sizes):
    """The plain trainer's generic ``total_loss`` at depth 3 and 4."""
    check_train_grid(tied, "float32", layer_sizes)


def check_train_grid(tied, state_dtype, layer_sizes=(16, 6)):
    """Two configs x two single-row folds, 3 steps with decay, no
    corruption, keep 1: every instance's parameters and noisy-val
    objective (tests/test_train_kernel.py:27-70 harness)."""
    kw = dict(num_feats=30, layer_sizes=layer_sizes, tie_weights=tied,
              element_dropout_frac=0.0,
              noise_type_percentages=(1.0, 0.0, 0.0, 0.0))
    tkw = dict(learning_rate=1e-2, batch_size=8, decay=True,
               clip_gradients=False, optimizer_state_dtype=state_dtype)
    settings = [{"dropout_prob": 1.0, "weight_penalty": 0.0,
                 "activation_function": "softsign"},
                {"dropout_prob": 1.0, "weight_penalty": 0.01,
                 "activation_function": "relu"}]
    rng = np.random.default_rng(0)
    X = [rng.random((1, 30)).astype(np.float32) for _ in range(2)]
    cj, tj = JaxConfig(**kw).validate(), JaxTrainConfig(**tkw)
    ct, tt = MMAEConfig(**kw).validate(), TrainConfig(**tkw)
    sj = JaxNoiseSpec.build(cj, JaxTable.uniform(5, 6, NAMES))
    st = NoiseSpec.build(ct, ModalityTable.uniform(5, 6, NAMES))
    pj, lj = jgt.train_grid_jit(
        jax.random.PRNGKey(0), cj, tj, sj,
        jgt.HyperStack.from_settings(settings, cj, tj),
        jgt.FoldedData.from_ragged(X, X), 3)

    # train_grid's per-instance init keys (:269-270, :339-345)
    inst = [jax.random.split(fk)[0]
            for ck in jax.random.split(jax.random.PRNGKey(0), 2)
            for fk in jax.random.split(ck, 2)]
    p0 = jax.vmap(lambda k: jax_mmae.init(k, cj))(jnp.stack(inst))
    p0 = jax.tree_util.tree_map(lambda a: a.reshape((2, 2) + a.shape[1:]),
                                p0)
    pt, lt = pgt.train_grid(
        0, ct, tt, st, pgt.HyperStack.from_settings(settings, ct, tt),
        pgt.FoldedData.from_ragged(X, X, device="cpu"), 3,
        params0=mmae.stacked_params_from_numpy(
            jax.tree_util.tree_leaves(p0), ct, "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(pj), mmae.params_to_numpy(pt)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)


def test_grid_sharded_pallas_on_cpu_is_the_twin():
    """On the CPU, backend='pallas' runs the kernels' twin with the (C, K)
    layout of the plain backend."""
    cfg = MMAEConfig(num_feats=30, layer_sizes=(16, 6)).validate()
    tcfg = TrainConfig(batch_size=4, clip_gradients=False)
    spec = NoiseSpec.build(cfg, ModalityTable.uniform(5, 6, NAMES))
    hyper = pgt.HyperStack.from_settings(
        [{"dropout_prob": 0.5}, {"dropout_prob": 1.0}, {}], cfg, tcfg)
    rng = np.random.default_rng(0)
    folded = pgt.FoldedData.from_ragged(
        [rng.random((9, 30)), rng.random((6, 30))],
        [rng.random((3, 30)), rng.random((4, 30))], device="cpu")
    params, losses = pgt.train_grid_sharded(
        "cpu", 0, cfg, tcfg, spec, hyper, folded, num_steps=3,
        backend="pallas")
    assert params.enc_w[0].shape == (3, 2, 30, 16)
    assert params.dec_w == () and params.dec_b[1].shape == (3, 2, 30)
    assert losses.shape == (3, 2) and torch.isfinite(losses).all()
    again, losses2 = ptk.train_grid_pallas(0, cfg, tcfg, spec, hyper,
                                           folded, 3)
    assert torch.equal(losses, losses2)
    assert torch.equal(params.enc_w[0], again.enc_w[0])


# --------------------------------------------- folds from the loader

def test_cross_val_folds_match_jax_loader(tmp_path):
    path_j = str(tmp_path / "jax.csv")
    jax_synthetic.write_csv(path_j, num_rows=300, seed=3)
    path_t = str(tmp_path / "port.csv")
    shutil.copy(path_j, path_t)
    kw = dict(suppress_output=True, cross_validation=True,
              fill_gaps_with=-1.0, seed=5)
    dj = JaxLoader(path_j, supervised=False, **kw)
    dt = DataLoader(path_t, supervised=False, **kw)
    np.testing.assert_array_equal(
        dt.fold_ids(), dj.df["logistics_cv_fold"].to_numpy())
    # the fold column went back to the file, in the raw row order
    np.testing.assert_array_equal(
        pd.read_csv(path_t, index_col=0)["logistics_cv_fold"].to_numpy(),
        pd.read_csv(path_j, index_col=0)["logistics_cv_fold"].to_numpy())
    np.testing.assert_array_equal(dt.train_X, dj.train_X)
    np.testing.assert_array_equal(dt.val_X, dj.val_X)
    np.testing.assert_array_equal(dt.test_X, dj.test_X)

    fj = jgt.FoldedData.from_loader(dj, 5)
    ft = pgt.FoldedData.from_loader(dt, 5, device="cpu")
    for name in ("train_x", "train_n", "val_x", "val_n"):
        np.testing.assert_array_equal(getattr(ft, name).numpy(),
                                      np.asarray(getattr(fj, name)))
    # a second load with another seed (another shuffle) reads the
    # persisted folds instead of drawing new ones
    again = DataLoader(path_t, supervised=False, **dict(kw, seed=9))

    def by_row(loader):
        return loader.fold_ids()[np.argsort(
            loader.frame.index.astype(int))]

    np.testing.assert_array_equal(by_row(again), by_row(dt))
    dt.set_to_cross_validation_fold(3)
    dj.set_to_cross_validation_fold(3)
    np.testing.assert_array_equal(dt.val_X, dj.val_X)


def test_hyper_stack_matches_jax():
    cfg, tcfg = MMAEConfig(num_feats=10), TrainConfig()
    settings = [{"learning_rate": 0.1, "activation_func": "relu"},
                {"dropout_prob": 0.5, "weight_penalty": 0.01},
                {"activation_function": "softplus"}]
    hj = jgt.HyperStack.from_settings(settings, JaxConfig(num_feats=10),
                                      JaxTrainConfig())
    ht = pgt.HyperStack.from_settings(settings, cfg, tcfg)
    for name in ("lr", "keep_prob", "weight_penalty", "act_id"):
        a, b = np.asarray(getattr(hj, name)), getattr(ht, name).numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    assert ht.num_configs == 3


# ------------------------------------------------ backend resolution

def _family(jax_mod, cfg_cls, tcfg_cls, spec_cls, table_cls):
    cfg = cfg_cls(num_feats=30, layer_sizes=(16, 6), tie_weights=True,
                  element_dropout_frac=0.0).validate()
    tcfg = tcfg_cls(batch_size=8, clip_gradients=False)
    spec = spec_cls.build(cfg, table_cls.uniform(5, 6, NAMES))
    return cfg, tcfg, spec


CASES = {
    "tied": lambda c, t: (c, t),
    "vae": lambda c, t: (c.replace(variational=True, tie_weights=False), t),
    "mean_squared": lambda c, t: (c.replace(loss="mean_squared",
                                            normalization="z_score"), t),
    "untied_1000": lambda c, t: (c.replace(num_feats=1000,
                                           layer_sizes=(1000, 100),
                                           tie_weights=False), t),
    "sgd": lambda c, t: (c, t.replace(optimizer="sgd")),
    "clipped": lambda c, t: (c, t.replace(clip_gradients=True)),
    "head": lambda c, t: (c.replace(classification_layer_sizes=(4,),
                                    num_labels=2).validate(), t),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_supported_and_resolve_backend_match_jax(case):
    """Depth-2 answers of tests/test_train_kernel.py:109-140 and :215-242
    (not the VMEM-budget ones: the port has no VMEM budget)."""
    cj, tj, sj = _family(tk, JaxConfig, JaxTrainConfig, JaxNoiseSpec,
                         JaxTable)
    ct, tt, st = _family(ptk, MMAEConfig, TrainConfig, NoiseSpec,
                         ModalityTable)
    cj, tj = CASES[case](cj, tj)
    ct, tt = CASES[case](ct, tt)
    assert ptk.supported(ct, tt, st) == tk.supported(cj, tj, sj)
    for on in (True, False):
        assert pgt.resolve_backend("auto", ct, tt, st, on_gpu=on) == \
            jgt.resolve_backend("auto", cj, tj, sj, on_tpu=on)
    for name in ("xla", "pallas"):
        assert pgt.resolve_backend(name, ct, tt, st, on_gpu=True) == name


def test_depth3_and_budget_cases_stay_off_the_kernel():
    """Depth >= 3 is the deep family now (ops/train_deep_kernels.py), so
    'auto' takes the kernels on a GPU and 'pallas' runs the deep twin on
    the CPU; depth 1 stays off every kernel.  Shapes the JAX kernels refuse
    only for VMEM (untied 2000 -> 100, and at depth 3 untied 1000 -> 500
    -> 100) are in the port's family."""
    ct, tt, st = _family(ptk, MMAEConfig, TrainConfig, NoiseSpec,
                         ModalityTable)
    deep = ct.replace(layer_sizes=(8, 4, 2))
    assert ptk.supported(deep, tt, st)
    assert pgt.resolve_backend("auto", deep, tt, st, on_gpu=True) == "pallas"
    assert pgt.resolve_backend("auto", deep, tt, st, on_gpu=False) == "xla"
    shallow = ct.replace(layer_sizes=(8,))
    assert not ptk.supported(shallow, tt, st)
    assert pgt.resolve_backend("auto", shallow, tt, st,
                               on_gpu=True) == "xla"
    assert ptk.supported(ct.replace(num_feats=2000, layer_sizes=(2000, 100),
                                    tie_weights=False), tt, st)
    assert ptk.supported(ct.replace(num_feats=1000,
                                    layer_sizes=(1000, 500, 100),
                                    tie_weights=False), tt, st)
    hyper = pgt.HyperStack.from_settings([{}], deep, tt)
    X = np.ones((2, 30), np.float32)
    folded = pgt.FoldedData.from_ragged([X], [X], device="cpu")
    for backend in ("pallas", "auto"):
        params, losses = pgt.train_grid_sharded("cpu", 0, deep, tt, st,
                                                hyper, folded, 1,
                                                backend=backend)
        assert params.enc_w[2].shape == (1, 1, 4, 2)
        assert torch.isfinite(losses).all()
    with pytest.raises(ValueError, match="family"):
        pgt.train_grid_sharded("cpu", 0, shallow, tt, st, hyper, folded, 1,
                               backend="pallas")


# ------------------------------------------------------- corruption

TABLE = ModalityTable.from_feature_names(
    [f"{m}_f{i}" for m in NAMES for i in range(10)])


def spec_of(**kw):
    return NoiseSpec.build(MMAEConfig(num_feats=50, **kw).validate(), TABLE)


def test_noise_spec_matches_jax():
    for kw in ({}, {"intelligent_noise": False}):
        st = spec_of(**kw)
        sj = JaxNoiseSpec.build(JaxConfig(num_feats=50, **kw).validate(),
                                JaxTable.from_feature_names(
                                    [f"{m}_f{i}" for m in NAMES
                                     for i in range(10)]))
        for name in ("type_masks", "modality_masks"):
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          np.asarray(getattr(sj, name)))
        # float32 logs of the same probabilities, each library's log
        np.testing.assert_allclose(st.type_log_probs.numpy(),
                                   np.asarray(sj.type_log_probs), rtol=1e-6)
        for name in ("num_element_drops", "num_modalities_to_drop",
                     "intelligent"):
            assert getattr(st, name) == getattr(sj, name)
        assert st.mask_with == float(sj.mask_with)


def test_element_dropout_rate():
    spec = spec_of(intelligent_noise=False, num_modalities_to_drop=0)
    assert spec.num_element_drops == 2
    noisy = add_noise_to_batch(torch.Generator().manual_seed(0),
                               torch.ones((2000, 50)), spec)
    rate = float((noisy == 0).float().mean())
    # 2 draws with replacement out of 50: E = 1-(1-1/50)^2 ~ 3.96 %
    assert abs(rate - (1 - (1 - 1 / 50) ** 2)) < 0.003


def test_uniform_modality_drop():
    spec = spec_of(intelligent_noise=False, num_modalities_to_drop=1,
                   element_dropout_frac=0.0)
    noisy = add_noise_to_batch(torch.Generator().manual_seed(1),
                               torch.ones((3000, 50)), spec).numpy()
    per_row = np.stack([(noisy[:, s:e] == -1.0).all(axis=1)
                        for s, e in (TABLE.span(m) for m in range(5))], 1)
    assert (per_row.sum(axis=1) == 1).all()
    assert np.all(np.abs(per_row.mean(axis=0) - 0.2) < 0.04)


def test_intelligent_noise_distribution():
    spec = spec_of(element_dropout_frac=0.0)
    noisy = add_noise_to_batch(torch.Generator().manual_seed(2),
                               torch.ones((4, 5000, 50)), spec)
    noisy = noisy.reshape(-1, 50).numpy()

    def missing(name):
        s, e = TABLE.span(TABLE.names.index(name))
        return (noisy[:, s:e] == -1.0).all(axis=1)

    assert abs(missing("location").mean() - 0.32814) < 0.02
    assert abs(missing("call").mean() - 0.10862) < 0.015
    assert (missing("call") == missing("sms")).all()
    assert not missing("survey").any()


def test_mask_overwrites_element_zeros():
    spec = spec_of(element_dropout_frac=1.0, intelligent_noise=False,
                   num_modalities_to_drop=5)
    noisy = add_noise_to_batch(torch.Generator().manual_seed(3),
                               torch.full((50, 50), 7.0), spec)
    assert set(np.unique(noisy.numpy())).issubset({-1.0, 0.0, 7.0})
    # spans drawn with replacement: wherever -1 is, the whole span is -1
    for s, e in (TABLE.span(m) for m in range(5)):
        span = noisy[:, s:e]
        hit = (span == -1.0).any(dim=1)
        assert (span[hit] == -1.0).all()


def test_forced_type_mask():
    spec = spec_of(element_dropout_frac=0.0)
    forced = torch.as_tensor(TABLE.feature_masks()[2])
    noisy = add_noise_to_batch(None, torch.ones((4, 50)), spec,
                               forced_type_mask=forced).numpy()
    s, e = TABLE.span(2)
    assert (noisy[:, s:e] == -1.0).all()
    outside = np.ones(50, dtype=bool)
    outside[s:e] = False
    assert (noisy[:, outside] == 1.0).all()


# ----------------------------------------------------- masked losses

@pytest.mark.parametrize("loss", ["mean_squared", "cross_entropy",
                                  "sigmoid_cross_entropy"])
def test_masked_losses_match_jax(loss):
    rng = np.random.default_rng(4)
    dec = rng.uniform(0.05, 0.95, (3, 7, 5)).astype(np.float32)
    x = rng.uniform(0, 1, (3, 7, 5)).astype(np.float32)
    valid = np.arange(7)[None, :] < np.array([[7], [4], [1]])
    for mask in (valid, None):
        got = masking.masked_reconstruction_loss(
            loss, torch.as_tensor(dec), torch.as_tensor(x),
            None if mask is None else torch.as_tensor(mask))
        got = masking.masked_report_scale(
            loss, got, None if mask is None else torch.as_tensor(mask), 7)
        for i in range(3):
            m = None if mask is None else jnp.asarray(mask[i])
            want = jax_masking.masked_reconstruction_loss(
                loss, jnp.asarray(dec[i]), jnp.asarray(x[i]), m)
            want = jax_masking.masked_report_scale(loss, want, m, 7)
            np.testing.assert_allclose(float(got[i]), float(want),
                                       rtol=1e-6)


# -------------------------------------------------------- optimizers

def _tree(rng, shapes):
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


@pytest.mark.parametrize("name, state_dtype, clip", [
    ("adam", "float32", None), ("adam", "bfloat16", None),
    ("adam", "float32", 0.5), ("sgd", None, None), ("sgd", None, 0.5),
    ("adagrad", None, None), ("adagrad", "bfloat16", 0.5)])
def test_optimizers_match_jax(name, state_dtype, clip):
    rng = np.random.default_rng(5)
    shapes = [(4, 3), (3,)]
    params = _tree(rng, shapes)
    grads = [_tree(rng, shapes) for _ in range(3)]
    pj = tuple(jnp.asarray(a) for a in params)
    pt = tuple(torch.as_tensor(a) for a in params)
    sj = jax_optim.opt_init(name, pj, jax_optim.state_dtype(state_dtype))
    st = optim.opt_init(name, pt, optim.state_dtype(state_dtype))
    for g in grads:
        pj, sj = jax_optim.opt_update(name, tuple(jnp.asarray(a) for a in g),
                                      sj, pj, 0.01, clip_norm=clip)
        pt, st = optim.opt_update(name, tuple(torch.as_tensor(a) for a in g),
                                  st, pt, 0.01, clip_norm=clip)
    for a, b in zip(pj, pt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    for a, b in zip(jax.tree_util.tree_leaves(sj),
                    optim.tree_leaves(st)):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a).astype(np.float32),
                                   rtol=1e-6, atol=1e-7)


def test_adam_batched_instances_match_jax_vmap():
    """A stack of instances with per-instance lr and clip norm, as the
    grid trainer uses it, against vmap in the JAX package."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((3, 4, 2)).astype(np.float32)
    gs = [rng.standard_normal((3, 4, 2)).astype(np.float32)
          for _ in range(2)]
    lr = np.array([0.1, 0.01, 0.001], np.float32)
    clip = np.array([0.5, 5.0, 1.0], np.float32)

    def jax_run(w, gs, lr, clip):
        p, s = (w,), jax_optim.adam_init((w,))
        for g in gs:
            p, s = jax_optim.adam_update((g,), s, p, lr, clip_norm=clip)
        return p[0]

    want = jax.vmap(jax_run, in_axes=(0, 1, 0, 0))(
        jnp.asarray(w), jnp.asarray(np.stack(gs)), jnp.asarray(lr),
        jnp.asarray(clip))
    p, s = (torch.as_tensor(w),), optim.adam_init((torch.as_tensor(w),))
    for g in gs:
        p, s = optim.adam_update((torch.as_tensor(g),), s, p,
                                 torch.as_tensor(lr),
                                 clip_norm=torch.as_tensor(clip),
                                 batch_dims=1)
    np.testing.assert_allclose(p[0].numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("staircase", [False, True])
def test_exponential_decay_matches_jax(staircase):
    for step in (0, 999, 1000, 1500, 14999):
        want = jax_optim.exponential_decay(1e-3, jnp.asarray(step), 1000,
                                           0.95, staircase)
        got = optim.exponential_decay(1e-3, step, 1000, 0.95, staircase)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(ValueError):
        optim.state_dtype("float16")
    with pytest.raises(ValueError):
        optim.opt_init("rmsprop", (torch.zeros(2),))


def test_loader_without_folds_keeps_dataset_splits(tmp_path):
    """cross_validation off: the Train/Val splits and no fold column."""
    path = str(tmp_path / "d.csv")
    jax_synthetic.write_csv(path, num_rows=120, seed=1)
    before = open(path).read()
    dt = DataLoader(path, supervised=False, suppress_output=True)
    dj = JaxLoader(path, supervised=False, suppress_output=True)
    np.testing.assert_array_equal(dt.train_X, dj.train_X)
    np.testing.assert_array_equal(dt.val_X, dj.val_X)
    assert open(path).read() == before
    assert "logistics_cv_fold" not in dt.frame.columns
    assert os.path.exists(path)
