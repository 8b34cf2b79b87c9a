"""The port's single-run trainer against the JAX package's.

- ``train`` and ``train_classification`` step for step against the JAX
  ones on the one-row harness of tests/test_train_kernel.py (every batch is
  row 0, no corruption, keep probability 1, so no draw matters): after 20
  steps the parameters agree within rtol 1e-5 / atol 1e-6 and the curves
  have the same lengths (20 steps recorded every 6 leave a remainder);
- ``learning_rate_at`` and ``state_for_params`` against the JAX ones;
- the reference recipe (utils/parity.py) trained by the port for 3 seeds
  lands inside tests/fixtures/parity_band.json;
- the training loop's draws come from the state's generator alone;
- on the card (``cuda``): chip_smoke.py [21]'s step gate over 12 seeds at
  two widths: the gradient of a ``use_pallas`` step against the plain
  route's and a float64 plain step's, with a bf16 control that it must
  catch.

Inputs are made with numpy from fixed seeds; the JAX side runs on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalautoencoder_tpu.config import MMAEConfig as JaxConfig
from multimodalautoencoder_tpu.config import TrainConfig as JaxTrainConfig
from multimodalautoencoder_tpu.data.modalities import \
    ModalityTable as JaxTable
from multimodalautoencoder_tpu.models.corruption import \
    NoiseSpec as JaxSpec
from multimodalautoencoder_tpu.train import trainer as jtr
from multimodalautoencoder_tpu.utils import parity
from multimodalautoencoder_tpu_torch.config import MMAEConfig, TrainConfig
from multimodalautoencoder_tpu_torch.data.loader import DataLoader
from multimodalautoencoder_tpu_torch.data.modalities import ModalityTable
from multimodalautoencoder_tpu_torch.models import mmae
from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec
from multimodalautoencoder_tpu_torch.ops import optim
from multimodalautoencoder_tpu_torch.train import trainer

NAMES = ("call", "location", "screen", "sms", "survey")
BAND_PATH = os.path.join(os.path.dirname(__file__), "fixtures",
                         "parity_band.json")
STEPS, RECORD = 20, 6


def harness(tied, act, pallas, head=None):
    """The one-row harness: 30 features in 5 modalities, one training row,
    no element dropout, the empty modality set always drawn, keep
    probability 1."""
    kw = dict(num_feats=30, layer_sizes=(16, 6), tie_weights=tied,
              activation=act, element_dropout_frac=0.0,
              noise_type_percentages=(1.0, 0.0, 0.0, 0.0),
              use_pallas=pallas)
    if head is not None:
        kw.update(classification_layer_sizes=head, num_labels=2)
    tk = dict(learning_rate=1e-3, batch_size=8, num_steps=STEPS,
              record_every_nth=RECORD, clip_gradients=False)
    jc, pc = JaxConfig(**kw).validate(), MMAEConfig(**kw).validate()
    jspec = JaxSpec.build(jc, JaxTable.uniform(5, 6, names=NAMES))
    pspec = NoiseSpec.build(pc, ModalityTable.uniform(5, 6, names=NAMES))
    X = np.random.default_rng(0).random((1, 30)).astype(np.float32)
    return (jc, JaxTrainConfig(**tk), jspec), (pc, TrainConfig(**tk),
                                                pspec), X


def port_params(jax_params, cfg):
    return mmae.params_from_numpy(
        [np.asarray(a) for a in jax.tree_util.tree_leaves(jax_params)], cfg,
        device="cpu")


def assert_params_match(jax_params, port):
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(jax_params)]
    got = mmae.params_to_numpy(port)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("act", ["softsign", "relu"])
@pytest.mark.parametrize("tied", [True, False])
def test_train_step_for_step_matches_jax(tied, act, pallas):
    (jc, jt, jspec), (pc, pt, pspec), X = harness(tied, act, pallas)
    st = jtr.init_state(jax.random.PRNGKey(0), jc, jt)
    jst, jcurves = jtr.train_jit(st, jc, jt, jspec, jnp.asarray(X),
                                 jnp.asarray(X))
    pst = trainer.state_for_params(port_params(st.params, pc), pt,
                                   torch.Generator().manual_seed(0))
    pst, curves = trainer.train(pst, pc, pt, pspec, torch.from_numpy(X),
                                torch.from_numpy(X))
    assert int(pst.step) == int(jst.step) == STEPS
    assert len(curves.val_loss) == len(jcurves.val_loss) == -(-STEPS
                                                              // RECORD)
    assert_params_match(jst.params, pst.params)
    np.testing.assert_allclose(curves.val_loss, np.asarray(jcurves.val_loss),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(curves.train_loss,
                               np.asarray(jcurves.train_loss),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tied,act,pallas", [
    (True, "softsign", False), (True, "relu", True),
    (False, "relu", False), (False, "softsign", True)])
def test_train_classification_step_for_step_matches_jax(tied, act, pallas):
    (jc, jt, jspec), (pc, pt, pspec), X = harness(tied, act, pallas,
                                                  head=(4,))
    Y = np.asarray([[1.0, 0.0]], np.float32)
    st = jtr.init_state(jax.random.PRNGKey(1), jc, jt)
    jst, jcurves = jtr.train_classification_jit(
        st, jc, jt, jspec, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(X),
        jnp.asarray(Y))
    pst = trainer.state_for_params(port_params(st.params, pc), pt,
                                   torch.Generator().manual_seed(0))
    tx, ty = torch.from_numpy(X), torch.from_numpy(Y)
    pst, curves = trainer.train_classification(pst, pc, pt, pspec, tx, ty,
                                               tx, ty)
    for name in curves._fields:
        assert len(getattr(curves, name)) == len(getattr(jcurves, name)) \
            == -(-STEPS // RECORD)
    assert_params_match(jst.params, pst.params)
    np.testing.assert_allclose(curves.val_loss, np.asarray(jcurves.val_loss),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(curves.val_acc, np.asarray(jcurves.val_acc))


@pytest.mark.parametrize("kw", [
    dict(), dict(decay=False), dict(faithful_inert_decay=True),
    dict(decay_staircase=True, decay_steps=7, decay_rate=0.5)])
def test_learning_rate_at_matches_jax(kw):
    jt, pt = JaxTrainConfig(**kw), TrainConfig(**kw)
    for step in (0, 1, 6, 7, 999, 1000, 12345):
        want = float(jtr.learning_rate_at(jt, jnp.int32(step)))
        got = trainer.learning_rate_at(
            pt, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_for_params_matches_jax(dtype):
    (jc, _, _), (pc, _, _), _ = harness(False, "softsign", False)
    jt = JaxTrainConfig(optimizer_state_dtype=dtype)
    pt = TrainConfig(optimizer_state_dtype=dtype)
    jp = jtr.init_state(jax.random.PRNGKey(0), jc, jt).params
    js = jtr.state_for_params(jp, jt, jax.random.PRNGKey(3))
    g = torch.Generator().manual_seed(3)
    ps = trainer.state_for_params(port_params(jp, pc), pt, g)
    assert ps.generator is g and int(ps.step) == int(js.step) == 0
    assert ps.step.dtype == torch.int32
    want = jax.tree_util.tree_leaves(js.opt_state)
    got = optim.tree_leaves(ps.opt_state)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert not bool(b.float().abs().sum())


def test_init_state_is_seeded_and_on_its_device():
    cfg = MMAEConfig(num_feats=12, layer_sizes=(8, 4))
    a = trainer.init_state(5, cfg, TrainConfig(), "cpu")
    b = trainer.init_state(5, cfg, TrainConfig(), "cpu")
    c = trainer.init_state(5, cfg, TrainConfig(seed=1), "cpu")
    for x, y in zip(mmae.params_to_numpy(a.params),
                    mmae.params_to_numpy(b.params)):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(mmae.params_to_numpy(a.params)[0],
                              mmae.params_to_numpy(c.params)[0])
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.generator.device.type == a.step.device.type == "cpu"


def test_training_draws_come_from_the_state_generator():
    """Two runs from equal states give equal parameters and curves, and a
    run advances only its own generator."""
    cfg = MMAEConfig(num_feats=30, layer_sizes=(16, 6), variational=True,
                     dropout_prob=0.8)
    tcfg = TrainConfig(batch_size=5, record_every_nth=4)
    spec = NoiseSpec.build(cfg, ModalityTable.uniform(5, 6, names=NAMES))
    x = torch.from_numpy(np.random.default_rng(2).random((40, 30))
                         .astype(np.float32))
    runs = []
    for _ in range(2):
        torch.manual_seed(123)          # the global generator is not used
        st = trainer.init_state(0, cfg, tcfg, "cpu")
        runs.append(trainer.train(st, cfg, tcfg, spec, x[:30], x[30:], 10))
        torch.manual_seed(7)
    (s1, c1), (s2, c2) = runs
    np.testing.assert_array_equal(c1.val_loss, c2.val_loss)
    for a, b in zip(mmae.params_to_numpy(s1.params),
                    mmae.params_to_numpy(s2.params)):
        np.testing.assert_array_equal(a, b)
    assert len(c1.train_loss) == 3 and np.isfinite(c1.train_loss).all()


def test_parity_recipe_inside_the_band():
    """The reference recipe (utils/parity.py:67-127: sigmoid-CE, lr 1e-3,
    batch 20, decay 1000 / 0.95, tied softsign 16 -> 8, 500 steps) trained
    by the port's trainer for 3 seeds on the fixture set: the noisy-val
    loss over the whole val set and the per-modality RMSE land inside the
    stored band (checked by the JAX package's check_band)."""
    with open(BAND_PATH) as f:
        band = json.load(f)
    path = parity._fixture_loader().filename
    dl = DataLoader(path, supervised=False, cross_validation=False,
                    suppress_output=True, normalize_and_fill=True,
                    normalization="between_0_and_1", fill_gaps_with=-1.0)
    cfg = MMAEConfig(num_feats=dl.num_feats, layer_sizes=parity.RECIPE_ARCH,
                     tie_weights=True, loss="sigmoid_cross_entropy",
                     normalization="between_0_and_1", mask_with=-1.0,
                     fill_missing_with=0.0, weight_initialization="normal",
                     activation="softsign").validate()
    tcfg = TrainConfig(learning_rate=1e-3, batch_size=20,
                       num_steps=band["recipe"]["num_steps"], decay=True,
                       decay_steps=1000, decay_rate=0.95,
                       clip_gradients=False, record_every_nth=500)
    spec = NoiseSpec.build(cfg, dl.modality_table)
    arr = dl.device_arrays("cpu")
    masks = torch.as_tensor(dl.modality_table.feature_masks())
    losses, rmse = [], []
    for seed in range(3):
        st = trainer.init_state(seed, cfg, tcfg, "cpu")
        st, _ = trainer.train(st, cfg, tcfg, spec, arr["train_x"],
                              arr["val_x"])
        losses.append(float(trainer.evaluate_reconstruction(
            st.params, cfg, spec, arr["val_x"], st.generator)))
        rmse.append(trainer.reconstruction_loss_per_modality(
            st.params, cfg, masks, arr["val_x"]).numpy())
    obs = {"noisy_val_loss": np.asarray(losses),
           "per_modality_rmse": np.stack(rmse)}
    problems = parity.check_band(obs, band)
    assert not problems, "\n".join(problems)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("act", ["softsign", "relu"])
@pytest.mark.parametrize("layers", [(300, 60), (1000, 100)])
def test_cuda_step_gate(cuda_device, layers, act, phase):
    """chip_smoke.py [21]'s gate (``chip_smoke.gate_step``) on 12 seeds of
    uniform data, 200 rows, 5 steps each from the plain route's state: the
    kernel route's gradient, read from Adam's first moments, is no further
    (L2) from a float64 plain step's than twice the plain route's, and the
    kernel route with bf16 operands, the control, is further than that."""
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    feats = layers[0]
    for seed in range(12):
        rng = np.random.default_rng(4 + 1000 * seed)
        x = torch.as_tensor(rng.random((200, feats)), dtype=torch.float32,
                            device=cuda_device)
        y = torch.as_tensor(rng.integers(0, 2, (200, 3)),
                            dtype=torch.float32, device=cuda_device)
        cfg = MMAEConfig(num_feats=feats, layer_sizes=layers, activation=act,
                         weight_initialization="normal",
                         classification_layer_sizes=(50, 20), num_labels=3)
        routes = {"plain": cfg, "kernel": cfg.replace(use_pallas=True),
                  "bf16": cfg.replace(use_pallas=True,
                                      compute_dtype="bfloat16")}
        spec = NoiseSpec.build(cfg, ModalityTable.uniform(
            5, feats // 5, names=NAMES)).to(cuda_device)
        tcfg = TrainConfig(learning_rate=1e-3, batch_size=20,
                           clip_gradients=False)
        if phase == 2:
            tcfg = tcfg.replace(learning_rate=1e-4, batch_size=100)
        st = trainer.init_state(seed, cfg, tcfg, cuda_device)
        for step in range(5):
            took, ref = chip_smoke.gate_step(phase, routes, tcfg, spec, st,
                                             x, y)
            g_p, g_k, g_b = (chip_smoke.gate_distances(took[r][0], ref)[0]
                             for r in ("plain", "kernel", "bf16"))
            where = f"seed {seed} step {step}"
            assert g_k <= 2.0 * g_p, (where, g_k, g_p)
            assert g_b > 2.0 * g_p, (where, g_b, g_p)
            st = took["plain"][0]
