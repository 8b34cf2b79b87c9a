"""The port's training kernels' plain twin against the JAX package.

``ops/train_kernels.train_grid_kernel_reference`` (the CUDA kernels' twin)
is held against the Pallas kernel ``ops/train_kernel.train_grid_pallas``,
run as the JAX package's own tests run it on the CPU (interpret mode), in
their deterministic harness (tests/test_train_kernel.py:27-70): one
training row, no corruption, keep probability 1, and the same initial
parameters, carried over with ``stacked_params_from_numpy``.  Tolerances
are the JAX tests' own: 2e-5 after one step, 1e-4 after five with decay.

The interpret-mode generator is not the port's, so the VAE step is held
against ``jax.grad`` of the loss with the twin's eps fed in, and the
twin's sampling and corruption against their distributions.  The CUDA
kernels against the twin run on the card (``-m cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalautoencoder_tpu.config import MMAEConfig as JaxConfig
from multimodalautoencoder_tpu.config import TrainConfig as JaxTrainConfig
from multimodalautoencoder_tpu.data.modalities import \
    ModalityTable as JaxTable
from multimodalautoencoder_tpu.models import losses as jax_losses
from multimodalautoencoder_tpu.models import mmae as jax_mmae
from multimodalautoencoder_tpu.models.corruption import \
    NoiseSpec as JaxNoiseSpec
from multimodalautoencoder_tpu.ops import optim as jax_optim
from multimodalautoencoder_tpu.ops import train_kernel as tk
from multimodalautoencoder_tpu.parallel import grid_trainer as jgt
from multimodalautoencoder_tpu_torch.config import MMAEConfig, TrainConfig
from multimodalautoencoder_tpu_torch.data.modalities import ModalityTable
from multimodalautoencoder_tpu_torch.models import mmae
from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec
from multimodalautoencoder_tpu_torch.ops import philox
from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk
from multimodalautoencoder_tpu_torch.parallel import grid_trainer as pgt

NAMES = ("call", "location", "screen", "sms", "survey")


def make(tied, act="softsign", wpen=0.0, lr=1e-2, decay=False,
         state_dtype="float32", variational=False):
    """The same bucket in both packages: (jax parts, port parts)."""
    kw = dict(num_feats=30, layer_sizes=(16, 6), tie_weights=tied,
              activation=act, element_dropout_frac=0.0,
              noise_type_percentages=(1.0, 0.0, 0.0, 0.0),
              variational=variational)
    tkw = dict(learning_rate=lr, batch_size=8, decay=decay,
               clip_gradients=False, optimizer_state_dtype=state_dtype)
    settings = [{"dropout_prob": 1.0, "weight_penalty": wpen,
                 "activation_function": act}]
    X = np.random.default_rng(0).random((1, 30)).astype(np.float32)
    cj, tj = JaxConfig(**kw).validate(), JaxTrainConfig(**tkw)
    ct, tt = MMAEConfig(**kw).validate(), TrainConfig(**tkw)
    jax_side = (cj, tj, JaxNoiseSpec.build(cj, JaxTable.uniform(5, 6, NAMES)),
                jgt.HyperStack.from_settings(settings, cj, tj),
                jgt.FoldedData.from_ragged([X], [X]))
    port = (ct, tt, NoiseSpec.build(ct, ModalityTable.uniform(5, 6, NAMES)),
            pgt.HyperStack.from_settings(settings, ct, tt),
            pgt.FoldedData.from_ragged([X], [X], device="cpu"))
    return jax_side, port, X


def jax_init(cfg):
    """The Pallas pipeline's initial parameters for key 0
    (train_kernel.py:939-942), with leading (1, 1) axes."""
    k_init, _ = jax.random.split(jax.random.PRNGKey(0))
    keys = jax.random.split(k_init, 1).reshape(1, 1, 2)
    return jax.vmap(jax.vmap(lambda k: jax_mmae.init(k, cfg)))(keys)


def run_both(steps, **kw):
    (cj, tj, sj, hj, fj), (ct, tt, st, ht, ft), _ = make(**kw)
    pj, lj = tk.train_grid_pallas(jax.random.PRNGKey(0), cj, tj, sj, hj, fj,
                                  num_steps=steps)
    p0 = mmae.stacked_params_from_numpy(
        jax.tree_util.tree_leaves(jax_init(cj)), ct, "cpu")
    pt, lt = ptk.train_grid_pallas(0, ct, tt, st, ht, ft, num_steps=steps,
                                   params0=p0)
    return pj, lj, pt, lt


def assert_params_close(pj, pt, tol):
    leaves_j = jax.tree_util.tree_leaves(pj)
    leaves_t = mmae.params_to_numpy(pt)
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_j, leaves_t):
        np.testing.assert_allclose(b, np.asarray(a), rtol=tol, atol=tol)


@pytest.mark.parametrize("tied", [True, False])
def test_twin_single_step_matches_pallas_kernel(tied):
    pj, lj, pt, lt = run_both(1, tied=tied)
    assert_params_close(pj, pt, 2e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=2e-5)


@pytest.mark.parametrize("act", ["linear", "relu", "tanh", "softsign",
                                 "softplus"])
def test_twin_activations_match_pallas_kernel(act):
    pj, _, pt, _ = run_both(1, tied=True, act=act)
    assert_params_close(pj, pt, 2e-5)


@pytest.mark.parametrize("tied", [True, False])
def test_twin_weight_penalty_matches_pallas_kernel(tied):
    pj, _, pt, _ = run_both(1, tied=tied, wpen=0.01)
    assert_params_close(pj, pt, 2e-5)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tied", [True, False])
def test_twin_five_steps_decay_moments_match_pallas_kernel(tied,
                                                           state_dtype):
    """Five steps with decay and L2; bf16 moments stored rounded but the
    weight updated with the unrounded values, as the Pallas kernel does."""
    pj, lj, pt, lt = run_both(5, tied=tied, wpen=0.01, decay=True,
                              state_dtype=state_dtype)
    assert_params_close(pj, pt, 1e-4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4)


def vae_step_vs_jax_grad(act):
    """One VAE step of the twin against jax.grad of the reference loss
    (mmae.encode/decode, losses, KL on the sampled z) with the twin's eps
    fed in, then optim.adam_update with f32 moments."""
    (cj, *_), (ct, tt, st, ht, ft), X = make(False, act=act, wpen=0.01,
                                              variational=True)
    pj0 = jax_init(cj)
    p0 = mmae.stacked_params_from_numpy(jax.tree_util.tree_leaves(pj0), ct,
                                        "cpu")
    run = ptk.prepare_run(torch.Generator().manual_seed(0), ct, tt, st, ht,
                          ft, p0)
    eps = ptk.vae_eps(run.seeds, 0, tt.batch_size, 6)[0].numpy()
    ptk.train_grid_kernel_reference(run, 0, 1)

    p = jax.tree_util.tree_map(lambda a: a[0, 0], pj0)
    xb = jnp.asarray(np.repeat(X, tt.batch_size, axis=0))

    def loss_fn(q):
        mu, lv = jax_mmae.encode(q, cj, xb)
        z = mu + eps * jnp.exp(lv)
        recon = jax_losses.reconstruction_loss(
            cj.loss, jax_mmae.decode(q, cj, z), xb)
        kl = jax_losses.kl_divergence_rows(z, lv)
        reg = jax_losses.weight_regularization(
            0.01, list(q.enc_w) + list(jax_mmae._decode_weights(q))
            + [q.var_w])
        return jnp.mean(recon + kl) + reg

    want, _ = jax_optim.adam_update(jax.grad(loss_fn)(p),
                                    jax_optim.adam_init(p), p, 1e-2)
    assert_params_close(jax.tree_util.tree_map(lambda a: a[None, None],
                                               want),
                        run.grid_params(1, 1), 2e-5)


def test_twin_vae_step_matches_jax_grad():
    vae_step_vs_jax_grad("softsign")


def test_twin_relu_vae_step_matches_jax_grad():
    """The grid's relu VAE settings (relu on both hidden layers, the
    log-sigma head fed by the relu layer)."""
    vae_step_vs_jax_grad("relu")


@pytest.mark.parametrize("counter, key, want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's Philox4x32-10 known-answer vectors."""
    c = [torch.tensor([v], dtype=torch.int64) for v in counter]
    out = philox.philox4x32(*c, *key)
    assert tuple(int(w[0]) for w in out) == want


def test_philox_probe_rows_distinct():
    """The generator check of the TPU probe (test_hardware.py:28-46): 8
    rows of uniforms in [0, 1), all distinct, from counters 0..3 x 2
    draws."""
    u = ptk.philox_probe(7, device="cpu")
    assert u.shape == (8, 128) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert len({tuple(r.tolist()) for r in u}) == 8
    assert torch.equal(u, philox.probe_uniforms(7))


# ----------------------------------------------- sampling and corruption

TABLE = ModalityTable.from_feature_names(
    [f"{m}_f{i}" for m in ("call", "location", "screen", "sms", "survey")
     for i in range(10)])


def stats_run(rows=10, n_valid=None, batch=2000, configs=4, **cfg_kw):
    """A GridRun over ``configs`` instances whose train rows hold their
    own row number in every feature (rows past ``n_valid`` hold 999)."""
    cfg = MMAEConfig(num_feats=50, layer_sizes=(4, 2), **cfg_kw).validate()
    tcfg = TrainConfig(batch_size=batch, clip_gradients=False)
    n_valid = rows if n_valid is None else n_valid
    X = np.repeat(np.arange(rows, dtype=np.float32)[:, None] + 1.0, 50, 1)
    folded = pgt.FoldedData.from_ragged([X[:n_valid]], [X[:1]],
                                        device="cpu")
    if n_valid < rows:   # padding rows past the fold's count
        folded = pgt.FoldedData(
            torch.cat([folded.train_x, torch.full((1, rows - n_valid, 50),
                                                  999.0)], 1),
            folded.train_n, folded.val_x, folded.val_n)
    hyper = pgt.HyperStack.from_settings([{}] * configs, cfg, tcfg)
    spec = NoiseSpec.build(cfg, TABLE)
    g = torch.Generator().manual_seed(0)
    return ptk.prepare_run(g, cfg, tcfg, spec, hyper, folded,
                           ptk.init_grid_params(g, cfg, configs, 1))


def test_twin_rows_uniform_below_n_valid():
    run = stats_run(rows=10, n_valid=7, element_dropout_frac=0.0,
                    intelligent_noise=False, num_modalities_to_drop=0)
    x = torch.cat([ptk.sample_batch(run, s)[0] for s in range(3)])
    rows = x[..., 0].flatten().numpy() - 1.0
    assert rows.min() >= 0 and rows.max() <= 6
    counts = np.bincount(rows.astype(int), minlength=7)
    expect = rows.size / 7
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 22.46          # chi-square, 6 dof, p = 0.001


def test_twin_element_zero_rate_is_elem_p():
    run = stats_run(intelligent_noise=False, num_modalities_to_drop=0)
    elem_p = ptk.element_drop_rate(50, NoiseSpec.build(
        MMAEConfig(num_feats=50, intelligent_noise=False,
                   num_modalities_to_drop=0).validate(), TABLE))
    assert abs(elem_p - (1 - (1 - 1 / 50) ** 2)) < 1e-12
    _, xn = ptk.sample_batch(run, 0)
    rate = float((xn == 0).float().mean())
    # 4 x 2000 x 50 Bernoulli draws: standard error ~3e-4
    assert abs(rate - elem_p) < 2e-3


def test_twin_modality_sets_follow_type_probabilities():
    run = stats_run(element_dropout_frac=0.0)
    _, xn = ptk.sample_batch(run, 0)
    missing = torch.stack([(xn[..., s:e] == -1.0).all(-1) for s, e in
                           (TABLE.span(m) for m in range(5))], -1)
    # the default sets: {}, {call, sms, screen}, {location}, {all four}
    key = missing.reshape(-1, 5).numpy()
    sets = [(0, 0, 0, 0, 0), (1, 0, 1, 1, 0), (0, 1, 0, 0, 0),
            (1, 1, 1, 1, 0)]
    counts = np.array([(key == np.array(s)).all(1).sum() for s in sets])
    assert counts.sum() == key.shape[0]
    probs = np.asarray(MMAEConfig().noise_type_percentages)
    expect = probs / probs.sum() * key.shape[0]
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 16.27          # chi-square, 3 dof, p = 0.001


def test_twin_mask_overwrites_element_zeros():
    run = stats_run(element_dropout_frac=1.0, intelligent_noise=False,
                    num_modalities_to_drop=1, batch=200)
    x, xn = ptk.sample_batch(run, 0)
    masked = torch.stack([(xn[..., s:e] == -1.0).all(-1) for s, e in
                          (TABLE.span(m) for m in range(5))], -1)
    assert (masked.sum(-1) == 1).all()       # one whole span per row
    assert ((xn == 0) | (xn == -1) | (xn == x)).all()
    assert float((xn == 0).float().mean()) > 0.3


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["tied_softsign", "untied_relu", "vae"])
def test_cuda_kernels_match_twin(family, state_dtype):
    """The CUDA kernels against their twin on the card, 10 steps with
    corruption and dropout on: random decisions are bit-identical, sums
    differ in order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    tied = family == "tied_softsign"
    cfg = MMAEConfig(num_feats=30, layer_sizes=(16, 6), tie_weights=tied,
                     variational=family == "vae",
                     activation="softsign" if tied else "relu").validate()
    tcfg = TrainConfig(learning_rate=1e-3, batch_size=20,
                       clip_gradients=False,
                       optimizer_state_dtype=state_dtype)
    spec = NoiseSpec.build(cfg, ModalityTable.uniform(5, 6, NAMES))
    hyper = pgt.HyperStack.from_settings(
        [{"dropout_prob": 0.5, "weight_penalty": 0.01},
         {"dropout_prob": 1.0, "weight_penalty": 0.0}], cfg, tcfg)
    rng = np.random.default_rng(1)
    folded = pgt.FoldedData.from_ragged(
        [rng.random((40, 30)), rng.random((33, 30))],
        [rng.random((9, 30)), rng.random((7, 30))], device="cuda")
    g = torch.Generator().manual_seed(0)
    run = ptk.prepare_run(g, cfg, tcfg, spec, hyper, folded,
                          ptk.init_grid_params(g, cfg, 2, 2))
    twin = run.clone()
    before = ptk.KERNELS.launches
    ptk.train_grid_kernel(run, 0, 10)
    ptk.train_grid_kernel_reference(twin, 0, 10)
    torch.cuda.synchronize()
    assert ptk.KERNELS.launches - before == \
        10 * ptk.launches_per_step(cfg.tie_weights, cfg.variational)
    for a, b in zip(run.params, twin.params):
        if a is not None:
            assert float((a - b).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["tied_softsign", "untied_relu", "vae"])
def test_cuda_kernels_match_twin_at_the_real_width(family):
    """The CUDA kernels against their twin at the ACII width (F = H1 =
    1000, H2 = 100), N = 2, bf16 moments, 10 steps with corruption,
    dropout, L2 and decay on, each step from the twin's state (chip_smoke
    [8]'s gate): random decisions are bit-identical and sums differ in
    order, so an instance may have at most max(8, 1e-5 of its
    parameters) over 1e-4 in a step (an Adam update whose gradient sits
    at rounding level can flip sign) and none more than 2 lr."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    tied = family == "tied_softsign"
    cfg = MMAEConfig(num_feats=1000, layer_sizes=(1000, 100),
                     tie_weights=tied, variational=family == "vae",
                     activation="softsign" if tied else "relu").validate()
    lr = 1e-3
    tcfg = TrainConfig(learning_rate=lr, batch_size=20, decay=True,
                       decay_steps=1000, decay_rate=0.95,
                       clip_gradients=False,
                       optimizer_state_dtype="bfloat16")
    spec = NoiseSpec.build(cfg, ModalityTable.uniform(5, 200, NAMES))
    hyper = pgt.HyperStack.from_settings(
        [{"dropout_prob": 0.5, "weight_penalty": 0.01}], cfg, tcfg)
    rng = np.random.default_rng(1)
    folded = pgt.FoldedData.from_ragged(
        [rng.random((40, 1000)), rng.random((33, 1000))],
        [rng.random((9, 1000)), rng.random((7, 1000))], device="cuda")
    g = torch.Generator().manual_seed(0)
    twin = ptk.prepare_run(g, cfg, tcfg, spec, hyper, folded,
                           ptk.init_grid_params(g, cfg, 1, 2))
    per_inst = sum(t[0].numel() for t in twin.params if t is not None)
    for step in range(10):
        run = twin.clone()
        before = ptk.KERNELS.launches
        ptk.train_grid_kernel(run, step, 1)
        ptk.train_grid_kernel_reference(twin, step, 1)
        torch.cuda.synchronize()
        assert ptk.KERNELS.launches - before == ptk.launches_per_step(
            cfg.tie_weights, cfg.variational)
        over = sum(((a - b).abs() > 1e-4).reshape(2, -1).sum(1)
                   for a, b in zip(run.params, twin.params)
                   if a is not None)
        assert int(over.max()) <= max(8, 1e-5 * per_inst), step
        for a, b in zip(run.params, twin.params):
            if a is not None:
                assert float((a - b).abs().max()) <= 2 * lr
