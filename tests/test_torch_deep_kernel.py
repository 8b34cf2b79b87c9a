"""The port's depth >= 3 training kernels' plain twin against the JAX
package.

``ops/train_deep_kernels.train_deep_kernel_reference`` (the CUDA kernels'
twin) is held against the Pallas kernel ``_train_kernel_deep`` through
``train_kernel.train_grid_pallas``, run as the JAX package's own tests run
it on the CPU (interpret mode), in their deterministic harness
(tests/test_train_kernel.py:27-70, :153-212): one training row, no
corruption, keep probability 1, the same initial parameters carried over
with ``stacked_params_from_numpy``.  Tolerances are the JAX tests' own:
2e-5 after one step, 1e-4 after five with decay and penalty.

The reference deep VAE has no gradient-level check (ROADMAP Queue 3
"Deep VAE"), so the twin's VAE step is held against ``jax.grad`` of
``mmae.total_loss`` with the twin's eps fed in.  The CUDA kernels against
the twin run on the card (``-m cuda``).
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
from multimodalautoencoder_tpu_torch.ops import train_deep_kernels as pdk
from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk
from multimodalautoencoder_tpu_torch.parallel import grid_trainer as pgt

NAMES = ("call", "location", "screen", "sms", "survey")
DEPTH3, DEPTH4 = (16, 10, 6), (20, 14, 10, 6)


def make(layer_sizes=DEPTH3, tied=True, act="softsign", wpen=0.0, lr=1e-2,
         decay=False, variational=False):
    """The same deep bucket in both packages: (jax parts, port parts, the
    one training row)."""
    kw = dict(num_feats=30, layer_sizes=layer_sizes, tie_weights=tied,
              activation=act, element_dropout_frac=0.0,
              noise_type_percentages=(1.0, 0.0, 0.0, 0.0),
              variational=variational)
    tkw = dict(learning_rate=lr, batch_size=8, decay=decay,
               clip_gradients=False, optimizer_state_dtype="float32")
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
    (train_kernel.py:1176-1179), with leading (1, 1) axes."""
    k_init, _ = jax.random.split(jax.random.PRNGKey(0))
    keys = jax.random.split(k_init, 1).reshape(1, 1, 2)
    return jax.vmap(jax.vmap(lambda k: jax_mmae.init(k, cfg)))(keys)


def assert_params_close(pj, pt, tol):
    leaves_j = jax.tree_util.tree_leaves(pj)
    leaves_t = mmae.params_to_numpy(pt)
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_j, leaves_t):
        np.testing.assert_allclose(b, np.asarray(a), rtol=tol, atol=tol)


def run_both(steps, **kw):
    (cj, tj, sj, hj, fj), (ct, tt, st, ht, ft), _ = make(**kw)
    assert tk.supported(cj, tj, sj) and ptk.supported(ct, tt, st)
    pj, lj = tk.train_grid_pallas(jax.random.PRNGKey(0), cj, tj, sj, hj, fj,
                                  num_steps=steps)
    p0 = mmae.stacked_params_from_numpy(
        jax.tree_util.tree_leaves(jax_init(cj)), ct, "cpu")
    pt, lt = ptk.train_grid_pallas(0, ct, tt, st, ht, ft, num_steps=steps,
                                   params0=p0)
    return pj, lj, pt, lt


@pytest.mark.parametrize("tied", [True, False])
def test_deep_twin_single_step_matches_pallas_kernel(tied):
    pj, lj, pt, lt = run_both(1, tied=tied)
    assert_params_close(pj, pt, 2e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=2e-5)


@pytest.mark.parametrize("tied", [True, False])
def test_deep_twin_five_steps_decay_penalty_match_pallas_kernel(tied):
    pj, lj, pt, lt = run_both(5, tied=tied, wpen=0.01, decay=True)
    assert_params_close(pj, pt, 1e-4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4)


def test_deep_twin_depth4_untied_relu_matches_pallas_kernel():
    pj, _, pt, _ = run_both(1, tied=False, act="relu", layer_sizes=DEPTH4)
    assert_params_close(pj, pt, 2e-5)


def test_deep_twin_softplus_five_steps_matches_pallas_kernel():
    """The padded-lane regression of the JAX package (softplus has act(0)
    != 0): the port pads nothing, and stays step-exact for 5 steps."""
    pj, _, pt, _ = run_both(5, tied=True, act="softplus")
    assert_params_close(pj, pt, 1e-4)


@pytest.mark.parametrize("layer_sizes, act",
                         [(DEPTH3, "softsign"), (DEPTH4, "relu")])
def test_deep_twin_vae_step_matches_jax_grad(layer_sizes, act):
    """One deep VAE step of the twin against jax.grad of the reference
    loss (the log-sigma head off the last hidden layer, KL on the sampled
    z, L2 over every weight and wv) with the twin's eps fed in, then
    optim.adam_update with f32 moments."""
    (cj, *_), (ct, tt, st, ht, ft), X = make(
        layer_sizes=layer_sizes, tied=False, act=act, wpen=0.01,
        variational=True)
    assert not ct.tie_weights
    pj0 = jax_init(cj)
    p0 = mmae.stacked_params_from_numpy(jax.tree_util.tree_leaves(pj0), ct,
                                        "cpu")
    run = pdk.prepare_deep_run(torch.Generator().manual_seed(0), ct, tt, st,
                               ht, ft, p0)
    eps = ptk.vae_eps(run.seeds, 0, tt.batch_size, layer_sizes[-1],
                      philox.DEEP_EPS)[0].numpy()
    pdk.train_deep_kernel_reference(run, 0, 1)

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


def test_deep_run_layout_follows_the_pallas_contract():
    """params in the order encW(L), decW(L, untied), encB(L), decB(L), wv,
    bv, each mapped to its C slot; grid_params inverts the flattening."""
    (_, port, _) = make(tied=False, variational=True)
    ct, tt, st, ht, ft = port
    g = torch.Generator().manual_seed(0)
    p0 = ptk.init_grid_params(g, ct, 1, 1)
    run = pdk.prepare_deep_run(g, ct, tt, st, ht, ft, p0)
    shapes = [tuple(t.shape[1:]) for t in run.params]
    assert shapes == [(30, 16), (16, 10), (10, 6), (6, 10), (10, 16),
                      (16, 30), (16,), (10,), (6,), (10,), (16,), (30,),
                      (10, 6), (6,)]
    M = pdk.MAX_DEPTH
    assert run.c_slots() == [0, 1, 2, M, M + 1, M + 2, 2 * M, 2 * M + 1,
                             2 * M + 2, 3 * M, 3 * M + 1, 3 * M + 2, 4 * M,
                             4 * M + 1]
    back = run.grid_params(1, 1)
    for a, b in zip(mmae.params_to_numpy(back), mmae.params_to_numpy(p0)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tied, vae", [(True, False), (False, False),
                                       (False, True)])
def test_deep_bounds_and_launches_reduce_to_depth2(tied, vae):
    """At L = 2 the deep step bound is the depth-2 kernels' own, and the
    deep step makes the depth-2 kernel's launches, its weight and bias
    updates grouped into one as there."""
    cfg = MMAEConfig(num_feats=1000, layer_sizes=(1000, 100),
                     tie_weights=tied, variational=vae).validate()
    for moments in (True, False):
        assert pdk.deep_step_bound(cfg, 60, 20, moments) == \
            ptk.step_bound(cfg, 60, 20, moments)
    assert pdk.launches_per_step(2, cfg.tie_weights, vae) == \
        ptk.launches_per_step(cfg.tie_weights, vae)
    deep = cfg.replace(layer_sizes=(1000, 500, 100)).validate()
    types = pdk.deep_launch_type_bounds(deep, 60, 20, True)
    assert set(types) == set(ptk.LAUNCH_TYPES)
    step = pdk.deep_step_bound(deep, 60, 20, True)
    assert step["bound_by"] == "bytes"
    # the tied 1000 -> 500 -> 100 bucket: 1.55 M parameters an instance
    if tied:
        assert abs(step["bytes"] / 60 / 16 - 1_553_100) < 1e4


# ------------------------------------------------- family and resolution

def _deep_cfg(cls_cfg, **kw):
    return cls_cfg(num_feats=30, layer_sizes=(8, 4, 2), tie_weights=True,
                   element_dropout_frac=0.0).replace(**kw).validate()


def test_supported_and_resolve_backend_take_deep_stacks():
    """Depth 3 and 4, DAE and VAE, are in the family as in the JAX
    package (tests/test_train_kernel.py:109-123); depth 1 stays on the
    plain trainer (:191-201); out-of-family options fall back."""
    cases = [dict(), dict(tie_weights=False),
             dict(variational=True, tie_weights=False),
             dict(layer_sizes=(12, 8, 4, 2)), dict(layer_sizes=(16,)),
             dict(loss="mean_squared", normalization="z_score")]
    for kw in cases:
        cj, ct = _deep_cfg(JaxConfig, **kw), _deep_cfg(MMAEConfig, **kw)
        tj, tt = JaxTrainConfig(batch_size=8, clip_gradients=False), \
            TrainConfig(batch_size=8, clip_gradients=False)
        sj = JaxNoiseSpec.build(cj, JaxTable.uniform(5, 6, NAMES))
        st = NoiseSpec.build(ct, ModalityTable.uniform(5, 6, NAMES))
        assert ptk.supported(ct, tt, st) == tk.supported(cj, tj, sj), kw
        for on in (True, False):
            assert pgt.resolve_backend("auto", ct, tt, st, on_gpu=on) == \
                jgt.resolve_backend("auto", cj, tj, sj, on_tpu=on), kw
        if len(ct.layer_sizes) == 1:
            assert pgt.resolve_backend("auto", ct, tt, st,
                                       on_gpu=True) == "xla"
    deep = _deep_cfg(MMAEConfig)
    st = NoiseSpec.build(deep, ModalityTable.uniform(5, 6, NAMES))
    assert not ptk.supported(deep, TrainConfig(optimizer="sgd"), st)
    assert not ptk.supported(
        deep.replace(layer_sizes=(4,) * (ptk.MAX_DEPTH + 1)),
        TrainConfig(), st)


def test_vmem_budget_divergence_on_deep_buckets():
    """The JAX deep family refuses untied 1000 -> 500 -> 100 at F = 1000
    for VMEM alone (vmem_bytes_deep, tests/test_train_kernel.py:230-234);
    the port keeps its moments in device memory and takes it (ROADMAP
    Queue 3)."""
    kw = dict(num_feats=1000, layer_sizes=(1000, 500, 100),
              tie_weights=False)
    cj, ct = JaxConfig(**kw).validate(), MMAEConfig(**kw).validate()
    table = dict(names=NAMES)
    sj = JaxNoiseSpec.build(cj, JaxTable.uniform(5, 200, **table))
    st = NoiseSpec.build(ct, ModalityTable.uniform(5, 200, **table))
    assert not tk.supported(cj, JaxTrainConfig(clip_gradients=False), sj)
    assert ptk.supported(ct, TrainConfig(clip_gradients=False), st)
    assert pgt.resolve_backend("auto", ct, TrainConfig(clip_gradients=False),
                               st, on_gpu=True) == "pallas"


def test_deep_grid_sharded_pallas_on_cpu_is_the_twin():
    """On the CPU, backend='pallas' at depth 3 runs the deep twin with the
    plain backend's (C, K) layout, and a seed gives the same run."""
    cfg = MMAEConfig(num_feats=30, layer_sizes=DEPTH3,
                     tie_weights=False).validate()
    tcfg = TrainConfig(batch_size=4, clip_gradients=False)
    spec = NoiseSpec.build(cfg, ModalityTable.uniform(5, 6, NAMES))
    hyper = pgt.HyperStack.from_settings(
        [{"dropout_prob": 0.5}, {"activation_function": "relu"}], cfg, tcfg)
    rng = np.random.default_rng(0)
    folded = pgt.FoldedData.from_ragged(
        [rng.random((9, 30)), rng.random((6, 30))],
        [rng.random((3, 30)), rng.random((4, 30))], device="cpu")
    params, losses = pgt.train_grid_sharded("cpu", 0, cfg, tcfg, spec, hyper,
                                            folded, 3, backend="pallas")
    assert [t.shape for t in params.dec_w] == [(2, 2, 6, 10),
                                               (2, 2, 10, 16),
                                               (2, 2, 16, 30)]
    assert losses.shape == (2, 2) and torch.isfinite(losses).all()
    again, losses2 = pdk.train_deep_pallas(0, cfg, tcfg, spec, hyper, folded,
                                           3)
    assert torch.equal(losses, losses2)
    assert torch.equal(params.enc_w[2], again.enc_w[2])


def test_deep_twin_dropout_streams_are_per_layer():
    """Each hidden layer of both halves draws its dropout from its own
    Philox purpose, DEEP_DROP + chain layer, so no two layers share
    bits."""
    run_kw = dict(layer_sizes=DEPTH4, tied=True)
    (_, port, _) = make(**run_kw)
    ct, tt, st, ht, ft = port
    g = torch.Generator().manual_seed(0)
    run = pdk.prepare_deep_run(g, ct, tt, st, ht, ft,
                               ptk.init_grid_params(g, ct, 1, 1))
    run.keep.fill_(0.5)
    masks = [ptk._dropout_factor(run, philox.DEEP_DROP + k, 0, (1, 20, 6))
             for k in (0, 1, 2, 4, 5, 6)]
    flat = {tuple(m.flatten().tolist()) for m in masks}
    assert len(flat) == len(masks)
    # no purpose of another run: phase 2's head layers take 12-14
    assert philox.DEEP_DROP > philox.DEEP_EPS > philox.CLS_HEAD_DROP + 2


# widths that are not multiples of 4, where products take 64-, 32- and
# 16-column panels and the update both tile shapes (N = 60).  Its VAE runs
# softsign: with relu a unit of layer 1 sits on its kink at step 0, and
# both this kernel and the one before it (bit-equal, chip_smoke.py
# --deep-ab) miss the f32 twin there by 2.3e-5 in 128 weights.
WIDE = (257, 130, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family, layers, feats, n_settings", [
    ("tied_softsign", DEPTH3, 30, 2), ("untied_relu", DEPTH3, 30, 2),
    ("vae", DEPTH3, 30, 2), ("untied_relu", DEPTH4, 30, 2),
    ("vae", DEPTH4, 30, 2), ("tied_softsign", DEPTH3, 30, 30),
    ("tied_softsign", WIDE, 330, 30), ("vae_softsign", WIDE, 330, 30)])
def test_cuda_deep_kernels_match_twin(family, layers, feats, n_settings,
                                      state_dtype):
    """The CUDA kernels against their twin on the card, 10 steps, each
    from the twin's state, with Adam in its linear regime (lr 1e-2, eps
    0.1): random decisions are bit-identical, sums differ in order, every
    parameter within 1e-6.  With 30 settings (N = 60) the plan takes
    narrow panels at F = 30 and every panel width and both update tile
    shapes at the WIDE widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    tied = family == "tied_softsign"
    cfg = MMAEConfig(num_feats=feats, layer_sizes=layers, tie_weights=tied,
                     variational=family.startswith("vae"),
                     activation="softsign" if family.endswith("softsign")
                     else "relu").validate()
    tcfg = TrainConfig(learning_rate=1e-2, batch_size=20, decay=True,
                       clip_gradients=False,
                       optimizer_state_dtype=state_dtype)
    spec = NoiseSpec.build(cfg, ModalityTable.uniform(5, feats // 5, NAMES))
    two = [{"dropout_prob": 0.5, "weight_penalty": 0.01},
           {"dropout_prob": 1.0, "weight_penalty": 0.0,
            "activation_function": "softsign"}]
    hyper = pgt.HyperStack.from_settings(
        [dict(two[i % 2], weight_penalty=0.01 * (i % 3) / 2)
         if i >= 2 else two[i] for i in range(n_settings)], cfg, tcfg)
    rng = np.random.default_rng(1)
    folded = pgt.FoldedData.from_ragged(
        [rng.random((40, feats)), rng.random((33, feats))],
        [rng.random((9, feats)), rng.random((7, feats))], device="cuda")
    g = torch.Generator().manual_seed(0)
    twin = pdk.prepare_deep_run(g, cfg, tcfg, spec, hyper, folded,
                                ptk.init_grid_params(g, cfg, n_settings, 2),
                                adam_eps=0.1)
    before = pdk.KERNELS.launches
    for step in range(10):
        run = twin.clone()
        pdk.train_deep_kernel(run, step, 1)
        pdk.train_deep_kernel_reference(twin, step, 1)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(run.params, twin.params)):
            gap = (a - b).abs()
            assert float(gap.max()) <= 1e-6, (step, i, float(gap.max()),
                                              int((gap > 1e-6).sum()))
    assert pdk.KERNELS.launches - before == 10 * pdk.launches_per_step(
        len(layers), cfg.tie_weights, cfg.variational)
