"""The port's phase-2 kernels' plain twin against the JAX package.

``ops/cls_train_kernels.train_cls_kernel_reference`` (the CUDA kernels'
twin) is held against the Pallas kernel of
``ops/train_kernel.train_two_phase_pallas``, run as the JAX package's own
tests run it on the CPU (interpret mode), in their deterministic harness
(tests/test_train_kernel.py:401-476): one row, no corruption, keep 1,
Adam with eps 0.1 (so an update stays linear in its gradient), and the
same initial parameters and heads, carried over with
``stacked_params_from_numpy``.  Tolerances are the JAX tests' f32 ones:
2e-5 after one step, 1e-4 after several.  With bf16 operands too, since
the twin rounds every operand (cotangents included) as the Pallas kernel
does (the JAX tests' 5e-3 bounds a bf16 run against an f32 one).

The interpret-mode generator is not the port's, so the VAE step is held
against ``jax.grad`` of ``classification_total_loss`` with the twin's eps
fed in.  The CUDA kernels against the twin run on the card (``-m cuda``).
"""

import functools

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
from multimodalautoencoder_tpu_torch.ops import cls_train_kernels as pck
from multimodalautoencoder_tpu_torch.ops import philox
from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk
from multimodalautoencoder_tpu_torch.parallel import grid_trainer as pgt

NAMES = ("call", "location", "screen", "sms", "survey")
ADAM_EPS = 0.1


def make(cls_layers=(8,), softmax=False, variational=False, cls_wpen=0.0,
         lr=1e-2, compute_dtype="float32"):
    """The same two-phase bucket in both packages: (jax parts, port
    parts, X, Y)."""
    kw = dict(num_feats=30, layer_sizes=(16, 6),
              tie_weights=not variational, variational=variational,
              activation="softsign", element_dropout_frac=0.0,
              noise_type_percentages=(1.0, 0.0, 0.0, 0.0),
              classification_layer_sizes=tuple(cls_layers), num_labels=2,
              classification_loss=("softmax" if softmax
                                   else "sigmoid_cross_entropy"),
              compute_dtype=compute_dtype)
    tkw = dict(learning_rate=1e-2, batch_size=8, num_steps=0, decay=False,
               clip_gradients=False)
    ckw = dict(learning_rate=lr, batch_size=8, decay=False,
               clip_gradients=False)
    # tests/test_train_kernel.py:422-427: no unit's gradient near zero
    rng = np.random.default_rng(10)
    X = rng.random((1, 30)).astype(np.float32)
    Y = (np.array([1], np.float32) if softmax
         else rng.integers(0, 2, (1, 2)).astype(np.float32))
    hset = [{"dropout_prob": 1.0, "weight_penalty": 0.0,
             "activation_function": "softsign"}]
    cset = [{"dropout_prob": 1.0, "weight_penalty": cls_wpen,
             "activation_func": "softsign"}]
    cj = JaxConfig(**kw).validate()
    tj, ctj = JaxTrainConfig(**tkw), JaxTrainConfig(**ckw)
    ct = MMAEConfig(**kw).validate()
    tt, ctt = TrainConfig(**tkw), TrainConfig(**ckw)
    jax_side = (cj, tj, ctj,
                JaxNoiseSpec.build(cj, JaxTable.uniform(5, 6, NAMES)),
                jgt.HyperStack.from_settings(hset, cj, tj),
                jgt.ClassifierHyperStack.from_settings(cset, cj),
                jgt.FoldedData.from_ragged([X], [X]),
                jgt.FoldedData.from_ragged([X], [X], [Y], [Y]))
    port = (ct, tt, ctt,
            NoiseSpec.build(ct, ModalityTable.uniform(5, 6, NAMES)),
            pgt.HyperStack.from_settings(hset, ct, tt),
            pgt.ClassifierHyperStack.from_settings(cset, ct),
            pgt.FoldedData.from_ragged([X], [X], device="cpu"),
            pgt.FoldedData.from_ragged([X], [X], device="cpu",
                                       train_y_list=[Y], val_y_list=[Y]))
    return jax_side, port, X, Y


def jax_inits(cfg, C=1, K=1):
    """The two-phase pipeline's initial encoders and heads for key 0
    (train_kernel.py:939-942, :1901-1904), leading (C, K) axes."""
    k_p1, k_cls_init, _, _ = jax.random.split(jax.random.PRNGKey(0), 4)
    k_init, _ = jax.random.split(k_p1)
    keys = jax.random.split(k_init, C * K).reshape(C, K, 2)
    p1 = jax.vmap(jax.vmap(lambda k: jax_mmae.init(k, tk._phase1_cfg(cfg))))(
        keys)
    ck = jax.random.split(k_cls_init, C * K).reshape(C, K, 2)
    heads = jax.vmap(jax.vmap(lambda k: jax_mmae.init_head(k, cfg)))(ck)
    return p1, heads


def port_inits(cj, ct, C=1, K=1):
    p1, (cls_w, cls_b) = jax_inits(cj, C, K)
    params0 = mmae.stacked_params_from_numpy(
        jax.tree_util.tree_leaves(p1), pck.phase1_cfg(ct), "cpu")
    head0 = tuple(tuple(torch.tensor(np.asarray(a)) for a in part)
                  for part in (cls_w, cls_b))
    return params0, head0


def run_port(steps1=0, steps2=1, **kw):
    """The port's two-phase pipeline (the twin on the CPU) from the JAX
    pipeline's initial parameters: (params, losses, preds)."""
    (cj, *_), (ct, tt, ctt, st, ht, cht, ut, supt), _, _ = make(**kw)
    params0, head0 = port_inits(cj, ct)
    return pck.train_two_phase_pallas(
        0, ct, tt, ctt, st, ht, cht, ut, supt, num_steps=steps1,
        cls_num_steps=steps2, params0=params0, head0=head0,
        adam_eps=ADAM_EPS)


@functools.lru_cache(maxsize=None)
def run_both(steps1=0, steps2=1, **kw):
    """JAX's two-phase Pallas pipeline and the port's from the same
    parameters: (jax params, jax preds, port params, port preds, port
    losses, jax losses)."""
    (cj, tj, ctj, sj, hj, chj, uj, supj), _, _, _ = make(**kw)
    pj, lj, prj = tk.train_two_phase_pallas(
        jax.random.PRNGKey(0), cj, tj, ctj, sj, hj, chj, uj, supj,
        num_steps=steps1, cls_num_steps=steps2, adam_eps=ADAM_EPS)
    pt, lt, prt = run_port(steps1, steps2, **kw)
    return pj, np.asarray(prj), pt, prt.numpy(), lt.numpy(), np.asarray(lj)


def assert_params_close(pj, pt, tol):
    leaves_j = jax.tree_util.tree_leaves(pj)
    leaves_t = mmae.params_to_numpy(pt)
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_j, leaves_t):
        np.testing.assert_allclose(b, np.asarray(a), rtol=tol, atol=tol)


@pytest.mark.parametrize("cls_layers", [(8,), (8, 4), ()])
def test_twin_single_step_matches_pallas_kernel(cls_layers):
    """1-3 head layers (the empty head's only layer is gated in faithful
    mode): one phase-2 step."""
    pj, prj, pt, prt, _, _ = run_both(cls_layers=cls_layers)
    assert_params_close(pj, pt, 2e-5)
    assert prt.shape == prj.shape == (1, 1, 1, 2)
    np.testing.assert_array_equal(prt, prj)


def test_twin_weight_penalty_matches_pallas_kernel():
    """Three phase-2 steps with head L2 (after three phase-1 steps, the
    run the chained test holds too): the penalty reaches the head's
    weights only."""
    pj, _, pt, _, _, _ = run_both(steps1=3, steps2=3, cls_wpen=0.01)
    assert_params_close(pj, pt, 1e-4)


def test_twin_softmax_matches_pallas_kernel():
    """Single-label mode: the label one-hot, the softmax gradient."""
    pj, prj, pt, prt, _, _ = run_both(steps2=2, softmax=True)
    assert_params_close(pj, pt, 1e-4)
    assert prt.shape == prj.shape == (1, 1, 1)
    np.testing.assert_array_equal(prt, prj)


def test_twin_bf16_operands_match_pallas_kernel():
    """compute_dtype='bfloat16': product operands (backward cotangents
    included) rounded to bf16, f32 sums (:680-730); the casts must be
    engaged, and storage stays f32."""
    pj, _, pt, _, _, _ = run_both(steps2=3, compute_dtype="bfloat16")
    assert_params_close(pj, pt, 1e-4)
    p32, _, _ = run_port(steps2=3)
    diffs = [float(np.abs(a - b).max()) for a, b in
             zip(mmae.params_to_numpy(pt), mmae.params_to_numpy(p32))]
    assert max(diffs) > 0.0
    assert all(t.dtype == torch.float32 for t in
               (pt.enc_w + pt.cls_w))


def test_both_phases_chained_match_pallas_pipeline():
    """The slice as a whole: 3 phase-1 steps on the depth-2 twin, then 3
    phase-2 steps with head L2, against the JAX pipeline (params and
    preds), and the phase-1 objectives."""
    pj, prj, pt, prt, lt, lj = run_both(steps1=3, steps2=3, cls_wpen=0.01)
    assert_params_close(pj, pt, 1e-4)
    np.testing.assert_array_equal(prt, prj)
    np.testing.assert_allclose(lt, lj, rtol=1e-4)


@pytest.mark.parametrize("act", ["softsign", "relu"])
def test_twin_vae_step_matches_jax_grad(act):
    """One VAE phase-2 step against jax.grad of classification_total_loss
    with the twin's eps fed in (no KL in phase 2), then Adam."""
    (cj, *_), (ct, tt, ctt, st, ht, cht, ut, supt), X, Y = make(
        variational=True, cls_wpen=0.01)
    cht = pgt.ClassifierHyperStack(cht.keep_prob, cht.weight_penalty,
                                   torch.tensor([mmae.activation_id(act)],
                                                dtype=torch.int32))
    ht = pgt.HyperStack(ht.lr, ht.keep_prob, ht.weight_penalty,
                        torch.tensor([mmae.activation_id(act)],
                                     dtype=torch.int32))
    params0, head0 = port_inits(cj, ct)
    run = pck.prepare_cls_run(torch.Generator().manual_seed(0), ct, ctt, st,
                              ht, cht, supt, params0, head0, ADAM_EPS)
    eps = ptk.vae_eps(run.seeds, 0, ctt.batch_size, 6,
                      philox.CLS_EPS)[0].numpy()
    pck.train_cls_kernel_reference(run, 0, 1)

    cfg = cj.replace(activation=act, classification_activation=act)
    p1, (cls_w, cls_b) = jax_inits(cj)
    p = jax.tree_util.tree_map(lambda a: a[0, 0], p1)._replace(
        cls_w=tuple(w[0, 0] for w in cls_w),
        cls_b=tuple(b[0, 0] for b in cls_b))
    xb = jnp.asarray(np.repeat(X, ctt.batch_size, axis=0))
    yb = jnp.asarray(np.repeat(Y, ctt.batch_size, axis=0))

    def loss_fn(q):
        mu, lv = jax_mmae.encode(q, cfg, xb)
        logits = jax_mmae.classify(q, cfg, mu + eps * jnp.exp(lv))
        return (jax_losses.classification_loss(cfg.classification_loss,
                                               logits, yb)
                + jax_losses.weight_regularization(0.01, list(q.cls_w)))

    want, _ = jax_optim.adam_update(jax.jit(jax.grad(loss_fn))(p),
                                    jax_optim.adam_init(p), p,
                                    ctt.learning_rate, eps=ADAM_EPS)
    assert_params_close(jax.tree_util.tree_map(lambda a: a[None, None],
                                               want),
                        run.grid_params(1, 1, params0), 2e-5)


def test_shared_phase1_path_equals_unshared():
    """Phase 2 on a shared phase-1 stack through the identity map equals
    the two-phase pipeline bit for bit (same seeds); a non-trivial map
    changes only the remapped config (test_train_kernel.py:627)."""
    _, (ct, tt, ctt, st, _, _, ut, supt), _, _ = make()
    tt = tt.replace(num_steps=2)
    ctt = ctt.replace(num_steps=3)
    hyper = pgt.HyperStack.from_settings(
        [{"dropout_prob": 1.0, "weight_penalty": 0.0,
          "activation_function": "softsign"}] * 2, ct, tt)
    chyper = pgt.ClassifierHyperStack.from_settings(
        [{"dropout_prob": 1.0, "weight_penalty": w,
          "activation_func": "softsign"} for w in (0.0, 0.01)], ct)
    ref_p, ref_l, ref_pr = pgt.train_two_phase_sharded(
        "cpu", 7, ct, tt, ctt, st, hyper, chyper, ut, supt,
        backend="pallas")
    params_u, losses_u = pgt.train_phase1_shared(
        "cpu", pck.derive_seed(7, 1), ct, tt, st, hyper, ut,
        backend="pallas")
    assert torch.equal(losses_u, ref_l)
    got_p, got_pr = pgt.train_phase2_shared_sharded(
        "cpu", pck.derive_seed(7, 2), ct, tt, ctt, st, params_u, [0, 1],
        hyper, chyper, supt, backend="pallas")
    for a, b in zip(mmae.params_to_numpy(got_p), mmae.params_to_numpy(ref_p)):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(got_pr, ref_pr)

    remap_p, remap_pr = pgt.train_phase2_shared_sharded(
        "cpu", pck.derive_seed(7, 2), ct, tt, ctt, st, params_u, [0, 0],
        hyper, chyper, supt, backend="pallas")
    assert torch.equal(remap_pr[0], got_pr[0])
    assert torch.equal(remap_p.enc_w[0][0], got_p.enc_w[0][0])
    assert not torch.equal(remap_p.enc_w[0][1], got_p.enc_w[0][1])


def test_supported_two_phase_matches_jax_but_vmem():
    """The port's family is the JAX predicate's without its VMEM budget:
    equal on every shape here once the budget is lifted; with it, JAX
    refuses the tied 1000 -> 1000 bucket with f32 phase-1 moments (its
    phase-1 moments cannot stream) and the untied 2000-feature bucket, the
    port trains both."""
    def both(**kw):
        base = dict(num_feats=30, layer_sizes=(16, 6), num_labels=3,
                    classification_layer_sizes=(8,))
        base.update(kw.pop("cfg", {}))
        cls_t = kw.pop("cls_tcfg", {})
        out = []
        for C, T, Spec, Table in ((JaxConfig, JaxTrainConfig, JaxNoiseSpec,
                                   JaxTable),
                                  (MMAEConfig, TrainConfig, NoiseSpec,
                                   ModalityTable)):
            cfg = C(**base).validate()
            spec = Spec.build(cfg, Table.uniform(
                5, cfg.num_feats // 5, NAMES))
            t = T(batch_size=20, clip_gradients=False)
            ct = T(**dict(dict(batch_size=100, clip_gradients=False,
                               optimizer_state_dtype="bfloat16"), **cls_t))
            out.append((cfg, t, ct, spec))
        (cj, tj, ctj, sj), (cp, tp, ctp, sp) = out
        return (tk.supported_two_phase(cj, tj, ctj, sj),
                pck.supported_two_phase(cp, tp, ctp, sp))

    cases = {
        "small (8,)": dict(),
        "head (8, 4)": dict(cfg=dict(classification_layer_sizes=(8, 4))),
        "empty head": dict(cfg=dict(classification_layer_sizes=())),
        "3 hidden head layers": dict(
            cfg=dict(classification_layer_sizes=(8, 8, 8))),
        "headless": dict(cfg=dict(classification_layer_sizes=None)),
        "deep encoder": dict(cfg=dict(layer_sizes=(16, 8, 6))),
        "softmax": dict(cfg=dict(classification_loss="softmax")),
        "200 labels": dict(cfg=dict(num_labels=200)),
        "sgd phase 2": dict(cls_tcfg=dict(optimizer="sgd")),
        "clipped phase 2": dict(cls_tcfg=dict(clip_gradients=True)),
        "fixed gate": dict(cfg=dict(faithful_classify_gate=False)),
        "VAE": dict(cfg=dict(variational=True)),
        "tied 1000 -> 1000": dict(cfg=dict(num_feats=1000,
                                           layer_sizes=(1000, 100),
                                           classification_layer_sizes=(
                                               50, 20))),
        "untied 2000": dict(cfg=dict(num_feats=2000, tie_weights=False,
                                     layer_sizes=(1000, 100),
                                     classification_layer_sizes=(
                                         100, 50))),
    }
    vmem_only = {"tied 1000 -> 1000", "untied 2000"}
    got = {name: both(**dict(kw)) for name, kw in cases.items()}
    for name, (j, p) in got.items():
        if name in vmem_only:
            assert (j, p) == (False, True), name
        else:
            assert j == p, name
    assert got["small (8,)"] == (True, True)
    assert got["3 hidden head layers"] == (False, False)
    budget = tk.VMEM_BUDGET
    try:
        tk.VMEM_BUDGET = 1 << 40
        for name in vmem_only:
            assert both(**dict(cases[name])) == (True, True), name
    finally:
        tk.VMEM_BUDGET = budget


def test_cls_gates_match_jax():
    for layers in ((), (8,), (8, 4)):
        for faithful in (True, False):
            cj = JaxConfig(num_feats=30, layer_sizes=(16, 6),
                           classification_layer_sizes=layers,
                           faithful_classify_gate=faithful)
            ct = MMAEConfig(num_feats=30, layer_sizes=(16, 6),
                            classification_layer_sizes=layers,
                            faithful_classify_gate=faithful)
            assert pck.cls_gates(ct) == tk._cls_gates(cj)[:len(layers) + 1]
    assert pck.launches_per_step(3, False) == 12
    assert pck.launches_per_step(1, True) == 11


def test_twin_rows_and_labels_from_one_row():
    """Sampled labels come from the sampled row, rows stay below the
    fold's count, and element zeros follow elem_p."""
    cfg = MMAEConfig(num_feats=50, layer_sizes=(4, 2),
                     classification_layer_sizes=(3,), num_labels=2,
                     intelligent_noise=False,
                     num_modalities_to_drop=0).validate()
    X = np.repeat(np.arange(7, dtype=np.float32)[:, None] + 1.0, 50, 1)
    Y = np.stack([np.arange(7) % 2, np.arange(7) // 4], 1).astype(np.float32)
    folded = pgt.FoldedData.from_ragged([X], [X[:1]], device="cpu",
                                        train_y_list=[Y],
                                        val_y_list=[Y[:1]])
    tcfg = TrainConfig(batch_size=500, clip_gradients=False)
    hyper = pgt.HyperStack.from_settings([{}] * 2, cfg, tcfg)
    chyper = pgt.ClassifierHyperStack.from_settings([{}] * 2, cfg)
    spec = NoiseSpec.build(cfg, ModalityTable.from_feature_names(
        [f"{m}_f{i}" for m in NAMES for i in range(10)]))
    g = torch.Generator().manual_seed(0)
    run = pck.prepare_cls_run(
        g, cfg, tcfg, spec, hyper, chyper, folded,
        ptk.init_grid_params(g, pck.phase1_cfg(cfg), 2, 1),
        pck.init_heads(g, cfg, 2, 1))
    xn, y = pck.sample_cls_batch(run, 0)
    rows = xn.amax(-1).long() - 1          # zeros never hit a whole row
    assert int(rows.min()) >= 0 and int(rows.max()) <= 6
    assert torch.equal(y, torch.as_tensor(Y)[rows])
    assert len(torch.unique(rows)) == 7


@pytest.mark.cuda
@pytest.mark.parametrize("ops", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["dae", "vae"])
@pytest.mark.parametrize("loss", ["sigmoid_cross_entropy", "softmax"])
@pytest.mark.parametrize("cls_layers", [(), (8,), (8, 4)])
def test_cuda_kernels_match_twin(cls_layers, loss, family, ops):
    """The CUDA kernels against their twin on the card, 10 steps with
    corruption and dropout on, each step started from the twin's state;
    lr 1e-2 with Adam eps 0.1 keeps each update linear in its gradient.
    Random decisions and bf16 operand rounding are bit-identical, sums
    differ in order, so either operand type is held to 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    vae = family == "vae"
    cfg = MMAEConfig(num_feats=30, layer_sizes=(16, 6), tie_weights=not vae,
                     variational=vae, classification_layer_sizes=cls_layers,
                     num_labels=3, classification_loss=loss,
                     compute_dtype=ops).validate()
    tcfg = TrainConfig(learning_rate=1e-2, batch_size=20,
                       clip_gradients=False,
                       optimizer_state_dtype="bfloat16" if ops == "bfloat16"
                       else "float32")
    spec = NoiseSpec.build(cfg, ModalityTable.uniform(5, 6, NAMES))
    hyper = pgt.HyperStack.from_settings(
        [{"dropout_prob": 1.0, "activation_function": "softsign"},
         {"dropout_prob": 0.5, "activation_function": "relu"}], cfg, tcfg)
    chyper = pgt.ClassifierHyperStack.from_settings(
        [{"dropout_prob": 0.5, "weight_penalty": 0.01,
          "activation_func": "relu"},
         {"dropout_prob": 1.0, "weight_penalty": 0.0,
          "activation_func": "softsign"}], cfg)
    rng = np.random.default_rng(1)
    ys = [rng.integers(0, 3, n).astype(np.float32) if loss == "softmax"
          else rng.integers(0, 2, (n, 3)).astype(np.float32)
          for n in (40, 33)]
    folded = pgt.FoldedData.from_ragged(
        [rng.random((40, 30)), rng.random((33, 30))],
        [rng.random((9, 30)), rng.random((7, 30))], device="cuda",
        train_y_list=ys, val_y_list=[y[:9] for y in ys])
    g = torch.Generator().manual_seed(0)
    twin = pck.prepare_cls_run(
        g, cfg, tcfg, spec, hyper, chyper, folded,
        ptk.init_grid_params(g, pck.phase1_cfg(cfg), 2, 2),
        pck.init_heads(g, cfg, 2, 2), adam_eps=0.1)
    for step in range(10):
        run = twin.clone()
        before = pck.KERNELS.launches
        pck.train_cls_kernel(run, step, 1)
        assert pck.KERNELS.launches - before == pck.launches_per_step(
            len(cls_layers) + 1, vae)
        pck.train_cls_kernel_reference(twin, step, 1)
        torch.cuda.synchronize()
        for a, b in zip(run.params, twin.params):
            if a is not None:
                assert float((a - b).abs().max()) <= 1e-6, step


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [100, 37])
@pytest.mark.parametrize("cls_layers", [(), (50, 20)])
def test_cuda_kernels_match_twin_at_the_real_batch(cls_layers, batch):
    """As :func:`test_cuda_kernels_match_twin`, at the validation bucket's
    widths (1000 -> 1000 -> 100, 3 labels) and phase 2's batch of 100 and
    a ragged 37, where the products run on 8 x 8 and 8 x 4 register tiles
    over the planned panels and the update is one grouped launch: two
    instances, a head of 1 and 3 layers, 10 steps each from the twin's
    state, held to 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MMAEConfig(num_feats=1000, layer_sizes=(1000, 100),
                     tie_weights=True, classification_layer_sizes=cls_layers,
                     num_labels=3).validate()
    tcfg = TrainConfig(learning_rate=1e-2, batch_size=batch,
                       clip_gradients=False, optimizer_state_dtype="bfloat16")
    spec = NoiseSpec.build(cfg, ModalityTable.uniform(5, 200, NAMES))
    hyper = pgt.HyperStack.from_settings(
        [{"dropout_prob": 1.0, "activation_function": "softsign"},
         {"dropout_prob": 0.5, "activation_function": "relu"}], cfg, tcfg)
    chyper = pgt.ClassifierHyperStack.from_settings(
        [{"dropout_prob": 0.5, "weight_penalty": 0.01,
          "activation_func": "relu"},
         {"dropout_prob": 1.0, "weight_penalty": 0.0,
          "activation_func": "softsign"}], cfg)
    rng = np.random.default_rng(2)
    y = rng.integers(0, 2, (150, 3)).astype(np.float32)
    folded = pgt.FoldedData.from_ragged(
        [rng.random((150, 1000))], [rng.random((20, 1000))], device="cuda",
        train_y_list=[y], val_y_list=[y[:20]])
    g = torch.Generator().manual_seed(0)
    twin = pck.prepare_cls_run(
        g, cfg, tcfg, spec, hyper, chyper, folded,
        ptk.init_grid_params(g, pck.phase1_cfg(cfg), 2, 1),
        pck.init_heads(g, cfg, 2, 1), adam_eps=0.1)
    assert twin.n_inst == 2 and twin.batch == batch
    for step in range(10):
        run = twin.clone()
        before = pck.KERNELS.launches
        pck.train_cls_kernel(run, step, 1)
        assert pck.KERNELS.launches - before == pck.launches_per_step(
            len(cls_layers) + 1, False)
        pck.train_cls_kernel_reference(twin, step, 1)
        torch.cuda.synchronize()
        for name, a, b in zip(pck.SLOTS, run.params, twin.params):
            if a is not None:
                gap = float((a - b).abs().max())
                assert gap <= 1e-6, (step, name, gap)
