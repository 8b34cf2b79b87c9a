"""The single-run trainers and the NN baseline as step functions replayed
from CUDA graphs (``ops/step_graph.py``), against the eager loop they
replace and against the JAX package's jitted scans.

On the CPU:

- the in-place optimizer updates equal the functional updates of the
  tree this port had before (their formulas are copied below), bit for
  bit, for Adam / SGD / Adagrad, f32 and bf16 moments, with and without
  clipping, and write into the state's own tensors;
- ``trainer.train`` / ``train_classification`` and ``neural_net.train``
  equal the eager loops they replace (the functional step of that tree,
  copied below, with its learning rate built each step), bit for bit,
  with every draw live (batches, corruption, dropout, the VAE's eps);
- the same runs equal the JAX package's ``train_jit``,
  ``train_classification_jit`` and ``neural_net.train_jit`` from the same
  numpy parameters on the deterministic path (one training row, no
  corruption, keep probability 1, the VAE's eps set to 0 on both sides),
  30 steps recorded every 10: parameters within rtol 1e-5 / atol 1e-6
  (f32 sums in another order), curves within 1e-5;
- the learning-rate schedule, the updates and the step functions build no
  tensor from a host scalar;
- a kernel launch recorded into a graph is counted at each replay, not at
  capture.

On the card (``cuda``): each graphed run equals the eager loop on the card
bit for bit (parameters, optimizer state, curves, the generator's state)
and counts the same ``fused_dense`` launches; a capture that would
synchronise raises.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalautoencoder_tpu.config import MMAEConfig as JaxConfig
from multimodalautoencoder_tpu.config import TrainConfig as JaxTrainConfig
from multimodalautoencoder_tpu.data.modalities import \
    ModalityTable as JaxTable
from multimodalautoencoder_tpu.models import neural_net as jnn
from multimodalautoencoder_tpu.models.corruption import \
    NoiseSpec as JaxSpec
from multimodalautoencoder_tpu.ops import optim as joptim
from multimodalautoencoder_tpu.train import trainer as jtr
from multimodalautoencoder_tpu_torch.config import (ClassifierTrainConfig,
                                                    MMAEConfig, TrainConfig)
from multimodalautoencoder_tpu_torch.data.modalities import ModalityTable
from multimodalautoencoder_tpu_torch.models import mmae
from multimodalautoencoder_tpu_torch.models import neural_net as nn
from multimodalautoencoder_tpu_torch.models.corruption import (
    NoiseSpec, add_noise_to_batch)
from multimodalautoencoder_tpu_torch.ops import (cuda_library, dense_kernels,
                                                 optim, step_graph)
from multimodalautoencoder_tpu_torch.train import trainer

NAMES = ("call", "location", "screen", "sms", "survey")
STEPS, RECORD = 30, 10
DECAYS = {"decay": dict(decay=True, decay_steps=7, decay_rate=0.5),
          "staircase": dict(decay=True, decay_staircase=True, decay_steps=7,
                            decay_rate=0.5),
          "inert": dict(faithful_inert_decay=True)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# The eager loop this port ran before its runs were graphed: the functional
# updates and steps, copied from that tree.
# ---------------------------------------------------------------------------

def seed_update(name, grads, state, params, lr, clip_norm=None):
    tm = optim.tree_map
    if clip_norm is not None:
        grads = optim.clip_by_global_norm(grads, clip_norm)
    if name == "adam":
        b1, b2, eps = 0.9, 0.999, 1e-8
        count = state.count + 1
        cf = count.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, cf)
        bc2 = 1.0 - torch.pow(b2, cf)
        lr = lr.to(dtype=torch.float32, device=cf.device) \
            if isinstance(lr, torch.Tensor) else lr
        alpha = lr * torch.sqrt(bc2) / bc1
        es2 = bc2 * (eps * eps)
        mu = tm(lambda m, g: (b1 * m.float() + (1 - b1) * g).to(m.dtype),
                state.mu, grads)
        nu = tm(lambda v, g: (b2 * v.float() + (1 - b2) * g * g
                              ).to(v.dtype), state.nu, grads)
        new = tm(lambda p, m, v: p - (alpha * m.float())
                 * torch.rsqrt(v.float() + es2), params, mu, nu)
        return new, optim.AdamState(count=count, mu=mu, nu=nu)
    if name == "sgd":
        return (tm(lambda p, g: p - lr * g, params, grads),
                optim.SGDState(count=state.count + 1))
    acc = tm(lambda a, g: (a.float() + g * g).to(a.dtype), state.acc, grads)
    new = tm(lambda p, g, a: p - lr * g / torch.sqrt(a.float()), params,
             grads, acc)
    return new, optim.AdagradState(count=state.count + 1, acc=acc)


def seed_lr(tcfg, step):
    lr0 = torch.as_tensor(tcfg.learning_rate, dtype=torch.float32)
    if not tcfg.decay or tcfg.faithful_inert_decay:
        return lr0
    p = step.to(torch.float32) / tcfg.decay_steps
    if tcfg.decay_staircase:
        p = torch.floor(p)
    rate = torch.tensor(tcfg.decay_rate, dtype=torch.float32)
    return lr0 * torch.pow(rate, p)


def seed_step(state, cfg, tcfg, spec, x_all, y_all=None):
    g = state.generator
    idx = trainer._sample_rows(g, x_all.shape[0], tcfg.batch_size, "cpu")
    x = x_all[idx]
    y = None if y_all is None else y_all[idx]
    noisy = add_noise_to_batch(g, x, spec)

    def loss_fn(params):
        if y is None:
            return mmae.total_loss(params, cfg, noisy, x, generator=g,
                                   keep_prob=cfg.dropout_prob,
                                   train=True)[0]
        return mmae.classification_total_loss(
            params, cfg, noisy, y, generator=g, keep_prob=cfg.dropout_prob,
            train=True)[0]

    _, grads = trainer._grads(loss_fn, state.params)
    clip = tcfg.clip_norm if tcfg.clip_gradients else None
    with torch.no_grad():
        params, opt = seed_update(tcfg.optimizer, grads, state.opt_state,
                                  state.params, seed_lr(tcfg, state.step),
                                  clip)
    return trainer.TrainState(params, opt, state.step + 1, g)


def seed_train(state, cfg, tcfg, spec, x, vx, num_steps, y=None, vy=None):
    rec = []
    for s in range(num_steps):
        if s % tcfg.record_every_nth == 0:
            t_idx, v_idx = trainer._eval_batches(state, tcfg, x.shape[0],
                                                 vx.shape[0], "cpu")
            g = state.generator
            if y is None:
                rec.append([trainer.evaluate_reconstruction(
                    state.params, cfg, spec, a[i], g)
                    for a, i in ((x, t_idx), (vx, v_idx))])
            else:
                rec.append([v for a, b, i in ((x, y, t_idx), (vx, vy, v_idx))
                            for v in trainer.evaluate_classification(
                                state.params, cfg, a[i], b[i], g)])
        state = seed_step(state, cfg, tcfg, spec, x, y)
    return state, np.asarray([[float(v) for v in r] for r in rec])


def seed_nn_train(state, cfg, tx, ty, vx, vy, num_steps, record):
    def steps(state, count, out):
        for _ in range(count):
            idx = torch.randint(0, tx.shape[0], (cfg.batch_size,),
                                generator=state.generator)
            n = len(state.params.w)
            leaves = [t.detach().requires_grad_()
                      for t in (*state.params.w, *state.params.b)]
            live = nn.NNParams(w=tuple(leaves[:n]), b=tuple(leaves[n:]))
            loss = nn.loss_fn(live, cfg, tx[idx], ty[idx],
                              generator=state.generator, train=True)
            gs = torch.autograd.grad(loss, leaves)
            grads = nn.NNParams(w=tuple(gs[:n]), b=tuple(gs[n:]))
            with torch.no_grad():
                params, opt = seed_update("adam", grads, state.opt_state,
                                          state.params, cfg.learning_rate,
                                          cfg.clip_norm)
            state = nn.NNState(params, opt, state.step + 1, state.generator)
            out.append(float(loss.detach()))
        return state

    out, rec = [], []
    if record:
        n_periods = num_steps // record
        for _ in range(max(n_periods, 1)):
            rec.append((float(nn.accuracy(state.params, cfg, tx, ty)),
                        float(nn.accuracy(state.params, cfg, vx, vy))))
            state = steps(state, record if n_periods else num_steps, out)
        if n_periods:
            state = steps(state, num_steps - n_periods * record, out)
        return state, np.asarray(rec)
    return steps(state, num_steps, out), np.asarray(out, np.float32)


def assert_trees_equal(a, b):
    la, lb = optim.tree_leaves(a), optim.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# CPU: the in-place route against the eager one it replaces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [None, 0.05])
@pytest.mark.parametrize("moments", [None, torch.bfloat16])
@pytest.mark.parametrize("name", optim.OPTIMIZERS)
def test_inplace_updates_equal_the_eager_update(name, moments, clip):
    g = torch.Generator().manual_seed(0)
    params = (torch.randn((17, 9), generator=g), torch.randn(9, generator=g))
    state = optim.opt_init(name, params, moments)
    seed_p, seed_s = params, state
    params = optim.tree_map(torch.clone, params)
    state = optim.tree_map(torch.clone, state)
    tcfg = TrainConfig(**DECAYS["decay"])
    lr = trainer.learning_rate_schedule(tcfg)
    ids = [id(t) for t in optim.tree_leaves((params, state))]
    for step in range(6):
        grads = (torch.randn((17, 9), generator=g),
                 torch.randn(9, generator=g))
        seed_p, seed_s = seed_update(name, grads, seed_s, seed_p,
                                     seed_lr(tcfg, seed_s.count), clip)
        out = optim.opt_update(name, grads, state, params, lr(state.count),
                               clip_norm=clip, inplace=True)
        assert [id(t) for t in optim.tree_leaves(out)] == ids
        assert_trees_equal((params, state), (seed_p, seed_s))
    fresh = optim.opt_update(name, grads, seed_s, seed_p, 1e-3,
                             clip_norm=clip)
    want = seed_update(name, grads, seed_s, seed_p, 1e-3, clip)
    assert_trees_equal(fresh, want)


def cpu_setup(variational, phase, optimizer, batch_size=5):
    cfg = MMAEConfig(num_feats=30, layer_sizes=(16, 6),
                     variational=variational, dropout_prob=0.8,
                     classification_layer_sizes=(4,), num_labels=2
                     ).validate()
    tk = dict(optimizer=optimizer, batch_size=batch_size,
              record_every_nth=4, eval_batch_size=7, **DECAYS["decay"])
    tcfg = (TrainConfig if phase == 1 else ClassifierTrainConfig)(**tk)
    spec = NoiseSpec.build(cfg, ModalityTable.uniform(5, 6, names=NAMES))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((40, 30)).astype(np.float32))
    y = torch.from_numpy((rng.random((40, 2)) < 0.5).astype(np.float32))
    return cfg, tcfg, spec, x, y


@pytest.mark.parametrize("optimizer", optim.OPTIMIZERS)
@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("variational", [False, True])
def test_train_equals_the_eager_loop(variational, phase, optimizer):
    """Every draw live: batches, intelligent noise, element dropout,
    dropout at keep 0.8 and the VAE's eps; 10 steps recorded every 4."""
    cfg, tcfg, spec, x, y = cpu_setup(variational, phase, optimizer)
    st = trainer.init_state(3, cfg, tcfg, "cpu")
    gstate = st.generator.get_state()
    ref = trainer.TrainState(*st[:3], torch.Generator().set_state(gstate))
    before = [t.clone() for t in optim.tree_leaves(st.params)]
    if phase == 1:
        new, curves = trainer.train(st, cfg, tcfg, spec, x[:30], x[30:], 10)
        want, rec = seed_train(ref, cfg, tcfg, spec, x[:30], x[30:], 10)
        got = np.stack([curves.train_loss, curves.val_loss], 1)
    else:
        new, curves = trainer.train_classification(
            st, cfg, tcfg, spec, x[:30], y[:30], x[30:], y[30:], 10)
        want, rec = seed_train(ref, cfg, tcfg, spec, x[:30], x[30:], 10,
                               y[:30], y[30:])
        got = np.stack(curves, 1)
    assert_trees_equal((new.params, new.opt_state, new.step),
                       (want.params, want.opt_state, want.step))
    np.testing.assert_array_equal(got, rec.astype(np.float32))
    assert torch.equal(new.generator.get_state(),
                       want.generator.get_state())
    # the caller's tensors are left as they were
    for a, b in zip(optim.tree_leaves(st.params), before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("record", [0, 4, 25])
def test_nn_train_equals_the_eager_loop(record):
    """Batches and dropout (keep 0.5) live, clipping at 5; 10 steps, with
    recording every 4 (a remainder), every 25 (a run shorter than one
    period) and without (the losses)."""
    rng = np.random.default_rng(4)
    tx = torch.from_numpy(rng.random((30, 12)).astype(np.float32))
    ty = torch.from_numpy((rng.random((30, 3)) < 0.5).astype(np.float32))
    cfg = nn.NNConfig(input_size=12, layer_sizes=(8, 6), output_size=3,
                      dropout_prob=0.5, weight_penalty=1e-3, batch_size=7)
    st = nn.init_state(cfg, "cpu")
    ref = nn.NNState(*st[:3], torch.Generator().set_state(
        st.generator.get_state()))
    new, out = nn.train(st, cfg, tx, ty, tx[:9], ty[:9], 10, record)
    want, rec = seed_nn_train(ref, cfg, tx, ty, tx[:9], ty[:9], 10, record)
    assert_trees_equal((new.params, new.opt_state, new.step),
                       (want.params, want.opt_state, want.step))
    got = torch.stack(out, 1).numpy() if record else out.numpy()
    np.testing.assert_array_equal(got, rec.astype(np.float32))


@pytest.fixture
def no_host_scalars(monkeypatch):
    """torch.tensor / torch.as_tensor of anything but a tensor raise."""
    @contextlib.contextmanager
    def guard():
        for name in ("tensor", "as_tensor"):
            orig = getattr(torch, name)

            def refuse(data, *a, _orig=orig, _name=name, **kw):
                if not isinstance(data, torch.Tensor):
                    raise AssertionError(f"torch.{_name}({data!r}) in a "
                                         "step")
                return _orig(data, *a, **kw)
            monkeypatch.setattr(torch, name, refuse)
        try:
            yield
        finally:
            monkeypatch.undo()
    return guard


@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("optimizer", optim.OPTIMIZERS)
def test_steps_build_no_tensor_from_a_host_scalar(no_host_scalars,
                                                  optimizer, decay):
    cfg, _, spec, x, y = cpu_setup(True, 1, optimizer)
    tcfg = TrainConfig(optimizer=optimizer, batch_size=5, **DECAYS[decay])
    st = trainer.init_state(0, cfg, tcfg, "cpu")
    lr = trainer.learning_rate_schedule(tcfg)
    ncfg = nn.NNConfig(input_size=30, layer_sizes=(8,), output_size=2,
                       dropout_prob=0.5, batch_size=5)
    nst = nn.init_state(ncfg, "cpu")
    with no_host_scalars():
        for _ in range(2):
            trainer.unsupervised_step_(st, cfg, tcfg, spec, x, lr)
            trainer.classification_step_(st, cfg, tcfg, spec, x, y, lr)
            nn.train_step_(nst, ncfg, x[:5], y[:5])
    assert int(st.step) == 4 and int(nst.step) == 2


def test_replays_count_the_launches_their_graph_holds(monkeypatch):
    """``NvccLibrary.count`` under capture adds to ``captured``; a
    StepGraph holds the captured launches and adds them at each replay.
    (A stand-in for torch.cuda.CUDAGraph: the CPU build has none.)"""
    capturing = []

    class FakeGraph:
        def register_generator_state(self, generator):
            self.generator = generator

        def capture_begin(self):
            capturing.append(True)

        def capture_end(self):
            capturing.pop()

        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())

    class FakeStream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "current_stream", lambda: FakeStream())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: bool(capturing))
    lib = cuda_library.NvccLibrary("none.cu", "none.so")
    lib.count(2)
    graph = step_graph.StepGraph(lambda: lib.count(3), torch.Generator(),
                                 FakeStream())
    assert (lib.launches, lib.captured) == (2, 3)
    for _ in range(4):
        graph.replay()
    assert lib.launches == 2 + 4 * 3
    assert graph.held == [(lib, 3)]

    def fails():
        lib.count(1)
        raise RuntimeError("not capturable")

    with pytest.raises(RuntimeError, match="not capturable"):
        step_graph.StepGraph(fails, torch.Generator(), FakeStream())
    assert not capturing


# ---------------------------------------------------------------------------
# CPU: against the JAX package's jitted scans, on the deterministic path
# ---------------------------------------------------------------------------

def harness(variational, phase, optimizer, decay):
    """One training row, no element dropout, the empty modality set
    always drawn, keep probability 1."""
    kw = dict(num_feats=30, layer_sizes=(16, 6), variational=variational,
              activation="softsign", element_dropout_frac=0.0,
              noise_type_percentages=(1.0, 0.0, 0.0, 0.0))
    if phase == 2:
        kw.update(classification_layer_sizes=(4,), num_labels=2)
    tk = dict(learning_rate=1e-2, batch_size=8, num_steps=STEPS,
              record_every_nth=RECORD, clip_gradients=True, clip_norm=0.5,
              optimizer=optimizer, **DECAYS[decay])
    jc, pc = JaxConfig(**kw).validate(), MMAEConfig(**kw).validate()
    jspec = JaxSpec.build(jc, JaxTable.uniform(5, 6, names=NAMES))
    pspec = NoiseSpec.build(pc, ModalityTable.uniform(5, 6, names=NAMES))
    return (jc, JaxTrainConfig(**tk), jspec), (pc, TrainConfig(**tk), pspec)


@pytest.fixture
def zero_eps(monkeypatch):
    """The VAE's eps is 0 in both packages (z = mu)."""
    orig = mmae._rand
    monkeypatch.setattr(
        mmae, "_rand", lambda fn, like, g: torch.zeros_like(like)
        if fn is torch.randn else orig(fn, like, g))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.zeros(shape, dtype))


@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("optimizer", optim.OPTIMIZERS)
@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("variational", [False, True])
def test_train_matches_jax_train_jit(zero_eps, variational, phase,
                                     optimizer, decay):
    (jc, jt, jspec), (pc, pt, pspec) = harness(variational, phase,
                                               optimizer, decay)
    X = np.random.default_rng(0).random((1, 30)).astype(np.float32)
    Y = np.asarray([[1.0, 0.0]], np.float32)
    st = jtr.init_state(jax.random.PRNGKey(1), jc, jt)
    pst = trainer.state_for_params(
        mmae.params_from_numpy([np.asarray(a) for a in
                                jax.tree_util.tree_leaves(st.params)], pc,
                               device="cpu"),
        pt, torch.Generator().manual_seed(0))
    tx, ty = torch.from_numpy(X), torch.from_numpy(Y)
    # a fresh jit, so that no trace of another test (eps drawn) is reused
    if phase == 1:
        jst, jcur = jax.jit(lambda s, x: jtr.train(s, jc, jt, jspec, x, x))(
            st, jnp.asarray(X))
        pst, cur = trainer.train(pst, pc, pt, pspec, tx, tx)
    else:
        jst, jcur = jax.jit(lambda s, x, y: jtr.train_classification(
            s, jc, jt, jspec, x, y, x, y))(st, jnp.asarray(X),
                                           jnp.asarray(Y))
        pst, cur = trainer.train_classification(pst, pc, pt, pspec, tx, ty,
                                                tx, ty)
    assert int(pst.step) == int(jst.step) == STEPS
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(jst.params)]
    got = mmae.params_to_numpy(pst.params)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    for name in cur._fields:
        assert len(getattr(cur, name)) == STEPS // RECORD
        np.testing.assert_allclose(getattr(cur, name),
                                   np.asarray(getattr(jcur, name)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("record", [0, RECORD])
def test_nn_train_matches_jax_train_jit(record):
    """One training row, keep 1, clipping at 0.05 (it engages)."""
    kw = dict(input_size=12, layer_sizes=(8, 6), output_size=3,
              dropout_prob=1.0, weight_penalty=1e-3, learning_rate=1e-2,
              batch_size=10, clip_norm=0.05)
    rng = np.random.default_rng(5)
    sizes = (12, 8, 6, 3)
    leaves = [(rng.normal(size=(a, b)) * 0.4).astype(np.float32)
              for a, b in zip(sizes[:-1], sizes[1:])]
    leaves += [(rng.normal(size=(b,)) * 0.1).astype(np.float32)
               for b in sizes[1:]]
    X = rng.random((1, 12)).astype(np.float32)
    Y = np.asarray([[1.0, 0.0, 1.0]], np.float32)
    VX = rng.random((6, 12)).astype(np.float32)
    VY = (rng.random((6, 3)) < 0.5).astype(np.float32)
    n = len(leaves) // 2
    jp = jnn.NNParams(w=tuple(map(jnp.asarray, leaves[:n])),
                      b=tuple(map(jnp.asarray, leaves[n:])))
    jst = jnn.NNState(jp, joptim.adam_init(jp), jnp.zeros((), jnp.int32),
                      jax.random.PRNGKey(0))
    jst, jout = jax.jit(lambda s, x, y, vx, vy: jnn.train(
        s, jnn.NNConfig(**kw), x, y, vx, vy, STEPS, record))(
        jst, *map(jnp.asarray, (X, Y, VX, VY)))
    params = nn.params_from_numpy(leaves, "cpu")
    pst = nn.NNState(params, optim.adam_init(params),
                     torch.zeros((), dtype=torch.int32),
                     torch.Generator().manual_seed(0))
    pst, out = nn.train(pst, nn.NNConfig(**kw),
                        *map(torch.from_numpy, (X, Y, VX, VY)), STEPS,
                        record)
    assert int(pst.step) == int(jst.step) == STEPS
    for a, b in zip(nn.params_to_numpy(pst.params),
                    jax.tree_util.tree_leaves(jst.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    if record:
        for a, b in zip(out, jout):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def cuda_run(device, phase, cfg, tcfg, spec, x, y, steps, graphed):
    st = trainer.init_state(7, cfg, tcfg, device)
    if phase == 2:
        st = trainer.state_for_params(st.params, tcfg, st.generator)
    dense_kernels.KERNELS.launches = 0
    with contextlib.nullcontext() if graphed else \
            step_graph.eager_route():
        if phase == 1:
            new, cur = trainer.train(st, cfg, tcfg, spec, x[:150],
                                     x[150:], steps)
        else:
            new, cur = trainer.train_classification(
                st, cfg, tcfg, spec, x[:150], y[:150], x[150:], y[150:],
                steps)
    torch.cuda.synchronize()
    return new, cur, dense_kernels.KERNELS.launches


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [10, 1])
@pytest.mark.parametrize("pallas", [True, False])
@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("variational", [False, True])
def test_cuda_graphed_runs_equal_the_eager_loop(cuda_device, variational,
                                                phase, pallas, batch):
    """25 steps recorded every 10 (a remainder), keep 0.8, intelligent
    noise (a batch of one row draws it too), the eval batch (50 rows)
    another fused_dense M than the step's."""
    cfg = MMAEConfig(num_feats=40, layer_sizes=(32, 8),
                     variational=variational, dropout_prob=0.8,
                     use_pallas=pallas, classification_layer_sizes=(6,),
                     num_labels=2).validate()
    kw = dict(batch_size=batch, record_every_nth=10, **DECAYS["decay"])
    tcfg = (TrainConfig if phase == 1 else ClassifierTrainConfig)(**kw)
    spec = NoiseSpec.build(cfg, ModalityTable.uniform(5, 8, names=NAMES))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((200, 40)).astype(np.float32)).to(
        cuda_device)
    y = torch.from_numpy((rng.random((200, 2)) < 0.5).astype(
        np.float32)).to(cuda_device)
    eager = cuda_run(cuda_device, phase, cfg, tcfg, spec, x, y, 25, False)
    graphed = cuda_run(cuda_device, phase, cfg, tcfg, spec, x, y, 25, True)
    assert_trees_equal((graphed[0].params, graphed[0].opt_state,
                        graphed[0].step),
                       (eager[0].params, eager[0].opt_state, eager[0].step))
    for a, b in zip(graphed[1], eager[1]):
        assert len(a) == 3
        np.testing.assert_array_equal(a, b)
    assert torch.equal(graphed[0].generator.get_state(),
                       eager[0].generator.get_state())
    assert graphed[2] == eager[2] == (
        (2 * len(cfg.layer_sizes) if phase == 1 else len(cfg.layer_sizes))
        * (25 + 2 * 3) if pallas else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("record", [0, 10])
def test_cuda_nn_graphed_equals_the_eager_loop(cuda_device, record):
    rng = np.random.default_rng(2)
    tx, ty = (torch.from_numpy(a).to(cuda_device) for a in (
        rng.random((300, 50)).astype(np.float32),
        (rng.random((300, 3)) < 0.5).astype(np.float32)))
    cfg = nn.NNConfig(input_size=50, layer_sizes=(32, 16), output_size=3,
                      dropout_prob=0.5, weight_penalty=1e-3, batch_size=20)
    runs = []
    for graphed in (False, True):
        st = nn.init_state(cfg, cuda_device)
        with contextlib.nullcontext() if graphed else \
            step_graph.eager_route():
            new, out = nn.train(st, cfg, tx, ty, tx[:40], ty[:40], 25,
                                record)
        runs.append((new, torch.stack(out) if record else out))
    torch.cuda.synchronize()
    (a, oa), (b, ob) = runs
    assert_trees_equal((a.params, a.opt_state, a.step),
                       (b.params, b.opt_state, b.step))
    assert torch.equal(oa, ob)
    assert oa.shape == ((2, 2) if record else (25,))


@pytest.mark.cuda
def test_cuda_graphed_loop_makes_no_host_sync(cuda_device):
    cfg = MMAEConfig(num_feats=40, layer_sizes=(32, 8), use_pallas=True
                     ).validate()
    tcfg = TrainConfig(batch_size=10, record_every_nth=10)
    spec = NoiseSpec.build(cfg, ModalityTable.uniform(5, 8, names=NAMES))
    x = torch.rand((200, 40), device=cuda_device)
    st = trainer.init_state(0, cfg, tcfg, cuda_device)
    spec = spec.to(cuda_device)
    lr = trainer.learning_rate_schedule(tcfg, cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step_graph.run(
            lambda: trainer.unsupervised_step_(st, cfg, tcfg, spec, x, lr),
            lambda: trainer._eval_period(st, cfg, tcfg, spec, x, x[:50]),
            30, range(0, 30, 10), st.generator, cuda_device)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(out) == 3 and int(st.step) == 30


@pytest.mark.cuda
def test_cuda_capture_mid_run_leaves_queued_replays_alone(cuda_device):
    """The evaluation is captured at step 20 while the step graph's
    replays (a spin of about a millisecond each, then a draw) are still
    queued on the device; every draw must be the eager loop's.  (Before
    the capture waited for them, the generator's offset that
    ``capture_begin`` resets was read by one of them.)"""
    draws = []
    for graphed in (False, True):
        g = torch.Generator(device=cuda_device).manual_seed(0)
        out = torch.zeros((40, 8), device=cuda_device)
        k = torch.zeros(1, dtype=torch.int64, device=cuda_device)

        def step():
            torch.cuda._sleep(2_000_000)
            out.index_copy_(0, k, torch.rand((1, 8), generator=g,
                                             device=cuda_device))
            k.add_(1)

        with contextlib.nullcontext() if graphed else \
                step_graph.eager_route():
            step_graph.run(step, lambda: out.sum().reshape(1), 40,
                           range(0, 40, 20), g, cuda_device)
        draws.append(out.cpu())
    assert torch.equal(*draws)


@pytest.mark.cuda
def test_cuda_capture_failure_raises(cuda_device):
    x = torch.ones(4, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    with pytest.raises(RuntimeError):
        step_graph.run(lambda: x.sum().item(), lambda: x.sum(), 3, (0,), g,
                       cuda_device)
