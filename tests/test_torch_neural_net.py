"""The port's NN baseline model (``models/neural_net.py``) against the JAX
package's: from the same numpy parameters and the same batches, at keep
1.0 (no dropout draw), each Adam step's loss, gradients and clipped update
equal ``loss_fn`` + ``optim.adam_update`` of the JAX package (the body of
its ``train``) within 1e-6 relative (float32 sums in another order);
``predict`` and ``accuracy`` are equal; the initial weights and the
dropout keep rate follow their distributions within a binomial band;
checkpoints cross-load both ways; and ``train``'s recording keeps the
JAX package's step count, including a run shorter than one period."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalautoencoder_tpu.models import neural_net as jnn
from multimodalautoencoder_tpu.ops import optim as joptim
from multimodalautoencoder_tpu_torch.models import neural_net as nn
from multimodalautoencoder_tpu_torch.ops import optim

CFG = dict(input_size=12, layer_sizes=(8, 6), output_size=3,
           dropout_prob=1.0, weight_penalty=1e-3, learning_rate=1e-3,
           batch_size=10)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def numpy_params(seed=0, cfg=CFG):
    rng = np.random.default_rng(seed)
    sizes = (cfg["input_size"],) + cfg["layer_sizes"] + (cfg["output_size"],)
    ws = [(rng.normal(size=(a, b)) * 0.4).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [(rng.normal(size=(b,)) * 0.1).astype(np.float32)
          for b in sizes[1:]]
    return ws + bs


def batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.random((CFG["batch_size"], CFG["input_size"]),
                        dtype=np.float32),
             (rng.random((CFG["batch_size"], CFG["output_size"])) < 0.5
              ).astype(np.float32)) for _ in range(n)]


def jax_params(leaves):
    n = len(leaves) // 2
    return jnn.NNParams(w=tuple(map(jnp.asarray, leaves[:n])),
                        b=tuple(map(jnp.asarray, leaves[n:])))


def assert_leaves_close(got, want, rtol=1e-6):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol,
                                   atol=rtol * np.abs(np.asarray(w)).max())


@pytest.mark.parametrize("clip_norm", [1e-2, 5.0])
def test_steps_match_jax_loss_grads_and_clipped_adam(clip_norm):
    """Three steps on injected batches: loss, gradients (before clipping)
    and the parameters after each clipped Adam update.  At clip_norm
    1e-2 the clip engages on every step; at 5.0 it does not."""
    leaves = numpy_params()
    jcfg = jnn.NNConfig(**CFG, clip_norm=clip_norm)
    pcfg = nn.NNConfig(**CFG, clip_norm=clip_norm)
    jp = jax_params(leaves)
    jst = joptim.adam_init(jp)
    params = nn.params_from_numpy(leaves, "cpu")
    state = nn.NNState(params, optim.adam_init(params),
                       torch.zeros((), dtype=torch.int32),
                       torch.Generator().manual_seed(0))
    engaged = []
    for x, y in batches(3):
        loss, grads = jax.value_and_grad(jnn.loss_fn)(
            jp, jcfg, jnp.asarray(x), jnp.asarray(y),
            rng=jax.random.PRNGKey(0), train=True)
        engaged.append(float(joptim.global_norm(grads)) > clip_norm)
        jp, jst = joptim.adam_update(grads, jst, jp, jcfg.learning_rate,
                                     clip_norm=clip_norm)
        state, p_loss, p_grads = nn.train_step(
            state, pcfg, torch.from_numpy(x), torch.from_numpy(y))
        assert float(p_loss) == pytest.approx(float(loss), rel=1e-6)
        assert_leaves_close(nn.params_to_numpy(p_grads),
                            jax.tree_util.tree_leaves(grads))
        assert_leaves_close(nn.params_to_numpy(state.params),
                            jax.tree_util.tree_leaves(jp))
    assert all(engaged) if clip_norm < 1 else not any(engaged)
    assert int(state.step) == 3 and int(state.opt_state.count) == 3


def test_predict_and_accuracy_match_jax():
    leaves = numpy_params(seed=3)
    x, y = batches(1, seed=4)[0]
    jp, pp = jax_params(leaves), nn.params_from_numpy(leaves, "cpu")
    jcfg, pcfg = jnn.NNConfig(**CFG), nn.NNConfig(**CFG)
    want = np.asarray(jnn.predict(jp, jcfg, jnp.asarray(x)))
    got = nn.predict(pp, pcfg, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert float(nn.accuracy(pp, pcfg, torch.from_numpy(x),
                             torch.from_numpy(y))) == pytest.approx(
        float(jnn.accuracy(jp, jcfg, jnp.asarray(x), jnp.asarray(y))),
        abs=1e-7)


def test_init_statistics_and_dropout_keep_rate():
    """Truncated normal at +-2 std with std 1/sqrt(fan_in) (the truncated
    distribution's std is 0.8796 of it), biases 0.1; the dropout keeps each
    unit at the keep rate and scales it by 1/keep.  Bands: 5 standard
    errors."""
    cfg = nn.NNConfig(input_size=1000, layer_sizes=(500,), output_size=400)
    p = nn.init(torch.Generator().manual_seed(0), cfg, "cpu")
    for w, fan_in in zip(p.w, (1000, 500)):
        std = 1.0 / np.sqrt(fan_in)
        a = w.numpy()
        assert np.abs(a).max() <= 2 * std * (1 + 1e-6)
        assert a.std() == pytest.approx(0.8796 * std,
                                        abs=5 * 0.8796 * std / np.sqrt(
                                            a.size / 2))
        assert abs(a.mean()) <= 5 * 0.8796 * std / np.sqrt(a.size)
    assert all(bool((b == 0.1).all()) for b in p.b)
    jw = np.asarray(jnn.init(jax.random.PRNGKey(0), jnn.NNConfig(
        input_size=1000, layer_sizes=(500,), output_size=400)).w[0])
    assert jw.std() == pytest.approx(p.w[0].numpy().std(), rel=0.01)

    keep = 0.7
    ident = nn.NNParams(w=(torch.eye(2000), torch.eye(2000)),
                        b=(torch.zeros(2000), torch.zeros(2000)))
    h = nn.apply(ident, nn.NNConfig(activation="none"),
                 torch.ones(50, 2000), keep_prob=keep, train=True,
                 generator=torch.Generator().manual_seed(1))
    kept = h != 0
    n = kept.numel()
    assert float(kept.float().mean()) == pytest.approx(
        keep, abs=5 * np.sqrt(keep * (1 - keep) / n))
    assert torch.allclose(h[kept], torch.full_like(h[kept], 1 / keep))


def test_checkpoints_cross_load_both_ways(tmp_path):
    leaves = numpy_params(seed=5)
    pcfg = nn.NNConfig(**CFG, seed=3)
    curves = {"train_acc": [0.5, 0.75], "val_acc": [0.25, 0.5]}
    path = nn.save_model(str(tmp_path), "port",
                         nn.params_from_numpy(leaves, "cpu"), pcfg, curves)
    jp, jcfg, jcurves = jnn.load_model(path)
    assert jcfg == jnn.NNConfig(**CFG, seed=3)
    for a, b in zip(jax.tree_util.tree_leaves(jp), leaves):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(jcurves["val_acc"], curves["val_acc"])

    jpath = jnn.save_model(str(tmp_path), "jax", jax_params(leaves),
                           jnn.NNConfig(**CFG), curves)
    pp, cfg2, curves2 = nn.load_model(jpath, device="cpu")
    assert cfg2 == nn.NNConfig(**CFG)
    for a, b in zip(nn.params_to_numpy(pp), leaves):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(curves2["train_acc"], curves["train_acc"])


@pytest.mark.parametrize("num_steps,record,records",
                         [(4, 10, 1), (25, 10, 2), (20, 0, 0)])
def test_train_runs_exactly_num_steps(num_steps, record, records):
    """A run shorter than one record period records once at entry and
    runs exactly num_steps (the JAX package's :150-159); otherwise one
    record a full period and the remainder after; without records, one
    loss a step.  Recording draws nothing: the final parameters equal a
    run without it."""
    cfg = nn.NNConfig(**dict(CFG, dropout_prob=0.5))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((40, 12), dtype=np.float32))
    y = torch.from_numpy((rng.random((40, 3)) < 0.5).astype(np.float32))
    st, out = nn.train(nn.init_state(cfg, "cpu"), cfg, x, y, x[:8], y[:8],
                       num_steps=num_steps, record_every_nth=record)
    assert int(st.step) == num_steps
    if record:
        ta, va = out
        assert ta.shape == va.shape == (records,)
        assert bool(((ta >= 0) & (ta <= 1)).all())
    else:
        assert out.shape == (num_steps,)
    plain, _ = nn.train(nn.init_state(cfg, "cpu"), cfg, x, y, x[:8], y[:8],
                        num_steps=num_steps)
    for a, b in zip(nn.params_to_numpy(st.params),
                    nn.params_to_numpy(plain.params)):
        np.testing.assert_array_equal(a, b)


def test_jax_train_short_run_counts_the_same_steps():
    """The JAX ``train`` on the same short run takes the same number of
    steps and records the same number of entries as the port's."""
    jcfg = jnn.NNConfig(**CFG)
    rng = np.random.default_rng(2)
    x = rng.random((40, 12), dtype=np.float32)
    y = (rng.random((40, 3)) < 0.5).astype(np.float32)
    jst = jnn.init_state(jax.random.PRNGKey(0), jcfg)
    jst, (ta, _) = jnn.train(jst, jcfg, jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(x[:8]), jnp.asarray(y[:8]),
                             num_steps=4, record_every_nth=10)
    pcfg = nn.NNConfig(**CFG)
    pst, (pta, _) = nn.train(nn.init_state(pcfg, "cpu"), pcfg,
                             torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(x[:8]), torch.from_numpy(y[:8]),
                             num_steps=4, record_every_nth=10)
    assert int(jst.step) == int(pst.step) == 4
    assert np.asarray(ta).shape == tuple(pta.shape) == (1,)


@pytest.mark.cuda
def test_cuda_step_matches_cpu_step(cuda_device):
    """One step on the card against the same step on the CPU (TF32 off),
    from the same parameters and batch, at keep 1.0: loss, gradients and
    the updated parameters within 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    leaves = numpy_params(seed=7)
    x, y = batches(1, seed=8)[0]
    cfg = nn.NNConfig(**CFG, clip_norm=1e-2)
    out = {}
    for dev in ("cpu", cuda_device):
        params = nn.params_from_numpy(leaves, dev)
        st = nn.NNState(params, optim.adam_init(params),
                        torch.zeros((), dtype=torch.int32, device=dev),
                        torch.Generator(device=dev).manual_seed(0))
        st, loss, grads = nn.train_step(st, cfg, torch.from_numpy(x).to(dev),
                                        torch.from_numpy(y).to(dev))
        out[str(dev)] = (float(loss), nn.params_to_numpy(grads),
                         nn.params_to_numpy(st.params))
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out[str(cuda_device)]
    assert lg == pytest.approx(lc, abs=1e-5)
    for a, b in zip(gg + pg, gc + pc):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
