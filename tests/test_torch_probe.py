"""The port's embedding-quality probe (``sweep/probe.py``) against the JAX
package's ``probe_grid`` (sweep/probe.py:156-203) on the same DAE
parameters and folds.

A DAE embeds deterministically, so both probes see the same embeddings;
the exact (T, T) kernel ridge then differs only in the solver's rounding,
and the random-Fourier primal is fed the JAX draws of W and b.  The
metrics are of hard predictions (scores > 0), so on data whose scores
stay clear of 0 they agree exactly: acc and auc to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalautoencoder_tpu.config import MMAEConfig as JaxConfig
from multimodalautoencoder_tpu.models import mmae as jax_mmae
from multimodalautoencoder_tpu.parallel import grid_trainer as jgt
from multimodalautoencoder_tpu.sweep import probe as jax_probe
from multimodalautoencoder_tpu_torch.config import MMAEConfig
from multimodalautoencoder_tpu_torch.models import mmae
from multimodalautoencoder_tpu_torch.ops import optim
from multimodalautoencoder_tpu_torch.parallel import grid_trainer as pgt
from multimodalautoencoder_tpu_torch.sweep import probe

F, E = 10, 6
CS, GAMMAS = (1.0, 10.0), (0.1, 0.01)


def folds(rng, K=2, n=(60, 50), v=(30, 26), labels=2):
    """Separable-ish folds: feature l carries label l, the rest is noise;
    val rows flagged noisy at random."""
    tx, vx, ty, vy, vn = [], [], [], [], []
    for k in range(K):
        for rows, xs, ys in ((n[k], tx, ty), (v[k], vx, vy)):
            y = rng.integers(0, 2, (rows, labels)).astype(np.float32)
            x = rng.normal(size=(rows, F)).astype(np.float32) * 0.3
            x[:, :labels] += 2.0 * y - 1.0
            xs.append(x)
            ys.append(y)
        vn.append(rng.random(v[k]) < 0.4)
    return tx, vx, ty, vy, vn


def both(rng_seed=0, C=2, K=2):
    rng = np.random.default_rng(rng_seed)
    tx, vx, ty, vy, vn = folds(rng, K)
    fj = jgt.FoldedData.from_ragged(tx, vx, train_y_list=ty, val_y_list=vy,
                                    val_noisy_list=vn)
    ft = pgt.FoldedData.from_ragged(tx, vx, "cpu", train_y_list=ty,
                                    val_y_list=vy, val_noisy_list=vn)
    kw = dict(num_feats=F, layer_sizes=(8, E), tie_weights=False)
    cj, ct = JaxConfig(**kw).validate(), MMAEConfig(**kw).validate()
    keys = jax.random.split(jax.random.PRNGKey(3), C * K).reshape(C, K, 2)
    pj = jax.vmap(jax.vmap(lambda k: jax_mmae.init(k, cj)))(keys)
    pt = mmae.stacked_params_from_numpy(jax.tree_util.tree_leaves(pj), ct,
                                        "cpu")
    acts = np.array([3, 2][:C], np.int32)      # softsign, tanh
    return (cj, pj, fj), (ct, pt, ft), acts


def jax_rff_draws(rng, C, K, D):
    """W (C, K, E, D) and b (C, K, D) as probe_grid draws them for each
    (config, fold) key (probe.py:79, :96-100, :184)."""
    keys = jax.random.split(rng, C * K).reshape((C, K) + rng.shape)
    W = np.zeros((C, K, E, D), np.float32)
    b = np.zeros((C, K, D), np.float32)
    for c in range(C):
        for k in range(K):
            _, _, k_rff = jax.random.split(keys[c, k], 3)
            kw, kb = jax.random.split(k_rff)
            W[c, k] = np.asarray(jax.random.normal(kw, (E, D), jnp.float32))
            b[c, k] = np.asarray(jax.random.uniform(
                kb, (D,), jnp.float32, 0.0, 2.0 * np.pi))
    return torch.as_tensor(W), torch.as_tensor(b)


@pytest.mark.parametrize("rff_dim", [None, 64])
def test_probe_grid_matches_jax(rff_dim):
    (cj, pj, fj), (ct, pt, ft), acts = both()
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jax_probe.probe_grid(
        rng, pj, jnp.asarray(acts), fj, cfg=cj, Cs=CS, gammas=GAMMAS,
        num_labels=2, rff_dim=rff_dim))
    rff = None if rff_dim is None else jax_rff_draws(rng, 2, 2, rff_dim)
    got = probe.probe_grid(0, pt, torch.as_tensor(acts), ft, cfg=ct, Cs=CS,
                           gammas=GAMMAS, num_labels=2, rff_dim=rff_dim,
                           rff=rff).numpy()
    assert got.shape == want.shape == (2, 2, 2, 3, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[:, :, :, 0, 0] > 0.8).all()      # the signal is found


def test_sqdist_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(7, 5)).astype(np.float32)
    b = rng.normal(size=(4, 5)).astype(np.float32)
    want = np.asarray(jax_probe._sqdist(jnp.asarray(a), jnp.asarray(b)))
    got = probe._sqdist(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got >= 0).all()


@pytest.mark.parametrize("rff_dim", [None, 256])
def test_device_probe_separates(rff_dim):
    """tests/test_sweep.py:262-303 on the port: a linearly separable
    embedding scores near-perfectly, and without noisy flags the noisy
    slice is empty (0)."""
    rng = np.random.default_rng(0)
    n, f = 120, 10
    y = rng.integers(0, 2, size=2 * n).astype(float)
    X = rng.normal(size=(2 * n, f)).astype(np.float32) * 0.1
    X[:, 0] = y * 2.0 - 1.0 + rng.normal(size=2 * n) * 0.05
    folded = pgt.FoldedData.from_ragged(
        [X[:n]], [X[n:]], "cpu", train_y_list=[y[:n, None]],
        val_y_list=[y[n:, None]])
    cfg = MMAEConfig(num_feats=f, layer_sizes=(8, 6),
                     tie_weights=False).validate()
    params = optim.tree_map(lambda t: t[None, None], mmae.init(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    best = probe.probe_grid(1, params, torch.zeros((1,), dtype=torch.int32),
                            folded, cfg=cfg, Cs=(1.0, 10.0),
                            gammas=(0.1, 0.01), num_labels=1,
                            rff_dim=rff_dim).numpy()
    assert best.shape == (1, 1, 1, 3, 2)
    assert best[0, 0, 0, 0, 0] > 0.9 and best[0, 0, 0, 0, 1] > 0.9
    assert (best[0, 0, 0, 1, :] == 0).all()


def test_vae_probe_embeds_with_sampled_z():
    """A VAE embeds with z sampled from the probe's generator (:80-85):
    one seed gives the same scores twice, each in [0, 1]."""
    (_, _, _), (ct, _, ft), acts = both()
    cfg = ct.replace(variational=True, tie_weights=False,
                     layer_sizes=(8, E)).validate()
    g = torch.Generator().manual_seed(0)
    insts = [mmae.init(cfg, generator=g, device="cpu") for _ in range(4)]
    stacked = optim.tree_map(lambda *t: torch.stack(t).reshape(
        (2, 2) + t[0].shape), *insts)
    kw = dict(cfg=cfg, Cs=CS, gammas=GAMMAS, num_labels=2, rff_dim=32)
    a = probe.probe_grid(5, stacked, torch.as_tensor(acts), ft, **kw)
    b = probe.probe_grid(5, stacked, torch.as_tensor(acts), ft, **kw)
    assert torch.equal(a, b)
    assert torch.isfinite(a).all() and (a >= 0).all() and (a <= 1).all()


def test_probe_survives_a_diverged_instance():
    """A diverged instance (NaN parameters) gets NaN scores, so all-zero
    predictions, as jax.scipy.linalg.solve gives in the JAX package: its
    metrics stay in [0, 1] and the probe raises nothing."""
    (_, _, _), (ct, pt, ft), acts = both()
    broken = optim.tree_map(lambda t: t.clone(), pt)
    broken.enc_w[0][1, 0].fill_(float("nan"))
    for rff_dim in (None, 32):
        best = probe.probe_grid(0, broken, torch.as_tensor(acts), ft,
                                cfg=ct, Cs=CS, gammas=GAMMAS, num_labels=2,
                                rff_dim=rff_dim)
        assert torch.isfinite(best).all()
        assert (best >= 0).all() and (best <= 1).all()
