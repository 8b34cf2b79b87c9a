"""The port's classification head, losses, metrics and metric battery
against the JAX package.

Same inputs, made with numpy, go through both packages' functions:
``mmae.init_head`` / ``classify`` / ``classification_total_loss`` and their
gradients (autograd against ``jax.grad``, both classify-gate modes, a
stack of instances against ``vmap``), the classification losses and
predictions, ``ops/metrics`` (ties in AUC, NaN on empty slices) and the
sweep's batched metric battery with its ledger columns.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalautoencoder_tpu.config import MMAEConfig as JaxConfig
from multimodalautoencoder_tpu.models import losses as jax_losses
from multimodalautoencoder_tpu.models import mmae as jax_mmae
from multimodalautoencoder_tpu.ops import metrics as jax_metrics
from multimodalautoencoder_tpu.sweep import wrappers as jax_wrappers
from multimodalautoencoder_tpu_torch.config import MMAEConfig
from multimodalautoencoder_tpu_torch.models import losses, mmae
from multimodalautoencoder_tpu_torch.ops import metrics, optim
from multimodalautoencoder_tpu_torch.sweep import wrappers


def configs(**kw):
    base = dict(num_feats=12, layer_sizes=(10, 5), activation="softsign",
                classification_layer_sizes=(8, 4), num_labels=3,
                classification_activation="tanh")
    base.update(kw)
    return JaxConfig(**base).validate(), MMAEConfig(**base).validate()


def shared_params(cj, ct, seed=0):
    pj = jax_mmae.init(jax.random.PRNGKey(seed), cj)
    return pj, mmae.params_from_numpy(
        [np.asarray(a) for a in jax.tree_util.tree_leaves(pj)], ct, "cpu")


@pytest.mark.parametrize("layers", [(), (8,), (8, 4)])
def test_init_head_structure_matches_jax(layers):
    """Fresh heads have the JAX package's shapes, biases 0.1 and weights
    inside the xavier bound (the draws themselves differ: two RNGs)."""
    cj, ct = configs(classification_layer_sizes=layers,
                     weight_initialization="xavier")
    wj, bj = jax_mmae.init_head(jax.random.PRNGKey(0), cj)
    wt, bt = mmae.init_head(ct, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(w.shape) for w in wt] == [w.shape for w in wj]
    assert [tuple(b.shape) for b in bt] == [b.shape for b in bj]
    for w in wt:
        bound = np.sqrt(6.0 / sum(w.shape))
        assert float(w.abs().max()) <= bound and float(w.std()) > 0
    assert all(torch.all(b == 0.1) for b in bt)


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("loss", ["sigmoid_cross_entropy", "softmax"])
@pytest.mark.parametrize("variational", [False, True])
def test_classification_total_loss_and_grads_match_jax(faithful, loss,
                                                        variational):
    cj, ct = configs(faithful_classify_gate=faithful,
                     classification_loss=loss, variational=variational,
                     classification_weight_penalty=0.01)
    pj, pt = shared_params(cj, ct)
    rng = np.random.default_rng(1)
    x = rng.random((7, 12)).astype(np.float32)
    y = (rng.integers(0, 3, 7) if loss == "softmax"
         else rng.integers(0, 2, (7, 3))).astype(np.float32)

    def jax_total(q):
        return jax_mmae.classification_total_loss(
            q, cj, jnp.asarray(x), jnp.asarray(y), sample=False)

    (lj, auxj), gj = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(pj)
    leaves = [t.requires_grad_() for t in mmae._leaves(pt)]
    it = iter(leaves)
    q = optim.tree_map(lambda _: next(it), pt)
    lt, aux = mmae.classification_total_loss(q, ct, torch.tensor(x),
                                             torch.tensor(y), sample=False)
    grads = torch.autograd.grad(lt, leaves, allow_unused=True)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=2e-6)
    for a, b in zip(jax.tree_util.tree_leaves(gj), grads):
        b = np.zeros(a.shape) if b is None else b.numpy()
        np.testing.assert_allclose(b, np.asarray(a), rtol=2e-5, atol=2e-7)
    np.testing.assert_allclose(aux["logits"].detach().numpy(),
                               np.asarray(auxj["logits"]), rtol=2e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(aux["predictions"].numpy(),
                                  np.asarray(auxj["predictions"]))


@pytest.mark.parametrize("faithful", [True, False])
def test_classify_stack_with_act_ids_matches_vmap(faithful):
    """Two instances with their own head activation (``act_id``) and
    penalty, against ``vmap`` over the JAX package's traced switch."""
    cj, ct = configs(faithful_classify_gate=faithful)
    pa, ta = shared_params(cj, ct, 0)
    pb, tb = shared_params(cj, ct, 1)
    pj = jax.tree_util.tree_map(lambda a, b: jnp.stack([a, b]), pa, pb)
    pt = optim.tree_map(lambda a, b: torch.stack([a, b]), ta, tb)
    emb = np.random.default_rng(2).normal(size=(2, 6, 5)).astype(np.float32)
    acts = np.array([1, 4], np.int32)
    want = jax.vmap(lambda p, e, a: jax_mmae.classify(p, cj, e, act_id=a))(
        pj, jnp.asarray(emb), jnp.asarray(acts))
    got = mmae.classify(pt, ct, torch.tensor(emb),
                        act_id=torch.tensor(acts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=1e-6)


def test_bf16_compute_matches_mxu_dot_policy():
    cj, ct = configs(compute_dtype="bfloat16")
    pj, pt = shared_params(cj, ct)
    emb = np.random.default_rng(3).normal(size=(6, 5)).astype(np.float32)
    want = jax_mmae.classify(pj, cj, jnp.asarray(emb))
    got = mmae.classify(pt, ct, torch.tensor(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("loss", ["sigmoid_cross_entropy", "softmax"])
def test_classification_losses_and_predictions_match_jax(loss):
    rng = np.random.default_rng(4)
    logits = (3 * rng.normal(size=(9, 4))).astype(np.float32)
    logits[0, :2] = 0.0                     # a tie and a 0.5 probability
    y = (rng.integers(0, 4, 9) if loss == "softmax"
         else rng.integers(0, 2, (9, 4))).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.classification_loss(loss, torch.tensor(logits),
                                         torch.tensor(y))),
        float(jax_losses.classification_loss(loss, jnp.asarray(logits),
                                             jnp.asarray(y))), rtol=1e-6)
    np.testing.assert_array_equal(
        losses.classification_predictions(loss, torch.tensor(logits)).numpy(),
        np.asarray(jax_losses.classification_predictions(
            loss, jnp.asarray(logits))))


def metric_inputs():
    rng = np.random.default_rng(5)
    cases = []
    for n in (1, 2, 9, 40):
        preds = rng.integers(0, 2, n).astype(np.float32)
        scores = np.round(rng.random(n), 1).astype(np.float32)   # ties
        y = rng.integers(0, 2, n).astype(np.float32)
        valid = rng.random(n) < 0.7
        cases.append((preds, scores, y, valid))
    n = 6
    cases.append((np.ones(n, np.float32), np.ones(n, np.float32),
                  np.ones(n, np.float32), np.ones(n, bool)))   # one class
    cases.append((np.zeros(n, np.float32), np.zeros(n, np.float32),
                  np.zeros(n, np.float32), np.zeros(n, bool)))   # empty
    return cases


@pytest.mark.parametrize("name", ["binary_accuracy", "roc_auc", "precision",
                                  "recall", "f1", "majority_baseline"])
def test_metrics_match_jax(name):
    fj, ft = getattr(jax_metrics, name), getattr(metrics, name)
    for preds, scores, y, valid in metric_inputs():
        for v in (None, valid):
            if name == "majority_baseline":
                args_j, args_t = (jnp.asarray(y),), (torch.tensor(y),)
            else:
                first = scores if name == "roc_auc" else preds
                args_j = (jnp.asarray(first), jnp.asarray(y))
                args_t = (torch.tensor(first), torch.tensor(y))
            want = float(fj(*args_j, None if v is None else jnp.asarray(v)))
            got = float(ft(*args_t, None if v is None else torch.tensor(v)))
            if np.isnan(want):
                assert np.isnan(got), (name, preds, y, v)
            else:
                assert abs(got - want) <= 1e-6, (name, got, want)


def test_metric_battery_and_rows_match_jax():
    """The batched (config, fold, label) battery with noisy/clean slices,
    and the ledger columns made from it, on shared predictions."""
    rng = np.random.default_rng(6)
    C, K, R, L = 3, 2, 11, 2
    preds = rng.integers(0, 2, (C, K, R, L)).astype(np.float32)
    val_y = rng.integers(0, 2, (K, R, L)).astype(np.float32)
    val_y[1, :, 1] = 1.0                        # a single-class fold
    val_n = np.array([11, 6], np.int32)
    noisy = rng.random((K, R)) < 0.4
    noisy[1] = False                            # an empty noisy slice
    want = np.asarray(jax_wrappers._batched_metric_battery(
        jnp.asarray(preds), jnp.asarray(val_y), jnp.asarray(val_n),
        jnp.asarray(noisy)))
    got = wrappers._metric_battery(torch.tensor(preds), torch.tensor(val_y),
                                   torch.tensor(val_n), torch.tensor(noisy))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, equal_nan=True)

    labels = ["happy_label", "calm_label"]
    fake_j = types.SimpleNamespace(
        sup_folded=types.SimpleNamespace(val_noisy=jnp.asarray(noisy)),
        labels=labels)
    fake_t = types.SimpleNamespace(
        sup_folded=types.SimpleNamespace(val_noisy=torch.tensor(noisy)),
        labels=labels)
    rows_j = jax_wrappers.MMAEClassificationSweep._metric_rows(
        fake_j, want, C)
    rows_t = wrappers.MMAEClassificationSweep._metric_rows(fake_t, got, C)
    for rj, rt in zip(rows_j, rows_t):
        assert list(rj) == list(rt)
        np.testing.assert_allclose([rt[k] for k in rt], [rj[k] for k in rj],
                                   atol=1e-6, equal_nan=True)
