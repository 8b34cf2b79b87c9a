"""The training kernels' arithmetic, emulated on the CPU.

``csrc/train_common.cuh`` sums every product of kernels 2-4 (forward,
backward data and weight gradients) as a chain of exact f32 fused
multiply-adds over k, in k order, pair 0 before pair 1: the order of the
earlier CUDA-core kernel, so its products are bit for bit that kernel's.
The emulation rounds to f32 after each multiply-add, computed in f64, and
is held against the f64 product at the main path's shapes, and through
one linear-regime Adam update against plain f32 products.  (The
tensor-core schemes are emulated beside ``fused_dense``'s, in
``tests/test_torch_fused_dense.py``.)

The inputs are the sweep's: data in [0, 1] for the first layer, hidden
values in (-1, 1) otherwise, and the "normal" initialisation (truncated at
2 sigma, stddev 1 / sqrt(fan_in)).  No GPU is needed.
"""

import numpy as np
import pytest
import torch

# (M, K, N) of the main path's products: phase 1 (batch 20) and phase 2
# (batch 100) of the tied 1000 -> 100 bucket
PRODUCTS = [(20, 1000, 1000), (20, 1000, 100), (20, 100, 1000),
            (100, 1000, 1000), (100, 1000, 100)]
# (R, B, C) of its weight gradients W (R x C) = L^T (R x B) R (B x C)
WEIGHT_GRADS = [(1000, 20, 1000), (1000, 100, 1000)]


def fma_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the training kernels sum it: one f32 fused multiply-add
    per k, in k order."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(a.shape[1]):
        acc = (acc.double() + torch.outer(a[:, k].double(),
                                          b[k].double())).float()
    return acc


def fma_weight_grad(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """lhs^T rhs as the weight-gradient kernel sums it: one f32 fused
    multiply-add per batch row, in batch order."""
    return fma_product(lhs.T, rhs)


def _normal_init(rng, k, n):
    return torch.from_numpy(
        np.clip(rng.normal(size=(k, n)), -2, 2) / np.sqrt(k)).float()


def _activations(rng, m, k):
    """The batch at the input (K = 1000 features in [0, 1]), hidden values
    in (-1, 1) elsewhere."""
    if k == 1000:
        return torch.from_numpy(rng.random((m, k))).float()
    return torch.from_numpy(rng.uniform(-1, 1, (m, k))).float()


@pytest.mark.parametrize("m,k,n", PRODUCTS)
def test_product_schemes_against_f64(m, k, n):
    """At every main-path shape, for sums of magnitude up to about 3, the
    kernels' FMA chain in k order stays within 4e-6 of the f64 product (a
    sequential f32 sum; 2.8e-6 at most here)."""
    rng = np.random.default_rng(m + k + n)
    a, b = _activations(rng, m, k), _normal_init(rng, k, n)
    exact = a.double() @ b.double()
    assert float((fma_product(a, b).double() - exact).abs().max()) <= 4e-6


@pytest.mark.parametrize("r,b,c", WEIGHT_GRADS)
def test_weight_grad_scheme_against_f64(r, b, c):
    """The weight gradient's f32 FMA chain over the batch is within 1e-6
    of the f64 product relative to its largest element (sums of 20 or 100
    terms of magnitude up to 1)."""
    rng = np.random.default_rng(r + b + c)
    lhs, rhs = _activations(rng, b, r), _activations(rng, b, c + 1)[:, :c]
    exact = lhs.double().T @ rhs.double()
    err = float((fma_weight_grad(lhs, rhs).double() - exact).abs().max())
    assert err <= 1e-6 * float(exact.abs().max()), err


@pytest.mark.parametrize("batch", [20, 100])
def test_linear_regime_adam_update(batch):
    """One layer's forward product by the kernels' FMA chain, phase 2's
    loss gradient (sigmoid(z) - y) / (B L) with L = 3 labels, the weight
    gradient by the FMA chain, and one Adam update from zero moments in
    its linear regime (lr 1e-2, eps 0.1, as chip_smoke [11]): it lies
    within 1e-7 of the same update from plain f32 products, a tenth of
    [11]'s 1e-6.  (A smooth layer: no relu kink, no eps-1e-8 sign flip.)"""
    rng = np.random.default_rng(batch)
    m, k, n = batch, 1000, 1000
    x, w = _activations(rng, m, k), _normal_init(rng, k, n)
    y = torch.from_numpy(rng.random((m, n))).float()

    def update(z, weight_grad):
        g = weight_grad(x, (torch.sigmoid(z) - y) / (m * 3))
        lr, eps, b1, b2 = 1e-2, 0.1, 0.9, 0.999
        alpha = lr * (1 - b2) ** 0.5 / (1 - b1)
        mom, var = (1 - b1) * g, (1 - b2) * g * g
        return alpha * mom * torch.rsqrt(var + (1 - b2) * eps * eps)

    got = update(fma_product(x, w), fma_weight_grad)
    want = update(x @ w, lambda lhs, rhs: lhs.T @ rhs)
    assert float((got - want).abs().max()) <= 1e-7


def test_cls_launch_type_bounds():
    """The phase-2 validation bucket (tied 1000 -> 100, head 50 -> 20 -> 3,
    N = 80, B = 100, bf16 moments), launch type by launch type: every type
    of the kernels, the weight gradient + Adam bound by its 16 B a
    parameter and the activations it reads, the forward products by their
    f32 multiply-adds, and together no less than the step's own bound."""
    from multimodalautoencoder_tpu_torch.config import MMAEConfig
    from multimodalautoencoder_tpu_torch.ops import cls_train_kernels as pck
    from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk

    cfg = MMAEConfig(num_feats=1000, layer_sizes=(1000, 100),
                     tie_weights=True, classification_layer_sizes=(50, 20),
                     num_labels=3).validate()
    n, b = 80, 100
    step = pck.cls_step_bound(cfg, n, b, True)
    types = pck.cls_launch_type_bounds(cfg, n, b, True)
    assert set(types) == set(pck.LAUNCH_TYPES)
    weights = 1000 * 1000 + 1000 * 100 + 100 * 50 + 50 * 20 + 20 * 3
    wga = types["weight_grad_adam"]
    assert wga["bound_by"] == "bytes"
    assert 16 * n * weights <= wga["bytes"] <= 18 * n * weights
    fwd = types["forward_products"]
    assert fwd["bound_by"] == "operations"
    assert fwd["bound_ms"] >= 2.0 * n * b * weights \
        / ptk.H100_F32_FLOP_PER_S * 1e3
    assert sum(t["bound_ms"] for t in types.values()) >= step["bound_ms"]
