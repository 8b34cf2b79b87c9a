"""The port's fused dense layer against the JAX package's Pallas kernel.

On the CPU the port's ``fused_dense`` runs its plain PyTorch version; the
JAX side runs the Pallas kernel in interpret mode, as tests/test_pallas.py
does.  Both get the same inputs, made with numpy.  The CUDA kernel itself
is compared with the plain version by the ``cuda``-marked test, which
skips without a GPU.

The gradients of the port's autograd Function are held against
``jax.grad`` of the Pallas version (its custom VJP) at 1e-5.

Tolerances: f32 rtol = atol = 2e-5 (the two sum K products in different
orders; K <= 256 here).  bf16 operands 1e-4: the operands are rounded to
bf16 identically on both sides, but the sums still differ in order.

The CUDA kernel computes f32 products as exact FMAs in k order
(``csrc/fused_dense.cu``).  It once computed them as 3xTF32 on the tensor
cores; a plain emulation of that scheme is held against an f64 product at
the serve shapes on the CPU: well inside the 1e-4 tolerance, but with
each instruction's cut toward zero, which is why f32 left the tensor
cores (the ``cuda`` test at the training shapes holds the served kernel's
lean).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalautoencoder_tpu.ops import pallas_kernels as pk
from multimodalautoencoder_tpu_torch.config import ACTIVATIONS
from multimodalautoencoder_tpu_torch.ops import dense_kernels as dk

SHAPES = [(20, 96, 64), (37, 96, 70), (600, 256, 700)]
# the kernel's cases on the card besides SHAPES: the four serve layers of
# the tied 1000 -> 100 DAE over 2000 rows (N = 100 with K split across a
# cluster; K = 100 leaves a partial last K tile of 4), a K that is no
# multiple of 4 with unaligned rows (4-byte staging), 4-byte staging with
# an 8-way K split, and an 8-way split with 16-byte staging.  Each runs on
# both orientations of w.  (37, 96, 70) above has unaligned 70-float rows.
CUDA_SHAPES = SHAPES + [(2000, 1000, 1000), (2000, 1000, 100),
                        (2000, 100, 1000), (300, 45, 130), (64, 1000, 70),
                        (300, 1000, 100)]
# (M, K, N, w is the tied decoder's transposed view) of the serve forward
SERVE_LAYERS = [(2000, 1000, 1000, False), (2000, 1000, 100, False),
                (2000, 100, 1000, True), (2000, 1000, 1000, True)]


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    return x, w, b


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("act", ACTIVATIONS)
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_dense_matches_pallas(shape, act, bf16):
    x, w, b = _inputs(*shape)
    want = np.asarray(pk.fused_dense(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), act, bf16))
    got = dk.fused_dense(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), act, bf16).numpy()
    tol = 1e-4 if bf16 else 2e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("final", [None, "tanh"])
def test_fused_mlp_matches_pallas(final):
    rng = np.random.default_rng(1)
    dims = (40, 24, 12, 6)
    x = rng.random((17, dims[0])).astype(np.float32)
    ws = [(rng.normal(size=(a, b)) * 0.2).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    bs = [np.full(b, 0.1, np.float32) for b in dims[1:]]
    want = np.asarray(pk.fused_mlp(jnp.asarray(x), [jnp.asarray(w)
                                                    for w in ws],
                                   [jnp.asarray(b) for b in bs],
                                   "softplus", final))
    got = dk.fused_mlp(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                       [torch.from_numpy(b) for b in bs], "softplus", final)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("act", ACTIVATIONS)
def test_fused_dense_gradients_match_pallas_vjp(act, bf16, tied):
    """The autograd Function's dx, dw, db against ``jax.grad`` of the
    Pallas ``fused_dense`` (interpret mode, its custom VJP) within 1e-5:
    the same formulas on the forward's output, in f32 whatever ``bf16``
    is.  ``tied`` passes the weight as the tied decoder does, a transposed
    view of a leaf, and its gradient comes back to the leaf."""
    x, w, b = _inputs(20, 48, 32, seed=5)
    g = np.random.default_rng(6).normal(size=(20, 32)).astype(np.float32)

    def loss(xx, ww, bb):
        return jnp.sum(pk.fused_dense(xx, ww, bb, act, bf16) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                             jnp.asarray(b))
    tx, tb = (torch.tensor(a, requires_grad=True) for a in (x, b))
    leaf = torch.tensor(np.ascontiguousarray(w.T) if tied else w,
                        requires_grad=True)
    out = dk.fused_dense(tx, leaf.T if tied else leaf, tb, act, bf16)
    (out * torch.from_numpy(g)).sum().backward()
    dw = leaf.grad.T if tied else leaf.grad
    for got, ref in zip((tx.grad, dw, tb.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x, w, b = _inputs(37, 96, 70)
    before = dk.KERNELS.launches
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    got = dk.fused_dense(tx, tw, tb, "tanh")
    torch.testing.assert_close(
        got, dk.fused_dense_reference(tx, tw, tb, "tanh"), rtol=0, atol=0)
    assert dk.KERNELS.launches == before


def test_transposed_weight_view_reads_as_laid_out():
    """The tied decoder passes ``w.T``: a strided view, never read as
    row-major."""
    x, w, b = _inputs(20, 64, 96)
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).T
    assert not wt.is_contiguous()
    got = dk.fused_dense(torch.from_numpy(x), wt, torch.from_numpy(b),
                         "softsign")
    want = np.asarray(pk.fused_dense(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), "softsign"))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_nan_passes_through_relu_and_softplus():
    x = torch.tensor([[float("nan")], [-1.0]])
    w = torch.ones((1, 1))
    b = torch.zeros(1)
    for act in ("relu", "softplus"):
        out = dk.fused_dense(x, w, b, act)
        assert torch.isnan(out[0, 0]) and torch.isfinite(out[1, 0])


def test_other_devices_raise():
    t = torch.empty((2, 2), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        dk.fused_dense(t, t, torch.empty(2, device="meta"))


def test_failed_build_raises(tmp_path):
    """A build that cannot happen is an error, never a fallback."""
    src = tmp_path / "broken.cu"
    src.write_text("this is not CUDA\n")
    lib = dk.CudaLibrary(source=str(src), library=str(tmp_path / "lib.so"))
    assert lib.stale()
    with pytest.raises((RuntimeError, OSError)):
        lib.load()
    assert lib.launches == 0


def _tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """Each f32 element rounded to TF32 (10 mantissa bits; to nearest,
    ties away from zero) by bit arithmetic, as ``cvt.rna.tf32.f32``."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def test_tf32_rounding_emulation():
    t = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 3 * 2.0 ** -11), 1.0 + 2.0 ** -10 - 2.0 ** -23])
    want = [1.0, 1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -9), 1.0 + 2.0 ** -10]
    assert _tf32_rna(t).tolist() == want


@pytest.mark.parametrize("m,k,n,tied", SERVE_LAYERS)
def test_3xtf32_scheme_sits_inside_the_tolerance(m, k, n, tied):
    """3xTF32 arithmetic, emulated: x = xh + xl, w = wh + wl with
    each part rounded to TF32, and the sum of xl wh + xh wl + xh wh (each
    product of TF32 values exact in f32, the sums in f32).  At the serve
    shapes, with the serve path's inputs (data in [0, 1] at K = 1000, hidden
    values in (-1, 1) otherwise, Xavier weights), it stays within 1e-5 of
    the f64 product: a tenth of the kernel's 1e-4.  Plain TF32 (xh wh
    alone) misses 1e-4, which is why a TF32 kernel takes three products."""
    rng = np.random.default_rng(k + n + tied)
    x = rng.random((m, k)).astype(np.float32)
    if k != 1000:
        x = 2 * x - 1
    bound = (6.0 / (k + n)) ** 0.5
    w = rng.uniform(-bound, bound, (n, k) if tied else (k, n))
    w = np.ascontiguousarray(w.T if tied else w).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    xh, wh = _tf32_rna(tx), _tf32_rna(tw)
    xl, wl = _tf32_rna(tx - xh), _tf32_rna(tw - wh)
    exact = tx.double() @ tw.double()
    three = xl @ wh + xh @ wl + xh @ wh
    err = float((three.double() - exact).abs().max())
    plain_tf32 = float(((xh @ wh).double() - exact).abs().max())
    assert err <= 1e-5, err
    assert plain_tf32 > 1e-4, plain_tf32


def _to_f32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """An f64 tensor cut to f32 toward zero, as a tensor-core instruction
    cuts its sum."""
    f = x.to(torch.float32)
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def test_toward_zero_cut():
    x = torch.tensor([1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30), 3.0, -0.5],
                     dtype=torch.float64)
    assert _to_f32_toward_zero(x).tolist() == [1.0, -1.0, 3.0, -0.5]


def _3xtf32_sum(x, w, promoted: bool) -> torch.Tensor:
    """x @ w as a 3xTF32 wgmma kernel sums it: each instruction adds its 8
    products (exact: TF32 x TF32) to its accumulator and cuts the sum
    toward zero, small terms first; ``promoted`` starts a fresh accumulator
    every 32-deep slice and adds it to the f32 sum (rounded to nearest),
    else one accumulator runs over all of K."""
    xh, wh = _tf32_rna(x), _tf32_rna(w)
    xl, wl = _tf32_rna(x - xh), _tf32_rna(w - wh)
    k = x.shape[1]
    total = torch.zeros(x.shape[0], w.shape[1])
    part = torch.zeros_like(total)
    for k0 in range(0, k, 8):
        if promoted and k0 % 32 == 0:
            part = torch.zeros_like(total)
        s = slice(k0, k0 + 8)
        for a, b in ((xl, wh), (xh, wl), (xh, wh)):
            part = _to_f32_toward_zero(
                part.double() + a[:, s].double() @ b[s].double())
        if promoted and (k0 % 32 == 24 or k0 + 8 >= k):
            total = total + part
    return total if promoted else part


@pytest.mark.parametrize("n", [1000, 100])
def test_3xtf32_promoted_against_one_accumulator(n):
    """3xTF32 sums with each instruction's cut toward zero, at the serve
    path's K = 1000 layers (rows cut to 200; data in [0, 1], Xavier
    weights): promoted slice by slice within 2e-6 of the f64 product; one
    accumulator across K, cut 375 times, over 5x further off."""
    rng = np.random.default_rng(n)
    m, k = 200, 1000
    x = torch.from_numpy(rng.random((m, k)).astype(np.float32))
    bound = (6.0 / (k + n)) ** 0.5
    w = torch.from_numpy(rng.uniform(-bound, bound, (k, n))
                         .astype(np.float32))
    exact = x.double() @ w.double()

    def err(promoted):
        return float((_3xtf32_sum(x, w, promoted).double() - exact)
                     .abs().max())

    promoted, one = err(True), err(False)
    assert promoted <= 2e-6, promoted
    assert one > 5 * promoted, (one, promoted)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("act", ACTIVATIONS)
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_kernel_matches_plain(cuda_device, shape, act, bf16):
    """The CUDA kernel against the plain version on the card, TF32 off;
    atol = rtol = 1e-4 (summation order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, b = (torch.from_numpy(a).to(cuda_device) for a in _inputs(*shape))
    before = dk.KERNELS.launches
    got = dk.fused_dense(x, w, b, act, bf16)
    torch.cuda.synchronize()
    assert dk.KERNELS.launches == before + 1
    want = dk.fused_dense_reference(x, w, b, act, bf16)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # the tied decoder's transposed view
    got_t = dk.fused_dense(x, w.T.contiguous().T, b, act, bf16)
    torch.testing.assert_close(got_t, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("act", ACTIVATIONS)
@pytest.mark.parametrize("m,k,n", [(20, 1000, 1000), (100, 1000, 100),
                                   (200, 100, 1000)])
def test_cuda_gradients_match_plain(cuda_device, m, k, n, act, bf16, tied):
    """The kernel route under autograd at the training shapes (chip_smoke.py
    [20]): the forward and dx, dw, db against the plain forward and the
    VJP's formula on its output, at the kernel's 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, b = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs(m, k, n, seed=m + n))
    g = torch.randn((m, n), generator=torch.Generator(
        device=cuda_device).manual_seed(1), device=cuda_device)
    leaf = (w.T.contiguous() if tied else w).clone().requires_grad_()
    xs, bs = x.clone().requires_grad_(), b.clone().requires_grad_()
    wv = leaf.T if tied else leaf
    out = dk.fused_dense(xs, wv, bs, act, bf16)
    out.backward(g)
    want = dk.fused_dense_reference(x, w, b, act, bf16)
    gz = dk.activation_grad(g, want, act)
    dw = leaf.grad.T if tied else leaf.grad
    for got, ref in ((out.detach(), want), (xs.grad, gz @ w.T),
                     (dw, x.T @ gz), (bs.grad, gz.sum(0))):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_ffma_row_limit_matches_the_source():
    """The wrapper's FFMA_MAX_ROWS, which chip_smoke.py's bounds read, is
    the one csrc/fused_dense.cu dispatches on."""
    with open(dk.SOURCE) as f:
        src = f.read()
    assert f"constexpr int FFMA_MAX_ROWS = {dk.FFMA_MAX_ROWS};" in src


@pytest.mark.cuda
@pytest.mark.parametrize("m", [20, 100, 200, 2000])
def test_cuda_training_shapes_against_f64(cuda_device, m):
    """The forward at the single-run trainer's shapes (run with -s): each
    layer of a tied 1000 -> 100 forward, data in [0, 1] at K = 1000 and in
    (-1, 1) otherwise, Xavier weights; the kernel's and ``torch.matmul``'s
    (TF32 off) largest distance from the f64 product, and the lean of each
    error toward zero (its mean along the product's sign over its root
    mean square).  Both stay within the kernel's 1e-4 tolerance of f64,
    and the kernel leans no more than 0.1 either way at every M: both FFMA
    kernels, up to FFMA_MAX_ROWS rows and the serve path's 2000, round
    to nearest (3xTF32 on the tensor cores leaned about -0.6 at 2000)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(m)

    def lean(e, exact):
        return float((e * exact.sign()).mean() / e.pow(2).mean().sqrt())

    for k, n, tied in ((1000, 1000, False), (1000, 100, False),
                       (100, 1000, True), (1000, 1000, True)):
        x = torch.rand((m, k), generator=g, device=cuda_device)
        if k != 1000:
            x = 2 * x - 1
        bound = (6.0 / (k + n)) ** 0.5
        w = (2 * torch.rand((n, k) if tied else (k, n), generator=g,
                            device=cuda_device) - 1) * bound
        w = w.T if tied else w
        exact = x.double() @ w.double()
        kern = dk.fused_dense(x, w, torch.zeros(n, device=cuda_device))
        plain = x @ w
        e_k, e_p = kern.double() - exact, plain.double() - exact
        print(f"\n  ({m}, {k}, {n}){' w.T' if tied else ''}: kernel "
              f"{float(e_k.abs().max()):.3e} (lean {lean(e_k, exact):+.3f})"
              f", torch.matmul {float(e_p.abs().max()):.3e} (lean "
              f"{lean(e_p, exact):+.3f}) from f64")
        assert float(e_k.abs().max()) <= 1e-4
        assert float(e_p.abs().max()) <= 1e-4
        assert abs(lean(e_k, exact)) <= 0.1
