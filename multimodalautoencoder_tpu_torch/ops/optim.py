"""Optimizers as plain functions on parameter trees.

Counterpart of ``multimodalautoencoder_tpu/ops/optim.py``, the same
formulas in the same float32 arithmetic.  A tree is an
``mmae.MMAEParams`` (or any nest of tuples, lists and NamedTuples) of
tensors; ``None`` leaves are skipped.  The learning rate and clip norm are
floats or, for a stack of ``batch_dims`` leading instance axes, tensors of
that shape, so one update serves a whole batch of configs (the JAX
package gets this from ``vmap``).  The updates return new tensors, or,
with ``inplace=True``, write every result into the given parameters' and
state's own tensors (the count too) and return them: a step captured in a
CUDA graph (``ops/step_graph.py``) must leave its results where the next
replay reads them.  Both modes run the same operations, so they agree bit
for bit; only the last operation of each result writes elsewhere.  No
update builds a tensor from a host scalar.

Formulations match TF1 semantics:
- adam: b1=0.9, b2=0.999, eps=1e-8, bias-corrected, in the rsqrt form
      alpha = lr * sqrt(bc2) / bc1;  p -= alpha * m * rsqrt(v + bc2*eps^2)
  which the training kernels use too (PARITY.md).  With bf16 moments the
  update uses the moments as stored (rounded), as ``optim.adam_update``
  does; the kernels use this step's unrounded values instead;
- sgd: p -= lr * g;
- adagrad: accumulator init 0.1, acc += g^2, p -= lr * g / sqrt(acc).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

OPTIMIZERS = ("adam", "sgd", "adagrad")


def tree_map(fn: Callable, *trees) -> Any:
    """``fn`` over corresponding tensor leaves; ``None`` stays ``None``."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_map(fn, *f) for f in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *f) for f in zip(*trees))
    raise TypeError(f"not a parameter tree node: {type(first)}")


def tree_leaves(tree) -> list:
    out = []
    tree_map(lambda t: out.append(t), tree)
    return out


def _bcast(s, like: torch.Tensor):
    """A scalar, or a per-instance tensor shaped to broadcast over the
    trailing axes of ``like``."""
    if not isinstance(s, torch.Tensor) or s.dim() == 0:
        return s
    return s.reshape(s.shape + (1,) * (like.dim() - s.dim()))


class AdamState(NamedTuple):
    count: torch.Tensor   # int32 scalar
    mu: Any               # tree like params
    nu: Any


def state_dtype(name) -> Optional[torch.dtype]:
    """``TrainConfig.optimizer_state_dtype`` -> moment dtype (None = the
    parameter dtype, float32).  Unknown names raise."""
    if name in (None, "float32"):
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unknown optimizer_state_dtype {name!r} "
                     "(float32 or bfloat16)")


def adam_init(params, state_dtype=None) -> AdamState:
    def z(p):
        return torch.zeros(p.shape, dtype=state_dtype or p.dtype,
                           device=p.device)
    count = torch.zeros((), dtype=torch.int32,
                        device=tree_leaves(params)[0].device)
    return AdamState(count=count, mu=tree_map(z, params),
                     nu=tree_map(z, params))


def global_norm(tree, batch_dims: int = 0) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, one per instance of the
    ``batch_dims`` leading axes."""
    def sq(leaf):
        return torch.sum(torch.square(leaf),
                         dim=tuple(range(batch_dims, leaf.dim())))
    return torch.sqrt(sum(sq(leaf) for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm, batch_dims: int = 0):
    """tf.clip_by_global_norm semantics (neural_net.py:190-195)."""
    norm = global_norm(grads, batch_dims)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-20), max=1.0)
    return tree_map(lambda g: g * _bcast(scale, g), grads)


def _outs(tree, inplace: bool):
    """Where an update writes: the tree's own tensors, or new ones."""
    return tree if inplace else tree_map(torch.empty_like, tree)


def _count(state, inplace: bool) -> torch.Tensor:
    return torch.add(state.count, 1, out=_outs(state.count, inplace))


def adam_update(grads, state: AdamState, params, lr, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                clip_norm=None, batch_dims: int = 0, inplace: bool = False):
    """One Adam step; returns (params, state).  Moments keep the dtype
    ``adam_init`` gave them (bf16 state computes in f32 and stores
    down)."""
    if clip_norm is not None:
        grads = clip_by_global_norm(grads, clip_norm, batch_dims)
    count = _count(state, inplace)
    cf = count.to(torch.float32)
    # Python scalars enter the f32 arithmetic as f32 values, as JAX's weak
    # types do, and make no host-to-device copy (a copy a step would
    # synchronise the host with the device)
    bc1 = 1.0 - torch.pow(b1, cf)
    bc2 = 1.0 - torch.pow(b2, cf)
    if isinstance(lr, torch.Tensor):
        lr = lr.to(dtype=torch.float32, device=cf.device)
    alpha = lr * torch.sqrt(bc2) / bc1
    es2 = bc2 * (eps * eps)

    mu = tree_map(lambda m, g, o: torch.add(b1 * m.float(), (1 - b1) * g,
                                            out=o),
                  state.mu, grads, _outs(state.mu, inplace))
    nu = tree_map(lambda v, g, o: torch.add(b2 * v.float(),
                                            (1 - b2) * g * g, out=o),
                  state.nu, grads, _outs(state.nu, inplace))
    new = tree_map(lambda p, m, v, o: torch.sub(
        p, (_bcast(alpha, p) * m.float()) * torch.rsqrt(v.float() + es2),
        out=o), params, mu, nu, _outs(params, inplace))
    return new, AdamState(count=count, mu=mu, nu=nu)


class SGDState(NamedTuple):
    count: torch.Tensor


def sgd_init(params, state_dtype=None) -> SGDState:
    del state_dtype
    return SGDState(count=torch.zeros(
        (), dtype=torch.int32, device=tree_leaves(params)[0].device))


def sgd_update(grads, state: SGDState, params, lr, clip_norm=None,
               batch_dims: int = 0, inplace: bool = False):
    """tf.train.GradientDescentOptimizer: p -= lr * g."""
    if clip_norm is not None:
        grads = clip_by_global_norm(grads, clip_norm, batch_dims)
    new = tree_map(lambda p, g, o: torch.sub(p, _bcast(lr, p) * g, out=o),
                   params, grads, _outs(params, inplace))
    return new, SGDState(count=_count(state, inplace))


class AdagradState(NamedTuple):
    count: torch.Tensor
    acc: Any


def adagrad_init(params, state_dtype=None,
                 initial_accumulator: float = 0.1) -> AdagradState:
    """TF1 AdagradOptimizer's initial_accumulator_value=0.1."""
    def z(p):
        return torch.full(p.shape, initial_accumulator,
                          dtype=state_dtype or p.dtype, device=p.device)
    return AdagradState(count=torch.zeros(
        (), dtype=torch.int32, device=tree_leaves(params)[0].device),
        acc=tree_map(z, params))


def adagrad_update(grads, state: AdagradState, params, lr, clip_norm=None,
                   batch_dims: int = 0, inplace: bool = False):
    """tf.train.AdagradOptimizer: acc += g^2; p -= lr * g / sqrt(acc)."""
    if clip_norm is not None:
        grads = clip_by_global_norm(grads, clip_norm, batch_dims)
    acc = tree_map(lambda a, g, o: torch.add(a.float(), g * g, out=o),
                   state.acc, grads, _outs(state.acc, inplace))
    new = tree_map(lambda p, g, a, o: torch.sub(
        p, _bcast(lr, p) * g / torch.sqrt(a.float()), out=o),
        params, grads, acc, _outs(params, inplace))
    return new, AdagradState(count=_count(state, inplace), acc=acc)


def opt_init(name: str, params, state_dtype=None):
    """Optimizer state for ``name`` ('adam' | 'sgd' | 'adagrad' — the
    reference's recognized set, generic_wrapper.py:233-239)."""
    if name == "adam":
        return adam_init(params, state_dtype)
    if name == "sgd":
        return sgd_init(params, state_dtype)
    if name == "adagrad":
        return adagrad_init(params, state_dtype)
    raise ValueError(f"unknown optimizer {name!r}; expected one of "
                     f"{OPTIMIZERS}")


def opt_update(name: str, grads, state, params, lr, clip_norm=None,
               batch_dims: int = 0, inplace: bool = False):
    """One update step of the named optimizer (in place with
    ``inplace``)."""
    if name == "adam":
        return adam_update(grads, state, params, lr, clip_norm=clip_norm,
                           batch_dims=batch_dims, inplace=inplace)
    if name == "sgd":
        return sgd_update(grads, state, params, lr, clip_norm, batch_dims,
                          inplace)
    if name == "adagrad":
        return adagrad_update(grads, state, params, lr, clip_norm,
                              batch_dims, inplace)
    raise ValueError(f"unknown optimizer {name!r}; expected one of "
                     f"{OPTIMIZERS}")


def exponential_decay(lr0, step, decay_steps, decay_rate,
                      staircase: bool = False) -> torch.Tensor:
    """tf.train.exponential_decay: lr0 * rate^(step/steps) in float32
    (multimodal_autoencoder.py:357-361).  ``lr0`` and ``decay_rate`` may
    be f32 tensors on ``step``'s device, built once for a run, so that a
    step builds nothing from the host."""
    p = torch.as_tensor(step, dtype=torch.float32) / decay_steps
    if staircase:
        p = torch.floor(p)
    rate = torch.as_tensor(decay_rate, dtype=torch.float32, device=p.device)
    lr0 = torch.as_tensor(lr0, dtype=torch.float32)
    return lr0 * torch.pow(rate, p.to(lr0.device))
