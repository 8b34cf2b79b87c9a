"""The NN comparison baseline's MLP classifier, trained on the device.

Counterpart of ``multimodalautoencoder_tpu/models/neural_net.py``, the
reference's ``comparison_algorithms/neural_net.py`` class
``NeuralNetwork`` (:27-381): an MLP with relu hidden layers and inverted
dropout, *mean* sigmoid-CE multi-label loss with an L2 penalty
(:170-180), real global-norm-5 gradient clipping (:190-195; unlike the
MMAE's, where clipping is inert), Adam at a constant learning rate, and
predictions round(sigmoid(logits)) (:183-188).  Initialisation follows the
reference's weight_variable / bias_variable (:383-406): truncated normal
at +-2 std with std 1/sqrt(fan_in), biases 0.1.

Plain functions on tensors: the products are ``torch.matmul`` in f32
(TF32 off; the JAX package leaves them to XLA, outside any Pallas
kernel).  Randomness (the initial weights, the batch draws, the dropout
masks) comes from an explicit ``torch.Generator`` on the parameters'
device; it gives other numbers than the JAX package's keys, so the tests
feed both packages the same parameters and batches.  :func:`train` makes
no host-synchronising call inside its step loop: the batch draw, the
clipping and the recorded accuracies stay on the device, and the caller
reads the curves once at the end.  Its step (:func:`train_step_`) and its
evaluation work in place on the run's tensors, driven by
``ops/step_graph.run``: on the card captured once per call as CUDA graphs
and replayed (the JAX package's jitted ``lax.scan``), on the CPU called in
a Python loop.

Checkpoints (:func:`save_model` / :func:`load_model`) are the JAX
package's npz layout (``param_i`` leaves in ``NNParams`` order: every
weight, then every bias; ``meta_json``; ``curve_*``), so each package
loads the other's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodalautoencoder_tpu_torch.models import losses as losses_lib
from multimodalautoencoder_tpu_torch.ops import optim, step_graph


@dataclasses.dataclass(frozen=True)
class NNConfig:
    input_size: int = 0
    layer_sizes: Tuple[int, ...] = (128, 64)
    output_size: int = 2
    activation: str = "relu"      # the reference's relu-or-none (:152-156)
    dropout_prob: float = 1.0     # keep probability
    weight_penalty: float = 0.0
    learning_rate: float = 1e-3
    batch_size: int = 100
    clip_gradients: bool = True
    clip_norm: float = 5.0
    seed: int = 0

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return (self.input_size,) + tuple(self.layer_sizes) + (
            self.output_size,)


class NNParams(NamedTuple):
    w: Tuple[torch.Tensor, ...]
    b: Tuple[torch.Tensor, ...]


def params_to_numpy(params: NNParams) -> List[np.ndarray]:
    """The leaves in the JAX package's flatten order: w_0..w_n, b_0..b_n."""
    return [t.detach().cpu().numpy() for t in (*params.w, *params.b)]


def params_from_numpy(leaves: Sequence[np.ndarray],
                      device="cuda") -> NNParams:
    """:class:`NNParams` from leaves in :func:`params_to_numpy` order."""
    n = len(leaves) // 2
    ts = [torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)
          for a in leaves]
    return NNParams(w=tuple(ts[:n]), b=tuple(ts[n:]))


def init(generator: torch.Generator, cfg: NNConfig,
         device="cuda") -> NNParams:
    """Truncated normal weights at +-2 std, std 1/sqrt(fan_in); biases
    0.1 (:383-406)."""
    sizes = cfg.sizes
    ws, bs = [], []
    for i in range(len(sizes) - 1):
        w = torch.empty((sizes[i], sizes[i + 1]), device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        ws.append(w * (1.0 / np.sqrt(sizes[i])))
        bs.append(torch.full((sizes[i + 1],), 0.1, device=device))
    return NNParams(w=tuple(ws), b=tuple(bs))


def apply(params: NNParams, cfg: NNConfig, x: torch.Tensor, *,
          generator: Optional[torch.Generator] = None,
          keep_prob: float = 1.0, train: bool = False) -> torch.Tensor:
    """run_network (:140-158): relu and inverted dropout on every layer but
    the last; the dropout keeps each unit with probability ``keep_prob``
    (a Bernoulli draw from ``generator``)."""
    h = x
    n = len(params.w)
    for i in range(n):
        h = h @ params.w[i] + params.b[i]
        if i < n - 1:
            if cfg.activation == "relu":
                h = torch.relu(h)
            if train and keep_prob < 1.0:
                keep = torch.rand(h.shape, generator=generator,
                                  device=h.device) < keep_prob
                h = torch.where(keep, h / keep_prob, 0.0)
    return h


def loss_fn(params: NNParams, cfg: NNConfig, x: torch.Tensor,
            y: torch.Tensor, *, generator: Optional[torch.Generator] = None,
            train: bool = False) -> torch.Tensor:
    """Mean sigmoid-CE plus the L2 penalty (:170-180)."""
    logits = apply(params, cfg, x, generator=generator,
                   keep_prob=cfg.dropout_prob, train=train)
    loss = torch.mean(losses_lib.sigmoid_bce_with_logits(logits, y))
    return loss + losses_lib.weight_regularization(cfg.weight_penalty,
                                                   list(params.w))


def predict(params: NNParams, cfg: NNConfig,
            x: torch.Tensor) -> torch.Tensor:
    """round(sigmoid(logits)) as int32 (:183-185)."""
    logits = apply(params, cfg, x)
    return torch.round(torch.sigmoid(logits)).to(torch.int32)


def accuracy(params: NNParams, cfg: NNConfig, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """The fraction of (row, label) cells predicted right, a 0-d tensor on
    the device."""
    preds = predict(params, cfg, x)
    return torch.mean((preds == y.to(torch.int32)).to(torch.float32))


class NNState(NamedTuple):
    params: NNParams
    opt_state: optim.AdamState
    step: torch.Tensor
    generator: torch.Generator


def init_state(cfg: NNConfig, device="cuda",
               generator: Optional[torch.Generator] = None) -> NNState:
    """Fresh parameters and Adam state; ``generator`` (default: seeded
    with ``cfg.seed`` on ``device``) draws the weights and then the run's
    batches and dropout masks."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    params = init(generator, cfg, device)
    return NNState(params, optim.adam_init(params),
                   torch.zeros((), dtype=torch.int32, device=device),
                   generator)


def clone_state(state: NNState) -> NNState:
    """A state with copies of ``state``'s tensors and the same
    generator."""
    return NNState(optim.tree_map(torch.clone, state.params),
                   optim.tree_map(torch.clone, state.opt_state),
                   state.step.clone(), state.generator)


def train_step_(state: NNState, cfg: NNConfig, x: torch.Tensor,
                y: torch.Tensor):
    """One Adam step on the batch ``(x, y)``, with real global-norm
    clipping when ``cfg.clip_gradients``, written into ``state``'s own
    tensors: returns (loss, gradients)."""
    n = len(state.params.w)
    leaves = [t.detach().requires_grad_()
              for t in (*state.params.w, *state.params.b)]
    live = NNParams(w=tuple(leaves[:n]), b=tuple(leaves[n:]))
    loss = loss_fn(live, cfg, x, y, generator=state.generator, train=True)
    g = torch.autograd.grad(loss, leaves)
    grads = NNParams(w=tuple(g[:n]), b=tuple(g[n:]))
    clip = cfg.clip_norm if cfg.clip_gradients else None
    with torch.no_grad():
        optim.adam_update(grads, state.opt_state, state.params,
                          cfg.learning_rate, clip_norm=clip, inplace=True)
        state.step.add_(1)
    return loss.detach(), grads


def train_step(state: NNState, cfg: NNConfig, x: torch.Tensor,
               y: torch.Tensor):
    """:func:`train_step_` on a copy of ``state``: (new state, loss,
    gradients)."""
    state = clone_state(state)
    loss, grads = train_step_(state, cfg, x, y)
    return state, loss, grads


def train(state: NNState, cfg: NNConfig, train_x: torch.Tensor,
          train_y: torch.Tensor, val_x: torch.Tensor, val_y: torch.Tensor,
          num_steps: int, record_every_nth: int = 0):
    """SGD on uniform-with-replacement batches (:200-244).  With
    ``record_every_nth`` > 0 records (train_acc, val_acc) at the start of
    every full period and returns ``(state, (train_accs, val_accs))``; a
    run shorter than one period records once at entry and runs exactly
    ``num_steps`` (:150-159).  Without it returns ``(state, losses)``.
    The curves and losses are tensors on the device.  ``state``'s tensors
    stay as they were (its generator advances); on the card the step and
    the evaluation replay CUDA graphs (``ops/step_graph.run``)."""
    rows = train_x.shape[0]
    device = train_x.device
    state = clone_state(state)
    record = record_every_nth is not None and record_every_nth > 0
    losses = None if record else torch.zeros(num_steps, device=device)
    at = torch.zeros(1, dtype=torch.int64, device=device)

    def step():
        idx = torch.randint(0, rows, (cfg.batch_size,),
                            generator=state.generator, device=device)
        loss, _ = train_step_(state, cfg, train_x[idx], train_y[idx])
        if losses is not None:
            losses.index_copy_(0, at, loss.reshape(1))
            at.add_(1)

    def evaluate():
        return torch.stack((accuracy(state.params, cfg, train_x, train_y),
                            accuracy(state.params, cfg, val_x, val_y)))

    if record:
        n_periods = num_steps // record_every_nth
        evals = range(0, n_periods * record_every_nth, record_every_nth) \
            if n_periods else (0,)
    else:
        evals = ()
    records = step_graph.run(step, evaluate, num_steps, evals,
                             state.generator, device)
    if record:
        ta, va = torch.stack(records).T.contiguous()
        return state, (ta, va)
    return state, losses


def save_model(directory: str, name: str, params: NNParams, cfg: NNConfig,
               curves: Optional[dict] = None) -> str:
    """npz checkpoint with the config beside it (reference save_model
    :312-339), in the JAX package's layout."""
    os.makedirs(directory, exist_ok=True)
    leaves = params_to_numpy(params)
    payload = {f"param_{i}": a for i, a in enumerate(leaves)}
    for k, v in (curves or {}).items():
        payload[f"curve_{k}"] = np.asarray(v)
    payload["meta_json"] = np.frombuffer(json.dumps({
        "config": dataclasses.asdict(cfg),
        "num_leaves": len(leaves),
        "curve_names": sorted((curves or {}).keys()),
    }).encode(), dtype=np.uint8)
    path = os.path.join(directory, name + ".npz")
    np.savez(path, **payload)
    return path


def load_model(path: str, device="cuda"):
    """(params, cfg, curves) of a checkpoint of either package (reference
    load_saved_model :341-381)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta_json"]).decode())
        leaves = [data[f"param_{i}"] for i in range(meta["num_leaves"])]
        curves = {k: data[f"curve_{k}"]
                  for k in meta.get("curve_names", [])}
    c = dict(meta["config"])
    c["layer_sizes"] = tuple(c["layer_sizes"])
    return params_from_numpy(leaves, device), NNConfig(**c), curves
