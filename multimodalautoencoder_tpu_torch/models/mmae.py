"""Multimodal autoencoder (MMAE) as plain functions on tensors.

Counterpart of ``multimodalautoencoder_tpu/models/mmae.py``.  The
reference builds a TF1 graph (``multimodal_autoencoder.py``: encode :454,
decode :499, classify :520):

- encoder: ``len(layer_sizes)`` dense layers, activation and dropout on
  all but the bottleneck (:461-475);
- decoder: mirrored sizes, activation and dropout on all but the output
  layer (:499-518); weight tying = transpose of encoder weights at apply
  time (:283-284) with always-independent decode biases (:291-293);
- VAE: variance head from the *second-to-last* hidden layer (:298-302,
  :464-465), reparameterized ``z = mu + eps * exp(log_var)`` (:372-375);
- classification head: dense layers from the embedding (:313-338,
  :520-540), re-initialized before phase 2 (:898-930, :func:`init_head`).

Parameters are an :class:`MMAEParams` of tensors with the JAX pytree's
field order; :func:`params_to_numpy` / :func:`params_from_numpy` carry them
across as the JAX package's flattened leaf list.  Every function also takes
a *stack* of instances: leaves with leading axes (the grid trainer's
``(N, rows, cols)``), inputs ``(N, rows, F)``, and per-instance ``act_id``,
``keep_prob`` and ``weight_penalty`` as (N,) tensors — what ``vmap`` gives
the JAX package.  ``act_id`` selects the activation per instance, like the
JAX package's ``lax.switch``.  With ``cfg.use_pallas`` and no ``act_id``
every encoder and decoder layer goes through
``ops/dense_kernels.fused_dense`` (the CUDA kernel on a GPU); the VAE head
stays a plain matmul, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch

from multimodalautoencoder_tpu_torch.config import ACTIVATIONS, MMAEConfig
from multimodalautoencoder_tpu_torch.models import losses as losses_lib
from multimodalautoencoder_tpu_torch.ops import dense_kernels


class MMAEParams(NamedTuple):
    """Parameters.  ``dec_w`` is empty when weights are tied; decode lists
    are stored in *decode order*.  ``cls_*`` are empty without a
    classification head."""

    enc_w: Tuple[torch.Tensor, ...]
    enc_b: Tuple[torch.Tensor, ...]
    dec_w: Tuple[torch.Tensor, ...]
    dec_b: Tuple[torch.Tensor, ...]
    var_w: Optional[torch.Tensor]
    var_b: Optional[torch.Tensor]
    cls_w: Tuple[torch.Tensor, ...]
    cls_b: Tuple[torch.Tensor, ...]


class MMAEOutputs(NamedTuple):
    mu: torch.Tensor                  # encoder output before sampling
    log_var: Optional[torch.Tensor]   # VAE only (reference's log-sigma)
    embedding: torch.Tensor           # == mu, or sampled z for VAE
    decoded: torch.Tensor             # raw decoder output (logits for BCE)
    recon: torch.Tensor               # reconstruction in data space


def _layer_dims(cfg: MMAEConfig) -> List[Tuple[int, int]]:
    """[(in, out)] for encoder layers."""
    dims = []
    prev = cfg.num_feats
    for size in cfg.layer_sizes:
        dims.append((prev, size))
        prev = size
    return dims


def _cls_dims(cfg: MMAEConfig) -> List[Tuple[int, int]]:
    if cfg.classification_layer_sizes is None:
        return []
    sizes = ((cfg.embedding_size,) + tuple(cfg.classification_layer_sizes)
             + (cfg.num_labels,))
    return [(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)]


def param_shapes(cfg: MMAEConfig) -> MMAEParams:
    """The shape of every parameter ``cfg`` implies, as an MMAEParams of
    shape tuples — the structure a flattened leaf list unflattens into."""
    dims = _layer_dims(cfg)
    dec = [(o, i) for i, o in reversed(dims)]
    var = cfg.variational
    cls = _cls_dims(cfg)
    return MMAEParams(
        enc_w=tuple(dims), enc_b=tuple((o,) for _, o in dims),
        dec_w=() if cfg.tie_weights else tuple(dec),
        dec_b=tuple((o,) for _, o in dec),
        var_w=(cfg.layer_sizes[-2], cfg.embedding_size) if var else None,
        var_b=(cfg.embedding_size,) if var else None,
        cls_w=tuple(cls), cls_b=tuple((o,) for _, o in cls))


def _init_weight(shape: Tuple[int, int], method: str, const: float,
                 generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    fan_in, fan_out = shape
    if method == "xavier":
        bound = const * math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(shape, generator=generator, device=device)
        return (2.0 * u - 1.0) * bound
    # 'normal': normal truncated at 2 sigma, stddev 1/sqrt(fan_in), drawn by
    # inverting the normal CDF over [Phi(-2), Phi(2)]
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, device=device)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (1.0 - 2.0 * lo) * u) - 1.0)
    return z.clamp(-2.0, 2.0) / math.sqrt(fan_in)


def init(cfg: MMAEConfig, generator: Optional[torch.Generator] = None,
         device="cuda") -> MMAEParams:
    """Initialize all trainable parameters for ``cfg`` (reference :22-56):
    'xavier' = uniform(+-const*sqrt(6/(fan_in+fan_out))), 'normal' =
    truncated normal with stddev 1/sqrt(fan_in); biases = 0.1.  Draws come
    from ``generator`` (a fresh one seeded 0 when None), so they differ
    from the JAX package's."""
    cfg = cfg.validate()
    if cfg.num_feats <= 0:
        raise ValueError("cfg.num_feats must be set before init")
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    shapes = param_shapes(cfg)

    def weight(shape):
        return _init_weight(shape, cfg.weight_initialization,
                            cfg.xavier_const, generator, device)

    def bias(shape):
        return torch.full(shape, 0.1, dtype=torch.float32, device=device)

    enc_w = tuple(weight(s) for s in shapes.enc_w)
    dec_w = tuple(weight(s) for s in shapes.dec_w)
    var_w = None if shapes.var_w is None else weight(shapes.var_w)
    cls_w, cls_b = init_head(cfg, generator, device)
    return MMAEParams(
        enc_w=enc_w, enc_b=tuple(bias(s) for s in shapes.enc_b),
        dec_w=dec_w, dec_b=tuple(bias(s) for s in shapes.dec_b),
        var_w=var_w,
        var_b=None if shapes.var_b is None else bias(shapes.var_b),
        cls_w=cls_w, cls_b=cls_b)


def init_head(cfg: MMAEConfig, generator: torch.Generator, device="cuda"
              ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Fresh classification-head parameters only, (cls_w, cls_b): the
    reference re-initializes the head before phase 2
    (set_classification_params -> rebuild_reinitialize,
    multimodal_autoencoder.py:898-930), so phase-2 trainers attach one to
    a headless phase-1 parameter stack.  Same init as :func:`init`."""
    device = torch.device(device)
    dims = _cls_dims(cfg)
    cls_w = tuple(_init_weight(d, cfg.weight_initialization,
                               cfg.xavier_const, generator, device)
                  for d in dims)
    cls_b = tuple(torch.full((o,), 0.1, dtype=torch.float32, device=device)
                  for _, o in dims)
    return cls_w, cls_b


def _leaves(tree: MMAEParams) -> list:
    """Leaves in ``jax.tree_util.tree_flatten`` order: fields in order,
    ``None`` fields dropped."""
    out = []
    for name, field in zip(tree._fields, tree):
        if field is None:
            continue
        if name in ("var_w", "var_b"):
            out.append(field)
        else:
            out.extend(field)
    return out


def params_to_numpy(params: MMAEParams) -> List[np.ndarray]:
    """The flattened leaf list of the JAX package's ``MMAEParams`` pytree
    (``jax.tree_util.tree_leaves`` order), as host numpy arrays."""
    return [t.detach().cpu().numpy() for t in _leaves(params)]


def params_from_numpy(leaves: Sequence[np.ndarray], cfg: MMAEConfig,
                      device="cuda", batch_shape: Tuple[int, ...] = ()
                      ) -> MMAEParams:
    """Rebuild parameters from a flattened leaf list (the inverse of
    :func:`params_to_numpy`; also what ``jax.tree_util.tree_leaves`` of the
    JAX package's params gives).  ``cfg`` fixes the structure; every leaf's
    shape is checked against it, after ``batch_shape`` leading axes."""
    shapes = param_shapes(cfg)
    want = _leaves(shapes)
    if len(leaves) != len(want):
        raise ValueError(f"got {len(leaves)} parameter leaves but the config "
                         f"implies {len(want)}; rebuild with the config the "
                         "parameters were trained under")
    it = iter(leaves)

    def take(shape):
        a = np.asarray(next(it))
        if tuple(a.shape) != tuple(batch_shape) + tuple(shape):
            raise ValueError(f"parameter leaf of shape {a.shape} where the "
                             f"config implies {tuple(batch_shape)} + "
                             f"{tuple(shape)}")
        return torch.tensor(a, dtype=torch.float32, device=device)

    def take_all(group):
        return tuple(take(s) for s in group)

    enc_w, enc_b = take_all(shapes.enc_w), take_all(shapes.enc_b)
    dec_w, dec_b = take_all(shapes.dec_w), take_all(shapes.dec_b)
    var_w = None if shapes.var_w is None else take(shapes.var_w)
    var_b = None if shapes.var_b is None else take(shapes.var_b)
    cls_w, cls_b = take_all(shapes.cls_w), take_all(shapes.cls_b)
    return MMAEParams(enc_w, enc_b, dec_w, dec_b, var_w, var_b, cls_w, cls_b)


def stacked_params_from_numpy(leaves: Sequence[np.ndarray], cfg: MMAEConfig,
                              device="cuda") -> MMAEParams:
    """Grid parameters from the leaves of a JAX params tree whose leaves
    carry leading ``(C, K)`` (config, fold) axes, as
    ``grid_trainer.train_grid`` returns them; :func:`params_to_numpy` is
    the inverse."""
    first = np.asarray(leaves[0])
    return params_from_numpy(leaves, cfg, device,
                             batch_shape=tuple(first.shape[:-2]))


def activation_id(name: str) -> int:
    """Map an activation name to its switch index (config.ACTIVATIONS
    order, the JAX package's ``lax.switch`` branches)."""
    table = {"linear": 0, "relu": 1, "tanh": 2, "softsign": 3, "softplus": 4}
    if name not in table:
        raise ValueError(f"unknown activation {name!r}")
    assert tuple(table) == ACTIVATIONS
    return table[name]


def _per_instance(v, like: torch.Tensor):
    """A per-instance (N,) tensor shaped to broadcast against ``like``
    (N, ..., cols); scalars pass through."""
    if not isinstance(v, torch.Tensor) or v.dim() == 0:
        return v
    return v.to(like.device).reshape(v.shape + (1,) * (like.dim() - v.dim()))


def _activate(x: torch.Tensor, name: str,
              act_id: Union[None, int, torch.Tensor]) -> torch.Tensor:
    """The activation ``name``, or the one ``act_id`` selects; a tensor
    ``act_id`` selects per instance of a stack."""
    if act_id is None:
        return dense_kernels.activate(x, name)
    if not isinstance(act_id, torch.Tensor):
        return dense_kernels.activate(x, ACTIVATIONS[int(act_id)])
    a = _per_instance(act_id, x)
    out = x
    for i, act in enumerate(ACTIVATIONS[1:], start=1):
        out = torch.where(a == i, dense_kernels.activate(x, act), out)
    return out


def _rand(fn: Callable, like: torch.Tensor,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """``fn`` (``torch.rand`` or ``torch.randn``) of ``like``'s shape, drawn
    on the generator's device and moved to ``like``'s, so one seeded CPU
    generator gives the same draws whatever device the model runs on."""
    dev = generator.device if generator is not None else like.device
    return fn(like.shape, generator=generator, device=dev,
              dtype=like.dtype).to(like.device)


def _dropout(x: torch.Tensor, keep_prob,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """TF-style dropout: keep with probability ``keep_prob`` (float or
    per-instance tensor), scale kept values by 1/keep_prob."""
    keep_prob = _per_instance(keep_prob, x)
    keep = _rand(torch.rand, x, generator) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def _matmul(x: torch.Tensor, w: torch.Tensor,
            cfg: MMAEConfig) -> torch.Tensor:
    """The plain matmul under ``mxu_dot``'s policy: with bfloat16 compute
    each operand is rounded to bf16, products and sums stay f32."""
    if cfg.compute_dtype == "bfloat16":
        x, w = dense_kernels.round_to_bf16(x), dense_kernels.round_to_bf16(w)
    return x @ w


def _affine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            cfg: MMAEConfig) -> torch.Tensor:
    """``x @ w + b``; ``b`` (..., cols) broadcasts over the rows."""
    return _matmul(x, w, cfg) + b.unsqueeze(-2)


def _decode_weights(params: MMAEParams) -> Tuple[torch.Tensor, ...]:
    """Decoder weight list in decode order; transposed encoder weights when
    tied (:283-284, :304)."""
    if params.dec_w:
        return params.dec_w
    return tuple(w.transpose(-2, -1) for w in reversed(params.enc_w))


def _layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, hidden: bool,
           cfg: MMAEConfig, use_pallas: bool, act_id) -> torch.Tensor:
    if use_pallas:
        return dense_kernels.fused_dense(
            x, w, b, cfg.activation if hidden else "linear",
            bf16=cfg.compute_dtype == "bfloat16")
    z = _affine(x, w, b, cfg)
    return _activate(z, cfg.activation, act_id) if hidden else z


def encode(params: MMAEParams, cfg: MMAEConfig, x: torch.Tensor, *,
           generator: Optional[torch.Generator] = None, keep_prob=1.0,
           train: bool = False, act_id=None
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Encoder forward (:454-475). Returns (mu, log_var|None).  With
    ``train`` the hidden layers take dropout at ``keep_prob``, drawn from
    ``generator``."""
    n = len(params.enc_w)
    use_pallas = cfg.use_pallas and act_id is None
    hidden = x
    log_var = None
    for i in range(n):
        if cfg.variational and i == n - 1:
            log_var = _affine(hidden, params.var_w, params.var_b, cfg)
        hidden = _layer(hidden, params.enc_w[i], params.enc_b[i], i < n - 1,
                        cfg, use_pallas, act_id)
        if i < n - 1 and train:
            hidden = _dropout(hidden, keep_prob, generator)
    return hidden, log_var


def decode(params: MMAEParams, cfg: MMAEConfig, embedding: torch.Tensor, *,
           generator: Optional[torch.Generator] = None, keep_prob=1.0,
           train: bool = False, act_id=None) -> torch.Tensor:
    """Decoder forward (:499-518). Raw output (logits for sigmoid-CE)."""
    ws = _decode_weights(params)
    use_pallas = cfg.use_pallas and act_id is None
    x = embedding
    for i, w in enumerate(ws):
        x = _layer(x, w, params.dec_b[i], i < len(ws) - 1, cfg, use_pallas,
                   act_id)
        if i < len(ws) - 1 and train:
            x = _dropout(x, keep_prob, generator)
    return x


def classify(params: MMAEParams, cfg: MMAEConfig, embedding: torch.Tensor, *,
             generator: Optional[torch.Generator] = None, keep_prob=1.0,
             train: bool = False, act_id=None) -> torch.Tensor:
    """Classification head forward (:520-540) -> logits.  Activation (the
    head's own, else the model's) and dropout apply where the gate is
    open: in faithful mode (``cfg.faithful_classify_gate``) the
    reference's gate ``i < len(decode_weights) - 1`` (:533), otherwise on
    every layer but the last.  ``act_id`` selects the head's activation
    per instance."""
    act = cfg.classification_activation or cfg.activation
    n_dec = len(cfg.layer_sizes)
    x = embedding
    for i, w in enumerate(params.cls_w):
        x = _affine(x, w, params.cls_b[i], cfg)
        gate = (i < n_dec - 1) if cfg.faithful_classify_gate \
            else (i < len(params.cls_w) - 1)
        if gate:
            x = _activate(x, act, act_id)
            if train:
                x = _dropout(x, keep_prob, generator)
    return x


def forward(params: MMAEParams, cfg: MMAEConfig, x: torch.Tensor, *,
            generator: Optional[torch.Generator] = None,
            sample: bool = True, keep_prob=1.0, train: bool = False,
            act_id=None) -> MMAEOutputs:
    """Full autoencoder forward (:367-390).

    For the VAE the reference *always* samples the embedding — including at
    evaluation time (:372-375) — so ``sample`` defaults to True and eps is
    drawn from ``generator`` (a fresh one seeded 0 when None); pass False
    for the deterministic embedding mu.  Dropout (``train``) draws from the
    same generator.
    """
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    mu, log_var = encode(params, cfg, x, generator=generator,
                         keep_prob=keep_prob, train=train, act_id=act_id)
    embedding = mu
    if cfg.variational and sample:
        eps = _rand(torch.randn, mu, generator)
        embedding = mu + eps * torch.exp(log_var)
    decoded = decode(params, cfg, embedding, generator=generator,
                     keep_prob=keep_prob, train=train, act_id=act_id)
    recon = torch.sigmoid(decoded) if cfg.loss == "sigmoid_cross_entropy" \
        else decoded
    return MMAEOutputs(mu=mu, log_var=log_var, embedding=embedding,
                       decoded=decoded, recon=recon)


def total_loss(params: MMAEParams, cfg: MMAEConfig, noisy_x: torch.Tensor,
               true_x: torch.Tensor, *,
               generator: Optional[torch.Generator] = None,
               sample: bool = True, keep_prob=1.0, train: bool = False,
               weight_penalty=None, act_id=None):
    """Training objective (:380-408): reconstruction + L2 reg (+ KL).

    ``weight_penalty`` (a float or per-instance (N,) tensor) overrides
    ``cfg.weight_penalty``.  Returns ``(loss, aux)``; aux carries the
    unregularized reconstruction loss and the outputs.  On a stack of
    instances the loss has one entry per instance."""
    penalty = cfg.weight_penalty if weight_penalty is None else weight_penalty
    out = forward(params, cfg, noisy_x, generator=generator, sample=sample,
                  keep_prob=keep_prob, train=train, act_id=act_id)
    recon_loss = losses_lib.reconstruction_loss(cfg.loss, out.decoded, true_x)

    reg_weights = list(params.enc_w) + list(_decode_weights(params))
    if cfg.variational:
        reg_weights.append(params.var_w)
    reg = losses_lib.weight_regularization(penalty, reg_weights)

    if cfg.variational:
        z_for_kl = out.embedding if cfg.faithful_kl_on_z else out.mu
        kl = losses_lib.kl_divergence_rows(z_for_kl, out.log_var)
        # reference: mean(scalar_recon + per-row kl) + reg (:406)
        loss = torch.mean(recon_loss.unsqueeze(-1) + kl, dim=-1) + reg
    else:
        kl = None
        loss = recon_loss + reg

    aux = {"recon_loss": recon_loss, "reg": reg, "kl": kl, "outputs": out}
    return loss, aux


def classification_total_loss(params: MMAEParams, cfg: MMAEConfig,
                              noisy_x: torch.Tensor, true_y: torch.Tensor, *,
                              generator: Optional[torch.Generator] = None,
                              keep_prob=1.0, train: bool = False,
                              sample: bool = True, weight_penalty=None,
                              enc_act_id=None, cls_act_id=None):
    """Phase-2 objective (:431-441): the classification loss of the
    embedding's logits plus L2 on the head's weights only; gradients flow
    through the encoder, as the reference's ``minimize`` spans every
    upstream variable (:443).  ``weight_penalty`` (float or per-instance
    tensor) overrides ``cfg.classification_weight_penalty``; the encoder
    and head activations are chosen by ``enc_act_id`` / ``cls_act_id``.
    The head's dropout uses ``keep_prob`` like the encoder's.  Returns
    ``(loss, aux)``, one loss per instance of a stack."""
    if generator is None:
        generator = torch.Generator(device=noisy_x.device).manual_seed(0)
    mu, log_var = encode(params, cfg, noisy_x, generator=generator,
                         keep_prob=keep_prob, train=train, act_id=enc_act_id)
    embedding = mu
    if cfg.variational and sample:
        eps = _rand(torch.randn, mu, generator)
        embedding = mu + eps * torch.exp(log_var)
    logits = classify(params, cfg, embedding, generator=generator,
                      keep_prob=keep_prob, train=train, act_id=cls_act_id)
    loss = losses_lib.classification_loss(cfg.classification_loss, logits,
                                          true_y)
    penalty = cfg.classification_weight_penalty if weight_penalty is None \
        else weight_penalty
    loss = loss + losses_lib.weight_regularization(penalty,
                                                   list(params.cls_w))
    preds = losses_lib.classification_predictions(cfg.classification_loss,
                                                  logits)
    aux = {"logits": logits, "predictions": preds, "embedding": embedding}
    return loss, aux
