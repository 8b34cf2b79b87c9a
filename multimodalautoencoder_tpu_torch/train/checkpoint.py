"""Checkpoints with a hyperparameter side-car, in the JAX package's format.

Counterpart of ``multimodalautoencoder_tpu/train/checkpoint.py``.  The
format is the same ``.npz``: ``param_<i>`` leaves in the JAX pytree's
flatten order (``models/mmae.params_to_numpy``), ``curve_<name>`` arrays,
``state_<name>_<i>`` leaves of named auxiliary states (optimizer slots,
step counter, RNG), and a ``meta_json`` blob holding every config field.
So a checkpoint written by either package loads in the other.  A state is
a tree of tensors (``ops/optim.tree_map``'s nests of tuples and
NamedTuples), flattened in the JAX pytree's order (``None`` skipped);
bfloat16 leaves are stored as uint16 views, as the JAX package stores
them.

The reference contract (multimodal_autoencoder.py:766-896): loading diffs
the saved hyperparameters against the current ones, warns, and keeps the
saved values, since the weights were trained under them.  Checkpoint
names carry the trained-step count (``<name>-<steps>``, :787-791).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

from multimodalautoencoder_tpu_torch.config import MMAEConfig, TrainConfig
from multimodalautoencoder_tpu_torch.models import mmae
from multimodalautoencoder_tpu_torch.ops import optim

# The 7 hyperparameters the reference persists (:792-801).
SIDECAR_FIELDS = ("layer_sizes", "variational", "dropout_prob",
                  "weight_penalty", "activation", "loss",
                  "weight_initialization")


def save_checkpoint(directory: str, model_name: str,
                    params: mmae.MMAEParams, cfg: MMAEConfig,
                    curves: Optional[dict] = None,
                    step: Optional[int] = None,
                    tcfg: Optional[TrainConfig] = None,
                    states: Optional[dict] = None,
                    state_tags: Optional[dict] = None,
                    extra: Optional[dict] = None) -> str:
    """Save params + hyperparameter/curve side-car; returns the file path.

    ``step`` defaults to ``len(train_loss) * record_every_nth``, matching
    the reference's "training_epochs" naming (:787-788).  ``states`` maps a
    name to a state tree persisted beside the params, the analog of the
    reference Saver covering the optimizer's slot variables (:786-788);
    ``state_tags`` attaches a string per state (the optimizer's name) that
    :meth:`CheckpointReader.restore_state` can check.  ``extra`` is a
    JSON-serializable dict stored under ``meta["extra"]``.
    """
    os.makedirs(directory, exist_ok=True)
    curves = curves or {}
    states = states or {}
    state_tags = state_tags or {}
    if step is None:
        record = tcfg.record_every_nth if tcfg else 50
        step = len(np.asarray(curves.get("train_loss", []))) * record

    leaves = mmae.params_to_numpy(params)
    payload = {f"param_{i}": a for i, a in enumerate(leaves)}
    for name, arr in curves.items():
        payload[f"curve_{name}"] = np.asarray(arr)
    states_meta = {}
    for name, tree in states.items():
        s_leaves = optim.tree_leaves(tree)
        bf16 = []
        for i, leaf in enumerate(s_leaves):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                bf16.append(i)
                a = leaf.view(torch.int16).numpy().view(np.uint16)
            else:
                a = leaf.numpy()
            payload[f"state_{name}_{i}"] = a
        states_meta[name] = {"num_leaves": len(s_leaves), "bf16": bf16,
                             "tag": state_tags.get(name)}
    meta = {
        "num_leaves": len(leaves),
        # readers of both packages rebuild the structure from the config
        "treedef": "MMAEParams",
        "step": int(step),
        "config": {f.name: getattr(cfg, f.name)
                   for f in dataclasses.fields(cfg)},
        "curve_names": sorted(curves.keys()),
        "states": states_meta,
    }
    if extra is not None:
        meta["extra"] = extra
    payload["meta_json"] = np.frombuffer(
        json.dumps(meta, default=_json_default).encode(), dtype=np.uint8)

    path = os.path.join(directory, f"{model_name}-{step}.npz")
    np.savez(path, **payload)
    return path


def _json_default(o):
    if isinstance(o, (tuple, set)):
        return list(o)
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    raise TypeError(f"not JSON serializable: {type(o)}")


def _as_tuples(v):
    """JSON lists back to the config's (nested) tuples."""
    if isinstance(v, list):
        return tuple(tuple(x) if isinstance(x, list) else x for x in v)
    return v


def latest_checkpoint(directory: str,
                      model_name: Optional[str] = None) -> Optional[str]:
    """Highest-step checkpoint in ``directory`` — the analog of
    ``tf.train.latest_checkpoint`` (:823)."""
    if not os.path.isdir(directory):
        return None
    pat = re.compile(r"^(.*)-(\d+)\.npz$")
    best, best_step = None, -1
    for fn in os.listdir(directory):
        m = pat.match(fn)
        if not m:
            continue
        if model_name is not None and m.group(1) != model_name:
            continue
        if int(m.group(2)) > best_step:
            best, best_step = fn, int(m.group(2))
    return os.path.join(directory, best) if best else None


class CheckpointReader:
    """One-open view of a checkpoint: the npz directory and the JSON
    metadata parse once, then params and curves load from the same handle.
    Use as a context manager."""

    def __init__(self, path: str):
        self.path = path
        self._data = np.load(path)
        self.meta = json.loads(bytes(self._data["meta_json"]).decode())

    def close(self) -> None:
        self._data.close()

    def __enter__(self) -> "CheckpointReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def step(self) -> int:
        return self.meta["step"]

    def state_names(self) -> tuple:
        return tuple(sorted(self.meta.get("states", {})))

    def curves(self) -> dict:
        return {name: self._data[f"curve_{name}"]
                for name in self.meta.get("curve_names", [])}

    def restore_state(self, name: str, template,
                      expect_tag: Optional[str] = None):
        """The state saved under ``name`` in ``template``'s structure, or
        None when the checkpoint has none (the equivalent of
        ``saver.restore`` over the slot variables, :855-859).  Each leaf
        comes back bit for bit, on the device of the template's leaf.
        Raises ``ValueError``
        on a tag, leaf-count, shape or dtype mismatch (a checkpoint saved
        under another optimizer, structure or ``optimizer_state_dtype``);
        callers fall back to a fresh state."""
        info = self.meta.get("states", {}).get(name)
        if info is None:
            return None
        if expect_tag is not None and info.get("tag") not in (None,
                                                              expect_tag):
            raise ValueError(
                f"checkpoint state {name!r} was saved under tag "
                f"{info.get('tag')!r} but {expect_tag!r} was expected")
        bf16 = set(info.get("bf16", []))
        want = optim.tree_leaves(template)
        if info["num_leaves"] != len(want):
            raise ValueError(
                f"checkpoint state {name!r} has {info['num_leaves']} leaves "
                f"but the template has {len(want)}: optimizer or model "
                "structure differs; fall back to a fresh state")
        leaves = []
        for i, t in enumerate(want):
            a = self._data[f"state_{name}_{i}"]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(
                    f"checkpoint state {name!r} leaf shape {a.shape} != "
                    f"template {tuple(t.shape)}: fall back to a fresh state")
            got = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                   if i in bf16 else torch.from_numpy(a))
            if got.dtype != t.dtype:
                raise ValueError(
                    f"checkpoint state {name!r} leaf dtype {got.dtype} != "
                    f"template {t.dtype} (optimizer_state_dtype differs?): "
                    "fall back to a fresh state")
            leaves.append(got.to(t.device))
        it = iter(leaves)
        return optim.tree_map(lambda _: next(it), template)

    def sidecar_resolved(self, cfg: MMAEConfig,
                         verbose: bool = True) -> MMAEConfig:
        """Diff the persisted SIDECAR_FIELDS against ``cfg``, warn, and
        override with the saved values (the saved model wins, :840-853)."""
        saved_cfg = self.meta["config"]
        resolved = cfg
        for name in SIDECAR_FIELDS:
            saved = _as_tuples(saved_cfg.get(name))
            current = getattr(cfg, name)
            if saved is not None and saved != current:
                if verbose:
                    print(f"WARNING! Saved setting for {name} is "
                          f"different! current={current!r} saved={saved!r}; "
                          f"overwriting with saved value.")
                resolved = resolved.replace(**{name: saved})
        return resolved

    def full_resolved(self, cfg: MMAEConfig) -> MMAEConfig:
        """``cfg`` overridden by EVERY persisted config field — the
        reference rebuilds its whole graph from the saved hyperparameters
        (:855-859)."""
        names = {f.name for f in dataclasses.fields(cfg)}
        return dataclasses.replace(cfg, **{
            k: _as_tuples(v) for k, v in self.meta["config"].items()
            if k in names}).validate()

    def params(self, cfg: MMAEConfig, device="cuda") -> mmae.MMAEParams:
        """The stored parameters, in the structure ``cfg`` implies, as
        tensors on ``device``."""
        leaves = [self._data[f"param_{i}"]
                  for i in range(self.meta["num_leaves"])]
        return mmae.params_from_numpy(leaves, cfg, device=device)

    def load(self, cfg: MMAEConfig, verbose: bool = True, device="cuda"
             ) -> Tuple[mmae.MMAEParams, MMAEConfig, dict, int]:
        """(params, resolved_cfg, curves, step), with ``cfg``'s side-car
        fields overridden by the saved ones."""
        resolved = self.sidecar_resolved(cfg, verbose=verbose)
        return (self.params(resolved, device), resolved, self.curves(),
                self.step)

    def load_auto(self, cfg: MMAEConfig, verbose: bool = True,
                  device="cuda"):
        """:meth:`load` with every saved config field taking precedence."""
        return self.load(self.full_resolved(cfg), verbose=verbose,
                         device=device)


def load_checkpoint(path: str, cfg: MMAEConfig, verbose: bool = True,
                    device="cuda"
                    ) -> Tuple[mmae.MMAEParams, MMAEConfig, dict, int]:
    """Load (params, resolved_cfg, curves, step) from a checkpoint.  Any
    persisted side-car hyperparameter that differs from ``cfg`` is reported
    and the saved value wins (:840-853); the parameter structure follows
    the resolved config."""
    with CheckpointReader(path) as r:
        return r.load(cfg, verbose=verbose, device=device)


def load_checkpoint_auto(path: str, cfg: MMAEConfig, verbose: bool = True,
                         device="cuda"):
    """Load a checkpoint under the config it was saved with: every saved
    field overrides ``cfg`` (the reference rebuilds its whole graph from
    them, :855-859)."""
    with CheckpointReader(path) as r:
        return r.load_auto(cfg, verbose=verbose, device=device)


def saved_state_names(path: str) -> tuple:
    """Names of the auxiliary states stored in a checkpoint, the analog of
    listing the reference Saver's slot variables (:786-788)."""
    with CheckpointReader(path) as r:
        return r.state_names()


def restore_state(path: str, name: str, template: Any,
                  expect_tag: Optional[str] = None):
    """:meth:`CheckpointReader.restore_state` on the checkpoint at
    ``path``."""
    with CheckpointReader(path) as r:
        return r.restore_state(name, template, expect_tag=expect_tag)


def checkpoint_meta(path: str) -> dict:
    """The checkpoint's JSON metadata (config, step, curve names, and any
    ``extra`` dict passed at save time) without loading the weights
    (multimodal_autoencoder.py:833-839)."""
    with CheckpointReader(path) as r:
        return r.meta
