"""Hyperparameter grid enumeration and constraint trimming.

A copy of ``multimodalautoencoder_tpu/sweep/grid.py`` (pure Python), so
the port enumerates and buckets the same settings in the same order.

The reference builds the cross-product with a recursive pop-and-recurse
(generic_wrapper.py:140-185) and each wrapper post-processes the list:

- MMAEWrapper appends VAE-compatible combos with variational=True,
  tie_weights=False (autoencoder_wrapper.py:138-155);
- the classification wrapper strips variational AND tie_weights combos
  (autoencoder_classification_wrapper.py:181-193);
- SVM strips redundant linear-kernel x beta combos
  (comparison_algorithms/svm.py:67-81).

Here enumeration is a deterministic itertools product (sorted-key order so
ledgers are reproducible), plus the same trimming transforms, plus
*shape-bucketing*: configs are grouped by the keys that change array shapes
(architecture / tie_weights / variational) so each bucket can train as one
stacked ``vmap`` batch — the TPU replacement for the reference's serial
sweep loop (generic_wrapper.py:253-254).
"""

from __future__ import annotations

import ast
import itertools
from typing import Any, Dict, Iterable, List, Sequence, Tuple

# keys whose value changes parameter-pytree shapes or trace structure
# -> vmap bucket key (weight_initialization branches the init trace;
# architectures/classification layers change shapes; the optimizer picks
# the update-step trace and its state pytree)
SHAPE_KEYS = ("architecture", "mmae_architecture", "classification_layers",
              "tie_weights", "variational", "weight_initialization",
              "optimizer")


def enumerate_grid(params: Dict[str, Sequence[Any]]) -> List[Dict[str, Any]]:
    """Full cross-product of ``{name: [values...]}`` in deterministic
    (sorted-key, given-value-order) order."""
    if not params:
        return [{}]
    keys = sorted(params.keys())
    out = []
    for combo in itertools.product(*(params[k] for k in keys)):
        out.append(dict(zip(keys, combo)))
    return out


def add_extra_vae_params(settings: List[Dict[str, Any]]
                         ) -> List[Dict[str, Any]]:
    """Mark existing combos non-variational, then append one
    variational+untied combo per unique projection onto the non-tie keys.

    The reference builds the VAE list from the cross product of
    (architecture x activation x dropout x penalty x init), independent of
    which tie_weights values were swept (autoencoder_wrapper.py:138-155) —
    so a sweep configured with tie_weights=[True] still gets its full VAE
    set.  Projecting the enumerated settings and deduping reproduces that
    cross product.
    """
    out = []
    for s in settings:
        s = dict(s)
        s.setdefault("variational", False)
        out.append(s)
    seen = set()
    for s in settings:
        v = dict(s)
        v["variational"] = True
        v["tie_weights"] = False
        key = tuple(sorted((k, str(val)) for k, val in v.items()))
        if key in seen:
            continue
        seen.add(key)
        out.append(v)
    return out


def trim_vae_tied(settings: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Remove combos with variational AND tie_weights — the classification
    wrapper's trim (autoencoder_classification_wrapper.py:181-193)."""
    return [s for s in settings
            if not (s.get("variational") and s.get("tie_weights"))]


def trim_linear_beta(settings: List[Dict[str, Any]],
                     kernel_key: str = "kernel",
                     beta_key: str = "beta") -> List[Dict[str, Any]]:
    """For linear kernels the RBF beta is irrelevant: keep only one beta
    per linear combo (comparison_algorithms/svm.py:67-81)."""
    out, seen = [], set()
    for s in settings:
        if s.get(kernel_key) == "linear":
            key = tuple(sorted((k, str(v)) for k, v in s.items()
                               if k != beta_key))
            if key in seen:
                continue
            seen.add(key)
        out.append(s)
    return out


def convert_param_dict_for_use(setting: Dict[str, Any]) -> Dict[str, Any]:
    """Parse stringified values loaded back from a results CSV
    (generic_wrapper.py:223-244): architecture lists via literal_eval,
    integer batch sizes.  (The reference's version references ``tf``
    without importing it — §2.8.6; here optimizer strings map to names.)"""
    s = dict(setting)
    for key in ("architecture", "mmae_architecture",
                "classification_layers", "classification_layer_sizes"):
        if key in s and isinstance(s[key], str):
            s[key] = ast.literal_eval(s[key])
    if "batch_size" in s and s["batch_size"] is not None:
        s["batch_size"] = int(float(s["batch_size"]))
    if "optimizer" in s and isinstance(s["optimizer"], str):
        low = s["optimizer"].lower()
        s["optimizer"] = ("sgd" if ("gradientdescent" in low
                                    or low == "sgd")
                          else "adagrad" if "adagrad" in low else "adam")
    return s


def bucket_key(setting: Dict[str, Any]) -> Tuple:
    """Shape-bucket key: settings sharing it have identical parameter-pytree
    shapes and trace structure, so they can be stacked into one vmap
    batch."""
    out = []
    for key in SHAPE_KEYS:
        v = setting.get(key)
        if isinstance(v, list):
            v = tuple(v)
        out.append(v)
    return tuple(out)


def bucket_settings(settings: Iterable[Dict[str, Any]]
                    ) -> List[Tuple[Tuple, List[Dict[str, Any]]]]:
    """Group settings by :func:`bucket_key`, preserving first-seen bucket
    order and within-bucket order."""
    order: List[Tuple] = []
    buckets: Dict[Tuple, List[Dict[str, Any]]] = {}
    for s in settings:
        k = bucket_key(s)
        if k not in buckets:
            buckets[k] = []
            order.append(k)
        buckets[k].append(s)
    return [(k, buckets[k]) for k in order]
