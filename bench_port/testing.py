"""A tiny copy of the benchmark's cells for the CPU tests: the same
manifest shape, entries, metric readers and limits, on configurations cut
to a few features and instances, written under a temporary root.  Run a
cell there with ``run.main([...], root=root, device="cpu",
require_cuda=False)``."""

from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

TINY_DATA = {"rows": 160, "modalities": [["call", 8], ["location", 8],
                                          ["screen", 8], ["sms", 8],
                                          ["survey", 8]],
             "labels": 3, "folds": 3, "latent_dim": 4, "gap_frac": 0.1,
             "nan_frac": 0.02, "test_frac": 0.15}
ARCH = [16, 8]
MMAE_SETTINGS = [
    {"learning_rate": 0.001, "dropout_prob": 1.0, "weight_penalty": 0.01,
     "activation": "softsign"},
    {"learning_rate": 0.001, "dropout_prob": 0.5, "weight_penalty": 0.001,
     "activation": "relu"}]
P1_SETTINGS = [{"dropout_prob": 1.0, "weight_penalty": 0.01,
                "activation": "relu"},
               {"dropout_prob": 0.5, "weight_penalty": 0.001,
                "activation": "relu"}]
CLS_SETTINGS = [
    {"mmae_dropout_prob": 1.0, "mmae_weight_penalty": 0.01,
     "mmae_activation": "relu", "weight_penalty": 0.0, "dropout_prob": 0.5,
     "activation": "relu"},
    {"mmae_dropout_prob": 0.5, "mmae_weight_penalty": 0.001,
     "mmae_activation": "relu", "weight_penalty": 0.001,
     "dropout_prob": 1.0, "activation": "relu"}]


def _write(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def _read(path: str):
    with open(path) as f:
        return json.load(f)


def make_tiny_root(root: str, steps: int = 4) -> str:
    """Write the tiny benchmark under ``root`` and return it."""
    here = os.path.join(root, "bench_port")
    os.makedirs(here, exist_ok=True)
    for sub in ("entries", "metrics"):
        link = os.path.join(here, sub)
        if not os.path.exists(link):
            os.symlink(os.path.join(HERE, sub), link)
    manifest = _read(os.path.join(REPO, "BENCHMARK.json"))
    by_name = {c["name"]: c for c in manifest["configs"]}
    for w in manifest["workloads"]:
        _write(os.path.join(here, "limits", w["name"] + ".json"),
               _read(os.path.join(HERE, "limits", w["name"] + ".json")))
    mm = _read(os.path.join(REPO, by_name["acii_mmae_grid"]["file"]))
    mm.update(num_feats=40, data=TINY_DATA, num_steps=steps)
    cls = _read(os.path.join(REPO, by_name["acii_cls_grid"]["file"]))
    cls.update(num_feats=40, data=TINY_DATA, cls_num_steps=steps)
    _write(os.path.join(here, "configs", "acii_mmae_grid.json"), mm)
    _write(os.path.join(here, "configs", "acii_cls_grid.json"), cls)
    buckets = [{"name": f"{ARCH[0]}x{ARCH[1]}.{kind}", "architecture": ARCH,
                "tie_weights": kind == "tied", "variational": kind == "vae",
                "settings": MMAE_SETTINGS}
               for kind in ("tied", "untied", "vae")]
    _write(os.path.join(here, "traffic", "mmae_grid.sweep_mix.json"),
           {"entry": "train_grid_sharded", "steps_per_call": steps,
            "buckets": buckets})
    families = {kind: {"mmae_architecture": ARCH,
                       "tie_weights": kind == "tied",
                       "variational": kind == "vae",
                       "settings": P1_SETTINGS}
                for kind in ("tied", "untied", "vae")}
    cbuckets = [{"name": f"{ARCH[0]}x{ARCH[1]}.h{'-'.join(map(str, h))}."
                         f"{kind}", "family": kind,
                 "classification_layers": h, "p1_map": [1, 0],
                 "settings": CLS_SETTINGS}
                for kind, h in (("tied", [6, 4]), ("untied", [6]),
                                ("vae", [6, 4]))]
    _write(os.path.join(here, "traffic", "cls_grid.phase2_wide.json"),
           {"entry": "train_phase2_shared_sharded", "steps_per_call": steps,
            "families": families, "buckets": cbuckets})
    tiny = copy.deepcopy(manifest)
    for c in tiny["configs"]:
        c["file"] = "bench_port/configs/" + c["name"] + ".json"
    _write(os.path.join(root, "BENCHMARK.json"), tiny)
    return root
