"""The relu VAE settings of the ACII grid under the reference's objective,
in the JAX package's own trainer and in the port, at full width on the
card.

The reference-scale study fills whole-modality gaps with -1, and the
reference's sigmoid cross-entropy takes the clean batch, -1 values
included, as its target, so the objective is unbounded below.  This test
runs the 1000-wide VAE bucket (its 12 settings, 6 of them relu) on fold 0
with the sweep's recipe for 2000 steps, for two seeds, and once more with
the gaps set to 0 (every target in [0, 1], the objective bounded),
through three trainers: the JAX package's XLA trainer (``train_grid_jit``,
on the CPU), the port's plain backend (``backend="xla"``, the same
semantics: k element draws, the update with the rounded bf16 moments) and
the port's training kernels (``backend="pallas"``, the Pallas semantics).  It prints every
setting's objective and holds all three to the same account: softsign
settings stay finite and end below their start (all but at most one: the
objective is one random draw, and the port's kernels print four more),
while relu settings diverge (NaN, or not below their start) in the
reference as in the port.

On a machine with an NVIDIA GPU (about 15 minutes on an H100, most of it
the JAX trainer on the CPU):

    JAX_PLATFORMS=cpu python3 -m pytest tests/test_torch_relu_divergence.py \\
        -m cuda -s -q
"""

import time

import jax
import numpy as np
import pytest
import torch

from multimodalautoencoder_tpu.config import MMAEConfig as JaxConfig
from multimodalautoencoder_tpu.config import TrainConfig as JaxTrainConfig
from multimodalautoencoder_tpu.data import synthetic as jax_synthetic
from multimodalautoencoder_tpu.models.corruption import \
    NoiseSpec as JaxNoiseSpec
from multimodalautoencoder_tpu.parallel import grid_trainer as jgt
from multimodalautoencoder_tpu.sweep import grid as jgrid
from multimodalautoencoder_tpu_torch.config import MMAEConfig, TrainConfig
from multimodalautoencoder_tpu_torch.data.modalities import ModalityTable
from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec
from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk
from multimodalautoencoder_tpu_torch.parallel import grid_trainer as pgt
from multimodalautoencoder_tpu_torch.sweep import grid

pytestmark = pytest.mark.cuda

STEPS = 2000
CHECKPOINTS = (500, 1000, STEPS)
GRID = {"architecture": [[1000, 100]], "tie_weights": [True, False],
        "dropout_prob": [1.0, 0.5], "weight_penalty": [0.0, 0.01, 0.001],
        "weight_initialization": ["normal"],
        "activation_function": ["softsign", "relu"], "variational": [False]}
BASE = dict(loss="sigmoid_cross_entropy", normalization="between_0_and_1",
            mask_with=-1.0, fill_missing_with=0.0, layer_sizes=(1000, 100),
            variational=True, weight_initialization="normal")
RECIPE = dict(learning_rate=1e-3, batch_size=20, decay=True,
              decay_steps=1000, decay_rate=0.95, clip_gradients=False,
              optimizer_state_dtype="bfloat16")


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """Fold 0 of the reference-scale study (train, val rows) and its
    modality table."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    unsup, _ = jax_synthetic.reference_scale_loaders(
        str(tmp_path_factory.mktemp("study")))
    a, _, b, _ = unsup.get_cross_val_data_for_fold(0)
    return a, b, unsup.modality_table


def make_bucket(study, targets):
    """The VAE bucket's settings and its inputs in both packages.  With
    ``targets == "bounded"`` the -1 gap values become 0, so every target
    lies in [0, 1] and the objective is bounded below."""
    a, b, jt = study
    if targets == "bounded":
        a, b = np.maximum(a, 0.0), np.maximum(b, 0.0)
    members = [s for s in jgrid.add_extra_vae_params(
        jgrid.enumerate_grid(GRID)) if s["variational"]]
    assert members == [s for s in grid.add_extra_vae_params(
        grid.enumerate_grid(GRID)) if s["variational"]]
    assert len(members) == 12
    table = ModalityTable(names=jt.names, start_indices=jt.start_indices,
                          num_feats=jt.num_feats)
    cj = JaxConfig(num_feats=jt.num_feats, **BASE).validate()
    cp = MMAEConfig(num_feats=jt.num_feats, **BASE).validate()
    tj, tp = JaxTrainConfig(**RECIPE), TrainConfig(**RECIPE)
    jax_side = (cj, tj, JaxNoiseSpec.build(cj, jt),
                jgt.HyperStack.from_settings(members, cj, tj),
                jgt.FoldedData.from_ragged([a], [b]))
    port = (cp, tp, NoiseSpec.build(cp, table),
            pgt.HyperStack.from_settings(members, cp, tp),
            pgt.FoldedData.from_ragged([a], [b], device="cuda"))
    return members, jax_side, port


def diverged(loss0, loss):
    """Non-finite, or not below the 0-step objective."""
    loss0, loss = np.asarray(loss0), np.asarray(loss)
    return ~np.isfinite(loss) | ~(loss < loss0)


@pytest.mark.parametrize("targets, seed", [("gaps -1", 0), ("gaps -1", 1),
                                           ("bounded", 0)])
def test_vae_bucket_relu_diverges_in_reference_and_port(study, targets,
                                                        seed):
    members, (cj, tj, sj, hj, fj), (cp, tp, sp, hp, fp) = make_bucket(
        study, targets)
    torch.backends.cuda.matmul.allow_tf32 = False
    relu = np.array([s["activation_function"] == "relu" for s in members])

    t = time.perf_counter()
    key = jax.random.PRNGKey(seed)
    ref0 = np.asarray(jgt.train_grid_jit(key, cj, tj, sj, hj, fj, 0)[1])[:, 0]
    ref = np.asarray(jgt.train_grid_jit(key, cj, tj, sj, hj, fj,
                                        STEPS)[1])[:, 0]
    ref_s = time.perf_counter() - t

    def port(backend, steps):
        return pgt.train_grid_sharded("cuda", seed, cp, tp, sp, hp, fp,
                                      num_steps=steps, backend=backend)

    def first(loss):
        return loss[:, 0].cpu().numpy()

    t = time.perf_counter()
    plain0, plain = first(port("xla", 0)[1]), first(port("xla", STEPS)[1])
    plain_s = time.perf_counter() - t
    kern0 = first(port("pallas", 0)[1])
    kern = {s: first(port("pallas", s)[1]) for s in CHECKPOINTS[:-1]}
    params, loss = port("pallas", STEPS)
    kern[STEPS] = first(loss)
    # the objective is one draw of the corruption and of the VAE's z; four
    # more draws on the same trained parameters show how much it moves
    redraw = np.stack([first(ptk.noisy_val_losses(
        params, cp, sp, hp, fp, torch.Generator().manual_seed(100 + d)))
        for d in range(4)], axis=1)

    print(f"\nVAE 1000 -> 100 bucket, fold 0, targets {targets}, seed "
          f"{seed}, {STEPS} steps "
          f"(reference: JAX XLA trainer on the CPU, {ref_s:.0f} s; port "
          f"plain backend on the card, {plain_s:.0f} s; port kernels on "
          f"the card at steps {CHECKPOINTS}, then 4 more draws of the "
          f"objective):")
    for i, s in enumerate(members):
        cells = " ".join(f"{kern[c][i]:10.4g}" for c in CHECKPOINTS)
        more = " ".join(f"{v:10.4g}" for v in redraw[i])
        print(f"  {s['activation_function']:8s} keep {s['dropout_prob']:.1f}"
              f" pen {s['weight_penalty']:<5}: reference {ref0[i]:7.2f} -> "
              f"{ref[i]:10.4g}; plain {plain0[i]:7.2f} -> {plain[i]:10.4g};"
              f" kernels {kern0[i]:7.2f} -> {cells} | {more}")
    runs = {"reference": (ref0, ref), "plain": (plain0, plain),
            "kernels": (kern0, kern[STEPS])}
    counts = {name: (int(diverged(*r)[relu].sum()),
                     int(diverged(*r)[~relu].sum()))
              for name, r in runs.items()}
    print("  diverged (non-finite or not below the 0-step objective), "
          "relu / softsign of 6 each: "
          + ", ".join(f"{n} {r} / {s}" for n, (r, s) in counts.items()))
    for name, (start, end) in runs.items():
        # softsign is bounded: every such setting stays finite and all but
        # at most one end below their start
        assert np.isfinite(end[~relu]).all(), name
        assert (end[~relu] < start[~relu]).sum() >= 5, name
    # the relu settings diverge in the reference as in the port
    for name, (relu_diverged, _) in counts.items():
        assert relu_diverged >= 1, name
