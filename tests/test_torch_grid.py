"""The port's sweep grid against the JAX package's: the MMAESweep default
grid (sweep/wrappers.py:160-168, :257-274) enumerates to the same 108
settings in the same order and falls into the same 9 buckets of 12."""

import pytest

from multimodalautoencoder_tpu.sweep import grid as jax_grid
from multimodalautoencoder_tpu_torch.sweep import grid

# MMAESweep's defaults (sweep/wrappers.py:160-168) as its params dict
# (:257-265)
ACII_PARAMS = {
    "architecture": [[1000, 100], [500, 100], [300, 100]],
    "tie_weights": [True, False],
    "dropout_prob": [1.0, 0.5],
    "weight_penalty": [0.0, 0.01, 0.001],
    "weight_initialization": ["normal"],
    "activation_function": ["softsign", "relu"],
    "variational": [False],
}


def test_acii_grid_and_buckets_match_jax():
    got = grid.add_extra_vae_params(grid.enumerate_grid(ACII_PARAMS))
    want = jax_grid.add_extra_vae_params(
        jax_grid.enumerate_grid(ACII_PARAMS))
    assert len(got) == 108
    assert got == want
    buckets = grid.bucket_settings(got)
    assert [(k, s) for k, s in buckets] == \
        [(k, s) for k, s in jax_grid.bucket_settings(want)]
    assert len(buckets) == 9
    assert all(len(s) == 12 for _, s in buckets)
    # every bucket is depth 2, the training kernels' family
    assert all(len(k[0]) == 2 for k, _ in buckets)


@pytest.mark.parametrize("setting", [
    {"architecture": "[300, 100]", "batch_size": "20.0",
     "optimizer": "GradientDescentOptimizer"},
    {"mmae_architecture": "[1000, 100]", "classification_layers": "[50]",
     "optimizer": "AdagradOptimizer"},
    {"optimizer": "adam", "kernel": "linear", "beta": 0.1},
])
def test_setting_helpers_match_jax(setting):
    assert grid.convert_param_dict_for_use(setting) == \
        jax_grid.convert_param_dict_for_use(setting)
    assert grid.bucket_key(setting) == jax_grid.bucket_key(setting)


def test_trims_match_jax():
    settings = grid.enumerate_grid({"variational": [True, False],
                                    "tie_weights": [True, False],
                                    "kernel": ["linear", "rbf"],
                                    "beta": [0.1, 1.0]})
    assert grid.trim_vae_tied(settings) == jax_grid.trim_vae_tied(settings)
    assert grid.trim_linear_beta(settings) == \
        jax_grid.trim_linear_beta(settings)
