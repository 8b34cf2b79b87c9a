"""The last public functions of the JAX package that the port lacked,
against the JAX package on the CPU:

- ``parallel/grid_trainer.embed_grid``: every (config, fold) instance's
  embedding, (C, K, rows, E), the deterministic mu within 1e-5 of the JAX
  one (f32 sums in another order), DAE and VAE, two activations; the
  VAE's sampled z finite and apart from mu;
- ``utils/helpers.get_rmse``: equal;
- ``DataLoader(extract_modalities=False)``: the same matrices and
  features as the JAX loader, and neither has a modality table;
- ``fill_frame_with_reconstruction`` (``fill_df_with_reconstruction``)
  with ``plot_to_debug``: the same filled values and the same debug PNGs,
  capped at ``max_debug_plots``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from multimodalautoencoder_tpu.config import MMAEConfig as JaxConfig
from multimodalautoencoder_tpu.config import TrainConfig as JaxTrainConfig
from multimodalautoencoder_tpu.data.loader import DataLoader as JaxLoader
from multimodalautoencoder_tpu.models import mmae as jax_mmae
from multimodalautoencoder_tpu.parallel import grid_trainer as jgt
from multimodalautoencoder_tpu.utils import helpers as jhelpers
from multimodalautoencoder_tpu_torch.config import MMAEConfig, TrainConfig
from multimodalautoencoder_tpu_torch.data import synthetic
from multimodalautoencoder_tpu_torch.data.loader import DataLoader
from multimodalautoencoder_tpu_torch.models import mmae
from multimodalautoencoder_tpu_torch.parallel import grid_trainer as pgt
from multimodalautoencoder_tpu_torch.utils import helpers

SETTINGS = [{"activation_function": "softsign"},
            {"activation_function": "relu"}]


@pytest.mark.parametrize("variational", [False, True])
def test_embed_grid_matches_jax(variational):
    kw = dict(num_feats=30, layer_sizes=(16, 6), variational=variational)
    cj, ct = JaxConfig(**kw).validate(), MMAEConfig(**kw).validate()
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    p0 = jax.vmap(lambda k: jax_mmae.init(k, cj))(keys)
    p0 = jax.tree_util.tree_map(lambda a: a.reshape((2, 2) + a.shape[1:]),
                                p0)
    x = np.random.default_rng(0).random((7, 30)).astype(np.float32)
    want = jgt.embed_grid(p0, cj,
                          jgt.HyperStack.from_settings(SETTINGS, cj,
                                                       JaxTrainConfig()),
                          x)
    params = mmae.stacked_params_from_numpy(
        [np.asarray(a) for a in jax.tree_util.tree_leaves(p0)], ct, "cpu")
    hyper = pgt.HyperStack.from_settings(SETTINGS, ct, TrainConfig())
    got = pgt.embed_grid(params, ct, hyper, torch.from_numpy(x))
    assert tuple(got.shape) == tuple(want.shape) == (2, 2, 7, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if variational:
        z = pgt.embed_grid(params, ct, hyper, torch.from_numpy(x),
                           torch.Generator().manual_seed(1), sample=True)
        assert z.shape == got.shape and bool(torch.isfinite(z).all())
        assert not torch.allclose(z, got)


def test_get_rmse_matches_jax():
    rng = np.random.default_rng(1)
    a, b = rng.random((5, 9)), rng.random((5, 9)).astype(np.float32)
    assert helpers.get_rmse(a, b) == jhelpers.get_rmse(a, b)
    assert helpers.get_rmse(a, a) == 0.0


@pytest.fixture
def csv_path(tmp_path):
    return synthetic.write_csv(str(tmp_path / "data.csv"), num_rows=120,
                               seed=2)


def test_loader_without_modalities_matches_jax(csv_path):
    kw = dict(supervised=False, suppress_output=True, fill_gaps_with=-1.0,
              extract_modalities=False)
    jl, pl = JaxLoader(csv_path, **kw), DataLoader(csv_path, **kw)
    assert pl.wanted_feats == jl.wanted_feats
    assert pl.num_feats == jl.num_feats
    np.testing.assert_array_equal(pl.train_X, jl.train_X)
    np.testing.assert_array_equal(pl.test_X, jl.test_X)
    for name in ("modality_table", "modality_names", "num_modalities"):
        assert not hasattr(pl, name) and not hasattr(jl, name)
    full = DataLoader(csv_path, **dict(kw, extract_modalities=True))
    assert full.modality_names == JaxLoader(
        csv_path, **dict(kw, extract_modalities=True)).modality_names


def test_fill_with_debug_plots_matches_jax(csv_path, tmp_path):
    """Four rows lose modality 0; the fill writes the reconstruction over
    that span only, and three overlays (max_debug_plots) are saved."""
    kw = dict(supervised=False, suppress_output=True, fill_gaps_with=-1.0)
    jl, pl = JaxLoader(csv_path, **kw), DataLoader(csv_path, **kw)
    feats = pl.wanted_feats
    s, e = pl.modality_table.span(0)
    X = pl.frame.matrix(feats)
    X[:4, s:e] = -1.0
    frame = pl.frame.with_columns(feats, X)
    df = jl.df.copy()
    df[feats] = X
    Xbar = np.random.default_rng(3).random(X.shape)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jl.fill_df_with_reconstruction(df, Xbar, plot_to_debug=True,
                                          plot_save_dir=jdir,
                                          max_debug_plots=3)
    got = pl.fill_frame_with_reconstruction(frame, Xbar, plot_to_debug=True,
                                            plot_save_dir=pdir,
                                            max_debug_plots=3)
    np.testing.assert_array_equal(got.matrix(feats),
                                  want[feats].to_numpy(dtype=float))
    np.testing.assert_array_equal(got.matrix(feats)[:4, s:e], Xbar[:4, s:e])
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    assert len(os.listdir(pdir)) == 3
    assert pl.fill_df_with_reconstruction == \
        pl.fill_frame_with_reconstruction
