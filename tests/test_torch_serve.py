"""The serve slice as a whole: the port's CLI against the JAX package's.

From one JAX-made checkpoint (tied softsign DAE with ``use_pallas``), both
CLIs run ``fill`` and ``embed --normalize-and-fill`` on their own copy of
a 200-row synthetic CSV (5 modalities x 6 features); the port runs with
``--device cpu``, where its dense layers take the kernel's plain version.
Outputs are compared by index label:

- cells the fill leaves alone are bit-equal; filled spans agree to 1e-5;
- embeddings and ``reconstruction_report`` agree to 1e-5 (f32 forward,
  different summation orders);
- the data layer (wanted features, normalized matrix, splits, modality
  table, row order) is identical.
"""

import dataclasses
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from multimodalautoencoder_tpu import cli as jcli
from multimodalautoencoder_tpu.config import MMAEConfig as JaxConfig
from multimodalautoencoder_tpu.data import synthetic as jsynthetic
from multimodalautoencoder_tpu.data.loader import DataLoader as JaxLoader
from multimodalautoencoder_tpu.models import mmae as jmmae
from multimodalautoencoder_tpu.tools import files as jfiles
from multimodalautoencoder_tpu.train import checkpoint as jckpt
from multimodalautoencoder_tpu_torch import cli
from multimodalautoencoder_tpu_torch.config import MMAEConfig
from multimodalautoencoder_tpu_torch.data import preprocess, synthetic
from multimodalautoencoder_tpu_torch.data.loader import DataLoader, read_csv
from multimodalautoencoder_tpu_torch.models import mmae
from multimodalautoencoder_tpu_torch.tools import files
from multimodalautoencoder_tpu_torch.train import checkpoint as ckpt

MODS = tuple((name, 6) for name in ("call", "location", "screen", "sms",
                                    "survey"))
ROWS = 200
SEED = 11


def _loaders(path, normalization="between_0_and_1"):
    fill_gaps = -1.0 if normalization == "between_0_and_1" else None
    kw = dict(normalize_and_fill=True, normalization=normalization,
              fill_gaps_with=fill_gaps, suppress_output=True)
    return (JaxLoader(path, supervised=False, **kw), DataLoader(path, supervised=False, **kw))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both CLIs' fill and embed outputs from one JAX checkpoint."""
    root = tmp_path_factory.mktemp("serve")
    for side in ("jax", "port"):
        os.makedirs(root / side)
    jcsv = jsynthetic.write_csv(str(root / "jax" / "study.csv"),
                                num_rows=ROWS, seed=SEED, modalities=MODS)
    pcsv = str(root / "port" / "study.csv")
    shutil.copy(jcsv, pcsv)

    jdl, pdl = _loaders(jcsv)
    jcfg = JaxConfig(num_feats=jdl.num_feats, layer_sizes=(16, 4),
                     tie_weights=True, activation="softsign",
                     use_pallas=True).validate()
    jp = jmmae.init(jax.random.PRNGKey(SEED), jcfg)
    ck = jckpt.save_checkpoint(str(root / "ck"), "dae", jp, jcfg, step=10)

    out = {}
    for cmd in ("fill", "embed"):
        assert jcli.main([cmd, jcsv, "--checkpoint", ck,
                          "--normalize-and-fill"]) == 0
        assert cli.main([cmd, pcsv, "--checkpoint", ck,
                         "--normalize-and-fill", "--device", "cpu"]) == 0
    prefix = {"fill": "MMAE_filled-", "embed": "embedding-"}
    for cmd, p in prefix.items():
        out[cmd] = tuple(pd.read_csv(str(root / side / (p + "study.csv")),
                                     index_col=0)
                         for side in ("jax", "port"))
    return dict(jcsv=jcsv, pcsv=pcsv, ck=ck, jcfg=jcfg, jp=jp, jdl=jdl,
                pdl=pdl, out=out)


def test_fill_matches_jax(served):
    j, p = served["out"]["fill"]
    assert list(p.index) == list(j.index)       # same shuffled row order
    assert list(p.columns) == list(j.columns)
    jdl = served["jdl"]
    feats = jdl.wanted_feats
    X_in = jdl.df[feats].to_numpy(dtype=float)
    filled = np.zeros_like(X_in, dtype=bool)
    for m in range(jdl.num_modalities):
        s, e = jdl.modality_table.span(m)
        rows = (X_in[:, s:e] == -1.0).all(axis=1)
        filled[rows, s:e] = True
    assert filled.any()
    jx, px = j[feats].to_numpy(), p[feats].to_numpy()
    np.testing.assert_array_equal(px[~filled], jx[~filled])
    np.testing.assert_allclose(px[filled], jx[filled], atol=1e-5, rtol=0)
    assert not np.any(px[filled] == -1.0)
    other = [c for c in j.columns if c not in set(feats)]
    pd.testing.assert_frame_equal(p[other], j[other])


def test_embed_matches_jax(served):
    j, p = served["out"]["embed"]
    assert list(p.index) == list(j.index)
    assert list(p.columns) == list(j.columns)
    emb = [c for c in j.columns if c.startswith("ae_embedding_dim")]
    assert len(emb) == 4
    np.testing.assert_allclose(p[emb].to_numpy(), j[emb].to_numpy(),
                               atol=1e-5, rtol=0)
    other = [c for c in j.columns if c not in set(emb)]
    pd.testing.assert_frame_equal(p[other], j[other])


def test_reconstruction_report_matches_jax(served):
    jdl, pdl = served["jdl"], served["pdl"]
    want = jfiles.reconstruction_report(served["jp"], served["jcfg"], jdl,
                                        jdl.val_X, verbose=False)
    tp, cfg, _, _ = ckpt.load_checkpoint_auto(
        served["ck"], MMAEConfig(num_feats=pdl.num_feats), verbose=False,
        device="cpu")
    got = files.reconstruction_report(tp, cfg, pdl, pdl.val_X,
                                      verbose=False)
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("normalization", ["between_0_and_1", "z_score"])
def test_data_layer_identical(served, normalization):
    jdl, pdl = _loaders(served["jcsv"], normalization)
    assert pdl.wanted_feats == jdl.wanted_feats
    assert list(pdl.frame.index) == [str(i) for i in jdl.df.index]
    np.testing.assert_array_equal(pdl.frame.matrix(pdl.wanted_feats),
                                  jdl.df[jdl.wanted_feats].to_numpy(float))
    for split in ("train_X", "val_X", "test_X"):
        np.testing.assert_array_equal(getattr(pdl, split),
                                      getattr(jdl, split))
    assert dataclasses.asdict(pdl.modality_table) == \
        dataclasses.asdict(jdl.modality_table)
    assert pdl.num_feats == jdl.num_feats
    assert pdl.modality_start_indices == jdl.modality_start_indices
    row = pdl.train_X[0]
    assert pdl.find_missing_modalities_indices(row) == \
        jdl.find_missing_modalities_indices(row)


@pytest.mark.parametrize("n,seed", [(2000, 0), (2000, 7), (37, 3)])
def test_shuffle_order_is_pandas_sample(n, seed):
    df = pd.DataFrame({"a": np.arange(n)})
    np.testing.assert_array_equal(
        preprocess.shuffle_order(n, seed),
        df.sample(frac=1, random_state=seed).index.to_numpy())


def test_synthetic_and_csv_round_trip_match_pandas(tmp_path):
    """The port's synthetic study is the JAX package's, and a CSV read and
    written back by the port is byte-identical to pandas doing the same."""
    jpath = jsynthetic.write_csv(str(tmp_path / "j.csv"), num_rows=60,
                                 seed=4, modalities=MODS,
                                 label_names=("a_label", "b_label"))
    ppath = synthetic.write_csv(str(tmp_path / "p.csv"), num_rows=60,
                                seed=4, modalities=MODS,
                                label_names=("a_label", "b_label"))
    with open(jpath) as f1, open(ppath) as f2:
        assert f1.read() == f2.read()
    read_csv(jpath).to_csv(str(tmp_path / "again.csv"))
    pd.read_csv(jpath, index_col=0).to_csv(str(tmp_path / "pandas.csv"))
    with open(tmp_path / "pandas.csv") as f1, \
            open(tmp_path / "again.csv") as f2:
        assert f1.read() == f2.read()
    big = synthetic.write_reference_scale_csv(str(tmp_path), num_rows=20)
    frame = read_csv(big)
    assert len(preprocess.get_wanted_feats_from_df(frame.names)) == 1000
    assert len(frame) == 20


def test_missing_text_cells_fill_like_pandas(tmp_path):
    path = tmp_path / "gaps.csv"
    path.write_text(",call_f0,call_f1,happy_label,dataset,user_id,"
                    "logistics_noisy\n"
                    "0,0.5,,1.0,Train,3,True\n"
                    "1,,0.25,,Train,NA,False\n"
                    "2,0.1,0.2,0.0,,7,False\n")
    kw = dict(normalize_and_fill=True, suppress_output=True)
    jdl = JaxLoader(str(path), supervised=False, **kw)
    pdl = DataLoader(str(path), supervised=False, **kw)
    pdl.frame.to_csv(str(tmp_path / "port.csv"))
    jdl.df.to_csv(str(tmp_path / "jax.csv"))
    got, want = (pd.read_csv(str(tmp_path / f"{side}.csv"), index_col=0)
                 for side in ("port", "jax"))
    assert got.isna().sum().sum() == 0
    pd.testing.assert_frame_equal(got, want)


def test_vae_checkpoint_serves_on_cpu(tmp_path):
    """The VAE samples at eval time, so it is checked by contract: files
    written, finite values, only -1 spans changed, embedding width."""
    pcsv = synthetic.write_csv(str(tmp_path / "s.csv"), num_rows=80,
                               seed=2, modalities=MODS)
    pdl = DataLoader(pcsv, supervised=False, fill_gaps_with=-1.0,
                     suppress_output=True)
    cfg = MMAEConfig(num_feats=pdl.num_feats, layer_sizes=(16, 4),
                     variational=True, use_pallas=True)
    ck = ckpt.save_checkpoint(str(tmp_path / "ck"), "vae",
                              mmae.init(cfg, device="cpu"), cfg, step=1)
    for cmd in ("fill", "embed"):
        assert cli.main([cmd, pcsv, "--checkpoint", ck,
                         "--normalize-and-fill", "--device", "cpu"]) == 0
    filled = read_csv(str(tmp_path / "MMAE_filled-s.csv"))
    before = pdl.frame.matrix(pdl.wanted_feats)
    after = filled.matrix(pdl.wanted_feats)
    assert np.isfinite(after).all()
    # the CSV text round trip moves a value by at most an ulp
    changed = ~np.isclose(before, after, rtol=0, atol=1e-12)
    assert changed.any() and (before[changed] == -1.0).all()
    emb = read_csv(str(tmp_path / "embedding-s.csv"))
    dims = [c for c in emb.names if c.startswith("ae_embedding_dim")]
    assert len(dims) == 4 and len(emb) == 80
    narrow = synthetic.write_csv(str(tmp_path / "n.csv"), num_rows=30,
                                 seed=1, modalities=MODS[:3])
    with pytest.raises(SystemExit, match="features"):
        cli.main(["fill", narrow, "--checkpoint", ck, "--device", "cpu"])


def test_cuda_device_is_never_replaced(tmp_path):
    """--device cuda without a card fails; it does not run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    pcsv = synthetic.write_csv(str(tmp_path / "s.csv"), num_rows=20,
                               seed=2, modalities=MODS)
    cfg = MMAEConfig(num_feats=30, layer_sizes=(8, 4), use_pallas=True)
    ck = ckpt.save_checkpoint(str(tmp_path / "ck"), "m",
                              mmae.init(cfg, device="cpu"), cfg, step=1)
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["embed", pcsv, "--checkpoint", ck])
    assert not os.path.exists(tmp_path / "embedding-s.csv")
