"""The port's native CSV engine (``data/fast_csv.py``) and the rest of its
data layer against the JAX package:

- ``engine="native"`` reads the same C++ parser (``native/csv_loader.cpp``)
  as the JAX package's native engine, so its feature values equal the JAX
  engine's bit for bit, and each is the correctly rounded value of its
  text.  The default reader gives pandas' values instead, which keep only
  17 digits, leading zeros included: the count of values that differ and
  their largest distance in units in the last place are printed (at the
  reference scale, 0.002544689905312978 reads 180 units apart);
- ``DataLoader(engine="native")`` against the default engine, folds
  persisted with only the fold column written back, and ``--engine``;
- a build that fails raises, naming it (no fallback);
- ``count_gaps_in_modalities`` and ``reference_scale_loaders`` against the
  JAX package's, the latter at 240 rows."""

import csv
import os

import jax  # noqa: F401  (the JAX package runs on the CPU here)
import numpy as np
import pytest

from multimodalautoencoder_tpu.data import fast_csv as jfast
from multimodalautoencoder_tpu.data import preprocess as jpp
from multimodalautoencoder_tpu.data import synthetic as jsynthetic
from multimodalautoencoder_tpu_torch import cli
from multimodalautoencoder_tpu_torch.data import fast_csv
from multimodalautoencoder_tpu_torch.data import preprocess as pp
from multimodalautoencoder_tpu_torch.data import synthetic
from multimodalautoencoder_tpu_torch.data.loader import DataLoader, read_csv


@pytest.fixture
def study(tmp_path):
    return synthetic.write_reference_scale_csv(str(tmp_path), num_rows=120,
                                               seed=2)


def ulps(a, b):
    ia = a.view(np.int64)
    ib = b.view(np.int64)
    return np.abs(ia - ib)


def test_native_engine_matches_jax_native_bit_for_bit(study, monkeypatch):
    frame = fast_csv.read_csv(study)
    # the JAX engine loads the same source's build from the port's
    # _build/, so that no other test process's build of native/build can
    # race it into its pandas fallback
    monkeypatch.setattr(jfast, "_SO_PATH", fast_csv.LIB.library)
    monkeypatch.setattr(jfast, "_lib", None)
    monkeypatch.setattr(jfast, "_lib_failed", False)
    assert jfast.native_available()
    jdf = jfast.read_dataframe(study)
    feats = pp.get_wanted_feats_from_df(frame.names)
    assert frame.names == list(jdf.columns)
    got = frame.matrix(feats)
    want = jdf[feats].to_numpy(dtype=np.float64)
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    # correctly rounded: each value is float() of its text
    with open(study, newline="") as f:
        rows = list(csv.reader(f))
    cols = [rows[0].index(n) for n in feats]
    text = np.array([[r[j] for j in cols] for r in rows[1:]])
    exact = np.array([[float(c) if c else np.nan for c in r] for r in text])
    np.testing.assert_array_equal(got, exact)
    # the default reader's (pandas') values: where they differ, and how far
    default = read_csv(study).matrix(feats)
    same_nan = np.isnan(default) == np.isnan(got)
    assert same_nan.all()
    finite = ~np.isnan(got)
    dist = ulps(default[finite], got[finite])
    print(f"\n  {int((dist > 0).sum())} of {int(finite.sum())} values differ"
          f" from the default reader, by at most {int(dist.max())} ulp")
    assert (dist > 0).any()
    for name in frame.names:
        if name not in feats:
            assert list(frame.columns[name]) == list(
                read_csv(study).columns[name]), name


def test_native_loader_against_default_and_persisted_folds(study, tmp_path):
    before = read_csv(study)
    native = DataLoader(study, engine="native", cross_validation=True,
                        normalize_and_fill=True, fill_gaps_with=-1.0,
                        suppress_output=True)
    # only the fold column was added; every other column reads as before
    after = read_csv(study)
    assert after.names == before.names + [pp.FOLD_COLUMN]
    assert list(after.index) == list(before.index)
    for name, col in before.columns.items():
        if col.dtype.kind == "f":
            np.testing.assert_array_equal(after.columns[name], col)
        else:
            assert list(after.columns[name]) == list(col), name
    default = DataLoader(study, cross_validation=True,
                         normalize_and_fill=True, fill_gaps_with=-1.0,
                         suppress_output=True)
    for f in range(native.num_folds):
        native.set_to_cross_validation_fold(f)
        default.set_to_cross_validation_fold(f)
        for name in ("train_X", "val_X", "test_X"):
            np.testing.assert_allclose(getattr(native, name),
                                       getattr(default, name), rtol=0,
                                       atol=1e-12)
        np.testing.assert_array_equal(native.train_Y, default.train_Y)
    with pytest.raises(ValueError, match="engine"):
        DataLoader(study, engine="polars")


def test_failed_build_names_the_native_engine(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    lib = fast_csv.CsvLibrary(source=str(src),
                              library=str(tmp_path / "lib.so"))
    with pytest.raises(RuntimeError, match="engine='native'"):
        lib.load()


def test_cli_engine_native(study, capsys):
    outs = []
    for engine in ("pandas", "native"):
        assert cli.main(["feature-select", study, "skb", "5", "--label",
                         "happiness_label", "--backend", "jax",
                         "--fill-missing", "0", "--engine", engine]) == 0
        out = capsys.readouterr().out.strip().split()[-1]
        outs.append(read_csv(out))
    a, b = outs
    assert a.names == b.names
    dims = [n for n in a.names if n.startswith("skb_dim")]
    np.testing.assert_allclose(a.matrix(dims), b.matrix(dims), rtol=1e-15)


def test_facade_and_cli_train_read_with_the_engine(study, tmp_path,
                                                   monkeypatch, capsys):
    """``MultimodalAutoencoder(engine=...)`` builds both of its loaders
    with that engine, and ``cli train --engine native`` reaches it."""
    from multimodalautoencoder_tpu_torch.api import MultimodalAutoencoder

    reads = []

    def counted(path, *a, **kw):
        reads.append(path)
        return read_native(path, *a, **kw)

    read_native = fast_csv.read_csv
    monkeypatch.setattr(fast_csv, "read_csv", counted)
    kw = dict(filename=study, layer_sizes=(16, 8), variational=False,
              classification_filename=study, classification_layer_sizes=[4],
              normalize_and_fill=True, verbose=False, device="cpu")
    MultimodalAutoencoder(**kw)
    assert reads == []
    model = MultimodalAutoencoder(engine="native", **kw)
    assert reads == [study, study]
    want = DataLoader(study, supervised=False, engine="native",
                      subdivide_physiology_features=True,
                      normalize_and_fill=True, seed=0)
    np.testing.assert_array_equal(model.data_loader.train_X, want.train_X)
    reads.clear()
    assert cli.main(["train", study, "--arch", "16", "8", "--num-steps",
                     "10", "--normalize-and-fill", "--device", "cpu",
                     "--engine", "native", "--checkpoint-dir",
                     str(tmp_path / "ck")]) == 0
    assert reads == [study]
    assert "checkpoint:" in capsys.readouterr().out


def test_count_gaps_matches_jax(study):
    import pandas as pd

    jdf = pd.read_csv(study, index_col=0)
    want = jpp.count_gaps_in_modalities(jdf)
    frame = read_csv(study)
    assert pp.count_gaps_in_modalities(frame) == want
    feats = pp.get_wanted_feats_from_df(frame.names)
    assert pp.count_gaps_in_modalities(frame.matrix(feats), feats) == want
    assert pp.count_gaps_in_modalities(
        frame, feats, gap_threshold=0.3, subdivide_phys=False) == \
        jpp.count_gaps_in_modalities(jdf, feats, gap_threshold=0.3,
                                     subdivide_phys=False)
    assert sum(want.values()) == len(frame) and len(want) > 1
    with pytest.raises(ValueError, match="wanted_feats"):
        pp.count_gaps_in_modalities(frame.matrix(feats))


def test_reference_scale_loaders_match_jax(tmp_path):
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "p")
    ju, js = jsynthetic.reference_scale_loaders(str(tmp_path / "j"),
                                                num_rows=240, seed=1)
    pu, ps = synthetic.reference_scale_loaders(str(tmp_path / "p"),
                                               num_rows=240, seed=1)
    assert ps.num_feats == js.num_feats == pu.num_feats
    assert ps.wanted_labels == js.wanted_labels
    for (j, p) in ((ju, pu), (js, ps)):
        for f in range(j.num_folds):
            j.set_to_cross_validation_fold(f)
            p.set_to_cross_validation_fold(f)
            for name in ("train_X", "val_X", "test_X"):
                np.testing.assert_array_equal(getattr(p, name),
                                              np.asarray(getattr(j, name)))
        if p.supervised:
            np.testing.assert_array_equal(p.train_Y, np.asarray(j.train_Y))
