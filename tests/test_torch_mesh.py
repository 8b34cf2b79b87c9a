"""A bucket split over a device list (``parallel/mesh.py`` and the split
runs of ``parallel/grid_trainer.py``), and both sweeps split over devices
and sharded over processes, against one device and the JAX package.

Every instance carries its own Philox seed, so a chunk trains each of its
instances as the whole bucket does.  On the CPU the chunks run the
kernels' twin, whose exp / tanh / sigmoid PyTorch evaluates on a vector's
lanes and on the scalar tail of a tensor with different code; an instance
whose elements move between the two when its bucket is cut can differ in
the last bit.  The bit-for-bit tests therefore use widths at which every
instance's rows fill whole 32-float vectors (as the 1000-wide buckets do),
and :func:`test_split_bucket_at_ragged_widths` holds a split at ragged
widths to 2e-6 of the unsplit run.  On the card each chunk launches the
same kernels on its own instances: the ``cuda`` test holds a split there
bit for bit at ragged widths too."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from multimodalautoencoder_tpu.data.loader import DataLoader as JaxLoader
from multimodalautoencoder_tpu.parallel import mesh as jax_mesh
from multimodalautoencoder_tpu.sweep import wrappers as jax_wrappers
from multimodalautoencoder_tpu_torch.config import MMAEConfig, TrainConfig
from multimodalautoencoder_tpu_torch.data import synthetic
from multimodalautoencoder_tpu_torch.data.loader import DataLoader
from multimodalautoencoder_tpu_torch.data.modalities import ModalityTable
from multimodalautoencoder_tpu_torch.models.corruption import NoiseSpec
from multimodalautoencoder_tpu_torch.ops import optim
from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk
from multimodalautoencoder_tpu_torch.parallel import grid_trainer as gt
from multimodalautoencoder_tpu_torch.parallel import mesh, multihost
from multimodalautoencoder_tpu_torch.sweep import wrappers
from multimodalautoencoder_tpu_torch.train import checkpoint as ck

NAMES = ("call", "location", "screen", "sms", "survey")
SETTINGS = [{"dropout_prob": kp, "weight_penalty": wp,
             "activation_function": act}
            for kp in (1.0, 0.5) for wp in (0.0, 0.01)
            for act in ("softsign", "relu")][:5]


# ------------------------------------------------------------ the mesh

def test_pad_to_multiple_matches_jax():
    for n in range(0, 20):
        for m in range(0, 6):
            assert mesh.pad_to_multiple(n, m) == jax_mesh.pad_to_multiple(
                n, m)


@pytest.mark.parametrize("shape", [(3, 2), (8, 2), (4, 1)])
def test_make_mesh_errors_match_jax(shape):
    import jax

    with pytest.raises(ValueError) as theirs:
        jax_mesh.make_mesh(shape=shape, devices=jax.devices())
    with pytest.raises(ValueError) as mine:
        mesh.make_mesh(shape=shape, devices=["cpu"] * 8)
    assert str(mine.value) == str(theirs.value)


def test_make_mesh_and_local_devices():
    assert mesh.make_mesh(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert mesh.make_mesh((2, 1), ["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="data axis"):
        mesh.make_mesh((1, 2), ["cpu", "cpu"])
    with pytest.raises(ValueError, match="mix"):
        mesh.as_devices(["cpu", "cuda:0"])
    assert mesh.local_devices("cpu") == [torch.device("cpu")]
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.local_devices()
    else:
        assert all(d.type == "cuda" for d in mesh.local_devices())


def test_split_and_gather_leading_axis():
    tree = (torch.arange(14.0).view(7, 2), [torch.arange(7), None])
    parts = mesh.split_leading_axis(tree, ["cpu"] * 3)
    assert [p[0].shape[0] for p in parts] == [3, 2, 2]
    assert mesh.chunk_bounds(2, 3) == [(0, 1), (1, 2), (2, 2)]
    back = mesh.gather_leading_axis(parts, "cpu")
    assert torch.equal(back[0], tree[0]) and torch.equal(back[1][0],
                                                         tree[1][0])
    assert back[1][1] is None


# ------------------------------------------------- split buckets on the CPU

def folds(F, labels=2, rows=40, val=9, seed=0):
    rng = np.random.default_rng(seed)
    tr = [rng.random((rows, F)).astype(np.float32) for _ in range(2)]
    va = [rng.random((val, F)).astype(np.float32) for _ in range(2)]
    ty = [rng.integers(0, 2, (rows, labels)).astype(np.float32)
          for _ in range(2)]
    vy = [rng.integers(0, 2, (val, labels)).astype(np.float32)
          for _ in range(2)]
    return (gt.FoldedData.from_ragged(tr, va, "cpu"),
            gt.FoldedData.from_ragged(tr, va, "cpu", train_y_list=ty,
                                      val_y_list=vy))


def bucket(layers, tied, vae, head=(4,)):
    cfg = MMAEConfig(num_feats=30, layer_sizes=layers, tie_weights=tied,
                     variational=vae, num_labels=2,
                     classification_layer_sizes=head).validate()
    spec = NoiseSpec.build(cfg, ModalityTable.uniform(5, 6, NAMES))
    return cfg, spec


def assert_trees_equal(a, b):
    la, lb = optim.tree_leaves(a), optim.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y), float((x - y).abs().max())


TCFG = TrainConfig(learning_rate=1e-3, batch_size=16, num_steps=12,
                   clip_gradients=False)


@pytest.mark.parametrize("layers, tied, vae", [((16, 8), True, False),
                                               ((16, 8), False, True),
                                               ((16, 10, 8), False, False)])
def test_split_phase1_bit_for_bit(layers, tied, vae):
    """Phase 1 of a 5-config x 2-fold bucket on three CPU chunks (4, 3, 3
    instances): every instance's parameters and noisy-val objective as on
    one device, bit for bit."""
    cfg, spec = bucket(layers, tied, vae, head=None)
    unsup, _ = folds(30)
    hyper = gt.HyperStack.from_settings(SETTINGS, cfg, TCFG)
    one = gt.train_grid_sharded("cpu", 3, cfg, TCFG, spec, hyper, unsup,
                                backend="pallas")
    split = gt.train_grid_sharded(["cpu"] * 3, 3, cfg, TCFG, spec, hyper,
                                  unsup, backend="pallas")
    assert_trees_equal(one, split)


@pytest.mark.parametrize("vae", [False, True])
def test_split_phase2_shared_and_two_phase_bit_for_bit(vae):
    """Shared phase 2 (five settings on three pretrained rows) and
    ``train_two_phase_sharded`` on two CPU chunks, against one device."""
    cfg, spec = bucket((16, 8), not vae, vae)
    unsup, sup = folds(30)
    hyper = gt.HyperStack.from_settings(SETTINGS, cfg, TCFG)
    chyper = gt.ClassifierHyperStack.from_settings(SETTINGS, cfg)
    hyper_u = gt.HyperStack.from_settings(SETTINGS[:3], cfg, TCFG)
    params_u, _ = gt.train_phase1_shared("cpu", 4, cfg, TCFG, spec, hyper_u,
                                         unsup, backend="pallas")
    p1_map = np.array([0, 1, 2, 1, 0])
    runs = [gt.train_phase2_shared_sharded(
        dev, 5, cfg, TCFG, TCFG, spec, params_u, p1_map, hyper, chyper, sup,
        backend="pallas") for dev in ("cpu", ["cpu", "cpu"])]
    assert_trees_equal(*runs)
    runs = [gt.train_two_phase_sharded(
        dev, 6, cfg, TCFG, TCFG, spec, hyper, chyper, unsup, sup,
        backend="pallas") for dev in ("cpu", ["cpu", "cpu"])]
    assert_trees_equal(*runs)


def test_split_bucket_at_ragged_widths():
    """At a batch of 10 the rows of an instance end mid-vector: the split
    two-phase run agrees with the unsplit one to 2e-6 (f32 rounding of a
    few exp / sigmoid evaluations, carried through 12 Adam steps)."""
    cfg, spec = bucket((16, 6), True, False, head=(5,))
    unsup, sup = folds(30)
    tcfg = TCFG.replace(batch_size=10)
    hyper = gt.HyperStack.from_settings(SETTINGS, cfg, tcfg)
    chyper = gt.ClassifierHyperStack.from_settings(SETTINGS, cfg)
    a, b = [gt.train_two_phase_sharded(
        dev, 6, cfg, tcfg, tcfg, spec, hyper, chyper, unsup, sup,
        backend="pallas") for dev in ("cpu", ["cpu", "cpu"])]
    for x, y in zip(optim.tree_leaves(a[0]), optim.tree_leaves(b[0])):
        torch.testing.assert_close(x, y, rtol=2e-6, atol=2e-6)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def test_split_counts_every_chunk(monkeypatch):
    """``run_steps`` hands each non-empty chunk to the runner for its
    device once, from its own thread, and gathers in instance order."""
    cfg, spec = bucket((16, 8), True, False, head=None)
    unsup, _ = folds(30)
    hyper = gt.HyperStack.from_settings(SETTINGS[:1], cfg, TCFG)  # N = 2
    seen = []
    real = ptk.train_grid_kernel_reference

    def spy(run, first, steps):
        seen.append(run.n_inst)
        real(run, first, steps)

    monkeypatch.setattr(ptk, "train_grid_kernel_reference", spy)
    one = ptk.train_grid_pallas(3, cfg, TCFG, spec, hyper, unsup)
    split = ptk.train_grid_pallas(3, cfg, TCFG, spec, hyper, unsup,
                                  devices=[torch.device("cpu")] * 3)
    assert seen == [2, 1, 1]            # the third chunk is empty
    assert_trees_equal(one, split)


# ------------------------------------------------------ the sweeps

MODALITIES = (("call", 8), ("location", 8), ("screen", 8), ("sms", 4),
              ("survey", 4))
LABELS = ("happy_label", "calm_label")
MMAE_GRID = dict(layer_sizes=[[16, 8]], tie_weights=[True, False],
                 dropout_probs=[1.0], weight_penalties=[0.0, 0.01],
                 activation_funcs=["softsign"], test_variational=True)
CLS_GRID = dict(mmae_layer_sizes=[[16, 8]], classification_layer_sizes=[[8]],
                tie_weights=[True, False], mmae_dropout_probs=[1.0],
                mmae_weight_penalties=[0.0, 0.01],
                mmae_activation_funcs=["relu"],
                mmae_test_variational=[False], weight_penalties=[0.0],
                dropout_probs=[1.0, 0.5], activation_funcs=["relu"])
TIMING = ("time_per_setting_s", "inst_steps_per_s")


def study(tmp_path):
    """32 features (rows of 20 and 16 fill whole vectors) and 2 labels."""
    path = str(tmp_path / "m.csv")
    synthetic.make_frame(num_rows=90, seed=4, modalities=MODALITIES,
                         label_names=LABELS).to_csv(path)
    return path


def loaders(path, jax_side=False):
    kw = dict(cross_validation=True, normalize_and_fill=True,
              fill_gaps_with=-1.0, suppress_output=True)
    cls = JaxLoader if jax_side else DataLoader
    return cls(path, supervised=False, **kw), cls(path, supervised=True,
                                                  **kw)


def mmae_sweep(tmp_path, name, path, **kw):
    unsup, _ = loaders(path)
    return wrappers.MMAESweep(
        unsup, results_path=str(tmp_path / name), num_steps=8,
        num_cross_folds=2, verbose=False, backend="pallas", probe=None,
        **MMAE_GRID, **kw)


def cls_sweep(tmp_path, name, path, **kw):
    unsup, sup = loaders(path)
    return wrappers.MMAEClassificationSweep(
        unsup, sup, results_path=str(tmp_path / name), mmae_num_steps=6,
        classification_num_steps=6, classification_batch_size=16,
        num_cross_folds=2, verbose=False, backend="pallas", **CLS_GRID,
        **kw)


def ledger_frame(path):
    return pd.read_csv(path, index_col=0).drop(columns=list(TIMING))


@pytest.mark.parametrize("make", [mmae_sweep, cls_sweep])
def test_sweep_on_a_device_list_writes_the_one_device_ledger(tmp_path, make):
    path = study(tmp_path)
    one = make(tmp_path, "one", path, device="cpu")
    one.sweep_all_parameters()
    two = make(tmp_path, "two", path, device=["cpu", "cpu"])
    assert two.devices == [torch.device("cpu")] * 2
    two.sweep_all_parameters()
    a, b = ledger_frame(one.ledger.path), ledger_frame(two.ledger.path)
    assert len(a) == one.num_settings
    assert set(a["backend_used"]) == {"pallas"}
    pd.testing.assert_frame_equal(a, b)


def test_mmae_sweep_shards_merge_and_match_jax(tmp_path):
    """``process_shard=(i, 2)``: two shard ledgers, each with JAX's slice of
    the grid; their merge holds the unsharded grid's settings once each
    (a shard's buckets are its own, so its rows draw other random numbers
    than the unsharded sweep's); both shards export a shard-tagged winner
    and the global one is the merged ledger's best row."""
    path = study(tmp_path)
    ju, _ = loaders(path, jax_side=True)
    whole = mmae_sweep(tmp_path, "whole", path, device="cpu")
    whole.sweep_all_parameters()
    for i in range(2):
        sweep = mmae_sweep(tmp_path, "shards", path, device="cpu",
                           process_shard=(i, 2), save_best_params=True)
        jax_sweep = jax_wrappers.MMAESweep(
            ju, results_path=str(tmp_path / "jax"), verbose=False,
            process_shard=(i, 2), **MMAE_GRID)
        assert sweep.list_of_param_settings == \
            jax_sweep.list_of_param_settings
        assert os.path.basename(sweep.ledger.path) == os.path.basename(
            jax_sweep.ledger.path) == f"MMAE-m.shard{i}of2.csv"
        sweep.sweep_all_parameters()
        meta = ck.checkpoint_meta(sweep.export_best_params())
        assert meta["extra"]["min_or_max"] == "min"
        assert meta["extra"]["optimize_for"] == "val_sigmoid_cross_entropy"
    shards = str(tmp_path / "shards")
    merged = ledger_frame(multihost.merge_ledger_shards(shards, "MMAE-m"))
    want = ledger_frame(whole.ledger.path)
    key = ["architecture", "tie_weights", "variational", "weight_penalty"]
    assert len(merged) == len(want) == whole.num_settings
    assert not merged.duplicated(key).any()
    assert list(merged.columns) == list(want.columns)
    pd.testing.assert_frame_equal(
        merged[key].sort_values(key).reset_index(drop=True),
        want[key].sort_values(key).reset_index(drop=True))
    assert np.isfinite(merged["val_sigmoid_cross_entropy"]).all()
    win = multihost.select_global_best_checkpoint(shards, "best_mmae")
    best = merged["val_sigmoid_cross_entropy"].min()
    assert ck.checkpoint_meta(win)["extra"]["score"] == pytest.approx(best)


def test_cls_sweep_shards_merge_and_match_jax(tmp_path):
    """The two-phase sweep sharded the same way; phase 1 is shared within
    each slice, so a shard's rows may differ from the unsharded sweep's
    (other pretraining families) but the merge holds every setting once,
    and both shards export a shard-tagged winner."""
    path = study(tmp_path)
    ju, js = loaders(path, jax_side=True)
    settings = []
    for i in range(2):
        sweep = cls_sweep(tmp_path, "shards", path, device="cpu",
                          process_shard=(i, 2), save_best_params=True)
        jax_sweep = jax_wrappers.MMAEClassificationSweep(
            ju, js, results_path=str(tmp_path / "jax"), verbose=False,
            process_shard=(i, 2), **CLS_GRID)
        assert sweep.list_of_param_settings == \
            jax_sweep.list_of_param_settings
        assert os.path.basename(sweep.ledger.path) == \
            os.path.basename(jax_sweep.ledger.path)
        sweep.sweep_all_parameters()
        settings += sweep.list_of_param_settings
        assert os.path.exists(os.path.join(
            str(tmp_path / "shards"), f"best_mmae_cls.shard{i}of2-6.npz"))
    shards = str(tmp_path / "shards")
    prefix = "MMAE_NN_classifier-m"
    merged = pd.read_csv(multihost.merge_ledger_shards(shards, prefix),
                         index_col=0)
    whole = cls_sweep(tmp_path, "whole", path, device="cpu")
    assert len(merged) == whole.num_settings == 8
    assert sorted(map(str, settings)) == sorted(
        map(str, whole.list_of_param_settings))
    assert np.isfinite(merged["val_acc"]).all()
    win = multihost.select_global_best_checkpoint(shards, "best_mmae_cls")
    assert ck.checkpoint_meta(win)["extra"]["score"] == pytest.approx(
        merged["val_acc"].max())


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the training kernels have no CPU "
                    "mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("layers, tied, vae", [((16, 6), True, False),
                                               ((16, 6), False, True),
                                               ((16, 10, 6), True, False)])
def test_cuda_split_bit_for_bit(cuda_device, layers, tied, vae):
    """On ``["cuda:0", "cuda:0"]`` each chunk launches the training
    kernels (phase 1 and phase 2) on its own instances: every instance
    ends bit for bit as in one launch, at ragged widths too."""
    from multimodalautoencoder_tpu_torch.ops import cls_train_kernels as pck

    cfg, spec = bucket(layers, tied, vae, head=(5,) if len(layers) == 2
                       else None)
    unsup, sup = (f.to(cuda_device) for f in folds(30))
    tcfg = TCFG.replace(batch_size=10)
    hyper = gt.HyperStack.from_settings(SETTINGS, cfg, tcfg)
    devs = [cuda_device, cuda_device]
    if len(layers) > 2:
        runs = [gt.train_grid_sharded(d, 3, cfg, tcfg, spec, hyper, unsup,
                                      backend="pallas")
                for d in (cuda_device, devs)]
    else:
        chyper = gt.ClassifierHyperStack.from_settings(SETTINGS, cfg)
        pck.KERNELS.launches = 0
        runs = [gt.train_two_phase_sharded(
            d, 6, cfg, tcfg, tcfg, spec, hyper, chyper, unsup, sup,
            backend="pallas") for d in (cuda_device, devs)]
        assert pck.KERNELS.launches == 3 * tcfg.num_steps * \
            pck.launches_per_step(2, vae)
    assert_trees_equal(*runs)
