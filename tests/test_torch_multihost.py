"""The port's multi-process sweep utilities (``parallel/multihost.py``)
against the JAX package's: a counterpart of each test of
tests/test_multihost.py, the settings slices and shard names on the
108-setting ACII grid, merged ledgers and the global winner picked by
both packages from files the port wrote, and a real two-process gloo
sweep through ``tools/multihost_sweep.py`` (on the card too, ``cuda``)."""

import os
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

from multimodalautoencoder_tpu.parallel import multihost as jax_multihost
from multimodalautoencoder_tpu_torch.config import MMAEConfig
from multimodalautoencoder_tpu_torch.models import mmae
from multimodalautoencoder_tpu_torch.parallel import multihost
from multimodalautoencoder_tpu_torch.sweep import engine
from multimodalautoencoder_tpu_torch.sweep import grid as grid_lib
from multimodalautoencoder_tpu_torch.train import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = MMAEConfig(num_feats=4, layer_sizes=(3, 2))


def save(tmp_path, name, step, **extra):
    params = mmae.init(CFG, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    return ck.save_checkpoint(str(tmp_path), name, params, CFG, step=step,
                              extra=extra)


def test_initialize_single_process(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert multihost.initialize() == (0, 1)
    multihost.barrier("single")        # a no-op in one process


def test_partition_round_robin():
    settings = [{"i": i} for i in range(10)]
    s0 = multihost.partition_settings(settings, 0, 3)
    s1 = multihost.partition_settings(settings, 1, 3)
    s2 = multihost.partition_settings(settings, 2, 3)
    assert [s["i"] for s in s0] == [0, 3, 6, 9]
    assert [s["i"] for s in s1] == [1, 4, 7]
    assert [s["i"] for s in s2] == [2, 5, 8]
    assert sorted(s["i"] for s in s0 + s1 + s2) == list(range(10))
    assert multihost.partition_settings(settings, 0, 1) == settings


def test_partition_rejects_out_of_range_index():
    settings = [{"i": i} for i in range(4)]
    with pytest.raises(ValueError, match="0-based"):
        multihost.partition_settings(settings, 2, 2)
    with pytest.raises(ValueError, match="0-based"):
        multihost.partition_settings(settings, -1, 2)
    with pytest.raises(ValueError, match="process_count"):
        multihost.partition_settings(settings, 0, 0)


def test_select_global_best_checkpoint(tmp_path):
    """The best meta['extra'] score within the newest shard generation; a
    stale wider generation does not leak in; min_or_max flips the
    comparison; NaN scores never win."""
    stale = save(tmp_path, "best.shard0of3", 10, score=0.99,
                 min_or_max="max")
    os.utime(stale, (1, 1))
    for i, score in ((0, 0.6), (1, 0.7)):
        save(tmp_path, f"best.shard{i}of2", 10, score=score,
             min_or_max="max")
    win = multihost.select_global_best_checkpoint(str(tmp_path), "best")
    assert win.endswith("best.shard1of2-10.npz")
    for i, score in ((0, 0.6), (1, 0.7)):
        save(tmp_path, f"loss.shard{i}of2", 10, score=score,
             min_or_max="min")
    win = multihost.select_global_best_checkpoint(str(tmp_path), "loss")
    assert win.endswith("loss.shard0of2-10.npz")
    for i, score in ((0, float("nan")), (1, 0.2)):
        save(tmp_path, f"nan.shard{i}of2", 10, score=score,
             min_or_max="max")
    win = multihost.select_global_best_checkpoint(str(tmp_path), "nan")
    assert win.endswith("nan.shard1of2-10.npz")
    with pytest.raises(FileNotFoundError):
        multihost.select_global_best_checkpoint(str(tmp_path), "absent")


def test_select_global_best_checkpoint_stale_step(tmp_path):
    """Only the newest export per shard counts (mtime first, then step):
    a rerun with more or with fewer steps leaves the old file beside the
    new one, and a shard with only its old export still counts."""
    stale = save(tmp_path, "best.shard0of2", 10, score=0.99,
                 min_or_max="max")
    os.utime(stale, (1000, 1000))
    save(tmp_path, "best.shard0of2", 20, score=0.5, min_or_max="max")
    save(tmp_path, "best.shard1of2", 20, score=0.7, min_or_max="max")
    win = multihost.select_global_best_checkpoint(str(tmp_path), "best")
    assert win.endswith("best.shard1of2-20.npz")
    stale = save(tmp_path, "down.shard0of2", 15000, score=0.99,
                 min_or_max="max")
    os.utime(stale, (1000, 1000))
    save(tmp_path, "down.shard0of2", 10000, score=0.5, min_or_max="max")
    save(tmp_path, "down.shard1of2", 10000, score=0.7, min_or_max="max")
    win = multihost.select_global_best_checkpoint(str(tmp_path), "down")
    assert win.endswith("down.shard1of2-10000.npz")
    old = save(tmp_path, "mix.shard0of2", 10, score=0.9, min_or_max="max")
    os.utime(old, (1000, 1000))
    save(tmp_path, "mix.shard1of2", 20, score=0.7, min_or_max="max")
    win = multihost.select_global_best_checkpoint(str(tmp_path), "mix")
    assert win.endswith("mix.shard0of2-10.npz")


def test_select_global_best_checkpoint_incomplete_generation(tmp_path):
    save(tmp_path, "best.shard0of2", 10, score=0.6, min_or_max="max")
    with pytest.raises(FileNotFoundError, match=r"missing indices \[1\]"):
        multihost.select_global_best_checkpoint(str(tmp_path), "best")


def test_shard_ledger_path():
    assert multihost.shard_ledger_path("r", "MMAE-d", 0, 1) == "MMAE-d"
    assert multihost.shard_ledger_path("r", "MMAE-d", 2, 4) == \
        "MMAE-d.shard2of4"


def write_shard(tmp_path, name, rows):
    led = engine.ResultsLedger(str(tmp_path), name)
    for r in rows:
        led.append(r)
    led.flush()
    return led.path


def test_merge_ledger_shards(tmp_path):
    for i in range(3):
        write_shard(tmp_path, f"MMAE-d.shard{i}of3",
                    [{"C": i, "val_acc": 0.5 + i / 10}])
    out = multihost.merge_ledger_shards(str(tmp_path), "MMAE-d")
    assert os.path.basename(out) == "MMAE-d.csv"
    df = pd.read_csv(out, index_col=0)
    assert len(df) == 3
    assert sorted(df["C"]) == [0, 1, 2]


def test_merge_missing_shards(tmp_path):
    with pytest.raises(FileNotFoundError):
        multihost.merge_ledger_shards(str(tmp_path), "nope")


def test_merge_ignores_stale_shard_generations(tmp_path):
    """An aborted of4 run's leftovers do not leak into a fresh of2 merge;
    an explicit incomplete generation raises."""
    for name, c in (("MMAE-d.shard0of4", 99), ("MMAE-d.shard0of2", 0),
                    ("MMAE-d.shard1of2", 1)):
        write_shard(tmp_path, name, [{"C": c}])
    now = time.time()
    os.utime(tmp_path / "MMAE-d.shard0of4.csv", (now - 100, now - 100))
    out = multihost.merge_ledger_shards(str(tmp_path), "MMAE-d")
    assert list(pd.read_csv(out, index_col=0)["C"]) == [0, 1]
    with pytest.raises(FileNotFoundError, match="missing"):
        multihost.merge_ledger_shards(str(tmp_path), "MMAE-d", num_shards=4)


def test_initialize_requires_explicit_topology(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize()
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize(coordinator_address="127.0.0.1:1")
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize(rendezvous_file="/nonexistent/rendezvous")


def test_port_zero_needs_a_rendezvous_file(monkeypatch):
    """With port 0 the other processes learn process 0's port only from
    the rendezvous file."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="rendezvous_file"):
        multihost.initialize(coordinator_address="127.0.0.1:0",
                             num_processes=2, process_id=1)


@pytest.mark.parametrize("meet", ["file", "tcp"])
def test_initialize_and_shutdown_one_process(tmp_path, monkeypatch, meet):
    """A one-process job through each meeting place: a file, or a TCP
    store that binds its own free port (port 0); ``shutdown`` leaves it
    and clears the store."""
    import torch.distributed as dist

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    kw = (dict(rendezvous_file=str(tmp_path / "rendezvous"))
          if meet == "file" else dict(coordinator_address="127.0.0.1:0"))
    try:
        assert multihost.initialize(num_processes=1, process_id=0,
                                    **kw) == (0, 1)
        assert dist.is_initialized() and multihost._STORE is not None
        multihost.barrier("one")
        multihost.shutdown()
        assert not dist.is_initialized() and multihost._STORE is None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        multihost._STORE = None


# -------------------------------------------------- against the JAX package

def acii_grid():
    """The MMAE sweep's default 108-setting grid (autoencoder_wrapper.py
    :127-136 with the VAE settings appended)."""
    params = {"architecture": [[1000, 100], [500, 100], [300, 100]],
              "tie_weights": [True, False], "dropout_prob": [1.0, 0.5],
              "weight_penalty": [0.0, 0.01, 0.001],
              "weight_initialization": ["normal"],
              "activation_function": ["softsign", "relu"],
              "variational": [False]}
    return grid_lib.add_extra_vae_params(grid_lib.enumerate_grid(params))


def test_partition_and_shard_names_match_jax_on_the_acii_grid():
    settings = acii_grid()
    assert len(settings) == 108
    for n in range(1, 5):
        slices = []
        for i in range(n):
            mine = multihost.partition_settings(settings, i, n)
            assert mine == jax_multihost.partition_settings(settings, i, n)
            assert multihost.shard_ledger_path("r", "MMAE-acii", i, n) == \
                jax_multihost.shard_ledger_path("r", "MMAE-acii", i, n)
            slices += mine
        assert sorted(map(str, slices)) == sorted(map(str, settings))


def test_merge_matches_jax_merge_of_port_shards(tmp_path):
    """Shards written by the port's ledger, with lists, bools, ints, NaN
    and a column only one shard has: both packages' merges give the same
    rows, columns and order."""
    rng = np.random.default_rng(0)
    settings = acii_grid()[:7]
    for i in range(2):
        rows = []
        for s in multihost.partition_settings(settings, i, 2):
            row = dict(s, val_sigmoid_cross_entropy=float(rng.random()),
                       backend_used="pallas")
            if i == 1:
                row["svm_val_acc"] = float("nan") if not rows else 0.5
            rows.append(row)
        write_shard(tmp_path, f"MMAE-acii.shard{i}of2", rows)
    mine = multihost.merge_ledger_shards(str(tmp_path), "MMAE-acii",
                                         out_name="port")
    theirs = jax_multihost.merge_ledger_shards(str(tmp_path), "MMAE-acii",
                                               out_name="jax")
    a, b = pd.read_csv(mine, index_col=0), pd.read_csv(theirs, index_col=0)
    assert list(a.columns) == list(b.columns)
    assert len(a) == 7
    pd.testing.assert_frame_equal(a, b)


def test_global_winner_matches_jax_on_port_exports(tmp_path):
    for i, score in enumerate((0.31, 0.12, float("nan"), 0.44)):
        save(tmp_path, f"best_mmae.shard{i}of4", 100, score=score,
             min_or_max="min", optimize_for="val_sigmoid_cross_entropy")
    mine = multihost.select_global_best_checkpoint(str(tmp_path),
                                                   "best_mmae")
    assert mine.endswith("best_mmae.shard1of4-100.npz")
    assert mine == jax_multihost.select_global_best_checkpoint(
        str(tmp_path), "best_mmae")


def test_study_rewritten_under_a_reader_is_read_whole(tmp_path):
    """The shards of a distributed sweep load one study at once, and each
    persists its CV folds into it (``DataLoader``): a reader must see the
    old file or the new one, never a part (before ``Frame.to_csv`` wrote
    through a replaced file, 2 of 50 runs of the two-process sweep below
    failed beside 5 busy pytest workers: a rank read a half-written study
    and the job lost it)."""
    import threading

    from multimodalautoencoder_tpu_torch.data import synthetic
    from multimodalautoencoder_tpu_torch.data.loader import read_csv

    path = synthetic.write_csv(str(tmp_path / "data.csv"), num_rows=1000,
                               seed=11)
    frame = read_csv(path)
    done = threading.Event()

    def writer():
        try:
            for _ in range(40):
                frame.to_csv(path)
        finally:
            done.set()

    t = threading.Thread(target=writer)
    t.start()
    reads = 0
    try:
        while not done.is_set() or reads == 0:
            got = read_csv(path)
            assert len(got) == 1000 and got.names == frame.names
            reads += 1
    finally:
        t.join(timeout=120)
    assert not t.is_alive()
    assert sorted(os.listdir(tmp_path)) == ["data.csv"]


# ------------------------------------------------ two processes on gloo

def run_distributed(tmp_path, device, coordinator=None):
    """``tools/multihost_sweep.py --hosts 2 --distributed``: two concurrent
    workers join one gloo job, through a file in the run's directory or at
    rank 0's TCP store on ``coordinator`` (no port is picked and released
    for another process to take), each trains its half of a 2-setting grid
    for 30 steps, they meet at the barrier, rank 0 merges the shards, and
    rank 0 leaves the job last."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m",
         "multimodalautoencoder_tpu_torch.tools.multihost_sweep",
         "--hosts", "2", "--distributed", "--steps", "30", "--device",
         device, "--out", str(tmp_path / "out"), "--timeout", "240"]
        + (["--coordinator", coordinator] if coordinator else []),
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=300)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "merged 2 shards" in r.stdout
    merged = pd.read_csv(tmp_path / "out" / "MMAE-data.csv", index_col=0)
    assert len(merged) == 2 and merged["tie_weights"].tolist() == [True,
                                                                   False]
    assert np.isfinite(merged["val_sigmoid_cross_entropy"]).all()
    return merged


def test_real_distributed_two_process_sweep(tmp_path):
    merged = run_distributed(tmp_path, "cpu")
    assert set(merged["backend_used"]) == {"xla"}


def test_real_distributed_two_process_sweep_over_tcp(tmp_path):
    """The same job at rank 0's TCP store, the way across machines: rank 0
    binds port 0 and writes the port it got to the run's rendezvous file,
    rank 1 reads it there, and rank 0, the store's host, leaves last.  The
    merged ledger is the file route's."""
    (tmp_path / "tcp").mkdir()
    (tmp_path / "file").mkdir()
    merged = run_distributed(tmp_path / "tcp", "cpu", "127.0.0.1:0")
    assert set(merged["backend_used"]) == {"xla"}
    by_file = run_distributed(tmp_path / "file", "cpu")
    timed = ["time_per_setting_s", "inst_steps_per_s"]   # wall clock
    pd.testing.assert_frame_equal(merged.drop(columns=timed),
                                  by_file.drop(columns=timed))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the training kernels have no CPU "
                    "mode")
    return "cuda"


@pytest.mark.cuda
def test_cuda_distributed_two_process_sweep(tmp_path, cuda_device):
    """Both ranks train on cuda:0 through the training kernels."""
    merged = run_distributed(tmp_path, cuda_device)
    assert set(merged["backend_used"]) == {"pallas"}
