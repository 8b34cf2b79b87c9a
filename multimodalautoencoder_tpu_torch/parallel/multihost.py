"""Multi-process sweep scale-out.

Counterpart of ``multimodalautoencoder_tpu/parallel/multihost.py``.  The
sweep's parallel unit (a config x fold training instance) is
embarrassingly parallel, so the multi-process story is simple: each
process takes a deterministic round-robin slice of the settings list,
trains it on its own devices (``parallel/mesh.py``) and writes a ledger
shard; the shards merge into one results CSV, and the shard-tagged winner
checkpoints give the global winner.  No tensor crosses processes, only
ledger and checkpoint files in a shared results directory.

:func:`initialize` brings up ``torch.distributed`` on gloo (on the CPU or
beside the GPUs alike: the only collective is :func:`barrier`) from
torchrun's variables or its own arguments, and is a no-op in a single
process, so the same sweep script runs everywhere.  The job meets through
a store: process 0's TCP store at the coordinator address, or a file (a
``FileStore`` in the run's directory, where no port has to be picked).
A coordinator address with port 0 lets process 0's store take a free port
and write it to the rendezvous file, where the others read it.
:func:`shutdown` leaves the job in order: process 0, which hosts a TCP
store, closes last.  The CSV is the port's own ledger format
(``sweep/engine.py``), which the JAX package's pandas ledger reads and
writes too.
"""

from __future__ import annotations

import datetime
import os
import re
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

BARRIER_TIMEOUT_MS = 1_800_000

# the store the process group was made on, for shutdown()'s ordering (the
# process group itself is torch.distributed's process-wide state)
_STORE = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_ms: int = BARRIER_TIMEOUT_MS,
               rendezvous_file: Optional[str] = None) -> Tuple[int, int]:
    """Join the distributed job when one is configured; returns
    (process_index, process_count), (0, 1) in a single process.

    The job meets at process 0's TCP store on ``coordinator_address``
    (``host:port``) or ``MASTER_ADDR`` / ``MASTER_PORT``, or else at
    ``rendezvous_file`` (a path every process can reach, not yet in use by
    another job).  With port 0 and more than one process, process 0's
    store takes a free port and writes it to ``rendezvous_file``, which the
    others wait for (``timeout_ms`` at most).  The topology is
    ``num_processes`` / ``process_id`` or ``WORLD_SIZE`` / ``RANK``
    (torchrun's names).  A meeting place without a topology raises
    ``ValueError``: with a defaulted topology every process would believe
    it is process 0 of 1, train the whole grid and clobber one shared
    ledger.  ``timeout_ms`` is the gloo group's timeout, which bounds
    :func:`barrier`."""
    import torch.distributed as dist

    global _STORE
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    addr = coordinator_address
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    if not (addr or rendezvous_file):
        return 0, 1
    nproc = num_processes if num_processes is not None else \
        os.environ.get("WORLD_SIZE")
    pid = process_id if process_id is not None else os.environ.get("RANK")
    if nproc is None or pid is None:
        raise ValueError(
            "a coordinator address or rendezvous file is set but "
            "num_processes/process_id are not — pass them explicitly or set"
            " WORLD_SIZE and RANK on every process")
    nproc, pid = int(nproc), int(pid)
    timeout = datetime.timedelta(milliseconds=timeout_ms)
    if addr:
        host, port = addr.rsplit(":", 1)
        publish = int(port) == 0 and nproc > 1
        if publish and not rendezvous_file:
            raise ValueError(
                f"coordinator {addr}: port 0 with {nproc} processes needs a "
                "rendezvous_file to publish the port through")
        if publish and pid:
            port = _published_port(rendezvous_file, timeout_ms)
        store = dist.TCPStore(host, int(port), nproc, is_master=pid == 0,
                              timeout=timeout, wait_for_workers=False)
        if publish and not pid:
            tmp = f"{rendezvous_file}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.write(str(store.port))
            os.replace(tmp, rendezvous_file)   # read whole or not at all
    else:
        store = dist.FileStore(rendezvous_file, nproc)
    dist.init_process_group("gloo", store=store, world_size=nproc,
                            rank=pid, timeout=timeout)
    _STORE = store
    return dist.get_rank(), dist.get_world_size()


def _published_port(path: str, timeout_ms: int) -> int:
    """The port process 0 wrote to ``path``, waited for up to
    ``timeout_ms``."""
    deadline = time.monotonic() + timeout_ms / 1000
    while True:
        try:
            with open(path) as f:
                return int(f.read())
        except FileNotFoundError:
            if time.monotonic() > deadline:
                raise TimeoutError(f"process 0 published no port at {path} "
                                   f"in {timeout_ms} ms") from None
            time.sleep(0.05)


def shutdown(timeout_ms: int = BARRIER_TIMEOUT_MS) -> None:
    """Leave the distributed job (no-op in a single process).  Every
    process meets at a last :func:`barrier`; then the others close their
    process groups and say so through the store, and process 0 closes its
    own only when all have: it hosts the TCP store, which a peer still
    closing would otherwise lose under it."""
    import torch.distributed as dist

    global _STORE
    if not (dist.is_available() and dist.is_initialized()):
        return
    rank, count = dist.get_rank(), dist.get_world_size()
    store, _STORE = _STORE, None
    barrier("shutdown", timeout_ms)
    if store is None:   # the group was made elsewhere: no store to order by
        dist.destroy_process_group()
    elif rank:
        dist.destroy_process_group()
        store.set(f"mmae_closed/{rank}", "1")
    else:
        store.wait([f"mmae_closed/{r}" for r in range(1, count)],
                   datetime.timedelta(milliseconds=timeout_ms))
        dist.destroy_process_group()


def barrier(name: str = "mmae_sweep_barrier",
            timeout_ms: int = BARRIER_TIMEOUT_MS) -> None:
    """Block until every process of the job reaches this point (no-op in
    a single process).  The sweep's one cross-process ordering: every
    ledger shard written before process 0 merges them.  Processes arrive
    minutes apart (their slices finish at different times), so the wait is
    a gloo ``monitored_barrier`` bounded by ``timeout_ms`` (30 min by
    default), not the first collective's short rendezvous.  ``name``
    labels the barrier in the error a timeout raises."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() <= 1:
        return
    try:
        dist.monitored_barrier(
            timeout=datetime.timedelta(milliseconds=timeout_ms),
            wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def partition_settings(settings: Sequence[Dict[str, Any]],
                       process_index: int, process_count: int
                       ) -> List[Dict[str, Any]]:
    """Deterministic round-robin slice of the settings list.  Round-robin
    (not contiguous chunks) so shape buckets spread evenly across
    processes.  Raises on an out-of-range index instead of returning an
    empty slice: a 1-based number (``(2, 2)``) would otherwise train
    nothing and surface hours later as an incomplete merge."""
    if process_count < 1:
        raise ValueError(f"process_count must be >= 1, got {process_count}")
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index must be in [0, {process_count}) — indices are "
            f"0-based — got {process_index}")
    if process_count == 1:
        return list(settings)
    return [s for i, s in enumerate(settings)
            if i % process_count == process_index]


def shard_ledger_path(results_path: str, save_prefix: str,
                      process_index: int, process_count: int) -> str:
    """Per-process ledger name; the plain name in a single process."""
    if process_count <= 1:
        return save_prefix
    return f"{save_prefix}.shard{process_index}of{process_count}"


def _generation(results_path: str, pattern: "re.Pattern", what: str,
                name: str, num_shards: Optional[int]) -> Tuple[int, list]:
    """The files of one shard generation (the ``ofN`` suffix): ``num_shards``
    or, by default, the generation with the most recently written file."""
    by_gen: Dict[int, list] = {}
    for f in os.listdir(results_path):
        m = pattern.match(f)
        if m:
            by_gen.setdefault(int(m.group(2)), []).append((f, m))
    if not by_gen:
        raise FileNotFoundError(f"no {what} for {name!r} in {results_path}")
    if num_shards is None:
        num_shards = max(by_gen, key=lambda n: max(
            os.path.getmtime(os.path.join(results_path, f))
            for f, _ in by_gen[n]))
    return num_shards, by_gen.get(num_shards, [])


def merge_ledger_shards(results_path: str, save_prefix: str,
                        out_name: Optional[str] = None,
                        num_shards: Optional[int] = None) -> str:
    """Concatenate the shard CSVs of one generation of ``save_prefix``
    into one results file (numeric shard order, then each shard's row
    order; columns in order of first appearance).  Returns its path.

    ``num_shards`` selects the generation (the ``ofN`` suffix); the
    default is the N of the most recently written shard, so a stale
    ``of4`` set left by an aborted run never leaks rows into a fresh
    ``of2`` merge.  Raises if the generation is incomplete."""
    from multimodalautoencoder_tpu_torch.sweep import engine

    pat = re.compile(re.escape(save_prefix) + r"\.shard(\d+)of(\d+)\.csv$")
    num_shards, files = _generation(results_path, pat, "shards",
                                    save_prefix, num_shards)
    shards = {int(m.group(1)): f for f, m in files}
    missing = sorted(set(range(num_shards)) - set(shards))
    if missing:
        raise FileNotFoundError(
            f"shard set of{num_shards} for {save_prefix!r} is missing "
            f"indices {missing}")
    out = engine.ResultsLedger(results_path, out_name or save_prefix,
                               save_every_nth=1 << 62)
    for i in range(num_shards):
        shard = engine.ResultsLedger(results_path, shards[i][:-len(".csv")],
                                     cont=True)
        for row in shard.rows:
            out.append(row)
    out.flush()
    return out.path


def select_global_best_checkpoint(results_path: str, name: str,
                                  num_shards: Optional[int] = None) -> str:
    """Path of the cross-process winner among the shard-tagged
    ``{name}.shard{i}of{N}-<step>.npz`` exports of ``save_best_params``:
    the checkpoint analog of find_best_setting over the merged ledger
    (generic_wrapper.py:317-347).  Each export's ``meta['extra']``
    carries its slice winner's score and the sweep's ``min_or_max``; the
    best score wins and NaN scores never do.  Per shard only the newest
    export counts (by mtime, then step): a rerun into the same directory
    with another ``num_steps`` leaves the old file beside the new one.
    ``num_shards`` selects the generation as in
    :func:`merge_ledger_shards`; a generation missing a shard raises."""
    from multimodalautoencoder_tpu_torch.train.checkpoint import \
        checkpoint_meta

    pat = re.compile(re.escape(name) + r"\.shard(\d+)of(\d+)-(\d+)\.npz$")
    num_shards, files = _generation(results_path, pat, "shard checkpoints",
                                    name, num_shards)
    newest: Dict[int, tuple] = {}
    for f, m in files:
        shard, step = int(m.group(1)), int(m.group(3))
        key = (os.path.getmtime(os.path.join(results_path, f)), step)
        if shard not in newest or key > newest[shard][0]:
            newest[shard] = (key, f)
    missing = sorted(set(range(num_shards)) - set(newest))
    if missing:
        raise FileNotFoundError(
            f"checkpoint shard set of{num_shards} for {name!r} is "
            f"missing indices {missing}")
    best_path, best_signed = None, None
    for shard in sorted(newest):
        path = os.path.join(results_path, newest[shard][1])
        extra = checkpoint_meta(path).get("extra") or {}
        score = extra.get("score")
        if score is None or np.isnan(float(score)):
            continue
        sign = 1.0 if extra.get("min_or_max", "max") == "max" else -1.0
        signed = sign * float(score)
        if best_signed is None or signed > best_signed:
            best_path, best_signed = path, signed
    if best_path is None:
        raise ValueError(
            f"no shard checkpoint of {name!r} carries a comparable score "
            f"in meta['extra'] (generation of{num_shards})")
    return best_path
