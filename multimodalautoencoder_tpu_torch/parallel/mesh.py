"""The device list a bucket's instance axis is split over.

Counterpart of ``multimodalautoencoder_tpu/parallel/mesh.py``.  There the
parallel unit, a training instance (one config on one fold), rides the
config axis of a (config, data) ``Mesh`` and ``shard_map`` splits it into
equal shards, padded to a multiple of the device count.  Here the mesh is
an explicit list of torch devices, the config axis; a bucket's instances
are cut into contiguous chunks, one per device, without padding, and each
chunk trains on its device from its own host thread
(``parallel/grid_trainer.py``).  The list is local: in a multi-process job
each process trains its own settings slice on its own devices
(``parallel/multihost.py``), and only ledger files cross processes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from multimodalautoencoder_tpu_torch.ops import optim

CONFIG_AXIS = "config"   # hyperparameter-setting axis (the headline axis)


def local_devices(kind: str = "cuda") -> List[torch.device]:
    """Every CUDA device of this process (``cuda:0`` .. ``cuda:n-1``), or
    ``[cpu]`` when ``kind`` is ``"cpu"``.  Raises ``RuntimeError`` when no
    CUDA device is visible: the CPU is never returned unless asked for."""
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"kind must be 'cuda' or 'cpu', not {kind!r}")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is visible; pass kind='cpu' to "
                           "train on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def as_devices(device) -> List[torch.device]:
    """A device or a sequence of devices as a list, the config axis.  A
    device may repeat (two chunks on one card); the types may not mix,
    since the kernels and their twin agree only within rounding."""
    seq = device if isinstance(device, (list, tuple)) else [device]
    devices = [torch.device(d) for d in seq]
    if not devices:
        raise ValueError("the device list is empty")
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"the devices mix types: {devices}")
    return devices


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> List[torch.device]:
    """The config axis over ``devices`` (default :func:`local_devices`).
    ``shape`` is the JAX package's (config, data) mesh shape; the port
    splits the config axis only, so it must be (len(devices), 1)."""
    devices = as_devices(list(devices) if devices is not None
                         else local_devices())
    if shape is None:
        shape = (len(devices), 1)
    if shape[0] * shape[1] != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    if shape[1] != 1:
        raise ValueError(f"mesh shape {shape}: the port splits the config "
                         "axis only, so the data axis must be 1")
    return devices


def pad_to_multiple(n: int, multiple: int) -> int:
    """Smallest padded size >= n divisible by ``multiple``."""
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


def chunk_bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """``parts`` contiguous [lo, hi) ranges covering [0, n), the first
    ``n % parts`` one longer than the rest; empty ranges when n < parts."""
    base, extra = divmod(int(n), int(parts))
    out, lo = [], 0
    for i in range(parts):
        hi = lo + base + (1 if i < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def split_leading_axis(tree, devices: Sequence) -> list:
    """One tree per device: every tensor leaf's leading axis cut into
    :func:`chunk_bounds` chunks, chunk i on ``devices[i]`` (the port's
    ``shard_leading_axis``).  A chunk on the leaf's own device is a view."""
    devices = as_devices(devices)
    n = int(optim.tree_leaves(tree)[0].shape[0])
    return [optim.tree_map(lambda t, lo=lo, hi=hi, d=d: t[lo:hi].to(d), tree)
            for d, (lo, hi) in zip(devices, chunk_bounds(n, len(devices)))]


def gather_leading_axis(trees: Sequence, device) -> object:
    """The inverse of :func:`split_leading_axis`: the chunks' leaves
    concatenated along the leading axis on ``device``."""
    device = torch.device(device)
    return optim.tree_map(
        lambda *leaves: torch.cat([t.to(device) for t in leaves]), *trees)
