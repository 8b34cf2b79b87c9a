"""Device-memory bandwidth probe of the H100: the rate the training
kernels' parameter and Adam-moment traffic can reach.

Counterpart of ``tools/hbm_bench.py`` of the JAX package, whose Pallas
kernel ``_stream_kernel`` (:60-122, ``pallas_call`` :112) streamed an HBM
buffer through VMEM in three patterns.  Here the three streams are the
hand-written kernels of ``csrc/hbm_stream.cu`` (built with nvcc for sm_90a
at first use), over a buffer the size of the untied 1000 -> 100 bucket's
bf16 Adam moments (60 instances x 2.2 M parameters x m and v x 2 B,
0.53 GB):

- ``read``: every 32-bit word summed as a signed integer (exact, so the
  kernel is checked against ``torch.sum``);
- ``write``: every word set to a value (against ``fill_``);
- ``mixed``: a copy into a second buffer, one read and one write of every
  byte, the traffic of an Adam step over its moments (against
  ``copy_``), through rings of bulk-async copies in shared memory.

Each pattern runs ``steps`` passes back to back, timed by CUDA events in
turns with the one PyTorch call that computes the same function (kernel,
library, library, kernel).  The plain twins above run for CPU tensors;
CUDA tensors take the kernels or raise.  Run on a card:

    python -m multimodalautoencoder_tpu_torch.tools.hbm_bench

It prints one line per pattern beside its library call, then a JSON
object of GB/s, and fails without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
from typing import Dict, Optional, Tuple

import torch

from multimodalautoencoder_tpu_torch.ops.cuda_library import (CSRC_DIR,
                                                              NvccLibrary)

SOURCE = os.path.join(CSRC_DIR, "hbm_stream.cu")
LIBRARY = "libhbm_stream.so"  # in cuda_library.build_dir()
PATTERNS = ("read", "write", "mixed")
# the untied 1000 -> 100 bucket's bf16 m and v: 60 instances x (1000 x
# 1000 x 2 + 1000 x 100 x 2) weights, 2 moments of 2 B each
MOMENT_BYTES = 60 * 2_200_000 * 2 * 2
STEPS = 20            # passes a timed call makes
REPS = 3              # timed calls a turn, after one warm-up call
VECTOR = 16           # bytes a thread moves per load or store
# the library call beside each pattern
LIBRARY_CALLS = {"read": "torch.sum(dtype=torch.int64)", "write": "fill_",
                 "mixed": "copy_"}


class HbmLibrary(NvccLibrary):
    """``csrc/hbm_stream.cu`` built and bound; ``launches`` counts its
    kernels' launches."""

    def __init__(self):
        super().__init__(SOURCE, LIBRARY)

    def _bind(self, lib: ctypes.CDLL) -> None:
        lib.hbm_stream_run.restype = ctypes.c_int
        lib.hbm_stream_run.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        lib.hbm_stream_error_string.restype = ctypes.c_char_p
        lib.hbm_stream_error_string.argtypes = [ctypes.c_int]

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.load().hbm_stream_error_string(err).decode()
            raise RuntimeError(f"{what} failed: {msg} ({err})")


KERNELS = HbmLibrary()


def _words(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as int32 words; it must be contiguous, start on a
    16-byte boundary and be a whole number of 16-byte vectors."""
    if not t.is_contiguous():
        raise ValueError("the stream buffers must be contiguous")
    nbytes = t.numel() * t.element_size()
    if nbytes % VECTOR:
        raise ValueError(f"{nbytes} bytes is not a whole number of "
                         f"{VECTOR}-byte vectors")
    if t.data_ptr() % VECTOR:
        raise ValueError(f"the stream buffers must be {VECTOR}-byte aligned")
    return t.view(torch.uint8).view(torch.int32)


def _run(pattern: str, src, dst, steps: int, value: int = 0,
         sums: Optional[torch.Tensor] = None) -> None:
    buf = src if src is not None else dst
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"the stream kernels run on cuda, not {dev}")
    lib = KERNELS.load()
    launches = ctypes.c_longlong(0)
    with torch.cuda.device(dev):
        err = lib.hbm_stream_run(
            PATTERNS.index(pattern),
            None if src is None else src.data_ptr(),
            None if dst is None else dst.data_ptr(),
            buf.numel() * buf.element_size() // VECTOR, int(steps),
            int(value) & 0xFFFFFFFF,
            None if sums is None else sums.data_ptr(), ctypes.byref(launches),
            torch.cuda.current_stream(dev).cuda_stream)
    KERNELS.launches += launches.value
    KERNELS.check(err, f"hbm_stream_run({pattern})")


def read_sums(src: torch.Tensor, steps: int = 1) -> torch.Tensor:
    """The read stream: (steps,) int64, the signed sum of ``src``'s int32
    words on each pass.  The plain twin for a CPU tensor."""
    words = _words(src)
    if src.device.type == "cpu":
        return words.sum(dtype=torch.int64).repeat(steps)
    sums = torch.zeros(steps, dtype=torch.int64, device=src.device)
    _run("read", src, None, steps, sums=sums)
    return sums


def fill(dst: torch.Tensor, value: int, steps: int = 1) -> None:
    """The write stream: every int32 word of ``dst`` set to ``value`` on
    each pass.  ``fill_`` for a CPU tensor."""
    words = _words(dst)
    if dst.device.type == "cpu":
        for _ in range(steps):
            words.fill_(value)
        return
    _run("write", None, dst, steps, value=value)


def copy(src: torch.Tensor, dst: torch.Tensor, steps: int = 1) -> None:
    """The mixed stream: ``dst`` = ``src``, bit for bit, on each pass.
    ``copy_`` for CPU tensors."""
    a, b = _words(src), _words(dst)
    if a.shape != b.shape or src.device != dst.device:
        raise ValueError("copy needs two buffers of one size on one device")
    if src.device.type == "cpu":
        for _ in range(steps):
            b.copy_(a)
        return
    _run("mixed", src, dst, steps)


def _event_ms(fn, reps: int = REPS) -> float:
    """Median over ``reps`` of one call of ``fn`` by CUDA events, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def _buffers(nbytes: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the bandwidth probe measures a CUDA device")
    n = nbytes // 4
    src = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), dtype=torch.int32,
                        device=device)
    return src, torch.empty_like(src)


def _in_turns(kernel, library, steps: int) -> Dict[str, object]:
    """ms a pass of ``kernel`` and ``library``, timed in turns (kernel,
    library, library, kernel); each figure is the mean of its two turns."""
    turns = [_event_ms(f) / steps for f in (kernel, library, library,
                                            kernel)]
    return {"ms": (turns[0] + turns[3]) / 2,
            "library_ms": (turns[1] + turns[2]) / 2, "turns": turns}


def measure(nbytes: int = MOMENT_BYTES, steps: int = STEPS,
            device="cuda") -> Dict[str, Dict[str, object]]:
    """Each pattern's ms per pass and GB/s over a buffer of ``nbytes``
    beside its library call's (:data:`LIBRARY_CALLS`), by CUDA events
    around ``steps`` back-to-back passes (the median of :data:`REPS` calls
    after a warm-up call), in turns."""
    src, dst = _buffers(nbytes, device)
    words = src.view(torch.int32)
    moved = {"read": nbytes, "write": nbytes, "mixed": 2 * nbytes}
    runs = {
        "read": (lambda: read_sums(src, steps),
                 lambda: [words.sum(dtype=torch.int64)
                          for _ in range(steps)]),
        "write": (lambda: fill(dst, 0x3F800000, steps),
                  lambda: [dst.fill_(0x3F800000) for _ in range(steps)]),
        "mixed": (lambda: copy(src, dst, steps),
                  lambda: [dst.copy_(src) for _ in range(steps)]),
    }
    out = {}
    for name, (kernel, library) in runs.items():
        r = _in_turns(kernel, library, steps)
        r.update(bytes=float(moved[name]), library=LIBRARY_CALLS[name],
                 gb_per_s=moved[name] / r["ms"] / 1e6,
                 library_gb_per_s=moved[name] / r["library_ms"] / 1e6)
        out[name] = r
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("hbm_bench: no CUDA device", file=sys.stderr)
        return 2
    result = measure()
    for name, r in result.items():
        print(f"{name:6s} {r['bytes'] / 1e9:.3f} GB moved a pass: "
              f"{r['ms']:.4f} ms, {r['gb_per_s']:.1f} GB/s; "
              f"{r['library']} {r['library_ms']:.4f} ms, "
              f"{r['library_gb_per_s']:.1f} GB/s")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "gb_per_s": {k: r["gb_per_s"]
                                   for k, r in result.items()},
                      "library_gb_per_s": {k: r["library_gb_per_s"]
                                           for k, r in result.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
