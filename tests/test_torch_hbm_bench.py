"""The device-memory stream probe (``tools/hbm_bench.py``, kernel 5): its
plain twins on the CPU, and the CUDA kernels against them on the card
(``-m cuda``), with exact checks: an integer checksum for the read stream,
bit-equal buffers for the write and mixed streams."""

import numpy as np
import pytest
import torch

from multimodalautoencoder_tpu_torch.tools import hbm_bench


def test_twins_are_exact_on_the_cpu():
    rng = np.random.default_rng(0)
    words = rng.integers(-2 ** 31, 2 ** 31 - 1, 1024, dtype=np.int64)
    src = torch.as_tensor(words.astype(np.int32))
    sums = hbm_bench.read_sums(src, steps=3)
    assert sums.dtype == torch.int64
    assert sums.tolist() == [int(words.sum())] * 3
    # any dtype streams as its bytes: a bf16 buffer of the same bytes
    as_bf16 = src.view(torch.bfloat16)
    assert hbm_bench.read_sums(as_bf16).tolist() == [int(words.sum())]
    dst = torch.empty_like(src)
    hbm_bench.copy(src, dst, steps=2)
    assert torch.equal(dst, src)
    hbm_bench.fill(dst, 0x3F800000)
    assert torch.equal(dst.view(torch.float32), torch.ones(1024))


def test_stream_buffers_are_checked():
    with pytest.raises(ValueError, match="16-byte"):
        hbm_bench.read_sums(torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        hbm_bench.read_sums(torch.zeros((8, 8), dtype=torch.int32).T)
    with pytest.raises(ValueError, match="one size"):
        hbm_bench.copy(torch.zeros(8, dtype=torch.int32),
                       torch.zeros(4, dtype=torch.int32))
    assert hbm_bench.MOMENT_BYTES == 528_000_000
    assert hbm_bench.MOMENT_BYTES % hbm_bench.VECTOR == 0
    with pytest.raises(ValueError, match="CUDA"):
        hbm_bench.measure(1024, 1, device="cpu")


def test_stream_buffers_must_be_aligned():
    """The bulk copies need 16-byte aligned buffers; a view that starts
    mid-vector is refused on either device."""
    words = torch.zeros(20, dtype=torch.int32)
    with pytest.raises(ValueError, match="aligned"):
        hbm_bench.read_sums(words[1:17])
    with pytest.raises(ValueError, match="aligned"):
        hbm_bench.copy(words[1:17], torch.zeros(16, dtype=torch.int32))
    assert hbm_bench.read_sums(words[4:20]).tolist() == [0]


@pytest.mark.cuda
@pytest.mark.parametrize("nbytes", [
    16, 16 * 1000 + 16 * 7, 1 << 24,
    # copies that end in a short chunk of the ring's 32 KiB stages: within
    # one ring, and after every ring of a full grid has cycled its stages
    32768 * 5 + 48, (1 << 27) + 16 * 3])
def test_cuda_streams_match_twins(nbytes):
    """Each stream against its twin on the card: the read checksum equal
    on every pass, the written and copied buffers equal bit for bit, one
    launch a pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator(device="cuda").manual_seed(0)
    src = torch.randint(-2 ** 31, 2 ** 31 - 1, (nbytes // 4,),
                        dtype=torch.int32, device="cuda", generator=g)
    before = hbm_bench.KERNELS.launches
    sums = hbm_bench.read_sums(src, steps=3)
    want = src.sum(dtype=torch.int64)
    assert sums.tolist() == [int(want)] * 3
    dst = torch.zeros_like(src)
    hbm_bench.copy(src, dst, steps=2)
    assert torch.equal(dst, src)
    hbm_bench.fill(dst, 0x3F800000, steps=1)
    torch.cuda.synchronize()
    assert torch.equal(dst.view(torch.float32),
                       torch.ones(nbytes // 4, device="cuda"))
    assert hbm_bench.KERNELS.launches - before == 6
