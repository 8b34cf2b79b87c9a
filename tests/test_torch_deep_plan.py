"""The deep training kernels' host plan: each product's panel width, the
grouped update's work list, the per-launch bounds, and the ctypes mirror
of ``struct DeepArgs``.

Kernel 3 (``csrc/train_deep_kernel.cu``) takes every product's panel
width and the update's work list from ``ops/train_deep_kernels``, computed
once a run on the host; these tests hold that plan to what the kernels
assume, on the CPU.  The kernels themselves run on the card
(``tests/test_torch_deep_kernel.py -m cuda``).
"""

import os
import re

import numpy as np
import pytest
import torch

from multimodalautoencoder_tpu_torch.config import MMAEConfig
from multimodalautoencoder_tpu_torch.ops import train_deep_kernels as pdk
from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk

TIED_BUCKET = (1000, 1000, 500, 100)
# (F, H1, ..., HL): the F = 30 gate widths, the full-width bucket, and
# widths that are not multiples of 4 (the 4-byte copy paths)
SIZES = [(30, 16, 10, 6), (30, 20, 14, 10, 6), TIED_BUCKET,
         (330, 257, 130, 6), (1000, 1000, 500, 100, 50),
         (1000, 500, 300, 100), (30, 24, 12, 8)]
FAMILIES = [(True, False), (False, False), (False, True)]   # tied, vae


def check_work_list(weights, biases, items, n_weight, tile_tx, n_inst,
                    ring):
    """Every (tensor, instance, tile) and every bias column of every
    instance in ``items`` exactly once; weight tiles first, the largest
    tensors first, then the bias items, the widest first; on the ring
    path (``ring``) an instance's tiles strip by strip, down each strip."""
    assert items.dtype == np.int32 and items.shape[1] == 4
    assert set(tile_tx) == {slot for slot, _, _ in weights}
    shapes = {slot: (R, C) for slot, R, C in weights}
    cover = {slot: np.zeros((n_inst, R, C), np.int64)
             for slot, R, C in weights}
    for slot, n, r0, c0 in items[:n_weight]:
        R, C = shapes[slot]
        tr, tc = pdk.update_tile(tile_tx[slot], ring)
        assert r0 % tr == 0 and c0 % tc == 0 and r0 < R and c0 < C
        cover[slot][n, r0:r0 + tr, c0:c0 + tc] += 1
    for slot, c in cover.items():
        assert (c == 1).all(), slot
    size = [shapes[slot][0] * shapes[slot][1] for slot in items[:n_weight, 0]]
    assert size == sorted(size, reverse=True)
    if ring:   # a strip's tiles follow each other, rows going down
        key = [tuple(it) for it in items[:n_weight, [0, 1, 3, 2]]]
        assert key == sorted(key, key=lambda k: (-np.prod(shapes[k[0]]),)
                             + k)
    widths = dict(biases)
    bcover = {slot: np.zeros((n_inst, C), np.int64) for slot, C in biases}
    for slot, n, r0, c0 in items[n_weight:]:
        assert slot in widths and r0 == 0 and c0 % pdk.BIAS_COLS == 0
        bcover[slot][n, c0:c0 + pdk.BIAS_COLS] += 1
    for slot, c in bcover.items():
        assert (c == 1).all(), slot
    width = [widths[slot] for slot in items[n_weight:, 0]]
    assert width == sorted(width, reverse=True)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("tied, vae", FAMILIES)
@pytest.mark.parametrize("sizes", SIZES)
def test_update_work_list_covers_every_element_once(sizes, tied, vae, ring):
    """Every (tensor, instance, tile) and every bias column of every
    instance is in the work list exactly once, on the in-place path's
    tiles and on the ring path's (:func:`check_work_list`).  The ring
    path's weight items split between the bulk copies (where
    ``ring_fits`` and the slot is aligned) and W, m, v read in place, with
    either moment type and a misaligned slot; the run plan takes the ring
    path at a batch of 20 and the in-place path, every item in place, at
    100."""
    n_inst = 3
    items, n_weight, tile_tx = pdk.update_work_list(sizes, tied, vae,
                                                    n_inst, ring)
    weights, biases = pdk.update_tensors(sizes, tied, vae)
    check_work_list(weights, biases, items, n_weight, tile_tx, n_inst, ring)
    paired = [pdk.ENC_W + i for i in range(len(sizes) - 1)] if tied else []
    for mbytes in (2, 4):
        for bad in ((), (weights[0][0],)):
            plan = pdk._run_plan(sizes, tied, vae, n_inst, 20 if ring
                                 else 100, 132, mbytes, bad)
            assert (plan[1].numpy() == items).all() and plan[2] == n_weight
            assert dict(plan[3]) == tile_tx
            got = plan[4]
            if not ring:
                assert got == pdk.UpdateRing((), 0, n_weight, 0, 0, 0, 0, 0)
                continue
            assert got == pdk.update_ring(weights, items, n_weight, tile_tx,
                                          20, mbytes, bad, paired)
            on = {s for s, R, C in weights if s not in bad
                  and pdk.ring_fits(R, C, tile_tx[s], mbytes)}
            assert set(got.ring) == on and got.depth >= 2
            assert got.ring_items == int(np.isin(items[:n_weight, 0],
                                                 list(on)).sum())
            assert got.ring_items + got.fallback_items == n_weight


@pytest.mark.parametrize("cols", [1, 4, 6, 10, 16, 30, 50, 64, 100, 128,
                                  130, 257, 300, 500, 1000, 1500])
def test_update_tiles_fit_the_block(cols):
    """An in-place tile keeps its threads within the block and its staged
    batch row (layer-input rows + gradient columns) within UPD_LD = 160
    floats, its rows a multiple of 4 (16-byte staging); a narrow tensor's
    tile leaves no more columns idle than a 64-wide one does.  A ring tile
    spans the columns up to 512 (fewer than 4 idle, but for the 8-thread
    floor), else strips of equal width on 8 columns (1000: two of 504),
    its rows a multiple of 4 and its threads within the block."""
    tx = pdk.update_tile_threads(cols)
    tr, tc = pdk.update_tile(tx)
    assert tx * tr // pdk.UPDATE_ROWS <= pdk.UPDATE_THREADS
    assert tr + tc <= 160 and tr % 4 == 0 and tc % 4 == 0
    idle = -(-cols // tc) * tc - cols
    assert idle <= -(-cols // 64) * 64 - cols
    if cols % 64 == 0 or cols > 128:
        assert (tr, tc) == (64, 64)
    tx = pdk.update_tile_threads(cols, True)
    tr, tc = pdk.update_tile(tx, True)
    assert tx * tr // pdk.UPDATE_ROWS <= pdk.UPDATE_THREADS
    assert tr % 4 == 0 and tc % 4 == 0 and tx >= 8
    if cols <= pdk.UPDATE_STRIP_COLS:
        assert tc >= cols and (tc - cols < 4 or tx == 8)
    else:
        strips = -(-cols // tc)
        assert tc % 8 == 0 and strips == -(-cols // pdk.UPDATE_STRIP_COLS)
        assert strips * tc - cols < 8 * strips
    if cols == 1000:
        assert (tr, tc) == (8, 504)


def test_update_tiles_of_the_tied_bucket():
    """The tied 1000 -> 500 -> 100 bucket's 500 x 100 weight takes 40 x
    100 tiles (250 of 256 threads busy), the others 64 x 64; on the ring
    path its 1000 x 1000 weight takes two strips of 8 x 504 tiles, the
    1000 x 500 whole rows of 8 x 500 and the 500 x 100 whole rows of 40 x
    100, every tile about 4000 elements."""
    items, n_weight, tile_tx = pdk.update_work_list(TIED_BUCKET, True,
                                                    False, 60)
    assert tile_tx == {pdk.ENC_W: 16, pdk.ENC_W + 1: 16, pdk.ENC_W + 2: 25}
    assert pdk.update_tile(25) == (40, 100)
    assert n_weight == 60 * (16 * 16 + 16 * 8 + 13 * 1)
    assert len(items) - n_weight == 60 * (4 + 2 + 1 + 2 + 4 + 4)
    items, n_weight, tile_tx = pdk.update_work_list(TIED_BUCKET, True,
                                                    False, 60, True)
    assert tile_tx == {pdk.ENC_W: 126, pdk.ENC_W + 1: 125,
                       pdk.ENC_W + 2: 25}
    assert [pdk.update_tile(tx, True) for tx in tile_tx.values()] == [
        (8, 504), (8, 500), (40, 100)]
    assert n_weight == 60 * (2 * 125 + 125 + 13)
    assert len(items) - n_weight == 60 * (4 + 2 + 1 + 2 + 4 + 4)


# the validation bucket's weights (kernel 4's phase 2: no pair of two)
VALIDATION_WEIGHTS = [(0, 1000, 1000), (2, 1000, 100), (6, 100, 50),
                      (8, 50, 20), (10, 20, 3)]


@pytest.mark.parametrize("batch", [13, 20, 24, 32, 37, 100])
@pytest.mark.parametrize("mbytes", [2, 4])
@pytest.mark.parametrize("paired", [(), (0, 2)])
def test_update_ring_depth_follows_batch_and_moments(batch, mbytes, paired):
    """Up to a batch of 32 the ring's buffers follow from the tiles, the
    pairs and the batch: a stage's layer inputs (pairs x B x the tallest
    tile's rows), a strip's gradients (pairs x B x the widest tile's
    columns) and the largest ring tile's W, m, v; as many stages as one
    block an SM holds beside them, at most UPDATE_MAX_DEPTH, the
    gradients in two buffers where that leaves three stages.  The head's
    50- and 3-column weights read in place (50 columns are not a multiple
    of 4).  A larger batch (phase 2's 100) takes the in-place path."""
    items, n_weight, tile_tx = pdk.work_list(VALIDATION_WEIGHTS, [], 80,
                                             True)
    ring = pdk.update_ring(VALIDATION_WEIGHTS, items, n_weight, tile_tx,
                           batch, mbytes, (), paired)
    pairs = {s: 2 if s in paired else 1 for s, _, _ in VALIDATION_WEIGHTS}
    tiles = {s: pdk.update_tile(tx, True) for s, tx in tile_tx.items()}
    l_floats = max(pairs[s] * batch * tr for s, (tr, _) in tiles.items())
    r_floats = max(pairs[s] * batch * tc for s, (_, tc) in tiles.items())
    stage = 8 * 504 * (4 + 2 * mbytes)
    if batch > 32 or pdk.ring_depth(l_floats, r_floats, 1, stage) < 2:
        # (two pairs of 32 rows at f32 moments: two stages do not fit)
        assert (batch, mbytes, paired) == (32, 4, (0, 2)) or batch > 32
        assert ring == pdk.UpdateRing((), 0, n_weight, 0, 0, 0, 0, 0)
        return
    assert ring.ring == (0, 2, 8)
    # the 100 x 50 weight in two 76-row tiles, the 20 x 3 in one
    assert ring.fallback_items == 80 * (2 + 1)
    assert (ring.l_floats, ring.r_floats, ring.stage_bytes) == (
        l_floats, r_floats, stage)

    def smem(depth, bufs):
        return (pdk.UPDATE_STATIC_BYTES + 4 * ring.r_floats * bufs
                + depth * (ring.stage_bytes + 4 * ring.l_floats))

    assert ring.depth >= 2 and smem(ring.depth, ring.r_bufs) <= \
        pdk.BLOCK_SHARED_BYTES
    assert ring.depth == pdk.UPDATE_MAX_DEPTH or smem(
        ring.depth + 1, ring.r_bufs) > pdk.BLOCK_SHARED_BYTES
    assert (ring.r_bufs == 2) == (pdk.ring_depth(
        ring.l_floats, ring.r_floats, 2, ring.stage_bytes) >= 3)


def test_ring_takes_rows_by_their_alignment():
    """With bf16 moments the 500-, 300- and 100-column weights' moment
    rows of 1000, 600 and 200 B are not multiples of 16 B, so they take
    whole-row tiles over an even number of rows, one bulk copy each of W,
    m and v; the 1000-column weight's rows of 2000 B take a copy a row of
    its 504-column strips.  An odd row count, columns not a multiple of
    4, or a W, m or v not on 16 bytes reads in place."""
    weights = [(0, 1000, 500), (2, 1000, 300), (4, 1000, 100),
               (6, 100, 1000), (8, 99, 100), (10, 64, 30)]
    items, n_weight, tile_tx = pdk.work_list(weights, [], 2, True)
    assert [2 * C % 16 for _, _, C in weights[:3]] == [8, 8, 8]
    for slot, R, C in weights[:4]:
        tr, tc = pdk.update_tile(tile_tx[slot], True)
        assert (tc >= C) == (C < 1000) and tr % 2 == 0
        assert pdk.ring_fits(R, C, tile_tx[slot], 2)
        assert pdk.ring_fits(R, C, tile_tx[slot], 4)
    assert not pdk.ring_fits(99, 100, tile_tx[8], 2)
    assert pdk.ring_fits(99, 100, tile_tx[8], 4)
    assert not pdk.ring_fits(64, 30, tile_tx[10], 4)
    ring = pdk.update_ring(weights, items, n_weight, tile_tx, 20, 2)
    assert ring.ring == (0, 2, 4, 6)
    assert ring.fallback_items == int(np.isin(items[:n_weight, 0],
                                              [8, 10]).sum())
    h = torch.zeros(64, dtype=torch.bfloat16)
    f = torch.zeros(64)
    assert h.data_ptr() % 16 == 0 and f.data_ptr() % 16 == 0
    assert pdk.misaligned_slots([(0, f, h, h), (2, f, h[8:], h[16:]),
                                 (4, f, h[4:], h), (6, f[1:], h, h),
                                 (8, f[4:], h, h[1:])]) == (4, 6, 8)
    bad = pdk.update_ring(weights, items, n_weight, tile_tx, 20, 2, (2,))
    assert bad.ring == (0, 4, 6)
    assert bad.fallback_items == int(np.isin(items[:n_weight, 0],
                                             [2, 8, 10]).sum())


def test_panel_choice_fills_an_h100():
    """Each of the tied bucket's 11 products gives at least two blocks an
    SM on 132 SMs, at a width of 64, 32 or 16 no wider than its columns
    need."""
    plan = pdk.product_plan(TIED_BUCKET, True, False, 60, 20, sms=132)
    assert len(plan) == 11
    for p in plan:
        gx, gy, gz = p["grid"]
        assert p["panel"] in pdk.PANEL_WIDTHS
        assert gx * gy * gz >= 2 * 132, p
        assert gx == -(-p["ncol"] // p["panel"])
        assert p["panel"] < 2 * p["ncol"] or p["panel"] == 16, p
    assert [p["panel"] for p in plan] == [64, 64, 16, 64, 64, 64, 64, 64,
                                          16, 64, 64]


@pytest.mark.parametrize("ncol, n_inst, batch, want", [
    (1000, 60, 20, 64), (500, 60, 20, 64), (100, 60, 20, 16),
    (30, 4, 20, 16), (30, 300, 20, 32), (6, 60, 20, 16),
    (1000, 4, 20, 16), (257, 60, 20, 64), (130, 60, 20, 32),
    (1000, 60, 100, 64)])
def test_panel_width_cases(ncol, n_inst, batch, want):
    assert pdk.panel_width(ncol, n_inst, batch, sms=132) == want


@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("tied, vae", FAMILIES)
def test_launches_per_step_follow_the_plan(depth, tied, vae):
    """A step is the sample, the planned products, the VAE's two passes
    and one update: 13 for tied depth 3, 16 for the depth-3 VAE; and
    deep_launch_bounds has one row a launch."""
    sizes = (40,) + tuple(range(30, 30 - 6 * depth, -6))[:depth]
    plan = pdk.product_plan(sizes, tied, vae, 10, 20)
    n = pdk.launches_per_step(depth, tied, vae)
    assert n == 1 + len(plan) + (2 if vae else 0) + 1
    assert len(plan) == 4 * depth - 1 + (1 if vae else 0)
    if depth == 3:
        assert n == (16 if vae else 13)
    cfg = MMAEConfig(num_feats=sizes[0], layer_sizes=sizes[1:],
                     tie_weights=tied, variational=vae).validate()
    rows = pdk.deep_launch_bounds(cfg, 10, 20, True)
    assert len(rows) == n
    assert rows[0]["name"] == "sample" and rows[-1]["name"] == "update"


@pytest.mark.parametrize("tied, vae", FAMILIES)
def test_launch_bounds_split_the_type_bounds(tied, vae):
    """The per-launch rows: the update is the weight and bias rows
    together, the VAE passes split theirs, the products' operations sum to
    their type rows', and each product reads its own weight, so the
    forward products' bytes sum to at least their type row's (which counts
    a tied weight once)."""
    cfg = MMAEConfig(num_feats=1000, layer_sizes=(1000, 500, 100),
                     tie_weights=tied, variational=vae).validate()
    rows = pdk.deep_launch_bounds(cfg, 60, 20, True)
    types = pdk.deep_launch_type_bounds(cfg, 60, 20, True)
    upd = rows[-1]
    assert upd["bytes"] == pytest.approx(
        types["weight_grad_adam"]["bytes"] + types["bias_grad_adam"]["bytes"])
    assert upd["flop"] == pytest.approx(
        types["weight_grad_adam"]["flop"] + types["bias_grad_adam"]["flop"])
    for kind in ("forward_products", "backward_products"):
        mine = [r for r in rows if r["type"] == kind]
        assert sum(r["flop"] for r in mine) == pytest.approx(
            types[kind]["flop"])
        for r in mine:
            assert r["bytes"] > 4.0 * 60 * (r["K"] + r["K2"]) * r["ncol"]
    fwd = [r for r in rows if r["type"] == "forward_products"]
    assert sum(r["bytes"] for r in fwd) >= types["forward_products"]["bytes"]
    vae_rows = [r for r in rows if r["type"] == "vae_elementwise"]
    assert len(vae_rows) == (2 if vae else 0)
    if vae:
        assert sum(r["bytes"] for r in vae_rows) == pytest.approx(
            types["vae_elementwise"]["bytes"])
    assert all(r["bound_by"] == "bytes" for r in rows if "K" in r)


def _c_struct_fields(source: str, name: str):
    """(field, kind, count) of a C struct's declarations, kind 'int',
    'float' or 'ptr'."""
    text = open(source).read()
    body = re.search(r"struct " + name + r" \{(.*?)\n\};", text, re.S)
    body = re.sub(r"//[^\n]*", "", body.group(1))
    consts = {"MAX_DEPTH": pdk.MAX_DEPTH, "NSLOT": pdk.NSLOT,
              "NBUF": pdk.NBUF, "MAX_PRODUCTS": pdk.MAX_PRODUCTS}
    out = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.match(r"((?:const )?\w+\s*\*?)\s*(.*)", decl, re.S)
        ctype, names = m.group(1).strip(), m.group(2)
        kind = "ptr" if ctype.endswith("*") else ctype
        for item in names.split(","):
            item = item.strip()
            if item.startswith("*"):
                kind, item = "ptr", item[1:].strip()
            arr = re.match(r"(\w+)\s*\[(.*)\]", item)
            count = 1
            if arr:
                item = arr.group(1)
                count = eval(arr.group(2), {}, consts)   # noqa: S307
            out.append((item, kind, count))
    return out


def test_deep_args_mirror_the_c_struct():
    """ops/train_deep_kernels.DeepArgs mirrors ``struct DeepArgs`` of
    csrc/train_deep_kernel.cu field for field, the plan's fields
    included."""
    import ctypes

    source = os.path.join(os.path.dirname(pdk.SOURCE), "train_deep_kernel.cu")
    c_fields = _c_struct_fields(source, "DeepArgs")
    kinds = {ctypes.c_int: "int", ctypes.c_float: "float",
             ctypes.c_void_p: "ptr"}
    py_fields = []
    for name, ctype in pdk.DeepArgs._fields_:
        count = getattr(ctype, "_length_", 1)
        base = getattr(ctype, "_type_", ctype) if count > 1 or hasattr(
            ctype, "_length_") else ctype
        py_fields.append((name, kinds[base], count))
    assert py_fields == c_fields
    for field in ("panel", "tile_tx", "n_items", "n_weight_items", "items",
                  "upd_desc", "upd_ring", "upd_depth", "upd_lfloats",
                  "upd_rfloats", "upd_rbufs", "upd_stage"):
        assert field in {f[0] for f in c_fields}


def test_depth2_bucket_plan_is_the_deep_family_at_l2():
    """The plan at L = 2 (kernel 3 runs it where a caller asks, though the
    sweep sends depth 2 to kernel 2): kernel 2's launches a step, one
    update of every weight and bias as kernel 2 makes it."""
    for tied, vae in FAMILIES:
        assert pdk.launches_per_step(2, tied, vae) == \
            ptk.launches_per_step(tied, vae)
