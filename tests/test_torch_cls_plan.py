"""The phase-2 kernels' host plan: each product's panel and thread tile,
the grouped update's work list, the per-launch bounds, and the ctypes
mirror of ``struct ClsArgs``.

Kernel 4 (``csrc/cls_train_kernel.cu``) takes every product's panel width
and thread tile and the update's work list from ``ops/cls_train_kernels``,
computed once a run on the host; these tests hold that plan to what the
kernels assume, on the CPU.  The kernels themselves run on the card
(``tests/test_torch_cls_kernel.py -m cuda``).
"""

import ctypes
import os
import re

import numpy as np
import pytest

from multimodalautoencoder_tpu_torch.config import MMAEConfig
from multimodalautoencoder_tpu_torch.ops import cls_train_kernels as pck
from multimodalautoencoder_tpu_torch.ops import train_deep_kernels as pdk

SOURCE = pck.SOURCE
COMMON = os.path.join(os.path.dirname(pck.SOURCE), "train_common.cuh")
# the classification sweep's default grid (sweep/wrappers.py:657-659):
# encoders on 1000 features, heads
ENCODERS = [(1000, 100), (200, 100), (500, 100)]
HEADS = [(), (50, 20), (25, 10), (100, 50), (100,), (20,)]
FAMILIES = ["tied", "untied", "vae"]
BATCHES = [20, 37, 100, 128]


def _cfg(layers=(1000, 100), head=(50, 20), family="tied", feats=1000,
         labels=3):
    return MMAEConfig(num_feats=feats, layer_sizes=layers,
                      classification_layer_sizes=head, num_labels=labels,
                      tie_weights=family == "tied",
                      variational=family == "vae").validate()


def _plan(cfg, n_inst, batch, sms=132):
    F, (H1, _) = cfg.num_feats, cfg.layer_sizes
    return pck.cls_product_plan(F, H1, pck.cls_dims(cfg), pck.cls_gates(cfg),
                                cfg.variational, n_inst, batch, sms)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("head", HEADS)
def test_update_work_list_covers_every_element_once(head, family):
    """Every (weight, instance, tile) and every bias column of every
    instance is in the work list exactly once; weight tiles first, the
    largest tensors first, then the bias items, the widest first.  Phase 2
    trains the encoder and the head, never the decoder, so a tied and an
    untied bucket update the same tensors.  At the batch of 100 the run
    plan takes this list and the in-place path; at a batch of 20 the ring
    path's list, whose weight items split between the bulk copies
    (``ring_fits``, the slot aligned: not the head's 50- or 3-column
    weights) and W, m, v read in place, with either moment type and a
    misaligned slot."""
    cfg = _cfg(head=head, family=family)
    n_inst = 2
    F, (H1, _) = cfg.num_feats, cfg.layer_sizes
    dims = pck.cls_dims(cfg)
    items, n_weight, tile_tx = pck.cls_update_work_list(
        F, H1, dims, cfg.variational, n_inst)
    weights, biases, _ = pck.cls_update_tensors(F, H1, dims,
                                                cfg.variational)
    assert items.dtype == np.int32 and items.shape[1] == 4
    assert set(tile_tx) == {slot for slot, _, _ in weights}
    want = {0, 2} | ({4} if cfg.variational else set()) \
        | {6 + 2 * j for j in range(len(dims) - 1)}
    assert {slot for slot, _, _ in weights} == want
    assert {slot for slot, _ in biases} == {s + 1 for s in want}
    shapes = {slot: (R, C) for slot, R, C in weights}
    cover = {slot: np.zeros((n_inst, R, C), np.int64)
             for slot, R, C in weights}
    for slot, n, r0, c0 in items[:n_weight]:
        R, C = shapes[slot]
        tr, tc = pdk.update_tile(tile_tx[slot])
        assert r0 % tr == 0 and c0 % tc == 0 and r0 < R and c0 < C
        cover[slot][n, r0:r0 + tr, c0:c0 + tc] += 1
    for slot, c in cover.items():
        assert (c == 1).all(), slot
    size = [shapes[slot][0] * shapes[slot][1] for slot in items[:n_weight, 0]]
    assert size == sorted(size, reverse=True)
    widths = dict(biases)
    bcover = {slot: np.zeros((n_inst, C), np.int64) for slot, C in biases}
    for slot, n, r0, c0 in items[n_weight:]:
        assert slot in widths and r0 == 0 and c0 % pdk.BIAS_COLS == 0
        bcover[slot][n, c0:c0 + pdk.BIAS_COLS] += 1
    for slot, c in bcover.items():
        assert (c == 1).all(), slot
    width = [widths[slot] for slot in items[n_weight:, 0]]
    assert width == sorted(width, reverse=True)
    assert items[:, 0].max() < len(pck.SLOTS)
    gates = pck.cls_gates(cfg)
    for mbytes in (2, 4):
        for bad in ((), (0,)):
            for batch in (20, 100):
                plan = pck._run_plan(F, H1, tuple(dims), tuple(gates),
                                     cfg.variational, n_inst, batch, 132,
                                     mbytes, bad)
                ring = plan[5]
                assert (ring.depth >= 2) == (batch <= 32)
                if batch > 32:   # the in-place path: the list above
                    assert (plan[2].numpy() == items).all()
                    assert plan[3] == n_weight
                    assert ring == pdk.UpdateRing(
                        (), 0, n_weight, 0, 0, 0, 0, 0)
                    continue
                ritems, rn, rtx = pdk.work_list(
                    weights, biases, n_inst, True)
                assert (plan[2].numpy() == ritems).all() and plan[3] == rn
                assert dict(plan[4]) == rtx
                on = {s for s, R, C in weights if s not in bad
                      and pdk.ring_fits(R, C, rtx[s], mbytes)}
                assert set(ring.ring) == on
                assert ring.ring_items == int(np.isin(ritems[:rn, 0],
                                                      list(on)).sum())
                assert ring.ring_items + ring.fallback_items == rn


def test_work_list_of_the_validation_bucket():
    """W1 in 64 x 64 tiles, W2 (1000 x 100) in 40 x 100, the head's 100 x
    50 in 72 x 52, its 50 x 20 and 20 x 3 in one 128 x 32 tile each; the
    items of 80 instances."""
    items, n_weight, tile_tx = pck.cls_update_work_list(
        1000, 1000, (100, 50, 20, 3), False, 80)
    assert tile_tx == {0: 16, 2: 25, 6: 13, 8: 8, 10: 8}
    assert [pdk.update_tile(tile_tx[s]) for s in (0, 2, 6, 8, 10)] == [
        (64, 64), (40, 100), (72, 52), (128, 32), (128, 32)]
    assert n_weight == 80 * (16 * 16 + 25 + 2 + 1 + 1)
    assert len(items) - n_weight == 80 * (4 + 1 + 1 + 1 + 1)


def test_encoder_takes_no_l2_and_the_head_does():
    """The encoder's weights carry an L2 factor of 0 and the head's 1
    (:1645 of the JAX package), in the plan and in the kernel's own
    descriptors (``ClsRunner::update_tensors``)."""
    weights, _, pen = pck.cls_update_tensors(1000, 1000, (100, 50, 20, 3),
                                             True)
    assert pen == {0: 0.0, 2: 0.0, 4: 0.0, 6: 1.0, 8: 1.0, 10: 1.0}
    text = open(SOURCE).read()
    calls = re.findall(r"weight\((\w+)(?: \+ 2 \* j)?,[^;]*?([\d.]+)f\);",
                       text)
    slot_of = {name: i for i, name in enumerate(
        ("W1", "B1", "W2", "B2", "WV", "BV", "C1"))}
    assert {slot_of[name]: float(p) for name, p in calls} == {
        0: 0.0, 2: 0.0, 4: 0.0, 6: 1.0}


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("layers", ENCODERS + [(16, 6)])
def test_product_tiles_fit_and_cover(layers, batch):
    """Every product of every head of the grid, at batches 20 (the batch
    kernel), 37, 100 and 128 (the tile kernel): the panels cover every
    column and the row blocks every row, a block stays within 256 threads
    and its ring within the kernel's shared memory, and a thread tile's
    columns fill whole 16-byte loads."""
    feats = 30 if layers == (16, 6) else 1000
    max_smem = pck.TILE_STAGES * 4 * (
        pck.TILE_K * (pck.TILE_BLOCK_ROWS + 4)
        + pck.TILE_MAX_PANEL * (pck.TILE_K + 4))
    assert max_smem <= 227 * 1024
    for head in HEADS + [(8,), (8, 4)]:
        for family in FAMILIES:
            cfg = _cfg(layers, head, family, feats)
            for n_inst in (4, 80, 600):
                for p in _plan(cfg, n_inst, batch):
                    gx, gy, gz = p["grid"]
                    pw = p["panel"]
                    assert gz == n_inst
                    assert gx * pw >= p["ncol"] > (gx - 1) * pw, p
                    assert p["threads"] <= pck.TILE_MAX_THREADS, p
                    if p["kernel"] == "batch":
                        assert batch <= pdk.BATCH_ROWS
                        assert pw in pdk.PANEL_WIDTHS
                        assert gy * pdk.BATCH_ROWS >= batch
                        continue
                    assert batch > pdk.BATCH_ROWS
                    rows = pck.tile_thread_rows(batch) * pck.TILE_ROWS
                    assert rows >= min(batch, pck.TILE_BLOCK_ROWS)
                    assert rows - min(batch, pck.TILE_BLOCK_ROWS) \
                        < pck.TILE_ROWS
                    assert gy * pck.TILE_BLOCK_ROWS >= batch
                    assert p["cols"] in pck.TILE_COLS
                    assert pw % p["cols"] == 0 and pw // p["cols"] >= 2
                    assert pw % 4 == 0 and pw <= pck.TILE_MAX_PANEL
                    if p["cols"] == 8:
                        assert pw % 8 == 0
                    else:
                        assert pw <= pck.TILE_MAX_PANEL // 2
                    assert 0 < p["smem"] <= max_smem


@pytest.mark.parametrize("ncol, n_inst, want", [
    (1000, 80, (128, 8)), (500, 80, (128, 8)), (200, 80, (104, 8)),
    (100, 80, (104, 8)), (50, 80, (28, 4)), (25, 80, (16, 4)),
    (20, 80, (12, 4)), (10, 80, (8, 4)), (3, 80, (8, 4)),
    (1000, 4, (128, 8)), (100, 600, (104, 8)), (30, 80, (16, 4))])
def test_tile_panel_cases(ncol, n_inst, want):
    assert pck.tile_panel(ncol, n_inst, 100, sms=132) == want


def test_validation_bucket_plan():
    """The validation bucket's 9 products at batch 100 over 80 instances:
    the 1000-wide ones on 8 x 8 tiles in 8 panels of 128 (13 x 16
    threads), the 100-wide one in one panel of 104, the narrower ones on
    8 x 4 tiles over at least one block an SM."""
    plan = _plan(_cfg(), 80, 100)
    assert [p["name"] for p in plan] == [
        "encode 1", "encode 2", "head 0", "head 1", "head 2",
        "head 2 grad", "head 1 grad", "head 0 grad", "g1"]
    assert [(p["panel"], p["cols"]) for p in plan] == [
        (128, 8), (104, 8), (28, 4), (12, 4), (8, 4), (12, 4), (28, 4),
        (104, 8), (128, 8)]
    assert [p["kmajor"] for p in plan] == [False] * 5 + [True] * 4
    assert plan[0]["threads"] == 13 * 16 and plan[0]["grid"] == (8, 1, 80)
    assert all(p["kernel"] == "tile" for p in plan)
    assert all(p["grid"][0] * p["grid"][2] >= 132 or p["ncol"] <= 8
               or p["ncol"] == 100 for p in plan)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("head", [(), (8,), (50, 20)])
@pytest.mark.parametrize("batch", [20, 100])
def test_launches_per_step_follow_the_plan(head, family, batch):
    """A step is the sample, the planned products, the loss gradient, the
    VAE's two passes and one update: 12 for the validation bucket, 15 for
    its VAE; cls_launch_bounds has one row a launch, in the kernel's
    order."""
    cfg = _cfg(head=head, family=family)
    nc = len(head) + 1
    vae = family == "vae"
    plan = _plan(cfg, 80, batch)
    n = pck.launches_per_step(nc, vae)
    assert len(plan) == 2 * nc + 3 + (1 if vae else 0) <= pck.MAX_PRODUCTS
    assert n == 1 + len(plan) + 1 + (2 if vae else 0) + 1
    if nc == 3:
        assert n == (15 if vae else 12)
    rows = pck.cls_launch_bounds(cfg, 80, batch, True)
    assert len(rows) == n
    names = [r["name"] for r in rows]
    assert names[0] == "sample" and names[-1] == "update"
    assert names.index("loss grad") == 3 + (2 if vae else 0) + nc - 1 + 1
    assert [r["name"] for r in rows if "K" in r] == [p["name"]
                                                      for p in plan]
    if vae:
        assert names.index("vae sample") == 4
        assert names[-3] == "vae grad"


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("head", [(), (50, 20), (100,)])
def test_launch_bounds_sum_to_the_type_bounds(head, family):
    """Per launch against per type: the operations sum to the types'
    exactly; the sample, elementwise and update rows sum to their types'
    bytes; each product reads its own weight and input, so the products'
    bytes sum to at least their types'."""
    cfg = _cfg(head=head, family=family)
    rows = pck.cls_launch_bounds(cfg, 80, 100, True)
    types = pck.cls_launch_type_bounds(cfg, 80, 100, True)
    assert sum(r["flop"] for r in rows) == pytest.approx(
        sum(t["flop"] for t in types.values()))
    for kind in ("forward_products", "backward_products"):
        mine = [r for r in rows if r["type"] == kind]
        assert sum(r["flop"] for r in mine) == pytest.approx(
            types[kind]["flop"])
        assert sum(r["bytes"] for r in mine) >= types[kind]["bytes"]
    for kind in ("sample_corrupt", "elementwise"):
        mine = [r for r in rows if r["type"] == kind]
        assert sum(r["bytes"] for r in mine) == pytest.approx(
            types[kind]["bytes"])
    upd = rows[-1]
    assert upd["bytes"] == pytest.approx(
        types["weight_grad_adam"]["bytes"] + types["bias_grad_adam"]["bytes"])
    assert upd["bound_by"] == "bytes"
    assert rows[1]["name"] == "encode 1" \
        and rows[1]["bound_by"] == "operations"


def _c_struct_fields(text: str, name: str, consts):
    """(field, kind, count) of a C struct's declarations, kind 'int',
    'float' or 'ptr'."""
    body = re.search(r"struct " + name + r" \{(.*?)\n\};", text, re.S)
    body = re.sub(r"//[^\n]*", "", body.group(1))
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


def test_cls_args_mirror_the_c_struct():
    """ops/cls_train_kernels.ClsArgs mirrors ``struct ClsArgs`` of
    csrc/cls_train_kernel.cu field for field, the plan's fields
    included."""
    text = open(SOURCE).read()
    max_products = int(re.search(r"constexpr int MAX_PRODUCTS = (\d+);",
                                 text).group(1))
    assert max_products == pck.MAX_PRODUCTS
    consts = {"MAX_PRODUCTS": max_products, "NSLOT": len(pck.SLOTS),
              "NBUF": len(pck.BUFFERS)}
    c_fields = _c_struct_fields(text, "ClsArgs", consts)
    kinds = {ctypes.c_int: "int", ctypes.c_float: "float",
             ctypes.c_void_p: "ptr"}
    py_fields = []
    for name, ctype in pck.ClsArgs._fields_:
        count = getattr(ctype, "_length_", 1)
        base = getattr(ctype, "_type_", ctype) if hasattr(
            ctype, "_length_") else ctype
        py_fields.append((name, kinds[base], count))
    assert py_fields == c_fields
    for field in ("panel", "tile_cols", "tile_tx", "n_items",
                  "n_weight_items", "items", "upd_desc", "upd_ring",
                  "upd_depth", "upd_lfloats", "upd_rfloats", "upd_rbufs",
                  "upd_stage"):
        assert field in {f[0] for f in c_fields}


def test_tile_constants_mirror_the_kernel():
    """The plan's tile constants are gemm_tile_kernel's, the update's
    descriptor table holds kernel 4's slots, and the slot and buffer
    enums have the plan's lengths."""
    text = open(COMMON).read()

    def const(name):
        return int(re.search(r"\b" + name + r" = (\d+)", text).group(1))

    assert const("TR") == pck.TILE_ROWS
    assert const("TK") == pck.TILE_K
    assert const("TSTAGES") == pck.TILE_STAGES
    assert const("TM_MAX") == pck.TILE_BLOCK_ROWS
    assert const("TT_MAX") == pck.TILE_MAX_THREADS
    assert const("TPW_MAX") == pck.TILE_MAX_PANEL
    assert const("UPD_SLOTS") * pdk.DESC_BYTES == pdk.NSLOT * pdk.DESC_BYTES
    assert len(pck.SLOTS) <= const("UPD_SLOTS")
    source = open(SOURCE).read()
    slots = re.search(r"enum Slot \{(.*?)\};", source, re.S).group(1)
    assert slots.count(",") == len(pck.SLOTS)
    bufs = re.search(r"enum Buf \{(.*?)\};", source, re.S).group(1)
    assert bufs.count(",") == len(pck.BUFFERS)
