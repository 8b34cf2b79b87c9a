"""The depth-2 training kernel's host plan: each product's panel width, the
grouped update's work list, the per-launch bounds, and the ctypes mirror
of ``struct TrainArgs``.

Kernel 2 (``csrc/train_kernel.cu``) takes every product's panel width
and the update's work list from ``ops/train_kernels``,
computed once a run on the host; these tests hold that plan to what the
kernel assumes, on the CPU.  The kernel itself runs on the card
(``tests/test_torch_train_kernel.py -m cuda``).
"""

import ctypes
import os
import re

import numpy as np
import pytest

from multimodalautoencoder_tpu_torch.config import MMAEConfig
from multimodalautoencoder_tpu_torch.ops import train_deep_kernels as pdk
from multimodalautoencoder_tpu_torch.ops import train_kernels as ptk

FAMILIES = [(True, False), (False, False), (False, True)]   # tied, vae
# the ACII widths (F = 1000 -> H1 -> 100), the F = 30 gate widths and
# widths that are not multiples of 4 (the 4-byte copy paths)
DIMS = [(1000, 1000, 100), (1000, 500, 100), (1000, 300, 100), (30, 16, 6),
        (330, 257, 6), (30, 16, 8), (48, 20, 12)]
SOURCE = os.path.join(os.path.dirname(pdk.SOURCE), "train_kernel.cu")


def expected_products(dims, tied, vae):
    """(name, ncol, K, K2, K-major B) of every product of
    ``Runner::step``, in launch order."""
    F, H1, H2 = dims
    out = [("z1", H1, F, 0, False)]
    if vae:
        out.append(("lv", H2, H1, 0, False))
    out += [("mu", H2, H1, 0, False),
            ("z3", H1, H2, 0, tied),          # W2^T when tied
            ("z4", F, H1, 0, tied),           # W1^T when tied
            ("g3", H1, F, 0, not tied),       # W4^T untied, W1 tied
            ("gz", H2, H1, 0, not tied),      # W3^T untied, W2 tied
            ("g1", H1, H2, H2 if vae else 0, True)]   # W2^T (+ Wv^T)
    return out


@pytest.mark.parametrize("n_inst", [60, 20])
@pytest.mark.parametrize("tied, vae", FAMILIES)
@pytest.mark.parametrize("dims", DIMS[:3])
def test_product_plan_in_launch_order(dims, tied, vae, n_inst):
    """The plan lists ``Runner::step``'s products in launch order with
    their columns, depths (the VAE's g1 with its second pair, glv Wv^T,
    as K2), B's orientation, the panel width of ``panel_width`` and the
    grid."""
    plan = ptk.product_plan(dims, tied, vae, n_inst, 20, sms=132)
    got = [(p["name"], p["ncol"], p["K"], p["K2"], p["kmajor"])
           for p in plan]
    assert got == expected_products(dims, tied, vae)
    for p in plan:
        assert p["panel"] == pdk.panel_width(p["ncol"], n_inst, 20, 132)
        assert p["grid"] == (-(-p["ncol"] // p["panel"]), 1, n_inst)
    types = [p["type"] for p in plan]
    n_fwd = 5 if vae else 4
    assert types == ["forward_products"] * n_fwd + ["backward_products"] * 3


def test_panels_of_the_tied_bucket():
    """The 1000-wide products take 64-column panels and the 100-wide ones
    16: 420 blocks at N = 60 and 140 at phase 1's N = 20, where 64-column
    panels gave 120 and 40 on 132 SMs."""
    for n_inst in (60, 20):
        plan = ptk.product_plan((1000, 1000, 100), True, False, n_inst, 20,
                                132)
        assert [p["panel"] for p in plan] == [64, 16, 64, 64, 64, 16, 64]
        assert plan[1]["grid"] == (7, 1, n_inst)


def _c_update_tensors():
    """Each ``weight(...)`` call of ``Runner::update_tensors`` in the
    source as (slot, rows, cols, layer input, gradient, second pair's
    input or -1, its gradient or -1, L2 factor), split by the tied and
    untied branches, and each ``bias(...)`` as (slot, cols, gradient)."""
    text = open(SOURCE).read()
    body = text[text.index("void update_tensors(UpdTensor* T) const {"):]
    body = body[:body.index("\n  }\n")]
    tied = body[body.index("if (a.tied) {"):body.index("} else {")]
    untied = body[body.index("} else {"):body.index("if (a.variational)")]
    rest = body[body.index("if (a.variational) weight"):]
    weight = re.compile(r"weight\((\w+), (\w+), (\w+), (\w+), (\w+), "
                        r"(-?\w+), (-?\w+), ([\d.]+)f\)")
    bias = re.compile(r"bias\((\w+), (\w+), (\w+)\)")
    return (weight.findall(tied), weight.findall(untied),
            weight.findall(rest), bias.findall(body))


def test_update_pairs_and_l2_factors():
    """The update's descriptors sum the twin's products: a tied W1 takes
    xn^T g1 then g4^T a3d, a tied W2 a1d^T gz then g3^T z2, both with the
    L2 doubled; untied weights and Wv take one pair at L2 factor 1; each
    bias the column sums of its layer's gradient."""
    tied, untied, vae, biases = _c_update_tensors()
    assert tied == [("W1", "F", "H1", "XN", "G1", "G4", "A3D", "2."),
                    ("W2", "H1", "H2", "A1D", "GZ", "G3", "z2", "2.")]
    assert untied == [("W1", "F", "H1", "XN", "G1", "-1", "-1", "1."),
                      ("W2", "H1", "H2", "A1D", "GZ", "-1", "-1", "1."),
                      ("W3", "H2", "H1", "z2", "G3", "-1", "-1", "1."),
                      ("W4", "H1", "F", "A3D", "G4", "-1", "-1", "1.")]
    assert vae == [("WV", "H1", "H2", "A1D", "GLV", "-1", "-1", "1.")]
    assert biases == [("B1", "H1", "G1"), ("B2", "H2", "GZ"),
                      ("B3", "H1", "G3"), ("B4", "F", "G4"),
                      ("BV", "H2", "GLV")]
    # the Python side names the same slots and shapes
    weights, bias_slots = ptk.update_tensors((7, 5, 3), False, True)
    names = {i: name.upper() for i, name in enumerate(ptk.SLOTS)}
    dims = {"F": 7, "H1": 5, "H2": 3}
    assert [(names[s], R, C) for s, R, C in weights] == [
        (w[0], dims[w[1]], dims[w[2]]) for w in untied + vae]
    assert [(names[s], C) for s, C in bias_slots] == [
        (b[0], dims[b[1]]) for b in biases]


@pytest.mark.parametrize("batch", [20, 100])
@pytest.mark.parametrize("n_inst", [1, 3, 60])
@pytest.mark.parametrize("tied, vae", FAMILIES)
@pytest.mark.parametrize("dims", DIMS)
def test_work_list_covers_every_element_once(dims, tied, vae, n_inst, batch):
    """Every (weight, instance, element) and every bias column of every
    instance is in the work list exactly once, weight tiles first (the
    largest tensors first), then bias items (the widest first); the plan's
    panels are the product plan's.  At a batch of 20 the plan takes the
    update's ring path (its tiles strip by strip) and its weight items
    split between the bulk copies (``ring_fits``, the slot aligned) and W,
    m, v read in place, with either moment type and a misaligned slot; at
    100 the in-place path takes every item."""
    panels, items, n_weight, tile_tx, ring = ptk.run_plan(
        dims, tied, vae, n_inst, batch, 132)
    plan = ptk.product_plan(dims, tied, vae, n_inst, batch, 132)
    assert panels == tuple([p["panel"] for p in plan]
                           + [0] * (ptk.MAX_PRODUCTS - len(plan)))
    items = items.numpy()
    weights, biases = ptk.update_tensors(dims, tied, vae)
    tile_tx = dict(tile_tx)
    on_ring = batch <= pdk.UPDATE_RING_MAX_BATCH
    assert (ring.depth >= 2) == on_ring
    assert set(tile_tx) == {s for s, _, _ in weights}
    assert items.dtype == np.int32 and items.shape[1] == 4
    shapes = {s: (R, C) for s, R, C in weights}
    cover = {s: np.zeros((n_inst, R, C), np.int64) for s, R, C in weights}
    bcover = {s: np.zeros((n_inst, C), np.int64) for s, C in biases}
    for slot, n, r0, c0 in items[:n_weight]:
        tr, tc = pdk.update_tile(tile_tx[slot], on_ring)
        R, C = shapes[slot]
        assert r0 % tr == 0 and c0 % tc == 0 and r0 < R and c0 < C
        cover[slot][n, r0:r0 + tr, c0:c0 + tc] += 1
    for slot, n, r0, c0 in items[n_weight:]:
        assert slot in bcover and r0 == 0 and c0 % pdk.BIAS_COLS == 0
        bcover[slot][n, c0:c0 + pdk.BIAS_COLS] += 1
    for c in list(cover.values()) + list(bcover.values()):
        assert (c == 1).all()
    size = [shapes[slot][0] * shapes[slot][1] for slot in items[:n_weight, 0]]
    assert size == sorted(size, reverse=True)
    width = [dict(biases)[slot] for slot in items[n_weight:, 0]]
    assert width == sorted(width, reverse=True)
    assert ring == ptk.run_plan(dims, tied, vae, n_inst, batch, 132, 2,
                                ())[4]
    for mbytes in (2, 4):
        for bad in ((), (weights[0][0],)):
            ring = ptk.run_plan(dims, tied, vae, n_inst, batch, 132, mbytes,
                                bad)[4]
            on = {s for s, R, C in weights if on_ring and s not in bad
                  and pdk.ring_fits(R, C, tile_tx[s], mbytes)}
            assert set(ring.ring) == on
            assert ring.ring_items == int(np.isin(items[:n_weight, 0],
                                                  list(on)).sum())
            assert ring.ring_items + ring.fallback_items == n_weight


def test_update_tiles_of_the_tied_bucket():
    """The tied 1000 -> 100 bucket at a batch of 20 takes the ring path:
    its 1000 x 1000 W1 two strips of 8 x 504 tiles, its 1000 x 100 W2
    whole rows in 40 x 100 tiles (250 of 256 threads busy), both by bulk
    copies; the strip's gradients for two pairs (80,640 B) leave room for
    three stages of 32,256 B of W, m, v and 6,400 B of layer inputs, and
    one gradient buffer.  At the batch of 100 W1 takes 64 x 64 tiles in
    place."""
    _, items, n_weight, tile_tx, ring = ptk.run_plan((1000, 1000, 100),
                                                     True, False, 60, 20, 132)
    assert dict(tile_tx) == {0: 126, 2: 25}
    assert n_weight == 60 * (2 * 125 + 25)
    assert ring == pdk.UpdateRing((0, 2), n_weight, 0, 3, 2 * 20 * 40,
                                  2 * 20 * 504, 1, 8 * 504 * 8)
    assert len(items) - n_weight == 60 * (4 + 1 + 4 + 4)
    _, items, n_weight, tile_tx, ring = ptk.run_plan((1000, 1000, 100),
                                                     True, False, 60, 100, 132)
    assert dict(tile_tx) == {0: 16, 2: 25}
    assert n_weight == 60 * (16 * 16 + 25)
    assert ring == pdk.UpdateRing((), 0, n_weight, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("tied, vae", FAMILIES)
def test_launches_per_step_follow_the_plan(tied, vae):
    """A step is the sample, the planned products, the VAE's two passes
    and one update: 9 tied or untied, 12 for a VAE, kernel 3's count at
    depth 2; launch_bounds has one row a launch."""
    plan = ptk.product_plan((30, 16, 6), tied, vae, 4, 20)
    n = ptk.launches_per_step(tied, vae)
    assert n == 1 + len(plan) + (2 if vae else 0) + 1
    assert n == (12 if vae else 9)
    assert n == pdk.launches_per_step(2, tied, vae)
    cfg = MMAEConfig(num_feats=30, layer_sizes=(16, 6), tie_weights=tied,
                     variational=vae).validate()
    rows = ptk.launch_bounds(cfg, 4, 20, True)
    assert len(rows) == n
    assert rows[0]["name"] == "sample" and rows[-1]["name"] == "update"
    names = [r["name"] for r in rows]
    assert [p["name"] for p in plan] == [x for x in names
                                         if x in ptk.PRODUCT_NAMES]


@pytest.mark.parametrize("moments", [True, False])
@pytest.mark.parametrize("tied, vae", FAMILIES)
def test_launch_bounds_sum_to_the_type_bounds(tied, vae, moments):
    """The per-launch rows against launch_type_bounds: the sample row is
    its type's, the VAE passes split theirs, the update is the weight and
    bias rows together, the products' operations sum to the forward and
    backward rows', and each product reads its own weight, so the forward
    products' bytes sum to at least their row's (which counts a tied
    weight once); every product is bound by bytes."""
    cfg = MMAEConfig(num_feats=1000, layer_sizes=(1000, 100),
                     tie_weights=tied, variational=vae).validate()
    rows = ptk.launch_bounds(cfg, 60, 20, moments)
    types = ptk.launch_type_bounds(cfg, 60, 20, moments)
    assert rows[0]["bytes"] == types["sample_corrupt"]["bytes"]
    assert rows[0]["flop"] == types["sample_corrupt"]["flop"]
    upd = rows[-1]
    for key in ("bytes", "flop"):
        assert upd[key] == pytest.approx(types["weight_grad_adam"][key]
                                         + types["bias_grad_adam"][key])
        vae_rows = [r for r in rows if r["type"] == "vae_elementwise"]
        assert len(vae_rows) == (2 if vae else 0)
        assert sum(r[key] for r in vae_rows) == pytest.approx(
            types["vae_elementwise"][key])
    for kind in ("forward_products", "backward_products"):
        mine = [r for r in rows if r["type"] == kind]
        assert sum(r["flop"] for r in mine) == pytest.approx(
            types[kind]["flop"])
    fwd = [r for r in rows if r["type"] == "forward_products"]
    assert sum(r["bytes"] for r in fwd) >= types["forward_products"]["bytes"]
    assert all(r["bound_by"] == "bytes" for r in rows if "K" in r)
    step = ptk.step_bound(cfg, 60, 20, moments)
    assert sum(r["bound_ms"] for r in rows) >= step["bound_ms"]


def _c_struct_fields(source: str, name: str):
    """(field, kind, count) of a C struct's declarations, kind 'int',
    'float' or 'ptr'."""
    text = open(source).read()
    body = re.search(r"struct " + name + r" \{(.*?)\n\};", text, re.S)
    body = re.sub(r"//[^\n]*", "", body.group(1))
    consts = {"NSLOT": len(ptk.SLOTS), "NBUF": len(ptk.BUFFERS),
              "MAX_PRODUCTS": ptk.MAX_PRODUCTS}
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


def test_train_args_mirror_the_c_struct():
    """ops/train_kernels.TrainArgs mirrors ``struct TrainArgs`` of
    csrc/train_kernel.cu field for field, the plan's fields included."""
    c_fields = _c_struct_fields(SOURCE, "TrainArgs")
    kinds = {ctypes.c_int: "int", ctypes.c_float: "float",
             ctypes.c_void_p: "ptr"}
    py_fields = []
    for name, ctype in ptk.TrainArgs._fields_:
        count = getattr(ctype, "_length_", 1)
        base = getattr(ctype, "_type_", ctype) if hasattr(
            ctype, "_length_") else ctype
        py_fields.append((name, kinds[base], count))
    assert py_fields == c_fields
    for field in ("panel", "tile_tx", "n_items", "n_weight_items",
                  "items", "upd_desc", "upd_ring", "upd_depth",
                  "upd_lfloats", "upd_rfloats", "upd_rbufs", "upd_stage"):
        assert field in {f[0] for f in c_fields}
    text = open(SOURCE).read()
    assert f"MAX_PRODUCTS = {ptk.MAX_PRODUCTS};" in text
    assert len(ptk.SLOTS) <= ptk.UPD_SLOTS
    common = open(os.path.join(os.path.dirname(SOURCE),
                               "train_common.cuh")).read()
    assert f"UPD_SLOTS = {ptk.UPD_SLOTS};" in common
