"""The frozen bounds and FLOP counts against values worked by hand."""

import pytest

from bench_port.yardstick import bounds, flops, peaks


def test_step_bound_tied_by_hand():
    # F 4, H1 3, H2 2, tied, N 1, B 1: weights 12 + 6; params 18 + 6 + 2 +
    # 4 = 30; macs 2*18 + 12 + 12 + 2*18 = 96; flop 2*96 + 10*30 = 492;
    # bytes 30*16 + 4*4 = 496
    b = bounds.step_bound(4, 3, 2, True, False, 1, 1, True)
    assert b["flop"] == 492 and b["bytes"] == 496
    assert b["bound_s"] == pytest.approx(496 / peaks.H100_HBM_BYTES_PER_S)
    assert b["bound_by"] == "bytes"


def test_step_bound_untied_vae_by_hand():
    # untied VAE: weights 18 + 18 + 6 = 42; params 42 + 12 + 2 = 56; macs
    # (36 + 12 + 12 + 12) + (36 + 6) = 114, times 3 instances at batch 2:
    # flop 3 (2*228 + 560) = 3048; bytes f32 moments 3 (56*24 + 32) = 4128
    b = bounds.step_bound(4, 3, 2, False, True, 3, 2, False)
    assert b["flop"] == 3 * (2 * 228 + 560)
    assert b["bytes"] == 3 * (56 * 24 + 4 * 2 * 4)


def test_deep_bound_equals_depth_two():
    for tied, vae in ((True, False), (False, False), (False, True)):
        a = bounds.step_bound(1000, 500, 100, tied, vae, 60, 20, True)
        d = bounds.deep_step_bound([1000, 500, 100], tied, vae, 60, 20, True)
        assert a["flop"] == d["flop"] and a["bytes"] == d["bytes"]


def test_cls_step_bound_by_hand():
    # F 4, H1 3, H2 2, head (5,), 2 labels, no VAE, N 1, B 1: dims
    # [2, 5, 2]; head 10 + 10 = 20; enc 18; params 18 + 20 + 3 + 2 + 7 =
    # 50; macs 38 + 26 + 38 = 102; flop 204 + 500 = 704; bytes 50*16 + 24
    b = bounds.cls_step_bound(4, 3, 2, (5,), 2, False, 1, 1, True)
    assert b["flop"] == 704 and b["bytes"] == 824
    assert b["bound_by"] == "bytes"


def test_reference_scale_bounds_match_the_published_table():
    # PERF.md: tied / untied / VAE 1000 -> 100 at N 60: 0.318 / 0.633 /
    # 0.662 ms; phase 2 of the validation bucket 0.567 ms by operations
    ms = [1e3 * bounds.step_bound(1000, 1000, 100, t, v, 60, 20,
                                  True)["bound_s"]
          for t, v in ((True, False), (False, False), (False, True))]
    assert ms == pytest.approx([0.318, 0.633, 0.662], abs=1e-3)
    c = bounds.cls_step_bound(1000, 1000, 100, (50, 20), 3, False, 80, 100,
                              True)
    assert round(1e3 * c["bound_s"], 3) == 0.567
    assert c["bound_by"] == "operations"


def test_train_step_flops_by_hand():
    # F 4, H1 3, H2 2, B 1, tied: fwd 2(12+6+6+12) = 72, bwd data
    # 2(12+6+6) = 48, weight grads 72: mxu 192
    f = flops.train_step_flops(4, 3, 2, True, False, 1)
    assert f["mxu"] == 192
    assert f["adam_elems"] == 18 + 12
    v = flops.train_step_flops(4, 3, 2, False, True, 1)
    assert v["mxu"] == 192 + 3 * 12
    assert v["adam_elems"] == 36 + 6 + 12 + 2


def test_cls_train_step_flops_by_hand():
    # F 4, H1 3, H2 2, head (5,), 2 labels, B 1: fwd 2(12+6) + 2*20 = 76;
    # bwd 2*40 + 2(6+12+6) = 128
    f = flops.cls_train_step_flops(4, 3, 2, (5,), 2, False, 1)
    assert f["mxu"] == 76 + 128
