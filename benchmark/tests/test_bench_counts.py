"""The benchmark's counts against the figures PERF.md derived by hand
(bytes at 3.35 TB/s, operations at 989 TFLOP/s or 1,979 TOP/s) and the
port's own FLOP census (tools/train_flops.py)."""

import pytest

from benchmark.counts import int8, lookup, model


def test_b1_bound():
    assert lookup.b1_bytes(196_608) == 177_012_736
    assert lookup.b1_bound_s(196_608) * 1e3 == pytest.approx(0.0528, abs=5e-5)
    assert lookup.b1_bound_s(4_096) * 1e3 == pytest.approx(0.00112, abs=5e-6)


def test_b2_bound():
    assert lookup.b2_bytes(4_096) == 3_818_496
    assert lookup.b2_bound_s(4_096) * 1e3 == pytest.approx(0.00114, abs=5e-6)
    assert lookup.b2_bound_s(196_608) * 1e3 == pytest.approx(0.0529, abs=5e-5)


NET = {"net_tag": "unet_vq_twostream", "in_channel": [12, 6],
       "out_channel": [3, 2], "embed_dim": 64, "n_embed": 256, "k": 2}


def test_int8_forward_bounds():
    convs = int8.forward_convs()
    assert int8.calls(NET, False, 256) == 34
    assert int8.calls(NET, True, 256) == 6
    assert int8.forward_bound_s(176, False, NET, 256) * 1e3 == pytest.approx(
        16.08, abs=0.005)
    assert int8.forward_bound_s(176, True, NET, 256) * 1e3 == pytest.approx(
        1.93, abs=0.005)
    by_name = {c[0]: c for c in convs}
    from benchmark.counts.peaks import INT8_OPS, bound_s

    for name, ms in (("rgb.inc.conv.conv.0", 0.262),
                     ("rgb.up1.conv.conv.0", 0.859), ("rgb.up1.up", 0.138),
                     ("rgb.up3.up", 0.551)):
        got = bound_s(*int8.conv_ops_bytes(by_name[name], 176), INT8_OPS)
        assert got * 1e3 == pytest.approx(ms, abs=0.0005)
    # the first convolution of each DoubleConv writes int8, no other
    assert {c[0] for c in convs if c[5]} == {
        c[0] for c in convs if c[0].endswith(".conv.0")}
    assert sum(c[5] for c in convs) == 16


def test_unknown_net_tag_raises():
    with pytest.raises(ValueError, match="no generator"):
        model.build_generator(dict(NET, net_tag="unet"), True)


def test_model_flops_match_the_census():
    assert model.generator_forward_flops() * 4 / 1e12 == pytest.approx(
        0.672, abs=0.0005)
    assert model.train_step_flops(4) / 1e12 == pytest.approx(2.439,
                                                             abs=0.0005)
    assert model.flownet_pair_flops() * 4 / 1e12 == pytest.approx(0.068,
                                                                  abs=0.0005)
