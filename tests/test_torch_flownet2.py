"""PyTorch port: FlowNet 2.0 (``models/flownet2.py``) and its correlation
(``ops/correlation.py``, ``ammcnet::correlation``) on the CPU.

The JAX package has no FlowNet 2.0, so the port is held to the
benchmark's plain float32 reference (``benchmark/reference/flownet2.py``,
written from flownet2-pytorch, importing nothing of the port) on seeded
random weights, the correlation on its plain route:

* the whole network at 64x64 and 128x128, the reference's state dict
  loaded into the port by name, and once the port's into the reference:
  within 1e-4 of the largest |flow| (float32 on both sides with the same
  weights; the two differ in the order of the correlation's channel sums,
  in FlowNetC's batched towers and in the warp's coordinates, which
  ``grid_sample`` normalizes and takes back, about 1e-7 of a pixel; 40-odd
  layers of five stacked networks and the warps' data-dependent sampling
  carry that to about 2e-5 of the largest |flow|, measured on four seeds);
* the warp against Resample2d's arithmetic (the reference's) with flows
  that point out of the frame: 1e-5 (values below 1; the fractions taken
  from the clamped or the unclamped coordinate weigh the same pixels);
* the correlation's channel order (dy outer, dx inner) on one-hot maps,
  exactly, on the plain wrapper, the registered op and the reference, and
  the op under ``torch.library.opcheck``;
* the parameter count, ``flownets_d``'s class, the seeded init, the
  sides it refuses, and ``torch.export`` of FlowNetC seeing one
  ``ammcnet::correlation`` node;
* ``run_test --on_the_fly_flow --flownet FlowNet2`` on a 64x64 toy tree.

Nothing here imports JAX.
"""

import json
import os

import numpy as np
import pytest
import torch

from ammcnet_aaai2021_torch.models import (FlowNet2, FlowNet2SD, FlowNetSD,
                                           init_flownet_weights)
from ammcnet_aaai2021_torch.models.flownet2 import FlowNetC, warp
from ammcnet_aaai2021_torch.ops import correlation as corr_ops
from ammcnet_aaai2021_torch.ops import library
from ammcnet_aaai2021_torch.runners import run_test
from benchmark import seeding
from benchmark.reference import flownet2 as ref

FLOW_REL = 1e-4  # of the largest |flow|: the module's note
PARAMETERS = 162_518_834  # flownet2-pytorch's FlowNet2
PARTS = {"flownetc": 39_175_298, "flownets_1": 38_695_322,
         "flownets_2": 38_695_322, "flownets_d": 45_371_666,
         "flownetfusion": 581_226}


def _pairs(n, size, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, 3, 2, size, size, generator=g) * 255


@pytest.mark.parametrize("size, direction", [(64, "into_port"),
                                             (128, "into_port"),
                                             (64, "into_reference")])
def test_flownet2_matches_the_reference(size, direction):
    reference = ref.FlowNet2().eval()
    port = FlowNet2(dtype=torch.float32).eval()
    if direction == "into_port":
        state = seeding.make_state(reference, size, "flownet", "cpu")
        seeding.load_state(reference, state)
        port.load_state_dict(state)
    else:
        init_flownet_weights(port, torch.Generator().manual_seed(size))
        with torch.no_grad():
            for name, p in port.named_parameters():
                if name.endswith("bias"):
                    p.normal_(0, 0.01)
        reference.load_state_dict(port.state_dict())
    x = _pairs(2, size, seed=size + 1)
    plain = corr_ops.correlation.launches_by_route["plain"]
    with torch.no_grad():
        got, want = port(x), reference(x)
    assert corr_ops.correlation.launches_by_route["plain"] == plain + 1
    assert got.shape == want.shape == (2, 2, size, size)
    assert got.dtype == torch.float32
    scale = want.abs().max()
    assert scale > 1.0  # the flows are not trivially small
    assert (got - want).abs().max() <= FLOW_REL * scale


@pytest.mark.parametrize("pixels", [0.5, 6.0, 40.0])
def test_warp_matches_resample2d_out_of_the_frame(pixels):
    g = torch.Generator().manual_seed(int(pixels * 10))
    img = torch.rand(2, 3, 16, 24, generator=g)
    flow = torch.randn(2, 2, 16, 24, generator=g) * pixels
    xs = torch.arange(24) + flow[:, 0]
    ys = torch.arange(16)[:, None] + flow[:, 1]
    outside = (xs < 0) | (xs > 23) | (ys < 0) | (ys > 15)
    if pixels > 1:
        assert outside.float().mean() > 0.1
    torch.testing.assert_close(warp(img, flow), ref.resample2d(img, flow),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("dy, dx", [(0, 0), (-20, 6), (4, -18), (20, 20),
                                    (-2, 2)])
def test_correlation_channel_order_is_dy_outer(dy, dx):
    c, h, w = 32, 48, 48
    y, x, ch = 22, 21, 5
    f1 = torch.zeros(1, c, h, w)
    f2 = torch.zeros(1, c, h, w)
    f1[0, ch, y, x] = 1.0
    f2[0, ch, y + dy, x + dx] = 1.0
    want = torch.zeros(1, 441, h, w)
    want[0, (dy + 20) // 2 * 21 + (dx + 20) // 2, y, x] = 1.0 / c
    for fn in (lambda a, b: corr_ops.correlation(a, b),
               lambda a, b: library.correlation(a, b), ref.correlation):
        assert torch.equal(fn(f1, f2), want)


def test_correlation_leaky_and_bf16_plain_route():
    g = torch.Generator().manual_seed(3)
    f1 = torch.randn(2, 16, 8, 16, generator=g).to(torch.bfloat16)
    f2 = torch.randn(2, 16, 8, 16, generator=g).to(torch.bfloat16)
    raw = ref.correlation(f1.float(), f2.float())
    out = corr_ops.correlation(f1, f2, leaky=True)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, torch.nn.functional.leaky_relu(raw, 0.1).to(
        torch.bfloat16))
    with pytest.raises(ValueError, match="one shape"):
        corr_ops.correlation(f1, f2[:, :8])


@pytest.mark.parametrize("dtype, leaky", [(torch.float32, False),
                                          (torch.bfloat16, True)])
def test_correlation_op_passes_opcheck(dtype, leaky):
    g = torch.Generator().manual_seed(5)
    f1, f2 = (torch.randn(2, 16, 8, 8, generator=g).to(dtype)
              for _ in range(2))
    torch.library.opcheck(torch.ops.ammcnet.correlation.default,
                          (f1, f2, leaky))
    assert torch.equal(library.correlation(f1, f2, leaky),
                       corr_ops.correlation(f1, f2, leaky))


def test_parameter_count_and_parts():
    with torch.device("meta"):
        net = FlowNet2()
    assert sum(p.numel() for p in net.parameters()) == PARAMETERS
    assert {n: sum(p.numel() for p in getattr(net, n).parameters())
            for n in PARTS} == PARTS
    assert type(net.flownets_d) is FlowNetSD
    # flownet2-pytorch's names, which its checkpoint's state dict carries
    names = set(net.state_dict())
    assert {"flownetc.conv_redir.0.weight", "flownetc.conv3_1.0.weight",
            "flownets_1.upsampled_flow6_to_5.weight",
            "flownets_d.inter_conv2.0.weight",
            "flownetfusion.inter_conv0.0.bias"} <= names
    assert "flownets_2.upsampled_flow3_to_2.bias" not in names
    assert "flownetc.upsampled_flow3_to_2.bias" in names


def test_init_covers_every_convolution():
    net = init_flownet_weights(FlowNet2(), torch.Generator().manual_seed(0))
    convs = [m for m in net.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    assert len(convs) == 114
    for m in convs:
        fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
        assert abs(m.weight.std().item() * fan_in ** 0.5 - 1) < 0.5
        assert m.bias is None or not m.bias.any()


@pytest.mark.parametrize("size", [(64, 96), (100, 128)])
def test_sides_not_multiples_of_64_raise(size):
    net = FlowNet2(dtype=torch.float32).eval()
    with pytest.raises(ValueError, match="multiples of 64"):
        net(torch.zeros(1, 3, 2, *size))


def test_export_sees_one_correlation_node():
    net = init_flownet_weights(FlowNetC(), torch.Generator().manual_seed(2))
    x = torch.randn(2, 6, 64, 64)
    exported = torch.export.export(net.eval(), (x,))
    targets = [n.target for n in exported.graph.nodes
               if n.op == "call_function"]
    assert targets.count(torch.ops.ammcnet.correlation.default) == 1
    with torch.no_grad():
        assert torch.equal(exported.module()(x), net(x))


@pytest.fixture(scope="module")
def toy_tree(tmp_path_factory):
    """A video of 12 64x64 u8 .npy frames, with toydata.json labels (no
    flows: they are made on the fly)."""
    root = str(tmp_path_factory.mktemp("flownet2_toy"))
    g = np.random.default_rng(12)
    labels = {}
    for vi, name in enumerate(("01",)):
        fdir = os.path.join(root, "toydata", "testing", "frames", name)
        os.makedirs(fdir)
        for t in range(12):
            np.save(os.path.join(fdir, f"{t:03d}.npy"),
                    g.integers(0, 255, (64, 64, 3), np.uint8))
        labels[name] = {"length": 12, "gt": [[3 + vi, 8]]}
    with open(os.path.join(root, "toydata", "toydata.json"), "w") as fh:
        json.dump(labels, fh)
    return root


def test_run_test_scores_with_flownet2(toy_tree, tmp_path, capsys):
    import pickle

    res = run_test.main(["--dataset_name", "toydata", "--data_dir", toy_tree,
                         "--save_dir", str(tmp_path), "--device", "cpu",
                         "--on_the_fly_flow", "--flownet", "FlowNet2"])
    # 63 pairs a video, FlowNet 2.0's 32 a forward
    assert res["flownet_forwards"] == 2
    assert np.isfinite(res["auc"])
    assert "the optimal auc = " in capsys.readouterr().out
    with open(res["pickle"], "rb") as fh:
        records = pickle.load(fh)
    assert all(len(r) == 12 and np.isfinite(r).all()
               for key in ("rgb_img_pred_records", "op_img_pred_records")
               for r in records[key])



class _PairCounter(torch.nn.Module):
    """A stand-in flow network: zero flows, the pairs of each forward
    kept."""

    def __init__(self, pairs_per_forward=None):
        super().__init__()
        if pairs_per_forward is not None:
            self.pairs_per_forward = pairs_per_forward
        self.batches = []

    def forward(self, frames):
        self.batches.append(frames.shape[0])
        return frames.new_zeros(frames.shape[0], 2, *frames.shape[-2:])


@pytest.mark.parametrize("own, chunk, want", [
    (FlowNet2.pairs_per_forward, None, 32),
    (FlowNet2SD.pairs_per_forward, None, 16),
    (None, None, 16),
    (FlowNet2.pairs_per_forward, 16, 16),
])
def test_extractor_takes_the_networks_pairs_a_forward(own, chunk, want):
    """The extractor's pairs a forward follow the network (FlowNet 2.0 32,
    FlowNet2-SD 16, a network that names none 16) unless given; a padded
    192-frame video's 191 pairs end in a ragged forward."""
    from ammcnet_aaai2021_torch.eval.infer import make_otf_flow_extractor

    net = _PairCounter(own)
    extract = make_otf_flow_extractor(net, chunk=chunk, gray=True)
    extract(torch.zeros(192, 8, 8, 1, dtype=torch.uint8))
    assert net.batches == [want] * (191 // want) + [191 % want]
    assert extract.forwards == len(net.batches)


def test_pairs_a_forward_of_the_networks():
    """FlowNet 2.0 takes 32 pairs a forward (at 16 the host's enqueue paced
    the card), FlowNet2-SD its 16 as before."""
    assert FlowNet2.pairs_per_forward == 32
    assert FlowNet2SD.pairs_per_forward == 16


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_checks_every_correlation_of_a_forward():
    """``chip_smoke.py``'s recorder sees the forward's correlation call
    through the name ``models/flownet2.py`` calls, holds it against the
    plain version and restores the name."""
    from ammcnet_aaai2021_torch.models import flownet2

    smoke = _chip_smoke()
    net = init_flownet_weights(FlowNet2(dtype=torch.float32),
                               torch.Generator().manual_seed(0)).eval()
    called = flownet2.correlation
    with smoke.CorrelationRecorder() as rec, torch.no_grad():
        net(torch.rand(2, 3, 2, 64, 64) * 255)
    assert flownet2.correlation is called
    assert [c["batch"] for c in rec.calls] == [2]
    assert rec.calls[0]["share_of_rounding"] == 0.0
    assert rec.calls[0]["bitwise_share"] == 1.0
    assert set(rec.kept) == {2} and rec.kept[2][0].shape == (2, 256, 8, 8)


def test_chip_smoke_fails_a_correlation_off_its_plain_version(monkeypatch):
    from ammcnet_aaai2021_torch.models import flownet2

    smoke = _chip_smoke()
    g = torch.Generator().manual_seed(1)
    f1, f2 = (torch.randn(2, 32, 8, 8, generator=g).to(torch.bfloat16)
              for _ in range(2))
    plain = flownet2.correlation
    monkeypatch.setattr(flownet2, "correlation",
                        lambda a, b, leaky=False: plain(a, b, leaky) * 1.05)
    with pytest.raises(SystemExit), smoke.CorrelationRecorder():
        flownet2.correlation(f1, f2, True)


@pytest.mark.parametrize("batch", [32, 31, 16])
def test_chip_smoke_correlation_bound_is_the_benchmarks(batch):
    from benchmark.counts import flownet2 as flow_counts

    row = _chip_smoke().correlation_bound(batch, 256, 32, 32)
    assert row["bound_by"] == "bytes"
    assert row["bound_ms"] == pytest.approx(
        1e3 * flow_counts.correlation_bound_s(batch), rel=1e-12)
