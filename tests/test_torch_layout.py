"""PyTorch port: the generator's memory layout follows its input.

On a CUDA device the memory-augmented streams enter channels-last
(``models/blocks.py:to_compute``); on the CPU they keep the input's layout,
so a channels-last input drives here the path the card runs and an NCHW
one the path the JAX parity tests hold.

* every ``Conv2d`` / ``ConvTranspose2d`` of ``TwoStreamUNetMem`` (each
  bridge kind, eval and train mode) sees and returns its input's layout,
  and the predictions leave float32 and NCHW-contiguous either way, the
  two layouts' outputs within float32 summation order of each other;
* ``TopKMemory`` hands ``q_topk`` back in its input's layout, values equal;
* ``blocks.Conv2d`` / ``ConvTranspose2d`` on an NCHW input are bitwise the
  plain functional convolution with the parameters cast;
* a channels-last stream input is padded with zero channels to a multiple
  of 8, which the first convolution meets with zero weights;
* the counters ``conv.layout.nhwc`` / ``.nchw`` count calls by layout while
  a profiler runs, and nothing without one.

Small sizes: 32x32 frames at the released widths, 16 codewords.
"""

import pytest
import torch
import torch.nn.functional as F

from ammcnet_aaai2021_torch.models import TopKMemory, TwoStreamUNetMem
from ammcnet_aaai2021_torch.models.blocks import (Conv2d, ConvTranspose2d,
                                                  is_channels_last,
                                                  to_compute)
from ammcnet_aaai2021_torch.models.unet_mem import BRIDGES
from ammcnet_aaai2021_torch.utils import profiling

torch.set_num_threads(2)

CONVS = (Conv2d, ConvTranspose2d)
LAYOUTS = {"channels_last": torch.channels_last,
           "nchw": torch.contiguous_format}
# float32 convolutions in NHWC and NCHW order their sums differently
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _clean_registry():
    profiling.reset()
    yield
    profiling.reset()


def _generator(bridge_kind: str, train: bool) -> TwoStreamUNetMem:
    torch.manual_seed(3)
    net = TwoStreamUNetMem(n_embed=16, k=2, dtype=torch.float32,
                           bridge_kind=bridge_kind)
    return net.train(train)


def _inputs(layout: str):
    g = torch.Generator().manual_seed(5)
    rgb = torch.rand(2, 12, 32, 32, generator=g) * 2 - 1
    op = torch.randn(2, 6, 32, 32, generator=g)
    fmt = LAYOUTS[layout]
    return (rgb.contiguous(memory_format=fmt),
            op.contiguous(memory_format=fmt))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("bridge_kind", sorted(BRIDGES))
def test_every_convolution_runs_in_the_inputs_layout(bridge_kind, train,
                                                     layout):
    net = _generator(bridge_kind, train)
    want = layout == "channels_last"
    seen = []

    def hook(module, args, out):
        seen.append((type(module).__name__, is_channels_last(args[0]),
                     is_channels_last(out)))

    for m in net.modules():
        if isinstance(m, CONVS):
            m.register_forward_hook(hook)
    rgb_pred, op_pred, diffs, codes = net(*_inputs(layout))
    n_convs = sum(isinstance(m, CONVS) for m in net.modules())
    assert len(seen) == n_convs
    assert all(i == want and o == want for _, i, o in seen), seen
    for pred, c in ((rgb_pred, 3), (op_pred, 2)):
        assert pred.dtype == torch.float32 and pred.is_contiguous()
        assert pred.shape == (2, c, 32, 32)
    if train:
        (rgb_pred.mean() + op_pred.mean() + sum(diffs)).backward()
        assert all(p.grad is not None for p in net.parameters())


@pytest.mark.parametrize("bridge_kind", sorted(BRIDGES))
def test_both_layouts_give_the_same_predictions(bridge_kind):
    with torch.no_grad():
        outs = [_generator(bridge_kind, False)(*_inputs(layout))
                for layout in sorted(LAYOUTS)]
    (cl_r, cl_o, cl_d, cl_c), (n_r, n_o, n_d, n_c) = outs
    for a, b in ((cl_r, n_r), (cl_o, n_o), *zip(cl_d, n_d), *zip(cl_c, n_c)):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_memory_returns_its_inputs_layout(layout, train):
    g = torch.Generator().manual_seed(7)
    z = torch.randn(2, 16, 4, 4, generator=g)
    outs = {}
    for name, fmt in LAYOUTS.items():
        torch.manual_seed(1)
        mem = TopKMemory(16, 32, k=2).train(train)
        outs[name] = mem(z.contiguous(memory_format=fmt))
    q_topk = outs[layout][0]
    assert is_channels_last(q_topk) == (layout == "channels_last")
    assert q_topk.is_contiguous(memory_format=LAYOUTS[layout])
    for a, b in zip(outs["channels_last"], outs["nchw"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cls", CONVS)
def test_convolution_on_nchw_is_the_plain_one_bitwise(cls, dtype):
    torch.manual_seed(2)
    conv = cls(8, 6, 3 if cls is Conv2d else 2,
               **({"padding": 1} if cls is Conv2d else {"stride": 2}))
    x = torch.randn(2, 8, 9, 9).to(dtype)
    w, b = conv.weight.to(dtype), conv.bias.to(dtype)
    plain = (F.conv2d(x, w, b, padding=1) if cls is Conv2d
             else F.conv_transpose2d(x, w, b, stride=2))
    got = conv(x)
    assert got.is_contiguous() and torch.equal(got, plain)


@pytest.mark.parametrize("channels,aligned", [(6, 8), (12, 16), (16, 16)])
def test_to_compute_pads_channels_last_and_keeps_cpu_nchw(channels, aligned):
    x = torch.randn(2, channels, 5, 5)
    assert to_compute(x) is x
    y = to_compute(x, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and y.is_contiguous()
    cl = to_compute(x.contiguous(memory_format=torch.channels_last),
                    torch.bfloat16)
    assert cl.dtype == torch.bfloat16 and is_channels_last(cl)
    assert cl.shape == (2, aligned, 5, 5)
    assert torch.equal(cl[:, :channels], y)
    assert not cl[:, channels:].any()


def test_convolution_meets_padded_channels_with_zero_weights():
    torch.manual_seed(4)
    conv = Conv2d(12, 8, 3, padding=1)
    x = torch.randn(2, 12, 6, 6)
    padded = to_compute(x.contiguous(memory_format=torch.channels_last))
    assert padded.shape[1] == 16
    got = conv(padded)
    assert is_channels_last(got)
    torch.testing.assert_close(got, conv(x), rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError):
        conv(torch.randn(2, 16, 6, 6))  # NCHW: not to_compute's padding


def test_counters_count_convolutions_by_layout_under_a_profiler(tmp_path):
    conv = Conv2d(4, 4, 3, padding=1)
    x = torch.randn(1, 4, 6, 6)
    with torch.no_grad():
        conv(x)
        conv(x.contiguous(memory_format=torch.channels_last))
        assert profiling.counts() == {}
        with profiling.device_trace(str(tmp_path)):
            conv(x)
            conv(x)
            conv(x.contiguous(memory_format=torch.channels_last))
    assert profiling.counts() == {"conv.layout.nchw": 2,
                                  "conv.layout.nhwc": 1}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_counters_count_every_generator_convolution(tmp_path, layout):
    net = _generator("amft", False)
    n_convs = sum(isinstance(m, CONVS) for m in net.modules())
    with torch.no_grad(), profiling.device_trace(str(tmp_path)):
        net(*_inputs(layout))
    name = "nhwc" if layout == "channels_last" else "nchw"
    assert profiling.counts() == {f"conv.layout.{name}": n_convs}
    assert n_convs == 44  # 20 a stream, 4 in the AMFT bridge
