"""PyTorch port: the CUDA kernels on the card.

Every test here needs an NVIDIA GPU and ``nvcc``, and skips without one.
The file imports nothing of JAX, so it also runs on a machine without JAX;
the repository's ``conftest.py`` imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The GPU JPEG route (``data/native.py``: the port's Huffman decode and
block smoothing, then the IDCT, colour and resize kernels) is held against
its plain versions bitwise (the resize on a sweep of random sizes too),
against the host libjpeg route's decode of the committed fixture bitwise
(grayscale frames as three channels, C5; smoothed progressive files, C6;
truncated files, C7) and against cv2's within 1 LSB
(``tests/fixtures/torch_jpeg``); the IDCT on a seeded sweep of
geometries, the colour kernel on chunks of each subsampling, and a colour
chunk's one colour launch.
A remat stage-2 step at full width is held against the plain step, and
a JAX-format ``.msgpack`` generator against its weights through B1.
Under a process group of one rank (NCCL), the group BatchNorm is held
against the plain one (two-pass float32 statistics against ATen's: 1e-5)
and the group lookup on B2 against the lookup without a group (bitwise:
one rank's all-reduce returns its input).
The int8 convolution kernels are held against their plain versions
bitwise: accumulators and epilogue; so is the int8 quantize kernel, at
the shapes and layouts of the forward's 24 statically quantized inputs,
and a calibrated forward through it scores as through its plain version;
the int8 calibration reads JPEG training frames through the GPU route as
its plain pipeline reads them.
The registered ops (``ops/library.py``) launch their kernels, counted, and
return the wrappers' outputs bitwise; a scorer exported on the card runs
B1 inside the loaded graph, equals the live scorer and refuses the CPU.
FlowNet 2.0's correlation kernel is held against its plain version at the
published shape (16, 256, 32, 32), at a ragged batch and at narrow maps:
the products of two bf16 values are exact in float32, so the kernel's and
the plain version's float32 sums differ only in their order, each within
C * 2^-24 of the sum of the products' magnitudes over C (the float32
summation bound), and then one bf16 rounding (2^-8 of the value) apart.
One FlowNet 2.0 forward launches it once, and ``torch.export`` of the
network on the card holds one ``ammcnet::correlation`` node that runs it.
The bf16 generator runs channels-last on the card: in eval mode and in a
train-mode forward and backward no cuDNN layout transpose runs, every
convolution counts ``conv.layout.nhwc``, and each window's commit distance
stays within the bf16 scoring cell's limits of the float32 generator's.

Near-ties: the kernel and the plain version sum the same fp32 products in
another order (B1's tensor-core route sums three bf16 split products), so a
top-k index may flip where two codewords lie at almost the same distance;
rows whose indices agree must match bitwise.  Kernel
B2's counts must equal the histogram of its own top-1 indices, and its
embed_sum the plain sum over those indices within 1e-5 of the magnitude
summed into each entry (another summation order).
"""

import copy
import os

import numpy as np
import pytest
import torch

from ammcnet_aaai2021_torch.configs import LossConfig, NetConfig, OptimConfig
from ammcnet_aaai2021_torch.data import native
from ammcnet_aaai2021_torch.data.kernel_sweeps import (
    IDCT_SWEEP,
    idct_sweep,
    ycc_sweep,
)
from ammcnet_aaai2021_torch.models import (
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    TopKMemory,
    build_generator,
    build_model,
    init_flownet_weights,
    init_weights,
)
from ammcnet_aaai2021_torch.ops import correlation as corr_ops
from ammcnet_aaai2021_torch.ops import int8_kernels as ik
from ammcnet_aaai2021_torch.ops import memory_kernels
from ammcnet_aaai2021_torch.ops.memory import Codebook, quantize_topk
from ammcnet_aaai2021_torch.ops.memory_kernels import (
    CUDA_CORE,
    TENSOR_CORE,
    quantize_topk_fused,
    quantize_topk_fused_ref,
    quantize_topk_train_fused,
    quantize_topk_train_fused_ref,
)
from ammcnet_aaai2021_torch.train.state import create_train_state
from ammcnet_aaai2021_torch.train.steps import (
    codebook_buffers,
    make_twostream_train_step,
)

DIM, K = 64, 2
# B2's embed_sum against a float64 sum: within this much of the magnitude
# summed into each entry (float32 sums in another order)
ESUM_REL = 1e-5
# a top-k index may differ from the plain version's only where the two
# codewords' float64 distances differ by less than this (chip_smoke.py)
NEAR_TIE_REL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_embed", [64, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda_device, dtype, n_embed):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    flat = torch.randn(1037, DIM, device=cuda_device, generator=g).to(dtype)
    embed = torch.randn(DIM, n_embed, device=cuda_device, generator=g)
    before = quantize_topk_fused.launches
    q, q1, idx = quantize_topk_fused(flat, embed, K)
    torch.cuda.synchronize()
    assert quantize_topk_fused.launches == before + 1
    rq, rq1, ridx = quantize_topk_fused_ref(flat, embed, K)
    agree = (idx == ridx) & (q == rq).all(dim=1)
    assert int((~agree).sum()) <= 2  # near-ties only, at this size
    assert torch.equal(q[agree], rq[agree]) and torch.equal(q1[agree], rq1[agree])


@pytest.mark.cuda
def test_kernel_lowest_index_wins_ties(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(8)
    flat = torch.randn(4096, DIM, device=cuda_device, generator=g)
    embed = torch.randn(DIM, 256, device=cuda_device, generator=g)
    embed[:, 1::2] = embed[:, 0::2]  # every distance ties in pairs
    q, _, idx = quantize_topk_fused(flat, embed, K)
    assert not bool((idx % 2).any())
    assert torch.equal(q[:, :DIM], q[:, DIM:])  # round 2 takes the twin


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("n_embed", [64, 256, 512])
def test_tensor_core_route_matches_plain_version(cuda_device, n_embed, k):
    g = torch.Generator(device=cuda_device).manual_seed(12)
    flat = torch.randn(1037, DIM, device=cuda_device,  # ragged: not 32 | N
                       generator=g).to(torch.bfloat16)
    embed = torch.randn(DIM, n_embed, device=cuda_device, generator=g)
    before = dict(quantize_topk_fused.launches_by_route)
    q, q1, idx = quantize_topk_fused(flat, embed, k)
    torch.cuda.synchronize()
    assert quantize_topk_fused.launches_by_route == {
        TENSOR_CORE: before[TENSOR_CORE] + 1, CUDA_CORE: before[CUDA_CORE]}
    rq, rq1, ridx = quantize_topk_fused_ref(flat, embed, k)
    assert q.shape == (1037, k * DIM) and torch.equal(q1, q[:, :DIM])
    agree = (idx == ridx) & (q == rq).all(dim=1)
    assert int((~agree).sum()) <= 2  # near-ties only, at this size
    assert torch.equal(q[agree], rq[agree]) and torch.equal(q1[agree], rq1[agree])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_tensor_core_route_lowest_index_wins_ties(cuda_device, k):
    g = torch.Generator(device=cuda_device).manual_seed(13)
    flat = torch.randn(4099, DIM, device=cuda_device,
                       generator=g).to(torch.bfloat16)
    embed = torch.randn(DIM, 256, device=cuda_device, generator=g)
    embed[:, 1::2] = embed[:, 0::2]  # every distance ties in pairs
    before = quantize_topk_fused.launches_by_route[TENSOR_CORE]
    q, _, idx = quantize_topk_fused(flat, embed, k)
    assert quantize_topk_fused.launches_by_route[TENSOR_CORE] == before + 1
    assert not bool((idx % 2).any())
    if k == 2:
        assert torch.equal(q[:, :DIM], q[:, DIM:])  # round 2 takes the twin


@pytest.mark.cuda
def test_routes_agree_and_cuda_core_route_is_forced(cuda_device):
    """bf16 latents through both kernels: the CUDA-core kernel when asked
    for it; the two agree but for near-ties."""
    g = torch.Generator(device=cuda_device).manual_seed(14)
    flat = torch.randn(8192, DIM, device=cuda_device,
                       generator=g).to(torch.bfloat16)
    embed = torch.randn(DIM, 256, device=cuda_device, generator=g)
    before = dict(quantize_topk_fused.launches_by_route)
    launches = quantize_topk_fused.launches
    tc = quantize_topk_fused(flat, embed, K)
    cc = quantize_topk_fused(flat, embed, K, route=CUDA_CORE)
    torch.cuda.synchronize()
    assert quantize_topk_fused.launches == launches + 2
    assert quantize_topk_fused.launches_by_route == {
        TENSOR_CORE: before[TENSOR_CORE] + 1,
        CUDA_CORE: before[CUDA_CORE] + 1}
    agree = (tc[2] == cc[2]) & (tc[0] == cc[0]).all(dim=1)
    assert int((~agree).sum()) <= 2
    assert torch.equal(tc[0][agree], cc[0][agree])


@pytest.mark.cuda
def test_tensor_core_route_rejects_misaligned_latents(cuda_device):
    """cp.async copies 16-byte chunks: latents 2 bytes off raise."""
    store = torch.zeros(64 * 65, device=cuda_device, dtype=torch.bfloat16)
    flat = store[1:1 + 64 * 64].view(64, DIM)
    embed = torch.randn(DIM, 256, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        quantize_topk_fused(flat, embed, K)


def _assert_lookup(flat, embed, k, out, max_flips=None):
    """B1's outputs (or B2's lookup) against the plain version: rows whose
    indices agree bitwise equal, at most ``max_flips`` other rows (by
    default 1 %), and in each of them every differing round's two codewords
    a near-tie in float64."""
    q, q1, idx = out[:3]
    dim = flat.shape[1]
    rq, rq1, ridx = quantize_topk_fused_ref(flat, embed, k)
    assert q.shape == rq.shape and torch.equal(q1, q[:, :dim])
    agree = (idx == ridx) & (q == rq).all(dim=1)
    assert torch.equal(q[agree], rq[agree]) and torch.equal(q1[agree], rq1[agree])
    if max_flips is None:
        max_flips = max(2, flat.shape[0] // 100)
    assert int((~agree).sum()) <= max_flips
    z = flat[~agree].double()
    for j in range(k):
        words = [t[~agree, j * dim:(j + 1) * dim].double() for t in (q, rq)]
        da, db = ((z - w).square().sum(1) for w in words)
        gap = (da - db).abs() / torch.maximum(da, db).clamp_min(1e-300)
        assert bool((gap < NEAR_TIE_REL).all()), float(gap.max())


@pytest.mark.cuda
def test_kernel_takes_a_codebook_over_the_shared_memory_of_a_block(cuda_device):
    """A (512, 512) codebook (1 MiB) streams through shared memory in
    chunks: it runs on the CUDA-core route and matches the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(19)
    flat = torch.randn(517, 512, device=cuda_device, generator=g)
    embed = torch.randn(512, 512, device=cuda_device, generator=g)
    before = quantize_topk_fused.launches_by_route[CUDA_CORE]
    out = quantize_topk_fused(flat, embed, K)
    torch.cuda.synchronize()
    assert quantize_topk_fused.launches_by_route[CUDA_CORE] == before + 1
    _assert_lookup(flat, embed, K, out)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,n_embed,k", [(64, 100, 2), (64, 1024, 2),
                                           (128, 1024, 8), (128, 100, 1),
                                           (64, 37, 8), (100, 300, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_core_route_takes_any_codebook_size(cuda_device, dtype, dim,
                                                 n_embed, k):
    """Non-powers of two, n_embed over the old 512, k up to 8, other widths,
    a ragged N: the CUDA-core route against the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(20)
    flat = torch.randn(1037, dim, device=cuda_device, generator=g).to(dtype)
    embed = torch.randn(dim, n_embed, device=cuda_device, generator=g)
    before = quantize_topk_fused.launches_by_route[CUDA_CORE]
    out = quantize_topk_fused(flat, embed, k, route=CUDA_CORE)
    torch.cuda.synchronize()
    assert quantize_topk_fused.launches_by_route[CUDA_CORE] == before + 1
    _assert_lookup(flat, embed, k, out)


@pytest.mark.cuda
def test_cuda_core_route_lowest_index_wins_ties_across_chunks(cuda_device):
    """Codeword j + 512 equals codeword j: every tie spans two chunks, and
    the lower index wins both rounds' picks in order."""
    g = torch.Generator(device=cuda_device).manual_seed(21)
    flat = torch.randn(2048, DIM, device=cuda_device, generator=g)
    half = torch.randn(DIM, 512, device=cuda_device, generator=g)
    embed = torch.cat([half, half], dim=1)
    q, _, idx = quantize_topk_fused(flat, embed, K)
    assert bool((idx < 512).all())
    assert torch.equal(q[:, :DIM], q[:, DIM:])  # round 2 takes the twin


@pytest.mark.cuda
def test_cuda_core_route_names_its_limits(cuda_device):
    """The general route streams the codebook and the rows 64 dims at a
    time, and past shared memory keeps k > 8's running lists in device
    memory: the lookup has no limit of width, n_embed or k (k = n_embed =
    1,600 runs, every distance a tie, so the indices come in order).  Shared
    memory limits B2's statistics kernel, whose blocks keep their warps'
    staged rows and partials of a codeword's dim sums: width 16,384 raises
    there, where B1 runs."""
    flat = torch.zeros(8, DIM, device=cuda_device)
    embed = torch.zeros(DIM, 1600, device=cuda_device)
    assert not bool(quantize_topk_fused(flat, embed, 1600)[2].any())
    assert not bool(quantize_topk_train_fused(flat, embed, 1600)[2].any())
    wide = torch.zeros(8, 16384, device=cuda_device)
    wide_embed = torch.zeros(16384, 64, device=cuda_device)
    with pytest.raises(ValueError, match="width 16384 .*shared memory"):
        quantize_topk_train_fused(wide, wide_embed, K)
    assert not bool(quantize_topk_fused(wide, wide_embed, K)[2].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dim,n_embed,k", [(64, 256, 9), (64, 256, 16),
                                           (64, 256, 256), (128, 100, 100),
                                           (64, 1024, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_core_route_takes_k_over_8(cuda_device, dtype, dim, n_embed, k):
    """k 9, 16 and n_embed (distances staged in shared memory, k rounds of
    a warp-wide minimum): B1 and B2 against their plain versions on a
    ragged N, B2's counts the histogram of its top-1 and its lookup bitwise
    B1's.  With k = n_embed every pair of codewords is ranked, so near-ties
    flip many rows; each flip must still be a near-tie."""
    g = torch.Generator(device=cuda_device).manual_seed(24)
    flat = torch.randn(1037, dim, device=cuda_device, generator=g).to(dtype)
    embed = torch.randn(dim, n_embed, device=cuda_device, generator=g)
    max_flips = flat.shape[0] if k == n_embed else None
    before = quantize_topk_fused.launches_by_route[CUDA_CORE]
    b1 = quantize_topk_fused(flat, embed, k)
    torch.cuda.synchronize()
    assert quantize_topk_fused.launches_by_route[CUDA_CORE] == before + 1
    _assert_lookup(flat, embed, k, b1, max_flips)
    out = _train_launch(flat, embed, k, CUDA_CORE)
    _assert_lookup(flat, embed, k, out, max_flips)
    assert torch.equal(out[3], torch.bincount(out[2].long(),
                                              minlength=n_embed).float())
    assert all(torch.equal(a, b) for a, b in zip(out[:3], b1))


@pytest.mark.cuda
def test_generator_kernel_route_matches_plain_route(cuda_device):
    """The full generator (float32, TF32 off) with the memory lookup in the
    kernel and in plain PyTorch: the same codewords, so the same outputs."""
    net = init_weights(build_generator(NetConfig(dtype="float32"),
                                       per_sample_diff=True),
                       torch.Generator().manual_seed(1)).to(cuda_device).eval()
    g = torch.Generator(device=cuda_device).manual_seed(2)
    rgb = torch.rand(2, 12, 64, 64, device=cuda_device, generator=g) * 2 - 1
    op = torch.randn(2, 6, 64, 64, device=cuda_device, generator=g)
    with torch.inference_mode():
        before = quantize_topk_fused.launches
        fused = net(rgb, op)
        assert quantize_topk_fused.launches == before + 2
        for m in net.modules():
            if isinstance(m, TopKMemory):
                m.use_kernel = False
        plain = net(rgb, op)
    def leaves(out):  # rgb_pred, op_pred, diffs, codes
        return [out[0], out[1], *out[2], *out[3]]

    for a, b in zip(leaves(fused), leaves(plain)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_core_route_takes_a_streamed_codebook_of_4096(cuda_device):
    """n_embed 4,096 at k 2: 64 stages of the codebook stream through each
    block; B1 and B2 against their plain versions, float32 and bf16."""
    g = torch.Generator(device=cuda_device).manual_seed(40)
    embed = torch.randn(DIM, 4096, device=cuda_device, generator=g)
    z = torch.randn(4099, DIM, device=cuda_device, generator=g)
    for flat in (z, z.to(torch.bfloat16)):
        b1 = quantize_topk_fused(flat, embed, K, route=CUDA_CORE)
        _assert_lookup(flat, embed, K, b1)
        out = _train_launch(flat, embed, K, CUDA_CORE)
        _assert_train_outputs(flat, embed, K, out)
        assert all(torch.equal(a, b) for a, b in zip(out[:3], b1))


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [15, 17, 63, 65, 127, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_core_route_takes_widths_off_the_k_step(cuda_device, dtype, dim):
    """Widths 16m +- 1: the last k-step is zero-padded in shared memory, and
    rows that are not 16-byte aligned are staged element by element; B1 and
    B2 against their plain versions."""
    g = torch.Generator(device=cuda_device).manual_seed(41)
    flat = torch.randn(1037, dim, device=cuda_device, generator=g).to(dtype)
    embed = torch.randn(dim, 300, device=cuda_device, generator=g)
    b1 = quantize_topk_fused(flat, embed, 3, route=CUDA_CORE)
    _assert_lookup(flat, embed, 3, b1)
    out = _train_launch(flat, embed, 3, CUDA_CORE)
    _assert_train_outputs(flat, embed, 3, out)
    assert all(torch.equal(a, b) for a, b in zip(out[:3], b1))


@pytest.mark.cuda
def test_cuda_core_route_takes_extreme_magnitudes(cuda_device):
    """float32 latents and codewords whose entries span 1e-30 to 1e30: rows
    scaled by 1e-15 to 1e30 and codewords by 1e-15 to 1e5, the entries of
    each spread over 15 more decades below its largest (so the lo part of
    the smallest, 2^-16 of the entry, underflows bf16), zero entries, a zero
    row and codeword, and ten codewords of entries near 1e-37.  The
    products stay finite and the distances inside float32's normal range
    (in its subnormals the plain version's own distances keep too few bits
    for the near-tie rule).  B1 and B2 against their plain versions under
    the near-tie rule, the gathered codewords bitwise the f32 codebook's."""
    rng = np.random.default_rng(42)
    n, n_embed = 4096, 256
    z = (rng.normal(size=(n, DIM)) * 10.0 ** rng.integers(-15, 31, size=(n, 1))
         * 10.0 ** rng.uniform(-15, 0, size=(n, DIM)))
    e = (rng.normal(size=(DIM, n_embed))
         * 10.0 ** rng.integers(-15, 6, size=(1, n_embed))
         * 10.0 ** rng.uniform(-15, 0, size=(DIM, n_embed)))
    z[:, ::7] = 0.0
    z[5] = 0.0
    e[::5] = 0.0
    e[:, 3] = 0.0
    e[:, 10:20] = rng.uniform(1.0, 2.0, size=(DIM, 10)) * 1e-37
    flat = torch.from_numpy(z.astype(np.float32)).to(cuda_device)
    embed = torch.from_numpy(e.astype(np.float32)).to(cuda_device)
    assert float(flat.abs().max()) > 1e29 and float(embed.abs().max()) > 1e4
    assert bool(torch.isfinite(flat @ embed).all())
    b1 = quantize_topk_fused(flat, embed, K)
    _assert_lookup(flat, embed, K, b1)
    out = _train_launch(flat, embed, K, CUDA_CORE)
    _assert_train_outputs(flat, embed, K, out)
    assert all(torch.equal(a, b) for a, b in zip(out[:3], b1))


@pytest.mark.cuda
def test_cuda_core_statistics_spread_a_hot_codeword(cuda_device):
    """float32 B2 where one codeword (the shortest) is the top-1 of at least
    half of 196,608 rows: its rows are summed by the 8 blocks of one
    cluster.  Counts exact, embed_sum within ESUM_REL of the summed
    magnitude, and two calls bitwise equal."""
    g = torch.Generator(device=cuda_device).manual_seed(43)
    embed = torch.randn(DIM, 256, device=cuda_device, generator=g)
    embed[:, 7] *= 0.05
    flat = torch.randn(196_608, DIM, device=cuda_device, generator=g) * 0.1
    out = _train_launch(flat, embed, K, CUDA_CORE)
    assert int(out[3].max()) >= flat.shape[0] // 2
    _assert_train_outputs(flat, embed, K, out)
    again = quantize_topk_train_fused(flat, embed, K)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def _train_launch(flat, embed, k, route=None):
    """B2 on ``route`` (by default the rule's), failing unless that route
    and no other counted the launch."""
    want = route or memory_kernels.lookup_route(flat.dtype, flat.shape[1],
                                                embed.shape[1], k)
    before = dict(quantize_topk_train_fused.launches_by_route)
    launches = quantize_topk_train_fused.launches
    out = quantize_topk_train_fused(flat, embed, k, route=route)
    torch.cuda.synchronize()
    assert quantize_topk_train_fused.launches == launches + 1
    assert quantize_topk_train_fused.launches_by_route == {
        r: before[r] + (r == want) for r in before}
    return out


def _assert_train_outputs(flat, embed, k, out):
    """B2's outputs against its plain version: near-ties only, counts the
    histogram of its own top-1, embed_sum within ESUM_REL of the summed
    magnitude."""
    q, q1, idx, counts, esum = out
    n_embed = embed.shape[1]
    _assert_lookup(flat, embed, k, out)
    _, _, ridx, rcounts, _ = quantize_topk_train_fused_ref(flat, embed, k)
    assert torch.equal(counts, torch.bincount(idx.long(), minlength=n_embed)
                       .float())
    if bool((idx == ridx).all()):
        assert torch.equal(counts, rcounts)
    one_hot = torch.nn.functional.one_hot(idx.long(), n_embed).double()
    want = flat.double().t() @ one_hot
    mag = flat.double().abs().t() @ one_hot
    assert bool(((esum.double() - want).abs() <= ESUM_REL * mag).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1037, 4096])
@pytest.mark.parametrize("n_embed", [64, 256])
@pytest.mark.parametrize("dtype,route", [(torch.float32, CUDA_CORE),
                                         (torch.bfloat16, CUDA_CORE),
                                         (torch.bfloat16, TENSOR_CORE)])
def test_train_kernel_matches_plain_version(cuda_device, dtype, route,
                                            n_embed, n):
    g = torch.Generator(device=cuda_device).manual_seed(9)
    flat = torch.randn(n, DIM, device=cuda_device, generator=g).to(dtype)
    embed = torch.randn(DIM, n_embed, device=cuda_device, generator=g)
    out = _train_launch(flat, embed, K, route)
    _assert_train_outputs(flat, embed, K, out)


@pytest.mark.cuda
@pytest.mark.parametrize("route", [TENSOR_CORE, CUDA_CORE])
def test_train_kernel_statistics_are_deterministic(cuda_device, route):
    g = torch.Generator(device=cuda_device).manual_seed(10)
    flat = torch.randn(196_608, DIM, device=cuda_device,
                       generator=g).to(torch.bfloat16)
    embed = torch.randn(DIM, 256, device=cuda_device, generator=g)
    first = quantize_topk_train_fused(flat, embed, K, route=route)
    for _ in range(3):
        again = quantize_topk_train_fused(flat, embed, K, route=route)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_train_kernel_tensor_core_route_takes_n_embed_512(cuda_device, k):
    """n_embed 512 on the tensor-core route."""
    g = torch.Generator(device=cuda_device).manual_seed(15)
    flat = torch.randn(4099, DIM, device=cuda_device,
                       generator=g).to(torch.bfloat16)
    embed = torch.randn(DIM, 512, device=cuda_device, generator=g)
    out = _train_launch(flat, embed, k)
    _assert_train_outputs(flat, embed, k, out)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1037, 4096, 196_608])
def test_train_kernel_lookup_is_b1s_on_the_tensor_core_route(cuda_device, n):
    """B2's tensor-core route runs B1's kernel: its q_topk, q1 and idx are
    bitwise B1's on the same input."""
    g = torch.Generator(device=cuda_device).manual_seed(16)
    flat = torch.randn(n, DIM, device=cuda_device,
                       generator=g).to(torch.bfloat16) * 0.5
    embed = torch.randn(DIM, 256, device=cuda_device, generator=g)
    b2 = _train_launch(flat, embed, K, TENSOR_CORE)
    b1 = quantize_topk_fused(flat, embed, K)
    assert all(torch.equal(a, b) for a, b in zip(b2[:3], b1))


@pytest.mark.cuda
def test_train_kernel_routes_agree(cuda_device):
    """The two routes on one bf16 input: the same lookup but for near-ties,
    the same counts where no top-1 flipped, and embed_sums within ESUM_REL
    of the summed magnitude (two summation orders)."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    flat = torch.randn(65_536, DIM, device=cuda_device,
                       generator=g).to(torch.bfloat16)
    embed = torch.randn(DIM, 256, device=cuda_device, generator=g)
    tc = _train_launch(flat, embed, K, TENSOR_CORE)
    cc = _train_launch(flat, embed, K, CUDA_CORE)
    agree = (tc[2] == cc[2]) & (tc[0] == cc[0]).all(dim=1)
    assert int((~agree).sum()) <= 2
    assert torch.equal(tc[0][agree], cc[0][agree])
    same = tc[2] == cc[2]
    if bool(same.all()):
        assert torch.equal(tc[3], cc[3])
    # entries of codewords that no flipped row touched
    touched = torch.zeros(256, dtype=torch.bool, device=cuda_device)
    touched[tc[2][~same].long()] = True
    touched[cc[2][~same].long()] = True
    mag = flat.double().abs().t() @ torch.nn.functional.one_hot(
        tc[2].long(), 256).double()
    err = (tc[4].double() - cc[4].double()).abs()
    assert bool((err[:, ~touched] <= ESUM_REL * mag[:, ~touched]).all())
    assert torch.equal(tc[3][~touched], cc[3][~touched])


@pytest.mark.cuda
def test_train_kernel_counts_launches_by_route(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(18)
    flat = torch.randn(300, DIM, device=cuda_device, generator=g)
    embed = torch.randn(DIM, 64, device=cuda_device, generator=g)
    for f, route in ((flat, None), (flat.to(torch.bfloat16), None),
                     (flat.to(torch.bfloat16), CUDA_CORE),
                     (flat.to(torch.bfloat16), TENSOR_CORE)):
        _train_launch(f, embed, K, route)
    with pytest.raises(ValueError, match="route"):
        quantize_topk_train_fused(flat, embed, K, route=TENSOR_CORE)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,n_embed,k", [(64, 512, 2), (64, 100, 2),
                                           (64, 1024, 2), (128, 1024, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_kernel_takes_any_codebook_size(cuda_device, dtype, dim,
                                              n_embed, k):
    """float32 B2 at n_embed 512 (over the old kernel's shared memory),
    non-powers of two, 1024, k 8, width 128: the CUDA-core route against the
    plain version, its lookup bitwise B1's CUDA-core lookup."""
    g = torch.Generator(device=cuda_device).manual_seed(22)
    flat = torch.randn(1037, dim, device=cuda_device, generator=g).to(dtype)
    embed = torch.randn(dim, n_embed, device=cuda_device, generator=g)
    out = _train_launch(flat, embed, k, CUDA_CORE)
    _assert_train_outputs(flat, embed, k, out)
    b1 = quantize_topk_fused(flat, embed, k, route=CUDA_CORE)
    assert all(torch.equal(a, b) for a, b in zip(out[:3], b1))


@pytest.mark.cuda
def test_train_kernel_statistics_are_deterministic_at_n_embed_1024(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(23)
    flat = torch.randn(65_536, DIM, device=cuda_device, generator=g)
    embed = torch.randn(DIM, 1024, device=cuda_device, generator=g)
    first = _train_launch(flat, embed, K, CUDA_CORE)
    _assert_train_outputs(flat, embed, K, first)
    for _ in range(2):
        again = quantize_topk_train_fused(flat, embed, K)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, TENSOR_CORE),
                                         (torch.float32, CUDA_CORE)])
def test_topk_training_lookup_runs_b2_and_equals_the_plain_route(
        cuda_device, dtype, route):
    """The VQ-VAE family's training lookup (``st_mode="topk"``) at its top
    level's N = 8 * 32 * 32 = 8,192: through B2 (one launch, on the
    route's kernel) and through the plain route.  Rows whose codewords agree
    give bitwise equal outputs and gradients; a differing row must be a
    near-tie; the EMA codebooks differ by embed_sum's summation order."""
    g = torch.Generator(device=cuda_device).manual_seed(31)
    z0 = torch.randn(8, 32, 32, DIM, device=cuda_device, generator=g)
    z0 = (z0 * 0.5).to(dtype)
    embed = torch.randn(DIM, 256, device=cuda_device, generator=g)
    cb = Codebook(embed, torch.zeros(256, device=cuda_device), embed.clone())
    runs = []
    for use_kernel in (True, False):
        z = z0.clone().requires_grad_()
        before = dict(quantize_topk_train_fused.launches_by_route)
        q, diff, q_st, new = quantize_topk(z, cb, K, train=True,
                                           use_kernel=use_kernel,
                                           st_mode="topk")
        (q.float().square().mean() + diff).backward()
        torch.cuda.synchronize()
        took = {r: c - before[r] for r, c in
                quantize_topk_train_fused.launches_by_route.items()}
        assert took == {r: int(use_kernel and r == route) for r in took}
        runs.append((q.reshape(-1, K * DIM), diff, q_st.reshape(-1, DIM),
                     new, z.grad.reshape(-1, DIM)))
    (q, diff, q_st, new, grad), (rq, rdiff, rq_st, rnew, rgrad) = runs
    agree = (q == rq).all(dim=1)
    flat = z0.reshape(-1, DIM).double()
    for j in range(K):
        block = slice(j * DIM, (j + 1) * DIM)
        rows = ~(q[:, block] == rq[:, block]).all(dim=1)
        dk = (flat[rows] - q[rows, block].double()).square().sum(1)
        dp = (flat[rows] - rq[rows, block].double()).square().sum(1)
        assert bool(((dk - dp).abs()
                     < NEAR_TIE_REL * torch.maximum(dk, dp)).all())
    assert int((~agree).sum()) <= 2  # near-ties only, at this size
    assert torch.equal(q[agree], rq[agree])
    assert torch.equal(q_st[agree], rq_st[agree])
    assert torch.equal(grad[agree], rgrad[agree])
    torch.testing.assert_close(diff, rdiff, rtol=1e-5, atol=0)
    # the codewords a flipped row's top-1 moved between
    keep = torch.ones(256, dtype=torch.bool, device=cuda_device)
    for r in (~agree).nonzero()[:, 0].tolist():
        for word in (q[r, :DIM], rq[r, :DIM]):
            keep &= ~(embed == word[:, None]).all(0)
    for got, want in zip(new, rnew):
        torch.testing.assert_close(got[..., keep], want[..., keep], rtol=0,
                                   atol=1e-5)


@pytest.mark.cuda
def test_wrappers_size_each_launch_shape_once(cuda_device):
    """The shared-memory check and grid sizing (device queries, occupancy)
    run once per device and shape, not on every launch; B1 and B2 share
    them on the CUDA-core route too."""
    flat = torch.randn(300, DIM, device=cuda_device)
    embed = torch.randn(DIM, 64, device=cuda_device)
    memory_kernels._grid.cache_clear()
    for _ in range(3):
        quantize_topk_fused(flat, embed, K)
        quantize_topk_train_fused(flat, embed, K)
    info = memory_kernels._grid.cache_info()
    assert (info.misses, info.hits) == (1, 5)  # B2's lookup is B1's kernel


@pytest.mark.cuda
def test_tensor_core_wrappers_size_each_launch_shape_once(cuda_device):
    """On the tensor-core route too: B1 and B2 share one sizing call (the
    lookup's grid, and B2's statistics kernel readied) per device and
    shape."""
    flat = torch.randn(300, DIM, device=cuda_device).to(torch.bfloat16)
    embed = torch.randn(DIM, 64, device=cuda_device)
    memory_kernels._mma_grid.cache_clear()
    for _ in range(3):
        quantize_topk_fused(flat, embed, K)
        quantize_topk_train_fused(flat, embed, K)
    info = memory_kernels._mma_grid.cache_info()
    assert (info.misses, info.hits) == (1, 5)


@pytest.mark.cuda
def test_train_step_kernel_route_matches_plain_route(cuda_device):
    """One float32 train step (cuDNN deterministic) at 64x64 through B2 and
    through plain PyTorch from one state and batch: the same codewords, so
    equal losses; codebooks within embed_sum's summation order."""
    torch.backends.cudnn.deterministic = True
    g = torch.Generator(device=cuda_device).manual_seed(11)
    batch = {"rgb": torch.randint(0, 256, (2, 5, 64, 64, 3), device=cuda_device,
                                  generator=g, dtype=torch.uint8),
             "op": torch.randn(2, 4, 64, 64, 2, device=cuda_device, generator=g)}
    runs = []
    for use_kernel in (True, False):
        model = build_model(NetConfig(dtype="float32", n_embed=64,
                                      use_memory_kernel=use_kernel), "training")
        state = create_train_state(model.generator, model.discriminator,
                                   OptimConfig(), 5, device=cuda_device)
        flownet = init_flownet_weights(model.flow_network,
                                       torch.Generator().manual_seed(6))
        before = quantize_topk_train_fused.launches
        metrics = make_twostream_train_step(LossConfig())(
            state, batch, flownet.to(cuda_device).eval())
        torch.cuda.synchronize()
        assert quantize_topk_train_fused.launches - before == (
            2 if use_kernel else 0)
        runs.append((metrics, codebook_buffers(state.generator)))
    (mk, ck), (mp, cp) = runs
    for k in mp:
        torch.testing.assert_close(mk[k], mp[k], rtol=1e-6, atol=0)
    for k in cp:
        torch.testing.assert_close(ck[k], cp[k], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_remat_step_matches_plain_step_at_full_width(cuda_device):
    """One bf16 stage-2 step of the released configuration at 256x256
    (batch 2, cuDNN deterministic) with ``remat=True`` and without, from
    one state and batch: g_loss within 1e-6 relative, parameters within
    1e-6, BatchNorm statistics and codebooks bitwise; the rerun forward
    takes B1, so B2 runs twice a step either way and B1 twice more under
    remat, all on the tensor-core route."""
    torch.backends.cudnn.deterministic = True
    g = torch.Generator(device=cuda_device).manual_seed(12)
    batch = {"rgb": torch.randint(0, 256, (2, 5, 256, 256, 3),
                                  device=cuda_device, generator=g,
                                  dtype=torch.uint8),
             "op": torch.randn(2, 4, 256, 256, 2, device=cuda_device,
                               generator=g)}
    runs = []
    for remat in (False, True):
        model = build_model(NetConfig(), "training")
        state = create_train_state(model.generator, model.discriminator,
                                   OptimConfig(), 5, device=cuda_device)
        flownet = init_flownet_weights(model.flow_network,
                                       torch.Generator().manual_seed(6))
        b1, b2 = quantize_topk_fused.launches, quantize_topk_train_fused.launches
        b1_tc = quantize_topk_fused.launches_by_route[TENSOR_CORE]
        metrics = make_twostream_train_step(LossConfig(), remat=remat)(
            state, batch, flownet.to(cuda_device).eval())
        torch.cuda.synchronize()
        assert quantize_topk_train_fused.launches - b2 == 2
        assert quantize_topk_fused.launches - b1 == (2 if remat else 0)
        assert (quantize_topk_fused.launches_by_route[TENSOR_CORE] - b1_tc
                == quantize_topk_fused.launches - b1)
        runs.append((metrics, state.generator.state_dict(),
                     {n for n, _ in state.generator.named_parameters()}))
    (mp, sp, params), (mr, sr, _) = runs
    torch.testing.assert_close(mr["g_loss"], mp["g_loss"], rtol=1e-6, atol=0)
    for k in sp:
        if k in params:
            torch.testing.assert_close(sr[k], sp[k], rtol=0, atol=1e-6)
        else:
            assert torch.equal(sr[k], sp[k]), k


@pytest.mark.cuda
def test_msgpack_checkpoint_scores_as_its_weights(cuda_device, tmp_path):
    """The released generator written as the JAX package's flax
    ``.msgpack`` (``chip_smoke.py``'s writer) loads bitwise its weights,
    and its bf16 forward on the card through B1 is bitwise the forward of
    the weights as given."""
    import importlib.util

    from ammcnet_aaai2021_torch.tools.weights import load_generator_checkpoint

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    nets = [init_weights(build_generator(NetConfig(), per_sample_diff=True),
                         torch.Generator().manual_seed(3))]
    path = str(tmp_path / "generator.msgpack")
    with open(path, "wb") as fh:
        fh.write(smoke.msgpack_bytes(smoke.flax_variables(
            nets[0].state_dict())))
    sd = load_generator_checkpoint(path)
    for k, v in nets[0].state_dict().items():
        assert torch.equal(sd[k], v), k
    nets.append(build_generator(NetConfig(), per_sample_diff=True))
    nets[1].load_state_dict(sd)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    rgb = torch.rand(4, 12, 256, 256, device=cuda_device, generator=g) * 2 - 1
    op = torch.randn(4, 6, 256, 256, device=cuda_device, generator=g)
    outs = []
    with torch.inference_mode():
        for net in nets:
            before = quantize_topk_fused.launches
            out = net.to(cuda_device).eval()(rgb, op)
            assert quantize_topk_fused.launches == before + 2
            outs.append([out[0], out[1], *out[2], *out[3]])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "torch_jpeg")


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [3, "1to3"])
@pytest.mark.parametrize("src,size", [((240, 360), (256, 256)),
                                      ((360, 640), (256, 256)),
                                      ((37, 53), (64, 48))])
def test_resize_kernel_matches_plain_version(cuda_device, channels, src,
                                             size):
    g = torch.Generator(device=cuda_device).manual_seed(25)
    img = torch.randint(0, 256, (3, *src, 3 if channels == 3 else 1),
                        dtype=torch.uint8, device=cuda_device, generator=g)
    before = native.resize_bilinear_u8.launches
    out = native.resize_bilinear_u8(img, size)
    torch.cuda.synchronize()
    assert native.resize_bilinear_u8.launches == before + 1
    assert out.shape == (3, *size, 3)
    assert torch.equal(out, native.resize_bilinear_u8_ref(img, size))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resize_kernel_is_its_plain_version_across_sizes(cuda_device, seed):
    """The resize kernel bitwise its plain version on 12 seeded random
    (sh, sw, dh, dw) from 16 to 720 pixels, up- and downscales, 1 -> 3 and
    3 -> 3 channels, 1 to 4 frames, at an unaligned source
    offset (the staging's byte head and tail) and in place: the host
    build's fused multiply-adds, the row buffer's copy at both edges, the
    tiling's column and row limits and its pairs of staged rows."""
    rng = np.random.default_rng(100 + seed)
    g = torch.Generator(device=cuda_device).manual_seed(seed)
    for i in range(12):
        sh, sw, dh, dw = (int(v) for v in rng.integers(16, 721, 4))
        sc = 1 if i % 2 == 0 else 3
        n = int(rng.integers(1, 5))
        flat = torch.randint(0, 256, (n * sh * sw * sc + 5,),
                             dtype=torch.uint8, device=cuda_device,
                             generator=g)
        img = flat[5:].view(n, sh, sw, sc)
        out = native.resize_bilinear_u8(img, (dh, dw))
        torch.cuda.synchronize()
        assert torch.equal(out, native.resize_bilinear_u8_ref(
            img, (dh, dw))), (sh, sw, dh, dw, sc)


@pytest.mark.cuda
@pytest.mark.parametrize("chroma", [(1, 1), (2, 1), (2, 2)],
                         ids=["444", "422", "420"])
def test_colour_kernel_matches_plain_version(cuda_device, chroma):
    """The colour sweep's inputs of one subsampling
    (``kernel_sweeps.ycc_sweep``, which ``chip_smoke.py`` checks too): one
    frame, then chunks of frames in one launch each, at odd sizes (ragged
    chroma edges, widths no multiple of 16) and at 360x640 (whole 16-pixel
    runs), bitwise the plain version."""
    cases = [planes for factors, *planes in ycc_sweep(cuda_device)
             if factors == chroma]
    assert len(cases) >= 5
    for y, cb, cr in cases:
        before = native.ycc_to_rgb_u8.launches
        out = native.ycc_to_rgb_u8(y, cb, cr)
        torch.cuda.synchronize()
        assert native.ycc_to_rgb_u8.launches == before + 1
        assert out.shape == (*y.shape, 3)
        assert torch.equal(out, native.ycc_to_rgb_u8_ref(y, cb, cr)), (
            tuple(y.shape))


@pytest.mark.cuda
def test_gpu_decode_of_the_fixture_is_within_its_tolerance(cuda_device):
    """The committed JPEGs through the GPU route against cv2's decode +
    resize (``reference.npz``): grayscale and colour frames come back as
    RGB on the card, every value within 1 LSB (libjpeg's decode, then the
    float resize against cv2's fixed-point one), as the host route is;
    every frame launched the kernels it needs."""
    ref = np.load(os.path.join(FIXTURE, "reference.npz"))
    launches = (native.resize_bilinear_u8.launches,
                native.ycc_to_rgb_u8.launches)
    for kind, want in (("gray", ref["gray"][..., None]),
                       ("color", ref["color"])):
        paths = [os.path.join(FIXTURE, f"{kind}_{i:02d}.jpg")
                 for i in range(len(want))]
        got = native.decode_video(paths, (256, 256), device=cuda_device)
        assert got.device.type == "cuda"
        assert got.shape == (len(paths), 256, 256, 3)
        diff = np.abs(got.cpu().numpy().astype(int) - want)
        assert diff.max() <= 1
    # one resize launch for the 16 gray frames and one for the 2 colour
    # frames (one source size each), one colour conversion a colour chunk
    assert (native.resize_bilinear_u8.launches - launches[0],
            native.ycc_to_rgb_u8.launches - launches[1]) == (2, 1)


@pytest.mark.cuda
def test_gpu_decode_of_a_mixed_video_is_rgb(cuda_device):
    """A video of grayscale and colour JPEGs comes back as RGB, each frame
    as it decodes alone (a grayscale video too is RGB, C5)."""
    paths = [os.path.join(FIXTURE, name) for name in ("gray_00.jpg",
                                                      "color_00.jpg")]
    got = native.decode_video(paths, (64, 64), device=cuda_device)
    gray = native.decode_video(paths[:1], (64, 64), device=cuda_device)
    colour = native.decode_video(paths[1:], (64, 64), device=cuda_device)
    assert got.shape == (2, 64, 64, 3) and gray.shape == (1, 64, 64, 3)
    assert torch.equal(got[:1], gray)
    assert torch.equal(got[1:], colour)


@pytest.mark.cuda
def test_idct_kernel_matches_plain_version(cuda_device):
    """The IDCT kernel against its plain version, bitwise: the fixture's
    coefficients (gray 240x360, colour 4:2:0 360x640, its three
    components), random blocks over the whole coefficient range with
    sparse AC terms (the SIMD shortcut's cases) at a ragged size, then
    ``IDCT_SWEEP`` seeded geometries (``kernel_sweeps.idct_sweep``, which
    ``chip_smoke.py`` checks too)."""
    frames = native.decode_coefs(
        [os.path.join(FIXTURE, name) for name in ("gray_00.jpg",
                                                  "color_00.jpg")])
    cases = [(torch.from_numpy(c.coefs)[None],
              torch.from_numpy(c.qtable)[None], c.size)
             for comps in frames for c in comps]
    g = torch.Generator().manual_seed(41)
    coefs = torch.randint(-1024, 1024, (3, 5, 7, 64), dtype=torch.int16,
                          generator=g)
    coefs[..., 1:] *= (torch.rand((3, 5, 7, 63), generator=g) < 0.2)
    q = torch.randint(1, 256, (3, 64), generator=g).to(torch.uint16)
    cases.append((coefs, q, (37, 53)))
    before = native.idct_islow_u8.launches
    for coefs, q, size in cases:
        got = native.idct_islow_u8(coefs.to(cuda_device), q.to(cuda_device),
                                   size)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), native.idct_islow_u8_ref(coefs, q, size))
    assert native.idct_islow_u8.launches == before + len(cases)
    for coefs, q, size in idct_sweep(IDCT_SWEEP, cuda_device):
        got = native.idct_islow_u8(coefs, q, size)
        assert torch.equal(got, native.idct_islow_u8_ref(coefs, q, size)), (
            tuple(coefs.shape), size)


@pytest.mark.cuda
def test_gpu_decode_of_a_colour_chunk_is_one_colour_launch(cuda_device):
    """40 colour frames (the fixture's two, cycled) decode in two chunks,
    32 and 8 frames: one colour launch and one resize launch a chunk, three
    IDCT launches a chunk, each frame bitwise its host-libjpeg
    reference."""
    ref = np.load(os.path.join(FIXTURE, "libjpeg_reference.npz"))
    paths = [os.path.join(FIXTURE, f"color_{i % 2:02d}.jpg") for i in range(40)]
    counters = (native.ycc_to_rgb_u8, native.resize_bilinear_u8,
                native.idct_islow_u8)
    before = [c.launches for c in counters]
    got = native.decode_video(paths, (256, 256), device=cuda_device)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 6]
    want = ref["color_256"]
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  want[np.arange(40) % 2])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gray", "color"])
def test_gpu_decode_is_the_host_route_bitwise(cuda_device, kind):
    """The fixture through the GPU route (Huffman decode on the host, the
    IDCT, colour and resize kernels) is bitwise the host libjpeg route
    (``libjpeg_reference.npz``), at source size and at 256x256, one IDCT
    launch a component a chunk."""
    ref = np.load(os.path.join(FIXTURE, "libjpeg_reference.npz"))
    count = {"gray": 16, "color": 2}[kind]
    paths = [os.path.join(FIXTURE, f"{kind}_{i:02d}.jpg")
             for i in range(count)]
    for name in ("source", "256"):
        want = ref[f"{kind}_{name}"]
        before = native.idct_islow_u8.launches
        got = native.decode_video(paths, want.shape[1:3], device=cuda_device)
        assert got.device.type == "cuda" and got.shape == want.shape
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        assert native.idct_islow_u8.launches - before == (
            1 if kind == "gray" else 3)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["progressive", "arithmetic"])
def test_gpu_decode_of_progressive_and_arithmetic_jpegs_is_libjpegs(
        cuda_device, kind):
    """The fixture's progressive JPEG (SOF2, colour 4:2:0, its reference at
    256x256) and arithmetic-coded progressive one (SOF10, grayscale, at
    source size and 256x256) decode on the GPU route bitwise as the host
    libjpeg route decoded them (``libjpeg_reference.npz``)."""
    ref = np.load(os.path.join(FIXTURE, "libjpeg_reference.npz"))
    names = [n for n in ("source", "256") if f"{kind}_{n}" in ref]
    assert names
    for name in names:
        want = ref[f"{kind}_{name}"]
        got = native.decode_video([os.path.join(FIXTURE, f"{kind}.jpg")],
                                  want.shape[1:3], device=cuda_device)
        assert got.device.type == "cuda" and got.shape == want.shape
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gray_c5", "smooth_partial",
                                  "smooth_dconly", "smooth_al1",
                                  "smooth_arith"])
def test_gpu_decode_of_c5_and_smoothing_fixtures_is_libjpegs(cuda_device,
                                                             kind):
    """Faults C5 and C6 on the card: ``gray_c5.jpg`` (a grayscale JPEG whose
    channel 0 the host build rounds 1 LSB off at 160x160 and 248x103)
    comes back as three channels, channel 0 with the host's rounding, and
    the progressive files that libjpeg block-smooths come back smoothed,
    each bitwise its host-libjpeg reference at every size
    (``libjpeg_reference.npz``)."""
    ref = np.load(os.path.join(FIXTURE, "libjpeg_reference.npz"))
    names = [k for k in ref.files if k.startswith(f"{kind}_")]
    assert len(names) == (3 if kind == "gray_c5" else 2)
    for name in names:
        want = ref[name]
        got = native.decode_video([os.path.join(FIXTURE, f"{kind}.jpg")],
                                  want.shape[1:3], device=cuda_device)
        assert got.device.type == "cuda" and got.shape == want.shape
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    if kind == "gray_c5":
        for name in ("gray_c5_160", "gray_c5_248x103"):
            want = ref[name]
            assert (want[..., 0] != want[..., 1]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["trunc_rst", "trunc_progressive",
                                  "trunc_arith"])
def test_gpu_decode_of_truncated_fixtures_is_libjpegs(cuda_device, kind):
    """Fault C7 on the card: the committed truncated files (a colour JPEG
    with restarts cut at 50 %, a progressive one cut at 30 % whose
    smoothing reads the second latch row, an arithmetic-coded progressive
    one cut at 10 % whose IDCT saturates) decode bitwise as the host
    libjpeg route decoded them, at source size and 256x256."""
    ref = np.load(os.path.join(FIXTURE, "libjpeg_reference.npz"))
    names = [k for k in ref.files if k.startswith(f"{kind}_")]
    assert len(names) == 2
    for name in names:
        want = ref[name]
        got = native.decode_video([os.path.join(FIXTURE, f"{kind}.jpg")],
                                  want.shape[1:3], device=cuda_device)
        assert got.device.type == "cuda" and got.shape == want.shape
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_int8_calibration_reads_jpeg_frames_through_the_gpu_route(
        cuda_device, tmp_path, monkeypatch):
    """``run_test --int8 --native_loader``'s calibration on a JPEG training
    split (the fixture's 240x360 frames, seeded ``.flo`` flows) on the card,
    where there is neither cv2 nor libjpeg: each frame decoded by the GPU
    route, brought back and sampled; the 40 scales are bitwise those of the
    same calibration reading each frame through the GPU route's plain
    pipeline on the CPU (``decode_video_ref``), and the IDCT kernel ran."""
    from ammcnet_aaai2021_torch.data.flo import write_flo
    from ammcnet_aaai2021_torch.models import quantized as pq

    rng = np.random.default_rng(8)
    train = tmp_path / "ped2" / "training"
    for v in range(2):
        fdir, odir = (train / kind / f"{v + 1:02d}" for kind in (
            "frames", "flows"))
        fdir.mkdir(parents=True)
        odir.mkdir(parents=True)
        for t in range(8):
            jpeg = os.path.join(FIXTURE, f"gray_{(5 * v + t) % 16:02d}.jpg")
            (fdir / f"{t:03d}.jpg").write_bytes(open(jpeg, "rb").read())
            if t < 7:
                write_flo(str(odir / f"{t:03d}.flo"), rng.normal(
                    0, 1.5, (240, 360, 2)).astype(np.float32))
    cfg = NetConfig()
    sd = init_weights(build_generator(cfg, per_sample_diff=True),
                      torch.Generator().manual_seed(9)).state_dict()

    def scales():
        _, qcal = pq.calibrated_int8_from_dataset(
            cfg, sd, str(tmp_path), "ped2", 64, calib_batches=2,
            calib_batch_size=4, use_native_loader=True, device=cuda_device)
        out = {}

        def walk(tree, base):
            for key, v in tree.items():
                if "act_scale" in v:
                    out[f"{base}/{key}"] = v["act_scale"].item()
                elif "wk" not in v:
                    walk(v, f"{base}/{key}")
        walk(qcal["streams"], "streams")
        walk(qcal["bridge"], "bridge")
        return out

    before = native.idct_islow_u8.launches
    gpu = scales()
    assert native.idct_islow_u8.launches - before == 2 * 4 * 5
    monkeypatch.setattr(native, "decode_video",
                        lambda paths, size, device="cpu":
                        native.decode_video_ref(paths, size))
    plain = scales()
    assert len(gpu) == pq.N_SITES and gpu == plain


def _int8_case(device, seed, n, h, w, cin, cout, taps):
    g = torch.Generator().manual_seed(seed)
    cols = cout if taps == 9 else 4 * cout
    x = torch.randint(-127, 128, (n, h, w, cin), generator=g).to(torch.int8)
    wk = torch.zeros((-(-cols // 64) * 64, taps, cin), dtype=torch.int8)
    wk[:cols] = torch.randint(-127, 128, (cols, taps, cin), generator=g)
    sx = torch.rand(1, generator=g) * 0.05
    scale = torch.rand(cout, generator=g) * 0.01
    bias = torch.randn(cout, generator=g)
    return [t.to(device) for t in (x, wk, sx, scale, bias)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 9, 13, 32, 64), (1, 16, 16, 64, 3), (3, 5, 7, 96, 130),
    (1, 20, 37, 128, 128), (2, 11, 5, 1024, 256), (1, 6, 10, 1024, 512),
    (2, 17, 16, 32, 512), (1, 8, 16, 64, 64), (2, 12, 20, 128, 64),
    (1, 9, 17, 96, 64), (2, 9, 21, 64, 128), (1, 10, 18, 32, 256)])
def test_int8_conv_kernel_matches_plain_version(cuda_device, shape):
    """The 3x3 int8 kernel against its plain version, bitwise: the int32
    accumulators, the bf16 output with and without ReLU, and the int8
    residency output, at ragged pixel counts and padded output columns.
    The kernel's tile is an 8 x 16 rectangle of output pixels and 64, 128
    or 256 columns (Cout_pad 64 or not a multiple of 128: 64; a multiple of
    128 but not of 256: 128; else 256), K tiles of 128, 64 or 32 channels:
    the shapes cover images the rectangle does not divide and narrower than
    it, Cin 32 to 1024, Cout 3 to 512, each column tile width, an image of
    exactly one rectangle, and the resident-weight halo stages (one column
    tile of 64, 128 or 256) at two blocks an SM and at one, with one and
    three channel blocks a shift."""
    n, h, w, cin, cout = shape
    x, wk, sx, scale, bias = _int8_case(cuda_device, 43, n, h, w, cin, cout,
                                        9)
    out_scale = torch.tensor([0.07], device=cuda_device)
    before = ik.qconv3x3_int8.launches
    for kw in (dict(acc=True), dict(), dict(relu=True),
               dict(relu=True, out_scale=out_scale)):
        got = ik.qconv3x3_int8(x, wk, sx, scale, bias, cout, **kw)
        torch.cuda.synchronize()
        want = ik.qconv3x3_int8_ref(x, wk, sx, scale, bias, cout, **kw)
        assert got.dtype == want.dtype and torch.equal(got, want), kw
    assert ik.qconv3x3_int8.launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 4, 512, 256), (1, 3, 5, 64, 24),
                                   (3, 7, 9, 128, 64), (1, 5, 6, 32, 128),
                                   (2, 3, 4, 1024, 3), (2, 16, 16, 64, 16)])
def test_int8_transposed_conv_kernel_matches_plain_version(cuda_device,
                                                           shape):
    """The transposed int8 kernel against its plain version, bitwise, on
    both its epilogues (the accumulators; bf16): 128-pixel M tiles over
    pixel counts they do not divide, column tiles of 64, 128 and 256 that
    span one or several taps, Cin 32 to 1024, Cout 3 (value-by-value
    stores) to 256."""
    n, h, w, cin, cout = shape
    x, wk, sx, scale, bias = _int8_case(cuda_device, 47, n, h, w, cin, cout,
                                        1)
    before = ik.qconv_transpose2x2_int8.launches
    for acc in (True, False):
        got = ik.qconv_transpose2x2_int8(x, wk, sx, scale, bias, cout,
                                         acc=acc)
        torch.cuda.synchronize()
        want = ik.qconv_transpose2x2_int8_ref(x, wk, sx, scale, bias, cout,
                                              acc=acc)
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert ik.qconv_transpose2x2_int8.launches == before + 2


# the quantize tests' scale, a power of two: (k + 1/2) * sx is exact in bf16
PACK_SX = 2.0 ** -6
# x / sx at the first values of each case: ties of both signs, values past
# +-127 * sx, -0.0, the infinities and a NaN (ATen's cast packs it to 0)
PACK_SPECIALS = (2.5, 3.5, -2.5, -3.5, 0.5, -0.5, 126.5, -126.5, 127.5,
                 -127.5, 200.0, -200.0, -0.0, float("inf"), float("-inf"),
                 float("nan"))
# the released forward's statically quantized inputs at 256x256, batch 2
# (form, dtype, the stored tensor's shape, sites): the stream inputs are
# channel slices of NCHW windows seen as NHWC; the bridge conv0s and
# up1.up read the memory block's NCHW output as NHWC; the rest are the
# convolutions' NHWC outputs (cat: the skip, then the upsampled tensor)
PACK_SITES = {
    "inc_conv0_rgb": ("entry", torch.float32, (2, 15, 256, 256), 12),
    "inc_conv0_op": ("entry", torch.bfloat16, (2, 8, 256, 256), 6),
    "down1_conv0": ("pool", torch.bfloat16, (2, 256, 256, 64), None),
    "down2_conv0": ("pool", torch.bfloat16, (2, 128, 128, 128), None),
    "down3_conv0": ("pool", torch.bfloat16, (2, 64, 64, 256), None),
    "bridge_conv0_up1_up": ("nchw", torch.bfloat16, (2, 512, 32, 32), None),
    "up1_conv0": ("cat", torch.bfloat16, (2, 64, 64, 256), 256),
    "up2_up": ("plain", torch.bfloat16, (2, 64, 64, 256), None),
    "up2_conv0": ("cat", torch.bfloat16, (2, 128, 128, 128), 128),
    "up3_up": ("plain", torch.bfloat16, (2, 128, 128, 128), None),
    "up3_conv0": ("cat", torch.bfloat16, (2, 256, 256, 64), 64),
    "outc": ("plain", torch.bfloat16, (2, 256, 256, 64), None),
    # ragged pixel counts (105 a tile of 32 does not divide), a channel
    # group that straddles the two sources, a misaligned source (the
    # value-by-value path), float32 16-byte loads and float32 pooling
    "ragged_cat_straddle": ("cat", torch.bfloat16, (3, 5, 7, 40), 24),
    "ragged_pool": ("pool", torch.bfloat16, (3, 10, 14, 64), None),
    "misaligned": ("misaligned", torch.bfloat16, (2, 9, 11, 66), None),
    "float32_plain": ("plain", torch.float32, (2, 9, 13, 32), None),
    "float32_pool": ("pool", torch.float32, (2, 10, 12, 48), None),
}


def _pack_site(device, seed, form, dtype, shape, extra):
    """``(x, skip, pool)`` of one case on the card: normal values around
    +-60 * sx, :data:`PACK_SPECIALS` first in storage order."""
    g = torch.Generator().manual_seed(seed)

    def normal(shape):
        t = torch.randn(shape, generator=g) * 60 * PACK_SX
        t.view(-1)[:len(PACK_SPECIALS)] = torch.tensor(PACK_SPECIALS) * PACK_SX
        return t.to(device=device, dtype=dtype)
    skip, pool = None, form == "pool"
    x = normal(shape)
    if form == "entry":
        x = x[:, :extra].permute(0, 2, 3, 1)
    elif form == "nchw":
        x = x.permute(0, 2, 3, 1)
    elif form == "cat":
        skip = normal((*shape[:3], extra))
    elif form == "misaligned":
        x = x[..., 1:65]
    return x, skip, pool


@pytest.mark.cuda
@pytest.mark.parametrize("site", sorted(PACK_SITES))
def test_int8_quantize_kernel_matches_plain_version(cuda_device, site):
    """The quantize kernel against its plain version (the PyTorch ops on
    the card), bitwise, at each statically quantized input's shape and
    layout, with ties, clipped values, -0.0, infinities and a NaN; one
    launch a call."""
    x, skip, pool = _pack_site(cuda_device, 53, *PACK_SITES[site])
    sx = torch.tensor([PACK_SX], device=cuda_device)
    before = ik.quantize_pack_int8.launches
    got = ik.quantize_pack_int8(x, sx, skip, pool)
    torch.cuda.synchronize()
    assert ik.quantize_pack_int8.launches == before + 1
    want = ik.quantize_pack_int8_ref(x, sx, skip, pool)
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.cuda
def test_int8_quantize_kernel_rounds_every_bf16_value(cuda_device):
    """The kernel's quotient (a reciprocal once, two exact corrections)
    against the plain version's IEEE division, bitwise, on every bf16 bit
    pattern (NaNs, infinities, denormals, both zeros) at 64 scales: powers
    of two, the smallest the calibration gives (1e-12 / 127), a huge one,
    and seeded scales across 1e-5 to 1e3; both the 16-byte loads (NHWC)
    and the value-by-value path (an NCHW view); and float32 inputs: the
    rgb window's 256 values as the gather computes them and seeded normal
    values around each scale's range."""
    g = torch.Generator().manual_seed(61)
    scales = [2.0 ** e for e in (-20, -6, 0, 3)] + [1e-12 / 127, 1e30]
    scales += torch.exp(torch.empty(58).uniform_(
        np.log(1e-5), np.log(1e3), generator=g)).tolist()
    every = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    u8 = torch.arange(256, dtype=torch.float32)
    rgb = (u8 / 255.0 - 0.5) / 0.5
    for scale in scales:
        sx = torch.tensor([scale], device=cuda_device)
        f32 = torch.cat([rgb, torch.randn(65536 - 256, generator=g)
                         * 80 * scale])
        for values in (every, f32):
            nhwc = values.reshape(1, 32, 32, 64).to(cuda_device)
            nchw = values.reshape(1, 64, 32, 32).to(cuda_device).permute(
                0, 2, 3, 1)
            for x in (nhwc, nchw):
                got = ik.quantize_pack_int8(x, sx)
                want = ik.quantize_pack_int8_ref(x, sx)
                assert torch.equal(got, want), (scale, values.dtype,
                                                x.stride())


@pytest.mark.cuda
def test_calibrated_forward_quantizes_through_the_kernel(cuda_device,
                                                         monkeypatch):
    """The released widths' calibrated int8 forward on the card (64x64,
    one forward of 4 windows through ``ChunkScorer``): 24 quantize
    launches a forward, and the records bitwise those of the same forward
    with the quantize's plain version patched in."""
    from ammcnet_aaai2021_torch.eval.export import ChunkScorer, chunk_example
    from ammcnet_aaai2021_torch.models import quantized as pq

    cfg = NetConfig()
    gen = init_weights(build_generator(cfg, per_sample_diff=True),
                       torch.Generator().manual_seed(5))
    kw = dict(embed_dim=cfg.embed_dim, n_embed=cfg.n_embed, k=cfg.k,
              per_sample_diff=True, use_kernel=cfg.use_memory_kernel)
    qvars = pq.quantize_twostream_variables(gen.state_dict())
    g = torch.Generator().manual_seed(6)
    cal = [((torch.rand(4, 12, 64, 64, generator=g) * 2 - 1).to(cuda_device),
            (torch.randn(4, 6, 64, 64, generator=g) * 0.02).to(cuda_device))]
    qcal = pq.calibrate_act_scales(
        pq.make_quantized_forward(qvars, **kw).to(cuda_device), qvars, cal)
    scorer = ChunkScorer(pq.make_quantized_forward(qcal, **kw).to(
        cuda_device), window_batch=4).eval()
    rgbs, ops = chunk_example(1, 8, 64, cuda_device, seed=7)
    with torch.no_grad():
        before = ik.quantize_pack_int8.launches
        got = scorer(rgbs, ops)
        torch.cuda.synchronize()
        assert ik.quantize_pack_int8.launches == before + 24
        monkeypatch.setattr(pq, "quantize_pack_int8",
                            ik.quantize_pack_int8_ref)
        want = scorer(rgbs, ops)
        torch.cuda.synchronize()
        assert ik.quantize_pack_int8.launches == before + 24
    assert torch.isfinite(got).all() and torch.equal(got, want)


@pytest.mark.cuda
def test_world_size_one_group_equals_the_plain_batchnorm_and_b2(cuda_device,
                                                                tmp_path):
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}",
                            world_size=1, rank=0)
    try:
        g = torch.Generator(device=cuda_device).manual_seed(41)
        x0 = torch.randn(4, 64, 32, 32, device=cuda_device, generator=g) * 2 + 0.5
        grad_out = torch.randn(x0.shape, device=cuda_device, generator=g)
        plain = BatchNorm2d(64).to(cuda_device).train()
        with torch.no_grad():
            plain.weight.uniform_(0.5, 1.5, generator=g)
            plain.bias.uniform_(-0.5, 0.5, generator=g)
        grouped = copy.deepcopy(plain)
        grouped.group = dist.group.WORLD
        outs = []
        for layer in (plain, grouped):
            x = x0.clone().requires_grad_()
            y = layer(x)
            (y * grad_out).sum().backward()
            outs.append((y.detach(), x.grad, layer.weight.grad,
                         layer.bias.grad, layer.running_mean,
                         layer.running_var))
        for want, got in zip(*outs):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

        for dtype, route in ((torch.bfloat16, TENSOR_CORE),
                             (torch.float32, CUDA_CORE)):
            z = (torch.randn(4, 32, 32, DIM, device=cuda_device, generator=g)
                 * 0.5).to(dtype)
            embed = torch.randn(DIM, 256, device=cuda_device, generator=g)
            cb = Codebook(embed, torch.zeros(256, device=cuda_device),
                          embed.clone())
            runs = []
            for group in (None, dist.group.WORLD):
                before = dict(quantize_topk_train_fused.launches_by_route)
                *_, new = quantize_topk(z, cb, K, train=True, use_kernel=True,
                                        group=group)
                torch.cuda.synchronize()
                took = {r: c - before[r] for r, c in
                        quantize_topk_train_fused.launches_by_route.items()}
                assert took == {r: int(r == route) for r in took}
                runs.append(new)
            assert all(torch.equal(a, b) for a, b in zip(*runs))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_registered_ops_launch_the_kernels_and_count(cuda_device):
    """Each registered op (``ops/library.py``) on CUDA tensors launches its
    kernel once, counted by the wrapper under it, and returns the
    wrapper's output bitwise."""
    from ammcnet_aaai2021_torch.ops import library

    g = torch.Generator(device=cuda_device).manual_seed(17)
    flat = torch.randn(4096, DIM, generator=g, device=cuda_device
                       ).to(torch.bfloat16)
    embed = torch.randn(DIM, 256, generator=g, device=cuda_device)
    x, wk, sx, scale, bias = _int8_case(cuda_device, 44, 2, 9, 13, 32, 64, 9)
    xt, wt, sxt, scale_t, bias_t = _int8_case(cuda_device, 45, 2, 5, 7, 64,
                                              24, 1)
    xp, skip, _ = _pack_site(cuda_device, 46, "cat", torch.bfloat16,
                             (2, 9, 13, 64), 64)
    cases = [
        (library.quantize_topk_fused, quantize_topk_fused, (flat, embed, K)),
        (library.quantize_topk_train_fused, quantize_topk_train_fused,
         (flat, embed, K)),
        (library.qconv3x3_int8, ik.qconv3x3_int8,
         (x, wk, sx, scale, bias, 64)),
        (library.qconv_transpose2x2_int8, ik.qconv_transpose2x2_int8,
         (xt, wt, sxt, scale_t, bias_t, 24)),
        (library.quantize_pack_int8, ik.quantize_pack_int8,
         (xp, torch.tensor([PACK_SX], device=cuda_device), skip)),
    ]
    for op, wrapper, args in cases:
        before = wrapper.launches
        got = op(*args)
        assert wrapper.launches == before + 1, wrapper.__name__
        want = wrapper(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), wrapper.__name__


@pytest.mark.cuda
def test_cuda_artifact_runs_b1_inside_and_refuses_the_cpu(cuda_device,
                                                          tmp_path):
    """A scorer exported on the card (float32, 32x32, 2 videos of 16
    frames) loads, launches B1 twice a forward inside the loaded graph and
    equals the live scorer bitwise; loading it for the CPU raises."""
    from ammcnet_aaai2021_torch.eval.export import (ChunkScorer,
                                                    chunk_example,
                                                    load_scorer, save_scorer)

    gen = init_weights(build_generator(NetConfig(dtype="float32",
                                                 n_embed=64),
                                       per_sample_diff=True),
                       torch.Generator().manual_seed(3))
    gen = gen.to(cuda_device).eval()
    path = str(tmp_path / "scorer.ammc")
    header = save_scorer(path, gen, n_videos=2, frames=16, size=32,
                         window_batch=8)
    assert header["platforms"] == ["cuda"]
    score_chunk, _ = load_scorer(path, device="cuda")
    rgbs, ops = chunk_example(2, 16, 32, cuda_device, torch.float32, seed=5)
    before = quantize_topk_fused.launches
    with torch.no_grad():
        got = score_chunk(rgbs, ops)
        torch.cuda.synchronize()
        assert quantize_topk_fused.launches == before + 2 * 2 * 2
        want = ChunkScorer(gen, window_batch=8)(rgbs, ops)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="cannot serve on"):
        load_scorer(path, device="cpu")


def _correlation_bound(f1, f2, leaky):
    """The plain float32 correlation (before its bf16 rounding) and the
    kernel's allowed gap from it (the module's note)."""
    want = corr_ops.correlation_ref(f1.float(), f2.float(), leaky)
    mag = corr_ops.correlation_ref(f1.float().abs(), f2.float().abs())
    c = f1.shape[1]
    return want, 2.0 ** -8 * want.abs() + c * 2.0 ** -24 * mag + 1e-30


@pytest.mark.cuda
@pytest.mark.parametrize("shape, leaky", [((16, 256, 32, 32), True),
                                          ((15, 256, 32, 32), True),
                                          ((16, 256, 32, 32), False),
                                          ((3, 64, 8, 24), True),
                                          ((2, 128, 16, 64), False)])
def test_correlation_kernel_matches_plain_version(cuda_device, shape, leaky):
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    f1 = torch.randn(shape, generator=g, device=cuda_device).to(torch.bfloat16)
    f2 = torch.randn(shape, generator=g, device=cuda_device).to(torch.bfloat16)
    before = corr_ops.correlation.launches_by_route["kernel"]
    got = corr_ops.correlation(f1, f2, leaky)
    torch.cuda.synchronize()
    assert corr_ops.correlation.launches_by_route["kernel"] == before + 1
    assert got.shape == (shape[0], 441, *shape[2:])
    assert got.dtype == torch.bfloat16
    want, gap = _correlation_bound(f1, f2, leaky)
    assert ((got.float() - want).abs() <= gap).all()
    # the displacements outside the map are exact zeros
    b, c, h, w = shape
    assert not got[:, 0, :20 if h > 20 else h].any()
    plain = corr_ops.correlation_ref(f1, f2, leaky)
    assert (got == plain).float().mean() > 0.99


@pytest.mark.cuda
def test_flownet2_forward_launches_the_correlation_once(cuda_device,
                                                         tmp_path):
    from ammcnet_aaai2021_torch.models import FlowNet2, init_flownet_weights

    from ammcnet_aaai2021_torch.utils import profiling

    net = init_flownet_weights(FlowNet2(), torch.Generator().manual_seed(4))
    net = net.to(cuda_device).eval()
    frames = torch.rand(2, 3, 2, 64, 64, device=cuda_device) * 255
    routes = dict(corr_ops.correlation.launches_by_route)
    convs = []
    for m in net.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.register_forward_hook(lambda *args: convs.append(1))
    with torch.no_grad(), profiling.device_trace(str(tmp_path)):
        flow = net(frames)
        torch.cuda.synchronize()
    assert corr_ops.correlation.launches_by_route == {
        "kernel": routes["kernel"] + 1, "plain": routes["plain"]}
    # fed NCHW, FlowNet 2.0 runs NCHW
    assert profiling.counts() == {"flownet2.pairs": 2,
                                  "flownet2.correlation.kernel": 1,
                                  "conv.layout.nchw": len(convs)}
    spans = profiling.summary()
    assert all(spans[name]["calls"] == n for name, n in (
        ("flownet2.c", 1), ("flownet2.correlation", 1), ("flownet2.s1", 1),
        ("flownet2.s2", 1), ("flownet2.sd", 1), ("flownet2.fusion", 1),
        ("flownet2.warp", 4)))
    assert flow.shape == (2, 2, 64, 64) and torch.isfinite(flow).all()
    exported = torch.export.export(net, (frames,))
    targets = [n.target for n in exported.graph.nodes
               if n.op == "call_function"]
    assert targets.count(torch.ops.ammcnet.correlation.default) == 1
    with torch.no_grad():
        again = exported.module()(frames)
        torch.cuda.synchronize()
    assert corr_ops.correlation.launches_by_route["kernel"] == \
        routes["kernel"] + 2
    assert torch.equal(again, flow)


# the bf16 scoring cell's limits on a window's commit distance against the
# float32 reference, relative (benchmark/limits/score.ped2.bf16.otf.json)
COMMIT_GAP = {"rgb": 0.004, "op": 0.0012}
LAYOUT_TRANSPOSES = ("nchwtonhwc", "nhwctonchw")


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True])
def test_bf16_generator_runs_without_layout_transposes(cuda_device, train):
    """The released bf16 generator on 256x256 windows (8 in eval mode; 4 in
    a stage-2 step's train-mode forward and backward) under
    ``torch.profiler``: no cuDNN ``nchwToNhwc`` / ``nhwcToNchw`` kernel runs,
    all 44 convolutions count channels-last, the predictions leave float32
    NCHW-contiguous, and each window's commit distance lies within
    ``COMMIT_GAP`` of the float32 generator's (TF32 off) on the same
    weights."""
    from ammcnet_aaai2021_torch.utils import profiling

    nets = {dtype: init_weights(
        build_generator(NetConfig(dtype=dtype), per_sample_diff=True),
        torch.Generator().manual_seed(3)).to(cuda_device).train(train)
        for dtype in ("float32", "bfloat16")}
    g = torch.Generator(device=cuda_device).manual_seed(22)
    b = 4 if train else 8
    rgb = torch.rand(b, 12, 256, 256, device=cuda_device, generator=g) * 2 - 1
    op = torch.randn(b, 6, 256, 256, device=cuda_device, generator=g)
    with torch.no_grad():
        want = nets["float32"](rgb, op)
    profiling.reset()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.set_grad_enabled(train), \
            torch.profiler.profile(activities=activities) as prof:
        got = nets["bfloat16"](rgb, op)
        if train:
            (got[0].mean() + got[1].mean() + sum(d.mean() for d in got[2])
             ).backward()
        torch.cuda.synchronize()
    counts = profiling.counts()
    profiling.reset()
    kernels = {e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert kernels, "the profiler saw no kernel on the card"
    assert not [k for k in kernels
                if any(t in k.lower() for t in LAYOUT_TRANSPOSES)]
    assert counts == {"conv.layout.nhwc": 44}
    for pred in got[:2]:
        assert pred.dtype == torch.float32 and pred.is_contiguous()
    for i, stream in enumerate(("rgb", "op")):
        gap = ((got[2][i].float() - want[2][i]).abs()
               / want[2][i].abs()).max().item()
        assert gap <= COMMIT_GAP[stream], (stream, gap)
