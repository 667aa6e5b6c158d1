"""PyTorch port: the CUDA kernels on the card.

Every test here needs an NVIDIA GPU and ``nvcc``, and skips without one.
The file imports nothing of JAX, so it also runs on a machine without JAX;
the repository's ``conftest.py`` imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Near-ties: the kernel and the plain version sum the same fp32 products in
another order, so a top-k index may flip where two codewords lie at almost
the same distance; rows whose indices agree must match bitwise.  Kernel
B2's counts must equal the histogram of its own top-1 indices, and its
embed_sum the plain sum over those indices within 1e-5 of the magnitude
summed into each entry (another summation order).
"""

import pytest
import torch

from ammcnet_aaai2021_torch.configs import LossConfig, NetConfig, OptimConfig
from ammcnet_aaai2021_torch.models import (
    TopKMemory,
    build_generator,
    build_model,
    init_flownet_weights,
    init_weights,
)
from ammcnet_aaai2021_torch.ops import memory_kernels
from ammcnet_aaai2021_torch.ops.memory_kernels import (
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
def test_kernel_rejects_codebook_over_shared_memory(cuda_device):
    flat = torch.zeros(8, 512, device=cuda_device)
    embed = torch.zeros(512, 512, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        quantize_topk_fused(flat, embed, K)


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
@pytest.mark.parametrize("n", [1037, 4096])
@pytest.mark.parametrize("n_embed", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_kernel_matches_plain_version(cuda_device, dtype, n_embed, n):
    g = torch.Generator(device=cuda_device).manual_seed(9)
    flat = torch.randn(n, DIM, device=cuda_device, generator=g).to(dtype)
    embed = torch.randn(DIM, n_embed, device=cuda_device, generator=g)
    before = quantize_topk_train_fused.launches
    q, q1, idx, counts, esum = quantize_topk_train_fused(flat, embed, K)
    torch.cuda.synchronize()
    assert quantize_topk_train_fused.launches == before + 1
    rq, rq1, ridx, rcounts, _ = quantize_topk_train_fused_ref(flat, embed, K)
    agree = (idx == ridx) & (q == rq).all(dim=1)
    assert int((~agree).sum()) <= 2  # near-ties only, at this size
    assert torch.equal(q[agree], rq[agree]) and torch.equal(q1[agree], rq1[agree])
    assert torch.equal(counts, torch.bincount(idx.long(), minlength=n_embed)
                       .float())
    if bool((idx == ridx).all()):
        assert torch.equal(counts, rcounts)
    one_hot = torch.nn.functional.one_hot(idx.long(), n_embed).double()
    want = flat.double().t() @ one_hot
    mag = flat.double().abs().t() @ one_hot
    assert bool(((esum.double() - want).abs() <= 1e-5 * mag).all())


@pytest.mark.cuda
def test_train_kernel_statistics_are_deterministic(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(10)
    flat = torch.randn(196_608, DIM, device=cuda_device,
                       generator=g).to(torch.bfloat16)
    embed = torch.randn(DIM, 256, device=cuda_device, generator=g)
    first = quantize_topk_train_fused(flat, embed, K)
    for _ in range(3):
        again = quantize_topk_train_fused(flat, embed, K)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_train_kernel_rejects_statistics_over_shared_memory(cuda_device):
    flat = torch.zeros(8, DIM, device=cuda_device)
    embed = torch.zeros(DIM, 512, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        quantize_topk_train_fused(flat, embed, K)


@pytest.mark.cuda
def test_wrappers_size_each_launch_shape_once(cuda_device):
    """The shared-memory check and grid sizing (device queries, occupancy)
    run once per device and shape, not on every launch."""
    flat = torch.randn(300, DIM, device=cuda_device)
    embed = torch.randn(DIM, 64, device=cuda_device)
    memory_kernels._grid.cache_clear()
    for _ in range(3):
        quantize_topk_fused(flat, embed, K)
        quantize_topk_train_fused(flat, embed, K)
    info = memory_kernels._grid.cache_info()
    assert (info.misses, info.hits) == (2, 4)


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
