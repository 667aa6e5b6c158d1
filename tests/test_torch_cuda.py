"""PyTorch port: the CUDA kernels on the card.

Every test here needs an NVIDIA GPU and ``nvcc``, and skips without one.
The file imports nothing of JAX, so it also runs on a machine without JAX;
the repository's ``conftest.py`` imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Near-ties: the kernel and the plain version sum the same fp32 products in
another order, so a top-k index may flip where two codewords lie at almost
the same distance; rows whose indices agree must match bitwise.
"""

import pytest
import torch

from ammcnet_aaai2021_torch.configs import NetConfig
from ammcnet_aaai2021_torch.models import TopKMemory, build_generator, init_weights
from ammcnet_aaai2021_torch.ops.memory_kernels import (
    quantize_topk_fused,
    quantize_topk_fused_ref,
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
