"""PyTorch port: the memory op and its fused-kernel module against JAX.

The same numpy inputs (from a seed) go through the JAX package's
``quantize_topk_pallas`` (Pallas in interpret mode on the CPU, as
``tests/test_memory_op.py`` runs it) and pure ``quantize_topk``, and through
the port's plain kernel version ``quantize_topk_fused_ref`` and its
``quantize_topk``.  The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``).

Tolerances: codewords are gathered, not computed, so equal indices give
equal values; 1e-5 absolute covers the straight-through ``z + (q - z)``
round trip.  Commit distances are means of the same squared differences
summed in another order: 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ammcnet_aaai2021_tpu.ops.memory import Codebook as JCodebook
from ammcnet_aaai2021_tpu.ops.memory import quantize_topk as j_quantize_topk
from ammcnet_aaai2021_tpu.ops.memory_pallas import quantize_topk_pallas
from ammcnet_aaai2021_torch.ops.memory import Codebook, quantize_topk
from ammcnet_aaai2021_torch.ops.memory_kernels import (
    quantize_topk_fused,
    quantize_topk_fused_ref,
)

torch.set_num_threads(2)

DIM, N_EMBED, K = 64, 64, 2


def _inputs(seed, n, dup=False):
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=(n, DIM)).astype(np.float32)
    embed = rng.normal(size=(DIM, N_EMBED)).astype(np.float32)
    if dup:  # columns 2m and 2m+1 equal: every distance ties in pairs
        embed[:, 1::2] = embed[:, 0::2]
    return flat, embed


@pytest.mark.parametrize("n", [128, 37])  # 37: not a multiple of any tile
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ref_matches_pallas(dtype, n):
    flat, embed = _inputs(0, n)
    jq, jq1, jidx = quantize_topk_pallas(
        jnp.asarray(flat).astype(dtype), jnp.asarray(embed), K)
    tq, tq1, tidx = quantize_topk_fused_ref(
        torch.from_numpy(flat).to(getattr(torch, dtype)),
        torch.from_numpy(embed), K)
    assert tidx.dtype == torch.int32 and tq.dtype == torch.float32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tq1.numpy(), np.asarray(jq1), rtol=0, atol=1e-5)


def test_fused_ref_lowest_index_wins_ties():
    flat, embed = _inputs(1, 96, dup=True)
    jq, _, jidx = quantize_topk_pallas(jnp.asarray(flat), jnp.asarray(embed), K)
    tq, _, tidx = quantize_topk_fused_ref(torch.from_numpy(flat),
                                          torch.from_numpy(embed), K)
    assert (tidx.numpy() % 2 == 0).all()
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    # round 2 takes the twin of round 1
    np.testing.assert_array_equal(tq[:, :DIM].numpy(), tq[:, DIM:].numpy())
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_fused_ref_matches_pure_jax_topk():
    """The kernel's ranking (||z||^2 dropped) picks what the JAX op's full
    distances pick."""
    flat, embed = _inputs(2, 128)
    cb = JCodebook(jnp.asarray(embed), jnp.zeros(N_EMBED), jnp.asarray(embed))
    jq, *_ = j_quantize_topk(jnp.asarray(flat), cb, K)
    tq, _, _ = quantize_topk_fused_ref(torch.from_numpy(flat),
                                       torch.from_numpy(embed), K)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-5)


def test_wrapper_on_cpu_takes_plain_version_without_counting():
    flat, embed = _inputs(3, 50)
    before = quantize_topk_fused.launches
    got = quantize_topk_fused(torch.from_numpy(flat), torch.from_numpy(embed), K)
    want = quantize_topk_fused_ref(torch.from_numpy(flat),
                                   torch.from_numpy(embed), K)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert quantize_topk_fused.launches == before


@pytest.mark.parametrize("bad", ["dim", "k", "embed_dtype", "flat_dtype",
                                 "contiguity"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    flat, embed = (torch.from_numpy(a) for a in _inputs(4, 16))
    k = K
    if bad == "dim":
        flat = flat[:, :32].contiguous()
    elif bad == "k":
        k = N_EMBED + 1
    elif bad == "embed_dtype":
        embed = embed.to(torch.bfloat16)
    elif bad == "flat_dtype":
        flat = flat.to(torch.float16)
    else:
        flat = flat.t().contiguous().t()
    with pytest.raises(ValueError):
        quantize_topk_fused(flat, embed, k)


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("st_mode", ["top1", "topk"])
@pytest.mark.parametrize("fused", [False, True])
def test_quantize_topk_matches_jax(fused, st_mode, per_sample):
    rng = np.random.default_rng(5)
    z = rng.normal(size=(2, 5, 7, DIM)).astype(np.float32)
    embed = rng.normal(size=(DIM, N_EMBED)).astype(np.float32)
    jcb = JCodebook(jnp.asarray(embed), jnp.zeros(N_EMBED), jnp.asarray(embed))
    jq, jdiff, jst, _ = j_quantize_topk(
        jnp.asarray(z), jcb, K, use_pallas=fused, st_mode=st_mode,
        per_sample=per_sample)
    tcb = Codebook(torch.from_numpy(embed), torch.zeros(N_EMBED),
                   torch.from_numpy(embed))
    tq, tdiff, tst, out_cb = quantize_topk(
        torch.from_numpy(z), tcb, K, use_kernel=fused, st_mode=st_mode,
        per_sample=per_sample)
    assert out_cb is tcb
    assert tq.shape == (2, 5, 7, K * DIM) and tst.shape == (2, 5, 7, DIM)
    assert tdiff.shape == ((2,) if per_sample else ())
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tdiff.numpy(), np.asarray(jdiff), rtol=1e-5)


def test_quantize_topk_keeps_bf16_latents_dtype():
    rng = np.random.default_rng(6)
    z = rng.normal(size=(2, 3, 3, DIM)).astype(np.float32)
    embed = rng.normal(size=(DIM, N_EMBED)).astype(np.float32)
    jcb = JCodebook(jnp.asarray(embed), jnp.zeros(N_EMBED), jnp.asarray(embed))
    jq, jdiff, _, _ = j_quantize_topk(jnp.asarray(z).astype(jnp.bfloat16), jcb,
                                      K, use_pallas=True, per_sample=True)
    tcb = Codebook(torch.from_numpy(embed), torch.zeros(N_EMBED),
                   torch.from_numpy(embed))
    tq, tdiff, _, _ = quantize_topk(torch.from_numpy(z).to(torch.bfloat16),
                                    tcb, K, use_kernel=True, per_sample=True)
    assert tq.dtype == torch.bfloat16 and tdiff.dtype == torch.float32
    np.testing.assert_array_equal(tq.float().numpy(),
                                  np.asarray(jq).astype(np.float32))
    np.testing.assert_allclose(tdiff.numpy(), np.asarray(jdiff), rtol=1e-5)


def test_quantize_topk_train_is_the_training_slices():
    """train=True (ported with the training slice; its parity with JAX is in
    tests/test_torch_train.py) returns a new, EMA-updated codebook and leaves
    the given one as it was."""
    rng = np.random.default_rng(7)
    embed = torch.from_numpy(rng.normal(size=(DIM, N_EMBED)).astype(np.float32))
    tcb = Codebook(embed.clone(), torch.zeros(N_EMBED), embed.clone())
    z = torch.from_numpy(rng.normal(size=(1, 2, 2, DIM)).astype(np.float32))
    _, _, _, new = quantize_topk(z, tcb, K, train=True)
    assert new is not tcb and float(new.cluster_size.sum()) == pytest.approx(
        0.01 * 4)  # (1 - decay) * 4 rows
    assert torch.equal(tcb.embed, embed) and not tcb.cluster_size.any()
