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

The tensor-core kernel (``csrc/quantize_topk_mma.cu``) splits the float32
codebook into three bf16 parts; its arithmetic is mirrored here in plain
PyTorch (the split is exact, and the split products rank as the plain
version does under the near-tie rule), :func:`lookup_route` is held to its
rule, and B1's and B2's wrappers to :func:`lookup_route`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ammcnet_aaai2021_tpu.ops.memory import Codebook as JCodebook
from ammcnet_aaai2021_tpu.ops.memory import quantize_topk as j_quantize_topk
from ammcnet_aaai2021_tpu.ops.memory_pallas import (
    quantize_topk_pallas,
    quantize_topk_pallas_train,
)
from ammcnet_aaai2021_torch.ops.memory import Codebook, quantize_topk
from ammcnet_aaai2021_torch.ops.memory_kernels import (
    CUDA_CORE,
    TENSOR_CORE,
    lookup_route,
    quantize_topk_fused,
    quantize_topk_fused_ref,
    quantize_topk_train_fused,
    quantize_topk_train_fused_ref,
    topk_smallest,
)

torch.set_num_threads(2)

DIM, N_EMBED, K = 64, 64, 2
# a top-k index may differ from the plain version's only where the two
# codewords' float64 distances differ by less than this (chip_smoke.py)
NEAR_TIE_REL = 1e-5


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


def split_bf16x3(embed):
    """The tensor-core kernel's split of the f32 codebook: hi = bf16(E),
    mid = bf16(E - hi), lo = bf16(E - hi - mid), each subtraction in f32."""
    hi = embed.to(torch.bfloat16)
    r1 = embed - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


# binary exponents of normal, tiny and large entries: the split is exact
# from 2^-110 (below it lo would need bf16 subnormals finer than 2^-133) to
# bf16's largest finite value, 3.39e38
@pytest.mark.parametrize("exponents", [(-10, 10), (-110, -100), (100, 126)],
                         ids=["normal", "tiny", "large"])
def test_split_bf16x3_is_exact(exponents):
    rng = np.random.default_rng(8)
    mantissa = rng.uniform(1.0, 2.0, size=(DIM, 256))
    sign = rng.choice([-1.0, 1.0], size=(DIM, 256))
    embed = torch.from_numpy(np.ldexp(sign * mantissa, rng.integers(
        *exponents, size=(DIM, 256), endpoint=True)).astype(np.float32))
    hi, mid, lo = split_bf16x3(embed)
    rebuilt = (hi.float() + mid.float()) + lo.float()  # the kernel's gather
    assert torch.equal(rebuilt.view(torch.int32), embed.view(torch.int32))
    # each part carries the next 8 significant bits: lo is 2^-16 of E or less
    assert bool((lo.float().abs() <= embed.abs() * 2.0 ** -16).all())


def test_split_products_pick_the_plain_versions_indices():
    """bf16 latents times each part are exact in f32, so their sum ranks the
    codewords as the plain version's f32 product does, up to near-ties; rows
    whose indices agree gather bitwise equal codewords from the parts."""
    rng = np.random.default_rng(9)
    n, n_embed, k = 2048, 256, 2
    flat = torch.from_numpy((rng.normal(size=(n, DIM)) * 0.5)
                            .astype(np.float32)).to(torch.bfloat16)
    embed = torch.from_numpy(rng.normal(size=(DIM, n_embed))
                             .astype(np.float32))
    hi, mid, lo = split_bf16x3(embed)
    z = flat.float()
    cross = z @ lo.float()  # the smallest terms first, as the kernel adds
    cross = cross + z @ mid.float()
    cross = cross + z @ hi.float()
    dist = torch.addcmul((embed * embed).sum(0, keepdim=True), cross,
                         torch.full_like(cross, -2.0))
    idx = topk_smallest(dist, k)
    rebuilt = ((hi.float() + mid.float()) + lo.float()).t()
    q = rebuilt[idx].reshape(n, k * DIM)

    rq, _, _ = quantize_topk_fused_ref(flat, embed, k)
    ref_idx = topk_smallest(-2.0 * (z @ embed) + (embed * embed).sum(0), k)
    agree = (idx == ref_idx).all(1)
    assert torch.equal(q[agree], rq[agree])
    assert int((~agree).sum()) <= 2  # near-ties only, at this size
    z64, e64 = z[~agree].double(), embed.t().double()
    d_split = (z64[:, None] - e64[idx[~agree]]).square().sum(-1)
    d_ref = (z64[:, None] - e64[ref_idx[~agree]]).square().sum(-1)
    gap = (d_split - d_ref).abs() / torch.maximum(d_split, d_ref)
    assert bool((gap < NEAR_TIE_REL).all())


@pytest.mark.parametrize("dim,n_embed", [(64, 256), (100, 1024), (17, 300)])
def test_six_split_products_pick_the_plain_versions_indices(dim, n_embed):
    """The general route's arithmetic for float32 latents: latents and
    codebook both split into three bf16 parts, six of the nine cross
    products kept (lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi, smallest
    first), each exact in f32: the dropped three are below 2^-24 of |z||E|,
    so the sum ranks the codewords as the plain version's f32 product does,
    up to near-ties in float64."""
    rng = np.random.default_rng(13)
    n, k = 2048, 2
    flat = torch.from_numpy((rng.normal(size=(n, dim)) * 0.5)
                            .astype(np.float32))
    embed = torch.from_numpy(rng.normal(size=(dim, n_embed))
                             .astype(np.float32))
    zh, zm, zl = (p.double() for p in split_bf16x3(flat))
    eh, em, el = (p.double() for p in split_bf16x3(embed))
    # float64 sums of exact products: only the dropped terms differ from z.E
    cross = (zl @ eh + zh @ el + zm @ em + zm @ eh + zh @ em + zh @ eh)
    assert float((cross - flat.double() @ embed.double()).abs().max()) <= (
        2.0 ** -24 * float((flat.double().abs() @ embed.double().abs()).max()))
    dist = (-2.0 * cross.float()) + (embed * embed).sum(0, keepdim=True)
    idx = topk_smallest(dist, k)
    _, _, ridx = quantize_topk_fused_ref(flat, embed, k)
    ref_idx = topk_smallest(-2.0 * (flat @ embed)
                            + (embed * embed).sum(0, keepdim=True), k)
    assert torch.equal(ref_idx[:, 0].to(torch.int32), ridx)
    agree = (idx == ref_idx).all(1)
    assert int((~agree).sum()) <= 2  # near-ties only, at this size
    z64, e64 = flat[~agree].double(), embed.t().double()
    d_split = (z64[:, None] - e64[idx[~agree]]).square().sum(-1)
    d_ref = (z64[:, None] - e64[ref_idx[~agree]]).square().sum(-1)
    gap = (d_split - d_ref).abs() / torch.maximum(d_split, d_ref)
    assert bool((gap < NEAR_TIE_REL).all())


ROUTE_CASES = [
    (torch.bfloat16, 64, 256, 2, TENSOR_CORE),  # the released configuration
    (torch.bfloat16, 64, 256, 1, TENSOR_CORE),  # TopKMemory's default k
    (torch.bfloat16, 64, 32, 4, TENSOR_CORE),
    (torch.bfloat16, 64, 512, 3, TENSOR_CORE),
    (torch.float32, 64, 256, 2, CUDA_CORE),  # f32 latents: the parity path
    (torch.bfloat16, 64, 256, 5, CUDA_CORE),  # k past the instantiated 4
    (torch.bfloat16, 32, 256, 2, CUDA_CORE),  # another latent width
    (torch.bfloat16, 64, 96, 2, CUDA_CORE),  # no tensor-core codebook size
    (torch.bfloat16, 64, 1024, 2, CUDA_CORE),  # over the tensor-core sizes
    (torch.bfloat16, 64, 100, 2, CUDA_CORE),  # not a power of two
    (torch.bfloat16, 128, 256, 2, CUDA_CORE),  # --embed_dim 128
]


@pytest.mark.parametrize("dtype,dim,n_embed,k,route", ROUTE_CASES)
def test_lookup_route(dtype, dim, n_embed, k, route):
    assert lookup_route(dtype, dim, n_embed, k) == route


def test_wrapper_rejects_a_tensor_core_route_the_rule_does_not_give():
    flat, embed = (torch.from_numpy(a) for a in _inputs(10, 16))
    with pytest.raises(ValueError, match="route"):
        quantize_topk_fused(flat, embed, K, route=TENSOR_CORE)  # f32 latents
    got = quantize_topk_fused(flat.to(torch.bfloat16), embed, K,
                              route=CUDA_CORE)  # every input may take it
    want = quantize_topk_fused_ref(flat.to(torch.bfloat16), embed, K)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype,dim,n_embed,k,route", ROUTE_CASES)
def test_train_wrapper_applies_lookup_route(dtype, dim, n_embed, k, route):
    """B2's wrapper takes B1's rule: a forced tensor-core route passes
    exactly where :func:`lookup_route` gives it, and any route returns the
    plain version for CPU tensors without counting a launch."""
    rng = np.random.default_rng(11)
    flat = torch.from_numpy(rng.normal(size=(40, dim)).astype(np.float32)
                            ).to(dtype)
    embed = torch.from_numpy(rng.normal(size=(dim, n_embed))
                             .astype(np.float32))
    want = quantize_topk_train_fused_ref(flat, embed, k)
    before = dict(quantize_topk_train_fused.launches_by_route)
    for asked in (None, CUDA_CORE, TENSOR_CORE):
        if asked == TENSOR_CORE and route != TENSOR_CORE:
            with pytest.raises(ValueError, match="route"):
                quantize_topk_train_fused(flat, embed, k, route=asked)
            continue
        got = quantize_topk_train_fused(flat, embed, k, route=asked)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert quantize_topk_train_fused.launches_by_route == before
    with pytest.raises(ValueError, match="route"):
        quantize_topk_train_fused(flat, embed, k, route="tensor_cores")


@pytest.mark.parametrize("dim,n_embed,k", [(64, 100, 2), (64, 1024, 2),
                                           (128, 1024, 8), (128, 100, 5),
                                           (64, 100, 9), (64, 256, 16)])
def test_plain_versions_match_pallas_at_any_codebook_size(dim, n_embed, k):
    """The codebook shapes the CUDA-core route takes (any n_embed, other
    widths, any k <= n_embed): B1's and B2's plain versions, which the CPU wrappers
    return and the card holds the kernels against, against the JAX package's
    Pallas kernels (interpret mode) on a ragged N."""
    rng = np.random.default_rng(12)
    flat = rng.normal(size=(300, dim)).astype(np.float32)
    embed = rng.normal(size=(dim, n_embed)).astype(np.float32)
    jq, jq1, jidx = quantize_topk_pallas(jnp.asarray(flat), jnp.asarray(embed), k)
    *_, jcounts, jesum = quantize_topk_pallas_train(
        jnp.asarray(flat), jnp.asarray(embed), k)
    tflat, tembed = torch.from_numpy(flat), torch.from_numpy(embed)
    q, q1, idx = quantize_topk_fused(tflat, tembed, k)
    _, _, idx2, counts, esum = quantize_topk_train_fused(tflat, tembed, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx2.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(q1.numpy(), np.asarray(jq1))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    onehot = np.eye(n_embed)[idx.numpy()]
    mag = np.abs(flat.astype(np.float64)).T @ onehot
    assert np.all(np.abs(esum.numpy() - np.asarray(jesum)) <= 1e-5 * mag + 1e-30)
