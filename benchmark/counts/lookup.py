"""Compulsory bytes and operations of the memory lookups (the port's B1 and
B2 on their tensor-core route: bf16 latents of width ``dim``, a float32
codebook of ``n_embed`` codewords, top-``k``).

B1 reads the latents (bf16) and the codebook, and writes the top-k
codewords and the nearest one in float32 with its int32 index.  B2 does
the same and also writes the EMA statistics: a float32 count a codeword
and a float32 sum of the rows that picked it.  The distances are the
products ``z . E`` at float32 accuracy on the bf16 tensor cores: three
bf16 parts of the codebook, so three products.
"""

from .peaks import BF16_FLOPS, bound_s


def b1_bytes(n: int, dim: int = 64, n_embed: int = 256, k: int = 2) -> int:
    return n * dim * 2 + dim * n_embed * 4 + n * k * dim * 4 + n * dim * 4 + n * 4


def b2_bytes(n: int, dim: int = 64, n_embed: int = 256, k: int = 2) -> int:
    return b1_bytes(n, dim, n_embed, k) + n_embed * 4 + dim * n_embed * 4


def lookup_flops(n: int, dim: int = 64, n_embed: int = 256) -> int:
    return 3 * 2 * n * dim * n_embed


def b1_bound_s(n: int, dim: int = 64, n_embed: int = 256, k: int = 2) -> float:
    return bound_s(lookup_flops(n, dim, n_embed), b1_bytes(n, dim, n_embed, k),
                   BF16_FLOPS)


def b2_bound_s(n: int, dim: int = 64, n_embed: int = 256, k: int = 2) -> float:
    return bound_s(lookup_flops(n, dim, n_embed), b2_bytes(n, dim, n_embed, k),
                   BF16_FLOPS)
