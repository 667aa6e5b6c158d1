"""Seeded inputs that hold the GPU JPEG route's kernels to their plain
versions across geometries: the card tests (``tests/test_torch_cuda.py``)
and ``chip_smoke.py`` draw the same ones.

    idct_sweep(n, device) -> n (coefs, qtables, size) for ``idct_islow_u8``
        (IDCT_SWEEP of them in both)
    ycc_sweep(device) -> ((hs, vs), y, cb, cr) chunks for ``ycc_to_rgb_u8``
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

IDCT_SEED, YCC_SEED = 20261017, 26
IDCT_SWEEP = 24  # the IDCT sweep's geometries


def idct_sweep(n: int, device) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                                 Tuple[int, int]]]:
    """``n`` seeded IDCT inputs: 1 to 33 frames of 1 to 90 block rows and
    columns, cropped to 8b - 7 .. 8b pixels (input i leaves i % 8 rows and
    3i % 8 columns of its last blocks out, so every crop shows on both
    axes), tables of quantizers 1 to 255 (every third one 1 to 65535,
    16-bit), coefficients of varying density drawn so that each
    dequantized value lies within +-2^13, which passes the +-512 where
    jidctint.c's range limit would wrap and the SIMD build saturates."""
    rng = np.random.default_rng(IDCT_SEED)
    for i in range(n):
        f = int(rng.integers(1, 34))
        bh, bw = (int(v) for v in rng.integers(1, 91, 2))
        size = (8 * bh - i % 8, 8 * bw - (3 * i) % 8)
        q = rng.integers(1, 65536 if i % 3 == 0 else 256, (f, 64))
        lim = np.maximum((1 << 13) // q, 1)[:, None, None, :]
        c = rng.integers(-lim, lim + 1, (f, bh, bw, 64))
        density = rng.uniform(0, 1, (f, bh, bw, 1))
        c = np.where(rng.uniform(0, 1, c.shape) < density, c, 0)
        yield (torch.from_numpy(c.astype(np.int16)).to(device),
               torch.from_numpy(q.astype(np.uint16)).to(device), size)


# (frames, h, w) of the colour sweep: one frame (no frame axis), chunks at
# odd sizes (ragged chroma edges, widths no multiple of 16 or 4), one row
# and column, a frame and a chunk at 360x640; the last two have enough
# 16-pixel runs for the kernel's 16-pixel form (ycc_to_rgb_kernel), the
# others take its 4-pixel form
YCC_GEOMETRIES = ((None, 61, 97), (5, 61, 97), (3, 1, 1), (7, 33, 17),
                  (None, 360, 640), (2, 129, 255), (8, 360, 640),
                  (32, 181, 333))


def ycc_sweep(device) -> Iterator[Tuple[Tuple[int, int], torch.Tensor,
                                         torch.Tensor, torch.Tensor]]:
    """Seeded random planes for the colour kernel: each of
    ``YCC_GEOMETRIES`` at 4:4:4, 4:2:2 and 4:2:0, the chroma factors (hs,
    vs), Y (F, h, w) and Cb, Cr (F, ch, cw) (2-D planes where F is
    None)."""
    g = torch.Generator(device=device).manual_seed(YCC_SEED)
    for hs, vs in ((1, 1), (2, 1), (2, 2)):
        for frames, h, w in YCC_GEOMETRIES:
            lead = () if frames is None else (frames,)
            ch, cw = -(-h // vs), -(-w // hs)
            yield ((hs, vs), *(torch.randint(0, 256, (*lead, *shape),
                                             dtype=torch.uint8, device=device,
                                             generator=g)
                               for shape in ((h, w), (ch, cw), (ch, cw))))
