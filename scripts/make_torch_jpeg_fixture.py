#!/usr/bin/env python3
"""Write the JPEG fixture that the port's GPU decode is held against.

The card's machine has no cv2 and no libjpeg, so the fixture carries cv2's
own decode with it.  It writes, into ``tests/fixtures/torch_jpeg/``:

* ``gray_00.jpg`` .. ``gray_15.jpg``: 16 grayscale frames at UCSD Ped2's
  native 240x360, a lit walkway with pedestrians (dark blobs) that move a
  few pixels a frame, so consecutive frames carry optical flow;
* ``color_00.jpg``, ``color_01.jpg``: 2 colour frames at Avenue's 360x640,
  chroma subsampled 4:2:0;
* ``reference.npz``: cv2's decode (``cv2.imread``, BGR to RGB) of each,
  resized to 256x256 by ``cv2.resize`` (INTER_LINEAR), u8: ``color``
  (2, 256, 256, 3) and ``gray`` (16, 256, 256), one channel of the three
  equal ones cv2 gives a grayscale JPEG (the script checks they are equal);
* ``progressive.jpg``: ``color_00.jpg``'s decode re-encoded progressive
  (SOF2) by cv2 at quality 95;
* ``arithmetic.jpg``: ``gray_00.jpg``'s decode re-encoded by libjpeg
  arithmetic-coded and progressive (SOF10, quality 85,
  ``scripts/libjpeg_write.c`` mode ``sof10rst``: restart intervals of 3
  MCUs), which cv2 cannot write;
* ``gray_c5.jpg``: a grayscale JPEG of seeded noise whose host-route
  decode at 160x160 and at 248x103 puts a channel-0 value 1 LSB off
  channels 1 and 2 (the JAX loader's build fuses that channel's product
  the other way; fault C5 in ``ROADMAP.md``): the first of a seeded loop
  of random sizes that does at both, at quality 95.  At 256x256 no JPEG
  can show it: a power-of-two width makes every horizontal weight a
  multiple of 1/512, so both fused orders are exact and equal;
* ``smooth_partial.jpg``, ``smooth_dconly.jpg``, ``smooth_al1.jpg``,
  ``smooth_arith.jpg``: progressive JPEGs that libjpeg block-smooths at
  output (jdcoefct.c decompress_smooth_data), written by
  ``scripts/libjpeg_write.c`` from crops of ``color_00.jpg`` and
  ``gray_00.jpg``: 4:2:0 colour in mode ``partial`` (AC never refined past
  Al = 1), grayscale in mode ``dconly`` (one DC scan: the DC is
  re-estimated too), colour in mode ``al1`` (AC 1-9 once at Al = 1), and
  grayscale in mode ``arithpartial`` (``partial``, arithmetic-coded);
* ``trunc_rst.jpg``, ``trunc_progressive.jpg``, ``trunc_arith.jpg``:
  truncated files (fault C7 in ``ROADMAP.md``), the first bytes of a crop
  of ``color_00.jpg``'s decode re-encoded: by cv2 at quality 90 with a
  restart interval of 4 MCUs, cut at 50 % (libjpeg skips the scan's rest
  and decodes, where a decode that stops at the first restart marker it
  does not find fails); by cv2 at quality 90, progressive, cut at 30 %
  (libjpeg block-smooths the rows past the last good one with the
  coefficient bits from before the cut scan); and by libjpeg
  arithmetic-coded and progressive (mode ``sof10``), cut at 10 % (the zero
  bytes decoded past the end drive the IDCT where libjpeg's SIMD build
  saturates);
* ``libjpeg_reference.npz``: the port's host route
  (``ammcnet_aaai2021_torch.data.native.decode_video(device="cpu")``,
  libjpeg, then the float resize), which the GPU route must equal bitwise,
  u8 RGB, every array (T, h, w, 3): ``gray_source`` (16, 240, 360) and
  ``gray_256``; ``color_source`` (2, 360, 640) and ``color_256``;
  ``progressive_256``; ``arithmetic_source`` (240, 360) and
  ``arithmetic_256``; ``gray_c5_160``, ``gray_c5_248x103`` and
  ``gray_c5_256``; each smoothing
  file's and each truncated file's ``_source`` and ``_256``.  It is a zip of ``.npy`` files as
  ``np.savez`` writes, compressed with LZMA (``np.load`` reads it), so that
  the fixture stays under 3 MB with the grayscale frames on three channels
  (the colour progressive frame's reference is kept at 256x256 alone).

JPEGs at quality 95 but the libjpeg-written ones (85), from fixed seeds;
the script needs cv2 and libjpeg's headers and library (it builds the
libjpeg writer with ``gcc -ljpeg`` and the port's host loader with
``g++ -ljpeg``).  Run from the repository root on such a host:

    python scripts/make_torch_jpeg_fixture.py               # everything
    python scripts/make_torch_jpeg_fixture.py --keep-jpegs  # all but the
                                                            # cv2 frames and
                                                            # reference.npz,
                                                            # from the
                                                            # committed ones
"""

from __future__ import annotations

import argparse
import io
import os
import subprocess
import sys
import tempfile
import zipfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "fixtures", "torch_jpeg")
GRAY_FRAMES, GRAY_SHAPE = 16, (240, 360)
COLOR_FRAMES, COLOR_SHAPE = 2, (360, 640)
SIZE = (256, 256)
QUALITY = 95
# gray_c5.jpg: the seed of its loop and the sizes it is resized to, where
# its channel 0 must be off (the ROADMAP reproducer's 248x103 among them)
C5_SEED, C5_SIZES = 3, {"160": (160, 160), "248x103": (248, 103)}
# the smoothing fixtures: (name, libjpeg_write.c mode, source, crop (top,
# left, height, width)); ragged sizes, an odd number of 4:2:0 MCU rows
SMOOTH = (("smooth_partial", "partial", "color", (40, 96, 136, 200)),
          ("smooth_dconly", "dconly", "gray", (20, 60, 120, 172)),
          ("smooth_al1", "al1", "color", (150, 300, 104, 168)),
          ("smooth_arith", "arithpartial", "gray", (100, 150, 96, 140)))
# the truncated fixtures: (name, writer, crop (top, left, height, width) of
# color_00.jpg's decode, per cent of the bytes kept)
TRUNCATED = (("trunc_rst", "rst", (40, 96, 136, 200), 50),
             ("trunc_progressive", "progressive", (40, 96, 136, 200), 30),
             ("trunc_arith", "sof10", (0, 0, 176, 320), 10))


def gray_frames(rng: np.random.Generator) -> list:
    h, w = GRAY_SHAPE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    walkway = 150 + 40 * np.cos(xx / 90.0) - 30 * (yy / h)
    walkway += 6 * np.sin(xx / 7.0) * np.sin(yy / 11.0)  # paving texture
    walkers = [(rng.uniform(20, w - 20), rng.uniform(40, h - 40),
                rng.uniform(-3, 3), rng.uniform(-1.5, 1.5)) for _ in range(5)]
    frames = []
    for t in range(GRAY_FRAMES):
        img = walkway.copy()
        for x0, y0, vx, vy in walkers:
            cx, cy = x0 + vx * t, y0 + vy * t
            img -= 90 * np.exp(-(((xx - cx) / 6.0) ** 2
                                 + ((yy - cy) / 14.0) ** 2))
        img += rng.normal(0, 0.5, img.shape)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def color_frames(rng: np.random.Generator) -> list:
    h, w = COLOR_SHAPE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for i in range(COLOR_FRAMES):
        bgr = np.stack([120 + 60 * np.sin(xx / (40 + 9 * c) + i)
                        * np.cos(yy / (55 - 7 * c)) for c in range(3)], -1)
        for _ in range(6):  # coloured objects with sharp chroma edges
            x, y = rng.integers(40, w - 80), rng.integers(40, h - 80)
            bgr[y:y + 50, x:x + 30] = rng.uniform(0, 255, 3)
        bgr += rng.normal(0, 0.5, bgr.shape)
        frames.append(np.clip(bgr, 0, 255).astype(np.uint8))
    return frames


def libjpeg_write(img, path: str, mode: str) -> None:
    """``img`` (gray (h, w), or RGB (h, w, 3)) written by libjpeg in
    ``scripts/libjpeg_write.c``'s ``mode``, which cv2 cannot ask for."""
    with tempfile.TemporaryDirectory() as tmp:
        writer = os.path.join(tmp, "libjpeg_write")
        subprocess.run(["gcc", "-O2", os.path.join(REPO, "scripts",
                                                   "libjpeg_write.c"),
                        "-o", writer, "-ljpeg"], check=True)
        raw = os.path.join(tmp, "in.raw")
        np.ascontiguousarray(img).tofile(raw)
        subprocess.run([writer, raw, str(img.shape[1]), str(img.shape[0]),
                        path, mode] + (["gray"] if img.ndim == 2 else []),
                       check=True)


def write_gray_c5(native, path: str) -> None:
    """The first of a seeded loop of grayscale noise JPEGs (random sizes,
    quality 95) whose host-route decode has a channel-0 value off channels
    1 and 2 at each of ``C5_SIZES``."""
    import cv2

    rng = np.random.default_rng(C5_SEED)
    for _ in range(1000):
        h, w = rng.integers(16, 160, 2)
        img = rng.integers(0, 256, (h, w), np.uint8)
        if not cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, QUALITY]):
            raise RuntimeError(f"cv2 could not write {path}")
        frames = [native.decode_video([path], size)
                  for size in C5_SIZES.values()]
        if all((f[..., 0] != f[..., 1]).any() for f in frames):
            return
    raise RuntimeError("no grayscale JPEG of the loop shows C5")


def write_truncated(bgr, path: str, writer: str, keep: int) -> None:
    """``bgr`` encoded by ``writer`` ("rst" and "progressive": cv2 at
    quality 90, a restart interval of 4 MCUs or progressive; else
    ``scripts/libjpeg_write.c``'s mode of that name), then cut to the first
    ``keep`` per cent of its bytes."""
    import cv2

    if writer == "rst":
        params = [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL,
                  4]
    elif writer == "progressive":
        params = [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE,
                  1]
    if writer in ("rst", "progressive"):
        if not cv2.imwrite(path, bgr, params):
            raise RuntimeError(f"cv2 could not write {path}")
    else:
        libjpeg_write(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB), path, writer)
    with open(path, "rb") as fh:
        data = fh.read()
    with open(path, "wb") as fh:
        fh.write(data[:len(data) * keep // 100])


def save_lzma_npz(path: str, arrays: dict) -> None:
    """``np.savez``'s layout (one ``.npy`` a key in a zip), LZMA-compressed."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_LZMA) as z:
        for name, arr in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.ascontiguousarray(arr))
            z.writestr(f"{name}.npy", buf.getvalue())


def write_references() -> None:
    """``progressive.jpg``, ``arithmetic.jpg``, ``gray_c5.jpg``, the
    smoothing fixtures, and the host route's decode of the committed JPEGs
    into ``libjpeg_reference.npz``."""
    import cv2

    colour = cv2.imread(os.path.join(OUT, "color_00.jpg"))
    gray = cv2.imread(os.path.join(OUT, "gray_00.jpg"), cv2.IMREAD_GRAYSCALE)
    if not cv2.imwrite(os.path.join(OUT, "progressive.jpg"), colour,
                       [cv2.IMWRITE_JPEG_QUALITY, QUALITY,
                        cv2.IMWRITE_JPEG_PROGRESSIVE, 1]):
        raise RuntimeError("cv2 could not write progressive.jpg")
    libjpeg_write(gray, os.path.join(OUT, "arithmetic.jpg"), "sof10rst")
    for name, mode, kind, (top, left, h, w) in SMOOTH:
        img = (cv2.cvtColor(colour, cv2.COLOR_BGR2RGB) if kind == "color"
               else gray)[top:top + h, left:left + w]
        libjpeg_write(img, os.path.join(OUT, f"{name}.jpg"), mode)
    for name, writer, (top, left, h, w), keep in TRUNCATED:
        write_truncated(colour[top:top + h, left:left + w],
                        os.path.join(OUT, f"{name}.jpg"), writer, keep)
    sys.path.insert(0, REPO)
    from ammcnet_aaai2021_torch.data import native

    write_gray_c5(native, os.path.join(OUT, "gray_c5.jpg"))
    kinds = [("gray", GRAY_FRAMES, {"source": GRAY_SHAPE}),
             ("color", COLOR_FRAMES, {"source": COLOR_SHAPE}),
             ("progressive", 1, {}), ("arithmetic", 1, {"source": GRAY_SHAPE}),
             ("gray_c5", 1, C5_SIZES)]
    kinds += [(name, 1, {"source": (h, w)})
              for name, _, _, (_, _, h, w) in SMOOTH]
    kinds += [(name, 1, {"source": (h, w)})
              for name, _, (_, _, h, w), _ in TRUNCATED]
    out = {}
    for kind, count, sizes in kinds:
        paths = ([os.path.join(OUT, f"{kind}.jpg")] if count == 1 else
                 [os.path.join(OUT, f"{kind}_{i:02d}.jpg")
                  for i in range(count)])
        for name, size in {**sizes, "256": SIZE}.items():
            out[f"{kind}_{name}"] = native.decode_video(paths, size)
    save_lzma_npz(os.path.join(OUT, "libjpeg_reference.npz"), out)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--keep-jpegs", action="store_true",
                        help="keep the committed cv2 frames and "
                             "reference.npz; write the rest from them")
    if parser.parse_args().keep_jpegs:
        write_references()
        return
    import cv2

    os.makedirs(OUT, exist_ok=True)
    rng = np.random.default_rng(20200525)
    params = [cv2.IMWRITE_JPEG_QUALITY, QUALITY,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
    refs = {"gray": [], "color": []}
    for kind, frames in (("gray", gray_frames(rng)),
                         ("color", color_frames(rng))):
        for i, img in enumerate(frames):
            path = os.path.join(OUT, f"{kind}_{i:02d}.jpg")
            if not cv2.imwrite(path, img, params):
                raise RuntimeError(f"cv2 could not write {path}")
            rgb = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
            ref = cv2.resize(rgb, (SIZE[1], SIZE[0]))
            if kind == "gray":
                if not (np.array_equal(ref[..., 0], ref[..., 1])
                        and np.array_equal(ref[..., 0], ref[..., 2])):
                    raise RuntimeError(f"cv2 decoded {path} to unequal "
                                       "channels")
                ref = ref[..., 0]
            refs[kind].append(ref)
    np.savez_compressed(os.path.join(OUT, "reference.npz"),
                        **{k: np.stack(v) for k, v in refs.items()})
    write_references()


if __name__ == "__main__":
    main()
