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
* ``libjpeg_reference.npz``: the port's host route
  (``ammcnet_aaai2021_torch.data.native.decode_video(device="cpu")``,
  libjpeg, then the float resize), which the GPU route must equal bitwise,
  u8: ``gray_source`` (16, 240, 360) and ``gray_256`` (16, 256, 256), one
  channel of the three equal ones; ``color_source`` (2, 360, 640, 3) and
  ``color_256`` (2, 256, 256, 3); ``progressive_256`` (1, 256, 256, 3);
  ``arithmetic_source`` (1, 240, 360) and ``arithmetic_256`` (1, 256,
  256), one channel (the fixture stays under 3 MB, so the colour
  progressive frame's reference is kept at 256x256 alone).

JPEGs at quality 95 but the arithmetic one, from a fixed seed; the script
builds the libjpeg writer with ``gcc -ljpeg``.  Run from the repository
root:

    python scripts/make_torch_jpeg_fixture.py               # everything
    python scripts/make_torch_jpeg_fixture.py --keep-jpegs  # the last three
                                                            # files, from the
                                                            # committed JPEGs
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "fixtures", "torch_jpeg")
GRAY_FRAMES, GRAY_SHAPE = 16, (240, 360)
COLOR_FRAMES, COLOR_SHAPE = 2, (360, 640)
SIZE = (256, 256)
QUALITY = 95


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


def write_arithmetic(gray, path: str) -> None:
    """A grayscale image written by libjpeg as an arithmetic-coded
    progressive JPEG (``scripts/libjpeg_write.c``, mode ``sof10rst``)."""
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        writer = os.path.join(tmp, "libjpeg_write")
        subprocess.run(["gcc", "-O2", os.path.join(REPO, "scripts",
                                                   "libjpeg_write.c"),
                        "-o", writer, "-ljpeg"], check=True)
        raw = os.path.join(tmp, "in.raw")
        np.ascontiguousarray(gray).tofile(raw)
        subprocess.run([writer, raw, str(gray.shape[1]), str(gray.shape[0]),
                        path, "sof10rst", "gray"], check=True)


def write_references() -> None:
    """``progressive.jpg``, ``arithmetic.jpg``, and the host route's decode
    of the committed JPEGs, at source size and at 256x256, into
    ``libjpeg_reference.npz``."""
    import cv2

    colour = cv2.imread(os.path.join(OUT, "color_00.jpg"))
    if not cv2.imwrite(os.path.join(OUT, "progressive.jpg"), colour,
                       [cv2.IMWRITE_JPEG_QUALITY, QUALITY,
                        cv2.IMWRITE_JPEG_PROGRESSIVE, 1]):
        raise RuntimeError("cv2 could not write progressive.jpg")
    write_arithmetic(cv2.imread(os.path.join(OUT, "gray_00.jpg"),
                                cv2.IMREAD_GRAYSCALE),
                     os.path.join(OUT, "arithmetic.jpg"))
    sys.path.insert(0, REPO)
    from ammcnet_aaai2021_torch.data import native

    out = {}
    for kind, count, shape in (("gray", GRAY_FRAMES, GRAY_SHAPE),
                               ("color", COLOR_FRAMES, COLOR_SHAPE),
                               ("progressive", 1, None),
                               ("arithmetic", 1, GRAY_SHAPE)):
        paths = ([os.path.join(OUT, f"{kind}.jpg")] if count == 1 else
                 [os.path.join(OUT, f"{kind}_{i:02d}.jpg")
                  for i in range(count)])
        for name, size in (("source", shape), ("256", SIZE)):
            if size is None:
                continue
            frames = native.decode_video(paths, size)
            if kind in ("gray", "arithmetic"):
                if not (frames == frames[..., :1]).all():
                    raise RuntimeError("the host route decoded a grayscale "
                                       "JPEG to unequal channels")
                frames = frames[..., 0]
            out[f"{kind}_{name}"] = frames
    np.savez_compressed(os.path.join(OUT, "libjpeg_reference.npz"), **out)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--keep-jpegs", action="store_true",
                        help="write progressive.jpg, arithmetic.jpg and "
                             "libjpeg_reference.npz alone, from the "
                             "committed JPEGs")
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
