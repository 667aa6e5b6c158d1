#!/usr/bin/env python3
"""Device time of the GPU JPEG route's IDCT and colour kernels.

Times ``idct_islow_u8`` on the committed fixture's coefficients (a
32-frame chunk of the 240x360 grayscale frames, and the Y, Cb and Cr
components of a 32-frame chunk of the 360x640 4:2:0 colour frames, the
frames cycled as the raw runs cycle them) and ``ycc_to_rgb_u8`` on seeded
random 4:2:0 360x640 planes, one frame and a 32-frame chunk, each as 20
calls in one CUDA graph replayed 5 times between CUDA events
(chip_smoke.py's ``graph_ms``), beside the card's bound.  A wrapper that
takes one frame a call (the colour kernel before it took chunks) is timed
on the chunk as one call a frame, as its decode launched it.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/torch_jpeg_kernel_timing.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``ammcnet_aaai2021_torch`` is timed (by
default this one), so two commits can be compared in one call on one card,
in the order parent, change, change, parent.  Prints the card's name and
power limit, then one JSON line per input.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_jpeg")
CHUNK = 32


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=REPO)
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs the card")
    sys.path.insert(0, root)
    from ammcnet_aaai2021_torch.data import native

    if not os.path.abspath(native.__file__).startswith(root + os.sep):
        sys.exit(f"imported {native.__file__}, not the package under {root}")
    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)

    def emit(kernel, name, call, bytes_moved, ops, frames):
        b = smoke.bound(bytes_moved, ops, "", "", smoke.FP32_FLOPS, "")
        print(json.dumps({
            "label": args.label, "card": card, "kernel": kernel,
            "input": name, "frames": frames,
            "kernel_ms": smoke.graph_ms(torch, call),
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}),
            flush=True)

    gray = [os.path.join(FIXTURE, f"gray_{i % 16:02d}.jpg")
            for i in range(CHUNK)]
    colour = [os.path.join(FIXTURE, f"color_{i % 2:02d}.jpg")
              for i in range(CHUNK)]
    frames = native.decode_coefs(gray + colour)
    chunks = {"gray": [f[0] for f in frames[:CHUNK]]}
    for c, name in enumerate(("y", "cb", "cr")):
        chunks[f"color_{name}"] = [f[c] for f in frames[CHUNK:]]
    for name, comps in chunks.items():
        coefs = torch.from_numpy(np.stack([c.coefs for c in comps])).cuda()
        q = torch.from_numpy(np.stack([c.qtable for c in comps])).cuda()
        size = comps[0].size
        f, bh, bw, _ = coefs.shape
        emit("idct_islow_u8", name,
             lambda: native.idct_islow_u8(coefs, q, size),
             f * bh * bw * 128 + f * 128 + f * size[0] * size[1],
             f * bh * bw * 1312, f)

    g = torch.Generator(device="cuda").manual_seed(5)
    h, w = 360, 640
    y = torch.randint(0, 256, (CHUNK, h, w), dtype=torch.uint8, device="cuda",
                      generator=g)
    cb, cr = (torch.randint(0, 256, (CHUNK, h // 2, w // 2),
                            dtype=torch.uint8, device="cuda", generator=g)
              for _ in range(2))
    frame = [p[0].contiguous() for p in (y, cb, cr)]
    per_frame = [[p[i].contiguous() for p in (y, cb, cr)]
                 for i in range(CHUNK)]
    try:
        native.ycc_to_rgb_u8(y, cb, cr)
        chunk_call = lambda: native.ycc_to_rgb_u8(y, cb, cr)  # noqa: E731
        chunk_name = "one call"
    except ValueError:  # a wrapper of one frame a call
        def chunk_call():
            for planes in per_frame:
                native.ycc_to_rgb_u8(*planes)
        chunk_name = "one call a frame"
    pixel_bytes = h * w + 2 * (h // 2) * (w // 2) + h * w * 3
    emit("ycc_to_rgb_u8", "4:2:0 360x640, one frame",
         lambda: native.ycc_to_rgb_u8(*frame), pixel_bytes, h * w * 35, 1)
    emit("ycc_to_rgb_u8", f"4:2:0 360x640, 32 frames, {chunk_name}",
         chunk_call, CHUNK * pixel_bytes, CHUNK * h * w * 35, CHUNK)


if __name__ == "__main__":
    main()
