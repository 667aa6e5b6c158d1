"""Data-loader throughput harness.

Port of ``ammcnet_aaai2021_tpu/tools/bench_loader.py`` over the port's
``data/`` modules: ``normal`` (the file loader, cv2 for JPEG frames),
``native`` (``data/native.py``: JPEG frames decoded on ``--device``, the
IDCT, colour and resize kernels on a GPU, the C++ loader on the CPU) and
``framepack`` (``data/framepack.py``).

Rebuild of the reference's data-loading benchmark suite
(``Code/dataset/__init__.py:166-1714`` — stas_v1..v4 / test_x1..x61: load-fps
for every (data_type x backend) combination) as one parameterized tool:

  python -m ammcnet_aaai2021_torch.tools.bench_loader --root <frames_root> \
      [--backends normal,native,framepack] [--image_size 256] \
      [--device cuda]

Prints one line per backend: frames/sec for whole-video sequential loading
(the fused scorer's access pattern).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def bench_backend(backend: str, frames_root: str, image_size: int,
                  repeat: int = 3, device: str = "cpu") -> float:
    import numpy as np

    from ..data.datasets import VideoIndex, _decode_rgb

    index = VideoIndex(frames_root)
    names = index.names
    total_frames = sum(index.length(n) for n in names)
    size = (image_size, image_size)

    if backend == "normal":
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=8)

        def load_all():
            for name in names:
                np.stack(list(pool.map(lambda p: _decode_rgb(p, size),
                                       index.videos[name])))

    elif backend == "native":
        import torch

        from ..data import native

        def load_all():
            for name in names:
                native.decode_video(index.videos[name], size, device=device)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)

    elif backend == "framepack":
        from ..data.framepack import pack_video_tree

        tmp = tempfile.mkdtemp()
        pack = pack_video_tree(frames_root, os.path.join(tmp, "b.fpk"),
                               image_size=image_size)

        def load_all():
            for name in pack.names:
                np.ascontiguousarray(pack.video(name))

    else:
        raise ValueError(f"unknown backend {backend!r}")

    load_all()  # warm page cache / build
    t0 = time.perf_counter()
    for _ in range(repeat):
        load_all()
    dt = (time.perf_counter() - t0) / repeat
    return total_frames / dt


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True, help="frames root (video folders)")
    p.add_argument("--backends", default="normal,native,framepack")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="the native backend's decode device; 'cuda' fails "
                        "when no GPU is visible")
    args = p.parse_args(argv)
    import torch

    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "visible (pass --device cpu)")
    results = {}
    for backend in args.backends.split(","):
        try:
            fps = bench_backend(backend, args.root, args.image_size,
                                args.repeat, args.device)
            results[backend] = fps
            print(f"{backend:10s} {fps:10.1f} frames/s")
        except Exception as exc:  # pragma: no cover - env dependent
            print(f"{backend:10s} unavailable: {exc}")
    return results


if __name__ == "__main__":
    main()
