"""Data layer: the (data_type x mode x backend) dataset factory.

Port of ``ammcnet_aaai2021_tpu/data/__init__.py`` (reference
``Code/dataset/__init__.py:52-123``, its 12-way dispatch over data_type in
{rgb, op, rgb_op} x train/test x file-tree/LMDB), with the framepack
backend in LMDB's place.  Testing mode returns None as in the reference
(:117-122): the scorer walks the VideoIndex itself.  The device-resident
backend is built by ``runners/run_train.py`` (it needs a device).
"""

from __future__ import annotations

from .flo import read_flo, write_flo

__all__ = ["read_flo", "write_flo", "get_dataset"]


def get_dataset(data_type: str, mode: str, which_ds: str = "normal",
                *, rgb_root: str = "", op_root: str = "",
                clip_len_rgb: int = 5, clip_len_op: int = 4,
                image_size: int = 256, aligned: bool = True,
                reproduce_flow_bug: bool = True, seed: int = 2017,
                cache_bytes: int = 2 << 30):
    """(data_type, mode, backend) -> a training sampler with ``.batch(b)``,
    or None in testing mode.  Backends: ``normal`` (file tree) and
    ``framepack`` (packed mmap, the successor of the reference's LMDB
    backend, which raises)."""
    if mode == "testing":
        return None
    if mode != "training":
        raise ValueError(f"unknown mode {mode!r}")
    if data_type not in ("rgb", "op", "rgb_op"):
        raise ValueError(f"unknown data_type {data_type!r}")
    root = rgb_root if data_type == "rgb" else op_root
    clip_len = clip_len_rgb if data_type == "rgb" else clip_len_op

    if which_ds == "normal":
        from .datasets import (
            ClipLoader, FrameCache, SingleStreamTrainSampler,
            TwoStreamTrainSampler, VideoIndex)

        if data_type == "rgb_op":
            return TwoStreamTrainSampler(
                VideoIndex(rgb_root), VideoIndex(op_root),
                clip_len_rgb=clip_len_rgb, clip_len_op=clip_len_op,
                aligned=aligned, seed=seed, image_size=image_size,
                reproduce_flow_bug=reproduce_flow_bug,
                cache_bytes=cache_bytes)
        cache = FrameCache(cache_bytes) if cache_bytes else None
        return SingleStreamTrainSampler(
            VideoIndex(root), clip_len,
            ClipLoader(data_type, image_size, reproduce_flow_bug,
                       cache=cache),
            seed=seed)

    if which_ds == "lmdb":
        # the reference's LMDB backend (Code/dataset/lmdb_dataset.py:23-243)
        # needs py-lmdb, which neither the JAX package's machines nor the
        # card's have; framepack keeps its clip semantics over an mmap
        raise ValueError(
            "the 'lmdb' backend was retired: py-lmdb is unavailable and the "
            "path could never run. Use which_ds='framepack' (pack with "
            "data.framepack.pack_video_tree): the same clip semantics, "
            "mmap-fast, tested.")

    if which_ds == "framepack":
        from .framepack import (FramePack, FramePackTrainSampler,
                                FramePackTwoStreamSampler)

        if data_type == "rgb_op":
            return FramePackTwoStreamSampler(
                FramePack(rgb_root), FramePack(op_root),
                clip_len_rgb=clip_len_rgb, clip_len_op=clip_len_op, seed=seed)
        return FramePackTrainSampler(FramePack(root), clip_len, seed=seed,
                                     normalize_rgb=data_type == "rgb")

    raise ValueError(f"unknown which_ds {which_ds!r}")
