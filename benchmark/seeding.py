"""Everything a run makes from ``--seed``: weights and data.

Each use draws from its own generator, seeded from ``(seed, purpose)``, so
a change in one draw moves no other.  Weights and data are made on the
device the run uses, in a few large calls, in the type they are served in.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

PURPOSES = ("generator", "flownet", "discriminator", "traffic", "order",
            "split", "sample", "check")


def derived_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` from the run's seed (any whole number
    that fits 64 bits)."""
    ss = np.random.SeedSequence([seed % 2 ** 64, PURPOSES.index(purpose)])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def torch_generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        derived_seed(seed, purpose))


def numpy_rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng(derived_seed(seed, purpose))


def _fan_in(m: nn.Module) -> float:
    kh, kw = m.kernel_size
    if isinstance(m, nn.ConvTranspose2d):
        # taps that reach one output pixel
        return m.in_channels * kh * kw / (m.stride[0] * m.stride[1])
    return m.in_channels * kh * kw


def _draw_plan(model: nn.Module) -> List[Tuple[str, str, float]]:
    """(state-dict key, kind, scale) of every float tensor ``model`` holds,
    in state-dict order."""
    plan = []
    for mname, m in model.named_modules():
        p = f"{mname}." if mname else ""
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            plan.append((p + "weight", "normal", math.sqrt(2.0 / _fan_in(m))))
            if m.bias is not None:
                plan.append((p + "bias", "normal", 0.01))
        elif isinstance(m, nn.BatchNorm2d):
            plan += [(p + "weight", "one_plus", 0.1), (p + "bias", "normal", 0.1),
                     (p + "running_mean", "zero", 0.0),
                     (p + "running_var", "one", 0.0)]
        elif hasattr(m, "embed") and hasattr(m, "embed_avg"):
            plan += [(p + "embed", "normal", 1.0),
                     (p + "cluster_size", "zero", 0.0),
                     (p + "embed_avg", "copy_embed", 0.0)]
    return plan


@torch.no_grad()
def make_state(model: nn.Module, seed: int, purpose: str, device
               ) -> Dict[str, torch.Tensor]:
    """A float32 state dict for ``model`` (the port's module or the
    reference's: the names are the same) made on ``device`` from one draw:
    convolutions He-normal (std ``sqrt(2 / fan_in)``, so activations keep
    their scale through ReLU), biases normal(0, 0.01), BatchNorm scale
    ``1 + normal(0, 0.1)`` and shift normal(0, 0.1) with fresh running
    statistics (mean 0, variance 1), codebooks standard normal with
    ``embed_avg`` a copy and zero cluster sizes.  Integer buffers
    (``num_batches_tracked``) are left out."""
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    plan = _draw_plan(model)
    drawn = [(k, kind, s) for k, kind, s in plan
             if kind in ("normal", "one_plus")]
    total = sum(math.prod(shapes[k]) for k, _, _ in drawn)
    flat = torch.randn(total, generator=torch_generator(seed, purpose, device),
                       device=device)
    out, pos = {}, 0
    for key, kind, scale in plan:
        shape = shapes[key]
        n = math.prod(shape)
        if kind in ("normal", "one_plus"):
            t = flat[pos:pos + n].view(shape) * scale
            pos += n
            out[key] = t + 1.0 if kind == "one_plus" else t
        elif kind == "zero":
            out[key] = torch.zeros(shape, device=device)
        elif kind == "one":
            out[key] = torch.ones(shape, device=device)
    for key, kind, _ in plan:
        if kind == "copy_embed":
            out[key] = out[key[:-len("embed_avg")] + "embed"].clone()
    return out


def as_served(state: Dict[str, torch.Tensor], dtype: str
              ) -> Dict[str, torch.Tensor]:
    """``state`` with every value rounded to ``dtype`` (the type a model is
    served in), kept float32: the program and the float32 reference then
    compute with the very same weights."""
    cast = getattr(torch, dtype)
    return {k: v.to(cast).float() for k, v in state.items()}


def load_state(model: nn.Module, state: Dict[str, torch.Tensor]) -> nn.Module:
    """Copy ``state`` into ``model`` (every float tensor it has; integer
    buffers stay as they are)."""
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"state does not fit the model: missing {missing[:4]},"
                       f" unexpected {unexpected[:4]}")
    return model


def pinned(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """A host copy of ``t`` (in page-locked memory when ``pin``)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    host.copy_(t)
    return host


def edge_pad(t: torch.Tensor, length: int) -> torch.Tensor:
    """Repeat the last frame up to ``length`` frames."""
    extra = length - t.shape[0]
    return t if extra <= 0 else torch.cat([t, t[-1:].expand(extra,
                                                            *t.shape[1:])])


def bucket(n: int, size: int) -> int:
    return -(-n // size) * size


FRAMES = ("uniform", "scene")


def scene_frames(g: torch.Generator, t: int, size: int, channels: int,
                 device, blobs: int = 6) -> torch.Tensor:
    """``t`` u8 frames (t, size, size, channels) of one seeded scene: a
    smooth background (a 9x9 field upsampled bicubically, in 0.25..0.75),
    ``blobs`` Gaussian blobs of 3 to 9 % of the side, each tinted and
    moving at its own constant velocity (up to 2 pixels a frame, wrapping
    round the edges), and sensor noise of 2/255.  Every seed draws the same
    numbers of values, so every seed gives the same work."""
    lo = torch.rand((1, channels, 9, 9), generator=g, device=device)
    bg = F.interpolate(lo, size=(size, size), mode="bicubic",
                       align_corners=True)[0].permute(1, 2, 0)
    p = torch.rand((blobs, 5 + channels), generator=g, device=device)
    ts = torch.arange(t, device=device, dtype=torch.float32)[:, None]
    ax = torch.arange(size, device=device, dtype=torch.float32)
    sigma = size * (0.03 + 0.06 * p[:, 4])

    def profile(start, velocity):
        # (t, blobs, size): the blob's Gaussian along one axis, with the
        # distance taken round the wrap
        c = start * size + (velocity - 0.5) * 4.0 * ts
        d = torch.remainder(ax - c[..., None] + size / 2, size) - size / 2
        return torch.exp(-d.square() / (2 * sigma[:, None].square()))

    amp = (p[:, 5:] - 0.5) * 0.8
    scene = torch.einsum("tkh,tkw,kc->thwc", profile(p[:, 0], p[:, 2]),
                         profile(p[:, 1], p[:, 3]), amp)
    noise = torch.randn((t, size, size, channels), generator=g,
                        device=device) * (2.0 / 255.0)
    frames = (0.25 + 0.5 * bg) + scene + noise
    return (frames.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8)


def draw_frames(g: torch.Generator, kind: str, t: int, size: int,
                channels: int, device) -> torch.Tensor:
    """``t`` u8 frames (t, size, size, channels): ``"uniform"`` noise over
    0..255, or one ``"scene"`` (:func:`scene_frames`)."""
    if kind == "uniform":
        return torch.randint(0, 256, (t, size, size, channels), generator=g,
                             device=device, dtype=torch.uint8)
    if kind == "scene":
        return scene_frames(g, t, size, channels, device)
    raise ValueError(f"unknown frames {kind!r}; have {FRAMES}")


@torch.no_grad()
def make_videos(lengths: Sequence[int], size: int, channels: int,
                flows: bool, bucket_size: int, seed: int, device,
                pin: bool, frames: str = "uniform"
                ) -> List[Dict[str, torch.Tensor]]:
    """The test split: each video's u8 frames (T, size, size, channels)
    (:func:`draw_frames` of kind ``frames``) and, with ``flows``, its
    (T - 1, size, size, 2) flows, normal(0, 0.02) in bf16; both
    edge-padded to the next multiple of ``bucket_size`` frames (as the
    port's ``pad_video_to_bucket`` pads a decoded video) and kept on the
    host.  Returns dicts with ``rgb``, ``op`` (or None) and
    ``true_frames``."""
    g = torch_generator(seed, "traffic", device)
    videos = []
    for t in lengths:
        tp = bucket(t, bucket_size)
        rgb = draw_frames(g, frames, t, size, channels, device)
        v = {"rgb": pinned(edge_pad(rgb, tp), pin), "op": None,
             "true_frames": int(t)}
        if flows:
            op = (torch.randn((t - 1, size, size, 2), generator=g,
                              device=device) * 0.02).to(torch.bfloat16)
            v["op"] = pinned(edge_pad(op, tp - 1), pin)
        videos.append(v)
    return videos


class TrainSplit:
    """A device-resident, seeded training split: ``lengths`` videos of u8
    frames (:func:`draw_frames` of kind ``frames``) and bf16 flows
    (normal(0, 0.02)), padded along one frame axis to the longest, and the
    port's aligned clip sampling (a video uniformly, then an offset
    against its own length)."""

    def __init__(self, lengths: Sequence[int], size: int, seed: int, device,
                 clip_rgb: int = 5, clip_op: int = 4,
                 frames: str = "uniform"):
        g = torch_generator(seed, "split", device)
        self.lengths = np.asarray(lengths)
        self.tmax = int(self.lengths.max())
        self.clip_rgb, self.clip_op = clip_rgb, clip_op
        v = len(lengths)
        if frames == "uniform":
            self.rgb = draw_frames(g, frames, v * self.tmax, size, 3, device)
        else:
            self.rgb = torch.cat([draw_frames(g, frames, self.tmax, size, 3,
                                              device) for _ in range(v)])
        self.op = (torch.randn((v * self.tmax, size, size, 2), generator=g,
                               device=device) * 0.02).to(torch.bfloat16)
        self.max_off = self.lengths - clip_rgb  # flows: one fewer than frames
        self.device = torch.device(device)

    def draw(self, rng: np.random.Generator, n: int, distinct: set
             ) -> np.ndarray:
        """``n`` (video, offset) rows, none of them in ``distinct`` (which
        the rows join)."""
        rows = []
        while len(rows) < n:
            vid = int(rng.integers(len(self.lengths)))
            row = (vid, int(rng.integers(self.max_off[vid] + 1)))
            if row not in distinct:
                distinct.add(row)
                rows.append(row)
        return np.asarray(rows)

    def gather(self, rows: np.ndarray) -> Dict[str, torch.Tensor]:
        """``{"rgb": (b, 5, h, w, 3) u8, "op": (b, 4, h, w, 2) bf16}``."""
        base = torch.from_numpy(rows[:, 0] * self.tmax + rows[:, 1]).to(
            self.device)
        out = {}
        for key, t in (("rgb", self.clip_rgb), ("op", self.clip_op)):
            idx = base[:, None] + torch.arange(t, device=self.device)
            out[key] = getattr(self, key)[idx]
        return out

    def calibration_batches(self, rng: np.random.Generator, batches: int,
                            batch: int) -> Iterable[Tuple[torch.Tensor,
                                                          torch.Tensor]]:
        """``batches`` NCHW float32 ``(rgb_x (b, 12, h, w), op_x (b, 6, h,
        w))`` input clips in the model's range, as ``run_test --int8``
        draws its calibration clips from the training split."""
        out = []
        for _ in range(batches):
            clip = self.gather(self.draw(rng, batch, set()))
            rgb = clip["rgb"].float() / 255.0
            rgb = ((rgb - 0.5) / 0.5).permute(0, 1, 4, 2, 3).flatten(1, 2)
            op = clip["op"].float().permute(0, 1, 4, 2, 3).flatten(1, 2)
            out.append((rgb[:, :12].contiguous(), op[:, :6].contiguous()))
        return out
