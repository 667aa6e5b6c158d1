"""Model FLOPs from the configuration's shapes: ``FlopCounterMode`` over
the benchmark's own float32 reference (``benchmark/reference``) on the
meta device, so nothing is computed and nothing of the port is read.
Counted: convolutions and matrix products (the lookups' distances
included), forward and, for the training step, backward; elementwise
work, BatchNorm and the optimizer are not counted."""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import model as ref
from ..reference import train as ref_train


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


# the generators the reference has, by the configuration's ``net_tag``:
# the reference's class and the kind of the port's training step
GENERATORS = {"unet_vq_twostream": (ref.TwoStreamUNetMem, "twostream")}


def _generator(net_tag: str):
    try:
        return GENERATORS[net_tag]
    except KeyError:
        raise ValueError(f"the benchmark's reference has no generator "
                         f"{net_tag!r}; it has {sorted(GENERATORS)}"
                         ) from None


def step_kind(net: dict) -> str:
    """The kind of the port's training step for the configuration's
    generator (``"twostream"``)."""
    return _generator(net["net_tag"])[1]


def build_generator(net: dict, per_sample_diff: bool, device="meta"):
    """The reference's generator of the configuration's ``net_tag``
    (``ValueError`` for a tag the reference lacks)."""
    cls = _generator(net["net_tag"])[0]
    rgb_in, op_in = net["in_channel"]
    rgb_out, op_out = net["out_channel"]
    with torch.device(device):
        return cls(rgb_in, op_in, rgb_out, op_out, net["embed_dim"],
                   net["n_embed"], net["k"], per_sample_diff)


@functools.lru_cache(maxsize=None)
def generator_forward_flops(net_tag="unet_vq_twostream", in_channel=(12, 6),
                            out_channel=(3, 2), embed_dim=64, n_embed=256,
                            k=2, size=256) -> int:
    """FLOPs of one window's eval forward."""
    net = dict(net_tag=net_tag, in_channel=in_channel,
               out_channel=out_channel, embed_dim=embed_dim,
               n_embed=n_embed, k=k)
    gen = build_generator(net, True).eval()
    with torch.no_grad():
        return _count(lambda: gen(
            torch.empty(1, in_channel[0], size, size, device="meta"),
            torch.empty(1, in_channel[1], size, size, device="meta")))


@functools.lru_cache(maxsize=None)
def flownet_pair_flops(size: int = 256) -> int:
    """FLOPs of FlowNet2-SD on one frame pair."""
    with torch.device("meta"):
        net = ref.FlowNet2SD().eval()
    with torch.no_grad():
        return _count(lambda: net(torch.empty(1, 3, 2, size, size,
                                              device="meta")))


@functools.lru_cache(maxsize=None)
def train_step_flops(batch: int, net_tag="unet_vq_twostream",
                     in_channel=(12, 6), out_channel=(3, 2), embed_dim=64,
                     n_embed=256, k=2, size=256,
                     disc_filters=(128, 256, 512, 512)) -> int:
    """FLOPs of one stage-2 step at ``batch`` clips: the generator's
    forward and backward, the discriminator's three forwards and two
    backwards, FlowNet2-SD's two forwards."""
    net = dict(net_tag=net_tag, in_channel=in_channel,
               out_channel=out_channel, embed_dim=embed_dim,
               n_embed=n_embed, k=k)
    gen = build_generator(net, False)
    with torch.device("meta"):
        disc = ref.PixelDiscriminator(disc_filters, out_channel[0])
        flownet = ref.FlowNet2SD().eval().requires_grad_(False)
    t_rgb = in_channel[0] // out_channel[0] + 1
    t_op = in_channel[1] // out_channel[1] + 1
    batch_in = {
        "rgb": torch.empty(batch, t_rgb, size, size, out_channel[0],
                           dtype=torch.uint8, device="meta"),
        "op": torch.empty(batch, t_op, size, size, out_channel[1],
                          device="meta")}
    return _count(lambda: ref_train.losses_and_grads(
        gen, disc, flownet, list(gen.parameters()), list(disc.parameters()),
        batch_in))
