"""Operations and compulsory bytes of the int8 convolutions of one serving
forward of the released two-stream generator (the port's
``qconv3x3_int8`` and ``qconv_transpose2x2_int8``), from the shapes.

A 3x3 convolution reads its int8 input (its true channels) and int8
weights, and writes bf16, or int8 where it is the first of a DoubleConv
with calibrated scales (its output is quantized in its epilogue to the
next convolution's scale); scales and biases are float32 a channel.  A
2x2 transposed convolution reads int8 and writes bf16 at twice the side.
Operations: two a multiply-add.
"""

import functools
from typing import List, Tuple

import torch
import torch.nn as nn

from . import model
from .peaks import INT8_OPS, bound_s

# (module name, cin, cout, side of the output, transposed, int8 output)
Conv = Tuple[str, int, int, int, bool, bool]


def _first_of_double(gen: nn.Module, name: str) -> bool:
    """Whether the convolution ``name`` is the first of a DoubleConv
    (``<block>.conv.0``), whose epilogue the int8 forward quantizes."""
    parent, _, index = name.rpartition(".")
    block = parent.rpartition(".")[0]
    return index == "0" and type(gen.get_submodule(block)).__name__ == \
        "DoubleConv"


@functools.lru_cache(maxsize=None)
def forward_convs(net_tag: str = "unet_vq_twostream", in_channel=(12, 6),
                  out_channel=(3, 2), embed_dim: int = 64,
                  n_embed: int = 256, k: int = 2, size: int = 256
                  ) -> Tuple[Conv, ...]:
    """The quantized convolutions of one serving forward, in the order it
    runs them: every 3x3 convolution and every transposed convolution of
    the configuration's generator, found by a forward of the benchmark's
    reference on the meta device (the released generator: 34 3x3 and 6
    transposed)."""
    net = dict(net_tag=net_tag, in_channel=in_channel,
               out_channel=out_channel, embed_dim=embed_dim, n_embed=n_embed,
               k=k)
    gen = model.build_generator(net, True).eval()
    convs: List[Conv] = []

    def hook(name):
        def record(m, _, out):
            transposed = isinstance(m, nn.ConvTranspose2d)
            convs.append((name, m.in_channels, m.out_channels, out.shape[-1],
                          transposed,
                          not transposed and _first_of_double(gen, name)))
        return record

    for name, m in gen.named_modules():
        if isinstance(m, nn.ConvTranspose2d) or (
                isinstance(m, nn.Conv2d) and m.kernel_size == (3, 3)):
            m.register_forward_hook(hook(name))
    with torch.no_grad():
        gen(torch.empty(1, in_channel[0], size, size, device="meta"),
            torch.empty(1, in_channel[1], size, size, device="meta"))
    return tuple(convs)


def _net_key(net: dict, size: int) -> tuple:
    return (net["net_tag"], tuple(net["in_channel"]),
            tuple(net["out_channel"]), net["embed_dim"], net["n_embed"],
            net["k"], size)


def calls(net: dict, transposed: bool, size: int) -> int:
    """Launches of the 3x3 (or transposed) int8 kernel in one forward."""
    return sum(c[4] == transposed for c in forward_convs(*_net_key(net, size)))


def conv_ops_bytes(conv: Conv, n: int) -> Tuple[int, int]:
    _, cin, cout, side, transposed, int8_out = conv
    if transposed:
        ops = 2 * n * (side // 2) ** 2 * cin * cout * 4
        read = n * (side // 2) ** 2 * cin + 4 * cin * cout
    else:
        ops = 2 * n * side * side * cin * cout * 9
        read = n * side * side * cin + 9 * cin * cout
    write = n * side * side * cout * (1 if int8_out else 2)
    return ops, read + write + 8 * cout


def forward_bound_s(n: int, transposed: bool, net: dict, size: int
                    ) -> float:
    """Sum over one forward's 3x3 (or transposed) int8 convolutions of each
    one's bound, at ``n`` windows."""
    return sum(bound_s(*conv_ops_bytes(c, n), INT8_OPS)
               for c in forward_convs(*_net_key(net, size))
               if c[4] == transposed)

