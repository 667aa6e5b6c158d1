"""The port's kernels as registered PyTorch ops (``torch.library``).

In the JAX package the Pallas kernels are ordinary traceable functions,
so ``jax.export`` sees them.  The port launches its kernels through ctypes
(``ops/memory_kernels.py``, ``ops/int8_kernels.py``), which no tracer can
follow; registered as ops, each kernel is one node of a traced graph and
of a ``torch.export`` artifact (``eval/export.py``), and runs its real
implementation when that graph runs:

* ``ammcnet::quantize_topk``: B1, ``memory_kernels.quantize_topk_fused``;
* ``ammcnet::quantize_topk_train``: B2,
  ``memory_kernels.quantize_topk_train_fused``;
* ``ammcnet::qconv3x3_int8``: ``int8_kernels.qconv3x3_int8``;
* ``ammcnet::qconv_transpose2x2_int8``:
  ``int8_kernels.qconv_transpose2x2_int8``;
* ``ammcnet::quantize_pack_int8``: ``int8_kernels.quantize_pack_int8``,
  the convolutions' statically quantized inputs;
* ``ammcnet::correlation``: ``correlation.correlation``, FlowNet 2.0's
  FlowNetC correlation (``models/flownet2.py``).

Each real implementation calls the wrapper unchanged: a CPU tensor gets
the plain version, a CUDA tensor launches the kernel or raises, and the
wrappers' ``launches`` counters go on counting, inside a loaded artifact
too.  Each fake implementation gives shapes and dtypes only, so the
wrappers' checks run on real tensors alone.  On the CPU the plain version
may return outputs that share storage (B1's ``q1`` is a view of
``q_topk`` at k 1); a registered op may not, so such an output is copied.

No op has an autograd formula: the lookups take detached latents and a
codebook buffer (``ops/memory.py``), and the int8 convolutions and the
correlation serve inference only.

The names :func:`quantize_topk_fused`, :func:`quantize_topk_train_fused`,
:func:`qconv3x3_int8`, :func:`qconv_transpose2x2_int8`,
:func:`quantize_pack_int8` and :func:`correlation` call the ops with the
wrappers' arguments; ``ops/memory.py``, ``models/quantized.py`` and
``models/flownet2.py`` call these.  Each op but the quantize also has a
FLOP formula for ``torch.utils.flop_counter`` (``tools/train_flops.py``):
the lookups' distance product, ``2 * N * dim * n_embed`` (B2: plus ``N *
dim`` adds of its sums), the convolutions' ``2 * N * H * W * taps * Cin *
cols`` at the kernel's padded input width, and the correlation's ``2 * B
* 441 * C * H * W``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import torch
from torch import Tensor

from ..utils import profiling

# set-up (``setup.ops``) from here to the registrations' end.  Each op's
# first call imports ``torch._dynamo`` (``torch.library.custom_op`` wraps
# every implementation in ``torch._disable_dynamo``): imported here, it is
# counted as the ops' set-up
_T_SETUP = time.perf_counter_ns()

import torch._dynamo  # noqa: E402,F401
from torch.utils.flop_counter import register_flop_formula  # noqa: E402

from . import correlation as correlation_kernels  # noqa: E402
from . import int8_kernels, memory_kernels  # noqa: E402

NAMESPACE = "ammcnet"


def _unshared(outs: Sequence[Tensor], inputs: Sequence[Tensor]
              ) -> List[Tensor]:
    """``outs``, each one that shares storage with an input or an earlier
    output copied."""
    seen = {t.untyped_storage().data_ptr() for t in inputs
            if isinstance(t, Tensor)}
    fresh = []
    for t in outs:
        ptr = t.untyped_storage().data_ptr()
        if ptr in seen:
            t = t.clone()
            ptr = t.untyped_storage().data_ptr()
        seen.add(ptr)
        fresh.append(t)
    return fresh


@torch.library.custom_op(f"{NAMESPACE}::quantize_topk", mutates_args=())
def _quantize_topk(flat: Tensor, embed: Tensor, k: int
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    outs = memory_kernels.quantize_topk_fused(flat, embed, k)
    return tuple(_unshared(outs, (flat, embed)))


@_quantize_topk.register_fake
def _(flat, embed, k):
    n, dim = flat.shape
    return (flat.new_empty((n, k * dim), dtype=torch.float32),
            flat.new_empty((n, dim), dtype=torch.float32),
            flat.new_empty((n,), dtype=torch.int32))


@torch.library.custom_op(f"{NAMESPACE}::quantize_topk_train", mutates_args=())
def _quantize_topk_train(flat: Tensor, embed: Tensor, k: int
                         ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    outs = memory_kernels.quantize_topk_train_fused(flat, embed, k)
    return tuple(_unshared(outs, (flat, embed)))


@_quantize_topk_train.register_fake
def _(flat, embed, k):
    n, dim = flat.shape
    n_embed = embed.shape[1]
    f32 = torch.float32
    return (flat.new_empty((n, k * dim), dtype=f32),
            flat.new_empty((n, dim), dtype=f32),
            flat.new_empty((n,), dtype=torch.int32),
            embed.new_empty((n_embed,), dtype=f32),
            embed.new_empty((dim, n_embed), dtype=f32))


def _conv_out_dtype(acc: bool, out_scale: Optional[Tensor]) -> torch.dtype:
    return (torch.int32 if acc else torch.int8 if out_scale is not None
            else torch.bfloat16)


@torch.library.custom_op(f"{NAMESPACE}::qconv3x3_int8", mutates_args=())
def _qconv3x3_int8(x: Tensor, wk: Tensor, sx: Tensor, scale: Tensor,
                   bias: Tensor, cout: int, relu: bool = False,
                   out_scale: Optional[Tensor] = None, acc: bool = False
                   ) -> Tensor:
    out = int8_kernels.qconv3x3_int8(x, wk, sx, scale, bias, cout, relu,
                                     out_scale, acc)
    return _unshared([out], (x, wk, sx, scale, bias, out_scale))[0]


@_qconv3x3_int8.register_fake
def _(x, wk, sx, scale, bias, cout, relu=False, out_scale=None, acc=False):
    n, h, w, _ = x.shape
    return x.new_empty((n, h, w, cout), dtype=_conv_out_dtype(acc, out_scale))


@torch.library.custom_op(f"{NAMESPACE}::qconv_transpose2x2_int8",
                         mutates_args=())
def _qconv_transpose2x2_int8(x: Tensor, wk: Tensor, sx: Tensor, scale: Tensor,
                             bias: Tensor, cout: int, acc: bool = False
                             ) -> Tensor:
    out = int8_kernels.qconv_transpose2x2_int8(x, wk, sx, scale, bias, cout,
                                               acc)
    return _unshared([out], (x, wk, sx, scale, bias))[0]


@_qconv_transpose2x2_int8.register_fake
def _(x, wk, sx, scale, bias, cout, acc=False):
    n, h, w, _ = x.shape
    return x.new_empty((n, 2 * h, 2 * w, cout),
                       dtype=_conv_out_dtype(acc, None))


@torch.library.custom_op(f"{NAMESPACE}::quantize_pack_int8", mutates_args=())
def _quantize_pack_int8(x: Tensor, sx: Tensor, skip: Optional[Tensor] = None,
                        pool: bool = False) -> Tensor:
    out = int8_kernels.quantize_pack_int8(x, sx, skip, pool)
    return _unshared([out], (x, sx, skip))[0]


@_quantize_pack_int8.register_fake
def _(x, sx, skip=None, pool=False):
    n, h, w, c = x.shape
    if skip is not None:
        c = c + skip.shape[-1]
    if pool:
        h, w = h // 2, w // 2
    align = int8_kernels.CIN_ALIGN
    return x.new_empty((n, h, w, (c + align - 1) // align * align),
                       dtype=torch.int8)


@torch.library.custom_op(f"{NAMESPACE}::correlation", mutates_args=())
def _correlation(f1: Tensor, f2: Tensor, leaky: bool = False) -> Tensor:
    return correlation_kernels.correlation(f1, f2, leaky)


@_correlation.register_fake
def _(f1, f2, leaky=False):
    b, _, h, w = f1.shape
    return f1.new_empty((b, correlation_kernels.DISPLACEMENTS, h, w))


@register_flop_formula(torch.ops.ammcnet.quantize_topk)
def _lookup_flop(flat_shape, embed_shape, *args, out_shape=None, **kwargs
                 ) -> int:
    n, dim = flat_shape
    return 2 * n * dim * embed_shape[1]


@register_flop_formula(torch.ops.ammcnet.quantize_topk_train)
def _train_lookup_flop(flat_shape, embed_shape, *args, out_shape=None,
                       **kwargs) -> int:
    n, dim = flat_shape
    return 2 * n * dim * embed_shape[1] + n * dim


@register_flop_formula(torch.ops.ammcnet.qconv3x3_int8)
def _qconv3x3_flop(x_shape, wk_shape, *args, out_shape=None, **kwargs) -> int:
    n, h, w, cin = x_shape
    return 2 * n * h * w * 9 * cin * out_shape[-1]


@register_flop_formula(torch.ops.ammcnet.qconv_transpose2x2_int8)
def _qconv_transpose_flop(x_shape, wk_shape, *args, out_shape=None,
                          **kwargs) -> int:
    n, h, w, cin = x_shape
    return 2 * n * h * w * cin * 4 * out_shape[-1]


@register_flop_formula(torch.ops.ammcnet.correlation)
def _correlation_flop(f1_shape, f2_shape, *args, out_shape=None, **kwargs
                      ) -> int:
    b, c, h, w = f1_shape
    return 2 * b * correlation_kernels.DISPLACEMENTS * c * h * w


profiling.add_setup("setup.ops", _T_SETUP)


def quantize_topk_fused(flat: Tensor, embed: Tensor, k: int
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """B1 through ``ammcnet::quantize_topk`` (arguments and results as
    ``memory_kernels.quantize_topk_fused``'s, its rule picking the
    route)."""
    return torch.ops.ammcnet.quantize_topk(flat, embed, k)


def quantize_topk_train_fused(flat: Tensor, embed: Tensor, k: int
                              ) -> Tuple[Tensor, Tensor, Tensor, Tensor,
                                         Tensor]:
    """B2 through ``ammcnet::quantize_topk_train`` (as
    ``memory_kernels.quantize_topk_train_fused``)."""
    return torch.ops.ammcnet.quantize_topk_train(flat, embed, k)


def qconv3x3_int8(x: Tensor, wk: Tensor, sx: Tensor, scale: Tensor,
                  bias: Tensor, cout: int, relu: bool = False,
                  out_scale: Optional[Tensor] = None, acc: bool = False
                  ) -> Tensor:
    """``int8_kernels.qconv3x3_int8`` through ``ammcnet::qconv3x3_int8``."""
    return torch.ops.ammcnet.qconv3x3_int8(x, wk, sx, scale, bias, cout, relu,
                                           out_scale, acc)


def qconv_transpose2x2_int8(x: Tensor, wk: Tensor, sx: Tensor, scale: Tensor,
                            bias: Tensor, cout: int, acc: bool = False
                            ) -> Tensor:
    """``int8_kernels.qconv_transpose2x2_int8`` through
    ``ammcnet::qconv_transpose2x2_int8``."""
    return torch.ops.ammcnet.qconv_transpose2x2_int8(x, wk, sx, scale, bias,
                                                     cout, acc)


def quantize_pack_int8(x: Tensor, sx: Tensor, skip: Optional[Tensor] = None,
                       pool: bool = False) -> Tensor:
    """``int8_kernels.quantize_pack_int8`` through
    ``ammcnet::quantize_pack_int8``."""
    return torch.ops.ammcnet.quantize_pack_int8(x, sx, skip, pool)


def correlation(f1: Tensor, f2: Tensor, leaky: bool = False) -> Tensor:
    """``correlation.correlation`` through ``ammcnet::correlation``."""
    return torch.ops.ammcnet.correlation(f1, f2, leaky)
