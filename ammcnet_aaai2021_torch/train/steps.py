"""The train steps: stage 2 (two-stream, joint GAN training) and stage 1
(one modality).

Port of ``make_twostream_train_step`` and ``make_single_stream_train_step``
in ``ammcnet_aaai2021_tpu/train/steps.py`` (reference
``Code/run_helper/train_helper.py:217-427``, ``train_from_multi_pretain``;
``train_base`` for stage 1).  The stage-2 step:

* one train-mode generator forward, shared by the G loss and (detached)
  the D loss.  BatchNorm statistics and the EMA codebooks update inside it,
  as the JAX step's mutable collections do;
* the FlowNet2-SD teacher runs on (target, prediction) and (target, target)
  under ``no_grad`` (train_helper.py:309-316 detaches it): the flow term is
  observational, with no gradient to G, but its value enters the G loss;
* ``d_gen`` for the G loss comes from the discriminator as it was before the
  step (train_helper.py:318-339).  G's gradient is taken with respect to G's
  parameters only and D's with respect to D's, from the D loss alone, so the
  G loss's backward through D leaves nothing on D (the JAX step
  differentiates each loss with respect to its own parameters);
* then both optimizers step and both schedulers advance.

Each step is the span ``train_step`` (``utils/profiling.py``), its phases
the spans ``train_step.forward`` (G), ``.teacher`` (FlowNet2-SD),
``.discriminator`` (the D forwards and both losses), ``.backward`` and
``.optimizer`` (the gradients' assignment and average, the optimizers and
schedulers); a stage-1 step has the same, ``.teacher`` only for a flow loss.

``freeze_codebook=True`` puts the three codebook buffers back as they were
before the step (the JAX step discards the codebook update).

``remat=True`` (JAX ``jax.checkpoint(gen_apply)``) wraps the generator
forward in ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: its
activations are not kept, and the backward pass reruns the forward.  The
forward writes state (BatchNorm running statistics, the EMA codebooks), so
the step defers those writes (``models.blocks.deferred_buffer_updates``):
the first forward records its new values, the rerun (inside
``models.blocks.recomputing``) drops its own and looks the codebook up as
it was before the step, through the inference lookup (kernel B1, whose
indices are B2's), and the recorded values are written once, after the
backward.  A remat step so launches B2 once and B1 once per memory block.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.utils.checkpoint

from ..configs import CHANNEL, LossConfig
from ..losses.primitives import discriminate_loss
from ..losses.zoo import LOSS_TAGS
from ..models import BatchNorm2d, TopKMemory
from ..models.blocks import (deferred_buffer_updates, recomputing,
                             write_buffers)
from ..parallel.multihost import all_reduce_sum, process_count
from ..utils.profiling import span
from .state import TrainState

CODEBOOK_BUFFERS = ("embed", "cluster_size", "embed_avg")


def _to_model_range(x: torch.Tensor) -> torch.Tensor:
    """Accept clips in the layouts the data layer emits and return float32
    NCHW ``(b, t*c, h, w)`` in the model's range:

    * uint8 is normalized ``(x/255 - .5)/.5``, other dtypes cast to float32;
    * frame-packed ``(b, t, h, w, c)`` is interleaved to channel ``t*c + ch``
      (the order of the reference's ``view(b, -1, h, w)`` fold); a 4-D input
      is taken as NCHW already."""
    if x.dtype == torch.uint8:
        x = (x.float() / 255.0 - 0.5) / 0.5
    elif x.dtype != torch.float32:
        x = x.float()
    if x.ndim == 5:
        b, t, h, w, c = x.shape
        x = x.permute(0, 1, 4, 2, 3).reshape(b, t * c, h, w)
    return x


def _flow_pair(flownet: nn.Module, last_frame: torch.Tensor,
               frame: torch.Tensor) -> torch.Tensor:
    """FlowNet2-SD on a ([-1, 1] range) frame pair with the reference's
    scaling (train_helper.py:309-316): to [0, 255], net, /255."""
    pair = torch.stack([(last_frame * 0.5 + 0.5) * 255.0,
                        (frame * 0.5 + 0.5) * 255.0], dim=2)  # (b,3,2,h,w)
    return flownet(pair) / 255.0


def codebook_buffers(generator: nn.Module) -> Dict[str, torch.Tensor]:
    """Every memory block's codebook buffers, by state-dict name."""
    return {f"{name}.{buf}": getattr(m, buf)
            for name, m in generator.named_modules()
            if isinstance(m, TopKMemory) for buf in CODEBOOK_BUFFERS}


class _FrozenCodebook:
    """``freeze_codebook``: puts the generator's codebook buffers back as
    they were before the forward (the JAX step discards the codebook
    update)."""

    def __init__(self, generator: nn.Module, active: bool):
        self.generator = generator
        self.saved: Optional[Dict[str, torch.Tensor]] = None
        if active:
            self.saved = {k: v.clone()
                          for k, v in codebook_buffers(generator).items()}

    @torch.no_grad()
    def restore(self) -> None:
        if self.saved is not None:
            for key, buf in codebook_buffers(self.generator).items():
                buf.copy_(self.saved[key])


def _average(tensors, group) -> list:
    """The tensors averaged over the group's ranks, in one all-reduce of a
    flattened buffer."""
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]), group)
    flat /= process_count(group)
    return [chunk.view_as(t) for chunk, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)]


def _update(state: TrainState, g_loss: torch.Tensor,
            d_loss: torch.Tensor, after_backward: Callable = lambda: None,
            group=None) -> None:
    """G's gradient from the G loss w.r.t. G's parameters only, D's from
    the D loss w.r.t. D's (the JAX steps differentiate each loss with
    respect to its own parameters); ``after_backward()``; under a
    ``group``, each model's gradients averaged over the ranks; then both
    optimizers and schedulers step and the step count advances.

    Each rank's loss is the mean over its shard, and the BatchNorm
    all-reduces send their gradients back summed over the ranks, so the
    sum of the ranks' gradients is that of the sum of their losses; over
    the world size, that of the global batch's mean loss."""
    g_params = list(state.generator.parameters())
    d_params = list(state.discriminator.parameters())
    with span("train_step.backward"):
        g_grads = torch.autograd.grad(g_loss, g_params, allow_unused=True)
        d_grads = torch.autograd.grad(d_loss, d_params, allow_unused=True)
        after_backward()
    with span("train_step.optimizer"):
        for params, grads in ((g_params, g_grads), (d_params, d_grads)):
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            if group is not None:
                grads = _average(grads, group)
            for p, g in zip(params, grads):
                p.grad = g
        state.d_opt.step()
        state.g_opt.step()
        state.d_sched.step()
        state.g_sched.step()
    state.step += 1


def _metrics(g_loss: torch.Tensor, d_loss: torch.Tensor,
             comps: Dict[str, torch.Tensor], group
             ) -> Dict[str, torch.Tensor]:
    """The step's metrics, detached; under a ``group`` their means over the
    ranks (one all-reduce), the global batch's values the JAX step
    reports."""
    metrics = {"g_loss": g_loss.detach(), "d_loss": d_loss.detach(),
               **{k: v.detach() for k, v in comps.items()}}
    if group is None:
        return metrics
    return dict(zip(metrics, _average(list(metrics.values()), group)))


def _check_group(generator: nn.Module, group) -> None:
    """A step under ``group`` needs a generator built for it: BatchNorm
    and the memories reducing over the same group."""
    if group is None:
        return
    stray = sorted({name for name, m in generator.named_modules()
                    if isinstance(m, (BatchNorm2d, TopKMemory))
                    and m.group is not group})
    if stray:
        raise ValueError(
            f"a step under a process group needs the generator's BatchNorm "
            f"and memories on that group (build_model(..., group=group) or "
            f"models.set_process_group); not on it: {stray[:3]}")


def make_twostream_train_step(loss_cfg: LossConfig, rgb_channels: int = 3,
                              op_channels: int = 2, remat: bool = False,
                              freeze_codebook: bool = False,
                              group=None) -> Callable:
    """``train_step(state, batch, flownet) -> metrics``: one stage-2 step
    in place on ``state``; ``batch`` holds ``rgb`` and ``op`` clips (target
    last) on the state's device; ``metrics`` maps ``g_loss``, ``d_loss`` and
    the loss components to 0-dim float32 tensors on that device.

    ``group``: data parallelism over a ``torch.distributed`` process group
    (the JAX step under a ``data`` mesh).  Each rank passes its equal shard
    of the global batch (``parallel.make_global_batch``) and a generator
    built with the same group (``build_model(..., group=group)``), whose
    BatchNorm and EMA statistics are then the global batch's; gradients
    and metrics are averaged over the ranks, so every rank applies the
    global-batch update and returns the global metrics.  Every rank issues
    the same collectives in the same order.  The models are not wrapped in
    ``DistributedDataParallel``: its reducer hooks the accumulation of
    ``.grad``, which the step's two ``autograd.grad`` calls (G's loss
    running through D) never do."""
    g_loss_fn = LOSS_TAGS[loss_cfg.loss_tag]

    def gen_apply(gen: nn.Module, rgb_input: torch.Tensor,
                  op_input: torch.Tensor):
        if not remat:
            return gen(rgb_input, op_input)
        return torch.utils.checkpoint.checkpoint(
            gen, rgb_input, op_input, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), recomputing()))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   flownet: nn.Module) -> Dict[str, torch.Tensor]:
        with span("train_step"):
            return _step(state, batch, flownet)

    def _step(state, batch, flownet):
        gen, disc = state.generator, state.discriminator
        _check_group(gen, group)
        rgb = _to_model_range(batch["rgb"])
        op = _to_model_range(batch["op"])
        rgb_input, rgb_target = rgb[:, :-rgb_channels], rgb[:, -rgb_channels:]
        op_input, op_target = op[:, :-op_channels], op[:, -op_channels:]

        with span("train_step.forward"):
            frozen = _FrozenCodebook(gen, freeze_codebook)
            gen.train()
            with (deferred_buffer_updates() if remat
                  else contextlib.nullcontext()) as recorded:
                rgb_pred, op_pred, diffs, _ = gen_apply(gen, rgb_input,
                                                        op_input)
            frozen.restore()

        with span("train_step.teacher"), torch.no_grad():
            flow_pred = _flow_pair(flownet, rgb_target, rgb_pred)
            flow_gt = _flow_pair(flownet, rgb_target, rgb_target)
        with span("train_step.discriminator"):
            d_gen = disc(rgb_pred)
            g_loss, comps = g_loss_fn({
                "rgb_pred": rgb_pred, "rgb_target": rgb_target,
                "op_pred": op_pred, "op_target": op_target,
                "d_gen": d_gen, "flow_pred": flow_pred, "flow_gt": flow_gt,
                "latent_diff": diffs,
            }, loss_cfg)
            d_loss = discriminate_loss(disc(rgb_target),
                                       disc(rgb_pred.detach()))

        def after_backward():
            if recorded is not None:  # remat: the forward's buffer updates
                write_buffers(recorded)
                frozen.restore()

        _update(state, g_loss, d_loss, after_backward, group)
        return _metrics(g_loss, d_loss, comps, group)

    return train_step


def make_single_stream_train_step(loss_cfg: LossConfig, data_type: str = "rgb",
                                  channels: Optional[int] = None,
                                  freeze_codebook: bool = False,
                                  group=None) -> Callable:
    """Stage-1 step (JAX ``make_single_stream_train_step``; reference
    inference_v1..v4 closures, train_helper.py:1408-1827):
    ``train_step(state, batch, flownet) -> metrics`` on one modality.
    ``batch`` is one clip tensor, target last (u8 or float, frame-packed or
    NCHW as :func:`_to_model_range` takes); the generator predicts the last
    ``c`` channels (3 for rgb, 2 for op) from the others and D scores that
    c-channel prediction.  The FlowNet2-SD pair (``flownet``, under
    ``no_grad``) runs only for the ``*flow*`` loss tags, which the rgb
    recipes use with GDL; the op recipes are intensity + adversarial (+
    commit for the ``_vq`` tags), and ``flownet`` may then be ``None``.
    ``freeze_codebook`` and ``group`` as in
    :func:`make_twostream_train_step`."""
    g_loss_fn = LOSS_TAGS[loss_cfg.loss_tag]
    c = channels if channels is not None else CHANNEL[data_type]
    uses_flow = "flow" in loss_cfg.loss_tag

    def train_step(state: TrainState, batch: torch.Tensor,
                   flownet: Optional[nn.Module]) -> Dict[str, torch.Tensor]:
        with span("train_step"):
            return _step(state, batch, flownet)

    def _step(state, batch, flownet):
        gen, disc = state.generator, state.discriminator
        _check_group(gen, group)
        clip = _to_model_range(batch)
        x_input, x_target = clip[:, :-c], clip[:, -c:]

        with span("train_step.forward"):
            frozen = _FrozenCodebook(gen, freeze_codebook)
            gen.train()
            pred, diff, _ = gen(x_input)
            frozen.restore()

        loss_batch = {"rgb_pred": pred, "rgb_target": x_target,
                      "op_pred": pred, "op_target": x_target,
                      "latent_diff": diff}
        if uses_flow:
            with span("train_step.teacher"), torch.no_grad():
                loss_batch["flow_pred"] = _flow_pair(flownet, x_target, pred)
                loss_batch["flow_gt"] = _flow_pair(flownet, x_target,
                                                   x_target)
        with span("train_step.discriminator"):
            loss_batch["d_gen"] = disc(pred)
            g_loss, comps = g_loss_fn(loss_batch, loss_cfg)
            d_loss = discriminate_loss(disc(x_target), disc(pred.detach()))
        _update(state, g_loss, d_loss, group=group)
        return _metrics(g_loss, d_loss, comps, group)

    return train_step
