"""The plain float32 reference of the stage-2 training step.

A frozen copy of the arithmetic of the port's ``train/steps.py``
(``make_twostream_train_step`` without remat, process group or frozen
codebook), ``losses/primitives.py`` and ``losses/zoo.py``'s
``twostream_vq`` loss, on the modules of :mod:`.model`: one train-mode
generator forward (BatchNorm statistics and EMA codebooks update inside
it), FlowNet2-SD on (target, prediction) and (target, target) under
``no_grad``, the discriminator as it was before the step for the G loss,
G's gradient from the G loss w.r.t. G's parameters and D's from the D
loss w.r.t. D's, then Adam (b1 0.9, b2 0.999, eps 1e-8) on each, D first.
The learning-rate schedule's first milestone lies at step 40,000, so the
steps compared here run at the base rates and the reference keeps no
scheduler.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

# the released stage-2 loss weights (the port's configs.LossConfig)
LOSS = dict(lam_adv=0.05, lam_gdl=1.0, lam_flow=2.0, lam_lp=1.0,
            lam_lp_op=1.0, lam_latent=0.25)


def to_model_range(x: torch.Tensor) -> torch.Tensor:
    """u8 clips normalized to [-1, 1], others cast to float32; a
    frame-packed (b, t, h, w, c) clip folded to (b, t*c, h, w)."""
    x = (x.float() / 255.0 - 0.5) / 0.5 if x.dtype == torch.uint8 else x.float()
    if x.ndim == 5:
        b, t, h, w, c = x.shape
        x = x.permute(0, 1, 4, 2, 3).reshape(b, t * c, h, w)
    return x


def intensity_loss(gen, gt):
    d = gen.float() - gt.float()
    return (d.square().sum(dim=1) + 1e-20).sqrt().mean()


def _channel_sum_grads(x):
    s = x.float().sum(dim=1)
    return s - F.pad(s, (1, 0))[:, :, :-1], s - F.pad(s, (0, 0, 1, 0))[:, :-1, :]


def gradient_loss(gen, gt):
    gdx, gdy = _channel_sum_grads(gen)
    tdx, tdy = _channel_sum_grads(gt)
    return ((tdx - gdx).abs() + (tdy - gdy).abs()).mean()


def adversarial_loss(fake):
    return ((fake.float() - 1.0).square() / 2.0).mean()


def discriminate_loss(real, fake):
    return (((real.float() - 1.0).square() / 2.0).mean()
            + (fake.float().square() / 2.0).mean())


def twostream_vq_loss(b: Dict) -> torch.Tensor:
    w = LOSS
    return (w["lam_adv"] * adversarial_loss(b["d_gen"])
            + w["lam_gdl"] * gradient_loss(b["rgb_pred"], b["rgb_target"])
            + w["lam_flow"] * (b["flow_pred"] - b["flow_gt"]).abs().mean()
            + w["lam_lp"] * intensity_loss(b["rgb_pred"], b["rgb_target"])
            + w["lam_lp_op"] * intensity_loss(b["op_pred"], b["op_target"])
            + w["lam_latent"] * sum(b["latent_diff"]))


def _flow_pair(flownet, last_frame, frame):
    pair = torch.stack([(last_frame * 0.5 + 0.5) * 255.0,
                        (frame * 0.5 + 0.5) * 255.0], dim=2)
    return flownet(pair) / 255.0


def make_adam(params, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def losses_and_grads(gen, disc, flownet, g_params, d_params,
                     batch: Dict[str, torch.Tensor]):
    """The step's forward and backward: ``(g_loss, d_loss, g_grads,
    d_grads)``, a zero gradient for a parameter a loss does not reach."""
    rgb, op = to_model_range(batch["rgb"]), to_model_range(batch["op"])
    rgb_input, rgb_target = rgb[:, :-3], rgb[:, -3:]
    op_input, op_target = op[:, :-2], op[:, -2:]
    gen.train()
    rgb_pred, op_pred, diffs, _ = gen(rgb_input, op_input)
    with torch.no_grad():
        flow_pred = _flow_pair(flownet, rgb_target, rgb_pred)
        flow_gt = _flow_pair(flownet, rgb_target, rgb_target)
    g_loss = twostream_vq_loss({
        "rgb_pred": rgb_pred, "rgb_target": rgb_target, "op_pred": op_pred,
        "op_target": op_target, "d_gen": disc(rgb_pred),
        "flow_pred": flow_pred, "flow_gt": flow_gt, "latent_diff": diffs})
    d_loss = discriminate_loss(disc(rgb_target), disc(rgb_pred.detach()))
    g_grads = torch.autograd.grad(g_loss, g_params, allow_unused=True)
    d_grads = torch.autograd.grad(d_loss, d_params, allow_unused=True)
    return (g_loss.detach(), d_loss.detach(),
            [torch.zeros_like(p) if g is None else g
             for p, g in zip(g_params, g_grads)],
            [torch.zeros_like(p) if g is None else g
             for p, g in zip(d_params, d_grads)])


def train_step(gen, disc, flownet, g_opt, d_opt, batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor],
                          List[torch.Tensor]]:
    """One stage-2 step in place.  Returns ``(g_loss, d_loss, g_grads,
    d_grads)``, the gradients as the optimizers got them."""
    g_params = [p for group in g_opt.param_groups for p in group["params"]]
    d_params = [p for group in d_opt.param_groups for p in group["params"]]
    g_loss, d_loss, g_grads, d_grads = losses_and_grads(
        gen, disc, flownet, g_params, d_params, batch)
    for params, grads in ((g_params, g_grads), (d_params, d_grads)):
        for p, g in zip(params, grads):
            p.grad = g
    d_opt.step()
    g_opt.step()
    return g_loss, d_loss, g_grads, d_grads
