"""Stage-2 training-step FLOP census and the step's share of the card's peak.

Port of ``ammcnet_aaai2021_tpu/tools/train_flops.py``.  The stage-2 GAN
step (``train.steps.make_twostream_train_step``): G forward and backward,
D forward and backward (real and fake), two FlowNet2-SD teacher forwards,
both Adam updates, BatchNorm and EMA codebook updates.

Census (default): one step of the released configuration runs on
``--device`` (default ``cuda``; it raises without a GPU) under
``torch.utils.flop_counter.FlopCounterMode``, which counts the matrix
products and convolutions of the forward and backward passes; the
memory lookups are registered ops with their own FLOP formulas
(``ops/library.py``), so they count too.  Elementwise work is not
counted (XLA's cost analysis, which the JAX tool reads, counts it).  The
components are counted alone: the generator's eval-mode forward, the
discriminator's forward and FlowNet2-SD's.

``--measure`` times ``--chain`` steps with CUDA events after a warm step,
and prints the rate against the H100's dense bf16 tensor-core peak
(989 TFLOP/s, NVIDIA's data sheet for the SXM card at 700 W) beside the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json

import torch

H100_BF16_PEAK = 989e12


def _build(size: int, batch: int, device, dtype: str = "bfloat16"):
    import dataclasses

    from ..configs import LossConfig, NetConfig, OptimConfig
    from ..models import build_model, init_flownet_weights
    from ..train.state import create_train_state
    from ..train.steps import make_twostream_train_step

    cfg = dataclasses.replace(NetConfig(), dtype=dtype)
    model = build_model(cfg, mode="training")
    state = create_train_state(model.generator, model.discriminator,
                               OptimConfig(), 20200525, device=device)
    flownet = init_flownet_weights(model.flow_network,
                                   torch.Generator().manual_seed(1))
    flownet.to(device).eval().requires_grad_(False)
    g = torch.Generator().manual_seed(0)
    batch_data = {
        "rgb": torch.randint(0, 256, (batch, 5, size, size, 3), generator=g,
                             dtype=torch.uint8).to(device),
        "op": (torch.rand((batch, 4, size, size, 2), generator=g) * 2 - 1
               ).to(device),
    }
    step_fn = make_twostream_train_step(LossConfig(loss_tag="twostream_vq"))
    return state, flownet, batch_data, step_fn


def count_flops(fn, *args) -> int:
    """FLOPs of ``fn(*args)`` by ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def census(size: int = 256, batch: int = 4, device="cuda",
           dtype: str = "bfloat16") -> dict:
    from ..train.steps import _to_model_range

    state, flownet, batch_data, step_fn = _build(size, batch, device, dtype)
    rgb = _to_model_range(batch_data["rgb"])
    op = _to_model_range(batch_data["op"])
    rgb_input, rgb_target = rgb[:, :-3], rgb[:, -3:]
    op_input = op[:, :-2]
    gen, disc = state.generator, state.discriminator

    out = {"full_step": count_flops(step_fn, state, batch_data, flownet)}
    gen.eval()
    with torch.no_grad():
        out["g_forward"] = count_flops(gen, rgb_input, op_input)
        out["d_forward"] = count_flops(disc, rgb_target)
        pair = torch.stack([rgb_target, rgb_target], dim=2)
        out["flownet_forward"] = count_flops(flownet, pair)
    gen.train()
    return out


def measure(size: int = 256, batch: int = 4, chain: int = 30,
            device="cuda") -> dict:
    """ms a step over ``chain`` dependent steps after a warm one: CUDA
    events on a GPU, the host clock on the CPU."""
    import time

    state, flownet, batch_data, step_fn = _build(size, batch, device)
    metrics = step_fn(state, batch_data, flownet)
    g0 = float(metrics["g_loss"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
    t0 = time.perf_counter()
    for _ in range(chain):
        metrics = step_fn(state, batch_data, flownet)
    if cuda:
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        seconds = time.perf_counter() - t0
    return {"per_step_s": seconds / chain, "steps_per_s": chain / seconds,
            "g_loss_first": g0, "g_loss_last": float(metrics["g_loss"])}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--measure", action="store_true",
                   help="also time the step on --device")
    p.add_argument("--chain", type=int, default=30)
    p.add_argument("--step_ms", type=float, default=None,
                   help="skip --measure and compute the rate from this "
                        "already-measured step time")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when no GPU is visible")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "visible (pass --device cpu)")
    from ..utils.profiling import card_name

    c = census(args.size, args.batch, device)
    print(f"== FLOP census (FlopCounterMode, {args.size}x{args.size} "
          f"batch {args.batch}) ==")
    for k, v in c.items():
        print(f"  {k:<18} {v / 1e9:10.1f} GFLOP")
    full = c["full_step"]
    result = {"census": c, "size": args.size, "batch": args.batch,
              "card": card_name(device)}
    step_s = None
    if args.measure:
        result["measure"] = measure(args.size, args.batch, args.chain, device)
        step_s = result["measure"]["per_step_s"]
    elif args.step_ms:
        step_s = args.step_ms / 1e3
    if step_s:
        tflops = full / step_s / 1e12
        result.update(step_ms=step_s * 1e3, tflops=tflops,
                      share_of_bf16_peak=tflops * 1e12 / H100_BF16_PEAK)
        print(f"== train rate: {full / 1e9:.1f} GFLOP / {step_s * 1e3:.2f} "
              f"ms = {tflops:.1f} TFLOP/s = "
              f"{100 * tflops * 1e12 / H100_BF16_PEAK:.1f}% of the H100's "
              f"dense bf16 peak ({result['card']}) ==")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
