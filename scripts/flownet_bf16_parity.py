#!/usr/bin/env python3
"""How far apart the two packages' bf16 FlowNet2-SD extractors are.

``run_test --on_the_fly_flow`` serves FlowNet2-SD in bf16 in both packages.
Their convolutions round differently at each layer, so their flows differ
by more than one bf16 rounding.  This script measures by how much, and
whether either is further than the other from the float32 flows of the
same weights, on the CPU at the size of ``tests/test_torch_otf.py`` (64x64,
9 frames of a textured moving blob, chunks of 4 pairs), for seeds 1-4 and
the reference's flow bug on and off.  It prints one JSON line a case:

* ``ulps``: the two bf16 extractors' largest difference, in bf16 ulps of
  the largest |flow| (2^-8 of it);
* ``max_ratio``, ``mean_ratio``: the port's largest and mean difference
  from the float32 flows over JAX's.

``test_bf16_extractor_matches_jax`` holds seed 1 to bounds set from these
readings.  Run from the repository root (needs jax and torch):

    JAX_PLATFORMS=cpu python scripts/flownet_bf16_parity.py
"""

from __future__ import annotations

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ammcnet_aaai2021_tpu.eval import infer as jinfer  # noqa: E402
from ammcnet_aaai2021_tpu.models.flownet_sd import FlowNet2SD as JFlowNet2SD  # noqa: E402
from ammcnet_aaai2021_torch.eval import infer  # noqa: E402
from ammcnet_aaai2021_torch.models.flownet_sd import FlowNet2SD  # noqa: E402
from ammcnet_aaai2021_torch.tools.weights import flownet_state_from_jax  # noqa: E402

SIZE, FRAMES, CHUNK = 64, 9, 4


def video(seed: int) -> np.ndarray:
    """(FRAMES, SIZE, SIZE, 3) u8: a blob moving 2 px a frame over texture,
    grayscale on three channels (as ``tests/test_torch_otf.py:_video``)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    frames = [np.clip(
        100 + 40 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
        + 80 * np.exp(-((xx - 10 - 2 * t) ** 2 + (yy - 30) ** 2) / 40.0)
        + rng.normal(0, 3, (SIZE, SIZE)), 0, 255).astype(np.uint8)
        for t in range(FRAMES)]
    return np.repeat(np.stack(frames)[..., None], 3, axis=-1)


def main() -> None:
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    torch.set_num_threads(2)
    variables = JFlowNet2SD(dtype=jnp.float32).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, SIZE, SIZE, 3, 2)))
    state = flownet_state_from_jax(jax.tree.map(np.asarray, variables))
    net32, net = FlowNet2SD(dtype=torch.float32), FlowNet2SD()
    for n in (net32, net):
        n.load_state_dict(state)
        n.eval()
    jnet = JFlowNet2SD(dtype=jnp.bfloat16)
    for seed in (1, 2, 3, 4):
        v = video(seed)
        for bug in (True, False):
            want = np.asarray(jinfer.make_otf_flow_extractor(
                jnet, variables, reproduce_flow_bug=bug, chunk=CHUNK)(
                    jnp.asarray(v)), np.float32)
            got = infer.make_otf_flow_extractor(
                net, reproduce_flow_bug=bug, chunk=CHUNK)(
                    torch.from_numpy(v)).float().numpy()
            f32 = infer.otf_flows(net32, torch.from_numpy(v), bug,
                                  CHUNK)[0].numpy()
            scale = float(np.abs(f32).max())
            err, ref_err = np.abs(got - f32), np.abs(want - f32)
            print(json.dumps({
                "seed": seed, "reproduce_flow_bug": bug,
                "max_abs_flow": scale,
                "ulps": float(np.abs(got - want).max() / (2.0 ** -8 * scale)),
                "max_ratio": float(err.max() / ref_err.max()),
                "mean_ratio": float(err.mean() / ref_err.mean())}),
                flush=True)


if __name__ == "__main__":
    main()
