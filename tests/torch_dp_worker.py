"""One rank of the port's multi-process tests (gloo on the CPU).

Run as ``python tests/torch_dp_worker.py <workdir> <rank> <world>``, or
from a test through :func:`launch`, which starts every rank: each joins
a gloo group through ``file://<workdir>/pg``, reads the task list
``<workdir>/spec.pt`` (written by the test with ``torch.save``), runs each
task on this rank's shard and writes ``<workdir>/out_<rank>.pt``.  Tasks:

* ``ema``: ``quantize_topk(train=True, group=...)`` on this rank's rows of a
  global latent, through B2's wrapper (its plain version on the CPU) and
  through the plain lookup: the updated codebooks;
* ``bn``: a group ``BatchNorm2d`` in training mode on this rank's rows of a
  global batch: output, input gradient and affine gradients of
  ``sum(y * grad_out)``, running statistics;
* ``train``: stage-2 steps of the port's two-stream step under the group
  from a given state (:func:`run_steps`);
* ``score``: ``runners.run_test.main`` with the given arguments;
* ``replicate``: ``parallel.replicate`` of a module seeded by the rank;
* ``uneven``: ``parallel.make_global_batch`` of a shard whose size differs
  by rank: the error it raises.

It imports nothing of JAX.
"""

import copy
import datetime
import os
import subprocess
import sys

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ammcnet_aaai2021_torch.parallel import (initialize, make_global_batch,  # noqa: E402
                                             replicate, shard_batch)


def ema(spec, rank, world, group):
    from ammcnet_aaai2021_torch.ops.memory import Codebook, quantize_topk

    z = shard_batch(spec["z"], rank, world)
    out = {}
    for use_kernel in (True, False):
        cb = Codebook(*(t.clone() for t in spec["codebook"]))
        *_, new = quantize_topk(z, cb, spec["k"], train=True,
                                use_kernel=use_kernel, group=group)
        out[use_kernel] = tuple(new)
    return out


def bn(spec, rank, world, group):
    from ammcnet_aaai2021_torch.models import BatchNorm2d

    layer = BatchNorm2d(spec["x"].shape[1])
    layer.load_state_dict(spec["state"])
    layer.group = group
    layer.train()
    x = shard_batch(spec["x"], rank, world).clone().requires_grad_(True)
    y = layer(x)
    (y * shard_batch(spec["grad_out"], rank, world)).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad,
            "weight_grad": layer.weight.grad, "bias_grad": layer.bias.grad,
            "state": layer.state_dict()}


def train(spec, rank, world, group):
    from ammcnet_aaai2021_torch.configs import LossConfig, NetConfig, OptimConfig
    from ammcnet_aaai2021_torch.models import build_model
    from ammcnet_aaai2021_torch.train.state import create_train_state
    from ammcnet_aaai2021_torch.train.steps import make_twostream_train_step

    model = build_model(NetConfig(dtype="float32", n_embed=spec["n_embed"]),
                        "training", group=group)
    state = create_train_state(model.generator, model.discriminator,
                               OptimConfig(), 0)
    state.generator.load_state_dict(spec["init"])
    state.discriminator.load_state_dict(spec["disc"])
    # rank 0's modules everywhere (they are equal already: this is the
    # broadcast a run from differing seeds needs)
    replicate(state.generator, group)
    replicate(state.discriminator, group)
    flownet = model.flow_network
    flownet.load_state_dict(spec["flownet"])
    flownet.eval()
    batch = make_global_batch(shard_batch(spec["batch"], rank, world),
                              "cpu", group)
    step = make_twostream_train_step(LossConfig(), remat=spec["remat"],
                                     group=group)
    return run_steps(step, state, batch, flownet, spec["steps"])


def run_steps(step, state, batch, flownet, steps: int) -> dict:
    """``steps`` steps: each step's metrics, the first step's gradients and
    the generator's state after it, and the state after the last."""
    metrics = []
    for i in range(steps):
        m = step(state, batch, flownet)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            first = {"g_grads": {n: p.grad.clone() for n, p in
                                 state.generator.named_parameters()},
                     "d_grads": {n: p.grad.clone() for n, p in
                                 state.discriminator.named_parameters()},
                     "state": copy.deepcopy(state.generator.state_dict())}
    return {"metrics": metrics, "first": first,
            "state": state.generator.state_dict()}


def score(spec, rank, world, group):
    from ammcnet_aaai2021_torch.runners.run_test import main

    return main(spec["argv"])


def replicate_task(spec, rank, world, group):
    torch.manual_seed(rank)
    return replicate(torch.nn.Linear(3, 2), group).state_dict()


def uneven(spec, rank, world, group):
    try:
        make_global_batch({"rgb": torch.zeros(rank + 1, 3)}, "cpu", group)
    except ValueError as e:
        return str(e)
    return None


TASKS = {"ema": ema, "bn": bn, "train": train, "score": score,
         "replicate": replicate_task, "uneven": uneven}


def launch(workdir, specs, world: int = 2, timeout: float = 600.0):
    """Write ``specs`` ({name: {"task": ..., ...}}) to ``workdir``, run
    ``world`` ranks of this script on them and return each rank's outputs
    ({name: result}).  Every worker is reaped by its PID, whatever
    happens; a failed rank raises ``AssertionError`` with its output."""
    torch.save(specs, os.path.join(workdir, "spec.pt"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(workdir), str(rank),
         str(world)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=REPO) for rank in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("\n".join(
            f"--- rank {r} (rc={p.returncode}) ---\n{out[-4000:]}"
            for r, (p, out) in enumerate(zip(procs, outs))))
    return [torch.load(os.path.join(workdir, f"out_{rank}.pt"),
                       weights_only=False) for rank in range(world)]


def main():
    workdir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(2)
    specs = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
    initialize(backend="gloo", init_method=f"file://{workdir}/pg",
               world_size=world, rank=rank,
               timeout=datetime.timedelta(seconds=300))
    try:
        out = {name: TASKS[spec["task"]](spec, rank, world, dist.group.WORLD)
               for name, spec in specs.items()}
        torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
