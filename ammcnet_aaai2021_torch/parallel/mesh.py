"""Data-parallel layout over a ``torch.distributed`` process group.

Port of ``ammcnet_aaai2021_tpu/parallel/mesh.py``.  The JAX package lays a
device mesh with a ``data`` axis, shards the batch over it and replicates
the parameters and codebooks; XLA inserts the all-reduces.  Here each rank
is a process with one device, so the mesh is the group's world size: the
batch is split into equal contiguous rank shards (:func:`shard_batch`, the
rows ``P("data")`` gives each device) and every rank holds a full copy of
the modules (:func:`replicate`); the reductions are explicit
(``parallel.multihost.all_reduce_sum``).

No counterpart: ``make_mesh`` and ``batch_sharding`` (nothing beyond the
world size to lay out), and ``shard_params_tensor_parallel`` with the
``model`` axis of ``__graft_entry__.dryrun_multichip``'s 2-D mesh.  The card
is one H100 and the model (about 25M parameters) fits on it many times
over; the JAX package itself calls tensor parallelism here "optional
capacity headroom, not a necessity" (``mesh.py:61-62``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from .multihost import process_count


@torch.no_grad()
def replicate(module: nn.Module,
              group: Optional[dist.ProcessGroup] = None) -> nn.Module:
    """Broadcast the group's first rank's parameters and buffers to every
    rank, in place; returns ``module``.  The identity in a single process."""
    if process_count(group) == 1:
        return module
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for tensor in (*module.parameters(), *module.buffers()):
        dist.broadcast(tensor.data, src=src, group=group)
    return module


def shard_batch(batch, rank: int, world: int):
    """This rank's rows of a global batch (a tensor or numpy array, or a dict
    of them, batch on the leading axis): the ``rank``-th of ``world`` equal
    contiguous blocks.  Raises ``ValueError`` unless the batch divides
    evenly."""
    def rows(x):
        n = x.shape[0]
        if n % world:
            raise ValueError(f"a global batch of {n} does not split into "
                             f"{world} equal rank shards")
        per = n // world
        return x[rank * per:(rank + 1) * per]

    if isinstance(batch, dict):
        return {k: rows(v) for k, v in batch.items()}
    return rows(batch)
