"""Multi-process data parallelism and multi-host scoring on ``torch.distributed``.

Port of ``ammcnet_aaai2021_tpu/parallel/multihost.py``.  Each process (a
rank) owns one device and feeds it only its shard of the data:

* training: each rank takes an equal shard of the global batch
  (:func:`make_global_batch`); the stage-2 step then reduces BatchNorm's
  statistics, the EMA codebook statistics and the gradients over the group
  (``models.blocks.BatchNorm2d``, ``ops.memory.ema_apply``,
  ``train.steps``), so every rank applies the global-batch update;
* scoring: sub-videos are dealt round-robin (:func:`host_shard`); each rank
  writes its records to a shard file and rank 0 merges them in global video
  order (``eval/infer.py:score_dataset``).

Every helper is the identity when no process group is initialized or the
world size is 1, as the JAX ones are in a single-process run.  The caller
starts the group (:func:`initialize`, or ``dist.init_process_group`` and
then :func:`warm_collectives`).
"""

from __future__ import annotations

import os
import pickle
import shutil
import time
import uuid
import warnings
from typing import Dict, List, Optional, Sequence, TypeVar

import torch
import torch.distributed as dist

T = TypeVar("T")


def process_count(group: Optional[dist.ProcessGroup] = None) -> int:
    """The group's world size; 1 when no process group is initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def process_index(group: Optional[dist.ProcessGroup] = None) -> int:
    """This process's rank in the group; 0 when none is initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def collective_device(group: Optional[dist.ProcessGroup] = None
                      ) -> torch.device:
    """Where the group's backend takes tensors: the current CUDA device for
    NCCL (which refuses CPU tensors), else the CPU."""
    if dist.get_backend(group) == dist.Backend.NCCL:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(tensor: torch.Tensor,
                   group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``tensor`` summed over the group, into a new tensor (the input is left
    as it is).  Every cross-rank sum of the training step goes through here,
    and ``all_reduce_sum.calls`` counts them."""
    out = tensor.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    all_reduce_sum.calls += 1
    return out


all_reduce_sum.calls = 0


def warm_collectives() -> None:
    """Align the ranks with one barrier right after the group starts.

    The JAX package needs this because XLA's CPU (gloo) collective context
    is created lazily at the first collective, with a fixed ~30 s
    rendezvous deadline, and a failed context poisons the process.
    ``torch.distributed`` creates its context in ``init_process_group`` and
    has no such deadline, but the barrier still releases every rank
    together before any heavy per-rank work (model build, kernel builds)
    skews them, so the first timed collective does not absorb that skew.
    No-op in a single process.
    """
    if process_count() == 1:
        return
    dist.barrier()


def initialize(**kwargs) -> None:
    """``dist.init_process_group(**kwargs)`` then :func:`warm_collectives`
    (give it ``backend``, ``init_method``, ``world_size`` and ``rank``)."""
    dist.init_process_group(**kwargs)
    warm_collectives()


def agree_on_run_token() -> str:
    """All ranks agree on one fresh random token: rank 0's ``uuid4``,
    broadcast as 16 uint8 on the backend's device.

    The token names a fresh per-run shard directory, so the end of a
    scoring run needs no collective: rank 0 polls for the shard files
    (:func:`wait_for_shards`) and can never merge an earlier run's shards.
    """
    local = uuid.uuid4().bytes
    if process_count() == 1:
        return local.hex()
    tok = torch.tensor(list(local), dtype=torch.uint8,
                       device=collective_device())
    dist.broadcast(tok, src=0)
    return bytes(tok.cpu().tolist()).hex()


def host_shard(items: Sequence[T]) -> List[T]:
    """Round-robin deal of items (e.g. sub-video names) to this rank."""
    return list(items[process_index()::process_count()])


def host_seed(base_seed: int) -> int:
    """A distinct sampling stream per rank for data-parallel training."""
    return base_seed + 1_000_003 * process_index()


def make_global_batch(local_batch, device, group=None):
    """This rank's shard of the global batch, on ``device``.

    ``local_batch`` is a tensor or numpy array, or a dict of them, with the
    batch on the leading axis.  Across ranks the shard sizes are gathered
    once and must be equal: then the mean of the per-rank means, which the
    step's losses and gradients average, is the global batch's mean, and
    every rank issues the same collectives in the same order.  Raises
    ``ValueError`` otherwise.
    """
    def to_device(x):
        x = torch.as_tensor(x)
        return x.to(device, non_blocking=True)

    batch = ({k: to_device(v) for k, v in local_batch.items()}
             if isinstance(local_batch, dict) else to_device(local_batch))
    leading = {int(v.shape[0]) for v in (
        batch.values() if isinstance(batch, dict) else (batch,))}
    if len(leading) != 1:
        raise ValueError(f"the batch's entries have leading sizes "
                         f"{sorted(leading)}; they must agree")
    world = process_count(group)
    if world > 1:
        size = leading.pop()
        sizes = [torch.zeros(1, dtype=torch.int64,
                             device=collective_device(group))
                 for _ in range(world)]
        dist.all_gather(sizes, torch.tensor([size], dtype=torch.int64,
                                            device=collective_device(group)),
                        group=group)
        sizes = [int(s) for s in sizes]
        if len(set(sizes)) != 1 or sizes[0] == 0:
            raise ValueError(f"per-rank batch shards of sizes {sizes}: every "
                             "rank needs an equal, non-empty shard")
    return batch


def _shard_path(shard_dir: str, rank: int) -> str:
    return os.path.join(shard_dir, f"records_{rank:05d}.pkl")


def write_record_shard(shard_dir: str, local_records: Dict[str, list],
                       local_names: Sequence[str]) -> str:
    """Persist this rank's per-video records and their video names.

    Ragged per-video score arrays cannot ride one collective, so multi-host
    scoring merges through a directory every rank can reach: each rank
    writes a shard, rank 0 merges them (:func:`merge_record_shards`).
    Write-then-rename: a reader never sees a half-written shard.
    """
    os.makedirs(shard_dir, exist_ok=True)
    path = _shard_path(shard_dir, process_index())
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump({"names": list(local_names), "records": local_records},
                    fh, pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return path


def wait_for_shards(shard_dir: str, n_shards: int = 0,
                    timeout_s: float = 3600.0, poll_s: float = 0.5) -> None:
    """Rank 0's rendezvous: poll until every rank's shard file exists.

    The shards are written atomically, so seeing the files is the
    strongest rendezvous there is, and polling tolerates ranks that finish
    minutes apart.  Raises ``TimeoutError`` naming the missing ranks.
    """
    n_shards = n_shards or process_count()
    deadline = time.monotonic() + timeout_s
    while True:
        missing = [r for r in range(n_shards)
                   if not os.path.exists(_shard_path(shard_dir, r))]
        if not missing:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"still waiting for record shards from ranks {missing} "
                f"under {shard_dir!r} after {timeout_s:.0f}s")
        time.sleep(poll_s)


def merge_record_shards(shard_dir: str, video_names: Sequence[str],
                        n_shards: int = 0) -> Dict[str, list]:
    """Rank 0's merge: every rank's shard, in global video order.

    Reads exactly the ``n_shards`` (default: the world size) shards this
    run's ranks wrote; a stale shard of a higher rank, left by an earlier
    run with more ranks, is ignored.  A missing shard raises
    ``FileNotFoundError``, a missing video ``RuntimeError``.
    """
    n_shards = n_shards or process_count()
    by_name: Dict[str, Dict[str, object]] = {}
    keys = None
    for rank in range(n_shards):
        path = _shard_path(shard_dir, rank)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"missing record shard for rank {rank}: {path!r} "
                f"(expected {n_shards} shards)")
        with open(path, "rb") as fh:
            shard = pickle.load(fh)  # written by write_record_shard
        if keys is None:
            keys = [k for k in shard["records"] if k != "dataset"]
        for i, name in enumerate(shard["names"]):
            by_name[name] = {k: shard["records"][k][i] for k in keys}
    if keys is None:
        raise RuntimeError(f"no record shards under {shard_dir!r}")
    missing = [n for n in video_names if n not in by_name]
    if missing:
        raise RuntimeError(f"shards missing videos: {missing}")
    return {k: [by_name[n][k] for n in video_names] for k in keys}


def consume_shard_dir(shard_dir: str) -> None:
    """Rank 0, after merging: retire the per-run shard directory.

    It is renamed aside first (the rename is the "merge done" signal that
    :func:`wait_for_merge` polls for), then the renamed remains are
    removed, so recurring evaluations do not pile up stale shards.
    """
    consumed = shard_dir.rstrip("/") + ".consumed"
    try:
        os.rename(shard_dir, consumed)
    except OSError:
        consumed = shard_dir  # the rename failed: remove it in place
    shutil.rmtree(consumed, ignore_errors=True)


def wait_for_merge(shard_dir: str, timeout_s: float = 3600.0,
                   poll_s: float = 0.5) -> None:
    """The other ranks' end of a scoring run: poll until rank 0 has
    consumed the shard directory, so they return together with it and a
    second run's :func:`agree_on_run_token` finds the ranks aligned.  On
    timeout, warn and return: a crashed rank 0 must not hang the others."""
    t0 = time.monotonic()
    while os.path.isdir(shard_dir):
        if time.monotonic() - t0 > timeout_s:
            warnings.warn(
                f"rank 0 did not consume {shard_dir!r} within "
                f"{timeout_s:.0f}s; returning unaligned", RuntimeWarning)
            return
        time.sleep(poll_s)
