"""The training loop around the step.

Port of ``ammcnet_aaai2021_tpu/train/loop.py`` (reference
``Code/run_helper/train_helper.py``: ``train_from_multi_pretain`` :217-427):
loss and train-PSNR logging every ``step_log`` steps, scalar summaries
every ``step_summary``, full-state checkpoints every ``step_save`` with
optional retention, and a host thread that assembles the next batches while
the device steps.

Scalars go to a CSV (``<run_dir>/summary/scalars.csv``) and the logger.  At
each log step the metrics are stacked on the device; ``fetch_every_periods``
such stacks are fetched with one device-to-host copy (JAX
``train_loop(fetch_every_periods=)``).  ``async_checkpoints`` writes the
checkpoints and prunes on a writer thread, from a device copy of the state
taken at the step (:func:`~.checkpoint.snapshot`).  TensorBoard scalars and
image grids are not ported (the card's machine has no tensorboard).

Spans (``utils/profiling.py``): ``train_loop.start`` (the writers and the
prefetch thread's start), ``train_loop.data_wait`` (each wait for the next
batch, whose host seconds are also ``data_stall_frac``'s),
``train_loop.fetch`` (a fetch of the pending rows, or the wait for the first
step) and ``train_loop.stop`` (the prefetch thread's stop and the writers'
close).
"""

from __future__ import annotations

import csv
import os
import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..configs import STEP_LOG, STEP_SAVE_CKPT, STEP_SUMMARY
from ..utils.profiling import span, timed
from .checkpoint import (checkpoint_payload, prune_checkpoints, snapshot,
                         write_checkpoint)
from .state import TrainState


class ScalarWriter:
    """CSV scalar sink (``step,tag,value`` rows), appended across runs."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "scalars.csv")
        self._fh = open(self.path, "a", newline="")
        self._writer = csv.writer(self._fh)
        if os.path.getsize(self.path) == 0:
            self._writer.writerow(["step", "tag", "value"])

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        for tag, val in values.items():
            self._writer.writerow([step, tag, float(val)])
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def prefetch(batch_iter: Iterator, depth: int = 2) -> Iterator:
    """Host-thread prefetch so batch assembly overlaps the device step
    (replaces the reference's DataLoader worker processes).  The producer
    thread starts here; an exception in it is raised to the consumer.
    Closing the returned generator stops the producer thread, which then
    closes ``batch_iter``."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()
    failure = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in batch_iter:
                if not put(item):
                    break
        except Exception as exc:  # handed to the consumer below
            failure.append(exc)
        finally:
            close = getattr(batch_iter, "close", None)
            if close is not None:
                close()
            put(end)

    def consume():
        thread.start()
        try:
            yield  # started: closing the generator from here stops the thread
            while True:
                item = q.get()
                if item is end:
                    if failure:
                        raise failure[0]
                    return
                yield item
        finally:
            stop.set()
            thread.join(timeout=60)

    thread = threading.Thread(target=worker, daemon=True)
    items = consume()
    next(items)
    return items


class CheckpointWriter:
    """Checkpoint saving and pruning, on the calling thread or (``async_``)
    on a writer thread behind a one-deep queue, as the JAX loop's
    ``async_checkpoints``: :meth:`put` blocks only while an earlier save is
    still queued.  The writer's exception is raised in the caller at the
    next :meth:`put` or at :meth:`close`."""

    def __init__(self, ckpt_dir: str, keep_ckpts: Optional[int] = None,
                 keep_every: Optional[int] = None, logger=None,
                 async_: bool = False):
        self.ckpt_dir, self.logger = ckpt_dir, logger
        self.keep = (keep_ckpts, keep_every)
        self.failure: list = []
        self.queue: Optional["queue.Queue"] = None
        if async_:
            self.queue = queue.Queue(maxsize=1)
            self.thread = threading.Thread(target=self._work, daemon=True)
            self.thread.start()

    def _write(self, payload: Dict) -> None:
        write_checkpoint(self.ckpt_dir, payload)
        deleted = prune_checkpoints(self.ckpt_dir, *self.keep)
        if self.logger:
            self.logger.info("checkpoint saved at step %d%s", payload["step"],
                             f" (pruned {len(deleted)})" if deleted else "")

    def _work(self) -> None:
        while True:
            payload = self.queue.get()
            if payload is None:
                return
            if self.failure:
                continue  # drain: the loop raises at its next put or close
            try:
                self._write(payload)
            except BaseException as exc:  # handed to the loop's thread
                self.failure.append(exc)

    def _raise(self) -> None:
        if self.failure:
            raise RuntimeError("the checkpoint writer thread failed"
                               ) from self.failure[0]

    def put(self, state: TrainState) -> None:
        """Save ``state`` at its step."""
        if self.queue is None:
            self._write(checkpoint_payload(state))
            return
        self._raise()
        self.queue.put(snapshot(state))

    def close(self) -> None:
        """Wait for the queued saves; raise the writer's exception."""
        if self.queue is not None:
            self.queue.put(None)
            self.thread.join()
        self._raise()


def train_loop(state: TrainState, train_step: Callable,
               batch_iter: Iterator, flownet: Optional[torch.nn.Module],
               iterations: int, run_dir: str, logger=None,
               psnr_fn: Optional[Callable] = None,
               step_log: int = STEP_LOG, step_summary: int = STEP_SUMMARY,
               step_save: int = STEP_SAVE_CKPT,
               fetch_every_periods: int = 1,
               async_checkpoints: bool = False,
               keep_ckpts: Optional[int] = None,
               keep_every: Optional[int] = None) -> TrainState:
    """Step ``state`` until ``state.step == iterations``.

    ``batch_iter`` yields what ``train_step(state, batch, flownet)`` takes:
    a ``{"rgb", "op"}`` dict of tensors (stage 2) or one clip tensor (stage
    1); ``flownet`` is None where no loss term reads it.

    ``psnr_fn(state, batch)`` gives the train PSNR the reference logs every
    ``step_log`` (train_helper.py:347-386).  Summary scalars are written at
    log steps that are multiples of ``step_summary``; the first step's wall
    seconds (it loads kernels and picks convolution algorithms) are written
    as ``first_step_s``.

    ``fetch_every_periods=K`` keeps K log periods' scalar stacks on the
    device and fetches them with one copy; each period's row is still
    written, K periods late.  Where a fetch brings more than one period the
    logged rate is the rate over the whole span since the last fetch (the
    per-period times before it only measure how fast the host enqueued).
    Pending rows are fetched before every checkpoint and at the end.
    ``async_checkpoints`` saves on a writer thread (:class:`CheckpointWriter`)
    from a snapshot taken at the step.  Returns ``state``."""
    with span("train_loop.start"):
        writer = ScalarWriter(os.path.join(run_dir, "summary"))
        saver = CheckpointWriter(
            os.path.join(run_dir, "training", "checkpoints"), keep_ckpts,
            keep_every, logger, async_=async_checkpoints)
        batches = prefetch(batch_iter)
    if logger:
        logger.info("training steps %d to %d", state.step + 1, iterations)
    data_times = []
    period_steps = 0
    t_period = time.perf_counter()
    # (step, keys, values on the device, period start, steps, data seconds)
    # of each log period not yet fetched; a period ends where the next
    # begins, the last at the fetch
    pending: list = []
    fetched = [state.step, t_period]  # step and time of the last fetch

    def flush() -> None:
        if pending:
            with span("train_loop.fetch"):
                fetch()

    def fetch() -> None:
        nonlocal t_period
        rows = torch.stack([p[2] for p in pending]).cpu().tolist()  # one copy
        now = time.perf_counter()
        span_rate = (pending[-1][0] - fetched[0]) / max(now - fetched[1], 1e-9)
        fetched[:] = [pending[-1][0], now]
        ends = [p[3] for p in pending[1:]] + [now if period_steps == 0
                                              else t_period]
        for (pstep, keys, _, t0, steps, data_s), t1, row in zip(
                pending, ends, rows):
            period = max(t1 - t0, 1e-9)
            rate = span_rate if len(pending) > 1 else steps / period
            data_frac = data_s / period
            vals = dict(zip(keys, row))
            if logger:
                logger.info("step %d | %s | %.2f steps/s data_stall=%.0f%%",
                            pstep, ", ".join(f"{k}={v:.4f}"
                                             for k, v in vals.items()),
                            rate, 100 * data_frac)
            if pstep % step_summary == 0:
                writer.scalars(pstep, vals)
                writer.scalars(pstep, {"steps_per_sec": rate,
                                       "data_stall_frac": data_frac})
        pending.clear()
        if period_steps == 0:  # the next period starts after the fetch
            t_period = now

    end = object()
    try:
        while True:
            with timed("train_loop.data_wait") as wait:
                batch = next(batches, end)
            if batch is end or state.step >= iterations:
                break
            data_times.append(wait.seconds)
            t_step = time.perf_counter()
            metrics = train_step(state, batch, flownet)
            step = state.step
            period_steps += 1
            if len(data_times) == 1:
                with span("train_loop.fetch"):
                    first = torch.stack([v.float() for v in metrics.values()])
                    first.cpu()  # waits for the step
                writer.scalars(step, {"first_step_s":
                                      time.perf_counter() - t_step})
            if step % step_log == 0:
                keys = sorted(metrics)
                values = [metrics[k] for k in keys]
                if psnr_fn is not None:
                    keys.append("train_psnr")
                    values.append(psnr_fn(state, batch))
                pending.append((step, keys,
                                torch.stack([v.float() for v in values]),
                                t_period, period_steps,
                                float(np.sum(data_times[-period_steps:]))))
                period_steps = 0
                t_period = time.perf_counter()
                if len(pending) >= max(1, fetch_every_periods):
                    flush()
            if step % step_save == 0:
                flush()
                saver.put(state)
            if step >= iterations:
                break
        flush()
    finally:
        with span("train_loop.stop"):
            batches.close()
            writer.close()
            saver.close()
    return state
