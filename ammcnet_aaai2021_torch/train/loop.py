"""The training loop around the step.

Port of ``ammcnet_aaai2021_tpu/train/loop.py`` (reference
``Code/run_helper/train_helper.py``: ``train_from_multi_pretain`` :217-427):
loss and train-PSNR logging every ``step_log`` steps, scalar summaries
every ``step_summary``, full-state checkpoints every ``step_save`` with
optional retention, and a host thread that assembles the next batches while
the device steps.

Scalars go to a CSV (``<run_dir>/summary/scalars.csv``) and the logger.  At
each log step the metrics are stacked on the device and fetched with one
device-to-host copy.  TensorBoard scalars and image grids are not ported
(the card's machine has no tensorboard).
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
from .checkpoint import prune_checkpoints, save_checkpoint
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
    (replaces the reference's DataLoader worker processes).  An exception in
    the producer is raised here.  Closing this generator stops the producer
    thread, which then closes ``batch_iter``."""
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

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
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


def train_loop(state: TrainState, train_step: Callable,
               batch_iter: Iterator, flownet: Optional[torch.nn.Module],
               iterations: int, run_dir: str, logger=None,
               psnr_fn: Optional[Callable] = None,
               step_log: int = STEP_LOG, step_summary: int = STEP_SUMMARY,
               step_save: int = STEP_SAVE_CKPT,
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
    as ``first_step_s``.  Returns ``state``."""
    writer = ScalarWriter(os.path.join(run_dir, "summary"))
    ckpt_dir = os.path.join(run_dir, "training", "checkpoints")
    if logger:
        logger.info("training steps %d to %d", state.step + 1, iterations)
    data_times = []
    period_steps = 0
    t_period = t_data0 = time.perf_counter()
    batches = prefetch(batch_iter)
    try:
        for batch in batches:
            if state.step >= iterations:
                break
            data_times.append(time.perf_counter() - t_data0)
            t_step = time.perf_counter()
            metrics = train_step(state, batch, flownet)
            step = state.step
            period_steps += 1
            if len(data_times) == 1:
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
                # one device-to-host copy for the period's scalars
                row = torch.stack([v.float() for v in values]).cpu().tolist()
                now = time.perf_counter()
                period = max(now - t_period, 1e-9)
                rate = period_steps / period
                data_frac = float(np.sum(data_times[-period_steps:])) / period
                t_period, period_steps = now, 0
                vals = dict(zip(keys, row))
                if logger:
                    logger.info("step %d | %s | %.2f steps/s data_stall=%.0f%%",
                                step, ", ".join(f"{k}={v:.4f}"
                                                for k, v in vals.items()),
                                rate, 100 * data_frac)
                if step % step_summary == 0:
                    writer.scalars(step, vals)
                    writer.scalars(step, {"steps_per_sec": rate,
                                          "data_stall_frac": data_frac})
            if step % step_save == 0:
                save_checkpoint(ckpt_dir, state)
                deleted = prune_checkpoints(ckpt_dir, keep_ckpts, keep_every)
                if logger:
                    logger.info("checkpoint saved at step %d%s", step,
                                f" (pruned {len(deleted)})" if deleted else "")
            t_data0 = time.perf_counter()
            if step >= iterations:
                break
    finally:
        batches.close()
        writer.close()
    return state
