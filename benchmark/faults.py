"""Faults planted under the timed path, to show that the correctness
check catches them (``benchmark/control.py`` on the card,
``benchmark/tests`` on the CPU): each patches the port for the duration of
a ``with`` block.

* ``alter_record``: every record the chunk scorer produces is 1 % off
  (an answer altered where it is produced);
* ``state_unchanged``: the training step puts every parameter and buffer
  back as it found them;
* ``half_batch``: the training step sees only the first half of each
  batch (its means over the rest).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

FAULTS = ("alter_record", "state_unchanged", "half_batch")


@contextlib.contextmanager
def planted(name: str) -> Iterator[None]:
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; have {FAULTS}")
    if name == "alter_record":
        from ammcnet_aaai2021_torch.eval import export

        orig = export.ChunkScorer.forward

        def forward(self, rgbs, ops):
            return orig(self, rgbs, ops) * 1.01

        export.ChunkScorer.forward = forward
        try:
            yield
        finally:
            export.ChunkScorer.forward = orig
        return
    from ammcnet_aaai2021_torch.train import steps

    orig_make = steps.make_twostream_train_step

    def make(*args, **kwargs):
        step = orig_make(*args, **kwargs)

        def faulty(state, batch, flownet):
            if name == "half_batch":
                half = batch["rgb"].shape[0] // 2
                return step(state, {k: v[:half] for k, v in batch.items()},
                            flownet)
            held = [t.detach().clone() for m in (state.generator,
                                                 state.discriminator)
                    for t in list(m.parameters()) + list(m.buffers())]
            metrics = step(state, batch, flownet)
            with torch.no_grad():
                live = [t for m in (state.generator, state.discriminator)
                        for t in list(m.parameters()) + list(m.buffers())]
                for t, h in zip(live, held):
                    t.copy_(h)
            return metrics

        return faulty

    steps.make_twostream_train_step = make
    try:
        yield
    finally:
        steps.make_twostream_train_step = orig_make
