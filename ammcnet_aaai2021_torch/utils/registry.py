"""Experiment registry: exp_tag -> run dir, with the train -> test config
round trip.

The port's copy of ``ammcnet_aaai2021_tpu/utils/registry.py`` (reference
fcntl-locked json registry and pickled net-params,
``Code/utils/utils.py:266-282``, ``Code/models/__init__.py:61-70,158-181``):
a training run registers ``exp_tag -> run_dir`` and writes its full
:class:`~..configs.ExperimentConfig` as JSON in the run dir; a test run
resolves the tag and rebuilds the exact train-time configuration.  The file
lock lets several training processes share one registry.
"""

from __future__ import annotations

import fcntl
import json
import os
import time
from typing import Dict

from ..configs import ExperimentConfig

CONFIG_FILENAME = "experiment_config.json"


def _locked_update(path: str, key: str, value: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "a+") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        fh.seek(0)
        text = fh.read()
        data: Dict[str, str] = json.loads(text) if text.strip() else {}
        data[key] = value
        fh.seek(0)
        fh.truncate()
        json.dump(data, fh, indent=2)
        fcntl.flock(fh, fcntl.LOCK_UN)


def register_run(registry_path: str, cfg: ExperimentConfig) -> str:
    """Create the run dir (named like the reference's
    "{net_tag}-{dataset}-{data_type}-{unix_ts}"), register it under
    ``cfg.exp_tag`` and write ``cfg`` into it."""
    run_name = (f"{cfg.net.net_tag}-{cfg.data.dataset_name}-"
                f"{cfg.net.data_type}-{int(time.time())}")
    run_dir = os.path.join(cfg.save_dir, run_name)
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, CONFIG_FILENAME), "w") as fh:
        fh.write(cfg.to_json())
    _locked_update(registry_path, cfg.exp_tag, run_dir)
    return run_dir


def resolve_run(registry_path: str, exp_tag: str) -> str:
    with open(registry_path) as fh:
        fcntl.flock(fh, fcntl.LOCK_SH)
        data = json.load(fh)
        fcntl.flock(fh, fcntl.LOCK_UN)
    if exp_tag not in data:
        raise KeyError(f"exp_tag {exp_tag!r} not in registry {registry_path!r}")
    return data[exp_tag]


def load_run_config(run_dir: str) -> ExperimentConfig:
    with open(os.path.join(run_dir, CONFIG_FILENAME)) as fh:
        return ExperimentConfig.from_json(fh.read())
