"""Run logging: console + rotating file handlers.

Rebuild of ``Code/utils/utils.py:27-64`` (get_logger/set_yaml_log_root) minus
the YAML dictConfig indirection: same channels (console, info file, error
file; 10 MB x 20 rotation) configured directly.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Optional


def get_logger(name: str = "ammcnet", log_dir: Optional[str] = None,
               level: int = logging.INFO) -> logging.Logger:
    # key the logger by its log_dir so multiple runs in one process each get
    # their own rotating files (a bare name would silently reuse the first
    # run's handlers)
    if log_dir:
        name = f"{name}.{abs(hash(os.path.abspath(log_dir))) & 0xFFFFFF:06x}"
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    logger.addHandler(console)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        for fname, lvl in (("info.log", level), ("errors.log", logging.ERROR)):
            fh = logging.handlers.RotatingFileHandler(
                os.path.join(log_dir, fname),
                maxBytes=10 * 1024 * 1024, backupCount=20)
            fh.setLevel(lvl)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger
