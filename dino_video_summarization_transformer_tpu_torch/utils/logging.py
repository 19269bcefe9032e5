"""Structured logging (ref: utils/logging.py:22-34, utils/utils.py:422-434),
copied from the JAX package's ``utils/logging.py``."""

from __future__ import annotations

import builtins
import decimal
import json
import logging
import sys


def setup_logging(name: str = "dvst", level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(
            "[%(asctime)s %(levelname)s %(name)s] %(message)s"))
        logger.addHandler(h)
    logger.setLevel(level)
    return logger


def log_json_stats(stats: dict, logger: logging.Logger | None = None) -> None:
    """JSON stats line (ref: utils/logging.py:22-34): floats rounded to 5
    decimals like the reference's simplejson output, keys sorted."""
    rounded = {
        k: (float(decimal.Decimal(f"{v:.5f}")) if isinstance(v, float) else v)
        for k, v in stats.items()
    }
    line = json.dumps(rounded, sort_keys=True)
    (logger or setup_logging()).info("json_stats: %s", line)


def setup_for_distributed(is_master: bool) -> None:
    """Gate print on non-master processes, keeping force=True escape
    (ref: utils/utils.py:422-434)."""
    builtin_print = builtins.print

    def print_gated(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            builtin_print(*args, **kwargs)

    builtins.print = print_gated
