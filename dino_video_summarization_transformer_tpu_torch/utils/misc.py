"""Small CLI helpers (copied from the JAX package's ``utils/misc.py``)."""

from __future__ import annotations

import argparse


def bool_flag(s: str) -> bool:
    """(ref: utils/utils.py:171-182)."""
    FALSY = {"off", "false", "0"}
    TRUTHY = {"on", "true", "1"}
    if s.lower() in FALSY:
        return False
    if s.lower() in TRUTHY:
        return True
    raise argparse.ArgumentTypeError("invalid value for a boolean flag")
