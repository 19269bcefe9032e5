"""Small CLI helpers (copied from the JAX package's ``utils/misc.py``):
``bool_flag`` and the git stamp the evaluation CLIs print."""

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


def get_sha() -> str:
    """Git SHA stamp for logs (ref: utils/utils.py:373-390)."""
    import os
    import subprocess

    cwd = os.path.dirname(os.path.abspath(__file__))

    def _run(cmd):
        return subprocess.check_output(cmd, cwd=cwd).decode("ascii").strip()

    sha, diff, branch = "N/A", "clean", "N/A"
    try:
        sha = _run(["git", "rev-parse", "HEAD"])
        subprocess.check_output(["git", "diff"], cwd=cwd)
        diff = _run(["git", "diff-index", "HEAD"])
        diff = "has uncommitted changes" if diff else "clean"
        branch = _run(["git", "rev-parse", "--abbrev-ref", "HEAD"])
    except (OSError, subprocess.SubprocessError):
        pass
    return f"sha: {sha}, status: {diff}, branch: {branch}"
