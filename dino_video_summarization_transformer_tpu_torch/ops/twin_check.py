"""How far a kernel's output may sit from its plain twin's.

Kernel and twin share every bf16 rounding point and differ only in f32
summation order, which now and then flips one bf16 rounding of an
intermediate (2^-8 relative). So the gap is held against the size of what
the op computes, not of what it passes through: where an output is a
residual stream plus a branch (the temporal op's ``x + branch``, the
spatial op's grid ``x1 + branches``), the error is measured against the
branch, ``want - base``; a wrong softmax inside a branch a thirtieth the
size of the stream would pass a tolerance set on the stream.

* ``rel_rms``: rms(got - want) / rms(want - base) <= ``REL_RMS_TOL``;
* ``rel_max``: max|got - want| / max|want - base| <= ``REL_MAX_TOL``
  (f32 outputs);
* ``max_ulps``: |got - want| in bf16 ulps of max(|got|, |want|,
  rms(want - base)), at most ``BF16_ULPS`` at every element (bf16
  outputs). The last rounding alone may flip one ulp; the rest is the
  branch's own f32 error, which the bf16 rounding points upstream (LN
  rows, qkv, probabilities, the MLP hidden) carry at ~1e-3 of the branch.
  Below the branch's rms an element's ulp shrinks faster than that error,
  so the ulp is taken at the branch's rms there.

``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py`` hold every
kernel to these; PERF.md gives the readings they were set from.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

REL_RMS_TOL = 1e-2
REL_MAX_TOL = 2e-2
BF16_ULPS = 4


def _bf16_ulp(a: torch.Tensor) -> torch.Tensor:
    """bf16 ulp at |a| (8 significant bits): 2^(floor(log2|a|) - 7)."""
    _, e = torch.frexp(a)
    return torch.pow(2.0, (e - 8).to(torch.float32))


def twin_gap(got: torch.Tensor, want: torch.Tensor,
             base: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """The kernel output ``got`` against the twin's ``want``; ``base`` is the
    residual stream the op adds its branch to, if any."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    ref = want if base is None else want - base.float()
    err = (got - want).abs()

    def rms(t):
        return float(t.double().square().mean().sqrt())

    gap = {"finite": bool(got.isfinite().all()),
           "max_abs_err": float(err.max()), "rms_err": rms(err),
           "ref_rms": rms(ref), "ref_max": float(ref.abs().max())}
    gap["rel_rms"] = gap["rms_err"] / max(gap["ref_rms"], 1e-30)
    gap["rel_max"] = gap["max_abs_err"] / max(gap["ref_max"], 1e-30)
    if bf16:
        mag = torch.maximum(got.abs(), want.abs()).clamp_min(gap["ref_rms"])
        gap["max_ulps"] = float((err / _bf16_ulp(mag)).max())
    return gap


def twin_failures(gap: Dict[str, float]) -> List[str]:
    """The tolerances ``gap`` breaks; empty when it is within all of them."""
    bad = []
    if not gap["finite"]:
        bad.append("non-finite output")
    if gap["rel_rms"] > REL_RMS_TOL:
        bad.append(f"rel_rms {gap['rel_rms']:.3e} > {REL_RMS_TOL}")
    if "max_ulps" in gap:
        if gap["max_ulps"] > BF16_ULPS:
            bad.append(f"max_ulps {gap['max_ulps']:.2f} > {BF16_ULPS}")
    elif gap["rel_max"] > REL_MAX_TOL:
        bad.append(f"rel_max {gap['rel_max']:.3e} > {REL_MAX_TOL}")
    return bad
