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

An op whose bf16 output is the residual plus its bf16-rounded branch,
bf16(base + bf16(branch)), is held in two parts instead: its branch
through the op's f32-out tier (the same launches, out - base at the
tolerances above), and its bf16 output by ``rounding_ulps`` at most
``ROUNDING_ULPS``: where the branch is small beside the output's ulp, the
last roundings' flips alone would read near ``REL_RMS_TOL`` against it.

The int8 tier's outputs (rows 1 and 2 with s8 weights, ``q8=True``) are
held by ``rel_rms`` and ``rel_max`` whatever their dtype. Kernel and twin
quantize rows that may differ by a bf16 ulp upstream (the attention tile
sums in another order than its twin), which flips a code, or, where it
moves the row's largest element, redraws the rounding of the whole row:
an error of the order of the quantization step times the weights at an
element (on the card: up to 1.5e-2 of max|branch|, 10.5 bf16 ulps, at rms
7e-4 of the branch), which an element-wise ulp rule does not bound. Their
blocks alone are held bit for bit (``chip_smoke.py`` phase 4d).

The f32 tiers of the trainer's mixed tier (rows 4f, 7f, 8f, 9f and the
LayerNorm backward's f32 instance) are held by the rules above and by two
more, which a single bf16 rounding (about 2^-9 relative) fails where the
rules above cannot see it (kernel and twin already differ by a few 1e-4 of
a branch where an upstream bf16 rounding flips):

* ``bf16_exact``: the share of an f32 output's elements that bf16 holds
  exactly, at most ``F32_EXACT_SHARE_MAX``. An f32 value has its 16 low
  bits all zero once in 65536; an output rounded to bf16 anywhere on its
  way out (dx, the grid, the CLS rows) has all of them so;
* ``sum_rel_max``: a bias gradient the tier sums from its f32 cotangent
  (rows 7f's dbfc, 8f's dbproj, 9f's db2) within ``F32_SUM_REL_MAX`` of max
  |want|. Kernel and twin add the same f32 values in another order (~1e-7
  of the sum); a sum of the cotangent's bf16 copy is off by ~1e-3.

``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py`` hold every
kernel to these; PERF.md gives the readings they were set from.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

REL_RMS_TOL = 1e-2
REL_MAX_TOL = 2e-2
BF16_ULPS = 4
ROUNDING_ULPS = 2
F32_EXACT_SHARE_MAX = 1e-2
F32_SUM_REL_MAX = 1e-4


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


def rounding_ulps(got: torch.Tensor, want: torch.Tensor,
                  base: torch.Tensor) -> float:
    """The largest gap of a bf16 output bf16(base + bf16(branch)) to its
    twin's, in bf16 ulps of max(|got|, |want|, max|want - base|) at each
    element. Kernel and twin round two values. The branch agrees in f32 to
    well under one ulp of the branch's max (the f32-out tier reads max|err|
    ~2.4e-3 x max|branch|; one ulp is >= 3.9e-3 x), so its rounding
    moves the sum by at most one ulp. The sum's rounding then adds at most
    one more: base has a finer grid, so both sums may sit on a tie, which
    rounds to even in opposite directions (x.5 -> x, x+1.5 -> x+2). A
    sound op reads at most 2; a wrong branch reads many."""
    got, want = got.float(), want.float()
    ref_max = float((want - base.float()).abs().max())
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(ref_max)
    return float(((got - want).abs() / _bf16_ulp(mag)).max())


def offset_rows(rng: np.random.RandomState, shape, offset: float = 4.0,
                spread: float = 0.1) -> np.ndarray:
    """f32 rows (last axis) with a large common offset (of either sign and
    of magnitude ``offset`` x (1 + |N(0, 1)|) a row) and a small spread
    (``spread`` x N(0, 1) an element): the inputs on which the card holds
    the f32 ("mixed") tiers to their twins. Rounded to bf16 (an ulp of 2^-5
    or more at |offset| >= 4), such a row loses ~10 % of its spread before
    LayerNorm rescales it, so a kernel that rounds an f32 input to bf16
    fails the bounds above; on unit-variance rows the same rounding moves
    LN's output ~0.4 % and passes them."""
    shape = tuple(shape)
    rows = shape[:-1] + (1,)
    mag = offset * (1.0 + np.abs(rng.randn(*rows)))
    sign = np.where(rng.rand(*rows) < 0.5, -1.0, 1.0)
    return (sign * mag + spread * rng.randn(*shape)).astype(np.float32)


def twin_failures(gap: Dict[str, float], q8: bool = False) -> List[str]:
    """The tolerances ``gap`` breaks; empty when it is within all of them.
    ``q8``: an output of the int8 tier, held by rel_rms and rel_max."""
    bad = []
    if not gap["finite"]:
        bad.append("non-finite output")
    if gap["rel_rms"] > REL_RMS_TOL:
        bad.append(f"rel_rms {gap['rel_rms']:.3e} > {REL_RMS_TOL}")
    if "max_ulps" in gap and not q8:
        if gap["max_ulps"] > BF16_ULPS:
            bad.append(f"max_ulps {gap['max_ulps']:.2f} > {BF16_ULPS}")
    elif gap["rel_max"] > REL_MAX_TOL:
        bad.append(f"rel_max {gap['rel_max']:.3e} > {REL_MAX_TOL}")
    return bad


def bf16_exact(t: torch.Tensor) -> float:
    """The share of an f32 tensor's elements that bf16 holds exactly (their
    16 low bits zero)."""
    bits = t.detach().float().contiguous().view(torch.int32)
    return float(((bits & 0xFFFF) == 0).double().mean())


def f32_failures(got: torch.Tensor, want: Optional[torch.Tensor] = None) -> List[str]:
    """The f32 tier's own rules (above) that ``got`` breaks: with ``want`` a
    bias gradient summed from an f32 cotangent (``sum_rel_max``), else an
    f32 output that must not have been rounded to bf16 (``bf16_exact``)."""
    if got.dtype != torch.float32:
        return [f"dtype {got.dtype}, not the f32 tier's float32"]
    if want is not None:
        rel = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        return ([] if rel <= F32_SUM_REL_MAX
                else [f"sum_rel_max {rel:.3e} > {F32_SUM_REL_MAX}"])
    share = bf16_exact(got)
    return ([] if share <= F32_EXACT_SHARE_MAX
            else [f"bf16_exact {share:.3e} > {F32_EXACT_SHARE_MAX}"])
