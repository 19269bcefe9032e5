"""Times the CLS window aggregation (``ops/banded_block.cls_band_attn``,
row 12) in each block shape it can take, and the per-phase attention
(``ops/fused_block.attn_phase``, row 5), at the banded pass's and the
windows' shapes, on one CUDA card; every timed call is first held to its
plain twin (``ops/twin_check.py``).

    python3 -m dino_video_summarization_transformer_tpu_torch.tools.cls_band_bench
    python3 dino_video_summarization_transformer_tpu_torch/tools/cls_band_bench.py \\
        --repo OTHER_CHECKOUT

Row 12 at ViT-B/16 (N=196, D=768, H=12) over the buckets 512, 256 and 64
at eff 30 and 3 (t_real = C): the block shape the library picks (strips
of 16 query frames a block, warps a strip, splits of the target frames)
and, at 512, a sweep of others, run through the library's test entry
``dvst_cls_band_attn_shaped``; beside each, the bytes a model says it
moves (``modelled_traffic``: every overlapping tile's patch K/V re-read
counted as an HBM read; nothing measures it) and two calls compared bit
for bit. Row 5 at the chunk-8 scorer's spatial sequences, (240, 197) and
(24, 197) rows of 768. ``--repo`` imports the port package
of another checkout (e.g. an unpacked parent commit; run the script as a
file for that): its ops are timed in their default shape only. ``ms`` is
the CUDA-event mean over ``--iters`` calls after a warm-up; ``device_ms``
the device time per call of ten calls captured in a CUDA graph. Inputs
are unit-variance bf16 from a seeded numpy generator. Prints the card's
name and power limit, then one JSON line.
"""

import argparse
import json
import os
import subprocess
import sys

# block shapes (strips, warps a strip, splits) tried at the 512-frame
# bucket beside the library's pick
SWEEP = [(4, 4, 4), (4, 4, 1), (4, 4, 8), (4, 2, 4), (3, 4, 1), (2, 2, 1), (2, 4, 2),
         (1, 4, 2), (1, 2, 2), (1, 4, 1), (1, 8, 2)]


def library_shape(lib, C, N, D, H, eff):
    """The block shape (strips, warps a strip, splits) the library's row 12
    takes at these shapes on the current card."""
    import ctypes

    shape = (ctypes.c_int * 3)()
    err = lib.dvst_cls_band_shape(C, N, D, H, eff, shape)
    if err:
        raise RuntimeError(f"dvst_cls_band_shape failed ({err})")
    return tuple(shape)


def run_shaped(lib, qkv_cls, qkv, t_real, eff, H, shape):
    """Row 12 on the card in the block shape ``shape`` (strips, warps a
    strip, splits): ``banded_block.cls_band_attn``'s launch with the shape
    given instead of picked; counts no launch."""
    import torch

    C, N, D3 = qkv.shape
    D = D3 // 3
    out = torch.empty((C, D), dtype=torch.bfloat16, device=qkv.device)
    ws = torch.empty(shape[2] * C * D if shape[2] > 1 else 0, dtype=torch.float32,
                     device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = lib.dvst_cls_band_attn_shaped(
            qkv_cls.data_ptr(), qkv.data_ptr(), out.data_ptr(), ws.data_ptr(), C, N, D, H,
            int(t_real), eff, *shape, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"CUDA kernel launch failed ({err})")
    return out


def modelled_traffic(C, N, D, t_real, eff, shape):
    """Bytes row 12 would move in ``shape`` (``library_shape``'s triple) if
    every re-read of a patch K/V row reached HBM — a model, not a reading:
    each tile's frames' patch K and V (every head), each split's queries,
    own keys and values, the output (and the splits' f32 partials, written
    and read once). ``reread`` is the patch K/V bytes over one read of the
    C frames'."""
    qs, _, z = shape
    Tq = 16 * qs
    hi = max(t_real - eff, 0)

    def lo(i):
        return min(max(i - eff // 2, 0), hi)

    frames = sum(lo(min(i0 + Tq, C) - 1) + eff - lo(i0) for i0 in range(0, C, Tq))
    kv = frames * N * 2 * D * 2
    rest = z * C * 3 * D * 2 + C * D * 2 + (2 * z * C * D * 4 if z > 1 else 0)
    return {"bytes": kv + rest, "kv_bytes": kv, "reread": kv / (C * N * 2 * D * 2)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.repo))
    from dino_video_summarization_transformer_tpu_torch.ops import (
        _build, banded_block as bb, fused_block as fb, twin_check)
    from dino_video_summarization_transformer_tpu_torch.tools.attn_bench import timed

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    N, D, H = 196, 768, 12
    lib = _build.load("banded")
    # an older checkout's library may have no test entry for block shapes
    sweepable = hasattr(lib, "dvst_cls_band_attn_shaped")
    rows = []

    def check(tag, got, want):
        gap = twin_check.twin_gap(got, want)
        bad = twin_check.twin_failures(gap)
        if bad:
            sys.exit(f"{tag}: the kernel disagrees with its twin: {bad}")
        return gap

    for C in (512, 256, 64):
        r = np.random.RandomState(C)
        qkv = torch.from_numpy(r.randn(C, N, 3 * D)).to(dev, torch.bfloat16)
        qkv_cls = torch.from_numpy(r.randn(C, 3 * D)).to(dev, torch.bfloat16)
        for eff in (30, 3):
            with torch.inference_mode():
                want = bb.cls_band_attn_plain(qkv_cls, qkv, C, eff, H)
                pick = library_shape(lib, C, N, D, H, eff) if sweepable else None
                shapes = [pick] + ([s_ for s_ in SWEEP if s_ != pick]
                                   if sweepable and C == 512 else [])
                for shape in shapes:
                    def run():
                        if shape == pick:
                            return bb.cls_band_attn(qkv_cls, qkv, C, eff, H)
                        return run_shaped(lib, qkv_cls, qkv, C, eff, H, shape)

                    got, again = run(), run()
                    gap = check(f"cls_band_attn C={C} eff={eff} {shape}", got, want)
                    row = {"op": "cls_band_attn", "C": C, "eff": eff,
                           "shape": shape, "picked": shape == pick,
                           "bit_identical": bool(torch.equal(got, again)),
                           "max_abs_err": gap["max_abs_err"], **timed(run, args.iters)}
                    if shape:
                        model = modelled_traffic(C, N, D, C, eff, shape)
                        row.update({f"modelled_{k}": v for k, v in model.items()})
                        row["modelled_gbs"] = model["bytes"] / row["device_ms"] / 1e6
                    rows.append(row)
                    print(json.dumps(row), flush=True)
        del qkv, qkv_cls
    p = {"ln1_w": torch.ones(D, device=dev), "ln1_b": torch.zeros(D, device=dev)}
    r = np.random.RandomState(9)
    for k, shape in (("qkv_w", (3 * D, D)), ("proj_w", (D, D))):
        p[k] = torch.from_numpy(0.03 * r.randn(*shape)).to(dev, torch.bfloat16)
    p["qkv_b"] = torch.zeros(3 * D, device=dev)
    p["proj_b"] = torch.zeros(D, device=dev)
    for S in (240, 24):
        x = torch.from_numpy(r.randn(S, N + 1, D)).to(dev, torch.bfloat16)
        with torch.inference_mode():
            gap = check(f"attn_phase S={S}", fb.attn_phase(x, p, H),
                        fb.attn_phase_plain(x, p, H))
            row = {"op": "attn_phase", "S": S, "L": N + 1,
                   "max_abs_err": gap["max_abs_err"],
                   **timed(lambda: fb.attn_phase(x, p, H), args.iters)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(card)
    print(json.dumps({"repo": os.path.abspath(args.repo), "card": card, "rows": rows}))


if __name__ == "__main__":
    main()
