"""Times the standalone attention (``ops/attention.fused_attention``, bf16),
the temporal attention of rows 1 and 6 (``ops/fused_block.
temporal_attention``) and the banded temporal attention
(``ops/banded_block.banded_temporal_attn``) at the shapes of the port's
main paths, beside their one-call PyTorch yardsticks, on one CUDA card.

    python3 -m dino_video_summarization_transformer_tpu_torch.tools.attn_bench
    python3 dino_video_summarization_transformer_tpu_torch/tools/attn_bench.py \\
        --repo OTHER_CHECKOUT

``--repo`` imports the port package (and so builds and times the kernels)
of another checkout, e.g. an unpacked parent commit, so two versions can be
timed in turns within one run on one card. Shapes: ViT-B/16 (N=196, D=768,
H=12, hd 64); the attention swap's head sequences of the chunk-8 scorer's
windows (B=8, T=30 and 3: spatial (B*T*H, 197), temporal (B*N*H, T)); the
banded pass at the 512-frame bucket (eff 30 and 3). Inputs are
unit-variance bf16 from a seeded numpy generator. ``ms`` is the CUDA-event
mean over ``--iters`` calls after a warm-up, as ``chip_smoke.py`` takes it
(no cache flush; where a kernel is shorter than the wrapper's host time,
this is the host's rate); ``device_ms`` is the device time per call of ten
calls captured in a CUDA graph and replayed, with no host time between
launches. Prints the card's name and power limit, then one JSON line.
"""

import argparse
import json
import os
import subprocess
import sys


def cuda_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, reps=10, iters=10):
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed between two events, so no host time falls between launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, iters) / reps


def timed(fn, iters):
    return {"ms": cuda_ms(fn, iters), "device_ms": graph_ms(fn)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.repo))
    from dino_video_summarization_transformer_tpu_torch.ops import (
        attention as fa, banded_block as bb)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    N, D, H, hd, B = 196, 768, 12, 64, 8
    rows = []
    for seq, T, BH, L in (("spatial", 30, B * 30 * H, N + 1),
                          ("temporal", 30, B * N * H, 30),
                          ("spatial", 3, B * 3 * H, N + 1),
                          ("temporal", 3, B * N * H, 3)):
        r = np.random.RandomState(BH + L)
        q, k, v = (torch.from_numpy(r.randn(BH, L, hd)).to(dev, torch.bfloat16)
                   for _ in range(3))
        with torch.inference_mode():
            kern = timed(lambda: fa.fused_attention(q, k, v, hd ** -0.5), args.iters)
            lib = timed(lambda: F.scaled_dot_product_attention(
                q[:, None], k[:, None], v[:, None], scale=hd ** -0.5), args.iters)
        rows.append({"op": "fused_attention", "seq": seq, "T": T, "BH": BH,
                     "L": L, **kern, "library_ms": lib["ms"],
                     "library_device_ms": lib["device_ms"]})
        del q, k, v
    from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb

    # rows 1 and 6's temporal attention (the tile at stride N), where the
    # checkout has it: the windows' sequences at stride N = 196 and row 6's
    # contiguous ones (N = 1), beside SDPA on (BH, 1, T, hd) tensors
    for Bt, T, Nt in ((B, 30, N), (B, 3, N), (B * N, 30, 1), (B * N, 3, 1)):
        if not hasattr(fb, "temporal_attention"):
            break
        tq = torch.from_numpy(np.random.RandomState(T + Nt).randn(
            Bt, T, Nt, 3 * D)).to(dev, torch.bfloat16)
        BH = Bt * Nt * H
        q, k, v = (torch.randn(BH, 1, T, hd, device=dev, dtype=torch.bfloat16)
                   for _ in range(3))
        with torch.inference_mode():
            kern = timed(lambda: fb.temporal_attention(tq, H), args.iters)
            lib = timed(lambda: F.scaled_dot_product_attention(q, k, v), args.iters)
        rows.append({"op": "temporal_attention", "B": Bt, "T": T, "N": Nt, "BH": BH,
                     **kern, "library_ms": lib["ms"],
                     "library_device_ms": lib["device_ms"]})
        del tq, q, k, v
    C = 512
    qkv = torch.from_numpy(np.random.RandomState(5).randn(C, N, 3 * D)).to(
        dev, torch.bfloat16)
    sq, sk, sv = (qkv[..., i * D:(i + 1) * D].reshape(C, N, H, hd)
                  .permute(1, 2, 0, 3).contiguous() for i in range(3))
    for eff in (30, 3):
        lo = bb.band_starts(torch.arange(C, device=dev), eff, C)
        kj = torch.arange(C, device=dev)
        mask = (kj[None] >= lo[:, None]) & (kj[None] < lo[:, None] + eff)
        with torch.inference_mode():
            kern = timed(lambda: bb.banded_temporal_attn(qkv, C, eff, H), args.iters)
            lib = timed(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask), args.iters)
        rows.append({"op": "banded_temporal_attn", "C": C, "eff": eff, **kern,
                     "library_ms": lib["ms"], "library_device_ms": lib["device_ms"]})
    print(card)
    print(json.dumps({"repo": os.path.abspath(args.repo), "card": card,
                      "rows": rows}))


if __name__ == "__main__":
    main()
