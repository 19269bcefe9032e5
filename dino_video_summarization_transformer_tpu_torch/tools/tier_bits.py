"""Save the bf16 training ops' outputs, or compare two saves bit for bit.

Runs the bf16 tiers of rows 4 (``spatial_phase``), 7, 8 and 9 (the three
backwards) and the LayerNorm backward at the DINO train step's global
crops (B = 16 clips, T = 8, N = 196, ViT-B widths) on inputs and weights
drawn from fixed seeds, and saves every output. Run it from two checkouts
on one card and compare: equal saves show that a change to the kernels
left the bf16 instances' arithmetic as it was. With ``--device cpu`` the
ops run their plain twins, at a small shape (B = 2, T = 4, N = 6, D = 256,
4 heads), for the same comparison of the twins.

    python3 dino_video_summarization_transformer_tpu_torch/tools/tier_bits.py \\
        --repo OTHER_CHECKOUT --out a.pt [--device cpu]
    python3 dino_video_summarization_transformer_tpu_torch/tools/tier_bits.py --out b.pt
    python3 dino_video_summarization_transformer_tpu_torch/tools/tier_bits.py --compare a.pt b.pt

``--repo`` imports the port package of that checkout (and so builds and
runs its kernels).
"""

import argparse
import os
import sys


def save(repo: str, out: str, device: str) -> None:
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        sys.exit("needs a CUDA card (or --device cpu: the plain twins)")
    sys.path.insert(0, os.path.abspath(repo))
    from dino_video_summarization_transformer_tpu_torch.models import convert
    from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf
    from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb
    from dino_video_summarization_transformer_tpu_torch.utils.synthetic import (
        make_numpy_params)

    dev = torch.device(device)
    B, T, N, D, H = (16, 8, 196, 768, 12) if device == "cuda" else (2, 4, 6, 256, 4)
    cfg = tsf.TimeSformerConfig(embed_dim=D, depth=1, num_heads=H, num_frames=T,
                                num_classes=0)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, seed=0), cfg)
    p = fb.block_params(tsf.build_timesformer(cfg, sd, device=dev).blocks[0])
    pt, ps = p["temporal"], p["spatial"]
    g = torch.Generator(device=device).manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    x, dout, cls, dco = rnd(B, T, N, D), rnd(B, T, N, D), rnd(B, 1, D), rnd(B, T, D)
    xm, dm = x.reshape(-1, D), dout.reshape(-1, D)
    dy = rnd(B * T * N + B * T, D, dtype=torch.float32)
    w = 1 + 0.1 * rnd(D, dtype=torch.float32)
    outs = {"row4": fb.spatial_phase(x, cls, ps, H),
            "row7": fb.temporal_phase_tm_bwd(x, dout, pt, H),
            "row8": fb.spatial_phase_bwd(x, cls, dout, dco, ps, H),
            "row9": fb.mlp_phase_bwd(xm, dm, ps),
            "row9_cls": fb.mlp_phase_bwd(xm[:B].contiguous(), dm[:B].contiguous(), ps),
            "ln_bwd": fb.layer_norm_bwd(xm, dy, w, dm, cls.reshape(B, D), T)}
    if device == "cuda":
        torch.cuda.synchronize()
    torch.save(_flat(outs), out)
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu: the plain twins"
    print(f"saved {len(_flat(outs))} tensors from {os.path.abspath(repo)} to {out} ({name})")


def _flat(tree, prefix=""):
    import torch

    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu()}
    if tree is None:
        return {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def compare(a: str, b: str) -> int:
    import torch

    ta, tb = torch.load(a), torch.load(b)
    if sorted(ta) != sorted(tb):
        print(f"different outputs: {sorted(set(ta) ^ set(tb))}")
        return 1
    bad = [k for k in sorted(ta) if ta[k].dtype != tb[k].dtype or not torch.equal(ta[k], tb[k])]
    for k in bad:
        d = (ta[k].float() - tb[k].float()).abs().max()
        print(f"  {k}: differs (max abs {float(d):.3e})")
    print(f"{len(ta) - len(bad)} of {len(ta)} outputs bit-equal")
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--out")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not args.out:
        ap.error("--out or --compare")
    save(args.repo, args.out, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
