#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Imports torch, numpy and the port package
(``dino_video_summarization_transformer_tpu_torch``) only. Phases:

1. card: require CUDA; print ``nvidia-smi``'s name and power limit.
2. build: compile the Hopper kernels from ``ops/csrc/`` with nvcc; print
   the build time and ptxas's register / shared-memory lines.
3. kernels: each kernel against its plain twin on the card at ViT-B/16
   widths (N=196, D=768, H=12, MLP 3072), at the teacher (B=8, T=30) and
   student (B=8, T=3) windows of the chunk-8 scorer; CUDA-event times of
   kernel and twin beside the bound computed from the shapes.
4. main path, bf16: ``make_scorers`` + ``run_scoring`` on ViT-B/16 with
   numpy-seeded weights over two synthetic clips (64 and 40 frames);
   launch counters read around the run; losses held against the plain
   bf16 path and the f32 path.
5. main path, f32: the reference-compat path (TF32 off) on one clip.

Tolerances (stated here, checked below):
* kernel vs twin (``ops/twin_check.py``, per output): both share every
  bf16 rounding point, so the gap is held against what the op computes,
  not what it passes through: the temporal op's out - x, the spatial
  grid's out - x1 (the branches, each far smaller than the stream of
  rms 1 they are added to) and the CLS rows. rms(err) <= 1e-2 x
  rms(branch); f32 outputs max|err| <= 2e-2 x max|branch|; the bf16 grid
  within 4 bf16 ulps of max(|want|, rms(branch)) at every element. PERF.md gives the
  readings they were set from and the planted faults they catch.
* per-frame losses against the f32 path (the oracle): the kernel path's
  mean absolute error <= 1.5 x the plain bf16 path's + 1e-3. Both bf16
  tiers sit a few % from f32 (the teacher softmax at temperature 0.02
  amplifies feature rounding); the kernel path's f32 intra-block carry
  should keep it no further than the plain tier.
* per-frame losses, kernel path vs the plain bf16 path: mean relative
  difference <= 0.06, about 2x the largest sound reading (0.031); kernels
  with uniform attention read 0.072.

Any failed check exits non-zero before the last line, which is
``{"ok": true, "device": {...}}``. The line before it lists every kernel as
JSON; the line before that is the card's name and power limit.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

LOSS_REL_TOL = 0.06
LOSS_F32_RATIO = 1.5


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
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


def bound_ms(flops, nbytes):
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3, (
        "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES
        else "bytes")


def temporal_cost(B, T, N, D):
    """FLOP and bytes the op must do: qkv, proj, fc GEMMs (10 D^2 per row)
    + attention over T (4 T D per row); x read (bf16), out written (f32),
    weights read once (bf16)."""
    M = B * T * N
    flops = M * (10 * D * D + 4 * T * D)
    nbytes = M * D * 2 + M * D * 4 + 5 * D * D * 2
    return flops, nbytes


def spatial_cost(B, T, N, D, Dh):
    """qkv over the grid rows plus one CLS row per sample, attention over
    L = N + 1 per frame, proj over grid + per-frame CLS rows, the MLP;
    x1 read (f32), cls read (bf16), grid out (bf16), CLS rows out (f32),
    weights once (bf16)."""
    M, L = B * T * N, N + 1
    flops = (2 * (M + B) * D * 3 * D + 4 * B * T * L * L * D
             + 2 * (M + B * T) * D * D + 4 * M * D * Dh)
    nbytes = (M * D * 4 + B * D * 2 + M * D * 2 + B * T * D * 4
              + (4 * D * D + 2 * D * Dh) * 2)
    return flops, nbytes


def kernel_breakdown(fn):
    """Device time by kernel name over one call of ``fn``
    (torch.profiler, CUDA activity): [(name, count, ms)], largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.device_time_total / 1e3)
            for e in prof.key_averages() if e.device_time_total > 0]
    return sorted(rows, key=lambda r: -r[2])


def check_close(name, got, want, base=None):
    """Print the kernel's gap to its twin (ops/twin_check.py); True if it is
    within tolerance."""
    from dino_video_summarization_transformer_tpu_torch.ops import twin_check

    gap = twin_check.twin_gap(got, want, base)
    bad = twin_check.twin_failures(gap)
    ulps = f" max_ulps={gap['max_ulps']:.2f}" if "max_ulps" in gap else ""
    print(f"  {name}: max_abs_err={gap['max_abs_err']:.3e} rms_err="
          f"{gap['rms_err']:.3e} ref_rms={gap['ref_rms']:.3e} ref_max="
          f"{gap['ref_max']:.3e} rel_rms={gap['rel_rms']:.3e} rel_max="
          f"{gap['rel_max']:.3e}{ulps} {'ok' if not bad else 'FAILED: ' + '; '.join(bad)}",
          flush=True)
    return not bad, gap


def main():
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"missing dependency: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    sys.path.insert(0, REPO)
    try:
        from dino_video_summarization_transformer_tpu_torch.data.transform import (
            tensor_normalize)
        from dino_video_summarization_transformer_tpu_torch.data.windows import (
            window_indices)
        from dino_video_summarization_transformer_tpu_torch.engine.scoring import (
            make_scorers, run_scoring)
        from dino_video_summarization_transformer_tpu_torch.models import (
            convert, timesformer as tsf)
        from dino_video_summarization_transformer_tpu_torch.ops import (
            _build, fused_block as fb)
        from dino_video_summarization_transformer_tpu_torch.utils.synthetic import (
            make_numpy_params, make_video)
    except ImportError as e:
        fail(f"the port package is not importable here: {e}")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")
    t_start = time.perf_counter()

    # -- 1. card ----------------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))",
          flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain twins in true f32

    # -- 2. build -----------------------------------------------------------------
    res = _build.build(force=True)
    print(f"[2] build: {res.seconds:.1f} s ({res.path})", flush=True)
    fn = None
    for line in res.log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "Used" in line and fn:
            print(f"  {fn}: {line.split(':', 1)[1].strip()}", flush=True)
    _build.load()

    # -- 3. kernels against their twins at ViT-B widths -------------------------
    cfg = tsf.vit_base_config(num_frames=8, num_classes=0)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, seed=0), cfg)
    D, H, N = cfg.embed_dim, cfg.num_heads, cfg.num_patches
    Dh = int(D * cfg.mlp_ratio)
    one_block = tsf.build_timesformer(
        tsf.TimeSformerConfig(embed_dim=D, depth=1, num_heads=H, num_frames=8,
                              num_classes=0), sd, device=dev)
    p = fb.block_params(one_block.blocks[0])
    print("[3] kernels vs plain twins (N=196, D=768, H=12)", flush=True)
    stats = {"temporal_phase_tm": [], "spatial_mlp": []}
    for B, T in [(8, 30), (8, 3)]:
        r = np.random.RandomState(T)
        x = torch.from_numpy(r.randn(B, T, N, D)).to(dev, torch.bfloat16)
        x1 = torch.from_numpy(r.randn(B, T, N, D)).to(dev, torch.float32)
        cls = torch.from_numpy(r.randn(B, 1, D)).to(dev, torch.bfloat16)
        iters = 20 if T > 8 else 50
        with torch.inference_mode():
            g, c = fb.spatial_mlp(x1, cls, p["spatial"], H)
            g0, c0 = fb.spatial_mlp_plain(x1, cls, p["spatial"], H)
            checks = [
                check_close(f"temporal_phase_tm out-x B={B} T={T}",
                            fb.temporal_phase_tm(x, p["temporal"], H),
                            fb.temporal_phase_tm_plain(x, p["temporal"], H), x),
                check_close(f"spatial_mlp grid-x1 B={B} T={T}", g, g0, x1),
                check_close(f"spatial_mlp cls B={B} T={T}", c, c0)]
            if not all(ok for ok, _ in checks):
                fail(f"a kernel disagrees with its plain twin at B={B} T={T}")
            gaps = [gap for _, gap in checks]
            ms_t = cuda_ms(lambda: fb.temporal_phase_tm(x, p["temporal"], H), iters)
            pl_t = cuda_ms(lambda: fb.temporal_phase_tm_plain(x, p["temporal"], H), 5)
            ms_s = cuda_ms(lambda: fb.spatial_mlp(x1, cls, p["spatial"], H), iters)
            pl_s = cuda_ms(lambda: fb.spatial_mlp_plain(x1, cls, p["spatial"], H), 5)
        bt, by_t = bound_ms(*temporal_cost(B, T, N, D))
        bs, by_s = bound_ms(*spatial_cost(B, T, N, D, Dh))
        for name, ms, pl, b, by, op_gaps in [
                ("temporal_phase_tm", ms_t, pl_t, bt, by_t, gaps[:1]),
                ("spatial_mlp", ms_s, pl_s, bs, by_s, gaps[1:])]:
            stats[name].append({
                "B": B, "T": T, "ms": ms, "plain_ms": pl, "bound_ms": b,
                "bound_by": by,
                "max_abs_err": max(g["max_abs_err"] for g in op_gaps),
                "rel_rms": max(g["rel_rms"] for g in op_gaps)})
            print(f"  {name} B={B} T={T}: kernel {ms:.3f} ms, plain {pl:.3f} ms,"
                  f" bound {b:.4f} ms ({by}), {b / ms:.1%} of bound", flush=True)
        if T > 8:  # where the time goes inside each op, teacher window
            for name, fn in [
                    ("temporal_phase_tm",
                     lambda: fb.temporal_phase_tm(x, p["temporal"], H)),
                    ("spatial_mlp",
                     lambda: fb.spatial_mlp(x1, cls, p["spatial"], H))]:
                rows = kernel_breakdown(fn)
                total = sum(r[2] for r in rows)
                print(f"  {name} B={B} T={T} by kernel (torch.profiler, "
                      f"{total:.3f} ms device time):", flush=True)
                for k, n, ms in rows:
                    print(f"    {ms:8.3f} ms {n:3d}x {k[:90]}", flush=True)
    del x, x1, cls, one_block
    torch.cuda.empty_cache()

    # -- 4. main path, bf16, through make_scorers + run_scoring ------------------
    print("[4] main path, bf16: make_scorers + run_scoring, ViT-B/16, "
          "local 3, global 30, chunk 8", flush=True)
    items = []
    for i, T in enumerate([64, 40]):
        vid = make_video(seed=10 + i, T=T, size=224)
        frames = tensor_normalize(vid, [0.45] * 3, [0.225] * 3)
        loc, glob, eff = window_indices(T, 3, 30)
        items.append({"path": f"clip{i}.mp4", "frames": frames, "local_idx": loc,
                      "global_idx": glob, "eff_global": eff, "num_frames": T,
                      "local_size": 3, "dummy": False})
    n_frames = sum(it["num_frames"] for it in items)
    chunks = math.ceil(n_frames / 8)

    def scorers_for(dtype, use_kernels):
        return make_scorers(
            sd, cfg, n_devices=1, local_size=3, global_size=30, chunk=8,
            compute_dtype=dtype, use_kernels=use_kernels,
            precision="highest" if dtype == torch.float32 else None)

    def run(scorers, its, tag):
        out = os.path.join(tmp, f"loss_{tag}.json")
        run_scoring(its, scorers, out, num_workers=1, log_every=0)
        with open(out) as f:
            return json.load(f)

    with tempfile.TemporaryDirectory() as tmp:
        scorers = scorers_for(torch.bfloat16, "auto")
        if not scorers[0].model_cfg.use_kernels:
            fail("use_kernels='auto' did not select the kernels on the card")
        run(scorers, items[1:], "warmup")
        fb.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run(scorers, items, "kernels")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(fb.launches)
        want = 2 * cfg.depth * chunks
        print(f"  launches {counts} (expected {want} each = 2 forwards x "
              f"{cfg.depth} blocks x {chunks} chunks)", flush=True)
        for k, v in counts.items():
            if v != want:
                fail(f"{k} launched {v} times on the main path, expected {want}")
        for it in items:
            key = it["path"][:-4]
            if key not in got or len(got[key]) != it["num_frames"]:
                fail(f"{key}: expected {it['num_frames']} losses in the JSON")
            if not np.all(np.isfinite(got[key])):
                fail(f"{key}: non-finite losses")
        print(f"  frames_per_s={n_frames / wall:.2f} ms_per_chunk="
              f"{wall * 1e3 / chunks:.1f} ({n_frames} frames, {chunks} chunks) "
              f"on {card}", flush=True)
        del scorers
        fb.reset_launches()
        plain = run(scorers_for(torch.bfloat16, False), items, "plain")
        if any(fb.launches.values()):
            fail("use_kernels=False launched a kernel")

        # -- 5. main path, f32 (reference-compat, TF32 off) -----------------------
        print("[5] main path, f32 (TF32 off)", flush=True)
        f32 = run(scorers_for(torch.float32, "auto"), items, "f32")
        if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
            fail("the f32 scorer left TF32 on")
        if any(fb.launches.values()):
            fail("the f32 path launched a kernel")

    for it in items:
        key = it["path"][:-4]
        k, pb, ref = (np.asarray(d[key]) for d in (got, plain, f32))
        if not np.all(np.isfinite(ref)) or len(ref) != it["num_frames"]:
            fail(f"{key}: f32 losses missing or non-finite")
        rel = float(np.mean(np.abs(k - pb)) / np.mean(np.abs(pb)))
        e_k = float(np.mean(np.abs(k - ref)))
        e_p = float(np.mean(np.abs(pb - ref)))
        print(f"  {key}: mean loss (f32) {np.mean(ref):.4f}; vs f32 mean abs: "
              f"kernel path {e_k:.3e}, plain bf16 {e_p:.3e} (need kernel <= "
              f"{LOSS_F32_RATIO} x plain + 1e-3); kernel vs plain bf16 mean "
              f"rel {rel:.3e} (<= {LOSS_REL_TOL})", flush=True)
        if e_k > LOSS_F32_RATIO * e_p + 1e-3:
            fail(f"{key}: the kernel path is further from f32 than allowed")
        if rel > LOSS_REL_TOL:
            fail(f"{key}: kernel-path losses disagree with the plain bf16 path")

    kernels = []
    sources = {
        "temporal_phase_tm": "dino_video_summarization_transformer_tpu/ops/fused_block.py:761",
        "spatial_mlp": "dino_video_summarization_transformer_tpu/ops/fused_block.py:1556",
    }
    for name, rows in stats.items():
        # one main-path block per chunk calls the op once at each window
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dino_video_summarization_transformer_tpu_torch/ops/csrc/fused_block.cu",
            "replaces": sources[name], "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": rows[0]["bound_by"], "library_ms": None,
            "per_window": rows})
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
