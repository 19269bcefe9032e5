"""Hopper kernels against their plain twins, on the card.

Card-only: every test takes the ``cuda_device`` fixture, which skips where
``torch.cuda.is_available()`` is false (the kernels have no CPU mode). The
file imports neither JAX nor ``tests/conftest.py``'s helpers, so it also
runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerance: ``ops/twin_check.py``, the one ``chip_smoke.py`` uses. Kernel
and twin share every bf16 rounding point and differ only in f32 summation
order, so each output's gap is held against what the op computes: the
temporal op's out - x, the spatial grids' out - x1 (out - x for the
banded spatial phase and the MLP phase), the CLS rows, the qkv buffers
and the banded attention outputs, at rms(err) <= 1e-2 x rms(branch), f32
max|err| <= 2e-2 x max|branch|, and bf16 outputs within 4 bf16 ulps of
max(|want|, rms(branch)) at every element. The frame wire's gather
(``ops/wire.py``) rounds at the twin's points: it is held bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dino_video_summarization_transformer_tpu_torch.models import (  # noqa: E402
    convert, timesformer as tsf)
from dino_video_summarization_transformer_tpu_torch.models import (  # noqa: E402
    banded)
from dino_video_summarization_transformer_tpu_torch.data import yuv  # noqa: E402
from dino_video_summarization_transformer_tpu_torch.engine import (  # noqa: E402
    scoring)
from dino_video_summarization_transformer_tpu_torch.ops import (  # noqa: E402
    _build, banded_block as bb, fused_block as fb, twin_check, wire)
from dino_video_summarization_transformer_tpu_torch.tools import (  # noqa: E402
    cls_band_bench)
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import (  # noqa: E402
    make_numpy_params)

pytestmark = pytest.mark.cuda

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _block(D, H, seed, device):
    cfg = tsf.TimeSformerConfig(img_size=32, patch_size=16, embed_dim=D,
                                depth=1, num_heads=H, num_frames=4,
                                num_classes=0)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, seed), cfg)
    model = tsf.build_timesformer(cfg, sd, device=device)
    return fb.block_params(model.blocks[0])


def _close(got, want, base=None):
    gap = twin_check.twin_gap(got, want, base)
    assert not twin_check.twin_failures(gap), gap


# (B, T, N, D, H): the main path's two windows at ViT-B widths, small
# shapes, and one row for each head dim the kernels take (16..128), at
# N = 196 so the spatial attention runs L = 197 rows in shared memory.
SHAPES = [(2, 3, 16, 128, 2), (1, 5, 4, 256, 4), (8, 30, 196, 768, 12),
          (8, 3, 196, 768, 12),
          (1, 3, 196, 128, 8), (1, 3, 196, 128, 4), (1, 3, 196, 384, 8),
          (1, 3, 196, 640, 8), (1, 3, 196, 384, 4), (1, 3, 196, 896, 8),
          (1, 3, 196, 256, 2)]


@pytest.mark.parametrize("B,T,N,D,H", SHAPES)
def test_temporal_phase_tm_kernel_matches_twin(cuda_device, B, T, N, D, H):
    p = _block(D, H, 0, cuda_device)["temporal"]
    x = torch.from_numpy(np.random.RandomState(1).randn(B, T, N, D)).to(
        cuda_device, torch.bfloat16)
    before = fb.launches["temporal_phase_tm"]
    got = fb.temporal_phase_tm(x, p, H)
    torch.cuda.synchronize()
    assert fb.launches["temporal_phase_tm"] == before + 1
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, fb.temporal_phase_tm_plain(x, p, H), x)


@pytest.mark.parametrize("B,T,N,D,H", SHAPES)
def test_spatial_mlp_kernel_matches_twin(cuda_device, B, T, N, D, H):
    p = _block(D, H, 0, cuda_device)["spatial"]
    r = np.random.RandomState(2)
    x1 = torch.from_numpy(r.randn(B, T, N, D)).to(cuda_device, torch.float32)
    cls = torch.from_numpy(r.randn(B, 1, D)).to(cuda_device, torch.bfloat16)
    before = fb.launches["spatial_mlp"]
    grid, rows = fb.spatial_mlp(x1, cls, p, H)
    torch.cuda.synchronize()
    assert fb.launches["spatial_mlp"] == before + 1
    assert grid.dtype == torch.bfloat16 and rows.dtype == torch.float32
    want_grid, want_rows = fb.spatial_mlp_plain(x1, cls, p, H)
    _close(grid, want_grid, x1)
    _close(rows, want_rows)


def test_forward_kernels_match_twins(cuda_device):
    """A whole bf16 forward on the kernels against the same forward with
    the twins (CPU twins of the same weights and inputs), at depth 2."""
    cfg = tsf.TimeSformerConfig(img_size=64, patch_size=16, embed_dim=128,
                                depth=2, num_heads=2, num_frames=4,
                                num_classes=0, use_kernels=True)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, 3), cfg)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 3, 6, 64, 64))
    gpu = tsf.build_timesformer(cfg, sd, device=cuda_device, dtype=torch.bfloat16)
    cpu = tsf.build_timesformer(cfg, sd, device="cpu", dtype=torch.bfloat16)
    with torch.inference_mode():
        got = gpu(x.to(cuda_device)).cpu()
        want = cpu(x)
    _close(got.float(), want.float())


def test_wrapper_rejects_bad_inputs(cuda_device):
    p = _block(128, 2, 0, cuda_device)["temporal"]
    x = torch.zeros(1, 3, 4, 128, device=cuda_device, dtype=torch.float32)
    with pytest.raises(TypeError):  # f32 in is the mixed tier: f32 out only
        fb.temporal_phase_tm(x, p, 2, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fb.temporal_phase_tm(x.to(torch.bfloat16), p, 3)  # 128 % 3


# Banded path: (C, t_real, eff, N, D, H). The full 512-frame bucket at
# ViT-B widths for both windows, padded chunks (t_real < C), and head dims
# 128 and 32 beside 64.
BAND_SHAPES = [(64, 64, 30, 8, 256, 4), (64, 50, 3, 8, 256, 4),
               (64, 40, 30, 16, 256, 2), (512, 512, 30, 196, 768, 12),
               (512, 500, 3, 196, 768, 12), (512, 300, 30, 16, 384, 12)]


def _qkv(shape, seed, device):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)).to(
        device, torch.bfloat16)


# The tensor-core temporal kernel's edges: chunks that are no multiple of
# its 16-frame steps or 128-frame blocks, windows of 1, 2, 30 and 64
# frames, t_real < eff (every window starts at frame 0), and a head group
# of 3 (H = 6 at hd 64).
BAND_TC_SHAPES = [(C, t_real, eff, 5, 384, 6) for C, t_real, eff in [
    (16, 16, 1), (16, 9, 2), (17, 17, 1), (17, 12, 2), (48, 48, 1),
    (48, 40, 2), (48, 20, 30), (100, 100, 1), (100, 77, 2), (100, 90, 30),
    (100, 50, 64)]]


@pytest.mark.parametrize("C,t_real,eff,N,D,H", BAND_SHAPES + BAND_TC_SHAPES)
def test_banded_temporal_attn_kernel_matches_twin(cuda_device, C, t_real, eff,
                                                  N, D, H):
    qkv = _qkv((C, N, 3 * D), 5, cuda_device)
    before = bb.launches["banded_temporal_attn"]
    got = bb.banded_temporal_attn(qkv, t_real, eff, H)
    again = bb.banded_temporal_attn(qkv, t_real, eff, H)
    torch.cuda.synchronize()
    assert bb.launches["banded_temporal_attn"] == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (C, N, D)
    assert torch.equal(got, again)
    _close(got, bb.banded_temporal_attn_plain(qkv, t_real, eff, H))


def test_banded_temporal_attn_refuses_what_shared_memory_cannot_hold(cuda_device):
    """The wrapper reads the kernel's shared-memory need from the library:
    a 450-frame window at hd 128 needs a 481-row key / value ring (250 KB)."""
    qkv = torch.zeros(500, 2, 3 * 128, dtype=torch.bfloat16, device=cuda_device)
    before = bb.launches["banded_temporal_attn"]
    with pytest.raises(ValueError, match="shared memory"):
        bb.banded_temporal_attn(qkv, 500, 450, 1)
    assert bb.launches["banded_temporal_attn"] == before


# Row 12's tensor-core design at every head dim it takes (16..128), at the
# buckets 64, 256 and 512, t_real below C and eff 1, 2, 3, 30 and 64:
# (C, t_real, eff, N, D, H).
CLS_TC_SHAPES = [(64, 64, 30, 196, 128, 8), (256, 200, 3, 16, 128, 4),
                 (512, 450, 30, 36, 384, 8), (64, 40, 3, 196, 128, 2),
                 (256, 256, 30, 12, 640, 8), (512, 512, 3, 20, 384, 4),
                 (64, 50, 64, 24, 896, 8), (256, 130, 30, 196, 256, 2),
                 (64, 64, 1, 8, 128, 2), (100, 77, 2, 33, 256, 4)]


@pytest.mark.parametrize("C,t_real,eff,N,D,H", BAND_SHAPES + CLS_TC_SHAPES)
def test_cls_band_attn_kernel_matches_twin(cuda_device, C, t_real, eff, N, D,
                                           H):
    qkv = _qkv((C, N, 3 * D), 6, cuda_device)
    qkv_cls = _qkv((C, 3 * D), 7, cuda_device)
    before = bb.launches["cls_band_attn"]
    got = bb.cls_band_attn(qkv_cls, qkv, t_real, eff, H)
    again = bb.cls_band_attn(qkv_cls, qkv, t_real, eff, H)
    torch.cuda.synchronize()
    assert bb.launches["cls_band_attn"] == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (C, D)
    assert torch.equal(got, again)  # split partials are added in a fixed order
    _close(got, bb.cls_band_attn_plain(qkv_cls, qkv, t_real, eff, H))


# Every block shape the kernel takes gives the twin's result, each
# bit-identical over two calls: (strips, warps a strip, splits), through
# the library's test entry (tools/cls_band_bench.run_shaped).
CLS_CONFIGS = [(4, 4, 1), (4, 4, 4), (1, 1, 1), (2, 4, 16), (3, 2, 2), (4, 1, 5),
               (1, 16, 1), (2, 8, 2), (1, 4, 2)]


@pytest.mark.parametrize("config", CLS_CONFIGS)
@pytest.mark.parametrize("C,t_real,eff", [(512, 512, 30), (64, 40, 3)])
def test_cls_band_attn_configs_match_twin(cuda_device, C, t_real, eff, config):
    N, D, H = 196, 768, 12
    qkv = _qkv((C, N, 3 * D), 8, cuda_device)
    qkv_cls = _qkv((C, 3 * D), 9, cuda_device)
    lib = _build.load("banded")
    got = cls_band_bench.run_shaped(lib, qkv_cls, qkv, t_real, eff, H, config)
    again = cls_band_bench.run_shaped(lib, qkv_cls, qkv, t_real, eff, H, config)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, bb.cls_band_attn_plain(qkv_cls, qkv, t_real, eff, H))


def test_cls_band_attn_refuses_bad_configs(cuda_device):
    """More warps than the block may have (16 at hd 64, 8 at hd 128), no
    strip or split, or more shared memory than a block may opt into: the
    library's test entry refuses."""
    lib = _build.load("banded")
    qkv = torch.zeros(64, 196, 3 * 768, dtype=torch.bfloat16, device=cuda_device)
    qkv_cls = torch.zeros(64, 3 * 768, dtype=torch.bfloat16, device=cuda_device)
    for cfg in [(4, 5, 1), (0, 4, 1), (4, 4, 0), (2, 16, 1), (2, 1 << 30, 1)]:
        with pytest.raises(RuntimeError, match="launch failed"):
            cls_band_bench.run_shaped(lib, qkv_cls, qkv, 64, 30, 12, cfg)
    qkv2 = torch.zeros(64, 196, 3 * 256, dtype=torch.bfloat16, device=cuda_device)
    for cfg in [(3, 4, 1), (1, 9, 1)]:  # hd 128: 8 warps at most
        with pytest.raises(RuntimeError, match="launch failed"):
            cls_band_bench.run_shaped(lib, qkv2[:, 0].contiguous(), qkv2, 64, 30, 2, cfg)
    qkv3 = torch.zeros(64, 214, 3 * 256, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):  # 214 patches: one strip only
        cls_band_bench.run_shaped(lib, qkv3[:, 0].contiguous(), qkv3, 64, 30, 2, (2, 4, 1))


def test_cls_band_shared_memory_mirror_is_the_librarys(cuda_device):
    """banded_block.cls_band_smem's mirror, by which the CPU twin refuses,
    equals the library's dvst_cls_band_smem; the library's block shape is
    ceil((eff - 1) / 8) strips of four warps, fewer where the warp cap (16
    at hd <= 64, else 8) or the shared memory forbids (banded_block.cu's
    cls_config)."""
    lib = _build.load("banded")
    for N in (8, 16, 36, 196, 256, 400):
        for hd in (16, 32, 48, 64, 80, 96, 112, 128):
            assert bb.cls_band_smem(N, hd) == bb.cls_band_smem(N, hd, lib), (N, hd)
            if bb.cls_band_smem(N, hd) > fb.SMEM_LIMIT:
                continue
            for eff in (1, 3, 17, 30):
                qs = min(max(-(-(eff - 1) // 8), 1), bb.CLS_STRIPS)
                while qs > 1 and (qs * bb.CLS_KEY_RUNS > (16 if hd <= 64 else 8) or
                                  bb._cls_smem(N, hd, qs, bb.CLS_KEY_RUNS) > fb.SMEM_LIMIT):
                    qs -= 1
                got = cls_band_bench.library_shape(lib, 512, N, hd * 8, 8, eff)
                assert got[:2] == (qs, bb.CLS_KEY_RUNS), (N, hd, eff, got)
                assert 1 <= got[2] <= 16
                ws = lib.dvst_cls_band_attn_ws(512, N, hd * 8, 8, eff)
                assert ws == (got[2] * 512 * hd * 8 * 4 if got[2] > 1 else 0)


@pytest.mark.parametrize("C,N,D,H", [(64, 16, 256, 4), (50, 196, 256, 2),
                                     (512, 196, 768, 12)])
def test_spatial_phase_pf_kernel_matches_twin(cuda_device, C, N, D, H):
    p = _block(D, H, 0, cuda_device)["spatial"]
    x = _qkv((C, N, D), 8, cuda_device)
    cls = _qkv((C, D), 9, cuda_device)
    before = bb.launches["spatial_phase_pf"]
    got = bb.spatial_phase_pf(x, cls, p, H)
    torch.cuda.synchronize()
    assert bb.launches["spatial_phase_pf"] == before + 1
    want = bb.spatial_phase_pf_plain(x, cls, p, H)
    _close(got[0], want[0], x)
    _close(got[1], want[1])
    _close(got[2], want[2])


# Row 3: a ragged small M, the banded 512-frame bucket, the train step's
# global (16 clips x 8 frames x 196) and local (64 x 8 x 36) crops, and the
# rand-fr step's 4-frame globals and 2- and 16-frame locals.
@pytest.mark.parametrize("M,D,H", [(200, 256, 4), (512 * 196, 768, 12),
                                   (16 * 8 * 196, 768, 12), (64 * 8 * 36, 768, 12),
                                   (8 * 4 * 196, 768, 12), (16 * 2 * 36, 768, 12),
                                   (16 * 16 * 36, 768, 12)])
def test_mlp_phase_kernel_matches_twin(cuda_device, M, D, H):
    p = _block(D, H, 0, cuda_device)["spatial"]
    x = _qkv((M, D), 10, cuda_device)
    before = fb.launches["mlp_phase"]
    got = fb.mlp_phase(x, p)
    torch.cuda.synchronize()
    assert fb.launches["mlp_phase"] == before + 1
    _close(got, fb.mlp_phase_plain(x, p), x)
    _close(fb.mlp_phase(x, p, residual=False),
           fb.mlp_phase_plain(x, p, residual=False))


@pytest.mark.parametrize("t_real,eff", [(64, 30), (50, 3)])
def test_banded_forward_kernels_match_twins(cuda_device, t_real, eff):
    """A whole bf16 banded pass on the kernels against the same pass with
    the twins (CPU), at depth 2."""
    cfg = tsf.TimeSformerConfig(img_size=64, patch_size=16, embed_dim=256,
                                depth=2, num_heads=4, num_frames=8,
                                num_classes=0, use_kernels=True)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, 11), cfg)
    fr = torch.from_numpy(np.random.RandomState(12).randn(64, 64, 64, 3))
    gpu = tsf.build_timesformer(cfg, sd, device=cuda_device, dtype=torch.bfloat16)
    cpu = tsf.build_timesformer(cfg, sd, device="cpu", dtype=torch.bfloat16)
    before = dict(bb.launches)
    with torch.inference_mode():
        got = banded.banded_cls_features(gpu, fr.to(cuda_device), t_real, eff)
        want = banded.banded_cls_features(cpu, fr, t_real, eff)
    # the bf16 tiers, each once per block (the f32 tier of row 11 not at all)
    assert all(bb.launches[k] == before[k] + 2
               for k in ("banded_temporal_attn", "spatial_phase_pf", "cls_band_attn"))
    assert bb.launches["spatial_phase_pf_f32"] == before["spatial_phase_pf_f32"]
    _close(got.cpu()[:t_real], want[:t_real])


# The per-phase training tier (forwards and backwards): the two crop
# geometries of the train step at ViT-B widths (global N=196, local N=36,
# T=8, at a small batch), small shapes, and a ragged row count for the MLP.
TRAIN_SHAPES = [(2, 4, 6, 128, 2), (2, 8, 196, 768, 12), (4, 8, 36, 768, 12),
                (1, 3, 16, 256, 4),
                # the train step's global and local crops whole; rows 4 and
                # 7's tiles at N = 4 (12 sequences: one ragged group of the
                # 14 the temporal tiles take at T = 8) and N = 1
                (16, 8, 196, 768, 12), (64, 8, 36, 768, 12), (3, 8, 4, 256, 4),
                (5, 8, 1, 128, 2),
                # the rand-fr step's groups (DATA.RAND_FR, batch 8): the 4-frame
                # globals, and the 2-, 4- and 16-frame locals (T = 16 takes the
                # strided backward's whole-sequence strips)
                (8, 4, 196, 768, 12), (16, 2, 36, 768, 12), (16, 4, 36, 768, 12),
                (16, 16, 36, 768, 12)]


def _grads_close(got: dict, want: dict):
    for k in want:
        gap = twin_check.twin_gap(got[k], want[k])
        assert not twin_check.twin_failures(gap), (k, gap)


@pytest.mark.parametrize("B,T,N,D,H", TRAIN_SHAPES)
def test_temporal_phase_tm_bf16_kernel_matches_twin(cuda_device, B, T, N, D, H):
    p = _block(D, H, 0, cuda_device)["temporal"]
    x = _qkv((B, T, N, D), 20, cuda_device)
    before = fb.launches["temporal_phase_tm_bf16"]
    got = fb.temporal_phase_tm(x, p, H, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fb.launches["temporal_phase_tm_bf16"] == before + 1
    assert got.dtype == torch.bfloat16
    # bf16(x + bf16(branch)), as row 6: the branch through the f32-out tier
    # of the same launches, the bf16 output at two ulps of the twin's
    _close(fb.temporal_phase_tm(x, p, H), fb.temporal_phase_tm_plain(x, p, H), x)
    ulps = twin_check.rounding_ulps(
        got, fb.temporal_phase_tm_plain(x, p, H, torch.bfloat16), x)
    assert ulps <= twin_check.ROUNDING_ULPS, ulps


@pytest.mark.parametrize("B,T,N,D,H", TRAIN_SHAPES)
def test_spatial_phase_kernel_matches_twin(cuda_device, B, T, N, D, H):
    p = _block(D, H, 0, cuda_device)["spatial"]
    x = _qkv((B, T, N, D), 21, cuda_device)
    cls = _qkv((B, 1, D), 22, cuda_device)
    before = fb.launches["spatial_phase"]
    grid, rows = fb.spatial_phase(x, cls, p, H)
    torch.cuda.synchronize()
    assert fb.launches["spatial_phase"] == before + 1
    want_grid, want_rows = fb.spatial_phase_plain(x, cls, p, H)
    # the grid is bf16(x + bf16(branch)), as rows 6 and 1b: the branch
    # through the f32-out tier of the same launches, the bf16 grid at two
    # ulps of the twin's
    grid32, rows32 = fb.spatial_phase(x, cls, p, H, out_dtype=torch.float32)
    assert grid32.dtype == torch.float32 and torch.equal(rows32, rows)
    _close(grid32, fb.spatial_phase_plain(x, cls, p, H, torch.float32)[0], x)
    ulps = twin_check.rounding_ulps(grid, want_grid, x)
    assert ulps <= twin_check.ROUNDING_ULPS, ulps
    _close(rows, want_rows)


@pytest.mark.parametrize("B,T,N,D,H", TRAIN_SHAPES)
def test_temporal_phase_tm_bwd_kernel_matches_twin(cuda_device, B, T, N, D, H):
    p = _block(D, H, 0, cuda_device)["temporal"]
    x = _qkv((B, T, N, D), 23, cuda_device)
    dout = _qkv((B, T, N, D), 24, cuda_device)
    before = fb.launches["temporal_phase_tm_bwd"]
    dx, g = fb.temporal_phase_tm_bwd(x, dout, p, H)
    dx2, g2 = fb.temporal_phase_tm_bwd(x, dout, p, H)
    torch.cuda.synchronize()
    assert fb.launches["temporal_phase_tm_bwd"] == before + 2
    assert torch.equal(dx, dx2) and all(torch.equal(g[k], g2[k]) for k in g)
    want_dx, want_g = fb.temporal_phase_tm_bwd_plain(x, dout, p, H)
    _close(dx, want_dx, dout)
    _grads_close(g, want_g)


@pytest.mark.parametrize("B,T,N,D,H", TRAIN_SHAPES)
def test_spatial_phase_bwd_kernel_matches_twin(cuda_device, B, T, N, D, H):
    p = _block(D, H, 0, cuda_device)["spatial"]
    x = _qkv((B, T, N, D), 25, cuda_device)
    cls = _qkv((B, 1, D), 26, cuda_device)
    dgo = _qkv((B, T, N, D), 27, cuda_device)
    dco = _qkv((B, T, D), 28, cuda_device)
    before = fb.launches["spatial_phase_bwd"]
    dx, dcls, g = fb.spatial_phase_bwd(x, cls, dgo, dco, p, H)
    dx2, dcls2, g2 = fb.spatial_phase_bwd(x, cls, dgo, dco, p, H)
    torch.cuda.synchronize()
    assert fb.launches["spatial_phase_bwd"] == before + 2
    assert torch.equal(dx, dx2) and torch.equal(dcls, dcls2)
    assert all(torch.equal(g[k], g2[k]) for k in g)
    want_dx, want_dcls, want_g = fb.spatial_phase_bwd_plain(x, cls, dgo, dco, p, H)
    _close(dx, want_dx, dgo)
    _close(dcls, want_dcls)
    _grads_close(g, want_g)


@pytest.mark.parametrize("M,D,Dh,residual", [(200, 128, 512, True),
                                             (25088, 768, 3072, True),
                                             (16, 768, 3072, True),
                                             (77, 256, 1024, False),
                                             (18432, 768, 3072, True),
                                             (64, 768, 3072, True),
                                             (100, 768, 3072, True),
                                             # the rand-fr step's 4-frame
                                             # globals, 2- and 16-frame locals
                                             (6272, 768, 3072, True),
                                             (1152, 768, 3072, True),
                                             (9216, 768, 3072, True)])
def test_mlp_phase_bwd_kernel_matches_twin(cuda_device, M, D, Dh, residual):
    p = _block(D, D // 64, 0, cuda_device)["spatial"]
    assert p["fc1_w"].shape == (Dh, D)
    x = _qkv((M, D), 29, cuda_device)
    do = _qkv((M, D), 30, cuda_device)
    before = fb.launches["mlp_phase_bwd"]
    dx, g = fb.mlp_phase_bwd(x, do, p, residual)
    dx2, g2 = fb.mlp_phase_bwd(x, do, p, residual)
    torch.cuda.synchronize()
    assert fb.launches["mlp_phase_bwd"] == before + 2
    assert torch.equal(dx, dx2) and all(torch.equal(g[k], g2[k]) for k in g)
    want_dx, want_g = fb.mlp_phase_bwd_plain(x, do, p, residual)
    _close(dx, want_dx, do if residual else None)
    _grads_close(g, want_g)


def test_train_step_kernel_route_matches_twins(cuda_device):
    """The bf16 kernel-route gradients of a whole train step (depth 2,
    D=128) on the card against the same step on the CPU, where the autograd
    Functions run the plain twins; same numpy-seeded weights and crops.
    Around the kernels the step runs plain bf16 torch (patch embedding,
    head, LayerNorm, casts), which rounds differently on the two devices,
    so the gradients are held to the step-level bound of the CPU test
    against JAX: per parameter max|diff| / max|CPU| < 0.15."""
    from dino_video_summarization_transformer_tpu_torch.train import ssl

    cfg = tsf.TimeSformerConfig(img_size=32, patch_size=16, embed_dim=128,
                                depth=2, num_heads=2, num_frames=4,
                                num_classes=0)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, 5), cfg)
    r = np.random.RandomState(6)
    g = torch.from_numpy(r.randn(4, 3, 4, 32, 32).astype(np.float32))
    l = torch.from_numpy(r.randn(8, 3, 4, 32, 32).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda_device):
        state, core, mask = ssl.init_train_state(cfg, out_dim=64, seed=7,
                                                 pretrained_backbone=sd,
                                                 device=dev)
        step = ssl.make_train_step(cfg, core, mask, n_local_crops=4,
                                   compute_dtype=torch.bfloat16)
        assert step.route == "kernels"
        before = dict(fb.launches)
        _, _, grads[str(dev)] = step.loss_and_grads(state, g.to(dev), l.to(dev), 0.04)
        ran = fb.launches["spatial_phase_bwd"] - before["spatial_phase_bwd"]
        assert ran == (0 if dev == "cpu" else 2 * cfg.depth)
    for n, want in grads["cpu"].items():
        got = grads["cuda"][n].cpu()
        rel = float((got - want).abs().max() / (want.abs().max() + 1e-12))
        assert torch.isfinite(got).all() and rel < 0.15, (n, rel)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_remat_kernel_route_equals_non_remat(cuda_device, dtype):
    """Rematerialized students (``make_train_step(remat=True)``) on the
    kernel route, bf16 and the mixed tier (f32): the loss and every
    gradient equal the non-remat route's bit for bit (the same kernels on
    the same inputs, deterministic); the recompute launches each student
    per-phase forward a second time per block."""
    from dino_video_summarization_transformer_tpu_torch.train import ssl

    cfg = tsf.TimeSformerConfig(img_size=32, patch_size=16, embed_dim=128,
                                depth=2, num_heads=2, num_frames=4,
                                num_classes=0)
    r = np.random.RandomState(8)
    g = torch.from_numpy(r.randn(4, 3, 4, 32, 32).astype(np.float32)).to(cuda_device)
    l = torch.from_numpy(r.randn(8, 3, 4, 32, 32).astype(np.float32)).to(cuda_device)
    state, core, mask = ssl.init_train_state(cfg, out_dim=64, seed=9, device=cuda_device)
    out = {}
    for remat in (False, True):
        step = ssl.make_train_step(cfg, core, mask, n_local_crops=4, compute_dtype=dtype,
                                   route="kernels", remat=remat)
        before = dict(fb.launches)
        out[remat] = step.loss_and_grads(state, g, l, 0.04)
        torch.cuda.synchronize()
        out[remat] += ({k: fb.launches[k] - before[k] for k in fb.launches},)
    (l0, c0, g0, n0), (l1, c1, g1, n1) = out[False], out[True]
    assert torch.equal(l0, l1) and torch.equal(c0, c1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    tier = "_f32" if dtype == torch.float32 else ""
    fwd = "temporal_phase_tm_f32" if tier else "temporal_phase_tm_bf16"
    assert (n0[fwd], n1[fwd]) == (3 * cfg.depth, 5 * cfg.depth)
    assert (n0["mlp_phase" + tier], n1["mlp_phase" + tier]) == (6 * cfg.depth, 10 * cfg.depth)
    assert n0["spatial_phase_bwd" + tier] == n1["spatial_phase_bwd" + tier] == 2 * cfg.depth


# The XLA-layout block's two attention phases (rows 5, 6): the spatial
# [CLS, grid] sequences and the temporal sequences of the chunk-8 scorer's
# teacher (B=8, T=30) and student (T=3) windows at ViT-B widths, and small
# shapes.
# S = 37 at L = 3 and S = 1568 leave the tile's last group of 35
# sequences ragged; S = 5 at L = 197 is one sequence a block.
PHASE_SHAPES = [(240, 197, 768, 12), (24, 197, 768, 12), (1568, 30, 768, 12),
                (1568, 3, 768, 12), (6, 5, 128, 2), (3, 17, 256, 4),
                (37, 3, 768, 12), (5, 197, 768, 12), (9, 197, 1024, 8)]


@pytest.mark.parametrize("S,L,D,H", PHASE_SHAPES)
def test_attn_phase_kernel_matches_twin(cuda_device, S, L, D, H):
    p = _block(D, H, 0, cuda_device)["spatial"]
    x = _qkv((S, L, D), 40, cuda_device)
    before = fb.launches["attn_phase"]
    got = fb.attn_phase(x, p, H)
    again = fb.attn_phase(x, p, H)
    torch.cuda.synchronize()
    assert fb.launches["attn_phase"] == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got, again)
    _close(got, fb.attn_phase_plain(x, p, H))


def test_attn_phase_refuses_unaligned_weights(cuda_device):
    """Row 5's GEMMs read qkv_w and proj_w through TMA, which needs a
    16-byte aligned start: a weight view one element in raises a
    ValueError before any launch, not a CUDA error."""
    D, H = 256, 4
    p = _block(D, H, 0, cuda_device)["spatial"]
    x = _qkv((8, 197, D), 42, cuda_device)
    before = fb.launches["attn_phase"]
    for k in ("qkv_w", "proj_w"):
        w = p[k]
        flat = torch.empty(w.numel() + 1, dtype=w.dtype, device=cuda_device)
        flat[1:] = w.reshape(-1)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fb.attn_phase(x, {**p, k: flat[1:].view(w.shape)}, H)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)
        fb.attn_phase(flat[1:].view(x.shape), p, H)
    assert fb.launches["attn_phase"] == before


# Row 6's output is bf16(x + bf16(branch)): where the branch is small
# beside the output's ulp (L = 197: branch rms 0.018 beside x of rms 1),
# the last rounding's flips alone read ~1e-2 of the branch's rms. So the
# branch is held through the f32-out tier of the same launches
# (temporal_phase_tm with N = 1), and the bf16 output at two ulps of the
# twin's, the two last roundings' flips (ops/twin_check.py).
@pytest.mark.parametrize("S,L,D,H", PHASE_SHAPES)
def test_temporal_phase_kernel_matches_twin(cuda_device, S, L, D, H):
    p = _block(D, H, 0, cuda_device)["temporal"]
    x = _qkv((S, L, D), 41, cuda_device)
    before = fb.launches["temporal_phase"]
    got = fb.temporal_phase(x, p, H)
    again = fb.temporal_phase(x, p, H)
    torch.cuda.synchronize()
    assert fb.launches["temporal_phase"] == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got, again)
    ulps = twin_check.rounding_ulps(got, fb.temporal_phase_plain(x, p, H), x)
    assert ulps <= twin_check.ROUNDING_ULPS, ulps
    x4 = x.view(S, L, 1, D)
    _close(fb.temporal_phase_tm(x4, p, H), fb.temporal_phase_tm_plain(x4, p, H), x4)


# The standalone attention (row 13): the attention swap's head sequences at
# ViT-B (hd 64) for the teacher and student windows, every head dim the
# kernel takes, and f32 beside bf16.
ATTN_SHAPES = [(2880, 197, 64, "bf16"), (18816, 30, 64, "bf16"),
               (288, 197, 64, "bf16"), (18816, 3, 64, "bf16"),
               (96, 197, 64, "f32"), (300, 30, 64, "f32"), (7, 5, 16, "bf16"),
               (5, 33, 128, "bf16"), (9, 65, 32, "f32"), (11, 64, 48, "bf16"),
               (4, 100, 80, "bf16"), (6, 20, 96, "f32"), (3, 50, 112, "bf16")]


@pytest.mark.parametrize("BH,L,hd,dtype", ATTN_SHAPES)
def test_fused_attention_kernel_matches_twin(cuda_device, BH, L, hd, dtype):
    from dino_video_summarization_transformer_tpu_torch.ops import attention as at

    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    r = np.random.RandomState(BH + L)
    q, k, v = (torch.from_numpy(r.randn(BH, L, hd)).to(cuda_device, td)
               for _ in range(3))
    before = at.launches["fused_attention"]
    got = at.fused_attention(q, k, v, hd ** -0.5)
    again = at.fused_attention(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    assert at.launches["fused_attention"] == before + 2
    assert got.dtype == td and got.shape == q.shape
    assert torch.equal(got, again)
    _close(got, at.fused_attention_plain(q, k, v, hd ** -0.5))


# The bf16 instance's strips at their edges: sequences of 1 to 15 rows
# packed 16 // L to a strip, 16-row strips around 16, 32, 64 and 256, the
# teacher's 197, at every head dim; BH = 131, a prime, is no multiple of
# the sequences a block holds (1 to 128).
TC_LENGTHS = [1, 2, 3, 5, 15, 16, 17, 30, 31, 33, 63, 64, 65, 197, 256, 257]


@pytest.mark.parametrize("hd", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("L", TC_LENGTHS)
def test_fused_attention_tensor_core_instance_matches_twin(cuda_device, L, hd):
    from dino_video_summarization_transformer_tpu_torch.ops import attention as at

    assert at.kernel_instance(torch.bfloat16, hd) == "tensor_core"
    r = np.random.RandomState(1000 * L + hd)
    q, k, v = (torch.from_numpy(r.randn(131, L, hd)).to(cuda_device, torch.bfloat16)
               for _ in range(3))
    before = at.launches["fused_attention"]
    got = at.fused_attention(q, k, v, hd ** -0.5)
    again = at.fused_attention(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    assert at.launches["fused_attention"] == before + 2
    assert torch.equal(got, again)
    _close(got, at.fused_attention_plain(q, k, v, hd ** -0.5))


def test_fused_attention_f32_takes_the_cuda_core_instance(cuda_device):
    from dino_video_summarization_transformer_tpu_torch.ops import attention as at

    assert at.kernel_instance(torch.float32, 64) == "cuda_core"
    with pytest.raises(ValueError):
        at.kernel_instance(torch.float16, 64)


def test_fused_attention_pack_equals_unpacked(cuda_device):
    from dino_video_summarization_transformer_tpu_torch.ops import attention as at

    r = np.random.RandomState(42)
    q, k, v = (torch.from_numpy(r.randn(18816, 30, 64)).to(cuda_device, torch.bfloat16)
               for _ in range(3))
    packed = at.fused_attention(*(t.view(4704, 120, 64) for t in (q, k, v)),
                                0.125, pack=4)
    assert torch.equal(packed.view(18816, 30, 64),
                       at.fused_attention(q, k, v, 0.125))


def test_fused_attention_refuses_what_shared_memory_cannot_hold(cuda_device):
    from dino_video_summarization_transformer_tpu_torch.ops import attention as at

    big = torch.zeros(1, 197, 128, device=cuda_device)  # f32 at hd 128: 306 KB
    before = at.launches["fused_attention"]
    with pytest.raises(ValueError, match="shared memory"):
        at.fused_attention(big, big, big, 1.0)
    assert at.launches["fused_attention"] == before


def test_fused_attention_bf16_refuses_what_shared_memory_cannot_hold(cuda_device):
    from dino_video_summarization_transformer_tpu_torch.ops import attention as at

    big = torch.zeros(1, 400, 128, dtype=torch.bfloat16, device=cuda_device)  # 307 KB
    before = at.launches["fused_attention"]
    with pytest.raises(ValueError, match="shared memory"):
        at.fused_attention(big, big, big, 1.0)
    assert at.launches["fused_attention"] == before


def test_smem_probe_budget(cuda_device):
    from dino_video_summarization_transformer_tpu_torch.tools import smem_probe

    before = smem_probe.launches["smem_probe"]
    r = smem_probe.probe(cuda_device)
    assert r["budget"] >= fb.SMEM_LIMIT, r
    assert r["budget"] <= r["optin"], r
    assert smem_probe.launches["smem_probe"] > before


def _small_model(cuda_device, **kw):
    cfg = tsf.TimeSformerConfig(img_size=64, patch_size=16, embed_dim=128,
                                depth=2, num_heads=2, num_frames=4,
                                num_classes=0, **kw)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, 13), cfg)
    return (tsf.build_timesformer(cfg, sd, device=cuda_device, dtype=torch.bfloat16),
            tsf.build_timesformer(cfg, sd, device="cpu", dtype=torch.bfloat16))


def _per_phase_forward(model, x):
    """CLS features with every block through Block.forward(use_fused=True)."""
    cls, grid = model.tokens(x)
    B, T, N, D = grid.shape
    spat = grid.transpose(1, 2).reshape(B, N * T, D)
    for blk, kp in zip(model.blocks, model.kernel_params()):
        cls, spat = blk(cls, spat, B, T, N, use_fused=True, kp=kp)
    return tsf.layer_norm(cls, model.norm.weight, model.norm.bias,
                          model.cfg.norm_eps)[:, 0]


def test_use_fused_forward_kernels_match_twins(cuda_device):
    """A whole bf16 forward with every block on the per-phase ops, on the
    kernels against the CPU twins: each phase kernel once per block, the
    MLP one twice (CLS and grid rows)."""
    gpu, cpu = _small_model(cuda_device)
    x = torch.from_numpy(np.random.RandomState(14).randn(2, 3, 6, 64, 64))
    before = dict(fb.launches)
    with torch.inference_mode():
        got = _per_phase_forward(gpu, x.to(cuda_device)).cpu()
        want = _per_phase_forward(cpu, x)
    ran = {k: fb.launches[k] - before[k] for k in before}
    assert ran == {**{k: 0 for k in ran}, "temporal_phase": 2,
                   "attn_phase": 2, "mlp_phase": 4}, ran
    _close(got.float(), want.float())


def test_attention_swap_forward_kernels_match_twins(cuda_device):
    from dino_video_summarization_transformer_tpu_torch.ops import attention as at

    gpu, cpu = _small_model(cuda_device, attention_kernel=True)
    x = torch.from_numpy(np.random.RandomState(15).randn(2, 3, 6, 64, 64))
    before = at.launches["fused_attention"]
    with torch.inference_mode():
        got = gpu.forward_features(x.to(cuda_device)).cpu()
        want = cpu.forward_features(x)
    assert at.launches["fused_attention"] == before + 4
    _close(got.float(), want.float())


# The wgmma + TMA GEMM of rows 1-3, 6 and 11 (csrc/wgmma_gemm.cuh), through
# its own wrapper: every epilogue the ops use, at every N = 3D of SHAPES
# (K = D; 384, 1152, 1920 and 2688 take the 128-wide tiles, the rest the
# 256-wide ones), at row 2's teacher shapes (M = 8 * 30 * 196 grid rows)
# and its CLS rows (M = 8), and at ragged M: 1 and 8 (less than one
# 128-row tile), 65, 77, 127 and 129 (no multiple of 64 or 128), with K of
# one to twelve 64-deep stages and 48 (fc2's K = 3072).
GEMM_SHAPES = [(300, 384, 128), (77, 768, 256), (47040, 2304, 768),
               (129, 1152, 384), (65, 1920, 640), (1, 2688, 896),
               (8, 2304, 768), (47040, 768, 768), (47040, 3072, 768),
               (47040, 768, 3072), (127, 256, 64), (129, 128, 192),
               # the 64-wide tile (N % 128 == 64): tensor parallelism's
               # head-sharded qkv at ViT-B over four shards (3 x 192), its
               # proj's 192-deep reduction, one 64-column tile
               (3136, 576, 768), (3136, 768, 192), (77, 64, 128)]


@pytest.mark.parametrize("epi", sorted(fb.GEMM_EPILOGUES))
@pytest.mark.parametrize("M,N,K", GEMM_SHAPES)
def test_gemm_kernel_matches_twin(cuda_device, epi, M, N, K):
    r = np.random.RandomState(M + N + K)
    a = torch.from_numpy(r.randn(M, K)).to(cuda_device, torch.bfloat16)
    w = torch.from_numpy(r.randn(N, K) * K ** -0.5).to(cuda_device, torch.bfloat16)
    bias = torch.from_numpy(r.randn(N)).to(cuda_device, torch.float32)
    res_dtype = fb.GEMM_EPILOGUES[epi][1]
    res = (None if res_dtype is None else
           torch.from_numpy(r.randn(M, N) * 4).to(cuda_device, res_dtype))
    before = fb.launches["gemm"]
    got = fb.gemm(a, w, bias, epi, res)
    again = fb.gemm(a, w, bias, epi, res)
    torch.cuda.synchronize()
    assert fb.launches["gemm"] == before + 2
    assert got.dtype == fb.GEMM_EPILOGUES[epi][2] and got.shape == (M, N)
    assert torch.equal(got, again)
    _close(got, fb.gemm_plain(a, w, bias, epi, res), res)


# The tensor-core spatial attention of rows 2 and 11
# (tc_attention.cuh's tc_prefix_attn), through its own wrapper: (S, P, N,
# D, H, prefix_out), sequence s = [prefix row s // (S / P), grid rows of
# s]. Row 2's teacher and student windows (S = B*T sequences, the B
# samples' CLS rows as prefixes, their outputs kept) and row 11's
# 512-frame bucket (each frame its own CLS row, its output dropped) at
# ViT-B widths; every head dim at N = 196; sequences of one strip (L = 5,
# 16) and one row past a strip (L = 17, 33).
SPATIAL_ATTN_SHAPES = [(240, 8, 196, 768, 12, True), (24, 8, 196, 768, 12, True),
                       (512, 512, 196, 768, 12, False), (6, 2, 16, 128, 2, True),
                       (5, 5, 4, 256, 4, False), (4, 1, 15, 256, 4, True),
                       (4, 2, 32, 256, 4, True)] + [
    (3, 1, 196, D, H, True) for D, H in [(128, 8), (128, 4), (384, 8), (640, 8),
                                         (384, 4), (896, 8), (256, 2)]]


def _spatial_qkv(S, P, N, D, seed, device, q_scale=1.0):
    r = np.random.RandomState(seed)
    qkv = r.randn(S, N, 3 * D)
    pre = r.randn(P, 3 * D)
    qkv[..., :D] *= q_scale
    pre[:, :D] *= q_scale
    return (torch.from_numpy(qkv).to(device, torch.bfloat16),
            torch.from_numpy(pre).to(device, torch.bfloat16))


@pytest.mark.parametrize("S,P,N,D,H,prefix_out", SPATIAL_ATTN_SHAPES)
def test_spatial_attention_kernel_matches_twin(cuda_device, S, P, N, D, H,
                                               prefix_out):
    qkv, pre = _spatial_qkv(S, P, N, D, S + N, cuda_device)
    before = fb.launches["spatial_attention"]
    got, got_pre = fb.spatial_attention(qkv, pre, H, prefix_out=prefix_out)
    again, again_pre = fb.spatial_attention(qkv, pre, H, prefix_out=prefix_out)
    torch.cuda.synchronize()
    assert fb.launches["spatial_attention"] == before + 2
    assert got.shape == (S, N, D) and torch.equal(got, again)
    want, want_pre = fb.spatial_attention_plain(qkv, pre, H)
    _close(got, want)
    if prefix_out:
        assert torch.equal(got_pre, again_pre)
        _close(got_pre, want_pre)
    else:
        assert got_pre is None


def test_spatial_attention_refuses_what_shared_memory_cannot_hold(cuda_device):
    """The wrapper reads the tile's shared-memory need from the library: 401
    rows at hd 128 need 308 KB."""
    qkv = torch.zeros(2, 400, 3 * 128, dtype=torch.bfloat16, device=cuda_device)
    pre = torch.zeros(2, 3 * 128, dtype=torch.bfloat16, device=cuda_device)
    before = fb.launches["spatial_attention"]
    with pytest.raises(ValueError, match="shared memory"):
        fb.spatial_attention(qkv, pre, 1)
    assert fb.launches["spatial_attention"] == before


# Logits past exp's range. The tensor-core tile takes each row's max over
# its whole key set before any exponential; a max from the first key block
# alone would overflow exp here (scores 64x the unit-variance inputs' at
# hd 64: the CPU tests in tests/test_torch_attention.py and
# tests/test_torch_banded_ops.py show that fault non-finite at this scale
# and invisible at scale hd^-0.5). Rows 13, 10 and the spatial attention
# of rows 2 and 11 at their main-path shapes, held to the same bounds.
@pytest.mark.parametrize("BH,L", [(2880, 197), (288, 197), (18816, 30), (18816, 3)])
def test_fused_attention_at_overflowing_logits(cuda_device, BH, L):
    from dino_video_summarization_transformer_tpu_torch.ops import attention as at

    r = np.random.RandomState(BH + L)
    q, k, v = (torch.from_numpy(r.randn(BH, L, 64)).to(cuda_device, torch.bfloat16)
               for _ in range(3))
    got = at.fused_attention(q, k, v, 8.0)
    want = at.fused_attention_plain(q, k, v, 8.0)
    assert bool(want.isfinite().all())
    _close(got, want)


@pytest.mark.parametrize("t_real,eff", [(512, 30), (500, 3)])
def test_banded_temporal_attn_at_overflowing_logits(cuda_device, t_real, eff):
    r = np.random.RandomState(eff)
    qkv = r.randn(512, 196, 3 * 768)
    qkv[..., :768] *= 64  # scores 64x: an exact power of two in bf16
    qkv = torch.from_numpy(qkv).to(cuda_device, torch.bfloat16)
    got = bb.banded_temporal_attn(qkv, t_real, eff, 12)
    want = bb.banded_temporal_attn_plain(qkv, t_real, eff, 12)
    assert bool(want.isfinite().all())
    _close(got, want)


@pytest.mark.parametrize("S,P,prefix_out", [(240, 8, True), (512, 512, False)])
def test_spatial_attention_at_overflowing_logits(cuda_device, S, P, prefix_out):
    qkv, pre = _spatial_qkv(S, P, 196, 768, S, cuda_device)
    got, got_pre = fb.spatial_attention(qkv, pre, 12, scale=8.0,
                                        prefix_out=prefix_out)
    want, want_pre = fb.spatial_attention_plain(qkv, pre, 12, scale=8.0)
    assert bool(want.isfinite().all()) and bool(want_pre.isfinite().all())
    _close(got, want)
    if prefix_out:
        _close(got_pre, want_pre)


# The tensor-core temporal attention of rows 1 and 6 (tc_attention.cuh's
# tc_strided_attn), through its own wrapper: qkv (B, T, N, 3D), sequence
# (b, n) the T rows at stride N. Every SHAPES window (the main path's
# teacher and student at ViT-B, every head dim) and every PHASE_SHAPES
# sequence set at N = 1 (row 6: S contiguous sequences of up to 197 rows).
TEMPORAL_ATTN_SHAPES = ([(B, T, N, D, H) for B, T, N, D, H in SHAPES]
                        + [(S, L, 1, D, H) for S, L, D, H in PHASE_SHAPES])


@pytest.mark.parametrize("B,T,N,D,H", TEMPORAL_ATTN_SHAPES)
def test_temporal_attention_kernel_matches_twin(cuda_device, B, T, N, D, H):
    qkv = _qkv((B, T, N, 3 * D), B + T + N, cuda_device)
    before = fb.launches["temporal_attention"]
    got = fb.temporal_attention(qkv, H)
    again = fb.temporal_attention(qkv, H)
    torch.cuda.synchronize()
    assert fb.launches["temporal_attention"] == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, N, D)
    assert torch.equal(got, again)
    _close(got, fb.temporal_attention_plain(qkv, H))


@pytest.mark.parametrize("B,T,N", [(8, 30, 196), (8, 3, 196), (1568, 30, 1)])
def test_temporal_attention_at_overflowing_logits(cuda_device, B, T, N):
    qkv = _qkv((B, T, N, 3 * 768), T + N, cuda_device)
    got = fb.temporal_attention(qkv, 12, scale=8.0)
    want = fb.temporal_attention_plain(qkv, 12, scale=8.0)
    assert bool(want.isfinite().all())
    _close(got, want)


def test_temporal_attention_refuses_what_shared_memory_cannot_hold(cuda_device):
    """The wrappers read the tile's shared-memory need from the library: one
    700-row sequence at hd 64 needs 263 KB."""
    qkv = torch.zeros(1, 700, 1, 3 * 128, dtype=torch.bfloat16, device=cuda_device)
    p = _block(128, 2, 0, cuda_device)["temporal"]
    before = dict(fb.launches)
    for call in (lambda: fb.temporal_attention(qkv, 2),
                 lambda: fb.temporal_phase_tm(qkv[..., :128].contiguous(), p, 2),
                 lambda: fb.temporal_phase(qkv[:, :, 0, :128].contiguous(), p, 2)):
        with pytest.raises(ValueError, match="shared memory"):
            call()
    assert fb.launches == before


def test_temporal_attention_shared_memory_mirror_is_the_librarys(cuda_device):
    """fused_block.temporal_attn_smem's mirror, by which the CPU twins
    refuse, equals the library's dvst_temporal_attn_smem."""
    from dino_video_summarization_transformer_tpu_torch.ops import _build

    lib = _build.load()
    for S in (1, 2, 5, 34, 35, 36, 1568, 100352):
        for L in (1, 2, 3, 5, 8, 15, 16, 17, 30, 31, 33, 48, 64, 96, 97, 112, 113, 197,
                  400, 700):
            for hd in (16, 64, 128):
                assert fb.temporal_attn_smem(S, L, hd) == fb.temporal_attn_smem(
                    S, L, hd, lib), (S, L, hd)


# Rows 8 and 9's blocks alone (csrc/fused_block_bwd.cu's exports): the
# tensor-core attention backward over [CLS, grid] sequences
# (tc_attention.cuh's tc_prefix_attn_bwd) at the train step's global (S =
# 16 x 8 frames, N = 196) and local (S = 64 x 8, N = 36) crops, with one
# prefix per sample (P = S / 8) as the wrapper takes it and one per
# sequence (P = S) as row 8 runs it; sequences of one strip or less (L =
# 5, 16), one row past a strip (L = 17, 33) and every head dim at N = 196.
SPATIAL_BWD_SHAPES = [(128, 16, 196, 768, 12), (128, 128, 196, 768, 12),
                      (512, 64, 36, 768, 12), (6, 2, 16, 128, 2), (5, 5, 4, 256, 4),
                      (4, 1, 15, 256, 4), (4, 2, 32, 256, 4)] + [
    (3, 1, 196, D, H) for D, H in [(128, 8), (128, 4), (384, 8), (640, 8),
                                   (384, 4), (896, 8), (256, 2)]]


def _close_sums(got, want):
    """The attention backward's dq, dk and dv held by twin_check's f32 rules
    (rms <= 1e-2 x rms, max <= 2e-2 x max), not elementwise in bf16 ulps:
    each element is a sum whose coefficients sum to zero (sum_j ds_ij = 0,
    ds = pn * (dp - rowsum(dp * pn))), so a bf16 flip of one probability
    moves it by a share of dp that no ulp of the element bounds. Read on
    the card: rel_rms ~1e-4 and 5 ulps at the global crops, with the
    forward tile's exponentials or the twin's exact ones alike. Row 8's
    outputs, which sum these over rows, are held elementwise as before."""
    _close(got.float(), want.float())


def _spatial_bwd_inputs(S, P, N, D, seed, device, q_scale=1.0):
    qkv, pre = _spatial_qkv(S, P, N, D, seed, device, q_scale)
    r = np.random.RandomState(seed + 1)
    da = torch.from_numpy(r.randn(S, N, D)).to(device, torch.bfloat16)
    dap = torch.from_numpy(r.randn(S, D)).to(device, torch.bfloat16)
    return qkv, pre, da, dap


@pytest.mark.parametrize("S,P,N,D,H", SPATIAL_BWD_SHAPES)
def test_spatial_attention_bwd_kernel_matches_twin(cuda_device, S, P, N, D, H):
    args = _spatial_bwd_inputs(S, P, N, D, S + N, cuda_device)
    before = fb.launches["spatial_attention_bwd"]
    got, got_pre = fb.spatial_attention_bwd(*args, H)
    again, again_pre = fb.spatial_attention_bwd(*args, H)
    torch.cuda.synchronize()
    assert fb.launches["spatial_attention_bwd"] == before + 2
    assert got.shape == (S, N, 3 * D) and got_pre.shape == (S, 3 * D)
    assert torch.equal(got, again) and torch.equal(got_pre, again_pre)
    want, want_pre = fb.spatial_attention_bwd_plain(*args, H)
    for i in range(3):  # dq, dk, dv: each held against its own size
        _close_sums(got[..., i * D:(i + 1) * D], want[..., i * D:(i + 1) * D])
        _close_sums(got_pre[:, i * D:(i + 1) * D], want_pre[:, i * D:(i + 1) * D])


@pytest.mark.parametrize("S,P,N", [(128, 16, 196), (512, 512, 36)])
def test_spatial_attention_bwd_at_overflowing_logits(cuda_device, S, P, N):
    """Scores 64x the unit-variance inputs' (scale 8 at hd 64): exp
    overflows unless each row's max over its whole key set comes first."""
    args = _spatial_bwd_inputs(S, P, N, 768, S, cuda_device)
    got, got_pre = fb.spatial_attention_bwd(*args, 12, scale=8.0)
    want, want_pre = fb.spatial_attention_bwd_plain(*args, 12, scale=8.0)
    assert bool(want.isfinite().all()) and bool(want_pre.isfinite().all())
    for i in range(3):
        _close_sums(got[..., i * 768:(i + 1) * 768], want[..., i * 768:(i + 1) * 768])
        _close_sums(got_pre[:, i * 768:(i + 1) * 768], want_pre[:, i * 768:(i + 1) * 768])


def test_spatial_attention_bwd_shared_memory_mirror_is_the_librarys(cuda_device):
    from dino_video_summarization_transformer_tpu_torch.ops import _build

    lib = _build.load("bwd")
    for L in (1, 2, 5, 15, 16, 17, 33, 37, 64, 197, 300):
        for hd in (16, 64, 128):
            assert fb.spatial_attn_bwd_smem(L, hd) == fb.spatial_attn_bwd_smem(L, hd, lib)


def test_spatial_attention_bwd_refuses_what_shared_memory_cannot_hold(cuda_device):
    """301 rows at hd 128 need 309 KB: the wrapper and row 8 refuse them."""
    args = [torch.zeros(shape, dtype=torch.bfloat16, device=cuda_device)
            for shape in [(2, 300, 384), (2, 384), (2, 300, 128), (2, 128)]]
    p = _block(128, 1, 0, cuda_device)["spatial"]
    x, cls, dco = (torch.zeros(shape, dtype=torch.bfloat16, device=cuda_device)
                   for shape in [(1, 2, 300, 128), (1, 1, 128), (1, 2, 128)])
    before = dict(fb.launches)
    for call in (lambda: fb.spatial_attention_bwd(*args, 1),
                 lambda: fb.spatial_phase_bwd(x, cls, x, dco, p, 1)):
        with pytest.raises(ValueError, match="shared memory"):
            call()
    assert fb.launches == before


# The dX and dW products of rows 8 and 9 on the wgmma GEMM: (M, N, K) of
# dX = dY (M, K) . W (K, N) at row 8's R = 16*8*196 + 128 rows (da: K = N =
# 768; dy: K = 2304) and row 9's M = 25088 (dh1: N = 3072; dy: K = 3072),
# the CLS-row calls (M = 16, 64) and ragged M (1, 100, 129); dW (n_out,
# k_in) over rows, non-square (dWqkv is 2304 x 768), at both crops' row
# counts and the CLS rows' (16, 64), and at 100 and 1 rows (a ragged last
# K stage: TMA's zero fill).
GEMM_DX_SHAPES = [(25216, 768, 768), (25216, 768, 2304), (25088, 3072, 768),
                  (25088, 768, 3072), (18944, 768, 2304), (16, 3072, 768),
                  (64, 768, 3072), (100, 768, 2304), (1, 128, 128), (129, 384, 128),
                  (300, 256, 192), (3136, 192, 768), (3136, 768, 576), (65, 64, 128)]
GEMM_DW_SHAPES = [(25216, 768, 768), (25216, 2304, 768), (25088, 768, 3072),
                  (25088, 3072, 768), (18944, 2304, 768), (18432, 3072, 768),
                  (16, 768, 3072), (64, 3072, 768), (100, 2304, 768), (1, 128, 128),
                  (300, 384, 128), (4096, 256, 512), (3136, 576, 768), (3136, 768, 192),
                  (100, 192, 64)]


@pytest.mark.parametrize("epi", sorted(fb.GEMM_DX_EPILOGUES))
@pytest.mark.parametrize("M,N,K", GEMM_DX_SHAPES)
def test_gemm_dx_kernel_matches_twin(cuda_device, epi, M, N, K):
    r = np.random.RandomState(M + N + K)
    dy = torch.from_numpy(r.randn(M, K)).to(cuda_device, torch.bfloat16)
    w = torch.from_numpy(r.randn(K, N) * K ** -0.5).to(cuda_device, torch.bfloat16)
    aux = (torch.from_numpy(r.rand(M, N) * 1.2 - 0.1).to(cuda_device, torch.float32)
           if fb.GEMM_DX_EPILOGUES[epi][1] is not None else None)
    before = fb.launches["gemm_dx"]
    got = fb.gemm_dx(dy, w, epi, aux)
    again = fb.gemm_dx(dy, w, epi, aux)
    torch.cuda.synchronize()
    assert fb.launches["gemm_dx"] == before + 2
    assert got.dtype == fb.GEMM_DX_EPILOGUES[epi][2] and got.shape == (M, N)
    assert torch.equal(got, again)
    _close(got, fb.gemm_dx_plain(dy, w, epi, aux))


@pytest.mark.parametrize("R,n_out,k_in", GEMM_DW_SHAPES)
def test_gemm_dw_kernel_matches_twin(cuda_device, R, n_out, k_in):
    r = np.random.RandomState(R + n_out + k_in)
    dy = torch.from_numpy(r.randn(R, n_out)).to(cuda_device, torch.bfloat16)
    x = torch.from_numpy(r.randn(R, k_in)).to(cuda_device, torch.bfloat16)
    before = fb.launches["gemm_dw"]
    got = fb.gemm_dw(dy, x)
    again = fb.gemm_dw(dy, x)
    torch.cuda.synchronize()
    assert fb.launches["gemm_dw"] == before + 2
    assert got.dtype == torch.float32 and got.shape == (n_out, k_in)
    assert torch.equal(got, again)  # the split partials in a fixed order
    _close(got, fb.gemm_dw_plain(dy, x))
    assert fb.gemm_dw_splits(R, n_out, k_in) >= 1


@pytest.mark.parametrize("M,N,K", [(25088, 3072, 768), (18432, 3072, 768),
                                   (16, 3072, 768), (77, 512, 128)])
def test_gemm_gelu_grad_kernel_matches_twin(cuda_device, M, N, K):
    r = np.random.RandomState(M + N)
    a = torch.from_numpy(r.randn(M, K)).to(cuda_device, torch.bfloat16)
    w = torch.from_numpy(r.randn(N, K) * K ** -0.5).to(cuda_device, torch.bfloat16)
    bias = torch.from_numpy(r.randn(N)).to(cuda_device, torch.float32)
    before = fb.launches["gemm_gelu_grad"]
    hg, gp = fb.gemm_gelu_grad(a, w, bias)
    torch.cuda.synchronize()
    assert fb.launches["gemm_gelu_grad"] == before + 1
    want_hg, want_gp = fb.gemm_gelu_grad_plain(a, w, bias)
    _close(hg, want_hg)
    _close(gp, want_gp)


def test_backward_blocks_refuse_bad_inputs(cuda_device):
    bf16 = torch.bfloat16
    dy = torch.zeros(64, 256, dtype=bf16, device=cuda_device)
    w = torch.zeros(256, 128, dtype=bf16, device=cuda_device)
    before = dict(fb.launches)
    with pytest.raises(ValueError):  # N = 96 is no multiple of 128
        fb.gemm_dx(dy, w[:, :96].contiguous(), "bf16")
    with pytest.raises(ValueError):  # aux for an epilogue without one
        fb.gemm_dx(dy, w, "f32", torch.zeros(64, 128, device=cuda_device))
    with pytest.raises(ValueError):  # an unaligned start (TMA needs 16 bytes)
        fb.gemm_dx(dy.view(-1)[1:1 + 63 * 256].view(63, 256), w, "bf16")
    with pytest.raises(ValueError):  # rows differ
        fb.gemm_dw(dy, torch.zeros(63, 128, dtype=bf16, device=cuda_device))
    with pytest.raises(TypeError):
        fb.gemm_dw(dy.float(), dy)
    assert fb.launches == before


# Row 7's blocks alone (csrc/fused_block_bwd.cu's exports). The temporal
# attention backward (tc_attention.cuh's tc_strided_attn_bwd) over (B, T,
# N): the train step's global (16 clips x 196 positions) and local (64 x
# 36) crops at T = 8, a ragged last group (S = B * N not a multiple of the
# 14 sequences a block takes at T = 8), N = 4 and 1, other lengths (3, 5:
# several sequences a strip; 17, 30: strips of one sequence) and every
# head dim at T = 8.
TEMPORAL_BWD_SHAPES = [(16, 8, 196, 768, 12), (64, 8, 36, 768, 12), (1, 8, 13, 128, 2),
                       (2, 8, 15, 256, 4), (3, 8, 4, 256, 4), (5, 8, 1, 128, 2),
                       (2, 3, 16, 128, 2), (2, 5, 9, 256, 4), (1, 30, 4, 768, 12),
                       (1, 17, 3, 256, 2),
                       # the rand-fr step's 2- and 16-frame locals
                       (16, 2, 36, 768, 12), (16, 16, 36, 768, 12)] + [
    (1, 8, 7, D, H) for D, H in [(128, 8), (128, 4), (384, 8), (640, 8), (384, 4),
                                 (896, 8), (256, 2)]]


@pytest.mark.parametrize("B,T,N,D,H", TEMPORAL_BWD_SHAPES)
def test_temporal_attention_bwd_kernel_matches_twin(cuda_device, B, T, N, D, H):
    qkv = _qkv((B, T, N, 3 * D), B + T + N, cuda_device)
    da = _qkv((B, T, N, D), B + T + N + 1, cuda_device)
    before = fb.launches["temporal_attention_bwd"]
    got = fb.temporal_attention_bwd(qkv, da, H)
    again = fb.temporal_attention_bwd(qkv, da, H)
    torch.cuda.synchronize()
    assert fb.launches["temporal_attention_bwd"] == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, N, 3 * D)
    assert torch.equal(got, again)
    want = fb.temporal_attention_bwd_plain(qkv, da, H)
    for i in range(3):  # dq, dk, dv: each held against its own size
        _close_sums(got[..., i * D:(i + 1) * D], want[..., i * D:(i + 1) * D])


@pytest.mark.parametrize("B,N", [(16, 196), (64, 36)])
def test_temporal_attention_bwd_at_overflowing_logits(cuda_device, B, N):
    """Scores 64x the unit-variance inputs' (scale 8 at hd 64): exp
    overflows unless each row's max over its own sequence comes first."""
    qkv = _qkv((B, 8, N, 3 * 768), N, cuda_device)
    da = _qkv((B, 8, N, 768), N + 1, cuda_device)
    got = fb.temporal_attention_bwd(qkv, da, 12, scale=8.0)
    want = fb.temporal_attention_bwd_plain(qkv, da, 12, scale=8.0)
    assert bool(want.isfinite().all())
    for i in range(3):
        _close_sums(got[..., i * 768:(i + 1) * 768], want[..., i * 768:(i + 1) * 768])


def test_temporal_attention_bwd_shared_memory_mirror_is_the_librarys(cuda_device):
    """fused_block.temporal_attn_bwd_smem's mirror, by which the CPU twins
    refuse, equals the library's dvst_temporal_attn_bwd_smem."""
    from dino_video_summarization_transformer_tpu_torch.ops import _build

    lib = _build.load("bwd")
    for S in (1, 2, 5, 13, 14, 15, 34, 35, 36, 3136, 2304):
        for L in (1, 2, 3, 5, 8, 15, 16, 17, 30, 31, 33, 48, 64, 97, 112, 113, 197, 300):
            for hd in (16, 64, 128):
                assert fb.temporal_attn_bwd_smem(S, L, hd) == fb.temporal_attn_bwd_smem(
                    S, L, hd, lib), (S, L, hd)


def test_temporal_attention_bwd_refuses_what_shared_memory_cannot_hold(cuda_device):
    """One 300-row sequence at hd 128 needs 304 KB: the wrapper and row 7
    refuse it."""
    qkv = torch.zeros(1, 300, 1, 3 * 128, dtype=torch.bfloat16, device=cuda_device)
    da = torch.zeros(1, 300, 1, 128, dtype=torch.bfloat16, device=cuda_device)
    p = _block(128, 1, 0, cuda_device)["temporal"]
    before = dict(fb.launches)
    for call in (lambda: fb.temporal_attention_bwd(qkv, da, 1),
                 lambda: fb.temporal_phase_tm_bwd(da, da, p, 1)):
        with pytest.raises(ValueError, match="shared memory"):
            call()
    assert fb.launches == before


# The LayerNorm backward of rows 7-9 (dvst_common.cuh's ln_bwd) alone: (M,
# tail rows P, tail_div, D, residual): row 8's R = M + B*T rows at both
# crops (the per-frame CLS rows each read one clip's row), rows 7 and 9's
# grid rows, row 9's CLS-row calls (16, 64), ragged counts, and every width
# the kernel takes (D = 128 .. 1024: 4 .. 32 values a lane, 4 or 8 at once).
LN_BWD_SHAPES = [(25088, 16, 8, 768, True), (18432, 64, 8, 768, True), (25088, 0, 1, 768, True),
                 (16, 0, 1, 768, True), (64, 0, 1, 768, False), (100, 3, 5, 768, True),
                 (1, 0, 1, 768, True)] + [
    (77, 2, 3, D, True) for D in (128, 256, 384, 512, 640, 896, 1024)]


@pytest.mark.parametrize("M,P,tail_div,D,residual", LN_BWD_SHAPES)
def test_layer_norm_bwd_kernel_matches_twin(cuda_device, M, P, tail_div, D, residual):
    r = np.random.RandomState(M + P + D)
    x = torch.from_numpy(r.randn(M, D) * 2 + 0.5).to(cuda_device, torch.bfloat16)
    x_tail = (torch.from_numpy(r.randn(P, D)).to(cuda_device, torch.bfloat16)
              if P else None)
    dy = torch.from_numpy(r.randn(M + P * tail_div, D)).to(cuda_device, torch.float32)
    w = torch.from_numpy(1 + 0.2 * r.randn(D)).to(cuda_device, torch.float32)
    res = torch.from_numpy(r.randn(M, D)).to(cuda_device, torch.bfloat16) if residual else None
    before = fb.launches["layer_norm_bwd"]
    got = fb.layer_norm_bwd(x, dy, w, res, x_tail, tail_div)
    again = fb.layer_norm_bwd(x, dy, w, res, x_tail, tail_div)
    torch.cuda.synchronize()
    assert fb.launches["layer_norm_bwd"] == before + 2
    assert all(g is None and a is None or torch.equal(g, a) for g, a in zip(got, again))
    want = fb.layer_norm_bwd_plain(x, dy, w, res, x_tail, tail_div)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (M, D)
    _close(got[0], want[0], res)  # dx held against its branch, dx + res - res
    if P:
        assert got[1].shape == (P * tail_div, D)
        _close(got[1], want[1])
    else:
        assert got[1] is None
    _close(got[2], want[2])
    _close(got[3], want[3])


# ---------------------------------------------------------------------------
# The mixed teacher's f32 tiers (rows 1, 2, 3, 11), their workspaces, the
# wrappers' alignment checks, and the mixed forwards against the twins.
# Inputs: f32 rows with a large common offset and a small spread
# (twin_check.offset_rows), on which a kernel that rounds an f32 input to
# bf16 fails the bound. Shapes: the main path's at ViT-B widths and row
# counts that are no multiple of the GEMM's 128-row tiles (M = 105, 200).
# ---------------------------------------------------------------------------

F32_SHAPES = [(8, 30, 196, 768, 12), (8, 3, 196, 768, 12), (1, 5, 4, 256, 4),
              (3, 7, 5, 128, 2)]


def _offset(shape, seed, device):
    return torch.from_numpy(twin_check.offset_rows(np.random.RandomState(seed),
                                                   shape)).to(device)


@pytest.mark.parametrize("B,T,N,D,H", F32_SHAPES)
def test_temporal_phase_tm_f32_kernel_matches_twin(cuda_device, B, T, N, D, H):
    p = _block(D, H, 0, cuda_device)["temporal"]
    x = _offset((B, T, N, D), 71, cuda_device)
    before = dict(fb.launches)
    got = fb.temporal_phase_tm(x, p, H)
    torch.cuda.synchronize()
    assert fb.launches["temporal_phase_tm_f32"] == before["temporal_phase_tm_f32"] + 1
    assert fb.launches["temporal_phase_tm"] == before["temporal_phase_tm"]
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, fb.temporal_phase_tm_plain(x, p, H), x)


@pytest.mark.parametrize("B,T,N,D,H", F32_SHAPES)
def test_spatial_mlp_f32_kernel_matches_twin(cuda_device, B, T, N, D, H):
    p = _block(D, H, 0, cuda_device)["spatial"]
    x1, cls = _offset((B, T, N, D), 72, cuda_device), _offset((B, 1, D), 73, cuda_device)
    before = fb.launches["spatial_mlp_f32"]
    grid, rows = fb.spatial_mlp(x1, cls, p, H)
    torch.cuda.synchronize()
    assert fb.launches["spatial_mlp_f32"] == before + 1
    assert grid.dtype == rows.dtype == torch.float32
    want_grid, want_rows = fb.spatial_mlp_plain(x1, cls, p, H)
    _close(grid, want_grid, x1)
    _close(rows, want_rows)


@pytest.mark.parametrize("M,D,H", [(200, 256, 4), (105, 128, 2), (512 * 196, 768, 12),
                                   (16 * 8 * 196, 768, 12)])
def test_mlp_phase_f32_kernel_matches_twin(cuda_device, M, D, H):
    p = _block(D, H, 0, cuda_device)["spatial"]
    x = _offset((M, D), 74, cuda_device)
    before = fb.launches["mlp_phase_f32"]
    got = fb.mlp_phase(x, p)
    torch.cuda.synchronize()
    assert fb.launches["mlp_phase_f32"] == before + 1
    assert got.dtype == torch.float32
    _close(got, fb.mlp_phase_plain(x, p), x)
    branch = fb.mlp_phase(x, p, residual=False)
    assert branch.dtype == torch.float32
    _close(branch, fb.mlp_phase_plain(x, p, residual=False))


@pytest.mark.parametrize("C,N,D,H", [(64, 16, 256, 4), (50, 196, 256, 2),
                                     (512, 196, 768, 12), (7, 15, 128, 2)])
def test_spatial_phase_pf_f32_kernel_matches_twin(cuda_device, C, N, D, H):
    p = _block(D, H, 0, cuda_device)["spatial"]
    x, cls = _offset((C, N, D), 75, cuda_device), _offset((C, D), 76, cuda_device)
    before = bb.launches["spatial_phase_pf_f32"]
    got = bb.spatial_phase_pf(x, cls, p, H)
    torch.cuda.synchronize()
    assert bb.launches["spatial_phase_pf_f32"] == before + 1
    assert got[0].dtype == torch.float32 and got[1].dtype == got[2].dtype == torch.bfloat16
    want = bb.spatial_phase_pf_plain(x, cls, p, H)
    _close(got[0], want[0], x)
    _close(got[1], want[1])
    _close(got[2], want[2])


@pytest.mark.parametrize("B,T,N,D,Dh", [(8, 30, 196, 768, 3072), (8, 3, 196, 768, 3072),
                                        (3, 7, 5, 128, 512), (1, 1, 1, 128, 128)])
def test_workspace_mirrors_are_the_librarys(cuda_device, B, T, N, D, Dh):
    """The wrappers' workspace mirrors (what the CPU twins and the CPU
    tests read) equal the library's ``*_ws`` answers, which the wrappers
    allocate on the card."""
    lib, blib = _build.load(), _build.load("banded")
    M = B * T * N
    assert fb.temporal_phase_tm_ws(B, T, N, D) == fb.temporal_phase_tm_ws(B, T, N, D, lib)
    assert fb.spatial_mlp_ws(B, T, N, D, Dh) == fb.spatial_mlp_ws(B, T, N, D, Dh, lib)
    assert fb.mlp_phase_ws(M, D, Dh) == fb.mlp_phase_ws(M, D, Dh, lib)
    assert bb.spatial_phase_pf_ws(B * T, N, D) == bb.spatial_phase_pf_ws(B * T, N, D, blib)


def _misaligned(t):
    """A view of ``t``'s values that starts one element past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


@pytest.mark.parametrize("op", ["temporal_phase_tm", "temporal_phase", "spatial_mlp",
                                "mlp_phase", "banded_temporal_attn", "spatial_phase_pf"])
def test_wrappers_refuse_unaligned_views(cuda_device, op):
    """Rows 1 (and 1b), 6, 2, 3, 10 and 11 read their inputs and weights
    through TMA, cp.async or 16-byte loads: a view one element in raises a
    ValueError before any launch, not a CUDA error."""
    D, H = 256, 4
    blk = _block(D, H, 0, cuda_device)
    pt, ps = blk["temporal"], blk["spatial"]
    x4 = _qkv((2, 3, 4, D), 80, cuda_device)
    calls = {
        "temporal_phase_tm": (lambda x, p: fb.temporal_phase_tm(x, p, H), x4, pt,
                              ("qkv_w", "proj_w", "fc_w"), fb.launches),
        "temporal_phase": (lambda x, p: fb.temporal_phase(x, p, H),
                           _qkv((6, 5, D), 81, cuda_device), pt,
                           ("qkv_w", "proj_w", "fc_w"), fb.launches),
        "spatial_mlp": (lambda x, p: fb.spatial_mlp(x, x4[:, :1, 0].contiguous(), p, H),
                        x4.float(), ps, ("qkv_w", "proj_w", "fc1_w", "fc2_w"), fb.launches),
        "mlp_phase": (lambda x, p: fb.mlp_phase(x, p), _qkv((50, D), 82, cuda_device), ps,
                      ("fc1_w", "fc2_w"), fb.launches),
        "banded_temporal_attn": (lambda x, p: bb.banded_temporal_attn(x, 8, 3, H),
                                 _qkv((8, 4, 3 * D), 83, cuda_device), None, (), bb.launches),
        "spatial_phase_pf": (lambda x, p: bb.spatial_phase_pf(
            x, _qkv((8, D), 84, cuda_device).to(x.dtype), p, H),
            _qkv((8, 4, D), 85, cuda_device), ps, ("qkv_w", "proj_w"), bb.launches),
    }
    fn, x, p, weights, counter = calls[op]
    before = dict(counter)
    fn(x, p)  # aligned: runs
    torch.cuda.synchronize()
    assert counter != before
    before = dict(counter)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fn(_misaligned(x), p)
    for k in weights:
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(x, {**p, k: _misaligned(p[k])})
    if op in ("temporal_phase_tm", "mlp_phase"):  # the f32 tier too
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(_misaligned(x.float()), p)
    assert counter == before


@pytest.mark.parametrize("band", [None, (64, 30), (50, 3)])
def test_mixed_teacher_forward_kernels_match_twins(cuda_device, band):
    """A whole f32 (mixed-teacher) forward on the kernels against the same
    forward with the twins (CPU), at depth 2, windowed and banded: the
    features held by the card's bound, the f32 tiers launched."""
    cfg = tsf.TimeSformerConfig(img_size=64, patch_size=16, embed_dim=256,
                                depth=2, num_heads=4, num_frames=8,
                                num_classes=0, use_kernels=True)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, 13), cfg)
    gpu = tsf.build_timesformer(cfg, sd, device=cuda_device, dtype=torch.float32)
    cpu = tsf.build_timesformer(cfg, sd, device="cpu", dtype=torch.float32)
    before = {**fb.launches, **bb.launches}
    with torch.inference_mode():
        if band is None:
            x = torch.from_numpy(np.random.RandomState(14).randn(2, 3, 6, 64, 64)).float()
            got, want = gpu(x.to(cuda_device)).cpu(), cpu(x)
            tiers = ("temporal_phase_tm_f32", "spatial_mlp_f32")
        else:
            t_real, eff = band
            fr = torch.from_numpy(np.random.RandomState(15).randn(64, 64, 64, 3)).float()
            got = banded.banded_cls_features(gpu, fr.to(cuda_device), t_real, eff).cpu()
            want = banded.banded_cls_features(cpu, fr, t_real, eff)
            got, want = got[:t_real], want[:t_real]
            tiers = ("spatial_phase_pf_f32", "mlp_phase_f32")
    after = {**fb.launches, **bb.launches}
    assert all(after[k] == before[k] + 2 for k in tiers), (before, after)
    _close(got, want)


# ---------------------------------------------------------------------------
# The frame wire's gather (ops/wire.py): bit for bit against its twin
# ---------------------------------------------------------------------------

def _wire_buffer(layout, n, H, W, seed):
    """n random frames' bytes in ``layout`` (any bytes are a packed frame)."""
    shape = ((n, H, W, 3) if layout == "rgb8" else
             (n, yuv.packed_height(H), W) if layout == "yuv420" else
             (n, yuv.packed_q_height(H, W), W))
    return torch.from_numpy(
        np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8))


@pytest.mark.parametrize("layout,H,W", [("rgb8", 224, 224), ("yuv420", 224, 224),
                                        ("yuv420q", 224, 224), ("yuv420", 226, 224),
                                        ("yuv420", 18, 24), ("yuv420q", 24, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_normalize_kernel_matches_twin(cuda_device, layout, H, W, dtype):
    buf = _wire_buffer(layout, 16, H, W, 3).to(cuda_device)
    idx = np.random.RandomState(4).randint(0, 16, (6, 5))
    before = wire.launches["gather_normalize"]
    got = wire.gather_normalize(buf, idx, dtype, layout)
    want = wire.gather_normalize_plain(buf, idx, dtype, layout)
    torch.cuda.synchronize()
    assert wire.launches["gather_normalize"] == before + 1
    assert got.shape == (30, H, W, 3) and got.dtype == dtype
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())
    # and the twin on the card equals the twin on the CPU
    assert torch.equal(want.cpu(), wire.gather_normalize_plain(buf.cpu(), idx, dtype,
                                                               layout))


def test_gather_normalize_repeats_and_padding(cuda_device):
    """The banded segment's padding (its last frame repeated) and the
    windowed path's padding rows (frame 0): every repeat equals its frame."""
    buf = _wire_buffer("yuv420", 40, 32, 32, 5).to(cuda_device)
    idx = np.concatenate([np.minimum(np.arange(48), 29), np.zeros(5, np.int64)])
    got = wire.gather_normalize(buf, idx, torch.bfloat16, "yuv420")
    assert torch.equal(got, wire.gather_normalize_plain(buf, idx, torch.bfloat16, "yuv420"))
    assert all(torch.equal(got[i], got[29]) for i in range(30, 48))
    assert all(torch.equal(got[48 + i], got[0]) for i in range(5))


def test_gather_normalize_refuses_bad_inputs(cuda_device):
    buf = _wire_buffer("yuv420", 4, 32, 32, 6).to(cuda_device)
    before = wire.launches["gather_normalize"]
    with pytest.raises(TypeError, match="uint8"):
        wire.gather_normalize(buf.float(), [0], torch.float32, "yuv420")
    for bad in ([4], [-1], [0, 1, 7]):
        with pytest.raises(IndexError, match="out of range"):
            wire.gather_normalize(buf, bad, torch.float32, "yuv420")
    with pytest.raises(TypeError, match="host array"):
        wire.gather_normalize(buf, torch.zeros(2, dtype=torch.int64, device=cuda_device),
                              torch.float32, "yuv420")
    with pytest.raises(ValueError, match=r"expected \(N, H, W, 3\)"):
        wire.gather_normalize(buf, [0], torch.float32, "rgb8")
    with pytest.raises(ValueError, match="yuv420q"):
        wire.gather_normalize(buf, [0], torch.float32, "yuv420q")
    with pytest.raises(TypeError, match="dtype"):
        wire.gather_normalize(buf, [0], torch.float16, "yuv420")
    assert wire.launches["gather_normalize"] == before


def test_scorer_refuses_a_group_of_mixed_layouts(cuda_device):
    cfg = tsf.TimeSformerConfig(img_size=32, patch_size=16, embed_dim=64, depth=1,
                                num_heads=2, num_frames=4, num_classes=0)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, 0), cfg)
    sc = scoring.FrameScorer(sd, cfg, local_size=3, global_size=8, chunk=4,
                             device=cuda_device)
    u8 = np.random.RandomState(7).randint(0, 256, (12, 32, 32, 3), dtype=np.uint8)
    loc, glob = np.zeros((12, 3), np.int64), np.zeros((12, 8), np.int64)
    item = {"local_idx": loc, "global_idx": glob, "eff_global": 8, "dummy": False}
    group = [dict(item, frames=u8), dict(item, frames=yuv.pack_rgb(u8))]
    with pytest.raises(ValueError, match="mixes frame layouts"):
        sc.score_group_async(group)


# ---------------------------------------------------------------------------
# The int8 tier (W8A8): its three kernels bit for bit, rows 1q and 2q by
# twin_check's int8 rules
# ---------------------------------------------------------------------------

def _q8_block(D, H, seed, device):
    from dino_video_summarization_transformer_tpu_torch.ops import quant

    cfg = tsf.TimeSformerConfig(img_size=32, patch_size=16, embed_dim=D,
                                depth=1, num_heads=H, num_frames=4,
                                num_classes=0)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, seed), cfg)
    model = tsf.build_timesformer(cfg, quant.quantize_state_dict_int8(sd), device=device)
    return fb.block_params(model.blocks[0])


@pytest.mark.parametrize("M,D,dtype", [(3, 128, torch.bfloat16), (1000, 768, torch.bfloat16),
                                       (1000, 768, torch.float32), (77, 1024, torch.float32)])
def test_ln_quant_rows_kernel_is_bit_equal(cuda_device, M, D, dtype):
    """K1: the LN + quantize kernel's codes and scales equal its twin's."""
    g = torch.Generator(device="cuda").manual_seed(M)
    x = (2 * torch.randn(M, D, generator=g, device=cuda_device) + 1).to(dtype)
    w = 1 + 0.1 * torch.randn(D, generator=g, device=cuda_device)
    b = 0.1 * torch.randn(D, generator=g, device=cuda_device)
    q, s = fb.ln_quant_rows(x, w, b)
    q0, s0 = fb.ln_quant_rows_plain(x, w, b)
    assert torch.equal(q, q0) and torch.equal(s, s0)


@pytest.mark.parametrize("M,D", [(5, 128), (1000, 768), (333, 3072)])
def test_quant_rows_kernel_is_bit_equal(cuda_device, M, D):
    """K2: the row quantize kernel's codes and scales equal its twin's; a
    zero row quantizes to zeros."""
    g = torch.Generator(device="cuda").manual_seed(D)
    x = torch.randn(M, D, generator=g, device=cuda_device).to(torch.bfloat16)
    x[0] = 0
    q, s = fb.quant_rows(x)
    q0, s0 = fb.quant_rows_plain(x)
    assert torch.equal(q, q0) and torch.equal(s, s0) and not q[0].any()


@pytest.mark.parametrize("M,N,K", [(1, 128, 128), (300, 768, 768), (4704, 2304, 768),
                                   (4704, 768, 3072), (129, 3072, 768)])
def test_gemm_s8_kernel_is_bit_equal(cuda_device, M, N, K):
    """K3: the s8 GEMM's outputs equal its twin's at every forward
    epilogue (the ragged M edge included)."""
    g = torch.Generator(device="cuda").manual_seed(N + K)
    a = torch.randint(-127, 128, (M, K), generator=g, device=cuda_device, dtype=torch.int8)
    w = torch.randint(-127, 128, (N, K), generator=g, device=cuda_device, dtype=torch.int8)
    sx = 0.05 * torch.rand(M, generator=g, device=cuda_device)
    sw = 1e-3 * torch.rand(N, generator=g, device=cuda_device)
    bias = torch.randn(N, generator=g, device=cuda_device)
    for epi, (_, rdt, _) in fb.GEMM_EPILOGUES.items():
        res = None if rdt is None else torch.randn(M, N, generator=g, device=cuda_device).to(rdt)
        got = fb.gemm_s8(a, sx, w, sw, bias, epi, res)
        want = fb.gemm_s8_plain(a, sx, w, sw, bias, epi, res)
        if epi == "gelu_bf16":  # erff against torch's erf: held as bf16 outputs are
            _close(got, want)
        else:
            assert torch.equal(got, want), epi


@pytest.mark.parametrize("B,T,N,D,H", [(2, 3, 16, 128, 2), (8, 30, 196, 768, 12),
                                       (8, 3, 196, 768, 12)])
def test_q8_rows_match_twins(cuda_device, B, T, N, D, H):
    """Rows 1q and 2q against their twins by twin_check's int8 rules."""
    p = _q8_block(D, H, 7, cuda_device)
    g = torch.Generator(device="cuda").manual_seed(T)
    x = torch.randn(B, T, N, D, generator=g, device=cuda_device).to(torch.bfloat16)
    x1 = torch.randn(B, T, N, D, generator=g, device=cuda_device)
    cls = torch.randn(B, 1, D, generator=g, device=cuda_device).to(torch.bfloat16)
    gaps = [twin_check.twin_gap(fb.temporal_phase_tm(x, p["temporal"], H),
                                fb.temporal_phase_tm_plain(x, p["temporal"], H), x)]
    got, want = fb.spatial_mlp(x1, cls, p["spatial"], H), fb.spatial_mlp_plain(
        x1, cls, p["spatial"], H)
    gaps += [twin_check.twin_gap(got[0], want[0], x1), twin_check.twin_gap(got[1], want[1])]
    for gap in gaps:
        assert not twin_check.twin_failures(gap, q8=True), gap


@pytest.mark.parametrize("B,T,N,D,H", [(2, 3, 16, 128, 2), (8, 30, 196, 768, 12),
                                       (8, 3, 196, 768, 12)])
def test_q8_f32_rows_match_twins(cuda_device, B, T, N, D, H):
    """Rows 1qf and 2qf (the int8 tier's f32 block boundary: f32 x, an f32
    CLS row, an f32 grid) on offset rows against their twins by twin_check's
    int8 rules, their f32 outputs also by its f32 rule (bf16_exact)."""
    p = _q8_block(D, H, 7, cuda_device)
    r = np.random.RandomState(T)

    def rows(*shape):
        return torch.from_numpy(twin_check.offset_rows(r, shape)).to(cuda_device)

    x, x1, cls = rows(B, T, N, D), rows(B, T, N, D), rows(B, 1, D)
    out = fb.temporal_phase_tm(x, p["temporal"], H)
    gaps = [twin_check.twin_gap(out, fb.temporal_phase_tm_plain(x, p["temporal"], H), x)]
    got, want = fb.spatial_mlp(x1, cls, p["spatial"], H), fb.spatial_mlp_plain(
        x1, cls, p["spatial"], H)
    gaps += [twin_check.twin_gap(got[0], want[0], x1), twin_check.twin_gap(got[1], want[1])]
    for gap in gaps:
        assert not twin_check.twin_failures(gap, q8=True), gap
    for t in (out, got[0], got[1]):
        assert not twin_check.f32_failures(t)


def test_q8_workspaces_match_the_mirrors(cuda_device):
    """The library's int8 workspaces == the Python mirrors."""
    lib = _build.load()
    for B, T, N, D, Dh in [(8, 30, 196, 768, 3072), (2, 3, 5, 128, 512)]:
        assert fb.temporal_phase_tm_q8_ws(B, T, N, D, lib) == fb.temporal_phase_tm_q8_ws(B, T, N, D)
        assert fb.spatial_mlp_q8_ws(B, T, N, D, Dh, lib) == fb.spatial_mlp_q8_ws(B, T, N, D, Dh)


# ---------------------------------------------------------------------------
# The trainer's mixed tier: rows 4f, 7f, 8f, 9f and the LayerNorm
# backward's f32 instance. Inputs on offset rows (x, the CLS row and the
# cotangents: twin_check.offset_rows), where an x rounded to bf16 before a
# LayerNorm fails the twin rules; the f32 outputs also held by
# twin_check's f32 rules (no output rounded to bf16, the f32-cotangent bias
# gradients within F32_SUM_REL_MAX of the twin's).
# ---------------------------------------------------------------------------

MIXED_SHAPES = [(16, 8, 196, 768, 12), (64, 8, 36, 768, 12), (3, 8, 4, 256, 4),
                (5, 8, 1, 128, 2)]


def _offset(shape, seed, device):
    return torch.from_numpy(twin_check.offset_rows(np.random.RandomState(seed),
                                                   shape)).to(device)


def _f32_ok(got, want=None):
    assert not twin_check.f32_failures(got, want), twin_check.f32_failures(got, want)


@pytest.mark.parametrize("B,T,N,D,H", MIXED_SHAPES)
def test_spatial_phase_f32_kernel_matches_twin(cuda_device, B, T, N, D, H):
    p = _block(D, H, 0, cuda_device)["spatial"]
    x, cls = _offset((B, T, N, D), 31, cuda_device), _offset((B, 1, D), 32, cuda_device)
    before = fb.launches["spatial_phase_f32"]
    grid, rows = fb.spatial_phase(x, cls, p, H)
    torch.cuda.synchronize()
    assert fb.launches["spatial_phase_f32"] == before + 1
    assert grid.dtype == rows.dtype == torch.float32
    want_grid, want_rows = fb.spatial_phase_plain(x, cls, p, H)
    _close(grid, want_grid, x)
    _close(rows, want_rows)
    _f32_ok(grid)
    _f32_ok(rows)


def _mixed_bwd(op, B, T, N, D, H, device, kernel=True):
    """(dx, dcls or None, grads, the inputs) of an f32 backward op on
    offset rows, through the wrapper (kernel) or its twin."""
    p = _block(D, H, 0, device)["spatial" if op != "temporal" else "temporal"]
    x = _offset((B, T, N, D), 33, device)
    dout = _offset((B, T, N, D), 34, device)
    if op == "temporal":
        fn = fb.temporal_phase_tm_bwd if kernel else fb.temporal_phase_tm_bwd_plain
        dx, g = fn(x, dout, p, H)
        return dx, None, g, (x, dout)
    if op == "spatial":
        cls, dco = _offset((B, 1, D), 35, device), _offset((B, T, D), 36, device)
        fn = fb.spatial_phase_bwd if kernel else fb.spatial_phase_bwd_plain
        dx, dcls, g = fn(x, cls, dout, dco, p, H)
        return dx, dcls, g, (x, dout)
    xm, dm = x.reshape(-1, D), dout.reshape(-1, D)
    fn = fb.mlp_phase_bwd if kernel else fb.mlp_phase_bwd_plain
    dx, g = fn(xm, dm, p)
    return dx, None, g, (xm, dm)


# the bias gradient each op sums from its f32 cotangent
COTANGENT_BIAS = {"temporal": "fc_b", "spatial": "proj_b", "mlp": "fc2_b"}


@pytest.mark.parametrize("op", ["temporal", "spatial", "mlp"])
@pytest.mark.parametrize("B,T,N,D,H", MIXED_SHAPES)
def test_backward_f32_kernels_match_twins(cuda_device, op, B, T, N, D, H):
    key = {"temporal": "temporal_phase_tm_bwd_f32", "spatial": "spatial_phase_bwd_f32",
           "mlp": "mlp_phase_bwd_f32"}[op]
    before = fb.launches[key]
    dx, dcls, g, (x, dout) = _mixed_bwd(op, B, T, N, D, H, cuda_device)
    dx2, dcls2, g2, _ = _mixed_bwd(op, B, T, N, D, H, cuda_device)
    torch.cuda.synchronize()
    assert fb.launches[key] == before + 2
    assert dx.dtype == torch.float32 and torch.equal(dx, dx2)
    assert all(torch.equal(g[k], g2[k]) for k in g)
    want_dx, want_dcls, want_g, _ = _mixed_bwd(op, B, T, N, D, H, cuda_device, kernel=False)
    _close(dx, want_dx, dout)
    _f32_ok(dx)
    if dcls is not None:
        assert torch.equal(dcls, dcls2)
        _close(dcls, want_dcls)
    _grads_close(g, want_g)
    b = COTANGENT_BIAS[op]
    _f32_ok(g[b], want_g[b])


@pytest.mark.parametrize("M,P,tail_div,D,residual", [(25088, 0, 1, 768, True),
                                                     (25088, 16, 8, 768, True),
                                                     (300, 3, 5, 256, False)])
def test_layer_norm_bwd_f32_kernel_matches_twin(cuda_device, M, P, tail_div, D, residual):
    r = np.random.RandomState(M + P + D + 1)
    x = _offset((M, D), M, cuda_device)
    x_tail = _offset((P, D), P + 1, cuda_device) if P else None
    dy = torch.from_numpy(r.randn(M + P * tail_div, D)).to(cuda_device, torch.float32)
    w = torch.from_numpy(1 + 0.2 * r.randn(D)).to(cuda_device, torch.float32)
    res = _offset((M, D), M + 2, cuda_device) if residual else None
    before = fb.launches["layer_norm_bwd_f32"]
    got = fb.layer_norm_bwd(x, dy, w, res, x_tail, tail_div)
    torch.cuda.synchronize()
    assert fb.launches["layer_norm_bwd_f32"] == before + 1
    want = fb.layer_norm_bwd_plain(x, dy, w, res, x_tail, tail_div)
    assert got[0].dtype == torch.float32
    _close(got[0], want[0], res)
    _f32_ok(got[0])
    if P:
        _close(got[1], want[1])
    _close(got[2], want[2])
    _close(got[3], want[3])


@pytest.mark.parametrize("B,T,N,D,H", [(16, 8, 196, 768, 12), (3, 8, 4, 256, 4)])
def test_f32_tiers_on_bf16_values_equal_the_bf16_tiers(cuda_device, B, T, N, D, H):
    """On inputs that bf16 holds exactly, each f32 tier computes what its
    bf16 tier computes, bit for bit, and differs only where it stores: row
    4f's grid equals row 4's f32-out tier and its CLS rows rounded to bf16
    row 4's; 7f, 8f and 9f's weight gradients and dcls equal the bf16
    tiers' and their dx rounded to bf16 the bf16 dx; the LN backward's f32
    dx rounded to bf16 its bf16 instance's. So the bf16 instances read,
    round and sum as before, and the f32 ones only read and store in f32."""
    pt, ps = _block(D, H, 0, cuda_device)["temporal"], _block(D, H, 0, cuda_device)["spatial"]
    bf = torch.bfloat16
    x16, dout16 = _qkv((B, T, N, D), 37, cuda_device), _qkv((B, T, N, D), 38, cuda_device)
    cls16, dco16 = _qkv((B, 1, D), 39, cuda_device), _qkv((B, T, D), 40, cuda_device)
    x, dout, cls, dco = (t.float() for t in (x16, dout16, cls16, dco16))
    grid, rows = fb.spatial_phase(x, cls, ps, H)
    grid16_f32, rows16 = fb.spatial_phase(x16, cls16, ps, H, out_dtype=torch.float32)
    assert torch.equal(grid, grid16_f32) and torch.equal(rows.to(bf), rows16)
    pairs = [(fb.temporal_phase_tm_bwd(x, dout, pt, H), fb.temporal_phase_tm_bwd(x16, dout16, pt, H)),
             (fb.spatial_phase_bwd(x, cls, dout, dco, ps, H),
              fb.spatial_phase_bwd(x16, cls16, dout16, dco16, ps, H)),
             (fb.mlp_phase_bwd(x.reshape(-1, D), dout.reshape(-1, D), ps),
              fb.mlp_phase_bwd(x16.reshape(-1, D), dout16.reshape(-1, D), ps))]
    for got32, got16 in pairs:
        assert got32[0].dtype == torch.float32 and torch.equal(got32[0].to(bf), got16[0])
        for a, b in zip(got32[1:-1], got16[1:-1]):  # dcls
            assert torch.equal(a, b)
        assert all(torch.equal(got32[-1][k], got16[-1][k]) for k in got16[-1])
    dy = torch.randn(B * T * N + B * T, D, device=cuda_device)
    w = torch.rand(D, device=cuda_device) + 0.5
    lb32 = fb.layer_norm_bwd(x.reshape(-1, D), dy, w, dout.reshape(-1, D), cls.reshape(B, D), T)
    lb16 = fb.layer_norm_bwd(x16.reshape(-1, D), dy, w, dout16.reshape(-1, D),
                             cls16.reshape(B, D), T)
    assert torch.equal(lb32[0].to(bf), lb16[0])
    assert all(torch.equal(a, b) for a, b in zip(lb32[1:], lb16[1:]))


def test_mixed_train_step_kernel_route_matches_twins(cuda_device):
    """The mixed tier's gradients of a whole train step (depth 2, D=128) on
    the card against the same step on the CPU (the twins), as the bf16
    route's test above holds it: per parameter max|diff| / max|CPU| <
    0.15; every backward on the card ran its f32 tier."""
    from dino_video_summarization_transformer_tpu_torch.train import ssl

    cfg = tsf.TimeSformerConfig(img_size=32, patch_size=16, embed_dim=128,
                                depth=2, num_heads=2, num_frames=4,
                                num_classes=0)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, 5), cfg)
    r = np.random.RandomState(6)
    g = torch.from_numpy(r.randn(4, 3, 4, 32, 32).astype(np.float32))
    l = torch.from_numpy(r.randn(8, 3, 4, 32, 32).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda_device):
        state, core, mask = ssl.init_train_state(cfg, out_dim=64, seed=7,
                                                 pretrained_backbone=sd,
                                                 device=dev)
        step = ssl.make_train_step(cfg, core, mask, n_local_crops=4,
                                   compute_dtype=torch.float32, route="kernels")
        before = dict(fb.launches)
        _, _, grads[str(dev)] = step.loss_and_grads(state, g.to(dev), l.to(dev), 0.04)
        ran = {k: fb.launches[k] - before[k] for k in fb.launches}
        want = 0 if dev == "cpu" else 2 * cfg.depth
        assert ran["spatial_phase_bwd_f32"] == ran["temporal_phase_tm_bwd_f32"] == want
        assert ran["spatial_phase_bwd"] == ran["temporal_phase_tm_bwd"] == 0
    for n, want in grads["cpu"].items():
        got = grads["cuda"][n].cpu()
        rel = float((got - want).abs().max() / (want.abs().max() + 1e-12))
        assert torch.isfinite(got).all() and rel < 0.15, (n, rel)


# ---------------------------------------------------------------------------
# The strided scorer's geometries: rows 1f and 2f at the students' window
# (f32 students on the kernels), rows 1 and 2 at teacher_img=160's grid
# (N = 100), and the scorer's strided modes on the card against its twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,N,D,H", [(8, 3, 196, 768, 12), (3, 3, 16, 128, 2)])
def test_f32_tiers_at_the_students_window_stay_f32(cuda_device, B, T, N, D, H):
    """Rows 1f and 2f at T = 3 on offset rows: their f32 outputs are not
    rounded to bf16 (twin_check's f32 rule) and match their twins."""
    blk = _block(D, H, 0, cuda_device)
    x = _offset((B, T, N, D), 75, cuda_device)
    x1, cls = _offset((B, T, N, D), 76, cuda_device), _offset((B, 1, D), 77, cuda_device)
    out = fb.temporal_phase_tm(x, blk["temporal"], H)
    grid, rows = fb.spatial_mlp(x1, cls, blk["spatial"], H)
    torch.cuda.synchronize()
    for t in (out, grid):
        _f32_ok(t)
    _close(out, fb.temporal_phase_tm_plain(x, blk["temporal"], H), x)
    want_grid, want_rows = fb.spatial_mlp_plain(x1, cls, blk["spatial"], H)
    _close(grid, want_grid, x1)
    _close(rows, want_rows)


@pytest.mark.parametrize("B,T,N,D,H", [(8, 30, 100, 768, 12), (2, 30, 100, 128, 2),
                                       (8, 3, 100, 768, 12)])
def test_windowed_pair_at_the_teacher_img_grid(cuda_device, B, T, N, D, H):
    """Rows 1 and 2 (bf16) at N = 100, teacher_img=160's 10 x 10 patch
    grid (the spatial attention at L = 101)."""
    blk = _block(D, H, 0, cuda_device)
    r = np.random.RandomState(8)
    x = torch.from_numpy(r.randn(B, T, N, D)).to(cuda_device, torch.bfloat16)
    x1 = torch.from_numpy(r.randn(B, T, N, D)).to(cuda_device, torch.float32)
    cls = torch.from_numpy(r.randn(B, 1, D)).to(cuda_device, torch.bfloat16)
    _close(fb.temporal_phase_tm(x, blk["temporal"], H),
           fb.temporal_phase_tm_plain(x, blk["temporal"], H), x)
    grid, rows = fb.spatial_mlp(x1, cls, blk["spatial"], H)
    want_grid, want_rows = fb.spatial_mlp_plain(x1, cls, blk["spatial"], H)
    _close(grid, want_grid, x1)
    _close(rows, want_rows)


STRIDED = {"turbo2e-mt": dict(compute_dtype=torch.bfloat16, teacher_dtype=torch.float32,
                              teacher_stride=8, teacher_interp="catmullrom",
                              teacher_refine=0.035),
           "turbo-mixed": dict(compute_dtype=torch.float32, teacher_stride=4),
           "teacher_img": dict(compute_dtype=torch.bfloat16, teacher_img=32)}


@pytest.mark.parametrize("mode", list(STRIDED))
def test_strided_scorer_kernels_match_twins(cuda_device, mode):
    """The strided scorer on the kernels against the same scorer on the CPU
    (the twins), depth 2, D = 128, 48-px frames: within 0.06 mean relative
    (chip_smoke.py's rule between the kernel path and its twins; one frame
    of the teacher_img case reads 0.26 x the mean loss apart, a teacher
    softmax at temperature 0.02 flipping between near-tied rows);
    student_dispatch 1 equal to 4 bit for bit on the card."""
    cfg = tsf.TimeSformerConfig(img_size=48, patch_size=16, embed_dim=128, depth=2,
                                num_heads=2, num_frames=4, num_classes=0)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, 3), cfg)
    frames = np.random.RandomState(9).randn(40, 48, 48, 3).astype(np.float32)
    loc = np.clip(np.arange(40)[:, None] + np.arange(-1, 2), 0, 39)
    glob = np.clip(np.arange(40)[:, None] + np.arange(-4, 4), 0, 39)
    kw = dict(local_size=3, global_size=8, chunk=4, use_kernels=True, precision=None,
              **STRIDED[mode])
    got = {}
    for dev in ("cpu", cuda_device):
        before = dict(fb.launches)
        sc = scoring.FrameScorer(sd, cfg, device=dev, **kw)
        got[str(dev)] = sc.score_video(frames, loc, glob, 8)
        ran = sum(fb.launches[k] - before[k] for k in fb.launches)
        assert (ran > 0) == (dev != "cpu")
    one = scoring.FrameScorer(sd, cfg, device=cuda_device, student_dispatch=1,
                              **kw).score_video(frames, loc, glob, 8)
    np.testing.assert_array_equal(one, got["cuda"])
    rel = np.mean(np.abs(got["cuda"] - got["cpu"])) / np.mean(np.abs(got["cpu"]))
    assert np.all(np.isfinite(got["cuda"])) and rel <= 0.06, rel


# ---------------------------------------------------------------------------
# The evaluation consumers' geometries: rows 1 and 2 at the kNN / linear
# probe's batch (B = 8, T = 8), rows 1f and 2f at the K400 classifier's
# clip (B = 1, T = 16; the strided tile's whole-sequence branch at T = 16),
# and the consumers' model routes on the card against their CPU twins
# ---------------------------------------------------------------------------

# Rows 1 and 2's bf16 tier on unit rows and on offset rows (|x| ~ 4-16).
# Row 2's bf16 grid is one rounding of x1 + branch; on offset rows its ulp
# (2^-4 near 8) is a fifth of the branch's max, so a tie flipped by the f32
# sum's order reads rel_rms ~1.5e-2 against the branch (on the card), past
# REL_RMS_TOL though the kernel is sound. So the grid is held in two parts,
# as the per-phase tier's bf16 outputs: its rounding by
# twin_check.rounding_ulps, its branch through the f32 tier on the same
# (bf16-exact) CLS row, which differs from the bf16 tier only in writing
# the grid in f32. On unit rows the bf16 grid is also held on its branch.
@pytest.mark.parametrize("rows", ["unit", "offset"])
@pytest.mark.parametrize("B,T,N,D,H", [(8, 8, 196, 768, 12), (3, 8, 16, 128, 2)])
def test_windowed_pair_at_the_probe_batch(cuda_device, B, T, N, D, H, rows):
    blk = _block(D, H, 0, cuda_device)
    if rows == "offset":
        x, x1 = _offset((B, T, N, D), 81, cuda_device), _offset((B, T, N, D), 82, cuda_device)
        cls = _offset((B, 1, D), 83, cuda_device)
    else:
        r = np.random.RandomState(81)
        x, x1, cls = (torch.from_numpy(r.randn(*shape)).to(cuda_device, torch.float32)
                      for shape in ((B, T, N, D), (B, T, N, D), (B, 1, D)))
    x, cls = x.to(torch.bfloat16), cls.to(torch.bfloat16)
    _close(fb.temporal_phase_tm(x, blk["temporal"], H),
           fb.temporal_phase_tm_plain(x, blk["temporal"], H), x)
    grid, cls_rows = fb.spatial_mlp(x1, cls, blk["spatial"], H)
    want_grid, want_rows = fb.spatial_mlp_plain(x1, cls, blk["spatial"], H)
    ulps = twin_check.rounding_ulps(grid, want_grid, x1)
    assert ulps <= twin_check.ROUNDING_ULPS, ulps
    _close(cls_rows, want_rows)
    grid32 = fb.spatial_mlp(x1, cls.float(), blk["spatial"], H)[0]
    assert grid32.dtype == torch.float32
    _close(grid32, fb.spatial_mlp_plain(x1, cls.float(), blk["spatial"], H)[0], x1)
    if rows == "unit":
        _close(grid, want_grid, x1)


@pytest.mark.parametrize("B,T,N,D,H", [(1, 16, 196, 768, 12), (2, 16, 16, 128, 2)])
def test_f32_tiers_at_the_k400_clip_stay_f32(cuda_device, B, T, N, D, H):
    blk = _block(D, H, 0, cuda_device)
    x = _offset((B, T, N, D), 84, cuda_device)
    x1, cls = _offset((B, T, N, D), 85, cuda_device), _offset((B, 1, D), 86, cuda_device)
    out = fb.temporal_phase_tm(x, blk["temporal"], H)
    grid, rows = fb.spatial_mlp(x1, cls, blk["spatial"], H)
    torch.cuda.synchronize()
    for t in (out, grid, rows):
        _f32_ok(t)
    _close(out, fb.temporal_phase_tm_plain(x, blk["temporal"], H), x)
    want_grid, want_rows = fb.spatial_mlp_plain(x1, cls, blk["spatial"], H)
    _close(grid, want_grid, x1)
    _close(rows, want_rows)


@pytest.mark.parametrize("dtype,B,T", [(torch.bfloat16, 3, 8), (torch.float32, 1, 16)])
def test_eval_consumer_routes_match_twins(cuda_device, dtype, B, T):
    """The kNN features (bf16, B = 3 clips of 8 frames, tail batch 1) and
    the K400 classifier (the f32 model on bf16 pixels, one 16-frame clip)
    on the card against the same calls on the CPU (the twins)."""
    import dataclasses

    from dino_video_summarization_transformer_tpu_torch.engine import (
        classification, knn)

    cfg = tsf.TimeSformerConfig(img_size=64, patch_size=16, embed_dim=128, depth=2,
                                num_heads=2, num_frames=T, num_classes=5)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, 5), cfg)
    r = np.random.RandomState(6)
    sd["head.weight"] = (0.1 * r.randn(5, 128)).astype(np.float32)
    sd["head.bias"] = np.zeros(5, np.float32)
    assert tsf.eval_kernels(cfg, torch.bfloat16, cuda_device)
    kcfg = dataclasses.replace(cfg, use_kernels=True)
    gpu = tsf.build_timesformer(kcfg, sd, device=cuda_device, dtype=dtype)
    cpu = tsf.build_timesformer(kcfg, sd, device="cpu", dtype=dtype)
    if dtype == torch.bfloat16:
        class Clips:
            x = r.randn(B, 3, T, 64, 64).astype(np.float32)

            def __len__(self):
                return B

            def __getitem__(self, i):
                return self.x[i], i

        before = fb.launches["temporal_phase_tm"]
        got = knn.extract_features(gpu, Clips(), batch_size=2, num_workers=1, log_every=0)
        assert fb.launches["temporal_phase_tm"] == before + 2 * 2  # 2 batches x depth
        want = knn.extract_features(cpu, Clips(), batch_size=2, num_workers=1, log_every=0)
    else:
        pix = r.randn(B, T, 3, 64, 64).astype(np.float32)
        before = fb.launches["temporal_phase_tm_f32"]
        got = classification.make_classifier_fn(gpu, torch.bfloat16)(pix).cpu().numpy()
        assert fb.launches["temporal_phase_tm_f32"] == before + 2
        want = classification.make_classifier_fn(cpu, torch.bfloat16)(pix).numpy()
    _close(torch.from_numpy(got), torch.from_numpy(want))


def test_two_stream_kernel_route_matches_plain_bf16(cuda_device):
    """The two-stream step (``make_two_stream_train_step``) at batch 2 on
    the kernel route against its plain bf16 route, by phase 7's gradient
    rule (per parameter max|diff| / max|plain| < 0.15): the RGB backbones'
    training ops launch, the motion nets (plain on both routes) give the
    same gradients, and the three loss terms agree to the bf16 rule's
    spread."""
    from dino_video_summarization_transformer_tpu_torch.models.vit2d import ViT2DConfig
    from dino_video_summarization_transformer_tpu_torch.train import ssl

    cfg = tsf.TimeSformerConfig(img_size=32, patch_size=16, embed_dim=128, depth=2,
                                num_heads=2, num_frames=4, num_classes=0)
    mcfg = ViT2DConfig(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=2)
    r = np.random.RandomState(10)
    g, l, flow = (torch.from_numpy(r.randn(*s).astype(np.float32)).to(cuda_device)
                  for s in ((4, 3, 4, 32, 32), (8, 3, 4, 32, 32), (4, 3, 32, 32)))
    state, core, mask = ssl.init_two_stream_state(cfg, mcfg, out_dim=64, seed=11,
                                                  device=cuda_device)
    out = {}
    for route in ("kernels", "plain"):
        step = ssl.make_two_stream_train_step(cfg, mcfg, core, mask, n_local_crops=4,
                                              compute_dtype=torch.bfloat16, route=route)
        before = dict(fb.launches)
        loss, (_, terms), grads = step.loss_and_grads(state, g, l, flow, 0.04)
        torch.cuda.synchronize()
        out[route] = (loss, terms, grads, {k: fb.launches[k] - before[k] for k in fb.launches})
    (lk, tk, gk, nk), (lp, tp, gp, np_) = out["kernels"], out["plain"]
    for op in ("temporal_phase_tm_bf16", "spatial_phase", "mlp_phase",
               "temporal_phase_tm_bwd", "spatial_phase_bwd", "mlp_phase_bwd"):
        assert nk[op] > 0 and np_[op] == 0, op
    for n in gp:
        rel = float((gk[n] - gp[n]).abs().max() / (gp[n].abs().max() + 1e-12))
        assert rel < 0.15, (n, rel)
    for k in tp:
        assert abs(float(tk[k]) - float(tp[k])) <= 0.05 * abs(float(tp[k])), k


# Tier C, tensor parallelism's partial tier (rows 1p, 4p, 7p and 8p): one
# shard's heads (the head-major qkv rows, proj's input columns), no proj
# or fc bias, no residual, at (B, T, N, D, H, tp): ViT-B's global crops
# over two and four shards (Dq 384, 192), the crops a TP-fused step at
# batch 4 gives the kernels (8 global, N=196; 32 local of 96 px, N=36),
# ViT-S over two (Dq 192), a 64-wide shard (D 256 over four).
PARTIAL_SHAPES = [(2, 8, 196, 768, 12, 2), (2, 8, 196, 768, 12, 4),
                  (8, 8, 196, 768, 12, 4), (32, 8, 36, 768, 12, 2), (32, 8, 36, 768, 12, 4),
                  (2, 8, 196, 384, 6, 2), (1, 4, 16, 256, 4, 4)]


@pytest.mark.parametrize("B,T,N,D,H,tp", PARTIAL_SHAPES)
def test_partial_tier_kernels_match_twins(cuda_device, B, T, N, D, H, tp):
    from dino_video_summarization_transformer_tpu_torch.parallel.tp_fused import (
        qkv_head_perm)

    p = _block(D, H, 21, cuda_device)
    pt, ps = p["temporal"], p["spatial"]
    Dq, Hl = D // tp, H // tp
    rows = torch.as_tensor(qkv_head_perm(D, H, tp)[-3 * Dq:], device=cuda_device)
    wt = {"ln_w": pt["ln_w"], "ln_b": pt["ln_b"], "qkv_w": pt["qkv_w"][rows].contiguous(),
          "qkv_b": pt["qkv_b"][rows].contiguous(),
          "proj_w": pt["proj_w"][:, -Dq:].contiguous(), "fc_w": pt["fc_w"]}
    ws = {"ln1_w": ps["ln1_w"], "ln1_b": ps["ln1_b"], "qkv_w": ps["qkv_w"][rows].contiguous(),
          "qkv_b": ps["qkv_b"][rows].contiguous(), "proj_w": ps["proj_w"][:, -Dq:].contiguous()}
    r = np.random.RandomState(B * T * N + tp)

    def rnd(*shape):
        return torch.from_numpy(r.randn(*shape).astype(np.float32)).to(cuda_device,
                                                                       torch.bfloat16)

    x, cls, dout, dco = rnd(B, T, N, D), rnd(B, 1, D), rnd(B, T, N, D), rnd(B, T, D)
    before = dict(fb.launches)
    got = fb.temporal_phase_tm(x, wt, Hl, partial_out=True)
    _close(got, fb.temporal_phase_tm_partial_plain(x, wt, Hl))
    g, c = fb.spatial_phase(x, cls, ws, Hl, partial_out=True)
    want = fb.spatial_phase_partial_plain(x, cls, ws, Hl)
    _close(g, want[0])
    _close(c, want[1])
    dx, grads = fb.temporal_phase_tm_bwd(x, dout, wt, Hl, partial_out=True)
    wdx, wgrads = fb.temporal_phase_tm_partial_bwd_plain(x, dout, wt, Hl)
    _close(dx, wdx)
    for k in fb.TEMPORAL_PARTIAL_KEYS:
        _close(grads[k], wgrads[k])
    dx, dcls, grads = fb.spatial_phase_bwd(x, cls, dout, dco, ws, Hl, partial_out=True)
    wdx, wdcls, wgrads = fb.spatial_phase_partial_bwd_plain(x, cls, dout, dco, ws, Hl)
    _close(dx, wdx)
    _close(dcls, wdcls)
    for k in fb.SPATIAL_PARTIAL_KEYS:
        _close(grads[k], wgrads[k])
    torch.cuda.synchronize()
    for op in ("temporal_phase_tm_partial", "spatial_phase_partial",
               "temporal_phase_tm_bwd_partial", "spatial_phase_bwd_partial"):
        assert fb.launches[op] == before[op] + 1, op
