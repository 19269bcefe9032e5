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
temporal op's out - x, the spatial grid's out - x1 and the CLS rows, at
rms(err) <= 1e-2 x rms(branch), f32 max|err| <= 2e-2 x max|branch|, and
the bf16 grid within 4 bf16 ulps of max(|want|, rms(branch)) at every
element.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dino_video_summarization_transformer_tpu_torch.models import (  # noqa: E402
    convert, timesformer as tsf)
from dino_video_summarization_transformer_tpu_torch.ops import (  # noqa: E402
    fused_block as fb, twin_check)
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
    with pytest.raises(TypeError):
        fb.temporal_phase_tm(x, p, 2)  # f32 in: the kernel takes bf16
    with pytest.raises(ValueError):
        fb.temporal_phase_tm(x.to(torch.bfloat16), p, 3)  # 128 % 3
