"""The whole-block divided space-time kernel pair, for Hopper, with plain twins.

Counterpart of the JAX package's ``ops/fused_block.py`` whole-block path
(``fused_divided_block_wb``): a divided block as two ops,

* ``temporal_phase_tm``: x (B, T, N, D) bf16, frame-major ->
  x + temporal_fc(proj(MHSA over T at each position(LN x))), f32 out —
  replaces ``_temporal_phase_tm_kernel`` (fused_block.py:761);
* ``spatial_mlp``: the f32 carry x1 and the bf16 CLS row ->
  per frame on [cls, x_t]: LN -> MHSA -> proj -> grid residual -> LN ->
  MLP -> residual, bf16 grid out, plus the raw per-frame CLS rows in f32 —
  replaces ``_spatial_mlp_kernel`` (fused_block.py:1556);

and ``divided_block_wb``, which chains them and updates the CLS row in
plain f32 torch (B rows: negligible), as the JAX package does.

Each op's wrapper runs its Hopper kernels (``csrc/fused_block.cu``) on a
CUDA tensor and its plain twin (``*_plain``) on a CPU tensor; it raises on
any other device and never falls back. ``launches`` counts the kernel
launches of each wrapper.

Numerics, shared by kernel and twin (the XLA-path rules, not the Pallas
kernels' TPU workarounds): LayerNorm in f32 (eps 1e-6), bf16 matmul
operands with f32 accumulation, qkv rounded to bf16 after the bias,
softmax in f32 with the row max subtracted, probabilities rounded to bf16
before the PV product, exact erf GELU, f32 intra-block carry, bf16 block
boundaries. The Pallas kernels instead clamp logits to +/-80 without the
max, sum the denominator on the MXU through a ones column and use tanh
GELU; the tests bound the resulting gap.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
SMEM_LIMIT = 232448  # dynamic shared memory a block may opt into on sm_90

# Kernel launches per op wrapper (plain twins do not count).
launches: Dict[str, int] = {"temporal_phase_tm": 0, "spatial_mlp": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


TEMPORAL_KEYS = ("ln_w", "ln_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
                 "fc_w", "fc_b")
SPATIAL_KEYS = ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
                "ln2_w", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def block_params(block) -> dict:
    """Kernel-layout weights of one ``models.timesformer.Block``: bf16
    (out, in) matrices and f32 vectors, for both ops."""
    def mat(lin):
        return lin.weight.detach().to(torch.bfloat16).contiguous()

    def vec(t):
        return t.detach().float().contiguous()

    def bias(lin):
        if lin.bias is None:
            return torch.zeros(lin.out_features, dtype=torch.float32,
                               device=lin.weight.device)
        return vec(lin.bias)

    ta, sa = block.temporal_attn, block.attn
    return {
        "temporal": {
            "ln_w": vec(block.temporal_norm1.weight),
            "ln_b": vec(block.temporal_norm1.bias),
            "qkv_w": mat(ta.qkv), "qkv_b": bias(ta.qkv),
            "proj_w": mat(ta.proj), "proj_b": bias(ta.proj),
            "fc_w": mat(block.temporal_fc), "fc_b": bias(block.temporal_fc),
        },
        "spatial": {
            "ln1_w": vec(block.norm1.weight), "ln1_b": vec(block.norm1.bias),
            "qkv_w": mat(sa.qkv), "qkv_b": bias(sa.qkv),
            "proj_w": mat(sa.proj), "proj_b": bias(sa.proj),
            "ln2_w": vec(block.norm2.weight), "ln2_b": vec(block.norm2.bias),
            "fc1_w": mat(block.mlp.fc1), "fc1_b": bias(block.mlp.fc1),
            "fc2_w": mat(block.mlp.fc2), "fc2_b": bias(block.mlp.fc2),
        },
    }


# ---------------------------------------------------------------------------
# Plain twins (the kernels' arithmetic in torch)
# ---------------------------------------------------------------------------

def _ln(xf: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 LayerNorm of f32 rows (biased variance)."""
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + LN_EPS) * w + b


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 accumulation: a (..., K) @ w (N, K)^T -> f32."""
    return torch.matmul(a.float(), w.float().t())


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v (..., L, hd) bf16 -> (..., L, hd) bf16: f32 scores, row max
    subtracted, probabilities rounded to bf16 for PV, f32 denominator."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e.to(torch.bfloat16).float()
    o = torch.matmul(p, v.float()) / e.sum(dim=-1, keepdim=True)
    return o.to(torch.bfloat16)


def temporal_phase_tm_plain(x: torch.Tensor, p: dict, num_heads: int) -> torch.Tensor:
    """Plain twin of ``temporal_phase_tm``."""
    B, T, N, D = x.shape
    H = num_heads
    hd = D // H
    xf = x.float()
    y = _ln(xf, p["ln_w"], p["ln_b"]).to(torch.bfloat16)
    qkv = (_mm(y, p["qkv_w"]) + p["qkv_b"]).to(torch.bfloat16)
    # (B, T, N, 3, H, hd) -> (3, B, N, H, T, hd): sequences over T per position
    q, k, v = qkv.reshape(B, T, N, 3, H, hd).permute(3, 0, 2, 4, 1, 5).unbind(0)
    a = _attention(q, k, v).permute(0, 3, 1, 2, 4).reshape(B, T, N, D)
    proj = (_mm(a, p["proj_w"]) + p["proj_b"]).to(torch.bfloat16)
    return xf + (_mm(proj, p["fc_w"]) + p["fc_b"])


def spatial_mlp_plain(x1: torch.Tensor, cls: torch.Tensor, p: dict,
                      num_heads: int):
    """Plain twin of ``spatial_mlp``."""
    B, T, N, D = x1.shape
    H = num_heads
    hd = D // H
    L = N + 1
    seq = torch.cat([cls.float().reshape(B, 1, 1, D).expand(B, T, 1, D), x1],
                    dim=2)  # (B, T, L, D) f32
    y = _ln(seq, p["ln1_w"], p["ln1_b"]).to(torch.bfloat16)
    qkv = (_mm(y, p["qkv_w"]) + p["qkv_b"]).to(torch.bfloat16)
    q, k, v = qkv.reshape(B, T, L, 3, H, hd).permute(3, 0, 1, 4, 2, 5).unbind(0)
    a = _attention(q, k, v).transpose(2, 3).reshape(B, T, L, D)
    res = _mm(a, p["proj_w"]) + p["proj_b"]
    cls_rows = res[:, :, 0, :]
    x2 = x1 + res[:, :, 1:, :]
    y2 = _ln(x2, p["ln2_w"], p["ln2_b"]).to(torch.bfloat16)
    h = F.gelu(_mm(y2, p["fc1_w"]) + p["fc1_b"]).to(torch.bfloat16)
    out = x2 + (_mm(h, p["fc2_w"]) + p["fc2_b"])
    return out.to(torch.bfloat16), cls_rows.contiguous()


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check_tensor(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _attn_smem(L: int, hd: int) -> int:
    """Shared bytes of the attention kernel: Q, K (row padded by one bf16
    pair), V in bf16 and one f32 score row per warp (csrc: attn_kernel)."""
    warps = max(1, min(8, L))
    return L * (3 * hd + 2) * 2 + warps * L * 4


def _check_geometry(D: int, num_heads: int, L: int, Dh: int = 0) -> None:
    if num_heads <= 0 or D % num_heads:
        raise ValueError(f"D={D} is not divisible by num_heads={num_heads}")
    hd = D // num_heads
    if hd % 16 or hd > 128:
        raise ValueError(f"head dim {hd}: the kernels need hd % 16 == 0 "
                         "and hd <= 128")
    if D % 128 or D > 1024 or Dh % 128:
        raise ValueError(f"D={D}, MLP width {Dh}: the kernels need "
                         "multiples of 128 and D <= 1024")
    if _attn_smem(L, hd) > SMEM_LIMIT:
        raise ValueError(f"sequence length {L} at head dim {hd} needs "
                         f"{_attn_smem(L, hd)} B of shared memory "
                         f"(limit {SMEM_LIMIT})")


def _device_of(x: torch.Tensor) -> torch.device:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device


def _run(fn, *args) -> None:
    from . import _build

    err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel launch failed ({err}): {_build.error_string(err)}")


def temporal_phase_tm(x: torch.Tensor, p: dict, num_heads: int) -> torch.Tensor:
    """x (B, T, N, D) bf16 frame-major -> x + temporal_fc(proj(MHSA over T
    (LN x))) as (B, T, N, D) f32. Kernel on CUDA, plain twin on CPU."""
    if x.dim() != 4:
        raise ValueError(f"x: expected (B, T, N, D), got {tuple(x.shape)}")
    B, T, N, D = x.shape
    dev = _device_of(x)
    _check_geometry(D, num_heads, T)
    _check_tensor("x", x, torch.bfloat16, x.shape, dev)
    shapes = {"ln_w": (D,), "ln_b": (D,), "qkv_w": (3 * D, D), "qkv_b": (3 * D,),
              "proj_w": (D, D), "proj_b": (D,), "fc_w": (D, D), "fc_b": (D,)}
    for k in TEMPORAL_KEYS:
        _check_tensor(k, p[k], torch.bfloat16 if k.endswith("_w") and k != "ln_w"
                      else torch.float32, shapes[k], dev)
    if dev.type == "cpu":
        return temporal_phase_tm_plain(x, p, num_heads)

    from . import _build

    lib = _build.load()
    M = B * T * N
    out = torch.empty((B, T, N, D), dtype=torch.float32, device=dev)
    # Scratch is freed on return while the kernels may still run: the
    # caching allocator hands it out again only to later work on this
    # stream, which is the stream the kernels run on.
    ws = torch.empty(M * 5 * D, dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        _run(lib.dvst_temporal_phase_tm, x.data_ptr(),
             *(p[k].data_ptr() for k in TEMPORAL_KEYS), ws.data_ptr(),
             out.data_ptr(), B, T, N, D, num_heads,
             torch.cuda.current_stream(dev).cuda_stream)
    launches["temporal_phase_tm"] += 1
    return out


def spatial_mlp(x1: torch.Tensor, cls: torch.Tensor, p: dict, num_heads: int):
    """x1 (B, T, N, D) f32 carry, cls (B, 1, D) bf16 -> (grid (B, T, N, D)
    bf16, per-frame CLS rows (B, T, D) f32). Kernel on CUDA, plain twin on
    CPU."""
    if x1.dim() != 4:
        raise ValueError(f"x1: expected (B, T, N, D), got {tuple(x1.shape)}")
    B, T, N, D = x1.shape
    Dh = p["fc1_w"].shape[0]
    dev = _device_of(x1)
    _check_geometry(D, num_heads, N + 1, Dh)
    _check_tensor("x1", x1, torch.float32, x1.shape, dev)
    _check_tensor("cls", cls, torch.bfloat16, (B, 1, D), dev)
    shapes = {"ln1_w": (D,), "ln1_b": (D,), "qkv_w": (3 * D, D),
              "qkv_b": (3 * D,), "proj_w": (D, D), "proj_b": (D,),
              "ln2_w": (D,), "ln2_b": (D,), "fc1_w": (Dh, D), "fc1_b": (Dh,),
              "fc2_w": (D, Dh), "fc2_b": (D,)}
    for k in SPATIAL_KEYS:
        _check_tensor(k, p[k], torch.bfloat16 if k in ("qkv_w", "proj_w", "fc1_w", "fc2_w")
                      else torch.float32, shapes[k], dev)
    if dev.type == "cpu":
        return spatial_mlp_plain(x1, cls, p, num_heads)

    from . import _build

    lib = _build.load()
    M = B * T * N
    out = torch.empty((B, T, N, D), dtype=torch.bfloat16, device=dev)
    cls_rows = torch.empty((B, T, D), dtype=torch.float32, device=dev)
    ws = torch.empty(M * (5 * D + Dh) + B * 4 * D + B * T * D,
                     dtype=torch.bfloat16, device=dev)
    x2 = torch.empty((M, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _run(lib.dvst_spatial_mlp, x1.data_ptr(), cls.data_ptr(),
             *(p[k].data_ptr() for k in SPATIAL_KEYS), ws.data_ptr(),
             x2.data_ptr(), out.data_ptr(), cls_rows.data_ptr(),
             B, T, N, D, num_heads, Dh,
             torch.cuda.current_stream(dev).cuda_stream)
    launches["spatial_mlp"] += 1
    return out, cls_rows


def divided_block_wb(p: dict, cls: torch.Tensor, grid: torch.Tensor,
                     num_heads: int):
    """Whole divided block: cls (B, 1, D) bf16, grid (B, T, N, D) bf16 ->
    (cls, grid) bf16, with the f32 intra-block carry between the two ops
    and the CLS row updated in plain f32 torch (erf GELU)."""
    x1 = temporal_phase_tm(grid, p["temporal"], num_heads)
    grid_out, cls_frames = spatial_mlp(x1, cls, p["spatial"], num_heads)
    s = p["spatial"]
    clsf = cls.float() + cls_frames.mean(dim=1, keepdim=True)
    yn = _ln(clsf, s["ln2_w"], s["ln2_b"])
    h = F.gelu(_mm(yn.to(torch.bfloat16), s["fc1_w"]) + s["fc1_b"])
    mo = _mm(h.to(torch.bfloat16), s["fc2_w"])
    clsf = clsf + mo + s["fc2_b"]
    return clsf.to(cls.dtype), grid_out
