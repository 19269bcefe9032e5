"""The banded one-pass scoring kernels, for Hopper, with plain twins.

Counterpart of the JAX package's ``ops/banded_block.py``. A banded pass
runs one forward over a chunk of C frames in which frame i attends in time
only to its clamp-shifted window [lo_i, lo_i + eff) (``band_starts``) and
owns a CLS row of its own (``models/banded.py``). Three ops:

* ``banded_temporal_attn``: qkv (C, N, 3D) bf16 -> (C, N, D) bf16, each
  frame's queries against its window's keys at the same position —
  replaces ``_banded_temporal_kernel`` (banded_block.py:43);
* ``spatial_phase_pf``: per frame on [cls_i, x_i]: LN -> qkv -> MHSA ->
  proj -> grid residual, in the rows' dtype (bf16, or f32 for the mixed
  teacher's f32 carry); returns the new grid and the two bf16 qkv
  buffers (grid rows, CLS rows), whose K/V and CLS-query columns are the
  TPU kernel's exports — replaces ``_spatial_pf_kernel`` (:174); its
  products run on the wgmma GEMM and its attention on the tensor-core
  tile, as ``fused_block.spatial_mlp``'s;
* ``cls_band_attn``: for each frame i, the mean over t in its window of
  softmax(q_cls_i . [k_cls_i, K_t]) [v_cls_i; V_t], one softmax per (i, t)
  pair, read straight from those qkv buffers — replaces ``_cls_band_kernel``
  (:291);

and ``banded_temporal_phase``, the temporal half around the first: LN, the
qkv, proj and temporal_fc products stay plain torch (the JAX package leaves
them to XLA outside its kernel), in the rows' dtype. The two attentions
take bf16 operands and return bf16 in every tier, as JAX's do.
``cls_band_attn_f32_plain`` is the CLS aggregation with f32 probabilities,
against which the card and the CPU tests measure row 12's bf16 roundings.

Each wrapper runs its Hopper kernel (``csrc/banded_block.cu``) on a CUDA
tensor and its plain twin (``*_plain``) on a CPU tensor; it raises on any
other device and never falls back. ``launches`` counts kernel launches.

Numerics, shared by kernel and twin: f32 scores with the row max
subtracted, f32 denominators, probabilities rounded to bf16 before the PV
product, bf16 outputs; the spatial op as ``fused_block``'s (f32 LN, qkv
rounded to bf16 after the bias) with the projection rounded to bf16 before
the bf16 residual add, as the Pallas kernel rounds it (its f32 tier adds
it unrounded). The Pallas kernels'
+/-80 logit clamp without the max and ones-column denominators are TPU
workarounds; the tests bound the gap.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from . import fused_block as fb

# Kernel launches per op wrapper (plain twins do not count).
launches: Dict[str, int] = {"banded_temporal_attn": 0, "spatial_phase_pf": 0,
                            "spatial_phase_pf_f32": 0, "cls_band_attn": 0}

PF_KEYS = ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b")
# the CLS-band kernel's blocks (csrc: kClsStrips, kClsKeyRuns): at most
# four strips of 16 query frames, each on four warps
CLS_STRIPS = 4
CLS_KEY_RUNS = 4


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def band_starts(idx: torch.Tensor, eff: int, t_real: int) -> torch.Tensor:
    """Per-frame window start ``lo_i`` — clamp for clamp the arithmetic of
    ``data/windows.window_indices`` (windows shift at the edges and never
    shrink): window(i) = [lo_i, lo_i + eff)."""
    return torch.clamp(idx - eff // 2, 0, max(int(t_real) - eff, 0))


def _cls_smem(N: int, hd: int, qs: int, ks: int) -> int:
    """Shared bytes of a CLS-band block of qs strips on ks warps each
    (csrc: cls_smem): a zero row; the tile's queries, own keys and own
    values; the strips' max and sum exchange; two frame stages of K and V,
    which later hold the warps' f32 sums."""
    return (16 + 96 * qs * hd + 128 * qs * ks
            + max(8 * N * hd, 64 * ks * qs * hd))


def cls_band_smem(N: int, hd: int, lib=None) -> int:
    """Shared bytes one block of the CLS-band kernel needs at least (one
    strip) at N patches a frame and head dim hd: ``lib``'s
    ``dvst_cls_band_smem`` where given, else its mirror here, so that the
    plain twin on the CPU refuses what the kernel refuses (a card test holds
    the two equal)."""
    if lib is not None:
        return lib.dvst_cls_band_smem(N, hd)
    return _cls_smem(N, hd, 1, CLS_KEY_RUNS)


def _check_cls_band_smem(N: int, hd: int, lib=None) -> None:
    need = cls_band_smem(N, hd, lib)
    if need > fb.SMEM_LIMIT:
        raise ValueError(f"{N} patches at head dim {hd} need {need} B of shared "
                         f"memory (limit {fb.SMEM_LIMIT})")


def banded_problems(D: int, num_heads: int, N: int, Dh: int) -> List[str]:
    """What keeps the banded kernels from a model geometry; empty when they
    take it. The spatial attention's shared memory is not among them:
    ``spatial_phase_pf`` reads it from the library on the card and raises
    there."""
    bad = []
    if num_heads <= 0 or D % num_heads:
        return [f"D={D} is not divisible by num_heads={num_heads}"]
    hd = D // num_heads
    if hd % 16 or hd > 128:
        bad.append(f"head dim {hd}: the kernels need hd % 16 == 0 and hd <= 128")
    if D % 128 or D > 1024 or Dh % 128:
        bad.append(f"D={D}, MLP width {Dh}: the kernels need multiples of 128 "
                   "and D <= 1024")
    need = cls_band_smem(N, hd)
    if need > fb.SMEM_LIMIT:
        bad.append(f"CLS window aggregation over {N} patches at head dim {hd} "
                   f"needs {need} B of shared memory (limit {fb.SMEM_LIMIT})")
    return bad


def banded_ok(D: int, num_heads: int, N: int, Dh: int) -> bool:
    """Shape gate of the banded kernel route (the port's own limits: the
    GEMM tiles, the LN row width, shared memory)."""
    return not banded_problems(D, num_heads, N, Dh)


def _check_band(C: int, t_real: int, eff: int) -> None:
    if not 1 <= eff <= C:
        raise ValueError(f"window {eff} must lie in [1, C={C}]")
    if not 1 <= t_real <= C:
        raise ValueError(f"t_real={t_real} must lie in [1, C={C}]")


def _split_heads(t: torch.Tensor, H: int) -> torch.Tensor:
    return t.reshape(*t.shape[:-1], H, t.shape[-1] // H)


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def banded_temporal_attn_plain(qkv: torch.Tensor, t_real: int, eff: int,
                               num_heads: int, block: int = 32) -> torch.Tensor:
    """Plain twin of ``banded_temporal_attn``: blocks of ``block`` query
    frames against the keys their windows cover, masked to each window."""
    C, N, D3 = qkv.shape
    D = D3 // 3
    q, k, v = (_split_heads(qkv[..., i * D:(i + 1) * D], num_heads).permute(
        1, 2, 0, 3).float() for i in range(3))  # (N, H, C, hd)
    scale = (D // num_heads) ** -0.5
    lo = band_starts(torch.arange(C, device=qkv.device), eff, t_real)
    out = torch.empty((N, num_heads, C, D // num_heads), dtype=torch.float32,
                      device=qkv.device)
    for i0 in range(0, C, block):
        i1 = min(C, i0 + block)
        k0, k1 = int(lo[i0]), int(lo[i1 - 1]) + eff
        kj = torch.arange(k0, k1, device=qkv.device)
        lo_b = lo[i0:i1, None]
        inband = (kj >= lo_b) & (kj < lo_b + eff)  # (P, S)
        s = torch.matmul(q[:, :, i0:i1], k[:, :, k0:k1].transpose(-2, -1)) * scale
        s = s.masked_fill(~inband, float("-inf"))
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e.to(torch.bfloat16).float()
        out[:, :, i0:i1] = torch.matmul(p, v[:, :, k0:k1]) / e.sum(-1, keepdim=True)
    return out.to(torch.bfloat16).permute(2, 0, 1, 3).reshape(C, N, D)


def spatial_phase_pf_plain(x: torch.Tensor, cls: torch.Tensor, p: dict,
                           num_heads: int):
    """Plain twin of ``spatial_phase_pf`` (both tiers: the projection in
    x's dtype, added in f32, the sum in x's dtype)."""
    C, N, D = x.shape
    xf = x.float()
    y = fb._ln(xf, p["ln1_w"], p["ln1_b"]).to(torch.bfloat16)
    y_c = fb._ln(cls.float(), p["ln1_w"], p["ln1_b"]).to(torch.bfloat16)
    qkv = (fb._mm(y, p["qkv_w"]) + p["qkv_b"]).to(torch.bfloat16)
    qkv_cls = (fb._mm(y_c, p["qkv_w"]) + p["qkv_b"]).to(torch.bfloat16)
    seq = torch.cat([qkv_cls[:, None], qkv], dim=1)  # (C, 1 + N, 3D)
    q, k, v = seq.reshape(C, N + 1, 3, num_heads, D // num_heads).permute(
        2, 0, 3, 1, 4).unbind(0)  # (C, H, 1 + N, hd)
    a = fb._attention(q, k, v)[:, :, 1:].transpose(1, 2).reshape(C, N, D)
    proj = (fb._mm(a, p["proj_w"]) + p["proj_b"]).to(x.dtype)
    return (xf + proj.float()).to(x.dtype), qkv, qkv_cls


def cls_band_attn_plain(qkv_cls: torch.Tensor, qkv: torch.Tensor, t_real: int,
                        eff: int, num_heads: int) -> torch.Tensor:
    """Plain twin of ``cls_band_attn``: for each window offset j, every
    frame i against frame lo_i + j, normalised per pair, then the mean."""
    C, N, D3 = qkv.shape
    D = D3 // 3
    H = num_heads
    q = _split_heads(qkv_cls[:, :D], H).float()          # (C, H, hd)
    k_self = _split_heads(qkv_cls[:, D:2 * D], H).float()
    v_self = _split_heads(qkv_cls[:, 2 * D:], H)
    k_pat = _split_heads(qkv[..., D:2 * D], H)            # (C, N, H, hd)
    v_pat = _split_heads(qkv[..., 2 * D:], H)
    scale = (D // H) ** -0.5
    lo = band_starts(torch.arange(C, device=qkv.device), eff, t_real)
    s_self = (q * k_self).sum(-1, keepdim=True) * scale  # (C, H, 1)
    acc = torch.zeros_like(q)
    for j in range(eff):
        t = lo + j
        s = torch.einsum("chd,cnhd->chn", q, k_pat[t].float()) * scale
        s = torch.cat([s_self, s], dim=-1)                # (C, H, 1 + N)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e.to(torch.bfloat16).float()
        vals = torch.cat([v_self[:, None], v_pat[t]], dim=1).float()
        acc += (torch.einsum("chn,cnhd->chd", p, vals)
                / e.sum(-1, keepdim=True))
    return (acc * (1.0 / eff)).reshape(C, D).to(torch.bfloat16)


def cls_band_attn_f32_plain(qkv_cls: torch.Tensor, qkv: torch.Tensor, t_real: int,
                            eff: int, num_heads: int) -> torch.Tensor:
    """``cls_band_attn``'s function with f32 probabilities and an f32
    output: the reference against which the kernel's and the twin's bf16
    rounding of P (and of the output) are measured; no op runs it."""
    C, N, D3 = qkv.shape
    H = num_heads
    D = D3 // 3
    q = _split_heads(qkv_cls[:, :D], H).float()
    k_self = _split_heads(qkv_cls[:, D:2 * D], H).float()
    v_self = _split_heads(qkv_cls[:, 2 * D:], H).float()
    k_pat = _split_heads(qkv[..., D:2 * D], H)
    v_pat = _split_heads(qkv[..., 2 * D:], H)
    scale = (D // H) ** -0.5
    lo = band_starts(torch.arange(C, device=qkv.device), eff, t_real)
    s_self = (q * k_self).sum(-1, keepdim=True) * scale
    acc = torch.zeros_like(q)
    for j in range(eff):
        t = lo + j
        s = torch.cat([s_self, torch.einsum("chd,cnhd->chn", q, k_pat[t].float()) * scale],
                      dim=-1)
        pr = torch.softmax(s, dim=-1)
        acc += torch.einsum("chn,cnhd->chd", pr,
                            torch.cat([v_self[:, None], v_pat[t].float()], dim=1))
    return (acc / eff).reshape(C, D)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def banded_temporal_attn(qkv: torch.Tensor, t_real: int, eff: int,
                         num_heads: int) -> torch.Tensor:
    """qkv (C, N, 3D) bf16, frame-major -> (C, N, D) bf16 pre-projection
    attention outputs, frame i's queries against its window's keys at the
    same position. Kernel on CUDA, plain twin on CPU."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv: expected (C, N, 3D), got {tuple(qkv.shape)}")
    C, N, D3 = qkv.shape
    D = D3 // 3
    dev = fb._device_of(qkv)
    fb._check_geometry(D, num_heads)
    fb._check_tensor("qkv", qkv, torch.bfloat16, qkv.shape, dev)
    _check_band(C, t_real, eff)
    if dev.type == "cpu":
        return banded_temporal_attn_plain(qkv, t_real, eff, num_heads)

    from . import _build

    fb._check_aligned(qkv=qkv)
    lib = _build.load("banded")
    need = lib.dvst_banded_temporal_attn_smem(D, num_heads, eff)
    if need > fb.SMEM_LIMIT:
        raise ValueError(f"a {eff}-frame window at head dim {D // num_heads} "
                         f"needs {need} B of shared memory (limit "
                         f"{fb.SMEM_LIMIT})")
    out = torch.empty((C, N, D), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        fb._run(lib.dvst_banded_temporal_attn, qkv.data_ptr(), out.data_ptr(),
                C, N, D, num_heads, int(t_real), eff,
                torch.cuda.current_stream(dev).cuda_stream)
    launches["banded_temporal_attn"] += 1
    return out


def spatial_phase_pf_ws(C: int, N: int, D: int, lib=None) -> int:
    """Workspace bytes of ``spatial_phase_pf`` (both tiers): ``lib``'s
    ``dvst_spatial_pf_ws`` where given, else its mirror here
    (banded_block.cu's spatial_pf_ws: the grid rows' LN rows, the CLS rows'
    LN rows, the grid rows' attention output, all bf16; the f32 tier stages
    nothing in f32). A card test holds the two equal."""
    if lib is not None:
        return lib.dvst_spatial_pf_ws(C, N, D)
    return fb._carve(C * N * D * 2, C * D * 2, C * N * D * 2)


def spatial_phase_pf(x: torch.Tensor, cls: torch.Tensor, p: dict,
                     num_heads: int):
    """x (C, N, D) grid, cls (C, D) per-frame CLS rows, both bf16 or (the
    mixed teacher's tier) both f32, ``p`` the ``PF_KEYS`` weights of
    ``fused_block.block_params(...)["spatial"]`` -> (x + proj(MHSA over
    [cls_i, x_i]) (C, N, D) in x's dtype, the grid rows' qkv (C, N, 3D)
    bf16, the CLS rows' qkv (C, 3D) bf16). bf16 rounds the projection
    before the add; f32 reads the rows unrounded into LN and adds the
    projection in f32. Kernel on CUDA, plain twin on CPU."""
    if x.dim() != 3:
        raise ValueError(f"x: expected (C, N, D), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x: dtype {x.dtype}, expected bfloat16 or float32")
    C, N, D = x.shape
    dev = fb._device_of(x)
    fb._check_geometry(D, num_heads)
    fb._check_tensor("x", x, x.dtype, x.shape, dev)
    fb._check_tensor("cls", cls, x.dtype, (C, D), dev)
    shapes = {"ln1_w": (D,), "ln1_b": (D,), "qkv_w": (3 * D, D),
              "qkv_b": (3 * D,), "proj_w": (D, D), "proj_b": (D,)}
    for k in PF_KEYS:
        fb._check_tensor(k, p[k], torch.bfloat16 if k in ("qkv_w", "proj_w")
                         else torch.float32, shapes[k], dev)
    if dev.type == "cpu":
        return spatial_phase_pf_plain(x, cls, p, num_heads)

    from . import _build

    fb._check_aligned(x=x, qkv_w=p["qkv_w"], proj_w=p["proj_w"])
    lib = _build.load("banded")
    fb.check_spatial_attn_smem(lib, N + 1, D // num_heads)
    out = torch.empty((C, N, D), dtype=x.dtype, device=dev)
    qkv = torch.empty((C, N, 3 * D), dtype=torch.bfloat16, device=dev)
    qkv_cls = torch.empty((C, 3 * D), dtype=torch.bfloat16, device=dev)
    ws = fb._ws(spatial_phase_pf_ws(C, N, D, lib), dev)
    x_f32 = x.dtype == torch.float32
    with torch.cuda.device(dev):
        fb._run(lib.dvst_spatial_pf, x.data_ptr(), cls.data_ptr(),
                *(p[k].data_ptr() for k in PF_KEYS), ws.data_ptr(),
                out.data_ptr(), qkv.data_ptr(), qkv_cls.data_ptr(),
                C, N, D, num_heads, int(x_f32),
                torch.cuda.current_stream(dev).cuda_stream)
    launches["spatial_phase_pf_f32" if x_f32 else "spatial_phase_pf"] += 1
    return out, qkv, qkv_cls


def cls_band_attn(qkv_cls: torch.Tensor, qkv: torch.Tensor, t_real: int,
                  eff: int, num_heads: int) -> torch.Tensor:
    """qkv_cls (C, 3D), qkv (C, N, 3D) bf16 (``spatial_phase_pf``'s) ->
    (C, D) bf16 pre-projection CLS outputs, each frame's averaged over its
    window. Kernel on CUDA (in the block shape the library picks for the
    card), plain twin on CPU."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv: expected (C, N, 3D), got {tuple(qkv.shape)}")
    C, N, D3 = qkv.shape
    D = D3 // 3
    dev = fb._device_of(qkv)
    fb._check_geometry(D, num_heads)
    fb._check_tensor("qkv", qkv, torch.bfloat16, qkv.shape, dev)
    fb._check_tensor("qkv_cls", qkv_cls, torch.bfloat16, (C, D3), dev)
    _check_band(C, t_real, eff)
    if dev.type == "cpu":
        _check_cls_band_smem(N, D // num_heads)
        return cls_band_attn_plain(qkv_cls, qkv, t_real, eff, num_heads)

    from . import _build

    fb._check_aligned(qkv=qkv, qkv_cls=qkv_cls)
    lib = _build.load("banded")
    _check_cls_band_smem(N, D // num_heads, lib)
    out = torch.empty((C, D), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        ws = fb._ws(lib.dvst_cls_band_attn_ws(C, N, D, num_heads, eff), dev)
        fb._run(lib.dvst_cls_band_attn, qkv_cls.data_ptr(), qkv.data_ptr(),
                out.data_ptr(), ws.data_ptr(), C, N, D, num_heads, int(t_real),
                eff, torch.cuda.current_stream(dev).cuda_stream)
    launches["cls_band_attn"] += 1
    return out


def _linear(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A dense layer in the activations' dtype (XLA's ``linear``)."""
    return F.linear(a, w.to(a.dtype), b.to(a.dtype))


def banded_temporal_phase(x: torch.Tensor, p: dict, t_real: int, eff: int,
                          num_heads: int) -> torch.Tensor:
    """x + temporal_fc(proj(banded_attn(LN x))) for x (C, N, D) bf16 or
    (the mixed teacher's tier) f32, ``p`` the ``fused_block.TEMPORAL_KEYS``
    weights in the block's own dtype (``models/banded.py`` passes the
    module's: the f32 tier's dense layers take the f32 weights, as JAX's
    ``linear`` on the f32 parameters): the attention is
    ``banded_temporal_attn`` on bf16 operands, returning bf16, which the
    caller casts, as JAX does (JAX ``ops/banded_block.py:136-137,158``); LN
    (f32 statistics) and the dense layers are plain torch in x's dtype."""
    y = fb._ln(x.float(), p["ln_w"], p["ln_b"]).to(x.dtype)
    qkv = _linear(y, p["qkv_w"], p["qkv_b"])
    o = banded_temporal_attn(qkv.to(torch.bfloat16), t_real, eff, num_heads)
    res = _linear(o.to(x.dtype), p["proj_w"], p["proj_b"])
    return x + _linear(res, p["fc_w"], p["fc_b"])
