"""Int8 W8A8 quantization of the block dense layers (counterpart of the JAX
package's ``ops/quant.py``).

Scheme (the JAX package's, dynamic post-training quantization):

* weights: symmetric, per output channel over the fan-in, quantized once
  from the original-precision state dict (``quantize_state_dict_int8``):
  each of a block's seven dense layers (``BLOCK_DENSE``, JAX
  ``_BLOCK_DENSE``) keeps ``weight`` as s8 codes (out, in) and gains
  ``qscale`` (out,) f32; its bias stays f32. The patch embedding, the
  norms and any head stay float;
* activations: symmetric per row (token), max |x| over the features, no
  calibration;
* the product s8 x s8 summed exactly in s32, then rescaled by the row's
  and the channel's scale (``int8_linear``).

Arithmetic, shared with the Hopper kernels of ``ops/fused_block.py`` and
JAX's XLA-path ``int8_linear`` (ops/quant.py:104-123): the scale is
``max(amax, 1e-12) / 127`` (IEEE division), the codes ``clip(round_half_
even(x / scale), -127, 127)``, the rescale ``f32(acc) * sx * qscale`` left
to right, then ``+ bias``. The plain s8 product runs in float64, exact
because |sum| <= 127^2 K < 2^53, and is rounded to f32 as the kernels'
``__int2float_rn`` rounds. A division by a CUDA tensor is IEEE division;
PyTorch multiplies by the reciprocal where the divisor is a host scalar,
so every divisor here is a tensor on the dividend's device (``div_ieee``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# the dense layers of a block that quantize (JAX _BLOCK_DENSE), by their
# reference state-dict names
BLOCK_DENSE = ("attn.qkv", "attn.proj", "temporal_attn.qkv",
               "temporal_attn.proj", "mlp.fc1", "mlp.fc2", "temporal_fc")


def div_ieee(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as IEEE division, the divisor made on x's device by a fill: a
    tensor copied from the host would wait for the device's queue (the int8
    CLS-row math runs in every block), a host scalar makes PyTorch multiply
    by its reciprocal."""
    return x / x.new_full((), d)


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 in f32: a row's or a channel's scale."""
    return div_ieee(torch.clamp(amax.float(), min=1e-12), 127.0)


def codes_of(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / scale), -127, 127) as s8 (x f32, scale broadcast)."""
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8)


def quantize_dense(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """An (out, in) weight -> (s8 codes (out, in), f32 scales (out,)):
    symmetric per output channel over the fan-in (JAX ``quantize_dense``
    on the (in, out) kernel, axis -2)."""
    w = torch.as_tensor(np.asarray(w) if not isinstance(w, torch.Tensor) else w,
                        dtype=torch.float32)
    scale = scale_of(w.abs().amax(dim=1))
    return codes_of(w, scale[:, None]), scale


def dequantize_dense(codes: torch.Tensor, qscale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_dense`` up to the rounding: f32 (out, in)."""
    return codes.float() * qscale[:, None]


def is_quantized(state_dict: Mapping[str, object]) -> bool:
    return any(k.endswith(".qscale") for k in state_dict)


def quantize_state_dict_int8(state_dict: Mapping[str, object]) -> Dict[str, object]:
    """A reference-layout state dict with every block's ``BLOCK_DENSE``
    weights quantized (JAX ``quantize_tree_int8``): ``blocks.{i}.{layer}.
    weight`` becomes its s8 codes and ``blocks.{i}.{layer}.qscale`` its f32
    scales (numpy arrays); every other entry is shared, not copied."""
    out = dict(state_dict)
    depth = 1 + max((int(k.split(".")[1]) for k in state_dict
                     if k.startswith("blocks.")), default=-1)
    if depth == 0:
        raise ValueError("the state dict has no blocks")
    for i in range(depth):
        for layer in BLOCK_DENSE:
            key = f"blocks.{i}.{layer}.weight"
            if key in state_dict:
                codes, scale = quantize_dense(state_dict[key])
                out[key] = codes.numpy()
                out[f"blocks.{i}.{layer}.qscale"] = scale.numpy()
    return out


def quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows (..., K) -> (s8 codes (..., K), f32 scales (...)): per-row
    dynamic quantization of x's f32 values."""
    xf = x.float()
    sx = scale_of(xf.abs().amax(dim=-1))
    return codes_of(xf, sx[..., None]), sx


def s8_product(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """a_q (..., K) s8 @ w_q (N, K)^T s8 -> the exact integer sums as f32
    (float64 products, exact below 2^53, rounded once)."""
    return torch.matmul(a_q.double(), w_q.double().t()).float()


def int8_linear(x: torch.Tensor, codes: torch.Tensor, qscale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = f32(quant_rows(x) @ codes^T) * sx * qscale [+ bias], in x's dtype
    (JAX ``int8_linear``; ``codes`` (out, in) s8, ``qscale`` (out,) f32)."""
    a_q, sx = quant_rows(x)
    y = s8_product(a_q, codes) * sx[..., None] * qscale
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
