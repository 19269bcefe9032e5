"""S3D, the separable 3D CNN (counterpart of the JAX package's
``models/s3d.py``; ref: models/s3d.py:9-219): the frozen feature teacher of
the CNN-distillation trainer (MODEL.CNN_DISTILL).

The module holds CoCLR's S3D state-dict layout (``Conv_1a.conv1.weight``
(cout, cin, kt, kh, kw), ``Conv_1a.bn1.running_mean``, ``Mixed_3b.branch1
.1.conv2.weight``, ...), so ``convert.convert_coclr_s3d`` loads a CoCLR
checkpoint natively; the self-gating layers of ``gating=True`` are
``Mixed_*.gating_b{0..3}`` linear layers. The forward is plain torch:
``F.conv3d`` (JAX computes it with ``lax.conv_general_dilated``, outside
any Pallas kernel), BatchNorm in eval mode (running statistics) or train
mode (batch statistics; ``batch_norm`` also returns the updated running
statistics, torch's momentum 0.1 and unbiased variance), and max pooling
whose padding never wins (JAX pads with -inf).

Dtypes follow JAX's promotion: each convolution and BatchNorm computes in
the common type of its input and its parameters. So with f32 weights and
``compute_dtype=torch.bfloat16`` only the input is rounded to bf16 and
every layer computes in f32, as JAX's BatchNorm (bf16 rows minus an f32
mean) promotes to f32. JAX's own forward raises there instead:
``lax.conv_general_dilated`` refuses a bf16 input with f32 weights
(ROADMAP section 3).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .timesformer import _trunc_normal, linear, load_reference_state_dict

# SepInception output plans (ref: models/s3d.py:163-198): (cin, [b0, b1a,
# b1b, b2a, b2b, b3b])
INCEPTION_PLAN = {
    "Mixed_3b": (192, [64, 96, 128, 16, 32, 32]),
    "Mixed_3c": (256, [128, 128, 192, 32, 96, 64]),
    "Mixed_4b": (480, [192, 96, 208, 16, 48, 64]),
    "Mixed_4c": (512, [160, 112, 224, 24, 64, 64]),
    "Mixed_4d": (512, [128, 128, 256, 24, 64, 64]),
    "Mixed_4e": (512, [112, 144, 288, 32, 64, 64]),
    "Mixed_4f": (528, [256, 160, 320, 32, 128, 128]),
    "Mixed_5b": (832, [256, 160, 320, 32, 128, 128]),
    "Mixed_5c": (832, [384, 192, 384, 48, 128, 128]),
}


def conv3d(x: torch.Tensor, w: torch.Tensor, stride, padding) -> torch.Tensor:
    """x (B, C, T, H, W), w (cout, cin, kt, kh, kw), symmetric zero padding,
    in the common type of x and w."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return F.conv3d(x.to(dt), w.to(dt), stride=stride, padding=padding)


def batch_norm(bn: "BatchNorm", x: torch.Tensor, training: bool = False,
               momentum: float = 0.1, eps: float = 1e-5):
    """torch BatchNorm3d semantics (JAX ``batch_norm``): eval uses the
    running statistics; train the batch's (biased variance) and returns the
    updated running statistics {"mean", "var"} (unbiased variance, as
    torch). -> (y, new_stats or None)."""
    if training:
        dims = (0, 2, 3, 4)
        mean = x.mean(dim=dims)
        var = x.var(dim=dims, unbiased=False)
        n = x.numel() / x.shape[1]
        new_stats = {
            "mean": (1 - momentum) * bn.running_mean + momentum * mean,
            "var": (1 - momentum) * bn.running_var + momentum * var * n / max(n - 1, 1),
        }
    else:
        mean, var = bn.running_mean, bn.running_var
        new_stats = None
    v = (-1, 1, 1, 1)
    y = ((x - mean.reshape(v)) * torch.rsqrt(var.reshape(v) + eps)
         * bn.weight.reshape(v) + bn.bias.reshape(v))
    return y, new_stats


def max_pool3d(x: torch.Tensor, kernel, stride, padding) -> torch.Tensor:
    return F.max_pool3d(x, kernel, stride, padding)


class BatchNorm(nn.Module):
    """BatchNorm3d's parameters and running statistics (the reference's
    names, without ``num_batches_tracked``); applied by ``batch_norm``."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


def _conv_weight(cin: int, cout: int, k3) -> nn.Parameter:
    return nn.Parameter(torch.zeros(cout, cin, *k3))


class BasicConv3d(nn.Module):
    """conv k^3 (no bias) -> BN -> ReLU."""

    def __init__(self, cin: int, cout: int, k: int, s: int, p: int):
        super().__init__()
        self.k, self.s, self.p = k, s, p
        self.conv = nn.Module()
        self.conv.weight = _conv_weight(cin, cout, (k, k, k))
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        s, p = self.s, self.p
        x = conv3d(x, self.conv.weight, (s, s, s), (p, p, p))
        return F.relu(batch_norm(self.bn, x, training)[0])


class STConv3d(nn.Module):
    """The separable block: conv (1, k, k) -> BN -> ReLU -> conv (k, 1, 1)
    -> BN -> ReLU, the second with temporal stride ``ts``."""

    def __init__(self, cin: int, cout: int, k: int, s: int, p: int,
                 ts: Optional[int] = None):
        super().__init__()
        self.k, self.s, self.p = k, s, p
        self.ts = s if ts is None else ts
        self.conv1 = nn.Module()
        self.conv1.weight = _conv_weight(cin, cout, (1, k, k))
        self.conv2 = nn.Module()
        self.conv2.weight = _conv_weight(cout, cout, (k, 1, 1))
        self.bn1, self.bn2 = BatchNorm(cout), BatchNorm(cout)

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        s, p = self.s, self.p
        x = conv3d(x, self.conv1.weight, (1, s, s), (0, p, p))
        x = F.relu(batch_norm(self.bn1, x, training)[0])
        x = conv3d(x, self.conv2.weight, (self.ts, 1, 1), (p, 0, 0))
        return F.relu(batch_norm(self.bn2, x, training)[0])


class SepInception(nn.Module):
    """Four branches concatenated on channels (ref: models/s3d.py:82-135):
    1^3; 1^3 -> ST 3; 1^3 -> ST 3; max-pool 3^3 -> 1^3; with ``gating``
    each branch scaled by sigmoid(linear(its spatio-temporal mean))."""

    def __init__(self, cin: int, plan, gating: bool = False):
        super().__init__()
        o0, o1a, o1b, o2a, o2b, o3b = plan
        self.branch0 = nn.Sequential(BasicConv3d(cin, o0, 1, 1, 0))
        self.branch1 = nn.Sequential(BasicConv3d(cin, o1a, 1, 1, 0),
                                     STConv3d(o1a, o1b, 3, 1, 1))
        self.branch2 = nn.Sequential(BasicConv3d(cin, o2a, 1, 1, 0),
                                     STConv3d(o2a, o2b, 3, 1, 1))
        self.branch3 = nn.Sequential(nn.Identity(), BasicConv3d(cin, o3b, 1, 1, 0))
        self.gating = gating
        if gating:
            for i, c in zip("0123", (o0, o1b, o2b, o3b)):
                setattr(self, f"gating_b{i}", nn.Linear(c, c))

    @staticmethod
    def _self_gate(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """(ref: models/s3d.py:70-79)."""
        w = torch.sigmoid(linear(x.mean(dim=(2, 3, 4)), lin))
        return w[:, :, None, None, None] * x

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        x0 = self.branch0[0](x, training)
        x1 = self.branch1[1](self.branch1[0](x, training), training)
        x2 = self.branch2[1](self.branch2[0](x, training), training)
        x3 = self.branch3[1](max_pool3d(x, (3, 3, 3), (1, 1, 1), (1, 1, 1)), training)
        outs = [x0, x1, x2, x3]
        if self.gating:
            outs = [self._self_gate(getattr(self, f"gating_b{i}"), o)
                    for i, o in enumerate(outs)]
        return torch.cat(outs, dim=1)


class S3D(nn.Module):
    """S3D (ref: models/s3d.py:138-219): ``forward`` takes (B, C, T, H, W)
    and returns (B, 1024, T', H', W'), channels first like the reference."""

    def __init__(self, input_channel: int = 3, gating: bool = False, slow: bool = False):
        super().__init__()
        self.gating = gating
        self.Conv_1a = STConv3d(input_channel, 64, 7, 2, 3, ts=1 if slow else 2)
        self.Conv_2b = BasicConv3d(64, 64, 1, 1, 0)
        self.Conv_2c = STConv3d(64, 192, 3, 1, 1)
        for name, (cin, plan) in INCEPTION_PLAN.items():
            setattr(self, name, SepInception(cin, plan, gating))

    def load_reference_state_dict(self, sd) -> None:
        load_reference_state_dict(self, sd)

    def forward(self, x: torch.Tensor, training: bool = False,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(ref: models/s3d.py:212-219; JAX ``s3d.forward``): x cast to
        ``compute_dtype`` (default: the parameters'), each layer in the
        common type of its input and parameters; ``training`` takes the
        BatchNorms' batch statistics (the running ones are not updated, as
        JAX's forward drops them)."""
        x = x.to(compute_dtype or self.Conv_1a.bn1.weight.dtype)
        x = self.Conv_1a(x, training)
        x = max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = self.Conv_2b(x, training)
        x = self.Conv_2c(x, training)
        x = max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = self.Mixed_3b(x, training)
        x = self.Mixed_3c(x, training)
        x = max_pool3d(x, (3, 3, 3), (2, 2, 2), (1, 1, 1))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x, training)
        x = max_pool3d(x, (2, 2, 2), (2, 2, 2), (0, 0, 0))
        x = self.Mixed_5b(x, training)
        return self.Mixed_5c(x, training)


def init_s3d(generator: torch.Generator, input_channel: int = 3, gating: bool = False,
             slow: bool = False, device=None) -> S3D:
    """Fresh f32 parameters with JAX ``init_s3d``'s rules, drawn from
    ``generator`` on the CPU, then moved to ``device`` (default: the CUDA
    card): convolutions N(0, 0.01) (ref: models/s3d.py:21), BatchNorms at
    scale 1, bias 0, running mean 0 and variance 1; gating layers
    truncated normal (std 0.02), zero bias."""
    from ..utils.device import resolve_device

    with torch.device("cpu"):
        model = S3D(input_channel, gating, slow)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("conv.weight") or ".conv1.weight" in name or ".conv2.weight" in name:
                p.copy_(0.01 * torch.randn(p.shape, generator=generator))
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                _trunc_normal(mod.weight, generator)
                mod.bias.zero_()
    return model.to(resolve_device(device))

