"""The DINO projection head (counterpart of the JAX package's
``models/heads.py``; ref: vision_transformer.py:248-282), in the
reference's state-dict layout: ``mlp.{0,2,4}`` (Linear, GELU, Linear,
GELU, Linear; a single ``mlp`` Linear at one layer) and a weight-normed
``last_layer`` holding ``weight_g`` (out, 1) and ``weight_v`` (out, in),
as torch's ``weight_norm`` stores them. The two-token trainer's dual head
(``MultiDINOHead``) holds two of them, ``main`` and ``aux``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .timesformer import linear


class WeightNormLinear(nn.Module):
    """Bias-free linear layer W = g * v / ||v|| (per output row)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(out_dim, 1))
        self.weight_v = nn.Parameter(torch.zeros(out_dim, in_dim))

    def weight(self) -> torch.Tensor:
        """The effective (out, in) weight, in the parameters' dtype (the
        JAX head forms it in f32 before casting)."""
        vn = self.weight_v.norm(dim=1, keepdim=True).clamp_min(1e-12)
        return self.weight_v * (self.weight_g / vn)


class DINOHead(nn.Module):
    """MLP -> L2 normalisation -> weight-normed last layer. ``forward`` runs
    in its input's dtype with the parameters cast to it, as the JAX head
    runs in the backbone's compute dtype."""

    def __init__(self, in_dim: int, out_dim: int, nlayers: int = 3,
                 hidden_dim: int = 2048, bottleneck_dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        nlayers = max(nlayers, 1)
        if nlayers == 1:
            self.mlp = nn.Linear(in_dim, bottleneck_dim)
        else:
            dims = [in_dim] + [hidden_dim] * (nlayers - 1) + [bottleneck_dim]
            mods = []
            for i in range(nlayers):
                mods.append(nn.Linear(dims[i], dims[i + 1]))
                if i < nlayers - 1:
                    mods.append(nn.GELU())
            self.mlp = nn.Sequential(*mods)
        self.last_layer = WeightNormLinear(bottleneck_dim, out_dim)
        if generator is not None:
            self.reset_parameters(generator)

    def linears(self):
        return [self.mlp] if isinstance(self.mlp, nn.Linear) else [
            m for m in self.mlp if isinstance(m, nn.Linear)]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX ``init_dino_head`` rules from ``generator``: truncated
        normal (std 0.02, cut at 2 std) kernels and ``weight_v``, zero
        biases, ``weight_g`` at 1."""
        def tn(w):
            nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)

        for lin in self.linears():
            tn(lin.weight)
            lin.bias.zero_()
        tn(self.last_layer.weight_v)
        self.last_layer.weight_g.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lins = self.linears()
        for i, lin in enumerate(lins):
            x = linear(x, lin)
            if i < len(lins) - 1:
                x = F.gelu(x)
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
        return torch.matmul(x, self.last_layer.weight().to(x.dtype).t())


class MultiDINOHead(nn.Module):
    """The two-token trainer's dual head (ref: vision_transformer.py:285-345;
    JAX ``init_multi_dino_head`` / ``multi_dino_head_forward``): a main and
    an aux ``DINOHead``, their parameters under ``main.`` and ``aux.``.
    ``forward((x_main, x_aux))`` -> (main(x_main), aux(x_aux))."""

    def __init__(self, in_dim: int, out_dim: int, nlayers: int = 3,
                 hidden_dim: int = 2048, bottleneck_dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.main = DINOHead(in_dim, out_dim, nlayers, hidden_dim,
                             bottleneck_dim, generator)
        self.aux = DINOHead(in_dim, out_dim, nlayers, hidden_dim,
                            bottleneck_dim, generator)

    def forward(self, x_pair):
        return self.main(x_pair[0]), self.aux(x_pair[1])
