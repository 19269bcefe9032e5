"""Image ops of the two-stream trainer and its data: RandConv augmentation,
Sobel filtering and the optical-flow folder reader (counterpart of the JAX
package's ``ops/image.py``; ref: datasets_custom/rand_conv.py:8-29,
kinetics.py:314-353 kornia sobel and the flow frames).

Plain torch: JAX runs these through ``lax.conv_general_dilated`` outside
any Pallas kernel. PIL loads lazily, where a flow folder is read.
"""

from __future__ import annotations

import glob
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32) / 8.0
SOBEL_Y = SOBEL_X.T


def rand_conv(image: torch.Tensor, kernel_size: int = 3, alpha: float = 0.7,
              generator: Optional[torch.Generator] = None,
              weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Random-convolution augmentation (ref: rand_conv.py:8-29; JAX
    ``rand_conv``): filter with a fresh N(0, 1/(sqrt(3) k)) 3 -> 3 k x k
    convolution (zero padding k // 2) and blend, alpha * image + (1 - alpha)
    * filtered. image (B, C, H, W) or (B, C, T, H, W), each frame filtered
    alone. ``weight`` (k, k, 3, 3) in JAX's HWIO layout replaces the draw
    (from ``generator``, on the CPU), which the JAX function takes from its
    own key."""
    if weight is None:
        std = 1.0 / (np.sqrt(3) * kernel_size)
        weight = std * torch.randn((kernel_size, kernel_size, 3, 3),
                                   generator=generator)
    w = weight.to(image.device, image.dtype).permute(3, 2, 0, 1)  # OIHW
    x = image
    temporal = image.dim() == 5
    if temporal:
        B, C, T, H, W = x.shape
        x = x.transpose(1, 2).reshape(B * T, C, H, W)
    y = F.conv2d(x, w, padding=kernel_size // 2)
    if temporal:
        y = y.reshape(B, T, C, H, W).transpose(1, 2)
    return alpha * image + (1 - alpha) * y


def sobel(images: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Sobel gradient magnitude as ``kornia.filters.sobel`` (ref:
    kinetics.py:319; JAX ``sobel``): each channel alone, the normalized
    3 x 3 kernels over reflect padding, sqrt(gx^2 + gy^2 + eps). images
    (B, C, H, W). The taps are summed one by one in ``_sobel_np``'s order,
    so a CPU tensor gives its numpy twin's values bit for bit."""
    H, W = images.shape[-2:]
    x = F.pad(images, (1, 1, 1, 1), mode="reflect")

    def corr(k):
        out = torch.zeros_like(images)
        for dy in range(3):
            for dx in range(3):
                if k[dy, dx]:
                    out += float(k[dy, dx]) * x[..., dy:dy + H, dx:dx + W]
        return out

    gx, gy = corr(SOBEL_X), corr(SOBEL_Y)
    # the square root taken in float64 and rounded once: the correctly
    # rounded root numpy takes (torch's vectorized CPU root can differ by
    # an ulp)
    return torch.sqrt((gx * gx + gy * gy + eps).double()).to(images.dtype)


def sobel_np(images: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Host-side Sobel magnitude (JAX ``data/datasets.py`` ``_sobel_np``):
    images (T, C, H, W) float32, the same numpy taps in the same order, so
    the data workers' flow frames equal JAX's bit for bit."""
    x = np.pad(images, ((0, 0), (0, 0), (1, 1), (1, 1)), mode="reflect")

    def corr(inp, k):
        out = np.zeros_like(images)
        for dy in range(3):
            for dx in range(3):
                if k[dy, dx]:
                    out += k[dy, dx] * inp[
                        :, :, dy:dy + images.shape[2], dx:dx + images.shape[3]]
        return out

    gx = corr(x, SOBEL_X)
    gy = corr(x, SOBEL_Y)
    return np.sqrt(gx * gx + gy * gy + eps)


def load_flow_folder(dir_path: str) -> Optional[np.ndarray]:
    """A folder of flow JPEGs as (T, C, H, W) float32 in [0, 1], sorted by
    name (ref: kinetics.py:348-353), or None when it holds none. PIL is
    imported here, where a folder is read."""
    paths = sorted(glob.glob(f"{dir_path}/*.jpg"))
    if not paths:
        return None
    from PIL import Image

    arr = np.stack([np.asarray(Image.open(p), np.float32) / 255.0 for p in paths])
    if arr.ndim == 3:
        arr = arr[..., None]
    return np.moveaxis(arr, -1, 1)
