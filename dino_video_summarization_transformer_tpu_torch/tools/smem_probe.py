"""Probe the dynamic shared memory a block may opt into on this card.

The card counterpart of the JAX package's ``tools/vmem_probe.py``, which
bisects the TPU's effective scoped-VMEM budget by compiling a trivial
Pallas kernel with an N-MB scratch. Here the kernel of
``ops/csrc/smem_probe.cu`` copies a row of N / 4 floats through N bytes of
dynamic shared memory after opting into N bytes
(``cudaFuncSetAttribute``), and ``probe`` bisects over N. A size counts as
granted when the attribute call and the launch return ``cudaSuccess`` and
the row comes back reversed, as the kernel writes it.

    python -m dino_video_summarization_transformer_tpu_torch.tools.smem_probe

prints the budget beside ``cudaDevAttrMaxSharedMemoryPerBlockOptin``. The
port's attention kernels assume ``ops/fused_block.SMEM_LIMIT``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

# Kernel launches of ``roundtrip`` (the plain twin and refused sizes do not
# count).
launches: Dict[str, int] = {"smem_probe": 0}

# cudaErrorInvalidValue, cudaErrorLaunchOutOfResources: the card does not
# grant the size (neither error is sticky)
_REFUSED = (1, 701)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def roundtrip_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``roundtrip``."""
    return x.flip(0)


def roundtrip(x: torch.Tensor) -> Optional[torch.Tensor]:
    """x (n,) f32 -> x reversed, through 4 n bytes of dynamic shared memory
    on CUDA (None when the card refuses that many bytes), the plain twin on
    CPU."""
    if x.dim() != 1 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x: a contiguous 1-D f32 tensor")
    if x.device.type == "cpu":
        return roundtrip_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")

    from ..ops import _build

    lib = _build.load("probe")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.dvst_smem_roundtrip(
            x.data_ptr(), out.data_ptr(), 4 * x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err in _REFUSED:
        return None
    if err != 0:
        raise RuntimeError(f"CUDA kernel launch failed ({err}): "
                           f"{_build.error_string(err)}")
    launches["smem_probe"] += 1
    return out


def granted(nbytes: int, device: torch.device) -> bool:
    """Whether a block of the probe kernel gets ``nbytes`` of dynamic shared
    memory and moves its row through it intact."""
    x = torch.arange(nbytes // 4, dtype=torch.float32, device=device)
    out = roundtrip(x)
    return out is not None and torch.equal(out, roundtrip_plain(x))


def probe(device=None) -> dict:
    """Bisect the largest granted size between 48 KB (granted without an
    opt-in on every card since sm_70) and 1 MB (beyond any card's shared
    memory), to 4 bytes, on the CUDA ``device`` (default: the current
    card): {"budget": bytes, "optin":
    cudaDevAttrMaxSharedMemoryPerBlockOptin, "steps": sizes tried}. Raises
    without a card: the budget is the card's."""
    from ..ops import _build
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the probe measures a CUDA card, not {dev}")
    with torch.cuda.device(dev):
        optin = _build.load("probe").dvst_smem_optin_max()
    lo, hi, steps = 48 * 1024, 1 << 20, 1
    if not granted(lo, dev):
        raise RuntimeError(f"the card refuses even {lo} B of shared memory")
    while hi - lo > 4:
        mid = (lo + hi) // 8 * 4
        steps += 1
        if granted(mid, dev):
            lo = mid
        else:
            hi = mid
    return {"budget": lo, "optin": optin, "steps": steps}


def main() -> None:
    r = probe()
    print(f"device: {torch.cuda.get_device_name()}")
    print(f"measured dynamic shared-memory budget: {r['budget']} B "
          f"({r['steps']} launches tried); "
          f"cudaDevAttrMaxSharedMemoryPerBlockOptin: {r['optin']} B")


if __name__ == "__main__":
    main()
