"""Checkpoint loading and the reference's weight surgery, on reference-layout
state dicts (counterpart of the JAX package's ``models/convert.py``).

The port's modules hold the reference ``.pth`` layout natively, so loading
needs no layout change: ``convert_svt_checkpoint`` returns the surgered
state dict. ``state_dict_from_jax_params`` is the other direction the tests
and ``chip_smoke.py`` need: a JAX-layout pytree (numpy arrays, blocks
stacked along a leading depth axis, as ``utils/synthetic.make_numpy_params``
returns) to the reference layout, with the logic of the JAX package's
``pytree_to_reference_state_dict`` and no JAX; ``head_state_dict_from_jax``
does the same for the DINO head (the inverse of the JAX package's
``dino_head_to_pytree``). Both take the two-token trainer's trees too:
the aux-token backbone (``aux_cls_token``, ``pos_embed`` widened to
num_patches + 2) and the dual head (``aux_mlp``, ``aux_last_layer``),
whose leaves the JAX package's ``pytree_to_reference_state_dict`` names
not; the names the port picks are in their docstrings. Both are linear in the leaves, so they also carry
JAX gradients and optimizer moments across for the tests. The int8 tier's
weights are not carried across: a converted state dict is quantized by the
port (``ops/quant.quantize_state_dict_int8``), whose codes and scales equal
JAX ``quantize_tree_int8``'s of the same tree bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np


def _to_np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def load_torch_state_dict(path: str, checkpoint_key: str | None = None
                          ) -> Dict[str, np.ndarray]:
    """Load a .pth file into a flat name -> ndarray dict. ``checkpoint_key``
    selects a sub-dict (e.g. "teacher", ref: eval_knn.py:64-69); falls back
    to "model" / "state_dict" / the root mapping."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ([checkpoint_key] if checkpoint_key else []) + ["model", "state_dict"]:
            if key and key in ckpt and isinstance(ckpt[key], dict):
                ckpt = ckpt[key]
                break
    return {k: _to_np(v) for k, v in ckpt.items()
            if hasattr(v, "shape") or hasattr(v, "detach")}


def strip_prefixes(sd: Mapping[str, np.ndarray],
                   prefixes=("module.", "backbone.", "model.")) -> Dict[str, np.ndarray]:
    """Iteratively strip known wrapper prefixes (ref: models/helpers.py:17-48)."""
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            while k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def select_backbone(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Keep only 'backbone.'-prefixed entries, stripped — the SVT checkpoint
    layout (ref: dino_similarity.py:33, scripts/train.sh)."""
    return {k[len("backbone."):]: v for k, v in sd.items()
            if k.startswith("backbone.")}


def _interp_nearest_np(src: np.ndarray, out_len: int, axis: int) -> np.ndarray:
    in_len = src.shape[axis]
    idx = np.floor(np.arange(out_len) * (in_len / out_len)).astype(np.int64)
    return np.take(src, idx, axis=axis)


def apply_surgery(sd: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """Reference load_pretrained surgery (ref: models/helpers.py:149-197):
    classifier drop/resize, pos_embed and time_embed nearest resize, and
    the temporal-attention bootstrap from the spatial weights."""
    sd = dict(sd)
    if "head.weight" in sd and (
        cfg.num_classes == 0 or sd["head.weight"].shape[0] != cfg.num_classes
    ):
        sd.pop("head.weight", None)
        sd.pop("head.bias", None)
    if "pos_embed" in sd and sd["pos_embed"].shape[1] != cfg.num_patches + 1:
        pe = sd["pos_embed"]
        cls_pe, other = pe[:, :1, :], pe[:, 1:, :]
        other = _interp_nearest_np(other, cfg.num_patches, axis=1)
        sd["pos_embed"] = np.concatenate([cls_pe, other], axis=1)
    if "time_embed" in sd and sd["time_embed"].shape[1] != cfg.num_frames:
        sd["time_embed"] = _interp_nearest_np(sd["time_embed"], cfg.num_frames,
                                              axis=1)
    if cfg.attention_type == "divided_space_time":
        for key in list(sd.keys()):
            if "blocks" in key and "attn" in key and "temporal" not in key:
                nk = key.replace("attn", "temporal_attn")
                if nk not in sd:
                    sd[nk] = sd[key]
            if "blocks" in key and "norm1" in key and "temporal" not in key:
                nk = key.replace("norm1", "temporal_norm1")
                if nk not in sd:
                    sd[nk] = sd[key]
    return sd


def convert_svt_checkpoint(path: str, cfg, checkpoint_key: str | None = "teacher"
                           ) -> Dict[str, np.ndarray]:
    """End to end: .pth -> surgered reference-layout backbone state dict."""
    sd = load_torch_state_dict(path, checkpoint_key)
    if any(k.startswith("backbone.") for k in sd):
        sd = select_backbone(sd)
    else:
        sd = strip_prefixes(sd)
    return apply_surgery(sd, cfg)


def _tree_index(tree: Any, i: int) -> Any:
    """Index every leaf's leading (stacked-depth) axis."""
    if isinstance(tree, Mapping):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def state_dict_from_jax_params(params_np: Mapping[str, Any], cfg
                               ) -> Dict[str, np.ndarray]:
    """JAX-layout pytree of numpy arrays -> reference-layout state dict:
    torch naming, (out, in) linear weights, (D, C, ps, ps) conv patch
    embed (the logic of the JAX package's ``pytree_to_reference_state_dict``,
    ``models/convert.py:330``). The aux-token backbone's extra leaf
    ``aux_cls_token`` keeps its JAX name; its ``pos_embed`` (1,
    num_patches + 2, D) goes across as it is (CLS, the patches, AUX)."""
    out: Dict[str, np.ndarray] = {}

    def np32(x):
        return np.asarray(x, np.float32)

    def put_linear(prefix, p):
        out[prefix + ".weight"] = np.ascontiguousarray(np32(p["kernel"]).T)
        if "bias" in p:
            out[prefix + ".bias"] = np32(p["bias"])

    def put_ln(prefix, p):
        out[prefix + ".weight"] = np32(p["scale"])
        out[prefix + ".bias"] = np32(p["bias"])

    out["cls_token"] = np32(params_np["cls_token"])
    if "aux_cls_token" in params_np:
        out["aux_cls_token"] = np32(params_np["aux_cls_token"])
    out["pos_embed"] = np32(params_np["pos_embed"])
    if "time_embed" in params_np:
        out["time_embed"] = np32(params_np["time_embed"])

    k = np32(params_np["patch_embed"]["proj"]["kernel"])
    ps = cfg.patch_size
    C = cfg.in_chans
    D = k.shape[-1]
    # kernel[(kh*ps + kw)*C + c, d] -> w[d, c, kh, kw]
    out["patch_embed.proj.weight"] = np.ascontiguousarray(
        k.reshape(ps, ps, C, D).transpose(3, 2, 0, 1))
    out["patch_embed.proj.bias"] = np32(params_np["patch_embed"]["proj"]["bias"])

    blocks = params_np["blocks"]
    for i in range(cfg.depth):
        b = _tree_index(blocks, i)
        pre = f"blocks.{i}."
        put_ln(pre + "norm1", b["norm1"])
        put_linear(pre + "attn.qkv", b["attn"]["qkv"])
        put_linear(pre + "attn.proj", b["attn"]["proj"])
        put_ln(pre + "norm2", b["norm2"])
        put_linear(pre + "mlp.fc1", b["mlp"]["fc1"])
        put_linear(pre + "mlp.fc2", b["mlp"]["fc2"])
        if "temporal_attn" in b:
            put_ln(pre + "temporal_norm1", b["temporal_norm1"])
            put_linear(pre + "temporal_attn.qkv", b["temporal_attn"]["qkv"])
            put_linear(pre + "temporal_attn.proj", b["temporal_attn"]["proj"])
            put_linear(pre + "temporal_fc", b["temporal_fc"])
    put_ln("norm", params_np["norm"])
    if "head" in params_np:
        put_linear("head", params_np["head"])
    return out


def head_state_dict_from_jax(head_np: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX DINO-head pytree (``{"mlp": {"fc0": ...}, "last_layer":
    {"weight_g": (out,), "weight_v": (in, out)}}``, numpy leaves) -> the
    reference layout ``mlp.{0,2,4}.weight/bias`` (``mlp.weight`` for one
    layer), ``last_layer.weight_g`` (out, 1), ``last_layer.weight_v``
    (out, in): the inverse of the JAX package's ``dino_head_to_pytree``
    (``models/convert.py:199-218``). The dual head of the two-token trainer
    (JAX ``init_multi_dino_head``: ``mlp``, ``last_layer``, ``aux_mlp``,
    ``aux_last_layer``) goes to ``heads.MultiDINOHead``'s names: the main
    head's leaves under ``main.``, the aux head's under ``aux.``."""
    if "aux_mlp" in head_np:
        return {pre + k: v
                for pre, mlp, ll in (("main.", "mlp", "last_layer"),
                                     ("aux.", "aux_mlp", "aux_last_layer"))
                for k, v in head_state_dict_from_jax(
                    {"mlp": head_np[mlp], "last_layer": head_np[ll]}).items()}
    out: Dict[str, np.ndarray] = {}
    mlp = head_np["mlp"]
    n = len(mlp)
    for i in range(n):
        p = mlp[f"fc{i}"]
        name = "mlp" if n == 1 else f"mlp.{2 * i}"
        out[name + ".weight"] = np.ascontiguousarray(
            np.asarray(p["kernel"], np.float32).T)
        out[name + ".bias"] = np.asarray(p["bias"], np.float32)
    ll = head_np["last_layer"]
    out["last_layer.weight_g"] = np.asarray(ll["weight_g"], np.float32).reshape(-1, 1)
    out["last_layer.weight_v"] = np.ascontiguousarray(
        np.asarray(ll["weight_v"], np.float32).T)
    return out
