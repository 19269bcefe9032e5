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
JAX gradients and optimizer moments across for the tests.
``jax_params_from_state_dict`` is the inverse (the JAX package's
``timesformer_to_pytree``): the finetuning CLI writes its parameters under
JAX's ``/``-joined pytree keys with it. ``convert_hf_timesformer`` reads a
HuggingFace TimeSformer checkpoint (``model.safetensors`` through the
numpy reader ``load_safetensors``, or ``pytorch_model.bin``) into the
reference layout. The int8 tier's
weights are not carried across: a converted state dict is quantized by the
port (``ops/quant.quantize_state_dict_int8``), whose codes and scales equal
JAX ``quantize_tree_int8``'s of the same tree bit for bit.
"""

from __future__ import annotations

import json
import os
import re
import struct
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


_BLOCK_RE = re.compile(r"^blocks\.(\d+)\.(.+)$")


def jax_params_from_state_dict(sd: Mapping[str, Any], cfg, dtype=np.float32
                               ) -> Dict[str, Any]:
    """Reference-layout state dict -> the JAX package's stacked-block pytree
    (numpy leaves, blocks stacked along a leading depth axis; JAX
    ``timesformer_to_pytree``, ``models/convert.py:132-197``): the inverse
    of ``state_dict_from_jax_params``."""
    sd = {k: np.asarray(_to_np(v), dtype=dtype) for k, v in sd.items()}
    block_sd: Dict[int, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        m = _BLOCK_RE.match(k)
        if m:
            block_sd.setdefault(int(m.group(1)), {})[m.group(2)] = v
    if len(block_sd) != cfg.depth:
        raise ValueError(f"expected {cfg.depth} blocks, got {len(block_sd)}")

    def lin(b, prefix):
        p = {"kernel": b[prefix + ".weight"].T}
        if prefix + ".bias" in b:
            p["bias"] = b[prefix + ".bias"]
        return p

    def ln(b, prefix):
        return {"scale": b[prefix + ".weight"], "bias": b[prefix + ".bias"]}

    def stacked(fn):
        per = [fn(block_sd[i]) for i in range(cfg.depth)]

        def stack(*xs):
            if isinstance(xs[0], dict):
                return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
            return np.stack(xs)
        return stack(*per)

    blocks = {
        "norm1": stacked(lambda b: ln(b, "norm1")),
        "attn": stacked(lambda b: {"qkv": lin(b, "attn.qkv"), "proj": lin(b, "attn.proj")}),
        "norm2": stacked(lambda b: ln(b, "norm2")),
        "mlp": stacked(lambda b: {"fc1": lin(b, "mlp.fc1"), "fc2": lin(b, "mlp.fc2")}),
    }
    if cfg.attention_type == "divided_space_time":
        blocks["temporal_norm1"] = stacked(lambda b: ln(b, "temporal_norm1"))
        blocks["temporal_attn"] = stacked(lambda b: {
            "qkv": lin(b, "temporal_attn.qkv"), "proj": lin(b, "temporal_attn.proj")})
        blocks["temporal_fc"] = stacked(lambda b: lin(b, "temporal_fc"))
    # conv (D, C, ps, ps) -> kernel[(kh*ps + kw)*C + c, d]
    w = sd["patch_embed.proj.weight"]
    Dp, C, ps, _ = w.shape
    params: Dict[str, Any] = {
        "cls_token": sd["cls_token"],
        "pos_embed": sd["pos_embed"],
        "patch_embed": {"proj": {"kernel": w.transpose(2, 3, 1, 0).reshape(ps * ps * C, Dp),
                                 "bias": sd["patch_embed.proj.bias"]}},
        "blocks": blocks,
        "norm": ln(sd, "norm"),
    }
    if "time_embed" in sd:
        params["time_embed"] = sd["time_embed"]
    if "head.weight" in sd and cfg.num_classes > 0:
        params["head"] = lin(sd, "head")
    return params


def flatten_params(tree: Mapping[str, Any], prefix=()):
    """(path tuple, leaf) pairs of a nested dict, in insertion order, as
    the JAX finetuning CLI walks its pytree for ``finetuned_params.npz``."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from flatten_params(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# HuggingFace TimesformerModel layout -> the reference's names; the order
# matters (the most specific prefix first)
_HF_BLOCK_MAP = [
    ("attention.attention.qkv.", "attn.qkv."),
    ("attention.output.dense.", "attn.proj."),
    ("temporal_attention.attention.qkv.", "temporal_attn.qkv."),
    ("temporal_attention.output.dense.", "temporal_attn.proj."),
    ("temporal_dense.", "temporal_fc."),
    ("temporal_layernorm.", "temporal_norm1."),
    ("layernorm_before.", "norm1."),
    ("layernorm_after.", "norm2."),
    ("intermediate.dense.", "mlp.fc1."),
    ("output.dense.", "mlp.fc2."),
]
_HF_EMBED = {
    "cls_token": "cls_token",
    "position_embeddings": "pos_embed",
    "time_embeddings": "time_embed",
    "patch_embeddings.projection.weight": "patch_embed.proj.weight",
    "patch_embeddings.projection.bias": "patch_embed.proj.bias",
}


def hf_timesformer_state_dict_to_reference(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Rename a HuggingFace TimeSformer state dict into the reference naming
    (the ``TimesformerForVideoClassification`` the reference evaluates,
    ref: timesformer_evaluation.py:60-62)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("timesformer.embeddings."):
            out[_HF_EMBED[k[len("timesformer.embeddings."):]]] = v
        elif k.startswith("timesformer.encoder.layer."):
            idx, sub = k[len("timesformer.encoder.layer."):].split(".", 1)
            for src, dst in _HF_BLOCK_MAP:
                if sub.startswith(src):
                    sub = dst + sub[len(src):]
                    break
            out[f"blocks.{idx}.{sub}"] = v
        elif k.startswith("timesformer.layernorm."):
            out["norm." + k[len("timesformer.layernorm."):]] = v
        elif k.startswith("classifier."):
            out["head." + k[len("classifier."):]] = v
    return out


_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
              "U8": np.uint8, "BOOL": np.bool_}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a ``.safetensors`` file with numpy: an 8-byte little-endian
    header length, the JSON header (name -> dtype, shape, data_offsets into
    the buffer that follows; ``__metadata__`` skipped), then the raw
    little-endian buffer. F16 stays float16 (as ``safetensors.numpy``
    returns it); BF16, which numpy lacks, is widened to float32 exactly (its
    16 bits are the high half of the f32 word)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        lo, hi = meta["data_offsets"]
        raw, shape = buf[lo:hi], tuple(meta["shape"])
        if meta["dtype"] == "BF16":
            bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(shape)
        elif meta["dtype"] in _ST_DTYPES:
            dt = np.dtype(_ST_DTYPES[meta["dtype"]]).newbyteorder("<")
            out[name] = np.frombuffer(raw, dt).reshape(shape).astype(dt.newbyteorder("="))
        else:
            raise ValueError(f"{path}: tensor {name!r} of dtype {meta['dtype']}")
    return out


def _load_hf_dir(path: str) -> Dict[str, np.ndarray]:
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        return load_safetensors(st)
    return load_torch_state_dict(os.path.join(path, "pytorch_model.bin"))


def convert_hf_timesformer(path_or_sd, cfg) -> Dict[str, np.ndarray]:
    """A HuggingFace TimeSformer checkpoint (a directory holding
    ``model.safetensors`` or ``pytorch_model.bin``, a ``.bin`` / ``.pth``
    file, or a state-dict mapping) -> the surgered reference-layout state
    dict (``apply_surgery``: ``time_embed`` and ``pos_embed`` resized to
    ``cfg``)."""
    if isinstance(path_or_sd, str):
        sd = (_load_hf_dir(path_or_sd) if os.path.isdir(path_or_sd)
              else load_torch_state_dict(path_or_sd))
    else:
        sd = {k: _to_np(v) for k, v in path_or_sd.items()}
    return apply_surgery(hf_timesformer_state_dict_to_reference(sd), cfg)


def linear_head_state_dict_from_jax(head_np: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX linear probe ``{"kernel": (dim, L), "bias": (L,)}`` ->
    ``heads.LinearClassifier``'s ``linear.weight`` (L, dim) and
    ``linear.bias``."""
    return {"linear.weight": np.ascontiguousarray(np.asarray(head_np["kernel"], np.float32).T),
            "linear.bias": np.asarray(head_np["bias"], np.float32)}
