"""Feature extraction + weighted kNN evaluation (ref: eval_knn.py:30-190;
the JAX package's ``engine/knn.py``).

``extract_features`` runs a frozen backbone over a dataset on one device
(the model's): the kNN and linear-probe CLIs pass a bf16 copy of the
no-head model whose ``use_kernels`` (``timesformer.eval_kernels``) runs
every block through the whole-block kernel pair on the card, and the
train CLI's online kNN hook passes the f32 teacher's training forward. The
kNN vote is one chunked matmul + top-k, with ties broken toward the lower
index as JAX's ``jax.lax.top_k`` breaks them (a stable descending sort:
``torch.topk`` leaves their order unspecified, which moves top-5 where k <
5 leaves classes tied at probability 0).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def extract_features(
    model: torch.nn.Module,
    dataset,
    batch_size: int = 8,
    num_workers: int = 4,
    forward: Optional[Callable] = None,
    mesh=None,
    log_every: int = 10,
) -> np.ndarray:
    """Run the backbone over a dataset of ``(clip (C, T, H, W), index)``
    items, returning (N, D) float32 features in index order. ``forward(x)``
    defaults to ``model.forward_features`` (the model's dtype and route);
    the batch goes to the model's device. The tail batch runs at its own
    size (JAX pads it to a static shape and drops the padded rows)."""
    from ..data.loader import PrefetchLoader

    if mesh is not None:
        raise NotImplementedError(
            "extract_features over several cards: multi-card extraction is not "
            "ported (ROADMAP queue 1 item 8, parallelism)")
    forward = forward or model.forward_features
    dev = next(model.parameters()).device
    n = len(dataset)
    feats_out = np.zeros((n, model.cfg.embed_dim), np.float32)

    def collate(items):
        return np.stack([it[0] for it in items]), np.asarray([it[1] for it in items])

    loader = PrefetchLoader(dataset, num_workers=num_workers,
                            batch_size=batch_size, collate=collate)
    with torch.no_grad():
        for i, (clips, idxs) in enumerate(loader):
            out = forward(torch.from_numpy(clips).to(dev))
            feats_out[idxs] = out.float().cpu().numpy()
            if log_every and i % log_every == 0:
                print(f"extract {i + 1}/{len(loader)}", flush=True)
    return feats_out


def _top(t: torch.Tensor, k: int):
    """The k largest of each row, ties toward the lower index
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(t, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _on(x, dtype, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev, dtype)
    return torch.as_tensor(np.asarray(x), device=dev).to(dtype)


def knn_predict(train_features, train_labels, test_features, k: int, T: float,
                num_classes: int = 1000, device=None) -> np.ndarray:
    """The temperature-weighted kNN vote's top-5 classes (top-min(5,
    num_classes)) of each test row, (n_test, top_n) int64: cosine
    similarity (features L2-normalized), top-k neighbours, exp(sim/T)-
    weighted one-hot vote (ref: eval_knn.py:138-178), on ``device``
    (default: the CUDA card). Arrays or tensors."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    train_f = _on(train_features, torch.float32, dev)
    train_l = _on(train_labels, torch.int64, dev)
    feats = _on(test_features, torch.float32, dev)
    dist, idx = _top(feats @ train_f.T, min(k, train_f.shape[0]))  # (B, k)
    w = torch.exp(dist / T)
    one_hot = F.one_hot(train_l[idx], num_classes).to(w.dtype)
    probs = (one_hot * w[..., None]).sum(dim=1)  # (B, C)
    return _top(probs, min(5, num_classes))[1].cpu().numpy()


def knn_classifier(
    train_features: np.ndarray,
    train_labels: np.ndarray,
    test_features: np.ndarray,
    test_labels: np.ndarray,
    k: int,
    T: float,
    num_classes: int = 1000,
    num_chunks: int = 100,
    device=None,
) -> Tuple[float, float]:
    """Top-1 / top-5 accuracy of ``knn_predict``'s vote, chunked over the
    test set (ref: eval_knn.py:138-178), on ``device`` (default: the CUDA
    card)."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    train_features = _on(train_features, torch.float32, dev)  # uploaded once
    train_labels = _on(train_labels, torch.int64, dev)
    n_test = test_labels.shape[0]
    imgs_per_chunk = max(n_test // num_chunks, 1)
    top_n = min(5, num_classes)
    top1 = top5 = total = 0
    for start in range(0, n_test, imgs_per_chunk):
        stop = min(start + imgs_per_chunk, n_test)
        preds = knn_predict(train_features, train_labels, test_features[start:stop], k, T,
                            num_classes, dev)
        correct = preds == np.asarray(test_labels[start:stop])[:, None]
        top1 += int(correct[:, 0].sum())
        top5 += int(correct[:, :top_n].sum())
        total += stop - start
    return top1 * 100.0 / total, top5 * 100.0 / total


def l2_normalize(x: np.ndarray) -> np.ndarray:
    """(ref: eval_knn.py:79) F.normalize(dim=1, p=2)."""
    return x / np.clip(np.linalg.norm(x, axis=1, keepdims=True), 1e-12, None)
