"""PyTorch/CUDA port of the video summarization framework.

The JAX package ``dino_video_summarization_transformer_tpu`` beside this one
is the reference; every module here mirrors its counterpart's path so a
reader can find the pair. This package imports ``torch`` and numpy, never
``jax`` and nothing of the JAX package: whatever it needs from there it
keeps as its own copy.

Layout:
  config/    config tree + YAML/opts merge (YAML read lazily)
  models/    TimeSformer divided space-time backbone, checkpoint loading
  ops/       hand-written Hopper kernels (csrc/) with their plain twins
  data/      windows, selection, scoring / clip / frame-selection datasets,
             native decode, prefetch
  train/     the DINO losses and the train step
  engine/    per-frame scoring engine (FrameScorer, run_scoring); the
             evaluation consumers (kNN, linear probe, K400 classification)
  utils/     device resolution, numpy-seeded synthetic params and video

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
