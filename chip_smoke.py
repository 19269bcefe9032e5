#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Imports torch, numpy and the port package
(``dino_video_summarization_transformer_tpu_torch``) only. Phases:

1. card: require CUDA; print ``nvidia-smi``'s name and power limit.
2. build: compile the Hopper kernels from ``ops/csrc/`` with nvcc, one
   process per source, all started together; print each library's build
   time and ptxas's register / shared-memory lines (and its stack and
   spill lines where they are not zero).
3. kernels: first the strided scorer's new kernel geometries: rows 1f
   and 2f (``temporal_phase_tm`` on f32 x, ``spatial_mlp`` with an f32 CLS
   row) at the students' window (B=8, T=3: f32 students on the kernels) on
   offset rows, and rows 1 and 2 (bf16) at ``teacher_img=160``'s grid
   (N=100, B=8, T=30), each against its twin, timed beside its plain time
   and bound. Then the frame wire's gather (``wire.gather_normalize``)
   against its twin, bit for bit (max abs 0), on the rgb8, yuv420 and
   yuv420q layouts in f32 and bf16: the teacher (8 x 30) and student
   (8 x 3) views of one chunk from a 64-frame buffer, the banded flat
   gather (512 indices with padding repeats) from a 600-frame buffer, and
   packed 226 x 224 frames (H = 2 mod 4); its device time
   (torch.profiler), CUDA-event time a call, plain time and bytes bound.
   Then each kernel against its plain twin on the card at ViT-B/16
   widths (N=196, D=768, H=12, MLP 3072): the windowed pair at the teacher
   (B=8, T=30) and student (B=8, T=3) windows of the chunk-8 scorer; the
   training ops (the bf16 tier of the temporal op, the spatial phase, and
   the three backwards: temporal, spatial, MLP, each gradient held to its
   twin) at the train step's global (B=16 clips, T=8, N=196) and local
   (B=64, T=8, N=36) crops; the banded kernels at the full 512-frame bucket for the teacher (eff=30)
   and student (eff=3) passes; the XLA-layout block's two attention
   phases (``attn_phase`` on the windows' spatial sequences, (240, 197) and
   (24, 197) rows of 768; ``temporal_phase`` on (1568, 30) and (1568, 3),
   its branch through its f32-out tier)
   and the standalone ``fused_attention`` on the attention swap's head
   sequences (hd 64: (2880, 197), (18816, 30), (288, 197), (18816, 3), each
   on the tensor-core instance, which it prints; pack=4 equal to the
   unpacked call; an f32 check on the CUDA-core instance); CUDA-event times of kernel
   and twin beside the bound computed from the shapes, and for the banded
   temporal attention and ``fused_attention`` the time of
   ``F.scaled_dot_product_attention`` on the same tensors (with the band
   as a boolean mask for the former; a yardstick the port never calls;
   the other ops have no single-call PyTorch counterpart); for these two
   also the device time per call from a CUDA graph of ten calls, which
   the CUDA-event time of the wrapper calls exceeds where the wrapper's
   host time is longer than the kernel (the 3-row sequences). Rows 1
   (``temporal_phase_tm``, and its bf16-out tier 1b), 2 (``spatial_mlp``),
   3 (``mlp_phase``, also at the train step's crops), 6
   (``temporal_phase``) and 11 (``spatial_phase_pf``): their device time
   split into attention, GEMMs and LN (torch.profiler), and their blocks
   alone against their twins: the wgmma GEMM (``fused_block.gemm``) at
   each of their products with its epilogue, in TFLOP/s beside
   ``torch.matmul`` on the same operands, the spatial attention
   (``fused_block.spatial_attention``) at rows 2 and 11's head-sequences
   and the temporal attention (``fused_block.temporal_attention``, the
   tile at stride N) at rows 1, 1b and 6's, beside SDPA (yardsticks the
   port never calls). Row 4 (``spatial_phase``) at both crops: its device
   time split into attention, GEMMs and LN. Row 5 (``attn_phase``) at
   both windows: the same split. Row 12 (``cls_band_attn``) at both
   passes: its block shape on the card (strips, warps a strip, splits of
   the target frames), its device time from a CUDA graph, the bytes a
   model says it moves (``cls_band_bench.modelled_traffic``: each
   overlapping tile's patch K / V re-read counted as an HBM read; printed
   only, as nothing measures it) beside its bytes bound, two calls bit
   for bit. Rows 7
   (``temporal_phase_tm_bwd``), 8 (``spatial_phase_bwd``) and 9
   (``mlp_phase_bwd``) at both crops: their device time split into
   attention (forward recompute), attention backward, GEMMs, LN (with
   its backward, held to its bytes bound) and the rest; their blocks
   alone against their twins: the tile's attention backward with the CLS
   prefix (``fused_block.spatial_attention_bwd``) and at stride N
   (``temporal_attention_bwd``) beside SDPA's backward on tensors of the
   same shape, the LayerNorm backward of the three (``layer_norm_bwd``)
   beside its bytes bound and autograd of ``F.layer_norm``, every dX and
   dW product of rows 8 and 9 (``gemm_dx``, ``gemm_dw``, with the dW split
   count) and row 9's fc1 recompute with its two outputs
   (``gemm_gelu_grad``) in TFLOP/s beside ``torch.matmul``; row 9 also at
   the CLS-row calls of the train step (M = 16 and 64).
   The mixed teacher's f32 tiers, right after the windowed pair: row 1
   on f32 x and row 2 with an f32 CLS row and an f32 grid at the teacher
   window, rows 3 and 11 on f32 rows at the 512-frame bucket, on rows with
   a large common offset (``twin_check.offset_rows``: a kernel that rounds
   an f32 input to bf16 fails there), each output held on its branch,
   timed beside its bound with f32 bytes for the carries (rows 3 and 11's
   f32 tiers at the 512-frame bucket: the banded mixed teacher's, phase
   6b).
   Row 12's kernel and twin against its f32 reference (f32 probabilities,
   ``cls_band_attn_f32_plain``) at eff 30 and 3, printed.
4. windowed path, bf16: ``make_scorers`` + ``run_scoring`` on ViT-B/16 with
   numpy-seeded weights over two synthetic clips (64 and 40 frames);
   launch counters read around the run; losses held against the plain
   bf16 path and the f32 path; a profiled run of the 40-frame clip whose
   kernel launches by family must match the ops' counters: the wgmma GEMM
   and the tile (at stride N for row 1, with the CLS prefix for row 2),
   no gemm_kernel and no attn_kernel.
5. windowed path, f32: the reference-compat path (TF32 off) on the clips.
4b. windowed path, the mixed teacher: ``make_scorers(teacher_dtype=f32)``
   + ``run_scoring`` on the same clips (after phase 5, whose f32 losses it
   reuses): launch counters (each windowed kernel's bf16 tier for the
   students, its f32 tier for the teacher), a profiled run's families held
   to them, frames/s beside phase 4's; losses held against the plain
   mixed path (the same scorer with every kernel op through its twin,
   ``twins``) and the f32 path, and no further from f32 than phase 4's
   bf16 kernel path on each clip; then the teacher's CLS features on eight
   30-frame windows: the mixed teacher's closer to the f32 teacher's than
   the bf16 teacher's (the losses cannot show the teacher's precision
   where its softmax at temperature 0.02 is one-hot).
4c. windowed path on the frame wire: the clips' bytes (``make_video``'s
   uint8) packed as I420 (``yuv.pack_rgb``) and, unpacked on the host, as
   uint8 RGB; ``make_scorers`` + ``run_scoring`` on the bf16 kernel path on
   each, and the mixed teacher on packed: the wire's gather launched
   once per view gather (2 x chunks), the windowed kernels as in phases 4
   and 4b, frames/s beside phase 4's, a profiled run's families; each
   run's losses held (a) against the same scorer fed the f32 frames the
   twin makes on the card from the same bytes (identical views: <= 1e-6
   mean relative), (b) against the same scorer with every kernel op and
   the gather through its twin (``twins``) and (c) against the f32 path
   on the same wire, by phase 4's two rules.
4d. the int8 tier (W8A8; ``ops/quant.py``), its kernels first: the LN +
   quantize kernel (``fused_block.ln_quant_rows``) on bf16 and f32 rows
   and the row quantize kernel (``quant_rows``) at widths 768 and 3072,
   at the teacher (M = 240 x 196) and student (24 x 196) rows, codes and
   scales bit for bit against their twins; the s8 wgmma GEMM
   (``gemm_s8``) at rows 1q and 2q's products (qkv, proj, fc, fc1, fc2)
   at both row counts, its f32 output (the dequantized sums + bias) bit
   for bit against ``gemm_s8_plain`` and the path's epilogue by
   ``twin_check``, its TOPS beside ``torch._int_mm`` (cuBLASLt's s32
   product, a yardstick the port never calls) and the bf16 wgmma GEMM;
   rows 1q and 2q (``temporal_phase_tm`` / ``spatial_mlp`` on s8 weights)
   against their twins by ``twin_check``'s int8 rules at both windows,
   timed beside their bounds (GEMMs at the s8 peak) and split by kernel;
   then their f32 tiers, rows 1qf and 2qf (f32 x, an f32 CLS row, an f32
   grid: the int8 teacher under the mixed teacher) on offset rows, by the
   same rules and twin_check's f32 rule, each timed beside its bound and,
   in turns, beside row 1q / 2q. Then ``make_scorers`` + ``run_scoring`` on
   phase 4's clips with student-int8, teacher-int8, both, and teacher-int8
   under the mixed teacher: launch counters around each run, frames/s
   beside phase 4's, a profiled run's families, losses held against the
   plain int8 path (the same scorer with every kernel op through its twin)
   and phase 5's f32 path.
4e. the strided scorer and f32 students on the kernels: ``make_scorers(
   use_kernels=True, ...)`` + ``run_scoring`` on phase 4's clips with the
   knobs of JAX's bench modes ``exact-mixed-fused`` (f32 students and
   teacher on the f32 tier), ``turbo-mixed``, ``turbo2e-mt`` (JAX's
   default), ``turbo2e-mt-m2e`` (the guarded score stride),
   ``turbo2-q8sq8t`` (both int8 tiers) and ``teacher_img=160`` on exact
   bf16 windows (the 40-frame clip): launch counters held to the models'
   forwards (forward pre-hooks: each windowed op once a block of each
   forward, in the tier of its model's dtype and quantization), frames/s
   and teacher and student rows per frame beside phase 4's, a profiled run
   of the 40-frame clip (device busy, idle share, kernel families held to
   the counters), the refined
   knots of the kernels and of the twins; losses held against the same
   scorer with every kernel op through its twin (``twins``) and against
   the same knobs on the plain route at f32 (TF32 off; for
   ``exact-mixed-fused`` phase 5's losses). ``turbo2e-mt`` also with
   ``student_dispatch=1``, bit for bit the default's; ``exact-mixed-fused``
   prints its students' CLS-feature distance to the f32 students beside
   the bf16 kernel path's. Last, the teacher rows' interpolation on the
   card (Catmull-Rom and linear at ``turbo2e-mt``'s refined knots)
   against a float64 evaluation.
6. banded path, bf16: ``make_scorers(band_mode="both")`` + ``run_scoring``
   over clips of 64, 40 and 600 frames (the last in two segments at
   ``band_chunk`` 512, halo 32: buckets 512 and 256); launch counters read
   around the run (each banded kernel once per block of each pass, no
   windowed kernel); losses held against the plain bf16 and the f32 banded
   paths; a profiled run of the 600-frame clip for the device time inside
   the kernels and the device's idle share, its launches by kernel family
   held to the ops' counters as in phase 4 (rows 3 and 11 on the wgmma
   GEMM, row 11 on the tile; no gemm_kernel, no attn_kernel);
   the "teacher" hybrid on the
   64-frame clip with both kernel sets counted; frames/s beside the
   windowed path's, and the rank correlation of banded against exact
   losses (information only). Then the 600-frame
   clip on the wire (packed I420): the gather once per segment, losses
   held by phase 4c's (a)-(c) at the banded tolerance, and profiles of the
   float and the wire path: the host-to-device copy's device ms, its bytes
   and the clip's device busy ms.
6b. banded path, the mixed teacher (JAX's ``band-mt`` and ``band-t-mt``):
   ``make_scorers(band_mode="both", teacher_dtype=f32)`` + ``run_scoring``
   on phase 6's clips: launch counters (rows 10 and 12 in every pass, rows
   11f and 3f in each teacher pass, rows 11 and 3 in each student pass),
   frames/s beside ``band``'s, a profiled run of the 600-frame clip (its
   families held to the counters), each pass's views (the teacher's the
   clip's f32 frames bit for bit, the students' their bf16 rounding),
   losses held
   against the same scorer through its twins and phase 6's f32 banded
   losses by phase 6's two rules. The teacher's precision by two rules
   fixed before the first card run (PERF.md, PR 17's prediction): (a) its
   CLS rows (the scorer's teacher pass on the 64-frame clip) strictly
   closer to the f32 banded teacher's than the bf16 banded teacher's; (b)
   at teacher_temp 0.1, on each clip, mean |loss - f32 banded loss| below
   ``band``'s (at 0.02 printed only: the random-weight teacher is one-hot
   there). ``band-t-mt`` on the 64-frame clip: counters, losses against its
   twins and the f32 hybrid. Banded int8: the kernel route's refusal, and
   one plain-route run on the 40-frame clip with its losses printed beside
   ``band``'s.
7. DINO SSL train step, bf16: ``init_train_state`` + ``make_train_step``
   on ViT-B/16 (T=8, batch 8: 16 global 224-px and 64 local 96-px clips,
   out_dim 65536, AdamW) on the kernel route; launch counters read around
   one step (each per-phase forward once per block of the three forwards,
   each backward once per block of the two student passes, no scoring
   kernel); ms per step and TFLOP/s from ``train_step_flops``; the loss
   finite at every step; the teacher equal to the EMA of the new student;
   a profiled step, its launches by family held to the ops' counters
   (every op on the wgmma GEMM and the tiles; no gemm_kernel,
   attn_kernel, gemmx_kernel or attn_bwd_kernel; the dW partial sums
   counted from the backward calls' shapes); the backwards' launches of
   the counted step by row count. Before the steps, at
   batch 2 on the initial weights and one set of crops, the gradients of
   the kernel route against the plain bf16 route and the f32 route (TF32
   off).
7b. DINO SSL train step, the mixed tier (``make_train_step(route=
   "kernels", compute_dtype=torch.float32)``: f32 activations and
   carries, bf16 matmul operands). First its new kernels against their
   twins at phase 7's global and local crops, on offset rows (x, the CLS
   row and the cotangents): row 4f (``spatial_phase`` on f32 x and CLS
   row), rows 7f, 8f and 9f (the three backwards on f32 x and cotangents;
   9f also at the step's CLS rows), the LayerNorm backward's f32 instance
   alone (beside its bytes bound and torch's layer-norm backward) and row
   3's f32 tier at the crops' rows; each timed beside its twin and bound,
   the backwards' device time split by profile. Then, on phase 7's initial
   weights and batch-2 crops, the mixed kernel route against the mixed
   twin route (every op through its twin on the card, ``twins(fb)``) and
   phase 7's f32 gradients; then the step at phase 7's batch: launches
   per step (the f32 tiers only), ms per step and TFLOP/s beside phase
   7's, peak memory, the EMA check, a profiled step's launches by family.
7c. the trainer's variants (``phase_7c``): (a) rows 1b, 4, 3 and the
   backwards 7, 8, 9 against their twins at the rand-fr step's
   geometries (16 local clips of T = 2, 4 and 16 at N = 36, 8 global clips
   of T = 4 at N = 196; T = 16 runs the strided backward's whole-sequence
   strips), on offset rows, each timed beside its twin and bound; (b)
   ``make_rand_fr_train_step`` on the bf16 kernel route: gradients at
   batch 2 against the plain bf16 and f32 routes by phase 7's rules, then
   batch 8 (g4, g8: 8 clips of 224 px; l2-l16: 16 clips of 96 px):
   launches read around one step (per block 6 student and 2 teacher
   forwards, 6 backwards, no scoring kernel), ms and device busy a step,
   peak memory, finite losses, the EMA check; (e) the CLI's profiler
   helper (``train_ssl.StepProfiler``) around two rand-fr steps: its
   Chrome trace parses and names a port kernel; (c) rematerialized
   students (``remat=True``) at phase 7's batch-2 crops: gradients bit for
   bit the non-remat route's (or within its own run-to-run spread, where
   that is not zero), each student per-phase forward twice per block;
   then phase 7's batch: ms and device busy a step in turns with the
   non-remat step, peak memory of the forward and backward (remat's
   lower) and of the step; (d) the two-token step on the plain bf16
   route at batch 2: no port launch, a finite loss, a (2, out_dim) center
   that moved, the EMA check, its gradients' mean distance to the f32
   route's (printed); then the largest batch up to 8 that fits: ms,
   device busy, peak memory.
8. per-phase XLA-layout forward, bf16: ViT-B/16 (numpy-seeded weights)
   with every block through ``Block.forward(use_fused=True)`` (the
   model's ``tokens``, then the blocks one by one, then its norm) on B=8
   windows of 30 and of 3 frames; launches read around each forward (``temporal_phase`` and
   ``attn_phase`` once per block, ``mlp_phase`` twice, nothing else); CLS
   features held against the plain bf16 and the f32 forwards; a profiled
   T=30 forward, its launches by family held to the counters. Then one
   30-frame pass with drop-path (per-block rates linspace(0, 0.1, 12),
   masks from a seeded generator) against the plain route fed the same
   masks: ``attn_phase`` once per block (block 0's rate is 0, so its whole
   block runs the ops).
9. attention swap: ViT-B/16 with ``attention_kernel=True`` on the same
   windows, ``fused_attention`` launched twice per block; features held as
   in phase 8; a profiled T=30 forward, in which no family of the port's
   building blocks may appear; the f32 forward with the swap against the
   f32 forward without it.
10. shared-memory probe: ``tools/smem_probe.probe`` bisects the dynamic
   shared memory a block may opt into; it must reach the
   ``fused_block.SMEM_LIMIT`` the attention kernels assume.
11. the evaluation consumers (``phase_11``; ViT-B/16, numpy-seeded
   weights, clips in memory): (a) rows 1 and 2 (bf16) at the kNN and
   linear probe's batch (B=8, T=8) and rows 1f and 2f (the f32 tier) at
   the K400 classifier's clip (B=1, T=16; offset rows, twin_check's f32
   rule on every output), each against its twin and timed beside its
   plain time and bound; (b) ``engine.knn.extract_features`` on the bf16
   kernel route (``timesformer.eval_kernels``) over 3 batches of 8 clips
   (T=8, 224 px): the whole-block pair once per block a batch and nothing
   else, ms a batch and clips/s, features held to the plain bf16 and f32
   routes by phase 8's rule, and ``knn_predict`` on the card equal to the
   CPU's; (c) the K400 classifier (400 classes, T=16, B=1) at
   ``--precision bfloat16``'s semantics (the f32 model on bf16-rounded
   pixels: rows 1f and 2f once per block, nothing else): its logits held
   to its twin route (``twins``) and f32 by phase 8's rule, and no further
   from f32 than the bf16 kernel route's; ms a video; (d) three
   linear-probe steps on the kernel route (launches, ms, peak memory) and
   two finetune steps (f32 plain route, B=4, T=16: no port launch; ms a
   step, peak memory).
12. the trainer's variants on the other backbones (``phase_12``; ViT-B/16,
   T=8, seeded weights, out_dim 65536, AdamW): (a) the two-stream step
   (``make_two_stream_train_step``: ViT-S/16 motion nets, plain, on 224-px
   flow frames) and (b) the CNN-distillation step (a frozen S3D on the
   global clips, weight 1), each at batch 2 on the bf16 kernel route
   against the plain bf16 and f32 routes by phase 7's gradient rules, its
   loss terms against their computation from the modules at f32 (1e-5
   relative: the two-stream step's rgb, flow and cross terms; the DINO
   loss plus the distillation term), then at batch 8 (16 global and 64
   local clips, 16 flow frames): launches by row (phase 7's step's), ms
   and device busy a step, peak memory, every teacher the EMA of its
   student; the S3D's forward in bf16 compute against its f32 run; (c)
   the space-only and joint TimeSformers at batch 2: features and a train
   step's loss, plain bf16 against f32, with no port launch.
13. tensor parallelism and ZeRO-1 (``phase_13``; ViT-B/16): (a) tier C,
   the partial tier of rows 1, 4, 7 and 8 (rows 1p, 4p, 7p, 8p: one
   shard's heads, no proj / fc bias, no residual) for tp = 2 and 4 (Dq
   384 and 192) at the global crops (B=2, T=8, N=196) and at the crops
   (b)'s TP-fused step gives them (B=8, N=196 and B=32, N=36), every
   shard's outputs against its twin by the twin rules, the shards'
   partials summed with the once-applied biases against the unsharded
   rows 1, 4, 7 and 8, each op at B=2 timed beside its twin and its
   bound; (b) a world of 2 ranks on this one card (``parallel.launch``,
   gloo; the kernels built before the ranks start): 3 bf16 train steps
   at out_dim 65536, batch 4 (8 global, 32 local clips), of the TP-fused
   route (mesh 1 x 2), the plain TP route (1 x 2), ZeRO-1 over data
   parallelism (2 x 1) and plain data parallelism (2 x 1), each step's
   loss and rank 0's first-step gradients against a one-rank step on the
   same global batch, each rank's peak of allocated memory and moments;
   the TP-fused ranks' counters show the tier-C kernels per step and no
   twin call.

Tolerances (stated here, checked below):
* kernel vs twin (``ops/twin_check.py``, per output): both share every
  bf16 rounding point, so the gap is held against what the op computes,
  not what it passes through: the temporal op's out - x, the spatial
  grid's out - x1, the banded spatial and MLP phases' out - x (the
  branches, each far smaller than the stream of rms 1 they are added to),
  the CLS rows, the qkv buffers and the banded attention outputs.
  rms(err) <= 1e-2 x rms(branch); f32 outputs max|err| <= 2e-2 x
  max|branch|; bf16 outputs within 4 bf16 ulps of max(|want|,
  rms(branch)) at every element. The bf16 outputs of ``temporal_phase``,
  of ``temporal_phase_tm``'s bf16 tier and of ``spatial_phase``'s grid,
  bf16(x + bf16(branch)), are held in two parts: the branch through its
  f32-out tier (the same launches) at those bounds, and the output within
  2 bf16 ulps of the twin's (of max(|got|, |want|, max|branch|): the two
  last roundings' flips, ``twin_check.rounding_ulps``). PERF.md gives the readings they were set from and
  the planted faults they catch.
* per-frame losses against the f32 path (the oracle), on either path: the
  kernel path's mean absolute error <= 1.5 x the plain bf16 path's +
  1e-3. Both bf16 tiers sit a few % from f32 (the teacher softmax at
  temperature 0.02 amplifies feature rounding); the kernels' f32
  accumulation should keep them no further than the plain tier.
* the mixed teacher (phase 4b): the same two rules with the plain mixed
  path in the plain bf16 path's place (0.06 mean relative; 1.5x + 1e-3 of
  its gap to f32), its gap to f32 at most the bf16 kernel path's on the
  same clip (the tier's reason to exist), and its teacher features
  strictly closer to the f32 teacher's than the bf16 teacher's; the banded
  mixed teacher (phase 6b) by phase 6's two rules against its twins, the
  feature rule on its teacher pass, and at teacher_temp 0.1 its losses
  closer to f32 than the bf16 banded path's on every clip.
* the int8 tier (phase 4d): its three kernels' codes, scales and
  dequantized f32 sums bit for bit (max abs 0) against their twins, which
  do the same integer sums and the same roundings; rows 1q and 2q by
  ``twin_check``'s int8 rules (rel_rms <= 1e-2 and max|err| <= 2e-2 x
  max|branch| for every output, bf16 or f32: a code that flips where the
  twin's attention differs by an ulp redraws the row's rounding, which no
  element-wise ulp rule bounds), rows 1qf and 2qf also by the f32 rule
  (bf16_exact <= 1 %); each int8 scoring path's losses by the
  mixed teacher's two rules against the plain int8 path (0.06 mean
  relative; mean |loss - f32 loss| <= 1.5 x the plain int8 path's + 1e-3).
* the strided scorer (phase 4e): the mixed teacher's two rules against
  the twins (0.06 mean relative; mean |loss - f32 loss| <= 1.5 x the
  twins' + 1e-3, f32 being the same knobs at f32), no rule between two
  tiers' distances to f32; ``student_dispatch`` 1 and 4 bit for bit; the
  interpolation within 1e-5 x max|rows| of float64. The kernels and their
  twins may refine different knots where a knot's error sits near the
  threshold: the knots are printed, not compared.
* training-op gradients (f32) vs their twins: the same rms and max
  bounds; dx (bf16) within 4 ulps of its branch dx - dout. The mixed
  tier's f32 outputs at the same rules (dx, the grid and the CLS rows
  against their branches) and at ``twin_check``'s f32 rules, which one
  bf16 rounding (about 2^-9) breaks: at most 1 % of an f32 output's
  elements exactly representable in bf16 (``bf16_exact``; an unrounded
  one has ~2^-16), and the bias gradients summed from the f32 cotangent
  within 1e-4 of max|twin| (``sum_rel_max``; summed from its bf16 copy
  they sit ~1e-3 off).
* train step, kernel route vs the plain bf16 route: per parameter
  max|diff| / max|plain| < 0.15, and the mean distance to the f32
  gradients <= 1.5 x the plain bf16 route's + 1e-6 (the CPU test's
  bounds against JAX); the teacher after a step equals t * m + s * (1 - m)
  of the teacher before and the new student to 1e-6. The mixed tier
  (phase 7b): the same two rules against the mixed twin route, and its
  mean distance to f32 at most the bf16 kernel route's (phase 7).
* CLS features of the per-phase and attention-swap forwards (phases 8-9)
  against the f32 forward: the kernel route's mean absolute error <= 1.5 x
  the plain bf16 route's + 1e-3, the scoring paths' rule; the f32 forward
  with the swap within F32_SWAP_MAX (max) of the f32 forward without it,
  the CPU test's bound (``tests/test_torch_attention.py``), whose only
  difference is the bf16 rounding of the probabilities.
* tier C (phase 13a): each shard's outputs by the twin rules above; the
  shards' partials summed in f32 with the once-applied biases (b_comb =
  bproj Wfc^T + bfc, bproj) against the unsharded rows' branches (rows 1
  and 4's f32-out tiers; rows 7 and 8's f32 tiers for dx - dout and the
  gradients, fc's with its b_comb term) at rms <= 1e-2 x rms and max <=
  4e-2 x max (``PARTIAL_SUM_*``): each shard rounds its term to bf16 where
  the unsharded op rounds once (the CPU test's bounds). The world (13b):
  each step's loss within 2e-3 relative of the one-rank step's
  (``WORLD_LOSS_RTOL``, JAX's bound for its TP-fused step against the
  plain one); rank 0's first-step gradients, gathered, by the train
  step's rule: per parameter max|diff| / max|one rank| < 0.15.
* per-frame losses, kernel path vs the plain bf16 path: mean relative
  difference <= 0.06 on the windowed path, about 2x the largest sound
  reading (0.031; kernels with uniform attention read 0.072), and <= 0.04
  on the banded path, about 2x its largest sound reading (0.020; PERF.md
  gives the readings of planted faults).

Every phase prints its wall seconds. Any failed check exits non-zero
before the last line, which is
``{"ok": true, "device": {...}}``. The line before it lists every kernel as
JSON; the line before that is the card's name and power limit.
"""

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (dense): bf16 tensor cores, s8 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_S8_OPS = 1979e12
PEAK_BYTES = 3.35e12

TRAIN_OPS = ("temporal_phase_tm_bf16", "spatial_phase", "temporal_phase_tm_bwd",
             "spatial_phase_bwd", "mlp_phase_bwd")
TRAIN_GRAD_REL_MAX = 0.15
TRAIN_F32_RATIO = 1.5
# phase 12: the S3D's pooled features, bf16 compute (f32 weights: the input
# rounded to bf16, every layer in f32) against f32, max|diff| / max|f32|;
# a space-only or joint model's plain bf16 route against f32 (features
# max|diff| / max|f32|, the train loss relative)
S3D_BF16_REL_MAX = 2e-2
PLAIN_BF16_REL_MAX = 5e-2
LOSS_REL_TOL = 0.06
BAND_LOSS_REL_TOL = 0.04
LOSS_F32_RATIO = 1.5
# the f32 forward with the attention swap against the one without it: the
# CPU test's bound (tests/test_torch_attention.py; readings 0.5e-3 to
# 1.4e-3 at D=128, depth 2 to 12)
F32_SWAP_MAX = 5e-3
BAND_CLIPS = (64, 40, 600)
BAND_C = 512  # the full bucket (band_chunk)


def fail(msg):
    """Print ``FAIL: msg`` on standard output and on standard error (a
    caller that keeps only the end of one stream still sees why), then exit
    with code 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def dev_randn(seed, *shape, dtype=None):
    """N(0, 1) samples of ``shape`` drawn on the card from ``seed``, in
    ``dtype`` (bf16 by default): the blocks-alone timings' large operands,
    which numpy would take tens of seconds to draw on the host."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=g, device="cuda").to(dtype or torch.bfloat16)


def dev_offset_rows(seed, *shape, offset=4.0, spread=0.1):
    """``twin_check.offset_rows`` drawn on the card from ``seed``: f32 rows
    with a common offset of either sign and magnitude offset x (1 + |N(0,
    1)|) a row and a spread of spread x N(0, 1) an element."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = tuple(shape[:-1]) + (1,)
    mag = offset * (1.0 + torch.randn(rows, generator=g, device="cuda").abs())
    sign = torch.where(torch.rand(rows, generator=g, device="cuda") < 0.5, -1.0, 1.0)
    return sign * mag + spread * torch.randn(shape, generator=g, device="cuda")


def graph_ms(fn, reps=10, iters=10):
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, replayed ``iters`` times between two events, so no host time
    falls between the launches (``cuda_ms`` of a wrapper whose host time
    exceeds its kernel's reads the host's rate)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, iters) / reps


def bound_ms(flops, nbytes):
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3, (
        "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES
        else "bytes")


def temporal_cost(B, T, N, D):
    """FLOP and bytes the op must do: qkv, proj, fc GEMMs (10 D^2 per row)
    + attention over T (4 T D per row); x read (bf16), out written (f32),
    weights read once (bf16)."""
    M = B * T * N
    flops = M * (10 * D * D + 4 * T * D)
    nbytes = M * D * 2 + M * D * 4 + 5 * D * D * 2
    return flops, nbytes


def spatial_cost(B, T, N, D, Dh):
    """qkv over the grid rows plus one CLS row per sample, attention over
    L = N + 1 per frame, proj over grid + per-frame CLS rows, the MLP;
    x1 read (f32), cls read (bf16), grid out (bf16), CLS rows out (f32),
    weights once (bf16)."""
    M, L = B * T * N, N + 1
    flops = (2 * (M + B) * D * 3 * D + 4 * B * T * L * L * D
             + 2 * (M + B * T) * D * D + 4 * M * D * Dh)
    nbytes = (M * D * 4 + B * D * 2 + M * D * 2 + B * T * D * 4
              + (4 * D * D + 2 * D * Dh) * 2)
    return flops, nbytes


def temporal_f32_cost(B, T, N, D):
    """Row 1's f32-in tier: the GEMMs and attention of temporal_cost; x read
    and out written in f32, weights once (bf16)."""
    M = B * T * N
    return M * (10 * D * D + 4 * T * D), 2 * M * D * 4 + 5 * D * D * 2


def spatial_f32_cost(B, T, N, D, Dh):
    """Row 2's mixed tier: spatial_cost's operations; x1 read, the grid
    written, the CLS row read and the CLS rows written, all f32; weights
    once (bf16)."""
    M = B * T * N
    flops, _ = spatial_cost(B, T, N, D, Dh)
    return flops, 2 * M * D * 4 + B * D * 4 + B * T * D * 4 + (4 * D * D + 2 * D * Dh) * 2


def temporal_q8_cost(B, T, N, D):
    """Row 1's int8 tier: (s8 operations of its qkv, proj and fc GEMMs, 10
    D^2 per row; bf16 FLOP of its attention over T, 4 T D per row; bytes: x
    read (bf16), out written (f32), the s8 weights and their f32 scales and
    biases read once)."""
    M = B * T * N
    return M * 10 * D * D, M * 4 * T * D, M * D * 2 + M * D * 4 + 5 * D * D + 10 * D * 4


def spatial_q8_cost(B, T, N, D, Dh):
    """Row 2's int8 tier: (s8 operations of qkv over the grid and the CLS
    rows, proj over the grid and the per-frame CLS rows, fc1 and fc2; bf16
    FLOP of the attention over L = N + 1 per frame; bytes: x1 read (f32),
    cls read (bf16), grid out (bf16), CLS rows out (f32), the s8 weights and
    their f32 scales and biases once)."""
    M, L = B * T * N, N + 1
    ops = 2 * (M + B) * D * 3 * D + 2 * (M + B * T) * D * D + 4 * M * D * Dh
    nbytes = (M * D * 4 + B * D * 2 + M * D * 2 + B * T * D * 4
              + (4 * D * D + 2 * D * Dh) + (10 * D + 2 * Dh) * 4)
    return ops, 4 * B * T * L * L * D, nbytes


def temporal_q8_f32_cost(B, T, N, D):
    """Row 1qf (the int8 tier's f32 block boundary): temporal_q8_cost's
    operations; x read and out written in f32, the s8 weights and their
    f32 scales and biases once."""
    ops, flops, _ = temporal_q8_cost(B, T, N, D)
    M = B * T * N
    return ops, flops, 2 * M * D * 4 + 5 * D * D + 10 * D * 4


def spatial_q8_f32_cost(B, T, N, D, Dh):
    """Row 2qf: spatial_q8_cost's operations; x1 read, the grid written,
    the CLS row read and the CLS rows written, all f32; the s8 weights and
    their f32 scales and biases once."""
    ops, flops, _ = spatial_q8_cost(B, T, N, D, Dh)
    M = B * T * N
    return ops, flops, (2 * M * D * 4 + B * D * 4 + B * T * D * 4
                        + (4 * D * D + 2 * D * Dh) + (10 * D + 2 * Dh) * 4)


def bound_q8_ms(s8_ops, bf16_flops, nbytes):
    """The int8 tier's bound: its s8 operations at the s8 peak plus its bf16
    FLOP at the bf16 peak, or its bytes at the memory rate if longer."""
    t_ops = s8_ops / PEAK_S8_OPS + bf16_flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def band_temporal_cost(C, N, D, eff):
    """Scores and PV over each query frame's eff keys; qkv read, out
    written (bf16)."""
    return 4 * C * N * eff * D, C * N * 3 * D * 2 + C * N * D * 2


def pf_cost(C, N, D):
    """qkv over the grid and the C CLS rows, patch attention over L = N + 1
    keys per frame (the CLS rows' own attention output is not computed),
    proj over the grid; x and cls read, the grid and both qkv buffers
    written (bf16), weights once."""
    flops = (2 * (C * N + C) * D * 3 * D + 4 * C * N * (N + 1) * D
             + 2 * C * N * D * D)
    nbytes = ((C * N * D + C * D) * 2 + C * N * D * 2
              + (C * N + C) * 3 * D * 2 + 4 * D * D * 2)
    return flops, nbytes


def cls_band_cost(C, N, D, eff):
    """For each frame, eff pair softmaxes over N + 1 keys; the patch K/V
    columns and the CLS qkv rows read once, out written (bf16)."""
    return (4 * C * eff * (N + 1) * D,
            C * N * 2 * D * 2 + C * 3 * D * 2 + C * D * 2)


def mlp_cost(M, D, Dh, elem=2):
    """fc1 and fc2 over M rows; rows read and written (``elem`` bytes: bf16,
    or f32 for the mixed tier), weights once (bf16)."""
    return 4 * M * D * Dh, 2 * M * D * elem + 2 * D * Dh * 2


def pf_f32_cost(C, N, D):
    """Row 11's f32 tier: pf_cost's operations; x and the CLS rows read and
    the grid written in f32, both qkv buffers written (bf16), weights
    once."""
    flops, _ = pf_cost(C, N, D)
    return flops, ((C * N * D + C * D) * 4 + C * N * D * 4
                   + (C * N + C) * 3 * D * 2 + 4 * D * D * 2)


def temporal_bf16_cost(B, T, N, D):
    """The temporal op's GEMMs and attention; x read, out written (bf16),
    weights once (bf16)."""
    M = B * T * N
    return M * (10 * D * D + 4 * T * D), 2 * M * D * 2 + 5 * D * D * 2


def spatial_phase_cost(B, T, N, D):
    """qkv over the grid rows and one CLS row per clip, attention over L =
    N + 1 per frame, proj over the grid and the per-frame CLS rows; x and
    cls read, grid and CLS rows written (bf16), weights once."""
    M, L = B * T * N, N + 1
    flops = 2 * (M + B) * D * 3 * D + 4 * B * T * L * L * D + 2 * (M + B * T) * D * D
    return flops, 2 * M * D * 2 + B * D * 2 + B * T * D * 2 + 4 * D * D * 2


def temporal_bwd_cost(B, T, N, D):
    """Recompute (qkv, attention, proj: 8 D^2 + 4 T D per row) and
    backward (fc, proj: 8 D^2; qkv: 12 D^2; attention with its score
    recompute: 10 T D); x and dout read, dx written (bf16), weights read
    (bf16), gradients written (f32)."""
    M = B * T * N
    return (M * (28 * D * D + 14 * T * D),
            3 * M * D * 2 + 5 * D * D * 2 + (5 * D * D + 7 * D) * 4)


def spatial_bwd_cost(B, T, N, D):
    """Recompute (qkv over grid + CLS rows, attention), backward over the R
    = grid + per-frame CLS rows (proj: 4 D^2, qkv: 12 D^2 per row;
    attention with its score recompute: 14 L^2 D per frame); x, dgo read,
    dx written, cls and dco read (bf16), dcls written (f32), weights read,
    gradients written."""
    M, L = B * T * N, N + 1
    R = M + B * T
    flops = 6 * (M + B) * D * D + 14 * B * T * L * L * D + 16 * R * D * D
    nbytes = (3 * M * D * 2 + B * D * 2 + B * T * D * 2 + B * D * 4
              + 4 * D * D * 2 + (4 * D * D + 6 * D) * 4)
    return flops, nbytes


def mlp_bwd_cost(M, D, Dh):
    """fc1 recompute and the four backward GEMMs (10 M D Dh); x, do read,
    dx written (bf16), weights read (bf16), gradients written (f32)."""
    return (10 * M * D * Dh,
            3 * M * D * 2 + 2 * D * Dh * 2 + (2 * D * Dh + Dh + 3 * D) * 4)


def ln_bwd_cost(M, R, D, residual):
    """ln_bwd_kernel over R rows: dy read (f32), x read (bf16), the
    residual read and dx written (bf16) over the M grid rows, the R - M
    CLS rows' dx written (f32); ~10 FLOP per element."""
    return 10 * R * D, R * D * 6 + M * D * 2 * (1 + int(residual)) + (R - M) * D * 4


def attention_bwd_cost(BH, L, hd):
    """The attention backward's five products (S = Q K^T, dP, dV, dQ, dK:
    10 L^2 hd per sequence); q, k, v, da read, dq, dk, dv written
    (bf16)."""
    return 10 * BH * L * L * hd, 7 * BH * L * hd * 2


def spatial_phase_f32_cost(B, T, N, D):
    """Row 4f: spatial_phase_cost's operations; x and cls read, the grid and
    the CLS rows written, all f32; weights once (bf16)."""
    flops, _ = spatial_phase_cost(B, T, N, D)
    return flops, 2 * B * T * N * D * 4 + B * D * 4 + B * T * D * 4 + 4 * D * D * 2


def temporal_bwd_f32_cost(B, T, N, D):
    """Row 7f: temporal_bwd_cost's operations; x, dout read and dx written
    in f32, weights read (bf16), gradients written (f32)."""
    flops, _ = temporal_bwd_cost(B, T, N, D)
    M = B * T * N
    return flops, 3 * M * D * 4 + 5 * D * D * 2 + (5 * D * D + 7 * D) * 4


def spatial_bwd_f32_cost(B, T, N, D):
    """Row 8f: spatial_bwd_cost's operations; x, dgo read, dx written, cls,
    dco read and dcls written, all f32; weights read, gradients written."""
    flops, _ = spatial_bwd_cost(B, T, N, D)
    M = B * T * N
    return flops, (3 * M * D * 4 + B * D * 4 + B * T * D * 4 + B * D * 4
                   + 4 * D * D * 2 + (4 * D * D + 6 * D) * 4)


def mlp_bwd_f32_cost(M, D, Dh):
    """Row 9f: mlp_bwd_cost's operations; x, do read and dx written in
    f32, weights read (bf16), gradients written (f32)."""
    return (10 * M * D * Dh,
            3 * M * D * 4 + 2 * D * Dh * 2 + (2 * D * Dh + Dh + 3 * D) * 4)


def ln_bwd_f32_cost(M, R, D, residual):
    """ln_bwd_kernel<V, float> over R rows: ln_bwd_cost's reads and writes
    with x, the residual and dx in f32 (dy and x read for every row, the
    residual read and dx written over the M grid rows, the R - M CLS rows'
    dx written)."""
    return 10 * R * D, R * D * 8 + M * D * 4 * (1 + int(residual)) + (R - M) * D * 4


def attn_phase_cost(S, L, D):
    """qkv and proj GEMMs (8 D^2 per row) + attention over L (4 L D per
    row), the Pallas cost estimate; x read, out written (bf16), weights
    once (bf16)."""
    return S * L * (8 * D * D + 4 * L * D), 2 * S * L * D * 2 + 4 * D * D * 2


def temporal_phase_cost(S, L, D):
    """qkv, proj, fc GEMMs (10 D^2 per row) + attention over L; x read, out
    written (bf16), weights once (bf16)."""
    return S * L * (10 * D * D + 4 * L * D), 2 * S * L * D * 2 + 5 * D * D * 2


def attention_cost(BH, L, hd, elem):
    """Scores and PV over each sequence (4 L^2 hd); q, k, v read, out
    written, ``elem`` bytes each."""
    return 4 * BH * L * L * hd, 4 * BH * L * hd * elem


def kernel_breakdown(fn, on_record=None):
    """Device time by kernel name over one call of ``fn``
    (torch.profiler, CUDA activity): ([(name, count, ms)] largest first,
    wall ms of the call). A first call of ``fn`` runs in the profiler's
    warm-up step and is not recorded: kernels launched just after tracing
    starts can go unrecorded (seen on the card: a single op's first
    kernels missing from its profile). ``on_record`` runs between the two
    calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        # the step's switch to recording settles on the host after step()
        # returns; a call launched at once, and the activity of a call
        # collected right after it ends, have gone unrecorded on the card
        # (whole profiles of one op, three in a row): a pause on each side
        # of the recorded call, outside its wall time. The first kernels of
        # the recorded step have gone unrecorded too (the int8 row 1's first
        # one or two, in three profiles in a row, with one spin kernel ahead
        # of them): sixteen short spin kernels take that place, and their
        # rows are dropped
        time.sleep(0.05)
        for _ in range(16):
            torch.cuda._sleep(20_000)
        torch.cuda.synchronize()
        if on_record is not None:
            on_record()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(0.05)
    rows = [(e.key, e.count, e.device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_time_total > 0 and "spin_kernel" not in e.key]
    return sorted(rows, key=lambda r: -r[2]), wall


# kernel families by name in a profile: the port's building blocks
# (dvst_common.cuh: ln_kernel and the backwards' ln_bwd_kernel,
# colsum_kernel and the two reduce_splits kernels; wgmma_gemm.cuh:
# wg_gemm_kernel; tc_attention.cuh: tc_prefix_attn_kernel_*,
# tc_strided_attn_kernel_*, tc_prefix_attn_bwd_kernel,
# tc_strided_attn_bwd_kernel; banded_block.cu: row 12's
# cls_band_tc_kernel), and the first design's gemm_kernel, attn_kernel,
# gemmx_kernel and attn_bwd_kernel, which no op launches any more (so any
# launch of them fails the check)
FAMILIES = {"gemm_kernel": "::gemm_kernel<", "attn_kernel": "::attn_kernel<",
            "wg_gemm_kernel": "::wg_gemm_kernel<",
            "tc_prefix_attn": "::tc_prefix_attn_kernel_",
            "tc_strided_attn": "::tc_strided_attn_kernel_", "ln_kernel": "::ln_kernel<",
            "gemmx_kernel": "::gemmx_kernel<", "attn_bwd_kernel": "::attn_bwd_kernel<",
            "tc_prefix_attn_bwd": "::tc_prefix_attn_bwd_kernel<",
            "tc_strided_attn_bwd": "::tc_strided_attn_bwd_kernel<",
            "ln_bwd_kernel": "::ln_bwd_kernel<", "colsum_kernel": "::colsum_kernel<",
            "cast_colsum": "::cast_colsum_kernel(",
            "reduce_splits_narrow": "::reduce_splits_narrow_kernel(",
            "reduce_splits": "::reduce_splits_kernel(",
            "cls_band_tc": "::cls_band_tc_kernel<",
            "gather_normalize": "::gather_normalize_kernel<",
            # the int8 tier's (wg_gemm_s8: the wgmma GEMM's s8 instance,
            # counted in wg_gemm_kernel too)
            "ln_quant_kernel": "::ln_quant_kernel<",
            "quant_rows_kernel": "::quant_rows_kernel(",
            "wg_gemm_s8": ", false, false, true>("}
# launches of each family per call of the ops that use them: every row on
# the wgmma GEMM and the tiles (row 4: qkv of the grid and of the CLS
# rows, proj of each; row 5: qkv, proj, the tile at stride 1; row 7: qkv
# and proj recomputed, three dX, three dW; row 8: qkv, two dX, two dW;
# row 9: fc1, two dX, two dW); row 12 on its own kernel, once a call (the
# adds of its split partials are not counted). The backwards' column sums
# and LN backward add their partials with reduce_splits_narrow (one each);
# the dW partial sums (reduce_splits, where a weight gradient takes more
# than one split: the split count depends on the shape and the card) are
# counted from the calls' shapes (dw_reduces).
TEMPORAL_FAMILIES = {"ln_kernel": 1, "wg_gemm_kernel": 3, "tc_strided_attn": 1}
FAMILY_PER_OP = {
    "temporal_phase_tm": TEMPORAL_FAMILIES,
    "temporal_phase_tm_bf16": TEMPORAL_FAMILIES,
    "temporal_phase": TEMPORAL_FAMILIES,
    "spatial_mlp": {"ln_kernel": 3, "wg_gemm_kernel": 6, "tc_prefix_attn": 1},
    "spatial_phase_pf": {"ln_kernel": 2, "wg_gemm_kernel": 3, "tc_prefix_attn": 1},
    "mlp_phase": {"ln_kernel": 1, "wg_gemm_kernel": 2},
    # the f32 tiers of the mixed teacher: the same launches
    "temporal_phase_tm_f32": TEMPORAL_FAMILIES,
    "spatial_mlp_f32": {"ln_kernel": 3, "wg_gemm_kernel": 6, "tc_prefix_attn": 1},
    "spatial_phase_pf_f32": {"ln_kernel": 2, "wg_gemm_kernel": 3, "tc_prefix_attn": 1},
    "mlp_phase_f32": {"ln_kernel": 1, "wg_gemm_kernel": 2},
    "spatial_phase": {"ln_kernel": 2, "wg_gemm_kernel": 4, "tc_prefix_attn": 1},
    "attn_phase": {"ln_kernel": 1, "wg_gemm_kernel": 2, "tc_strided_attn": 1},
    "cls_band_attn": {"cls_band_tc": 1},
    # the int8 tier: LN + quantize, each product an s8 GEMM on rows quantized
    # just before it (fb.Q8_LAUNCHES)
    "temporal_phase_tm_q8": {"ln_quant_kernel": 1, "wg_gemm_kernel": 3, "wg_gemm_s8": 3,
                             "tc_strided_attn": 1, "quant_rows_kernel": 2},
    "spatial_mlp_q8": {"ln_quant_kernel": 3, "wg_gemm_kernel": 6, "wg_gemm_s8": 6,
                       "tc_prefix_attn": 1, "quant_rows_kernel": 3},
    "gather_normalize": {"gather_normalize": 1},
    "temporal_phase_tm_bwd": {"ln_kernel": 1, "wg_gemm_kernel": 8, "tc_strided_attn": 1,
                              "tc_strided_attn_bwd": 1, "ln_bwd_kernel": 1,
                              "colsum_kernel": 3, "reduce_splits_narrow": 4},
    "spatial_phase_bwd": {"ln_kernel": 2, "wg_gemm_kernel": 5, "tc_prefix_attn": 1,
                          "tc_prefix_attn_bwd": 1, "ln_bwd_kernel": 1,
                          "colsum_kernel": 2, "reduce_splits_narrow": 3},
    "mlp_phase_bwd": {"ln_kernel": 1, "wg_gemm_kernel": 5, "ln_bwd_kernel": 1,
                      "colsum_kernel": 2, "reduce_splits_narrow": 3},
    # the trainer's mixed tier: the same launches, the incoming cotangent's
    # column sum a cast_colsum pass (its bf16 copy and its f32 sums)
    "spatial_phase_f32": {"ln_kernel": 2, "wg_gemm_kernel": 4, "tc_prefix_attn": 1},
    "temporal_phase_tm_bwd_f32": {"ln_kernel": 1, "wg_gemm_kernel": 8, "tc_strided_attn": 1,
                                  "tc_strided_attn_bwd": 1, "ln_bwd_kernel": 1,
                                  "colsum_kernel": 2, "cast_colsum": 1,
                                  "reduce_splits_narrow": 4},
    "spatial_phase_bwd_f32": {"ln_kernel": 2, "wg_gemm_kernel": 5, "tc_prefix_attn": 1,
                              "tc_prefix_attn_bwd": 1, "ln_bwd_kernel": 1,
                              "colsum_kernel": 1, "cast_colsum": 1, "reduce_splits_narrow": 3},
    "mlp_phase_bwd_f32": {"ln_kernel": 1, "wg_gemm_kernel": 5, "ln_bwd_kernel": 1,
                          "colsum_kernel": 1, "cast_colsum": 1, "reduce_splits_narrow": 3},
}
# the int8 tier's f32 tier (the int8 teacher under the mixed teacher): the
# same launches
FAMILY_PER_OP.update({f"{op}_f32": FAMILY_PER_OP[op]
                      for op in ("temporal_phase_tm_q8", "spatial_mlp_q8")})


def dw_reduces(fb, calls, D, Dh):
    """reduce_splits launches of the backward calls ``calls`` ({(op, rows):
    count}): one for each weight gradient the card splits (row 7: fc, proj,
    qkv; row 8: proj, qkv; row 9: fc2, fc1)."""
    shapes = {"temporal_phase_tm_bwd": [(D, D), (D, D), (3 * D, D)],
              "spatial_phase_bwd": [(D, D), (3 * D, D)],
              "mlp_phase_bwd": [(D, Dh), (Dh, D)]}  # either tier
    return sum(n * sum(fb.gemm_dw_splits(rows, o, i) > 1 for o, i in shapes[op])
               for (op, rows), n in calls.items())


def family_counts(rows):
    return {f: sum(n for k, n, _ in rows if pat in k) for f, pat in FAMILIES.items()}


def split_ms(rows):
    """Device ms of one op's profile by block: attention, the attention
    backward (where the op has one), GEMMs, LN (and its backward), rest."""
    out = {"attention": 0.0, "attention_bwd": 0.0, "gemm": 0.0, "ln": 0.0,
           "quantize": 0.0, "other": 0.0}
    for k, _, ms in rows:
        part = ("attention_bwd" if "attn_bwd" in k else "attention" if "attn" in k
                else "gemm" if "gemm" in k
                else "ln" if "::ln_kernel<" in k or "::ln_bwd_kernel<" in k
                else "quantize" if "quant" in k else "other")
        out[part] += ms
    for k in ("attention_bwd", "quantize"):
        if not out[k]:
            del out[k]
    return out


def record_split(tag, fn, row, top=None, op=None):
    """Profile one call of ``fn``: print its kernels, and add its device
    time and the split of ``split_ms`` to ``row``. The card's profiler has
    recorded none of a call's kernels (row 5's first profile after the
    CUDA-graph timings, H100): a profile that saw no device time, or fewer
    launches of a family than ``op`` makes (FAMILY_PER_OP), is taken
    again, twice at most; if the third misses too, the smoke fails rather
    than record a time it did not see."""
    for attempt in range(3):
        rows, _ = kernel_breakdown(fn)
        seen = family_counts(rows)
        short = [f for f, n in FAMILY_PER_OP.get(op, {}).items() if seen[f] < n]
        if rows and not short:
            break
        print(f"  {tag}: the profile missed kernels ({short or 'all'}; it recorded "
              f"{len(rows)} kernel names: {[k[:40] for k, _, _ in rows]})"
              + ("; profiling again" if attempt < 2 else ""), flush=True)
        time.sleep(1.0)  # let the profiler's collection settle first
    else:
        fail(f"{tag}: three profiles missed kernels ({short or 'all'})")
    total = sum(r[2] for r in rows)
    print(f"  {tag} by kernel (torch.profiler, {total:.3f} ms device time):",
          flush=True)
    for k, n, ms in rows[:top]:
        print(f"    {ms:8.3f} ms {n:3d}x {k[:90]}", flush=True)
    row["device_ms"], row["split_ms"] = total, split_ms(rows)
    print(f"  {tag} split: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in row["split_ms"].items()), flush=True)
    return rows


def expected_families(ops, reduces=0):
    """Launches by kernel family that the ops' launch counters ``ops`` (and
    ``reduces`` dW partial sums) account for."""
    want = {f: sum(n * FAMILY_PER_OP.get(op, {}).get(f, 0) for op, n in ops.items())
            for f in FAMILIES}
    want["reduce_splits"] += reduces
    return want


def check_families(tag, rows, ops, reduces=0):
    """The profiled run's launches by kernel family against what the ops'
    launch counters say they launched (and ``reduces`` dW partial sums): the
    first design's gemm_kernel, attn_kernel, gemmx_kernel and
    attn_bwd_kernel nowhere."""
    seen, want = family_counts(rows), expected_families(ops, reduces)
    print(f"  {tag}: kernel launches by family {seen}, expected from the ops' "
          f"counters {want}", flush=True)
    if seen != want:
        for k, n, ms in rows:
            if any(pat in k for pat in FAMILIES.values()):
                print(f"    {ms:8.3f} ms {n:5d}x {k[:100]}", flush=True)
        fail(f"{tag}: kernel families {seen}, expected {want}")


def print_profile(tag, fn, top=10, on_record=None):
    """Print one profiled call of ``fn``: wall, device busy and idle share,
    the share inside the port's kernels, the largest kernels; returns the
    rows by kernel."""
    rows, wall = kernel_breakdown(fn, on_record)
    busy = sum(r[2] for r in rows)
    # the port's kernels live in an anonymous namespace; PyTorch's do not
    ours = sum(r[2] for r in rows if "(anonymous namespace)::" in r[0])
    print(f"  {tag}, profiled: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"(idle share {1 - busy / wall:.1%}), inside the port's kernels "
          f"{ours:.1f} ms ({ours / max(busy, 1e-9):.1%} of device time); by kernel:",
          flush=True)
    for k, n, ms in rows[:top]:
        print(f"    {ms:8.3f} ms {n:4d}x {k[:90]}", flush=True)
    return rows


def checked_profile(tag, family_tag, fn, reset, counts, top=10, reduces=0):
    """``print_profile`` of one call of ``fn`` (``reset`` zeroes the ops'
    counters before the recorded call), then ``check_families`` against the
    counters. The card's profiler has dropped the first kernels of a
    recorded call even after the warm-up call (the first 22 of a train
    step, once in six runs on the H100): a profile whose launches by
    family differ from the counters' is taken again, twice at most (as in
    ``record_split``), and the check reads the last. A launch the counters
    do not account for is made by the code, so it shows in every profile
    and still fails the check. Returns the rows by kernel."""
    for attempt in range(3):
        rows = print_profile(tag, fn, top, on_record=reset)
        seen, want = family_counts(rows), expected_families(counts(), reduces)
        if seen == want or attempt == 2:
            break
        off = {f: seen[f] - want[f] for f in FAMILIES if seen[f] != want[f]}
        print(f"  {family_tag}: the profile's launches differ from the counters' by {off}; "
              "profiling again", flush=True)
        time.sleep(1.0)  # let the profiler's collection settle first
    check_families(family_tag, rows, counts(), reduces)
    return rows


def check_close(name, got, want, base=None, q8=False, quiet=False):
    """Print the kernel's gap to its twin (ops/twin_check.py; ``q8``: the
    int8 tier's rules; ``quiet``: only if it fails); True if it is within
    tolerance."""
    from dino_video_summarization_transformer_tpu_torch.ops import twin_check

    gap = twin_check.twin_gap(got, want, base)
    bad = twin_check.twin_failures(gap, q8)
    ulps = f" max_ulps={gap['max_ulps']:.2f}" if "max_ulps" in gap else ""
    if quiet and not bad:
        return True, gap
    print(f"  {name}: max_abs_err={gap['max_abs_err']:.3e} rms_err="
          f"{gap['rms_err']:.3e} ref_rms={gap['ref_rms']:.3e} ref_max="
          f"{gap['ref_max']:.3e} rel_rms={gap['rel_rms']:.3e} rel_max="
          f"{gap['rel_max']:.3e}{ulps} {'ok' if not bad else 'FAILED: ' + '; '.join(bad)}",
          flush=True)
    return not bad, gap


def grad_distances(gk, gp, gf):
    """The train phases' gradient rules' readings: the worst max|kernel -
    reference| / max|reference| over the parameters as (name, value), and
    the mean over the parameters of the kernel and reference routes' mean
    distance to f32 (each over mean|f32|)."""
    worst, e_k, e_p = ("", 0.0), 0.0, 0.0
    for n in gf:
        rel = float((gk[n] - gp[n]).abs().max() / (gp[n].abs().max() + 1e-12))
        worst = max(worst, (n, rel), key=lambda t: t[1])
        scale = float(gf[n].abs().mean()) + 1e-12
        e_k += float((gk[n] - gf[n]).abs().mean()) / scale
        e_p += float((gp[n] - gf[n]).abs().mean()) / scale
    return worst, e_k / len(gf), e_p / len(gf)


def train_op_checks(fb, p, H, D, Dh, tag, x, cls, dout, dco, stats, split=False):
    """Rows 1b, 4, 7, 8 and 9 at one crop geometry, x and dout (B, T, N, D),
    cls (B, 1, D) and dco (B, T, D) bf16, against their plain twins by the
    training ops' twin rules, then each timed beside its twin and its bound
    (a row appended to ``stats[op]``); row 3 at the grid's rows likewise
    (its row returned). Rows 1b and 4's bf16 outputs are bf16(x +
    bf16(branch)): the branch is held through the f32-out tier of the same
    launches, the bf16 output at ``twin_check.ROUNDING_ULPS`` of the
    twin's. ``split``: also each op's device time split by profile (the
    backwards' LN backward beside its bytes bound). Fails on a
    disagreement."""
    import torch

    from dino_video_summarization_transformer_tpu_torch.ops import twin_check

    bf16 = torch.bfloat16
    B, T, Np, _ = x.shape
    xm, dm = x.reshape(-1, D), dout.reshape(-1, D)
    pt, ps = p["temporal"], p["spatial"]
    runs = {
        "temporal_phase_tm_bf16": (
            lambda: fb.temporal_phase_tm(x, pt, H, out_dtype=bf16),
            lambda: fb.temporal_phase_tm_plain(x, pt, H, bf16),
            temporal_bf16_cost(B, T, Np, D)),
        "spatial_phase": (
            lambda: fb.spatial_phase(x, cls, ps, H),
            lambda: fb.spatial_phase_plain(x, cls, ps, H),
            spatial_phase_cost(B, T, Np, D)),
        "temporal_phase_tm_bwd": (
            lambda: fb.temporal_phase_tm_bwd(x, dout, pt, H),
            lambda: fb.temporal_phase_tm_bwd_plain(x, dout, pt, H),
            temporal_bwd_cost(B, T, Np, D)),
        "spatial_phase_bwd": (
            lambda: fb.spatial_phase_bwd(x, cls, dout, dco, ps, H),
            lambda: fb.spatial_phase_bwd_plain(x, cls, dout, dco, ps, H),
            spatial_bwd_cost(B, T, Np, D)),
        "mlp_phase_bwd": (
            lambda: fb.mlp_phase_bwd(xm, dm, ps),
            lambda: fb.mlp_phase_bwd_plain(xm, dm, ps),
            mlp_bwd_cost(B * T * Np, D, Dh)),
    }
    geo = f"{tag} B={B} T={T} N={Np}"
    with torch.inference_mode():
        checks, bf16_out = {}, {}
        for name, (kern, plain, _) in runs.items():
            got, want = kern(), plain()
            lbl = f"{name} {geo}"
            if name in ("temporal_phase_tm_bf16", "spatial_phase"):
                grid, want_grid = (got, want) if name == "temporal_phase_tm_bf16" else (
                    got[0], want[0])
                ulps = twin_check.rounding_ulps(grid, want_grid, x)
                err = float((grid.float() - want_grid.float()).abs().max())
                print(f"  {lbl} bf16 out: max_abs_err={err:.3e} {ulps:.2f} ulps (<= "
                      f"{twin_check.ROUNDING_ULPS})", flush=True)
                if ulps > twin_check.ROUNDING_ULPS:
                    fail(f"{lbl}: the bf16 output is {ulps:.2f} ulps from its twin's")
                bf16_out[name] = (err, ulps)
                if name == "temporal_phase_tm_bf16":
                    checks[name] = [check_close(
                        f"{lbl} f32-out tier out-x", fb.temporal_phase_tm(x, pt, H),
                        fb.temporal_phase_tm_plain(x, pt, H), x)]
                else:
                    checks[name] = [
                        check_close(f"{lbl} f32-out tier grid-x",
                                    fb.spatial_phase(x, cls, ps, H, out_dtype=torch.float32)[0],
                                    fb.spatial_phase_plain(x, cls, ps, H, torch.float32)[0], x),
                        check_close(f"{lbl} cls rows", got[1], want[1])]
            else:
                base = dm if name == "mlp_phase_bwd" else dout
                c = [check_close(f"{lbl} dx-dout", got[0], want[0], base)]
                if name == "spatial_phase_bwd":
                    c.append(check_close(f"{lbl} dcls", got[1], want[1]))
                c += [check_close(f"{lbl} d{k}", got[-1][k], want[-1][k]) for k in want[-1]]
                checks[name] = c
            del got, want
        if not all(ok for v in checks.values() for ok, _ in v):
            fail(f"a training kernel disagrees with its plain twin ({geo})")
        for name, (kern, plain, cost) in runs.items():
            ms = cuda_ms(kern, 5)
            pl = cuda_ms(plain, 1, warmup=1)
            b, by = bound_ms(*cost)
            gaps = [gap for _, gap in checks[name]]
            row = {"crops": tag, "B": B, "T": T, "N": Np, "ms": ms, "plain_ms": pl,
                   "bound_ms": b, "bound_by": by, "library_ms": None,
                   "max_abs_err": max(g["max_abs_err"] for g in gaps),
                   "rel_rms": max(g["rel_rms"] for g in gaps)}
            if name in bf16_out:  # the bf16 output's gap
                err, ulps = bf16_out[name]
                row.update(max_abs_err=max([err] + [g["max_abs_err"] for g in gaps[1:]]),
                           max_ulps=ulps, f32_tier_max_abs_err=gaps[0]["max_abs_err"])
            stats[name].append(row)
            print(f"  {name} {geo}: kernel {ms:.3f} ms, plain {pl:.3f} ms, bound "
                  f"{b:.4f} ms ({by}), {b / ms:.1%} of bound", flush=True)
            if split and name in bf16_out:
                record_split(f"{name} {tag}", kern, row, op=name)
        # row 3 at the crop's rows, as the train step's forwards run it
        Mx = B * T * Np
        ok, gap = check_close(f"mlp_phase {geo} out-x M={Mx}", fb.mlp_phase(xm, ps),
                              fb.mlp_phase_plain(xm, ps), xm)
        if not ok:
            fail(f"mlp_phase disagrees with its plain twin ({geo})")
        ms = cuda_ms(lambda: fb.mlp_phase(xm, ps), 5)
        pl = cuda_ms(lambda: fb.mlp_phase_plain(xm, ps), 1, warmup=1)
        b, by = bound_ms(*mlp_cost(Mx, D, Dh))
        mlp_row = {"crops": tag, "M": Mx, "ms": ms, "plain_ms": pl, "bound_ms": b,
                   "bound_by": by, "max_abs_err": gap["max_abs_err"], "rel_rms": gap["rel_rms"]}
        print(f"  mlp_phase {geo} M={Mx}: kernel {ms:.3f} ms, plain {pl:.3f} ms, "
              f"bound {b:.4f} ms ({by}), {b / ms:.1%} of bound", flush=True)
        if split:
            record_split(f"mlp_phase {tag}", lambda: fb.mlp_phase(xm, ps), mlp_row,
                         op="mlp_phase")
    if split:
        # where the time goes inside each backward: rows 7, 8 and 9 split by
        # block, ln_bwd_kernel beside its bytes bound
        for name, R_ in (("temporal_phase_tm_bwd", B * T * Np),
                         ("spatial_phase_bwd", B * T * Np + B * T),
                         ("mlp_phase_bwd", B * T * Np)):
            row = stats[name][-1]
            rows = record_split(f"{name} {tag}", runs[name][0], row, top=16, op=name)
            lb_ms = sum(ms for k, _, ms in rows if "::ln_bwd_kernel<" in k)
            lb_bound, _ = bound_ms(*ln_bwd_cost(B * T * Np, R_, D, True))
            row["ln_bwd"] = {"ms": lb_ms, "bound_ms": lb_bound, "bound_by": "bytes"}
            print(f"  {name} {tag}: ln_bwd_kernel {lb_ms:.4f} ms, bytes bound "
                  f"{lb_bound:.4f} ms ({lb_bound / max(lb_ms, 1e-9):.1%})", flush=True)
    return mlp_row


def spearman(a, b):
    import numpy as np

    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    ra -= ra.mean()
    rb -= rb.mean()
    return float((ra * rb).sum() / math.sqrt((ra * ra).sum() * (rb * rb).sum()))


def feature_checks(tag, got, plain, f32):
    """Hold a kernel route's CLS features against the plain bf16 route's and
    the f32 route's on the same input: finite, the same shape, and the
    kernel route's mean |error| against f32 at most LOSS_F32_RATIO x the
    plain bf16 route's + 1e-3."""
    if got.shape != f32.shape or not bool(got.isfinite().all()):
        fail(f"{tag}: features of shape {tuple(got.shape)}, expected "
             f"{tuple(f32.shape)}, all finite")
    e_k = float((got.float() - f32).abs().mean())
    e_p = float((plain.float() - f32).abs().mean())
    print(f"  {tag}: features vs f32 mean abs: kernel route {e_k:.3e}, plain "
          f"bf16 {e_p:.3e} (need kernel <= {LOSS_F32_RATIO} x plain + 1e-3)",
          flush=True)
    if e_k > LOSS_F32_RATIO * e_p + 1e-3:
        fail(f"{tag}: the kernel route is further from f32 than allowed")


def loss_checks(tag, clips, got, plain, f32, rel_tol, plain_name="plain bf16",
                bf16_kernels=None):
    """Hold the kernel path's per-frame losses against the plain path
    (``plain_name``) and the f32 path; with ``bf16_kernels`` (the bf16
    kernel path's losses on the same clips, for the mixed teacher) also
    require the kernel path no further from f32 than that. Every reading
    is printed before any check can fail."""
    import numpy as np

    for key, n in clips:
        k, pb, ref = (np.asarray(d[key]) for d in (got, plain, f32))
        if not np.all(np.isfinite(ref)) or len(ref) != n:
            fail(f"{tag} {key}: f32 losses missing or non-finite")
        if not np.all(np.isfinite(pb)) or len(pb) != n:
            fail(f"{tag} {key}: {plain_name} losses missing or non-finite")
        if not np.all(np.isfinite(k)) or len(k) != n:
            fail(f"{tag} {key}: kernel-path losses missing or non-finite")
        rel = float(np.mean(np.abs(k - pb)) / np.mean(np.abs(pb)))
        e_k = float(np.mean(np.abs(k - ref)))
        e_p = float(np.mean(np.abs(pb - ref)))
        e_b = None if bf16_kernels is None else float(
            np.mean(np.abs(np.asarray(bf16_kernels[key]) - ref)))
        print(f"  {tag} {key}: mean loss (f32) {np.mean(ref):.4f}; vs f32 mean "
              f"abs: kernel path {e_k:.3e}, {plain_name} {e_p:.3e} (need kernel "
              f"<= {LOSS_F32_RATIO} x plain + 1e-3)"
              + ("" if e_b is None else f", bf16 kernel path {e_b:.3e} (need "
                 "kernel <= it)")
              + f"; kernel vs {plain_name} mean rel {rel:.3e} (<= {rel_tol})",
              flush=True)
        if e_k > LOSS_F32_RATIO * e_p + 1e-3:
            fail(f"{tag} {key}: the kernel path is further from f32 than allowed")
        if rel > rel_tol:
            fail(f"{tag} {key}: kernel-path losses disagree with the {plain_name} path")
        if e_b is not None and e_k > e_b:
            fail(f"{tag} {key}: the mixed teacher's kernel path is further from "
                 "f32 than the bf16 kernel path")


@contextlib.contextmanager
def twins(*modules):
    """Within the block, every kernel op of the given op modules that the
    scoring paths and the training Functions call runs its plain twin
    (``<op>_plain``) on the card: the plain path of a tier that has no
    plain route of its own (the mixed teacher, the trainer's mixed tier:
    the same dtype policy, the kernels' arithmetic in torch). The ops'
    launch counters do not move."""
    ops = ("temporal_phase_tm", "spatial_mlp", "mlp_phase", "banded_temporal_attn",
           "spatial_phase_pf", "cls_band_attn", "gather_normalize",
           # the training ops the autograd Functions call
           "spatial_phase", "temporal_phase_tm_bwd", "spatial_phase_bwd", "mlp_phase_bwd")
    saved = [(m, k, getattr(m, k)) for m in modules for k in ops if hasattr(m, k)]
    try:
        for m, k, _ in saved:
            setattr(m, k, getattr(m, k + "_plain"))
        yield
    finally:
        for m, k, fn in saved:
            setattr(m, k, fn)


def phase_7c(fb, p, dev, card, reset_counts, counts, part, phase7):
    """Phase 7c, the trainer's variants at ViT-B/16 (numpy-seeded weights
    for the ops, seeded ones for the steps; out_dim 65536, AdamW): (a) rows
    1b, 3, 4 and 7-9 at the rand-fr step's geometries against their twins;
    (b) the rand-fr step on the bf16 kernel route (gradients against the
    plain bf16 and f32 routes at batch 2, then batch 8: launches, ms and
    device busy a step, peak memory, losses, the EMA); (e) the CLI's
    profiler helper around two rand-fr steps; (c) rematerialized students
    against the non-remat kernel route (gradients, launches, ms, peak
    memory); (d) the two-token step on the plain bf16 route. ``phase7``:
    phase 7's bf16 step (its "ms", "peak" and "crops"). Returns the
    kernels line's additions: (rows by op at the rand-fr geometries,
    launches per rand-fr step, launches per remat forward and backward)."""
    import torch

    from dino_video_summarization_transformer_tpu_torch import train_ssl
    from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf
    from dino_video_summarization_transformer_tpu_torch.train import ssl

    bf16 = torch.bfloat16
    tcfg = tsf.vit_base_config(num_frames=8, num_classes=0)
    D, H, N, depth = tcfg.embed_dim, tcfg.num_heads, tcfg.num_patches, tcfg.depth
    Dh = int(D * tcfg.mlp_ratio)
    batch, n_local, out_dim, n_steps = 8, 8, 65536, 3
    hp = (5e-4, 0.04, 0.996, 0.04, True)  # lr, wd, teacher momentum, temp, freeze
    m = hp[2]
    ms_step_bf16, peak_bf16, crops = phase7["ms"], phase7["peak"], phase7["crops"]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_steps

    print(f"[7c] the trainer's variants: rows 1b, 3, 4 and 7-9 at the rand-fr groups' "
          f"geometries, the rand-fr step (DATA.RAND_FR), rematerialized students, the "
          f"two-token step and the CLI's profiler trace: ViT-B/16, out_dim {out_dim}, "
          "AdamW", flush=True)
    # (a) the train ops at the rand-fr step's geometries (batch 8: 16 local
    # clips of 2, 4 and 16 frames, 8 global clips of 4; T = 8 is phase 7's),
    # on offset rows, by phase 3's twin rules; T = 16 runs the strided
    # backward's whole-sequence strips (kSeqStrips)
    rf_geo = {k: [] for k in TRAIN_OPS}
    rf_geo["mlp_phase"] = []
    for tag, (B, T, Np) in [("local", (16, 2, 36)), ("local", (16, 4, 36)),
                            ("local", (16, 16, 36)), ("global", (8, 4, N))]:
        seed = 90 + T + Np
        x, dout = (dev_offset_rows(seed + i, B, T, Np, D).to(bf16) for i in (0, 1))
        cls = dev_offset_rows(seed + 2, B, 1, D).to(bf16)
        dco = dev_offset_rows(seed + 3, B, T, D).to(bf16)
        rf_geo["mlp_phase"].append(
            train_op_checks(fb, p, H, D, Dh, tag, x, cls, dout, dco, rf_geo))
        del x, dout, cls, dco
    torch.cuda.empty_cache()
    part("phase 7c: the train ops at the rand-fr geometries")

    # (b) the rand-fr step on the bf16 kernel route: its gradients at batch 2
    # on the initial weights against the plain bf16 and f32 routes (phase
    # 7's rules), then batch 8 (g4, g8: 8 clips of 224 px; l2-l16: 16 clips
    # of 96 px)
    def rf_crops(b, seed):
        groups = ((1, 4, 224), (1, 8, 224), (2, 2, 96), (2, 4, 96), (2, 8, 96), (2, 16, 96))
        return tuple(dev_randn(seed + i, n * b, 3, t, px, px, dtype=torch.float32)
                     for i, (n, t, px) in enumerate(groups))

    state, core, mask = ssl.init_train_state(tcfg, out_dim=out_dim, optimizer="adamw",
                                             seed=0, device=dev)
    rf2 = rf_crops(2, 60)
    rf_grads, rf_loss = {}, {}
    for name, cd, route in [("kernels", bf16, "kernels"), ("plain bf16", bf16, "plain"),
                            ("f32", torch.float32, "plain")]:
        st = ssl.make_rand_fr_train_step(tcfg, core, mask, compute_dtype=cd, route=route)
        reset_counts()
        loss, _, grads = st.loss_and_grads(state, rf2, 0.04)
        torch.cuda.synchronize()
        ran = counts()
        if route == "plain" and any(ran.values()):
            fail(f"the rand-fr {name} route launched a kernel: {ran}")
        if route == "kernels" and not all(ran[k] for k in TRAIN_OPS):
            fail(f"the rand-fr kernel route missed a training op: {ran}")
        rf_loss[name], rf_grads[name] = float(loss), grads
        del grads
        torch.cuda.empty_cache()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("the f32 route ran with TF32 on")
    worst, e_k, e_p = grad_distances(*(rf_grads[k] for k in ("kernels", "plain bf16", "f32")))
    print(f"  rand-fr batch 2, losses {rf_loss}; kernel vs plain bf16 gradients: worst "
          f"max|diff|/max|plain| {worst[1]:.3e} at {worst[0]} (< {TRAIN_GRAD_REL_MAX}); mean "
          f"distance to f32: kernel route {e_k:.3e}, plain bf16 {e_p:.3e} (need kernel <= "
          f"{TRAIN_F32_RATIO} x plain + 1e-6)", flush=True)
    if worst[1] >= TRAIN_GRAD_REL_MAX:
        fail("rand-fr kernel-route gradients disagree with the plain bf16 route")
    if e_k > TRAIN_F32_RATIO * e_p + 1e-6:
        fail("rand-fr kernel-route gradients are further from f32 than allowed")
    del rf_grads, rf2
    torch.cuda.empty_cache()

    rf = rf_crops(batch, 61)
    rstep = ssl.make_rand_fr_train_step(tcfg, core, mask, clip_grad=3.0,
                                        compute_dtype=bf16)
    if rstep.route != "kernels":
        fail(f"the bf16 ViT-B rand-fr step chose the {rstep.route!r} route")
    losses = []

    def rf_step():
        nonlocal state
        state, metrics = rstep(state, rf, *hp)
        losses.append(float(metrics["loss"]))

    torch.cuda.reset_peak_memory_stats()
    rf_step()  # first-call allocations
    torch.cuda.synchronize()
    reset_counts()
    rf_step()
    torch.cuda.synchronize()
    seen = counts()
    want = {k: 0 for k in seen}
    want.update({"temporal_phase_tm_bf16": 8 * depth, "spatial_phase": 8 * depth,
                 "mlp_phase": 16 * depth, "temporal_phase_tm_bwd": 6 * depth,
                 "spatial_phase_bwd": 6 * depth, "mlp_phase_bwd": 6 * (2 * depth - 1)})
    print(f"  launches in one rand-fr step {seen} (expected {want}: per block 6 student "
          "and 2 teacher forwards, 6 backwards, no backward of the last block's grid "
          "MLP, no scoring kernel)", flush=True)
    if seen != want:
        fail(f"rand-fr step launches {seen}, expected {want}")
    launches_rf = {k: v for k, v in seen.items() if v}
    peak_rf = torch.cuda.max_memory_allocated()
    ms_rf = timed(rf_step)
    rows, _ = kernel_breakdown(rf_step)
    busy_rf = sum(ms_ for _, _, ms_ in rows)
    print(f"  rand-fr ms_per_step={ms_rf:.1f} ({n_steps} steps), device busy "
          f"{busy_rf:.1f} ms a step ({busy_rf / ms_rf:.1%}), peak memory "
          f"{peak_rf / 2**30:.1f} GiB (phase 7's step: {ms_step_bf16:.1f} ms, "
          f"{peak_bf16 / 2**30:.1f} GiB) on {card}", flush=True)
    print(f"  losses {[round(v, 4) for v in losses]}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail("a rand-fr step gave a non-finite loss")
    t_before = [t.detach().clone() for t in state.teacher.parameters()]
    rf_step()
    ema_err = max(float((t - (tb * m + s_.detach() * (1.0 - m))).abs().max())
                  for t, tb, s_ in zip(state.teacher.parameters(), t_before,
                                       state.student.parameters()))
    del t_before
    print(f"  teacher vs EMA of the new student (rand-fr step): max abs {ema_err:.3e} "
          "(<= 1e-6)", flush=True)
    if not math.isfinite(losses[-1]) or ema_err > 1e-6:
        fail("the rand-fr step's teacher is not the EMA of the student")

    # (e) the CLI's profiling helper around two rand-fr steps: a Chrome trace
    # that parses and names a port kernel (presence only: the card's
    # profiler drops a recorded call's first kernels now and then)
    with tempfile.TemporaryDirectory() as prof_dir:
        prof = train_ssl.StepProfiler(prof_dir, 0, 2, dev)
        for gi in range(3):
            prof.step(gi)
            if gi < 2:
                rf_step()
        prof.stop()
        with open(prof.path) as f:
            trace = json.load(f)
    names = {e.get("name", "") for e in trace.get("traceEvents", [])}
    fams = sorted({fam for fam, pat in FAMILIES.items() for n_ in names if pat in n_})
    print(f"  profiler trace of two rand-fr steps: {len(trace.get('traceEvents', []))} "
          f"events, the port's kernel families in it: {fams}", flush=True)
    if not fams:
        fail("the CLI's profiler trace names no kernel of the port")
    del trace, names, rf
    part("phase 7c: the rand-fr step")

    # (c) rematerialized students on the bf16 kernel route, at phase 7's
    # batch-2 crops: the gradients of remat against non-remat, bit for bit
    # (or, where the kernels are not deterministic, within the non-remat
    # route's own run-to-run spread), the launches; then phase 7's batch
    g2, l2 = crops(2, 51)
    remat_grads, remat_counts = {}, {}
    for name, remat in (("non-remat", False), ("non-remat again", False), ("remat", True)):
        st = ssl.make_train_step(tcfg, core, mask, n_local_crops=n_local, clip_grad=3.0,
                                 compute_dtype=bf16, remat=remat)
        reset_counts()
        loss, _, grads = st.loss_and_grads(state, g2, l2, 0.04)
        torch.cuda.synchronize()
        remat_counts[name] = counts()
        remat_grads[name] = (loss, grads)
    (l0, g0), (l1, g1), (lr_, gr) = (remat_grads[k] for k in (
        "non-remat", "non-remat again", "remat"))
    spread = {n: float((g1[n] - g0[n]).abs().max()) for n in g0}
    gap = {n: float((gr[n] - g0[n]).abs().max()) for n in g0}
    noisy = sorted(n for n, v in spread.items() if v > 0)
    print(f"  remat batch 2: loss {float(lr_)} (non-remat {float(l0)}, again {float(l1)}); "
          f"gradients differing from non-remat: {sum(v > 0 for v in gap.values())} of "
          f"{len(gap)} (largest {max(gap.values()):.3e}); non-remat run to run: "
          f"{len(noisy)} differ{' (' + ', '.join(noisy[:6]) + ')' if noisy else ''}",
          flush=True)
    if noisy:
        over = [n for n in g0 if gap[n] > spread[n]]
        if over:
            fail(f"remat gradients beyond the non-remat route's own spread: {over[:6]}")
    elif any(gap.values()) or not torch.equal(lr_, l0):
        fail("remat gradients are not bit for bit the non-remat route's")
    want_r = {k: 0 for k in remat_counts["remat"]}
    want_r.update({"temporal_phase_tm_bf16": 5 * depth, "spatial_phase": 5 * depth,
                   "mlp_phase": 10 * depth, "temporal_phase_tm_bwd": 2 * depth,
                   "spatial_phase_bwd": 2 * depth, "mlp_phase_bwd": 2 * (2 * depth - 1)})
    print(f"  launches of one remat forward and backward {remat_counts['remat']} (expected "
          f"{want_r}: per block each student forward twice, the teacher's once)", flush=True)
    if remat_counts["remat"] != want_r:
        fail(f"remat launches {remat_counts['remat']}, expected {want_r}")
    launches_remat = {k: v for k, v in remat_counts["remat"].items() if v}
    del remat_grads, g0, g1, gr, g2, l2
    torch.cuda.empty_cache()

    g, l = crops(batch, 50)
    steps_ = {}
    peaks = {}
    for name, remat in (("non-remat", False), ("remat", True)):
        st = ssl.make_train_step(tcfg, core, mask, n_local_crops=n_local, clip_grad=3.0,
                                 compute_dtype=bf16, remat=remat)

        def one(st=st):
            nonlocal state
            state, _ = st(state, g, l, *hp)

        one()  # first call
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, _, grads = st.loss_and_grads(state, g, l, 0.04)
        torch.cuda.synchronize()
        fb_peak = torch.cuda.max_memory_allocated()
        del grads
        torch.cuda.reset_peak_memory_stats()
        one()
        torch.cuda.synchronize()
        peaks[name] = (fb_peak, torch.cuda.max_memory_allocated())
        steps_[name] = one
    turns = {"non-remat": [], "remat": []}
    for order in (("remat", "non-remat"), ("non-remat", "remat")):
        for name in order:
            turns[name].append(timed(steps_[name]))
    ms_remat = {k: sum(v) / 2 for k, v in turns.items()}
    busy = {name: sum(ms_ for _, _, ms_ in kernel_breakdown(steps_[name])[0])
            for name in turns}
    print(f"  remat ms_per_step={ms_remat['remat']:.1f} (turns {turns['remat']}, {n_steps} "
          f"steps each), non-remat in turns {ms_remat['non-remat']:.1f} "
          f"({turns['non-remat']}; phase 7's {ms_step_bf16:.1f}); device busy a step: remat "
          f"{busy['remat']:.1f} ms ({busy['remat'] / ms_remat['remat']:.1%}), non-remat "
          f"{busy['non-remat']:.1f} ms ({busy['non-remat'] / ms_remat['non-remat']:.1%}); peak memory "
          f"of the forward and backward: remat {peaks['remat'][0] / 2**30:.2f} GiB, "
          f"non-remat {peaks['non-remat'][0] / 2**30:.2f} GiB; of the whole step: remat "
          f"{peaks['remat'][1] / 2**30:.2f} GiB, non-remat {peaks['non-remat'][1] / 2**30:.2f}"
          f" GiB (phase 7's {peak_bf16 / 2**30:.2f} GiB) on {card}", flush=True)
    if peaks["remat"][0] >= peaks["non-remat"][0]:
        fail("remat's forward and backward peak memory is not below the non-remat's")
    del steps_, g, l, state, rstep
    torch.cuda.empty_cache()
    part("phase 7c: remat")

    # (d) the two-token step on the plain bf16 route (JAX runs no Pallas
    # kernel there): batch 2 (teacher 2 x 224 px, student 2 x 96 px and 2 x
    # 224 px views of 8 frames): its launches, loss, center, EMA, and its
    # gradients' mean distance to the f32 route's (printed); then the step
    # at the largest batch up to 8 that fits
    def tt_crops(b, seed):
        return (dev_randn(seed, 2 * b, 3, 8, 224, 224, dtype=torch.float32),
                (dev_randn(seed + 1, 2 * b, 3, 8, 96, 96, dtype=torch.float32),
                 dev_randn(seed + 2, 2 * b, 3, 8, 224, 224, dtype=torch.float32)))

    state, core, mask = ssl.init_train_state(tcfg, out_dim=out_dim, optimizer="adamw",
                                             seed=0, device=dev, two_token=True)
    tt2 = tt_crops(2, 70)
    tt_grads = {}
    for cd in (bf16, torch.float32):
        st = ssl.make_train_step(tcfg, core, mask, two_token=True, compute_dtype=cd)
        if st.route != "plain":
            fail(f"the two-token step chose the {st.route!r} route")
        _, _, tt_grads[cd] = st.loss_and_grads(state, *tt2, 0.04)
    e_tt = sum(float((tt_grads[bf16][n] - gf_).abs().mean())
               / (float(gf_.abs().mean()) + 1e-12)
               for n, gf_ in tt_grads[torch.float32].items()) / len(tt_grads[bf16])
    del tt_grads
    tstep = ssl.make_train_step(tcfg, core, mask, two_token=True, compute_dtype=bf16)
    losses = []

    def tt_step(crops_):
        nonlocal state
        state, metrics = tstep(state, *crops_, *hp)
        losses.append(float(metrics["loss"]))

    reset_counts()
    t_before = [t.detach().clone() for t in state.teacher.parameters()]
    tt_step(tt2)
    torch.cuda.synchronize()
    ran = {k: v for k, v in counts().items() if v}
    ema_err = max(float((t - (tb * m + s_.detach() * (1.0 - m))).abs().max())
                  for t, tb, s_ in zip(state.teacher.parameters(), t_before,
                                       state.student.parameters()))
    del t_before
    moved = float(state.center.abs().max())
    print(f"  two-token batch 2: loss {losses[-1]}, center {tuple(state.center.shape)} "
          f"max |c| {moved:.3e}, teacher vs EMA max abs {ema_err:.3e} (<= 1e-6), port "
          f"kernels launched: {ran or 'none'}; gradients' mean distance to the f32 "
          f"route's {e_tt:.3e} (printed only; the rand-fr plain bf16 route's: {e_p:.3e})",
          flush=True)
    if ran:
        fail(f"the two-token step launched port kernels: {ran}")
    if not math.isfinite(losses[-1]) or tuple(state.center.shape) != (2, out_dim) or moved == 0:
        fail("the two-token step's loss or center is wrong")
    if ema_err > 1e-6:
        fail("the two-token step's teacher is not the EMA of the student")
    del tt2
    for b_tt in (8, 4, 2):
        try:
            ttc = tt_crops(b_tt, 71)
            torch.cuda.reset_peak_memory_stats()
            tt_step(ttc)
            torch.cuda.synchronize()
            peak_tt = torch.cuda.max_memory_allocated()
            ms_tt = timed(lambda: tt_step(ttc))
            rows, _ = kernel_breakdown(lambda: tt_step(ttc))
            break
        except torch.cuda.OutOfMemoryError:
            print(f"  two-token batch {b_tt}: out of memory", flush=True)
            ttc = None
            torch.cuda.empty_cache()
    else:
        fail("the two-token step fits at no batch of 8, 4 or 2")
    busy_tt = sum(ms_ for _, _, ms_ in rows)
    print(f"  two-token batch {b_tt}: ms_per_step={ms_tt:.1f} ({n_steps} steps), device "
          f"busy {busy_tt:.1f} ms a step ({busy_tt / ms_tt:.1%}), peak memory "
          f"{peak_tt / 2**30:.1f} GiB on {card}; losses {[round(v, 4) for v in losses]}",
          flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail("a two-token step gave a non-finite loss")
    del ttc, state, tstep, core, mask
    torch.cuda.empty_cache()
    return rf_geo, launches_rf, launches_remat


def offset_pair_checks(fb, pt, ps, H, B, T, N, D, checks):
    """Rows 1 and 2's bf16 tier on offset rows (|x| ~ 4-16), the case
    tests/test_torch_kernels_cuda.py's offset-row test holds. Row 2's bf16
    grid is one rounding of x1 + branch, whose ulp there (2^-4 near 8) is a
    fifth of the branch's max, so a tie flipped by the sum's order fails
    REL_RMS_TOL on a sound kernel: the grid is held by
    ``twin_check.rounding_ulps``, its branch through the f32 tier on the
    same bf16-exact CLS row (the bf16 tier but for the grid's dtype).
    Appends the gaps to ``checks``; returns the failures."""
    import torch

    from dino_video_summarization_transformer_tpu_torch.ops import twin_check

    x = dev_offset_rows(116, B, T, N, D).to(torch.bfloat16)
    x1, cls = dev_offset_rows(117, B, T, N, D), dev_offset_rows(118, B, 1, D).to(torch.bfloat16)
    tag = f"B={B} T={T} offset rows"
    checks["temporal_phase_tm"].append(check_close(
        f"temporal_phase_tm out-x {tag}", fb.temporal_phase_tm(x, pt, H),
        fb.temporal_phase_tm_plain(x, pt, H), x))
    grid, rows = fb.spatial_mlp(x1, cls, ps, H)
    want_grid, want_rows = fb.spatial_mlp_plain(x1, cls, ps, H)
    ulps = twin_check.rounding_ulps(grid, want_grid, x1)
    ok = ulps <= twin_check.ROUNDING_ULPS
    print(f"  spatial_mlp bf16 grid {tag}: {ulps:.2f} ulps of the twin's (<= "
          f"{twin_check.ROUNDING_ULPS}) {'ok' if ok else 'FAILED'}", flush=True)
    checks["spatial_mlp"].append(check_close(f"spatial_mlp cls rows {tag}", rows, want_rows))
    checks["spatial_mlp"].append(check_close(
        f"spatial_mlp grid-x1 {tag} (f32 grid, same CLS row)",
        fb.spatial_mlp(x1, cls.float(), ps, H)[0],
        fb.spatial_mlp_plain(x1, cls.float(), ps, H)[0], x1))
    return [] if ok else [f"spatial_mlp bf16 grid {tag}: {ulps} ulps"]


def phase_11(fb, p, dev, card, reset_counts, counts, part):
    """Phase 11, the evaluation consumers at ViT-B/16 (numpy-seeded
    weights, clips in memory, no decode): (a) rows 1 and 2 at the kNN and
    linear probe's batch (B=8, T=8) and rows 1f and 2f at the K400
    classifier's clip (B=1, T=16) against their twins; (b)
    ``extract_features`` on the bf16 kernel route over three batches of 8
    clips, launches, features against the plain bf16 and f32 routes,
    ``knn_predict`` on the card against the CPU; (c) the K400 classifier
    (400 classes, T=16, B=1) at ``--precision bfloat16``'s semantics (the
    f32 model on bf16 pixels, the kernel pair's f32 tier) against its twin
    route, f32 and the bf16 kernel route; (d) linear-probe steps on kernel
    features and two f32 finetune steps (B=4, T=16, no port kernel).
    ``p``: phase 3's block (the ops' weights). Returns the kernels line's
    additions: (rows by op at the new geometries, launches by op and
    path)."""
    import numpy as np
    import torch

    from dino_video_summarization_transformer_tpu_torch.engine import (
        classification, knn, linear)
    from dino_video_summarization_transformer_tpu_torch.models import (
        convert, timesformer as tsf)
    from dino_video_summarization_transformer_tpu_torch.ops import twin_check
    from dino_video_summarization_transformer_tpu_torch.utils.synthetic import (
        make_numpy_params)

    bf16, f32 = torch.bfloat16, torch.float32
    cfg8 = tsf.vit_base_config(num_frames=8, num_classes=0)
    D, H, N, depth = cfg8.embed_dim, cfg8.num_heads, cfg8.num_patches, cfg8.depth
    Dh = int(D * cfg8.mlp_ratio)
    pt, ps = p["temporal"], p["spatial"]
    print("[11] the evaluation consumers: rows 1 and 2 at B=8 T=8, rows 1f and 2f at "
          "B=1 T=16, kNN features, the K400 classifier, the linear probe and "
          "finetuning (ViT-B/16)", flush=True)

    # (a) the new geometries first, each output on its branch by the twin
    # rules; the f32 tiers on offset rows and by twin_check's f32 rule
    geo, launches = {}, {}
    cases = [("temporal_phase_tm", "spatial_mlp", 8, 8, False),
             ("temporal_phase_tm_f32", "spatial_mlp_f32", 1, 16, True)]
    for t_name, s_name, B, T, f32_tier in cases:
        if f32_tier:
            x, x1, cls = (dev_offset_rows(111, B, T, N, D), dev_offset_rows(112, B, T, N, D),
                          dev_offset_rows(113, B, 1, D))
        else:
            x, x1, cls = (dev_randn(111, B, T, N, D), dev_randn(112, B, T, N, D, dtype=f32),
                          dev_randn(113, B, 1, D))
        with torch.inference_mode():
            got_t, want_t = fb.temporal_phase_tm(x, pt, H), fb.temporal_phase_tm_plain(x, pt, H)
            got_s, want_s = fb.spatial_mlp(x1, cls, ps, H), fb.spatial_mlp_plain(x1, cls, ps, H)
            checks = {t_name: [check_close(f"{t_name} out-x B={B} T={T}", got_t, want_t, x)],
                      s_name: [check_close(f"{s_name} grid-x1 B={B} T={T}", got_s[0],
                                           want_s[0], x1),
                               check_close(f"{s_name} cls rows B={B} T={T}", got_s[1],
                                           want_s[1])]}
            bad = []
            if f32_tier:
                for tag, t in ((f"{t_name} out", got_t), (f"{s_name} grid", got_s[0]),
                               (f"{s_name} cls rows", got_s[1])):
                    b_ = twin_check.f32_failures(t)
                    print(f"  {tag} B={B} T={T}: bf16_exact={twin_check.bf16_exact(t):.3e} "
                          f"{'ok' if not b_ else 'FAILED: ' + '; '.join(b_)}", flush=True)
                    bad += b_
            else:
                bad += offset_pair_checks(fb, pt, ps, H, B, T, N, D, checks)
            del got_t, want_t, got_s, want_s
            if bad or not all(ok for v in checks.values() for ok, _ in v):
                fail(f"a kernel disagrees with its plain twin at the evaluation geometry "
                     f"B={B}, T={T}")
            runs = {t_name: (lambda: fb.temporal_phase_tm(x, pt, H),
                             lambda: fb.temporal_phase_tm_plain(x, pt, H),
                             (temporal_f32_cost if f32_tier else temporal_cost)(B, T, N, D)),
                    s_name: (lambda: fb.spatial_mlp(x1, cls, ps, H),
                             lambda: fb.spatial_mlp_plain(x1, cls, ps, H),
                             (spatial_f32_cost if f32_tier else spatial_cost)(B, T, N, D, Dh))}
            for name, (kern, plain, cost) in runs.items():
                ms, pl = cuda_ms(kern, 20), cuda_ms(plain, 5)
                b, by = bound_ms(*cost)
                gaps = [gap for _, gap in checks[name]]
                geo[name] = {"B": B, "T": T, "N": N, "ms": ms, "plain_ms": pl,
                             "bound_ms": b, "bound_by": by, "library_ms": None,
                             "max_abs_err": max(g["max_abs_err"] for g in gaps),
                             "rel_rms": max(g["rel_rms"] for g in gaps)}
                print(f"  {name} B={B} T={T}: kernel {ms:.3f} ms, plain {pl:.3f} ms, bound "
                      f"{b:.4f} ms ({by}), {b / ms:.1%} of bound; library: none (no single "
                      "call)", flush=True)
        del x, x1, cls, runs
    torch.cuda.empty_cache()
    part("phase 11a: rows 1, 2 at B=8 T=8 and 1f, 2f at B=1 T=16")

    # (b) kNN features: the bf16 no-head model on the kernel pair, as the
    # CLIs build it (timesformer.eval_kernels), over 3 batches of 8 clips
    sd8 = convert.state_dict_from_jax_params(make_numpy_params(cfg8, seed=0), cfg8)
    if not tsf.eval_kernels(cfg8, bf16, dev) or tsf.eval_kernels(cfg8, f32, dev):
        fail("eval_kernels: expected the kernel pair for bf16 on the card only")
    kmodel = tsf.build_timesformer(dataclasses.replace(cfg8, use_kernels=True), sd8,
                                   device=dev, dtype=bf16)

    class Clips:
        x = np.random.RandomState(114).randn(24, 3, 8, 224, 224).astype(np.float32)

        def __len__(self):
            return len(self.x)

        def __getitem__(self, i):
            return self.x[i], i

    clips = Clips()
    knn.extract_features(kmodel, clips, batch_size=8, num_workers=2, log_every=0)  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = knn.extract_features(kmodel, clips, batch_size=8, num_workers=2, log_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    seen = counts()
    want = {k: 0 for k in seen}
    want.update(temporal_phase_tm=3 * depth, spatial_mlp=3 * depth)
    xb = torch.from_numpy(clips.x[:8]).to(dev)
    with torch.inference_mode():
        dev_ms = cuda_ms(lambda: kmodel.forward_features(xb), 5)
    print(f"  extract_features, 24 clips (3 batches of 8, T=8, 224 px): {wall * 1e3 / 3:.1f} ms "
          f"a batch wall, {24 / wall:.1f} clips/s; one batch's forward on the card "
          f"{dev_ms:.1f} ms on {card}; launches {seen}", flush=True)
    if seen != want:
        fail(f"extract_features launches {seen}, expected {want}")
    launches["knn_extract_3_batches"] = {k: seen[k] for k in ("temporal_phase_tm", "spatial_mlp")}
    plain_model = tsf.build_timesformer(cfg8, sd8, device=dev, dtype=bf16)
    f32_model = tsf.build_timesformer(cfg8, sd8, device=dev)
    reset_counts()
    plain = knn.extract_features(plain_model, clips, batch_size=8, num_workers=2, log_every=0)
    ref = knn.extract_features(f32_model, clips, batch_size=8, num_workers=2, log_every=0)
    if any(counts().values()):
        fail("the plain bf16 and f32 extractions launched a kernel")
    feature_checks("kNN features (bf16 kernel route)", torch.from_numpy(feats),
                   torch.from_numpy(plain), torch.from_numpy(ref))
    del plain_model, f32_model
    fn = knn.l2_normalize(feats)
    labels = np.arange(24) % 5
    for k in (1, 5, 20):
        on_card = knn.knn_predict(fn[:16], labels[:16], fn[16:], k, 0.07, 5, dev)
        on_cpu = knn.knn_predict(fn[:16], labels[:16], fn[16:], k, 0.07, 5, "cpu")
        if not np.array_equal(on_card, on_cpu):
            fail(f"knn_predict k={k}: the card's top-5 differ from the CPU's")
    print("  knn_predict k=1, 5, 20 (16 train, 8 test, 5 classes): the card's top-5 equal "
          "the CPU's", flush=True)
    extract = {"ms_per_batch_wall": wall * 1e3 / 3, "clips_per_s": 24 / wall,
               "ms_per_batch_device": dev_ms}
    part("phase 11b: kNN features")

    # (c) the K400 classifier at --precision bfloat16: the f32 model with
    # the kernel pair's f32 tier on bf16-rounded pixels (JAX's dtype fault)
    cfg16 = tsf.vit_base_config(num_frames=16, num_classes=400)
    sd16 = convert.state_dict_from_jax_params(make_numpy_params(cfg16, seed=1), cfg16)
    r = np.random.RandomState(115)
    sd16["head.weight"] = (0.02 * r.randn(400, D)).astype(np.float32)
    sd16["head.bias"] = np.zeros(400, np.float32)
    kcfg16 = dataclasses.replace(cfg16, use_kernels=tsf.eval_kernels(cfg16, bf16, dev))
    k400 = tsf.build_timesformer(kcfg16, sd16, device=dev)
    pix = torch.from_numpy(r.randn(1, 16, 3, 224, 224).astype(np.float32)).to(dev)
    clf = classification.make_classifier_fn(k400, bf16)
    clf(pix)  # warm-up
    reset_counts()
    logits = clf(pix)
    torch.cuda.synchronize()
    seen = counts()
    want = {k: 0 for k in seen}
    want.update(temporal_phase_tm_f32=depth, spatial_mlp_f32=depth)
    if seen != want:
        fail(f"the K400 classifier's launches {seen}, expected {want}")
    launches["k400_video"] = {k: seen[k] for k in ("temporal_phase_tm_f32", "spatial_mlp_f32")}
    with twins(fb):
        twin = clf(pix)
    ref = classification.make_classifier_fn(tsf.build_timesformer(cfg16, sd16, device=dev),
                                            bf16)(pix)
    bf16_k = classification.make_classifier_fn(tsf.build_timesformer(
        kcfg16, sd16, device=dev, dtype=bf16), bf16)(pix).float()
    e_k = float((logits - ref).abs().mean())
    e_b = float((bf16_k - ref).abs().mean())
    feature_checks("K400 logits (f32 tier on bf16 pixels)", logits, twin, ref)
    print(f"  K400 logits vs f32 mean abs: f32 tier {e_k:.3e}, bf16 kernel route {e_b:.3e} "
          f"(need f32 tier <= it); argmax f32 tier / twin / f32 / bf16: "
          f"{int(logits.argmax())} / {int(twin.argmax())} / {int(ref.argmax())} / "
          f"{int(bf16_k.argmax())}", flush=True)
    if tuple(logits.shape) != (1, 400) or e_k > e_b:
        fail("the K400 classifier's f32 tier is further from f32 than the bf16 kernel route")
    host = pix.cpu().numpy()
    with torch.inference_mode():
        video_ms = cuda_ms(lambda: clf(host), 5)
        video_dev_ms = cuda_ms(lambda: clf(pix), 5)
    print(f"  K400 classifier (ViT-B/16, T=16, 400 classes): {video_ms:.1f} ms a video with "
          f"its upload, {video_dev_ms:.1f} ms on the card ({card})", flush=True)
    # the host's preprocessing of one video (not in the times above): 16
    # decoded 240x320 frames through hf_video_preprocess, the first call
    # (the resize taps computed) and the next (cached)
    frames = np.random.RandomState(119).randint(0, 256, (16, 240, 320, 3), np.uint8)
    classification._bilinear_taps.cache_clear()
    pre_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        classification.hf_video_preprocess(frames)
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"  hf_video_preprocess, 16 frames 240x320 on the host: {pre_ms[0]:.1f} ms first "
          f"call, {min(pre_ms[1:]):.1f} ms after (decode not included)", flush=True)
    k400_times = {"ms_per_video": video_ms, "ms_per_video_device": video_dev_ms,
                  "preprocess_ms_per_video_host": min(pre_ms[1:]),
                  "preprocess_ms_first_video_host": pre_ms[0]}
    del k400, clf, twin, ref, bf16_k
    torch.cuda.empty_cache()
    part("phase 11c: the K400 classifier")

    # (d) linear-probe steps on the kernel features, then two finetune steps
    state, train_step, _, epoch_lr = linear.make_linear_probe(
        kmodel, num_labels=101, lr=1e-3 * 8 / 256, epochs=10,
        generator=torch.Generator().manual_seed(0))
    ys = torch.from_numpy(r.randint(0, 101, (3, 8))).to(dev)
    xs = [torch.from_numpy(clips.x[8 * i:8 * i + 8]).to(dev) for i in range(3)]
    state, _ = train_step(state, xs[0], ys[0], epoch_lr(0))  # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(3):
        state, loss = train_step(state, xs[i], ys[i], epoch_lr(0))
        losses.append(float(loss))
    probe_ms = (time.perf_counter() - t0) * 1e3 / 3
    seen = counts()
    want = {k: 0 for k in seen}
    want.update(temporal_phase_tm=3 * depth, spatial_mlp=3 * depth)
    print(f"  linear probe: {probe_ms:.1f} ms a step (batch 8), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}, losses "
          f"{[round(v, 4) for v in losses]}; launches {seen}", flush=True)
    if seen != want or not all(math.isfinite(v) for v in losses):
        fail(f"linear-probe steps: launches {seen} (expected {want}), losses {losses}")
    launches["linear_probe_step"] = {k: seen[k] // 3 for k in ("temporal_phase_tm", "spatial_mlp")}
    probe = {"ms_per_step": probe_ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del kmodel, state, xs, clips
    torch.cuda.empty_cache()

    class Frames:  # clips in memory: the step's time is the card's and the upload's
        def __init__(self, n):
            g = np.random.RandomState(120)
            self.x = g.randn(n, 16, 3, 224, 224).astype(np.float32)
            self.y = g.randint(0, 400, n)

        def __len__(self):
            return len(self.x)

        def __getitem__(self, i):
            return {"pixel_values": self.x[i], "label": int(self.y[i])}

    ft = tsf.build_timesformer(cfg16, sd16, device=dev).train()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with tempfile.TemporaryDirectory() as out_dir:
        _, hist = classification.finetune(Frames(8), Frames(0), ft, out_dir, num_epochs=1,
                                          batch_size=4, lr=5e-5, warmup_steps=1,
                                          num_workers=2, max_steps_per_epoch=2, log_every=1)
    torch.cuda.synchronize()
    seen = counts()
    summary = hist[-1]
    ft_ms = 1e3 * summary["train_runtime"] / max(summary["step"], 1)
    print(f"  finetune (f32 plain, B=4, T=16, 2 steps): {ft_ms:.1f} ms a step (with the "
          f"host's batch and upload), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"on {card}, "
          f"losses {[round(e['loss'], 4) for e in hist if 'loss' in e]}", flush=True)
    if any(seen.values()):
        fail(f"the finetune step launched a port kernel: {seen}")
    if summary["step"] != 2 or not all(math.isfinite(e["loss"]) for e in hist if "loss" in e):
        fail(f"finetune: {hist}")
    finetune_rec = {"ms_per_step": ft_ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del ft
    torch.cuda.empty_cache()
    part("phase 11d: the linear probe and finetuning")
    return geo, {"launches": launches, "extract_features": extract, "k400": k400_times,
                 "linear_probe": probe, "finetune": finetune_rec}


def phase_12(dev, card, reset_counts, counts, part, phase7):
    """Phase 12, the trainer's variants on the other backbones (ViT-B/16,
    T = 8, seeded weights, out_dim 65536, AdamW, bf16): (a) the two-stream
    step (ViT-S/16 motion nets on 224-px flow frames) and (b) the
    CNN-distillation step (a frozen S3D on the global clips, weight 1), each
    at batch 2 on the kernel route against the plain bf16 and f32 routes
    (phase 7's gradient rules), its loss terms against a computation of
    their own from the modules at f32 (1e-5 relative), then at batch 8 (16
    global, 64 local clips; 16 flow frames): launches by row, ms and device
    busy a step, peak memory, the EMA of every teacher; (b) also the S3D
    forward alone in bf16 against its f32 run; (c) the space-only and joint
    TimeSformers at batch 2 (a forward and a train step's loss, plain bf16
    against f32) with no port launch. ``phase7``: phase 7's bf16 step (its
    "ms" and "peak"). Returns the launches by op of one two-stream and one
    distillation step."""
    import torch

    from dino_video_summarization_transformer_tpu_torch.models import s3d
    from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf
    from dino_video_summarization_transformer_tpu_torch.models.vit2d import vit2d_small
    from dino_video_summarization_transformer_tpu_torch.train import ssl
    from dino_video_summarization_transformer_tpu_torch.train.dino import dino_loss

    bf16, f32 = torch.bfloat16, torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 routes and the S3D in true f32
    torch.backends.cudnn.allow_tf32 = False
    tcfg = tsf.vit_base_config(num_frames=8, num_classes=0)
    mcfg = vit2d_small(img_size=224)
    depth = tcfg.depth
    batch, n_local, out_dim, n_steps = 8, 8, 65536, 3
    hp = (5e-4, 0.04, 0.996, 0.04, True)  # lr, wd, teacher momentum, temp, freeze
    m, tt = hp[2], hp[3]
    # one step's launches, phase 7's: 3 forwards and 2 student backwards a
    # block, the MLP on the grid and the CLS rows, no backward of the last
    # block's grid MLP (the heads read the CLS row only)
    want_step = {"temporal_phase_tm_bf16": 3 * depth, "spatial_phase": 3 * depth,
                 "mlp_phase": 6 * depth, "temporal_phase_tm_bwd": 2 * depth,
                 "spatial_phase_bwd": 2 * depth, "mlp_phase_bwd": 2 * (2 * depth - 1)}
    print(f"[12] the trainer's variants on the other backbones: two-stream (ViT-B/16 RGB, "
          f"ViT-S/16 motion nets on flow), CNN distillation (a frozen S3D), space-only and "
          f"joint TimeSformers: T=8, out_dim {out_dim}, AdamW", flush=True)

    def clips(b, seed):
        return (dev_randn(seed, 2 * b, 3, 8, 224, 224, dtype=f32),
                dev_randn(seed + 1, n_local * b, 3, 8, 96, 96, dtype=f32))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_steps

    def ema_error(pairs):
        return max(float((t - (tb * m + s_.detach() * (1.0 - m))).abs().max())
                   for t, tb, s_ in pairs)

    def rel(a, b):
        return abs(a - b) / (abs(b) + 1e-12)

    def routes(tag, make, batch2):
        """Phase 7's rules on the kernel, plain bf16 and f32 routes at batch
        2; -> the f32 route's aux (centers and terms)."""
        grads, losses, auxes = {}, {}, {}
        for name, cd, route in [("kernels", bf16, "kernels"), ("plain bf16", bf16, "plain"),
                                ("f32", f32, "plain")]:
            st = make(cd, route)
            reset_counts()
            loss, aux, g_ = st.loss_and_grads(*batch2)
            torch.cuda.synchronize()
            ran = counts()
            if route == "plain" and any(ran.values()):
                fail(f"the {tag} {name} route launched a kernel: {ran}")
            if route == "kernels" and not all(ran[k] for k in TRAIN_OPS):
                fail(f"the {tag} kernel route missed a training op: {ran}")
            losses[name], grads[name], auxes[name] = float(loss), g_, aux
            del g_
            torch.cuda.empty_cache()
        if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
            fail("the f32 route ran with TF32 on")
        worst, e_k, e_p = grad_distances(*(grads[k] for k in ("kernels", "plain bf16", "f32")))
        print(f"  {tag} batch 2, losses {losses}; kernel vs plain bf16 gradients: worst "
              f"max|diff|/max|plain| {worst[1]:.3e} at {worst[0]} (< {TRAIN_GRAD_REL_MAX}); "
              f"mean distance to f32: kernel route {e_k:.3e}, plain bf16 {e_p:.3e} (need "
              f"kernel <= {TRAIN_F32_RATIO} x plain + 1e-6)", flush=True)
        if worst[1] >= TRAIN_GRAD_REL_MAX:
            fail(f"{tag} kernel-route gradients disagree with the plain bf16 route")
        if e_k > TRAIN_F32_RATIO * e_p + 1e-6:
            fail(f"{tag} kernel-route gradients are further from f32 than allowed")
        return losses["f32"], auxes["f32"]

    def batch8(tag, step, state_ref, args, teachers):
        """The step at batch 8: launches, ms, device busy, peak memory,
        losses and the EMA of each (teacher, student) pair of
        ``teachers(state)``; -> (launches, ms, busy, peak)."""
        losses = []

        def one():
            state_ref[0], metrics = step(state_ref[0], *args, *hp)
            losses.append(float(metrics["loss"]))

        torch.cuda.reset_peak_memory_stats()
        one()  # first-call allocations
        torch.cuda.synchronize()
        reset_counts()
        one()
        torch.cuda.synchronize()
        seen = counts()
        want = {k: 0 for k in seen}
        want.update(want_step)
        print(f"  {tag} launches in one step {seen} (expected {want}: phase 7's)", flush=True)
        if seen != want:
            fail(f"{tag} step launches {seen}, expected {want}")
        peak = torch.cuda.max_memory_allocated()
        ms = timed(one)
        rows, _ = kernel_breakdown(one)
        busy = sum(ms_ for _, _, ms_ in rows)
        pairs = teachers(state_ref[0])
        before = [[t.detach().clone() for t in te.parameters()] for te, _ in pairs]
        one()
        err = max(ema_error(zip(te.parameters(), tb, st_.parameters()))
                  for (te, st_), tb in zip(pairs, before))
        del before
        print(f"  {tag} batch {batch}: ms_per_step={ms:.1f} ({n_steps} steps), device busy "
              f"{busy:.1f} ms a step ({busy / ms:.1%}), peak memory {peak / 2**30:.2f} GiB "
              f"(phase 7's step: {phase7['ms']:.1f} ms, {phase7['peak'] / 2**30:.2f} GiB) on "
              f"{card}; losses {[round(v, 4) for v in losses]}; every teacher vs the EMA of "
              f"its new student: max abs {err:.3e} (<= 1e-6)", flush=True)
        if not all(math.isfinite(v) for v in losses):
            fail(f"a {tag} step gave a non-finite loss")
        if err > 1e-6:
            fail(f"a {tag} teacher is not the EMA of its student")
        return {k: v for k, v in seen.items() if v}, ms, busy, peak

    # (a) two-stream
    state, core, mask = ssl.init_two_stream_state(tcfg, mcfg, out_dim=out_dim, seed=0,
                                                  device=dev)

    def make_ts(cd, route):
        return ssl.make_two_stream_train_step(tcfg, mcfg, core, mask, n_local_crops=n_local,
                                              clip_grad=3.0, compute_dtype=cd, route=route)

    g2, l2 = clips(2, 120)
    flow2 = dev_randn(122, 4, 3, 224, 224, dtype=f32).abs()
    loss32, (centers, terms) = routes("two-stream", make_ts, (state, g2, l2, flow2, tt))
    # each term from the modules, at f32, on the same weights and inputs
    with torch.no_grad():
        feats = torch.cat([state.student["backbone"].forward_train(c) for c in (g2, l2)])
        s_rgb, s_cross = state.student["head"]((feats, feats))
        t_rgb = state.teacher["head"].main(state.teacher["backbone"].forward_train(g2))
        s_flow = state.motion_student["head"](state.motion_student["backbone"](flow2))
        t_flow = state.motion_teacher["head"](state.motion_teacher["backbone"](flow2))
        ref = {"loss_rgb": dino_loss(s_rgb, t_rgb, state.center_rgb, tt, n_crops=2 + n_local)[0],
               "loss_flow": dino_loss(s_flow, t_flow, state.center_flow, tt, n_crops=2)[0],
               "loss_cross": dino_loss(s_cross, t_flow, state.center_cross, tt,
                                       n_crops=2 + n_local)[0]}
    ref = {k: float(v) for k, v in ref.items()}
    got = {k: float(v) for k, v in terms.items()}
    worst_term = max(rel(got[k], ref[k]) for k in ref)
    print(f"  two-stream f32 terms {got} against the modules' {ref}: worst relative "
          f"{worst_term:.3e} (<= 1e-5); total {loss32:.6f}", flush=True)
    if worst_term > 1e-5 or rel(loss32, sum(ref.values())) > 1e-5:
        fail("a two-stream loss term disagrees with its computation from the modules")
    del g2, l2, flow2, feats, s_rgb, s_cross, t_rgb, s_flow, t_flow
    torch.cuda.empty_cache()
    tstep = make_ts(bf16, "auto")
    if tstep.route != "kernels":
        fail(f"the bf16 ViT-B two-stream step chose the {tstep.route!r} route")
    g, l = clips(batch, 123)
    flow = dev_randn(125, 2 * batch, 3, 224, 224, dtype=f32).abs()
    ref_state = [state]
    launches_ts, ms_ts, busy_ts, peak_ts = batch8(
        "two-stream", tstep, ref_state, (g, l, flow),
        lambda s: [(s.teacher, s.student), (s.motion_teacher, s.motion_student)])
    del state, ref_state, tstep, core, mask, g, l, flow
    torch.cuda.empty_cache()
    part("phase 12a: two-stream")

    # (b) CNN distillation: the S3D alone first, bf16 against f32
    cnn = s3d.init_s3d(torch.Generator().manual_seed(7), device=dev).requires_grad_(False)
    g, l = clips(batch, 126)
    with torch.no_grad():
        f_32 = cnn(g).mean(dim=(2, 3, 4))
        f_bf = cnn(g, compute_dtype=bf16).mean(dim=(2, 3, 4))
        ms_cnn = cuda_ms(lambda: cnn(g, compute_dtype=bf16), 3)
    cnn_err = float((f_bf - f_32).abs().max() / f_32.abs().max())
    print(f"  S3D on the {2 * batch} global clips: pooled features bf16 compute vs f32 "
          f"max|diff|/max|f32| {cnn_err:.3e} (<= {S3D_BF16_REL_MAX}; with f32 weights bf16 "
          f"compute rounds the input only), {ms_cnn:.1f} ms a forward on {card}", flush=True)
    if not cnn_err <= S3D_BF16_REL_MAX:
        fail("the S3D's bf16 compute strays from its f32 run")
    del f_32, f_bf
    weight = 1.0
    state, core, mask = ssl.init_train_state(tcfg, out_dim=out_dim, seed=0, device=dev,
                                             cnn_distill_dim=1024)

    def make_cd(cd, route):
        return ssl.make_train_step(tcfg, core, mask, n_local_crops=n_local, clip_grad=3.0,
                                   compute_dtype=cd, route=route, cnn_params=cnn,
                                   cnn_distill_weight=weight)

    g2, l2 = clips(2, 127)
    loss32, _ = routes("distillation", make_cd, (state, g2, l2, tt))
    with torch.no_grad():
        s_g = state.student["backbone"].forward_train(g2)
        s_out = state.student["head"](torch.cat([s_g, state.student["backbone"].forward_train(l2)]))
        t_out = state.teacher["head"](state.teacher["backbone"].forward_train(g2))
        dino = float(dino_loss(s_out, t_out, state.center, tt, n_crops=2 + n_local)[0])
        feats = torch.nn.functional.normalize(cnn(g2).mean(dim=(2, 3, 4)), dim=-1)
        proj = torch.nn.functional.normalize(state.student["cnn_proj"](s_g), dim=-1)
        term = float((1.0 - (proj * feats).sum(dim=-1)).mean())
    print(f"  distillation f32 loss {loss32:.6f} against the modules' DINO {dino:.6f} + "
          f"{weight} x distill term {term:.6f}: relative {rel(loss32, dino + weight * term):.3e} "
          f"(<= 1e-5)", flush=True)
    if rel(loss32, dino + weight * term) > 1e-5 or not term > 1e-3:
        fail("the distillation loss disagrees with its computation from the modules")
    del g2, l2, s_g, s_out, t_out, feats, proj
    torch.cuda.empty_cache()
    dstep = make_cd(bf16, "auto")
    if dstep.route != "kernels":
        fail(f"the bf16 ViT-B distillation step chose the {dstep.route!r} route")
    ref_state = [state]
    launches_cd, ms_cd, busy_cd, peak_cd = batch8(
        "distillation", dstep, ref_state, (g, l), lambda s: [(s.teacher, s.student)])
    del state, ref_state, dstep, core, mask, g, l, cnn
    torch.cuda.empty_cache()
    part("phase 12b: CNN distillation")

    # (c) space-only and joint: the plain route, no port kernel
    for at in ("space_only", "joint_space_time"):
        cfg = dataclasses.replace(tcfg, attention_type=at)
        model = tsf.init_timesformer(cfg, torch.Generator().manual_seed(3), device=dev)
        x = dev_randn(130, 2, 3, 8, 224, 224, dtype=f32)
        reset_counts()
        with torch.no_grad():
            y32 = model.forward_features(x)
            ybf = model.to(bf16).forward_features(x)
        fwd_err = float((ybf.float() - y32).abs().max() / y32.abs().max())
        state, core, mask = ssl.init_train_state(cfg, out_dim=out_dim, seed=0, device=dev)
        g2, l2 = clips(2, 131)
        step_losses = {}
        for name, cd in (("bf16", bf16), ("f32", f32)):
            st = ssl.make_train_step(cfg, core, mask, n_local_crops=n_local, compute_dtype=cd)
            if st.route != "plain":
                fail(f"the {at} step chose the {st.route!r} route")
            step_losses[name] = float(st.loss_and_grads(state, g2, l2, tt)[0])
        state, metrics = ssl.make_train_step(cfg, core, mask, n_local_crops=n_local,
                                             compute_dtype=bf16)(state, g2, l2, *hp)
        torch.cuda.synchronize()
        ran = {k: v for k, v in counts().items() if v}
        loss_err = rel(step_losses["bf16"], step_losses["f32"])
        print(f"  {at} batch 2: features plain bf16 vs f32 max|diff|/max|f32| {fwd_err:.3e} "
              f"(<= {PLAIN_BF16_REL_MAX}); train loss bf16 {step_losses['bf16']:.5f} vs f32 "
              f"{step_losses['f32']:.5f} (relative {loss_err:.3e} <= {PLAIN_BF16_REL_MAX}); "
              f"a bf16 step's loss {float(metrics['loss']):.5f}; port kernels launched: "
              f"{ran or 'none'}", flush=True)
        if ran:
            fail(f"the {at} model launched port kernels: {ran}")
        if not (fwd_err <= PLAIN_BF16_REL_MAX and loss_err <= PLAIN_BF16_REL_MAX
                and math.isfinite(float(metrics["loss"]))):
            fail(f"the {at} model's plain bf16 route strays from f32")
        del model, state, core, mask, g2, l2, x, y32, ybf
        torch.cuda.empty_cache()
    part("phase 12c: space-only and joint")
    print(f"  phase 12 summary: two-stream {ms_ts:.1f} ms a step (busy {busy_ts:.1f}, "
          f"{peak_ts / 2**30:.2f} GiB), distillation {ms_cd:.1f} ms (busy {busy_cd:.1f}, "
          f"{peak_cd / 2**30:.2f} GiB), phase 7's step {phase7['ms']:.1f} ms on {card}",
          flush=True)
    return launches_ts, launches_cd


def partial_costs(B, T, N, D, Dq):
    """(FLOP, bytes) of the partial tier's four ops at the shard's
    attention width Dq, bf16 rows. Row 1p: qkv (6 Dq D a row), attention
    over T (4 T Dq), proj (2 Dq D), fc (2 D^2); x read, out written,
    weights once. Row 4p: qkv over the grid and one CLS row a clip,
    attention over L = N + 1 a frame, proj over the grid and the per-frame
    CLS rows; x and cls read, grid and CLS rows written, weights once.
    Rows 7p and 8p: temporal_bwd_cost's and spatial_bwd_cost's terms at
    width Dq (the recomputes, the backwards' dW and dX products, the
    attention backward with its score recompute); x and the cotangents
    read, dx written (bf16), dcls (f32), weights read, f32 gradients
    written (no proj or fc bias gradient)."""
    M, L = B * T * N, N + 1
    R = M + B * T
    w_t = (3 * Dq * D + D * Dq + D * D)
    w_s = (3 * Dq * D + D * Dq)
    return {
        "temporal_phase_tm_partial": (
            M * (8 * Dq * D + 2 * D * D + 4 * T * Dq),
            2 * M * D * 2 + w_t * 2 + (3 * Dq + 2 * D) * 4),
        "spatial_phase_partial": (
            2 * (M + B) * D * 3 * Dq + 4 * B * T * L * L * Dq + 2 * (M + B * T) * Dq * D,
            2 * M * D * 2 + B * D * 2 + B * T * D * 2 + w_s * 2 + (3 * Dq + 2 * D) * 4),
        "temporal_phase_tm_bwd_partial": (
            M * (24 * Dq * D + 4 * D * D + 14 * T * Dq),
            3 * M * D * 2 + w_t * 2 + (w_t + 3 * Dq + 2 * D) * 4),
        "spatial_phase_bwd_partial": (
            6 * (M + B) * Dq * D + 14 * B * T * L * L * Dq + 16 * R * Dq * D,
            3 * M * D * 2 + B * D * 2 + B * T * D * 2 + B * D * 4 + w_s * 2
            + (w_s + 3 * Dq + 2 * D) * 4),
    }


PARTIAL_OPS = ("temporal_phase_tm_partial", "spatial_phase_partial",
               "temporal_phase_tm_bwd_partial", "spatial_phase_bwd_partial")
# phase 13a: the shards' partials summed (f32) with the once-applied biases
# against the unsharded kernel's branch, and the gradients likewise: each
# shard rounds its terms to bf16 where the unsharded op rounds once (the
# CPU test's bounds, tests/test_torch_parallel_ops.py)
PARTIAL_SUM_RMS, PARTIAL_SUM_MAX = 1e-2, 4e-2
# phase 13b: each step's loss of the world against a one-rank step on the
# same global batch, relative: JAX's bound for its TP-fused step against
# the plain one (tests/test_tp_fused.py), the loosest of the three routes'
# sources of difference (bf16 partials summed in f32; gradients averaged
# over ranks; the plain route's bf16 products cut in K). Rank 0's
# first-step gradients (gathered) against the one-rank step's: the train
# step's rule, TRAIN_GRAD_REL_MAX
WORLD_LOSS_RTOL = 2e-3


def phase_13(fb, p, H, dev, part):
    """Phase 13, tensor parallelism and ZeRO-1 (ViT-B/16, D 768, H 12):
    (a) tier C, rows 1p, 4p, 7p and 8p, for tp = 2 and 4 (Dq 384 and 192:
    qkv's 1152 and 576 columns, proj's 384- and 192-deep reduction) at the
    global crops (B=2, T=8, N=196) and at the crops (b)'s TP-fused step
    gives them (its 8 global crops, N=196, and 32 local ones, N=36): every
    shard's outputs against its twin by the twin rules; the shards'
    partials summed with the once-applied biases against the unsharded
    rows 1 and 4 (their f32-out branches), and the gradients likewise
    against rows 7 and 8 (PARTIAL_SUM_*); each op at B=2 and tp = 2 and 4
    timed beside its twin and its bound (library: none, no single call).
    (b) A world of 2 ranks on this one card (the port's launcher, gloo;
    the kernels built here first): 3 bf16 train steps at out_dim 65536,
    batch 4 (8 global 224-px and 32 local 96-px clips, T=8) of the
    TP-fused route (mesh 1 x 2), the plain TP route (1 x 2), ZeRO-1 over
    data parallelism (2 x 1) and plain data parallelism (2 x 1, ZeRO-1's
    memory beside it), each step's loss against a one-rank step on the
    same global batch (WORLD_LOSS_RTOL) and rank 0's first-step gradients
    against the one-rank step's (TRAIN_GRAD_REL_MAX); the TP-fused ranks'
    launch counters hold the tier-C kernels per step and no twin call.
    Returns (stats rows by op, launches by op of the TP-fused
    run, the phase's record)."""
    import numpy as np
    import torch

    from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf
    from dino_video_summarization_transformer_tpu_torch.parallel import launch, worlds
    from dino_video_summarization_transformer_tpu_torch.parallel.tp_fused import qkv_head_perm
    from dino_video_summarization_transformer_tpu_torch.train import ssl

    bf16 = torch.bfloat16
    pt, ps = p["temporal"], p["spatial"]
    D = pt["fc_w"].shape[0]
    T = 8
    print(f"[13] tensor parallelism: (a) tier C (rows 1p, 4p, 7p, 8p) at tp = 2 and 4, timed at "
          f"ViT-B global crops B=2 T={T} N=196 and checked at the crops 13b's step gives them "
          f"(global B=8 N=196, local B=32 N=36); (b) a world of 2 ranks on this card",
          flush=True)
    stats, per_tp = {k: [] for k in PARTIAL_OPS}, {k: {} for k in PARTIAL_OPS}
    row_of = dict(zip(PARTIAL_OPS, ("1p", "4p", "7p", "8p")))

    def shard(tp, l):
        """Shard l's partial-tier weights: the head-major qkv rows, proj's
        input columns, temporal_fc whole."""
        Dq = D // tp
        rows = torch.as_tensor(qkv_head_perm(D, H, tp)[l * 3 * Dq:(l + 1) * 3 * Dq],
                               device=dev)
        wt = {"ln_w": pt["ln_w"], "ln_b": pt["ln_b"],
              "qkv_w": pt["qkv_w"][rows].contiguous(), "qkv_b": pt["qkv_b"][rows].contiguous(),
              "proj_w": pt["proj_w"][:, l * Dq:(l + 1) * Dq].contiguous(),
              "fc_w": pt["fc_w"]}
        ws = {"ln1_w": ps["ln1_w"], "ln1_b": ps["ln1_b"],
              "qkv_w": ps["qkv_w"][rows].contiguous(), "qkv_b": ps["qkv_b"][rows].contiguous(),
              "proj_w": ps["proj_w"][:, l * Dq:(l + 1) * Dq].contiguous()}
        return wt, ws

    def gap(name, got, want, loud):
        """The sum rule's reading: -> (ok, rms, max) of got - want over
        want's (printed where ``loud`` or failing)."""
        got, want = got.float(), want.float()
        d = got - want
        rms = float(d.square().mean().sqrt() / want.square().mean().sqrt().clamp_min(1e-30))
        mx = float(d.abs().max() / want.abs().max().clamp_min(1e-30))
        ok = rms <= PARTIAL_SUM_RMS and mx <= PARTIAL_SUM_MAX
        if loud or not ok:
            print(f"  {name}: rel_rms {rms:.3e} (<= {PARTIAL_SUM_RMS}), rel_max {mx:.3e} (<= "
                  f"{PARTIAL_SUM_MAX}) {'ok' if ok else 'FAILED'}", flush=True)
        return ok, rms, mx

    def tier_c(crops, B, N, seed, timed):
        """Every shard of rows 1p, 4p, 7p and 8p at (B, T, N), tp = 2 and 4,
        against its twin, and the shards' sums against rows 1, 4, 7 and 8.
        ``timed``: shard 0's readings printed in full and each op timed
        beside its twin and its bound; else one line a tp."""
        x, cls = dev_randn(seed, B, T, N, D), dev_randn(seed + 1, B, 1, D)
        dout, dco = dev_randn(seed + 2, B, T, N, D), dev_randn(seed + 3, B, T, D)
        full_t = fb.temporal_phase_tm(x, pt, H) - x.float()  # row 1's branch (f32-out tier)
        full_g, full_c = fb.spatial_phase(x, cls, ps, H, out_dtype=torch.float32)
        full_g = full_g - x.float()
        # rows 7 and 8 through their f32 tier on the same (bf16-exact) rows:
        # dx - dout is the branch unrounded (the bf16 tier's dx rounds
        # dout + branch, which at these weights is ~1e-2 dout)
        x32, dout32 = x.float(), dout.float()
        dx7, g7 = fb.temporal_phase_tm_bwd(x32, dout32, pt, H)
        dx8, dcls8, g8 = fb.spatial_phase_bwd(x32, cls.float(), dout32, dco.float(), ps, H)
        b_comb = pt["proj_b"] @ pt["fc_w"].float().t() + pt["fc_b"]
        for tp in (2, 4):
            Hl, Dq = H // tp, D // tp
            inv = torch.as_tensor(np.argsort(qkv_head_perm(D, H, tp)), device=dev)
            sums = {"t": 0.0, "g": 0.0, "c": 0.0}
            bwd7, bwd8 = [], []
            worst = [0.0, 0.0]  # the twin rules' rel_rms and rel_max over every shard
            for l in range(tp):
                wt, ws = shard(tp, l)
                out_t = fb.temporal_phase_tm(x, wt, Hl, partial_out=True)
                out_g, out_c = fb.spatial_phase(x, cls, ws, Hl, partial_out=True)
                r7 = fb.temporal_phase_tm_bwd(x, dout, wt, Hl, partial_out=True)
                r8 = fb.spatial_phase_bwd(x, cls, dout, dco, ws, Hl, partial_out=True)
                sums["t"] = sums["t"] + out_t.float()
                sums["g"], sums["c"] = sums["g"] + out_g.float(), sums["c"] + out_c.float()
                bwd7.append(r7)
                bwd8.append(r8)
                geo = f"{crops} B={B} N={N} tp={tp} shard {l} (Hl={Hl}, Dq={Dq})"
                want_t = fb.temporal_phase_tm_partial_plain(x, wt, Hl)
                want_s = fb.spatial_phase_partial_plain(x, cls, ws, Hl)
                want7 = fb.temporal_phase_tm_partial_bwd_plain(x, dout, wt, Hl)
                want8 = fb.spatial_phase_partial_bwd_plain(x, cls, dout, dco, ws, Hl)
                pairs = {"temporal_phase_tm_partial": [("out", out_t, want_t)],
                         "spatial_phase_partial": [("grid", out_g, want_s[0]),
                                                   ("cls rows", out_c, want_s[1])],
                         "temporal_phase_tm_bwd_partial": [("dx", r7[0], want7[0])]
                         + [(f"d{k}", r7[1][k], want7[1][k]) for k in want7[1]],
                         "spatial_phase_bwd_partial": [("dx", r8[0], want8[0]),
                                                       ("dcls", r8[1], want8[1])]
                         + [(f"d{k}", r8[2][k], want8[2][k]) for k in want8[2]]}
                loud = timed and not l
                c = {op: [check_close(f"row {row_of[op]} {geo} {what}", got, want,
                                      quiet=not loud) for what, got, want in v]
                     for op, v in pairs.items()}
                for v in c.values():
                    for _, g_ in v:
                        worst[0] = max(worst[0], g_["rel_rms"])
                        worst[1] = max(worst[1], g_["rel_max"])
                if not all(ok for v in c.values() for ok, _ in v):
                    fail(f"a tier-C kernel disagrees with its plain twin ({geo})")
                if not loud:
                    continue
                runs = {"temporal_phase_tm_partial": (
                            lambda: fb.temporal_phase_tm(x, wt, Hl, partial_out=True),
                            lambda: fb.temporal_phase_tm_partial_plain(x, wt, Hl)),
                        "spatial_phase_partial": (
                            lambda: fb.spatial_phase(x, cls, ws, Hl, partial_out=True),
                            lambda: fb.spatial_phase_partial_plain(x, cls, ws, Hl)),
                        "temporal_phase_tm_bwd_partial": (
                            lambda: fb.temporal_phase_tm_bwd(x, dout, wt, Hl, partial_out=True),
                            lambda: fb.temporal_phase_tm_partial_bwd_plain(x, dout, wt, Hl)),
                        "spatial_phase_bwd_partial": (
                            lambda: fb.spatial_phase_bwd(x, cls, dout, dco, ws, Hl,
                                                         partial_out=True),
                            lambda: fb.spatial_phase_partial_bwd_plain(x, cls, dout, dco, ws,
                                                                       Hl))}
                costs = partial_costs(B, T, N, D, Dq)
                for name, (kern, plain) in runs.items():
                    ms, pl = cuda_ms(kern, 10), cuda_ms(plain, 2, warmup=1)
                    dms = graph_ms(kern)  # the device's time, without the wrapper's
                    b, by = bound_ms(*costs[name])
                    gaps = [g_ for _, g_ in c[name]]
                    row = {"crops": "global", "tp": tp, "B": B, "T": T, "N": N, "Dq": Dq,
                           "ms": ms, "device_ms": dms, "plain_ms": pl, "bound_ms": b,
                           "bound_by": by, "library_ms": None,
                           "max_abs_err": max(g_["max_abs_err"] for g_ in gaps),
                           "rel_rms": max(g_["rel_rms"] for g_ in gaps)}
                    per_tp[name][tp] = row
                    if tp == 2:
                        stats[name].append(row)
                    print(f"  {name} {geo}: kernel {ms:.3f} ms (device {dms:.3f} ms), plain "
                          f"{pl:.3f} ms, bound {b:.4f} ms ({by}), {b / dms:.1%} of bound on "
                          "the device; library: none (no single call)", flush=True)
            if not timed:
                print(f"  {crops} B={B} N={N} tp={tp}: rows 1p, 4p, 7p, 8p of all {tp} shards "
                      f"within the twin rules (worst rel_rms {worst[0]:.3e}, rel_max "
                      f"{worst[1]:.3e})", flush=True)
            # the shards' sum against the unsharded ops, forward and backward
            tag = f"{crops} B={B} N={N} tp={tp}"
            fc_bias = torch.outer(dout.float().reshape(-1, D).sum(0), pt["proj_b"])
            got7 = {"dx": sum(d_.float() for d_, _ in bwd7),
                    "ln_w": sum(g_["ln_w"] for _, g_ in bwd7),
                    "ln_b": sum(g_["ln_b"] for _, g_ in bwd7),
                    "fc_w": sum(g_["fc_w"] for _, g_ in bwd7) + fc_bias,
                    "qkv_w": torch.cat([g_["qkv_w"] for _, g_ in bwd7])[inv],
                    "qkv_b": torch.cat([g_["qkv_b"] for _, g_ in bwd7])[inv],
                    "proj_w": torch.cat([g_["proj_w"] for _, g_ in bwd7], dim=1)}
            want7 = {"dx": dx7 - dout32, **g7}
            got8 = {"dx": sum(d_.float() for d_, _, _ in bwd8),
                    "cls": sum(c_ for _, c_, _ in bwd8),
                    "ln1_w": sum(g_["ln1_w"] for _, _, g_ in bwd8),
                    "ln1_b": sum(g_["ln1_b"] for _, _, g_ in bwd8),
                    "qkv_w": torch.cat([g_["qkv_w"] for _, _, g_ in bwd8])[inv],
                    "qkv_b": torch.cat([g_["qkv_b"] for _, _, g_ in bwd8])[inv],
                    "proj_w": torch.cat([g_["proj_w"] for _, _, g_ in bwd8], dim=1)}
            want8 = {"dx": dx8 - dout32, "cls": dcls8, **g8}
            readings = ([gap(f"{tag} sum of row 1p + b_comb vs row 1's branch",
                             sums["t"] + b_comb, full_t, timed),
                         gap(f"{tag} sum of row 4p grid + bproj vs row 4's",
                             sums["g"] + ps["proj_b"], full_g, timed),
                         gap(f"{tag} sum of row 4p cls rows + bproj vs row 4's",
                             sums["c"] + ps["proj_b"], full_c, timed)]
                        + [gap(f"{tag} row 7p sum d{k} vs row 7's", v, want7[k], timed)
                           for k, v in got7.items()]
                        + [gap(f"{tag} row 8p sum d{k} vs row 8's", v, want8[k], timed)
                           for k, v in got8.items()])
            if not timed:
                print(f"  {tag}: the shards' sums vs rows 1, 4, 7, 8 (worst rel_rms "
                      f"{max(r[1] for r in readings):.3e}, rel_max "
                      f"{max(r[2] for r in readings):.3e})", flush=True)
            if not all(r[0] for r in readings):
                fail(f"the tier-C shards do not sum to the unsharded rows ({tag})")
            del sums, bwd7, bwd8
        torch.cuda.empty_cache()

    with torch.inference_mode():
        tier_c("global crops", 2, 196, 130, timed=True)
        # the shapes 13b's TP-fused step gives the kernels: batch 4's 8
        # global and 32 local (96 px) crops
        tier_c("the step's global crops", 8, 196, 140, timed=False)
        tier_c("the step's local crops", 32, 36, 150, timed=False)
    torch.cuda.empty_cache()
    part("phase 13a: tier C")

    # -- 13b: a world of 2 ranks on the card ----------------------------------------
    tcfg = tsf.vit_base_config(num_frames=8, num_classes=0)
    depth = tcfg.depth
    batch, n_local, out_dim, n_steps = 4, 8, 65536, 3
    hp = [(5e-4, 0.04, 0.996, 0.04, True)] * n_steps
    spec = {"cfg": dataclasses.asdict(tcfg), "out_dim": out_dim, "seed": 0, "n_local": n_local,
            "hyper": hp, "crops_seed": (135, n_steps, batch, n_local, 8, 224, 96),
            "device": dev.type, "compute_dtype": "bfloat16", "state": False,
            "count_twins": True}
    modes = [("tp_fused", (1, 2)), ("tp", (1, 2)), ("zero1", (2, 1)), ("dp", (2, 1))]
    t0 = time.perf_counter()
    ranks = launch.run_world(worlds.run_calls, 2, [
        (worlds.sharded_steps, dict(spec, mode=m, mesh=mesh)) for m, mesh in modes],
        threads=0)
    print(f"  world of 2 (gloo on one card): {time.perf_counter() - t0:.1f} s wall for "
          f"its {len(modes)} runs of {n_steps} steps", flush=True)
    # the one-rank references: the same seeded state and global batch, the
    # kernel route (TP-fused, ZeRO-1) and the plain bf16 route (plain TP)
    ref = {}
    for route in ("kernels", "plain"):
        out = worlds.sharded_steps(0, 1, dict(spec, mode="one", count_twins=False,
                                              route=route))
        ref[route] = out
        print(f"  one rank, {route} route: losses {[round(v, 5) for v in out['loss']]}, "
              f"ms a step {[round(v, 1) for v in out['ms']]}, peak allocated "
              f"{out['peak_mib']:.0f} MiB, moments {out['moments_mib']:.0f} MiB", flush=True)
    want_fused = {k: 0 for k in ranks[0][0]["launches"]}
    want_fused.update({"temporal_phase_tm_partial": 3 * depth, "spatial_phase_partial": 3 * depth,
                       "mlp_phase": 6 * depth, "temporal_phase_tm_bwd_partial": 2 * depth,
                       "spatial_phase_bwd_partial": 2 * depth,
                       "mlp_phase_bwd": 2 * (2 * depth - 1)})
    want_fused = {k: n_steps * v for k, v in want_fused.items()}
    record = {}
    for i, (mode, mesh) in enumerate(modes):
        base = ref["plain" if mode == "tp" else "kernels"]
        # rank 0's first-step gradients, gathered into the single-card
        # layout, against the one-rank step's (a dropped or doubled reduce
        # of a partial gradient moves a tensor by about half its size)
        got_g, want_g = ranks[0][i]["grads"], base["grads"]
        if set(got_g) != set(want_g):
            fail(f"the {mode} world's gradients have other names than the one-rank step's")
        g_rel = {n: float(np.abs(got_g[n] - w).max() / (np.abs(w).max() + 1e-12))
                 for n, w in want_g.items()}
        g_worst = max(g_rel, key=g_rel.get)
        print(f"  {mode} {mesh[0]}x{mesh[1]} first-step gradients vs one rank's: worst "
              f"max|diff| / max|one rank| {g_rel[g_worst]:.3e} ({g_worst}; < "
              f"{TRAIN_GRAD_REL_MAX}), median {float(np.median(list(g_rel.values()))):.3e}",
              flush=True)
        if not g_rel[g_worst] < TRAIN_GRAD_REL_MAX:
            fail(f"the {mode} world's gradients stray from the one-rank step's ({g_worst})")
        for r, res in enumerate(ranks):
            out = res[i]
            errs = [abs(a - b_) / abs(b_) for a, b_ in zip(out["loss"], base["loss"])]
            seen = {k: v for k, v in out["launches"].items() if v}
            twins_called = {k: v for k, v in out.get("twins", {}).items() if v}
            print(f"  {mode} {mesh[0]}x{mesh[1]} rank {r}: losses "
                  f"{[round(v, 5) for v in out['loss']]} (relative to one rank "
                  f"{max(errs):.2e} <= {WORLD_LOSS_RTOL}), ms a step "
                  f"{[round(v, 1) for v in out['ms']]}, peak allocated "
                  f"{out['peak_mib']:.0f} MiB, moments {out['moments_mib']:.0f} MiB, launches "
                  f"{seen or 'none'}, twin calls {twins_called or 'none'}", flush=True)
            if not all(np.isfinite(out["loss"])) or max(errs) > WORLD_LOSS_RTOL:
                fail(f"the {mode} world's losses stray from the one-rank step's")
            if twins_called:
                fail(f"the {mode} world called plain twins on the card: {twins_called}")
            if mode == "tp_fused" and out["launches"] != want_fused:
                fail(f"TP-fused launches {seen}, expected {n_steps} steps of "
                     f"{ {k: v // n_steps for k, v in want_fused.items() if v} }")
            if mode == "tp" and seen:
                fail(f"the plain TP route launched port kernels: {seen}")
            if mode in ("zero1", "dp") and out["launches"] != ref["kernels"]["launches"]:
                fail(f"{mode} launches {seen}, not the one-rank kernel route's")
        record[mode] = {"losses": [res[i]["loss"] for res in ranks],
                        "ms_per_step": [res[i]["ms"] for res in ranks],
                        "peak_mib": [res[i]["peak_mib"] for res in ranks],
                        "moments_mib": [res[i]["moments_mib"] for res in ranks],
                        "grad_rel_max": g_rel[g_worst],
                        "one_rank_losses": base["loss"], "one_rank_ms": base["ms"]}
    record["one_rank_kernels_ms"] = ref["kernels"]["ms"]
    part("phase 13b: the world of 2")
    launches = {k: ranks[0][0]["launches"][k] for k in PARTIAL_OPS}
    launches_by_rank = [{k: res[0]["launches"][k] for k in PARTIAL_OPS} for res in ranks]
    return stats, per_tp, launches, launches_by_rank, record


def main():
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        fail(f"missing dependency: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    sys.path.insert(0, REPO)
    try:
        from dino_video_summarization_transformer_tpu_torch.data.transform import (
            tensor_normalize)
        from dino_video_summarization_transformer_tpu_torch.data.windows import (
            window_indices)
        from dino_video_summarization_transformer_tpu_torch.engine.scoring import (
            make_scorers, run_scoring)
        from dino_video_summarization_transformer_tpu_torch.models import (
            banded, convert, timesformer as tsf)
        from dino_video_summarization_transformer_tpu_torch.ops import (
            _build, attention as fa, banded_block as bb, fused_block as fb,
            quant, twin_check, wire)
        from dino_video_summarization_transformer_tpu_torch.data import yuv
        from dino_video_summarization_transformer_tpu_torch.tools import (
            cls_band_bench, smem_probe)
        from dino_video_summarization_transformer_tpu_torch.utils.synthetic import (
            make_numpy_params, make_video)
    except ImportError as e:
        fail(f"the port package is not importable here: {e}")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")
    t_start = time.perf_counter()
    marks = [t_start, t_start]

    def lap(tag):
        """Print the wall seconds since the last lap (each phase's time)."""
        now = time.perf_counter()
        print(f"  ({tag}: {now - marks[0]:.1f} s wall)", flush=True)
        marks[0] = marks[1] = now

    def part(tag):
        """Print the wall seconds of one part of a phase (since the last
        part or lap)."""
        now = time.perf_counter()
        print(f"  (part: {tag}, {now - marks[1]:.1f} s wall)", flush=True)
        marks[1] = now

    # -- 1. card ----------------------------------------------------------------
    card = card_line()
    print(f"[1] card: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))",
          flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain twins in true f32

    # -- 2. build -----------------------------------------------------------------
    t0 = time.perf_counter()
    results = _build.build(force=True)
    print(f"[2] build: {time.perf_counter() - t0:.1f} s wall, "
          + ", ".join(f"{os.path.basename(r.path)} {r.seconds:.1f} s"
                      for r in results), flush=True)
    for res in results:
        fn = None
        for line in res.log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "Used" in line and fn:
                print(f"  {fn}: {line.split(':', 1)[1].strip()}", flush=True)
            elif "spill stores" in line and fn and not line.strip().startswith("0 bytes stack"):
                print(f"  {fn}: {line.strip()}", flush=True)
            elif "warning" in line.lower() and "wgmma" in line.lower():
                print(f"  {os.path.basename(res.path)}: {line.strip()[:200]}",
                      flush=True)
    for name in _build.SOURCES:
        _build.load(name)

    # -- 3. kernels against their twins at ViT-B widths -------------------------
    lap("phases 1-2")
    cfg = tsf.vit_base_config(num_frames=8, num_classes=0)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, seed=0), cfg)
    D, H, N = cfg.embed_dim, cfg.num_heads, cfg.num_patches
    Dh = int(D * cfg.mlp_ratio)
    one_block = tsf.build_timesformer(
        tsf.TimeSformerConfig(embed_dim=D, depth=1, num_heads=H, num_frames=8,
                              num_classes=0), sd, device=dev)
    p = fb.block_params(one_block.blocks[0])
    print("[3] kernels vs plain twins (N=196, D=768, H=12)", flush=True)
    stats = {"temporal_phase_tm": [], "spatial_mlp": [],
             "banded_temporal_attn": [], "spatial_phase_pf": [],
             "cls_band_attn": [], "mlp_phase": []}

    # the strided scorer's new kernel geometries first, so that a geometry
    # the card refuses shows before anything else: rows 1f and 2f (the f32
    # tier) at the students' window (B=8, T=3; f32 students on the
    # kernels), on offset rows (twin_check.offset_rows), each output held
    # on its branch by the twin rules and by twin_check's f32 rule
    # (bf16_exact: an f32 output rounded to bf16 fails it); rows 1 and 2
    # (bf16) at teacher_img=160's grid (N=100, the teacher's B=8, T=30)
    print("  the strided path's new geometries: rows 1f and 2f at B=8 T=3 (offset "
          "rows), rows 1 and 2 at N=100 (teacher_img=160)", flush=True)
    pt, ps = p["temporal"], p["spatial"]
    geo_f32, geo_img = {}, {}
    B, T = 8, 3
    xw, x1w, clsw = (dev_offset_rows(91, B, T, N, D), dev_offset_rows(92, B, T, N, D),
                     dev_offset_rows(93, B, 1, D))
    with torch.inference_mode():
        got_t, want_t = fb.temporal_phase_tm(xw, pt, H), fb.temporal_phase_tm_plain(xw, pt, H)
        got_s, want_s = fb.spatial_mlp(x1w, clsw, ps, H), fb.spatial_mlp_plain(x1w, clsw, ps, H)
        checks = {"temporal_phase_tm_f32": [
                      check_close(f"temporal_phase_tm_f32 out-x B={B} T={T}", got_t, want_t, xw)],
                  "spatial_mlp_f32": [
                      check_close(f"spatial_mlp_f32 grid-x1 B={B} T={T}", got_s[0], want_s[0],
                                  x1w),
                      check_close(f"spatial_mlp_f32 cls rows B={B} T={T}", got_s[1], want_s[1])]}
        f32_bad = []
        for tag, t in (("temporal_phase_tm_f32 out", got_t), ("spatial_mlp_f32 grid", got_s[0])):
            bad = twin_check.f32_failures(t)
            print(f"  {tag} B={B} T={T}: bf16_exact={twin_check.bf16_exact(t):.3e} "
                  f"{'ok' if not bad else 'FAILED: ' + '; '.join(bad)}", flush=True)
            f32_bad += bad
        del got_t, want_t, got_s, want_s
        if f32_bad or not all(ok for v in checks.values() for ok, _ in v):
            fail(f"an f32 tier disagrees with its plain twin at the students' window "
                 f"(B={B}, T={T})")
        runs = {"temporal_phase_tm_f32": (lambda: fb.temporal_phase_tm(xw, pt, H),
                                          lambda: fb.temporal_phase_tm_plain(xw, pt, H),
                                          temporal_f32_cost(B, T, N, D)),
                "spatial_mlp_f32": (lambda: fb.spatial_mlp(x1w, clsw, ps, H),
                                    lambda: fb.spatial_mlp_plain(x1w, clsw, ps, H),
                                    spatial_f32_cost(B, T, N, D, Dh))}
        for name, (kern, plain, cost) in runs.items():
            ms, pl = cuda_ms(kern, 50), cuda_ms(plain, 5)
            b, by = bound_ms(*cost)
            gaps = [gap for _, gap in checks[name]]
            geo_f32[name] = {"B": B, "T": T, "ms": ms, "plain_ms": pl, "bound_ms": b,
                             "bound_by": by, "library_ms": None,
                             "max_abs_err": max(g["max_abs_err"] for g in gaps),
                             "rel_rms": max(g["rel_rms"] for g in gaps)}
            print(f"  {name} B={B} T={T}: kernel {ms:.3f} ms, plain {pl:.3f} ms, bound "
                  f"{b:.4f} ms ({by}, f32 carry bytes), {b / ms:.1%} of bound; library: "
                  "none (no single call)", flush=True)
    del xw, x1w, clsw, runs
    B, T, Ni = 8, 30, 100
    x, x1 = dev_randn(94, B, T, Ni, D), dev_randn(95, B, T, Ni, D, dtype=torch.float32)
    cls = dev_randn(96, B, 1, D)
    with torch.inference_mode():
        g, c = fb.spatial_mlp(x1, cls, ps, H)
        g0, c0 = fb.spatial_mlp_plain(x1, cls, ps, H)
        checks = {"temporal_phase_tm": [check_close(
                      f"temporal_phase_tm out-x B={B} T={T} N={Ni}", fb.temporal_phase_tm(x, pt, H),
                      fb.temporal_phase_tm_plain(x, pt, H), x)],
                  "spatial_mlp": [
                      check_close(f"spatial_mlp grid-x1 B={B} T={T} N={Ni}", g, g0, x1),
                      check_close(f"spatial_mlp cls B={B} T={T} N={Ni}", c, c0)]}
        del g, c, g0, c0
        if not all(ok for v in checks.values() for ok, _ in v):
            fail(f"a kernel disagrees with its plain twin at teacher_img=160's grid (N={Ni})")
        runs = {"temporal_phase_tm": (lambda: fb.temporal_phase_tm(x, pt, H),
                                      lambda: fb.temporal_phase_tm_plain(x, pt, H),
                                      temporal_cost(B, T, Ni, D)),
                "spatial_mlp": (lambda: fb.spatial_mlp(x1, cls, ps, H),
                                lambda: fb.spatial_mlp_plain(x1, cls, ps, H),
                                spatial_cost(B, T, Ni, D, Dh))}
        for name, (kern, plain, cost) in runs.items():
            ms, pl = cuda_ms(kern, 20), cuda_ms(plain, 5)
            b, by = bound_ms(*cost)
            gaps = [gap for _, gap in checks[name]]
            geo_img[name] = {"B": B, "T": T, "N": Ni, "ms": ms, "plain_ms": pl, "bound_ms": b,
                             "bound_by": by, "library_ms": None,
                             "max_abs_err": max(g["max_abs_err"] for g in gaps),
                             "rel_rms": max(g["rel_rms"] for g in gaps)}
            print(f"  {name} B={B} T={T} N={Ni}: kernel {ms:.3f} ms, plain {pl:.3f} ms, bound "
                  f"{b:.4f} ms ({by}), {b / ms:.1%} of bound", flush=True)
    del x, x1, cls, runs
    torch.cuda.empty_cache()
    part("the strided path's new geometries")

    # the frame wire's gather first, so that a fault in it shows within the
    # first minute: kernel against twin bit for bit (max abs 0) on the
    # three layouts in f32 and bf16, at the teacher views of one chunk (8 x
    # 30 frames gathered from a 64-frame buffer by the scorer's windows),
    # the students' (8 x 3), the banded flat gather (512 indices, padding
    # repeating the segment's last frame, from a 600-frame buffer), and
    # packed 226 x 224 frames (H = 2 mod 4: the U plane ends mid-row).
    # Any bytes are a packed frame, so the buffers are random bytes.
    print("  the frame wire's gather (gather_normalize), kernel vs twin bit for "
          "bit", flush=True)
    r = np.random.RandomState(13)
    wloc, wglob, _ = window_indices(64, 3, 30)
    wire_idx = {"teacher": wglob[:8], "student": wloc[:8],
                "band": np.minimum(np.arange(BAND_C), 479)}
    stats["gather_normalize"], wire_cases = [], []
    bf16, f32t = torch.bfloat16, torch.float32
    for layout in ("yuv420", "rgb8", "yuv420q"):
        for n_frames, H_img in ((64, 224), (600, 224), (8, 226)):
            if H_img == 226 and layout != "yuv420":
                continue
            shape = ((n_frames, H_img, 224, 3) if layout == "rgb8" else
                     (n_frames, yuv.packed_height(H_img), 224) if layout == "yuv420"
                     else (n_frames, yuv.packed_q_height(H_img, 224), 224))
            buf = torch.from_numpy(r.randint(0, 256, shape, dtype=np.uint8)).to(dev)
            kinds = (["band"] if n_frames == 600 else ["teacher", "student"]
                     if H_img == 224 else ["odd"])
            for kind in kinds:
                idx = r.randint(0, n_frames, 20) if kind == "odd" else wire_idx[kind]
                for dt in (bf16, f32t):
                    with torch.inference_mode():
                        got = wire.gather_normalize(buf, idx, dt, layout)
                        want = wire.gather_normalize_plain(buf, idx, dt, layout)
                    err = float((got.float() - want.float()).abs().max())
                    tag = f"{layout} {kind} M={idx.size} H={H_img} {str(dt)[6:]}"
                    if not torch.equal(got, want):
                        fail(f"gather_normalize {tag}: kernel differs from its twin "
                             f"(max abs {err:.3e})")
                    del got, want
                    M = idx.size
                    nbytes = wire.gather_bytes(buf, idx, dt, layout)
                    for _try in range(3):  # a profile that missed the kernel is taken again
                        rows, _ = kernel_breakdown(lambda: [wire.gather_normalize(
                            buf, idx, dt, layout) for _ in range(10)])
                        dev_ms = [ms / n for k, n, ms in rows
                                  if "gather_normalize_kernel" in k]
                        if dev_ms:
                            break
                        time.sleep(1.0)
                    else:
                        fail(f"gather_normalize {tag}: the profile saw no kernel")
                    ev = cuda_ms(lambda: wire.gather_normalize(buf, idx, dt, layout), 20)
                    pl = cuda_ms(lambda: wire.gather_normalize_plain(buf, idx, dt, layout),
                                 5, warmup=1)
                    b, by = bound_ms(0, nbytes)
                    row = {"layout": layout, "kind": kind, "M": int(M), "H": H_img,
                           "dtype": str(dt)[6:], "ms": dev_ms[0], "event_ms": ev,
                           "plain_ms": pl, "bound_ms": b, "bound_by": by,
                           "library_ms": None, "max_abs_err": err, "bytes": nbytes}
                    wire_cases.append(row)
                    # the kernels line sums the main path's calls on its
                    # default wire: a chunk's teacher and student views (bf16;
                    # f32 for the mixed teacher's) and a banded segment's
                    if layout == "yuv420" and H_img == 224 and (
                            dt == bf16 or kind == "teacher"):
                        stats["gather_normalize"].append(row)
                    print(f"  gather_normalize {tag}: bit-equal, device {dev_ms[0]:.4f} "
                          f"ms (events {ev:.4f} ms a call, host included), plain "
                          f"{pl:.3f} ms, bound {b:.4f} ms ({nbytes / 1e6:.1f} MB), "
                          f"{b / dev_ms[0]:.1%} of bound", flush=True)
            del buf
    torch.cuda.empty_cache()
    part("the wire gather")
    for B, T in [(8, 30), (8, 3)]:
        r = np.random.RandomState(T)
        x = torch.from_numpy(r.randn(B, T, N, D)).to(dev, torch.bfloat16)
        x1 = torch.from_numpy(r.randn(B, T, N, D)).to(dev, torch.float32)
        cls = torch.from_numpy(r.randn(B, 1, D)).to(dev, torch.bfloat16)
        iters = 20 if T > 8 else 50
        with torch.inference_mode():
            g, c = fb.spatial_mlp(x1, cls, p["spatial"], H)
            g0, c0 = fb.spatial_mlp_plain(x1, cls, p["spatial"], H)
            checks = [
                check_close(f"temporal_phase_tm out-x B={B} T={T}",
                            fb.temporal_phase_tm(x, p["temporal"], H),
                            fb.temporal_phase_tm_plain(x, p["temporal"], H), x),
                check_close(f"spatial_mlp grid-x1 B={B} T={T}", g, g0, x1),
                check_close(f"spatial_mlp cls B={B} T={T}", c, c0)]
            if not all(ok for ok, _ in checks):
                fail(f"a kernel disagrees with its plain twin at B={B} T={T}")
            gaps = [gap for _, gap in checks]
            ms_t = cuda_ms(lambda: fb.temporal_phase_tm(x, p["temporal"], H), iters)
            pl_t = cuda_ms(lambda: fb.temporal_phase_tm_plain(x, p["temporal"], H), 5)
            ms_s = cuda_ms(lambda: fb.spatial_mlp(x1, cls, p["spatial"], H), iters)
            pl_s = cuda_ms(lambda: fb.spatial_mlp_plain(x1, cls, p["spatial"], H), 5)
        bt, by_t = bound_ms(*temporal_cost(B, T, N, D))
        bs, by_s = bound_ms(*spatial_cost(B, T, N, D, Dh))
        for name, ms, pl, b, by, op_gaps in [
                ("temporal_phase_tm", ms_t, pl_t, bt, by_t, gaps[:1]),
                ("spatial_mlp", ms_s, pl_s, bs, by_s, gaps[1:])]:
            stats[name].append({
                "B": B, "T": T, "ms": ms, "plain_ms": pl, "bound_ms": b,
                "bound_by": by, "library_ms": None,
                "max_abs_err": max(g["max_abs_err"] for g in op_gaps),
                "rel_rms": max(g["rel_rms"] for g in op_gaps)})
            print(f"  {name} B={B} T={T}: kernel {ms:.3f} ms, plain {pl:.3f} ms,"
                  f" bound {b:.4f} ms ({by}), {b / ms:.1%} of bound", flush=True)
        # where the time goes inside each op, split into attention, GEMMs, LN
        for name, fn in [
                ("temporal_phase_tm",
                 lambda: fb.temporal_phase_tm(x, p["temporal"], H)),
                ("spatial_mlp",
                 lambda: fb.spatial_mlp(x1, cls, p["spatial"], H))]:
            record_split(f"{name} B={B} T={T}", fn, stats[name][-1], op=name)
    del x, x1, cls

    part("rows 1 and 2")

    # the f32 ("mixed") tiers of the mixed teacher: row 1 on f32 x and row 2
    # with an f32 CLS row and an f32 grid at the teacher window, rows 3 and
    # 11 on f32 rows at the 512-frame bucket; each output = x + branch held
    # on its branch. The inputs are rows with a large common offset and a
    # small spread (twin_check.offset_rows): a kernel that rounds an f32
    # input to bf16 before its LN loses much of the spread and fails here,
    # where on unit-variance rows it would pass.
    print("  the f32 tiers (mixed teacher), on offset rows", flush=True)
    B, T = 8, 30
    r = np.random.RandomState(70)

    def f32_rows(*shape):
        return torch.from_numpy(twin_check.offset_rows(r, shape)).to(dev)

    xw, x1w, clsw = f32_rows(B, T, N, D), f32_rows(B, T, N, D), f32_rows(B, 1, D)
    xm32 = f32_rows(BAND_C * N, D)
    band_f32_rows = {}
    xg32, cg32 = f32_rows(BAND_C, N, D), f32_rows(BAND_C, D)
    pt, ps = p["temporal"], p["spatial"]
    runs32 = {
        "temporal_phase_tm_f32": (
            lambda: fb.temporal_phase_tm(xw, pt, H),
            lambda: fb.temporal_phase_tm_plain(xw, pt, H),
            temporal_f32_cost(B, T, N, D), {"B": B, "T": T}),
        "spatial_mlp_f32": (
            lambda: fb.spatial_mlp(x1w, clsw, ps, H),
            lambda: fb.spatial_mlp_plain(x1w, clsw, ps, H),
            spatial_f32_cost(B, T, N, D, Dh), {"B": B, "T": T}),
        "mlp_phase_f32": (
            lambda: fb.mlp_phase(xm32, ps), lambda: fb.mlp_phase_plain(xm32, ps),
            mlp_cost(BAND_C * N, D, Dh, elem=4), {"C": BAND_C, "M": BAND_C * N}),
        "spatial_phase_pf_f32": (
            lambda: bb.spatial_phase_pf(xg32, cg32, ps, H),
            lambda: bb.spatial_phase_pf_plain(xg32, cg32, ps, H),
            pf_f32_cost(BAND_C, N, D), {"C": BAND_C}),
    }
    with torch.inference_mode():
        checks = {}
        for name, (kern, plain, _, _) in runs32.items():
            got, want = kern(), plain()
            if name == "temporal_phase_tm_f32":
                checks[name] = [check_close(f"{name} out-x B={B} T={T}", got, want, xw)]
            elif name == "spatial_mlp_f32":
                checks[name] = [check_close(f"{name} grid-x1 B={B} T={T}", got[0], want[0], x1w),
                                check_close(f"{name} cls rows B={B} T={T}", got[1], want[1])]
            elif name == "mlp_phase_f32":
                checks[name] = [check_close(f"{name} out-x M={BAND_C * N}", got, want, xm32)]
            else:
                checks[name] = [
                    check_close(f"{name} grid-x C={BAND_C}", got[0], want[0], xg32),
                    check_close(f"{name} qkv C={BAND_C}", got[1], want[1]),
                    check_close(f"{name} qkv_cls C={BAND_C}", got[2], want[2])]
            dtypes = [t.dtype for t in (got if isinstance(got, tuple) else (got,))]
            print(f"  {name} output dtypes {dtypes}", flush=True)
            if dtypes[0] != torch.float32:
                fail(f"{name} wrote {dtypes[0]}, not the f32 tier's f32")
            del got, want
        if not all(ok for v in checks.values() for ok, _ in v):
            fail("an f32 tier disagrees with its plain twin")
        for name, (kern, plain, cost, shape) in runs32.items():
            ms = cuda_ms(kern, 10)
            pl = cuda_ms(plain, 2, warmup=1)
            b, by = bound_ms(*cost)
            gaps = [gap for _, gap in checks[name]]
            row = {**shape, "ms": ms, "plain_ms": pl, "bound_ms": b, "bound_by": by,
                   "library_ms": None,
                   "max_abs_err": max(g["max_abs_err"] for g in gaps),
                   "rel_rms": max(g["rel_rms"] for g in gaps)}
            # rows 3 and 11's f32 tiers serve the banded mixed teacher
            # (band-mt, phase 6b), at the 512-frame bucket
            if name in ("mlp_phase_f32", "spatial_phase_pf_f32"):
                band_f32_rows[name] = row
            if name in ("temporal_phase_tm_f32", "spatial_mlp_f32"):
                # the teacher's window, then the students' (the start of
                # phase 3): f32 students on the kernels run both
                stats[name] = [row, geo_f32[name]]
            print(f"  {name} {shape}: kernel {ms:.3f} ms, plain {pl:.3f} ms, bound "
                  f"{b:.4f} ms ({by}, f32 carry bytes), {b / ms:.1%} of bound; "
                  "library: none (no single call)", flush=True)
    del xw, x1w, clsw, xm32, xg32, cg32, runs32
    torch.cuda.empty_cache()

    part("the f32 tiers")

    # the training ops at the train step's global and local crop shapes
    for k in TRAIN_OPS:
        stats[k] = []
    mlp_crops = []
    for tag, (B, T, Np) in [("global", (16, 8, N)), ("local", (64, 8, 36))]:
        r = np.random.RandomState(40 + Np)

        def rnd(*shape):
            return torch.from_numpy(r.randn(*shape).astype(np.float32)).to(dev, bf16)

        x, cls, dout, dco = rnd(B, T, Np, D), rnd(B, 1, D), rnd(B, T, Np, D), rnd(B, T, D)
        mlp_crops.append(train_op_checks(fb, p, H, D, Dh, tag, x, cls, dout, dco, stats,
                                         split=True))
        del x, cls, dout, dco
        torch.cuda.empty_cache()

    part("the training ops")

    # the banded kernels at the full bucket, teacher and student pass
    C, M = BAND_C, BAND_C * N
    hd = D // H
    r = np.random.RandomState(5)
    # attention inputs: unit-variance qkv rows (logits of std ~1, sharper
    # than the random-weight model's, so a wrong key set shows)
    qkv = torch.from_numpy(r.randn(C, N, 3 * D)).to(dev, torch.bfloat16)
    qkv_cls = torch.from_numpy(r.randn(C, 3 * D)).to(dev, torch.bfloat16)
    xg = torch.from_numpy(r.randn(C, N, D)).to(dev, torch.bfloat16)
    cls_rows = torch.from_numpy(r.randn(C, D)).to(dev, torch.bfloat16)
    xm = xg.reshape(M, D)
    sdpa_q, sdpa_k, sdpa_v = (
        qkv[..., i * D:(i + 1) * D].reshape(C, N, H, hd).permute(1, 2, 0, 3)
        .contiguous() for i in range(3))  # (N, H, C, hd): the library layout
    for eff in (30, 3):
        lo = bb.band_starts(torch.arange(C, device=dev), eff, C)
        kj = torch.arange(C, device=dev)
        band_mask = (kj[None] >= lo[:, None]) & (kj[None] < lo[:, None] + eff)
        with torch.inference_mode():
            pf = bb.spatial_phase_pf(xg, cls_rows, p["spatial"], H)
            pf0 = bb.spatial_phase_pf_plain(xg, cls_rows, p["spatial"], H)
            checks = {
                "banded_temporal_attn": [check_close(
                    f"banded_temporal_attn C={C} eff={eff}",
                    bb.banded_temporal_attn(qkv, C, eff, H),
                    bb.banded_temporal_attn_plain(qkv, C, eff, H))],
                "spatial_phase_pf": [
                    check_close(f"spatial_phase_pf grid-x C={C}", pf[0], pf0[0], xg),
                    check_close(f"spatial_phase_pf qkv C={C}", pf[1], pf0[1]),
                    check_close(f"spatial_phase_pf qkv_cls C={C}", pf[2], pf0[2])],
                "cls_band_attn": [check_close(
                    f"cls_band_attn C={C} eff={eff}",
                    bb.cls_band_attn(qkv_cls, qkv, C, eff, H),
                    bb.cls_band_attn_plain(qkv_cls, qkv, C, eff, H))],
                "mlp_phase": [check_close(
                    f"mlp_phase out-x M={M}", fb.mlp_phase(xm, p["spatial"]),
                    fb.mlp_phase_plain(xm, p["spatial"]), xm)],
            }
            del pf, pf0
            # row 12 against its f32 reference (f32 probabilities, no bf16
            # rounding of P or of the output): the kernel's error and the
            # twin's, which rounds where the kernel rounds (printed; a
            # kernel well beyond the twin here is a fault of its own)
            ref12 = bb.cls_band_attn_f32_plain(qkv_cls, qkv, C, eff, H)
            vs_ref = {}
            for who, out12 in (("kernel", bb.cls_band_attn(qkv_cls, qkv, C, eff, H)),
                               ("twin", bb.cls_band_attn_plain(qkv_cls, qkv, C, eff, H))):
                d12 = out12.float() - ref12
                vs_ref[who] = {"rel_rms": float(d12.square().mean().sqrt()
                                                / ref12.square().mean().sqrt()),
                               "max_abs_err": float(d12.abs().max())}
            del ref12, out12, d12
            print(f"  cls_band_attn C={C} eff={eff} against its f32 reference: kernel "
                  f"rel_rms {vs_ref['kernel']['rel_rms']:.4e} max_abs "
                  f"{vs_ref['kernel']['max_abs_err']:.4e}, twin rel_rms "
                  f"{vs_ref['twin']['rel_rms']:.4e} max_abs "
                  f"{vs_ref['twin']['max_abs_err']:.4e} (kernel / twin "
                  f"{vs_ref['kernel']['rel_rms'] / vs_ref['twin']['rel_rms']:.4f})",
                  flush=True)
            if not all(ok for v in checks.values() for ok, _ in v):
                fail(f"a banded kernel disagrees with its plain twin at eff={eff}")
            runs = {
                "banded_temporal_attn": (
                    lambda: bb.banded_temporal_attn(qkv, C, eff, H),
                    lambda: bb.banded_temporal_attn_plain(qkv, C, eff, H),
                    band_temporal_cost(C, N, D, eff)),
                "spatial_phase_pf": (
                    lambda: bb.spatial_phase_pf(xg, cls_rows, p["spatial"], H),
                    lambda: bb.spatial_phase_pf_plain(xg, cls_rows, p["spatial"], H),
                    pf_cost(C, N, D)),
                "cls_band_attn": (
                    lambda: bb.cls_band_attn(qkv_cls, qkv, C, eff, H),
                    lambda: bb.cls_band_attn_plain(qkv_cls, qkv, C, eff, H),
                    cls_band_cost(C, N, D, eff)),
                "mlp_phase": (
                    lambda: fb.mlp_phase(xm, p["spatial"]),
                    lambda: fb.mlp_phase_plain(xm, p["spatial"]),
                    mlp_cost(M, D, Dh)),
            }
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                sdpa_q, sdpa_k, sdpa_v, attn_mask=band_mask), 10)
            for name, (kern, plain, cost) in runs.items():
                ms = cuda_ms(kern, 10)
                pl = cuda_ms(plain, 2, warmup=1)
                b, by = bound_ms(*cost)
                gaps = [gap for _, gap in checks[name]]
                row = {"C": C, "eff": eff, "ms": ms, "plain_ms": pl,
                       "bound_ms": b, "bound_by": by,
                       "library_ms": lib if name == "banded_temporal_attn" else None,
                       "max_abs_err": max(g["max_abs_err"] for g in gaps),
                       "rel_rms": max(g["rel_rms"] for g in gaps)}
                extra = ""
                if name == "banded_temporal_attn":
                    row["device_ms"] = graph_ms(kern)
                    extra = (f", device {row['device_ms']:.3f} ms, SDPA with the "
                             f"band mask {lib:.3f} ms")
                if name == "cls_band_attn":
                    row["vs_f32_reference"] = vs_ref
                    # its block shape on this card, two calls bit for bit,
                    # and beside the bound's one read of the patch K / V
                    # the bytes a model says it moves (each overlapping
                    # tile's re-read counted as an HBM read: nothing
                    # measures it, so it stays out of the kernels line)
                    shape = cls_band_bench.library_shape(_build.load("banded"), C, N, D, H, eff)
                    model = cls_band_bench.modelled_traffic(C, N, D, C, eff, shape)
                    row["device_ms"] = graph_ms(kern)
                    same = torch.equal(kern(), kern())
                    row["bit_identical"] = same
                    extra = (f", device {row['device_ms']:.3f} ms; block shape "
                             f"(strips, warps a strip, splits) {shape}; modelled "
                             f"traffic {model['bytes'] / 1e6:.1f} MB (patch K/V "
                             f"re-read {model['reread']:.3f}x, a model) = "
                             f"{model['bytes'] / row['device_ms'] / 1e6:.0f} GB/s "
                             f"modelled, against the bound's {cost[1] / 1e6:.1f} MB; "
                             f"two calls bit-identical: {same}")
                    if not same:
                        fail(f"cls_band_attn at eff={eff}: two calls differ")
                if name in ("spatial_phase_pf", "mlp_phase"):
                    rows, _ = kernel_breakdown(kern)
                    row["device_ms"] = sum(r_[2] for r_ in rows)
                    row["split_ms"] = split_ms(rows)
                    extra = (f"; device {row['device_ms']:.3f} ms: " + ", ".join(
                        f"{k} {v:.3f} ms" for k, v in row["split_ms"].items()))
                stats[name].append(row)
                print(f"  {name} C={C} eff={eff}: kernel {ms:.3f} ms, plain "
                      f"{pl:.3f} ms, bound {b:.4f} ms ({by}), {b / ms:.1%} of "
                      f"bound{extra}", flush=True)
    del qkv, qkv_cls, xg, cls_rows, xm, sdpa_q, sdpa_k, sdpa_v

    part("the banded kernels")

    # the XLA-layout block's two attention phases and the standalone
    # attention, at the chunk-8 scorer's teacher and student windows. They
    # are profiled ahead of the blocks-alone timings below: on the card,
    # profiles taken after those timings (their CUDA graphs of the backward
    # tiles, SDPA's and LayerNorm's backwards by autograd) recorded no
    # kernel in about every other profile, at times three in a row
    for name in ("attn_phase", "temporal_phase", "fused_attention"):
        stats[name] = []
    B = 8
    for T in (30, 3):
        r = np.random.RandomState(60 + T)
        xs = torch.from_numpy(r.randn(B * T, N + 1, D)).to(dev, torch.bfloat16)
        xt = torch.from_numpy(r.randn(B * N, T, D)).to(dev, torch.bfloat16)
        ps, pt = p["spatial"], p["temporal"]
        runs = {
            "attn_phase": (lambda: fb.attn_phase(xs, ps, H),
                           lambda: fb.attn_phase_plain(xs, ps, H),
                           attn_phase_cost(B * T, N + 1, D)),
            "temporal_phase": (lambda: fb.temporal_phase(xt, pt, H),
                               lambda: fb.temporal_phase_plain(xt, pt, H),
                               temporal_phase_cost(B * N, T, D)),
        }
        with torch.inference_mode():
            # row 5's output is the branch itself. Row 6's is bf16(x +
            # bf16(branch)): the branch is held through the f32-out tier
            # of the same launches (temporal_phase_tm with N = 1), the bf16
            # output at two ulps of the twin's (ops/twin_check.py)
            xt4 = xt.view(B * N, T, 1, D)
            checks = {
                "attn_phase": check_close(
                    f"attn_phase out S={B * T} L={N + 1}",
                    fb.attn_phase(xs, ps, H), fb.attn_phase_plain(xs, ps, H)),
                "temporal_phase": check_close(
                    f"temporal_phase f32-out tier out-x S={B * N} L={T}",
                    fb.temporal_phase_tm(xt4, pt, H),
                    fb.temporal_phase_tm_plain(xt4, pt, H), xt4)}
            got6, want6 = fb.temporal_phase(xt, pt, H), fb.temporal_phase_plain(xt, pt, H)
            ulps6 = twin_check.rounding_ulps(got6, want6, xt)
            err6 = float((got6.float() - want6.float()).abs().max())
            print(f"  temporal_phase bf16 out S={B * N} L={T}: max_abs_err={err6:.3e} "
                  f"{ulps6:.2f} ulps (<= {twin_check.ROUNDING_ULPS})", flush=True)
            del got6, want6
            if not all(ok for ok, _ in checks.values()):
                fail(f"a per-phase kernel disagrees with its plain twin at T={T}")
            if ulps6 > twin_check.ROUNDING_ULPS:
                fail(f"temporal_phase's bf16 output is {ulps6:.2f} ulps from its twin's")
            for name, (kern, plain, cost) in runs.items():
                ms = cuda_ms(kern, 10)
                pl = cuda_ms(plain, 2, warmup=1)
                b, by = bound_ms(*cost)
                gap = checks[name][1]
                row = {"B": B, "T": T, "ms": ms, "plain_ms": pl, "bound_ms": b,
                       "bound_by": by, "library_ms": None,
                       "max_abs_err": gap["max_abs_err"], "rel_rms": gap["rel_rms"]}
                if name == "temporal_phase":  # the bf16 output's gap
                    row.update(max_abs_err=err6, max_ulps=ulps6,
                               f32_tier_max_abs_err=gap["max_abs_err"])
                stats[name].append(row)
                print(f"  {name} B={B} T={T}: kernel {ms:.3f} ms, plain {pl:.3f} "
                      f"ms, bound {b:.4f} ms ({by}), {b / ms:.1%} of bound",
                      flush=True)
                if name == "temporal_phase":
                    record_split(f"{name} S={B * N} L={T}", kern, row, op=name)
                else:
                    record_split(f"{name} S={B * T} L={N + 1}", kern, row, op=name)
        del xs, xt
        # the attention swap's head sequences: spatial (B*T*H, N+1, hd) and
        # temporal (B*N*H, T, hd)
        for seq, BH, L in (("spatial", B * T * H, N + 1), ("temporal", B * N * H, T)):
            q, k, v = (torch.from_numpy(r.randn(BH, L, hd)).to(dev, torch.bfloat16)
                       for _ in range(3))
            scale = hd ** -0.5
            inst = fa.kernel_instance(q.dtype, hd)
            if inst != "tensor_core":
                fail(f"fused_attention takes the {inst} instance for bf16")
            with torch.inference_mode():
                ok, gap = check_close(f"fused_attention {seq} BH={BH} L={L}",
                                      fa.fused_attention(q, k, v, scale),
                                      fa.fused_attention_plain(q, k, v, scale))
                if not ok:
                    fail(f"fused_attention disagrees with its plain twin ({seq}, T={T})")
                if seq == "temporal" and T == 30:
                    packed = fa.fused_attention(
                        *(t.view(BH // 4, 4 * L, hd) for t in (q, k, v)), scale,
                        pack=4).view(BH, L, hd)
                    same = torch.equal(packed, fa.fused_attention(q, k, v, scale))
                    print(f"  fused_attention pack=4 (BH={BH // 4}, L={4 * L}) "
                          f"equals the unpacked call: {same}", flush=True)
                    if not same:
                        fail("fused_attention with pack=4 differs from the unpacked call")
                ms = cuda_ms(lambda: fa.fused_attention(q, k, v, scale), 10)
                pl = cuda_ms(lambda: fa.fused_attention_plain(q, k, v, scale), 2,
                             warmup=1)
                # SDPA on (BH, 1, L, hd) views of the same tensors: its
                # fused (flash) kernels take 4-D inputs
                lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q[:, None], k[:, None], v[:, None], scale=scale), 10)
                # at L = 3 the event time above is the wrapper's host time
                dms = graph_ms(lambda: fa.fused_attention(q, k, v, scale))
            b, by = bound_ms(*attention_cost(BH, L, hd, 2))
            stats["fused_attention"].append({
                "B": B, "T": T, "seq": seq, "BH": BH, "L": L, "instance": inst,
                "ms": ms, "device_ms": dms, "plain_ms": pl, "bound_ms": b,
                "bound_by": by, "library_ms": lib,
                "max_abs_err": gap["max_abs_err"], "rel_rms": gap["rel_rms"]})
            print(f"  fused_attention {seq} B={B} T={T} (BH={BH}, L={L}), {inst} "
                  f"instance: kernel {ms:.3f} ms (device {dms:.4f} ms), "
                  f"plain {pl:.3f} ms, bound {b:.4f} ms ({by}), "
                  f"{b / ms:.1%} of bound, SDPA {lib:.3f} ms", flush=True)
            del q, k, v
    # the kernel's f32 instance, at small shapes
    for BH, L in ((96, N + 1), (300, 30)):
        r = np.random.RandomState(BH)
        q, k, v = (torch.from_numpy(r.randn(BH, L, hd)).to(dev, torch.float32)
                   for _ in range(3))
        inst = fa.kernel_instance(q.dtype, hd)
        if inst != "cuda_core":
            fail(f"fused_attention takes the {inst} instance for f32")
        with torch.inference_mode():
            ok, _ = check_close(f"fused_attention f32 BH={BH} L={L} ({inst})",
                                fa.fused_attention(q, k, v, hd ** -0.5),
                                fa.fused_attention_plain(q, k, v, hd ** -0.5))
        if not ok:
            fail("fused_attention (f32) disagrees with its plain twin")

    part("the per-phase ops and the attention swap")

    # rows 1-3, 6 and 11's blocks alone: the wgmma GEMM at each of their
    # products (rows 1, 2 and 6 at the teacher window, M = 8 * 30 * 196
    # rows; rows 3 and 11 at the bucket, M = 512 * 196) with its epilogue
    # there, the spatial attention at rows 2 and 11's head-sequences and
    # the temporal attention at rows 1 and 6's, each against its twin;
    # torch.matmul on the same operands (bf16 out) and SDPA on (BH, 1, L,
    # hd) tensors of the same shape as yardsticks the port never calls
    print("  rows 1-3, 6 and 11's blocks alone: the wgmma GEMM, the spatial "
          "and the temporal attention", flush=True)
    blocks = {"spatial_mlp": {"gemm": [], "attention": []},
              "spatial_phase_pf": {"gemm": [], "attention": []},
              "temporal_phase_tm": {"gemm": [], "attention": []},
              "temporal_phase": {"attention": []}, "mlp_phase": {"gemm": []}}
    Mw, Mb = 8 * 30 * N, BAND_C * N
    for op, M_, Nn, K_, epi in [
            ("spatial_mlp", Mw, 3 * D, D, "bf16"),
            ("spatial_mlp", Mw, D, D, "res_f32_f32"),
            ("spatial_mlp", Mw, Dh, D, "gelu_bf16"),
            ("spatial_mlp", Mw, D, Dh, "res_f32_bf16"),
            ("spatial_phase_pf", Mb, 3 * D, D, "bf16"),
            ("spatial_phase_pf", Mb, D, D, "add_bf16"),
            # row 6's products are row 1's (M = 1568 * 30 rows)
            ("temporal_phase_tm", Mw, 3 * D, D, "bf16"),
            ("temporal_phase_tm", Mw, D, D, "bf16"),
            ("temporal_phase_tm", Mw, D, D, "res_bf16_f32"),
            ("mlp_phase", Mb, Dh, D, "gelu_bf16"),
            ("mlp_phase", Mb, D, Dh, "add_bf16")]:
        r = np.random.RandomState(M_ + Nn + K_)
        a = dev_randn(M_ + Nn + K_, M_, K_)
        w = torch.from_numpy((r.randn(Nn, K_) * K_ ** -0.5).astype(np.float32)).to(
            dev, torch.bfloat16)
        bias = torch.from_numpy(r.randn(Nn).astype(np.float32)).to(dev)
        rd = fb.GEMM_EPILOGUES[epi][1]
        res = None if rd is None else dev_randn(M_ + Nn + K_ + 1, M_, Nn, dtype=rd)
        ok, gap = check_close(f"gemm {epi} M={M_} N={Nn} K={K_}",
                              fb.gemm(a, w, bias, epi, res),
                              fb.gemm_plain(a, w, bias, epi, res), res)
        if not ok:
            fail(f"the wgmma GEMM disagrees with its twin ({epi}, N={Nn}, K={K_})")
        ms = cuda_ms(lambda: fb.gemm(a, w, bias, epi, res), 10)
        # the same product with the plainest epilogue (bias, bf16 store):
        # what the shape's own epilogue adds
        ms_bf16 = cuda_ms(lambda: fb.gemm(a, w, bias, "bf16"), 10)
        mm = cuda_ms(lambda: torch.matmul(a, w.t()), 10)
        flops = 2 * M_ * Nn * K_
        nbytes = (M_ * K_ + Nn * K_) * 2 + M_ * Nn * (
            fb.GEMM_EPILOGUES[epi][2].itemsize + (0 if rd is None else rd.itemsize))
        b, by = bound_ms(flops, nbytes)
        blocks[op]["gemm"].append({
            "M": M_, "N": Nn, "K": K_, "epilogue": epi, "ms": ms,
            "tflops": flops / ms / 1e9, "bf16_epilogue_ms": ms_bf16, "matmul_ms": mm,
            "matmul_tflops": flops / mm / 1e9, "bound_ms": b, "bound_by": by,
            "max_abs_err": gap["max_abs_err"], "rel_rms": gap["rel_rms"]})
        print(f"  gemm {epi} M={M_} N={Nn} K={K_}: {ms:.3f} ms, "
              f"{flops / ms / 1e9:.0f} TFLOP/s ({flops / ms / 1e9 / 989:.1%} of "
              f"989), bound {b:.4f} ms ({by}); with the bf16 epilogue {ms_bf16:.3f} "
              f"ms, {flops / ms_bf16 / 1e9:.0f} TFLOP/s; torch.matmul {mm:.3f} ms, "
              f"{flops / mm / 1e9:.0f} TFLOP/s", flush=True)
        del a, w, bias, res
    for op, S_, P_, po in [("spatial_mlp", 8 * 30, 8, True),
                           ("spatial_mlp", 8 * 3, 8, True),
                           ("spatial_phase_pf", BAND_C, BAND_C, False)]:
        r = np.random.RandomState(S_)
        sq = dev_randn(S_, S_, N, 3 * D)
        sp = torch.from_numpy(r.randn(P_, 3 * D).astype(np.float32)).to(dev, torch.bfloat16)
        got, got_pre = fb.spatial_attention(sq, sp, H, prefix_out=po)
        want, want_pre = fb.spatial_attention_plain(sq, sp, H)
        oks = [check_close(f"spatial_attention S={S_} P={P_}", got, want)]
        if po:
            oks.append(check_close(f"spatial_attention S={S_} P={P_} prefix rows",
                                   got_pre, want_pre))
        if not all(ok for ok, _ in oks):
            fail(f"the spatial attention disagrees with its twin (S={S_})")
        del got, got_pre, want, want_pre
        ms = cuda_ms(lambda: fb.spatial_attention(sq, sp, H, prefix_out=po), 10)
        dms = graph_ms(lambda: fb.spatial_attention(sq, sp, H, prefix_out=po))
        BH, L = S_ * H, N + 1
        q, k, v = (torch.randn(BH, 1, L, hd, device=dev, dtype=torch.bfloat16)
                   for _ in range(3))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10)
        del q, k, v, sq, sp
        b, by = bound_ms(*attention_cost(BH, L, hd, 2))
        blocks[op]["attention"].append({
            "S": S_, "BH": BH, "L": L, "prefix_out": po, "ms": ms, "device_ms": dms,
            "sdpa_ms": lib, "bound_ms": b, "bound_by": by,
            "max_abs_err": max(g["max_abs_err"] for _, g in oks)})
        print(f"  spatial_attention S={S_} ({BH} x {L} rows, hd {hd}): {ms:.3f} ms "
              f"(device {dms:.3f} ms), bound {b:.4f} ms ({by}), SDPA {lib:.3f} ms",
              flush=True)
    # the temporal attention: rows 1 and 1b's sequences (B clips x N
    # positions of T rows at stride N), row 6's (S contiguous sequences)
    for op, B_, T_, N_ in [("temporal_phase_tm", 8, 30, N), ("temporal_phase_tm", 8, 3, N),
                           ("temporal_phase_tm", 16, 8, N),
                           ("temporal_phase", 8 * N, 30, 1), ("temporal_phase", 8 * N, 3, 1)]:
        tq = dev_randn(B_ * T_ + N_, B_, T_, N_, 3 * D)
        ok, gap = check_close(f"temporal_attention B={B_} T={T_} N={N_}",
                              fb.temporal_attention(tq, H), fb.temporal_attention_plain(tq, H))
        if not ok:
            fail(f"the temporal attention disagrees with its twin (B={B_}, T={T_}, N={N_})")
        ms = cuda_ms(lambda: fb.temporal_attention(tq, H), 10)
        dms = graph_ms(lambda: fb.temporal_attention(tq, H))
        BH, L = B_ * N_ * H, T_
        q, k, v = (torch.randn(BH, 1, L, hd, device=dev, dtype=torch.bfloat16)
                   for _ in range(3))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10)
        del q, k, v, tq
        b, by = bound_ms(*attention_cost(BH, L, hd, 2))
        blocks[op]["attention"].append({
            "B": B_, "T": T_, "N": N_, "BH": BH, "L": L, "ms": ms, "device_ms": dms,
            "sdpa_ms": lib, "bound_ms": b, "bound_by": by,
            "max_abs_err": gap["max_abs_err"], "rel_rms": gap["rel_rms"]})
        print(f"  temporal_attention B={B_} T={T_} N={N_} ({BH} x {L} rows, hd {hd}): "
              f"{ms:.3f} ms (device {dms:.3f} ms), bound {b:.4f} ms ({by}), SDPA "
              f"{lib:.3f} ms", flush=True)
    torch.cuda.empty_cache()

    part("the forward blocks alone")

    # rows 8 and 9's blocks alone, at both crops: the tile's attention
    # backward beside SDPA's backward on (BH, 1, L, hd) tensors of the same
    # shape; each dX and dW product (row 8 over R = grid + per-frame CLS
    # rows, row 9 over the grid rows) and row 9's fc1 recompute with its
    # two outputs, in TFLOP/s beside torch.matmul on the same operands
    # (bf16 out; yardsticks the port never calls); row 9 whole at the train
    # step's CLS-row calls (M = 16 global, 64 local clips)
    print("  rows 8 and 9's blocks alone: the attention backward tile, the dX and "
          "dW GEMMs, the fc1 recompute; row 9 at the CLS rows", flush=True)
    blocks["spatial_phase_bwd"] = {"attention_bwd": [], "gemm_dx": [], "gemm_dw": []}
    blocks["mlp_phase_bwd"] = {"gemm_gelu_grad": [], "gemm_dx": [], "gemm_dw": []}
    mlp_cls_calls = []
    for tag, B_, T_, N_ in (("global", 16, 8, N), ("local", 64, 8, 36)):
        S_, L = B_ * T_, N_ + 1
        M8, M9 = S_ * N_ + S_, S_ * N_
        r = np.random.RandomState(S_ + N_)
        sq = dev_randn(S_ + N_, S_, N_, 3 * D)
        sp = torch.from_numpy(r.randn(B_, 3 * D).astype(np.float32)).to(dev, torch.bfloat16)
        sda = dev_randn(S_ + N_ + 1, S_, N_, D)
        sdp = torch.from_numpy(r.randn(S_, D).astype(np.float32)).to(dev, torch.bfloat16)
        got, got_pre = fb.spatial_attention_bwd(sq, sp, sda, sdp, H)
        want, want_pre = fb.spatial_attention_bwd_plain(sq, sp, sda, sdp, H)
        # dq, dk, dv are sums whose coefficients sum to zero (sum_j ds_ij =
        # 0): held by twin_check's f32 rules, not elementwise in ulps
        # (tests/test_torch_kernels_cuda.py, _close_sums)
        oks = [check_close(f"spatial_attention_bwd {tag} S={S_} L={L} d{nm}{part}",
                           g_[..., i * D:(i + 1) * D].float(), w_[..., i * D:(i + 1) * D].float())
               for i, nm in enumerate("qkv")
               for part, g_, w_ in (("", got, want), (" prefix rows", got_pre, want_pre))]
        if not all(ok for ok, _ in oks):
            fail(f"the attention backward tile disagrees with its twin ({tag} crops)")
        del got, got_pre, want, want_pre
        ms = cuda_ms(lambda: fb.spatial_attention_bwd(sq, sp, sda, sdp, H), 10)
        dms = graph_ms(lambda: fb.spatial_attention_bwd(sq, sp, sda, sdp, H))
        pl = cuda_ms(lambda: fb.spatial_attention_bwd_plain(sq, sp, sda, sdp, H), 1, warmup=1)
        BH = S_ * H
        q, k, v = (torch.randn(BH, 1, L, hd, device=dev, dtype=torch.bfloat16,
                               requires_grad=True) for _ in range(3))
        o = F.scaled_dot_product_attention(q, k, v)
        go = torch.randn_like(o)
        lib = cuda_ms(lambda: torch.autograd.grad(o, (q, k, v), go, retain_graph=True), 10)
        del q, k, v, o, go, sq, sp, sda, sdp
        b, by = bound_ms(*attention_bwd_cost(BH, L, hd))
        blocks["spatial_phase_bwd"]["attention_bwd"].append({
            "crops": tag, "S": S_, "BH": BH, "L": L, "ms": ms, "device_ms": dms,
            "plain_ms": pl, "library_ms": lib, "bound_ms": b, "bound_by": by,
            "max_abs_err": max(g_["max_abs_err"] for _, g_ in oks),
            "rel_rms": max(g_["rel_rms"] for _, g_ in oks)})
        print(f"  spatial_attention_bwd {tag} ({BH} x {L} rows, hd {hd}): {ms:.3f} ms "
              f"(device {dms:.3f} ms), bound {b:.4f} ms ({by}), SDPA's backward "
              f"{lib:.3f} ms", flush=True)
        for op, kind, M_, Nn, K_, epi in [
                ("spatial_phase_bwd", "gemm_dx", M8, D, D, "bf16"),        # da
                ("spatial_phase_bwd", "gemm_dx", M8, D, 3 * D, "f32"),     # dy
                ("spatial_phase_bwd", "gemm_dw", M8, D, D, None),          # dWproj
                ("spatial_phase_bwd", "gemm_dw", M8, 3 * D, D, None),      # dWqkv
                ("mlp_phase_bwd", "gemm_gelu_grad", M9, Dh, D, None),      # fc1
                ("mlp_phase_bwd", "gemm_dx", M9, Dh, D, "mul_f32_bf16"),  # dh1
                ("mlp_phase_bwd", "gemm_dx", M9, D, Dh, "f32"),            # dy
                ("mlp_phase_bwd", "gemm_dw", M9, D, Dh, None),             # dW2
                ("mlp_phase_bwd", "gemm_dw", M9, Dh, D, None)]:            # dW1
            r = np.random.RandomState(M_ + Nn + K_)
            extra, mm_args = {}, None
            if kind == "gemm_dw":  # rows M_, out Nn (n_out), in K_ (k_in)
                dy_ = dev_randn(M_ + Nn + K_, M_, Nn)
                x_ = dev_randn(M_ + Nn + K_ + 1, M_, K_)
                kern = lambda: fb.gemm_dw(dy_, x_)  # noqa: E731
                plain = lambda: fb.gemm_dw_plain(dy_, x_)  # noqa: E731
                mm = lambda: torch.matmul(dy_.t(), x_)  # noqa: E731
                extra["splits"] = fb.gemm_dw_splits(M_, Nn, K_)
                flops = 2 * M_ * Nn * K_
                nbytes = (M_ * Nn + M_ * K_) * 2 + Nn * K_ * 4
                shape = {"rows": M_, "n_out": Nn, "k_in": K_}
            elif kind == "gemm_dx":  # dY (M_, K_) . W (K_, Nn)
                dy_ = dev_randn(M_ + Nn + K_, M_, K_)
                w_ = torch.from_numpy((r.randn(K_, Nn) * K_ ** -0.5).astype(np.float32)).to(
                    dev, torch.bfloat16)
                aux_ = (torch.from_numpy(r.rand(M_, Nn).astype(np.float32)).to(dev)
                        if epi == "mul_f32_bf16" else None)
                kern = lambda: fb.gemm_dx(dy_, w_, epi, aux_)  # noqa: E731
                plain = lambda: fb.gemm_dx_plain(dy_, w_, epi, aux_)  # noqa: E731
                mm = lambda: torch.matmul(dy_, w_)  # noqa: E731
                flops = 2 * M_ * Nn * K_
                nbytes = ((M_ * K_ + K_ * Nn) * 2 + M_ * Nn * fb.GEMM_DX_EPILOGUES[epi][2].itemsize
                          + (0 if aux_ is None else M_ * Nn * 4))
                shape = {"M": M_, "N": Nn, "K": K_, "epilogue": epi}
            else:  # fc1: a (M_, K_) . W (Nn, K_)^T + bias -> bf16 GELU, f32 GELU'
                a_ = dev_randn(M_ + Nn + K_, M_, K_)
                w_ = torch.from_numpy((r.randn(Nn, K_) * K_ ** -0.5).astype(np.float32)).to(
                    dev, torch.bfloat16)
                b_ = torch.from_numpy(r.randn(Nn).astype(np.float32)).to(dev)
                kern = lambda: fb.gemm_gelu_grad(a_, w_, b_)  # noqa: E731
                plain = lambda: fb.gemm_gelu_grad_plain(a_, w_, b_)  # noqa: E731
                mm = lambda: torch.matmul(a_, w_.t())  # noqa: E731
                flops = 2 * M_ * Nn * K_
                nbytes = (M_ * K_ + Nn * K_) * 2 + M_ * Nn * 6
                shape = {"M": M_, "N": Nn, "K": K_}
            got, want = kern(), plain()
            if kind == "gemm_gelu_grad":
                oks = [check_close(f"gemm_gelu_grad {tag} M={M_} N={Nn} K={K_} {nm}", g_, w2)
                       for nm, g_, w2 in (("gelu", got[0], want[0]), ("gelu'", got[1], want[1]))]
            else:
                oks = [check_close(f"{kind} {tag} {shape}", got, want)]
            del got, want
            if not all(ok for ok, _ in oks):
                fail(f"{kind} disagrees with its twin ({tag} crops, {shape})")
            ms = cuda_ms(kern, 10)
            mm_ms = cuda_ms(mm, 10)
            b, by = bound_ms(flops, nbytes)
            blocks[op][kind].append({
                "crops": tag, **shape, **extra, "ms": ms, "tflops": flops / ms / 1e9,
                "matmul_ms": mm_ms, "matmul_tflops": flops / mm_ms / 1e9, "bound_ms": b,
                "bound_by": by, "max_abs_err": max(g_["max_abs_err"] for _, g_ in oks),
                "rel_rms": max(g_["rel_rms"] for _, g_ in oks)})
            print(f"  {kind} {tag} {shape}{' ' + str(extra) if extra else ''}: {ms:.3f} ms, "
                  f"{flops / ms / 1e9:.0f} TFLOP/s ({flops / ms / 1e9 / 989:.1%} of 989), "
                  f"bound {b:.4f} ms ({by}); torch.matmul {mm_ms:.3f} ms, "
                  f"{flops / mm_ms / 1e9:.0f} TFLOP/s", flush=True)
            del kern, plain, mm
            torch.cuda.empty_cache()
        # row 9 at the CLS rows: one call per block of each student pass
        r = np.random.RandomState(B_)
        xc = torch.from_numpy(r.randn(B_, D).astype(np.float32)).to(dev, torch.bfloat16)
        dc = torch.from_numpy(r.randn(B_, D).astype(np.float32)).to(dev, torch.bfloat16)
        ps = p["spatial"]
        got, want = fb.mlp_phase_bwd(xc, dc, ps), fb.mlp_phase_bwd_plain(xc, dc, ps)
        oks = [check_close(f"mlp_phase_bwd {tag} CLS rows M={B_} dx-dout", got[0], want[0], dc)]
        oks += [check_close(f"mlp_phase_bwd {tag} CLS rows M={B_} d{k_}", got[1][k_], want[1][k_])
                for k_ in want[1]]
        if not all(ok for ok, _ in oks):
            fail(f"mlp_phase_bwd disagrees with its twin at the CLS rows (M={B_})")
        ms = cuda_ms(lambda: fb.mlp_phase_bwd(xc, dc, ps), 10)
        dms = graph_ms(lambda: fb.mlp_phase_bwd(xc, dc, ps))
        pl = cuda_ms(lambda: fb.mlp_phase_bwd_plain(xc, dc, ps), 2, warmup=1)
        b, by = bound_ms(*mlp_bwd_cost(B_, D, Dh))
        mlp_cls_calls.append({"crops": tag, "M": B_, "ms": ms, "device_ms": dms, "plain_ms": pl,
                              "bound_ms": b, "bound_by": by,
                              "max_abs_err": max(g_["max_abs_err"] for _, g_ in oks)})
        print(f"  mlp_phase_bwd {tag} CLS rows M={B_}: kernel {ms:.3f} ms (device "
              f"{dms:.3f} ms), plain {pl:.3f} ms, bound {b:.4f} ms ({by})", flush=True)
        del xc, dc, got, want
    torch.cuda.empty_cache()

    part("rows 8 and 9's blocks alone")

    # row 7's blocks alone, at both crops: the strided attention-backward
    # tile beside SDPA's backward on (BH, 1, T, hd) tensors of the same
    # shape, and the LayerNorm backward of rows 7-9 (row 7's and 9's grid
    # rows with the residual; row 8's grid rows and per-frame CLS rows)
    # beside autograd of F.layer_norm on the same rows (f32; yardsticks the
    # port never calls), each against its twin
    print("  row 7's blocks alone: the strided attention-backward tile; the LayerNorm "
          "backward of rows 7-9", flush=True)
    blocks["temporal_phase_tm_bwd"] = {"attention_bwd": [], "layer_norm_bwd": []}
    for tag, B_, T_, N_ in (("global", 16, 8, N), ("local", 64, 8, 36)):
        r = np.random.RandomState(B_ * T_ + N_)
        tq = dev_randn(B_ * T_ + N_, B_, T_, N_, 3 * D)
        td = dev_randn(B_ * T_ + N_ + 1, B_, T_, N_, D)
        got, want = fb.temporal_attention_bwd(tq, td, H), fb.temporal_attention_bwd_plain(tq, td, H)
        # dq, dk, dv: sums whose coefficients sum to zero, held by
        # twin_check's f32 rules (tests/test_torch_kernels_cuda.py, _close_sums)
        oks = [check_close(f"temporal_attention_bwd {tag} B={B_} T={T_} N={N_} d{nm}",
                           got[..., i * D:(i + 1) * D].float(), want[..., i * D:(i + 1) * D].float())
               for i, nm in enumerate("qkv")]
        if not all(ok for ok, _ in oks):
            fail(f"the strided attention backward tile disagrees with its twin ({tag} crops)")
        del got, want
        ms = cuda_ms(lambda: fb.temporal_attention_bwd(tq, td, H), 10)
        dms = graph_ms(lambda: fb.temporal_attention_bwd(tq, td, H))
        pl = cuda_ms(lambda: fb.temporal_attention_bwd_plain(tq, td, H), 1, warmup=1)
        BH = B_ * N_ * H
        q, k, v = (torch.randn(BH, 1, T_, hd, device=dev, dtype=torch.bfloat16,
                               requires_grad=True) for _ in range(3))
        o = F.scaled_dot_product_attention(q, k, v)
        go = torch.randn_like(o)
        lib = cuda_ms(lambda: torch.autograd.grad(o, (q, k, v), go, retain_graph=True), 10)
        del q, k, v, o, go, tq, td
        b, by = bound_ms(*attention_bwd_cost(BH, T_, hd))
        blocks["temporal_phase_tm_bwd"]["attention_bwd"].append({
            "crops": tag, "B": B_, "T": T_, "N": N_, "BH": BH, "ms": ms, "device_ms": dms,
            "plain_ms": pl, "library_ms": lib, "bound_ms": b, "bound_by": by,
            "max_abs_err": max(g_["max_abs_err"] for _, g_ in oks),
            "rel_rms": max(g_["rel_rms"] for _, g_ in oks)})
        print(f"  temporal_attention_bwd {tag} ({BH} x {T_} rows, hd {hd}): {ms:.3f} ms "
              f"(device {dms:.3f} ms), bound {b:.4f} ms ({by}), plain {pl:.3f} ms, "
              f"SDPA's backward {lib:.3f} ms", flush=True)
        M_ = B_ * T_ * N_
        for what, P_, div in (("rows 7 and 9", 0, 1), ("row 8", B_, T_)):
            R_ = M_ + P_ * div
            lx = torch.from_numpy(r.randn(M_, D).astype(np.float32)).to(dev, torch.bfloat16)
            lt = (torch.from_numpy(r.randn(P_, D).astype(np.float32)).to(dev, torch.bfloat16)
                  if P_ else None)
            ldy = torch.from_numpy(r.randn(R_, D).astype(np.float32)).to(dev)
            lw = torch.from_numpy((1 + 0.1 * r.randn(D)).astype(np.float32)).to(dev)
            lres = torch.from_numpy(r.randn(M_, D).astype(np.float32)).to(dev, torch.bfloat16)
            args = (lx, ldy, lw, lres, lt, div)
            got, want = fb.layer_norm_bwd(*args), fb.layer_norm_bwd_plain(*args)
            oks = [check_close(f"layer_norm_bwd {tag} {what} R={R_} dx-res", got[0], want[0], lres)]
            if P_:
                oks.append(check_close(f"layer_norm_bwd {tag} {what} R={R_} tail dx",
                                       got[1], want[1]))
            oks += [check_close(f"layer_norm_bwd {tag} {what} R={R_} d{nm}", got[i], want[i])
                    for i, nm in ((2, "scale"), (3, "bias"))]
            if not all(ok for ok, _ in oks):
                fail(f"the LayerNorm backward disagrees with its twin ({tag}, {what})")
            del got, want
            ms = cuda_ms(lambda: fb.layer_norm_bwd(*args), 10)
            dms = graph_ms(lambda: fb.layer_norm_bwd(*args))
            pl = cuda_ms(lambda: fb.layer_norm_bwd_plain(*args), 2, warmup=1)
            xf = torch.cat([lx, lt.repeat_interleave(div, 0)]) if P_ else lx
            xf = xf.float().requires_grad_(True)
            lwq = lw.clone().requires_grad_(True)
            lb_ = torch.zeros_like(lw, requires_grad=True)
            lo = F.layer_norm(xf, (D,), lwq, lb_, 1e-6)
            lib = cuda_ms(lambda: torch.autograd.grad(lo, (xf, lwq, lb_), ldy, retain_graph=True),
                          10)
            del xf, lwq, lb_, lo
            b, by = bound_ms(*ln_bwd_cost(M_, R_, D, True))
            blocks["temporal_phase_tm_bwd"]["layer_norm_bwd"].append({
                "crops": tag, "rows_of": what, "M": M_, "R": R_, "ms": ms, "device_ms": dms,
                "plain_ms": pl, "library_ms": lib, "bound_ms": b, "bound_by": by,
                "max_abs_err": max(g_["max_abs_err"] for _, g_ in oks)})
            print(f"  layer_norm_bwd {tag} {what} (M={M_}, R={R_}, D={D}): {ms:.3f} ms "
                  f"(device {dms:.4f} ms), bound {b:.4f} ms ({by}), {b / dms:.1%} of bound, "
                  f"plain {pl:.3f} ms, torch's layer-norm backward {lib:.3f} ms", flush=True)
            del lx, lt, ldy, lw, lres, args
    torch.cuda.empty_cache()

    del one_block
    torch.cuda.empty_cache()
    part("row 7's blocks alone")

    # -- 4. windowed path, bf16, through make_scorers + run_scoring --------------
    lap("phase 3")
    print("[4] windowed path, bf16: make_scorers + run_scoring, ViT-B/16, "
          "local 3, global 30, chunk 8", flush=True)

    def clip_item(i, T):
        vid = make_video(seed=10 + i, T=T, size=224)
        frames = tensor_normalize(vid, [0.45] * 3, [0.225] * 3)
        loc, glob, eff = window_indices(T, 3, 30)
        return {"path": f"clip{i}.mp4", "frames": frames, "local_idx": loc,
                "global_idx": glob, "eff_global": eff, "num_frames": T,
                "local_size": 3, "dummy": False, "u8": vid}

    items = [clip_item(i, T) for i, T in enumerate(BAND_CLIPS[:2])]
    n_frames = sum(it["num_frames"] for it in items)
    chunks = math.ceil(n_frames / 8)

    def scorers_for(dtype, use_kernels, **kw):
        return make_scorers(
            sd, cfg, n_devices=1, local_size=3, global_size=30, chunk=8,
            compute_dtype=dtype, use_kernels=use_kernels,
            precision="highest" if dtype == torch.float32 else None, **kw)

    def run(scorers, its, tag):
        out = os.path.join(tmp, f"loss_{tag}.json")
        run_scoring(its, scorers, out, num_workers=1, log_every=0)
        with open(out) as f:
            return json.load(f)

    def reset_counts():
        for mod in (fb, bb, fa, smem_probe, wire):
            mod.reset_launches()

    def counts():
        return {**fb.launches, **bb.launches, **fa.launches,
                **smem_probe.launches, **wire.launches}

    def on_wire(its, frames):
        """The items with their frames replaced (``frames(item)``)."""
        return [{**it, "frames": frames(it)} for it in its]

    def twin_floats(its, layout):
        """The f32 frames the wire's twin makes on the card from each
        item's bytes: a float path fed these reads the kernel path's views
        bit for bit."""
        return on_wire(its, lambda it: wire.gather_normalize_plain(
            torch.from_numpy(it["frames"]).to(dev), np.arange(it["num_frames"]),
            torch.float32, layout).cpu().numpy())

    def same_losses(tag, clips, got, want):
        """Check (a): the wire's kernel path against the same scorer fed the
        twin's float frames, <= 1e-6 mean relative (identical views)."""
        for key, _ in clips:
            k, w = np.asarray(got[key]), np.asarray(want[key])
            rel = float(np.mean(np.abs(k - w)) / np.mean(np.abs(w)))
            print(f"  {tag} {key}: vs the same scorer on the twin's float frames: "
                  f"mean rel {rel:.3e} (<= 1e-6), max abs {np.max(np.abs(k - w)):.3e}",
                  flush=True)
            if not rel <= 1e-6:
                fail(f"{tag} {key}: the wire's losses differ from the float "
                     "frames' the twin makes from the same bytes")

    def upload_split(rows):
        """Device ms of the host-to-device copies and of everything in a
        profile's rows."""
        return (sum(ms for k, _, ms in rows if "HtoD" in k),
                sum(ms for _, _, ms in rows))

    windowed = ("temporal_phase_tm", "spatial_mlp")
    band_ops = ("banded_temporal_attn", "spatial_phase_pf", "cls_band_attn",
                "mlp_phase")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        scorers = scorers_for(torch.bfloat16, "auto")
        if not scorers[0].model_cfg.use_kernels:
            fail("use_kernels='auto' did not select the kernels on the card")
        run(scorers, items[1:], "warmup")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run(scorers, items, "kernels")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seen = counts()
        want = {k: 2 * cfg.depth * chunks if k in windowed else 0 for k in seen}
        print(f"  launches {seen} (expected {2 * cfg.depth * chunks} for each "
              f"windowed kernel = 2 forwards x {cfg.depth} blocks x {chunks} "
              "chunks, 0 for the banded ones)", flush=True)
        if seen != want:
            fail(f"windowed path launches {seen}, expected {want}")
        launches.update({k: seen[k] for k in windowed})
        for it in items:
            key = it["path"][:-4]
            if key not in got or len(got[key]) != it["num_frames"]:
                fail(f"{key}: expected {it['num_frames']} losses in the JSON")
            if not np.all(np.isfinite(got[key])):
                fail(f"{key}: non-finite losses")
        fps_windowed = n_frames / wall
        print(f"  frames_per_s={fps_windowed:.2f} ms_per_chunk="
              f"{wall * 1e3 / chunks:.1f} ({n_frames} frames, {chunks} chunks) "
              f"on {card}", flush=True)
        # which kernels the path launched: one profiled run of the 40-frame clip
        checked_profile(f"{items[1]['num_frames']}-frame clip", "windowed path",
                        lambda: run(scorers, items[1:], "profiled"), reset_counts, counts,
                        top=8)
        del scorers
        reset_counts()
        plain = run(scorers_for(torch.bfloat16, False), items, "plain")
        if any(counts().values()):
            fail("use_kernels=False launched a kernel")

        # -- 5. windowed path, f32 (reference-compat, TF32 off) ---------------
        print("[5] windowed path, f32 (TF32 off)", flush=True)
        f32 = run(scorers_for(torch.float32, "auto"), items, "f32")
        if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
            fail("the f32 scorer left TF32 on")
        if any(counts().values()):
            fail("the f32 path launched a kernel")
        loss_checks("windowed", [(it["path"][:-4], it["num_frames"])
                                 for it in items], got, plain, f32,
                    LOSS_REL_TOL)

        # -- 4b. windowed path, the mixed teacher -------------------------------
        lap("phases 4-5")
        print("[4b] windowed path, mixed teacher: make_scorers(teacher_dtype="
              "f32) + run_scoring, bf16 students, the same clips", flush=True)
        scorers = scorers_for(torch.bfloat16, "auto", teacher_dtype=f32t)
        sc = scorers[0]
        if not (sc.model_cfg.use_kernels and sc.t_model.pos_embed.dtype == f32t):
            fail("the mixed scorer did not build an f32 teacher on the kernels")
        del sc
        run(scorers, items[1:], "mixed_warmup")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mixed = run(scorers, items, "mixed_kernels")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seen = counts()
        mixed_ops = ("temporal_phase_tm", "spatial_mlp", "temporal_phase_tm_f32",
                     "spatial_mlp_f32")
        want = {k: cfg.depth * chunks if k in mixed_ops else 0 for k in seen}
        print(f"  launches {seen} (expected {cfg.depth * chunks} for each windowed "
              f"kernel's bf16 tier (the students) and f32 tier (the teacher) = "
              f"{cfg.depth} blocks x {chunks} chunks, 0 for the others)", flush=True)
        if seen != want:
            fail(f"windowed mixed path launches {seen}, expected {want}")
        launches.update({k: seen[k] for k in mixed_ops[2:]})
        print(f"  frames_per_s={n_frames / wall:.2f} ms_per_chunk={wall * 1e3 / chunks:.1f} "
              f"against the bf16 path's {fps_windowed:.2f} on {card}", flush=True)
        checked_profile(f"{items[1]['num_frames']}-frame clip, mixed teacher",
                        "windowed mixed path", lambda: run(scorers, items[1:], "mixed_prof"),
                        reset_counts, counts, top=8)
        del scorers
        # the plain mixed path: the same scorer and dtype policy, every
        # kernel op through its twin
        reset_counts()
        with twins(fb, bb):
            mixed_plain = run(scorers_for(torch.bfloat16, "auto", teacher_dtype=f32t),
                              items, "mixed_plain")
        if any(counts().values()):
            fail("the plain mixed path launched a kernel")
        loss_checks("windowed mixed", [(it["path"][:-4], it["num_frames"]) for it in items],
                    mixed, mixed_plain, f32, LOSS_REL_TOL, plain_name="plain mixed",
                    bf16_kernels=got)
        # the tier's effect where the teacher's precision shows: its CLS
        # features on the 40-frame clip's first eight global windows, the
        # mixed teacher (its f32 model on the kernels) against the bf16
        # teacher on the kernels, each against the f32 teacher (TF32 off).
        # The losses above cannot show it where the teacher softmax at
        # temperature 0.02 is one-hot, as it is on these random weights.
        it1 = items[1]
        views = torch.from_numpy(it1["frames"][np.asarray(it1["global_idx"][:8])]).to(dev)
        views = views.permute(0, 4, 1, 2, 3).contiguous()  # (8, C, 30, H, W)
        kcfg = dataclasses.replace(cfg, use_kernels=True)
        teachers = {"mixed": (tsf.build_timesformer(kcfg, sd, device=dev), torch.float32),
                    "bf16": (tsf.build_timesformer(kcfg, sd, device=dev,
                                                   dtype=torch.bfloat16), torch.bfloat16),
                    "f32": (tsf.build_timesformer(cfg, sd, device=dev), torch.float32)}
        with torch.inference_mode():
            feats = {k: m(views.to(dt)).float() for k, (m, dt) in teachers.items()}
        del teachers
        e_tm = float((feats["mixed"] - feats["f32"]).abs().mean())
        e_tb = float((feats["bf16"] - feats["f32"]).abs().mean())
        print(f"  teacher CLS features (8 windows of 30 frames) vs the f32 teacher, "
              f"mean abs: mixed teacher {e_tm:.4e}, bf16 teacher {e_tb:.4e} (need "
              f"mixed < bf16; ratio {e_tm / e_tb:.3f})", flush=True)
        del feats, views
        if not e_tm < e_tb:
            fail("the mixed teacher's features are no closer to the f32 teacher's "
                 "than the bf16 teacher's")
        lap("phase 4b")

        # -- 4c. the frame wire, windowed -------------------------------------
        print("[4c] windowed path on the frame wire: the clips' bytes as packed "
              "I420 (yuv420) and as uint8 RGB, bf16 kernels, and the mixed "
              "teacher on packed", flush=True)
        clips = [(it["path"][:-4], it["num_frames"]) for it in items]
        packed_items = on_wire(items, lambda it: yuv.pack_rgb(it["u8"]))
        wires = {"yuv420": packed_items,
                 "rgb8": on_wire(packed_items, lambda it: yuv.unpack_to_rgb(it["frames"]))}
        print(f"  upload bytes of the two clips: yuv420 "
              f"{sum(it['frames'].nbytes for it in packed_items) / 1e6:.1f} MB, rgb8 "
              f"{sum(it['frames'].nbytes for it in wires['rgb8']) / 1e6:.1f} MB, bf16 "
              f"floats {sum(it['frames'].size * 2 for it in items) / 1e6:.1f} MB",
              flush=True)
        f32_wire = {k: run(scorers_for(torch.float32, "auto"), v, f"f32_{k}")
                    for k, v in wires.items()}
        want = {k: 2 * cfg.depth * chunks if k in windowed else 2 * chunks
                if k == "gather_normalize" else 0 for k in counts()}
        mixed_want = {k: cfg.depth * chunks if k in mixed_ops else 2 * chunks
                      if k == "gather_normalize" else 0 for k in counts()}
        launches_wire = {}
        for tag, teacher, layout in (("yuv420", None, "yuv420"), ("rgb8", None, "rgb8"),
                                     ("mixed yuv420", f32t, "yuv420")):
            its = wires[layout]
            scorers = scorers_for(torch.bfloat16, "auto", teacher_dtype=teacher)
            run(scorers, its[1:], "wire_warmup")
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got_w = run(scorers, its, f"wire_{layout}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            seen = counts()
            expect = mixed_want if teacher else want
            print(f"  {tag}: launches {seen} (expected {expect}: the wire's gather once "
                  f"per view gather, 2 x {chunks} chunks)", flush=True)
            if seen != expect:
                fail(f"wire {tag}: launches {seen}, expected {expect}")
            launches_wire[tag] = seen["gather_normalize"]
            print(f"  {tag}: frames_per_s={n_frames / wall:.2f} ms_per_chunk="
                  f"{wall * 1e3 / chunks:.1f} (phase 4's float frames: {fps_windowed:.2f}) "
                  f"on {card}", flush=True)
            if tag == "yuv420":
                checked_profile(f"{items[1]['num_frames']}-frame clip on the wire",
                                "windowed wire path", lambda: run(scorers, its[1:], "wire_prof"),
                                reset_counts, counts, top=8)
            # (a) the same scorer on the twin's float frames from these bytes
            same_losses(f"wire {tag}", clips, got_w, run(scorers, twin_floats(its, layout),
                                                        f"wire_floats_{layout}"))
            # (b) the same scorer with every kernel op through its twin, and
            # (c) the f32 path on the same wire
            reset_counts()
            with twins(fb, bb, wire):
                plain_w = run(scorers, its, f"wire_plain_{layout}")
            if any(counts().values()):
                fail(f"wire {tag}: the twins launched a kernel")
            loss_checks(f"wire {tag}", clips, got_w, plain_w, f32_wire[layout],
                        LOSS_REL_TOL, plain_name="plain (twins)")
            del scorers
        launches["gather_normalize"] = launches_wire["yuv420"]
        lap("phase 4c")

        # -- 4d. the int8 tier --------------------------------------------
        print("[4d] the int8 tier (W8A8): its three kernels against their twins "
              "bit for bit, rows 1q and 2q against theirs, then make_scorers("
              "teacher_quant / student_quant='int8') + run_scoring on the clips",
              flush=True)
        q_sd = quant.quantize_state_dict_int8(sd)
        q_block = tsf.build_timesformer(
            tsf.TimeSformerConfig(embed_dim=D, depth=1, num_heads=H, num_frames=8,
                                  num_classes=0), q_sd, device=dev)
        pq = fb.block_params(q_block.blocks[0])
        tq, sq = pq["temporal"], pq["spatial"]
        del q_block
        s8 = torch.int8
        Mt, Ms = 8 * 30 * N, 8 * 3 * N  # the teacher's and the students' rows
        for k in ("ln_quant_rows", "quant_rows", "gemm_s8"):
            stats[k] = []
        # (1) K1 and K2, codes and scales bit for bit at the main path's
        # calls: LN + quantize on row 1's bf16 x and row 2's f32 carries
        # (rows with a large common offset: twin_check.offset_rows' shape,
        # drawn on the card) and on the CLS rows (B = 8, bf16); quantize on
        # the 768-wide attention and proj outputs and the 3072-wide hidden
        # rows
        g8 = torch.Generator(device="cuda").manual_seed(81)

        def rows_on_card(M_, K_, dtype, offset=0.0):
            x_ = torch.randn(M_, K_, generator=g8, device=dev)
            if offset:
                x_ = 0.1 * x_ + offset * (1 + torch.randn(M_, 1, generator=g8,
                                                          device=dev).abs())
            return x_.to(dtype)

        q_checks = []
        for who, M_ in (("teacher", Mt), ("student", Ms)):
            for tag, x_, w_, b_ in (
                    ("bf16 x", rows_on_card(M_, D, bf16), tq["ln_w"], tq["ln_b"]),
                    ("f32 carry", rows_on_card(M_, D, f32t, 4.0), sq["ln2_w"], sq["ln2_b"]),
                    ("bf16 CLS rows", rows_on_card(8, D, bf16), sq["ln1_w"], sq["ln1_b"]),
                    ("f32 CLS rows", rows_on_card(8, D, f32t, 4.0), sq["ln1_w"], sq["ln1_b"])):
                with torch.inference_mode():
                    q_, s_ = fb.ln_quant_rows(x_, w_, b_)
                    q0, s0 = fb.ln_quant_rows_plain(x_, w_, b_)
                n_bad = int((q_ != q0).sum()) + int((s_ != s0).sum())
                print(f"  ln_quant_rows {who} M={x_.shape[0]} {tag}: codes and scales "
                      f"{'bit-equal' if n_bad == 0 else f'differ at {n_bad}'}", flush=True)
                q_checks.append(n_bad == 0)
                if "CLS rows" not in tag:
                    elem = x_.element_size()
                    b, by = bound_ms(10 * x_.numel(), x_.numel() * (elem + 1) + 4 * x_.shape[0])
                    stats["ln_quant_rows"].append({
                        "rows": who, "M": x_.shape[0], "dtype": str(x_.dtype)[6:],
                        "ms": cuda_ms(lambda: fb.ln_quant_rows(x_, w_, b_), 20),
                        "plain_ms": cuda_ms(lambda: fb.ln_quant_rows_plain(x_, w_, b_), 3),
                        "bound_ms": b, "bound_by": by, "library_ms": None,
                        "max_abs_err": float((q_.int() - q0.int()).abs().max())})
            for K_ in (D, Dh):
                x_ = rows_on_card(M_, K_, bf16)
                with torch.inference_mode():
                    q_, s_ = fb.quant_rows(x_)
                    q0, s0 = fb.quant_rows_plain(x_)
                n_bad = int((q_ != q0).sum()) + int((s_ != s0).sum())
                print(f"  quant_rows {who} M={M_} K={K_}: codes and scales "
                      f"{'bit-equal' if n_bad == 0 else f'differ at {n_bad}'}", flush=True)
                q_checks.append(n_bad == 0)
                b, by = bound_ms(3 * x_.numel(), 3 * x_.numel() + 4 * M_)
                stats["quant_rows"].append({
                    "rows": who, "M": M_, "K": K_, "ms": cuda_ms(lambda: fb.quant_rows(x_), 20),
                    "plain_ms": cuda_ms(lambda: fb.quant_rows_plain(x_), 3),
                    "bound_ms": b, "bound_by": by, "library_ms": None,
                    "max_abs_err": float((q_.int() - q0.int()).abs().max())})
            del x_, q_, q0
        if not all(q_checks):
            fail("a quantize kernel's codes or scales differ from its twin's")
        part("phase 4d: the quantize kernels")
        # (2) K3: its f32 output (the dequantized sums + bias) bit-equal to
        # gemm_s8_plain at each product of rows 1q and 2q (the twin does the
        # same integer sums and the same roundings), the path's own
        # epilogue held by twin_check; TOPS beside torch._int_mm (the s32
        # product alone, cuBLASLt) and the bf16 wgmma GEMM on operands of
        # the same shape (yardsticks the port never calls)
        products = [("qkv", tq, "qkv", "bf16"), ("proj", tq, "proj", "bf16"),
                    ("fc", tq, "fc", "res_bf16_f32"), ("fc1", sq, "fc1", "gelu_bf16"),
                    ("fc2", sq, "fc2", "res_f32_bf16")]
        k3_ok = []
        for who, M_ in (("teacher", Mt), ("student", Ms)):
            for name, half, key, epi in products:
                w_q, sw_, bias_ = half[f"{key}_w"], half[f"{key}_s"], half[f"{key}_b"]
                Nn, K_ = w_q.shape
                a_q = torch.randint(-127, 128, (M_, K_), generator=g8, device=dev, dtype=s8)
                sx_ = 0.05 * torch.rand(M_, generator=g8, device=dev)
                rdt = fb.GEMM_EPILOGUES[epi][1]
                res_ = None if rdt is None else dev_randn(82, M_, Nn, dtype=rdt)
                with torch.inference_mode():
                    exact = torch.equal(fb.gemm_s8(a_q, sx_, w_q, sw_, bias_, "f32"),
                                        fb.gemm_s8_plain(a_q, sx_, w_q, sw_, bias_, "f32"))
                    ok, gap = check_close(f"gemm_s8 {name} {who} M={M_} N={Nn} K={K_} {epi}",
                                          fb.gemm_s8(a_q, sx_, w_q, sw_, bias_, epi, res_),
                                          fb.gemm_s8_plain(a_q, sx_, w_q, sw_, bias_, epi, res_),
                                          res_)
                print(f"  gemm_s8 {name} {who}: f32 output {'bit-equal' if exact else 'DIFFERS'} "
                      "to the twin's", flush=True)
                k3_ok.append(exact and ok)
                ops = 2 * M_ * Nn * K_
                ms = cuda_ms(lambda: fb.gemm_s8(a_q, sx_, w_q, sw_, bias_, epi, res_), 20)
                pl = cuda_ms(lambda: fb.gemm_s8_plain(a_q, sx_, w_q, sw_, bias_, epi, res_), 3)
                lib = cuda_ms(lambda: torch._int_mm(a_q, w_q.t()), 20)
                a16, w16 = a_q.to(bf16), w_q.to(bf16)
                ms16 = cuda_ms(lambda: fb.gemm(a16, w16, bias_, "bf16"), 20)
                del a16, w16
                out_b = fb.GEMM_EPILOGUES[epi][2].itemsize
                nbytes = (M_ * K_ + Nn * K_ + 4 * M_ + 8 * Nn + M_ * Nn * out_b
                          + (0 if res_ is None else res_.numel() * res_.element_size()))
                b = max(ops / PEAK_S8_OPS, nbytes / PEAK_BYTES) * 1e3
                by = "operations" if ops / PEAK_S8_OPS >= nbytes / PEAK_BYTES else "bytes"
                stats["gemm_s8"].append({
                    "rows": who, "product": name, "M": M_, "N": Nn, "K": K_, "epilogue": epi,
                    "ms": ms, "plain_ms": pl, "bound_ms": b, "bound_by": by,
                    "library_ms": lib, "bf16_gemm_ms": ms16,
                    "max_abs_err": gap["max_abs_err"], "bit_equal_f32": exact})
                print(f"  gemm_s8 {name} {who} M={M_} N={Nn} K={K_}: kernel {ms:.4f} ms "
                      f"({ops / ms / 1e9:.0f} TOPS), torch._int_mm {lib:.4f} ms "
                      f"({ops / lib / 1e9:.0f} TOPS), bf16 wgmma GEMM {ms16:.4f} ms "
                      f"({ops / ms16 / 1e9:.0f} TFLOP/s), plain {pl:.3f} ms, bound {b:.4f} "
                      f"ms ({by}, s8 peak), {b / ms:.1%} of bound", flush=True)
                del a_q, res_
        if not all(k3_ok):
            fail("the s8 GEMM disagrees with its twin")
        torch.cuda.empty_cache()
        part("phase 4d: the s8 GEMM")
        # (3) rows 1q and 2q against their twins (twin_check, q8 rules) at
        # the teacher and student windows; times beside their bounds (the
        # GEMMs at the s8 peak, the attention at the bf16 peak)
        for k in ("temporal_phase_tm_q8", "spatial_mlp_q8"):
            stats[k] = []
        for B, T in [(8, 30), (8, 3)]:
            x = dev_randn(83, B, T, N, D)
            x1 = dev_randn(84, B, T, N, D, dtype=f32t)
            cls = dev_randn(85, B, 1, D)
            with torch.inference_mode():
                g_, c_ = fb.spatial_mlp(x1, cls, sq, H)
                g0, c0 = fb.spatial_mlp_plain(x1, cls, sq, H)
                t_ = fb.temporal_phase_tm(x, tq, H)
                t0_ = fb.temporal_phase_tm_plain(x, tq, H)
            checks = [check_close(f"temporal_phase_tm_q8 out-x B={B} T={T}", t_, t0_, x, q8=True),
                      check_close(f"spatial_mlp_q8 grid-x1 B={B} T={T}", g_, g0, x1, q8=True),
                      check_close(f"spatial_mlp_q8 cls B={B} T={T}", c_, c0, q8=True)]
            if not all(ok for ok, _ in checks):
                fail(f"an int8 row disagrees with its plain twin at B={B} T={T}")
            del g_, c_, g0, c0, t_, t0_
            gaps = [gap for _, gap in checks]
            iters = 20 if T > 8 else 50
            for name, kern, plain_fn, cost, op_gaps in [
                    ("temporal_phase_tm_q8", lambda: fb.temporal_phase_tm(x, tq, H),
                     lambda: fb.temporal_phase_tm_plain(x, tq, H),
                     temporal_q8_cost(B, T, N, D), gaps[:1]),
                    ("spatial_mlp_q8", lambda: fb.spatial_mlp(x1, cls, sq, H),
                     lambda: fb.spatial_mlp_plain(x1, cls, sq, H),
                     spatial_q8_cost(B, T, N, D, Dh), gaps[1:])]:
                # the profile right after the kernel's own timing: once, after
                # the twin's timing (thousands of small launches), three
                # profiles in a row missed the call's first kernels
                row = {"B": B, "T": T, "max_abs_err": max(g["max_abs_err"] for g in op_gaps),
                       "rel_rms": max(g["rel_rms"] for g in op_gaps)}
                with torch.inference_mode():
                    ms = cuda_ms(kern, iters)
                    record_split(f"{name} B={B} T={T}", kern, row, op=name)
                    pl = cuda_ms(plain_fn, 2, warmup=1)
                b, by = bound_q8_ms(*cost)
                row.update(ms=ms, plain_ms=pl, bound_ms=b, bound_by=by, library_ms=None)
                stats[name].append(row)
                print(f"  {name} B={B} T={T}: kernel {ms:.3f} ms, plain {pl:.3f} ms, bound "
                      f"{b:.4f} ms ({by}; GEMMs at the s8 peak), {b / ms:.1%} of bound",
                      flush=True)
            del x, x1, cls
        torch.cuda.empty_cache()
        part("phase 4d: rows 1q and 2q")
        # (3b) rows 1qf and 2qf, the int8 tier's f32 block boundary (the
        # int8 teacher under the mixed teacher: f32 x into row 1, an f32 CLS
        # row into row 2 and an f32 grid out), against their twins at both
        # windows on offset rows (twin_check.offset_rows: a kernel that
        # rounds an f32 input to bf16 fails there) by the int8 rules, their
        # f32 outputs also by twin_check's f32 rule (bf16_exact); each timed
        # beside its bound and, in turns, beside row 1q / 2q on the same rows
        # (bf16 x and CLS row for those)
        for k in ("temporal_phase_tm_q8_f32", "spatial_mlp_q8_f32"):
            stats[k] = []
        for B, T in [(8, 30), (8, 3)]:
            x = dev_offset_rows(86, B, T, N, D)
            x1 = dev_offset_rows(87, B, T, N, D)
            cls = dev_offset_rows(88, B, 1, D)
            xb, clsb = x.to(bf16), cls.to(bf16)
            with torch.inference_mode():
                t_ = fb.temporal_phase_tm(x, tq, H)
                t0_ = fb.temporal_phase_tm_plain(x, tq, H)
                g_, c_ = fb.spatial_mlp(x1, cls, sq, H)
                g0, c0 = fb.spatial_mlp_plain(x1, cls, sq, H)
            checks = [check_close(f"temporal_phase_tm_q8_f32 out-x B={B} T={T}", t_, t0_, x,
                                  q8=True),
                      check_close(f"spatial_mlp_q8_f32 grid-x1 B={B} T={T}", g_, g0, x1, q8=True),
                      check_close(f"spatial_mlp_q8_f32 cls B={B} T={T}", c_, c0, q8=True)]
            f32_bad = []
            for tag, t in (("temporal_phase_tm_q8_f32 out", t_), ("spatial_mlp_q8_f32 grid", g_),
                           ("spatial_mlp_q8_f32 cls rows", c_)):
                bad = twin_check.f32_failures(t)
                print(f"  {tag} B={B} T={T}: bf16_exact={twin_check.bf16_exact(t):.3e} "
                      f"{'ok' if not bad else 'FAILED: ' + '; '.join(bad)}", flush=True)
                f32_bad += bad
            if f32_bad or not all(ok for ok, _ in checks):
                fail(f"an int8 f32 row disagrees with its plain twin at B={B} T={T}")
            del t_, t0_, g_, c_, g0, c0
            gaps = [gap for _, gap in checks]
            iters = 20 if T > 8 else 50
            for name, kern, plain_fn, base_fn, base, cost, op_gaps in [
                    ("temporal_phase_tm_q8_f32", lambda: fb.temporal_phase_tm(x, tq, H),
                     lambda: fb.temporal_phase_tm_plain(x, tq, H),
                     lambda: fb.temporal_phase_tm(xb, tq, H), "temporal_phase_tm_q8",
                     temporal_q8_f32_cost(B, T, N, D), gaps[:1]),
                    ("spatial_mlp_q8_f32", lambda: fb.spatial_mlp(x1, cls, sq, H),
                     lambda: fb.spatial_mlp_plain(x1, cls, sq, H),
                     lambda: fb.spatial_mlp(x1, clsb, sq, H), "spatial_mlp_q8",
                     spatial_q8_f32_cost(B, T, N, D, Dh), gaps[1:])]:
                row = {"B": B, "T": T, "max_abs_err": max(g["max_abs_err"] for g in op_gaps),
                       "rel_rms": max(g["rel_rms"] for g in op_gaps)}
                with torch.inference_mode():
                    turns = [cuda_ms(f, iters) for f in (base_fn, kern, kern, base_fn)]
                    record_split(f"{name} B={B} T={T}", kern, row, op=name)
                    pl = cuda_ms(plain_fn, 2, warmup=1)
                ms, ms_q8 = min(turns[1:3]), min(turns[0], turns[3])
                b, by = bound_q8_ms(*cost)
                row.update(ms=ms, plain_ms=pl, bound_ms=b, bound_by=by, library_ms=None,
                           int8_bf16_tier_ms=ms_q8, turns_ms=turns)
                stats[name].append(row)
                print(f"  {name} B={B} T={T}: kernel {ms:.3f} ms ({base} in turns "
                      f"{ms_q8:.3f} ms, ratio {ms / ms_q8:.3f}; turns {base}, f32, f32, {base}: "
                      + ", ".join(f"{t:.3f}" for t in turns) + f"), plain {pl:.3f} ms, bound "
                      f"{b:.4f} ms ({by}; GEMMs at the s8 peak), {b / ms:.1%} of bound",
                      flush=True)
            del x, x1, cls, xb, clsb
        torch.cuda.empty_cache()
        part("phase 4d: rows 1qf and 2qf")
        # (4) the windowed path with each int8 option, and the int8 teacher
        # under the mixed teacher (rows 1qf and 2qf): counters around the
        # run, frames/s beside phase 4's, a profiled run's families, losses
        # against the plain int8 path (the same scorer, every kernel op
        # through its twin) and the f32 path of phase 5
        q8_ops = ("temporal_phase_tm_q8", "spatial_mlp_q8")
        launches_q8 = {}
        for tag, qkw in (("student int8", dict(student_quant="int8")),
                         ("teacher int8", dict(teacher_quant="int8")),
                         ("both int8", dict(teacher_quant="int8", student_quant="int8")),
                         ("teacher int8 mixed", dict(teacher_quant="int8",
                                                     teacher_dtype=f32t))):
            scorers = scorers_for(torch.bfloat16, "auto", **qkw)
            sc = scorers[0]
            t_dt = qkw.get("teacher_dtype", bf16)
            if not (sc.model_cfg.use_kernels
                    and sc.model.quantized == ("student_quant" in qkw)
                    and sc.t_model.quantized == ("teacher_quant" in qkw)
                    and sc.t_model.pos_embed.dtype == t_dt):
                fail(f"{tag}: the scorer did not build its quantized model on the kernels")
            del sc
            run(scorers, items[1:], "q8_warmup")
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got_q = run(scorers, items, f"q8_{tag[:4]}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            seen = counts()
            # each forward's tier: the students' and the teacher's
            expect = {k: 0 for k in seen}
            for quantized, f32_tier in (("student_quant" in qkw, False),
                                        ("teacher_quant" in qkw, t_dt == f32t)):
                for op in windowed:
                    name = (f"{op}_q8" if quantized else op) + ("_f32" if f32_tier else "")
                    expect[name] += cfg.depth * chunks
                    for k, n in fb.Q8_LAUNCHES.get(name, {}).items():
                        expect[k] += n * cfg.depth * chunks
            print(f"  {tag}: launches {seen} (expected {expect}: each windowed op's int8 "
                  f"tier (its f32 tier for an f32 teacher) once a block of each quantized "
                  f"forward, its bf16 tier for the other, and the int8 tier's kernels per "
                  f"call {fb.Q8_LAUNCHES})", flush=True)
            if seen != expect:
                fail(f"{tag}: launches {seen}, expected {expect}")
            launches_q8[tag] = seen
            print(f"  {tag}: frames_per_s={n_frames / wall:.2f} ms_per_chunk="
                  f"{wall * 1e3 / chunks:.1f} (phase 4's bf16: {fps_windowed:.2f}) on {card}",
                  flush=True)
            checked_profile(f"{items[1]['num_frames']}-frame clip, {tag}", f"windowed {tag}",
                            lambda: run(scorers, items[1:], "q8_prof"), reset_counts, counts,
                            top=10)
            del scorers
            reset_counts()
            with twins(fb, bb):
                plain_q = run(scorers_for(torch.bfloat16, "auto", **qkw), items, "q8_plain")
            if any(counts().values()):
                fail(f"{tag}: the plain int8 path launched a kernel")
            loss_checks(f"windowed {tag}", [(it["path"][:-4], it["num_frames"])
                                            for it in items],
                        got_q, plain_q, f32, LOSS_REL_TOL, plain_name="plain int8")
        for k in q8_ops + ("gemm_s8", "quant_rows", "ln_quant_rows"):
            launches[k] = launches_q8["both int8"][k]
        for k in q8_ops:
            launches[f"{k}_f32"] = launches_q8["teacher int8 mixed"][f"{k}_f32"]
        torch.cuda.empty_cache()
        lap("phase 4d")

        # -- 4e. the strided scorer and f32 students on the kernels ------
        print("[4e] the strided scorer (JAX's turbo* modes) and f32 students on the "
              "kernels: make_scorers(use_kernels=True, ...) + run_scoring on the "
              "clips, each against its twins and the same knobs at f32", flush=True)
        strided_launches, strided_fps = {}, {}
        knots_seen = {}

        def forward_counter(sc):
            """Forward pre-hooks on the scorer's models: {tier: forwards}, the
            tier by the model's dtype and quantization."""
            seen, hooks = {}, []
            for m in {id(sc.model): sc.model, id(sc.t_model): sc.t_model}.values():
                tier = ("q8" if m.quantized else "f32"
                        if m.pos_embed.dtype == torch.float32 else "bf16")

                def pre(mod, inp, _tier=tier):
                    seen[_tier] = seen.get(_tier, 0) + 1
                hooks.append(m.register_forward_pre_hook(pre))
            return seen, hooks

        def tier_launches(forwards):
            """The counters a run of ``forwards`` ({tier: n}) must read: each
            windowed op once a block of each forward in its tier's name (the
            int8 tier's kernels per call, fb.Q8_LAUNCHES), nothing else."""
            expect = {k: 0 for k in counts()}
            for tier, n in forwards.items():
                for op in windowed:
                    name = op if tier == "bf16" else f"{op}_{tier}"
                    expect[name] += cfg.depth * n
                    for k, per in fb.Q8_LAUNCHES.get(name, {}).items():
                        expect[k] += per * cfg.depth * n
            return expect

        def record_knots(sc, tag):
            """Keep the refined teacher knots of each group the scorer scores."""
            real = sc._refine_group

            def refine(*a):
                tposs, feats = real(*a)
                knots_seen.setdefault(tag, []).append([t.tolist() for t in tposs])
                return tposs, feats
            sc._refine_group = refine

        k8cr = dict(teacher_stride=8, teacher_interp="catmullrom")
        mt = dict(teacher_dtype=f32t, teacher_refine=0.035, **k8cr)
        strided_cfgs = {  # JAX bench.py MODES: (students' dtype, knobs, clips)
            "exact-mixed-fused": (f32t, {}, items),
            "turbo-mixed": (f32t, dict(teacher_stride=4), items),
            "turbo2e-mt": (bf16, mt, items),
            "turbo2e-mt-m2e": (bf16, dict(mt, score_stride=2, score_refine=0.2), items),
            "turbo2-q8sq8t": (bf16, dict(teacher_quant="int8", student_quant="int8", **k8cr),
                              items),
            "teacher_img=160": (bf16, dict(teacher_img=160), items[1:]),
        }
        for tag, (dtype, kw, its) in strided_cfgs.items():
            t_cfg = time.perf_counter()
            clips_s = [(it["path"][:-4], it["num_frames"]) for it in its]
            frames_s = sum(n for _, n in clips_s)
            scorers = make_scorers(sd, cfg, n_devices=1, local_size=3, global_size=30,
                                   chunk=8, compute_dtype=dtype, use_kernels=True,
                                   precision=None, **kw)
            sc = scorers[0]
            record_knots(sc, tag)
            run(scorers, its[1:] if len(its) > 1 else its, "strided_warmup")
            knots_seen.pop(tag, None)
            reset_counts()
            rows0 = dict(sc.stats)
            seen_fw, hooks = forward_counter(sc)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got_s = run(scorers, its, "strided_kernels")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for h in hooks:
                h.remove()
            seen = counts()
            expect = tier_launches(seen_fw)
            print(f"  {tag}: launches {seen} (expected {expect}: {seen_fw} forwards by "
                  "tier, each windowed op once a block of each)", flush=True)
            if seen != expect or not any(seen.values()):
                fail(f"{tag}: launches {seen}, expected {expect}")
            strided_launches[tag] = {k: v for k, v in seen.items() if v}
            t_rows = sc.stats["teacher_rows"] - rows0["teacher_rows"]
            s_rows = sc.stats["student_rows"] - rows0["student_rows"]
            strided_fps[tag] = {"frames_per_s": frames_s / wall, "frames": frames_s,
                                "teacher_rows_per_frame": t_rows / frames_s,
                                "student_rows_per_frame": s_rows / frames_s}
            print(f"  {tag}: frames_per_s={frames_s / wall:.2f} ({frames_s} frames; phase "
                  f"4's exact bf16 {fps_windowed:.2f}), teacher rows per frame "
                  f"{t_rows / frames_s:.3f}, student rows per frame {s_rows / frames_s:.3f} "
                  f"on {card}", flush=True)
            # which kernels the path launched, the device's busy and idle
            # share: one profiled run of the 40-frame clip
            checked_profile(f"{its[-1]['num_frames']}-frame clip, {tag}", f"strided {tag}",
                            lambda: run(scorers, its[-1:], "strided_prof"), reset_counts,
                            counts, top=6)
            if tag == "turbo2e-mt":
                # student_dispatch 1 on the same clips: bit for bit the
                # default's (4 chunks a call), kernels and all
                one = run(make_scorers(sd, cfg, n_devices=1, local_size=3, global_size=30,
                                       chunk=8, compute_dtype=dtype, use_kernels=True,
                                       precision=None, student_dispatch=1, **kw),
                          its, "strided_dispatch1")
                same = all(np.array_equal(np.asarray(one[k]), np.asarray(got_s[k]))
                           for k, _ in clips_s)
                print(f"  {tag}: student_dispatch 1 against 4 on the kernels: "
                      f"{'bit-equal' if same else 'DIFFERENT'}", flush=True)
                if not same:
                    fail(f"{tag}: student_dispatch changes the losses")
            reset_counts()
            with twins(fb, bb, wire):
                sc_tw = make_scorers(sd, cfg, n_devices=1, local_size=3, global_size=30,
                                     chunk=8, compute_dtype=dtype, use_kernels=True,
                                     precision=None, **kw)
                record_knots(sc_tw[0], f"{tag} twins")
                plain_s = run(sc_tw, its, "strided_twins")
            if any(counts().values()):
                fail(f"{tag}: the twins launched a kernel")
            del scorers, sc, sc_tw
            knobs = {k: v for k, v in kw.items()
                     if k not in ("teacher_dtype", "teacher_quant", "student_quant")}
            f32_s = (f32 if not knobs else
                     run(scorers_for(torch.float32, False, **knobs), its, "strided_f32"))
            for key in (f"{tag}", f"{tag} twins"):  # the timed run's, then the twins'
                if key in knots_seen:
                    print(f"  {key}: refined knots per video {knots_seen[key][0]}", flush=True)
            loss_checks(f"strided {tag}", clips_s, got_s, plain_s, f32_s, LOSS_REL_TOL,
                        plain_name="twins")
            if tag == "exact-mixed-fused":
                # the students' CLS features on the 40-frame clip's first
                # eight local windows: f32 students on the kernels and the
                # bf16 kernel path's, each against the f32 students (printed)
                it1 = items[1]
                views = torch.from_numpy(it1["frames"][np.asarray(it1["local_idx"][:8])])
                views = views.to(dev).permute(0, 4, 1, 2, 3).contiguous()
                kcfg = dataclasses.replace(cfg, use_kernels=True)
                feats = {}
                for k, (mc, dt) in {"f32 kernels": (kcfg, f32t), "bf16 kernels": (kcfg, bf16),
                                    "f32": (cfg, f32t)}.items():
                    model = tsf.build_timesformer(mc, sd, device=dev, dtype=dt)
                    with torch.inference_mode():
                        feats[k] = model(views.to(dt)).float()
                    del model
                e_fk = float((feats["f32 kernels"] - feats["f32"]).abs().mean())
                e_bk = float((feats["bf16 kernels"] - feats["f32"]).abs().mean())
                print(f"  {tag}: students' CLS features (8 windows of 3 frames) vs the f32 "
                      f"students, mean abs: f32 kernels {e_fk:.4e}, bf16 kernels {e_bk:.4e} "
                      f"(ratio {e_fk / e_bk:.3f})", flush=True)
                strided_fps[tag]["student_feature_err"] = {"f32_kernels": e_fk,
                                                           "bf16_kernels": e_bk}
                del feats, views
            torch.cuda.empty_cache()
            part(f"phase 4e: {tag} ({time.perf_counter() - t_cfg:.1f} s)")
        print("  strided paths: " + json.dumps(strided_fps), flush=True)
        # the device form of the teacher rows' interpolation against an
        # independent float64 evaluation: Catmull-Rom (tangents over the
        # uneven spans, clamped ends) and linear at turbo2e-mt's refined
        # knots of the 64-frame clip, every frame, rows of the model's width
        from dino_video_summarization_transformer_tpu_torch.engine import scoring as eng

        kn = np.asarray(knots_seen["turbo2e-mt"][0][0])
        rows = dev_randn(97, len(kn), D, dtype=torch.float32)
        y = rows.double().cpu().numpy()
        xs = np.arange(int(kn[-1]) + 1)
        j = np.clip(np.searchsorted(kn, xs, side="right") - 1, 0, len(kn) - 2)
        h = (kn[j + 1] - kn[j]).astype(np.float64)
        t = (xs - kn[j]) / h
        jm1, jp2 = np.maximum(j - 1, 0), np.minimum(j + 2, len(kn) - 1)
        m0 = (y[j + 1] - y[jm1]) / (kn[j + 1] - kn[jm1])[:, None]
        m1 = (y[jp2] - y[j]) / (kn[jp2] - kn[j])[:, None]
        tt = t[:, None]
        want_cr = ((2 * tt**3 - 3 * tt**2 + 1) * y[j] + (tt**3 - 2 * tt**2 + tt) * h[:, None] * m0
                   + (-2 * tt**3 + 3 * tt**2) * y[j + 1] + (tt**3 - tt**2) * h[:, None] * m1)
        want_li = y[j] * (1 - tt) + y[j + 1] * tt
        for kind, want_i in (("catmullrom", want_cr), ("linear", want_li)):
            got_i = eng._interp_rows(kn, rows, xs, kind).double().cpu().numpy()
            err = float(np.abs(got_i - want_i).max())
            print(f"  interpolation on the card, {kind} at {len(kn)} knots x {D}: max abs "
                  f"{err:.3e} against float64 (<= 1e-5 x max|rows| = "
                  f"{1e-5 * np.abs(y).max():.3e})", flush=True)
            if not err <= 1e-5 * np.abs(y).max():
                fail(f"the teacher rows' {kind} interpolation disagrees with float64")
        del rows
        lap("phase 4e")

        # -- 6. banded path, bf16 ---------------------------------------------
        print(f"[6] banded path, bf16: make_scorers(band_mode='both') + "
              f"run_scoring, clips of {BAND_CLIPS} frames, band_chunk "
              f"{BAND_C}, halo 32", flush=True)
        band_items = items + [clip_item(2, BAND_CLIPS[2])]
        n_band = sum(it["num_frames"] for it in band_items)
        scorers = scorers_for(torch.bfloat16, "auto", band_mode="both")
        sc = scorers[0]
        segs = [sc._band_segments(it["num_frames"]) for it in band_items]
        passes = 2 * sum(len(s) for s in segs)
        buckets = [sc._band_bucket(w1 - w0) for s in segs for w0, w1, _, _ in s]
        print(f"  segments {segs}, buckets {buckets}", flush=True)
        run(scorers, items[1:], "band_warmup")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        band_got = run(scorers, band_items, "band_kernels")
        torch.cuda.synchronize()
        band_wall = time.perf_counter() - t0
        seen = counts()
        want = {k: passes * cfg.depth if k in band_ops else 0 for k in seen}
        print(f"  launches {seen} (expected {passes * cfg.depth} for each "
              f"banded kernel = {passes} passes x {cfg.depth} blocks, 0 for "
              "the windowed ones)", flush=True)
        if seen != want:
            fail(f"banded path launches {seen}, expected {want}")
        launches.update({k: seen[k] for k in band_ops})
        for it in band_items:
            key = it["path"][:-4]
            if key not in band_got or len(band_got[key]) != it["num_frames"]:
                fail(f"banded {key}: expected {it['num_frames']} losses")
            if not np.all(np.isfinite(band_got[key])):
                fail(f"banded {key}: non-finite losses")
        fps_band = n_band / band_wall
        print(f"  frames_per_s={fps_band:.2f} ({n_band} frames, {passes} "
              f"passes, {band_wall:.3f} s) against the windowed path's "
              f"{fps_windowed:.2f} on {card}", flush=True)

        # where the time goes: one profiled run of the 600-frame clip
        long = band_items[2]
        checked_profile(f"{long['num_frames']}-frame clip", "banded path",
                        lambda: sc.score_video(long["frames"], long["local_idx"],
                                               long["global_idx"], long["eff_global"]),
                        reset_counts, counts, top=14)
        del scorers, sc

        reset_counts()
        band_plain = run(scorers_for(torch.bfloat16, False, band_mode="both"),
                         band_items, "band_plain")
        band_f32 = run(scorers_for(torch.float32, "auto", band_mode="both"),
                       band_items, "band_f32")
        if any(counts().values()):
            fail("the plain and f32 banded paths launched a kernel")
        loss_checks("banded", [(it["path"][:-4], it["num_frames"])
                               for it in band_items], band_got, band_plain,
                    band_f32, BAND_LOSS_REL_TOL)
        rho = spearman(band_got["clip0"], got["clip0"])
        print(f"  rank correlation, banded vs exact kernel-path losses on "
              f"clip0 (64 frames): {rho:.4f} (information only)", flush=True)

        # the "teacher" hybrid: banded teacher rows, exact windowed students
        reset_counts()
        hybrid = run(scorers_for(torch.bfloat16, "auto", band_mode="teacher"),
                     items[:1], "hybrid")
        seen = counts()
        n_chunks = math.ceil(items[0]["num_frames"] / 8)
        want = {k: (n_chunks if k in windowed else 1 if k in band_ops else 0)
                * cfg.depth for k in seen}
        print(f"  hybrid launches {seen} (expected {want}: one banded teacher "
              f"pass, {n_chunks} student chunks)", flush=True)
        if seen != want:
            fail(f"hybrid launches {seen}, expected {want}")
        h = np.asarray(hybrid["clip0"])
        if len(h) != items[0]["num_frames"] or not np.all(np.isfinite(h)):
            fail("hybrid: losses missing or non-finite")
        print(f"  hybrid vs exact kernel-path losses on clip0: mean rel "
              f"{np.mean(np.abs(h - got['clip0'])) / np.mean(got['clip0']):.3e}, "
              f"rank correlation {spearman(h, got['clip0']):.4f} (information "
              "only)", flush=True)

        # the 600-frame clip once more, its bytes on the wire (packed I420):
        # the wire's gather once per segment (both passes read its views),
        # losses held as phase 4c holds the windowed ones, and the upload
        # beside the float path's
        long_w = on_wire([long], lambda it: yuv.pack_rgb(it["u8"]))
        key = long["path"][:-4]
        segs_long = len(segs[2])
        print(f"  the wire: the {long['num_frames']}-frame clip as packed I420, "
              f"{segs_long} segments", flush=True)
        scorers = scorers_for(torch.bfloat16, "auto", band_mode="both")
        sc = scorers[0]
        run(scorers, on_wire(items[1:], lambda it: yuv.pack_rgb(it["u8"])), "bw_warmup")
        reset_counts()
        band_w = run(scorers, long_w, "band_wire")
        seen = counts()
        want = {k: 2 * segs_long * cfg.depth if k in band_ops else segs_long
                if k == "gather_normalize" else 0 for k in seen}
        print(f"  wire launches {seen} (expected {want})", flush=True)
        if seen != want:
            fail(f"banded wire launches {seen}, expected {want}")
        launches["gather_normalize_banded"] = seen["gather_normalize"]
        same_losses("banded wire", [(key, long["num_frames"])], band_w,
                    run(scorers, twin_floats(long_w, "yuv420"), "band_wire_floats"))
        reset_counts()
        with twins(fb, bb, wire):
            band_w_plain = run(scorers, long_w, "band_wire_plain")
        if any(counts().values()):
            fail("banded wire: the twins launched a kernel")
        band_w_f32 = run(scorers_for(torch.float32, "auto", band_mode="both"), long_w,
                         "band_wire_f32")
        loss_checks("banded wire", [(key, long["num_frames"])], band_w, band_w_plain,
                    band_w_f32, BAND_LOSS_REL_TOL, plain_name="plain (twins)")
        # the upload, by the profile: the float path (bf16 frames) and the wire
        up = {}
        for tag, fr in (("bf16 floats", long["frames"]), ("yuv420", long_w[0]["frames"])):
            rows = checked_profile(f"{long['num_frames']}-frame clip, {tag}",
                                   f"banded path, {tag}",
                                   lambda: sc.score_video(fr, long["local_idx"],
                                                          long["global_idx"],
                                                          long["eff_global"]),
                                   reset_counts, counts, top=6)
            h2d, busy = upload_split(rows)
            nbytes = fr.size * (2 if fr.dtype != np.uint8 else 1)
            up[tag] = (h2d, busy, nbytes)
            print(f"  upload, {tag}: {nbytes / 1e6:.1f} MB, host-to-device copies "
                  f"{h2d:.3f} device ms ({nbytes / h2d / 1e6:.2f} GB/s), device busy "
                  f"{busy:.1f} ms on {card}", flush=True)
        del scorers, sc
        lap("phase 6")

        # -- 6b. banded path, the mixed teacher -------------------------------
        print("[6b] banded path, the mixed teacher (JAX's band-mt and band-t-mt): "
              "make_scorers(band_mode='both' / 'teacher', teacher_dtype=f32) + "
              "run_scoring, bf16 students", flush=True)
        mixed_band_ops = ("banded_temporal_attn", "cls_band_attn", "spatial_phase_pf",
                          "spatial_phase_pf_f32", "mlp_phase", "mlp_phase_f32")
        scorers = scorers_for(torch.bfloat16, "auto", band_mode="both", teacher_dtype=f32t)
        sc = scorers[0]
        if not (sc.model_cfg.use_kernels and sc.t_model.pos_embed.dtype == f32t
                and sc.model.pos_embed.dtype == bf16):
            fail("band-mt: the scorer did not build an f32 teacher and bf16 students on "
                 "the kernels")
        run(scorers, items[1:], "band_mt_warmup")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        band_mt = run(scorers, band_items, "band_mt")
        torch.cuda.synchronize()
        band_mt_wall = time.perf_counter() - t0
        seen = counts()
        # each pass once a segment: per block, the teacher pass's rows 10,
        # 11f, 12 and 3f, the student pass's rows 10, 11, 12 and 3
        half = passes // 2 * cfg.depth
        want = {k: (2 * half if k in ("banded_temporal_attn", "cls_band_attn")
                    else half if k in mixed_band_ops else 0) for k in seen}
        print(f"  band-mt launches {seen} (expected {want}: {passes // 2} teacher and "
              f"{passes // 2} student passes x {cfg.depth} blocks)", flush=True)
        if seen != want:
            fail(f"band-mt launches {seen}, expected {want}")
        launches_band_mt = {k: seen[k] for k in mixed_band_ops}
        for it in band_items:
            key = it["path"][:-4]
            if len(band_mt.get(key, [])) != it["num_frames"] or not np.all(
                    np.isfinite(band_mt[key])):
                fail(f"band-mt {key}: expected {it['num_frames']} finite losses")
        fps_band_mt = n_band / band_mt_wall
        print(f"  band-mt frames_per_s={fps_band_mt:.2f} ({n_band} frames, "
              f"{band_mt_wall:.3f} s) against band's {fps_band:.2f} on {card}", flush=True)
        # where its time goes beside phase 6's profile: the 600-frame clip
        checked_profile(f"{long['num_frames']}-frame clip, band-mt", "band-mt",
                        lambda: sc.score_video(long["frames"], long["local_idx"],
                                               long["global_idx"], long["eff_global"]),
                        reset_counts, counts, top=14)
        # each pass's views in its model's dtype: the teacher's the clip's f32
        # frames bit for bit, the students' their bf16 rounding (the 64-frame
        # clip: one segment)
        views = {}
        real_pass = sc._band_pass

        def keep_views(frames, t_real, eff, kind):
            views[kind] = frames
            return real_pass(frames, t_real, eff, kind)

        sc._band_pass = keep_views
        it0 = band_items[0]
        sc.score_video(it0["frames"], it0["local_idx"], it0["global_idx"], it0["eff_global"])
        sc._band_pass = real_pass
        want_f32 = torch.from_numpy(it0["frames"]).to(dev)
        ok_views = (views["teacher"].dtype == f32t and views["student"].dtype == bf16
                    and torch.equal(views["teacher"], want_f32)
                    and torch.equal(views["student"], want_f32.to(bf16)))
        print(f"  band-mt views: teacher {views['teacher'].dtype}, students "
              f"{views['student'].dtype}; "
              f"{'the f32 frames and their bf16 rounding' if ok_views else 'DIFFER'}",
              flush=True)
        if not ok_views:
            fail("band-mt: a pass's views are not the clip's frames in its model's dtype")
        del views, want_f32, scorers, sc
        # losses against the same scorer with every kernel op through its
        # twin and the f32 banded path (phase 6), by phase 6's two rules
        reset_counts()
        with twins(fb, bb):
            band_mt_plain = run(scorers_for(torch.bfloat16, "auto", band_mode="both",
                                            teacher_dtype=f32t), band_items, "band_mt_plain")
        if any(counts().values()):
            fail("band-mt: the twins launched a kernel")
        band_clips = [(it["path"][:-4], it["num_frames"]) for it in band_items]
        loss_checks("band-mt", band_clips, band_mt, band_mt_plain, band_f32,
                    BAND_LOSS_REL_TOL, plain_name="plain (twins)")
        # the teacher's precision. (a) its CLS rows (the scorer's teacher
        # pass on the 64-frame clip) strictly closer to the f32 banded
        # teacher's (TF32 off) than the bf16 banded teacher's on the kernels
        t_rows = {}
        for tag, dt, kw in (("mixed", bf16, dict(teacher_dtype=f32t)), ("bf16", bf16, {}),
                            ("f32", f32t, {})):
            sc = scorers_for(dt, "auto", band_mode="both", **kw)[0]
            real_pass = sc._band_pass

            def keep_teacher(frames, t_real, eff, kind, _real=real_pass, _tag=tag):
                out = _real(frames, t_real, eff, kind)
                if kind == "teacher":
                    t_rows[_tag] = out[:t_real]
                return out

            sc._band_pass = keep_teacher
            sc.score_video(it0["frames"], it0["local_idx"], it0["global_idx"],
                           it0["eff_global"])
            del sc
        e_tm = float((t_rows["mixed"] - t_rows["f32"]).abs().mean())
        e_tb = float((t_rows["bf16"] - t_rows["f32"]).abs().mean())
        print(f"  (a) band-mt teacher CLS rows ({it0['num_frames']} frames, eff "
              f"{it0['eff_global']}) vs the f32 banded teacher's, mean abs: mixed {e_tm:.4e}, "
              f"bf16 {e_tb:.4e} (need mixed < bf16; ratio {e_tm / e_tb:.3f})", flush=True)
        del t_rows
        if not e_tm < e_tb:
            fail("band-mt: the teacher's CLS rows are no closer to the f32 banded "
                 "teacher's than the bf16 banded teacher's")
        # (b) at teacher_temp 0.1 (the random-weight teacher's softmax is
        # one-hot at 0.02, where a few argmax flips decide any loss rule):
        # on each clip, mean |loss - f32 banded loss| strictly below band's
        hot = {tag: run(scorers_for(dt, "auto", band_mode="both", teacher_temp=0.1, **kw),
                        band_items, f"band_t01_{tag}")
               for tag, dt, kw in (("mixed", bf16, dict(teacher_dtype=f32t)),
                                   ("bf16", bf16, {}), ("f32", f32t, {}))}
        gaps_b = {}
        for key, _ in band_clips:
            ref = np.asarray(hot["f32"][key])
            e_m = float(np.mean(np.abs(np.asarray(hot["mixed"][key]) - ref)))
            e_b = float(np.mean(np.abs(np.asarray(hot["bf16"][key]) - ref)))
            e_m02 = float(np.mean(np.abs(np.asarray(band_mt[key]) - band_f32[key])))
            e_b02 = float(np.mean(np.abs(np.asarray(band_got[key]) - band_f32[key])))
            gaps_b[key] = (e_m, e_b)
            print(f"  (b) {key}: mean |loss - f32 banded loss| at teacher_temp 0.1: band-mt "
                  f"{e_m:.4e}, band {e_b:.4e} (need band-mt < band; ratio {e_m / e_b:.3f}); "
                  f"at 0.02 (information only): band-mt {e_m02:.4e}, band {e_b02:.4e}",
                  flush=True)
        del hot
        if not all(e_m < e_b for e_m, e_b in gaps_b.values()):
            fail("band-mt: at teacher_temp 0.1 its losses are no closer to the f32 banded "
                 "losses than band's on some clip")
        # band-t-mt on the 64-frame clip: the f32 banded teacher pass, the
        # exact bf16 windowed students (rows 1 and 2), against its twins and
        # the f32 hybrid
        reset_counts()
        scorers = scorers_for(torch.bfloat16, "auto", band_mode="teacher", teacher_dtype=f32t)
        band_tmt = run(scorers, items[:1], "band_t_mt")
        seen = counts()
        n_chunks = math.ceil(items[0]["num_frames"] / 8)
        want = {k: (n_chunks if k in windowed else 1 if k in (
                    "banded_temporal_attn", "cls_band_attn", "spatial_phase_pf_f32",
                    "mlp_phase_f32") else 0) * cfg.depth for k in seen}
        print(f"  band-t-mt launches {seen} (expected {want}: one f32 banded teacher "
              f"pass, {n_chunks} bf16 student chunks)", flush=True)
        if seen != want:
            fail(f"band-t-mt launches {seen}, expected {want}")
        launches_band_tmt = {k: v for k, v in seen.items() if v}
        reset_counts()
        with twins(fb, bb):
            band_tmt_plain = run(scorers, items[:1], "band_t_mt_plain")
        if any(counts().values()):
            fail("band-t-mt: the twins launched a kernel")
        del scorers
        loss_checks("band-t-mt", band_clips[:1], band_tmt, band_tmt_plain,
                    run(scorers_for(torch.float32, "auto", band_mode="teacher"), items[:1],
                        "band_t_f32"), BAND_LOSS_REL_TOL, plain_name="plain (twins)")
        # banded int8 (JAX's XLA route): the kernel route refuses, the plain
        # route runs the 40-frame clip
        try:
            scorers_for(torch.bfloat16, "auto", band_mode="both", teacher_quant="int8",
                        student_quant="int8")
        except NotImplementedError as e:
            print(f"  banded int8 on the kernel route: refused ({str(e)[:160]})", flush=True)
        else:
            fail("banded int8 on the kernel route did not raise")
        reset_counts()
        t0 = time.perf_counter()
        band_q8 = run(scorers_for(torch.bfloat16, False, band_mode="both", teacher_quant="int8",
                                  student_quant="int8"), items[1:2], "band_int8_plain")
        wall_q8 = time.perf_counter() - t0
        key1 = items[1]["path"][:-4]
        lq = np.asarray(band_q8.get(key1, []))
        if len(lq) != items[1]["num_frames"] or not np.all(np.isfinite(lq)) or any(
                counts().values()):
            fail("banded int8 (plain route): losses missing, non-finite, or a kernel launched")
        print(f"  banded int8 (both, plain route) {key1}: mean loss {lq.mean():.4f} beside "
              f"band's {np.mean(band_got[key1]):.4f} (f32 banded {np.mean(band_f32[key1]):.4f});"
              f" {items[1]['num_frames'] / wall_q8:.2f} frames/s (information only)", flush=True)
        lap("phase 6b")

    # -- 7. DINO SSL train step, bf16 kernel route ---------------------------------
    from dino_video_summarization_transformer_tpu_torch.train import ssl
    from dino_video_summarization_transformer_tpu_torch.utils.flops import (
        train_step_flops)

    batch, n_local, out_dim = 8, 8, 65536
    print(f"[7] DINO SSL train step, bf16: ViT-B/16, T=8, batch {batch} "
          f"({2 * batch} global 224-px clips, {n_local * batch} local 96-px "
          f"clips), out_dim {out_dim}, AdamW", flush=True)
    torch.cuda.empty_cache()
    tcfg = tsf.vit_base_config(num_frames=8, num_classes=0)
    state, core, mask = ssl.init_train_state(tcfg, out_dim=out_dim,
                                             optimizer="adamw", seed=0,
                                             device=dev)
    step = ssl.make_train_step(tcfg, core, mask, n_local_crops=n_local,
                               clip_grad=3.0, compute_dtype=torch.bfloat16)
    if step.route != "kernels":
        fail(f"the bf16 ViT-B train step chose the {step.route!r} route")

    def crops(b, seed):
        r = np.random.RandomState(seed)
        g = torch.from_numpy(r.randn(2 * b, 3, 8, 224, 224).astype(np.float32))
        l = torch.from_numpy(r.randn(n_local * b, 3, 8, 96, 96).astype(np.float32))
        return g.to(dev), l.to(dev)

    # routes on the same (initial) weights and crops, at batch 2: after a
    # few steps the temporal branches of the zero-initialised temporal_fc
    # blocks carry gradients ~1e-7 of the rest, which both bf16 routes
    # only round
    torch.backends.cudnn.allow_tf32 = False
    g2, l2 = crops(2, 51)
    route_grads, route_loss = {}, {}
    for name, cd, route in [("kernels", torch.bfloat16, "kernels"),
                            ("plain bf16", torch.bfloat16, "plain"),
                            ("f32", torch.float32, "plain")]:
        st = ssl.make_train_step(tcfg, core, mask, n_local_crops=n_local,
                                 compute_dtype=cd, route=route)
        reset_counts()
        loss, _, grads = st.loss_and_grads(state, g2, l2, 0.04)
        torch.cuda.synchronize()
        if route == "plain" and any(counts().values()):
            fail(f"the {name} route launched a kernel")
        route_loss[name], route_grads[name] = float(loss), grads
        del grads
        torch.cuda.empty_cache()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("the f32 route ran with TF32 on")
    gk, gp, gf = (route_grads[k] for k in ("kernels", "plain bf16", "f32"))
    worst, e_k, e_p = grad_distances(gk, gp, gf)
    print(f"  batch 2, losses {route_loss}; kernel vs plain bf16 gradients: "
          f"worst max|diff|/max|plain| {worst[1]:.3e} at {worst[0]} (< "
          f"{TRAIN_GRAD_REL_MAX}); mean distance to f32: kernel route {e_k:.3e}, "
          f"plain bf16 {e_p:.3e} (need kernel <= {TRAIN_F32_RATIO} x plain + "
          "1e-6)", flush=True)
    if worst[1] >= TRAIN_GRAD_REL_MAX:
        fail("kernel-route gradients disagree with the plain bf16 route")
    if e_k > TRAIN_F32_RATIO * e_p + 1e-6:
        fail("kernel-route gradients are further from f32 than allowed")
    # phase 7b holds the mixed tier against these f32 gradients and the bf16
    # kernel route's distance to them, on the same weights and crops
    f32_grads_b2, e_bf16_kernels = gf, e_k
    del route_grads, gk, gp
    torch.cuda.empty_cache()

    g, l = crops(batch, 50)
    hp = (5e-4, 0.04, 0.996, 0.04, True)  # lr, wd, teacher momentum, temp, freeze
    losses = []

    def train_step():
        nonlocal state
        state, metrics = step(state, g, l, *hp)
        losses.append(float(metrics["loss"]))  # a sync per step, as the NaN guard

    torch.cuda.reset_peak_memory_stats()
    train_step()  # first-call allocations
    torch.cuda.synchronize()
    reset_counts()
    # the backwards' calls of the counted step by row count (row 7: grid
    # rows; row 8: grid and per-frame CLS rows; row 9: grid or CLS rows),
    # read through shims around the ops (the counters stay the ops' own)
    bwd_calls = {}
    rows_of = {"temporal_phase_tm_bwd": lambda x: x.numel() // x.shape[-1],
               "spatial_phase_bwd": lambda x: x.numel() // x.shape[-1] + x.shape[0] * x.shape[1],
               "mlp_phase_bwd": lambda x: x.shape[0]}
    sound = {op: getattr(fb, op) for op in rows_of}

    def shim(op):
        def call(x, *a, **k):
            key = (op, rows_of[op](x))
            bwd_calls[key] = bwd_calls.get(key, 0) + 1
            return sound[op](x, *a, **k)
        return call

    for op in rows_of:
        setattr(fb, op, shim(op))
    try:
        train_step()
    finally:
        for op, fn in sound.items():
            setattr(fb, op, fn)
    torch.cuda.synchronize()
    seen = counts()
    depth = tcfg.depth
    mlp_rows = {rows: n for (op, rows), n in bwd_calls.items() if op == "mlp_phase_bwd"}
    reduces = dw_reduces(fb, bwd_calls, tcfg.embed_dim, int(tcfg.embed_dim * tcfg.mlp_ratio))
    print(f"  backward calls in one step by row count: {bwd_calls}; dW partial sums "
          f"(reduce_splits) expected per step: {reduces}", flush=True)
    want = {k: 0 for k in seen}
    want.update({"temporal_phase_tm_bf16": 3 * depth, "spatial_phase": 3 * depth,
                 "mlp_phase": 6 * depth, "temporal_phase_tm_bwd": 2 * depth,
                 "spatial_phase_bwd": 2 * depth,
                 # the last block's grid MLP feeds nothing the loss reads
                 # (only the CLS row goes on to the head): autograd skips
                 # its backward
                 "mlp_phase_bwd": 2 * (2 * depth - 1)})
    print(f"  launches in one step {seen} (expected {want}: 3 forwards and 2 "
          f"student backwards x {depth} blocks, the MLP on the grid and the "
          "CLS rows, no backward of the last block's grid MLP)", flush=True)
    if seen != want:
        fail(f"train step launches {seen}, expected {want}")
    launches.update({k: seen[k] for k in TRAIN_OPS})
    launches["mlp_phase_train_step"] = seen["mlp_phase"]
    launches["mlp_phase_bwd_by_rows"] = {str(k): v for k, v in sorted(mlp_rows.items())}
    n_steps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        train_step()
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / n_steps
    flops = train_step_flops(tcfg, batch, n_local_crops=n_local, local_size_px=96)
    ms_step_bf16, peak_bf16 = ms_step, torch.cuda.max_memory_allocated()
    print(f"  ms_per_step={ms_step:.1f} ({n_steps} steps), {flops:.3e} FLOP per "
          f"step (train_step_flops), {flops / ms_step / 1e9:.1f} TFLOP/s, "
          f"{flops / ms_step / 1e9 / (PEAK_BF16_FLOPS / 1e12):.1%} of the bf16 "
          f"peak; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB on {card}", flush=True)
    print(f"  losses {[round(v, 4) for v in losses]}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail("a train step gave a non-finite loss")

    # the teacher after a step is the EMA of the teacher before and the new student
    t_before = [t.detach().clone() for t in state.teacher.parameters()]
    train_step()
    m = hp[2]
    ema_err = max(float((t - (tb * m + s.detach() * (1.0 - m))).abs().max())
                  for t, tb, s in zip(state.teacher.parameters(), t_before,
                                      state.student.parameters()))
    del t_before
    print(f"  teacher vs EMA of the new student: max abs {ema_err:.3e} (<= 1e-6)",
          flush=True)
    if not math.isfinite(losses[-1]) or ema_err > 1e-6:
        fail("the teacher is not the EMA of the student")

    # no train op accounts for gemm_kernel, attn_kernel, gemmx_kernel or
    # attn_bwd_kernel: the check fails if the step launches any of them
    checked_profile("one step", "train step", train_step, reset_counts, counts, top=16,
                    reduces=reduces)
    del g, l

    del state, step
    torch.cuda.empty_cache()

    # -- 7b. DINO SSL train step, the mixed tier -----------------------------------
    lap("phase 7")
    print(f"[7b] DINO SSL train step, mixed tier (make_train_step(route='kernels', "
          f"compute_dtype=float32): f32 activations and carries, bf16 matmul operands): "
          f"ViT-B/16, T=8, batch {batch}, as phase 7", flush=True)
    # the new tiers against their twins first, on offset rows (x, the CLS
    # row, the cotangents: dev_offset_rows), where an x rounded to bf16
    # before a LayerNorm fails the twin rules; the f32 outputs also by
    # twin_check's f32 rules: each output float32 and not rounded to bf16
    # (bf16_exact <= F32_EXACT_SHARE_MAX), the bias gradients summed from
    # an f32 cotangent within F32_SUM_REL_MAX of the twin's
    mixed_ops = ("spatial_phase_f32", "temporal_phase_tm_bwd_f32", "spatial_phase_bwd_f32",
                 "mlp_phase_bwd_f32", "mlp_phase_f32")
    for k in mixed_ops:
        stats[k] = []
    blocks["temporal_phase_tm_bwd_f32"] = {"layer_norm_bwd": []}
    mixed_cls_calls = []
    cot_bias = {"temporal_phase_tm_bwd_f32": "fc_b", "spatial_phase_bwd_f32": "proj_b",
                "mlp_phase_bwd_f32": "fc2_b"}

    def check_f32(name, got, want=None):
        """twin_check's f32 rules on one output (``want``: a bias gradient
        summed from an f32 cotangent, against the twin's); prints the
        reading; (ok, reading)."""
        bad = twin_check.f32_failures(got, want)
        if want is None:
            reading = {"bf16_exact": twin_check.bf16_exact(got)}
        else:
            reading = {"sum_rel_max": float((got - want).abs().max())
                       / max(float(want.abs().max()), 1e-30)}
        print(f"  {name}: " + ", ".join(f"{k}={v:.3e}" for k, v in reading.items())
              + f" {'ok' if not bad else 'FAILED: ' + '; '.join(bad)}", flush=True)
        return not bad, reading

    pt, ps = p["temporal"], p["spatial"]
    for tag, (B, T, Np) in [("global", (16, 8, N)), ("local", (64, 8, 36))]:
        seed = 80 + Np
        x, dout = dev_offset_rows(seed, B, T, Np, D), dev_offset_rows(seed + 1, B, T, Np, D)
        cls, dco = dev_offset_rows(seed + 2, B, 1, D), dev_offset_rows(seed + 3, B, T, D)
        xm, dm = x.reshape(-1, D), dout.reshape(-1, D)
        # the same rows in bf16, for each op's bf16 tier timed in turns
        # with its f32 tier (the card's clocks move over a run)
        x16, dout16, cls16, dco16 = (t.to(torch.bfloat16) for t in (x, dout, cls, dco))
        xm16, dm16 = x16.reshape(-1, D), dout16.reshape(-1, D)
        bf16_tier = {
            "spatial_phase_f32": lambda: fb.spatial_phase(x16, cls16, ps, H),
            "temporal_phase_tm_bwd_f32": lambda: fb.temporal_phase_tm_bwd(x16, dout16, pt, H),
            "spatial_phase_bwd_f32": lambda: fb.spatial_phase_bwd(x16, cls16, dout16, dco16,
                                                                  ps, H),
            "mlp_phase_bwd_f32": lambda: fb.mlp_phase_bwd(xm16, dm16, ps),
            "mlp_phase_f32": lambda: fb.mlp_phase(xm16, ps)}
        M_ = B * T * Np
        runs = {
            "spatial_phase_f32": (
                lambda: fb.spatial_phase(x, cls, ps, H),
                lambda: fb.spatial_phase_plain(x, cls, ps, H),
                spatial_phase_f32_cost(B, T, Np, D)),
            "temporal_phase_tm_bwd_f32": (
                lambda: fb.temporal_phase_tm_bwd(x, dout, pt, H),
                lambda: fb.temporal_phase_tm_bwd_plain(x, dout, pt, H),
                temporal_bwd_f32_cost(B, T, Np, D)),
            "spatial_phase_bwd_f32": (
                lambda: fb.spatial_phase_bwd(x, cls, dout, dco, ps, H),
                lambda: fb.spatial_phase_bwd_plain(x, cls, dout, dco, ps, H),
                spatial_bwd_f32_cost(B, T, Np, D)),
            "mlp_phase_bwd_f32": (
                lambda: fb.mlp_phase_bwd(xm, dm, ps),
                lambda: fb.mlp_phase_bwd_plain(xm, dm, ps),
                mlp_bwd_f32_cost(M_, D, Dh)),
            "mlp_phase_f32": (
                lambda: fb.mlp_phase(xm, ps), lambda: fb.mlp_phase_plain(xm, ps),
                mlp_cost(M_, D, Dh, elem=4)),
        }
        with torch.inference_mode():
            checks, f32_checks = {}, {}
            for name, (kern, plain, _) in runs.items():
                got, want = kern(), plain()
                lbl = f"{name} {tag}"
                if name == "spatial_phase_f32":
                    checks[name] = [check_close(f"{lbl} grid-x", got[0], want[0], x),
                                    check_close(f"{lbl} cls rows", got[1], want[1])]
                    f32_checks[name] = [check_f32(f"{lbl} grid", got[0]),
                                        check_f32(f"{lbl} cls rows", got[1])]
                elif name == "mlp_phase_f32":
                    checks[name] = [check_close(f"{lbl} out-x M={M_}", got, want, xm)]
                    f32_checks[name] = [check_f32(f"{lbl} out", got)]
                else:
                    base = dm if name == "mlp_phase_bwd_f32" else dout
                    c = [check_close(f"{lbl} dx-dout", got[0], want[0], base)]
                    if name == "spatial_phase_bwd_f32":
                        c.append(check_close(f"{lbl} dcls", got[1], want[1]))
                    c += [check_close(f"{lbl} d{k}", got[-1][k], want[-1][k])
                          for k in want[-1]]
                    checks[name] = c
                    b_ = cot_bias[name]
                    f32_checks[name] = [check_f32(f"{lbl} dx", got[0]),
                                        check_f32(f"{lbl} d{b_} (from the f32 cotangent)",
                                                  got[-1][b_], want[-1][b_])]
                del got, want
            if not all(ok for v in checks.values() for ok, _ in v):
                fail(f"a mixed-tier kernel disagrees with its plain twin ({tag} crops)")
            if not all(ok for v in f32_checks.values() for ok, _ in v):
                fail(f"a mixed-tier kernel breaks the f32 tier's rules ({tag} crops)")
            for name, (kern, plain, cost) in runs.items():
                # f32 tier, bf16 tier, bf16, f32: each the mean of its two turns
                ms, ms16 = cuda_ms(kern, 5), cuda_ms(bf16_tier[name], 5)
                ms16 = (ms16 + cuda_ms(bf16_tier[name], 5)) / 2
                ms = (ms + cuda_ms(kern, 5)) / 2
                pl = cuda_ms(plain, 1, warmup=1)
                b, by = bound_ms(*cost)
                gaps = [gap for _, gap in checks[name]]
                row = {"crops": tag, "B": B, "T": T, "N": Np, "ms": ms, "bf16_tier_ms": ms16,
                       "plain_ms": pl, "bound_ms": b, "bound_by": by, "library_ms": None,
                       "max_abs_err": max(g_["max_abs_err"] for g_ in gaps),
                       "rel_rms": max(g_["rel_rms"] for g_ in gaps)}
                for _, reading in f32_checks[name]:
                    for k, v in reading.items():
                        row[k] = max(row.get(k, 0.0), v)
                stats[name].append(row)
                print(f"  {name} {tag} B={B} T={T} N={Np}: kernel {ms:.3f} ms (its bf16 "
                      f"tier in turns {ms16:.3f} ms, {ms / ms16:.2f}x), plain {pl:.3f} ms, "
                      f"bound {b:.4f} ms ({by}, f32 rows), {b / ms:.1%} of bound; library: "
                      "none (no single call)", flush=True)
                if name != "mlp_phase_f32":
                    rows = record_split(f"{name} {tag}", kern, row, top=16, op=name)
                    if name != "spatial_phase_f32":
                        row["ln_bwd_ms"] = sum(ms_ for k_, _, ms_ in rows
                                               if "::ln_bwd_kernel<" in k_)
                        row["cast_colsum_ms"] = sum(ms_ for k_, _, ms_ in rows
                                                    if "::cast_colsum_kernel(" in k_)
            # row 9f at the step's CLS-row calls (M = 16 global, 64 local clips)
            xc, dc = x[:, 0, 0].contiguous(), dout[:, 0, 0].contiguous()
            got, want = fb.mlp_phase_bwd(xc, dc, ps), fb.mlp_phase_bwd_plain(xc, dc, ps)
            oks = ([check_close(f"mlp_phase_bwd_f32 {tag} CLS rows M={B} dx-do", got[0],
                                want[0], dc)]
                   + [check_close(f"mlp_phase_bwd_f32 {tag} CLS rows d{k}", got[1][k],
                                  want[1][k]) for k in want[1]])
            f32_oks = [check_f32(f"mlp_phase_bwd_f32 {tag} CLS rows dx", got[0]),
                       check_f32(f"mlp_phase_bwd_f32 {tag} CLS rows dfc2_b", got[1]["fc2_b"],
                                 want[1]["fc2_b"])]
            if not all(ok for ok, _ in oks + f32_oks):
                fail(f"mlp_phase_bwd's f32 tier disagrees with its twin at the CLS rows ({tag})")
            ms = cuda_ms(lambda: fb.mlp_phase_bwd(xc, dc, ps), 10)
            pl = cuda_ms(lambda: fb.mlp_phase_bwd_plain(xc, dc, ps), 2, warmup=1)
            b, by = bound_ms(*mlp_bwd_f32_cost(B, D, Dh))
            mixed_cls_calls.append({"crops": tag, "M": B, "ms": ms, "plain_ms": pl,
                                    "bound_ms": b, "bound_by": by,
                                    "max_abs_err": max(g_["max_abs_err"] for _, g_ in oks)})
            print(f"  mlp_phase_bwd_f32 {tag} CLS rows M={B}: kernel {ms:.3f} ms, plain "
                  f"{pl:.3f} ms, bound {b:.4f} ms ({by})", flush=True)
            del xc, dc, got, want
        # the LayerNorm backward's f32 instance alone (rows 7f and 9f's grid
        # rows with the residual; row 8f's grid rows and per-frame CLS rows)
        # beside its bytes bound and autograd of F.layer_norm on the same
        # rows (a yardstick the port never calls)
        for what, P_, div in (("rows 7f and 9f", 0, 1), ("row 8f", B, T)):
            R_ = M_ + P_ * div
            lt = cls.reshape(B, D) if P_ else None
            ldy = dev_randn(seed + 4, R_, D, dtype=torch.float32)
            lw = (1 + 0.1 * dev_randn(seed + 5, D, dtype=torch.float32))
            args = (xm, ldy, lw, dm, lt, div)
            args16 = (xm16, ldy, lw, dm16, None if lt is None else cls16.reshape(B, D), div)
            got, want = fb.layer_norm_bwd(*args), fb.layer_norm_bwd_plain(*args)
            oks = [check_close(f"layer_norm_bwd f32 {tag} {what} R={R_} dx-res", got[0],
                               want[0], dm)]
            if P_:
                oks.append(check_close(f"layer_norm_bwd f32 {tag} {what} R={R_} tail dx",
                                       got[1], want[1]))
            oks += [check_close(f"layer_norm_bwd f32 {tag} {what} R={R_} d{nm}", got[i],
                                want[i]) for i, nm in ((2, "scale"), (3, "bias"))]
            f32_ok = check_f32(f"layer_norm_bwd f32 {tag} {what} dx", got[0])
            if not all(ok for ok, _ in oks + [f32_ok]):
                fail(f"the LayerNorm backward's f32 tier disagrees with its twin ({tag}, {what})")
            del got, want
            ms = cuda_ms(lambda: fb.layer_norm_bwd(*args), 10)
            dms, dms16 = graph_ms(lambda: fb.layer_norm_bwd(*args)), graph_ms(
                lambda: fb.layer_norm_bwd(*args16))
            dms16 = (dms16 + graph_ms(lambda: fb.layer_norm_bwd(*args16))) / 2
            dms = (dms + graph_ms(lambda: fb.layer_norm_bwd(*args))) / 2
            pl = cuda_ms(lambda: fb.layer_norm_bwd_plain(*args), 2, warmup=1)
            xf = (torch.cat([xm, lt.repeat_interleave(div, 0)]) if P_ else xm).clone()
            xf.requires_grad_(True)
            lwq = lw.clone().requires_grad_(True)
            lb_ = torch.zeros_like(lw, requires_grad=True)
            lo = F.layer_norm(xf, (D,), lwq, lb_, 1e-6)
            lib = cuda_ms(lambda: torch.autograd.grad(lo, (xf, lwq, lb_), ldy, retain_graph=True),
                          10)
            del xf, lwq, lb_, lo
            b, by = bound_ms(*ln_bwd_f32_cost(M_, R_, D, True))
            blocks["temporal_phase_tm_bwd_f32"]["layer_norm_bwd"].append({
                "crops": tag, "rows_of": what, "M": M_, "R": R_, "ms": ms, "device_ms": dms,
                "bf16_instance_device_ms": dms16, "plain_ms": pl, "library_ms": lib,
                "bound_ms": b, "bound_by": by,
                "max_abs_err": max(g_["max_abs_err"] for _, g_ in oks),
                "bf16_exact": f32_ok[1]["bf16_exact"]})
            print(f"  layer_norm_bwd f32 {tag} {what} (M={M_}, R={R_}, D={D}): {ms:.3f} ms "
                  f"(device {dms:.4f} ms; the bf16 instance in turns {dms16:.4f} ms), bound "
                  f"{b:.4f} ms ({by}), {b / dms:.1%} of bound, plain {pl:.3f} ms, torch's "
                  f"layer-norm backward {lib:.3f} ms", flush=True)
            del ldy, lw, args, args16
        del x, dout, cls, dco, xm, dm, runs, x16, dout16, cls16, dco16, xm16, dm16, bf16_tier
        torch.cuda.empty_cache()
    part("phase 7b: the mixed tier's kernels")

    # routes on phase 7's initial weights and batch-2 crops: the mixed tier
    # on the kernels, the same tier with every op through its twin on the
    # card (twins(fb)), against phase 7's f32 route gradients
    state, core, mask = ssl.init_train_state(tcfg, out_dim=out_dim, optimizer="adamw",
                                             seed=0, device=dev)
    mstep = ssl.make_train_step(tcfg, core, mask, n_local_crops=n_local, clip_grad=3.0,
                                compute_dtype=torch.float32, route="kernels")
    if mstep.route != "kernels":
        fail(f"the mixed ViT-B train step chose the {mstep.route!r} route")
    mixed_grads, mixed_loss = {}, {}
    for name in ("kernels", "twins"):
        reset_counts()
        with twins(fb) if name == "twins" else contextlib.nullcontext():
            loss, _, grads = mstep.loss_and_grads(state, g2, l2, 0.04)
        torch.cuda.synchronize()
        ran = counts()
        if name == "twins" and any(ran.values()):
            fail(f"the mixed twin route launched kernels: {ran}")
        if name == "kernels" and not all(ran[k] for k in (
                "temporal_phase_tm_f32", "spatial_phase_f32", "mlp_phase_f32",
                "temporal_phase_tm_bwd_f32", "spatial_phase_bwd_f32", "mlp_phase_bwd_f32")):
            fail(f"the mixed kernel route missed an f32 tier: {ran}")
        mixed_loss[name], mixed_grads[name] = float(loss), grads
        del grads
        torch.cuda.empty_cache()
    gk, gt, gf = mixed_grads["kernels"], mixed_grads["twins"], f32_grads_b2
    worst, e_mk, e_mt = grad_distances(gk, gt, gf)
    print(f"  batch 2, losses {mixed_loss} (f32 route {route_loss['f32']}); mixed kernel vs "
          f"mixed twin gradients: worst max|diff|/max|twin| {worst[1]:.3e} at {worst[0]} (< "
          f"{TRAIN_GRAD_REL_MAX}); mean distance to f32: mixed kernels {e_mk:.3e}, mixed "
          f"twins {e_mt:.3e} (need kernels <= {TRAIN_F32_RATIO} x twins + 1e-6), phase 7's "
          f"bf16 kernel route {e_bf16_kernels:.3e} (need mixed kernels <= it)", flush=True)
    if worst[1] >= TRAIN_GRAD_REL_MAX:
        fail("mixed kernel-route gradients disagree with the mixed twin route")
    if e_mk > TRAIN_F32_RATIO * e_mt + 1e-6:
        fail("mixed kernel-route gradients are further from f32 than allowed")
    if e_mk > e_bf16_kernels:
        fail("the mixed kernel route is further from f32 than the bf16 kernel route")
    del mixed_grads, gk, gt, gf, f32_grads_b2, g2, l2
    torch.cuda.empty_cache()

    # the step at phase 7's batch, on the same crops
    g, l = crops(batch, 50)
    losses = []

    def mixed_step():
        nonlocal state
        state, metrics = mstep(state, g, l, *hp)
        losses.append(float(metrics["loss"]))

    torch.cuda.reset_peak_memory_stats()
    mixed_step()  # first-call allocations
    torch.cuda.synchronize()
    reset_counts()
    bwd_calls = {}
    sound = {op: getattr(fb, op) for op in rows_of}
    for op in rows_of:
        setattr(fb, op, shim(op))
    try:
        mixed_step()
    finally:
        for op, fn in sound.items():
            setattr(fb, op, fn)
    torch.cuda.synchronize()
    seen = counts()
    reduces = dw_reduces(fb, bwd_calls, tcfg.embed_dim, int(tcfg.embed_dim * tcfg.mlp_ratio))
    want = {k: 0 for k in seen}
    want.update({"temporal_phase_tm_f32": 3 * depth, "spatial_phase_f32": 3 * depth,
                 "mlp_phase_f32": 6 * depth, "temporal_phase_tm_bwd_f32": 2 * depth,
                 "spatial_phase_bwd_f32": 2 * depth,
                 "mlp_phase_bwd_f32": 2 * (2 * depth - 1)})
    print(f"  launches in one mixed step {seen} (expected {want}: the f32 tiers only, 3 "
          f"forwards and 2 student backwards x {depth} blocks, no backward of the last "
          f"block's grid MLP); backward calls by row count {bwd_calls}", flush=True)
    if seen != want:
        fail(f"mixed train step launches {seen}, expected {want}")
    launches_mixed = {k: seen[k] for k in want if want[k]}
    mlp_rows = {rows: n for (op, rows), n in bwd_calls.items() if op == "mlp_phase_bwd"}
    peak_mixed = torch.cuda.max_memory_allocated()
    # ms per step in turns with phase 7's bf16 step on the same state and
    # crops (mixed, bf16, mixed, bf16; n_steps steps a turn)
    bstep = ssl.make_train_step(tcfg, core, mask, n_local_crops=n_local, clip_grad=3.0,
                                compute_dtype=torch.bfloat16)

    def bf16_step():
        nonlocal state
        state, _ = bstep(state, g, l, *hp)

    bf16_step()  # its first call on this state

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_steps

    turns = {"mixed": [], "bf16": []}
    for _ in range(2):
        turns["mixed"].append(timed(mixed_step))
        turns["bf16"].append(timed(bf16_step))
    ms_mixed = sum(turns["mixed"]) / 2
    ms_bf16_turns = sum(turns["bf16"]) / 2
    print(f"  mixed ms_per_step={ms_mixed:.1f} (turns {[round(v, 1) for v in turns['mixed']]}, "
          f"{n_steps} steps each; the bf16 step in turns {ms_bf16_turns:.1f}: "
          f"{[round(v, 1) for v in turns['bf16']]}; phase 7's {ms_step_bf16:.1f}), "
          f"{flops / ms_mixed / 1e9:.1f} TFLOP/s (bf16 {flops / ms_bf16_turns / 1e9:.1f}); "
          f"peak memory {peak_mixed / 2**30:.1f} GiB (phase 7's bf16 step {peak_bf16 / 2**30:.1f}) "
          f"on {card}", flush=True)
    print(f"  losses {[round(v, 4) for v in losses]}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail("a mixed train step gave a non-finite loss")
    t_before = [t.detach().clone() for t in state.teacher.parameters()]
    mixed_step()
    ema_err = max(float((t - (tb * m + s.detach() * (1.0 - m))).abs().max())
                  for t, tb, s in zip(state.teacher.parameters(), t_before,
                                      state.student.parameters()))
    del t_before
    print(f"  teacher vs EMA of the new student (mixed step): max abs {ema_err:.3e} "
          "(<= 1e-6)", flush=True)
    if not math.isfinite(losses[-1]) or ema_err > 1e-6:
        fail("the mixed step's teacher is not the EMA of the student")
    checked_profile("one mixed step", "mixed train step", mixed_step, reset_counts, counts,
                    top=16, reduces=reduces)
    print_profile("one bf16 step beside it", bf16_step, top=0)
    launches.update({k: launches_mixed[k] for k in mixed_ops})
    launches["mlp_phase_bwd_f32_by_rows"] = {str(k): v for k, v in sorted(mlp_rows.items())}
    launches["temporal_phase_tm_f32_train_step"] = launches_mixed["temporal_phase_tm_f32"]
    del g, l, state, mstep, bstep
    torch.cuda.empty_cache()

    # -- 7c. the trainer's variants ------------------------------------------------
    lap("phase 7b")
    rf_geo, launches_rf, launches_remat = phase_7c(
        fb, p, dev, card, reset_counts, counts, part,
        {"ms": ms_step_bf16, "peak": peak_bf16, "crops": crops})

    # -- 8. per-phase XLA-layout forward, bf16 ------------------------------------
    lap("phase 7c")
    print("[8] per-phase XLA-layout forward, bf16: ViT-B/16, every block "
          "through Block.forward(use_fused=True), B=8 windows of 30 and 3 "
          "frames", flush=True)
    bf16_model = tsf.build_timesformer(cfg, sd, device=dev, dtype=torch.bfloat16)
    f32_model = tsf.build_timesformer(cfg, sd, device=dev)
    depth = cfg.depth
    phase_ops = ("temporal_phase", "attn_phase", "mlp_phase")
    windows, refs = {}, {}
    for T in (30, 3):
        windows[T] = torch.from_numpy(np.random.RandomState(80 + T).randn(
            8, 3, T, 224, 224).astype(np.float32)).to(dev)

    def phase_forward(model, x, use_fused, rates=None, masks=None):
        """CLS features with every block through Block.forward(use_fused=
        ...), per-block drop-path rates and masks where given."""
        cls, grid = model.tokens(x)
        B_, T_, N_, D_ = grid.shape
        spat = grid.transpose(1, 2).reshape(B_, N_ * T_, D_)
        n = len(model.blocks)
        kps = model.kernel_params() if use_fused else [None] * n
        for blk, kp_, r_, m_ in zip(model.blocks, kps, rates or [0.0] * n,
                                    masks or [None] * n):
            cls, spat = blk(cls, spat, B_, T_, N_, use_fused=use_fused,
                            kp=kp_, drop_path_rate=r_, masks=m_)
        return tsf.layer_norm(cls, model.norm.weight, model.norm.bias,
                              cfg.norm_eps)[:, 0]

    with torch.inference_mode():
        for T, x in windows.items():
            phase_forward(bf16_model, x, True)  # warm-up
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = phase_forward(bf16_model, x, True)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            seen = counts()
            want = {k: 0 for k in seen}
            want.update({"temporal_phase": depth, "attn_phase": depth,
                         "mlp_phase": 2 * depth})
            print(f"  T={T}: {wall:.1f} ms per forward; launches {seen}",
                  flush=True)
            if seen != want:
                fail(f"per-phase forward launches {seen}, expected {want}")
            for k in phase_ops:
                launches[f"{k}_per_phase"] = launches.get(f"{k}_per_phase", 0) + seen[k]
            reset_counts()
            plain = bf16_model.forward_features(x)
            ref = f32_model.forward_features(x)
            if any(counts().values()):
                fail("the plain bf16 and f32 forwards launched a kernel")
            refs[T] = (plain, ref)
            feature_checks(f"per-phase forward T={T}", got, plain, ref)

        checked_profile("per-phase forward T=30", "per-phase forward",
                        lambda: phase_forward(bf16_model, windows[30], True),
                        reset_counts, counts)

        # drop-path: per-block rates linspace(0, 0.1, depth), masks from a
        # seeded generator, the kernel route and the plain route fed the
        # same masks
        x = windows[30]
        rates = torch.linspace(0, 0.1, depth).tolist()
        gen = torch.Generator().manual_seed(8)
        masks = [tsf.drop_path_masks(8, 30, r_, gen, device=dev) for r_ in rates]
        reset_counts()
        got = phase_forward(bf16_model, x, True, rates, masks)
        torch.cuda.synchronize()
        seen = counts()
        # block 0's rate is 0: its whole block takes the ops; blocks 1-11
        # run drop-path, whose only op is the spatial attn_phase
        want = {k: 0 for k in seen}
        want.update({"attn_phase": depth, "temporal_phase": 1, "mlp_phase": 2})
        print(f"  drop-path 0..0.1, T=30: launches {seen}", flush=True)
        if seen != want:
            fail(f"drop-path forward launches {seen}, expected {want}")
        launches["attn_phase_drop_path"] = seen["attn_phase"]
        kept = sum(float(m_.sum()) for ms_ in masks for m_ in ms_)
        print(f"  masks: {kept:.0f} of {sum(m_.numel() for ms_ in masks for m_ in ms_)}"
              " branch entries kept", flush=True)
        feature_checks("drop-path forward T=30", got,
                       phase_forward(bf16_model, x, False, rates, masks),
                       phase_forward(f32_model, x, False, rates, masks))

    # -- 9. attention-swap forward ---------------------------------------------
    lap("phase 8")
    print("[9] attention swap: ViT-B/16 with attention_kernel=True, the plain "
          "route's MHSA through fused_attention, same windows", flush=True)
    swap_cfg = dataclasses.replace(cfg, attention_kernel=True)
    swap_model = tsf.build_timesformer(swap_cfg, sd, device=dev, dtype=torch.bfloat16)
    with torch.inference_mode():
        for T, x in windows.items():
            swap_model.forward_features(x)  # warm-up
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = swap_model.forward_features(x)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            seen = counts()
            want = {k: 0 for k in seen}
            want["fused_attention"] = 2 * depth
            print(f"  T={T}: {wall:.1f} ms per forward; launches {seen}",
                  flush=True)
            if seen != want:
                fail(f"attention-swap forward launches {seen}, expected {want}")
            launches["fused_attention"] = (launches.get("fused_attention", 0)
                                           + seen["fused_attention"])
            feature_checks(f"attention-swap forward T={T}", got, *refs[T])
        # no op counter accounts for a family here: the swap's attention is
        # attention.cu's, the rest plain torch
        checked_profile("attention-swap forward T=30", "attention-swap forward",
                        lambda: swap_model.forward_features(windows[30]),
                        reset_counts, counts)
        del swap_model
        swap32 = tsf.build_timesformer(swap_cfg, sd, device=dev)
        for T, x in windows.items():
            gap = float((swap32.forward_features(x) - refs[T][1]).abs().max())
            print(f"  f32, T={T}: swap vs no swap max |diff| {gap:.3e} (<= "
                  f"{F32_SWAP_MAX})", flush=True)
            if not gap <= F32_SWAP_MAX:
                fail("the f32 forward with the attention swap is too far from "
                     "the one without it")
    del swap32, bf16_model, f32_model, windows, refs
    torch.cuda.empty_cache()

    # -- 10. shared-memory probe ---------------------------------------------------
    lap("phase 9")
    print("[10] shared-memory probe: bisect the dynamic shared memory a block "
          "may opt into", flush=True)
    reset_counts()
    probe = smem_probe.probe(dev)
    seen = counts()
    launches["smem_probe"] = seen["smem_probe"]
    print(f"  budget {probe['budget']} B, cudaDevAttrMaxSharedMemoryPerBlockOptin "
          f"{probe['optin']} B, the kernels assume {fb.SMEM_LIMIT} B; "
          f"{probe['steps']} sizes tried, {seen['smem_probe']} launched", flush=True)
    if probe["budget"] < fb.SMEM_LIMIT:
        fail(f"the card grants {probe['budget']} B of shared memory, less than "
             f"the {fb.SMEM_LIMIT} B the kernels assume")
    if seen["smem_probe"] == 0 or any(v for k, v in seen.items() if k != "smem_probe"):
        fail(f"probe launches {seen}")
    row = torch.arange(probe["budget"] // 4, dtype=torch.float32, device=dev)
    err = float((smem_probe.roundtrip(row) - smem_probe.roundtrip_plain(row)).abs().max())
    b, by = bound_ms(0, 2 * probe["budget"])
    stats["smem_probe"] = [{
        "bytes": probe["budget"], "budget_bytes": probe["budget"],
        "optin_bytes": probe["optin"],
        "ms": cuda_ms(lambda: smem_probe.roundtrip(row), 50),
        "plain_ms": cuda_ms(lambda: smem_probe.roundtrip_plain(row), 50),
        "bound_ms": b, "bound_by": by, "library_ms": None, "max_abs_err": err}]
    print(f"  roundtrip of {probe['budget']} B: kernel {stats['smem_probe'][0]['ms']:.4f}"
          f" ms (with its attribute call), max_abs_err {err}", flush=True)

    # -- 11. the evaluation consumers ------------------------------------------
    lap("phase 10")
    eval_geo, eval_rec = phase_11(fb, p, dev, card, reset_counts, counts, part)

    # -- 12. the trainer's variants on the other backbones -------------------------
    lap("phase 11")
    launches_ts, launches_cd = phase_12(dev, card, reset_counts, counts, part,
                                        {"ms": ms_step_bf16, "peak": peak_bf16})

    # -- 13. tensor parallelism and ZeRO-1 -------------------------------------------
    lap("phase 12")
    tp_stats, tp_per_tp, tp_launches, tp_by_rank, tp_record = phase_13(
        fb, p, H, dev, part)
    stats.update(tp_stats)
    launches.update(tp_launches)

    lap("phase 13")
    kernels = []
    sources = {
        "temporal_phase_tm": ("fused_block.cu", "ops/fused_block.py:761"),
        "spatial_mlp": ("fused_block.cu", "ops/fused_block.py:1556"),
        "temporal_phase_tm_f32": ("fused_block.cu", "ops/fused_block.py:761"),
        "spatial_mlp_f32": ("fused_block.cu", "ops/fused_block.py:1556"),
        "banded_temporal_attn": ("banded_block.cu", "ops/banded_block.py:43"),
        "spatial_phase_pf": ("banded_block.cu", "ops/banded_block.py:174"),
        "cls_band_attn": ("banded_block.cu", "ops/banded_block.py:291"),
        "mlp_phase": ("fused_block.cu", "ops/fused_block.py:1191"),
        "temporal_phase_tm_bf16": ("fused_block.cu", "ops/fused_block.py:761"),
        "spatial_phase": ("fused_block.cu", "ops/fused_block.py:287"),
        "temporal_phase_tm_bwd": ("fused_block_bwd.cu", "ops/fused_block.py:963"),
        "spatial_phase_bwd": ("fused_block_bwd.cu", "ops/fused_block.py:430"),
        "mlp_phase_bwd": ("fused_block_bwd.cu", "ops/fused_block.py:1233"),
        "attn_phase": ("fused_block.cu", "ops/fused_block.py:188"),
        "temporal_phase": ("fused_block.cu", "ops/fused_block.py:642"),
        "fused_attention": ("attention.cu", "ops/attention.py:42"),
        "smem_probe": ("smem_probe.cu", "tools/vmem_probe.py:31"),
        # no Pallas kernel: the XLA fusion of the gather with unpack_normalize
        "gather_normalize": ("wire.cu", "data/yuv.py:288"),
        # the int8 tier of rows 1 and 2 (their int8 refs, _q8_rows :1481)
        # and its three kernels (row Q): the quantization half and the s8
        # product of _q8_rows
        "temporal_phase_tm_q8": ("fused_block.cu", "ops/fused_block.py:761"),
        "spatial_mlp_q8": ("fused_block.cu", "ops/fused_block.py:1556"),
        # their f32 tier (rows 1qf and 2qf: the int8 teacher under the mixed
        # teacher)
        "temporal_phase_tm_q8_f32": ("fused_block.cu", "ops/fused_block.py:761"),
        "spatial_mlp_q8_f32": ("fused_block.cu", "ops/fused_block.py:1556"),
        "gemm_s8": ("wgmma_gemm.cuh", "ops/fused_block.py:1481"),
        "quant_rows": ("dvst_common.cuh", "ops/fused_block.py:1481"),
        "ln_quant_rows": ("dvst_common.cuh", "ops/fused_block.py:1481"),
        # the trainer's mixed tier (phase 7b): rows 4f, 7f, 8f, 9f and row
        # 3's f32 tier on the train step's rows
        "spatial_phase_f32": ("fused_block.cu", "ops/fused_block.py:287"),
        "temporal_phase_tm_bwd_f32": ("fused_block_bwd.cu", "ops/fused_block.py:963"),
        "spatial_phase_bwd_f32": ("fused_block_bwd.cu", "ops/fused_block.py:430"),
        "mlp_phase_bwd_f32": ("fused_block_bwd.cu", "ops/fused_block.py:1233"),
        "mlp_phase_f32": ("fused_block.cu", "ops/fused_block.py:1191"),
        # the banded mixed teacher's row 11f (phase 6b; row 3f above)
        "spatial_phase_pf_f32": ("banded_block.cu", "ops/banded_block.py:174"),
        # tier C, tensor parallelism's partial tier (phase 13): rows 1p, 4p,
        # 7p and 8p, the partial_out branches of rows 1, 4, 7 and 8
        "temporal_phase_tm_partial": ("fused_block.cu", "ops/fused_block.py:761"),
        "spatial_phase_partial": ("fused_block.cu", "ops/fused_block.py:287"),
        "temporal_phase_tm_bwd_partial": ("fused_block_bwd.cu", "ops/fused_block.py:963"),
        "spatial_phase_bwd_partial": ("fused_block_bwd.cu", "ops/fused_block.py:430"),
    }
    # rows 3f and 11f on band-mt's teacher passes (the 512-frame bucket),
    # row 3f at the mixed train step's crops beside them
    mlp_f32_crops = stats["mlp_phase_f32"]
    stats["mlp_phase_f32"] = [band_f32_rows["mlp_phase_f32"]]
    stats["spatial_phase_pf_f32"] = [band_f32_rows["spatial_phase_pf_f32"]]
    launches["mlp_phase_f32_train_step"] = launches["mlp_phase_f32"]
    for name in ("mlp_phase_f32", "spatial_phase_pf_f32"):
        launches[name] = launches_band_mt[name]
    for name in ("attn_phase", "temporal_phase"):
        launches[name] = launches[f"{name}_per_phase"]
    for name, rows in stats.items():
        # per block, the op runs once per window (windowed: the teacher and
        # the student forward; the per-phase ops), once per pass (banded:
        # the teacher and the student pass) or once per crop shape
        # (training: global and local): ms, plain_ms and bound_ms sum the
        # rows (fused_attention: its spatial and temporal call per window)
        src, tpu = sources[name]
        libs = [r["library_ms"] for r in rows]
        extra = {}
        if name == "mlp_phase":
            extra = {"launches_train_step": launches["mlp_phase_train_step"],
                     "launches_per_phase_forward": launches["mlp_phase_per_phase"],
                     "per_crop": mlp_crops}
        elif name == "attn_phase":
            extra = {"launches_drop_path": launches["attn_phase_drop_path"]}
        elif name == "mlp_phase_bwd":
            extra = {"launches_by_rows": launches["mlp_phase_bwd_by_rows"],
                     "per_cls_call": mlp_cls_calls}
        elif name == "mlp_phase_bwd_f32":
            extra = {"launches_by_rows": launches["mlp_phase_bwd_f32_by_rows"],
                     "per_cls_call": mixed_cls_calls}
        elif name == "mlp_phase_f32":
            extra = {"launches_mixed_train_step": launches["mlp_phase_f32_train_step"],
                     "per_crop": mlp_f32_crops}
        elif name == "temporal_phase_tm_f32":
            # the count is the mixed teacher's (phase 4b); the mixed train
            # step's too (phase 7b)
            extra = {"launches_mixed_train_step": launches["temporal_phase_tm_f32_train_step"]}
        elif name == "gather_normalize":
            extra = {"launches_rgb8": launches_wire["rgb8"],
                     "launches_mixed": launches_wire["mixed yuv420"],
                     "launches_banded": launches["gather_normalize_banded"],
                     "cases": wire_cases,
                     "upload_600_frames": {k: {"h2d_device_ms": v[0], "device_busy_ms": v[1],
                                               "bytes": v[2]} for k, v in up.items()}}
        elif name == "smem_probe":
            extra = {"budget_bytes": rows[0]["budget_bytes"],
                     "optin_bytes": rows[0]["optin_bytes"]}
        elif name in ("temporal_phase_tm_q8", "spatial_mlp_q8", "gemm_s8", "quant_rows",
                      "ln_quant_rows"):
            # the count is the both-int8 run's; the two one-sided runs' and
            # the int8 teacher under the mixed teacher's too
            extra = {"launches_student_int8": launches_q8["student int8"][name],
                     "launches_teacher_int8": launches_q8["teacher int8"][name],
                     "launches_teacher_int8_mixed": launches_q8["teacher int8 mixed"][name]}
        if name in launches_band_mt:  # rows 10, 11(f), 12 and 3(f) on band-mt / band-t-mt
            extra["launches_band_mt"] = launches_band_mt[name]
            extra["launches_band_t_mt"] = launches_band_tmt.get(name, 0)
        if name in blocks:  # rows 1-3, 6, 8, 9 and 11: their blocks alone
            extra["blocks"] = blocks[name]
        # phase 4e's launches of the op by configuration, and rows 1 and 2
        # at teacher_img=160's grid (phase 3)
        by_cfg = {tag: n[name] for tag, n in strided_launches.items() if name in n}
        if by_cfg:
            extra["launches_strided"] = by_cfg
        if name in geo_img:
            extra["teacher_img_160"] = geo_img[name]
        if name in eval_geo:  # the evaluation consumers (phase 11)
            extra["eval_geometry"] = eval_geo[name]
            extra["launches_eval"] = {path: n[name] for path, n in eval_rec["launches"].items()
                                      if name in n}
        if name in launches_ts:  # the two-stream and distillation steps (phase 12)
            extra.update(launches_two_stream_step=launches_ts[name],
                         launches_distill_step=launches_cd[name])
        if name in tp_per_tp:  # tier C (phase 13): both tp, the main path's ranks
            extra.update(per_tp={str(k): v for k, v in tp_per_tp[name].items()},
                         launches_by_rank=[r[name] for r in tp_by_rank],
                         launches_per_step=launches[name] // 3)
        if name in launches_rf:  # the trainer's variants (phase 7c)
            extra.update(launches_rand_fr_step=launches_rf[name],
                         launches_remat_step=launches_remat[name],
                         rand_fr_geometries=rf_geo[name])
        kernels.append({**extra,
            "name": name, "route": "cuda",
            "source": f"dino_video_summarization_transformer_tpu_torch/ops/csrc/{src}",
            "replaces": (tpu if tpu.startswith("tools/")
                         else f"dino_video_summarization_transformer_tpu/{tpu}"),
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": rows[0]["bound_by"],
            "library_ms": None if None in libs else sum(libs),
            "per_window": rows})
    print(f"  evaluation consumers (phase 11): {json.dumps({k: v for k, v in eval_rec.items() if k != 'launches'})}",
          flush=True)
    print(f"  tensor parallelism (phase 13b): {json.dumps(tp_record)}", flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
