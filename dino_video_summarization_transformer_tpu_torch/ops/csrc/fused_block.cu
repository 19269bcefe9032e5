// Hopper (sm_90a) kernels for the whole-block divided space-time pair, the
// per-phase spatial half, the row-wise MLP phase and the XLA-layout
// block's two attention phases (forwards; the backwards are in
// fused_block_bwd.cu).
//
// Ten C entry points, each a short chain of launches on the caller's
// stream (the building blocks are in dvst_common.cuh):
//
//   dvst_temporal_phase_tm  replaces _temporal_phase_tm_kernel
//       (dino_video_summarization_transformer_tpu/ops/fused_block.py:761):
//       x (B,T,N,D) -> x + fc(proj(MHSA over T at each position(LN x)))
//       in three tiers: bf16 x, f32 out (the whole-block path's carry);
//       bf16 x, out_bf16: bf16 out = bf16(x + bf16(fc)) (the per-phase
//       training path, the Pallas kernel's rounding at
//       fused_block.py:855-857); x_f32: f32 x, f32 out = x + fc, the
//       mixed teacher's block boundary (fused_block.py:852-854), its LN
//       reading the f32 rows (ln_kernel<float>) and its fc epilogue adding
//       the f32 residual unrounded (kEpiResF32F32)
//       launches: LN -> GEMM qkv -> attention -> GEMM proj -> GEMM fc+res
//       Its GEMMs are the wgmma + TMA kernel (wgmma_gemm.cuh), its
//       attention the tensor-core tile reading the T rows of each
//       sequence at stride N straight from the qkv buffer (tc_attention.cuh's
//       tc_strided_attn).
//   dvst_temporal_phase_tm_q8  replaces the int8 tier of
//       _temporal_phase_tm_kernel (fused_block.py:761, its weight-scale
//       refs at :765-769, wrapper :911-921; _q8_rows :1481): bf16 x ->
//       f32 x + fc(proj(MHSA over T(LN x))) with s8 weights and per-row
//       s8 activations, as JAX's _dense_rows runs every product of the
//       tier (:1496); the attention stays bf16. Its f32 tier (x_f32, row
//       1qf: the int8 teacher under the mixed teacher, whose block
//       boundary is f32): f32 x -> f32 x + fc, the LN + quantize reading
//       the f32 rows (ln_quant_kernel<float>, fused_block.py:780-784 casts
//       any x to f32 before LN) and fc's dequantizing epilogue adding the
//       f32 residual unrounded (kEpiResF32F32), as row 1f's does
//       launches: LN+quant -> s8 GEMM qkv -> attention -> quant ->
//       s8 GEMM proj -> quant -> s8 GEMM fc+res
//       (ln_quant_kernel, wg_gemm_s8, tc_strided_attn, quant_rows_kernel)
//   dvst_spatial_phase      replaces _spatial_phase_kernel
//       (ops/fused_block.py:287): per frame on [cls, x_t]: LN -> MHSA ->
//       proj; grid out = bf16(x + bf16(proj)), raw per-frame CLS rows bf16;
//       x_f32, the trainer's mixed tier (f32 x and CLS row in, :299): the
//       LNs read the f32 rows (ln_kernel<float>), grid out = f32 x + proj
//       unrounded (kEpiResF32F32) and the CLS rows f32 (kEpiF32; the
//       Pallas kernel writes x.dtype, :340-345)
//       launches: LN grid, LN cls -> GEMM qkv grid, GEMM qkv cls ->
//       attention -> GEMM proj+res grid, GEMM proj cls
//       Bound by operations: at the training step's global crops (B=16,
//       T=8, N=196, D=768) B*T*L*(8*D^2 + 4*L*D) = 1.34e11 FLOP (the
//       Pallas cost estimate) against 0.1 GB of rows, 0.136 ms at the
//       bf16 peak. The design is the first half of dvst_spatial_mlp: its
//       GEMMs the wgmma + TMA kernel, its attention the tensor-core tile
//       with the CLS row as prefix key (tc_prefix_attn, one CLS row per
//       clip read for all its frames, so no per-frame copy is built).
//   dvst_temporal_phase_tm_partial, dvst_spatial_phase_partial  replace
//       the partial_out branches of _temporal_phase_tm_kernel
//       (fused_block.py:842-851, rows 1p) and _spatial_phase_kernel
//       (:336-343, row 4p): tensor parallelism's tier C, one shard's term
//       of the sum over the shards (parallel/tp_fused.py), bf16 x (and
//       CLS row) -> bf16 fc(proj(MHSA)) or proj(MHSA) with the shard's
//       heads, no proj or fc bias and no residual. The attention width Dq
//       (= D / tp) is any multiple of 64: qkv is (3 Dq, D), proj (D, Dq),
//       so at ViT-B over four shards qkv's 576 columns and proj's 192-deep
//       reduction run the GEMM's 64-wide instance. The same launches as
//       rows 1 and 4 with null biases.
//   dvst_spatial_mlp        replaces _spatial_mlp_kernel
//       (ops/fused_block.py:1556, float tier):
//       per frame on [cls, x_t]: LN -> MHSA -> proj -> grid residual -> LN ->
//       MLP -> residual; bf16 grid out + f32 per-frame CLS rows, or, in
//       the mixed teacher's tier, an f32 CLS row in (its LN on the f32
//       row: the CLS token is f32 end to end, fused_block.py:1688-1715)
//       and an f32 grid out (out_dtype = the boundary's, :1684-1686;
//       kEpiResF32F32 in place of kEpiResF32Bf16)
//       launches: LN grid, LN cls -> GEMM qkv grid, GEMM qkv cls ->
//       attention -> GEMM proj+res grid, GEMM proj cls -> LN ->
//       GEMM fc1+GELU -> GEMM fc2+res
//       Its GEMMs are the wgmma + TMA kernel (wgmma_gemm.cuh), its
//       attention the tensor-core tile with the CLS row as prefix key
//       (tc_attention.cuh's tc_prefix_attn).
//   dvst_spatial_mlp_q8     replaces the int8 tier of _spatial_mlp_kernel
//       (fused_block.py:1556, refs :1567-1571, wrapper :1607-1618): the
//       float tier's chain with every product an s8 GEMM on rows quantized
//       just before it: the LN rows of the grid and of the CLS rows, the
//       attention outputs (grid and per-frame CLS), the post-spatial LN
//       rows and the 3072-wide hidden rows before fc2 (_mhsa_rows :1505,
//       _mlp_rows :1538); the CLS row bf16, the grid out bf16, or (f32,
//       row 2qf: the int8 teacher under the mixed teacher) an f32 CLS row,
//       its LN + quantize on the f32 row (ln_quant_kernel<float>,
//       :1688-1690), and an f32 grid out = x2 + MLP unrounded (fc2's
//       dequantizing epilogue kEpiResF32F32 in place of kEpiResF32Bf16,
//       :1684-1686)
//       launches: LN+quant grid, LN+quant cls -> s8 GEMM qkv grid, qkv
//       cls -> attention -> quant, s8 GEMM proj+res grid -> quant, s8
//       GEMM proj cls -> LN+quant -> s8 GEMM fc1+GELU -> quant -> s8
//       GEMM fc2+res
//       The int8 tier's bound: its GEMMs' operations at the s8 peak (1979
//       TOPS), its attention's at the bf16 peak; it is a simple first
//       form, the quantization a row pass of its own before each product.
//   dvst_mlp_phase          replaces _mlp_phase_kernel
//       (ops/fused_block.py:1191): rows (M,D) bf16 -> LN -> fc1 -> erf GELU
//       -> fc2, optionally + x, bf16 out; fc2's output is rounded to bf16
//       before the residual add, as the Pallas kernel rounds it. Its
//       mixed tier (the banded teacher's grid MLP) takes f32 rows and
//       writes f32 x + fc2 with nothing rounded (the kernel writes
//       x.dtype, :1213-1215)
//       launches: LN -> GEMM fc1+GELU -> GEMM fc2(+res), both GEMMs the
//       wgmma + TMA kernel
//       Bound by operations: 4*M*D*Dh FLOP against 4*M*D bytes of rows
//       (~1500 FLOP/B at ViT-B). The fc1 hidden (M, Dh) bf16 goes through
//       device memory (617 MB at M = 512*196): the simple form; keeping it
//       on chip means one kernel with both GEMMs, a later step.
//   dvst_attn_phase         replaces _attn_phase_kernel
//       (ops/fused_block.py:188): x (S,L,D) bf16 -> bf16(proj(MHSA(LN x)))
//       over S contiguous sequences of L rows (the XLA-layout block's
//       spatial half on [CLS, grid] rows, no residual; the CLS row is a
//       query of its sequence like any other row)
//       launches: LN -> GEMM qkv -> attention -> GEMM proj
//       Bound by operations: S*L*(8*D^2 + 4*L*D) FLOP (the Pallas cost
//       estimate) against 4*S*L*D bytes; 2.5e11 FLOP at the teacher window's
//       spatial sequences (S = 240, L = 197), 0.255 ms at the bf16 peak.
//       Its GEMMs are the wgmma + TMA kernel, its attention the tile over
//       S contiguous sequences (tc_strided_attn at N = 1, as
//       dvst_temporal_phase runs it: one sequence a block at L = 197, 35
//       at L = 3).
//   dvst_temporal_phase     replaces _temporal_phase_kernel
//       (ops/fused_block.py:642): x (S,L,D) bf16 ->
//       bf16(x + bf16(fc(proj(MHSA(LN x))))) over S contiguous sequences
//       (the Pallas rounding at fused_block.py:702-707). It is
//       dvst_temporal_phase_tm with B = S, T = L, N = 1 in its bf16-out
//       tier: the sequence rows (b*T + t)*N + n become s*L + l. Bound by
//       operations: S*L*(10*D^2 + 4*L*D) FLOP.
//
// Bound on the card. Both ops are bound by operations, not bytes: at the
// teacher window (B=8, T=30, N=196, D=768, MLP 3072) the temporal op needs
// B*N*T*(10*D^2 + 4*T*D) = 2.8e11 FLOP against 0.22 GB of activations, the
// spatial op 6.9e11 FLOP against 0.23 GB (the bf16 tensor-core ridge is
// ~295 FLOP/B). Their floors are those FLOP at 989 TFLOP/s. 95% of the
// FLOP are the dense GEMMs; the attention over 30 (temporal) or 197
// (spatial) rows is ~1-4% of them.
//
// Design: every entry point runs its products on the persistent
// warp-specialised wgmma + TMA GEMM (wgmma_gemm.cuh) and its attention on
// the tensor-core tile (tc_attention.cuh): with the CLS row as prefix key
// for the spatial ops (the CLS row is the same for every frame of a clip,
// so its LN and qkv run once per clip and the tile reads it by address),
// at stride N straight from the qkv buffer for the temporal ops (the TPU
// kernel's in-VMEM transpose without an HBM transpose), over contiguous
// sequences (stride 1) for the XLA-layout block's two phases. ln_kernel
// (dvst_common.cuh): one warp per row, f32 statistics, bf16 rows out.
//
// Numerics (the XLA-path rules): LN in f32 (eps 1e-6); bf16 operands with
// f32 accumulation; qkv rounded to bf16 after the bias; max-subtracted f32
// softmax; exact erf GELU; f32 intra-block carry. The Pallas kernels' +/-80
// logit clamp, ones-column denominator and tanh GELU are TPU workarounds and
// are not copied.

#include "tc_attention.cuh"
#include "wgmma_gemm.cuh"

namespace {

// The entry points' workspaces, each buffer carved 256-byte aligned
// (Carve) so every TMA operand starts 16-byte aligned. Every buffer holds
// what the C side stages in it, in that dtype: the LN rows, qkv, attention
// and hidden rows are bf16 in every tier; the post-spatial carry x2 of
// dvst_spatial_mlp is f32. The f32 ("mixed") tiers read their f32 inputs
// and write their f32 outputs in the caller's tensors and stage nothing
// more. Each layout's bytes are its *_ws entry point's answer, and the
// wrappers size their workspace from it.

// dvst_spatial_phase's: the LN rows, qkv and attention output of the M
// grid rows, of the B CLS rows, and the B*T per-frame CLS attention
// outputs. Dq: the attention's width (D; Dq = D / tp in the partial tier,
// whose qkv is 3 * Dq wide and whose attention output is Dq wide).
struct SpatialPhaseWs {
  bf16 *y, *qkv, *a, *y_cls, *qkv_cls, *a_cls;
  size_t bytes;
};

SpatialPhaseWs spatial_phase_ws(char* base, int B, int T, int N, int D, int Dq) {
  const long M = (long)B * T * N;
  Carve c{base};
  SpatialPhaseWs w;
  w.y = c.take<bf16>(M * D);
  w.qkv = c.take<bf16>(M * 3 * Dq);
  w.a = c.take<bf16>(M * Dq);
  w.y_cls = c.take<bf16>((long)B * D);
  w.qkv_cls = c.take<bf16>((long)B * 3 * Dq);
  w.a_cls = c.take<bf16>((long)B * T * Dq);
  w.bytes = c.off;
  return w;
}

// dvst_temporal_phase_tm's (and dvst_temporal_phase's): qkv of the M rows,
// the LN rows (then the proj output), the attention output (Dq as above).
struct TemporalWs {
  bf16 *qkv, *buf1, *buf2;
  size_t bytes;
};

TemporalWs temporal_ws(char* base, long M, int D, int Dq) {
  Carve c{base};
  TemporalWs w;
  w.qkv = c.take<bf16>(M * 3 * Dq);
  w.buf1 = c.take<bf16>(M * D);
  w.buf2 = c.take<bf16>(M * Dq);
  w.bytes = c.off;
  return w;
}

// dvst_spatial_mlp's: the M grid rows' LN rows (LN1, then LN2), qkv,
// attention output and MLP hidden rows; the B CLS rows' LN rows and qkv;
// the B*T per-frame CLS attention outputs; and the f32 post-spatial carry
// x2 of the M grid rows.
struct SpatialMlpWs {
  bf16 *y, *qkv, *a, *hid, *y_cls, *qkv_cls, *a_cls;
  float* x2;
  size_t bytes;
};

SpatialMlpWs spatial_mlp_ws(char* base, int B, int T, int N, int D, int Dh) {
  const long M = (long)B * T * N;
  Carve c{base};
  SpatialMlpWs w;
  w.y = c.take<bf16>(M * D);
  w.qkv = c.take<bf16>(M * 3 * D);
  w.a = c.take<bf16>(M * D);
  w.hid = c.take<bf16>(M * Dh);
  w.y_cls = c.take<bf16>((long)B * D);
  w.qkv_cls = c.take<bf16>((long)B * 3 * D);
  w.a_cls = c.take<bf16>((long)B * T * D);
  w.x2 = c.take<float>(M * D);
  w.bytes = c.off;
  return w;
}

// dvst_temporal_phase_tm_q8's: the s8 codes and f32 scales of the rows
// about to be multiplied (the LN rows, then the attention output, then the
// proj output), qkv, and the attention output (then the proj output).
struct TemporalQ8Ws {
  int8_t* q;
  float* sx;
  bf16 *qkv, *a;
  size_t bytes;
};

TemporalQ8Ws temporal_q8_ws(char* base, long M, int D) {
  Carve c{base};
  TemporalQ8Ws w;
  w.q = c.take<int8_t>(M * D);
  w.sx = c.take<float>(M);
  w.qkv = c.take<bf16>(M * 3 * D);
  w.a = c.take<bf16>(M * D);
  w.bytes = c.off;
  return w;
}

// dvst_spatial_mlp_q8's: the codes and scales of the M grid rows (up to
// Dh wide: the hidden rows), qkv, the attention output and the hidden
// rows; the codes and scales of the B CLS rows and then of the B*T
// per-frame CLS attention outputs, the CLS rows' qkv and those outputs;
// and the f32 post-spatial carry x2.
struct SpatialMlpQ8Ws {
  int8_t *q, *q_cls;
  float *sx, *sx_cls;
  bf16 *qkv, *a, *hid, *qkv_cls, *a_cls;
  float* x2;
  size_t bytes;
};

SpatialMlpQ8Ws spatial_mlp_q8_ws(char* base, int B, int T, int N, int D, int Dh) {
  const long M = (long)B * T * N;
  Carve c{base};
  SpatialMlpQ8Ws w;
  w.q = c.take<int8_t>(M * (Dh > D ? Dh : D));
  w.sx = c.take<float>(M);
  w.qkv = c.take<bf16>(M * 3 * D);
  w.a = c.take<bf16>(M * D);
  w.hid = c.take<bf16>(M * Dh);
  w.q_cls = c.take<int8_t>((long)B * T * D);
  w.sx_cls = c.take<float>((long)B * T);
  w.qkv_cls = c.take<bf16>((long)B * 3 * D);
  w.a_cls = c.take<bf16>((long)B * T * D);
  w.x2 = c.take<float>(M * D);
  w.bytes = c.off;
  return w;
}

// dvst_mlp_phase's: the LN rows and the hidden rows.
struct MlpWs {
  bf16 *y, *hid;
  size_t bytes;
};

MlpWs mlp_ws(char* base, long M, int D, int Dh) {
  Carve c{base};
  MlpWs w;
  w.y = c.take<bf16>(M * D);
  w.hid = c.take<bf16>(M * Dh);
  w.bytes = c.off;
  return w;
}

}  // namespace

extern "C" {

const char* dvst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B,T,N,D) frame-major, bf16 or (x_f32) f32 -> out (B,T,N,D), f32 or
// (out_bf16, bf16 x only) bf16. ws: the bytes dvst_temporal_phase_tm_ws
// gives.
long dvst_temporal_phase_tm_ws(int B, int T, int N, int D) {
  return (long)temporal_ws(nullptr, (long)B * T * N, D, D).bytes;
}

int dvst_temporal_phase_tm(const void* x_, const void* ln_w, const void* ln_b,
                           const void* qkv_w, const void* qkv_b,
                           const void* proj_w, const void* proj_b,
                           const void* fc_w, const void* fc_b, void* ws,
                           void* out, int B, int T, int N, int D, int H,
                           int x_f32, int out_bf16, void* stream) {
  if (x_f32 && out_bf16) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)B * T * N;
  const TemporalWs w = temporal_ws(static_cast<char*>(ws), M, D, D);
  const float* lw = static_cast<const float*>(ln_w);
  const float* lb = static_cast<const float*>(ln_b);
  cudaError_t e;
  // LN reads x in its own dtype: the mixed tier's f32 rows are never
  // rounded before their statistics
  if (x_f32)
    e = ln_launch<float>(static_cast<const float*>(x_), lw, lb, w.buf1, M, D, st);
  else
    e = ln_launch<bf16>(static_cast<const bf16*>(x_), lw, lb, w.buf1, M, D, st);
  if (e) return e;
  if ((e = wg_gemm<kEpiBf16>(w.buf1, qkv_w, qkv_b, nullptr, w.qkv, M, 3 * D, D, st))) return e;
  // sequence (b, n) over t: rows (b*T + t)*N + n
  const int hd = D / H;
  if ((e = tc_strided_attn(hd, w.qkv, w.buf2, B, T, N, H, 1.0f / sqrtf((float)hd), st)))
    return e;
  if ((e = wg_gemm<kEpiBf16>(w.buf2, proj_w, proj_b, nullptr, w.buf1, M, D, D, st))) return e;
  if (x_f32)  // the mixed tier: x + fc in f32, nothing rounded
    return wg_gemm<kEpiResF32F32>(w.buf1, fc_w, fc_b, x_, out, M, D, D, st);
  if (out_bf16)
    return wg_gemm<kEpiAddBf16>(w.buf1, fc_w, fc_b, x_, out, M, D, D, st);
  return wg_gemm<kEpiResBf16F32>(w.buf1, fc_w, fc_b, x_, out, M, D, D, st);
}

// The int8 tier: x (B,T,N,D) bf16 or (x_f32) f32 -> out (B,T,N,D) f32 =
// x + fc, with s8 weights (out, in) and their f32 scales. ws: the bytes
// dvst_temporal_phase_tm_q8_ws gives (the same layout for either x).
long dvst_temporal_phase_tm_q8_ws(int B, int T, int N, int D) {
  return (long)temporal_q8_ws(nullptr, (long)B * T * N, D).bytes;
}

int dvst_temporal_phase_tm_q8(const void* x_, const void* ln_w, const void* ln_b,
                              const void* qkv_w, const void* qkv_s, const void* qkv_b,
                              const void* proj_w, const void* proj_s, const void* proj_b,
                              const void* fc_w, const void* fc_s, const void* fc_b, void* ws,
                              void* out, int B, int T, int N, int D, int H, int x_f32,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)B * T * N;
  const TemporalQ8Ws w = temporal_q8_ws(static_cast<char*>(ws), M, D);
  const float* lw = static_cast<const float*>(ln_w);
  const float* lb = static_cast<const float*>(ln_b);
  cudaError_t e;
  // LN reads x in its own dtype: the f32 tier's rows are never rounded
  // before their statistics (the LN output is rounded to bf16, then
  // quantized, in both tiers)
  if (x_f32)
    e = ln_quant_launch<float>(static_cast<const float*>(x_), lw, lb, w.q, w.sx, M, D, st);
  else
    e = ln_quant_launch<bf16>(static_cast<const bf16*>(x_), lw, lb, w.q, w.sx, M, D, st);
  if (e) return e;
  if ((e = wg_gemm_s8<kEpiBf16>(w.q, w.sx, qkv_w, qkv_s, qkv_b, nullptr, w.qkv, M, 3 * D, D,
                                st)))
    return e;
  // sequence (b, n) over t: rows (b*T + t)*N + n
  const int hd = D / H;
  if ((e = tc_strided_attn(hd, w.qkv, w.a, B, T, N, H, 1.0f / sqrtf((float)hd), st))) return e;
  if ((e = quant_rows_launch(w.a, w.q, w.sx, M, D, st))) return e;
  if ((e = wg_gemm_s8<kEpiBf16>(w.q, w.sx, proj_w, proj_s, proj_b, nullptr, w.a, M, D, D, st)))
    return e;
  if ((e = quant_rows_launch(w.a, w.q, w.sx, M, D, st))) return e;
  if (x_f32)  // the f32 tier: x + fc in f32, nothing rounded
    return wg_gemm_s8<kEpiResF32F32>(w.q, w.sx, fc_w, fc_s, fc_b, x_, out, M, D, D, st);
  return wg_gemm_s8<kEpiResBf16F32>(w.q, w.sx, fc_w, fc_s, fc_b, x_, out, M, D, D, st);
}

// x (B,T,N,D) bf16, cls (B,1,D) bf16 -> out (B,T,N,D) bf16 =
// bf16(x + bf16(proj)) or, with out_f32, f32 x + proj (the branch
// unrounded: the card's checks hold the branch through this tier of the
// same launches), cls_rows (B,T,D) bf16. With x_f32 (the trainer's mixed
// tier): x and cls f32 -> out f32 = x + proj, cls_rows f32 (out_f32 is
// then ignored). ws: the bytes dvst_spatial_phase_ws gives.
long dvst_spatial_phase_ws(int B, int T, int N, int D) {
  return (long)spatial_phase_ws(nullptr, B, T, N, D, D).bytes;
}

int dvst_spatial_phase(const void* x_, const void* cls_, const void* ln_w,
                       const void* ln_b, const void* qkv_w, const void* qkv_b,
                       const void* proj_w, const void* proj_b, void* ws,
                       void* out, void* cls_rows, int B, int T, int N, int D,
                       int H, int out_f32, int x_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)B * T * N;
  const SpatialPhaseWs w = spatial_phase_ws(static_cast<char*>(ws), B, T, N, D, D);
  const float* lw = static_cast<const float*>(ln_w);
  const float* lb = static_cast<const float*>(ln_b);
  const int hd = D / H;
  cudaError_t e;
  if (x_f32) {
    if ((e = ln_launch<float>(static_cast<const float*>(x_), lw, lb, w.y, M, D, st))) return e;
    e = ln_launch<float>(static_cast<const float*>(cls_), lw, lb, w.y_cls, B, D, st);
  } else {
    if ((e = ln_launch<bf16>(static_cast<const bf16*>(x_), lw, lb, w.y, M, D, st))) return e;
    e = ln_launch<bf16>(static_cast<const bf16*>(cls_), lw, lb, w.y_cls, B, D, st);
  }
  if (e) return e;
  if ((e = wg_gemm<kEpiBf16>(w.y, qkv_w, qkv_b, nullptr, w.qkv, M, 3 * D, D, st))) return e;
  if ((e = wg_gemm<kEpiBf16>(w.y_cls, qkv_w, qkv_b, nullptr, w.qkv_cls, B, 3 * D, D, st)))
    return e;
  // sequence s = b*T + t: [cls row b, grid rows s*N + n for n < N]
  if ((e = tc_prefix_attn(hd, w.qkv, w.qkv_cls, w.a, w.a_cls, B * T, T, N, H,
                          1.0f / sqrtf((float)hd), st)))
    return e;
  if (x_f32) {
    if ((e = wg_gemm<kEpiResF32F32>(w.a, proj_w, proj_b, x_, out, M, D, D, st))) return e;
    return wg_gemm<kEpiF32>(w.a_cls, proj_w, proj_b, nullptr, cls_rows, (long)B * T, D, D, st);
  }
  e = out_f32 ? wg_gemm<kEpiResBf16F32>(w.a, proj_w, proj_b, x_, out, M, D, D, st)
              : wg_gemm<kEpiAddBf16>(w.a, proj_w, proj_b, x_, out, M, D, D, st);
  if (e) return e;
  return wg_gemm<kEpiBf16>(w.a_cls, proj_w, proj_b, nullptr, cls_rows, (long)B * T, D, D, st);
}

// The partial tier (tier C) of dvst_temporal_phase_tm: one shard's
// term of the tensor-parallel sum, x (B,T,N,D) bf16 -> out (B,T,N,D)
// bf16 = bf16(fc(bf16(proj(MHSA over T(LN x))))) with the shard's H heads
// of width Dq / H: qkv_w (3 Dq, D) and qkv_b (3 Dq) head-major, proj_w
// (D, Dq), fc_w (D, D); no proj or fc bias and no residual (the caller
// adds them once, after the sum over the shards). ws: the bytes
// dvst_temporal_phase_tm_partial_ws gives.
long dvst_temporal_phase_tm_partial_ws(int B, int T, int N, int D, int Dq) {
  return (long)temporal_ws(nullptr, (long)B * T * N, D, Dq).bytes;
}

int dvst_temporal_phase_tm_partial(const void* x_, const void* ln_w, const void* ln_b,
                                   const void* qkv_w, const void* qkv_b, const void* proj_w,
                                   const void* fc_w, void* ws, void* out, int B, int T, int N,
                                   int D, int Dq, int H, void* stream) {
  if (H <= 0 || Dq % H || Dq % 64) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)B * T * N;
  const TemporalWs w = temporal_ws(static_cast<char*>(ws), M, D, Dq);
  cudaError_t e;
  if ((e = ln_launch<bf16>(static_cast<const bf16*>(x_), static_cast<const float*>(ln_w),
                           static_cast<const float*>(ln_b), w.buf1, M, D, st)))
    return e;
  if ((e = wg_gemm<kEpiBf16>(w.buf1, qkv_w, qkv_b, nullptr, w.qkv, M, 3 * Dq, D, st))) return e;
  const int hd = Dq / H;
  if ((e = tc_strided_attn(hd, w.qkv, w.buf2, B, T, N, H, 1.0f / sqrtf((float)hd), st)))
    return e;
  if ((e = wg_gemm<kEpiBf16>(w.buf2, proj_w, nullptr, nullptr, w.buf1, M, D, Dq, st))) return e;
  return wg_gemm<kEpiBf16>(w.buf1, fc_w, nullptr, nullptr, out, M, D, D, st);
}

// The partial tier of dvst_spatial_phase: x (B,T,N,D), cls (B,1,D) bf16
// -> out (B,T,N,D) bf16 = bf16(proj(MHSA(LN [cls, x_t]))) over the grid
// rows, cls_rows (B,T,D) bf16 the same over the CLS rows, with the shard's
// H heads (qkv_w (3 Dq, D), qkv_b (3 Dq), proj_w (D, Dq)); no proj bias
// and no residual. ws: the bytes dvst_spatial_phase_partial_ws gives.
long dvst_spatial_phase_partial_ws(int B, int T, int N, int D, int Dq) {
  return (long)spatial_phase_ws(nullptr, B, T, N, D, Dq).bytes;
}

int dvst_spatial_phase_partial(const void* x_, const void* cls_, const void* ln_w,
                               const void* ln_b, const void* qkv_w, const void* qkv_b,
                               const void* proj_w, void* ws, void* out, void* cls_rows, int B,
                               int T, int N, int D, int Dq, int H, void* stream) {
  if (H <= 0 || Dq % H || Dq % 64) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)B * T * N;
  const SpatialPhaseWs w = spatial_phase_ws(static_cast<char*>(ws), B, T, N, D, Dq);
  const float* lw = static_cast<const float*>(ln_w);
  const float* lb = static_cast<const float*>(ln_b);
  const int hd = Dq / H;
  cudaError_t e;
  if ((e = ln_launch<bf16>(static_cast<const bf16*>(x_), lw, lb, w.y, M, D, st))) return e;
  if ((e = ln_launch<bf16>(static_cast<const bf16*>(cls_), lw, lb, w.y_cls, B, D, st))) return e;
  if ((e = wg_gemm<kEpiBf16>(w.y, qkv_w, qkv_b, nullptr, w.qkv, M, 3 * Dq, D, st))) return e;
  if ((e = wg_gemm<kEpiBf16>(w.y_cls, qkv_w, qkv_b, nullptr, w.qkv_cls, B, 3 * Dq, D, st)))
    return e;
  // sequence s = b*T + t: [cls row b, grid rows s*N + n for n < N]
  if ((e = tc_prefix_attn(hd, w.qkv, w.qkv_cls, w.a, w.a_cls, B * T, T, N, H,
                          1.0f / sqrtf((float)hd), st)))
    return e;
  if ((e = wg_gemm<kEpiBf16>(w.a, proj_w, nullptr, nullptr, out, M, D, Dq, st))) return e;
  return wg_gemm<kEpiBf16>(w.a_cls, proj_w, nullptr, nullptr, cls_rows, (long)B * T, D, Dq, st);
}

// x1 (B,T,N,D) f32, cls (B,1,D) bf16 -> out (B,T,N,D) bf16, or (f32, the
// mixed teacher's tier) cls f32 -> out f32; cls_rows (B,T,D) f32. ws: the
// bytes dvst_spatial_mlp_ws gives.
long dvst_spatial_mlp_ws(int B, int T, int N, int D, int Dh) {
  return (long)spatial_mlp_ws(nullptr, B, T, N, D, Dh).bytes;
}

int dvst_spatial_mlp(const void* x1_, const void* cls_, const void* ln1_w,
                     const void* ln1_b, const void* qkv_w, const void* qkv_b,
                     const void* proj_w, const void* proj_b, const void* ln2_w,
                     const void* ln2_b, const void* fc1_w, const void* fc1_b,
                     const void* fc2_w, const void* fc2_b, void* ws, void* out,
                     void* cls_rows, int B, int T, int N, int D, int H, int Dh,
                     int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)B * T * N;
  const float* x1 = static_cast<const float*>(x1_);
  const SpatialMlpWs w = spatial_mlp_ws(static_cast<char*>(ws), B, T, N, D, Dh);
  const float* l1w = static_cast<const float*>(ln1_w);
  const float* l1b = static_cast<const float*>(ln1_b);
  cudaError_t e;
  if ((e = ln_launch<float>(x1, l1w, l1b, w.y, M, D, st))) return e;
  // the CLS row's LN reads it in its own dtype (f32 in the mixed tier,
  // where it is f32 end to end)
  if (f32)
    e = ln_launch<float>(static_cast<const float*>(cls_), l1w, l1b, w.y_cls, B, D, st);
  else
    e = ln_launch<bf16>(static_cast<const bf16*>(cls_), l1w, l1b, w.y_cls, B, D, st);
  if (e) return e;
  if ((e = wg_gemm<kEpiBf16>(w.y, qkv_w, qkv_b, nullptr, w.qkv, M, 3 * D, D, st))) return e;
  if ((e = wg_gemm<kEpiBf16>(w.y_cls, qkv_w, qkv_b, nullptr, w.qkv_cls, B, 3 * D, D, st)))
    return e;
  // sequence s = b*T + t: [cls row b, grid rows s*N + n for n < N]
  const int hd = D / H;
  if ((e = tc_prefix_attn(hd, w.qkv, w.qkv_cls, w.a, w.a_cls, B * T, T, N, H,
                          1.0f / sqrtf((float)hd), st)))
    return e;
  if ((e = wg_gemm<kEpiResF32F32>(w.a, proj_w, proj_b, x1, w.x2, M, D, D, st))) return e;
  if ((e = wg_gemm<kEpiF32>(w.a_cls, proj_w, proj_b, nullptr, cls_rows, (long)B * T,
                            D, D, st)))
    return e;
  if ((e = ln_launch<float>(w.x2, static_cast<const float*>(ln2_w),
                            static_cast<const float*>(ln2_b), w.y, M, D, st)))
    return e;
  if ((e = wg_gemm<kEpiGeluBf16>(w.y, fc1_w, fc1_b, nullptr, w.hid, M, Dh, D, st))) return e;
  if (f32)  // the mixed tier's grid: x2 + MLP in f32
    return wg_gemm<kEpiResF32F32>(w.hid, fc2_w, fc2_b, w.x2, out, M, D, Dh, st);
  return wg_gemm<kEpiResF32Bf16>(w.hid, fc2_w, fc2_b, w.x2, out, M, D, Dh, st);
}

// The int8 tier: x1 (B,T,N,D) f32, cls (B,1,D) bf16 -> out (B,T,N,D) bf16,
// or (f32) cls f32 -> out f32; cls_rows (B,T,D) f32, with s8 weights (out,
// in) and their f32 scales. ws: the bytes dvst_spatial_mlp_q8_ws gives
// (the same layout for either tier).
long dvst_spatial_mlp_q8_ws(int B, int T, int N, int D, int Dh) {
  return (long)spatial_mlp_q8_ws(nullptr, B, T, N, D, Dh).bytes;
}

int dvst_spatial_mlp_q8(const void* x1_, const void* cls_, const void* ln1_w,
                        const void* ln1_b, const void* qkv_w, const void* qkv_s,
                        const void* qkv_b, const void* proj_w, const void* proj_s,
                        const void* proj_b, const void* ln2_w, const void* ln2_b,
                        const void* fc1_w, const void* fc1_s, const void* fc1_b,
                        const void* fc2_w, const void* fc2_s, const void* fc2_b, void* ws,
                        void* out, void* cls_rows, int B, int T, int N, int D, int H, int Dh,
                        int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)B * T * N;
  const float* x1 = static_cast<const float*>(x1_);
  const SpatialMlpQ8Ws w = spatial_mlp_q8_ws(static_cast<char*>(ws), B, T, N, D, Dh);
  const float* l1w = static_cast<const float*>(ln1_w);
  const float* l1b = static_cast<const float*>(ln1_b);
  cudaError_t e;
  if ((e = ln_quant_launch<float>(x1, l1w, l1b, w.q, w.sx, M, D, st))) return e;
  // the CLS row's LN reads it in its own dtype (f32 in the f32 tier)
  if (f32)
    e = ln_quant_launch<float>(static_cast<const float*>(cls_), l1w, l1b, w.q_cls, w.sx_cls, B,
                               D, st);
  else
    e = ln_quant_launch<bf16>(static_cast<const bf16*>(cls_), l1w, l1b, w.q_cls, w.sx_cls, B,
                              D, st);
  if (e) return e;
  if ((e = wg_gemm_s8<kEpiBf16>(w.q, w.sx, qkv_w, qkv_s, qkv_b, nullptr, w.qkv, M, 3 * D, D,
                                st)))
    return e;
  if ((e = wg_gemm_s8<kEpiBf16>(w.q_cls, w.sx_cls, qkv_w, qkv_s, qkv_b, nullptr, w.qkv_cls, B,
                                3 * D, D, st)))
    return e;
  // sequence s = b*T + t: [cls row b, grid rows s*N + n for n < N]
  const int hd = D / H;
  if ((e = tc_prefix_attn(hd, w.qkv, w.qkv_cls, w.a, w.a_cls, B * T, T, N, H,
                          1.0f / sqrtf((float)hd), st)))
    return e;
  if ((e = quant_rows_launch(w.a, w.q, w.sx, M, D, st))) return e;
  if ((e = wg_gemm_s8<kEpiResF32F32>(w.q, w.sx, proj_w, proj_s, proj_b, x1, w.x2, M, D, D, st)))
    return e;
  if ((e = quant_rows_launch(w.a_cls, w.q_cls, w.sx_cls, (long)B * T, D, st))) return e;
  if ((e = wg_gemm_s8<kEpiF32>(w.q_cls, w.sx_cls, proj_w, proj_s, proj_b, nullptr, cls_rows,
                               (long)B * T, D, D, st)))
    return e;
  if ((e = ln_quant_launch<float>(w.x2, static_cast<const float*>(ln2_w),
                                  static_cast<const float*>(ln2_b), w.q, w.sx, M, D, st)))
    return e;
  if ((e = wg_gemm_s8<kEpiGeluBf16>(w.q, w.sx, fc1_w, fc1_s, fc1_b, nullptr, w.hid, M, Dh, D,
                                    st)))
    return e;
  if ((e = quant_rows_launch(w.hid, w.q, w.sx, M, Dh, st))) return e;
  if (f32)  // the f32 tier's grid: x2 + MLP in f32
    return wg_gemm_s8<kEpiResF32F32>(w.q, w.sx, fc2_w, fc2_s, fc2_b, w.x2, out, M, D, Dh, st);
  return wg_gemm_s8<kEpiResF32Bf16>(w.q, w.sx, fc2_w, fc2_s, fc2_b, w.x2, out, M, D, Dh, st);
}

// x (M,D) bf16 or (x_f32) f32 -> out (M,D) in x's dtype = [x +]
// fc2(gelu(fc1(LN x))): bf16 rounds fc2's output before the residual add
// (the Pallas order), f32 adds it unrounded. ws: the bytes
// dvst_mlp_phase_ws gives.
long dvst_mlp_phase_ws(long M, int D, int Dh) { return (long)mlp_ws(nullptr, M, D, Dh).bytes; }

int dvst_mlp_phase(const void* x_, const void* ln_w, const void* ln_b,
                   const void* fc1_w, const void* fc1_b, const void* fc2_w,
                   const void* fc2_b, void* ws, void* out, long M, int D,
                   int Dh, int residual, int x_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MlpWs w = mlp_ws(static_cast<char*>(ws), M, D, Dh);
  const float* lw = static_cast<const float*>(ln_w);
  const float* lb = static_cast<const float*>(ln_b);
  cudaError_t e;
  if (x_f32)
    e = ln_launch<float>(static_cast<const float*>(x_), lw, lb, w.y, M, D, st);
  else
    e = ln_launch<bf16>(static_cast<const bf16*>(x_), lw, lb, w.y, M, D, st);
  if (e) return e;
  if ((e = wg_gemm<kEpiGeluBf16>(w.y, fc1_w, fc1_b, nullptr, w.hid, M, Dh, D, st))) return e;
  if (x_f32)  // the mixed tier: the residual in f32
    return residual ? wg_gemm<kEpiResF32F32>(w.hid, fc2_w, fc2_b, x_, out, M, D, Dh, st)
                    : wg_gemm<kEpiF32>(w.hid, fc2_w, fc2_b, nullptr, out, M, D, Dh, st);
  if (residual)
    return wg_gemm<kEpiAddBf16>(w.hid, fc2_w, fc2_b, x_, out, M, D, Dh, st);
  return wg_gemm<kEpiBf16>(w.hid, fc2_w, fc2_b, nullptr, out, M, D, Dh, st);
}

// x (S,L,D) bf16 -> out (S,L,D) bf16 = proj(MHSA(LN x)).
// ws: bf16 workspace of S*L*4*D elements.
int dvst_attn_phase(const void* x_, const void* ln_w, const void* ln_b,
                    const void* qkv_w, const void* qkv_b, const void* proj_w,
                    const void* proj_b, void* ws, void* out, int S, int L,
                    int D, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)S * L;
  const bf16* x = static_cast<const bf16*>(x_);
  bf16* qkv = static_cast<bf16*>(ws);  // (M, 3D)
  bf16* buf = qkv + M * 3 * D;          // (M, D): LN rows, then attention out
  cudaError_t e;
  if ((e = ln_launch<bf16>(x, static_cast<const float*>(ln_w),
                           static_cast<const float*>(ln_b), buf, M, D, st)))
    return e;
  if ((e = wg_gemm<kEpiBf16>(buf, qkv_w, qkv_b, nullptr, qkv, M, 3 * D, D, st))) return e;
  // sequence s: rows s*L + l, the tile at stride N = 1
  const int hd = D / H;
  if ((e = tc_strided_attn(hd, qkv, buf, S, L, 1, H, 1.0f / sqrtf((float)hd), st))) return e;
  return wg_gemm<kEpiBf16>(buf, proj_w, proj_b, nullptr, out, M, D, D, st);
}

// x (S,L,D) bf16 -> out (S,L,D) bf16 = bf16(x + bf16(fc(proj(MHSA(LN x))))).
// ws: the bytes dvst_temporal_phase_tm_ws(S, L, 1, D) gives.
int dvst_temporal_phase(const void* x, const void* ln_w, const void* ln_b,
                        const void* qkv_w, const void* qkv_b,
                        const void* proj_w, const void* proj_b,
                        const void* fc_w, const void* fc_b, void* ws, void* out,
                        int S, int L, int D, int H, void* stream) {
  return dvst_temporal_phase_tm(x, ln_w, ln_b, qkv_w, qkv_b, proj_w, proj_b,
                                fc_w, fc_b, ws, out, S, L, 1, D, H, 0, 1, stream);
}

// The spatial attention of dvst_spatial_mlp alone: qkv (S, N, 3D) grid
// rows and qkv_pre (S / S_lo, 3D) prefix rows, bf16 -> out (S, N, D) and,
// unless null, out_pre (S, D), at logit scale `scale`.
int dvst_spatial_attn(const void* qkv, const void* qkv_pre, void* out, void* out_pre,
                      int S, int S_lo, int N, int D, int H, float scale,
                      void* stream) {
  if (H <= 0 || D % H) return cudaErrorInvalidValue;
  return tc_prefix_attn(D / H, static_cast<const bf16*>(qkv),
                        static_cast<const bf16*>(qkv_pre), static_cast<bf16*>(out),
                        static_cast<bf16*>(out_pre), S, S_lo, N, H, scale,
                        static_cast<cudaStream_t>(stream));
}

// Dynamic shared bytes one block of the spatial attention needs at L rows.
long dvst_spatial_attn_smem(int L, int hd) { return (long)tc_prefix_smem(L, hd); }

// The temporal attention of dvst_temporal_phase_tm alone: qkv (B*T*N, 3D)
// bf16, sequence (b, n) the rows (b*T + t)*N + n -> out (B*T*N, D) bf16, at
// logit scale `scale`.
int dvst_temporal_attn(const void* qkv, void* out, int B, int T, int N, int D, int H,
                       float scale, void* stream) {
  if (H <= 0 || D % H) return cudaErrorInvalidValue;
  return tc_strided_attn(D / H, static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
                         B, T, N, H, scale, static_cast<cudaStream_t>(stream));
}

// Dynamic shared bytes one block of the temporal attention needs over S
// sequences of L rows.
long dvst_temporal_attn_smem(int S, int L, int hd) {
  return S <= 0 || L <= 0 ? 0 : (long)tc_smem(tc_group(S, L), L, hd);
}

// The wgmma GEMM alone: out = epi(A (M, K) . W (N, K)^T + bias), epi one
// of dvst_common.cuh's Epi.
int dvst_gemm(const void* A, const void* W, const void* bias, const void* res,
              void* out, long M, int N, int K, int epi, void* stream) {
  const bf16* a = static_cast<const bf16*>(A);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case kEpiBf16: return wg_gemm<kEpiBf16>(a, W, bias, res, out, M, N, K, st);
    case kEpiGeluBf16: return wg_gemm<kEpiGeluBf16>(a, W, bias, res, out, M, N, K, st);
    case kEpiResBf16F32: return wg_gemm<kEpiResBf16F32>(a, W, bias, res, out, M, N, K, st);
    case kEpiResF32F32: return wg_gemm<kEpiResF32F32>(a, W, bias, res, out, M, N, K, st);
    case kEpiF32: return wg_gemm<kEpiF32>(a, W, bias, res, out, M, N, K, st);
    case kEpiResF32Bf16: return wg_gemm<kEpiResF32Bf16>(a, W, bias, res, out, M, N, K, st);
    case kEpiAddBf16: return wg_gemm<kEpiAddBf16>(a, W, bias, res, out, M, N, K, st);
    default: return cudaErrorInvalidValue;
  }
}

// The int8 tier's blocks alone. The s8 GEMM: out = epi(f32(A (M, K) s8 .
// W (N, K)^T s8) * sx[row] * sw[col] + bias), epi one of the forwards'
// Epi (0-6).
int dvst_gemm_s8(const void* A, const void* sx, const void* W, const void* sw,
                 const void* bias, const void* res, void* out, long M, int N, int K, int epi,
                 void* stream) {
  const int8_t* a = static_cast<const int8_t*>(A);
  const float* s = static_cast<const float*>(sx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case kEpiBf16: return wg_gemm_s8<kEpiBf16>(a, s, W, sw, bias, res, out, M, N, K, st);
    case kEpiGeluBf16: return wg_gemm_s8<kEpiGeluBf16>(a, s, W, sw, bias, res, out, M, N, K, st);
    case kEpiResBf16F32:
      return wg_gemm_s8<kEpiResBf16F32>(a, s, W, sw, bias, res, out, M, N, K, st);
    case kEpiResF32F32:
      return wg_gemm_s8<kEpiResF32F32>(a, s, W, sw, bias, res, out, M, N, K, st);
    case kEpiF32: return wg_gemm_s8<kEpiF32>(a, s, W, sw, bias, res, out, M, N, K, st);
    case kEpiResF32Bf16:
      return wg_gemm_s8<kEpiResF32Bf16>(a, s, W, sw, bias, res, out, M, N, K, st);
    case kEpiAddBf16: return wg_gemm_s8<kEpiAddBf16>(a, s, W, sw, bias, res, out, M, N, K, st);
    default: return cudaErrorInvalidValue;
  }
}

// Bf16 rows (M, D) -> s8 codes (M, D) and f32 scales (M).
int dvst_quant_rows(const void* x, void* q, void* sx, long M, int D, void* stream) {
  return quant_rows_launch(static_cast<const bf16*>(x), static_cast<int8_t*>(q),
                           static_cast<float*>(sx), M, D, static_cast<cudaStream_t>(stream));
}

// LayerNorm of rows (M, D), bf16 or (x_f32) f32, rounded to bf16, then
// quantized: s8 codes (M, D) and f32 scales (M).
int dvst_ln_quant_rows(const void* x, const void* w, const void* b, void* q, void* sx, long M,
                       int D, int x_f32, void* stream) {
  const float* lw = static_cast<const float*>(w);
  const float* lb = static_cast<const float*>(b);
  int8_t* qq = static_cast<int8_t*>(q);
  float* s = static_cast<float*>(sx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32) return ln_quant_launch<float>(static_cast<const float*>(x), lw, lb, qq, s, M, D, st);
  return ln_quant_launch<bf16>(static_cast<const bf16*>(x), lw, lb, qq, s, M, D, st);
}

}  // extern "C"
