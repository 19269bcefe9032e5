// Hopper (sm_90a) kernels for the whole-block divided space-time pair, the
// per-phase spatial half, the row-wise MLP phase and the XLA-layout
// block's two attention phases (forwards; the backwards are in
// fused_block_bwd.cu).
//
// Six C entry points, each a short chain of launches on the caller's
// stream (the building blocks are in dvst_common.cuh):
//
//   dvst_temporal_phase_tm  replaces _temporal_phase_tm_kernel
//       (dino_video_summarization_transformer_tpu/ops/fused_block.py:761):
//       x (B,T,N,D) bf16 -> x + fc(proj(MHSA over T at each position(LN x)))
//       in two tiers: f32 out (the whole-block path's carry) or, with
//       out_bf16, bf16 out = bf16(x + bf16(fc)) (the per-phase training
//       path, the Pallas kernel's rounding at fused_block.py:855-857)
//       launches: LN -> GEMM qkv -> attention -> GEMM proj -> GEMM fc+res
//       Its GEMMs are the wgmma + TMA kernel (wgmma_gemm.cuh), its
//       attention the tensor-core tile reading the T rows of each
//       sequence at stride N straight from the qkv buffer (tc_attention.cuh's
//       tc_strided_attn).
//   dvst_spatial_phase      replaces _spatial_phase_kernel
//       (ops/fused_block.py:287): per frame on [cls, x_t]: LN -> MHSA ->
//       proj; grid out = bf16(x + bf16(proj)), raw per-frame CLS rows bf16
//       launches: LN grid, LN cls -> GEMM qkv grid, GEMM qkv cls ->
//       attention -> GEMM proj+res grid, GEMM proj cls
//       Bound by operations: at the training step's global crops (B=16,
//       T=8, N=196, D=768) B*T*L*(8*D^2 + 4*L*D) = 1.34e11 FLOP (the
//       Pallas cost estimate) against 0.1 GB of rows, 0.136 ms at the
//       bf16 peak. The design is the first half of dvst_spatial_mlp: its
//       GEMMs the wgmma + TMA kernel, its attention the tensor-core tile
//       with the CLS row as prefix key (tc_prefix_attn, one CLS row per
//       clip read for all its frames, so no per-frame copy is built).
//   dvst_spatial_mlp        replaces _spatial_mlp_kernel
//       (ops/fused_block.py:1556, float tier):
//       per frame on [cls, x_t]: LN -> MHSA -> proj -> grid residual -> LN ->
//       MLP -> residual; bf16 grid out + f32 per-frame CLS rows
//       launches: LN grid, LN cls -> GEMM qkv grid, GEMM qkv cls ->
//       attention -> GEMM proj+res grid, GEMM proj cls -> LN ->
//       GEMM fc1+GELU -> GEMM fc2+res
//       Its GEMMs are the wgmma + TMA kernel (wgmma_gemm.cuh), its
//       attention the tensor-core tile with the CLS row as prefix key
//       (tc_attention.cuh's tc_prefix_attn).
//   dvst_mlp_phase          replaces _mlp_phase_kernel
//       (ops/fused_block.py:1191): rows (M,D) bf16 -> LN -> fc1 -> erf GELU
//       -> fc2, optionally + x, bf16 out; fc2's output is rounded to bf16
//       before the residual add, as the Pallas kernel rounds it
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

// dvst_spatial_phase's workspace: the LN rows, qkv and attention output of
// the M grid rows, of the B CLS rows, and the B*T per-frame CLS attention
// outputs, each 256-byte aligned (Carve): every TMA operand starts 16-byte
// aligned.
struct SpatialPhaseWs {
  bf16 *y, *qkv, *a, *y_cls, *qkv_cls, *a_cls;
  size_t bytes;
};

SpatialPhaseWs spatial_phase_ws(char* base, int B, int T, int N, int D) {
  const long M = (long)B * T * N;
  Carve c{base};
  SpatialPhaseWs w;
  w.y = c.take<bf16>(M * D);
  w.qkv = c.take<bf16>(M * 3 * D);
  w.a = c.take<bf16>(M * D);
  w.y_cls = c.take<bf16>((long)B * D);
  w.qkv_cls = c.take<bf16>((long)B * 3 * D);
  w.a_cls = c.take<bf16>((long)B * T * D);
  w.bytes = c.off;
  return w;
}

}  // namespace

extern "C" {

const char* dvst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B,T,N,D) bf16 frame-major -> out (B,T,N,D), f32 or (out_bf16) bf16.
// ws: bf16 workspace of B*T*N*5*D elements.
int dvst_temporal_phase_tm(const void* x_, const void* ln_w, const void* ln_b,
                           const void* qkv_w, const void* qkv_b,
                           const void* proj_w, const void* proj_b,
                           const void* fc_w, const void* fc_b, void* ws,
                           void* out, int B, int T, int N, int D, int H,
                           int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)B * T * N;
  const bf16* x = static_cast<const bf16*>(x_);
  bf16* qkv = static_cast<bf16*>(ws);   // (M, 3D)
  bf16* buf1 = qkv + M * 3 * D;          // (M, D): LN rows, then proj out
  bf16* buf2 = buf1 + M * D;             // (M, D): attention out
  const float* lw = static_cast<const float*>(ln_w);
  const float* lb = static_cast<const float*>(ln_b);
  cudaError_t e;
  if ((e = ln_launch<bf16>(x, lw, lb, buf1, M, D, st))) return e;
  if ((e = wg_gemm<kEpiBf16>(buf1, qkv_w, qkv_b, nullptr, qkv, M, 3 * D, D, st))) return e;
  // sequence (b, n) over t: rows (b*T + t)*N + n
  const int hd = D / H;
  if ((e = tc_strided_attn(hd, qkv, buf2, B, T, N, H, 1.0f / sqrtf((float)hd), st)))
    return e;
  if ((e = wg_gemm<kEpiBf16>(buf2, proj_w, proj_b, nullptr, buf1, M, D, D, st))) return e;
  if (out_bf16)
    e = wg_gemm<kEpiAddBf16>(buf1, fc_w, fc_b, x, out, M, D, D, st);
  else
    e = wg_gemm<kEpiResBf16F32>(buf1, fc_w, fc_b, x, out, M, D, D, st);
  return e;
}

// x (B,T,N,D) bf16, cls (B,1,D) bf16 -> out (B,T,N,D) bf16 =
// bf16(x + bf16(proj)) or, with out_f32, f32 x + proj (the branch
// unrounded: the card's checks hold the branch through this tier of the
// same launches), cls_rows (B,T,D) bf16. ws: the bytes
// dvst_spatial_phase_ws gives.
long dvst_spatial_phase_ws(int B, int T, int N, int D) {
  return (long)spatial_phase_ws(nullptr, B, T, N, D).bytes;
}

int dvst_spatial_phase(const void* x_, const void* cls_, const void* ln_w,
                       const void* ln_b, const void* qkv_w, const void* qkv_b,
                       const void* proj_w, const void* proj_b, void* ws,
                       void* out, void* cls_rows, int B, int T, int N, int D,
                       int H, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)B * T * N;
  const bf16* x = static_cast<const bf16*>(x_);
  const SpatialPhaseWs w = spatial_phase_ws(static_cast<char*>(ws), B, T, N, D);
  const float* lw = static_cast<const float*>(ln_w);
  const float* lb = static_cast<const float*>(ln_b);
  const int hd = D / H;
  cudaError_t e;
  if ((e = ln_launch<bf16>(x, lw, lb, w.y, M, D, st))) return e;
  if ((e = ln_launch<bf16>(static_cast<const bf16*>(cls_), lw, lb, w.y_cls, B, D, st))) return e;
  if ((e = wg_gemm<kEpiBf16>(w.y, qkv_w, qkv_b, nullptr, w.qkv, M, 3 * D, D, st))) return e;
  if ((e = wg_gemm<kEpiBf16>(w.y_cls, qkv_w, qkv_b, nullptr, w.qkv_cls, B, 3 * D, D, st)))
    return e;
  // sequence s = b*T + t: [cls row b, grid rows s*N + n for n < N]
  if ((e = tc_prefix_attn(hd, w.qkv, w.qkv_cls, w.a, w.a_cls, B * T, T, N, H,
                          1.0f / sqrtf((float)hd), st)))
    return e;
  e = out_f32 ? wg_gemm<kEpiResBf16F32>(w.a, proj_w, proj_b, x, out, M, D, D, st)
              : wg_gemm<kEpiAddBf16>(w.a, proj_w, proj_b, x, out, M, D, D, st);
  if (e) return e;
  return wg_gemm<kEpiBf16>(w.a_cls, proj_w, proj_b, nullptr, cls_rows, (long)B * T, D, D, st);
}

// x1 (B,T,N,D) f32, cls (B,1,D) bf16 -> out (B,T,N,D) bf16,
// cls_rows (B,T,D) f32. ws: bf16 workspace of
// B*T*N*(5*D + Dh) + 4*B*D + B*T*D elements; x2: f32 (B*T*N, D).
int dvst_spatial_mlp(const void* x1_, const void* cls_, const void* ln1_w,
                     const void* ln1_b, const void* qkv_w, const void* qkv_b,
                     const void* proj_w, const void* proj_b, const void* ln2_w,
                     const void* ln2_b, const void* fc1_w, const void* fc1_b,
                     const void* fc2_w, const void* fc2_b, void* ws, void* x2_,
                     void* out, void* cls_rows, int B, int T, int N, int D,
                     int H, int Dh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)B * T * N;
  const float* x1 = static_cast<const float*>(x1_);
  const bf16* cls = static_cast<const bf16*>(cls_);
  float* x2 = static_cast<float*>(x2_);
  bf16* y = static_cast<bf16*>(ws);  // (M, D): LN1 rows, then LN2 rows
  bf16* qkv = y + M * D;              // (M, 3D)
  bf16* a = qkv + M * 3 * D;          // (M, D)
  bf16* hid = a + M * D;              // (M, Dh)
  bf16* y_cls = hid + M * Dh;         // (B, D)
  bf16* qkv_cls = y_cls + (long)B * D;      // (B, 3D)
  bf16* a_cls = qkv_cls + (long)B * 3 * D;  // (B*T, D)
  const float* l1w = static_cast<const float*>(ln1_w);
  const float* l1b = static_cast<const float*>(ln1_b);
  cudaError_t e;
  if ((e = ln_launch<float>(x1, l1w, l1b, y, M, D, st))) return e;
  if ((e = ln_launch<bf16>(cls, l1w, l1b, y_cls, B, D, st))) return e;
  if ((e = wg_gemm<kEpiBf16>(y, qkv_w, qkv_b, nullptr, qkv, M, 3 * D, D, st))) return e;
  if ((e = wg_gemm<kEpiBf16>(y_cls, qkv_w, qkv_b, nullptr, qkv_cls, B, 3 * D, D, st)))
    return e;
  // sequence s = b*T + t: [cls row b, grid rows s*N + n for n < N]
  const int hd = D / H;
  if ((e = tc_prefix_attn(hd, qkv, qkv_cls, a, a_cls, B * T, T, N, H,
                          1.0f / sqrtf((float)hd), st)))
    return e;
  if ((e = wg_gemm<kEpiResF32F32>(a, proj_w, proj_b, x1, x2, M, D, D, st))) return e;
  if ((e = wg_gemm<kEpiF32>(a_cls, proj_w, proj_b, nullptr, cls_rows, (long)B * T,
                            D, D, st)))
    return e;
  if ((e = ln_launch<float>(x2, static_cast<const float*>(ln2_w),
                            static_cast<const float*>(ln2_b), y, M, D, st)))
    return e;
  if ((e = wg_gemm<kEpiGeluBf16>(y, fc1_w, fc1_b, nullptr, hid, M, Dh, D, st))) return e;
  if ((e = wg_gemm<kEpiResF32Bf16>(hid, fc2_w, fc2_b, x2, out, M, D, Dh, st))) return e;
  return cudaSuccess;
}

// x (M,D) bf16 -> out (M,D) bf16 = [x +] fc2(gelu(fc1(LN x))).
// ws: bf16 workspace of M*(D + Dh) elements.
int dvst_mlp_phase(const void* x_, const void* ln_w, const void* ln_b,
                   const void* fc1_w, const void* fc1_b, const void* fc2_w,
                   const void* fc2_b, void* ws, void* out, long M, int D,
                   int Dh, int residual, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(x_);
  bf16* y = static_cast<bf16*>(ws);  // (M, D)
  bf16* hid = y + M * D;              // (M, Dh)
  cudaError_t e;
  if ((e = ln_launch<bf16>(x, static_cast<const float*>(ln_w),
                           static_cast<const float*>(ln_b), y, M, D, st)))
    return e;
  if ((e = wg_gemm<kEpiGeluBf16>(y, fc1_w, fc1_b, nullptr, hid, M, Dh, D, st))) return e;
  if (residual)
    e = wg_gemm<kEpiAddBf16>(hid, fc2_w, fc2_b, x, out, M, D, Dh, st);
  else
    e = wg_gemm<kEpiBf16>(hid, fc2_w, fc2_b, nullptr, out, M, D, Dh, st);
  return e;
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
// ws: bf16 workspace of S*L*5*D elements.
int dvst_temporal_phase(const void* x, const void* ln_w, const void* ln_b,
                        const void* qkv_w, const void* qkv_b,
                        const void* proj_w, const void* proj_b,
                        const void* fc_w, const void* fc_b, void* ws, void* out,
                        int S, int L, int D, int H, void* stream) {
  return dvst_temporal_phase_tm(x, ln_w, ln_b, qkv_w, qkv_b, proj_w, proj_b,
                                fc_w, fc_b, ws, out, S, L, 1, D, H, 1, stream);
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

}  // extern "C"
