// Hopper (sm_90a) backward kernels of the per-phase training path: each
// recomputes its phase's forward from the saved inputs, then runs the
// backward (the Pallas kernels' recompute-in-kernel VJPs, as chains of
// launches on the caller's stream; the building blocks are in
// dvst_common.cuh, wgmma_gemm.cuh and tc_attention.cuh).
//
//   dvst_temporal_phase_tm_bwd  replaces _temporal_phase_tm_bwd_kernel
//       (dino_video_summarization_transformer_tpu/ops/fused_block.py:963):
//       x, dout (B,T,N,D) bf16 -> dx bf16, or (f32) x, dout f32 -> dx
//       f32; f32 dLN, dWqkv, dbqkv, dWproj, dbproj, dWfc, dbfc.
//       recompute: LN -> GEMM qkv -> strided attention -> GEMM proj, as
//       dvst_temporal_phase_tm runs them
//       backward: dWfc, dbfc -> dproj -> dWproj, dbproj -> da -> the
//       strided attention backward (tc_strided_attn_bwd) -> dWqkv, dbqkv ->
//       dy -> LN backward (+ dout)
//       Bound by operations: the Pallas cost estimate 3 * B*N*T*(10*D^2 +
//       4*T*D) is 4.5e11 FLOP at the training step's global crops (B=16,
//       T=8, N=196, D=768), 0.45 ms at the bf16 peak, against ~0.13 GB
//       moved (chip_smoke.py counts what these launches do: 4.2e11).
//   dvst_spatial_phase_bwd      replaces _spatial_phase_bwd_kernel
//       (ops/fused_block.py:430): x, cls, dgo (B,T,N,D), dco (B,T,D), all
//       bf16 or (f32) all f32 -> dx in x's dtype, dcls f32 (B,1,D) (the
//       CLS row's gradient summed over the T frames it joins) and f32 dLN,
//       dWqkv, dbqkv, dWproj, dbproj.
//       The per-frame CLS rows are B*T extra rows after the M grid rows in
//       every row buffer (their LN rows replicated), so each weight
//       gradient is one GEMM over M + B*T rows.
//       Bound by operations: the Pallas estimate 3 * B*T*L*(8*D^2 +
//       4*L*D) is 4.0e11 FLOP at the global crops, 0.41 ms (chip_smoke.py:
//       3.8e11).
//   dvst_mlp_phase_bwd          replaces _mlp_phase_bwd_kernel
//       (ops/fused_block.py:1233): x, do (M,D) bf16 or (f32) f32 -> dx in
//       x's dtype and f32 dLN, dW1, db1, dW2, db2; only the M real rows
//       enter the sums (the
//       Pallas kernel masks its ragged tail, :1254-1259).
//       recompute: LN -> GEMM fc1 + erf GELU (bf16) and its derivative (f32)
//       backward: dW2, db2 -> dh1 = bf16((do . W2) * gelu'(h1)) -> dW1, db1
//       -> dy -> LN backward (+ do)
//       Bound by operations: 10*M*D*Dh = 5.9e11 FLOP at the global grid
//       (M = 25,088), 0.60 ms.
//
// Design: the Pallas kernels carry f32 weight-gradient sums across a
// sequential grid; Hopper blocks run in no order. So every bf16 operand
// the Pallas kernels round (dproj, da, ds, dqkv, dh1, the recomputed LN
// rows and activations) is written to bf16 scratch, and each dW is a GEMM
// over the rows whose reduction is cut into splits, their f32 partials
// added in a fixed order by a second pass; bias, LN-scale and LN-bias sums
// go the same way. No float atomics: two calls give bit-identical
// gradients. The LN backward's dy stays f32, as in the Pallas kernels
// (:527-536, :1075-1085).
// * All three run every product on the wgmma + TMA GEMM (wgmma_gemm.cuh):
//   the recomputes as the forwards run them (row 9's fc1 with an epilogue
//   that writes both bf16 GELU and f32 GELU', so no separate pass reads
//   the f32 pre-activation back), dX = dY . W with the weight read as
//   stored (wg_gemm_dx, MN-major B), dW = dY^T . X with both operands read
//   as stored (wg_gemm_dw, MN-major A and B, split over the rows). Their
//   attention recomputes are the forwards' tiles (tc_strided_attn at
//   stride N for row 7, tc_prefix_attn with the CLS prefix for row 8), the
//   backwards the tile's backward over the same sequences
//   (tc_strided_attn_bwd, tc_prefix_attn_bwd; tc_attention.cuh): no L x L
//   matrix in memory. The LN backward is dvst_common.cuh's ln_bwd.
//
// The f32 tier of all three (the trainer's mixed tier: f32 activations and
// carries, bf16 matmul operands; the Pallas kernels on f32 x): the
// recompute's LN reads the f32 x (ln_kernel<float>); the incoming
// cotangent is read in f32 by one pass (cast_colsum) that writes its bf16
// copy, the operand of the products that read it, and sums the f32 values
// into the bias gradient of the layer it enters (dbfc, :1033; dbproj of
// row 8, :497; db2, :1276); the LN backward is ln_bwd<float>, which reads
// the f32 x and adds the f32 residual cotangent, and dx is stored in f32,
// never rounded (:1089-1090, :540-541, :1294-1297). Every other rounding
// is the bf16 tier's.
//
// Numerics: the XLA-path rules, not the TPU workarounds — the softmax
// subtracts its row max (no +/-80 clamp, so no |s| < 80 mask on ds), the
// GELU derivative is the exact erf one, and positions are not packed.

#define DVST_WITH_BACKWARD
#include "dvst_common.cuh"
#include "tc_attention.cuh"
#include "wgmma_gemm.cuh"

namespace {

size_t max3(size_t a, size_t b, size_t c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// f32 scratch of the wgmma backwards over `rows` rows: the split partials
// of the weight gradients (n_out, k_in) in dw[0 .. n_dw) (wg_dw_splits'
// choice on this device; kWgMaxSplits where the device cannot be asked),
// the column sums of at most max_cols columns, the LN backward's per-block
// sums.
size_t wg_part_floats(long rows, const int (*dw)[2], int n_dw, int max_cols, int D) {
  size_t n = max3(0, (size_t)colsum_splits(rows) * max_cols,
                  (size_t)ln_bwd_blocks(rows) * 2 * D);
  for (int i = 0; i < n_dw; ++i) {
    size_t p = 0;
    if (wg_dw_part_floats(rows, dw[i][0], dw[i][1], &p) != cudaSuccess)
      p = (size_t)kWgMaxSplits * dw[i][0] * dw[i][1];
    n = p > n ? p : n;
  }
  return n;
}

// The f32 tier's bf16 copy of the incoming cotangent (do16) is carved only
// in that tier.
struct TemporalWs {
  bf16 *y, *qkv, *a, *proj, *dproj, *da, *dqkv, *do16;
  float *dy, *part;
  size_t bytes;
};

TemporalWs temporal_ws(char* base, long M, int D, bool f32) {
  Carve c{base};
  TemporalWs w;
  const int dw[2][2] = {{D, D}, {3 * D, D}};  // dWfc and dWproj, dWqkv
  w.y = c.take<bf16>(M * D);
  w.qkv = c.take<bf16>(M * 3 * D);
  w.a = c.take<bf16>(M * D);
  w.proj = c.take<bf16>(M * D);
  w.dproj = c.take<bf16>(M * D);
  w.da = c.take<bf16>(M * D);
  w.dqkv = c.take<bf16>(M * 3 * D);
  w.dy = c.take<float>(M * D);
  w.part = c.take<float>(wg_part_floats(M, dw, 2, 3 * D, D));
  w.do16 = f32 ? c.take<bf16>(M * D) : nullptr;
  w.bytes = c.off;
  return w;
}

// Row buffers over R = M + B*T rows: the M grid rows, then the per-frame
// CLS rows (sequence s = b*T + t at row M + s).
struct SpatialWs {
  bf16 *y, *y_cls, *qkv, *a, *dproj, *da, *dqkv;
  float *dy, *dx_tail, *part;
  size_t bytes;
};

SpatialWs spatial_ws(char* base, long M, long Mc, int B, int D) {
  Carve c{base};
  SpatialWs w;
  const long R = M + Mc;
  const int dw[2][2] = {{D, D}, {3 * D, D}};
  w.y = c.take<bf16>(R * D);
  w.y_cls = c.take<bf16>((long)B * D);
  w.qkv = c.take<bf16>(R * 3 * D);
  w.a = c.take<bf16>(R * D);
  w.dproj = c.take<bf16>(R * D);
  w.da = c.take<bf16>(R * D);
  w.dqkv = c.take<bf16>(R * 3 * D);
  w.dy = c.take<float>(R * D);
  w.dx_tail = c.take<float>(Mc * D);
  w.part = c.take<float>(wg_part_floats(R, dw, 2, 3 * D, D));
  w.bytes = c.off;
  return w;
}

struct MlpWs {
  bf16 *y, *hg, *dh1, *do16;
  float *gp, *dy, *part;  // gp: gelu_erf'(h1), f32
  size_t bytes;
};

MlpWs mlp_ws(char* base, long M, int D, int Dh, bool f32) {
  Carve c{base};
  MlpWs w;
  const int dw[2][2] = {{D, Dh}, {Dh, D}};
  w.y = c.take<bf16>(M * D);
  w.hg = c.take<bf16>(M * Dh);
  w.dh1 = c.take<bf16>(M * Dh);
  w.gp = c.take<float>(M * Dh);
  w.dy = c.take<float>(M * D);
  w.part = c.take<float>(wg_part_floats(M, dw, 2, Dh, D));
  w.do16 = f32 ? c.take<bf16>(M * D) : nullptr;
  w.bytes = c.off;
  return w;
}

// LN rows of the M rows of x (bf16, or f32 in the f32 tier) into y.
cudaError_t ln_rows(const void* x, bool f32, const float* lw, const float* lb, bf16* y,
                    long M, int D, cudaStream_t st) {
  return f32 ? ln_launch<float>(static_cast<const float*>(x), lw, lb, y, M, D, st)
             : ln_launch<bf16>(static_cast<const bf16*>(x), lw, lb, y, M, D, st);
}

// The LN backward of the three, over x's type: dx = LN-backward + res.
cudaError_t ln_bwd_rows(const void* x, const void* x_tail, int tail_div, bool f32,
                        const float* dy, const float* lw, const void* res, void* dx,
                        float* dx_tail, long M, long R, int D, float* part, float* dgb,
                        cudaStream_t st) {
  if (f32)
    return ln_bwd<float>(static_cast<const float*>(x), static_cast<const float*>(x_tail),
                         tail_div, dy, lw, static_cast<const float*>(res),
                         static_cast<float*>(dx), dx_tail, M, R, D, part, dgb, st);
  return ln_bwd<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(x_tail), tail_div,
                      dy, lw, static_cast<const bf16*>(res), static_cast<bf16*>(dx), dx_tail,
                      M, R, D, part, dgb, st);
}

}  // namespace

extern "C" {

long dvst_temporal_phase_tm_bwd_ws(int B, int T, int N, int D, int H, int f32) {
  (void)H;
  return (long)temporal_ws(nullptr, (long)B * T * N, D, f32).bytes;
}

// x, dout (B,T,N,D) bf16 -> dx (B,T,N,D) bf16, or with f32 all three f32;
// dln f32 (2, D) (scale | bias); dqkv_w (3D, D), dqkv_b (3D), dproj_w (D,
// D), dproj_b (D), dfc_w (D, D), dfc_b (D), f32, (out, in) layout. ws: the
// bytes dvst_temporal_phase_tm_bwd_ws gives for the same f32.
int dvst_temporal_phase_tm_bwd(
    const void* x_, const void* dout_, const void* ln_w, const void* ln_b,
    const void* qkv_w, const void* qkv_b, const void* proj_w,
    const void* proj_b, const void* fc_w, const void* fc_b, void* ws,
    void* dx, void* dln, void* dqkv_w, void* dqkv_b, void* dproj_w,
    void* dproj_b, void* dfc_w, void* dfc_b, int B, int T, int N, int D,
    int H, int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)B * T * N;
  const bf16* Wqkv = static_cast<const bf16*>(qkv_w);
  const bf16* Wproj = static_cast<const bf16*>(proj_w);
  const bf16* Wfc = static_cast<const bf16*>(fc_w);
  const float* lw = static_cast<const float*>(ln_w);
  const TemporalWs w = temporal_ws(static_cast<char*>(ws), M, D, f32);
  const int hd = D / H;
  const float scale = 1.0f / sqrtf((float)hd);
  cudaError_t e;
  // recompute the forward up to proj, as dvst_temporal_phase_tm runs it
  if ((e = ln_rows(x_, f32, lw, static_cast<const float*>(ln_b), w.y, M, D, st))) return e;
  if ((e = wg_gemm<kEpiBf16>(w.y, Wqkv, qkv_b, nullptr, w.qkv, M, 3 * D, D, st))) return e;
  // sequence (b, n) over t: rows (b*T + t)*N + n
  if ((e = tc_strided_attn(hd, w.qkv, w.a, B, T, N, H, scale, st))) return e;
  if ((e = wg_gemm<kEpiBf16>(w.a, Wproj, proj_b, nullptr, w.proj, M, D, D, st))) return e;
  // temporal_fc: dbfc from the cotangent as read (f32 in the f32 tier),
  // dWfc and dproj from its bf16 copy
  const bf16* dout = static_cast<const bf16*>(dout_);
  if (f32) {
    if ((e = cast_colsum(static_cast<const float*>(dout_), M, nullptr, M, D, w.do16, w.part,
                         static_cast<float*>(dfc_b), st)))
      return e;
    dout = w.do16;
  }
  if ((e = wg_gemm_dw(dout, w.proj, static_cast<float*>(dfc_w), w.part, M, D, D, st))) return e;
  if (!f32 && (e = colsum<bf16>(dout, M, D, w.part, static_cast<float*>(dfc_b), st))) return e;
  if ((e = wg_gemm_dx<kEpiBf16>(dout, Wfc, nullptr, w.dproj, M, D, D, st))) return e;
  // proj
  if ((e = wg_gemm_dw(w.dproj, w.a, static_cast<float*>(dproj_w), w.part, M, D, D, st))) return e;
  if ((e = colsum<bf16>(w.dproj, M, D, w.part, static_cast<float*>(dproj_b), st))) return e;
  if ((e = wg_gemm_dx<kEpiBf16>(w.dproj, Wproj, nullptr, w.da, M, D, D, st))) return e;
  // attention, over the same sequences at stride N
  if ((e = tc_strided_attn_bwd(hd, w.qkv, w.da, w.dqkv, B, T, N, H, scale, st))) return e;
  // qkv
  if ((e = wg_gemm_dw(w.dqkv, w.y, static_cast<float*>(dqkv_w), w.part, M, 3 * D, D, st)))
    return e;
  if ((e = colsum<bf16>(w.dqkv, M, 3 * D, w.part, static_cast<float*>(dqkv_b), st))) return e;
  if ((e = wg_gemm_dx<kEpiF32>(w.dqkv, Wqkv, nullptr, w.dy, M, D, 3 * D, st))) return e;
  // LN, + the residual's dout (as read)
  return ln_bwd_rows(x_, nullptr, 1, f32, w.dy, lw, dout_, dx, nullptr, M, M, D, w.part,
                     static_cast<float*>(dln), st);
}

long dvst_spatial_phase_bwd_ws(int B, int T, int N, int D, int H, int f32) {
  (void)H;
  (void)f32;  // the f32 tier's cotangent copy is the dproj rows the bf16 tier fills
  return (long)spatial_ws(nullptr, (long)B * T * N, (long)B * T, B, D).bytes;
}

// x (B,T,N,D), cls (B,1,D), dgo (B,T,N,D), dco (B,T,D) bf16 -> dx (B,T,N,D)
// bf16, or with f32 all five f32; dcls (B,1,D) f32; dln f32 (2, D); dqkv_w
// (3D, D), dqkv_b (3D), dproj_w (D, D), dproj_b (D) f32. ws:
// dvst_spatial_phase_bwd_ws bytes.
int dvst_spatial_phase_bwd(const void* x_, const void* cls_, const void* dgo_,
                           const void* dco_, const void* ln_w,
                           const void* ln_b, const void* qkv_w,
                           const void* qkv_b, const void* proj_w,
                           const void* proj_b, void* ws, void* dx, void* dcls,
                           void* dln, void* dqkv_w, void* dqkv_b,
                           void* dproj_w, void* dproj_b, int B, int T, int N,
                           int D, int H, int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)B * T * N, Mc = (long)B * T, R = M + Mc;
  const bf16* Wqkv = static_cast<const bf16*>(qkv_w);
  const bf16* Wproj = static_cast<const bf16*>(proj_w);
  const float* lw = static_cast<const float*>(ln_w);
  const float* lb = static_cast<const float*>(ln_b);
  const SpatialWs w = spatial_ws(static_cast<char*>(ws), M, Mc, B, D);
  const int hd = D / H;
  const float scale = 1.0f / sqrtf((float)hd);
  cudaError_t e;
  // recompute: LN rows of the grid, then of the CLS replicated per frame;
  // qkv over all R rows (the CLS rows are sequence s's prefix at M + s)
  if ((e = ln_rows(x_, f32, lw, lb, w.y, M, D, st))) return e;
  if ((e = ln_rows(cls_, f32, lw, lb, w.y_cls, B, D, st))) return e;
  rep_rows_kernel<<<ew_blocks(Mc * D), 256, 0, st>>>(w.y_cls, w.y + M * D, T,
                                                     D, B);
  if ((e = cudaGetLastError())) return e;
  if ((e = wg_gemm<kEpiBf16>(w.y, Wqkv, qkv_b, nullptr, w.qkv, R, 3 * D, D, st))) return e;
  // sequence s = b*T + t: [row M + s, grid rows s*N + n]; CLS outputs at M + s
  if ((e = tc_prefix_attn(hd, w.qkv, w.qkv + M * 3 * D, w.a, w.a + M * D, (int)Mc, 1, N, H,
                          scale, st)))
    return e;
  // proj: the cotangent rows are [dgo; dco] (bf16; in the f32 tier their
  // bf16 copy, dbproj summed from the f32 rows)
  if (f32) {
    if ((e = cast_colsum(static_cast<const float*>(dgo_), M, static_cast<const float*>(dco_),
                         R, D, w.dproj, w.part, static_cast<float*>(dproj_b), st)))
      return e;
  } else {
    if ((e = cudaMemcpyAsync(w.dproj, dgo_, (size_t)M * D * sizeof(bf16),
                             cudaMemcpyDeviceToDevice, st)))
      return e;
    if ((e = cudaMemcpyAsync(w.dproj + M * D, dco_, (size_t)Mc * D * sizeof(bf16),
                             cudaMemcpyDeviceToDevice, st)))
      return e;
  }
  if ((e = wg_gemm_dw(w.dproj, w.a, static_cast<float*>(dproj_w), w.part, R, D, D, st)))
    return e;
  if (!f32 &&
      (e = colsum<bf16>(w.dproj, R, D, w.part, static_cast<float*>(dproj_b), st)))
    return e;
  if ((e = wg_gemm_dx<kEpiBf16>(w.dproj, Wproj, nullptr, w.da, R, D, D, st))) return e;
  // attention: the CLS row's dq/dk/dv per frame go to rows M + (b*T + t)
  if ((e = tc_prefix_attn_bwd(hd, w.qkv, w.qkv + M * 3 * D, w.da, w.da + M * D, w.dqkv,
                              w.dqkv + M * 3 * D, (int)Mc, 1, N, H, scale, st)))
    return e;
  // qkv
  if ((e = wg_gemm_dw(w.dqkv, w.y, static_cast<float*>(dqkv_w), w.part, R, 3 * D, D, st)))
    return e;
  if ((e = colsum<bf16>(w.dqkv, R, 3 * D, w.part, static_cast<float*>(dqkv_b), st))) return e;
  if ((e = wg_gemm_dx<kEpiF32>(w.dqkv, Wqkv, nullptr, w.dy, R, D, 3 * D, st))) return e;
  // LN: grid rows + dgo -> dx; CLS rows -> per-frame f32, summed over T
  if ((e = ln_bwd_rows(x_, cls_, T, f32, w.dy, lw, dgo_, dx, w.dx_tail, M, R, D, w.part,
                       static_cast<float*>(dln), st)))
    return e;
  sum_groups_kernel<<<ew_blocks((long)B * D), 256, 0, st>>>(
      w.dx_tail, T, D, B, static_cast<float*>(dcls));
  return cudaGetLastError();
}

long dvst_mlp_phase_bwd_ws(long M, int D, int Dh, int f32) {
  return (long)mlp_ws(nullptr, M, D, Dh, f32).bytes;
}

// x, do (M,D) bf16 -> dx (M,D) bf16 (+ do when residual), or with f32 all
// three f32; dln f32 (2, D); dfc1_w (Dh, D), dfc1_b (Dh), dfc2_w (D, Dh),
// dfc2_b (D) f32. ws: dvst_mlp_phase_bwd_ws bytes for the same f32.
int dvst_mlp_phase_bwd(const void* x_, const void* do_, const void* ln_w,
                       const void* ln_b, const void* fc1_w, const void* fc1_b,
                       const void* fc2_w, const void* fc2_b, void* ws,
                       void* dx, void* dln, void* dfc1_w, void* dfc1_b,
                       void* dfc2_w, void* dfc2_b, long M, int D, int Dh,
                       int residual, int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* W1 = static_cast<const bf16*>(fc1_w);
  const bf16* W2 = static_cast<const bf16*>(fc2_w);
  const float* lw = static_cast<const float*>(ln_w);
  const MlpWs w = mlp_ws(static_cast<char*>(ws), M, D, Dh, f32);
  cudaError_t e;
  if ((e = ln_rows(x_, f32, lw, static_cast<const float*>(ln_b), w.y, M, D, st))) return e;
  // fc1: hg = bf16(gelu(h1)) and gp = gelu'(h1) from the f32 accumulator
  if ((e = wg_gemm<kEpiGeluBf16GradF32>(w.y, W1, fc1_b, w.gp, w.hg, M, Dh, D, st))) return e;
  // fc2: db2 from the cotangent as read (f32 in the f32 tier), dW2 and dh1
  // from its bf16 copy
  const bf16* dout = static_cast<const bf16*>(do_);
  if (f32) {
    if ((e = cast_colsum(static_cast<const float*>(do_), M, nullptr, M, D, w.do16, w.part,
                         static_cast<float*>(dfc2_b), st)))
      return e;
    dout = w.do16;
  }
  if ((e = wg_gemm_dw(dout, w.hg, static_cast<float*>(dfc2_w), w.part, M, D, Dh, st))) return e;
  if (!f32 && (e = colsum<bf16>(dout, M, D, w.part, static_cast<float*>(dfc2_b), st))) return e;
  // dh1 = bf16((do . W2) * gelu'(h1)), both factors f32
  if ((e = wg_gemm_dx<kEpiMulF32Bf16>(dout, W2, w.gp, w.dh1, M, Dh, D, st))) return e;
  // fc1
  if ((e = wg_gemm_dw(w.dh1, w.y, static_cast<float*>(dfc1_w), w.part, M, Dh, D, st))) return e;
  if ((e = colsum<bf16>(w.dh1, M, Dh, w.part, static_cast<float*>(dfc1_b), st))) return e;
  if ((e = wg_gemm_dx<kEpiF32>(w.dh1, W1, nullptr, w.dy, M, D, Dh, st))) return e;
  return ln_bwd_rows(x_, nullptr, 1, f32, w.dy, lw, residual ? do_ : nullptr, dx, nullptr, M,
                     M, D, w.part, static_cast<float*>(dln), st);
}

// The building blocks of the three alone, for the card tests and
// chip_smoke.py.

// The attention backward tile: qkv (S*N, 3D) and qkv_pre (S / S_lo, 3D),
// da (S*N, D) and da_pre (S, D) bf16 -> dqkv (S*N, 3D), dqkv_pre (S, 3D)
// bf16, at logit scale `scale`.
int dvst_spatial_attn_bwd(const void* qkv, const void* qkv_pre, const void* da,
                          const void* da_pre, void* dqkv, void* dqkv_pre, int S, int S_lo,
                          int N, int D, int H, float scale, void* stream) {
  if (H <= 0 || D % H) return cudaErrorInvalidValue;
  return tc_prefix_attn_bwd(D / H, static_cast<const bf16*>(qkv),
                            static_cast<const bf16*>(qkv_pre), static_cast<const bf16*>(da),
                            static_cast<const bf16*>(da_pre), static_cast<bf16*>(dqkv),
                            static_cast<bf16*>(dqkv_pre), S, S_lo, N, H, scale,
                            static_cast<cudaStream_t>(stream));
}

// Dynamic shared bytes one block of the attention backward needs at L rows.
long dvst_spatial_attn_bwd_smem(int L, int hd) { return (long)tc_prefix_bwd_smem(L, hd); }

// The attention backward of dvst_temporal_phase_tm_bwd alone: qkv (B*T*N,
// 3D) and da (B*T*N, D) bf16, sequence (b, n) the rows (b*T + t)*N + n ->
// dqkv (B*T*N, 3D) bf16 (dq | dk | dv), at logit scale `scale`.
int dvst_temporal_attn_bwd(const void* qkv, const void* da, void* dqkv, int B, int T, int N,
                           int D, int H, float scale, void* stream) {
  if (H <= 0 || D % H) return cudaErrorInvalidValue;
  return tc_strided_attn_bwd(D / H, static_cast<const bf16*>(qkv), static_cast<const bf16*>(da),
                             static_cast<bf16*>(dqkv), B, T, N, H, scale,
                             static_cast<cudaStream_t>(stream));
}

// Dynamic shared bytes one block of the temporal attention backward needs
// over S sequences of L rows.
long dvst_temporal_attn_bwd_smem(int S, int L, int hd) {
  return S <= 0 || L <= 0 ? 0 : (long)tc_bwd_smem(tc_group(S, L), L, hd);
}

// The LayerNorm backward of the three alone: x (M, D) bf16 and, for the R
// - M tail rows, x_tail ((R - M) / tail_div, D) bf16 (null when R == M);
// dy (R, D) f32, w (D) f32, res (M, D) bf16 or null -> dx (M, D) bf16 =
// bf16(dx + res), dx_tail (R - M, D) f32, dgb (2, D) f32 (scale | bias);
// with f32, x, x_tail, res and dx f32 (dx = dx + res, unrounded). part:
// the bytes dvst_layer_norm_bwd_ws gives.
int dvst_layer_norm_bwd(const void* x, const void* x_tail, const void* dy, const void* w,
                        const void* res, void* dx, void* dx_tail, void* part, void* dgb,
                        long M, long R, int D, int tail_div, int f32, void* stream) {
  if (M < 0 || R < M || tail_div <= 0) return cudaErrorInvalidValue;
  return ln_bwd_rows(x, x_tail, tail_div, f32, static_cast<const float*>(dy),
                     static_cast<const float*>(w), res, dx, static_cast<float*>(dx_tail), M, R,
                     D, static_cast<float*>(part), static_cast<float*>(dgb),
                     static_cast<cudaStream_t>(stream));
}

long dvst_layer_norm_bwd_ws(long R, int D) {
  return (long)(ln_bwd_blocks(R) * 2 * D * sizeof(float));
}

// dX = epi(dY (M, K) . W (K, N)): epi kEpiBf16, kEpiF32, or
// kEpiMulF32Bf16 with aux (M, N) f32.
int dvst_gemm_dx(const void* dY, const void* W, const void* aux, void* out, long M, int N,
                 int K, int epi, void* stream) {
  const bf16* a = static_cast<const bf16*>(dY);
  const bf16* w = static_cast<const bf16*>(W);
  const float* x = static_cast<const float*>(aux);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case kEpiBf16: return wg_gemm_dx<kEpiBf16>(a, w, x, out, M, N, K, st);
    case kEpiF32: return wg_gemm_dx<kEpiF32>(a, w, x, out, M, N, K, st);
    case kEpiMulF32Bf16: return wg_gemm_dx<kEpiMulF32Bf16>(a, w, x, out, M, N, K, st);
    default: return cudaErrorInvalidValue;
  }
}

// dW (n_out, k_in) f32 = dY (rows, n_out)^T . X (rows, k_in); part: the
// bytes dvst_gemm_dw_ws gives.
int dvst_gemm_dw(const void* dY, const void* X, void* out, void* part, long rows, int n_out,
                 int k_in, void* stream) {
  return wg_gemm_dw(static_cast<const bf16*>(dY), static_cast<const bf16*>(X),
                    static_cast<float*>(out), static_cast<float*>(part), rows, n_out, k_in,
                    static_cast<cudaStream_t>(stream));
}

// Bytes of split partials dvst_gemm_dw needs (-1 if the device cannot be
// asked), and the split count it takes.
long dvst_gemm_dw_ws(long rows, int n_out, int k_in) {
  size_t n = 0;
  return wg_dw_part_floats(rows, n_out, k_in, &n) == cudaSuccess ? (long)(n * sizeof(float))
                                                                 : -1;
}

int dvst_gemm_dw_splits(long rows, int n_out, int k_in) {
  int sms = 0, kchunk = 0;
  if (wg_sms(&sms) != cudaSuccess || rows <= 0) return rows <= 0 ? 1 : -1;
  return wg_dw_splits(rows, n_out, k_in, sms, &kchunk);
}

// Row 9's fc1 recompute alone: hg (M, N) bf16 = bf16(gelu_erf(A . W^T +
// bias)) and gp (M, N) f32 = gelu_erf'(A . W^T + bias), W (N, K).
int dvst_gemm_gelu_grad(const void* A, const void* W, const void* bias, void* hg, void* gp,
                        long M, int N, int K, void* stream) {
  return wg_gemm<kEpiGeluBf16GradF32>(static_cast<const bf16*>(A), W, bias, gp, hg, M, N, K,
                                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
