// Hopper (sm_90a) kernel for the standalone attention of the attention
// swap (TimeSformerConfig.attention_kernel: the plain inference block's
// MHSA with its softmax(q k^T) v in one kernel).
//
//   dvst_fused_attention  replaces _attn_kernel
//       (dino_video_summarization_transformer_tpu/ops/attention.py:42):
//       q, k, v (BH, L, hd) -> out (BH, L, hd) = softmax(q k^T * scale) v
//       over BH independent sequences, bf16 (dtype 0) or f32 (dtype 1),
//       out in the input's type. The JAX kernel's `pack` (pack sequences
//       of L/pack rows in one block-diagonal score tile) is the wrapper's
//       view of the same memory as BH*pack sequences of L/pack rows.
//
// Numerics (the XLA path's, as in every kernel of the port): f32 scores,
// the row max subtracted, probabilities rounded to bf16 before the PV
// product (f32 inputs too, as the Pallas kernel's P is bf16), an f32
// denominator of the unrounded exponentials, out rounded to the input
// type. Not copied (ops/attention.py:14-27): the +/-80 clamp in place of
// the max, the ones column through which the MXU sums the denominator,
// the block-diagonal packing.
//
// Bound: by bytes at the port's shapes. Reading q, k, v and writing out
// moves 8*L*hd bytes per bf16 sequence against 4*L^2*hd FLOP, L/2 FLOP per
// byte, under the tensor cores' ~295 FLOP/B ridge for every L <= 197: the
// teacher window's spatial sequences (2880 x 197 rows, hd 64) move 2.9e8 B,
// 0.087 ms at 3.35 TB/s.
//
// Two instances, chosen by dtype:
//
// bf16: the tensor-core kernel (tc_attn_block, on tc_attention.cuh's
// tile). A block stages G contiguous sequences of Q, K and V (one
// coalesced run per tensor, 16-byte cp.async, XOR-swizzled rows) in
// shared memory; each warp takes 16-row strips: a sequence of L >= 16 rows
// has ceil(L / 16) strips (13 at L = 197, 2 at L = 30), and where L < 16
// one strip holds P = 16 / L whole sequences, each row's keys masked to
// its own sequence (5 sequences in 15 rows at L = 3; a masked key's
// probability is an exact 0, so the packed arithmetic equals the
// unpacked). G is chosen so a block has ~7 strips where sequences are
// short (G = 3 at L = 30, 35 at L = 3) and one sequence at L = 197
// (76 KB at hd 64; its 13 strips on 7 warps in two rounds, so three blocks
// share an SM and one's copy overlaps the others' compute). K and V come
// in two copy groups, V arriving while the max pass runs. Scores and PV
// run on mma.sync; rows past L are never written.
//
// f32: the CUDA-core kernel (fused_attn_kernel): tensor
// cores would compute its scores in TF32. A block of up to 8 warps holds
// G = max(1, 64 / L) whole sequences in shared memory (K rows padded by
// one element pair), one f32 score row per warp; a warp takes one query
// row at a time, lane j scoring keys j, j+32, ..., then PV with lane c
// owning output pairs c, c+32, ...

#include "tc_attention.cuh"

namespace {

template <typename T>
struct Pair2;

template <>
struct Pair2<float> {
  using type = float2;
  static __device__ __forceinline__ float2 f2(type p) { return p; }
  static __device__ __forceinline__ type make(float a, float b) {
    return make_float2(a, b);
  }
};

constexpr int kFaRows = 64;  // query rows per block: G = max(1, kFaRows / L)
constexpr int kFaWarps = 8;

inline int fa_group(int BH, int L) {
  int g = L >= kFaRows ? 1 : kFaRows / L;
  return g < BH ? g : (BH > 0 ? BH : 1);
}

// Shared bytes: G sequences of Q, K (rows padded by one pair), V, and one
// f32 score row per warp. The wrapper reads it through
// dvst_fused_attention_smem.
inline size_t fa_smem(int G, int L, int hd, size_t elem) {
  const int rows = G * L;
  const int warps = rows < kFaWarps ? rows : kFaWarps;
  const size_t pairs = (size_t)rows * (hd / 2) * 2 + (size_t)rows * (hd / 2 + 1);
  return pairs * 2 * elem + (size_t)warps * L * 4;
}

template <typename T, int HD>
__global__ void fused_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, T* __restrict__ out,
                                  int BH, int L, int G, float scale) {
  using P2 = Pair2<T>;
  using Pair = typename P2::type;
  constexpr int HD2 = HD / 2;   // element pairs per row
  constexpr int KST = HD2 + 1;  // K row stride in pairs: conflict-free columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s0 = blockIdx.x * G;  // the block's first sequence
  const int rows = (BH - s0 < G ? BH - s0 : G) * L;
  Pair* q_s = reinterpret_cast<Pair*>(smem_raw);
  Pair* k_s = q_s + G * L * HD2;
  Pair* v_s = k_s + G * L * KST;
  float* p_all = reinterpret_cast<float*>(v_s + G * L * HD2);

  const long base = (long)s0 * L * HD2;  // pair offset of the block's row 0
  const Pair* q2 = reinterpret_cast<const Pair*>(q) + base;
  const Pair* k2 = reinterpret_cast<const Pair*>(k) + base;
  const Pair* v2 = reinterpret_cast<const Pair*>(v) + base;
  for (int idx = threadIdx.x; idx < rows * HD2; idx += blockDim.x) {
    const int r = idx / HD2, c = idx - r * HD2;
    q_s[idx] = q2[idx];
    k_s[r * KST + c] = k2[idx];
    v_s[idx] = v2[idx];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  float* p_w = p_all + warp * L;
  Pair* out2 = reinterpret_cast<Pair*>(out) + base;
  for (int r = warp; r < rows; r += nw) {
    const int g = r / L;  // sequence of the block; its keys are rows g*L ..
    const Pair* kg = k_s + g * L * KST;
    const Pair* vg = v_s + g * L * HD2;
    Pair qr[HD2];
#pragma unroll
    for (int c = 0; c < HD2; ++c) qr[c] = q_s[r * HD2 + c];
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const Pair* kr = kg + j * KST;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < HD2; ++c) {
        const float2 a = P2::f2(qr[c]);
        const float2 b = P2::f2(kr[c]);
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
      }
      acc *= scale;
      p_w[j] = acc;
      mx = fmaxf(mx, acc);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(p_w[j] - mx);
      sum += e;
      p_w[j] = __bfloat162float(__float2bfloat16(e));  // bf16 probabilities
    }
    sum = warp_sum(sum);
    __syncwarp();
    Pair* orow = out2 + (long)r * HD2;
    for (int c = lane; c < HD2; c += 32) {
      float ax = 0.f, ay = 0.f;
      for (int j = 0; j < L; ++j) {
        const float pj = p_w[j];
        const float2 vf = P2::f2(vg[j * HD2 + c]);
        ax = fmaf(pj, vf.x, ax);
        ay = fmaf(pj, vf.y, ay);
      }
      orow[c] = P2::make(ax / sum, ay / sum);
    }
    __syncwarp();  // p_w is rewritten by the warp's next row
  }
}

template <typename T, int HD>
cudaError_t fused_attn_launch(const void* q, const void* k, const void* v,
                              void* out, int BH, int L, float scale,
                              cudaStream_t st) {
  if (BH <= 0) return cudaSuccess;
  const int G = fa_group(BH, L);
  const int rows = G * L;
  const int warps = rows < kFaWarps ? rows : kFaWarps;
  const size_t smem = fa_smem(G, L, HD, sizeof(T));
  static SmemGrant grant;
  const cudaError_t e = smem_opt_in(fused_attn_kernel<T, HD>, smem, grant);
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)((BH + G - 1) / G);
  fused_attn_kernel<T, HD><<<blocks, warps * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), BH, L, G, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fused_attn(int hd, const void* q, const void* k, const void* v,
                       void* out, int BH, int L, float scale, cudaStream_t st) {
#define DVST_FA_CASE(HDV)                                                      \
  case HDV:                                                                    \
    return fused_attn_launch<T, HDV>(q, k, v, out, BH, L, scale, st);
  switch (hd) {
    DVST_FA_CASE(16)
    DVST_FA_CASE(32)
    DVST_FA_CASE(48)
    DVST_FA_CASE(64)
    DVST_FA_CASE(80)
    DVST_FA_CASE(96)
    DVST_FA_CASE(112)
    DVST_FA_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DVST_FA_CASE
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core instance. Grid: ceil(BH / G) blocks.
// ---------------------------------------------------------------------------

// The block shape (kTcStrips, tc_warps, tc_group, tc_strips, tc_smem) and
// the strip loop (tc_seq_strips) are tc_attention.cuh's, shared with the
// strided temporal instance.

template <int HD>
__device__ __forceinline__ void tc_attn_block(const bf16* __restrict__ q,
                                              const bf16* __restrict__ k,
                                              const bf16* __restrict__ v,
                                              bf16* __restrict__ out, int BH,
                                              int L, int G, float scale) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s0 = blockIdx.x * G;  // the block's first sequence
  const int nseq = BH - s0 < G ? BH - s0 : G;
  const int R = nseq * L;
  bf16* zero = reinterpret_cast<bf16*>(smem_raw);
  bf16* qs = zero + 8;
  const int swz = tc_swizzle(CH);
  const TcRows Q{qs, CH, swz, 0, 0};
  const TcRows K{qs + (long)G * L * HD, CH, swz, 0, 0};
  const TcRows V{qs + (long)2 * G * L * HD, CH, swz, 0, 0};
  const long base = (long)s0 * L * HD;
  // two copy groups: Q and K, which the max pass reads, then V, which
  // arrives while it runs
  for (int idx = threadIdx.x; idx < R * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx - r * CH;
    const long off = base + (long)idx * 8;
    cp_async16(Q.at(r, c), q + off, 16);
    cp_async16(K.at(r, c), k + off, 16);
  }
  cp_async_commit();
  for (int idx = threadIdx.x; idx < R * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx - r * CH;
    cp_async16(V.at(r, c), v + base + (long)idx * 8, 16);
  }
  cp_async_commit();
  if (threadIdx.x == 0) *reinterpret_cast<uint4*>(zero) = make_uint4(0u, 0u, 0u, 0u);
  cp_async_wait<1>();
  __syncthreads();

  tc_seq_strips<HD>(Q, K, V, zero, nseq, L, scale,
                    [&](int r) { return out + base + (long)r * HD; });
}

// The kernel: at hd <= 64 capped at 96 registers a thread, so three
// 7-warp blocks (L = 197) share an SM (at 97 only two do); above, where a
// strip's fragments alone take ~100, uncapped.
template <int HD>
__global__ void __maxnreg__(96)
tc_attn_kernel_narrow(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                      int BH, int L, int G, float scale) {
  tc_attn_block<HD>(q, k, v, out, BH, L, G, scale);
}

template <int HD>
__global__ void __launch_bounds__(kTcStrips * 32)
tc_attn_kernel_wide(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                    int BH, int L, int G, float scale) {
  tc_attn_block<HD>(q, k, v, out, BH, L, G, scale);
}

template <int HD>
auto tc_attn_kernel() {
  if constexpr (HD <= 64) {
    return tc_attn_kernel_narrow<HD>;
  } else {
    return tc_attn_kernel_wide<HD>;
  }
}

template <int HD>
cudaError_t tc_attn_launch(const void* q, const void* k, const void* v,
                           void* out, int BH, int L, float scale,
                           cudaStream_t st) {
  if (BH <= 0) return cudaSuccess;
  const int G = tc_group(BH, L);
  const int warps = tc_warps(tc_strips(G, L));
  const size_t smem = tc_smem(G, L, HD);
  static SmemGrant grant;
  const auto kernel = tc_attn_kernel<HD>();
  const cudaError_t e = smem_opt_in(kernel, smem, grant);
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)((BH + G - 1) / G);
  kernel<<<blocks, warps * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), BH, L, G, scale);
  return cudaGetLastError();
}

cudaError_t tc_attn(int hd, const void* q, const void* k, const void* v,
                    void* out, int BH, int L, float scale, cudaStream_t st) {
#define DVST_TC_CASE(HDV) \
  case HDV:               \
    return tc_attn_launch<HDV>(q, k, v, out, BH, L, scale, st);
  switch (hd) {
    DVST_TC_CASE(16)
    DVST_TC_CASE(32)
    DVST_TC_CASE(48)
    DVST_TC_CASE(64)
    DVST_TC_CASE(80)
    DVST_TC_CASE(96)
    DVST_TC_CASE(112)
    DVST_TC_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DVST_TC_CASE
}

}  // namespace

extern "C" {

// q, k, v, out (BH, L, hd) contiguous, all bf16 (dtype 0: the tensor-core
// instance; 16-byte aligned) or all f32 (dtype 1: the CUDA-core instance).
int dvst_fused_attention(const void* q, const void* k, const void* v,
                         void* out, int BH, int L, int hd, float scale,
                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tc_attn(hd, q, k, v, out, BH, L, scale, st);
  if (dtype == 1) return fused_attn<float>(hd, q, k, v, out, BH, L, scale, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared bytes one block of dvst_fused_attention needs.
long dvst_fused_attention_smem(int BH, int L, int hd, int dtype) {
  if (dtype == 0) return (long)tc_smem(tc_group(BH, L), L, hd);
  return (long)fa_smem(fa_group(BH, L), L, hd, 4);
}

// The instance a call takes: 0 the tensor-core kernel (bf16), 1 the
// CUDA-core kernel (f32), -1 none (another dtype, or a head dim other
// than 16, 32, ..., 128).
int dvst_fused_attention_instance(int hd, int dtype) {
  if (hd % 16 || hd < 16 || hd > 128) return -1;
  return dtype == 0 ? 0 : dtype == 1 ? 1 : -1;
}

}  // extern "C"
