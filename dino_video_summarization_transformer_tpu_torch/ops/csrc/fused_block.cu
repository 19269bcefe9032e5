// Hopper (sm_90a) kernels for the whole-block divided space-time pair.
//
// Two C entry points, each a short chain of launches on the caller's stream:
//
//   dvst_temporal_phase_tm  replaces _temporal_phase_tm_kernel
//       (dino_video_summarization_transformer_tpu/ops/fused_block.py:761,
//       bf16 in / f32 out, the float tier):
//       x (B,T,N,D) bf16 -> x + fc(proj(MHSA over T at each position(LN x)))
//       launches: LN -> GEMM qkv -> attention -> GEMM proj -> GEMM fc+res
//   dvst_spatial_mlp        replaces _spatial_mlp_kernel
//       (ops/fused_block.py:1556, float tier):
//       per frame on [cls, x_t]: LN -> MHSA -> proj -> grid residual -> LN ->
//       MLP -> residual; bf16 grid out + f32 per-frame CLS rows
//       launches: LN grid, LN cls -> GEMM qkv grid, GEMM qkv cls ->
//       attention -> GEMM proj+res grid, GEMM proj cls -> LN ->
//       GEMM fc1+GELU -> GEMM fc2+res
//
// Bound on the card. Both ops are bound by operations, not bytes: at the
// teacher window (B=8, T=30, N=196, D=768, MLP 3072) the temporal op needs
// B*N*T*(10*D^2 + 4*T*D) = 2.8e11 FLOP against 0.22 GB of activations, the
// spatial op 6.9e11 FLOP against 0.23 GB (the bf16 tensor-core ridge is
// ~295 FLOP/B). Their floors are those FLOP at 989 TFLOP/s. 95% of the
// FLOP are the dense GEMMs; the attention over 30 (temporal) or 197
// (spatial) rows is ~1-4% of them.
//
// Design, right and simple first:
// * gemm_kernel: one tiled bf16 GEMM on the tensor cores (wmma 16x16x16,
//   f32 accumulate), 128x128x32 tiles, a 2-stage cp.async pipeline, the
//   ragged M edge zero-filled on load and masked on store, and fused
//   epilogues (bias, erf GELU, f32 or bf16 residual, f32 or bf16 store).
//   It uses mma.sync-class wmma, not wgmma/TMA: a persistent warp-
//   specialised wgmma GEMM is the later step to the card's peak.
// * attn_kernel: one block per (sequence, head); Q, K, V of the sequence in
//   dynamic shared memory (L=197, hd=64: ~80 KB, opted in), one warp per
//   query row, f32 scores with the row max subtracted, probabilities rounded
//   to bf16 before PV. The temporal op reads its T rows at stride N straight
//   from the frame-major qkv buffer — the TPU kernel's in-VMEM transpose
//   without an HBM transpose; the spatial op indexes the CLS row from its
//   own per-sample qkv row instead of building [cls, x_t] in memory (the
//   CLS row is identical for every frame of a sample, so its LN and qkv
//   run once per sample).
// * ln_kernel: one warp per row, f32 statistics, bf16 rows out.
//
// Numerics (the XLA-path rules): LN in f32 (eps 1e-6); bf16 operands with
// f32 accumulation; qkv rounded to bf16 after the bias; max-subtracted f32
// softmax; exact erf GELU; f32 intra-block carry. The Pallas kernels' +/-80
// logit clamp, ones-column denominator and tanh GELU are TPU workarounds and
// are not copied.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <mutex>

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

namespace {

constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// LayerNorm: one warp per row, D <= 32 * kLnMaxV, bf16 out.
// Bound by bytes (one read, one write of the rows).
// ---------------------------------------------------------------------------

constexpr int kLnMaxV = 32;
constexpr int kLnThreads = 256;

template <typename TIn>
__global__ void __launch_bounds__(kLnThreads)
ln_kernel(const TIn* __restrict__ x, const float* __restrict__ w,
          const float* __restrict__ b, bf16* __restrict__ y, long rows, int D) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (kLnThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform per warp
  const TIn* xr = x + row * D;
  float v[kLnMaxV];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxV; ++i) {
    const int d = lane + 32 * i;
    v[i] = d < D ? to_f32(xr[d]) : 0.f;
    s += v[i];
  }
  const float mu = warp_sum(s) / (float)D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxV; ++i) {
    const int d = lane + 32 * i;
    const float c = d < D ? v[i] - mu : 0.f;
    q += c * c;
  }
  const float rs = rsqrtf(warp_sum(q) / (float)D + kLnEps);
  bf16* yr = y + row * D;
#pragma unroll
  for (int i = 0; i < kLnMaxV; ++i) {
    const int d = lane + 32 * i;
    if (d < D) yr[d] = __float2bfloat16((v[i] - mu) * rs * w[d] + b[d]);
  }
}

template <typename TIn>
cudaError_t ln_launch(const TIn* x, const float* w, const float* b, bf16* y,
                      long rows, int D, cudaStream_t st) {
  if (rows <= 0) return cudaSuccess;
  const long rows_per_block = kLnThreads / 32;
  const unsigned blocks = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  ln_kernel<TIn><<<blocks, kLnThreads, 0, st>>>(x, w, b, y, rows, D);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GEMM: out[M, N] = epilogue(A[M, K] @ W[N, K]^T + bias[N]).
// A row-major bf16; W is an nn.Linear weight (out, in) row-major bf16, read
// as a column-major K x N operand. Requires N % 128 == 0 and K % 32 == 0
// (the wrapper checks); M is ragged. Bound by operations at the shapes of
// both ops (K = 768 or 3072: ~250-600 FLOP per byte moved).
// ---------------------------------------------------------------------------

enum Epi {
  kEpiBf16 = 0,        // bf16(acc + bias)
  kEpiGeluBf16 = 1,    // bf16(gelu_erf(acc + bias))
  kEpiResBf16F32 = 2,  // f32(res_bf16 + (acc + bias))
  kEpiResF32F32 = 3,   // f32(res_f32 + (acc + bias))
  kEpiF32 = 4,         // f32(acc + bias)
  kEpiResF32Bf16 = 5,  // bf16(res_f32 + (acc + bias))
};

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLds = kBK + 8;  // padded smem row: conflict-free wmma loads
constexpr int kGemmThreads = 256;  // 8 warps as 4 (M) x 2 (N), 32x64 each

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ void load8(const bf16* src, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* t = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(t[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 c = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}

__device__ __forceinline__ void store8(bf16* dst, const float* v) {
  uint4 u;
  __nv_bfloat162* t = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) t[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <int EPI>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const float* __restrict__ bias, const void* __restrict__ res,
            void* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(128) bf16 smem[2 * (kBM + kBN) * kLds];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto load_tile = [&](int stage, int k0) {
    bf16* as = smem + stage * (kBM + kBN) * kLds;
    bf16* bs = as + kBM * kLds;
#pragma unroll
    for (int c = tid; c < kBM * (kBK / 8); c += kGemmThreads) {
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      const int gm = m0 + r;
      // rows past M are zero-filled (src size 0), from a valid address
      const bf16* src = A + (size_t)(gm < M ? gm : M - 1) * K + k0 + kc;
      cp_async16(as + r * kLds + kc, src, gm < M ? 16 : 0);
    }
#pragma unroll
    for (int c = tid; c < kBN * (kBK / 8); c += kGemmThreads) {
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      cp_async16(bs + r * kLds + kc, W + (size_t)(n0 + r) * K + k0 + kc, 16);
    }
    cp_async_commit();
  };

  const int nk = K / kBK;
  load_tile(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_tile((kt + 1) & 1, (kt + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = smem + (kt & 1) * (kBM + kBN) * kLds;
    const bf16* bs = as + kBM * kLds;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * kLds + kk, kLds);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], bs + (wn * 64 + j * 16) * kLds + kk, kLds);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the stage is refilled by the next iteration's load
  }

  // Epilogue through a per-warp 16x16 f32 scratch (the pipeline buffers are
  // free now): each lane owns 8 consecutive columns of one row.
  float* scr = reinterpret_cast<float*>(smem) + warp * 256;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * 32 + i * 16 + r;
      const int gn = n0 + wn * 64 + j * 16 + c0;
      if (gm < M) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = scr[r * 16 + c0 + e] + bias[gn + e];
        const size_t o = (size_t)gm * N + gn;
        if constexpr (EPI == kEpiBf16) {
          store8(static_cast<bf16*>(out) + o, v);
        } else if constexpr (EPI == kEpiGeluBf16) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = gelu_erf(v[e]);
          store8(static_cast<bf16*>(out) + o, v);
        } else if constexpr (EPI == kEpiF32) {
          store8(static_cast<float*>(out) + o, v);
        } else {
          float rv[8];
          if constexpr (EPI == kEpiResBf16F32)
            load8(static_cast<const bf16*>(res) + o, rv);
          else
            load8(static_cast<const float*>(res) + o, rv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = rv[e] + v[e];
          if constexpr (EPI == kEpiResF32Bf16)
            store8(static_cast<bf16*>(out) + o, v);
          else
            store8(static_cast<float*>(out) + o, v);
        }
      }
      __syncwarp();
    }
  }
}

template <int EPI>
cudaError_t gemm(const bf16* A, const void* W, const void* bias, const void* res,
                 void* out, long M, int N, int K, cudaStream_t st) {
  if (M <= 0) return cudaSuccess;
  const dim3 grid(N / kBN, (unsigned)((M + kBM - 1) / kBM));
  gemm_kernel<EPI><<<grid, kGemmThreads, 0, st>>>(
      A, static_cast<const bf16*>(W), static_cast<const float*>(bias), res, out,
      (int)M, N, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Attention over short sequences: one block per (sequence s, head h).
// Sequence s = s_hi * S_lo + s_lo; its main row l (0 <= l < n_main) is qkv
// row s_hi*hi_stride + s_lo*lo_stride + l*l_stride (rows of width 3D:
// q | k | v, heads contiguous inside each). With a prefix, row 0 of the
// sequence is prefix row s_hi and its output goes to out_prefix row s.
// Bound by operations on the CUDA cores at these lengths (it is a few % of
// the op's FLOP); shared memory holds the whole sequence, so each K/V row is
// read from device memory once per head.
// ---------------------------------------------------------------------------

template <int HD>
__global__ void attn_kernel(const bf16* __restrict__ qkv,
                            const bf16* __restrict__ qkv_prefix,
                            bf16* __restrict__ out, bf16* __restrict__ out_prefix,
                            int S_lo, long hi_stride, long lo_stride,
                            long l_stride, int n_main, int H, float scale) {
  constexpr int HD2 = HD / 2;   // bf16 pairs per head row
  constexpr int KST = HD2 + 1;  // K row stride in pairs: conflict-free columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pre = qkv_prefix != nullptr ? 1 : 0;
  const int L = n_main + pre;
  const int s = blockIdx.x, h = blockIdx.y;
  const int D = H * HD;
  const long row_w = 3L * D;
  const int s_hi = s / S_lo, s_lo = s - s_hi * S_lo;
  const long base = (long)s_hi * hi_stride + (long)s_lo * lo_stride;

  __nv_bfloat162* q_s = reinterpret_cast<__nv_bfloat162*>(smem_raw);
  __nv_bfloat162* k_s = q_s + L * HD2;
  __nv_bfloat162* v_s = k_s + L * KST;
  float* p_all = reinterpret_cast<float*>(v_s + L * HD2);

  for (int idx = threadIdx.x; idx < L * HD2; idx += blockDim.x) {
    const int l = idx / HD2, c = idx - l * HD2;
    const bf16* row = l < pre ? qkv_prefix + (long)s_hi * row_w
                              : qkv + (base + (long)(l - pre) * l_stride) * row_w;
    const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(row + h * HD);
    q_s[l * HD2 + c] = r2[c];
    k_s[l * KST + c] = r2[D / 2 + c];
    v_s[l * HD2 + c] = r2[D + c];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  float* p_w = p_all + warp * L;
  for (int i = warp; i < L; i += nw) {
    __nv_bfloat162 qr[HD2];
#pragma unroll
    for (int c = 0; c < HD2; ++c) qr[c] = q_s[i * HD2 + c];
    // scores: lane j handles keys j, j+32, ...
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const __nv_bfloat162* kr = k_s + j * KST;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < HD2; ++c) {
        const float2 a = __bfloat1622float2(qr[c]);
        const float2 b = __bfloat1622float2(kr[c]);
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
    bf16* orow = i < pre ? out_prefix + (long)s * D
                         : out + (base + (long)(i - pre) * l_stride) * D;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(orow + h * HD);
    for (int c = lane; c < HD2; c += 32) {
      float ax = 0.f, ay = 0.f;
      for (int j = 0; j < L; ++j) {
        const float pj = p_w[j];
        const float2 vf = __bfloat1622float2(v_s[j * HD2 + c]);
        ax = fmaf(pj, vf.x, ax);
        ay = fmaf(pj, vf.y, ay);
      }
      o2[c] = __floats2bfloat162_rn(ax / sum, ay / sum);
    }
    __syncwarp();  // p_w is rewritten by the warp's next row
  }
}

// Opts attn_kernel<HD> into `smem` bytes of dynamic shared memory on the
// current device. The attribute is set only when a launch needs more than
// the largest size already granted there (it never shrinks), so the host
// API is called once per instance, device and size, not once per launch.
template <int HD>
cudaError_t attn_opt_in(size_t smem) {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static size_t granted[kMaxDevices] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < kMaxDevices && smem <= granted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(attn_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && dev < kMaxDevices) granted[dev] = smem;
  return e;
}

template <int HD>
cudaError_t attn_launch(const bf16* qkv, const bf16* qkv_prefix, bf16* out,
                        bf16* out_prefix, int S, int S_lo, long hi_stride,
                        long lo_stride, long l_stride, int n_main, int H,
                        cudaStream_t st) {
  if (S <= 0) return cudaSuccess;
  const int L = n_main + (qkv_prefix != nullptr ? 1 : 0);
  const int warps = L < 8 ? L : 8;
  const size_t smem = (size_t)L * (3 * HD + 2) * 2 + (size_t)warps * L * 4;
  const cudaError_t e = attn_opt_in<HD>(smem);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf((float)HD);
  attn_kernel<HD><<<dim3(S, H), warps * 32, smem, st>>>(
      qkv, qkv_prefix, out, out_prefix, S_lo, hi_stride, lo_stride, l_stride,
      n_main, H, scale);
  return cudaGetLastError();
}

cudaError_t attn(int hd, const bf16* qkv, const bf16* qkv_prefix, bf16* out,
                 bf16* out_prefix, int S, int S_lo, long hi_stride,
                 long lo_stride, long l_stride, int n_main, int H,
                 cudaStream_t st) {
#define DVST_ATTN_CASE(HDV)                                                    \
  case HDV:                                                                    \
    return attn_launch<HDV>(qkv, qkv_prefix, out, out_prefix, S, S_lo,         \
                            hi_stride, lo_stride, l_stride, n_main, H, st);
  switch (hd) {
    DVST_ATTN_CASE(16)
    DVST_ATTN_CASE(32)
    DVST_ATTN_CASE(48)
    DVST_ATTN_CASE(64)
    DVST_ATTN_CASE(80)
    DVST_ATTN_CASE(96)
    DVST_ATTN_CASE(112)
    DVST_ATTN_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DVST_ATTN_CASE
}

}  // namespace

extern "C" {

const char* dvst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B,T,N,D) bf16 frame-major -> out (B,T,N,D) f32.
// ws: bf16 workspace of B*T*N*5*D elements.
int dvst_temporal_phase_tm(const void* x_, const void* ln_w, const void* ln_b,
                           const void* qkv_w, const void* qkv_b,
                           const void* proj_w, const void* proj_b,
                           const void* fc_w, const void* fc_b, void* ws,
                           void* out, int B, int T, int N, int D, int H,
                           void* stream) {
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
  if ((e = gemm<kEpiBf16>(buf1, qkv_w, qkv_b, nullptr, qkv, M, 3 * D, D, st))) return e;
  // sequence (b, n) over t: rows (b*T + t)*N + n
  if ((e = attn(D / H, qkv, nullptr, buf2, nullptr, B * N, N, (long)T * N, 1,
                N, T, H, st)))
    return e;
  if ((e = gemm<kEpiBf16>(buf2, proj_w, proj_b, nullptr, buf1, M, D, D, st))) return e;
  if ((e = gemm<kEpiResBf16F32>(buf1, fc_w, fc_b, x, out, M, D, D, st))) return e;
  return cudaSuccess;
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
  if ((e = gemm<kEpiBf16>(y, qkv_w, qkv_b, nullptr, qkv, M, 3 * D, D, st))) return e;
  if ((e = gemm<kEpiBf16>(y_cls, qkv_w, qkv_b, nullptr, qkv_cls, B, 3 * D, D, st))) return e;
  // sequence (b, t) = [cls_b, rows (b*T + t)*N + n for n < N]
  if ((e = attn(D / H, qkv, qkv_cls, a, a_cls, B * T, T, (long)T * N, N, 1, N,
                H, st)))
    return e;
  if ((e = gemm<kEpiResF32F32>(a, proj_w, proj_b, x1, x2, M, D, D, st))) return e;
  if ((e = gemm<kEpiF32>(a_cls, proj_w, proj_b, nullptr, cls_rows, (long)B * T,
                         D, D, st)))
    return e;
  if ((e = ln_launch<float>(x2, static_cast<const float*>(ln2_w),
                            static_cast<const float*>(ln2_b), y, M, D, st)))
    return e;
  if ((e = gemm<kEpiGeluBf16>(y, fc1_w, fc1_b, nullptr, hid, M, Dh, D, st))) return e;
  if ((e = gemm<kEpiResF32Bf16>(hid, fc2_w, fc2_b, x2, out, M, D, Dh, st))) return e;
  return cudaSuccess;
}

}  // extern "C"
