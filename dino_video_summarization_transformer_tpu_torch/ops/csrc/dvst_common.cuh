// Building blocks shared by the port's Hopper kernel libraries
// (fused_block.cu, banded_block.cu, fused_block_bwd.cu, attention.cu):
// LayerNorm, the GEMM epilogues of wgmma_gemm.cuh and their helpers, the
// cp.async wrappers, the shared-memory opt-in, the workspace carver, and
// for the backwards the LayerNorm backward (bf16 and f32 rows), the column
// sums and the f32 cotangent pass, the
// fixed-order reductions and two small row passes.
// Each library includes this file once; everything here has internal
// linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

using bf16 = __nv_bfloat16;

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
// The int8 tier's row quantization (replaces the activation half of
// _q8_rows, dino_video_summarization_transformer_tpu/ops/fused_block.py:
// 1481-1493): a row's scale sx = max(amax, 1e-12) / 127 and its codes
// clip(rint(x / sx), -127, 127) in s8, with IEEE division (__fdiv_rn) and
// round-half-even (rintf), as JAX's int8_linear and the twins compute them
// (the Pallas kernel multiplies by 1 / sx and does not clip). One warp a
// row, so the row's amax is one warp_max. Bound by bytes: each row read
// once (the second read of quant_rows_kernel hits L1), the codes and the
// scale written once.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum_rn(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float q8_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
}

__device__ __forceinline__ float q8_code(float v, float sx) {
  return fminf(fmaxf(rintf(__fdiv_rn(v, sx)), -127.f), 127.f);
}

// K1: LayerNorm of a row, rounded to bf16, then quantized: the codes (s8)
// and the row's scale. The LN runs in an order the twin
// (fused_block.ln_quant_rows_plain) repeats step for step, so the two
// agree bit for bit: lane l sums its values x[l + 32 i] in order of i, the
// lanes' sums meet in a xor butterfly (16, 8, 4, 2, 1); mean = sum / D;
// the squares of x - mean likewise; rs = 1 / sqrt(var + eps); y = ((x -
// mean) * rs) * w + b; every step rounded (_rn intrinsics: no FMA
// contraction, no approximate rsqrt). The row width D = 32 V is a template
// parameter, so a lane holds exactly its V values (24 at ViT-B): a first
// form sized for the widest row held 95 registers a thread and ran at
// ~10% of its bytes bound (PERF.md). D % 128 == 0, D <= 1024.
template <typename TIn, int V>
__global__ void __launch_bounds__(kLnThreads)
ln_quant_kernel(const TIn* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, int8_t* __restrict__ q,
                float* __restrict__ sx, long rows) {
  constexpr int D = 32 * V;
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (kLnThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform per warp
  const TIn* xr = x + row * D;
  float v[V];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    v[i] = to_f32(xr[lane + 32 * i]);
    s = __fadd_rn(s, v[i]);
  }
  const float mu = __fdiv_rn(warp_sum_rn(s), (float)D);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    v[i] = __fsub_rn(v[i], mu);
    ss = __fadd_rn(ss, __fmul_rn(v[i], v[i]));
  }
  const float var = __fdiv_rn(warp_sum_rn(ss), (float)D);
  const float rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, kLnEps)));
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int d = lane + 32 * i;
    const float y = __fadd_rn(__fmul_rn(__fmul_rn(v[i], rs), w[d]), b[d]);
    v[i] = __bfloat162float(__float2bfloat16_rn(y));  // what gets quantized
    amax = fmaxf(amax, fabsf(v[i]));
  }
  const float scale = q8_scale(warp_max(amax));
  int8_t* qr = q + row * D;
#pragma unroll
  for (int i = 0; i < V; ++i) qr[lane + 32 * i] = (int8_t)q8_code(v[i], scale);
  if (lane == 0) sx[row] = scale;
}

template <typename TIn>
cudaError_t ln_quant_launch(const TIn* x, const float* w, const float* b, int8_t* q,
                            float* sx, long rows, int D, cudaStream_t st) {
  if (rows <= 0) return cudaSuccess;
  const long rows_per_block = kLnThreads / 32;
  const unsigned blocks = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
#define DVST_LNQ_CASE(VV)                                                                 \
  case 32 * VV:                                                                           \
    ln_quant_kernel<TIn, VV><<<blocks, kLnThreads, 0, st>>>(x, w, b, q, sx, rows);        \
    break;
  switch (D) {
    DVST_LNQ_CASE(4)
    DVST_LNQ_CASE(8)
    DVST_LNQ_CASE(12)
    DVST_LNQ_CASE(16)
    DVST_LNQ_CASE(20)
    DVST_LNQ_CASE(24)
    DVST_LNQ_CASE(28)
    DVST_LNQ_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef DVST_LNQ_CASE
  return cudaGetLastError();
}

// K2: bf16 rows (the attention output, the proj output, the MLP's hidden
// rows) to s8 codes and the row's scale. A lane reads 4 consecutive values
// (8 bytes) at a time, columns 4 (lane + 32 c): one pass for the amax,
// a second for the codes (4 bytes a store). D % 128 == 0.
__global__ void __launch_bounds__(kLnThreads)
quant_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ sx, long rows, int D) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (kLnThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform per warp
  const bf16* xr = x + row * D;
  float amax = 0.f;
  for (int d = 4 * lane; d < D; d += 128) {
    const uint2 u = *reinterpret_cast<const uint2*>(xr + d);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    amax = fmaxf(fmaxf(amax, fmaxf(fabsf(a.x), fabsf(a.y))), fmaxf(fabsf(c.x), fabsf(c.y)));
  }
  const float scale = q8_scale(warp_max(amax));
  for (int d = 4 * lane; d < D; d += 128) {
    const uint2 u = *reinterpret_cast<const uint2*>(xr + d);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    *reinterpret_cast<char4*>(q + row * D + d) =
        make_char4((signed char)q8_code(a.x, scale), (signed char)q8_code(a.y, scale),
                   (signed char)q8_code(c.x, scale), (signed char)q8_code(c.y, scale));
  }
  if (lane == 0) sx[row] = scale;
}

inline cudaError_t quant_rows_launch(const bf16* x, int8_t* q, float* sx, long rows, int D,
                                     cudaStream_t st) {
  if (rows <= 0) return cudaSuccess;
  if (D <= 0 || D % 128) return cudaErrorInvalidValue;
  const long rows_per_block = kLnThreads / 32;
  const unsigned blocks = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  quant_rows_kernel<<<blocks, kLnThreads, 0, st>>>(x, q, sx, rows, D);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The GEMM epilogues of wgmma_gemm.cuh: out[M, N] = epilogue(A . W^T +
// bias[N]), with the helpers its epilogues and the row passes share.
// ---------------------------------------------------------------------------

enum Epi {
  kEpiBf16 = 0,        // bf16(acc + bias)
  kEpiGeluBf16 = 1,    // bf16(gelu_erf(acc + bias))
  kEpiResBf16F32 = 2,  // f32(res_bf16 + (acc + bias))
  kEpiResF32F32 = 3,   // f32(res_f32 + (acc + bias))
  kEpiF32 = 4,         // f32(acc + bias)
  kEpiResF32Bf16 = 5,  // bf16(res_f32 + (acc + bias))
  kEpiAddBf16 = 6,     // bf16(res_bf16 + bf16(acc + bias)): bf16 residual
                       // stream, branch rounded first (the Pallas order)
  // the backwards' (bias may be null there):
  kEpiMulF32Bf16 = 7,       // bf16(res_f32 * (acc + bias)): dh1 = dhg * gelu'(h1)
  kEpiGeluBf16GradF32 = 8,  // bf16(gelu_erf(acc + bias)) to out and
                            // f32 gelu_erf'(acc + bias) to res (an output)
};

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

__device__ __forceinline__ float gelu_erf_grad(float x) {
  // d/dx [x * Phi(x)] = Phi(x) + x * phi(x)
  return 0.5f * (1.f + erff(x * 0.70710678118654752f)) +
         x * 0.39894228040143268f * expf(-0.5f * x * x);
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

// The dynamic shared memory one kernel instance has been granted, per
// device. Each launcher keeps one as a function-local static.
struct SmemGrant {
  static constexpr int kMaxDevices = 64;
  std::mutex mu;
  size_t granted[kMaxDevices] = {};
};

// Opts `kernel` into `smem` bytes of dynamic shared memory on the current
// device. The attribute is set only when a launch needs more than the
// largest size already granted there (it never shrinks), so the host API
// is called once per instance, device and size, not once per launch.
template <typename Kernel>
cudaError_t smem_opt_in(Kernel* kernel, size_t smem, SmemGrant& g) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(g.mu);
  if (dev < SmemGrant::kMaxDevices && smem <= g.granted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && dev < SmemGrant::kMaxDevices) g.granted[dev] = smem;
  return e;
}

// Carves 256-byte aligned buffers from one workspace (so every TMA operand
// starts 16-byte aligned); with a null base it only counts the bytes.
struct Carve {
  char* base;
  size_t off = 0;
  template <typename T>
  T* take(size_t n) {
    off = (off + 255) & ~size_t(255);
    T* p = base ? reinterpret_cast<T*>(base + off) : nullptr;
    off += n * sizeof(T);
    return p;
  }
};

// ===========================================================================
// Backward building blocks, compiled only where DVST_WITH_BACKWARD is
// defined before this file is included (fused_block_bwd.cu), so the
// forward libraries do not build them. Every reduction across rows runs in
// a fixed order (per-block partial sums, then reduce_splits over the
// blocks in a fixed order): no float atomics, so two calls give
// bit-identical gradients.
// ===========================================================================

#ifdef DVST_WITH_BACKWARD

// out[i] = the sum over z = 0 .. splits-1 of part[z * n + i], in a fixed
// order. A wide output (a weight gradient's split partials) takes one
// thread per element, adding z in order. A narrow one (column sums, the
// LayerNorm scale and bias: a few thousand elements over up to a few
// hundred partials) takes a block of kRedWarps warps per 32 elements:
// warp w adds z = w, w + kRedWarps, ... in order, then the warps' sums
// are added in warp order. One thread per element there would leave the
// card a few blocks, each a chain of hundreds of dependent loads.
constexpr int kRedWarps = 32;

__global__ void reduce_splits_kernel(const float* __restrict__ part, int splits,
                                     long n, float* __restrict__ out) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[(long)z * n + i];
    out[i] = s;
  }
}

__global__ void __launch_bounds__(kRedWarps * 32)
reduce_splits_narrow_kernel(const float* __restrict__ part, int splits, long n,
                            float* __restrict__ out) {
  __shared__ float acc[kRedWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long i = (long)blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < n)
    for (int z = warp; z < splits; z += kRedWarps) s += part[(long)z * n + i];
  acc[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < n) {
    float t = 0.f;
    for (int w = 0; w < kRedWarps; ++w) t += acc[w][lane];
    out[i] = t;
  }
}

inline cudaError_t reduce_splits(const float* part, int splits, long n,
                                 float* out, cudaStream_t st) {
  if (n <= 0) return cudaSuccess;
  if (n < 65536) {
    reduce_splits_narrow_kernel<<<(unsigned)((n + 31) / 32), kRedWarps * 32, 0, st>>>(
        part, splits, n, out);
  } else {
    long blocks = (n + 255) / 256;
    if (blocks > 4096) blocks = 4096;
    reduce_splits_kernel<<<(unsigned)blocks, 256, 0, st>>>(part, splits, n, out);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Column sums (bias gradients): out[c] = sum_r x[r, c] in f32. Block
// (column group, row split) sums its rows in order; reduce_splits adds the
// splits. Bound by bytes (one read of x).
// ---------------------------------------------------------------------------

constexpr int kColsumMaxSplits = 128;

inline int colsum_splits(long rows) {
  long s = (rows + 255) / 256;
  return s < 1 ? 1 : (s > kColsumMaxSplits ? kColsumMaxSplits : (int)s);
}

template <typename T>
__global__ void colsum_kernel(const T* __restrict__ x, long rows, int cols,
                              long rows_per_split, float* __restrict__ part) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const long r0 = (long)blockIdx.y * rows_per_split;
  const long r1 = r0 + rows_per_split < rows ? r0 + rows_per_split : rows;
  float s = 0.f;
  for (long r = r0; r < r1; ++r) s += to_f32(x[r * cols + c]);
  part[(long)blockIdx.y * cols + c] = s;
}

// part: colsum_splits(rows) * cols floats of scratch.
template <typename T>
cudaError_t colsum(const T* x, long rows, int cols, float* part, float* out,
                   cudaStream_t st) {
  const int splits = colsum_splits(rows);
  const long rps = (rows + splits - 1) / splits;
  colsum_kernel<T><<<dim3((cols + 255) / 256, splits), 256, 0, st>>>(
      x, rows, cols, rps, part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_splits(part, splits, cols, out, st);
}

// The trainer's mixed tier reads its incoming cotangents in f32: one pass
// writes their bf16 copy (the operand of the products that read them) and
// sums them over the rows in f32 (the bias gradient of the layer they
// enter), as colsum splits and adds the rows, so that bias gradients come
// from the f32 values (JAX fused_block.py:1033, :1276). The rows are a's
// first Ma rows, then b's (the spatial op's [dgo; dco]; b null when Ma ==
// rows). Bound by bytes: the cotangent read once, its copy written once.
__global__ void cast_colsum_kernel(const float* __restrict__ a, long Ma,
                                   const float* __restrict__ b, long rows, int cols,
                                   long rows_per_split, bf16* __restrict__ out16,
                                   float* __restrict__ part) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const long r0 = (long)blockIdx.y * rows_per_split;
  const long r1 = r0 + rows_per_split < rows ? r0 + rows_per_split : rows;
  float s = 0.f;
  for (long r = r0; r < r1; ++r) {
    const float v = r < Ma ? a[r * cols + c] : b[(r - Ma) * cols + c];
    out16[r * cols + c] = __float2bfloat16(v);
    s += v;
  }
  part[(long)blockIdx.y * cols + c] = s;
}

// part: colsum_splits(rows) * cols floats of scratch; out16 (rows, cols)
// bf16, out (cols) f32.
inline cudaError_t cast_colsum(const float* a, long Ma, const float* b, long rows, int cols,
                               bf16* out16, float* part, float* out, cudaStream_t st) {
  const int splits = colsum_splits(rows);
  const long rps = (rows + splits - 1) / splits;
  cast_colsum_kernel<<<dim3((cols + 255) / 256, splits), 256, 0, st>>>(a, Ma, b, rows, cols,
                                                                      rps, out16, part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_splits(part, splits, cols, out, st);
}

// ---------------------------------------------------------------------------
// LayerNorm backward, f32 throughout (the JAX kernels' f32 dy): dx = rstd *
// (dxh - mean(dxh) - xhat * mean(dxh * xhat)), dxh = dy * w. Rows r < M
// read x[r] and write dx[r] = TX(dx + res[r]) (res may be null); rows M
// <= r < R read x_tail[(r - M) / tail_div] (a row shared by tail_div rows,
// the spatial op's per-frame CLS) and write dx_tail[r - M] in f32. TX is
// the rows' type: bf16 (x, the residual and dx bf16, dx rounded once at
// the store) or f32 (the trainer's mixed tier: x read, the residual added
// and dx stored in f32, never rounded). The
// column sums of dy * xhat and dy (the scale and bias gradients) go to one
// partial per block, its warps' sums added in warp order, which
// reduce_splits adds in a fixed order.
// Bound by bytes: dy (f32), x, the residual read once, dx written once
// (193 MB at R = 25216, D = 768: 0.058 ms).
// Design: the row width D = 32 V is a template parameter, so a lane holds
// exactly its V values of a row (24 at ViT-B), bf16 x as packed bf16 pairs
// (its f32 values are recomputed where used, so the lane's dy, dxh and the
// two column sums fit 128 registers without spilling), f32 x as it is
// (LnRow); a lane reads 8
// consecutive values at once (16-byte loads of x and the residual, two of
// dy; 4 where V % 8 != 0) and writes them at once; a warp takes one row at
// a time; a
// grid of at most kLnBwdBlocks blocks of kLnBwdWarps warps, two blocks an
// SM, each over a contiguous run of rows (block b of G: rows [b R / G, (b
// + 1) R / G)), so the partials stay few.
// ---------------------------------------------------------------------------

constexpr int kLnBwdWarps = 8;
constexpr int kLnBwdBlocks = 264;  // two on each of the H100's 132 SMs

// Blocks (and partials) of the LayerNorm backward over `rows` rows.
inline long ln_bwd_blocks(long rows) {
  const long b = (rows + kLnBwdWarps - 1) / kLnBwdWarps;
  return b < kLnBwdBlocks ? b : kLnBwdBlocks;
}

// CW consecutive values (CW 8 or 4) of a bf16 or f32 row, to or from f32;
// of a bf16 row also as CW / 2 packed pairs.
template <int CW>
__device__ __forceinline__ void ln_load(const bf16* src, float* v) {
  if constexpr (CW == 8) {
    load8(src, v);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
}

template <int CW>
__device__ __forceinline__ void ln_load_packed(const bf16* src, uint32_t* p) {
  if constexpr (CW == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    p[0] = u.x; p[1] = u.y; p[2] = u.z; p[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    p[0] = u.x; p[1] = u.y;
  }
}

// Value i of bf16 pairs p (the low half first) in f32: bf16 is f32's top 16
// bits.
__device__ __forceinline__ float bf16_of(const uint32_t* p, int i) {
  const uint32_t w = p[i >> 1];
  return __uint_as_float((i & 1) ? w & 0xffff0000u : w << 16);
}

template <int CW>
__device__ __forceinline__ void ln_load(const float* src, float* v) {
  if constexpr (CW == 8) {
    load8(src, v);
  } else {
    const float4 a = *reinterpret_cast<const float4*>(src);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
}

template <int CW>
__device__ __forceinline__ void ln_store(bf16* dst, const float* v) {
  if constexpr (CW == 8) {
    store8(dst, v);
  } else {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(dst) = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                                                *reinterpret_cast<const uint32_t*>(&b));
  }
}

template <int CW>
__device__ __forceinline__ void ln_store(float* dst, const float* v) {
  if constexpr (CW == 8) {
    store8(dst, v);
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// A lane's V values of one x row: bf16 rows as packed pairs, f32 rows as
// they are; v(i) is value i in f32 either way.
template <typename TX, int V>
struct LnRow;

template <int V>
struct LnRow<bf16, V> {
  uint32_t p[V / 2];
  template <int CW>
  __device__ __forceinline__ void load(const bf16* src, int c) {
    ln_load_packed<CW>(src, p + CW / 2 * c);
  }
  __device__ __forceinline__ float v(int i) const { return bf16_of(p, i); }
};

template <int V>
struct LnRow<float, V> {
  float f[V];
  template <int CW>
  __device__ __forceinline__ void load(const float* src, int c) {
    ln_load<CW>(src, f + CW * c);
  }
  __device__ __forceinline__ float v(int i) const { return f[i]; }
};

template <int V, typename TX>
__global__ void __launch_bounds__(kLnBwdWarps * 32, 2)
ln_bwd_kernel(const TX* __restrict__ x, const TX* __restrict__ x_tail, int tail_div,
              const float* __restrict__ dy, const float* __restrict__ w,
              const TX* __restrict__ res, TX* __restrict__ dx, float* __restrict__ dx_tail,
              long M, long R, float* __restrict__ part) {
  constexpr int D = 32 * V;
  constexpr int CW = V % 8 == 0 ? 8 : 4;  // values a lane reads at once
  constexpr int NC = V / CW;              // its chunks of a row: columns CW (lane + 32 c) ..
  __shared__ float sg[D], sb[D];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float ag[V], ab[V];
#pragma unroll
  for (int i = 0; i < V; ++i) ag[i] = ab[i] = 0.f;
  const long G = gridDim.x;
  const long rb = blockIdx.x * R / G, re = (blockIdx.x + 1) * R / G;
  for (long r = rb + warp; r < re; r += kLnBwdWarps) {
    const TX* xr = r < M ? x + r * D : x_tail + (r - M) / tail_div * D;
    const float* dyr = dy + r * D;
    LnRow<TX, V> xp;
    float g[V];  // dy, then dxh
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = CW * (lane + 32 * c);
      xp.template load<CW>(xr + d, c);
      ln_load<CW>(dyr + d, g + CW * c);
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) s += xp.v(i);
    const float mu = warp_sum(s) / (float)D;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) q += (xp.v(i) - mu) * (xp.v(i) - mu);
    const float rs = rsqrtf(warp_sum(q) / (float)D + kLnEps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float wv[CW];
      ln_load<CW>(w + CW * (lane + 32 * c), wv);
#pragma unroll
      for (int e = 0; e < CW; ++e) {
        const int i = CW * c + e;
        const float xh = (xp.v(i) - mu) * rs;
        ag[i] += g[i] * xh;
        ab[i] += g[i];
        const float dxh = g[i] * wv[e];
        s1 += dxh;
        s2 += dxh * xh;
        g[i] = dxh;
      }
    }
    const float m1 = warp_sum(s1) / (float)D, m2 = warp_sum(s2) / (float)D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = CW * (lane + 32 * c);
      float o[CW];
#pragma unroll
      for (int e = 0; e < CW; ++e) {
        const float xh = (xp.v(CW * c + e) - mu) * rs;
        o[e] = rs * (g[CW * c + e] - m1 - xh * m2);
      }
      if (r < M) {
        if (res) {
          float rv[CW];
          ln_load<CW>(res + r * D + d, rv);
#pragma unroll
          for (int e = 0; e < CW; ++e) o[e] += rv[e];
        }
        ln_store<CW>(dx + r * D + d, o);
      } else {
        ln_store<CW>(dx_tail + (r - M) * D + d, o);
      }
    }
  }
  // the block's column sums, warp by warp in order
  for (int wi = 0; wi < kLnBwdWarps; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < CW; ++e) {
          const int d = CW * (lane + 32 * c) + e, i = CW * c + e;
          sg[d] = wi == 0 ? ag[i] : sg[d] + ag[i];
          sb[d] = wi == 0 ? ab[i] : sb[d] + ab[i];
        }
    }
    __syncthreads();
  }
  float* pb = part + (long)blockIdx.x * 2 * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    pb[d] = sg[d];
    pb[D + d] = sb[d];
  }
}

// dgb: 2D floats, (dw | db). part: ln_bwd_blocks(R) * 2D floats. D a
// multiple of 128 up to 1024; x, x_tail, dy, res, dx, dx_tail and w
// 16-byte aligned. TX: bf16 or float (x, x_tail, res and dx).
template <typename TX>
cudaError_t ln_bwd(const TX* x, const TX* x_tail, int tail_div, const float* dy,
                   const float* w, const TX* res, TX* dx, float* dx_tail, long M, long R,
                   int D, float* part, float* dgb, cudaStream_t st) {
  if (R <= 0) return cudaSuccess;
  const long blocks = ln_bwd_blocks(R);
#define DVST_LNB_CASE(VV)                                                                   \
  case 32 * VV:                                                                             \
    ln_bwd_kernel<VV, TX><<<(unsigned)blocks, kLnBwdWarps * 32, 0, st>>>(                   \
        x, x_tail, tail_div, dy, w, res, dx, dx_tail, M, R, part);                          \
    break;
  switch (D) {
    DVST_LNB_CASE(4)
    DVST_LNB_CASE(8)
    DVST_LNB_CASE(12)
    DVST_LNB_CASE(16)
    DVST_LNB_CASE(20)
    DVST_LNB_CASE(24)
    DVST_LNB_CASE(28)
    DVST_LNB_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef DVST_LNB_CASE
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_splits(part, (int)blocks, 2L * D, dgb, st);
}

// ---------------------------------------------------------------------------
// Small elementwise passes of the backwards (bound by bytes).
// ---------------------------------------------------------------------------

// dst row g*reps + t = src row g, for t < reps (bf16 rows of width D).
__global__ void rep_rows_kernel(const bf16* __restrict__ src, bf16* __restrict__ dst,
                                int reps, int D, long groups) {
  const long n = groups * reps * D;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const long row = i / D, d = i - row * D;
    dst[i] = src[(row / reps) * D + d];
  }
}

// out row g = sum over t < reps, in order, of src row g*reps + t (f32).
__global__ void sum_groups_kernel(const float* __restrict__ src, int reps, int D,
                                  long groups, float* __restrict__ out) {
  const long n = groups * D;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const long g = i / D, d = i - g * D;
    float s = 0.f;
    for (int t = 0; t < reps; ++t) s += src[(g * reps + t) * D + d];
    out[i] = s;
  }
}

inline unsigned ew_blocks(long n) {
  long b = (n + 255) / 256;
  return (unsigned)(b < 1 ? 1 : (b > 8192 ? 8192 : b));
}

#endif  // DVST_WITH_BACKWARD

}  // namespace
