// Hopper (sm_90a) frame-wire gather: gathers frames from a uint8 buffer by
// index and writes them unpacked, colour-converted and normalized, in one
// pass over the output.
//
//   dvst_gather_normalize  frames (N, H, W, 3) RGB or packed (N, rows, W)
//       I420 / yuv420q uint8, idx (M,) int64 -> out (M, H, W, 3) f32 or
//       bf16, channels-last.
//
// Replaces no Pallas kernel: the JAX package leaves this to XLA, which
// fuses the gather (jnp.take) with data/yuv.py's unpack_normalize /
// unpack_normalize_q (:288 / :265) and the RGB wire's / 255 + mean / std
// inside engine/scoring.py's _gather_views and _gather_frames. In eager
// torch the same math is a dozen launches with f32 intermediates the size
// of the views (144 MB each for a chunk of teacher views), so the port
// writes it by hand.
//
// Bound: by bytes. Each output pixel reads its Y byte and one U and one V
// byte (shared by a 2x2 block, 8x8 for yuv420q) or its three RGB bytes,
// and writes 3 values. A frame that several indices gather is read from
// HBM once (the scorer's windows overlap and fit in L2): (distinct frames
// x frame bytes) in + (M x H x W x 3 x 4 or 2) out.
// One thread per output pixel; the reads go through L2 (a chroma byte is
// read by the threads of its block), the writes are contiguous across a
// warp. Simple and right first: vectorised stores are later work.
//
// Numerics: the colour math is written with __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn in the order of the plain version
// (data/yuv.py: c, d, e, the three channel sums, clip to [0, 255], / 255,
// (x - mean) / std), so nvcc cannot contract a multiply and an add into an
// FMA, and bf16 is rounded to nearest even: the output equals the plain
// version's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the plain version's constants: data/yuv.py's _Y_GAIN, _R_V, _G_U, _G_V
// and _B_U as f64, rounded once to f32 as PyTorch rounds a Python float
// against an f32 tensor, and ops/wire.py's MEAN and STD (one value for all
// three channels). A CPU test holds these literals to the Python ones.
constexpr float kYGain = (float)1.1643835616438356;
constexpr float kRV = (float)1.596026785714286;
constexpr float kGU = (float)0.39176229009491365;
constexpr float kGV = (float)0.8129676472377709;
constexpr float kBU = (float)2.017232142857143;
constexpr float kMean = (float)0.45;
constexpr float kStd = (float)0.225;

enum Layout { kRgb8 = 0, kYuv420 = 1, kYuv420q = 2 };

__device__ __forceinline__ void store3(float* out, size_t o, float r, float g,
                                       float b) {
  out[o] = r;
  out[o + 1] = g;
  out[o + 2] = b;
}

__device__ __forceinline__ void store3(__nv_bfloat16* out, size_t o, float r,
                                       float g, float b) {
  out[o] = __float2bfloat16_rn(r);
  out[o + 1] = __float2bfloat16_rn(g);
  out[o + 2] = __float2bfloat16_rn(b);
}

__device__ __forceinline__ float clip255(float x) {
  return fminf(fmaxf(x, 0.f), 255.f);
}

// grid (ceil(H * W / blockDim.x), M): block row m writes output frame m
// from input frame idx[m]; each thread one pixel.
template <typename T, int LAYOUT>
__global__ void gather_normalize_kernel(const uint8_t* __restrict__ frames,
                                        const int64_t* __restrict__ idx,
                                        T* __restrict__ out, int H, int W,
                                        long frame_bytes) {
  const int m = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= H * W) return;
  const uint8_t* f = frames + idx[m] * frame_bytes;
  float r, g, b;
  if (LAYOUT == kRgb8) {  // the RGB wire: / 255 only, as JAX's (no clip)
    r = f[3 * p];
    g = f[3 * p + 1];
    b = f[3 * p + 2];
  } else {
    const int h = p / W, w = p - h * W;
    // byte-flat chroma planes after the Y rows (U, then V)
    const int sub = LAYOUT == kYuv420 ? 2 : 8;
    const int cw = W / sub;
    const long u_at = (long)H * W + (long)(h / sub) * cw + w / sub;
    const long v_at = u_at + (long)(H / sub) * cw;
    const float c = __fmul_rn(__fsub_rn((float)f[p], 16.f), kYGain);
    const float d = __fsub_rn((float)f[u_at], 128.f);
    const float e = __fsub_rn((float)f[v_at], 128.f);
    r = clip255(__fadd_rn(c, __fmul_rn(kRV, e)));
    g = clip255(__fsub_rn(__fsub_rn(c, __fmul_rn(kGU, d)), __fmul_rn(kGV, e)));
    b = clip255(__fadd_rn(c, __fmul_rn(kBU, d)));
  }
  r = __fdiv_rn(__fsub_rn(__fdiv_rn(r, 255.f), kMean), kStd);
  g = __fdiv_rn(__fsub_rn(__fdiv_rn(g, 255.f), kMean), kStd);
  b = __fdiv_rn(__fsub_rn(__fdiv_rn(b, 255.f), kMean), kStd);
  store3(out, ((size_t)m * H * W + p) * 3, r, g, b);
}

template <typename T>
cudaError_t launch(int layout, const uint8_t* frames, const int64_t* idx,
                   T* out, int M, int H, int W, long frame_bytes,
                   cudaStream_t st) {
  const int threads = 256;
  const dim3 grid((H * W + threads - 1) / threads, M);
  switch (layout) {
    case kRgb8:
      gather_normalize_kernel<T, kRgb8><<<grid, threads, 0, st>>>(
          frames, idx, out, H, W, frame_bytes);
      break;
    case kYuv420:
      gather_normalize_kernel<T, kYuv420><<<grid, threads, 0, st>>>(
          frames, idx, out, H, W, frame_bytes);
      break;
    case kYuv420q:
      gather_normalize_kernel<T, kYuv420q><<<grid, threads, 0, st>>>(
          frames, idx, out, H, W, frame_bytes);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// frames: N frames of frame_bytes uint8 each, idx: M int64 in [0, N) (the
// wrapper checks them on the host), out: M x H x W x 3 in f32 or
// (out_bf16) bf16. layout: 0 rgb8, 1 yuv420, 2 yuv420q. Returns the
// launch's CUDA error; 0 means the kernel was launched.
int dvst_gather_normalize(const void* frames, const void* idx, void* out,
                          int M, int H, int W, long frame_bytes, int layout,
                          int out_bf16, void* stream) {
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  const int64_t* ix = static_cast<const int64_t*>(idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch(layout, f, ix, static_cast<__nv_bfloat16*>(out), M, H, W,
                  frame_bytes, st);
  return launch(layout, f, ix, static_cast<float*>(out), M, H, W, frame_bytes,
                st);
}

}  // extern "C"
