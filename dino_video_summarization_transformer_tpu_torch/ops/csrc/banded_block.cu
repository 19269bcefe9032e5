// Hopper (sm_90a) kernels for the banded one-pass scoring forwards.
//
// A banded pass runs one ViT forward over a chunk of C frames (C = 64..512)
// in which frame i attends in time only to its clamp-shifted window
// [lo_i, lo_i + eff), lo_i = clip(i - eff/2, 0, max(t_real - eff, 0)), and
// owns its own CLS row. Windows shift at the edges and never shrink, so
// every query has exactly eff keys, all inside [0, max(t_real, eff)): rows
// >= t_real (padding) never reach a valid row. Three C entry points:
//
//   dvst_banded_temporal_attn  replaces _banded_temporal_kernel
//       (dino_video_summarization_transformer_tpu/ops/banded_block.py:43):
//       qkv (C,N,3D) bf16 frame-major -> o (C,N,D) bf16, per position n and
//       head h, softmax over the query frame's eff window.
//       Bound by bytes: 4*eff*D FLOP per row against 8*D bytes (qkv read,
//       o written): ~15 FLOP/B at eff = 30, far below the ~295 FLOP/B ridge.
//       Design (tensor cores, tc_attention.cuh's tile): one block per
//       (chunk of kBandChunk = 128 query frames, position n, group of HG
//       heads; HG = 4 at ViT-B's hd 64), one warp per head. Each frame row
//       gives the block one contiguous run of HG * hd elements (512 bytes)
//       of q, k and v, copied with 16-byte cp.async. The block walks its
//       chunk in steps of 16 query frames: a step's keys are frames
//       [lo(first), lo(last) + eff) (<= 15 + eff rows), kept in a ring of
//       eff + 31 rows, so each key row is copied once per block (K and V
//       read 1.23x at C = 512, eff = 30) and the next step's rows are in
//       flight while the current step computes. A warp scores its head's
//       16 queries against the step's keys with mma.sync, each row
//       masked to its own window; its output goes out as 16-byte stores.
//       No slab of out-of-band keys is read or scored (the TPU kernel's
//       3P-frame slab and P >= eff - 1 are its block geometry).
//   dvst_spatial_pf             replaces _spatial_pf_kernel
//       (ops/banded_block.py:174): per frame on [cls_i, x_i]: LN -> qkv ->
//       MHSA -> proj -> bf16 grid residual. Its exports (the patch K/V, the
//       CLS rows' own K/V, the CLS queries) are column slices of the two
//       bf16 qkv buffers it writes anyway; cls_band_attn reads them there
//       with their row stride, so nothing is copied. The CLS rows'
//       attention output (the TPU kernel's co_ref) has no consumer (its
//       only caller, models/banded.py:193, drops it) and is not computed.
//       launches: LN grid, LN cls -> GEMM qkv grid, GEMM qkv cls ->
//       attention (CLS row as the per-frame prefix key) -> GEMM proj+res.
//       Bound by operations, like dvst_spatial_mlp's first half, and on
//       the same blocks: the wgmma + TMA GEMM (wgmma_gemm.cuh) and the
//       tensor-core tile's prefix attention (tc_prefix_attn), here
//       without the CLS queries' output.
//   dvst_cls_band_attn          replaces _cls_band_kernel
//       (ops/banded_block.py:291): for each frame i,
//       (1/eff) * sum over t in win(i) of softmax(q_i . [k_cls_i, K_t]) [v_cls_i; V_t]
//       -- a softmax per (i, t) pair over the self key and frame t's N
//       patch keys, then the mean of the eff results (not one softmax over
//       the window's keys).
//       Bound by bytes at its floor (each patch K/V read once: 4*D bytes a
//       row against 4*eff*D FLOP a row: ~30 FLOP/B at eff = 30).
//       Design: one block per (tile of kClsTq query frames, head). The TPU
//       kernel sums over t across sequential grid steps in a VMEM scratch;
//       Hopper blocks carry nothing between them, so the block loops over
//       the tile's target frames [lo(first), lo(last) + eff) itself: frame
//       t's K/V (N x hd) is loaded into shared memory once per tile and
//       every query whose window holds t adds its normalised pair result
//       to a per-query f32 sum in shared memory (owned by one warp: no
//       atomics). Each patch K/V row is read ceil(C/kClsTq) * (kClsTq +
//       eff - 1) / C times per head, not once per query.
//
// Numerics, shared with the plain twins in ops/banded_block.py: f32 scores
// with the row max subtracted, f32 denominators, probabilities rounded to
// bf16 before the PV product, outputs rounded to bf16. The TPU kernels'
// +/-80 logit clamp, ones-column denominators and group-matrix sums are TPU
// workarounds and are not copied.

#include "tc_attention.cuh"
#include "wgmma_gemm.cuh"

namespace {

constexpr int kBandStrip = 16;   // query frames per step of the temporal kernel
constexpr int kBandChunk = 128;  // query frames per temporal block
constexpr int kBandRun = 256;    // elements of a temporal block's head group, at most
constexpr size_t kSmemBudget = 232448;  // sm_90's opt-in maximum (SMEM_LIMIT)
constexpr int kClsTq = 16;       // query frames per CLS-band block
constexpr int kClsThreads = 256;

__device__ __forceinline__ int band_lo(int i, int eff, int hi) {
  const int l = i - eff / 2;
  return l < 0 ? 0 : (l > hi ? hi : l);
}

// Key rows the temporal kernel's ring holds: one step's keys (<= 15 + eff)
// and the next step's new ones (<= 16), so the next copies never overwrite
// a key the current step reads.
__host__ __device__ inline int band_ring(int eff) { return eff + 2 * kBandStrip - 1; }

// ---------------------------------------------------------------------------
// Banded temporal attention: grid (H / HG, N, ceil(C / kBandChunk)).
// ---------------------------------------------------------------------------

// Shared bytes at a head group of W elements: a 16-byte zero row, one
// strip of queries, and the key and value rings.
inline size_t band_smem(int W, int eff) {
  return 16 + (size_t)kBandStrip * W * 2 + (size_t)2 * band_ring(eff) * W * 2;
}

// Heads per block: the largest divisor of H whose group is at most
// kBandRun elements wide and whose shared memory fits.
inline int band_heads(int H, int hd, int eff) {
  for (int hg = H; hg > 1; --hg)
    if (H % hg == 0 && hg * hd <= kBandRun && band_smem(hg * hd, eff) <= kSmemBudget)
      return hg;
  return 1;
}

template <int HD>
__global__ void __launch_bounds__(kBandRun / 16 * 32)
band_temporal_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                     int C, int N, int H, int HG, int t_real, int eff,
                     float scale) {
  constexpr int CH = HD / 8;  // 16-byte chunks of one head
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = HG * HD, WC = HG * CH;  // the group's width: elements, chunks
  const int ring = band_ring(eff);
  const int i0 = blockIdx.z * kBandChunk, n = blockIdx.y;
  const int i1 = min(C, i0 + kBandChunk);
  const int hi = max(t_real - eff, 0);
  const int D = H * HD;
  const long frame = (long)N * 3 * D;  // elements between frames
  const bf16* src = qkv + (long)n * 3 * D + (long)blockIdx.x * W;
  bf16* zero = reinterpret_cast<bf16*>(smem_raw);
  bf16* qbuf = zero + 8;
  bf16* kbuf = qbuf + kBandStrip * W;
  bf16* vbuf = kbuf + (long)ring * W;
  const int swz = tc_swizzle(WC);
  const TcRows Qg{qbuf, WC, swz, 0, 0};
  const TcRows Kg{kbuf, WC, swz, ring, 0};
  const TcRows Vg{vbuf, WC, swz, ring, 0};
  const int nsteps = (i1 - i0 + kBandStrip - 1) / kBandStrip;

  // step t: query frames [i0 + 16 t, ...) against keys [klo(t), khi(t))
  auto klo = [&](int t) { return band_lo(i0 + t * kBandStrip, eff, hi); };
  auto khi = [&](int t) {
    return band_lo(min(i0 + t * kBandStrip + kBandStrip, i1) - 1, eff, hi) + eff;
  };
  // copies step t's query rows and key / value rows [ka, kz): one
  // W-element run of each frame row, 16 bytes a thread
  // (each thread copies one chunk column: the block's HG warps are 32 / CH
  // rows of WC chunks)
  const int lc = threadIdx.x % WC, lr = threadIdx.x / WC, rstep = blockDim.x / WC;
  auto load = [&](int t, int ka, int kz) {
    const int q0 = i0 + t * kBandStrip;
    const int nq = min(kBandStrip, i1 - q0);
    for (int r = lr; r < nq; r += rstep)
      cp_async16(Qg.at(r, lc), src + (q0 + r) * frame + lc * 8, 16);
    for (int r = lr; r < kz - ka; r += rstep) {
      const bf16* row = src + (ka + r) * frame + D + lc * 8;
      cp_async16(Kg.at(ka + r, lc), row, 16);
      cp_async16(Vg.at(ka + r, lc), row + D, 16);
    }
    cp_async_commit();
  };

  if (threadIdx.x == 0) *reinterpret_cast<uint4*>(zero) = make_uint4(0u, 0u, 0u, 0u);
  load(0, klo(0), khi(0));
  const int warp = threadIdx.x >> 5;  // the warp's head within the group
  const int g = (threadIdx.x & 31) >> 2;
  const TcRows Qh{qbuf, WC, swz, 0, warp * CH};
  const TcRows Kh{kbuf, WC, swz, ring, warp * CH};
  const TcRows Vh{vbuf, WC, swz, ring, warp * CH};
  for (int t = 0; t < nsteps; ++t) {
    const int q0 = i0 + t * kBandStrip;
    const int nq = min(kBandStrip, i1 - q0);
    cp_async_wait<0>();
    __syncthreads();
    TcStrip<HD> s;
    s.load_q(Qh, 0, nq, zero);
    // the query strip is in registers; step t + 1's copies run while it
    // computes (they overwrite only keys before klo(t): the ring holds
    // eff + 31 rows)
    __syncthreads();
    if (t + 1 < nsteps) load(t + 1, khi(t), khi(t + 1));
    const int lo0 = band_lo(q0 + g, eff, hi), lo1 = band_lo(q0 + g + 8, eff, hi);
    s.attend(Kh, Vh, klo(t), khi(t), lo0, lo0 + eff, lo1, lo1 + eff, scale, zero);
    s.store(out + ((long)q0 * N + n) * D + ((long)blockIdx.x * HG + warp) * HD,
            (long)N * D, nq);
  }
}

template <int HD>
cudaError_t band_temporal_launch(const bf16* qkv, bf16* out, int C, int N,
                                 int H, int t_real, int eff, cudaStream_t st) {
  const int HG = band_heads(H, HD, eff);
  const size_t smem = band_smem(HG * HD, eff);
  static SmemGrant grant;
  cudaError_t e = smem_opt_in(band_temporal_kernel<HD>, smem, grant);
  if (e != cudaSuccess) return e;
  // head groups fastest, then positions: the blocks in flight together
  // read whole qkv rows of neighbouring positions
  const dim3 grid(H / HG, N, (C + kBandChunk - 1) / kBandChunk);
  band_temporal_kernel<HD><<<grid, HG * 32, smem, st>>>(
      qkv, out, C, N, H, HG, t_real, eff, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// CLS window aggregation: grid (ceil(C / kClsTq), H).
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kClsThreads)
cls_band_kernel(const bf16* __restrict__ qkv_cls, const bf16* __restrict__ qkv,
                bf16* __restrict__ out, int C, int N, int H, int t_real,
                int eff, float scale) {
  constexpr int HD2 = HD / 2;
  constexpr int KST = HD2 + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int i0 = blockIdx.x * kClsTq, h = blockIdx.y;
  const int nq = min(kClsTq, C - i0);
  const int hi = max(t_real - eff, 0);
  const int t0 = band_lo(i0, eff, hi);
  const int t1 = band_lo(i0 + nq - 1, eff, hi) + eff;
  const int D = H * HD;
  const long row_w = 3L * D;

  __nv_bfloat162* k_s = reinterpret_cast<__nv_bfloat162*>(smem_raw);  // N x KST
  __nv_bfloat162* v_s = k_s + N * KST;                                 // N x HD2
  __nv_bfloat162* q_s = v_s + N * HD2;              // kClsTq x HD2: CLS queries
  __nv_bfloat162* ks_s = q_s + kClsTq * HD2;        // the CLS rows' own keys
  __nv_bfloat162* vs_s = ks_s + kClsTq * HD2;       // ... and values
  float* acc_s = reinterpret_cast<float*>(vs_s + kClsTq * HD2);  // kClsTq x HD
  float* p_all = acc_s + kClsTq * HD;                // one N-row per warp

  for (int idx = threadIdx.x; idx < nq * HD2; idx += blockDim.x) {
    const int l = idx / HD2, c = idx - l * HD2;
    const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(
        qkv_cls + (long)(i0 + l) * row_w + h * HD);
    q_s[idx] = r2[c];
    ks_s[idx] = r2[D / 2 + c];
    vs_s[idx] = r2[D + c];
  }
  for (int idx = threadIdx.x; idx < kClsTq * HD; idx += blockDim.x) acc_s[idx] = 0.f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  float* p_w = p_all + warp * N;
  for (int t = t0; t < t1; ++t) {
    __syncthreads();  // the previous frame's K/V are no longer read
    for (int idx = threadIdx.x; idx < N * HD2; idx += blockDim.x) {
      const int l = idx / HD2, c = idx - l * HD2;
      const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(
          qkv + ((long)t * N + l) * row_w + h * HD);
      k_s[l * KST + c] = r2[D / 2 + c];
      v_s[l * HD2 + c] = r2[D + c];
    }
    __syncthreads();
    for (int qi = warp; qi < nq; qi += nw) {
      const int lo = band_lo(i0 + qi, eff, hi);
      if (t < lo || t >= lo + eff) continue;  // uniform across the warp
      __nv_bfloat162 qr[HD2];
#pragma unroll
      for (int c = 0; c < HD2; ++c) qr[c] = q_s[qi * HD2 + c];
      float ps = 0.f;  // the self key's score
      for (int c = lane; c < HD2; c += 32) {
        const float2 a = __bfloat1622float2(q_s[qi * HD2 + c]);
        const float2 b = __bfloat1622float2(ks_s[qi * HD2 + c]);
        ps = fmaf(a.x, b.x, ps);
        ps = fmaf(a.y, b.y, ps);
      }
      const float s_self = warp_sum(ps) * scale;
      float mx = s_self;
      for (int j = lane; j < N; j += 32) {
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
      for (int j = lane; j < N; j += 32) {
        const float e = expf(p_w[j] - mx);
        sum += e;
        p_w[j] = __bfloat162float(__float2bfloat16(e));
      }
      const float e_self = expf(s_self - mx);
      sum = warp_sum(sum) + e_self;
      const float p_self = __bfloat162float(__float2bfloat16(e_self));
      __syncwarp();
      float* acc_q = acc_s + qi * HD;
      for (int c = lane; c < HD2; c += 32) {
        const float2 vo = __bfloat1622float2(vs_s[qi * HD2 + c]);
        float ax = p_self * vo.x, ay = p_self * vo.y;
        for (int j = 0; j < N; ++j) {
          const float pj = p_w[j];
          const float2 vf = __bfloat1622float2(v_s[j * HD2 + c]);
          ax = fmaf(pj, vf.x, ax);
          ay = fmaf(pj, vf.y, ay);
        }
        acc_q[2 * c] += ax / sum;
        acc_q[2 * c + 1] += ay / sum;
      }
      __syncwarp();  // p_w is rewritten by the warp's next query
    }
  }
  // each query's sum was written only by the warp that owns the query
  const float inv_eff = 1.f / (float)eff;
  for (int qi = warp; qi < nq; qi += nw) {
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(
        out + (long)(i0 + qi) * D + h * HD);
    const float* acc_q = acc_s + qi * HD;
    for (int c = lane; c < HD2; c += 32)
      o2[c] = __floats2bfloat162_rn(acc_q[2 * c] * inv_eff,
                                    acc_q[2 * c + 1] * inv_eff);
  }
}

template <int HD>
cudaError_t cls_band_launch(const bf16* qkv_cls, const bf16* qkv, bf16* out,
                            int C, int N, int H, int t_real, int eff,
                            cudaStream_t st) {
  const size_t smem = (size_t)N * (2 * HD + 2) * 2 + (size_t)kClsTq * HD * 2 * 3 +
                      (size_t)kClsTq * HD * 4 + (size_t)(kClsThreads / 32) * N * 4;
  static SmemGrant grant;
  cudaError_t e = smem_opt_in(cls_band_kernel<HD>, smem, grant);
  if (e != cudaSuccess) return e;
  const dim3 grid((C + kClsTq - 1) / kClsTq, H);
  cls_band_kernel<HD><<<grid, kClsThreads, smem, st>>>(
      qkv_cls, qkv, out, C, N, H, t_real, eff, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

#define DVST_HD_CASES(CASE) \
  CASE(16) CASE(32) CASE(48) CASE(64) CASE(80) CASE(96) CASE(112) CASE(128)

}  // namespace

extern "C" {

// qkv (C,N,3D) bf16 frame-major -> out (C,N,D) bf16.
int dvst_banded_temporal_attn(const void* qkv, void* out, int C, int N, int D,
                              int H, int t_real, int eff, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
#define DVST_CASE(HDV) \
  case HDV:            \
    return band_temporal_launch<HDV>(q, o, C, N, H, t_real, eff, st);
  switch (D / H) {
    DVST_HD_CASES(DVST_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef DVST_CASE
}

// Dynamic shared bytes one block of dvst_banded_temporal_attn needs.
long dvst_banded_temporal_attn_smem(int D, int H, int eff) {
  const int hd = D / H;
  return (long)band_smem(band_heads(H, hd, eff) * hd, eff);
}

// x (C,N,D) bf16, cls (C,D) bf16 -> out (C,N,D) bf16 = x + proj(MHSA), and
// the bf16 qkv of the grid rows (C,N,3D) and of the CLS rows (C,3D).
// ws: bf16 workspace of 2*C*N*D + C*D elements.
int dvst_spatial_pf(const void* x_, const void* cls_, const void* ln_w,
                    const void* ln_b, const void* qkv_w, const void* qkv_b,
                    const void* proj_w, const void* proj_b, void* ws, void* out,
                    void* qkv_, void* qkv_cls_, int C, int N, int D, int H,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)C * N;
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* cls = static_cast<const bf16*>(cls_);
  bf16* qkv = static_cast<bf16*>(qkv_);
  bf16* qkv_cls = static_cast<bf16*>(qkv_cls_);
  bf16* y = static_cast<bf16*>(ws);  // (M, D): LN rows
  bf16* y_cls = y + M * D;            // (C, D)
  bf16* a = y_cls + (long)C * D;      // (M, D): attention out
  const float* lw = static_cast<const float*>(ln_w);
  const float* lb = static_cast<const float*>(ln_b);
  cudaError_t e;
  if ((e = ln_launch<bf16>(x, lw, lb, y, M, D, st))) return e;
  if ((e = ln_launch<bf16>(cls, lw, lb, y_cls, C, D, st))) return e;
  if ((e = wg_gemm<kEpiBf16>(y, qkv_w, qkv_b, nullptr, qkv, M, 3 * D, D, st))) return e;
  if ((e = wg_gemm<kEpiBf16>(y_cls, qkv_w, qkv_b, nullptr, qkv_cls, C, 3 * D, D, st)))
    return e;
  // sequence c = [cls row c, grid rows c*N + n for n < N]
  const int hd = D / H;
  if ((e = tc_prefix_attn(hd, qkv, qkv_cls, a, nullptr, C, 1, N, H,
                          1.0f / sqrtf((float)hd), st)))
    return e;
  if ((e = wg_gemm<kEpiAddBf16>(a, proj_w, proj_b, x, out, M, D, D, st))) return e;
  return cudaSuccess;
}

// Dynamic shared bytes one block of dvst_spatial_pf's attention needs at L
// rows.
long dvst_spatial_attn_smem(int L, int hd) { return (long)tc_prefix_smem(L, hd); }

// qkv_cls (C,3D), qkv (C,N,3D) bf16 (dvst_spatial_pf's) -> out (C,D) bf16.
int dvst_cls_band_attn(const void* qkv_cls, const void* qkv, void* out, int C,
                       int N, int D, int H, int t_real, int eff, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qc = static_cast<const bf16*>(qkv_cls);
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
#define DVST_CASE(HDV) \
  case HDV:            \
    return cls_band_launch<HDV>(qc, q, o, C, N, H, t_real, eff, st);
  switch (D / H) {
    DVST_HD_CASES(DVST_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef DVST_CASE
}

}  // extern "C"
