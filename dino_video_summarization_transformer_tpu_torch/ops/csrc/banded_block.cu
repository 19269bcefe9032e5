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
//       MHSA -> proj -> grid residual, in x's dtype (the kernel writes
//       x.dtype, :223-224, 268-269): bf16, the projection rounded before
//       the add; or f32 x and CLS rows, the mixed teacher's f32 carry,
//       LN on the f32 rows (ln_kernel<float>) and the residual added
//       unrounded (kEpiResF32F32). The qkv buffers are bf16 in both
//       tiers, as the TPU kernel's exports are. Its exports (the patch K/V, the
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
//       Design (tensor cores, tc_attention.cuh's strip layout): one block
//       per (tile of Tq query frames, head, run of target frames). The TPU
//       kernel sums over t across sequential grid steps in a VMEM scratch;
//       Hopper blocks carry nothing between them, so the block walks the
//       tile's target frames [lo(first), lo(last) + eff) itself, frame
//       t + 1's K and V rows (N runs of hd elements, 16-byte cp.async) in
//       flight while frame t computes (two stages of 2 N hd bf16). The
//       tile's queries are strips of 16 frames; a strip takes a frame only
//       where one of its rows has it in its window (a choice its warps
//       make together) and runs two passes on mma.sync: S = Q K_t^T for
//       each row's max over the self key (a per-row q . k_self) and the N
//       keys, then recomputed, exponentiated, summed, rounded to bf16 and
//       multiplied into V_t, the self key's p_self v_self added, divided by
//       the row's sum and added, where the row's window holds t, into f32
//       registers that persist across the frames. No online softmax: the
//       pair's whole max comes first, as in the tile. Each strip's 13 key
//       blocks are cut into four runs on four warps, which trade their
//       rows' maxima and sums through shared memory (a named barrier per
//       strip); the passes (ClsPass) take two whole key blocks a loop
//       iteration from precomputed swizzled addresses, the exponentials as
//       2^(s scale log2 e - m), and mask only the frame's ragged last block.
//       Bound at C = 512 by the latency of each frame step, not by bytes or
//       the tensor cores (H100, tools/cls_band_bench.py): a strip meets
//       16 + eff - 1 frames, so the SM's warps idle on the frames their
//       strips skip, and one warp a strip ran 2-3x slower than four.
//       Choice, from that sweep: Tq = 64 (four strips, 16 warps, 124 KB at
//       hd 64: one block an SM) at eff 30, where each patch K/V row is
//       read 1.40x (Tq = 16: 2.76x) and the frames split four ways so 384
//       blocks fill the SMs;
//       Tq = 16 (four warps, 105 KB: two blocks an SM) at eff 3, where the
//       re-read is 1.12x and the short windows leave a wider tile's strips
//       mostly idle. In general ceil((eff - 1) / 8) strips, at most four.
//       Where the tiles leave SMs idle (C = 64: one tile per head), the
//       target frames are cut into up to 16 runs, each block's f32 partial
//       sums written apart and added in run order by
//       cls_band_reduce_kernel, so two calls give bit-identical outputs
//       (cls_config: the run count with the fewest modelled block waves).
//       A third frame stage (two frames in flight) measured no faster.
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
// CLS window aggregation on the tensor cores: grid (ceil(C / Tq) * H,
// splits), heads fastest. Block (query tile, head h, split z) holds the
// tile's Tq = 16 qs query frames as qs strips of 16, each strip on ks
// warps (its N keys cut into ks runs of whole 16-key blocks), and walks
// its share of the tile's target frames [lo(first), lo(last) + eff), cut
// into `splits` runs of consecutive frames.
// ---------------------------------------------------------------------------

constexpr int kClsStrips = 4;     // strips per block at most (Tq = 64)
constexpr int kClsKeyRuns = 4;    // warps per strip
constexpr int kClsMaxSplits = 16;
constexpr size_t kSmemSm = 233472;  // an SM's shared memory (228 KB)

// A call's shape on the card: strips per block, warps per strip (key
// runs), splits of the target frames.
struct ClsCfg {
  int qs, ks, z;
};

// Warps a block may have: at hd <= 64 sixteen (128 registers a thread for
// the strip's Q fragments, its P V tile and its running sums), above eight.
__host__ __device__ inline int cls_max_warps(int hd) { return hd <= 64 ? 16 : 8; }

// Shared bytes of a block of qs strips on ks warps each, N keys a frame,
// at head dim hd: a 16-byte zero row; the tile's CLS queries, own keys and
// own values (16 qs rows each); the strips' max and sum exchange (2 qs ks
// 16 floats); two frame stages of K and V (N rows each), which after the
// last frame hold the warps' f32 sums (ks x 16 qs rows of hd) for the
// fixed-order add.
__host__ __device__ inline size_t cls_smem(int N, int hd, int qs, int ks) {
  const size_t ring = (size_t)8 * N * hd;
  const size_t red = (size_t)64 * ks * qs * hd;
  return 16 + (size_t)96 * qs * hd + (size_t)128 * qs * ks + (ring > red ? ring : red);
}

// The config at these shapes on a card of `sms` SMs. Strips: enough that
// the patch K / V re-read, (16 qs + eff - 1) / 16 qs, stays near 1.5 or
// under (four at eff 30, one at eff 3), fewer where the warp cap or the
// shared memory forbids. Splits: the count with the least modelled time,
// waves of blocks (as many resident an SM as shared memory and threads
// allow) times a block's frames plus a fixed cost of four frames (its
// queries' load and its output's write).
inline ClsCfg cls_config(int C, int N, int H, int hd, int eff, int sms) {
  ClsCfg c{(eff + 6) / 8, kClsKeyRuns, 1};
  if (c.qs < 1) c.qs = 1;
  if (c.qs > kClsStrips) c.qs = kClsStrips;
  while (c.qs > 1 && (c.qs * c.ks > cls_max_warps(hd) ||
                      cls_smem(N, hd, c.qs, c.ks) > kSmemBudget))
    --c.qs;
  const int Tq = 16 * c.qs;
  const long blocks = (long)((C + Tq - 1) / Tq) * H;
  long per_sm = (long)(kSmemSm / (cls_smem(N, hd, c.qs, c.ks) + 1024));
  const long by_threads = 2048 / (32L * c.qs * c.ks);
  if (by_threads < per_sm) per_sm = by_threads;
  const long slots = (long)sms * (per_sm > 1 ? per_sm : 1);
  const int frames = (Tq < C ? Tq : C) + eff - 1;
  double best = 0.0;
  for (int z = 1; z <= kClsMaxSplits && z <= frames; ++z) {
    const double t = (double)((blocks * z + slots - 1) / slots) * ((double)frames / z + 4.0);
    if (z == 1 || t < best) {
      best = t;
      c.z = z;
    }
  }
  return c;
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The CLS kernel's strip passes over a run of one frame's keys, stored as
// tile rows (tc_attention.cuh's layout) from shared address k (keys) and v
// (values). The run's whole 16-key blocks go through cls_scores / cls_pv:
// a block starts at a multiple of 16, so each lane's swizzled chunk is the
// same in every block and its ldmatrix address is the block's offset plus
// a constant; two blocks a loop iteration, so their product chains
// overlap. The frame's ragged last block (N % 16 keys) takes the tile's
// masked path (tc_dot_rows, tc_acc_rows: keys past the frame read the
// zero row).
template <int HD>
struct ClsPass {
  static constexpr int KC = HD / 16, NT = HD / 8, CH = HD / 8;
  static constexpr int kSwz = (CH & 7) == 0 ? 7 : (CH & 3) == 0 ? 3 : (CH & 1) == 0 ? 1 : 0;

  // s = q . k over keys j0 .. j0 + 15, unscaled
  static __device__ __forceinline__ void scores(const uint32_t (&qa)[KC][4], unsigned k, int j0,
                                                float (&s)[2][4]) {
    const int lane = threadIdx.x & 31;
    const unsigned row = k + (unsigned)((j0 + (lane & 7) + (lane >> 4) * 8) * CH * 16);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int c = (2 * kc + ((lane >> 3) & 1)) ^ ((lane & 7) & kSwz);
      uint32_t b0, b1, b2, b3;
      ldsm_x4(row + c * 16, b0, b1, b2, b3);
      mma_bf16(s[0], qa[kc], b0, b1);
      mma_bf16(s[1], qa[kc], b2, b3);
    }
  }

  // o += p . values j0 .. j0 + 15
  static __device__ __forceinline__ void pv(const uint32_t (&p)[4], unsigned v, int j0,
                                            float (&o)[NT][4]) {
    const int lane = threadIdx.x & 31;
    const unsigned row = v + (unsigned)((j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * CH * 16);
#pragma unroll
    for (int t = 0; t < NT; t += 2) {
      const int c = (t + (lane >> 4)) ^ ((lane & 7) & kSwz);
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(row + c * 16, b0, b1, b2, b3);
      mma_bf16(o[t], p, b0, b1);
      mma_bf16(o[t + 1], p, b2, b3);
    }
  }

  // Pass 1: the rows' max over keys [kb, ke) (whole blocks up to kf), in
  // the exponent's base-2 domain (times sl = scale * log2 e); -inf for an
  // empty run.
  static __device__ __forceinline__ void max_pass(const uint32_t (&qa)[KC][4], const TcRows& K,
                                             unsigned k, int kb, int kf, int ke, float sl,
                                             const bf16* zero, float& m0, float& m1) {
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll 2
    for (int j0 = kb; j0 < kf; j0 += 16) {
      float s[2][4];
      scores(qa, k, j0, s);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
        mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
      }
    }
    if (kf < ke) {
      const int col = 2 * (threadIdx.x & 3);
      float s[2][4];
      tc_dot_rows(qa, K, kf, ke, zero, s);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (kf + 8 * t + col + e < ke) {
            mx0 = fmaxf(mx0, s[t][e]);
            mx1 = fmaxf(mx1, s[t][2 + e]);
          }
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    m0 = mx0 * sl;
    m1 = mx1 * sl;
  }

  // Pass 2: e = 2^(s sl - m) over keys [kb, ke), their f32 sums l0 / l1
  // (quad-reduced), bf16 P, o = P V (o starts at zero).
  static __device__ __forceinline__ void exp_pass(const uint32_t (&qa)[KC][4], const TcRows& K,
                                             const TcRows& V, unsigned k, unsigned v, int kb,
                                             int kf, int ke, float sl, const bf16* zero,
                                             float m0, float m1, float (&o)[NT][4], float& l0,
                                             float& l1) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 2
    for (int j0 = kb; j0 < kf; j0 += 16) {
      float s[2][4];
      scores(qa, k, j0, s);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        s[t][0] = ex2(fmaf(s[t][0], sl, -m0));
        s[t][1] = ex2(fmaf(s[t][1], sl, -m0));
        s[t][2] = ex2(fmaf(s[t][2], sl, -m1));
        s[t][3] = ex2(fmaf(s[t][3], sl, -m1));
        s0 += s[t][0] + s[t][1];
        s1 += s[t][2] + s[t][3];
      }
      uint32_t pa[4];
      tc_c_to_a(s, pa);
      pv(pa, v, j0, o);
    }
    if (kf < ke) {
      const int col = 2 * (threadIdx.x & 3);
      float s[2][4];
      tc_dot_rows(qa, K, kf, ke, zero, s);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = kf + 8 * t + col + e < ke;
          s[t][e] = ok ? ex2(fmaf(s[t][e], sl, -m0)) : 0.f;
          s[t][2 + e] = ok ? ex2(fmaf(s[t][2 + e], sl, -m1)) : 0.f;
          s0 += s[t][e];
          s1 += s[t][2 + e];
        }
      uint32_t pa[4];
      tc_c_to_a(s, pa);
      tc_acc_rows(pa, V, kf, ke, zero, o);
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o_);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o_);
    }
    l0 = s0;
    l1 = s1;
  }
};

template <int HD>
__global__ void __launch_bounds__(HD <= 64 ? 512 : 256)
cls_band_tc_kernel(const bf16* __restrict__ qkv_cls, const bf16* __restrict__ qkv,
                   bf16* __restrict__ out, float* __restrict__ part, int C, int N,
                   int H, int t_real, int eff, int qs, int ks, float scale) {
  constexpr int CH = HD / 8;  // 16-byte chunks of a head row, n8 tiles of an output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Tq = 16 * qs;
  const int h = blockIdx.x % H, i0 = blockIdx.x / H * Tq;
  const int nq = min(Tq, C - i0);
  const int hi = max(t_real - eff, 0);
  const int D = H * HD;
  const long row_w = 3L * D;
  // the tile's target frames [fa, fb), cut into gridDim.y runs: this
  // block's [ta, tb)
  const int fa = band_lo(i0, eff, hi), fb = band_lo(i0 + nq - 1, eff, hi) + eff;
  const int per = (fb - fa + (int)gridDim.y - 1) / (int)gridDim.y;
  const int ta = min(fb, fa + (int)blockIdx.y * per), tb = min(fb, ta + per);

  bf16* zero = reinterpret_cast<bf16*>(smem_raw);
  bf16* qbuf = zero + 8;
  const int swz = tc_swizzle(CH);
  const TcRows Q{qbuf, CH, swz, 0, 0};
  const TcRows KS{qbuf + (long)Tq * HD, CH, swz, 0, 0};
  const TcRows VS{qbuf + (long)2 * Tq * HD, CH, swz, 0, 0};
  float* xmax = reinterpret_cast<float*>(qbuf + (long)3 * Tq * HD);  // [qs][ks][16]
  float* xsum = xmax + qs * ks * 16;
  bf16* ring = reinterpret_cast<bf16*>(xsum + qs * ks * 16);
  const long stage = (long)2 * N * HD;  // one frame's K, then its V
  auto frame_rows = [&](int t, int v) {
    return TcRows{ring + ((t - ta) & 1) * stage + v * (long)N * HD, CH, swz, 0, 0};
  };

  // the tile's CLS queries, own keys and own values (rows past nq are
  // never read: the strips serve them the zero row)
  for (int idx = threadIdx.x; idx < nq * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx - r * CH;
    const bf16* p = qkv_cls + (long)(i0 + r) * row_w + h * HD + c * 8;
    cp_async16(Q.at(r, c), p, 16);
    cp_async16(KS.at(r, c), p + D, 16);
    cp_async16(VS.at(r, c), p + 2 * D, 16);
  }
  // frame t's patch K and V rows of head h: N runs of HD elements at
  // stride 3D, 16 bytes a thread
  auto load = [&](int t) {
    const TcRows K = frame_rows(t, 0), V = frame_rows(t, 1);
    const bf16* src = qkv + (long)t * N * row_w + D + h * HD;
    for (int idx = threadIdx.x; idx < N * CH; idx += blockDim.x) {
      const int n = idx / CH, c = idx - n * CH;
      const bf16* p = src + n * row_w + c * 8;
      cp_async16(K.at(n, c), p, 16);
      cp_async16(V.at(n, c), p + D, 16);
    }
  };
  if (ta < tb) load(ta);
  cp_async_commit();
  if (threadIdx.x == 0) *reinterpret_cast<uint4*>(zero) = make_uint4(0u, 0u, 0u, 0u);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, col = 2 * (lane & 3);
  const int s = warp / ks, k = warp - s * ks;  // the warp's strip and key run
  const int r0 = 16 * s, nr = min(16, nq - r0);
  const bool live = nr > 0;  // a block's last strips may have no rows
  // the strip's target frames, its rows' windows
  const int sa = live ? band_lo(i0 + r0, eff, hi) : 0;
  const int sb = live ? band_lo(i0 + r0 + nr - 1, eff, hi) + eff : 0;
  const bool ok0 = g < nr, ok1 = g + 8 < nr;
  const int lo0 = band_lo(i0 + r0 + g, eff, hi), lo1 = band_lo(i0 + r0 + g + 8, eff, hi);
  // the warp's keys: 16-key blocks [k nb / ks, (k + 1) nb / ks)
  const int nb = (N + 15) / 16;
  const int kb = 16 * (k * nb / ks), ke = min(N, 16 * ((k + 1) * nb / ks));
  const int kf = kb + (ke - kb) / 16 * 16;  // whole 16-key blocks end here
  float* xm = xmax + s * ks * 16;
  float* xs = xsum + s * ks * 16;
  using P = ClsPass<HD>;
  const float sl = scale * 1.4426950408889634f;  // exponentials as 2^(s sl - m)
  uint32_t qa[P::KC][4];  // the strip's queries as A fragments
  float o[CH][4];         // a frame's P V over the warp's keys
  float self0 = 0.f, self1 = 0.f;  // q . k_self of rows g and g + 8, unscaled
  float acc[CH][4];                // the rows' running sums over their frames
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  // q . k_self of strip row r (zero where !ok): the quad's four lanes sum
  // every fourth chunk, then each other's sums
  auto self_dot = [&](int r, bool ok) {
    float d = 0.f;
    for (int c = lane & 3; c < CH; c += 4) {
      const uint4 a = *reinterpret_cast<const uint4*>(ok ? Q.at(r, c) : zero);
      const uint4 b = *reinterpret_cast<const uint4*>(ok ? KS.at(r, c) : zero);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(b2[e]);
        d = fmaf(x.x, y.x, d);
        d = fmaf(x.y, y.y, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    return d + __shfl_xor_sync(0xffffffffu, d, 2);
  };

  for (int t = ta; t < tb; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // frame t (at ta, the queries too) has landed; frame t - 1's stage is free
    if (t == ta && live) {
      tc_load_a(Q, r0, nr, zero, qa);
      self0 = self_dot(r0 + g, ok0);
      self1 = self_dot(r0 + g + 8, ok1);
    }
    if (t + 1 < tb) load(t + 1);  // in flight while frame t computes
    cp_async_commit();
    if (!live || t < sa || t >= sb) continue;  // no row of the strip has t in its window
    const TcRows K = frame_rows(t, 0), V = frame_rows(t, 1);
    const unsigned ka = smem_u32(K.base), va = smem_u32(V.base);
    // pass 1: each row's max over its self key and the frame's N keys
    float m0, m1;
    P::max_pass(qa, K, ka, kb, kf, ke, sl, zero, m0, m1);
    if (ks > 1) {
      if ((lane & 3) == 0) {
        xm[k * 16 + g] = m0;
        xm[k * 16 + g + 8] = m1;
      }
      named_bar(1 + s, ks * 32);
      m0 = m1 = -INFINITY;
      for (int j = 0; j < ks; ++j) {
        m0 = fmaxf(m0, xm[j * 16 + g]);
        m1 = fmaxf(m1, xm[j * 16 + g + 8]);
      }
    }
    const float mx0 = fmaxf(m0, self0 * sl), mx1 = fmaxf(m1, self1 * sl);
    // pass 2: the run's exponentials, their f32 sum, bf16 P, P V
    float l0, l1;
    P::exp_pass(qa, K, V, ka, va, kb, kf, ke, sl, zero, mx0, mx1, o, l0, l1);
    const float e0 = ex2(fmaf(self0, sl, -mx0)), e1 = ex2(fmaf(self1, sl, -mx1));
    if (ks > 1) {  // the runs' sums, added in run order by every warp of the strip
      if ((lane & 3) == 0) {
        xs[k * 16 + g] = l0;
        xs[k * 16 + g + 8] = l1;
      }
      named_bar(1 + s, ks * 32);
      l0 = l1 = 0.f;
      for (int j = 0; j < ks; ++j) {
        l0 += xs[j * 16 + g];
        l1 += xs[j * 16 + g + 8];
      }
    }
    const float inv0 = 1.f / (l0 + e0), inv1 = 1.f / (l1 + e1);
    if (k == 0) {  // the self key's bf16 probability times the row's own value
      const float p0 = __bfloat162float(__float2bfloat16(e0));
      const float p1 = __bfloat162float(__float2bfloat16(e1));
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float2 v0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>((ok0 ? VS.at(r0 + g, c) : zero) + col));
        const float2 v1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>((ok1 ? VS.at(r0 + g + 8, c) : zero) + col));
        o[c][0] = fmaf(p0, v0.x, o[c][0]);
        o[c][1] = fmaf(p0, v0.y, o[c][1]);
        o[c][2] = fmaf(p1, v1.x, o[c][2]);
        o[c][3] = fmaf(p1, v1.y, o[c][3]);
      }
    }
    // the pair's normalised result, for the rows whose window holds t
    const bool in0 = ok0 && t >= lo0 && t < lo0 + eff;
    const bool in1 = ok1 && t >= lo1 && t < lo1 + eff;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      acc[c][0] += in0 ? o[c][0] * inv0 : 0.f;
      acc[c][1] += in0 ? o[c][1] * inv0 : 0.f;
      acc[c][2] += in1 ? o[c][2] * inv1 : 0.f;
      acc[c][3] += in1 ? o[c][3] * inv1 : 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the frames are done: the ring takes the warps' sums
  float* red = reinterpret_cast<float*>(ring);  // [ks][Tq][HD]
  if (live) {
    float* rw = red + ((long)k * Tq + r0) * HD;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      *reinterpret_cast<float2*>(rw + g * HD + 8 * c + col) = make_float2(acc[c][0], acc[c][1]);
      *reinterpret_cast<float2*>(rw + (g + 8) * HD + 8 * c + col) =
          make_float2(acc[c][2], acc[c][3]);
    }
  }
  __syncthreads();
  // the key runs' sums added in run order; then the mean, rounded to bf16
  // (one split) or the split's f32 partial
  const float inv_eff = 1.f / (float)eff;
  for (int idx = threadIdx.x; idx < nq * (HD / 2); idx += blockDim.x) {
    const int r = idx / (HD / 2), c = 2 * (idx - r * (HD / 2));
    float2 v = make_float2(0.f, 0.f);
    for (int j = 0; j < ks; ++j) {
      const float2 w = *reinterpret_cast<const float2*>(red + ((long)j * Tq + r) * HD + c);
      v.x += w.x;
      v.y += w.y;
    }
    const long off = (long)(i0 + r) * D + h * HD + c;
    if (part == nullptr)
      *reinterpret_cast<__nv_bfloat162*>(out + off) =
          __floats2bfloat162_rn(v.x * inv_eff, v.y * inv_eff);
    else
      *reinterpret_cast<float2*>(part + (long)blockIdx.y * C * D + off) = v;
  }
}

// out = bf16(inv_eff * the sum over z of part[z * n + i], z in order): the
// splits' partials, two elements a thread.
__global__ void cls_band_reduce_kernel(const float* __restrict__ part, int splits, long n,
                                       float inv_eff, bf16* __restrict__ out) {
  for (long i = 2 * ((long)blockIdx.x * blockDim.x + threadIdx.x); i < n;
       i += 2L * gridDim.x * blockDim.x) {
    float2 v = make_float2(0.f, 0.f);
    for (int z = 0; z < splits; ++z) {
      const float2 w = *reinterpret_cast<const float2*>(part + (long)z * n + i);
      v.x += w.x;
      v.y += w.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + i) =
        __floats2bfloat162_rn(v.x * inv_eff, v.y * inv_eff);
  }
}

template <int HD>
cudaError_t cls_band_launch(const bf16* qkv_cls, const bf16* qkv, bf16* out, float* part,
                            int C, int N, int H, int t_real, int eff, ClsCfg cfg,
                            cudaStream_t st) {
  const size_t smem = cls_smem(N, HD, cfg.qs, cfg.ks);
  const long tiles = (C + 16L * cfg.qs - 1) / (16L * cfg.qs);
  if (cfg.qs < 1 || cfg.ks < 1 || cfg.qs > 15 || cfg.ks > 16 ||
      cfg.qs * cfg.ks > cls_max_warps(HD) ||
      cfg.z < 1 || cfg.z > 65535 || (cfg.z > 1 && part == nullptr) || smem > kSmemBudget ||
      tiles * H > 0x7fffffffL)
    return cudaErrorInvalidValue;
  static SmemGrant grant;
  cudaError_t e = smem_opt_in(cls_band_tc_kernel<HD>, smem, grant);
  if (e != cudaSuccess) return e;
  cls_band_tc_kernel<HD><<<dim3((unsigned)(tiles * H), cfg.z), cfg.qs * cfg.ks * 32, smem, st>>>(
      qkv_cls, qkv, out, cfg.z > 1 ? part : nullptr, C, N, H, t_real, eff, cfg.qs, cfg.ks,
      1.0f / sqrtf((float)HD));
  if ((e = cudaGetLastError()) != cudaSuccess || cfg.z == 1) return e;
  const long n = (long)C * H * HD;
  long blocks = (n / 2 + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  cls_band_reduce_kernel<<<(unsigned)blocks, 256, 0, st>>>(part, cfg.z, n, 1.f / (float)eff,
                                                           out);
  return cudaGetLastError();
}

#define DVST_HD_CASES(CASE) \
  CASE(16) CASE(32) CASE(48) CASE(64) CASE(80) CASE(96) CASE(112) CASE(128)

// dvst_spatial_pf's workspace (below).
struct SpatialPfWs {
  bf16 *y, *y_cls, *a;
  size_t bytes;
};

SpatialPfWs spatial_pf_ws(char* base, int C, int N, int D) {
  const long M = (long)C * N;
  Carve c{base};
  SpatialPfWs w;
  w.y = c.take<bf16>(M * D);
  w.y_cls = c.take<bf16>((long)C * D);
  w.a = c.take<bf16>(M * D);
  w.bytes = c.off;
  return w;
}

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

// x (C,N,D) and cls (C,D), both bf16 or (x_f32) both f32 -> out (C,N,D) in
// their dtype = x + proj(MHSA) (bf16: the projection rounded before the
// add, the Pallas order; f32: the mixed teacher's tier, added unrounded),
// and the bf16 qkv of the grid rows (C,N,3D) and of the CLS rows (C,3D).
// ws: the bytes dvst_spatial_pf_ws gives: the grid rows' LN rows, the CLS
// rows' LN rows and the grid rows' attention output, bf16 in both tiers,
// each carved 256-byte aligned.
long dvst_spatial_pf_ws(int C, int N, int D) {
  return (long)spatial_pf_ws(nullptr, C, N, D).bytes;
}

int dvst_spatial_pf(const void* x_, const void* cls_, const void* ln_w,
                    const void* ln_b, const void* qkv_w, const void* qkv_b,
                    const void* proj_w, const void* proj_b, void* ws, void* out,
                    void* qkv_, void* qkv_cls_, int C, int N, int D, int H,
                    int x_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)C * N;
  bf16* qkv = static_cast<bf16*>(qkv_);
  bf16* qkv_cls = static_cast<bf16*>(qkv_cls_);
  const SpatialPfWs w = spatial_pf_ws(static_cast<char*>(ws), C, N, D);
  const float* lw = static_cast<const float*>(ln_w);
  const float* lb = static_cast<const float*>(ln_b);
  cudaError_t e;
  // the LNs read the rows in their own dtype (the mixed tier's f32 carry
  // and per-frame CLS rows are never rounded before their statistics)
  if (x_f32) {
    if ((e = ln_launch<float>(static_cast<const float*>(x_), lw, lb, w.y, M, D, st))) return e;
    e = ln_launch<float>(static_cast<const float*>(cls_), lw, lb, w.y_cls, C, D, st);
  } else {
    if ((e = ln_launch<bf16>(static_cast<const bf16*>(x_), lw, lb, w.y, M, D, st))) return e;
    e = ln_launch<bf16>(static_cast<const bf16*>(cls_), lw, lb, w.y_cls, C, D, st);
  }
  if (e) return e;
  if ((e = wg_gemm<kEpiBf16>(w.y, qkv_w, qkv_b, nullptr, qkv, M, 3 * D, D, st))) return e;
  if ((e = wg_gemm<kEpiBf16>(w.y_cls, qkv_w, qkv_b, nullptr, qkv_cls, C, 3 * D, D, st)))
    return e;
  // sequence c = [cls row c, grid rows c*N + n for n < N]
  const int hd = D / H;
  if ((e = tc_prefix_attn(hd, qkv, qkv_cls, w.a, nullptr, C, 1, N, H,
                          1.0f / sqrtf((float)hd), st)))
    return e;
  if (x_f32) return wg_gemm<kEpiResF32F32>(w.a, proj_w, proj_b, x_, out, M, D, D, st);
  return wg_gemm<kEpiAddBf16>(w.a, proj_w, proj_b, x_, out, M, D, D, st);
}

// Dynamic shared bytes one block of dvst_spatial_pf's attention needs at L
// rows.
long dvst_spatial_attn_smem(int L, int hd) { return (long)tc_prefix_smem(L, hd); }

// For tests and tools/cls_band_bench.py only: dvst_cls_band_attn in a
// block shape of qs strips, ks warps a strip and z splits of the target
// frames (ws: z * C * D f32 where z > 1).
int dvst_cls_band_attn_shaped(const void* qkv_cls, const void* qkv, void* out, void* ws,
                              int C, int N, int D, int H, int t_real, int eff, int qs,
                              int ks, int z, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qc = static_cast<const bf16*>(qkv_cls);
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  float* part = static_cast<float*>(ws);
  const ClsCfg c{qs, ks, z};
  if (H <= 0 || D % H) return cudaErrorInvalidValue;
#define DVST_CASE(HDV) \
  case HDV:            \
    return cls_band_launch<HDV>(qc, q, o, part, C, N, H, t_real, eff, c, st);
  switch (D / H) {
    DVST_HD_CASES(DVST_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef DVST_CASE
}

// For tests and tools only: the block shape dvst_cls_band_attn takes at
// these shapes on the current card, written to shape[0..2] (strips, warps
// a strip, splits).
int dvst_cls_band_shape(int C, int N, int D, int H, int eff, int* shape) {
  int sms = 0;
  if (H <= 0 || D % H || C <= 0 || eff <= 0) return cudaErrorInvalidValue;
  const cudaError_t e = wg_sms(&sms);
  if (e != cudaSuccess) return e;
  const ClsCfg c = cls_config(C, N, H, D / H, eff, sms);
  shape[0] = c.qs;
  shape[1] = c.ks;
  shape[2] = c.z;
  return cudaSuccess;
}

// qkv_cls (C,3D), qkv (C,N,3D) bf16 (dvst_spatial_pf's) -> out (C,D) bf16,
// in the block shape cls_config picks for this card. ws: the bytes
// dvst_cls_band_attn_ws gives (the split partials, f32).
int dvst_cls_band_attn(const void* qkv_cls, const void* qkv, void* out, void* ws, int C,
                       int N, int D, int H, int t_real, int eff, void* stream) {
  int sms = 0;
  if (H <= 0 || D % H || C <= 0 || eff <= 0) return cudaErrorInvalidValue;
  const cudaError_t e = wg_sms(&sms);
  if (e != cudaSuccess) return e;
  const ClsCfg c = cls_config(C, N, H, D / H, eff, sms);
  return dvst_cls_band_attn_shaped(qkv_cls, qkv, out, ws, C, N, D, H, t_real, eff, c.qs,
                                   c.ks, c.z, stream);
}

// Bytes of split partials dvst_cls_band_attn needs at these shapes on
// the current card (-1 if the device cannot be asked).
long dvst_cls_band_attn_ws(int C, int N, int D, int H, int eff) {
  int sms = 0;
  if (H <= 0 || D % H || C <= 0 || eff <= 0 || wg_sms(&sms) != cudaSuccess) return -1;
  const ClsCfg c = cls_config(C, N, H, D / H, eff, sms);
  return c.z > 1 ? (long)c.z * C * D * (long)sizeof(float) : 0;
}

// Dynamic shared bytes one block of dvst_cls_band_attn needs at least at
// N keys a frame and head dim hd (one strip): above the budget, no block
// shape fits.
long dvst_cls_band_smem(int N, int hd) { return (long)cls_smem(N, hd, 1, kClsKeyRuns); }

}  // extern "C"
