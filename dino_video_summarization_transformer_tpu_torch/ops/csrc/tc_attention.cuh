// The tensor-core attention tile: one warp computes a 16-query strip
// against a range of keys held in shared memory, with mma.sync
// (m16n8k16, bf16 in, f32 accumulate) fed by ldmatrix. Used by the
// standalone attention (attention.cu, bf16), the banded temporal
// attention and, strip by strip over each frame's keys, the CLS window
// aggregation (banded_block.cu), through tc_prefix_attn below the spatial
// attention of dvst_spatial_mlp (fused_block.cu) and dvst_spatial_pf
// (banded_block.cu), the per-frame attention of dvst_spatial_phase
// (fused_block.cu) and its recompute in dvst_spatial_phase_bwd
// (fused_block_bwd.cu), through tc_prefix_attn_bwd that op's attention
// backward, through tc_strided_attn the temporal attention of
// dvst_temporal_phase_tm and dvst_temporal_phase (fused_block.cu) and its
// recompute in dvst_temporal_phase_tm_bwd (fused_block_bwd.cu), and the
// per-phase attention of dvst_attn_phase over contiguous sequences (N =
// 1), and through tc_strided_attn_bwd that op's attention backward.
//
// Numerics are the plain twins': f32 scores
// (q . k accumulated in f32, times the scale), the max of the row's whole
// valid key set subtracted before any exponential, an f32 denominator of
// the unrounded exponentials, probabilities rounded to bf16 for the PV
// product, the quotient (times the denominator's reciprocal) rounded to
// bf16. So the strip makes two
// passes over its keys: the first takes the row max, the second recomputes
// the scores (the kernels that use the tile are bound by bytes, so the
// extra Q K^T costs little), exponentiates, sums and runs P V. There is no
// online softmax: it would rescale probabilities already rounded to bf16.
//
// Why mma.sync and not wgmma: the strips are 16 rows over 3-48 keys
// (banded) or up to a few hundred (spatial); a 64-row wgmma tile would pad
// the band's strips 4x and 30-row sequences 2x.
//
// Shared-memory layout: a "row" of the tile is a run of 16-byte chunks
// (8 bf16). Rows are stored without padding; chunk c of stored row r sits
// at chunk position c ^ (r & swz), where swz + 1 (a power of two <= 8)
// divides the chunks per row, so ldmatrix's eight row addresses fall in
// distinct banks when a row holds 8 or more chunks. A row may be a ring
// slot (key j in stored row j % ring). Rows the strip must not read (keys
// past its range, queries past its last row) are served by a zero row.

#pragma once

#include <type_traits>

#include "dvst_common.cuh"

namespace {

// The largest power of two <= 8 dividing `chunks`, less one: the XOR
// swizzle mask of a stored row of `chunks` 16-byte chunks.
__host__ __device__ __forceinline__ int tc_swizzle(int chunks) {
  return (chunks & 7) == 0 ? 7 : (chunks & 3) == 0 ? 3 : (chunks & 1) == 0 ? 1 : 0;
}

// A set of stored rows in shared memory: `chunks` 16-byte chunks per row,
// an optional ring of `ring` rows (0: none), columns starting at chunk
// `col0` (a head's slice of a row holding several heads).
struct TcRows {
  bf16* base;
  int chunks;
  int swz;
  int ring;
  int col0;

  // Shared-memory address of chunk c (of this view's columns) of row r.
  __device__ __forceinline__ bf16* at(int r, int c) const {
    const int pr = ring ? r % ring : r;
    return base + ((long)pr * chunks + ((col0 + c) ^ (pr & swz))) * 8;
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Fragment helpers of a warp's 16-row strip (KC = HD / 16 k16 chunks of
// the head dim, NT = HD / 8 n8 tiles).

// Rows r0 .. r0 + 15 of `x` as m16k16 A fragments; rows at or past r0 +
// nrows read zeros.
template <int KC>
__device__ __forceinline__ void tc_load_a(const TcRows& x, int r0, int nrows, const bf16* zero,
                                          uint32_t (&a)[KC][4]) {
  const int lane = threadIdx.x & 31;
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = 2 * kc + (lane >> 4);
    const bf16* p = r < nrows ? x.at(r0 + r, c) : zero;
    ldsm_x4(smem_u32(p), a[kc][0], a[kc][1], a[kc][2], a[kc][3]);
  }
}

// s = a . b^T against rows j0 .. j0 + 15 of `b` (two n8 tiles); rows at
// or past `je` read zeros.
template <int KC>
__device__ __forceinline__ void tc_dot_rows(const uint32_t (&a)[KC][4], const TcRows& b,
                                            int j0, int je, const bf16* zero,
                                            float (&s)[2][4]) {
  const int lane = threadIdx.x & 31;
  const int j = j0 + (lane & 7) + (lane >> 4) * 8;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = 2 * kc + ((lane >> 3) & 1);
    const bf16* p = j < je ? b.at(j, c) : zero;
    uint32_t b0, b1, b2, b3;
    ldsm_x4(smem_u32(p), b0, b1, b2, b3);
    mma_bf16(s[0], a[kc], b0, b1);
    mma_bf16(s[1], a[kc], b2, b3);
  }
}

// o += p (m16k16 A fragment over rows j0 .. j0 + 15) . rows j0 .. j0 + 15
// of `v`; rows at or past `je` read zeros.
template <int NT>
__device__ __forceinline__ void tc_acc_rows(const uint32_t (&p)[4], const TcRows& v, int j0,
                                            int je, const bf16* zero, float (&o)[NT][4]) {
  const int lane = threadIdx.x & 31;
  const int j = j0 + (lane & 7) + ((lane >> 3) & 1) * 8;  // the row this lane addresses
#pragma unroll
  for (int t = 0; t < NT; t += 2) {
    const int c = t + (lane >> 4);
    const bf16* a = j < je ? v.at(j, c) : zero;
    uint32_t b0, b1, b2, b3;
    ldsm_x4_t(smem_u32(a), b0, b1, b2, b3);
    mma_bf16(o[t], p, b0, b1);
    mma_bf16(o[t + 1], p, b2, b3);
  }
}

// The two n8 tiles of a 16 x 16 C fragment as one m16k16 A fragment.
__device__ __forceinline__ void tc_c_to_a(const float (&s)[2][4], uint32_t (&a)[4]) {
  a[0] = pack_bf16(s[0][0], s[0][1]);
  a[1] = pack_bf16(s[0][2], s[0][3]);
  a[2] = pack_bf16(s[1][0], s[1][1]);
  a[3] = pack_bf16(s[1][2], s[1][3]);
}

// Writes o (rows g, times inv0, and g + 8, times inv1), rounded to bf16,
// as 16-byte stores: row r of the strip (r < nrows) to row(r) .. + NT * 8,
// skipped where row(r) is null. The quad of lanes holding a row transposes
// its 2-column pairs in two butterfly rounds, so lane q owns the 8 columns
// of tile j0 + q of each group of four tiles.
template <int NT, typename RowPtr>
__device__ __forceinline__ void tc_store_rows(const float (&o)[NT][4], float inv0, float inv1,
                                              RowPtr row, int nrows) {
  const int lane = threadIdx.x & 31;
  const int q = lane & 3, g = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    const float inv = h ? inv1 : inv0;
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += 4) {
      uint32_t x[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        x[t] = j0 + t < NT ? pack_bf16(o[j0 + t][2 * h] * inv, o[j0 + t][2 * h + 1] * inv)
                           : 0u;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int m = 1 << b;
        const bool up = (q >> b) & 1;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (t & m) continue;
          const uint32_t got = __shfl_xor_sync(0xffffffffu, up ? x[t] : x[t | m], m);
          if (up) x[t] = got;
          else x[t | m] = got;
        }
      }
      bf16* dst = r < nrows ? row(r) : nullptr;
      if (dst != nullptr && j0 + q < NT)
        *reinterpret_cast<uint4*>(dst + (j0 + q) * 8) = make_uint4(x[0], x[1], x[2], x[3]);
    }
  }
}

// One warp's strip: 16 query rows. Lane l holds rows g = l / 4 and g + 8
// of the m16n8 fragments (columns 2 (l % 4) and 2 (l % 4) + 1 of each
// 8-column tile).
template <int HD>
struct TcStrip {
  static constexpr int KC = HD / 16;  // k16 chunks of the head dim
  static constexpr int NT = HD / 8;   // n8 tiles of the output
  static constexpr int KB = 16;       // keys per block of the two passes
  uint32_t qa[KC][4];  // Q as A fragments
  float o[NT][4];      // P V accumulators
  float sum[2];        // denominators of rows g and g + 8

  // Q rows q0 .. q0 + 15 of `q`; rows at or past q0 + nrows read zeros.
  __device__ __forceinline__ void load_q(const TcRows& q, int q0, int nrows,
                                         const bf16* zero) {
    tc_load_a(q, q0, nrows, zero, qa);
  }

  // q . k of keys j0 .. j0 + 15 (two n8 tiles), unscaled; keys at or past
  // `ke` read zeros.
  __device__ __forceinline__ void scores(const TcRows& k, int j0, int ke,
                                         const bf16* zero,
                                         float (&s)[2][4]) const {
    tc_dot_rows(qa, k, j0, ke, zero, s);
  }

  // The strip against keys [kb, ke) of `k` / `v`, in blocks of 16 keys (a
  // wider block of 32 or 64 keys measured no faster: its scores' registers
  // cost the SM a resident block). Row g may see keys [lo0, hi0), row g + 8
  // keys [lo1, hi1) (both within [kb, ke)); every other key is -inf. A key
  // block inside both rows' ranges skips the per-key mask. The scale is
  // applied after the max (max(x * scale) = max(x) * scale for scale > 0:
  // rounding is monotonic), and each exponential takes fma(qk, scale, -max).

  // Pass 1: the scaled max over each row's whole key set (0 for a row with
  // no key, one the caller does not write, so it stays finite).
  __device__ __forceinline__ void max_pass(const TcRows& k, int kb, int ke,
                                           int lo0, int hi0, int lo1, int hi1,
                                           float scale, const bf16* zero,
                                           float& m0, float& m1) const {
    const int col = 2 * (threadIdx.x & 3);
    const int lo = lo0 > lo1 ? lo0 : lo1, hi = hi0 < hi1 ? hi0 : hi1;
    float mx0 = -INFINITY, mx1 = -INFINITY;
    for (int j0 = kb; j0 < ke; j0 += KB) {
      float s[2][4];
      scores(k, j0, ke, zero, s);
      if (j0 >= lo && j0 + KB <= hi) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
          mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
        }
      } else {
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + 8 * t + col + e;
            if (j >= lo0 && j < hi0) mx0 = fmaxf(mx0, s[t][e]);
            if (j >= lo1 && j < hi1) mx1 = fmaxf(mx1, s[t][2 + e]);
          }
      }
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    m0 = mx0 == -INFINITY ? 0.f : mx0 * scale;
    m1 = mx1 == -INFINITY ? 0.f : mx1 * scale;
  }

  // Pass 2: exponentials, their f32 sum, bf16 P, P V. Leaves o and sum,
  // both unnormalised.
  __device__ __forceinline__ void exp_pass(const TcRows& k, const TcRows& v,
                                           int kb, int ke, int lo0, int hi0,
                                           int lo1, int hi1, float scale,
                                           const bf16* zero, float mx0, float mx1) {
    const int lane = threadIdx.x & 31;
    const int col = 2 * (lane & 3);
    const int lo = lo0 > lo1 ? lo0 : lo1, hi = hi0 < hi1 ? hi0 : hi1;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
    float s0 = 0.f, s1 = 0.f;
    for (int j0 = kb; j0 < ke; j0 += KB) {
      float s[2][4];
      scores(k, j0, ke, zero, s);
      if (j0 >= lo && j0 + KB <= hi) {
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[t][e] = __expf(fmaf(s[t][e], scale, -mx0));
            s[t][2 + e] = __expf(fmaf(s[t][2 + e], scale, -mx1));
          }
      } else {
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + 8 * t + col + e;
            s[t][e] = (j >= lo0 && j < hi0) ? __expf(fmaf(s[t][e], scale, -mx0)) : 0.f;
            s[t][2 + e] =
                (j >= lo1 && j < hi1) ? __expf(fmaf(s[t][2 + e], scale, -mx1)) : 0.f;
          }
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        s0 += s[t][0] + s[t][1];
        s1 += s[t][2] + s[t][3];
      }
      // the two n8 score tiles are one m16k16 A fragment of P
      uint32_t pa[4];
      tc_c_to_a(s, pa);
      tc_acc_rows(pa, v, j0, ke, zero, o);
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o_);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o_);
    }
    sum[0] = s0;
    sum[1] = s1;
  }

  // Both passes.
  __device__ __forceinline__ void attend(const TcRows& k, const TcRows& v,
                                         int kb, int ke, int lo0, int hi0,
                                         int lo1, int hi1, float scale,
                                         const bf16* zero) {
    float mx0, mx1;
    max_pass(k, kb, ke, lo0, hi0, lo1, hi1, scale, zero, mx0, mx1);
    exp_pass(k, v, kb, ke, lo0, hi0, lo1, hi1, scale, zero, mx0, mx1);
  }


  // Writes o / sum, rounded to bf16 (tc_store_rows): row r of the strip
  // (r < nrows) to row(r) .. + HD, skipped where row(r) is null.
  template <typename RowPtr>
  __device__ __forceinline__ void store_rows(RowPtr row, int nrows) const {
    tc_store_rows(o, 1.f / sum[0], 1.f / sum[1], row, nrows);
  }

  // store_rows to dst + r * stride.
  __device__ __forceinline__ void store(bf16* dst, long stride, int nrows) const {
    store_rows([=](int r) { return dst + r * stride; }, nrows);
  }
};

// ---------------------------------------------------------------------------
// The block shape of the instances over whole sequences (attention.cu's
// standalone attention, the strided temporal attention below, the prefix
// attention's warps). A sequence of L >= 16 rows has ceil(L / 16) strips;
// where L < 16, one strip holds P = 16 / L whole sequences, each row's keys
// masked to its own sequence (a masked key's probability is an exact 0,
// so the packed arithmetic equals the unpacked).
// ---------------------------------------------------------------------------

// Strips per block where sequences are short, and warps per block at
// most: 7, so three blocks of the 13 strips of L = 197 (two rounds of 7
// warps, 76 KB each at hd 64) fit an SM's shared memory and, at <= 97
// registers a thread, its register file.
constexpr int kTcStrips = 7;

// Warps of a block of `strips` strips: at most kTcStrips, each taking the
// same number of strips but for the last round.
__host__ __device__ inline int tc_warps(int strips) {
  const int rounds = (strips + kTcStrips - 1) / kTcStrips;
  return (strips + rounds - 1) / rounds;
}

// Sequences per block.
inline int tc_group(int BH, int L) {
  int g;
  if (L < 16) {
    g = kTcStrips * (16 / L);
  } else {
    const int sps = (L + 15) / 16;
    g = sps < kTcStrips ? kTcStrips / sps : 1;
  }
  return g < BH ? g : (BH > 0 ? BH : 1);
}

// Strips of a block of `nseq` sequences.
__host__ __device__ inline int tc_strips(int nseq, int L) {
  if (L < 16) {
    const int P = 16 / L;
    return (nseq + P - 1) / P;
  }
  return nseq * ((L + 15) / 16);
}

// Shared bytes: a 16-byte zero row, then G sequences of Q, K and V (the
// wrappers read it through the libraries' *_smem exports).
inline size_t tc_smem(int G, int L, int hd) {
  return 16 + (size_t)3 * G * L * hd * 2;
}

// Strip st of nseq whole sequences of L rows stored sequence-major
// (sequence g's row l at g*L + l): its rows [r0, r0 + nrows) and the keys
// [kb, ke) they may see, the sequences the strip holds.
struct TcSpan {
  int r0, nrows, kb, ke;
};

__host__ __device__ inline TcSpan tc_seq_span(int st, int nseq, int L) {
  TcSpan sp;
  if (L < 16) {
    const int P = 16 / L;  // sequences per strip
    sp.r0 = st * P * L;
    sp.nrows = (nseq - st * P < P ? nseq - st * P : P) * L;
    sp.kb = sp.r0;
    sp.ke = sp.r0 + sp.nrows;
  } else {
    const int sps = (L + 15) / 16, sq = st / sps;  // strips per sequence, its sequence
    sp.kb = sq * L;
    sp.ke = sp.kb + L;
    sp.r0 = sp.kb + 16 * (st - sq * sps);
    sp.nrows = sp.ke - sp.r0 < 16 ? sp.ke - sp.r0 : 16;
  }
  return sp;
}

// The strips of a block of nseq whole sequences of L rows, stored
// sequence-major in Q, K and V, in rounds of one strip per warp, each row
// against its own sequence's keys. The caller has committed two cp.async
// groups (Q and K, then V) and waited for the first: V is waited for
// after the first round's max pass. dst(r) is the output address of
// stored row r.
template <int HD, typename Dst>
__device__ __forceinline__ void tc_seq_strips(const TcRows& Q, const TcRows& K,
                                              const TcRows& V, const bf16* zero,
                                              int nseq, int L, float scale, Dst dst) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int nstrips = tc_strips(nseq, L);
  // every warp meets the first round's barrier, with or without a strip
  for (int st = warp; st - warp < nstrips; st += nw) {
    const bool has = st < nstrips;
    const TcSpan sp = tc_seq_span(has ? st : 0, nseq, L);
    // each row sees its own sequence's keys
    const int lo0 = (sp.r0 + g) / L * L, lo1 = (sp.r0 + g + 8) / L * L;
    TcStrip<HD> s;
    float mx0 = 0.f, mx1 = 0.f;
    if (has) {
      s.load_q(Q, sp.r0, sp.nrows, zero);
      s.max_pass(K, sp.kb, sp.ke, lo0, lo0 + L, lo1, lo1 + L, scale, zero, mx0, mx1);
    }
    if (st == warp) {  // V has arrived
      cp_async_wait<0>();
      __syncthreads();
    }
    if (has) {
      s.exp_pass(K, V, sp.kb, sp.ke, lo0, lo0 + L, lo1, lo1 + L, scale, zero, mx0, mx1);
      s.store_rows([&](int r) { return dst(sp.r0 + r); }, sp.nrows);
    }
  }
}

// ---------------------------------------------------------------------------
// Spatial attention with a prefix key: sequence s is [prefix row s / S_lo,
// grid rows s*N .. s*N + N - 1], read straight from the (rows, 3D) qkv
// buffers (q | k | v, heads contiguous inside each): no [cls, x_t] buffer
// is built. Query row 0 (the prefix's) goes to out_prefix row s (skipped
// when out_prefix is null), grid query n to out row s*N + n. Grid (H, S):
// one block per (head, sequence), heads fastest, so neighbouring blocks
// read neighbouring 128-byte runs of the same rows. The block copies the
// sequence's head slice of Q, K and V into shared memory as tile rows (the
// prefix as row 0; two cp.async groups, V arriving while the max pass
// runs) and takes its ceil(L / 16) strips over the whole key set [0, L)
// on at most kTcStrips warps (13 strips at L = 197: two rounds of 7).
// The tile's numerics: f32 scores, the whole row's max first, bf16 P, an
// f32 sum of the unrounded exponentials.
// ---------------------------------------------------------------------------

// Shared bytes: a 16-byte zero row, then L rows each of Q, K and V.
__host__ __device__ inline size_t tc_prefix_smem(int L, int hd) {
  return 16 + (size_t)3 * L * hd * 2;
}

template <int HD>
__device__ __forceinline__ void tc_prefix_attn_block(const bf16* __restrict__ qkv,
                                                     const bf16* __restrict__ qkv_pre,
                                                     bf16* __restrict__ out,
                                                     bf16* __restrict__ out_pre, int N,
                                                     int S_lo, int H, float scale) {
  constexpr int CH = HD / 8;  // 16-byte chunks per head row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, s = blockIdx.y;
  const int L = N + 1, D = H * HD;
  const long row_w = 3L * D;
  bf16* zero = reinterpret_cast<bf16*>(smem_raw);
  bf16* qs = zero + 8;
  const int swz = tc_swizzle(CH);
  const TcRows Q{qs, CH, swz, 0, 0};
  const TcRows K{qs + (long)L * HD, CH, swz, 0, 0};
  const TcRows V{qs + (long)2 * L * HD, CH, swz, 0, 0};
  // sequence row r: the prefix row (r = 0) or grid row r - 1, this head
  auto src = [&](int r) {
    return (r == 0 ? qkv_pre + (long)(s / S_lo) * row_w
                   : qkv + ((long)s * N + r - 1) * row_w) + h * HD;
  };
  for (int idx = threadIdx.x; idx < L * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx - r * CH;
    const bf16* p = src(r) + c * 8;
    cp_async16(Q.at(r, c), p, 16);
    cp_async16(K.at(r, c), p + D, 16);
  }
  cp_async_commit();
  for (int idx = threadIdx.x; idx < L * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx - r * CH;
    cp_async16(V.at(r, c), src(r) + 2 * D + c * 8, 16);
  }
  cp_async_commit();
  if (threadIdx.x == 0) *reinterpret_cast<uint4*>(zero) = make_uint4(0u, 0u, 0u, 0u);
  cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int nstrips = (L + 15) / 16;
  const int k0 = 0;  // the first key: the prefix row
  // rounds of one strip per warp; every warp meets the first round's
  // barrier, with or without a strip
  for (int st = warp; st - warp < nstrips; st += nw) {
    const bool has = st < nstrips;
    const int r0 = 16 * st;
    const int nrows = L - r0 < 16 ? L - r0 : 16;
    TcStrip<HD> t;
    float mx0 = 0.f, mx1 = 0.f;
    if (has) {
      t.load_q(Q, r0, nrows, zero);
      t.max_pass(K, k0, L, k0, L, k0, L, scale, zero, mx0, mx1);
    }
    if (st == warp) {  // V has arrived
      cp_async_wait<0>();
      __syncthreads();
    }
    if (has) {
      t.exp_pass(K, V, k0, L, k0, L, k0, L, scale, zero, mx0, mx1);
      t.store_rows(
          [&](int r) -> bf16* {
            const int l = r0 + r;
            if (l == 0) return out_pre != nullptr ? out_pre + (long)s * D + h * HD : nullptr;
            return out + ((long)s * N + l - 1) * D + h * HD;
          },
          nrows);
    }
  }
}

// At hd <= 64 capped at 96 registers a thread, so three 7-warp blocks (L =
// 197, 76 KB each) share an SM, as the standalone attention's bf16
// instance (attention.cu); above, uncapped.
template <int HD>
__global__ void __maxnreg__(96)
tc_prefix_attn_kernel_narrow(const bf16* qkv, const bf16* qkv_pre, bf16* out,
                             bf16* out_pre, int N, int S_lo, int H, float scale) {
  tc_prefix_attn_block<HD>(qkv, qkv_pre, out, out_pre, N, S_lo, H, scale);
}

template <int HD>
__global__ void __launch_bounds__(kTcStrips * 32)
tc_prefix_attn_kernel_wide(const bf16* qkv, const bf16* qkv_pre, bf16* out,
                           bf16* out_pre, int N, int S_lo, int H, float scale) {
  tc_prefix_attn_block<HD>(qkv, qkv_pre, out, out_pre, N, S_lo, H, scale);
}

template <int HD>
cudaError_t tc_prefix_attn_launch(const bf16* qkv, const bf16* qkv_pre, bf16* out,
                                  bf16* out_pre, int S, int S_lo, int N, int H,
                                  float scale, cudaStream_t st) {
  if (S <= 0) return cudaSuccess;
  if (S > 65535 || S_lo <= 0 || S % S_lo) return cudaErrorInvalidValue;
  const int L = N + 1;
  const size_t smem = tc_prefix_smem(L, HD);
  static SmemGrant grant;
  cudaError_t e;
  if constexpr (HD <= 64) {
    if ((e = smem_opt_in(tc_prefix_attn_kernel_narrow<HD>, smem, grant))) return e;
    tc_prefix_attn_kernel_narrow<HD><<<dim3(H, S), tc_warps(tc_strips(1, L)) * 32, smem, st>>>(
        qkv, qkv_pre, out, out_pre, N, S_lo, H, scale);
  } else {
    if ((e = smem_opt_in(tc_prefix_attn_kernel_wide<HD>, smem, grant))) return e;
    tc_prefix_attn_kernel_wide<HD><<<dim3(H, S), tc_warps(tc_strips(1, L)) * 32, smem, st>>>(
        qkv, qkv_pre, out, out_pre, N, S_lo, H, scale);
  }
  return cudaGetLastError();
}

// S sequences [qkv_pre row s / S_lo, qkv rows s*N ..] at head dim hd and
// logit scale `scale`.
inline cudaError_t tc_prefix_attn(int hd, const bf16* qkv, const bf16* qkv_pre, bf16* out,
                                  bf16* out_pre, int S, int S_lo, int N, int H,
                                  float scale, cudaStream_t st) {
#define DVST_TCP_CASE(HDV) \
  case HDV:                \
    return tc_prefix_attn_launch<HDV>(qkv, qkv_pre, out, out_pre, S, S_lo, N, H, scale, st);
  switch (hd) {
    DVST_TCP_CASE(16)
    DVST_TCP_CASE(32)
    DVST_TCP_CASE(48)
    DVST_TCP_CASE(64)
    DVST_TCP_CASE(80)
    DVST_TCP_CASE(96)
    DVST_TCP_CASE(112)
    DVST_TCP_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DVST_TCP_CASE
}

// The backward tiles compile only where DVST_WITH_BACKWARD is defined before
// this file is included (fused_block_bwd.cu), as dvst_common.cuh's backward
// blocks.
#ifdef DVST_WITH_BACKWARD

// ---------------------------------------------------------------------------
// The tile's backward. For each (sequence, head), the contract of the plain
// twin (fused_block._attention_bwd):
//   pn = bf16(softmax(q k^T * scale)) (the whole row's max subtracted, an
//   f32 denominator), dv = pn^T da, dp = da v^T,
//   ds = bf16(pn * (dp - rowsum(dp * pn)) * scale), dq = ds k, dk = ds^T q,
// each rounded to bf16, f32 sums. A block copies the head slices of Q, K,
// V and dA of nseq whole sequences of L rows into shared memory as tile
// rows, sequence-major, and runs two passes on the tensor cores, so no L
// x L matrix is ever stored:
// * query strips (the forward's, tc_seq_span): a warp owns a strip's query
//   rows and sweeps their keys in blocks of 16 three times: the row max of
//   the scores with the f32 sum of the exponentials (each lane's running
//   sum rescaled as its max grows, the quad's four sums then rescaled to
//   the row's max), the row term delta = rowsum(dp * pn) (pn the bf16
//   probabilities, dp = dA V^T), then ds and dq += ds K. It writes dq and
//   keeps the row's max, 1 / sum and delta in shared memory.
// * key strips: a warp owns the same strip's rows as keys and sweeps the
//   query rows that see them: S^T = K Q^T, pn^T from the stored max and 1
//   / sum, dp^T = V dA^T, ds^T from the stored delta; dv += pn^T dA and dk
//   += ds^T Q in registers. Each dk and dv row has one owner: no atomics,
//   one summation order.
// Each row sees its own sequence only, in both passes: where a strip packs
// several short sequences (L < 16, the temporal sequences of T = 8 two to
// a strip), a query's keys and a key's queries are masked to its
// sequence, so the key pass never adds another sequence's queries into dk
// or dv. Where a strip's rows are one sequence's, its full blocks of 16
// columns skip the per-element mask (tc_blocks16).
// The two passes compute pn from S and from S^T (the operands swapped in
// mma.sync); each pass's delta and ds use its own pn. The exponentials
// are the forward tile's (__expf of fma(s, scale, -max), times 1 / sum):
// the twin's exact expf(fl(s * scale) - max) / sum read the same largest
// gap to the twin on the card (PERF.md).
// Bound by operations over long sequences (~14 L^2 hd FLOP per sequence
// and head on the tensor cores: S four times, dp three; the K, V, Q and dA
// fragments each product reads through ldmatrix make shared memory as
// busy as the tensor cores), by bytes over short ones (at T = 8, qkv and
// dA read once, dqkv written once).
// ---------------------------------------------------------------------------

// Shared bytes of a block of G sequences of L rows at head dim hd: a
// 16-byte zero row, Q, K, V and dA (G L rows of hd bf16 each), three
// floats per row of its strips (16 rows a strip).
__host__ __device__ inline size_t tc_bwd_smem(int G, int L, int hd) {
  return 16 + (size_t)8 * G * L * hd + (size_t)3 * 16 * tc_strips(G, L) * 4;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ds before its bf16 rounding, in both passes: pn * (dp - delta) * scale.
__device__ __forceinline__ float tc_ds(float p, float dp, float delta, float scale) {
  return p * (dp - delta) * scale;
}

// How a backward block's rows sit in its strips (tc_seq_span's): one
// sequence (the prefix tile's: every row sees [0, L), strips 16 rows
// apart); whole-sequence strips (L >= 16: a strip's rows are one
// sequence's); packed strips (L < 16: several sequences a strip, each row
// masked to its own).
enum TcBwdRows { kOneSeq, kSeqStrips, kPackedStrips };

// The 16-column blocks [c0, c0 + 16) of [cb, ce): body(c0, masked), masked
// a compile-time false for a block wholly inside [cb, ce) of a strip whose
// rows all see it (one sequence, or whole-sequence strips: no per-element
// mask), true for the ragged last block and in packed strips. The choice
// is the same for every lane: mma.sync and ldmatrix need the whole warp.
template <int kRows, typename Body>
__device__ __forceinline__ void tc_blocks16(int cb, int ce, Body body) {
  for (int c0 = cb; c0 < ce; c0 += 16) {
    if constexpr (kRows == kPackedStrips) {
      body(c0, std::true_type{});
    } else {
      if (c0 + 16 <= ce) body(c0, std::false_type{});
      else body(c0, std::true_type{});
    }
  }
}

// The two passes over nseq whole sequences of L rows stored sequence-major
// in Q, K, V and dA, laid out in strips as kRows says. stats: three floats
// per row of the strips (the layout tc_bwd_smem counts). dst(r): stored
// row r's gradient row, at this head's dq (its dk at + D, its dv at + 2
// D). The caller has filled shared memory and synchronised.
template <int HD, int kRows, typename Dst>
__device__ __forceinline__ void tc_bwd_strips(const TcRows& Q, const TcRows& K, const TcRows& V,
                                              const TcRows& dA, const bf16* zero, float* stats,
                                              int nseq, int L, int D, float scale, Dst dst) {
  constexpr int KC = HD / 16;  // k16 chunks of the head dim
  constexpr int NT = HD / 8;   // n8 tiles of a head row
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, col = 2 * (lane & 3);
  constexpr bool kOne = kRows == kOneSeq;
  const int nstrips = kOne ? (L + 15) / 16 : tc_strips(nseq, L);
  float* row_max = stats;
  float* row_inv = row_max + 16 * nstrips;
  float* row_delta = row_inv + 16 * nstrips;
  auto span = [&](int st) -> TcSpan {
    if constexpr (kRows == kOneSeq) return TcSpan{16 * st, L - 16 * st < 16 ? L - 16 * st : 16, 0, L};
    else return tc_seq_span(st, nseq, L);
  };

  // -- query strips: their rows against their keys ----------------------------
  for (int st = warp; st < nstrips; st += nw) {
    const TcSpan sp = span(st);
    int lo0 = 0, lo1 = 0, hi0 = L, hi1 = L;  // one sequence: every row sees [0, L)
    if constexpr (!kOne) {  // the keys of rows r0 + g and r0 + g + 8: their sequence's
      lo0 = (sp.r0 + g) / L * L; lo1 = (sp.r0 + g + 8) / L * L; hi0 = lo0 + L; hi1 = lo1 + L;
    }
    uint32_t qa[KC][4], dfa[KC][4];
    tc_load_a(Q, sp.r0, sp.nrows, zero, qa);
    tc_load_a(dA, sp.r0, sp.nrows, zero, dfa);
    // 1. the row max and the f32 sum of the unrounded exponentials in one
    // sweep: each lane keeps its keys' running max and its sum at that
    // max, rescaled when the max grows; the quad then rescales its four
    // sums to the row's max
    float mx0 = -INFINITY, mx1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    tc_blocks16<kRows>(sp.kb, sp.ke, [&](int j0, auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
      float sc[2][4];
      tc_dot_rows(qa, K, j0, sp.ke, zero, sc);
      float b0 = -INFINITY, b1 = -INFINITY;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 8 * t + col + e;
          if (!kMasked || (j >= lo0 && j < hi0)) b0 = fmaxf(b0, sc[t][e]);
          if (!kMasked || (j >= lo1 && j < hi1)) b1 = fmaxf(b1, sc[t][2 + e]);
        }
      const float n0 = fmaxf(mx0, b0), n1 = fmaxf(mx1, b1);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 8 * t + col + e;
          if (!kMasked || (j >= lo0 && j < hi0)) s0 += __expf((sc[t][e] - n0) * scale);
          if (!kMasked || (j >= lo1 && j < hi1)) s1 += __expf((sc[t][2 + e] - n1) * scale);
        }
      // a lane with no key yet (its max -inf) has nothing to rescale
      l0 = (mx0 == -INFINITY ? 0.f : l0 * __expf((mx0 - n0) * scale)) + s0;
      l1 = (mx1 == -INFINITY ? 0.f : l1 * __expf((mx1 - n1) * scale)) + s1;
      mx0 = n0;
      mx1 = n1;
    });
    float m0 = mx0, m1 = mx1;
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o_));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o_));
    }
    l0 = mx0 == -INFINITY ? 0.f : l0 * __expf((mx0 - m0) * scale);
    l1 = mx1 == -INFINITY ? 0.f : l1 * __expf((mx1 - m1) * scale);
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
    }
    // the scaled row max and 1 / sum; a row with no key (past the strip's
    // rows) takes 0 and 0, so nothing it computes is infinite
    m0 = m0 == -INFINITY ? 0.f : m0 * scale;
    m1 = m1 == -INFINITY ? 0.f : m1 * scale;
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    // pn (bf16, 0 past the row's keys) and dp = dA V^T of keys j0 .. j0 + 15
    auto pn_dp = [&](int j0, auto masked, float (&pn)[2][4], float (&dp)[2][4]) {
      constexpr bool kMasked = decltype(masked)::value;
      tc_dot_rows(qa, K, j0, sp.ke, zero, pn);
      tc_dot_rows(dfa, V, j0, sp.ke, zero, dp);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 8 * t + col + e;
          const bool ok0 = !kMasked || (j >= lo0 && j < hi0);
          const bool ok1 = !kMasked || (j >= lo1 && j < hi1);
          pn[t][e] = ok0 ? bf16_round(__expf(fmaf(pn[t][e], scale, -m0)) * inv0) : 0.f;
          pn[t][2 + e] = ok1 ? bf16_round(__expf(fmaf(pn[t][2 + e], scale, -m1)) * inv1) : 0.f;
        }
    };
    // 2. delta = rowsum(dp * pn)
    float d0 = 0.f, d1 = 0.f;
    tc_blocks16<kRows>(sp.kb, sp.ke, [&](int j0, auto masked) {
      float pn[2][4], dp[2][4];
      pn_dp(j0, masked, pn, dp);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          d0 += dp[t][e] * pn[t][e];
          d1 += dp[t][2 + e] * pn[t][2 + e];
        }
    });
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, o_);
      d1 += __shfl_xor_sync(0xffffffffu, d1, o_);
    }
    // 3. ds = bf16(pn * (dp - delta) * scale), dq += ds K
    float dq[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[t][e] = 0.f;
    tc_blocks16<kRows>(sp.kb, sp.ke, [&](int j0, auto masked) {
      float pn[2][4], dp[2][4];
      pn_dp(j0, masked, pn, dp);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pn[t][e] = tc_ds(pn[t][e], dp[t][e], d0, scale);
          pn[t][2 + e] = tc_ds(pn[t][2 + e], dp[t][2 + e], d1, scale);
        }
      uint32_t dsa[4];
      tc_c_to_a(pn, dsa);
      tc_acc_rows(dsa, K, j0, sp.ke, zero, dq);
    });
    tc_store_rows(dq, 1.f, 1.f, [&](int r) { return dst(sp.r0 + r); }, sp.nrows);
    // the strip's own rows (with one sequence, its 16: the key pass reads
    // them, masked); where strips pack sequences and one holds fewer than
    // 16 rows, the rows after them are the next strip's
    if ((lane & 3) == 0) {
      if (kOne || g < sp.nrows) {
        row_max[sp.r0 + g] = m0;
        row_inv[sp.r0 + g] = inv0;
        row_delta[sp.r0 + g] = d0;
      }
      if (kOne || g + 8 < sp.nrows) {
        row_max[sp.r0 + g + 8] = m1;
        row_inv[sp.r0 + g + 8] = inv1;
        row_delta[sp.r0 + g + 8] = d1;
      }
    }
  }
  __syncthreads();

  // -- key strips: the strip's rows as keys against their queries [kb, ke) --
  for (int st = warp; st < nstrips; st += nw) {
    const TcSpan sp = span(st);
    const int k0 = sp.r0, nkeys = sp.nrows;
    int lo0 = 0, lo1 = 0, hi0 = L, hi1 = L;  // one sequence: every key meets [0, L)
    if constexpr (!kOne) {  // the queries of keys k0 + g and k0 + g + 8: their sequence's
      lo0 = (sp.r0 + g) / L * L; lo1 = (sp.r0 + g + 8) / L * L; hi0 = lo0 + L; hi1 = lo1 + L;
    }
    uint32_t ka[KC][4], va[KC][4];
    tc_load_a(K, k0, nkeys, zero, ka);
    tc_load_a(V, k0, nkeys, zero, va);
    float dk[NT][4], dv[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;
    tc_blocks16<kRows>(sp.kb, sp.ke, [&](int i0, auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
      // pt[t][e]: key row g (+ 8 for e >= 2), query i0 + 8 t + col + (e & 1)
      float pt[2][4], dpt[2][4];
      tc_dot_rows(ka, Q, i0, sp.ke, zero, pt);
      tc_dot_rows(va, dA, i0, sp.ke, zero, dpt);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i = i0 + 8 * t + col;  // queries i and i + 1
        float m[2], inv[2], dl[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          // with one sequence every row of the strips was written; else
          // the query strips wrote [kb, ke)
          const int ir = kRows == kOneSeq || i + x < sp.ke ? i + x : sp.ke - 1;
          m[x] = row_max[ir];
          inv[x] = row_inv[ir];
          dl[x] = row_delta[ir];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = e & 1;
          const bool ok = !kMasked || (e < 2 ? i + x >= lo0 && i + x < hi0
                                             : i + x >= lo1 && i + x < hi1);
          const float p = ok ? bf16_round(__expf(fmaf(pt[t][e], scale, -m[x])) * inv[x]) : 0.f;
          pt[t][e] = p;
          dpt[t][e] = ok ? tc_ds(p, dpt[t][e], dl[x], scale) : 0.f;
        }
      }
      uint32_t pa[4], dsa[4];
      tc_c_to_a(pt, pa);
      tc_c_to_a(dpt, dsa);
      tc_acc_rows(pa, dA, i0, sp.ke, zero, dv);
      tc_acc_rows(dsa, Q, i0, sp.ke, zero, dk);
    });
    tc_store_rows(dk, 1.f, 1.f, [&](int r) { return dst(k0 + r) + D; }, nkeys);
    tc_store_rows(dv, 1.f, 1.f, [&](int r) { return dst(k0 + r) + 2 * D; }, nkeys);
  }
}

// ---------------------------------------------------------------------------
// The backward of tc_prefix_attn, with its addressing: sequence s is
// [prefix row s / S_lo, grid rows s*N .. s*N + N - 1] of the (rows, 3D) qkv
// buffers, its cotangent rows [da_pre row s, da rows s*N ..] (D wide), its
// gradient rows [dqkv_pre row s, dqkv rows s*N ..] (3D wide: dq | dk |
// dv): the prefix row's dq, dk and dv go to one row per sequence, which
// the caller sums. One block per (head, sequence), heads fastest: one
// sequence of L = N + 1 rows (the prefix as row 0) through tc_bwd_strips,
// 103 KB at L = 197, hd 64, so two blocks an SM (attn_bwd_kernel's L x L
// probabilities took 185 KB, one block).
// ---------------------------------------------------------------------------

// Shared bytes of one block at L rows, head dim hd.
__host__ __device__ inline size_t tc_prefix_bwd_smem(int L, int hd) {
  return tc_bwd_smem(1, L, hd);
}

template <int HD>
__device__ __forceinline__ void tc_prefix_attn_bwd_block(
    const bf16* __restrict__ qkv, const bf16* __restrict__ qkv_pre,
    const bf16* __restrict__ da, const bf16* __restrict__ da_pre, bf16* __restrict__ dqkv,
    bf16* __restrict__ dqkv_pre, int N, int S_lo, int H, float scale) {
  constexpr int CH = HD / 8;  // 16-byte chunks per head row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, s = blockIdx.y;
  const int L = N + 1, D = H * HD;
  const long row_w = 3L * D;
  bf16* zero = reinterpret_cast<bf16*>(smem_raw);
  bf16* base = zero + 8;
  const int swz = tc_swizzle(CH);
  const TcRows Q{base, CH, swz, 0, 0};
  const TcRows K{base + (long)L * HD, CH, swz, 0, 0};
  const TcRows V{base + (long)2 * L * HD, CH, swz, 0, 0};
  const TcRows dA{base + (long)3 * L * HD, CH, swz, 0, 0};
  // sequence row r: the prefix row (r = 0) or grid row r - 1, this head
  auto src = [&](int r) {
    return (r == 0 ? qkv_pre + (long)(s / S_lo) * row_w
                   : qkv + ((long)s * N + r - 1) * row_w) + h * HD;
  };
  auto dsrc = [&](int r) {
    return (r == 0 ? da_pre + (long)s * D : da + ((long)s * N + r - 1) * D) + h * HD;
  };
  auto dst = [&](int r) -> bf16* {  // row r's gradient row, at this head's dq
    return (r == 0 ? dqkv_pre + (long)s * row_w : dqkv + ((long)s * N + r - 1) * row_w) +
           h * HD;
  };
  for (int idx = threadIdx.x; idx < L * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx - r * CH;
    const bf16* p = src(r) + c * 8;
    cp_async16(Q.at(r, c), p, 16);
    cp_async16(K.at(r, c), p + D, 16);
    cp_async16(V.at(r, c), p + 2 * D, 16);
    cp_async16(dA.at(r, c), dsrc(r) + c * 8, 16);
  }
  cp_async_commit();
  if (threadIdx.x == 0) *reinterpret_cast<uint4*>(zero) = make_uint4(0u, 0u, 0u, 0u);
  cp_async_wait<0>();
  __syncthreads();
  tc_bwd_strips<HD, kOneSeq>(Q, K, V, dA, zero, reinterpret_cast<float*>(base + (long)4 * L * HD),
                          1, L, D, scale, dst);
}

// Two blocks an SM at L = 197, hd 64 (103 KB each): at most 144 registers
// a thread for seven warps.
template <int HD>
__global__ void __launch_bounds__(kTcStrips * 32, 2)
tc_prefix_attn_bwd_kernel(const bf16* qkv, const bf16* qkv_pre, const bf16* da,
                          const bf16* da_pre, bf16* dqkv, bf16* dqkv_pre, int N, int S_lo,
                          int H, float scale) {
  tc_prefix_attn_bwd_block<HD>(qkv, qkv_pre, da, da_pre, dqkv, dqkv_pre, N, S_lo, H, scale);
}

template <int HD>
cudaError_t tc_prefix_attn_bwd_launch(const bf16* qkv, const bf16* qkv_pre, const bf16* da,
                                      const bf16* da_pre, bf16* dqkv, bf16* dqkv_pre, int S,
                                      int S_lo, int N, int H, float scale, cudaStream_t st) {
  if (S <= 0) return cudaSuccess;
  if (S > 65535 || S_lo <= 0 || S % S_lo) return cudaErrorInvalidValue;
  const int L = N + 1;
  const size_t smem = tc_prefix_bwd_smem(L, HD);
  static SmemGrant grant;
  cudaError_t e;
  if ((e = smem_opt_in(tc_prefix_attn_bwd_kernel<HD>, smem, grant))) return e;
  tc_prefix_attn_bwd_kernel<HD><<<dim3(H, S), tc_warps(tc_strips(1, L)) * 32, smem, st>>>(
      qkv, qkv_pre, da, da_pre, dqkv, dqkv_pre, N, S_lo, H, scale);
  return cudaGetLastError();
}

// The backward of tc_prefix_attn over its S sequences: qkv, qkv_pre as
// there, da (S*N, D) and da_pre (S, D) -> dqkv (S*N, 3D) and dqkv_pre (S,
// 3D), at head dim hd and logit scale `scale`.
inline cudaError_t tc_prefix_attn_bwd(int hd, const bf16* qkv, const bf16* qkv_pre,
                                      const bf16* da, const bf16* da_pre, bf16* dqkv,
                                      bf16* dqkv_pre, int S, int S_lo, int N, int H,
                                      float scale, cudaStream_t st) {
#define DVST_TCB_CASE(HDV)                                                                 \
  case HDV:                                                                                \
    return tc_prefix_attn_bwd_launch<HDV>(qkv, qkv_pre, da, da_pre, dqkv, dqkv_pre, S, S_lo, \
                                          N, H, scale, st);
  switch (hd) {
    DVST_TCB_CASE(16)
    DVST_TCB_CASE(32)
    DVST_TCB_CASE(48)
    DVST_TCB_CASE(64)
    DVST_TCB_CASE(80)
    DVST_TCB_CASE(96)
    DVST_TCB_CASE(112)
    DVST_TCB_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DVST_TCB_CASE
}

#endif  // DVST_WITH_BACKWARD

// ---------------------------------------------------------------------------
// Temporal attention at stride N (dvst_temporal_phase_tm's, fused_block.cu):
// sequence s = b*N + n at head h is the T rows (b*T + t)*N + n of the
// (B*T*N, 3D) qkv buffer (q | k | v, heads contiguous inside each), and
// its output row t goes to the same row of the (B*T*N, D) output. N = 1
// is S contiguous sequences of T rows (dvst_temporal_phase). Q, K and V
// are read straight from the qkv buffer by address (cp.async, 16 bytes a
// thread): no transpose in device memory, no copy to a buffer. One block
// per (head, group of G consecutive sequences), heads fastest; the group
// and its strips are the standalone attention's (tc_group, tc_strips
// above): G = 3 at T = 30 (6 strips), 35 at T = 3 (7 strips of 5
// sequences each, every row's keys masked to its own sequence), 1 at T =
// 197. G consecutive sequences of one b read, at each t, one contiguous
// run of G rows. The tile's numerics: f32 scores, the whole row's max
// first, bf16 P, an f32 sum of the unrounded exponentials. Bound by bytes
// (qkv read once, out written once: 0.086 ms at the teacher window).
// ---------------------------------------------------------------------------

template <int HD>
__device__ __forceinline__ void tc_strided_attn_block(const bf16* __restrict__ qkv,
                                                      bf16* __restrict__ out, int S,
                                                      int T, int N, int H, int G,
                                                      float scale) {
  constexpr int CH = HD / 8;  // 16-byte chunks per head row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x % H;
  const int s0 = blockIdx.x / H * G;  // the block's first sequence
  const int nseq = S - s0 < G ? S - s0 : G;
  const int L = T, R = nseq * L;
  const int D = H * HD;
  const long row_w = 3L * D;
  bf16* zero = reinterpret_cast<bf16*>(smem_raw);
  bf16* qs = zero + 8;
  const int swz = tc_swizzle(CH);
  const TcRows Q{qs, CH, swz, 0, 0};
  const TcRows K{qs + (long)G * L * HD, CH, swz, 0, 0};
  const TcRows V{qs + (long)2 * G * L * HD, CH, swz, 0, 0};
  // stored row r = g*L + t: sequence s0 + g at time t, buffer row
  // (b*T + t)*N + n; at N = 1 (contiguous sequences) that is s0*T + r,
  // with no division on the copy and store paths
  auto row = [&](int r) -> long {
    if (N == 1) return (long)s0 * T + r;
    const int g = r / L, t = r - g * L;
    const int s = s0 + g, b = s / N;
    return ((long)b * T + t) * N + (s - b * N);
  };
  // two copy groups: Q and K, which the max pass reads, then V, which
  // arrives while it runs
  for (int idx = threadIdx.x; idx < R * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx - r * CH;
    const bf16* p = qkv + row(r) * row_w + h * HD + c * 8;
    cp_async16(Q.at(r, c), p, 16);
    cp_async16(K.at(r, c), p + D, 16);
  }
  cp_async_commit();
  for (int idx = threadIdx.x; idx < R * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx - r * CH;
    cp_async16(V.at(r, c), qkv + row(r) * row_w + 2 * D + h * HD + c * 8, 16);
  }
  cp_async_commit();
  if (threadIdx.x == 0) *reinterpret_cast<uint4*>(zero) = make_uint4(0u, 0u, 0u, 0u);
  cp_async_wait<1>();
  __syncthreads();

  tc_seq_strips<HD>(Q, K, V, zero, nseq, L, scale,
                    [&](int r) { return out + row(r) * D + h * HD; });
}

// At hd <= 64 capped at 96 registers a thread (row 13's measured optimum:
// three 7-warp blocks an SM at L = 197); above, uncapped.
template <int HD>
__global__ void __maxnreg__(96)
tc_strided_attn_kernel_narrow(const bf16* qkv, bf16* out, int S, int T, int N, int H,
                              int G, float scale) {
  tc_strided_attn_block<HD>(qkv, out, S, T, N, H, G, scale);
}

template <int HD>
__global__ void __launch_bounds__(kTcStrips * 32)
tc_strided_attn_kernel_wide(const bf16* qkv, bf16* out, int S, int T, int N, int H,
                            int G, float scale) {
  tc_strided_attn_block<HD>(qkv, out, S, T, N, H, G, scale);
}

template <int HD>
cudaError_t tc_strided_attn_launch(const bf16* qkv, bf16* out, int B, int T, int N,
                                   int H, float scale, cudaStream_t st) {
  const long S = (long)B * N;
  if (S <= 0 || T <= 0) return cudaSuccess;
  if (S > (1L << 30)) return cudaErrorInvalidValue;
  const int G = tc_group((int)S, T);
  const long blocks = (S + G - 1) / G * H;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  const int warps = tc_warps(tc_strips(G, T));
  const size_t smem = tc_smem(G, T, HD);
  static SmemGrant grant;
  cudaError_t e;
  if constexpr (HD <= 64) {
    if ((e = smem_opt_in(tc_strided_attn_kernel_narrow<HD>, smem, grant))) return e;
    tc_strided_attn_kernel_narrow<HD><<<(unsigned)blocks, warps * 32, smem, st>>>(
        qkv, out, (int)S, T, N, H, G, scale);
  } else {
    if ((e = smem_opt_in(tc_strided_attn_kernel_wide<HD>, smem, grant))) return e;
    tc_strided_attn_kernel_wide<HD><<<(unsigned)blocks, warps * 32, smem, st>>>(
        qkv, out, (int)S, T, N, H, G, scale);
  }
  return cudaGetLastError();
}

// The B*N sequences of T rows at stride N of qkv (B*T*N, 3D) at head dim
// hd and logit scale `scale` -> out (B*T*N, D).
inline cudaError_t tc_strided_attn(int hd, const bf16* qkv, bf16* out, int B, int T,
                                   int N, int H, float scale, cudaStream_t st) {
#define DVST_TCS_CASE(HDV) \
  case HDV:                \
    return tc_strided_attn_launch<HDV>(qkv, out, B, T, N, H, scale, st);
  switch (hd) {
    DVST_TCS_CASE(16)
    DVST_TCS_CASE(32)
    DVST_TCS_CASE(48)
    DVST_TCS_CASE(64)
    DVST_TCS_CASE(80)
    DVST_TCS_CASE(96)
    DVST_TCS_CASE(112)
    DVST_TCS_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DVST_TCS_CASE
}

#ifdef DVST_WITH_BACKWARD

// ---------------------------------------------------------------------------
// The backward of tc_strided_attn (dvst_temporal_phase_tm_bwd's,
// fused_block_bwd.cu): sequence s = b*N + n at head h is the T rows (b*T +
// t)*N + n of the (B*T*N, 3D) qkv buffer; its cotangent rows are the same
// rows of da (B*T*N, D), its gradient rows (dq | dk | dv) the same rows of
// dqkv (B*T*N, 3D). One block per (head, group of G consecutive
// sequences), numbered as the forward's (heads fastest, a flat
// blockIdx.x; tc_group's G: 14 sequences of T = 8, two to a strip, seven
// strips), through tc_bwd_strips with every row masked to its own
// sequence in both passes. 58.7 KB a block at T = 8, hd 64; two blocks an
// SM by registers, as the prefix backward (the key strips hold dk and dv,
// 64 floats a thread). Bound by bytes at T = 8: qkv and da read once,
// dqkv written once, 0.08 ms at the train step's global crops.
// ---------------------------------------------------------------------------

template <int HD, int kRows>
__device__ __forceinline__ void tc_strided_attn_bwd_block(const bf16* __restrict__ qkv,
                                                          const bf16* __restrict__ da,
                                                          bf16* __restrict__ dqkv, int S, int T,
                                                          int N, int H, int G, float scale) {
  constexpr int CH = HD / 8;  // 16-byte chunks per head row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x % H;
  const int s0 = blockIdx.x / H * G;  // the block's first sequence
  const int nseq = S - s0 < G ? S - s0 : G;
  const int L = T, R = nseq * L, D = H * HD;
  const long row_w = 3L * D;
  bf16* zero = reinterpret_cast<bf16*>(smem_raw);
  bf16* base = zero + 8;
  const int swz = tc_swizzle(CH);
  const TcRows Q{base, CH, swz, 0, 0};
  const TcRows K{base + (long)G * L * HD, CH, swz, 0, 0};
  const TcRows V{base + (long)2 * G * L * HD, CH, swz, 0, 0};
  const TcRows dA{base + (long)3 * G * L * HD, CH, swz, 0, 0};
  // stored row r: sequence s0 + r / L at time r % L
  auto row = [&](int r) -> long {
    const int s = s0 + r / L, b = s / N;
    return ((long)b * T + r % L) * N + s % N;
  };
  for (int idx = threadIdx.x; idx < R * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx - r * CH;
    const long rr = row(r);
    const bf16* p = qkv + rr * row_w + h * HD + c * 8;
    cp_async16(Q.at(r, c), p, 16);
    cp_async16(K.at(r, c), p + D, 16);
    cp_async16(V.at(r, c), p + 2 * D, 16);
    cp_async16(dA.at(r, c), da + rr * D + h * HD + c * 8, 16);
  }
  cp_async_commit();
  if (threadIdx.x == 0) *reinterpret_cast<uint4*>(zero) = make_uint4(0u, 0u, 0u, 0u);
  cp_async_wait<0>();
  __syncthreads();
  tc_bwd_strips<HD, kRows>(Q, K, V, dA, zero, reinterpret_cast<float*>(base + (long)4 * G * L * HD),
                           nseq, L, D, scale, [&](int r) { return dqkv + row(r) * row_w + h * HD; });
}

// kRows: kPackedStrips where T < 16, kSeqStrips otherwise.
template <int HD, int kRows>
__global__ void __launch_bounds__(kTcStrips * 32, 2)
tc_strided_attn_bwd_kernel(const bf16* qkv, const bf16* da, bf16* dqkv, int S, int T, int N,
                           int H, int G, float scale) {
  tc_strided_attn_bwd_block<HD, kRows>(qkv, da, dqkv, S, T, N, H, G, scale);
}

template <int HD, int kRows>
cudaError_t tc_strided_attn_bwd_go(const bf16* qkv, const bf16* da, bf16* dqkv, int S, int T,
                                   int N, int H, int G, long blocks, float scale,
                                   cudaStream_t st) {
  const size_t smem = tc_bwd_smem(G, T, HD);
  static SmemGrant grant;
  cudaError_t e;
  if ((e = smem_opt_in(tc_strided_attn_bwd_kernel<HD, kRows>, smem, grant))) return e;
  tc_strided_attn_bwd_kernel<HD, kRows>
      <<<(unsigned)blocks, tc_warps(tc_strips(G, T)) * 32, smem, st>>>(qkv, da, dqkv, S, T, N,
                                                                          H, G, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t tc_strided_attn_bwd_launch(const bf16* qkv, const bf16* da, bf16* dqkv, int B, int T,
                                       int N, int H, float scale, cudaStream_t st) {
  const long S = (long)B * N;
  if (S <= 0 || T <= 0) return cudaSuccess;
  if (S > (1L << 30)) return cudaErrorInvalidValue;
  const int G = tc_group((int)S, T);
  const long blocks = (S + G - 1) / G * H;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  return T < 16 ? tc_strided_attn_bwd_go<HD, kPackedStrips>(qkv, da, dqkv, (int)S, T, N, H, G,
                                                             blocks, scale, st)
                : tc_strided_attn_bwd_go<HD, kSeqStrips>(qkv, da, dqkv, (int)S, T, N, H, G,
                                                          blocks, scale, st);
}

// The backward of tc_strided_attn over the B*N sequences of T rows at
// stride N: qkv (B*T*N, 3D) and da (B*T*N, D) -> dqkv (B*T*N, 3D), at head
// dim hd and logit scale `scale`.
inline cudaError_t tc_strided_attn_bwd(int hd, const bf16* qkv, const bf16* da, bf16* dqkv,
                                       int B, int T, int N, int H, float scale,
                                       cudaStream_t st) {
#define DVST_TCSB_CASE(HDV) \
  case HDV:                 \
    return tc_strided_attn_bwd_launch<HDV>(qkv, da, dqkv, B, T, N, H, scale, st);
  switch (hd) {
    DVST_TCSB_CASE(16)
    DVST_TCSB_CASE(32)
    DVST_TCSB_CASE(48)
    DVST_TCSB_CASE(64)
    DVST_TCSB_CASE(80)
    DVST_TCSB_CASE(96)
    DVST_TCSB_CASE(112)
    DVST_TCSB_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DVST_TCSB_CASE
}

#endif  // DVST_WITH_BACKWARD

}  // namespace
