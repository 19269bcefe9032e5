// The Hopper GEMM of the port's spatial ops: out[M, N] = epilogue(A[M, K] .
// W[N, K]^T + bias[N]), A row-major bf16, W an nn.Linear weight (out, in)
// bf16, f32 accumulation, with dvst_common.cuh's epilogues (Epi) at the
// twins' rounding points. Used by dvst_spatial_mlp, dvst_temporal_phase_tm
// (and dvst_temporal_phase), dvst_spatial_phase, dvst_mlp_phase and
// dvst_attn_phase (fused_block.cu) and dvst_spatial_pf (banded_block.cu)
// for all their products.
//
// The backwards' products run on the same kernel (fused_block_bwd.cu's
// dvst_temporal_phase_tm_bwd, dvst_spatial_phase_bwd and
// dvst_mlp_phase_bwd, under DVST_WITH_BACKWARD): dX = dY . W reads the
// weight (out, in) as it is stored, an MN-major B operand (wg_gemm_dx);
// dW = dY^T . X reads both operands as stored, (rows, out) and (rows, in),
// MN-major A and B, its reduction over the rows cut into splits whose f32
// partials reduce_splits adds in a fixed order (wg_gemm_dw).
//
// Bound by operations at the port's shapes (K = 768 or 3072: ~250-600 FLOP
// per byte moved), except where a K = 768 product reads a residual and
// writes an f32 sum (the spatial op's proj, f32 residual: ~150 FLOP/B; the
// temporal op's fc, bf16 residual: ~190 FLOP/B): bound by bytes.
//
// Design (warp-specialised, persistent):
// * Tiles of 128 x BN outputs, BN = 256 where N allows it, else 128 (N is
//   a multiple of 128). Grid: one block per SM (at most the tile count);
//   block b takes tiles b, b + grid, ..., N-tiles fastest, so the blocks in
//   flight together share their A rows in L2 (W fits L2 whole).
// * A ring of 64-deep K stages in shared memory (4 at BN 256, 6 at 128;
//   192 KB), each stage one TMA load of A (128 x 64) and one of W (BN x
//   64), 128-byte swizzled as wgmma reads them. The ragged M edge: TMA
//   fills rows past M with zeros on load, and the epilogue masks them.
// * mbarriers per stage: "full" (the producer's expected bytes, completed
//   by TMA) and "empty" (one arrival per consumer warpgroup).
// * Warpgroup 2 is the producer: one thread issues the loads, its
//   warpgroup keeps 40 registers a thread. Warpgroups 0 and 1 are the
//   consumers (232 registers): each issues wgmma.mma_async m64nBNk16 on
//   its 64 rows of the tile, keeps one group of four in flight, frees a
//   stage when its group has retired, and at the tile's end applies the
//   epilogue from registers straight to device memory: the quad of lanes
//   holding a row trades its column pairs (two shuffle rounds) so each
//   lane loads its residual and stores its output 8 columns (16 bytes of
//   bf16) at a time; a residual is prefetched into L2 when the tile
//   begins and read in batches of four loads ahead of their stores
//   (2-element stores, eight rows a warp instruction, and one residual
//   load at a time behind each store left the tensor cores idle for most
//   of an epilogue-heavy tile: PERF.md).
// * Tensor maps come from cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint (no -lcuda), and go to the kernel as
//   __grid_constant__ parameters.
// * MN-major operands (AMN, BMN): an operand stored with the reduction as
//   its row index, (K, M) or (K, N), loads as boxes of 64 columns x 64 K
//   rows, one 128-byte swizzle atom of MN per box and the boxes of a stage
//   8 KB apart; wgmma reads them with its transpose bit and the MN-major
//   descriptor (wg_desc_mn). Work items are (split, tile) pairs, tiles
//   fastest: split z reduces K stages [z * kchunk, (z + 1) * kchunk) and
//   writes partial z, whichever block takes it, so the sums are the same
//   on every call.
//
// The s8 instance (Q8, wg_gemm_s8): the int8 tier's products, A (M, K) s8
// row codes and W (N, K) s8 channel codes, both K-major (8-bit wgmma has
// no transpose bit), summed exactly in s32 by
// wgmma.mma_async.m64nBNk32.s32.s8.s8. A 128-deep s8 stage is 128 bytes a
// row, as a 64-deep bf16 stage is, so the ring, the 128-byte TMA swizzle,
// the descriptors' byte strides and the four wgmma a stage carry over
// (each k32 step 32 bytes on, as each bf16 k16 step). The epilogue first
// dequantizes each sum as f32(acc) * sx[row] * sw[col] + bias[col], left
// to right with no FMA contraction (the twin's order, so the f32 result is
// bit-equal to it), then applies the same Epi codes. Bound by operations
// at the port's shapes (K = 768 or 3072) at the s8 peak (1979 TOPS), half
// the time of the bf16 product; a simple first form, its quantization in
// separate row passes (dvst_common.cuh's ln_quant_kernel and
// quant_rows_kernel).

#pragma once

#include <cuda.h>  // CUtensorMap and the encode function's types (header only)

#include <type_traits>

#include "dvst_common.cuh"

namespace {

constexpr int kWgBM = 128;       // rows per tile: two consumer warpgroups of 64
constexpr int kWgBK = 64;        // K per stage: one 128-byte swizzled row of bf16
                                 // (128 deep in the s8 instance)
constexpr int kWgThreads = 384;  // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int kWgRing = 196608;  // bytes of the stage ring

template <int BN>
struct WgShape {
  static constexpr int kA = kWgBM * kWgBK * 2;  // A bytes of a stage
  static constexpr int kB = BN * kWgBK * 2;     // W bytes of a stage
  static constexpr int kStage = kA + kB;
  static constexpr int kStages = kWgRing / kStage;
  // the ring, its barriers, and slack to align the ring to 1024 bytes
  // (the 128-byte swizzle's period)
  static constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;
};

__device__ __forceinline__ uint32_t wg_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spins until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA load of the box at (c0, c1) (K, row) of `map` into `dst`,
// completing `bar`'s expected bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzled
// (TMA's CU_TENSOR_MAP_SWIZZLE_128B): 8-row groups 1024 bytes apart. The
// next 16-deep K slice starts 32 bytes on (+2 in the address field).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma descriptor of an MN-major tile (TMA boxes of 64 MN columns x 64 K
// rows, 128-byte swizzled): the leading byte offset is the stride between
// 64-wide MN atoms (the next box, kWgMnLbo), the stride byte offset that
// between groups of 8 K rows (kWgMnSbo). The next 16-deep K slice starts
// 16 rows on: 2048 bytes (+128 in the address field).
constexpr uint32_t kWgMnLbo = 8192;  // one box: 64 K rows x 128 bytes
constexpr uint32_t kWgMnSbo = 1024;  // 8 K rows x 128 bytes

__device__ __forceinline__ uint64_t wg_desc_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kWgMnLbo >> 4) << 16) | ((uint64_t)(kWgMnSbo >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// wgmma issue / retire points.
template <int R>
__device__ __forceinline__ void wg_fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void wg_fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x n, f32) += A (64 x 16, descriptor da) . B (16 x n, descriptor db);
// TA / TB: 1 where that operand is MN-major (wgmma's transpose bits).
template <int TA, int TB>
__device__ __forceinline__ void wg_mma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wg_mma(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, %131, %132;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x n, s32) += A (64 x 32, s8, descriptor da) . B (32 x n, s8,
// descriptor db), both K-major: the s8 instance's product, exact.
__device__ __forceinline__ void wg_mma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wg_mma_s8(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t wg_pack(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// A quad's 4 x 4 words transposed in two butterfly rounds: lane q's x[t]
// (column pair q of n8 tile t) becomes column pair t of tile q, so each
// lane then owns 8 consecutive columns of its row.
__device__ __forceinline__ void wg_quad_transpose(uint32_t (&x)[4], int q) {
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
}

template <int EPI>
struct WgEpi {
  // the residual's bytes per element (0: none)
  static constexpr int kRes = EPI == kEpiResBf16F32 || EPI == kEpiAddBf16 ? 2
                              : EPI == kEpiResF32F32 || EPI == kEpiResF32Bf16 ||
                                        EPI == kEpiMulF32Bf16
                                  ? 4
                                  : 0;
  static constexpr bool kF32Out = EPI == kEpiResBf16F32 || EPI == kEpiResF32F32 || EPI == kEpiF32;
  // rounded to bf16 before anything else (kEpiAddBf16: the branch, before the add)
  static constexpr bool kRoundFirst = EPI == kEpiBf16 || EPI == kEpiGeluBf16 || EPI == kEpiAddBf16;
};

// Epilogue, first pass, of one row's 32 columns held by a quad: lo[t],
// hi[t] are the f32 sums acc + bias at columns 8 t + 2 q and 8 t + 2 q + 1
// of the group; after the transpose the lane owns columns 8 q .. 8 q + 7
// (row-major index o). An epilogue without a residual stores them
// (16 bytes of bf16, or 32 of f32); one with a residual leaves them in
// v[8] for the second pass. The twins' rounding points.
// kEpiGeluBf16GradF32 stores two outputs: the bf16 GELU to out, its f32
// derivative to res.
template <int EPI>
__device__ __forceinline__ void wg_epilogue8(void* out, const void* res, size_t o, bool live,
                                             float (&lo)[4], float (&hi)[4], int q,
                                             float (&v)[8]) {
  if constexpr (EPI == kEpiGeluBf16GradF32) {
    uint32_t x[4], gl[4], gh[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      x[t] = wg_pack(gelu_erf(lo[t]), gelu_erf(hi[t]));
      gl[t] = __float_as_uint(gelu_erf_grad(lo[t]));
      gh[t] = __float_as_uint(gelu_erf_grad(hi[t]));
    }
    wg_quad_transpose(x, q);
    wg_quad_transpose(gl, q);
    wg_quad_transpose(gh, q);
    if (live) {
      *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + o) = make_uint4(x[0], x[1], x[2], x[3]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        v[2 * t] = __uint_as_float(gl[t]);
        v[2 * t + 1] = __uint_as_float(gh[t]);
      }
      store8(const_cast<float*>(static_cast<const float*>(res)) + o, v);
    }
    return;
  }
  if constexpr (EPI == kEpiGeluBf16) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      lo[t] = gelu_erf(lo[t]);
      hi[t] = gelu_erf(hi[t]);
    }
  }
  if constexpr (WgEpi<EPI>::kRoundFirst) {
    uint32_t x[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) x[t] = wg_pack(lo[t], hi[t]);
    wg_quad_transpose(x, q);
    if constexpr (WgEpi<EPI>::kRes == 0) {
      if (live)
        *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + o) = make_uint4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[t]));
        v[2 * t] = f.x;
        v[2 * t + 1] = f.y;
      }
    }
  } else {
    uint32_t xl[4], xh[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      xl[t] = __float_as_uint(lo[t]);
      xh[t] = __float_as_uint(hi[t]);
    }
    wg_quad_transpose(xl, q);
    wg_quad_transpose(xh, q);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      v[2 * t] = __uint_as_float(xl[t]);
      v[2 * t + 1] = __uint_as_float(xh[t]);
    }
    if constexpr (WgEpi<EPI>::kRes == 0) {
      if (live) store8(static_cast<float*>(out) + o, v);
    }
  }
}

// Second pass: v += the residual's 8 elements at o (kEpiMulF32Bf16: v *=),
// stored in the output's type.
template <int EPI>
__device__ __forceinline__ void wg_load_res8(const void* res, size_t o, float (&r)[8]) {
  if constexpr (WgEpi<EPI>::kRes == 2)
    load8(static_cast<const bf16*>(res) + o, r);
  else
    load8(static_cast<const float*>(res) + o, r);
}

template <int EPI>
__device__ __forceinline__ void wg_store_res8(void* out, size_t o, const float (&v)[8],
                                              const float (&r)[8]) {
  float s[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = EPI == kEpiMulF32Bf16 ? r[e] * v[e] : r[e] + v[e];
  if constexpr (WgEpi<EPI>::kF32Out)
    store8(static_cast<float*>(out) + o, s);
  else
    store8(static_cast<bf16*>(out) + o, s);
}

// The s8 instance's sums kept in their accumulator registers between the
// epilogue's two passes (as the f32 sums are kept in theirs): the bits of
// the f32 value.
__device__ __forceinline__ void wg_keep(float& d, float v) { d = v; }
__device__ __forceinline__ void wg_keep(int& d, float v) { d = __float_as_int(v); }
__device__ __forceinline__ float wg_kept(float d) { return d; }
__device__ __forceinline__ float wg_kept(int d) { return __int_as_float(d); }

// Q8: A and W s8 codes, sx (M) and sw (N) their f32 scales (null otherwise).
template <int BN, int EPI, bool AMN, bool BMN, bool Q8 = false>
__global__ void __launch_bounds__(kWgThreads, 1)
wg_gemm_kernel(const __grid_constant__ CUtensorMap tmA,
               const __grid_constant__ CUtensorMap tmW, const float* __restrict__ bias,
               const void* __restrict__ res, void* __restrict__ out, int M, int N,
               int K, int kchunk, int splits, long split_stride,
               const float* __restrict__ sx, const float* __restrict__ sw) {
  using S = WgShape<BN>;
  static_assert(!Q8 || (!AMN && !BMN), "8-bit wgmma reads K-major operands only");
  constexpr int kBK = Q8 ? 2 * kWgBK : kWgBK;  // K of a 128-byte stage row
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  const uint32_t ring = (wg_smem_u32(wg_smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + S::kStages * S::kStage;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (S::kStages + s); };
  // Only dW (MN-major A) splits its reduction, and only the products
  // with a K-major weight (the forwards' and row 9's fc1) have a bias: the
  // other instances carry neither through their mainloop.
  constexpr bool kSplit = AMN, kBias = !BMN;
  const int n_tiles = N / BN;
  const int tiles = (M + kWgBM - 1) / kWgBM * n_tiles;
  const int work = kSplit ? tiles * splits : tiles;  // (split, tile) items, tiles fastest
  const int nk = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full, across tile boundaries
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int w = blockIdx.x; w < work; w += gridDim.x) {
        const int t = kSplit ? w % tiles : w, z = kSplit ? w / tiles : 0;
        const int m0 = t / n_tiles * kWgBM, n0 = t % n_tiles * BN;
        const int k1 = kSplit && (z + 1) * kchunk < nk ? (z + 1) * kchunk : nk;
        for (int kt = z * kchunk; kt < k1; ++kt) {
          mbar_wait(empty(s), ph ^ 1u);
          const uint32_t a = ring + s * S::kStage;
          const int k0 = kt * kBK;
          mbar_expect_tx(full(s), S::kStage);
          if constexpr (AMN) {  // two boxes of 64 rows of M
            tma_load_2d(a, &tmA, full(s), m0, k0);
            tma_load_2d(a + kWgMnLbo, &tmA, full(s), m0 + 64, k0);
          } else {
            tma_load_2d(a, &tmA, full(s), k0, m0);
          }
          if constexpr (BMN) {  // BN / 64 boxes of 64 columns of N
#pragma unroll
            for (int i = 0; i < BN / 64; ++i)
              tma_load_2d(a + S::kA + i * kWgMnLbo, &tmW, full(s), n0 + 64 * i, k0);
          } else {
            tma_load_2d(a + S::kA, &tmW, full(s), k0, n0);
          }
          if (++s == S::kStages) {
            s = 0;
            ph ^= 1u;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg computes rows 64 wg .. 64 wg + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x & 127;
    const int g = (tid & 31) >> 2, q = tid & 3;
    // K-major: the next 16-deep slice is 32 bytes on; MN-major: 16 rows on
    constexpr uint64_t kStepA = AMN ? 128 : 2, kStepB = BMN ? 128 : 2;
    std::conditional_t<Q8, int, float> acc[BN / 2];
    int s = 0;
    uint32_t ph = 0;
    for (int w = blockIdx.x; w < work; w += gridDim.x) {
      const int t = kSplit ? w % tiles : w, z = kSplit ? w / tiles : 0;
      const int m0 = t / n_tiles * kWgBM, n0 = t % n_tiles * BN;
      const int k0t = z * kchunk;
      const int k1 = kSplit && (z + 1) * kchunk < nk ? (z + 1) * kchunk : nk;
      const int row0 = m0 + wg * 64 + (tid >> 5) * 16 + g;
      if constexpr (WgEpi<EPI>::kRes != 0) {
        // the residual lines of this lane's two rows, into L2 while the
        // mainloop runs: the quad's lanes take every fourth 128-byte line
        constexpr int kLines = BN * WgEpi<EPI>::kRes / 128;
        const char* rb = static_cast<const char*>(res);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int l = q; l < kLines; l += 4)
            if (row0 + 8 * h < M)
              asm volatile("prefetch.L2 [%0];\n" ::"l"(
                  rb + ((size_t)(row0 + 8 * h) * N + n0) * WgEpi<EPI>::kRes + l * 128));
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      wg_fence_operands(acc);
      int prev = 0;
      for (int kt = k0t; kt < k1; ++kt) {
        mbar_wait(full(s), ph);
        const uint32_t a = ring + s * S::kStage;
        const uint64_t da = AMN ? wg_desc_mn(a + wg * kWgMnLbo) : wg_desc(a + wg * (64 * 128));
        const uint64_t db = BMN ? wg_desc_mn(a + S::kA) : wg_desc(a + S::kA);
        wg_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // k16 (bf16) or k32 (s8): 32 bytes each
          if constexpr (Q8)
            wg_mma_s8(acc, da + kStepA * k, db + kStepB * k);
          else
            wg_mma<AMN, BMN>(acc, da + kStepA * k, db + kStepB * k);
        }
        wg_commit();
        wg_wait<1>();  // the previous stage's group has retired: free it
        if (kt > k0t && tid == 0) mbar_arrive(empty(prev));
        prev = s;
        if (++s == S::kStages) {
          s = 0;
          ph ^= 1u;
        }
      }
      wg_wait<0>();
      wg_fence_operands(acc);
      if (tid == 0) mbar_arrive(empty(prev));

      // acc[4 j + 2 h + e]: row 16 warp + g + 8 h, column 8 j + 2 q + e;
      // taken 32 columns (four n8 tiles) at a time; the s8 instance's sums
      // dequantized first. With a residual, the
      // transposed sums go back into acc (group (j0, h)'s eight slots) and
      // the residual is read in batches of four 16- or 32-byte loads, all
      // issued before the batch's stores (the tile's lines were prefetched
      // into L2 when the tile began). Split z writes its partial at z *
      // split_stride.
      constexpr int kRes = WgEpi<EPI>::kRes;
      float rsx[2] = {0.f, 0.f};  // the s8 instance: the two rows' scales
      if constexpr (Q8) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (row0 + 8 * h < M) rsx[h] = sx[row0 + 8 * h];
      }
      void* outz = kSplit && splits > 1
                       ? static_cast<void*>(static_cast<float*>(out) + (size_t)z * split_stride)
                       : out;
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += 4) {
        float2 b[4], c[4];
#pragma unroll
        for (int t_ = 0; t_ < 4; ++t_) {
          b[t_] = kBias ? *reinterpret_cast<const float2*>(bias + n0 + 8 * (j0 + t_) + 2 * q)
                        : make_float2(0.f, 0.f);
          if constexpr (Q8)
            c[t_] = *reinterpret_cast<const float2*>(sw + n0 + 8 * (j0 + t_) + 2 * q);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          float lo[4], hi[4], v[8];
#pragma unroll
          for (int t_ = 0; t_ < 4; ++t_) {
            if constexpr (Q8) {  // f32(acc) * sx * sw + bias, each step rounded
              lo[t_] = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * (j0 + t_) + 2 * h]),
                                                     rsx[h]), c[t_].x), b[t_].x);
              hi[t_] = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * (j0 + t_) + 2 * h + 1]),
                                                     rsx[h]), c[t_].y), b[t_].y);
            } else {
              lo[t_] = acc[4 * (j0 + t_) + 2 * h] + b[t_].x;
              hi[t_] = acc[4 * (j0 + t_) + 2 * h + 1] + b[t_].y;
            }
          }
          wg_epilogue8<EPI>(outz, res, (size_t)row * N + n0 + 8 * (j0 + q), row < M, lo, hi, q,
                            v);
          if constexpr (kRes != 0) {
#pragma unroll
            for (int t_ = 0; t_ < 4; ++t_) {
              wg_keep(acc[4 * (j0 + t_) + 2 * h], v[2 * t_]);
              wg_keep(acc[4 * (j0 + t_) + 2 * h + 1], v[2 * t_ + 1]);
            }
          }
        }
      }
      if constexpr (kRes != 0) {
        constexpr int kGroups = BN / 16;  // (j0, h) pairs
#pragma unroll
        for (int b0 = 0; b0 < kGroups; b0 += 4) {
          float r[4][8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j0 = (b0 + i) / 2 * 4, h = (b0 + i) % 2;
            const int row = row0 + 8 * h;
            if (row < M) wg_load_res8<EPI>(res, (size_t)row * N + n0 + 8 * (j0 + q), r[i]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j0 = (b0 + i) / 2 * 4, h = (b0 + i) % 2;
            const int row = row0 + 8 * h;
            float v[8];
#pragma unroll
            for (int t_ = 0; t_ < 4; ++t_) {
              v[2 * t_] = wg_kept(acc[4 * (j0 + t_) + 2 * h]);
              v[2 * t_ + 1] = wg_kept(acc[4 * (j0 + t_) + 2 * h + 1]);
            }
            if (row < M) wg_store_res8<EPI>(outz, (size_t)row * N + n0 + 8 * (j0 + q), v, r[i]);
          }
        }
      }
    }
  }
}

using WgEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once (null if missing).
inline WgEncodeTiled wg_encode_tiled() {
  static const WgEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<WgEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a (rows, cols) row-major bf16 matrix, boxes of box_rows x
// 64 (cols), 128-byte swizzled; rows past `rows` read as zeros. A K-major
// operand is (M or N, K) in boxes of the tile's rows; an MN-major one
// (K, M or N) in boxes of 64 K rows. With s8, an s8 matrix in boxes of
// box_rows x 128 (the same 128 bytes a box row).
inline cudaError_t wg_tensor_map(CUtensorMap* map, const void* ptr, long rows, int cols,
                                 int box_rows, bool s8 = false) {
  const WgEncodeTiled encode = wg_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * (s8 ? 1 : 2)};
  const cuuint32_t box[2] = {(cuuint32_t)(s8 ? 2 * kWgBK : kWgBK), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, s8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            2, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t wg_sms(int* sms) {
  int dev = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev))) return e;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// out (M, N) = epi(op(A) . op(W) + bias) over K: A (M, K) or, AMN, (K, M);
// W (N, K) or, BMN, (K, N); row-major bf16; bias only where W is K-major
// (!BMN). With AMN and splits > 1 (kEpiF32 only), split z reduces K
// stages [z * kchunk, (z + 1) * kchunk) into out + z * split_stride.
template <int BN, int EPI, bool AMN, bool BMN>
cudaError_t wg_gemm_launch(const bf16* A, const bf16* W, const float* bias,
                           const void* res, void* out, long M, int N, long K, int splits,
                           int kchunk, long split_stride, cudaStream_t st) {
  using S = WgShape<BN>;
  CUtensorMap ta, tw;
  cudaError_t e;
  if ((e = AMN ? wg_tensor_map(&ta, A, K, (int)M, 64) : wg_tensor_map(&ta, A, M, (int)K, kWgBM)))
    return e;
  if ((e = BMN ? wg_tensor_map(&tw, W, K, N, 64) : wg_tensor_map(&tw, W, N, (int)K, BN)))
    return e;
  static SmemGrant grant;
  if ((e = smem_opt_in(wg_gemm_kernel<BN, EPI, AMN, BMN>, S::kSmem, grant))) return e;
  int sms = 0;
  if ((e = wg_sms(&sms))) return e;
  const long work = (M + kWgBM - 1) / kWgBM * (N / BN) * splits;
  wg_gemm_kernel<BN, EPI, AMN, BMN>
      <<<(unsigned)(work < sms ? work : sms), kWgThreads, S::kSmem, st>>>(
          ta, tw, bias, res, out, (int)M, N, (int)K, kchunk, splits, split_stride, nullptr,
          nullptr);
  return cudaGetLastError();
}

template <int EPI, bool AMN, bool BMN>
cudaError_t wg_gemm_any(const bf16* A, const void* W, const void* bias, const void* res,
                        void* out, long M, int N, long K, int splits, int kchunk,
                        long split_stride, cudaStream_t st) {
  const bf16* w = static_cast<const bf16*>(W);
  const float* b = static_cast<const float*>(bias);
  if (N % 256 == 0)
    return wg_gemm_launch<256, EPI, AMN, BMN>(A, w, b, res, out, M, N, K, splits, kchunk,
                                              split_stride, st);
  return wg_gemm_launch<128, EPI, AMN, BMN>(A, w, b, res, out, M, N, K, splits, kchunk,
                                            split_stride, st);
}

// gemm<EPI>'s interface on the wgmma kernel. Requires N % 128 == 0, K % 64
// == 0 and 16-byte aligned A and W (the wrappers check); M is ragged.
template <int EPI>
cudaError_t wg_gemm(const bf16* A, const void* W, const void* bias, const void* res,
                    void* out, long M, int N, int K, cudaStream_t st) {
  if (M <= 0) return cudaSuccess;
  if (N <= 0 || N % 128 || K <= 0 || K % kWgBK || M > (1L << 30))
    return cudaErrorInvalidValue;
  return wg_gemm_any<EPI, false, false>(A, W, bias, res, out, M, N, K, 1, K / kWgBK, 0, st);
}

template <int BN, int EPI>
cudaError_t wg_gemm_s8_launch(const int8_t* A, const float* sx, const int8_t* W,
                              const float* sw, const float* bias, const void* res, void* out,
                              long M, int N, long K, cudaStream_t st) {
  using S = WgShape<BN>;
  CUtensorMap ta, tw;
  cudaError_t e;
  if ((e = wg_tensor_map(&ta, A, M, (int)K, kWgBM, true))) return e;
  if ((e = wg_tensor_map(&tw, W, N, (int)K, BN, true))) return e;
  static SmemGrant grant;
  if ((e = smem_opt_in(wg_gemm_kernel<BN, EPI, false, false, true>, S::kSmem, grant))) return e;
  int sms = 0;
  if ((e = wg_sms(&sms))) return e;
  const long work = (M + kWgBM - 1) / kWgBM * (N / BN);
  wg_gemm_kernel<BN, EPI, false, false, true>
      <<<(unsigned)(work < sms ? work : sms), kWgThreads, S::kSmem, st>>>(
          ta, tw, bias, res, out, (int)M, N, (int)K, (int)(K / (2 * kWgBK)), 1, 0, sx, sw);
  return cudaGetLastError();
}

// The int8 tier's product: out (M, N) = epi(f32(A . W^T) * sx[row] * sw[col]
// + bias[col]), A (M, K) s8 row codes with their f32 scales sx (M), W
// (N, K) s8 channel codes with theirs, sw (N). Requires N % 128 == 0, K %
// 128 == 0, 16-byte aligned A and W (the wrappers check); M is ragged.
template <int EPI>
cudaError_t wg_gemm_s8(const int8_t* A, const float* sx, const void* W, const void* sw,
                       const void* bias, const void* res, void* out, long M, int N, int K,
                       cudaStream_t st) {
  if (M <= 0) return cudaSuccess;
  if (N <= 0 || N % 128 || K <= 0 || K % (2 * kWgBK) || M > (1L << 30))
    return cudaErrorInvalidValue;
  const int8_t* w = static_cast<const int8_t*>(W);
  const float* s = static_cast<const float*>(sw);
  const float* b = static_cast<const float*>(bias);
  if (N % 256 == 0)
    return wg_gemm_s8_launch<256, EPI>(A, sx, w, s, b, res, out, M, N, K, st);
  return wg_gemm_s8_launch<128, EPI>(A, sx, w, s, b, res, out, M, N, K, st);
}

#ifdef DVST_WITH_BACKWARD

// dX (M, N) = epi(dY (M, K) . W (K, N)), W an (out, in) weight read as
// stored (out = K, in = N): kEpiBf16, kEpiF32, or kEpiMulF32Bf16 with aux
// (M, N) f32 (bf16(acc * aux)). No bias. Requires N % 128 == 0, K % 64 ==
// 0, 16-byte aligned dY and W; M is ragged.
template <int EPI>
cudaError_t wg_gemm_dx(const bf16* dY, const bf16* W, const float* aux, void* out, long M,
                       int N, int K, cudaStream_t st) {
  if (M <= 0) return cudaSuccess;
  if (N <= 0 || N % 128 || K <= 0 || K % kWgBK || M > (1L << 30))
    return cudaErrorInvalidValue;
  return wg_gemm_any<EPI, false, true>(dY, W, nullptr, aux, out, M, N, K, 1, K / kWgBK, 0,
                                       st);
}

constexpr int kWgMaxSplits = 16;

// Splits of a weight gradient's reduction over `rows` rows for an (n_out,
// k_in) output: the count in [1, kWgMaxSplits] that minimises a model of
// the time, the rounds of (split, tile) items over the SMs times each
// item's K stages (~0.84 us a 128 x 256 x 64 stage at ~640 TFLOP/s a
// card) plus the f32 partials' write and reduce_splits' read (3.35 TB/s);
// ties go to fewer splits. *kchunk: K stages per split, every split
// non-empty.
inline int wg_dw_splits(long rows, int n_out, int k_in, int sms, int* kchunk) {
  const long nk = (rows + kWgBK - 1) / kWgBK;
  const int bn = k_in % 256 == 0 ? 256 : 128;
  const long tiles = (long)(n_out + kWgBM - 1) / kWgBM * (k_in / bn);
  const double stage_ns = 0.84e3 * bn / 256, byte_ns = 1.0 / 3350.0;
  int best = 1;
  double best_ns = 0.0;
  for (int s = 1; s <= kWgMaxSplits && s <= nk; ++s) {
    const long chunk = (nk + s - 1) / s;
    if ((nk + chunk - 1) / chunk != s) continue;  // an empty split
    const long rounds = (tiles * s + sms - 1) / sms;
    const double ns = stage_ns * rounds * chunk +
                      (s > 1 ? byte_ns * 8.0 * s * n_out * (double)k_in : 0.0);
    if (s == 1 || ns < best_ns) {
      best = s;
      best_ns = ns;
    }
  }
  *kchunk = (int)((nk + best - 1) / best);
  return best;
}

// Floats of split partials wg_gemm_dw needs for `rows` rows of an (n_out,
// k_in) gradient on this device (0 with one split).
inline cudaError_t wg_dw_part_floats(long rows, int n_out, int k_in, size_t* n) {
  int sms = 0, kchunk = 0;
  const cudaError_t e = wg_sms(&sms);
  if (e != cudaSuccess) return e;
  const int s = wg_dw_splits(rows, n_out, k_in, sms, &kchunk);
  *n = s > 1 ? (size_t)s * n_out * k_in : 0;
  return cudaSuccess;
}

// dW (n_out, k_in) f32 = dY^T . X over `rows` rows: dY (rows, n_out) and X
// (rows, k_in) bf16 row-major, both read as stored (MN-major). The rows
// past `rows` of the last stage are TMA's zero fill. part: the floats
// wg_dw_part_floats gives. Requires n_out % 128 == 0 (the wrappers check),
// k_in % 128 == 0, 16-byte aligned dY and X.
inline cudaError_t wg_gemm_dw(const bf16* dY, const bf16* X, float* out, float* part,
                              long rows, int n_out, int k_in, cudaStream_t st) {
  if (n_out <= 0 || n_out % 128 || k_in <= 0 || k_in % 128 || rows > (1L << 30))
    return cudaErrorInvalidValue;
  if (rows <= 0) return cudaMemsetAsync(out, 0, (size_t)n_out * k_in * sizeof(float), st);
  int sms = 0, kchunk = 0;
  cudaError_t e = wg_sms(&sms);
  if (e != cudaSuccess) return e;
  const int splits = wg_dw_splits(rows, n_out, k_in, sms, &kchunk);
  const long n = (long)n_out * k_in;
  e = wg_gemm_any<kEpiF32, true, true>(dY, X, nullptr, nullptr, splits > 1 ? part : out,
                                       n_out, k_in, rows, splits, kchunk, n, st);
  if (e != cudaSuccess || splits == 1) return e;
  return reduce_splits(part, splits, n, out, st);
}

#endif  // DVST_WITH_BACKWARD

}  // namespace
