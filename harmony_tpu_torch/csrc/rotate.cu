// K6, K7, K10 and K11: the rotate schedule's re-entry, its stats-carrying
// round and the two virtual-R kernels, hand-written for Hopper (sm_90a).
//
// K6 replaces harmony_tpu/ops/pallas_rotate.py _reassign_kernel (:1261),
// reached through pallas_reassign (:1354): per cell tile it L2-normalises
// the corrected embedding, recomputes R = colnorm(exp((Y^T Z - 1) 2/sigma))
// on valid cells and contracts R against the design into the per-tile
// table tile_O (NT, K, B); O is the fixed-order sum of the table and E its
// covariate-0 row sums times Pr_b. R itself is never written. It also
// stores the phase's Gram table G (L, K) = (Y^T Zn)^T, one contiguous row
// of K values a cell, which every K7 round of the phase reads: Y and Zn do
// not change within a clustering phase.
// Bound on this card at N_pad = 503,808, d = 50, K = 100, B = 10: Z read
// once and Zn written once (0.2 GB, 60 us at 3.35 TB/s); Y^T Z is
// 2*K*d*N = 5 GFLOP of fp32 FMA (75 us at 67 TFLOP/s): operations-bound.
// G adds 0.2 GB written (60 us), so this design's floor is 0.4 GB, 0.12 ms.
// What bounds the product on the SM is its shared-memory load path: a
// float4 load costs a warp's quarter-phases whatever its lanes share, so
// the design counts loads per FMA. Persistent CTAs (two a SM) stage Y^T
// once and walk the 64-cell pieces with the next piece's Z columns and
// codes in flight (cp.async); a thread forms a 4-cell x 8-cluster register
// tile (three float4 loads per 32 FMAs), the cell-wise steps take 4-cell
// float4 columns of a (K x 64) table whose rows are an odd number of
// float4s (no bank conflicts), the design sums spread over (cluster, cell
// split) threads, and the reduce reads the per-piece partials as coalesced
// rows, one thread a (k, b) column, over (tile, column chunk) CTAs.
//
// K7 replaces harmony_tpu/ops/pallas_rotate.py _round_kernel_v2 (:594),
// reached through pallas_rotate_update_round_v2 (:851), in both of its op
// orders (_assign_tile :403): one stats-carrying round. Per block (a run
// of whole tiles, rotated mod NT) it removes the block's old O/E, taken
// from the previous round's tile table and never from R, builds the
// block-constant penalty ((2E+1)/(O+E+1))^theta, assigns each cell
//   fused_vpu: w = exp((g - 1) 2/sigma) * pen[code],
//   legacy:    e = exp(-2 (1 - g) / sigma), w = (e / colsum(e)) * pen[code]
//              (the reference's two normalisations, src/harmony.cpp:319-323),
//   R = w * (1 / colsum(w)),
// emits the block's per-tile table, the k-means error (2 n - 2 sum R g;
// legacy: sum R 2 (1 - g)) and the entropy (factorised for one covariate,
// pallas_rotate.py:781-805, whose column term is log colsum(w), legacy
// log(colsum(e) colsum(w)); sum sigma R log R otherwise), and commits the
// block. R is written only
// when asked (the phase's last round). On the last round it can also
// store each block's penalty table (emit_pen, for virtual R) and fuse the
// M-step's joint-batch moments M[j] = sum over layout tiles of joint j of
// R_t [Z_orig_t; 1]^T (the msub fusion, pallas_rotate.py:813-835), so no
// separate pass over R and Z_orig (K8) runs. Bound (of the function, not
// of this design): the same 5 GFLOP as K6 (75 us); bytes are Z read once
// (0.1 GB) plus R written once on the round that writes it (0.2 GB, 90 us
// then); with moments 2*K*(d+1)*N = 5.1 GFLOP more and Z_orig read once
// (0.15 ms in all, operations-bound). This design does the product once a
// phase, in K6, and reads g from K6's G instead: 0.2 GB a round, 60 us.
//
// K10 replaces _virtual_correction_kernel (:1451), reached through
// pallas_virtual_correction (:1493): Z_corr = Z_orig - W_joint[j] R per
// layout tile with R recomputed from the last round's penalty tables and
// its tile -> block map, so R is never read. Bound: Zn and Z_orig read and
// Z_corr written once (0.3 GB, 90 us); the distances and the correction
// are 2*K*d*N each, 10 GFLOP (0.15 ms): operations-bound. This design
// forms no distances: it reads the phase's G (K6's, 0.2 GB, kept on the
// state until the correction), so it moves 0.5 GB (0.15 ms) and does the
// correction's 5 GFLOP (75 us).
// K11 replaces _materialize_r_kernel (:1621), reached through
// pallas_materialize_r (:1648): the run-end R from the same tables, and on
// a correction K10 does not take, the R K9 applies. Bound: R written once
// and Zn read once (0.3 GB, 90 us) against 5 GFLOP (75 us): bytes-bound.
// This design forms g again (the phase's G is gone by then): its floor is
// the larger of the 0.3 GB and the product at K6's rate on the SM (~21
// TFLOP/s, a 4 x 8 tile's shared-memory loads: ~0.24 ms), so ~0.24 ms
// where the chain and the R stores hide behind the product of the other
// CTA on the SM. They hide only in part: the chain is latency-bound and
// as long as the product on its own at the main shape (PERF.md §6).
//
// Design. On the TPU the round was one sequential grid with E/O in VMEM.
// Here, as in estep_round.cu (K1), blocks are sequential and a block's
// cells are independent, so a round is a host loop over the positions of
// the block order with two launches each. Neither launch takes the schedule
// as host ints: both read the round's row of the schedule table
// (rotation, block order) and the block table (tiles, first virtual tile)
// from device memory, so the launches of a round are the same for every
// schedule and a captured CUDA graph replays any round (engine.run_rounds):
//   (a) rot_assign over the block's cells, 64-cell pieces of a tile (one
//       per CTA: a block's ~384 pieces at 500k cells already fit the card
//       in one wave; the launch has the largest block's CTAs, the rest
//       return at once). A CTA does not compute Y^T Z and stages neither Y^T
//       nor Z: its piece's rows of G (64 x K floats, contiguous) come in
//       through cp.async, transposed into the (K x 64) table the chain
//       reads, with the codes and the penalty tables; then per cell (one
//       warp a column, two cells at a time) the exp, the guarded
//       normalise and the objective terms, and per cluster row the (K x B)
//       design contraction (a run of cells of one batch row summed in a
//       register). It writes R (if asked) and a partials row [tO (K*B)
//       | k-means error | entropy]. With moments it also forms its piece's
//       R [Z_orig; 1]^T, one 4x4 register tile at a time (any K and d),
//       and stores each tile into the piece's row of a scratch the size of
//       one block's pieces (L2-resident); the last of a layout tile's
//       pieces to finish (an integer count) sums their rows in piece order
//       into one (K x d+1) row per layout tile. One
//       CTA looping over a layout tile's pieces left a block's launch with
//       fewer CTAs than the card has SMs, and a thread-block cluster per
//       layout tile made each launch slower by itself, on the H100.
//   (b) rot_commit, one CTA per cluster row, folds the partials of each
//       tile in a fixed order into tile_O and the block's new O/E, removes
//       the next block's old O (a fixed-order sum over its tiles of the
//       previous table) and writes the next penalty tables (and, with
//       emit_pen, stores them as that block's table).
// With moments a last launch sums each joint's layout-tile rows in tile
// order (tiled.cu's sum_joint_rows, called by the wrapper: the rows are
// laid out joint by joint). No float atomics anywhere, so repeated runs
// give the same trajectory.
// K6 is (a) without the penalty over persistent CTAs (see its kernel),
// plus a reduction kernel that builds tile_O, O and E. K11 walks the
// whole padded layout over persistent CTAs, as K6 does, forming g with
// K6's register tiles and running K10's chain (see its kernel). K10
// gives each persistent CTA an equal range of the layout
// tiles in K8's plan order (tiled.cu), a joint's betas staged once where
// its run starts, and splits its warps into a chain role and correction
// groups that hand R tables over at named barriers (see its kernel). It
// takes K <= 256 (a lane's registers), d <= 192 and one correction
// group's shared memory; past those, and without G, the correction runs
// K11, then K9 on its R (ops/ridge.py virtual_tile_correction).
//
// Bit-equal recomputation. K7's written R, the R K10 recomputes and K11's
// R must be the same bits per cell (the property of pallas_rotate.py:
// 1436-1441), in either op order. K7 and K10 read g from K6's G; K11
// computes it on the phase's stored Zn with tile_gram, the routine K6
// formed G with on the same Zn values (a fixed fmaf sequence over e =
// 0..d-1 per output), so g has the same bits in all three. Then K7 runs
// assign_chain, and K10 and K11 run its per-cell operations in its order
// four cells at a time (v_chain; K11 past 256 clusters runs assign_chain);
// each column sum is a lane's sum over its clusters in order, then the
// same xor-shuffle tree; every product that feeds a sum or R is __fmul_rn
// and every division __fdiv_rn, so no kernel lets the compiler contract
// or approximate them differently.
//
// Storage types. A bf16 engine stores Z_orig, Z_corr and R in bf16
// (harmony_tpu/state.py:127-166) and runs every contraction in fp32 on
// operands upcast at the boundary (harmony_tpu/ops/assign.py:32-38). K6
// (Z_raw), K7 (Z_orig, in the moments), K10 (Z_orig in, Z_corr out) and
// K11 (R out) are templated on the storage type, float or __nv_bfloat16,
// one instance each bound to the C entry points through an int. A load
// converts to float in registers or while staging (exact); every product
// and sum is then the float form's fmaf in the same order; a bf16 store is
// __float2bfloat16_rn of the float the float form stores. So each bf16
// output is the float form's on the upcast inputs, rounded once to nearest
// even, and the float outputs (K6's Zn and G, K7's moments) are the float
// form's bit for bit. G, Zn, the penalty tables, sigma and the betas stay
// float. K6 stages a piece's bf16 Z (eight values a 16-byte copy, double
// buffered) and converts it into one float buffer as it normalises, so
// its shared memory is the float form's; K7 converts while staging its
// [Z_orig; 1] columns; K10 and K11 read and write 4 values as 8 bytes
// where the float form moves 16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

// ROTATE_PART (set by the file that includes this one): the instances and
// C entry points of this translation unit. Each part is a library of its
// own, so nvcc compiles them side by side (cuda_rotate._lib_for and
// _k10_lib mirror the table):
//   0 rotate.cu            K6 (every form), K7 on whole 64-cell pieces and
//                          its commit, K11 with fp32 products;
//   1 rotate_tiles.cu      K7's moments and K10 with fp32 products on layout
//                          tiles that are not whole 64-cell pieces;
//   2 rotate_k10.cu        K10 with fp32 products on whole pieces;
//   3 rotate_mma.cu        K10 in the bf16 product form on whole pieces;
//   4 rotate_mma_tiles.cu  K10 in the bf16 product form on the other tiles;
//   5 rotate_k11_mma.cu    K11 in the bf16 product form.
// Every part holds each storage type (float, bf16, f16), but K10's product
// forms only the 2-byte ones: a float32 engine takes no bf16 product.
#ifndef ROTATE_PART
#define ROTATE_PART 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 8;   // cluster rows per thread in the product
constexpr int kCT = 64;  // cells per piece
constexpr int kTP = kCT + 1;
constexpr int kLP = kCT + 4;  // K6's (K8 x 64) table: a row is 17 float4s (odd), so
                              // float4 columns are read and written without conflicts
constexpr int kVThreads = 512;          // K10: one CTA a SM
constexpr int kVCells = 64;             // K10: cells a step
constexpr int kVLP = kVCells + 4;       // K10's (K x 64) R table: a row is 17 float4s

// Storage-type conversions: a bf16 value is the high 16 bits of its float
// and every float16 value is a float, so the loads are exact; a store
// rounds to nearest even.
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// four bf16 values, 8-byte aligned
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// four float16 values, 8-byte aligned
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const unsigned a = __bfloat16_as_ushort(__float2bfloat16_rn(v.x));
  const unsigned b = __bfloat16_as_ushort(__float2bfloat16_rn(v.y));
  const unsigned c = __bfloat16_as_ushort(__float2bfloat16_rn(v.z));
  const unsigned e = __bfloat16_as_ushort(__float2bfloat16_rn(v.w));
  *reinterpret_cast<uint2*>(p) = make_uint2(a | (b << 16), c | (e << 16));
}
__device__ __forceinline__ void store4(__half* p, float4 v) {
  const __half2 a = __floats2half2_rn(v.x, v.y), b = __floats2half2_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&a), *reinterpret_cast<const unsigned*>(&b));
}

// Two neighbouring cells' values (8-byte aligned as float, 4 as 2-byte).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}
__device__ __forceinline__ void store2(__half* p, float2 v) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(v.x, v.y);
}

// The values of cells c..c+3 of a step whose cells [lo, hi) are to be
// written: one 16-byte (bf16: 8-byte) store where all four are, else one
// store a cell.
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store1(__half* p, float v) { *p = __float2half_rn(v); }
template <bool kWhole, typename TZ>
__device__ __forceinline__ void store4_cells(TZ* p, float4 v, int c, int lo, int hi) {
  if (kWhole || (c >= lo && c + 4 <= hi)) {
    store4(p, v);
    return;
  }
  const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (c + i >= lo && c + i < hi) store1(p + i, vv[i]);
}

template <bool kWhole, typename TZ>
__device__ __forceinline__ void store2_cells(TZ* p, float2 v, int c, int lo, int hi) {
  if (kWhole || (c >= lo && c + 2 <= hi)) {
    store2(p, v);
    return;
  }
  if (c >= lo && c < hi) store1(p, v.x);
  if (c + 1 >= lo && c + 1 < hi) store1(p + 1, v.y);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// The product of K6 and K11: g = Y^T z of one 4-cell x 8-cluster register
// tile, acc[i][j] = the sum over e = 0..d-1 of y[e][j] z[e][i], each
// output acc = fmaf(y, z, acc) from 0 in that order, so K6's G and K11's g
// are the same bits. yp: the tile's 8 clusters of Y^T stored (d x ys),
// zp: its 4 cells of a (d x 64) piece; both float4-aligned. One float4 of
// z and two of Y^T per 32 FMAs.
__device__ __forceinline__ void tile_gram(const float* yp, int ys, const float* zp, int d,
                                          float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int e = 0; e < d; ++e) {
    const float4 z = *reinterpret_cast<const float4*>(zp + e * kCT);
    const float4 ya = *reinterpret_cast<const float4*>(yp + e * ys);
    const float4 yb = *reinterpret_cast<const float4*>(yp + e * ys + 4);
    const float zv[4] = {z.x, z.y, z.z, z.w};
    const float yv[8] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(yv[j], zv[i], acc[i][j]);
  }
}

// ---- The bf16 product form (ROADMAP B.1) -----------------------------------
// The JAX package traces a reduced-precision engine's phases under
// jax.default_matmul_precision('bfloat16') (harmony_tpu/engine.py:783-798),
// so on the TPU g = Y^T Zn (K6, K11) and the correction W R (K10) take one
// bf16 pass. The product forms round both operands to bf16 (to nearest
// even) and multiply them on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulated from 0 over the depth in 16-wide steps). The product of
// two bf16 values is exact in fp32, so a product form and its plain twin
// (the rounded operands, an fp32 product) differ only in the order of the
// sums; the fp32-product forms are the instances without kMma, untouched.

// Two floats as a bf16 pair, each rounded to nearest even, lo in the low
// half (the lower index of an mma fragment's pair).
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// c += a b of one m16n8k16 tile: a (16 x 16, row-major) as four bf16 pairs,
// b (16 x 8, column-major) as two, c (16 x 8) in fp32. Thread (g, t) = (lane
// / 4, lane % 4) holds a's rows g, g + 8 at columns 2t, 2t + 1 (+ 8), b's
// rows 2t, 2t + 1 (+ 8) at column g, c's rows g, g + 8 at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// g = Y^T zn of one 64-cell piece in the bf16 product form, the routine K6
// and K11 share, so K11's g keeps K6's G bits. Zp: the piece's Zn in bf16,
// (64 x S) a cell a row; Yb: Y^T in bf16, (K8 x S) a cluster a row, zero
// past K; both zero past d up to d16 (d rounded up to 16). S = d16 + 8: a
// row is 4 mod 8 words, so a fragment's 8 rows x 4 words meet 32 banks.
// Warp w takes the 8-cluster tiles w, w + 8, ... against the piece's four
// 16-cell rows and hands each of the 64 x K8 values to put(cell, cluster, g).
template <typename Put>
__device__ __forceinline__ void piece_gram_bf16(const __nv_bfloat16* Zp,
                                                const __nv_bfloat16* Yb, int S, int d16,
                                                int K8, Put put) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, gr = lane >> 2, tq = lane & 3;
  const int S2 = S / 2;  // 32-bit words a row
  const unsigned* Z32 = reinterpret_cast<const unsigned*>(Zp);
  const unsigned* Y32 = reinterpret_cast<const unsigned*>(Yb);
  for (int nt = w; nt < K8 / 8; nt += kWarps) {
    float c[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m) c[m][0] = c[m][1] = c[m][2] = c[m][3] = 0.f;
    const unsigned* yr = Y32 + (8 * nt + gr) * S2 + tq;
    for (int k2 = 0; k2 < d16 / 2; k2 += 8) {
      const unsigned b[2] = {yr[k2], yr[k2 + 4]};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const unsigned* zr = Z32 + (16 * m + gr) * S2 + k2 + tq;
        const unsigned a[4] = {zr[0], zr[8 * S2], zr[4], zr[8 * S2 + 4]};
        mma_bf16(c[m], a, b);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int t = 16 * m + gr, k = 8 * nt + 2 * tq;
      put(t, k, c[m][0]);
      put(t, k + 1, c[m][1]);
      put(t + 8, k, c[m][2]);
      put(t + 8, k + 1, c[m][3]);
    }
  }
}

// Per cluster row: the piece's (K x B) design contraction added into Obs
// (each thread owns its rows) and, if R is given, the assignments. A run
// of cells with one batch row (a batch-tiled layout's pieces are mostly
// one run) is summed in a register and added to Obs once.
__device__ __forceinline__ void add_stats(const float* Ls, const int* gcs, float* Obs,
                                          float* R, long long L, long long base, int K,
                                          int B, int ncov) {
  const int tid = threadIdx.x;
  for (int k = tid; k < K; k += kThreads) {
    for (int c = 0; c < ncov; ++c) {
      int cur = -1;
      float run = 0.f;
#pragma unroll 8
      for (int t = 0; t < kCT; ++t) {
        const int gc = gcs[c * kCT + t];
        if (gc != cur) {
          if (cur >= 0) Obs[k * B + cur] += run;
          cur = gc;
          run = 0.f;
        }
        run += Ls[k * kTP + t];
      }
      if (cur >= 0) Obs[k * B + cur] += run;
    }
  }
  if (R != nullptr) {
    for (int i = tid; i < K * kCT; i += kThreads) {
      const int k = i / kCT, t = i - k * kCT;
      R[k * L + base + t] = Ls[k * kTP + t];
    }
  }
}

// Stages the CTA's cells' global batch rows (code + covariate offset, -1
// on pad cells) into gcs.
__device__ __forceinline__ void stage_codes(const int* codes, const int* offsets, int* gcs,
                                            long long L, long long base, int ncov) {
  for (int i = threadIdx.x; i < ncov * kCT; i += kThreads) {
    const int c = i / kCT, t = i - c * kCT;
    const int code = codes[c * L + base + t];
    gcs[i] = code >= 0 ? code + offsets[c] : -1;
  }
}

// The per-cell operations of the legacy order (pallas_rotate.py:452-458,
// the reference's two normalisations, src/harmony.cpp:319-323):
// d = 2 (1 - g), e = exp(-d / sigma), then w = (e / colsum(e)) * pc.
__device__ __forceinline__ float legacy_d(float g) { return __fmul_rn(2.f, 1.f - g); }
__device__ __forceinline__ float legacy_e(float dv, float sigma) {
  return expf(__fdiv_rn(-dv, sigma));
}

// The assignment chain of K7 and K11 past 256 clusters (K10 and K11 run
// its operations four cells at once, v_chain) for the piece whose g = Y^T z
// is in Ls (K7: from K6's G; K11: tile_gram), per cell (one warp a column,
// lanes over clusters), with pc the penalty summed over the cell's
// covariates (0 on pad cells):
//   fused_vpu: w = exp((g - 1) 2/sigma) * pc;
//   legacy (kLegacy): e = exp(-2 (1 - g) / sigma), w = (e / colsum(e)) * pc,
//     Ls holding e between the passes (with kObj, g is read again from the
//     piece's rows of G, Gg, for the k-means error);
// then R = w * (1 / colsum(w)), the sum guarded against zero; R overwrites
// Ls. Each column sum is a lane's sum over k = lane, lane + 32, ... in
// order, then the xor-shuffle tree. With kObj the cell's k-means error
// and entropy terms are added to kerr/ent (lane-uniform). The caller
// synchronises before (g in Ls) and after (readers of Ls).
// A warp takes two cells at a time, t and t + 32, so the two chains'
// latencies overlap; each cell's operations are the same in the same order
// as one at a time.
template <bool kObj, bool kLegacy>
__device__ __forceinline__ void assign_chain(float* Ls, const float* pens, const float* lps,
                                             const float* sig, const float* i2s,
                                             const int* gcs, int K, int B, int ncov,
                                             float& kerr, float& ent,
                                             const float* Gg = nullptr) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int t0 = w; t0 < kCT / 2; t0 += kWarps) {
    const int tt[2] = {t0, t0 + kCT / 2};
    int g0[2];
    float cs[2], swg[2], sws[2], swl[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      g0[u] = gcs[tt[u]];
      cs[u] = swg[u] = sws[u] = swl[u] = 0.f;
    }
    if constexpr (kLegacy) {
      // pass 1: e into Ls, colsum(e) summed
      float c1[2] = {0.f, 0.f};
      for (int k = lane; k < K; k += 32) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float e = legacy_e(legacy_d(Ls[k * kTP + tt[u]]), sig[k]);
          c1[u] += e;
          Ls[k * kTP + tt[u]] = e;
        }
      }
      warp_sum2(c1[0], c1[1]);
      // pass 2: w = (e / colsum(e)) * pc; the k-means error as sum w d
      for (int k = lane; k < K; k += 32) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = tt[u];
          float pc = 0.f;
          for (int c = 0; c < ncov; ++c) {
            const int gc = gcs[c * kCT + t];
            if (gc >= 0) pc += pens[k * B + gc];
          }
          const float wv = __fmul_rn(__fdiv_rn(Ls[k * kTP + t], c1[u]), pc);
          cs[u] += wv;
          if (kObj) {
            swg[u] += wv * legacy_d(Gg[t * K + k]);
            if (ncov == 1 && g0[u] >= 0) {
              sws[u] += sig[k] * wv;
              swl[u] += sig[k] * wv * lps[k * B + g0[u]];
            }
          }
          Ls[k * kTP + t] = wv;
        }
      }
      warp_sum2(cs[0], cs[1]);
      float inv[2], sxl[2] = {0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 2; ++u) inv[u] = 1.f / (cs[u] == 0.f ? 1.f : cs[u]);
      for (int k = lane; k < K; k += 32) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float r = __fmul_rn(Ls[k * kTP + tt[u]], inv[u]);
          if (kObj && ncov > 1) sxl[u] += sig[k] * (r > 0.f ? r * logf(r) : 0.f);
          Ls[k * kTP + tt[u]] = r;
        }
      }
      if (kObj) {
        warp_sum2(swg[0], swg[1]);
        if (ncov == 1) {
          warp_sum2(sws[0], sws[1]);
          warp_sum2(swl[0], swl[1]);
        } else {
          warp_sum2(sxl[0], sxl[1]);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          // sum R d (pallas_rotate.py:773-774); log R's column term is
          // log(colsum(e) colsum(w)) (:796-798)
          const float csg = cs[u] == 0.f ? 1.f : cs[u];
          const float s_rd = swg[u] * inv[u];
          kerr += s_rd;
          if (ncov == 1)
            ent += -s_rd - logf(c1[u] * csg) * (sws[u] * inv[u]) + swl[u] * inv[u];
          else
            ent += sxl[u];
        }
      }
      continue;
    }
    for (int k = lane; k < K; k += 32) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = tt[u];
        float pc = 0.f;
        for (int c = 0; c < ncov; ++c) {
          const int gc = gcs[c * kCT + t];
          if (gc >= 0) pc += pens[k * B + gc];
        }
        const float g = Ls[k * kTP + t];
        const float wv = __fmul_rn(expf(__fmul_rn(g - 1.f, i2s[k])), pc);
        cs[u] += wv;
        if (kObj) {
          swg[u] += wv * g;
          if (ncov == 1 && g0[u] >= 0) {
            sws[u] += sig[k] * wv;
            swl[u] += sig[k] * wv * lps[k * B + g0[u]];
          }
        }
        Ls[k * kTP + t] = wv;
      }
    }
    warp_sum2(cs[0], cs[1]);
    float csg[2], inv[2], sr[2] = {0.f, 0.f}, sxl[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      csg[u] = cs[u] == 0.f ? 1.f : cs[u];
      inv[u] = 1.f / csg[u];
    }
    for (int k = lane; k < K; k += 32) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float r = __fmul_rn(Ls[k * kTP + tt[u]], inv[u]);
        if (kObj) {
          sr[u] += r;
          if (ncov > 1) sxl[u] += sig[k] * (r > 0.f ? r * logf(r) : 0.f);
        }
        Ls[k * kTP + tt[u]] = r;
      }
    }
    if (kObj) {
      warp_sum2(sr[0], sr[1]);
      warp_sum2(swg[0], swg[1]);
      if (ncov == 1) {
        warp_sum2(sws[0], sws[1]);
        warp_sum2(swl[0], swl[1]);
      } else {
        warp_sum2(sxl[0], sxl[1]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        // k-means error as 2 sum R - 2 sum R g (pallas_rotate.py:776-779)
        const float s_rd = 2.f * sr[u] - 2.f * (swg[u] * inv[u]);
        kerr += s_rd;
        if (ncov == 1)
          ent += -s_rd - logf(csg[u]) * (sws[u] * inv[u]) + swl[u] * inv[u];
        else
          ent += sxl[u];
      }
    }
  }
}

// Floats of K7's assign CTA layout before the moments' [Z_orig; 1] stage
// (rot_assign_kernel; cuda_rotate.assign_smem_bytes mirrors it), rounded
// up to whole float4s.
__host__ __device__ __forceinline__ int assign_floats(int K, int B, int ncov) {
  const int n = (K + 3) / 4 * 4 * kTP + 3 * K * B + 2 * K + 2 * kWarps + ncov * kCT;
  return (n + 3) / 4 * 4;
}

// ---- K7 ---------------------------------------------------------------

// One 4x4 (cluster x dim) register tile of a piece's moments R [Z_orig;
// 1]^T over its cells [u0, u1) (Ls: R, K4 x kTP; Zos: [Z_orig; 1],
// cell-major), stored as 16-byte rows into the piece's (K4 x d1p) table
// out (L2), so K and d are not bounded by the registers a thread has.
__device__ __forceinline__ void moment_tile(const float* Ls, const float* Zos, int kb, int eb,
                                            int u0, int u1, int d1p, float* out) {
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
#pragma unroll 8
  for (int u = u0; u < u1; ++u) {
    const float4 z = *reinterpret_cast<const float4*>(Zos + u * d1p + 4 * eb);
    const float rv[4] = {Ls[(4 * kb) * kTP + u], Ls[(4 * kb + 1) * kTP + u],
                         Ls[(4 * kb + 2) * kTP + u], Ls[(4 * kb + 3) * kTP + u]};
    const float zv[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(rv[i], zv[jj], acc[i][jj]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(out + (4 * kb + i) * d1p + 4 * eb) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// The 64-cell pieces that layout tile lt (tw cells, tw >= 64, pieces and
// tiles both from cell 0) meets: tw / 64 where tiles are whole pieces.
__device__ __forceinline__ int tile_pieces(int lt, int tw) {
  const long long a = static_cast<long long>(lt) * tw;
  return static_cast<int>((a + tw - 1) / kCT - a / kCT) + 1;
}

// The block at position pos of the round's order (sched: the round's row of
// the schedule table, [rotation, block order]; blocks: (2, nb) int32, the
// tiles of each block, then its first virtual tile) has ntile tiles from
// virtual tile v0 on: v0 = (vstart[blk] + rotation) mod NT. The launch has
// the largest block's CTAs, and those past the block's ntile * cpt return
// at once, so one launch shape serves every block and no host int carries
// the schedule. The block's CTA c covers cells [p*T + (c % cpt)*64, +64) of
// physical tile p = (v0 + c / cpt) mod NT, cpt = T / 64. With kMoments each CTA
// stores its piece's (K4 x d1p) table as row c of mpiece (tw a multiple of
// 64: a layout tile of tw cells is C = tw / 64 whole pieces) or, where
// layout tiles are not whole pieces (tw >= 64, T a multiple of tw), the
// tables of its cells in each of the (at most two) layout tiles it meets as
// rows 2c and 2c + 1, and counts itself in count[lt] of each such tile lt
// of the launch; the last of a tile's pieces to arrive sums the tile's
// rows in piece order into mpart's row slot[layout tile] and resets the
// count for the next launch. kWhole: tw is a multiple of 64 (without
// moments too), whose instance splits no piece.
template <bool kMoments, bool kLegacy, typename TZ, bool kWhole>
__global__ void __launch_bounds__(kThreads) rot_assign_kernel(
    const float* __restrict__ G,       // (L, K) the phase's Gram table (K6)
    const int* __restrict__ codes,     // (ncov, L), pads < 0
    const int* __restrict__ offsets,   // (ncov,)
    const float* __restrict__ pen,     // (K, B) block-removed penalty
    const float* __restrict__ logpen,  // (K, B) theta * log(ratio)
    const float* __restrict__ sigma,   // (K,)
    float* __restrict__ R,             // (K, L) out, or null
    float* __restrict__ part,          // (n_cta, K*B + 2) out
    const TZ* __restrict__ Zo,         // (d, L) Z_orig (moments), float or bf16
    const int* __restrict__ slot,      // (L / tw,) moment row of each layout tile
    float* __restrict__ mpart,         // (L / tw, K*(d+1)) out (moments)
    float* __restrict__ mpiece,        // (n_cta, K4*d1p) scratch (moments)
    int* __restrict__ count,           // (n_cta / C,) zero on entry and exit (moments)
    const int* __restrict__ sched,     // (1 + nb,) the round's rotation and block order
    const int* __restrict__ blocks,    // (2, nb) tiles of each block, first virtual tile
    int pos, int nb, long long L, int NT, int cpt, int tw, int K, int d, int B, int ncov,
    int d1p) {
  const int blk = sched[1 + pos];
  if (static_cast<int>(blockIdx.x) >= blocks[blk] * cpt) return;
  const int v0 = (blocks[nb + blk] + sched[0]) % NT;
  extern __shared__ __align__(16) float smem[];
  const int K4 = (K + 3) / 4 * 4;
  float* Ls = smem;             // K4*kTP: g, then w, then R
  float* pens = Ls + K4 * kTP;  // K*B
  float* lps = pens + K * B;    // K*B
  float* sig = lps + K * B;     // K
  float* i2s = sig + K;         // K
  float* Obs = i2s + K;         // K*B
  float* red = Obs + K * B;     // 2*kWarps
  int* gcs = reinterpret_cast<int*>(red + 2 * kWarps);  // ncov*kCT
  // moments: the piece's [Z_orig; 1] columns, cell-major (kCT*d1p)
  float* Zos = smem + assign_floats(K, B, ncov);

  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int j = blockIdx.x / cpt, q = blockIdx.x - j * cpt;
  const long long p = (v0 + j) % NT;
  const long long base = p * cpt * kCT + static_cast<long long>(q) * kCT;
  const int P = K * B + 2;
  const int d1 = d + 1;

  // g of the piece's cells: their rows of G, contiguous, transposed into
  // Ls in flight (warp w takes rows w, w + 8, ..., lanes the clusters)
  const float* Gp = G + base * K;
  for (int t = w; t < kCT; t += kWarps)
    for (int k = lane; k < K; k += 32) cp_async4(Ls + k * kTP + t, Gp + t * K + k);
  for (int i = tid; i < K * B; i += kThreads) {
    pens[i] = pen[i];
    lps[i] = logpen[i];
    Obs[i] = 0.f;
  }
  for (int i = tid; i < K; i += kThreads) {
    sig[i] = sigma[i];
    i2s[i] = 2.f / sigma[i];
  }
  // rows K..K4 of Ls stay zero: the moment tiles read them
  for (int i = K * kTP + tid; i < K4 * kTP; i += kThreads) Ls[i] = 0.f;

  float kerr = 0.f, ent = 0.f;
  stage_codes(codes, offsets, gcs, L, base, ncov);
  cp_async_wait_all();
  __syncthreads();
  assign_chain<true, kLegacy>(Ls, pens, lps, sig, i2s, gcs, K, B, ncov, kerr, ent, Gp);
  __syncthreads();
  if (kMoments) {
    for (int i = tid; i < d1p * kCT; i += kThreads) {
      const int e = i / kCT, u = i - e * kCT;
      float v = 0.f;
      if (e < d1) v = e < d ? to_f(Zo[e * L + base + u]) : 1.f;
      Zos[u * d1p + e] = v;
    }
  }
  add_stats(Ls, gcs, Obs, R, L, base, K, B, ncov);
  // rows of KDp floats: the (K4 x d1p) piece table, zero past K and d + 1
  const int KDp = K4 * d1p;
  // the piece's first layout tile of the launch (its cells [0, split));
  // split < kCT: the cells [split, kCT) lie in the next one
  constexpr bool whole = kWhole;
  const long long off0 = static_cast<long long>(blockIdx.x) * kCT;  // in the launch
  const int lt0 = static_cast<int>(off0 / tw);
  const int split = whole ? kCT : min(kCT, tw - static_cast<int>(off0 % tw));
  if (kMoments) {
    __syncthreads();
    // one 4x4 (cluster x dim) register tile at a time, stored as 16-byte
    // rows into the piece's row of mpiece (L2), so K and d are not bounded
    // by the registers a thread has
    const int nkb = K4 / 4, neb = (d1 + 3) / 4;
    if (whole) {
      float* mine = mpiece + static_cast<long long>(blockIdx.x) * KDp;
      for (int mt = tid; mt < nkb * neb; mt += kThreads)
        moment_tile(Ls, Zos, mt / neb, mt % neb, 0, kCT, d1p, mine);
    } else {
      // the cells before the tile boundary into row 2c, the rest into 2c + 1
      float* mine = mpiece + 2 * static_cast<long long>(blockIdx.x) * KDp;
      for (int mt = tid; mt < nkb * neb; mt += kThreads) {
        moment_tile(Ls, Zos, mt / neb, mt % neb, 0, split, d1p, mine);
        if (split < kCT) moment_tile(Ls, Zos, mt / neb, mt % neb, split, kCT, d1p, mine + KDp);
      }
    }
  }
  if (lane == 0) {
    red[w] = kerr;
    red[kWarps + w] = ent;
  }
  __syncthreads();
  float* prow = part + static_cast<long long>(blockIdx.x) * P;
  for (int i = tid; i < K * B; i += kThreads) prow[i] = Obs[i];
  if (tid == 0) {
    float a = 0.f, b = 0.f;
    for (int i = 0; i < kWarps; ++i) {
      a += red[i];
      b += red[kWarps + i];
    }
    prow[P - 2] = a;
    prow[P - 1] = b;
  }
  if (kMoments) {
    // The fences order the piece's rows before the counts (release) and a
    // count before the last CTA's reads (acquire); those read L2
    // (__ldcg), where the other CTAs' rows are.
    const int nseg = split < kCT ? 2 : 1;
    __threadfence();
    __syncthreads();
    int* last = reinterpret_cast<int*>(red);  // red's readers are done
    if (tid < nseg) {
      const int lt = lt0 + tid;
      last[tid] = atomicAdd(count + lt, 1) == tile_pieces(lt, tw) - 1;
    }
    __syncthreads();
    for (int sg = 0; sg < nseg; ++sg) {
      if (!last[sg]) continue;
      __threadfence();
      const int lt = lt0 + sg;
      const long long c0 = static_cast<long long>(lt) * tw / kCT;
      const int np = tile_pieces(lt, tw);
      // the tile's first cell: launch tile j, physical tile (v0 + j) mod NT
      const long long a = static_cast<long long>(lt) * tw, T = static_cast<long long>(cpt) * kCT;
      const long long jt = a / T;
      const long long g0 = (v0 + jt) % NT * T + (a - jt * T);
      float* out = mpart + static_cast<long long>(slot[g0 / tw]) * K * d1;
      const float4* rows = reinterpret_cast<const float4*>(mpiece);
      for (int i = tid; i < KDp / 4; i += kThreads) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c = 0; c < np; ++c) {
          // piece c0 + c's row of this tile: its second where it starts
          // in the tile before
          const long long pc = c0 + c;
          const long long row = whole ? pc : 2 * pc + (pc * kCT / tw != lt);
          const float4 x = __ldcg(rows + row * (KDp / 4) + i);
          v.x += x.x;
          v.y += x.y;
          v.z += x.z;
          v.w += x.w;
        }
        const float vv[4] = {v.x, v.y, v.z, v.w};
        const int k = 4 * i / d1p, e0 = 4 * i - k * d1p;
        for (int t = 0; t < 4; ++t)
          if (k < K && e0 + t < d1) out[k * d1 + e0 + t] = vv[t];
      }
      if (tid == 0) count[lt] = 0;
    }
  }
}

// One CTA per cluster row k; the commit after the block at position pos of
// the round's order (pos < 0: the round's first commit), the blocks read
// from the round's row of the schedule table as K7's assign launch reads
// them. add (pos >= 0): fold the block's partials (ntile tiles of cpt CTAs,
// physical tiles (v0 + j) mod NT) into tile_O and E/O, and on row 0 the
// objective terms into acc (zeroed by the first commit); rm_n > 0 (a block
// follows at pos + 1): remove its old O, tiles (rm_v0 + j) mod NT, j <
// rm_n, summed from the previous table tO_old; always: write the penalty
// tables (emit_pen: also into the removed block's row of pen_out, its
// stored table). E/O are read from E_in/O_in and written to E/O (the first
// commit of a round copies them). The tile sums are read back from tO_new
// after the barrier, which makes the CTA's global writes visible to all its
// threads.
__global__ void __launch_bounds__(kThreads) rot_commit_kernel(
    const float* __restrict__ part, const int* __restrict__ sched,
    const int* __restrict__ blocks, int pos, int nb, int cpt,
    int NT, float* tO_new, const float* __restrict__ tO_old,
    const float* E_in, const float* O_in, float* E, float* O,
    const float* __restrict__ Pr, const float* __restrict__ theta,
    float* __restrict__ pen, float* __restrict__ logpen,
    float* __restrict__ pen_out, int emit_pen,
    float* __restrict__ acc, int K, int B, int b0) {
  extern __shared__ float buf[];  // B block sums, B removal, 2*ntile objective
  const int rt = sched[0];
  const int add_blk = pos >= 0 ? sched[1 + pos] : -1;
  const int rm_blk = pos + 1 < nb ? sched[2 + pos] : -1;
  const int add = add_blk >= 0, zero_acc = pos < 0;
  const int v0 = add ? (blocks[nb + add_blk] + rt) % NT : 0;
  const int ntile = add ? blocks[add_blk] : 0;
  const int rm_v0 = rm_blk >= 0 ? (blocks[nb + rm_blk] + rt) % NT : 0;
  const int rm_n = rm_blk >= 0 ? blocks[rm_blk] : 0;
  const int pen_row = emit_pen && rm_blk >= 0 ? rm_blk : -1;
  const int k = blockIdx.x, tid = threadIdx.x;
  const int P = K * B + 2;
  float* fin = buf;
  float* rmv = fin + B;
  float* obj = rmv + B;
  if (add) {
    for (int i = tid; i < ntile * B; i += kThreads) {
      const int j = i / B, b = i - j * B;
      const long long row0 = static_cast<long long>(j) * cpt;
      float v = 0.f;
      for (int c = 0; c < cpt; ++c) v += part[(row0 + c) * P + k * B + b];
      tO_new[(((v0 + j) % NT) * static_cast<long long>(K) + k) * B + b] = v;
    }
    if (k == 0) {
      for (int i = tid; i < 2 * ntile; i += kThreads) {
        const int j = i >> 1, s = i & 1;
        const long long row0 = static_cast<long long>(j) * cpt;
        float v = 0.f;
        for (int c = 0; c < cpt; ++c) v += part[(row0 + c) * P + K * B + s];
        obj[i] = v;
      }
    }
  }
  for (int b = tid; b < B && rm_n > 0; b += kThreads) {
    float v = 0.f;
    for (int j = 0; j < rm_n; ++j)
      v += tO_old[(((rm_v0 + j) % NT) * static_cast<long long>(K) + k) * B + b];
    rmv[b] = v;
  }
  __syncthreads();
  for (int b = tid; b < B && add; b += kThreads) {
    float v = 0.f;
    for (int j = 0; j < ntile; ++j)
      v += tO_new[(((v0 + j) % NT) * static_cast<long long>(K) + k) * B + b];
    fin[b] = v;
  }
  __syncthreads();
  float radd = 0.f, rrm = 0.f;
  for (int b = 0; b < b0; ++b) {
    if (add) radd += fin[b];
    if (rm_n > 0) rrm += rmv[b];
  }
  for (int b = tid; b < B; b += kThreads) {
    const int i = k * B + b;
    float e = E_in[i], o = O_in[i];
    if (add) {
      e = e + radd * Pr[b];
      o = o + fin[b];
    }
    if (rm_n > 0) {
      e = e - rrm * Pr[b];
      o = o - rmv[b];
    }
    E[i] = e;
    O[i] = o;
    const float ratio = (2.f * e + 1.f) / (o + e + 1.f);
    const float pv = powf(ratio, theta[b]);
    pen[i] = pv;
    logpen[i] = logf(ratio) * theta[b];
    if (pen_row >= 0) pen_out[static_cast<long long>(pen_row) * K * B + i] = pv;
  }
  if (k == 0 && tid == 0) {
    float a = zero_acc ? 0.f : acc[0], c = zero_acc ? 0.f : acc[1];
    for (int j = 0; j < ntile && add; ++j) {
      a += obj[2 * j];
      c += obj[2 * j + 1];
    }
    acc[0] = a;
    acc[1] = c;
  }
}

// ---- K6 ---------------------------------------------------------------

// A persistent CTA walks the 64-cell pieces p = blockIdx.x, + gridDim.x,
// ...: Y^T is staged once (d x K8, cluster-contiguous, zero past K), each
// piece's Z columns and codes come in by cp.async while the previous piece
// computes. Per piece: column norms (four partial sums a cell, summed in
// order), Zn stored; g = Y^T zn with a 4-cell x 8-cluster register tile a
// thread (tile_gram, which K11 runs too, so G has the bits K11
// recomputes). The tile's epilogue stores its rows of G
// from the registers, takes w = exp((g - 1) 2/sigma) on valid cells and
// its partial column sums (a table of ceil(K/8) x 64, summed per cell in
// tile order). The (K x B) design sums of R = w / colsum: thread (k, h)
// walks split h of the piece's cells (nh splits), a run of one batch row
// summed in a register (four cells at once where they share it), and the
// splits are added in order into the piece's partials row. CTA 0 zeroes
// the reduce's arrival counts. kMma: the bf16 product form, g by
// piece_gram_bf16 from Y^T in bf16 (Ybg, staged once) and the piece's Zn
// rounded to bf16 as it is normalised, into the (K8 x 64) table, from
// which each thread takes its register tile for the same epilogue.
template <typename TZ, bool kMma>
__global__ void __launch_bounds__(kThreads, 2) reassign_assign_kernel(
    const float* __restrict__ Yt,     // (K, d) (the fp32-product form)
    const __nv_bfloat16* __restrict__ Ybg,  // (K8, S) Y^T in bf16, zero past K, d (kMma)
    const TZ* __restrict__ Z,         // (d, L) raw corrected embedding, float, bf16 or f16
    const int* __restrict__ codes,    // (ncov, L), pads < 0
    const int* __restrict__ offsets,  // (ncov,)
    const float* __restrict__ sigma,  // (K,)
    float* __restrict__ Zn,           // (d, L) out, L2-normalised columns
    float* __restrict__ G,            // (L, K) out, g = Y^T Zn a cell a row
    float* __restrict__ part,         // (L/64, K*B) out
    int* __restrict__ count,          // (n_chunk + 1,) the reduce's counts, zeroed
    long long L, int K, int d, int B, int ncov, int K8, int nh, int n_chunk, int S, int d16) {
  extern __shared__ __align__(16) float smem[];
  const int nkg = K8 / 8;
  float* Ys = smem;                 // d*K8; kMma: Y^T in bf16 (K8*S), then the piece's
                                    // bf16 Zn (64*S)
  __nv_bfloat16* Yb = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Zp = Yb + K8 * S;
  float* Zb = smem + (kMma ? K8 * S / 2 + 32 * S : d * K8);  // 2*d*kCT: the pieces' Z (float:
                                    // normalised in place; 2-byte: two staged pieces, then
                                    // one float piece)
  float* Ls = Zb + 2 * d * kCT;     // K8*kLP: w = exp((g - 1) 2/sigma)
  int* cb = reinterpret_cast<int*>(Ls + K8 * kLP);  // 2*ncov*kCT: the pieces' codes
  float* invs = reinterpret_cast<float*>(cb + 2 * ncov * kCT);  // kCT: 1 / colsum(w)
  float* red = invs + kCT;          // 4*kCT: column norm partials
  float* psum = red + 4 * kCT;      // nkg*kCT: partial column sums of w
  float* Obs = psum + nkg * kCT;    // nh*K*B
  float* i2s = Obs + nh * K * B;    // K
  int* offs = reinterpret_cast<int*>(i2s + K);  // ncov

  const int tid = threadIdx.x;
  const int npc = static_cast<int>(L / kCT);
  if (blockIdx.x == 0)  // the reduce's counts: one a column chunk, one for the chunks
    for (int i = tid; i <= n_chunk; i += kThreads) count[i] = 0;
  if constexpr (kMma) {
    // Y^T's bf16 rows as they lie; the piece's rows stay zero past d
    for (int i = tid; i < K8 * S / 8; i += kThreads)
      reinterpret_cast<uint4*>(Yb)[i] = reinterpret_cast<const uint4*>(Ybg)[i];
    for (int i = tid; i < 32 * S; i += kThreads) reinterpret_cast<unsigned*>(Zp)[i] = 0u;
  } else {
    for (int i = tid; i < d * K8; i += kThreads) {
      const int e = i / K8, k = i - e * K8;
      Ys[i] = k < K ? Yt[k * d + e] : 0.f;
    }
  }
  for (int i = tid; i < K; i += kThreads) i2s[i] = 2.f / sigma[i];
  if (tid < ncov) offs[tid] = offsets[tid];
  constexpr int kQ = kCT / 4;  // 16-byte copies of a piece's row of codes
  constexpr int kE = 16 / static_cast<int>(sizeof(TZ));  // Z values a 16-byte copy
  constexpr int kQz = kCT / kE;                           // copies of a piece's row of Z
  constexpr bool kF32 = std::is_same<TZ, float>::value;
  TZ* Zs = reinterpret_cast<TZ*>(Zb);  // the two staged pieces
  auto stage = [&](int p, int buf) {
    const long long base = static_cast<long long>(p) * kCT;
    TZ* zs = Zs + buf * d * kCT;
    for (int i = tid; i < d * kQz; i += kThreads) {
      const int e = i / kQz, q = i - e * kQz;
      cp_async16(zs + e * kCT + kE * q, Z + e * L + base + kE * q);
    }
    int* c = cb + buf * ncov * kCT;
    for (int i = tid; i < ncov * kQ; i += kThreads) {
      const int cc = i / kQ, q = i - cc * kQ;
      cp_async16(c + cc * kCT + 4 * q, codes + cc * L + base + 4 * q);
    }
  };
  if (static_cast<int>(blockIdx.x) < npc) stage(blockIdx.x, 0);
  cp_async_commit();
  const int cg = tid & 15;
  const bool vec = (K & 3) == 0;  // rows of G start on 16-byte boundaries
  for (int p = blockIdx.x, s = 0; p < npc; p += gridDim.x, ++s) {
    const int cur = s & 1;
    if (p + static_cast<int>(gridDim.x) < npc) stage(p + gridDim.x, cur ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // the piece is in; the last piece's readers are done
    const long long base = static_cast<long long>(p) * kCT;
    const TZ* zs = Zs + cur * d * kCT;
    // the piece as float: in place (float), else the float buffer past the
    // two staged 2-byte pieces
    float* zb = kF32 ? Zb + cur * d * kCT : Zb + d * kCT;
    const int* gc = cb + cur * ncov * kCT;
    {
      // column norms; zero columns (pads) stay zero (src/harmony.cpp:220)
      const int t = tid & (kCT - 1), q = tid / kCT;
      float s2 = 0.f;
      for (int e = q; e < d; e += kThreads / kCT) {
        const float z = to_f(zs[e * kCT + t]);
        s2 += z * z;
      }
      red[q * kCT + t] = s2;
    }
    for (int i = tid; i < nh * K * B; i += kThreads) Obs[i] = 0.f;
    __syncthreads();
    {
      const int t = tid & (kCT - 1);
      const float nr = sqrtf(((red[t] + red[kCT + t]) + red[2 * kCT + t]) + red[3 * kCT + t]);
      const float n = nr == 0.f ? 1.f : nr;
      for (int e = tid / kCT; e < d; e += kThreads / kCT) {
        const float z = to_f(zs[e * kCT + t]) / n;
        if constexpr (kMma)
          Zp[t * S + e] = __float2bfloat16_rn(z);
        else
          zb[e * kCT + t] = z;
        Zn[e * L + base + t] = z;
      }
    }
    __syncthreads();
    if constexpr (kMma) {
      piece_gram_bf16(Zp, Yb, S, d16, K8, [&](int t, int k, float v) { Ls[k * kLP + t] = v; });
      __syncthreads();
    }
    for (int kg = tid >> 4; kg < nkg; kg += kThreads / 16) {
      float acc[4][8];
      if constexpr (kMma) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(Ls + (8 * kg + j) * kLP + 4 * cg);
          acc[0][j] = v.x;
          acc[1][j] = v.y;
          acc[2][j] = v.z;
          acc[3][j] = v.w;
        }
      } else {
        tile_gram(Ys + 8 * kg, K8, zb + 4 * cg, d, acc);
      }
      const int k0 = 8 * kg;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * cg + i;
        // the cell's row of G
        float* grow = G + (base + t) * K + k0;
        if (vec) {
          *reinterpret_cast<float4*>(grow) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          if (k0 + 4 < K)
            *reinterpret_cast<float4*>(grow + 4) =
                make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (k0 + j < K) grow[j] = acc[i][j];
        }
        // w on valid cells, and the tile's part of the cell's column sum
        const float valid = gc[t] >= 0 ? 1.f : 0.f;
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = k0 + j < K ? expf((acc[i][j] - 1.f) * i2s[k0 + j]) * valid : 0.f;
          acc[i][j] = v;
          ps += v;
        }
        psum[kg * kCT + t] = ps;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float4*>(Ls + (k0 + j) * kLP + 4 * cg) =
            make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    }
    __syncthreads();
    if (tid < kCT) {
      float cs = 0.f;
      for (int kg = 0; kg < nkg; ++kg) cs += psum[kg * kCT + tid];
      invs[tid] = 1.f / (cs == 0.f ? 1.f : cs);
    }
    __syncthreads();
    // the (K x B) design sums of R = w / colsum: thread (k, h) walks split
    // h's cells, a run of one batch row summed in a register and added to
    // its own row once
    const int span = kCT / nh;
    for (int it = tid; it < nh * K; it += kThreads) {
      const int h = it / K, k = it - h * K;
      float* ob = Obs + (h * K + k) * B;
      const float* lr = Ls + k * kLP + h * span;
      const float* iv = invs + h * span;
      for (int c = 0; c < ncov; ++c) {
        const int* g = gc + c * kCT + h * span;
        const int off = offs[c];
        int cur_b = -1;
        float run = 0.f;
        for (int t4 = 0; t4 < span; t4 += 4) {
          const float4 x = *reinterpret_cast<const float4*>(lr + t4);
          const float4 y = *reinterpret_cast<const float4*>(iv + t4);
          const int4 c4 = *reinterpret_cast<const int4*>(g + t4);
          const float xv[4] = {__fmul_rn(x.x, y.x), __fmul_rn(x.y, y.y), __fmul_rn(x.z, y.z),
                               __fmul_rn(x.w, y.w)};
          const int cv[4] = {c4.x, c4.y, c4.z, c4.w};
          if (cur_b >= 0 && c4.x + off == cur_b && c4.y == c4.x && c4.z == c4.x &&
              c4.w == c4.x) {
            run += (xv[0] + xv[1]) + (xv[2] + xv[3]);  // four cells of the run
            continue;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int b = cv[u] >= 0 ? cv[u] + off : -1;
            if (b != cur_b) {
              if (cur_b >= 0) ob[cur_b] += run;
              cur_b = b;
              run = 0.f;
            }
            run += xv[u];
          }
        }
        if (cur_b >= 0) ob[cur_b] += run;
      }
    }
    __syncthreads();
    float* prow = part + static_cast<long long>(p) * K * B;
    for (int i = tid; i < K * B; i += kThreads) {
      float v = Obs[i];
      for (int h = 1; h < nh; ++h) v += Obs[h * K * B + i];
      prow[i] = v;
    }
  }
  cp_async_wait<0>();
}

// K6's reduce, CTA (p, chunk): each thread takes one (k, b) column i of
// the chunk and sums the cpt piece rows of tile p in piece order (the rows
// read coalesced, 16 at a time) into tile_O[p]. The last CTA of a column
// chunk to finish (an integer count a chunk) folds the chunk's columns of
// O = the sum of tile_O over tiles in tile order; the last of those
// (count[gridDim.y]) writes E[k, :] = (sum of O[k, :b0]) * Pr. The counts
// are zeroed by the assign launch.
__global__ void __launch_bounds__(kThreads) reassign_reduce_kernel(
    const float* __restrict__ part, int NT, int cpt, float* tO, float* O,
    float* __restrict__ E, const float* __restrict__ Pr, int* __restrict__ count, int K,
    int B, int b0) {
  constexpr int kU = 16;
  __shared__ int last;
  const int KB = K * B;
  const int p = blockIdx.x, i = blockIdx.y * kThreads + threadIdx.x;
  if (i < KB) {
    const float* src = part + static_cast<long long>(p) * cpt * KB + i;
    float v = 0.f;
    for (int c0 = 0; c0 < cpt; c0 += kU) {
      float x[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        x[u] = c0 + u < cpt ? src[static_cast<long long>(c0 + u) * KB] : 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (c0 + u < cpt) v += x[u];
    }
    tO[static_cast<long long>(p) * KB + i] = v;
  }
  // the fences order the rows before the count (release) and the count
  // before the reads that follow it (acquire), which read L2 (__ldcg)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(count + blockIdx.y, 1) == NT - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (i < KB) {
    float v = 0.f;
    for (int q0 = 0; q0 < NT; q0 += kU) {
      float x[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        x[u] = q0 + u < NT ? __ldcg(tO + static_cast<long long>(q0 + u) * KB + i) : 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (q0 + u < NT) v += x[u];
    }
    O[i] = v;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(count + gridDim.y, 1) == static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = threadIdx.x; j < KB; j += kThreads) {
    const int k = j / B, b = j - k * B;
    float rs = 0.f;
    for (int bb = 0; bb < b0; ++bb) rs += __ldcg(O + k * B + bb);
    E[j] = rs * Pr[b];
  }
}

// ---- K10 / K11 ---------------------------------------------------------

// K10's and K11's penalties of four of a step's cells, t0..t0+3, for one
// warp, lanes over clusters k = lane + 32 j: pc = 0 + the table entries of
// the cell's batch rows, covariate by covariate (assign_chain's sum), 0 on
// pad cells and past K; all four cells' lookups first, so no cell's wait on
// another's.
template <int KJ>
__device__ __forceinline__ void v_pens(const float* pt, const int* gc, int t0, int K, int B,
                                       int ncov, float (&v)[4][KJ]) {
  constexpr int NC = 4;
  const int lane = threadIdx.x & 31;
  int b[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) b[c] = gc[t0 + c];
#pragma unroll
  for (int j = 0; j < KJ; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      v[c][j] = 0.f;
      if (lane + 32 * j < K && b[c] >= 0) v[c][j] = 0.f + pt[(lane + 32 * j) * B + b[c]];
    }
  for (int cv = 1; cv < ncov; ++cv) {
#pragma unroll
    for (int c = 0; c < NC; ++c) b[c] = gc[cv * kVCells + t0 + c];
#pragma unroll
    for (int j = 0; j < KJ; ++j)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (lane + 32 * j < K && b[c] >= 0) v[c][j] += pt[(lane + 32 * j) * B + b[c]];
  }
}

// The chain of K10 and K11 (to 256 clusters) for four of a step's cells,
// t0..t0+3, one warp, lanes over clusters k = lane + 32 j, g of cell t in
// row t of Gc (K floats a row): per cell assign_chain's operations in its
// order (so K7's R bit for bit: each column sum a lane's sum over j in
// order, then the xor-shuffle tree), the four cells interleaved so that
// their latencies overlap. s holds 2/sigma of the lane's clusters, under
// kLegacy sigma. R goes into the (K x 64) table Lh as one float4 of the
// four cells a cluster.
template <int KJ, bool kLegacy>
__device__ __forceinline__ void v_chain(const float* Gc, const float* pt, const int* gc,
                                        float* Lh, const float (&s)[KJ], int t0, int K,
                                        int B, int ncov) {
  constexpr int NC = 4;
  const int lane = threadIdx.x & 31;
  float v[NC][KJ], cs[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) cs[c] = 0.f;
  if constexpr (kLegacy) {
    // e = exp(-2 (1 - g) / sigma) and colsum(e); then per cluster value
    // its four penalties (v_pens' sums, one j at a time: the registers
    // hold e) and w = (e / colsum(e)) * pc
    float c1[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) c1[c] = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int k = lane + 32 * j;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        v[c][j] = 0.f;
        if (k < K) {
          v[c][j] = legacy_e(legacy_d(Gc[(t0 + c) * K + k]), s[j]);
          c1[c] += v[c][j];
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int c = 0; c < NC; ++c) c1[c] += __shfl_xor_sync(0xffffffffu, c1[c], o);
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int k = lane + 32 * j;
      if (k >= K) continue;
      float pc[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int b = gc[t0 + c];
        pc[c] = b >= 0 ? 0.f + pt[k * B + b] : 0.f;
      }
      for (int cv = 1; cv < ncov; ++cv)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int b = gc[cv * kVCells + t0 + c];
          if (b >= 0) pc[c] += pt[k * B + b];
        }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        v[c][j] = __fmul_rn(__fdiv_rn(v[c][j], c1[c]), pc[c]);
        cs[c] += v[c][j];
      }
    }
  } else {
    v_pens<KJ>(pt, gc, t0, K, B, ncov, v);
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int k = lane + 32 * j;
      if (k < K)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          v[c][j] = __fmul_rn(expf(__fmul_rn(Gc[(t0 + c) * K + k] - 1.f, s[j])), v[c][j]);
          cs[c] += v[c][j];
        }
    }
  }
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int c = 0; c < NC; ++c) cs[c] += __shfl_xor_sync(0xffffffffu, cs[c], o);
#pragma unroll
  for (int c = 0; c < NC; ++c) cs[c] = 1.f / (cs[c] == 0.f ? 1.f : cs[c]);
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int k = lane + 32 * j;
    if (k < K)
      *reinterpret_cast<float4*>(Lh + k * kVLP + t0) =
          make_float4(__fmul_rn(v[0][j], cs[0]), __fmul_rn(v[1][j], cs[1]),
                      __fmul_rn(v[2][j], cs[2]), __fmul_rn(v[3][j], cs[3]));
  }
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// K10's named barriers (0 is __syncthreads): the chain's warps, each
// correction group's warps, and per R table b, full (chain -> correction)
// and empty (correction -> chain).
constexpr int kBarChain = 1, kBarGroup = 2, kBarFull = 4, kBarEmpty = 7;

// K10: a persistent CTA of 512 threads a SM takes an equal range of the
// layout tiles in K8's plan order (joint by joint), 64-cell steps, its
// warps in roles that meet at named barriers, so no role waits on
// another's step. The chain's warps start step s+1's copies (cp.async: the
// cells' rows of the phase's G, one contiguous span; the penalty table of
// their tile's block; their codes), then run step s's chain (v_chain, four
// cells a warp at a time) into R table s mod (ng + 1) once its last reader
// is done with it, and mark it full. The correction takes ng groups of the
// first warps (two where both leave the chain eight warps, d <= 64, and
// their betas and R tables fit, else one; cuda_rotate.virtual_plan), group
// g the steps s = g mod ng, so a group has ng steps' time for its own and
// each scheduler holds ng of its warps; thread (tb, eb) of a group owns a
// 4-dim x 8-cell register tile, cells 4tb..4tb+3 and 32+4tb..32+4tb+3 (so
// eight lanes read 128 contiguous bytes of a row of R: no bank
// conflicts), one float4 of betas and two of R a cluster for 32 FMAs,
// acc = fmaf(w, r, acc) over k = 0..K-1 from 0 (K9's sequence), its
// Z_orig loaded as float4s before the product and Z_corr stored as float4s;
// then it marks the table empty. A group stages a joint's betas into its
// own buffer where the joint starts among its steps (once or twice a
// range). A trash step copies Z_orig through (its betas are zero). Where
// layout tiles are not whole 64-cell pieces (tw = 160), a tile's steps
// are the pieces it meets, cut at its edges: the chain runs all 64 cells
// of a piece, the correction writes the tile's cells only, so a piece
// across a tile boundary runs once for each of its two tiles (the same
// bits both times), each with its own joint's betas. The
// chain and the correction share the SM's instruction slots and shared-memory
// loads, so they overlap only in part. kMma: the bf16 product form of the
// correction: a group stages its joint's betas as the wrapper rounded them
// (bf16, (d16 x SW) a dim a row, zero past d and K; SW = K16 + 8), the R
// tables hold K16 rows (zero past K), and warp w of a group takes the
// step's 16-dim rows w, w + cw, ... against all eight 8-cell columns: its
// Z_orig loaded first, then mma.sync over K in 16-wide steps, A from the
// betas' rows once a step, B from the chain's float table rounded to bf16
// pairs as it loads, then Z_orig - W R two cells at a time.
template <int KJ, bool kLegacy, typename TZ, bool kWhole, bool kMma>
__global__ void __launch_bounds__(kVThreads, 1) virtual_correction_kernel(
    const float* __restrict__ G,       // (L, K) the phase's Gram table (K6)
    const int* __restrict__ codes,     // (ncov, L), pads < 0
    const int* __restrict__ offsets,   // (ncov,)
    const float* __restrict__ pen,     // (nb, K, B) the last round's block tables
    const int* __restrict__ blkmap,    // (L / T,) block of each physical tile
    const float* __restrict__ sigma,   // (K,)
    const float* __restrict__ Wj,      // (n_joint + 1, d, K) betas (the fp32-product form)
    const __nv_bfloat16* __restrict__ Wbj,  // (n_joint + 1, d16, SW) bf16 betas (kMma)
    const int* __restrict__ order,     // (n,) the plan's layout tiles, joint by joint
    const int* __restrict__ tj,        // (L / tw,) joint of each layout tile
    const TZ* __restrict__ Zo,         // (d, L), float, bf16 or f16
    TZ* __restrict__ Zc,               // (d, L) out, Zo's type
    long long L, int n, int span, int T, int tw, int spt, int trash, int K, int d, int dp,
    int B, int ncov, int ng, int SW, int d16) {
  extern __shared__ __align__(16) float smem[];
  const int neb = (d + 3) / 4;
  const int cw = (8 * neb + 31) / 32;              // a correction group's warps
  const int nbuf = ng + 1;                         // R tables
  const int KBp = (K * B + 3) / 4 * 4;
  const int wsz = kMma ? d16 * SW / 2 : K * dp;    // floats of a group's betas
  float* Ws = smem;                      // ng*wsz: each group's betas
  float* Gs = Ws + ng * wsz;             // 2*kVCells*K: the steps' rows of G
  const int rstr = (kMma ? (K + 15) / 16 * 16 : K) * kVLP;  // floats of an R table
  float* Ls = Gs + 2 * kVCells * K;      // nbuf*rstr: the steps' R, cluster-major
  float* pens = Ls + nbuf * rstr;        // 2*KBp: the steps' block tables
  int* gcs = reinterpret_cast<int*>(pens + 2 * KBp);  // 2*ncov*kVCells global batch rows
  int* pl = gcs + 2 * ncov * kVCells;    // 3*span: the range's tiles, joints, blocks
  int* offs = pl + 3 * span;             // ncov
  const int tid = threadIdx.x, w = tid >> 5;
  constexpr int kQ = kVCells / 4;  // float4s of a step's row
  const int lo = static_cast<int>(static_cast<long long>(blockIdx.x) * n / gridDim.x);
  const int nt = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * n / gridDim.x) - lo;
  for (int i = tid; i < nt; i += kVThreads) {
    const int t = order[lo + i];
    pl[i] = t;
    pl[span + i] = tj[t];
    pl[2 * span + i] = blkmap[static_cast<long long>(t) * tw / T];
  }
  if (tid < ncov) offs[tid] = offsets[tid];
  if constexpr (kMma)  // the R tables' rows past K, which the chain never writes
    for (int bb = 0; bb < nbuf; ++bb)
      for (int i = K * kVLP + tid; i < rstr; i += kVThreads) Ls[bb * rstr + i] = 0.f;
  __syncthreads();  // the range's plan is in
  // step s of the range: piece (tile * tw) / 64 + s % spt of the tile
  // pl[s / spt], cells [cut_lo, cut_hi) of it in the tile; a tile meets at
  // most spt pieces (tw / 64 where tiles are whole pieces: all 64 cells),
  // a step past its last is empty (cut_lo >= cut_hi)
  const int ns = nt * spt;
  const int nT = 32 * cw, nC = kVThreads - ng * nT;
  // kWhole: tw is a multiple of 64, every step a whole piece of its tile
  auto first = [&](int s) { return static_cast<long long>(pl[s / spt]) * tw; };
  auto base = [&](int s) { return (first(s) / kVCells + s % spt) * kVCells; };
  auto cut_lo = [&](int s) {
    return kWhole ? 0 : static_cast<int>(max(first(s) - base(s), 0LL));
  };
  auto cut_hi = [&](int s) {
    return kWhole ? kVCells
                  : static_cast<int>(min(first(s) + tw - base(s),
                                         static_cast<long long>(kVCells)));
  };
  auto joint = [&](int s) { return pl[span + s / spt]; };
  // the chain runs a step of a non-trash joint that holds cells
  auto live = [&](int s) { return joint(s) != trash && cut_lo(s) < cut_hi(s); };

  if (w >= ng * cw) {
    // ---- the chain's warps ----
    const int ct = tid - ng * nT, wc = w - ng * cw, nwc = nC / 32, lane = tid & 31;
    float sv[KJ];  // the chain's 2/sigma (legacy: sigma) of the lane's clusters
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int k = lane + 32 * j;
      sv[j] = k < K ? (kLegacy ? sigma[k] : 2.f / sigma[k]) : 0.f;
    }
    auto stage = [&](int s, int h) {
      if (s >= ns || !live(s)) return;
      const long long b0 = base(s);
      const float* src = G + b0 * K;  // 16-byte aligned: b0 is a multiple of 64
      float* gd = Gs + h * kVCells * K;
      for (int i = ct; i < kVCells * K / 4; i += nC) cp_async16(gd + 4 * i, src + 4 * i);
      const float* pb = pen + static_cast<long long>(pl[2 * span + s / spt]) * K * B;
      float* pd = pens + h * KBp;
      for (int i = ct; i < K * B; i += nC) cp_async4(pd + i, pb + i);
      int* cd = gcs + h * ncov * kVCells;
      for (int i = ct; i < ncov * kQ; i += nC) {
        const int c = i / kQ, q = i - c * kQ;
        cp_async16(cd + c * kVCells + 4 * q, codes + c * L + b0 + 4 * q);
      }
    };
    stage(0, 0);
    cp_async_commit();
    for (int s = 0; s < ns; ++s) {
      const int h = s & 1, b = s % nbuf;
      const bool on = live(s);
      cp_async_wait<0>();
      if (on) {
        // the codes this thread copied, made global batch rows (-1 on pads)
        int* cd = gcs + h * ncov * kVCells;
        for (int i = ct; i < ncov * kQ; i += nC) {
          const int c = i / kQ, o = offs[c];
          int4* p = reinterpret_cast<int4*>(cd + c * kVCells + 4 * (i - c * kQ));
          int4 v = *p;
          v.x = v.x >= 0 ? v.x + o : -1;
          v.y = v.y >= 0 ? v.y + o : -1;
          v.z = v.z >= 0 ? v.z + o : -1;
          v.w = v.w >= 0 ? v.w + o : -1;
          *p = v;
        }
      }
      bar_sync(kBarChain, nC);  // step s's inputs are in; step s-1's are free
      stage(s + 1, h ^ 1);
      cp_async_commit();
      if (s >= nbuf) bar_sync(kBarEmpty + b, nC + nT);  // step s - nbuf's correction is done
      if (on) {
        const float* Gc = Gs + h * kVCells * K;
        const float* pt = pens + h * KBp;
        const int* gc = gcs + h * ncov * kVCells;
        float* Lh = Ls + b * rstr;
        for (int g = wc; g < kVCells / 4; g += nwc)
          v_chain<KJ, kLegacy>(Gc, pt, gc, Lh, sv, 4 * g, K, B, ncov);
      }
      bar_arrive(kBarFull + b, nC + nT);
    }
    cp_async_wait<0>();
    return;
  }

  // ---- a correction group ----
  const int grp = w / cw, gt = tid - grp * nT;
  const bool owns = gt < 8 * neb;
  const int tb = gt & 7, eb = gt >> 3;
  float* Wg = Ws + grp * wsz;
  int held = -1;  // the joint whose betas are in Wg
  for (int s = grp; s < ns; s += ng) {
    const int b = s % nbuf, jt = joint(s);
    bar_sync(kBarFull + b, nC + nT);  // step s's R is in Ls[b]
    const int c_lo = cut_lo(s), c_hi = cut_hi(s);
    if (c_lo < c_hi && jt != trash && jt != held) {
      // the joint's betas, once every thread of the group is done with the
      // last: the product form's bf16 rows as they lie, else transposed into
      // (K x dp) as they come in (the columns past d are never stored from)
      bar_sync(kBarGroup + grp, nT);
      if constexpr (kMma) {
        const __nv_bfloat16* src = Wbj + static_cast<long long>(jt) * d16 * SW;
        for (int i = gt; i < d16 * SW / 8; i += nT) cp_async16(Wg + 4 * i, src + 8 * i);
      } else {
        const float* src = Wj + static_cast<long long>(jt) * d * K;
        for (int i = gt; i < d * K; i += nT) {
          const int e = i / K;
          cp_async4(Wg + (i - e * K) * dp + e, src + i);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      bar_sync(kBarGroup + grp, nT);
      held = jt;
    }
    const long long b0 = base(s);
    if (c_lo >= c_hi) {
      // an empty step: nothing of the tile
    } else if (jt == trash) {
      for (int x = gt; x < d * kQ; x += nT) {
        const int e = x / kQ, c = 4 * (x - e * kQ);
        const long long o = e * L + b0 + c;
        store4_cells<kWhole>(Zc + o, load4(Zo + o), c, c_lo, c_hi);
      }
    } else if constexpr (kMma) {
      // rows m0 + g (+ 8) of the step's product, cells 8 nt + 2 t (+ 1)
      const int lane = tid & 31, wg = w - grp * cw, gr = lane >> 2, tq = lane & 3;
      const int SW2 = SW / 2;
      const unsigned* W32 = reinterpret_cast<const unsigned*>(Wg);
      const float* Rt = Ls + b * rstr;
      for (int mt = wg; mt < d16 / 16; mt += cw) {
        const int m0 = 16 * mt;
        float2 z[8][2];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = m0 + gr + 8 * h;
            z[nt][h] = e < d ? load2(Zo + e * L + b0 + 8 * nt + 2 * tq) : make_float2(0.f, 0.f);
          }
        float c[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
        const unsigned* wr = W32 + (m0 + gr) * SW2 + tq;
        for (int k0 = 0; k0 < K; k0 += 16) {
          const int k2 = k0 / 2;
          const unsigned a[4] = {wr[k2], wr[8 * SW2 + k2], wr[k2 + 4], wr[8 * SW2 + k2 + 4]};
          const float* r0 = Rt + (k0 + 2 * tq) * kVLP + gr;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const float* rc = r0 + 8 * nt;
            const unsigned bb[2] = {bf16_pair(rc[0], rc[kVLP]),
                                    bf16_pair(rc[8 * kVLP], rc[9 * kVLP])};
            mma_bf16(c[nt], a, bb);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = m0 + gr + 8 * h, cell = 8 * nt + 2 * tq;
            if (e < d)
              store2_cells<kWhole>(Zc + e * L + b0 + cell,
                                   make_float2(z[nt][h].x - c[nt][2 * h],
                                               z[nt][h].y - c[nt][2 * h + 1]),
                                   cell, c_lo, c_hi);
          }
      }
    } else if (owns) {
      float4 z[4][2];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int e = 4 * eb + ii;
        if (e >= d) continue;
        const TZ* zp = Zo + e * L + b0 + 4 * tb;
        z[ii][0] = load4(zp);
        z[ii][1] = load4(zp + 32);
      }
      float acc[4][8];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[ii][j] = 0.f;
      const float* Wp = Wg + 4 * eb;
      const float* Rp = Ls + b * rstr + 4 * tb;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float4 wq = *reinterpret_cast<const float4*>(Wp + k * dp);
        const float4 ra = *reinterpret_cast<const float4*>(Rp + k * kVLP);
        const float4 rb = *reinterpret_cast<const float4*>(Rp + k * kVLP + 32);
        const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
        const float rv[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[ii][j] = fmaf(wv[ii], rv[j], acc[ii][j]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int e = 4 * eb + ii;
        if (e >= d) continue;
        TZ* op = Zc + e * L + b0 + 4 * tb;
        store4_cells<kWhole>(op, make_float4(z[ii][0].x - acc[ii][0], z[ii][0].y - acc[ii][1],
                                     z[ii][0].z - acc[ii][2], z[ii][0].w - acc[ii][3]),
                     4 * tb, c_lo, c_hi);
        store4_cells<kWhole>(op + 32, make_float4(z[ii][1].x - acc[ii][4], z[ii][1].y - acc[ii][5],
                                          z[ii][1].z - acc[ii][6], z[ii][1].w - acc[ii][7]),
                     32 + 4 * tb, c_lo, c_hi);
      }
    }
    if (s + nbuf < ns) bar_arrive(kBarEmpty + b, nC + nT);  // Ls[b] is free for step s+nbuf
  }
}

// K11: persistent CTAs (two a SM where their shared memory allows it),
// CTA c over the contiguous range of 64-cell pieces [c npc / grid,
// (c + 1) npc / grid). The centroids Y (d x K8, zero past K, the layout
// of K6's staged Y^T) are staged once a CTA where they fit (ys_shared),
// else read where they lie, through L1. Per piece: its Zn columns came in
// by cp.async during the last piece's chain, its codes during the last
// piece's R stores; the block's
// penalty table is staged again only where the piece's tile lies in
// another block than the last piece's; g = Y^T zn by tile_gram (K6's
// routine, so K6's bits) into the table the chain reads (KJ > 0: a row
// of K a cell, as the rows of K6's G that K10 reads; KJ == 0: (K x 65),
// assign_chain's); then the next piece's copies are issued; the chain
// (v_chain, four cells a warp, to 256 clusters; assign_chain past that)
// leaves R in a (K x 64) table, and R goes out as rows of 256 bytes a
// cluster (float4 stores; 128 bytes in 8-byte stores of four 2-byte
// values). Three barriers a piece. kMma: the bf16 product form, K6's: Y^T
// in bf16 (Ybg, (K8 x S), staged where ys_shared), the piece's Zn rounded
// to bf16 into a (64 x S) table once it is in (one barrier more), g by
// piece_gram_bf16 into the table the chain reads.
template <int KJ, bool kLegacy, typename TR, bool kMma>
__global__ void __launch_bounds__(kThreads, 2) materialize_r_kernel(
    const float* __restrict__ Yp,      // (d, K8) centroids, zero past K (fp32 products)
    const __nv_bfloat16* __restrict__ Ybg,  // (K8, S) Y^T in bf16, zero past K, d (kMma)
    const float* __restrict__ Zn,      // (d, L) the phase's normalised layout
    const int* __restrict__ codes,     // (ncov, L), pads < 0
    const int* __restrict__ offsets,   // (ncov,)
    const float* __restrict__ pen,     // (nb, K, B) the last round's block tables
    const int* __restrict__ blkmap,    // (L / T,) block of each physical tile
    const float* __restrict__ sigma,   // (K,)
    TR* __restrict__ R,                // (K, L) out, float, bf16 or f16
    long long L, int T, int K, int d, int B, int ncov, int K8, int ys_shared, int S, int d16) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, w = tid >> 5;
  // the layout (cuda_rotate.materialize_r_smem_bytes mirrors it), each part
  // a whole number of float4s
  float* Ys = smem;  // d*K8 (ys_shared); kMma: K8*S bf16
  float* Zb = Ys + (ys_shared ? (kMma ? K8 * S / 2 : d * K8) : 0);  // d*kCT: the piece's Zn
  __nv_bfloat16* Zp = reinterpret_cast<__nv_bfloat16*>(Zb + d * kCT);  // kMma: 64*S bf16
  float* Gs = Zb + d * kCT + (kMma ? 32 * S : 0);  // KJ > 0: kCT*K g; 0: K*kTP g, then R
  float* Lh = Gs + kCT * K;                        // KJ > 0: K*kVLP R
  float* sig = Gs + (K * kTP + 3) / 4 * 4;         // KJ == 0: sigma, then 2/sigma
  float* i2s = sig + K;
  float* pens = KJ > 0 ? Lh + K * kVLP : sig + (2 * K + 3) / 4 * 4;  // K*B
  int* gcs = reinterpret_cast<int*>(pens + (K * B + 3) / 4 * 4);     // ncov*kCT
  int* offs = gcs + ncov * kCT;                                      // ncov
  constexpr int kQ = kCT / 4;  // float4s of a piece's row
  const int npc = static_cast<int>(L / kCT);
  const int lo = static_cast<int>(static_cast<long long>(blockIdx.x) * npc / gridDim.x);
  const int hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * npc / gridDim.x);
  // a piece's copies: its Zn columns (once the product is done with the
  // last piece's) and its codes (once the chain is)
  auto stage_zn = [&](int p) {
    const long long base = static_cast<long long>(p) * kCT;
    for (int i = tid; i < d * kQ; i += kThreads) {
      const int e = i / kQ, q = i - e * kQ;
      cp_async16(Zb + e * kCT + 4 * q, Zn + e * L + base + 4 * q);
    }
  };
  auto stage_codes = [&](int p) {
    const long long base = static_cast<long long>(p) * kCT;
    for (int i = tid; i < ncov * kQ; i += kThreads) {
      const int cc = i / kQ, q = i - cc * kQ;
      cp_async16(gcs + cc * kCT + 4 * q, codes + cc * L + base + 4 * q);
    }
  };
  if (lo < hi) {
    stage_zn(lo);
    stage_codes(lo);
  }
  cp_async_commit();
  if constexpr (kMma) {
    if (ys_shared)
      for (int i = tid; i < K8 * S / 8; i += kThreads)
        reinterpret_cast<uint4*>(Ys)[i] = reinterpret_cast<const uint4*>(Ybg)[i];
    for (int i = tid; i < 32 * S; i += kThreads) reinterpret_cast<unsigned*>(Zp)[i] = 0u;
  } else if (ys_shared) {
    for (int i = tid; i < d * K8 / 4; i += kThreads)
      reinterpret_cast<float4*>(Ys)[i] = reinterpret_cast<const float4*>(Yp)[i];
  }
  const float* Yr = ys_shared ? Ys : Yp;
  const __nv_bfloat16* Ybr = ys_shared ? reinterpret_cast<const __nv_bfloat16*>(Ys) : Ybg;
  if (tid < ncov) offs[tid] = offsets[tid];
  float sv[KJ > 0 ? KJ : 1];  // v_chain's 2/sigma (legacy: sigma) of the lane's clusters
  if constexpr (KJ > 0) {
    const int lane = tid & 31;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int k = lane + 32 * j;
      sv[j] = k < K ? (kLegacy ? sigma[k] : 2.f / sigma[k]) : 0.f;
    }
  } else {
    for (int i = tid; i < K; i += kThreads) {
      sig[i] = sigma[i];
      i2s[i] = 2.f / sigma[i];
    }
  }
  __syncthreads();  // Y, the offsets and sigma are in
  const int cg = tid & 15;
  const bool vec = (K & 3) == 0;  // a cell's row of g starts on 16 bytes
  int held = -1;                  // the block whose table is in pens
  for (int p = lo; p < hi; ++p) {
    const long long base = static_cast<long long>(p) * kCT;
    cp_async_wait<0>();
    // the codes this thread copied, made global batch rows (-1 on pads)
    for (int i = tid; i < ncov * kQ; i += kThreads) {
      const int cc = i / kQ, o = offs[cc];
      int4* q = reinterpret_cast<int4*>(gcs + cc * kCT + 4 * (i - cc * kQ));
      int4 v = *q;
      v.x = v.x >= 0 ? v.x + o : -1;
      v.y = v.y >= 0 ? v.y + o : -1;
      v.z = v.z >= 0 ? v.z + o : -1;
      v.w = v.w >= 0 ? v.w + o : -1;
      *q = v;
    }
    const int blk = blkmap[base / T];
    if (blk != held) {
      const float* pb = pen + static_cast<long long>(blk) * K * B;
      for (int i = tid; i < K * B; i += kThreads) pens[i] = pb[i];
      held = blk;
    }
    __syncthreads();  // the piece's Zn, codes and table are in; the last piece's R is out
    if constexpr (kMma) {
      // the piece's rows in bf16 (zero past d), then K6's product
      for (int i = tid; i < d * kCT; i += kThreads) {
        const int e = i / kCT, t = i - e * kCT;
        Zp[t * S + e] = __float2bfloat16_rn(Zb[i]);
      }
      __syncthreads();
      piece_gram_bf16(Zp, Ybr, S, d16, K8, [&](int t, int k, float v) {
        if (k < K) {
          if constexpr (KJ > 0)
            Gs[t * K + k] = v;
          else
            Gs[k * kTP + t] = v;
        }
      });
    } else {
      for (int kg = tid >> 4; kg < K8 / 8; kg += kThreads / 16) {
        float acc[4][8];
        tile_gram(Yr + 8 * kg, K8, Zb + 4 * cg, d, acc);
        const int k0 = 8 * kg;
        if constexpr (KJ > 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* row = Gs + (4 * cg + i) * K + k0;
            if (vec) {
              *reinterpret_cast<float4*>(row) =
                  make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
              if (k0 + 4 < K)
                *reinterpret_cast<float4*>(row + 4) =
                    make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
            } else {
#pragma unroll
              for (int j = 0; j < 8; ++j)
                if (k0 + j < K) row[j] = acc[i][j];
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (k0 + j < K)
#pragma unroll
              for (int i = 0; i < 4; ++i) Gs[(k0 + j) * kTP + 4 * cg + i] = acc[i][j];
        }
      }
    }
    __syncthreads();  // g is in; Zb is free
    if (p + 1 < hi) stage_zn(p + 1);
    cp_async_commit();
    if constexpr (KJ > 0) {
      for (int g = w; g < kCT / 4; g += kWarps)
        v_chain<KJ, kLegacy>(Gs, pens, gcs, Lh, sv, 4 * g, K, B, ncov);
    } else {
      float unused0 = 0.f, unused1 = 0.f;
      assign_chain<false, kLegacy>(Gs, pens, nullptr, sig, i2s, gcs, K, B, ncov, unused0,
                                   unused1);
    }
    __syncthreads();  // R is in its table; the codes are free
    if (p + 1 < hi) stage_codes(p + 1);
    cp_async_commit();
    for (int i = tid; i < K * kQ; i += kThreads) {
      const int k = i / kQ, q = i - k * kQ;
      float4 r;
      if constexpr (KJ > 0) {
        r = *reinterpret_cast<const float4*>(Lh + k * kVLP + 4 * q);
      } else {
        const float* x = Gs + k * kTP + 4 * q;
        r = make_float4(x[0], x[1], x[2], x[3]);
      }
      store4(R + k * L + base + 4 * q, r);
    }
  }
  cp_async_wait<0>();
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// The instances of this translation unit (ROTATE_PART, above): K10's tile
// form and product form, K11's product form.
constexpr bool holds_k10(bool whole, bool mma) {
  return ROTATE_PART == (mma ? (whole ? 3 : 4) : (whole ? 2 : 1));
}
constexpr bool holds_k11(bool mma) { return ROTATE_PART == (mma ? 5 : 0); }

// K7's assign launch, with moments reading Z_orig as TZ on layout tiles
// that are (kWhole) or are not whole 64-cell pieces.
template <bool kMoments, bool kLegacy, typename TZ, bool kWhole>
int k7_launch(const float* G, const int* codes, const int* offsets, const float* pen,
              const float* logpen, const float* sigma, float* R, float* part, const void* Zo,
              const int* slot, float* mpart, float* mpiece, int* count, const int* sched,
              const int* blocks, int pos, int nb, long long L, int ncta, int NT, int cpt,
              int tw, int K, int d, int B, int ncov, int d1p, int smem_bytes,
              cudaStream_t st) {
  const void* kern =
      reinterpret_cast<const void*>(rot_assign_kernel<kMoments, kLegacy, TZ, kWhole>);
  int err = set_smem(kern, smem_bytes);
  if (err) return err;
  rot_assign_kernel<kMoments, kLegacy, TZ, kWhole><<<ncta, kThreads, smem_bytes, st>>>(
      G, codes, offsets, pen, logpen, sigma, R, part, static_cast<const TZ*>(Zo), slot, mpart,
      mpiece, count, sched, blocks, pos, nb, L, NT, cpt, tw, K, d, B, ncov, d1p);
  return static_cast<int>(cudaGetLastError());
}

using K7Launch = decltype(&k7_launch<false, false, float, true>);

// K7 with the moments reading Z_orig in the storage type (0 float, 1 bf16,
// 2 f16).
template <bool kLegacy, bool kWhole>
K7Launch k7_moments_form(int storage) {
  switch (storage) {
    case 0: return k7_launch<true, kLegacy, float, kWhole>;
    case 1: return k7_launch<true, kLegacy, __nv_bfloat16, kWhole>;
    case 2: return k7_launch<true, kLegacy, __half, kWhole>;
    default: return nullptr;
  }
}

// K10 with KJ cluster values a lane (1, 2, 4 or 8: K <= 256), Z as TZ, on
// layout tiles that are (kWhole) or are not whole 64-cell pieces, the
// correction's product in fp32 or (kMma) in the bf16 product form.
template <int KJ, bool kLegacy, typename TZ, bool kWhole, bool kMma>
int k10_launch(const float* G, const int* codes, const int* offsets, const float* pen,
               const int* blkmap, const float* sigma, const void* Wj, const int* order,
               const int* tj, const void* Zo, void* Zc, long long L, int n, int span, int T,
               int tw, int spt, int trash, int K, int d, int dp, int B, int ncov, int ng,
               int SW, int d16, int grid, int smem_bytes, cudaStream_t st) {
  const void* kern =
      reinterpret_cast<const void*>(virtual_correction_kernel<KJ, kLegacy, TZ, kWhole, kMma>);
  int err = set_smem(kern, smem_bytes);
  if (err) return err;
  virtual_correction_kernel<KJ, kLegacy, TZ, kWhole, kMma><<<grid, kVThreads, smem_bytes, st>>>(
      G, codes, offsets, pen, blkmap, sigma, kMma ? nullptr : static_cast<const float*>(Wj),
      kMma ? static_cast<const __nv_bfloat16*>(Wj) : nullptr, order, tj,
      static_cast<const TZ*>(Zo), static_cast<TZ*>(Zc), L, n, span, T, tw, spt, trash, K, d, dp,
      B, ncov, ng, SW, d16);
  return static_cast<int>(cudaGetLastError());
}

using K10Launch = decltype(&k10_launch<1, false, float, true, false>);

// The K10 instance for K and the op order.
template <typename TZ, bool kWhole, bool kMma>
K10Launch k10_pick_form(int K, int legacy) {
  return legacy ? (K <= 32    ? k10_launch<1, true, TZ, kWhole, kMma>
                   : K <= 64  ? k10_launch<2, true, TZ, kWhole, kMma>
                   : K <= 128 ? k10_launch<4, true, TZ, kWhole, kMma>
                              : k10_launch<8, true, TZ, kWhole, kMma>)
                : (K <= 32    ? k10_launch<1, false, TZ, kWhole, kMma>
                   : K <= 64  ? k10_launch<2, false, TZ, kWhole, kMma>
                   : K <= 128 ? k10_launch<4, false, TZ, kWhole, kMma>
                              : k10_launch<8, false, TZ, kWhole, kMma>);
}

// The K10 instance for the storage type (0 float, 1 bf16, 2 f16) where this
// library holds the tile and product form, else null. The product form
// takes 2-byte storage only: a float32 engine takes no bf16 product.
template <bool kWhole, bool kMma>
K10Launch k10_form(int K, int legacy, int storage) {
  if constexpr (holds_k10(kWhole, kMma)) {
    switch (storage) {
      case 0:
        if constexpr (!kMma) return k10_pick_form<float, kWhole, kMma>(K, legacy);
        break;
      case 1: return k10_pick_form<__nv_bfloat16, kWhole, kMma>(K, legacy);
      case 2: return k10_pick_form<__half, kWhole, kMma>(K, legacy);
    }
  }
  return nullptr;
}

// K11 with KJ cluster values a lane (v_chain), or assign_chain (KJ == 0),
// R written as TR, g in fp32 products or (kMma) the bf16 product form.
template <int KJ, bool kLegacy, typename TR, bool kMma>
int k11_launch(const void* Y, const float* Zn, const int* codes, const int* offsets,
               const float* pen, const int* blkmap, const float* sigma, void* R, long long L,
               int T, int K, int d, int B, int ncov, int K8, int ys_shared, int S, int d16,
               int grid, int smem_bytes, cudaStream_t st) {
  const void* kern = reinterpret_cast<const void*>(materialize_r_kernel<KJ, kLegacy, TR, kMma>);
  int err = set_smem(kern, smem_bytes);
  if (err) return err;
  materialize_r_kernel<KJ, kLegacy, TR, kMma><<<grid, kThreads, smem_bytes, st>>>(
      kMma ? nullptr : static_cast<const float*>(Y),
      kMma ? static_cast<const __nv_bfloat16*>(Y) : nullptr, Zn, codes, offsets, pen, blkmap,
      sigma, static_cast<TR*>(R), L, T, K, d, B, ncov, K8, ys_shared, S, d16);
  return static_cast<int>(cudaGetLastError());
}

using K11Launch = decltype(&k11_launch<0, false, float, false>);

// The K11 instance for the chain form kj and the op order.
template <typename TR, bool kMma>
K11Launch k11_pick(int kj, int legacy) {
  switch (kj) {
    case 1: return legacy ? k11_launch<1, true, TR, kMma> : k11_launch<1, false, TR, kMma>;
    case 2: return legacy ? k11_launch<2, true, TR, kMma> : k11_launch<2, false, TR, kMma>;
    case 4: return legacy ? k11_launch<4, true, TR, kMma> : k11_launch<4, false, TR, kMma>;
    case 8: return legacy ? k11_launch<8, true, TR, kMma> : k11_launch<8, false, TR, kMma>;
    default: return legacy ? k11_launch<0, true, TR, kMma> : k11_launch<0, false, TR, kMma>;
  }
}

// The K11 instance for R's storage type (0 float, 1 bf16, 2 f16) where this
// library holds the product form, else null.
template <bool kMma>
K11Launch k11_form(int kj, int legacy, int storage) {
  if constexpr (holds_k11(kMma)) {
    switch (storage) {
      case 0: return k11_pick<float, kMma>(kj, legacy);
      case 1: return k11_pick<__nv_bfloat16, kMma>(kj, legacy);
      case 2: return k11_pick<__half, kMma>(kj, legacy);
    }
  }
  return nullptr;
}

// K6's assign launch, Z as TZ, g in fp32 products or (kMma) the bf16
// product form.
template <typename TZ, bool kMma>
int k6_assign_launch(const float* Yt, const void* Yb, const void* Z, const int* codes,
                     const int* offsets, const float* sigma, float* Zn, float* G, float* part,
                     int* count, long long L, int K, int d, int B, int ncov, int K8, int nh,
                     int n_chunk, int S, int d16, int grid, int smem_bytes, cudaStream_t st) {
  const void* kern = reinterpret_cast<const void*>(reassign_assign_kernel<TZ, kMma>);
  int err = set_smem(kern, smem_bytes);
  if (err) return err;
  reassign_assign_kernel<TZ, kMma><<<grid, kThreads, smem_bytes, st>>>(
      Yt, static_cast<const __nv_bfloat16*>(Yb), static_cast<const TZ*>(Z), codes, offsets,
      sigma, Zn, G, part, count, L, K, d, B, ncov, K8, nh, n_chunk, S, d16);
  return static_cast<int>(cudaGetLastError());
}

#if ROTATE_PART == 0
// K6's assign kernel and its launch for the storage type (0 float, 1 bf16,
// 2 f16) and the product form.
template <typename TZ>
const void* k6_kernel(int mma) {
  return mma ? reinterpret_cast<const void*>(reassign_assign_kernel<TZ, true>)
             : reinterpret_cast<const void*>(reassign_assign_kernel<TZ, false>);
}

const void* k6_pick_kernel(int storage, int mma) {
  switch (storage) {
    case 0: return k6_kernel<float>(mma);
    case 1: return k6_kernel<__nv_bfloat16>(mma);
    case 2: return k6_kernel<__half>(mma);
    default: return nullptr;
  }
}

using K6Launch = decltype(&k6_assign_launch<float, false>);

template <typename TZ>
K6Launch k6_launch_of(int mma) {
  return mma ? k6_assign_launch<TZ, true> : k6_assign_launch<TZ, false>;
}

K6Launch k6_pick_launch(int storage, int mma) {
  switch (storage) {
    case 0: return k6_launch_of<float>(mma);
    case 1: return k6_launch_of<__nv_bfloat16>(mma);
    case 2: return k6_launch_of<__half>(mma);
    default: return nullptr;
  }
}
#endif  // ROTATE_PART == 0

}  // namespace

extern "C" {

#if ROTATE_PART <= 1
// K7 assign launch for the block at position pos of the round's order
// (sched: the round's row of the schedule table, [rotation, block order];
// blocks: (2, nb) int32, the tiles of each block, then its first virtual
// tile), max_ntile * cpt CTAs, max_ntile the largest block's tiles (the
// CTAs past the block's return at once); Zo == nullptr: no moments;
// legacy != 0: the legacy op order; storage: the moments' Z_orig (0 float,
// 1 bf16, 2 f16). Part 0 holds the whole-piece forms, part 1 the moments
// on layout tiles that are not whole pieces.
int k7_assign(const void* G, const void* codes,
              const void* offsets, const void* pen, const void* logpen,
              const void* sigma, void* R, void* part, const void* Zo, const void* slot,
              void* mpart, void* mpiece, void* count, const void* sched, const void* blocks,
              long long L, int pos, int nb, int max_ntile, int NT, int cpt, int tw, int K,
              int d, int B, int ncov, int d1p, int legacy, int storage, int smem_bytes,
              void* stream) {
  K7Launch launch;
#if ROTATE_PART == 1
  if (Zo == nullptr || tw % kCT == 0) return static_cast<int>(cudaErrorInvalidValue);
  launch = legacy ? k7_moments_form<true, false>(storage) : k7_moments_form<false, false>(storage);
#else
  // without moments the tile form does not matter; with them tw must be a
  // multiple of 64 here (part 1 holds the other form)
  if (Zo == nullptr)
    launch = legacy ? k7_launch<false, true, float, true> : k7_launch<false, false, float, true>;
  else if (tw % kCT != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  else
    launch = legacy ? k7_moments_form<true, true>(storage) : k7_moments_form<false, true>(storage);
#endif
  if (launch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(static_cast<const float*>(G), static_cast<const int*>(codes),
                static_cast<const int*>(offsets), static_cast<const float*>(pen),
                static_cast<const float*>(logpen), static_cast<const float*>(sigma),
                static_cast<float*>(R), static_cast<float*>(part), Zo,
                static_cast<const int*>(slot), static_cast<float*>(mpart),
                static_cast<float*>(mpiece), static_cast<int*>(count),
                static_cast<const int*>(sched), static_cast<const int*>(blocks), pos, nb, L,
                max_ntile * cpt, NT, cpt, tw, K, d, B, ncov, d1p, smem_bytes,
                static_cast<cudaStream_t>(stream));
}
#endif

#if ROTATE_PART == 0
// K7's commit after the block at position pos of the round's order (pos
// < 0: the round's first commit); max_ntile: the largest block's tiles,
// which sizes the shared memory.
int k7_commit(const void* part, const void* sched, const void* blocks, int pos, int nb,
              int max_ntile, int cpt, int NT, void* tO_new, const void* tO_old,
              const void* E_in, const void* O_in, void* E, void* O,
              const void* Pr, const void* theta, void* pen, void* logpen,
              void* pen_out, int emit_pen, void* acc, int K, int B, int b0, void* stream) {
  const int smem_bytes = (2 * B + 2 * max_ntile) * static_cast<int>(sizeof(float));
  int err = set_smem(reinterpret_cast<const void*>(rot_commit_kernel), smem_bytes);
  if (err) return err;
  rot_commit_kernel<<<K, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<const int*>(sched),
      static_cast<const int*>(blocks), pos, nb, cpt, NT,
      static_cast<float*>(tO_new), static_cast<const float*>(tO_old),
      static_cast<const float*>(E_in), static_cast<const float*>(O_in),
      static_cast<float*>(E), static_cast<float*>(O),
      static_cast<const float*>(Pr), static_cast<const float*>(theta),
      static_cast<float*>(pen), static_cast<float*>(logpen),
      static_cast<float*>(pen_out), emit_pen, static_cast<float*>(acc), K, B, b0);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of K6's assign kernel (storage: Z's type, 0 float, 1 bf16, 2 f16;
// mma: the bf16 product form) an SM holds with smem_bytes each; < 0 is
// minus a CUDA error.
int k6_occupancy(int smem_bytes, int storage, int mma) {
  const void* kern = k6_pick_kernel(storage, mma);
  if (kern == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem(kern, smem_bytes);
  if (err) return -err;
  int n = 0;
  err = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads, smem_bytes));
  return err ? -err : n;
}

// K6: the assign launch (grid persistent CTAs over the L/64 pieces, nh
// cell splits of the design sums; storage: Z's type; mma != 0: the bf16
// product form, Yb the (K8 x S) bf16 Y^T, d16 its depth), then the reduce
// over (tile, 256-column chunk), n_chunk = ceil(K*B / 256) chunks.
int k6_reassign(const void* Yt, const void* Yb, const void* Z, const void* codes,
                const void* offsets, const void* sigma, const void* Pr,
                void* Zn, void* G, void* part, void* tO, void* O, void* E, void* count,
                long long L, int NT, int K, int d, int B, int ncov, int b0, int K8, int nh,
                int grid, int n_chunk, int storage, int mma, int S, int d16, int smem_bytes,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  K6Launch launch = k6_pick_launch(storage, mma);
  if (launch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int err = launch(static_cast<const float*>(Yt), Yb, Z, static_cast<const int*>(codes),
                   static_cast<const int*>(offsets), static_cast<const float*>(sigma),
                   static_cast<float*>(Zn), static_cast<float*>(G), static_cast<float*>(part),
                   static_cast<int*>(count), L, K, d, B, ncov, K8, nh, n_chunk, S, d16, grid,
                   smem_bytes, st);
  if (err) return err;
  const int npc = static_cast<int>(L / kCT);
  reassign_reduce_kernel<<<dim3(NT, n_chunk), kThreads, 0, st>>>(
      static_cast<const float*>(part), NT, npc / NT, static_cast<float*>(tO),
      static_cast<float*>(O), static_cast<float*>(E), static_cast<const float*>(Pr),
      static_cast<int*>(count), K, B, b0);
  return static_cast<int>(cudaGetLastError());
}
#endif  // ROTATE_PART == 0

#if ROTATE_PART >= 1 && ROTATE_PART <= 4
// K10 over the plan's order (n layout tiles of tw cells, each at most spt
// 64-cell steps) in grid equal ranges of at most span tiles; legacy != 0:
// the legacy op order; storage: Z_orig's and Z_corr's type (0 float, 1
// bf16, 2 f16); mma != 0: the bf16 product form, Wj the (n_joint + 1, d16,
// SW) bf16 betas (else (n_joint + 1, d, K) float). Each part holds one tile
// form and one product form (holds_k10); another returns an error.
int k10_virtual_correction(const void* G, const void* codes, const void* offsets,
                           const void* pen, const void* blkmap, const void* sigma,
                           const void* Wj, const void* order, const void* tj, const void* Zo,
                           void* Zc, long long L, int n, int span, int T, int tw, int spt,
                           int trash, int K, int d, int dp, int B, int ncov, int ng, int legacy,
                           int storage, int mma, int SW, int d16, int grid, int smem_bytes,
                           void* stream) {
  const bool whole = tw % kVCells == 0;
  const K10Launch launch = whole ? (mma ? k10_form<true, true>(K, legacy, storage)
                                        : k10_form<true, false>(K, legacy, storage))
                                 : (mma ? k10_form<false, true>(K, legacy, storage)
                                        : k10_form<false, false>(K, legacy, storage));
  if (launch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(static_cast<const float*>(G), static_cast<const int*>(codes),
                static_cast<const int*>(offsets), static_cast<const float*>(pen),
                static_cast<const int*>(blkmap), static_cast<const float*>(sigma), Wj,
                static_cast<const int*>(order), static_cast<const int*>(tj), Zo, Zc, L, n, span,
                T, tw, spt, trash, K, d, dp, B, ncov, ng, SW, d16, grid, smem_bytes,
                static_cast<cudaStream_t>(stream));
}
#endif

#if ROTATE_PART == 0 || ROTATE_PART == 5
// K11 over grid persistent CTAs; kj: v_chain's cluster values a lane (1,
// 2, 4, 8), 0 for assign_chain; ys_shared: Y staged into shared memory;
// legacy != 0: the legacy op order; storage: R's type (0 float, 1 bf16, 2
// f16); mma != 0: the bf16 product form (part 5), Y the (K8 x S) bf16 Y^T
// and d16 its depth, else (part 0) Y the (d x K8) float centroids.
int k11_materialize_r(const void* Y, const void* Zn, const void* codes,
                      const void* offsets, const void* pen, const void* blkmap,
                      const void* sigma, void* R, long long L, int T, int K, int d, int B,
                      int ncov, int K8, int kj, int ys_shared, int legacy, int storage, int mma,
                      int S, int d16, int grid, int smem_bytes, void* stream) {
  const K11Launch launch =
      mma ? k11_form<true>(kj, legacy, storage) : k11_form<false>(kj, legacy, storage);
  if (launch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(Y, static_cast<const float*>(Zn), static_cast<const int*>(codes),
                static_cast<const int*>(offsets), static_cast<const float*>(pen),
                static_cast<const int*>(blkmap), static_cast<const float*>(sigma), R, L, T, K,
                d, B, ncov, K8, ys_shared, S, d16, grid, smem_bytes,
                static_cast<cudaStream_t>(stream));
}
#endif

}  // extern "C"
