// K2 and K3: the fused R-gather-free permute phase, hand-written for Hopper
// (sm_90a). The reference-exact schedule (update_R, src/harmony.cpp:269-342)
// with a fresh permutation every round, without reading or writing R during
// the rounds: a cell's current assignment is a function of (Y, its Z
// column, the penalty table its block was assigned with), so the phase
// carries the per-block penalty tables and each cell's last block id and
// recomputes the old assignments instead.
//
// K2 replaces harmony_tpu/ops/pallas_estep.py _permute_round_kernel (:303),
// reached through pallas_permute_phase (:567, pallas_call :662).
// K3 replaces _permute_materialize_kernel (:487, pallas_call :898),
// including its msub moment fusion.
//
// Tables. pen is (nbp*B, K) in device memory, nbp = nb + 1: row blk*B + b
// holds the K penalties ((2E+1)/(O+E+1))^theta of batch row b that block
// blk was assigned with, and rows nb*B.. are ones (the assignments made
// before the phase). A cell's K penalties are one contiguous row, and the
// tables (84 KB at B = 10, nb = 20, K = 100) stay in L2. The TPU kernel's
// select chain, one-hot matmul and chunking were layout devices for this
// same lookup.
//
// The phase's distances. Y and Z do not change within a clustering phase
// (the property pallas_estep.py:350-353 states), so a cell's distances
// dist = 2(1 - Y^T z) are the same in every round. The TPU kernel
// recomputes them in every pass to keep a (K, N) table out of HBM; on this
// card that table is G (N, K), 200 MB at N = 500k, K = 100, and a pass
// reads it in 0.06 ms. So K2 starts a phase with one head launch
// (head_kernel) that writes G, cell-major (a cell's K distances are one
// contiguous row), and neither of its cell passes computes Y^T Z or stages
// Y^T or Z: each warp reads its cell's row of G through the permutation.
// The head computes with tile_dist (a fixed fmaf sequence over e =
// 0..d-1, whatever the tile), and G also feeds K3, so the rounds and K3
// read the same bits.
//
// One chain (chain) serves the removal pass, the assign pass and K3: a
// warp per cell, lanes over clusters, the cell's K distances in registers
// (up to 8 a lane, so K <= 256; past that chain_wide, the same operations
// on shared memory), exp(-dist / sigma) once per (cluster, cell), the softmax over K, times the penalty summed over covariates, the
// guarded renormalise. Its products are __fmul_rn, so no kernel fuses them
// differently: the removal subtracts exactly the assignments the last
// round added, and K3's R equals the last round's R bit for bit per cell
// (the property of pallas_estep.py:350-353, 502-504).
//
// K2, one phase: the head, then per round, all host-ordered launches on
// one stream with no PyTorch op and no host copy between them (2*nb + 2
// launches a round):
//   (0) round_cells_kernel<false> over all the round's cells (the removal
//       depends only on last round's tables and block ids): per CTA, a
//       span of one block's positions; it reads each cell's id through the
//       permutation, its codes and previous block id, stores the cell's new
//       block id in place, and writes partial row sums and batch sums of
//       the recomputed old assignments. One wave of CTAs that each loop
//       over ~1,000 cells: a CTA per few dozen cells would write 20x the
//       partials for the commits to read.
//   (1) commit_kernel: no add; remove block 0; store table row 0.
//   (2) per block i: round_cells_kernel<true> (the assign pass, against
//       table row i; no R; k-means error and entropy partials), its CTAs
//       sized so that the block's cells run as one even wave on the card,
//       then commit_kernel: fold the block's partials in a fixed order,
//       remove block i+1's old statistics (its removal partials, in a
//       fixed order), compute the penalty and store it as table row i+1.
// In a cell pass each warp takes its CTA's cells in turn, with the rows of
// G of its next kRing - 1 cells in flight into a ring in shared memory
// (cp.async, each lane copying the entries it will read) and the next
// cell's penalties in registers while the current cell's chain runs: a
// row is 400 bytes at a random place, so a pass is bound by how many are
// in flight. Each lane adds its r to its warp's own row sums (registers)
// and, where shared memory holds a (B x K) table a warp with two CTAs an
// SM (B <= 26 at K = 100), its own batch sums, so every thread works and
// no two share a sum; past that (or past K = 256) the warps share one
// table, filled step by step in warp order after a barrier. The warps'
// sums go to the CTA's partials row in warp order. The
// swap of the two tables stays between rounds in the wrapper.
// Shared with K1 (estep_round.cu, copied because each source builds into a
// library of its own): the commit's fixed-order fold.
//
// K3: materialize_kernel writes R (K, Np) in natural order, pad cells 0,
// from the phase's G: the head computed every cell's distances with the
// loop the rounds read, so K3 forms no product and its R is the last
// round's R bit for bit. Bound on this card at N = 500k, d = 50, K = 100:
// of the function, the distance product and, with moments, 2*K*(d+1)*N =
// 5.1 GFLOP more (0.15 ms at 67 TFLOP/s; 0.09 ms without); of this design,
// G read and R written, 0.4 GB (0.12 ms at 3.35 TB/s), plus Z_orig with
// moments. What bounds it in practice is the chain's latency (two warp
// sums and three divisions a cell) and, with moments, the SM's
// shared-memory load path (a 16-byte load costs a warp four cycles
// whatever its lanes share, so what counts is the floats a thread loads
// per FMA). One CTA of 512 threads a SM walks 64-cell steps (32 or 16
// where shared memory is short) in a pipeline with one barrier a step:
// after step s's barrier it issues step s+1's copies (rows of G, one
// contiguous span, and Z_orig, 16-byte cp.async; codes and block ids),
// loads the penalties of step s's cells, stores step s-1's R and runs its
// moment tail, then runs step s's chain, a warp four cells at once
// (chain_n) so their latencies overlap, writing r cluster-major (the
// coalesced R store) and cell-major (the moments). The moment tail: each
// thread owns one 4 x 8 (cluster x dim) register tile for the CTA's whole
// run, and per block of four cells one float4 of R a cell and one of
// [Z_orig; 1] a dim (dim-major as copied, so no transposition) for 128
// FMAs, three float4 loads per 32 FMAs; the (K/4) x ceil((d+1)/8) tiles
// take one pass (512 threads cover K <= 128
// at d <= 100; moments_fit refuses past 512 tiles). Where the tiles leave
// threads idle up to four groups of threads split the cells (two at the
// main shape's 175 tiles), each writing its own partial row. With
// moments the layout tiles, joint by joint, are cut into equal ranges,
// one a CTA of one wave, and each range where its joint changes, so no
// SM waits on a second wave; each segment writes a
// partial row a cell group, summed per joint in row order by a second
// launch (tiled.cu's sum_joint_rows). No float atomics anywhere.
//
// Bounds of K2 on this card at N = 500k, d = 50, K = 100 (fp32 outside the
// tensor cores, 67 TFLOP/s; 3.35 TB/s): a round of the function needs one
// distance product, 2*K*d*N = 5 GFLOP, 0.075 ms, against 0.1 GB of Z,
// codes, block ids and the permutation (0.03 ms): operations-bound. This
// design does the product once a phase (the head) and moves G instead:
// each cell pass reads it once, 200 MB, 0.06 ms.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 8;      // cluster rows per thread in the product
constexpr int kSlices = 8;  // commit: partial rows summed per warp slice
constexpr int kK3Threads = 512;  // K3: threads of a CTA, one a SM
constexpr int kK3Warps = kK3Threads / 32;
constexpr int kMR = 4;      // K3 moments: clusters of a thread's register tile
constexpr int kME = 8;      // K3 moments: dims of a thread's register tile
constexpr int kCPW = 4;     // K3: most cells a warp takes in a step (T <= 64 cells, 16 warps)
constexpr int kChunk = 256; // cell passes: cells whose ids and codes a CTA stages at once
constexpr int kRing = 4;    // cell passes: rows of G a warp has in flight, plus the one in use

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
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

// dist = 2 (1 - Y^T z) for the T cells staged in Zs (row stride TP) into Ls
// (row stride TP): lane -> cells (lane, lane + 32), warp -> 8 cluster rows.
// The head computes with it; the rounds and K3 read what it wrote.
__device__ __forceinline__ void tile_dist(const float* Ys, const float* Zs, float* Ls,
                                          int K, int d, int T, int TP) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bool two = T > 32;
  for (int kc = w * kKC; kc < K; kc += kWarps * kKC) {
    float a0[kKC], a1[kKC];
#pragma unroll
    for (int j = 0; j < kKC; ++j) a0[j] = a1[j] = 0.f;
    for (int e = 0; e < d; ++e) {
      const float z0 = Zs[e * TP + lane];
      const float z1 = two ? Zs[e * TP + lane + 32] : 0.f;
#pragma unroll
      for (int j = 0; j < kKC; ++j) {
        const float y = Ys[min(kc + j, K - 1) * d + e];
        a0[j] = fmaf(y, z0, a0[j]);
        a1[j] = fmaf(y, z1, a1[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kKC; ++j) {
      const int k = kc + j;
      if (k < K) {
        Ls[k * TP + lane] = 2.f * (1.f - a0[j]);
        if (two) Ls[k * TP + lane + 32] = 2.f * (1.f - a1[j]);
      }
    }
  }
}

// One warp, lanes over clusters (k = lane + 32 j, j < KJ): the assignment
// of a cell from its distances dv and its penalties pc (the table rows of
// its block summed over covariates), r = L1(L1(exp(-dist / sigma)) * pc),
// both sums guarded against zero, each normalisation a multiplication by
// the sum's reciprocal. Each exp is taken once. Entries with k >= K are
// left undefined.
template <int KJ>
__device__ __forceinline__ void chain(const float (&dv)[KJ], const float (&pc)[KJ],
                                      const float (&sg)[KJ], int K, float (&r)[KJ]) {
  const int lane = threadIdx.x & 31;
  float s1 = 0.f;
#pragma unroll
  for (int j = 0; j < KJ; ++j)
    if (lane + 32 * j < K) {
      r[j] = expf(-dv[j] / sg[j]);
      s1 += r[j];
    }
  s1 = warp_sum(s1);
  const float i1 = 1.f / (s1 == 0.f ? 1.f : s1);
  float s2 = 0.f;
#pragma unroll
  for (int j = 0; j < KJ; ++j)
    if (lane + 32 * j < K) {
      r[j] = __fmul_rn(__fmul_rn(r[j], i1), pc[j]);
      s2 += r[j];
    }
  s2 = warp_sum(s2);
  const float i2 = 1.f / (s2 == 0.f ? 1.f : s2);
#pragma unroll
  for (int j = 0; j < KJ; ++j)
    if (lane + 32 * j < K) r[j] = __fmul_rn(r[j], i2);
}

// chain for NC cells at once, their operations interleaved so that their
// latencies overlap: v holds each cell's distances in and its r out, p its
// penalties. Each cell's operations are chain's in chain's order, so each
// gets chain's bits.
template <int NC, int KJ>
__device__ __forceinline__ void chain_n(float (&v)[NC][KJ], const float (&p)[NC][KJ],
                                        const float (&sg)[KJ], int K) {
  const int lane = threadIdx.x & 31;
  float s[NC], inv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) s[c] = 0.f;
#pragma unroll
  for (int j = 0; j < KJ; ++j)
    if (lane + 32 * j < K)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        v[c][j] = expf(-v[c][j] / sg[j]);
        s[c] += v[c][j];
      }
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int c = 0; c < NC; ++c) s[c] += __shfl_xor_sync(0xffffffffu, s[c], o);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    inv[c] = 1.f / (s[c] == 0.f ? 1.f : s[c]);
    s[c] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < KJ; ++j)
    if (lane + 32 * j < K)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        v[c][j] = __fmul_rn(__fmul_rn(v[c][j], inv[c]), p[c][j]);
        s[c] += v[c][j];
      }
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int c = 0; c < NC; ++c) s[c] += __shfl_xor_sync(0xffffffffu, s[c], o);
#pragma unroll
  for (int c = 0; c < NC; ++c) inv[c] = 1.f / (s[c] == 0.f ? 1.f : s[c]);
#pragma unroll
  for (int j = 0; j < KJ; ++j)
    if (lane + 32 * j < K)
#pragma unroll
      for (int c = 0; c < NC; ++c) v[c][j] = __fmul_rn(v[c][j], inv[c]);
}

// chain for any K (the one for K > 256): a cell's
// distances at dv[k * ds], its assignments out at r[k * rs] (r may be dv),
// its penalties summed from rows as in penalties(), sigma from device
// memory. Each lane takes k = lane + 32 j in chain's order with chain's
// operations, so the passes that share it give the same bits.
__device__ __forceinline__ void chain_wide(const float* dv, int ds, float* r, int rs,
                                           const float* rows, const int* gcs, int stride,
                                           int ncov, const float* __restrict__ sigma, int K) {
  const int lane = threadIdx.x & 31;
  float s1 = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float e = expf(-dv[k * ds] / sigma[k]);
    r[k * rs] = e;
    s1 += e;
  }
  s1 = warp_sum(s1);
  const float i1 = 1.f / (s1 == 0.f ? 1.f : s1);
  float s2 = 0.f;
  for (int k = lane; k < K; k += 32) {
    float pc = rows[static_cast<long long>(gcs[0]) * K + k];
    for (int c = 1; c < ncov; ++c) pc += rows[static_cast<long long>(gcs[c * stride]) * K + k];
    const float v = __fmul_rn(__fmul_rn(r[k * rs], i1), pc);
    r[k * rs] = v;
    s2 += v;
  }
  s2 = warp_sum(s2);
  const float i2 = 1.f / (s2 == 0.f ? 1.f : s2);
  for (int k = lane; k < K; k += 32) r[k * rs] = __fmul_rn(r[k * rs], i2);
}

// pc[j] of a cell: the sum over covariates c of its block's table row
// entry, rows[gc(c)] at cluster lane + 32 j (gc(c) = gcs[c * stride]);
// rows lie in shared or device memory.
template <int KJ>
__device__ __forceinline__ void penalties(const float* rows, const int* gcs, int stride,
                                          int ncov, int K, float (&pc)[KJ]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int k = lane + 32 * j;
    if (k < K) {
      float v = rows[static_cast<long long>(gcs[0]) * K + k];
      for (int c = 1; c < ncov; ++c) v += rows[static_cast<long long>(gcs[c * stride]) * K + k];
      pc[j] = v;
    }
  }
}

// A lane's entries k = lane + 32 j of cell n's row of G into the same
// entries of dst, in flight (cp.async): each lane later reads only what
// it copied, so its own wait suffices.
template <int KJ>
__device__ __forceinline__ void fetch_row(const float* __restrict__ G, int n, int K,
                                          float* dst) {
  const float* row = G + static_cast<long long>(n) * K;
  const int lane = threadIdx.x & 31;
  if constexpr (KJ > 0) {
#pragma unroll
    for (int j = 0; j < KJ; ++j)
      if (lane + 32 * j < K) cp_async4(dst + lane + 32 * j, row + lane + 32 * j);
  } else {
    for (int k = lane; k < K; k += 32) cp_async4(dst + k, row + k);
  }
}

// The head: G[n, :] = 2 (1 - Y^T z_n) for the N cells, T cells a tile; a
// CTA stages Y^T once and walks tiles blockIdx.x, blockIdx.x + gridDim.x,
// ...; each tile's rows are written coalesced, one cell a contiguous row.
__global__ void __launch_bounds__(kThreads) head_kernel(
    const float* __restrict__ Yt,  // (K, d)
    const float* __restrict__ Z,   // (d, Np) L2-normalised
    float* __restrict__ G,         // (N, K) out
    long long N, long long Np, int K, int d, int T) {
  extern __shared__ float smem[];
  const int TP = T + 1;
  float* Ys = smem;        // K*d
  float* Zs = Ys + K * d;  // d*TP
  float* Ls = Zs + d * TP; // K*TP
  const int tid = threadIdx.x;
  for (int i = tid; i < K * d; i += kThreads) Ys[i] = Yt[i];
  for (long long n0 = static_cast<long long>(blockIdx.x) * T; n0 < N;
       n0 += static_cast<long long>(gridDim.x) * T) {
    const int nv = static_cast<int>(min(static_cast<long long>(T), N - n0));
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < d * T; i += kThreads) {
      const int e = i / T, t = i - e * T;
      Zs[e * TP + t] = t < nv ? Z[e * Np + n0 + t] : 0.f;
    }
    __syncthreads();
    tile_dist(Ys, Zs, Ls, K, d, T, TP);
    __syncthreads();
    for (int i = tid; i < nv * K; i += kThreads) {
      const int t = i / K, k = i - t * K;
      G[(n0 + t) * K + k] = Ls[k * TP + t];
    }
  }
}

// K2's cell passes over the round's positions (block i holds positions
// [i*cpb, i*cpb + size_i) of perm). CTA c = cta0 + blockIdx.x covers the
// positions [q0, q0 + span) of block min(c / cta_per, nb - 1), in chunks of
// kChunk: the CTA stages the chunk's cell ids, codes and (removal) previous
// block ids, storing each cell's new block id in place; then warp w takes
// the chunk's cells w, w + nw, ... (its i-th cell in step i), with the next
// kRing - 1 cells' rows of G coming into its ring in shared memory
// (cp.async) and, with KJ > 0, the next cell's penalties loading while the
// current cell's chain runs. The removal (kAssign false) looks each cell up
// in its previous block's table rows (L2); the assign pass in block i's
// rows, staged in shared memory where each warp has a table of its own.
// Batch sums: without kShared each warp adds its cells' r into its own
// (B x K) table; with kShared (the tables of all warps do not fit, or K is
// past the register chain, KJ = 0) the warps write step i's r into a
// double-buffered row each, and after a barrier thread k adds the step's
// rows into the CTA's one table at cluster k, in warp order. Either way
// the sums have one order, with no atomics. Partials row of a CTA, at
// blockIdx.x: [row sums K | batch sums K*B | k-means error | entropy].
template <bool kAssign, int KJ, bool kShared>
__global__ void __launch_bounds__(kThreads) round_cells_kernel(
    const float* __restrict__ G,        // (N, K) the phase's distances
    const long long* __restrict__ perm, // (N,) this round's permutation
    const int* __restrict__ gn,         // (Np, ncov) global batch rows
    int* __restrict__ blk,              // (Np,) block of each cell's last assignment
    const float* __restrict__ pen,      // (nbp*B, K) tables
    const float* __restrict__ sigma,    // (K,)
    float* __restrict__ part,           // (gridDim.x, P) out
    int cpb, int last, int nb, int cta_per, int span, int cta0, int K, int B, int ncov) {
  static_assert(KJ > 0 || kShared, "chain_wide (KJ = 0) writes r into the step's rows");
  constexpr int KR = KJ > 0 ? KJ : 1;  // register arrays of the KJ > 0 chain
  extern __shared__ float smem[];
  const int nw = blockDim.x >> 5;
  const int nt = kShared ? 1 : nw;  // batch-sum tables
  const int P = K + K * B + 2;
  float* Ob = smem;                       // nt*B*K: table q's batch sums at (q*B + b)*K + k
  float* rsw = Ob + nt * B * K;           // nw*K: the warps' row sums
  float* red = rsw + nw * K;              // 2*nw
  float* pen_s = red + 2 * nw;            // B*K without kShared: the assign pass's rows
  float* ring = pen_s + (kShared ? 0 : B * K);  // nw*kRing*K: each warp's rows of G
  float* rrow = ring + nw * kRing * K;    // 2*nw*K with kShared: step i's r at (i&1)*nw + w
  int* ids = reinterpret_cast<int*>(rrow + (kShared ? 2 * nw * K : 0));  // kChunk cell ids
  int* gcs = ids + kChunk;                          // ncov*kChunk global batch rows
  int* bks = gcs + ncov * kChunk;                   // kChunk previous block ids

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int c = cta0 + blockIdx.x;
  const int bi = cta_per ? min(c / cta_per, nb - 1) : nb - 1;
  const int size = bi < nb - 1 ? cpb : last;
  const int q0 = (c - bi * cta_per) * span;
  const int q1 = min(q0 + span, size);
  const long long cell0 = static_cast<long long>(bi) * cpb;

  for (int i = tid; i < nt * B * K; i += blockDim.x) Ob[i] = 0.f;
  if (KJ == 0)
    for (int i = tid; i < nw * K; i += blockDim.x) rsw[i] = 0.f;
  if (kAssign && !kShared)
    for (int i = tid; i < B * K; i += blockDim.x)
      pen_s[i] = pen[static_cast<long long>(bi) * B * K + i];
  float sg[KR], rs[KR];
#pragma unroll
  for (int j = 0; j < KR; ++j) {
    const int k = lane + 32 * j;
    sg[j] = k < K ? sigma[k] : 1.f;
    rs[j] = 0.f;
  }
  float* Om = Ob + (kShared ? 0 : w * B * K);
  float* myring = ring + w * kRing * K;
  float kerr = 0.f, ent = 0.f;
  for (int s0 = q0; s0 < q1; s0 += kChunk) {
    const int nv = min(kChunk, q1 - s0);
    __syncthreads();  // the previous chunk's readers are done
    for (int t = tid; t < nv; t += blockDim.x) {
      const int n = static_cast<int>(perm[cell0 + s0 + t]);
      ids[t] = n;
      for (int cc = 0; cc < ncov; ++cc)
        gcs[cc * kChunk + t] = gn[static_cast<long long>(n) * ncov + cc];
      if (!kAssign) {
        bks[t] = blk[n];
        blk[n] = bi;
      }
    }
    __syncthreads();
    auto rows = [&](int t) {
      if (kAssign) return kShared ? pen + static_cast<long long>(bi) * B * K : pen_s;
      return pen + static_cast<long long>(bks[t]) * B * K;
    };
    // ring slot i % kRing holds the warp's i-th cell of the chunk; the
    // slot refilled is the one read a step earlier
    for (int i = 0; i < kRing - 1; ++i) {
      if (w + i * nw < nv) fetch_row<KJ>(G, ids[w + i * nw], K, myring + i * K);
      cp_async_commit();
    }
    float dv[KR], pc[KR], pn[KR], r[KR];
    if constexpr (KJ > 0)
      if (w < nv) penalties(rows(w), gcs + w, kChunk, ncov, K, pc);
    const int steps = (nv + nw - 1) / nw;
    for (int i = 0; i < steps; ++i) {
      const int t = w + i * nw;
      cp_async_wait<kRing - 2>();  // the cell's row has landed
      const float* slot = myring + (i % kRing) * K;
      float* rw = rrow + ((i & 1) * nw + w) * K;
      if constexpr (KJ > 0) {
#pragma unroll
        for (int j = 0; j < KJ; ++j)
          if (t < nv && lane + 32 * j < K) dv[j] = slot[lane + 32 * j];
      }
      const int tf = t + (kRing - 1) * nw;
      if (tf < nv) fetch_row<KJ>(G, ids[tf], K, myring + ((i + kRing - 1) % kRing) * K);
      cp_async_commit();
      if (t < nv) {
        if constexpr (KJ > 0) {
          const int tn = t + nw;
          if (tn < nv) penalties(rows(tn), gcs + tn, kChunk, ncov, K, pn);  // in flight
          chain(dv, pc, sg, K, r);
          if constexpr (kShared) {
#pragma unroll
            for (int j = 0; j < KJ; ++j)
              if (lane + 32 * j < K) rw[lane + 32 * j] = r[j];
          } else {
            for (int cc = 0; cc < ncov; ++cc) {
              float* o = Om + gcs[cc * kChunk + t] * K + lane;
#pragma unroll
              for (int j = 0; j < KJ; ++j)
                if (lane + 32 * j < K) o[32 * j] += r[j];
            }
          }
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            if (lane + 32 * j < K) {
              rs[j] += r[j];
              if (kAssign) {
                kerr += r[j] * dv[j];
                ent += sg[j] * (r[j] > 0.f ? r[j] * logf(r[j]) : 0.f);
              }
            }
            pc[j] = pn[j];
          }
        } else {
          chain_wide(slot, 1, rw, 1, rows(t), gcs + t, kChunk, ncov, sigma, K);
          for (int k = lane; k < K; k += 32) {
            const float rv = rw[k];
            rsw[w * K + k] += rv;
            if (kAssign) {
              kerr += rv * slot[k];
              ent += sigma[k] * (rv > 0.f ? rv * logf(rv) : 0.f);
            }
          }
        }
      }
      if constexpr (kShared) {
        __syncthreads();  // step i's rows are in; step i - 1's buffer is free
        const int nq = min(nw, nv - i * nw);
        for (int k = tid; k < K; k += blockDim.x)
          for (int q = 0; q < nq; ++q) {
            const float rv = rrow[((i & 1) * nw + q) * K + k];
            for (int cc = 0; cc < ncov; ++cc) Ob[gcs[cc * kChunk + i * nw + q] * K + k] += rv;
          }
      }
    }
    cp_async_wait<0>();  // no copy into the ring outlives the chunk
  }
  if constexpr (KJ > 0) {
#pragma unroll
    for (int j = 0; j < KJ; ++j)
      if (lane + 32 * j < K) rsw[w * K + lane + 32 * j] = rs[j];
  }
  kerr = warp_sum(kerr);
  ent = warp_sum(ent);
  if (lane == 0) {
    red[w] = kerr;
    red[nw + w] = ent;
  }
  __syncthreads();
  // the warps' sums, in warp order
  float* prow = part + static_cast<long long>(blockIdx.x) * P;
  for (int k = tid; k < K; k += blockDim.x) {
    float v = 0.f;
    for (int q = 0; q < nw; ++q) v += rsw[q * K + k];
    prow[k] = v;
  }
  for (int i = tid; i < K * B; i += blockDim.x) {
    const int k = i / B, b = i - k * B;
    float v = 0.f;
    for (int q = 0; q < nt; ++q) v += Ob[(q * B + b) * K + k];
    prow[K + i] = v;
  }
  if (tid == 0) {
    float a = 0.f, e = 0.f;
    for (int q = 0; q < nw; ++q) {
      a += red[q];
      e += red[nw + q];
    }
    prow[P - 2] = a;
    prow[P - 1] = e;
  }
}

// Fixed-order sum of partials rows [first, first + n) for cluster k into
// fin: batch sums (B), row sum, and on k == 0 the k-means error and entropy.
__device__ void fold(const float* __restrict__ part, int first, int n, int P, int K,
                     int B, int k, int nE, float* buf, float* fin) {
  const int tid = threadIdx.x, lane = tid & 31, s = tid >> 5;
  for (int j = lane; j < nE; j += 32) {
    const int src = j < B ? K + k * B + j : (j == B ? k : P - 2 + (j - B - 1));
    float v = 0.f;
    for (int c = s; c < n; c += kSlices)
      v += part[static_cast<long long>(first + c) * P + src];
    buf[s * nE + j] = v;
  }
  __syncthreads();
  for (int j = tid; j < nE; j += kThreads) {
    float v = 0.f;
    for (int q = 0; q < kSlices; ++q) v += buf[q * nE + j];
    fin[j] = v;
  }
  __syncthreads();
}

// One CTA per cluster row k. add: fold the assigned block's partials into
// E/O (and, on row 0, the k-means error and entropy into acc); rm: remove
// the next block's old statistics, its removal partials [rm_first,
// rm_first + rm_n); store_row >= 0: store the penalty as that table row.
__global__ void __launch_bounds__(kThreads) commit_kernel(
    const float* __restrict__ part1, int n1, const float* __restrict__ part0,
    int rm_first, int rm_n, float* __restrict__ E, float* __restrict__ O,
    const float* __restrict__ Pr, const float* __restrict__ theta,
    float* __restrict__ pen, int store_row, float* __restrict__ acc, int K, int B,
    int add, int rm) {
  extern __shared__ float buf[];  // kSlices * nE, then nE + nE finals
  const int k = blockIdx.x;
  const int P = K + K * B + 2;
  const int nE = B + 1 + (k == 0 ? 2 : 0);
  float* fa = buf + kSlices * nE;
  float* fr = fa + nE;
  const int tid = threadIdx.x;
  if (add) fold(part1, 0, n1, P, K, B, k, nE, buf, fa);
  if (rm) fold(part0, rm_first, rm_n, P, K, B, k, nE, buf, fr);
  for (int b = tid; b < B; b += kThreads) {
    const int i = k * B + b;
    float e = E[i], o = O[i];
    if (add) {
      e = e + fa[B] * Pr[b];
      o = o + fa[b];
    }
    if (rm) {
      e = e - fr[B] * Pr[b];
      o = o - fr[b];
    }
    E[i] = e;
    O[i] = o;
    if (store_row >= 0)
      pen[(static_cast<long long>(store_row) * B + b) * K + k] =
          powf((2.f * e + 1.f) / (o + e + 1.f), theta[b]);
  }
  if (add && k == 0 && tid == 0) {
    acc[0] += fa[B + 1];
    acc[1] += fa[B + 2];
  }
}

// K3's steps. A step is one sub-tile of T cells: [n0, n0 + nv). Without
// moments CTA b takes the sub-tiles b, b + gridDim.x, ... of the natural
// order; with moments the sub-tiles of the layout tiles (width tw) of its
// range of the plan (pl: span tile ids, then each tile's segment, -1 past
// the range; in shared memory), in order. nv <= 0 is an empty step (a
// tile past Np).
struct Step {
  long long n0;
  int nv;
  int seg;  // moments: the segment whose partials row the step adds to
  bool done;
};

template <bool kMoments>
__device__ __forceinline__ Step k3_step(int s, const int* pl, long long Np, int T, int span,
                                        int tw) {
  if (kMoments) {
    const int spt = (tw + T - 1) / T;
    const int c = s / spt;
    if (c >= span || pl[c] < 0) return {0, 0, -1, true};
    const int s0 = (s - c * spt) * T;
    const long long n0 = static_cast<long long>(pl[c]) * tw + s0;
    return {n0, static_cast<int>(min(static_cast<long long>(min(T, tw - s0)), Np - n0)),
            pl[span + c], false};
  }
  const long long n0 =
      (static_cast<long long>(blockIdx.x) + static_cast<long long>(s) * gridDim.x) * T;
  if (n0 >= Np) return {0, 0, 0, true};
  return {n0, static_cast<int>(min(static_cast<long long>(T), Np - n0)), 0, false};
}

// Issues the copies of a step's inputs (cp.async): the rows of G of its
// cells below N, one contiguous span; their codes and block ids; with
// moments their Z_orig columns, dim-major (row stride T + 4), 16 bytes at
// a time where aligned, zeros up to a whole float4 past the cells.
template <bool kMoments>
__device__ __forceinline__ void k3_stage(const Step& st, const float* __restrict__ G,
                                         const int* __restrict__ codes,
                                         const int* __restrict__ blkn,
                                         const float* __restrict__ Zo, float* Gs, int* gcs,
                                         int* bks, float* Zr, long long Np, long long N, int K,
                                         int d, int ncov, int T) {
  if (st.done || st.nv <= 0) return;
  const int tid = threadIdx.x, nv = st.nv;
  const int nf = static_cast<int>(max(0LL, min(static_cast<long long>(nv), N - st.n0))) * K;
  const float* src = G + st.n0 * K;
  int head = 0;
  if (((st.n0 * K) & 3) == 0) {
    head = nf & ~3;
    for (int i = 4 * tid; i < head; i += 4 * kK3Threads) cp_async16(Gs + i, src + i);
  }
  for (int i = head + tid; i < nf; i += kK3Threads) cp_async4(Gs + i, src + i);
  for (int i = tid; i < ncov * nv; i += kK3Threads) {
    const int c = i / nv, t = i - c * nv;
    cp_async4(gcs + c * T + t, codes + c * Np + st.n0 + t);
  }
  for (int t = tid; t < nv; t += kK3Threads) cp_async4(bks + t, blkn + st.n0 + t);
  if (kMoments) {
    const int nq = (nv + 3) / 4, zs = T + 4;
    const bool al = (Np & 3) == 0 && (st.n0 & 3) == 0;
    for (int i = tid; i < d * nq; i += kK3Threads) {
      const int e = i / nq, q = 4 * (i - e * nq);
      const float* z = Zo + e * Np + st.n0 + q;
      float* dst = Zr + e * zs + q;
      if (al && q + 4 <= nv) {
        cp_async16(dst, z);
      } else {
        for (int u = 0; u < 4; ++u) {
          if (q + u < nv) cp_async4(dst + u, z + u);
          else dst[u] = 0.f;  // past the step's cells, up to a whole float4
        }
      }
    }
  }
}

// K3: R of the final round in natural order, read from the phase's
// distances G (the head's, so R is the last round's bit for bit), and with
// moments the [R Z_orig^T | R 1] partials, one (K x d+1) row per segment
// of the plan and cell group, written when the segment's last step is
// done. Cells n >= N are pads: R = 0. A software pipeline
// with one barrier a step: in the interval after step s's barrier the CTA
// issues step s+1's copies, loads the penalties of step s's cells, stores
// step s-1's R and runs its moment tail from the other halves of Ls and
// Rc, then runs step s's chain (a warp four cells at once, r written
// cluster-major into Ls and, with moments, cell-major into Rc). The tail:
// thread (group g, tile mt) owns a kMR x kME (cluster x dim) register tile
// over the 4-cell blocks g, g + ng, ..., one float4 of R a cell and one of
// [Z_orig; 1] a dim (dim-major, as copied) for each 128 FMAs.
template <bool kMoments, int KJ>
__global__ void __launch_bounds__(kK3Threads, 1) materialize_kernel(
    const float* __restrict__ G,      // (N, K) the phase's distances
    const int* __restrict__ codes,    // (ncov, Np) local levels
    const int* __restrict__ offs,     // (ncov,) covariate offsets
    const int* __restrict__ blkn,     // (Np,) final block id per cell
    const float* __restrict__ pen,    // (nbp*B, K) final tables
    const float* __restrict__ sigma,  // (K,)
    float* __restrict__ R,            // (K, Np) out
    const float* __restrict__ Zo,     // (d, Np) Z_orig (moments)
    const int* __restrict__ plan,     // (gridDim.x, 2, span) tile ids, segments (moments)
    float* __restrict__ part,         // (segments * ng, K, d+1) out (moments)
    long long Np, long long N, int K, int d, int B, int ncov, int T, int span, int tw,
    int KR, int d1p, int ng) {
  extern __shared__ __align__(16) float smem[];
  const int TP = T + 1;
  const int LS = (K * TP + 3) / 4 * 4;
  const int d1 = d + 1;
  float* Gs = smem;                                   // 2*T*K: the steps' rows of G
  float* Ls = Gs + 2 * T * K;                         // 2*LS: R, cluster-major
  float* Rc = Ls + 2 * LS;                            // 2*T*KR (moments): R, cell-major
  const int zs = T + 4;                               // row stride of Zr
  // 3*d1p*zs (moments): [Z_orig; 1; 0], dim-major, d1p = 8 ceil((d+1)/8)
  // rows; three steps', as step s+1's copies land while step s-1's tail
  // reads
  float* Zr = Rc + (kMoments ? 2 * T * KR : 0);
  int* gcs = reinterpret_cast<int*>(Zr + (kMoments ? 3 * d1p * zs : 0));  // 2*ncov*T
  int* bks = gcs + 2 * ncov * T;                      // 2*T
  int* pl = bks + 2 * T;                              // 2*span (moments): the CTA's plan

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  if (kMoments)
    for (int c = tid; c < 2 * span; c += kK3Threads)
      pl[c] = plan[static_cast<long long>(blockIdx.x) * 2 * span + c];
  constexpr int KR_ = KJ > 0 ? KJ : 1;
  float sg[KR_];
#pragma unroll
  for (int j = 0; j < KR_; ++j) sg[j] = lane + 32 * j < K ? sigma[lane + 32 * j] : 1.f;
  const int neb = (d1 + kME - 1) / kME;
  const int nt = (K + kMR - 1) / kMR * neb;
  const int nkb = (K + kMR - 1) / kMR;
  const int grp = tid / nt, mt = tid - grp * nt;
  const bool mine = kMoments && grp < ng;
  const int eb = mt / nkb, kb = mt - eb * nkb;  // clusters fastest: Zr's loads broadcast
  float acc[kMR][kME];
#pragma unroll
  for (int i = 0; i < kMR; ++i)
#pragma unroll
    for (int j = 0; j < kME; ++j) acc[i][j] = 0.f;
  if (kMoments) {
    // the constant rows of the three: 1 at e = d, 0 past it
    const int nc = d1p - d;
    for (int i = tid; i < 3 * nc * zs; i += kK3Threads) {
      const int r = i / zs, u = i - r * zs;
      const int hh = r / nc, e = d + (r - hh * nc);
      Zr[(hh * d1p + e) * zs + u] = e == d ? 1.f : 0.f;
    }
  }

  auto finish_cells = [&](const Step& st, int h, int hz) {
    if (st.nv <= 0) return;
    const int nv = st.nv;
    const float* Lh = Ls + h * LS;
    const int t = tid % T;
    if (t < nv)
      for (int k = tid / T; k < K; k += kK3Threads / T) R[k * Np + st.n0 + t] = Lh[k * TP + t];
    if (mine) {
      // 4-cell blocks q = grp, grp + ng, ...: four float4s of R (one a
      // cell) and eight of [Z_orig; 1] (one a dim, four cells) for 128 FMAs
      const float* Zc = Zr + (hz * d1p + kME * eb) * zs;
      const float* Rk = Rc + h * T * KR + kMR * kb;
      for (int u0 = 4 * grp; u0 < nv; u0 += 4 * ng) {
        float zv[kME][4];
#pragma unroll
        for (int j = 0; j < kME; ++j) {
          const float4 z = *reinterpret_cast<const float4*>(Zc + j * zs + u0);
          zv[j][0] = z.x;
          zv[j][1] = z.y;
          zv[j][2] = z.z;
          zv[j][3] = z.w;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 rq = *reinterpret_cast<const float4*>(Rk + (u0 + c) * KR);
          const float rv[kMR] = {rq.x, rq.y, rq.z, rq.w};
#pragma unroll
          for (int i = 0; i < kMR; ++i)
#pragma unroll
            for (int j = 0; j < kME; ++j) acc[i][j] = fmaf(rv[i], zv[j][c], acc[i][j]);
        }
      }
    }
  };
  // the step's R: stored, and its moments added into the register tiles;
  // after the last step of a segment (nx the step after st) the tiles go
  // to the segment's partials row and start again from zero
  auto finish = [&](const Step& st, int h, int hz, const Step& nx) {
    if (st.done) return;
    finish_cells(st, h, hz);
    if (kMoments && mine && (nx.done || nx.seg != st.seg)) {
      float* out = part + (static_cast<long long>(st.seg) * ng + grp) * K * d1;
#pragma unroll
      for (int i = 0; i < kMR; ++i)
#pragma unroll
        for (int j = 0; j < kME; ++j) {
          const int k = kMR * kb + i, e = kME * eb + j;
          if (k < K && e < d1) out[k * d1 + e] = acc[i][j];
          acc[i][j] = 0.f;
        }
    }
  };
  // the penalties of a warp's cells of step st (w + 16 c, c < kCPW),
  // issued before the other work of the interval so that their loads
  // overlap it
  float pq[kCPW][KR_];
  auto load_pens = [&](const Step& st, int h) {
    if constexpr (KJ > 0) {
      if (st.done || st.nv <= 0) return;
      const int nreal = static_cast<int>(max(0LL, min(static_cast<long long>(st.nv), N - st.n0)));
      const int* gc = gcs + h * ncov * T;
      const int* bk = bks + h * T;
#pragma unroll
      for (int c = 0; c < kCPW; ++c) {
        const int t = w + kK3Warps * c;
        if (t < nreal) {
          penalties(pen + static_cast<long long>(bk[t]) * B * K, gc + t, T, ncov, K, pq[c]);
        } else {
#pragma unroll
          for (int j = 0; j < KJ; ++j) pq[c][j] = 0.f;
        }
      }
    }
  };
  // the step's chain: R into half h of Ls (and Rc)
  auto run_chain = [&](const Step& st, int h) {
    if (st.done || st.nv <= 0) return;
    const int nv = st.nv;
    float* Gc = Gs + h * T * K;
    const int* gc = gcs + h * ncov * T;
    const int* bk = bks + h * T;
    float* Lh = Ls + h * LS;
    float* Rh = Rc + h * T * KR;
    const int nreal = static_cast<int>(max(0LL, min(static_cast<long long>(nv), N - st.n0)));
    auto put = [&](int t, int k, float v) {
      Lh[k * TP + t] = v;
      if (kMoments) Rh[t * KR + k] = v;
    };
    if constexpr (KJ > 0) {
      // NC of the warp's cells at once; a cell past nreal runs on zeros
      constexpr int NC = KJ <= 4 ? kCPW : 2;
#pragma unroll
      for (int c0 = 0; c0 < kCPW; c0 += NC) {
        if (w + kK3Warps * c0 >= nreal) break;
        float v[NC][KJ], pp[NC][KJ];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int t = w + kK3Warps * (c0 + c);
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            v[c][j] = t < nreal && lane + 32 * j < K ? Gc[t * K + lane + 32 * j] : 0.f;
            pp[c][j] = pq[c0 + c][j];
          }
        }
        chain_n<NC, KJ>(v, pp, sg, K);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int t = w + kK3Warps * (c0 + c);
          if (t < nreal)
#pragma unroll
            for (int j = 0; j < KJ; ++j)
              if (lane + 32 * j < K) put(t, lane + 32 * j, v[c][j]);
        }
      }
    } else {
      for (int t = w; t < nreal; t += kK3Warps) {
        float* row = Gc + t * K;  // r overwrites the cell's distances
        chain_wide(row, 1, row, 1, pen + static_cast<long long>(bk[t]) * B * K, gc + t, T,
                   ncov, sigma, K);
        for (int k = lane; k < K; k += 32) put(t, k, row[k]);
      }
    }
    // pads, and with moments R = 0 up to a whole float4 of cells
    const int nz = kMoments ? min(T, (nv + 3) / 4 * 4) : nv;
    for (int t = nreal + w; t < nz; t += kK3Warps)
      for (int k = lane; k < K; k += 32) put(t, k, 0.f);
  };

  __syncthreads();  // the plan is in
  Step cur = k3_step<kMoments>(0, pl, Np, T, span, tw), prv = {0, 0, -1, true};
  k3_stage<kMoments>(cur, G, codes, blkn, Zo, Gs, gcs, bks, Zr, Np, N, K, d, ncov, T);
  cp_async_commit();
  for (int s = 0; !(cur.done && prv.done); ++s) {
    const int h = s & 1;
    cp_async_wait<0>();  // this thread's copies of step s have landed
    if (!cur.done && cur.nv > 0) {
      // the codes this thread copied, made global batch rows
      int* gc = gcs + h * ncov * T;
      for (int i = tid; i < ncov * cur.nv; i += kK3Threads) {
        const int c = i / cur.nv, t = i - c * cur.nv;
        gc[c * T + t] += offs[c];
      }
    }
    __syncthreads();  // step s's inputs are in; step s-1's R is in Ls, Rc
    const Step nx =
        cur.done ? Step{0, 0, -1, true} : k3_step<kMoments>(s + 1, pl, Np, T, span, tw);
    k3_stage<kMoments>(nx, G, codes, blkn, Zo, Gs + (h ^ 1) * T * K,
                       gcs + (h ^ 1) * ncov * T, bks + (h ^ 1) * T,
                       Zr + (s + 1) % 3 * d1p * zs, Np, N, K, d, ncov, T);
    cp_async_commit();
    load_pens(cur, h);
    finish(prv, h ^ 1, (s + 2) % 3, cur);
    run_chain(cur, h);
    prv = cur;
    cur = nx;
  }
  cp_async_wait<0>();
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// KJ, the cluster values a lane holds in registers: 1, 2, 4 or 8 for
// K <= 256, else 0 (chain_wide, in shared memory).
int lanes_kj(int K) { return K <= 32 ? 1 : K <= 64 ? 2 : K <= 128 ? 4 : K <= 256 ? 8 : 0; }

template <int KJ, bool kShared>
const void* cells_kernel(int assign) {
  return assign ? reinterpret_cast<const void*>(round_cells_kernel<true, KJ, kShared>)
                : reinterpret_cast<const void*>(round_cells_kernel<false, KJ, kShared>);
}

template <bool kShared>
const void* cells_kernel_kj(int assign, int K) {
  switch (lanes_kj(K)) {
    case 1: return cells_kernel<1, kShared>(assign);
    case 2: return cells_kernel<2, kShared>(assign);
    case 4: return cells_kernel<4, kShared>(assign);
    case 8: return cells_kernel<8, kShared>(assign);
    default: return kShared ? cells_kernel<0, true>(assign) : nullptr;
  }
}

// nullptr for the per-warp tables past K = 256
const void* cells_kernel_for(int assign, int K, int shared) {
  return shared ? cells_kernel_kj<true>(assign, K) : cells_kernel_kj<false>(assign, K);
}

template <bool kMoments>
const void* materialize_kernel_for(int K) {
  switch (lanes_kj(K)) {
    case 1: return reinterpret_cast<const void*>(materialize_kernel<kMoments, 1>);
    case 2: return reinterpret_cast<const void*>(materialize_kernel<kMoments, 2>);
    case 4: return reinterpret_cast<const void*>(materialize_kernel<kMoments, 4>);
    case 8: return reinterpret_cast<const void*>(materialize_kernel<kMoments, 8>);
    default: return reinterpret_cast<const void*>(materialize_kernel<kMoments, 0>);
  }
}

}  // namespace

extern "C" {

// CTAs of `threads` threads and smem_bytes of shared memory an SM holds at
// once: kernel 0 the head, 1 the removal pass, 2 the assign pass (shared:
// one batch-sum table a CTA); < 0 is minus a CUDA error.
int k2_occupancy(int which, int K, int shared, int threads, int smem_bytes) {
  const void* kern = which == 0 ? reinterpret_cast<const void*>(head_kernel)
                                : cells_kernel_for(which == 2, K, shared);
  if (kern == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem(kern, smem_bytes);
  if (err) return -err;
  int n = 0;
  err = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads, smem_bytes));
  return err ? -err : n;
}

int k2_head(const void* Yt, const void* Z, void* G, long long N, long long Np, int K, int d,
            int T, int grid, int smem_bytes, void* stream) {
  int err = set_smem(reinterpret_cast<const void*>(head_kernel), smem_bytes);
  if (err) return err;
  head_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Yt), static_cast<const float*>(Z), static_cast<float*>(G), N,
      Np, K, d, T);
  return static_cast<int>(cudaGetLastError());
}

// K2 cell pass: assign = 0 is the removal over the whole round, 1 the
// assign pass of one block (cta0 = block * cta_per); shared: one batch-sum
// table a CTA.
int k2_cells(int assign, int shared, const void* G, const void* perm, const void* gn,
             void* blk, const void* pen, const void* sigma, void* part, int grid, int threads,
             int cpb, int last, int nb, int cta_per, int span, int cta0, int K, int B, int ncov,
             int smem_bytes, void* stream) {
  const void* kern = cells_kernel_for(assign, K, shared);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem(kern, smem_bytes);
  if (err) return err;
  const float* Gf = static_cast<const float*>(G);
  const long long* pi = static_cast<const long long*>(perm);
  const int* gi = static_cast<const int*>(gn);
  int* bi = static_cast<int*>(blk);
  const float* penf = static_cast<const float*>(pen);
  const float* sigf = static_cast<const float*>(sigma);
  float* partf = static_cast<float*>(part);
  void* args[] = {&Gf, &pi, &gi, &bi, &penf, &sigf, &partf, &cpb, &last, &nb,
                  &cta_per, &span, &cta0, &K, &B, &ncov};
  return static_cast<int>(cudaLaunchKernel(kern, dim3(grid), dim3(threads), args,
                                           smem_bytes, static_cast<cudaStream_t>(stream)));
}

int k2_commit(const void* part1, int n1, const void* part0, int rm_first, int rm_n,
              void* E, void* O, const void* Pr, const void* theta, void* pen,
              int store_row, void* acc, int K, int B, int add, int rm, void* stream) {
  const int smem_bytes = (kSlices + 2) * (B + 3) * static_cast<int>(sizeof(float));
  int err = set_smem(reinterpret_cast<const void*>(commit_kernel), smem_bytes);
  if (err) return err;
  commit_kernel<<<K, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part1), n1, static_cast<const float*>(part0), rm_first,
      rm_n, static_cast<float*>(E), static_cast<float*>(O), static_cast<const float*>(Pr),
      static_cast<const float*>(theta), static_cast<float*>(pen), store_row,
      static_cast<float*>(acc), K, B, add, rm);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of K3 (moments or not, at K) an SM holds with smem_bytes each; < 0
// is minus a CUDA error.
int k3_occupancy(int moments, int K, int smem_bytes) {
  const void* kern = moments ? materialize_kernel_for<true>(K) : materialize_kernel_for<false>(K);
  int err = set_smem(kern, smem_bytes);
  if (err) return -err;
  int n = 0;
  err = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kK3Threads, smem_bytes));
  return err ? -err : n;
}

// K3; Zo == nullptr: no moments (grid CTAs walk the sub-tiles); else the
// plan, a range of layout tiles a CTA, and ng partials rows per segment,
// which the wrapper sums per joint with tiled.cu's sum_joint_rows.
int k3_materialize(const void* G, const void* codes, const void* offs, const void* blk,
                   const void* pen, const void* sigma, void* R, const void* Zo,
                   const void* plan, void* part, long long Np, long long N, int K, int d,
                   int B, int ncov, int T, int grid, int span, int tw, int KR, int d1p, int ng,
                   int smem_bytes, void* stream) {
  const void* kern = Zo != nullptr ? materialize_kernel_for<true>(K)
                                   : materialize_kernel_for<false>(K);
  int err = set_smem(kern, smem_bytes);
  if (err) return err;
  const float* Gf = static_cast<const float*>(G);
  const int* ci = static_cast<const int*>(codes);
  const int* oi = static_cast<const int*>(offs);
  const int* bi = static_cast<const int*>(blk);
  const float* penf = static_cast<const float*>(pen);
  const float* sigf = static_cast<const float*>(sigma);
  float* Rf = static_cast<float*>(R);
  const float* Zof = static_cast<const float*>(Zo);
  const int* pli = static_cast<const int*>(plan);
  float* partf = static_cast<float*>(part);
  void* args[] = {&Gf, &ci, &oi, &bi, &penf, &sigf, &Rf, &Zof, &pli, &partf, &Np, &N,
                  &K, &d, &B, &ncov, &T, &span, &tw, &KR, &d1p, &ng};
  return static_cast<int>(cudaLaunchKernel(kern, dim3(grid), dim3(kK3Threads), args,
                                           smem_bytes, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
