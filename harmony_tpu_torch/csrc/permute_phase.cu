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
// One per-cell chain (cell_chain) serves the removal pass, the assign pass
// and K3: g = Y^T z with K1's product loop, d = 2(1 - g), the softmax over
// K, times the penalty summed over covariates, the guarded renormalise.
// Its products are __fmul_rn, so no kernel fuses them differently: the
// removal subtracts exactly the assignments the last round added, and K3's
// R equals the last round's R bit for bit per cell (the property of
// pallas_estep.py:350-353, 502-504).
//
// K2, one round, all host-ordered launches on one stream, no PyTorch op and
// no host copy between them (2*nb + 2 launches):
//   (0) round_cells_kernel<false> over all the round's cells (the removal
//       depends only on last round's tables and block ids): per CTA, up to
//       nsub tiles of T cells of one block, partial row sums and batch sums
//       of the recomputed old assignments.
//   (1) commit_kernel: no add; remove block 0; store table row 0.
//   (2) per block i: round_cells_kernel<true> (the assign pass, against
//       table row i; no R; k-means error and entropy partials), then
//       commit_kernel: fold the block's partials in a fixed order, remove
//       block i+1's old statistics (its removal partials, in a fixed
//       order), compute the penalty and store it as table row i+1.
// The layout gather (cells in block order, cell-major so each gathered
// cell is one contiguous row), the scatter of the new block ids and the
// swap of the two tables stay PyTorch between rounds, as pallas_estep.py:
// 807-843 keeps them outside its kernel.
// Shared with K1 (estep_round.cu, copied because each source builds into a
// library of its own): the distance product loop, the per-warp cell
// column, the row pass and the commit's fixed-order fold.
//
// K3: materialize_kernel over natural-order tiles writes R (K, Np), pad
// cells 0. With moments the grid is K8's chunk plan (csrc/tiled.cu): a CTA
// takes up to `chunk` layout tiles of one joint batch level, computes
// their R in 64-cell sub-tiles, writes it, and accumulates
// R_t [Z_orig_t; 1]^T in 4x4 register tiles; per-chunk partials are summed
// per joint in chunk order by a second launch (tiled.cu's sum_joint_rows).
// No float atomics anywhere.
//
// Bounds on this card at N = 500k, d = 50, K = 100 (fp32 outside the
// tensor cores, 67 TFLOP/s; 3.35 TB/s): Y and Z do not change within a
// clustering phase, so a round needs one distance product, 2*K*d*N =
// 5 GFLOP, 0.075 ms, against 0.1 GB of Z, codes, block ids and the
// permutation (0.03 ms): operations-bound. Computing the distances again
// in the removal pass (as the TPU kernel does) is this design's choice,
// not the function's: it keeps the removal one launch with no (K, N)
// buffer between rounds, at twice the bound's operations. K3 is
// 2*K*d*N = 5 GFLOP plus, with
// moments, 2*K*(d+1)*N = 5.1 GFLOP (0.15 ms), against Z, Z_orig and R,
// 0.4 GB (0.12 ms). The design keeps the chain in shared memory and L2
// (tile staged once, tables L2-resident) so the passes stay near the
// operations bound rather than re-reading Z or R.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 8;      // cluster rows per thread in the product
constexpr int kSlices = 8;  // commit: partial rows summed per warp slice
constexpr int kMaxMT = 2;   // K3 moments: 4x4 register tiles a thread owns

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dist = 2 (1 - Y^T z) for the T cells staged in Zs (row stride TP) into Ls
// (row stride TP): lane -> cells (lane, lane + 32), warp -> 8 cluster rows.
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

// pc[k] of cell t: the sum over covariates of its table row's entry k.
__device__ __forceinline__ float penalty(const float* __restrict__ rows, const int* gcs,
                                         int t, int T, int ncov, int K, int k) {
  float pc = __ldg(rows + static_cast<long long>(gcs[t]) * K + k);
  for (int c = 1; c < ncov; ++c)
    pc += __ldg(rows + static_cast<long long>(gcs[c * T + t]) * K + k);
  return pc;
}

// One warp, lanes over clusters: the assignment of cell t from its
// distances (column t of Ls, overwritten with R) and the table rows of
// block blk: r = L1(L1(exp(-dist / sigma)) * pc), both sums guarded against
// zero. With kObj the cell's k-means error and entropy terms are added to
// the lane's kerr/ent.
template <bool kObj>
__device__ __forceinline__ void cell_chain(float* Ls, int TP, int t, const float* sig,
                                           const float* __restrict__ pen, int blk,
                                           const int* gcs, int T, int ncov, int B, int K,
                                           float& kerr, float& ent) {
  const int lane = threadIdx.x & 31;
  const float* rows = pen + static_cast<long long>(blk) * B * K;
  float s1 = 0.f;
  for (int k = lane; k < K; k += 32) s1 += expf(-Ls[k * TP + t] / sig[k]);
  s1 = warp_sum(s1);
  const float s1g = s1 == 0.f ? 1.f : s1;
  float s2 = 0.f;
  for (int k = lane; k < K; k += 32)
    s2 += __fmul_rn(expf(-Ls[k * TP + t] / sig[k]) / s1g,
                    penalty(rows, gcs, t, T, ncov, K, k));
  s2 = warp_sum(s2);
  const float s2g = s2 == 0.f ? 1.f : s2;
  for (int k = lane; k < K; k += 32) {
    const float dist = Ls[k * TP + t];
    const float r = __fmul_rn(expf(-dist / sig[k]) / s1g,
                              penalty(rows, gcs, t, T, ncov, K, k)) / s2g;
    if (kObj) {
      kerr += r * dist;
      ent += sig[k] * (r > 0.f ? r * logf(r) : 0.f);
    }
    Ls[k * TP + t] = r;
  }
}

// K2's cell passes over the round's layout (cells in block order; block i
// holds cells [i*cpb, i*cpb + size_i)). CTA c = cta0 + blockIdx.x covers up
// to nsub tiles of T cells of block min(c / cta_per, nb - 1). The removal
// (kAssign false) looks each cell up in its previous block's table rows;
// the assign pass in block i's rows. Partials row of a CTA, in part at
// blockIdx.x: [row sums K | batch sums K*B | k-means error | entropy].
template <bool kAssign>
__global__ void __launch_bounds__(kThreads) round_cells_kernel(
    const float* __restrict__ Yt,     // (K, d)
    const float* __restrict__ Zl,     // (L, d) cell-major, block order
    const int* __restrict__ gl,       // (L, ncov) global batch rows
    const int* __restrict__ bl,       // (L,) previous block id (removal only)
    const float* __restrict__ pen,    // (nbp*B, K) tables
    const float* __restrict__ sigma,  // (K,)
    float* __restrict__ part,         // (gridDim.x, P) out
    int cpb, int last, int nb, int cta_per, int nsub, int cta0, int K, int d,
    int B, int ncov, int T) {
  extern __shared__ float smem[];
  const int TP = T + 1;
  const int P = K + K * B + 2;
  float* Ys = smem;             // K*d
  float* Zs = Ys + K * d;       // d*TP
  float* Ls = Zs + d * TP;      // K*TP: dist, then R
  float* sig = Ls + K * TP;     // K
  float* Obs = sig + K;         // K*B
  float* rss = Obs + K * B;     // K
  float* red = rss + K;         // 2*kWarps
  int* gcs = reinterpret_cast<int*>(red + 2 * kWarps);  // ncov*T
  int* bks = gcs + ncov * T;                           // T

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int c = cta0 + blockIdx.x;
  const int blk = cta_per ? min(c / cta_per, nb - 1) : nb - 1;
  const int size = blk < nb - 1 ? cpb : last;
  const int q0 = (c - blk * cta_per) * T * nsub;
  const int q1 = min(q0 + T * nsub, size);
  const long long cell0 = static_cast<long long>(blk) * cpb;

  for (int i = tid; i < K * d; i += kThreads) Ys[i] = Yt[i];
  for (int i = tid; i < K; i += kThreads) {
    sig[i] = sigma[i];
    rss[i] = 0.f;
  }
  for (int i = tid; i < K * B; i += kThreads) Obs[i] = 0.f;

  float kerr = 0.f, ent = 0.f;
  for (int s0 = q0; s0 < q1; s0 += T) {
    const int nv = min(T, q1 - s0);
    const long long base = cell0 + s0;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < T * d; i += kThreads) {
      const int t = i / d, e = i - t * d;
      Zs[e * TP + t] = t < nv ? Zl[(base + t) * d + e] : 0.f;
    }
    for (int i = tid; i < ncov * T; i += kThreads) {
      const int t = i / ncov, cc = i - t * ncov;
      gcs[cc * T + t] = t < nv ? gl[(base + t) * ncov + cc] : 0;
    }
    if (!kAssign)
      for (int t = tid; t < T; t += kThreads) bks[t] = t < nv ? bl[base + t] : 0;
    __syncthreads();
    tile_dist(Ys, Zs, Ls, K, d, T, TP);
    __syncthreads();
    for (int t = w; t < nv; t += kWarps)
      cell_chain<kAssign>(Ls, TP, t, sig, pen, kAssign ? blk : bks[t], gcs, T, ncov, B,
                          K, kerr, ent);
    __syncthreads();
    // row pass: each thread owns cluster rows, so no two threads share a sum
    for (int k = tid; k < K; k += kThreads) {
      float rs = rss[k];
      for (int t = 0; t < nv; ++t) {
        const float r = Ls[k * TP + t];
        rs += r;
        for (int cc = 0; cc < ncov; ++cc) Obs[k * B + gcs[cc * T + t]] += r;
      }
      rss[k] = rs;
    }
  }
  if (kAssign) {
    kerr = warp_sum(kerr);
    ent = warp_sum(ent);
    if (lane == 0) {
      red[w] = kerr;
      red[kWarps + w] = ent;
    }
  }
  __syncthreads();
  float* prow = part + static_cast<long long>(blockIdx.x) * P;
  for (int k = tid; k < K; k += kThreads) prow[k] = rss[k];
  for (int i = tid; i < K * B; i += kThreads) prow[K + i] = Obs[i];
  if (tid == 0) {
    float a = 0.f, b = 0.f;
    if (kAssign)
      for (int i = 0; i < kWarps; ++i) {
        a += red[i];
        b += red[kWarps + i];
      }
    prow[P - 2] = a;
    prow[P - 1] = b;
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

// K3: R of the final round in natural order. Without moments CTA b covers
// cells [b*T, b*T + T); with moments it covers the layout tiles (width tw)
// of chunk row b, in sub-tiles of T cells, and writes the chunk's
// [R Z_orig^T | R 1] partial (K x d+1). Cells n >= N are pads: R = 0.
template <bool kMoments>
__global__ void __launch_bounds__(kThreads) materialize_kernel(
    const float* __restrict__ Yt,     // (K, d)
    const float* __restrict__ Z,      // (d, Np) L2-normalised
    const int* __restrict__ codes,    // (ncov, Np) local levels
    const int* __restrict__ offs,     // (ncov,) covariate offsets
    const int* __restrict__ blkn,     // (Np,) final block id per cell
    const float* __restrict__ pen,    // (nbp*B, K) final tables
    const float* __restrict__ sigma,  // (K,)
    float* __restrict__ R,            // (K, Np) out
    const float* __restrict__ Zo,     // (d, Np) Z_orig (moments)
    const int* __restrict__ chunks,   // (gridDim.x, chunk) tile ids, -1 pad
    float* __restrict__ part,         // (gridDim.x, K, d+1) out (moments)
    long long Np, long long N, int K, int d, int B, int ncov, int T, int chunk,
    int tw, int d1p) {
  extern __shared__ float smem[];
  const int TP = T + 1;
  const int K4 = (K + 3) / 4 * 4;
  const int d1 = d + 1;
  float* Zos = smem;                           // T*d1p (moments), cell-major
  float* Ys = Zos + (kMoments ? T * d1p : 0);  // K*d
  float* Zs = Ys + K * d;                      // d*TP
  float* Ls = Zs + d * TP;                     // K4*TP
  float* sig = Ls + K4 * TP;                   // K
  int* gcs = reinterpret_cast<int*>(sig + K);  // ncov*T
  int* bks = gcs + ncov * T;                   // T

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  for (int i = tid; i < K * d; i += kThreads) Ys[i] = Yt[i];
  for (int i = tid; i < K; i += kThreads) sig[i] = sigma[i];
  for (int i = K * TP + tid; i < K4 * TP; i += kThreads) Ls[i] = 0.f;
  const int nkb = K4 / 4, neb = (d1 + 3) / 4;
  float acc[kMaxMT][4][4];
#pragma unroll
  for (int m = 0; m < kMaxMT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][i][j] = 0.f;
  float unused0 = 0.f, unused1 = 0.f;

  const int ntiles = kMoments ? chunk : 1;
  for (int c = 0; c < ntiles; ++c) {
    long long start;
    int len;
    if (kMoments) {
      const int tile = chunks[static_cast<long long>(blockIdx.x) * chunk + c];
      if (tile < 0) break;
      start = static_cast<long long>(tile) * tw;
      len = tw;
    } else {
      start = static_cast<long long>(blockIdx.x) * T;
      len = T;
    }
    for (int s0 = 0; s0 < len; s0 += T) {
      const long long n0 = start + s0;
      const int nv = static_cast<int>(min(static_cast<long long>(min(T, len - s0)), Np - n0));
      if (nv <= 0) break;
      __syncthreads();  // the previous sub-tile's readers are done
      for (int i = tid; i < d * T; i += kThreads) {
        const int e = i / T, t = i - e * T;
        Zs[e * TP + t] = t < nv ? Z[e * Np + n0 + t] : 0.f;
      }
      for (int i = tid; i < ncov * T; i += kThreads) {
        const int cc = i / T, t = i - cc * T;
        gcs[i] = t < nv ? codes[cc * Np + n0 + t] + offs[cc] : 0;
      }
      for (int t = tid; t < T; t += kThreads) bks[t] = t < nv ? blkn[n0 + t] : 0;
      if (kMoments)
        for (int i = tid; i < d1p * T; i += kThreads) {
          const int e = i / T, u = i - e * T;
          float v = 0.f;
          if (u < nv && e < d1) v = e < d ? Zo[e * Np + n0 + u] : 1.f;
          Zos[u * d1p + e] = v;
        }
      __syncthreads();
      tile_dist(Ys, Zs, Ls, K, d, T, TP);
      __syncthreads();
      for (int t = w; t < nv; t += kWarps) {
        if (n0 + t < N) {
          cell_chain<false>(Ls, TP, t, sig, pen, bks[t], gcs, T, ncov, B, K, unused0,
                            unused1);
        } else {
          for (int k = lane; k < K; k += 32) Ls[k * TP + t] = 0.f;
        }
      }
      __syncthreads();
      for (int i = tid; i < K * T; i += kThreads) {
        const int k = i / T, t = i - k * T;
        if (t < nv) R[k * Np + n0 + t] = Ls[k * TP + t];
      }
      if (kMoments) {
#pragma unroll
        for (int m = 0; m < kMaxMT; ++m) {
          const int mt = tid + m * kThreads;
          if (mt >= nkb * neb) break;
          const int kb = mt / neb, eb = mt - kb * neb;
          for (int u = 0; u < nv; ++u) {
            const float4 z = *reinterpret_cast<const float4*>(Zos + u * d1p + 4 * eb);
            const float rv[4] = {Ls[(4 * kb) * TP + u], Ls[(4 * kb + 1) * TP + u],
                                 Ls[(4 * kb + 2) * TP + u], Ls[(4 * kb + 3) * TP + u]};
            const float zv[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[m][i][j] = fmaf(rv[i], zv[j], acc[m][i][j]);
          }
        }
      }
    }
  }
  if (kMoments) {
    float* out = part + static_cast<long long>(blockIdx.x) * K * d1;
#pragma unroll
    for (int m = 0; m < kMaxMT; ++m) {
      const int mt = tid + m * kThreads;
      if (mt >= nkb * neb) break;
      const int kb = mt / neb, eb = mt - kb * neb;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * kb + i, e = 4 * eb + j;
          if (k < K && e < d1) out[k * d1 + e] = acc[m][i][j];
        }
    }
  }
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

extern "C" {

// K2 cell pass: assign = 0 is the removal over the whole round, 1 the
// assign pass of one block (cta0 = block * cta_per).
int k2_cells(int assign, const void* Yt, const void* Zl, const void* gl, const void* bl,
             const void* pen, const void* sigma, void* part, int grid, int cpb, int last,
             int nb, int cta_per, int nsub, int cta0, int K, int d, int B, int ncov, int T,
             int smem_bytes, void* stream) {
  const void* kern = assign ? reinterpret_cast<const void*>(round_cells_kernel<true>)
                            : reinterpret_cast<const void*>(round_cells_kernel<false>);
  int err = set_smem(kern, smem_bytes);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* Ytf = static_cast<const float*>(Yt);
  const float* Zlf = static_cast<const float*>(Zl);
  const int* gli = static_cast<const int*>(gl);
  const int* bli = static_cast<const int*>(bl);
  const float* penf = static_cast<const float*>(pen);
  const float* sigf = static_cast<const float*>(sigma);
  float* partf = static_cast<float*>(part);
  if (assign)
    round_cells_kernel<true><<<grid, kThreads, smem_bytes, st>>>(
        Ytf, Zlf, gli, bli, penf, sigf, partf, cpb, last, nb, cta_per, nsub, cta0, K, d,
        B, ncov, T);
  else
    round_cells_kernel<false><<<grid, kThreads, smem_bytes, st>>>(
        Ytf, Zlf, gli, bli, penf, sigf, partf, cpb, last, nb, cta_per, nsub, cta0, K, d,
        B, ncov, T);
  return static_cast<int>(cudaGetLastError());
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

// K3; Zo == nullptr: no moments (grid = ceil(Np / T)); else the chunk plan
// (grid = n_chunks) and a partials row per chunk, which the wrapper sums
// per joint with tiled.cu's sum_joint_rows.
int k3_materialize(const void* Yt, const void* Z, const void* codes, const void* offs,
                   const void* blk, const void* pen, const void* sigma, void* R,
                   const void* Zo, const void* chunks, void* part, long long Np,
                   long long N, int K, int d, int B, int ncov, int T, int grid, int chunk,
                   int tw, int d1p, int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mom = Zo != nullptr;
  const void* kern = mom ? reinterpret_cast<const void*>(materialize_kernel<true>)
                         : reinterpret_cast<const void*>(materialize_kernel<false>);
  int err = set_smem(kern, smem_bytes);
  if (err) return err;
  const float* Ytf = static_cast<const float*>(Yt);
  const float* Zf = static_cast<const float*>(Z);
  const int* ci = static_cast<const int*>(codes);
  const int* oi = static_cast<const int*>(offs);
  const int* bi = static_cast<const int*>(blk);
  const float* penf = static_cast<const float*>(pen);
  const float* sigf = static_cast<const float*>(sigma);
  float* Rf = static_cast<float*>(R);
  const float* Zof = static_cast<const float*>(Zo);
  const int* chi = static_cast<const int*>(chunks);
  float* partf = static_cast<float*>(part);
  if (mom)
    materialize_kernel<true><<<grid, kThreads, smem_bytes, st>>>(
        Ytf, Zf, ci, oi, bi, penf, sigf, Rf, Zof, chi, partf, Np, N, K, d, B, ncov, T,
        chunk, tw, d1p);
  else
    materialize_kernel<false><<<grid, kThreads, smem_bytes, st>>>(
        Ytf, Zf, ci, oi, bi, penf, sigf, Rf, Zof, chi, partf, Np, N, K, d, B, ncov, T,
        chunk, tw, d1p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
