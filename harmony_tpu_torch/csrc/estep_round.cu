// K1: one reference-exact E-step round (update_R, src/harmony.cpp:269-342),
// and K12: one rotate round without the stats carry; hand-written for
// Hopper (sm_90a). The two share their assign and commit kernels.
//
// Replaces: harmony_tpu/ops/pallas_estep.py, _round_kernel (:43), reached
// through pallas_block_update_round (:127); and
// harmony_tpu/ops/pallas_rotate.py, _round_kernel (:223), reached through
// pallas_rotate_update_round (:1752).
//
// Bound on this card. Per round K1 reads the gathered Z (d x N fp32) once
// and writes R (K x N fp32) once: at N = 500k, d = 50, K = 100 that is
// 0.3 GB, 90 us at 3.35 TB/s. The distances are 2*K*d*N = 5 GFLOP of fp32
// FMA, 75 us at the card's 67 TFLOP/s outside the tensor cores. The two
// bounds are close; the round is bytes-bound by a hair. K12 also reads the
// old R (K x N) once, for the blocks' old statistics: 0.5 GB, 151 us.
//
// Design. On the TPU the grid ran in order, so E/O stayed in VMEM across
// blocks. Here CTAs run in parallel and in no order, so a round is a host
// loop over the blocks with two launches each:
//   (a) assign_kernel over the block's cell tiles. Every cell of the block
//       sees the same committed penalty table ((2E+1)/(O+E+1))^theta. A CTA
//       owns T cells: it stages Y^T, its Z tile and the penalty table in
//       shared memory, computes g = Y^T Z with register tiles (8 clusters x
//       T/32 cells a thread), then per cell (one warp per column) the
//       exp, the two L1 normalisations with their zero guards and the
//       penalty picked by the cell's batch codes, summed over covariates.
//       It writes R and its partials: row sums (K), batch sums (K x B),
//       k-means error and entropy. No float atomics anywhere. K1's cells
//       are a contiguous range of the gathered layout; K12's are the
//       block's schedule tiles (v0 + j) mod NT in the physical layout, read
//       and written in place with no gather or scatter. A negative code
//       (K12's pad cells) picks no penalty, so the cell's R is 0.
//   (b) commit_kernel, one CTA per cluster row, reduces the partials in a
//       fixed order (so repeated runs give the same trajectory), adds the
//       block's new contribution to E/O, removes the next block's old
//       contribution and writes the next penalty table. The old
//       contribution is a fixed-order sum of rows of a table of old
//       statistics: K1's has one row per block, K12's one per span of
//       cells, and a block's rows are its tiles' (they may wrap).
// K12's table comes from one more launch at the round's start,
// old_stats_kernel over every span of the old R. No step of the round
// changes the input R (the new R is another buffer), so one pass serves
// every block, and R is read once a round as on the TPU.
// The (K x T) logits tile stays in shared memory (K is a runtime value and
// does not fit registers); its row stride is T+1 so both the column pass
// (lanes over clusters) and the row pass (threads over clusters) are free
// of bank conflicts. Op order and zero guards follow
// harmony_tpu/ops/estep.py:block_update_round, which the parity fixtures
// pin. K12 on the TPU does not guard its first normalisation; the guard
// here only differs where every exp(-dist/sigma) of a cell underflows,
// which dist <= 4 at sigma ~0.1 cannot reach.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 8;  // cluster rows per thread in the product
constexpr int kSlices = 8;  // commit: partial rows summed per warp slice

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Partials row of one CTA: [row sums K | batch sums K*B | kerr | ent].
__global__ void __launch_bounds__(kThreads) assign_kernel(
    const float* __restrict__ Yt,     // (K, d)
    const float* __restrict__ Z,      // (d, L) cells in block order (K1)
                                      // or in the physical layout (K12)
    const int* __restrict__ gcodes,   // (ncov, L) global batch rows; -1 pads
    const float* __restrict__ pen,    // (K, B) committed penalty table
    const float* __restrict__ sigma,  // (K,)
    float* __restrict__ R,            // (K, L) out
    float* __restrict__ part,         // (n_cta, P) out
    long long L, long long cell0, int ncells, int K, int d, int B, int ncov,
    int T, int tileT, int NT, int v0) {
  extern __shared__ float smem[];
  const int TP = T + 1;
  const int P = K + K * B + 2;
  float* Ys = smem;           // K*d
  float* Zs = Ys + K * d;     // d*T
  float* Ls = Zs + d * T;     // K*TP: dist, then R
  float* pens = Ls + K * TP;  // K*B
  float* sig = pens + K * B;  // K
  float* Obs = sig + K;       // K*B
  float* red = Obs + K * B;   // 2*kWarps
  int* gcs = reinterpret_cast<int*>(red + 2 * kWarps);  // ncov*T

  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int t0 = blockIdx.x * T;
  const int nv = min(T, ncells - t0);
  // NT > 0 (K12): the block's cells are whole schedule tiles of tileT cells
  // from tile v0 on, wrapping at NT; a CTA's T cells lie in one tile
  const int tl = NT > 0 ? t0 / tileT : 0;
  const long long base = NT > 0
      ? static_cast<long long>((v0 + tl) % NT) * tileT + (t0 - tl * tileT)
      : cell0 + t0;

  for (int i = tid; i < K * d; i += kThreads) Ys[i] = Yt[i];
  for (int i = tid; i < d * T; i += kThreads) {
    const int e = i / T, t = i - e * T;
    Zs[i] = t < nv ? Z[e * L + base + t] : 0.f;
  }
  for (int i = tid; i < K * B; i += kThreads) {
    pens[i] = pen[i];
    Obs[i] = 0.f;
  }
  for (int i = tid; i < K; i += kThreads) sig[i] = sigma[i];
  for (int i = tid; i < ncov * T; i += kThreads) {
    const int c = i / T, t = i - c * T;
    gcs[i] = t < nv ? gcodes[c * L + base + t] : 0;
  }
  __syncthreads();

  // dist = 2 (1 - Y^T Z): lane -> cells (lane, lane+32), warp -> 8 rows
  const bool two = T > 32;
  for (int kc = w * kKC; kc < K; kc += kWarps * kKC) {
    float a0[kKC], a1[kKC];
#pragma unroll
    for (int j = 0; j < kKC; ++j) a0[j] = a1[j] = 0.f;
    for (int e = 0; e < d; ++e) {
      const float z0 = Zs[e * T + lane];
      const float z1 = two ? Zs[e * T + lane + 32] : 0.f;
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
  __syncthreads();

  // per cell: R = L1(L1(exp(-dist/sigma)) * penalty); one warp per column
  float kerr = 0.f, ent = 0.f;
  for (int t = w; t < nv; t += kWarps) {
    const bool pad = gcs[t] < 0;  // every covariate's code of a pad is -1
    float s1 = 0.f;
    for (int k = lane; k < K; k += 32) s1 += expf(-Ls[k * TP + t] / sig[k]);
    s1 = warp_sum(s1);
    const float s1g = s1 == 0.f ? 1.f : s1;
    float s2 = 0.f;
    for (int k = lane; k < K; k += 32) {
      float pc = pad ? 0.f : pens[k * B + gcs[t]];
      for (int c = 1; c < ncov && !pad; ++c) pc += pens[k * B + gcs[c * T + t]];
      s2 += (expf(-Ls[k * TP + t] / sig[k]) / s1g) * pc;
    }
    s2 = warp_sum(s2);
    const float s2g = s2 == 0.f ? 1.f : s2;
    for (int k = lane; k < K; k += 32) {
      float pc = pad ? 0.f : pens[k * B + gcs[t]];
      for (int c = 1; c < ncov && !pad; ++c) pc += pens[k * B + gcs[c * T + t]];
      const float dist = Ls[k * TP + t];
      const float r = ((expf(-dist / sig[k]) / s1g) * pc) / s2g;
      kerr += r * dist;
      ent += sig[k] * (r > 0.f ? r * logf(r) : 0.f);
      Ls[k * TP + t] = r;
    }
  }
  kerr = warp_sum(kerr);
  ent = warp_sum(ent);
  if (lane == 0) {
    red[w] = kerr;
    red[kWarps + w] = ent;
  }
  __syncthreads();

  // row pass: each thread owns cluster rows, so no two threads share a sum
  float* prow = part + static_cast<long long>(blockIdx.x) * P;
  for (int k = tid; k < K; k += kThreads) {
    float rs = 0.f;
    for (int t = 0; t < nv; ++t) {
      const float r = Ls[k * TP + t];
      rs += r;
      if (gcs[t] < 0) continue;
      for (int c = 0; c < ncov; ++c) Obs[k * B + gcs[c * T + t]] += r;
    }
    prow[k] = rs;
  }
  for (int i = tid; i < K * T; i += kThreads) {
    const int k = i / T, t = i - k * T;
    if (t < nv) R[k * L + base + t] = Ls[k * TP + t];
  }
  __syncthreads();
  for (int i = tid; i < K * B; i += kThreads) prow[K + i] = Obs[i];
  if (tid == 0) {
    float a = 0.f, b = 0.f;
    for (int i = 0; i < kWarps; ++i) {
      a += red[i];
      b += red[kWarps + i];
    }
    prow[P - 2] = a;
    prow[P - 1] = b;
  }
}

// K12's table of old statistics: one row [row sums K | batch sums K*B] per
// span of `span` cells of the old R (spans never cross a schedule tile).
// Each thread owns cluster rows and walks the staged cells in order.
__global__ void __launch_bounds__(kThreads) old_stats_kernel(
    const float* __restrict__ R,       // (K, L) the round's input R
    const int* __restrict__ gcodes,    // (ncov, L) global batch rows; -1 pads
    float* __restrict__ old,           // (L / span, P) out
    long long L, int span, int K, int B, int ncov) {
  extern __shared__ float smem[];
  constexpr int kCT = 64;  // cells staged at a time
  const int P = K + K * B + 2;
  float* Rs = smem;                // K*(kCT+1)
  float* Obs = Rs + K * (kCT + 1);  // K*B
  float* rsum = Obs + K * B;        // K
  int* gcs = reinterpret_cast<int*>(rsum + K);  // ncov*kCT
  const int tid = threadIdx.x;
  const long long c0 = static_cast<long long>(blockIdx.x) * span;
  for (int i = tid; i < K * B; i += kThreads) Obs[i] = 0.f;
  for (int i = tid; i < K; i += kThreads) rsum[i] = 0.f;
  for (int p = 0; p < span; p += kCT) {
    __syncthreads();
    for (int i = tid; i < K * kCT; i += kThreads) {
      const int k = i / kCT, t = i - k * kCT;
      Rs[k * (kCT + 1) + t] = R[k * L + c0 + p + t];
    }
    for (int i = tid; i < ncov * kCT; i += kThreads) {
      const int c = i / kCT, t = i - c * kCT;
      gcs[i] = gcodes[c * L + c0 + p + t];
    }
    __syncthreads();
    for (int k = tid; k < K; k += kThreads) {
      float rs = rsum[k];
      for (int t = 0; t < kCT; ++t) {
        const float r = Rs[k * (kCT + 1) + t];
        rs += r;
        if (gcs[t] < 0) continue;
        for (int c = 0; c < ncov; ++c) Obs[k * B + gcs[c * kCT + t]] += r;
      }
      rsum[k] = rs;
    }
  }
  __syncthreads();
  float* row = old + static_cast<long long>(blockIdx.x) * P;
  for (int i = tid; i < K; i += kThreads) row[i] = rsum[i];
  for (int i = tid; i < K * B; i += kThreads) row[K + i] = Obs[i];
}

// fin[j] (j < nE) = the sum over rows (row0 + i) mod wrap, i < nrows, of the
// P-wide table `tab` at cluster row k's column for j: batch sum j (j < B),
// row sum (j == B), k-means error and entropy (j > B). Each warp slice sums
// every kSlices-th row, then the slices are summed in order: a fixed order.
__device__ void fold_rows(const float* __restrict__ tab, int row0, int nrows,
                          int wrap, int k, int K, int B, int nE, float* buf,
                          float* fin) {
  const int P = K + K * B + 2;
  const int tid = threadIdx.x, lane = tid & 31, s = tid >> 5;
  for (int j = lane; j < nE; j += 32) {
    const int src = j < B ? K + k * B + j : (j == B ? k : P - 2 + (j - B - 1));
    float v = 0.f;
    for (int i = s; i < nrows; i += kSlices)
      v += tab[static_cast<long long>((row0 + i) % wrap) * P + src];
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

// One CTA per cluster row k. add: fold the block's partials into E/O (and,
// on row 0, the k-means error and entropy into acc); nold > 0: remove the
// next block's old contribution, rows (old0 + i) mod wrap (i < nold) of
// the table `old`; always: write the penalty table row.
__global__ void __launch_bounds__(kThreads) commit_kernel(
    const float* __restrict__ part, int ncta, float* __restrict__ E,
    float* __restrict__ O, const float* __restrict__ old, int old0, int nold,
    int wrap, const float* __restrict__ Pr, const float* __restrict__ theta,
    float* __restrict__ pen, float* __restrict__ acc, int K, int B, int add) {
  extern __shared__ float buf[];  // kSlices * (B+3), then two finals
  const int k = blockIdx.x;
  const int nE = B + 1 + (k == 0 ? 2 : 0);
  float* fin = buf + kSlices * (B + 3);
  float* fin_old = fin + B + 3;
  if (add) fold_rows(part, 0, ncta, max(ncta, 1), k, K, B, nE, buf, fin);
  if (nold > 0) fold_rows(old, old0, nold, wrap, k, K, B, B + 1, buf, fin_old);
  const int tid = threadIdx.x;
  for (int b = tid; b < B; b += kThreads) {
    const int i = k * B + b;
    float e = E[i], o = O[i];
    if (add) {
      e = e + fin[B] * Pr[b];
      o = o + fin[b];
    }
    if (nold > 0) {
      e = e - fin_old[B] * Pr[b];
      o = o - fin_old[b];
    }
    E[i] = e;
    O[i] = o;
    pen[i] = powf((2.f * e + 1.f) / (o + e + 1.f), theta[b]);
  }
  if (add && k == 0 && tid == 0) {
    acc[0] += fin[B + 1];
    acc[1] += fin[B + 2];
  }
}

}  // namespace

extern "C" {

int k1_assign(const void* Yt, const void* Z, const void* gcodes,
              const void* pen, const void* sigma, void* R, void* part,
              long long L, long long cell0, int ncells, int K, int d, int B,
              int ncov, int T, int tileT, int NT, int v0, int smem_bytes,
              void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (ncells + T - 1) / T;
  assign_kernel<<<grid, kThreads, smem_bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Yt), static_cast<const float*>(Z),
      static_cast<const int*>(gcodes), static_cast<const float*>(pen),
      static_cast<const float*>(sigma), static_cast<float*>(R),
      static_cast<float*>(part), L, cell0, ncells, K, d, B, ncov, T, tileT,
      NT, v0);
  return static_cast<int>(cudaGetLastError());
}

int k1_commit(const void* part, int ncta, void* E, void* O, const void* old,
              int old0, int nold, int wrap, const void* Pr, const void* theta,
              void* pen, void* acc, int K, int B, int add, void* stream) {
  const int smem_bytes = (kSlices + 2) * (B + 3) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      commit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  commit_kernel<<<K, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), ncta, static_cast<float*>(E),
      static_cast<float*>(O), static_cast<const float*>(old), old0, nold, wrap,
      static_cast<const float*>(Pr), static_cast<const float*>(theta),
      static_cast<float*>(pen), static_cast<float*>(acc), K, B, add);
  return static_cast<int>(cudaGetLastError());
}

int k12_old_stats(const void* R, const void* gcodes, void* old, long long L,
                  int span, int K, int B, int ncov, int smem_bytes,
                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      old_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  old_stats_kernel<<<static_cast<int>(L / span), kThreads, smem_bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R), static_cast<const int*>(gcodes),
      static_cast<float*>(old), L, span, K, B, ncov);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
