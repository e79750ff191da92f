// K6 and K7: the rotate schedule's re-entry and its stats-carrying round,
// hand-written for Hopper (sm_90a).
//
// K6 replaces harmony_tpu/ops/pallas_rotate.py _reassign_kernel (:1261),
// reached through pallas_reassign (:1354): per cell tile it L2-normalises
// the corrected embedding, recomputes R = colnorm(exp((Y^T Z - 1) 2/sigma))
// on valid cells and contracts R against the design into the per-tile
// table tile_O (NT, K, B); O is the fixed-order sum of the table and E its
// covariate-0 row sums times Pr_b. R itself is never written.
// Bound on this card at N_pad = 503,808, d = 50, K = 100, B = 10: Z read
// once and Zn written once (0.2 GB, 60 us at 3.35 TB/s); Y^T Z is
// 2*K*d*N = 5 GFLOP of fp32 FMA (75 us at 67 TFLOP/s): operations-bound.
//
// K7 replaces harmony_tpu/ops/pallas_rotate.py _round_kernel_v2 (:594),
// reached through pallas_rotate_update_round_v2 (:851), in its fused_vpu
// op order (_assign_tile :403): one stats-carrying round. Per block (a run
// of whole tiles, rotated mod NT) it removes the block's old O/E, taken
// from the previous round's tile table and never from R, builds the
// block-constant penalty ((2E+1)/(O+E+1))^theta, assigns each cell
//   w = exp((g - 1) 2/sigma) * pen[code],  R = w * (1 / colsum(w)),
// emits the block's per-tile table, the k-means error 2 n - 2 sum R g and
// the entropy (factorised for one covariate, pallas_rotate.py:781-805;
// sum sigma R log R otherwise), and commits the block. R is written only
// when asked (the phase's last round). Bound: the same 5 GFLOP as K6
// (75 us); bytes are Z read once (0.1 GB) plus R written once on the round
// that writes it (0.2 GB, 90 us then).
//
// Design. On the TPU the round was one sequential grid with E/O in VMEM.
// Here, as in estep_round.cu (K1), blocks are sequential and a block's
// cells are independent, so a round is a host loop over the blocks with
// two launches each:
//   (a) rot_assign over the block's cells, one 64-cell CTA each (a tile
//       of T cells is T/64 CTAs). A CTA stages Y^T, its Z columns and the
//       penalty tables in shared memory, forms g = Y^T Z with register
//       tiles, then per cell (one warp a column) the exp, the guarded
//       normalise and the objective terms, and per cluster row the
//       (K x B) design contraction. It writes R (if asked) and a partials
//       row [tO (K*B) | k-means error | entropy].
//   (b) rot_commit, one CTA per cluster row, folds the partials of each
//       tile in a fixed order into tile_O and the block's new O/E, removes
//       the next block's old O (a fixed-order sum over its tiles of the
//       previous table) and writes the next penalty tables. No float
//       atomics anywhere, so repeated runs give the same trajectory.
// K6 is (a) without the penalty, plus a reduction kernel that builds
// tile_O, O and E.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 8;   // cluster rows per thread in the product
constexpr int kCT = 64;  // cells per CTA
constexpr int kTP = kCT + 1;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Ls[k * kTP + t] = sum_e Ys[k, e] Zs[e, t] for the CTA's 64 cells: lane ->
// cells (lane, lane+32), warp -> 8 cluster rows at a time.
__device__ __forceinline__ void gram(const float* Ys, const float* Zs,
                                     float* Ls, int K, int d) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int kc = w * kKC; kc < K; kc += kWarps * kKC) {
    float a0[kKC], a1[kKC];
#pragma unroll
    for (int j = 0; j < kKC; ++j) a0[j] = a1[j] = 0.f;
    for (int e = 0; e < d; ++e) {
      const float z0 = Zs[e * kCT + lane];
      const float z1 = Zs[e * kCT + lane + 32];
#pragma unroll
      for (int j = 0; j < kKC; ++j) {
        const float y = Ys[min(kc + j, K - 1) * d + e];
        a0[j] = fmaf(y, z0, a0[j]);
        a1[j] = fmaf(y, z1, a1[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kKC; ++j) {
      if (kc + j < K) {
        Ls[(kc + j) * kTP + lane] = a0[j];
        Ls[(kc + j) * kTP + lane + 32] = a1[j];
      }
    }
  }
}

// Per cluster row: the CTA's (K x B) design contraction into Obs, then the
// partials row (tO first) and, if R is given, the assignments.
__device__ __forceinline__ void tile_stats(const float* Ls, const int* gcs,
                                           float* Obs, float* prow, float* R,
                                           long long L, long long base, int K,
                                           int B, int ncov) {
  const int tid = threadIdx.x;
  for (int k = tid; k < K; k += kThreads) {
    for (int t = 0; t < kCT; ++t) {
      const float r = Ls[k * kTP + t];
      for (int c = 0; c < ncov; ++c) {
        const int gc = gcs[c * kCT + t];
        if (gc >= 0) Obs[k * B + gc] += r;
      }
    }
  }
  if (R != nullptr) {
    for (int i = tid; i < K * kCT; i += kThreads) {
      const int k = i / kCT, t = i - k * kCT;
      R[k * L + base + t] = Ls[k * kTP + t];
    }
  }
  __syncthreads();
  for (int i = tid; i < K * B; i += kThreads) prow[i] = Obs[i];
}

// Stages the CTA's cells: Z columns into Zs, global batch rows (code +
// covariate offset, -1 on pad cells) into gcs.
__device__ __forceinline__ void stage_cells(const float* Z, const int* codes,
                                            const int* offsets, float* Zs,
                                            int* gcs, long long L,
                                            long long base, int d, int ncov) {
  for (int i = threadIdx.x; i < d * kCT; i += kThreads) {
    const int e = i / kCT, t = i - e * kCT;
    Zs[i] = Z[e * L + base + t];
  }
  for (int i = threadIdx.x; i < ncov * kCT; i += kThreads) {
    const int c = i / kCT, t = i - c * kCT;
    const int code = codes[c * L + base + t];
    gcs[i] = code >= 0 ? code + offsets[c] : -1;
  }
}

// ---- K7 ---------------------------------------------------------------

// The block's CTA c covers cells [p*T + (c % cpt)*64, +64) of physical tile
// p = (v0 + c / cpt) mod NT, cpt = T / 64.
__global__ void __launch_bounds__(kThreads) rot_assign_kernel(
    const float* __restrict__ Yt,      // (K, d)
    const float* __restrict__ Z,       // (d, L) normalised, padded layout
    const int* __restrict__ codes,     // (ncov, L), pads < 0
    const int* __restrict__ offsets,   // (ncov,)
    const float* __restrict__ pen,     // (K, B) block-removed penalty
    const float* __restrict__ logpen,  // (K, B) theta * log(ratio)
    const float* __restrict__ sigma,   // (K,)
    float* __restrict__ R,             // (K, L) out, or null
    float* __restrict__ part,          // (n_cta, K*B + 2) out
    long long L, int v0, int NT, int cpt, int K, int d, int B, int ncov) {
  extern __shared__ float smem[];
  float* Ys = smem;             // K*d
  float* Zs = Ys + K * d;       // d*kCT
  float* Ls = Zs + d * kCT;     // K*kTP: g, then w, then R
  float* pens = Ls + K * kTP;   // K*B
  float* lps = pens + K * B;    // K*B
  float* sig = lps + K * B;     // K
  float* i2s = sig + K;         // K
  float* Obs = i2s + K;         // K*B
  float* red = Obs + K * B;     // 2*kWarps
  int* gcs = reinterpret_cast<int*>(red + 2 * kWarps);  // ncov*kCT

  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int j = blockIdx.x / cpt, q = blockIdx.x - j * cpt;
  const long long p = (v0 + j) % NT;
  const long long base = p * cpt * kCT + static_cast<long long>(q) * kCT;
  const int P = K * B + 2;

  for (int i = tid; i < K * d; i += kThreads) Ys[i] = Yt[i];
  for (int i = tid; i < K * B; i += kThreads) {
    pens[i] = pen[i];
    lps[i] = logpen[i];
    Obs[i] = 0.f;
  }
  for (int i = tid; i < K; i += kThreads) {
    sig[i] = sigma[i];
    i2s[i] = 2.f / sigma[i];
  }
  stage_cells(Z, codes, offsets, Zs, gcs, L, base, d, ncov);
  __syncthreads();
  gram(Ys, Zs, Ls, K, d);
  __syncthreads();

  // per cell: w = exp((g-1) 2/sigma) * pen[code]; R = w * (1/colsum(w))
  float kerr = 0.f, ent = 0.f;
  for (int t = w; t < kCT; t += kWarps) {
    float cs = 0.f, swg = 0.f, sws = 0.f, swl = 0.f;
    for (int k = lane; k < K; k += 32) {
      float pc = 0.f;
      for (int c = 0; c < ncov; ++c) {
        const int gc = gcs[c * kCT + t];
        if (gc >= 0) pc += pens[k * B + gc];
      }
      const float g = Ls[k * kTP + t];
      const float wv = expf((g - 1.f) * i2s[k]) * pc;
      cs += wv;
      swg += wv * g;
      if (ncov == 1 && gcs[t] >= 0) {
        sws += sig[k] * wv;
        swl += sig[k] * wv * lps[k * B + gcs[t]];
      }
      Ls[k * kTP + t] = wv;
    }
    cs = warp_sum(cs);
    swg = warp_sum(swg);
    const float csg = cs == 0.f ? 1.f : cs;
    const float inv = 1.f / csg;
    float sr = 0.f, sxl = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float r = Ls[k * kTP + t] * inv;
      sr += r;
      if (ncov > 1) sxl += sig[k] * (r > 0.f ? r * logf(r) : 0.f);
      Ls[k * kTP + t] = r;
    }
    sr = warp_sum(sr);
    // k-means error as 2 sum R - 2 sum R g (pallas_rotate.py:776-779)
    const float s_rd = 2.f * sr - 2.f * (swg * inv);
    kerr += s_rd;
    if (ncov == 1) {
      sws = warp_sum(sws);
      swl = warp_sum(swl);
      ent += -s_rd - logf(csg) * (sws * inv) + swl * inv;
    } else {
      ent += warp_sum(sxl);
    }
  }
  if (lane == 0) {
    red[w] = kerr;
    red[kWarps + w] = ent;
  }
  __syncthreads();
  float* prow = part + static_cast<long long>(blockIdx.x) * P;
  tile_stats(Ls, gcs, Obs, prow, R, L, base, K, B, ncov);
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

// One CTA per cluster row k. add: fold the block's partials (ntile tiles of
// cpt CTAs, physical tiles (v0 + j) mod NT) into tile_O and E/O, and on row
// 0 the objective terms into acc; rm_n > 0: remove the old O of the block
// of tiles (rm_v0 + j) mod NT, j < rm_n, summed from the previous table
// tO_old; always: write the penalty tables. E/O are read from E_in/O_in
// and written to E/O (the first commit of a round copies them). The tile
// sums are read back from tO_new after the barrier, which makes the CTA's
// global writes visible to all its threads.
__global__ void __launch_bounds__(kThreads) rot_commit_kernel(
    const float* __restrict__ part, int add, int v0, int ntile, int cpt,
    int NT, float* tO_new, const float* __restrict__ tO_old, int rm_v0,
    int rm_n, const float* E_in, const float* O_in, float* E, float* O,
    const float* __restrict__ Pr, const float* __restrict__ theta,
    float* __restrict__ pen, float* __restrict__ logpen,
    float* __restrict__ acc, int zero_acc, int K, int B, int b0) {
  extern __shared__ float buf[];  // B block sums, B removal, 2*ntile objective
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
    pen[i] = powf(ratio, theta[b]);
    logpen[i] = logf(ratio) * theta[b];
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

// CTA c covers cells [c*64, +64) of the padded layout.
__global__ void __launch_bounds__(kThreads) reassign_assign_kernel(
    const float* __restrict__ Yt,     // (K, d)
    const float* __restrict__ Z,      // (d, L) raw corrected embedding
    const int* __restrict__ codes,    // (ncov, L), pads < 0
    const int* __restrict__ offsets,  // (ncov,)
    const float* __restrict__ sigma,  // (K,)
    float* __restrict__ Zn,           // (d, L) out, L2-normalised columns
    float* __restrict__ part,         // (L/64, K*B) out
    long long L, int K, int d, int B, int ncov) {
  extern __shared__ float smem[];
  float* Ys = smem;            // K*d
  float* Zs = Ys + K * d;      // d*kCT
  float* Ls = Zs + d * kCT;    // K*kTP
  float* i2s = Ls + K * kTP;   // K
  float* Obs = i2s + K;        // K*B
  float* nrm = Obs + K * B;    // kCT
  int* gcs = reinterpret_cast<int*>(nrm + kCT);  // ncov*kCT

  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kCT;

  for (int i = tid; i < K * d; i += kThreads) Ys[i] = Yt[i];
  for (int i = tid; i < K * B; i += kThreads) Obs[i] = 0.f;
  for (int i = tid; i < K; i += kThreads) i2s[i] = 2.f / sigma[i];
  stage_cells(Z, codes, offsets, Zs, gcs, L, base, d, ncov);
  __syncthreads();
  // column norms; zero columns (pads) stay zero (src/harmony.cpp:220)
  for (int t = w; t < kCT; t += kWarps) {
    float s = 0.f;
    for (int e = lane; e < d; e += 32) s += Zs[e * kCT + t] * Zs[e * kCT + t];
    s = warp_sum(s);
    if (lane == 0) {
      const float n = sqrtf(s);
      nrm[t] = n == 0.f ? 1.f : n;
    }
  }
  __syncthreads();
  for (int i = tid; i < d * kCT; i += kThreads) {
    const int e = i / kCT, t = i - e * kCT;
    const float z = Zs[i] / nrm[t];
    Zs[i] = z;
    Zn[e * L + base + t] = z;
  }
  __syncthreads();
  gram(Ys, Zs, Ls, K, d);
  __syncthreads();
  for (int t = w; t < kCT; t += kWarps) {
    const float valid = gcs[t] >= 0 ? 1.f : 0.f;
    float cs = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float v = expf((Ls[k * kTP + t] - 1.f) * i2s[k]) * valid;
      cs += v;
      Ls[k * kTP + t] = v;
    }
    cs = warp_sum(cs);
    const float inv = 1.f / (cs == 0.f ? 1.f : cs);
    for (int k = lane; k < K; k += 32) Ls[k * kTP + t] *= inv;
  }
  __syncthreads();
  tile_stats(Ls, gcs, Obs, part + static_cast<long long>(blockIdx.x) * K * B,
             nullptr, L, base, K, B, ncov);
}

// One CTA per cluster row k: tile_O[p, k, :] = fixed-order sum of the cpt
// CTA partials of tile p; O[k, :] = sum over p in order, read back after
// the barrier; E[k, :] = (sum of O[k, :b0]) * Pr.
__global__ void __launch_bounds__(kThreads) reassign_reduce_kernel(
    const float* __restrict__ part, int NT, int cpt, float* tO, float* O,
    float* __restrict__ E, const float* __restrict__ Pr, int K, int B,
    int b0) {
  extern __shared__ float fin[];  // B
  const int k = blockIdx.x, tid = threadIdx.x;
  for (int i = tid; i < NT * B; i += kThreads) {
    const int p = i / B, b = i - p * B;
    const long long row0 = static_cast<long long>(p) * cpt;
    float v = 0.f;
    for (int c = 0; c < cpt; ++c) v += part[(row0 + c) * K * B + k * B + b];
    tO[(static_cast<long long>(p) * K + k) * B + b] = v;
  }
  __syncthreads();
  for (int b = tid; b < B; b += kThreads) {
    float v = 0.f;
    for (int p = 0; p < NT; ++p) v += tO[(static_cast<long long>(p) * K + k) * B + b];
    fin[b] = v;
    O[k * B + b] = v;
  }
  __syncthreads();
  float rs = 0.f;
  for (int b = 0; b < b0; ++b) rs += fin[b];
  for (int b = tid; b < B; b += kThreads) E[k * B + b] = rs * Pr[b];
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

extern "C" {

int k7_assign(const void* Yt, const void* Z, const void* codes,
              const void* offsets, const void* pen, const void* logpen,
              const void* sigma, void* R, void* part, long long L, int v0,
              int ntile, int NT, int cpt, int K, int d, int B, int ncov,
              int smem_bytes, void* stream) {
  int err = set_smem(reinterpret_cast<const void*>(rot_assign_kernel), smem_bytes);
  if (err) return err;
  rot_assign_kernel<<<ntile * cpt, kThreads, smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Yt), static_cast<const float*>(Z),
      static_cast<const int*>(codes), static_cast<const int*>(offsets),
      static_cast<const float*>(pen), static_cast<const float*>(logpen),
      static_cast<const float*>(sigma), static_cast<float*>(R),
      static_cast<float*>(part), L, v0, NT, cpt, K, d, B, ncov);
  return static_cast<int>(cudaGetLastError());
}

int k7_commit(const void* part, int add, int v0, int ntile, int cpt, int NT,
              void* tO_new, const void* tO_old, int rm_v0, int rm_n,
              const void* E_in, const void* O_in, void* E, void* O,
              const void* Pr, const void* theta, void* pen, void* logpen,
              void* acc, int zero_acc, int K, int B, int b0, void* stream) {
  const int smem_bytes = (2 * B + 2 * ntile) * static_cast<int>(sizeof(float));
  int err = set_smem(reinterpret_cast<const void*>(rot_commit_kernel), smem_bytes);
  if (err) return err;
  rot_commit_kernel<<<K, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), add, v0, ntile, cpt, NT,
      static_cast<float*>(tO_new), static_cast<const float*>(tO_old), rm_v0,
      rm_n, static_cast<const float*>(E_in), static_cast<const float*>(O_in),
      static_cast<float*>(E), static_cast<float*>(O),
      static_cast<const float*>(Pr), static_cast<const float*>(theta),
      static_cast<float*>(pen), static_cast<float*>(logpen),
      static_cast<float*>(acc), zero_acc, K, B, b0);
  return static_cast<int>(cudaGetLastError());
}

int k6_reassign(const void* Yt, const void* Z, const void* codes,
                const void* offsets, const void* sigma, const void* Pr,
                void* Zn, void* part, void* tO, void* O, void* E, long long L,
                int NT, int K, int d, int B, int ncov, int b0, int smem_bytes,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = set_smem(reinterpret_cast<const void*>(reassign_assign_kernel), smem_bytes);
  if (err) return err;
  const int ncta = static_cast<int>(L / kCT);
  reassign_assign_kernel<<<ncta, kThreads, smem_bytes, st>>>(
      static_cast<const float*>(Yt), static_cast<const float*>(Z),
      static_cast<const int*>(codes), static_cast<const int*>(offsets),
      static_cast<const float*>(sigma), static_cast<float*>(Zn),
      static_cast<float*>(part), L, K, d, B, ncov);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int red_bytes = B * static_cast<int>(sizeof(float));
  err = set_smem(reinterpret_cast<const void*>(reassign_reduce_kernel), red_bytes);
  if (err) return err;
  reassign_reduce_kernel<<<K, kThreads, red_bytes, st>>>(
      static_cast<const float*>(part), NT, ncta / NT, static_cast<float*>(tO),
      static_cast<float*>(O), static_cast<float*>(E),
      static_cast<const float*>(Pr), K, B, b0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
