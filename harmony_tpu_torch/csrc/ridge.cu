// K4 and K5: the single-covariate M-step contractions (moe_correct_ridge,
// src/harmony.cpp:345-638), hand-written for Hopper (sm_90a).
//
// K4 replaces harmony_tpu/ops/pallas_ridge.py _moments_kernel (:41), reached
// through pallas_moments (:66): M[k, b, e] = sum_n R[k,n] [code(n)==b]
// [Z;1][e,n], the O row last (e = d).
// Bound on this card: R and Z read once, 0.3 GB at N = 500k, d = 50,
// K = 100 (90 us at 3.35 TB/s); 2*K*(d+1)*N = 5.1 GFLOP of fp32 FMA (76 us
// at 67 TFLOP/s). Design: CTAs tile (KT cluster rows x a contiguous cell
// range). A CTA stages (KT x 64)-cell tiles of R and (d+1 x 64) of [Z;1] in
// shared memory; each thread owns (row, column) pairs of the (KT, d+1)
// block and adds each cell's product into the accumulator row of that
// cell's batch, picked by its int32 code, not by a one-hot column. Pairs are
// owned, so there are no atomics. Partials per cell range go to a scratch
// buffer and a second launch sums them in a fixed order. Cluster tiles vary
// fastest in the grid, so the tiles that share a cell range run together and
// read Z from L2 after the first.
//
// K5 replaces harmony_tpu/ops/pallas_ridge.py _correction_kernel (:382),
// reached through pallas_correction (:394):
//   Z_corr[:, n] = Z[:, n] - sum_k R[k,n] W[k, code(n), :].
// Bound on this card: R and Z read once, Z_corr written once, 0.4 GB at the
// main shape (120 us at 3.35 TB/s); K*d*N = 2.5 GFLOP of FMA. Design: one
// CTA per 64-cell tile stages R and Z in shared memory; each thread owns
// (cell, dim) outputs with lanes along the dim, so the reads of W
// (K x B x d, 200 KB at the main shape, which L2 holds) are coalesced. There
// is no (B*d, K) x (K, T) product and no select by one-hot: each cell reads
// only its own batch's betas.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCT = 64;  // cells per staged tile
constexpr int kCTP = kCT + 1;

__global__ void __launch_bounds__(kThreads) moments_partial_kernel(
    const float* __restrict__ R,      // (K, N)
    const float* __restrict__ Z,      // (d, N)
    const int* __restrict__ codes,    // (N,) in [0, B)
    float* __restrict__ part,         // (NS, K, B, d+1)
    long long N, int K, int d, int B, int KT, long long chunk) {
  extern __shared__ float smem[];
  const int d1 = d + 1;
  float* Ms = smem;                 // B * KT * d1
  float* Rs = Ms + B * KT * d1;     // KT * kCTP
  float* Zs = Rs + KT * kCTP;       // d1 * kCTP
  int* cs = reinterpret_cast<int*>(Zs + d1 * kCTP);  // kCT
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * KT;
  const int kt = min(KT, K - k0);
  const long long n_begin = blockIdx.y * chunk;
  const long long n_end = min(N, n_begin + chunk);

  for (int i = tid; i < B * KT * d1; i += kThreads) Ms[i] = 0.f;
  for (long long n0 = n_begin; n0 < n_end; n0 += kCT) {
    const int nv = static_cast<int>(min(static_cast<long long>(kCT), n_end - n0));
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < KT * kCT; i += kThreads) {
      const int kk = i / kCT, t = i - kk * kCT;
      Rs[kk * kCTP + t] = (kk < kt && t < nv) ? R[(k0 + kk) * N + n0 + t] : 0.f;
    }
    for (int i = tid; i < d1 * kCT; i += kThreads) {
      const int e = i / kCT, t = i - e * kCT;
      Zs[e * kCTP + t] = t < nv ? (e < d ? Z[e * N + n0 + t] : 1.f) : 0.f;
    }
    for (int t = tid; t < kCT; t += kThreads) cs[t] = t < nv ? codes[n0 + t] : 0;
    __syncthreads();
    for (int p = tid; p < kt * d1; p += kThreads) {
      const int kk = p / d1, e = p - kk * d1;
      const float* rrow = Rs + kk * kCTP;
      const float* zrow = Zs + e * kCTP;
      float* mcol = Ms + kk * d1 + e;
      for (int t = 0; t < nv; ++t)
        mcol[cs[t] * KT * d1] = fmaf(rrow[t], zrow[t], mcol[cs[t] * KT * d1]);
    }
  }
  __syncthreads();
  float* out = part + static_cast<long long>(blockIdx.y) * K * B * d1;
  for (int i = tid; i < B * kt * d1; i += kThreads) {
    const int b = i / (kt * d1), r = i - b * kt * d1;
    const int kk = r / d1, e = r - kk * d1;
    out[(static_cast<long long>(k0 + kk) * B + b) * d1 + e] =
        Ms[(b * KT + kk) * d1 + e];
  }
}

__global__ void __launch_bounds__(kThreads) sum_partials_kernel(
    const float* __restrict__ part, float* __restrict__ M, int NS,
    long long n) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int s = 0; s < NS; ++s) v += part[s * n + i];
  M[i] = v;
}

__global__ void __launch_bounds__(kThreads) correction_kernel(
    const float* __restrict__ W,      // (K, B, d)
    const float* __restrict__ R,      // (K, N)
    const float* __restrict__ Z,      // (d, N)
    const int* __restrict__ codes,    // (N,)
    float* __restrict__ Zc,           // (d, N) out
    long long N, int K, int d, int B) {
  extern __shared__ float smem[];
  float* Rs = smem;              // K * kCTP
  float* Zs = Rs + K * kCTP;     // d * kCTP
  int* cs = reinterpret_cast<int*>(Zs + d * kCTP);
  const int tid = threadIdx.x;
  const long long n0 = static_cast<long long>(blockIdx.x) * kCT;
  const int nv = static_cast<int>(min(static_cast<long long>(kCT), N - n0));
  for (int i = tid; i < K * kCT; i += kThreads) {
    const int k = i / kCT, t = i - k * kCT;
    Rs[k * kCTP + t] = t < nv ? R[k * N + n0 + t] : 0.f;
  }
  for (int i = tid; i < d * kCT; i += kThreads) {
    const int e = i / kCT, t = i - e * kCT;
    Zs[e * kCTP + t] = t < nv ? Z[e * N + n0 + t] : 0.f;
  }
  for (int t = tid; t < kCT; t += kThreads) cs[t] = t < nv ? codes[n0 + t] : 0;
  __syncthreads();
  for (int p = tid; p < nv * d; p += kThreads) {
    const int t = p / d, e = p - t * d;
    const float* wcol = W + static_cast<long long>(cs[t]) * d + e;
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc = fmaf(Rs[k * kCTP + t], __ldg(wcol + static_cast<long long>(k) * B * d), acc);
    Zs[e * kCTP + t] = Zs[e * kCTP + t] - acc;
  }
  __syncthreads();
  for (int i = tid; i < d * kCT; i += kThreads) {
    const int e = i / kCT, t = i - e * kCT;
    if (t < nv) Zc[e * N + n0 + t] = Zs[e * kCTP + t];
  }
}

}  // namespace

extern "C" {

int k4_moments(const void* R, const void* Z, const void* codes, void* part,
               void* M, long long N, int K, int d, int B, int KT, int NS,
               long long chunk, int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      moments_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((K + KT - 1) / KT, NS);
  moments_partial_kernel<<<grid, kThreads, smem_bytes, st>>>(
      static_cast<const float*>(R), static_cast<const float*>(Z),
      static_cast<const int*>(codes), static_cast<float*>(part), N, K, d, B,
      KT, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(K) * B * (d + 1);
  sum_partials_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                        kThreads, 0, st>>>(static_cast<const float*>(part),
                                           static_cast<float*>(M), NS, n);
  return static_cast<int>(cudaGetLastError());
}

int k5_correction(const void* W, const void* R, const void* Z,
                  const void* codes, void* Zc, long long N, int K, int d,
                  int B, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      correction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((N + kCT - 1) / kCT);
  correction_kernel<<<grid, kThreads, smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(R),
      static_cast<const float*>(Z), static_cast<const int*>(codes),
      static_cast<float*>(Zc), N, K, d, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
