// K8 and K9: the batch-tiled M-step contractions (harmony_tpu/ops/ridge.py
// _moments_tiled and _correction_tiled), hand-written for Hopper (sm_90a).
// A batch-tiled cell order (ops/tiled.py) makes every layout tile of
// `tile` cells pure in its joint batch level, so the moments and the
// correction lose their factor B: one (K x tile) x (tile x d) product per
// tile, routed by the static tile -> joint table.
//
// K8 replaces harmony_tpu/ops/pallas_ridge.py _tile_moments_kernel (:109),
// reached through pallas_tile_moments (:143):
//   M[j] = sum over tiles t of joint j of [R_t Z_t^T | R_t 1], j = n_joint
//   collecting the mixed/pad tiles.
// Bound on this card at N = 503,808, d = 50, K = 100: R and Z read once,
// 0.3 GB (90 us at 3.35 TB/s); 2*K*(d+1)*N = 5.1 GFLOP of fp32 FMA (77 us
// at 67 TFLOP/s): bytes-bound. Design: the TPU accumulated every tile into
// its joint's slot in VMEM along a sequential grid. Here the host groups
// each joint's tiles into chunks of kChunk tiles (a static plan); one CTA
// per (chunk, cluster slice) accumulates the chunk's (KS x d+1) moments in
// registers, each thread owning up to kMaxMT 4x4 register tiles fed by
// 16-byte shared-memory loads of the staged R and [Z;1] columns, and
// writes them to a partials row. A second launch sums each joint's chunks
// in order. No atomics, so the result is the same on every run.
//
// K9 replaces harmony_tpu/ops/pallas_ridge.py _tiled_correction_kernel
// (:254), reached through pallas_tiled_correction (:275):
//   Z_corr[:, t] = Z[:, t] - W_joint[j(t)] R_t, the trash row being zero.
// Bound: R and Z read once, Z_corr written once, 0.4 GB (120 us); K*d*N
// = 2.5 GFLOP. Design: one CTA per 64 cells (a tile is tile/64 CTAs)
// stages its joint's betas (K x d, transposed) and its R columns in shared
// memory; each thread owns up to kMaxMT 4x4 (dim x cell) register tiles.
// A trash-tile CTA copies Z through.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSub = 32;   // K8: cells staged at a time
constexpr int kCT = 64;    // K9: cells per CTA
constexpr int kMaxMT = 2;  // 4x4 register tiles a thread owns

__global__ void __launch_bounds__(kThreads) tile_moments_kernel(
    const float* __restrict__ R,       // (K, N)
    const float* __restrict__ Z,       // (d, N)
    const int* __restrict__ chunks,    // (n_chunks, chunk) tile ids, -1 pad
    float* __restrict__ part,          // (n_chunks, K, d+1) out
    long long N, int K, int d, int tile, int chunk, int KS, int KSp, int d1p) {
  extern __shared__ float smem[];
  float* Rs = smem;               // kSub * KSp, cell-major
  float* Zs = Rs + kSub * KSp;    // kSub * d1p, cell-major; column d is 1
  const int tid = threadIdx.x;
  const int d1 = d + 1;
  const int k0 = blockIdx.y * KS;
  const int ks = min(KS, K - k0);
  const int nkb = (ks + 3) / 4, neb = (d1 + 3) / 4;
  float acc[kMaxMT][4][4];
#pragma unroll
  for (int m = 0; m < kMaxMT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][i][j] = 0.f;

  for (int c = 0; c < chunk; ++c) {
    const int t = chunks[static_cast<long long>(blockIdx.x) * chunk + c];
    if (t < 0) break;
    const long long n0 = static_cast<long long>(t) * tile;
    for (int s0 = 0; s0 < tile; s0 += kSub) {
      __syncthreads();  // the previous slice's readers are done
      for (int i = tid; i < kSub * KSp; i += kThreads) {
        const int k = i / kSub, u = i - k * kSub;
        const long long n = n0 + s0 + u;
        Rs[u * KSp + k] = (k < ks && n < N) ? R[(k0 + k) * N + n] : 0.f;
      }
      for (int i = tid; i < kSub * d1p; i += kThreads) {
        const int e = i / kSub, u = i - e * kSub;
        const long long n = n0 + s0 + u;
        float v = 0.f;
        if (n < N && e < d1) v = e < d ? Z[e * N + n] : 1.f;
        Zs[u * d1p + e] = v;
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kMaxMT; ++m) {
        const int mt = tid + m * kThreads;
        if (mt >= nkb * neb) break;
        const int kb = mt / neb, eb = mt - kb * neb;
        for (int u = 0; u < kSub; ++u) {
          const float4 r = *reinterpret_cast<const float4*>(Rs + u * KSp + 4 * kb);
          const float4 z = *reinterpret_cast<const float4*>(Zs + u * d1p + 4 * eb);
          const float rv[4] = {r.x, r.y, r.z, r.w};
          const float zv[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[m][i][j] = fmaf(rv[i], zv[j], acc[m][i][j]);
        }
      }
    }
  }
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
        if (k < ks && e < d1) out[(k0 + k) * d1 + e] = acc[m][i][j];
      }
  }
}

// M[j, :] = sum of the partials rows of joint j's chunks, in chunk order.
// K3 and K7 sum their moment rows with it too (sum_joint_rows).
__global__ void __launch_bounds__(kThreads) sum_chunks_kernel(
    const float* __restrict__ part, const int* __restrict__ start,
    float* __restrict__ M, int n_rows, long long row) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= n_rows * row) return;
  const int j = static_cast<int>(i / row);
  const long long r = i - j * row;
  float v = 0.f;
  for (int c = start[j]; c < start[j + 1]; ++c) v += part[c * row + r];
  M[i] = v;
}

__global__ void __launch_bounds__(kThreads) tiled_correction_kernel(
    const float* __restrict__ Wt,      // (n_joint + 1, K, d) betas, transposed
    const int* __restrict__ tj,        // (ceil(N / tile),) joint of each tile
    const float* __restrict__ R,       // (K, N)
    const float* __restrict__ Z,       // (d, N)
    float* __restrict__ Zc,            // (d, N) out
    long long N, int K, int d, int tile, int trash, int dp) {
  extern __shared__ float smem[];
  float* Ws = smem;            // K * dp
  float* Rs = Ws + K * dp;     // K * kCT
  const int tid = threadIdx.x;
  const long long n0 = static_cast<long long>(blockIdx.x) * kCT;
  const int nv = static_cast<int>(min(static_cast<long long>(kCT), N - n0));
  const int jt = tj[n0 / tile];
  if (jt == trash) {
    for (int i = tid; i < d * kCT; i += kThreads) {
      const int e = i / kCT, u = i - e * kCT;
      if (u < nv) Zc[e * N + n0 + u] = Z[e * N + n0 + u];
    }
    return;
  }
  const float* W = Wt + static_cast<long long>(jt) * K * d;
  for (int i = tid; i < K * dp; i += kThreads) {
    const int k = i / dp, e = i - k * dp;
    Ws[i] = e < d ? W[k * d + e] : 0.f;
  }
  for (int i = tid; i < K * kCT; i += kThreads) {
    const int k = i / kCT, u = i - k * kCT;
    Rs[i] = u < nv ? R[k * N + n0 + u] : 0.f;
  }
  __syncthreads();
  const int neb = (d + 3) / 4;
  constexpr int ntb = kCT / 4;
#pragma unroll
  for (int m = 0; m < kMaxMT; ++m) {
    const int mt = tid + m * kThreads;
    if (mt >= neb * ntb) break;
    const int eb = mt / ntb, tb = mt - eb * ntb;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float4 w = *reinterpret_cast<const float4*>(Ws + k * dp + 4 * eb);
      const float4 r = *reinterpret_cast<const float4*>(Rs + k * kCT + 4 * tb);
      const float wv[4] = {w.x, w.y, w.z, w.w};
      const float rv[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], rv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * eb + i;
      if (e >= d) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = 4 * tb + j;
        if (u < nv) Zc[e * N + n0 + u] = Z[e * N + n0 + u] - acc[i][j];
      }
    }
  }
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

int ceil4(int n) {
  n = (n + 3) / 4 * 4;
  return n % 32 == 0 ? n + 4 : n;
}

}  // namespace

extern "C" {

// M (n_rows, row) = per joint j the sum of rows start[j] .. start[j+1] - 1
// of part, in row order: K8's second launch, and the per-joint moment sum
// of K3 and K7.
int sum_joint_rows(const void* part, const void* start, void* M, int n_rows,
                   long long row, void* stream) {
  const long long n = n_rows * row;
  sum_chunks_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<const int*>(start),
      static_cast<float*>(M), n_rows, row);
  return static_cast<int>(cudaGetLastError());
}

int k8_tile_moments(const void* R, const void* Z, const void* chunks,
                    const void* start, void* part, void* M, long long N, int K,
                    int d, int tile, int n_chunks, int n_joint, int KS,
                    int chunk, int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0) {
    int err = set_smem(reinterpret_cast<const void*>(tile_moments_kernel), smem_bytes);
    if (err) return err;
    dim3 grid(n_chunks, (K + KS - 1) / KS);
    tile_moments_kernel<<<grid, kThreads, smem_bytes, st>>>(
        static_cast<const float*>(R), static_cast<const float*>(Z),
        static_cast<const int*>(chunks), static_cast<float*>(part), N, K, d,
        tile, chunk, KS, ceil4(KS), ceil4(d + 1));
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  return sum_joint_rows(part, start, M, n_joint + 1, static_cast<long long>(K) * (d + 1),
                        stream);
}

int k9_tiled_correction(const void* Wt, const void* tj, const void* R,
                        const void* Z, void* Zc, long long N, int K, int d,
                        int tile, int trash, int smem_bytes, void* stream) {
  int err = set_smem(reinterpret_cast<const void*>(tiled_correction_kernel), smem_bytes);
  if (err) return err;
  const unsigned grid = static_cast<unsigned>((N + kCT - 1) / kCT);
  tiled_correction_kernel<<<grid, kThreads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Wt), static_cast<const int*>(tj),
      static_cast<const float*>(R), static_cast<const float*>(Z),
      static_cast<float*>(Zc), N, K, d, tile, trash, ceil4(d));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
