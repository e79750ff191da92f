// The Lloyd rounds of the k-means centroid init (ops/kmeans.py _lloyd_round,
// src/utils.cpp:53-64), hand-written for Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package's round
// (harmony_tpu/ops/kmeans.py _lloyd_round) is a jnp.dot and a segment_sum
// that XLA fuses. The port's plain round (lloyd_round_twin) is eager
// PyTorch over 65,536-cell chunks: a product, an argmin, a (chunk, K)
// one-hot written and read back, a second product and a column sum, ten
// launches a chunk, 153 chunks a round at 10M cells.
//
// Bound on this card, one round at d = 50, K = 100: X read once, 4 d N
// bytes (2 GB at N = 10M, 0.60 ms at 3.35 TB/s; 0.1 GB at 500k, 30 us);
// 2 N K d = 1.0e11 FLOPs of fp32 FMA at 10M (1.49 ms at 67 TFLOP/s; 75 us
// at 500k). So the round is bound by its products, on the CUDA cores: no
// TF32 or 2-byte tensor-core product, X's 2-byte forms are read as they
// are stored and widened to float, as the plain round's .float() does.
//
// Design: two launches a round, nothing of size (K, N) in device memory.
//   lloyd_assign_kernel: a CTA owns a fixed, contiguous range of tiles of
//   H x 128 cells (H = 2 where it fits), set by N alone: at most 264
//   CTAs (ops/kmeans.py lloyd_grid). Y (d x K, as float) and |y_k|^2 sit
//   in shared memory; each tile of X (d x 128 H) comes in by 16-byte
//   cp.async, double-buffered where two stages fit. A warp computes 128
//   cells against 16 clusters: lane l takes the cells 4c..4c+3 and
//   64+4c..64+4c+3 (c = l mod 16) against the clusters 8g..8g+7 (g from
//   the warp and l / 16), so a dim costs two 16-byte loads of the tile
//   (16 distinct addresses, two wavefronts each), two of Y (two distinct,
//   one each) and 64 FMAs a thread. Each thread keeps its cells' best
//   |y_k|^2 - 2 y_k.x (one rounding, as the plain round's sq - 2 (Y^T X))
//   over its clusters in rising k, and the cluster groups' bests are
//   folded in group order, lowest k on a tie (torch.argmin's rule; exact
//   ties come from equal centroids, whose values are computed alike).
//   Cells past n_valid get no cluster. A warp's 32 labels become one bit
//   mask a cluster and 32-cell word (__match_any_sync; one writer a mask).
//   Then JT threads own a cluster, each its dims jt, jt + JT, ...: it walks
//   the cluster's cells of the tile in cell order, all its dims of a cell
//   at once, and adds the tile's sums into its entries of the CTA's sums
//   (in shared memory; in the CTA's slab of the partials in device memory
//   where K x d does not fit) and the count. The CTA writes its slab once.
//   Every entry has one owner and a fixed order: no float atomics, in
//   shared or device memory.
//   lloyd_update_kernel: 16 warps a block of 32 entries; warp w sums the
//   CTAs b = w, w + 16, ... in order, then the 16 in warp order. It
//   divides by the count (correctly rounded, as torch's division), keeps
//   the old centroid of an empty cluster and writes Y in X's dtype (round
//   to nearest even).
// Two launches on the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kGroup = 8;         // clusters of a lane's register tile
constexpr int kHalf = 128;        // cells a warp computes (16 lanes x 8 cells)
constexpr int kMaxWarps = 14;     // warps a CTA: 146 registers a thread (passes cover more clusters)
constexpr int kMaxDims = 16;      // dims a thread owns of a cluster's sums
constexpr int kUpdateWarps = 16;  // lloyd_update_kernel: warps a block of 32 entries

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void from_f(__half* p, float v) { *p = __float2half_rn(v); }

// four neighbouring values, as float (16-byte aligned as float, 8 as 2-byte)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A staged row of a tile: H x 128 cells and 16 bytes more, so that each
// row starts 16-byte aligned and neighbouring dims of one cell fall in
// different banks.
template <typename T, int H>
struct Tile {
  static constexpr int kCells = kHalf * H;
  static constexpr int kStride = kCells + 16 / static_cast<int>(sizeof(T));
  static constexpr int kWords = kCells / 32;  // 32-bit masks a cluster
};

// Tile t of X (cells t*T.. of every dim) into stage ``dst``: 16-byte
// cp.async where X's rows are 16-byte aligned (``vec``), the bytes past
// n_valid zero-filled and never read; else plain loads.
template <typename T, int H>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ X, long long ldx,
                                           int n_valid, int d, int t, int vec) {
  using TL = Tile<T, H>;
  const int n0 = t * TL::kCells;
  if (vec) {
    constexpr int E = 16 / static_cast<int>(sizeof(T));
    constexpr int chunks = TL::kCells / E;
    for (int i = threadIdx.x; i < d * chunks; i += blockDim.x) {
      const int j = i / chunks, c = (i - j * chunks) * E;
      const int valid = max(0, min(E, n_valid - (n0 + c)));
      const T* src = valid > 0 ? X + static_cast<long long>(j) * ldx + n0 + c : X;
      cp_async16(dst + j * TL::kStride + c, src, valid * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int i = threadIdx.x; i < d * TL::kCells; i += blockDim.x) {
      const int j = i / TL::kCells, c = i - j * TL::kCells;
      T v;
      from_f(&v, 0.f);
      if (n0 + c < n_valid) v = X[static_cast<long long>(j) * ldx + n0 + c];
      dst[j * TL::kStride + c] = v;
    }
  }
}

// One round's assignments and the CTA's partial sums (see the note at the
// top). ``pairs``: cluster pairs (16 clusters) a pass of the CTA's warps of
// one half; ``jt``: threads a cluster in the sums. part (CTAs, K, d) float
// and part_count (CTAs, K) int: the CTA's slab, written by it alone.
template <typename T, int H>
__global__ void __launch_bounds__(kMaxWarps * 32)
lloyd_assign_kernel(const T* __restrict__ X, long long ldx, const T* __restrict__ Y,
                    int n_valid, int K, int d, int pairs, int passes, int jt_n,
                    int tiles_per_block, int n_tiles, int vec, int nbuf, int acc_smem,
                    float* __restrict__ part, int* __restrict__ part_count) {
  using TL = Tile<T, H>;
  constexpr int kT = TL::kCells;
  constexpr int kW = TL::kWords;
  extern __shared__ __align__(16) unsigned char smem[];
  const int KP = 2 * kGroup * pairs * passes;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, n_tiles);
  const int S = 2 * pairs;  // cluster groups a pass: the sources of a cell's fold
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = w % H, pw = w / H;        // the warp's half of the tile, its pair
  const int cg = lane & 15, kq = lane >> 4;  // the lane's cells, its group of the pair
  float* Ys = reinterpret_cast<float*>(smem);                     // [d][KP]
  float* sq = Ys + d * KP;                                        // [KP]
  float* red_v = sq + KP;                                         // [S][kT]
  int* red_k = reinterpret_cast<int*>(red_v + S * kT);            // [S][kT]
  int* label = red_k + S * kT;                                    // [kT]
  unsigned* bits = reinterpret_cast<unsigned*>(label + kT);       // [KP][kW]
  int* cnt_s = reinterpret_cast<int*>(bits + KP * kW);            // [KP]
  float* acc_s = reinterpret_cast<float*>(cnt_s + KP);            // [K * d], 16-byte rounded
  T* Xs = reinterpret_cast<T*>(acc_s + (acc_smem ? (K * d + 3) & ~3 : 0));  // [nbuf][d][kStride]
  const int stage_elems = d * TL::kStride;
  if (t0 < t1) stage_tile<T, H>(Xs, X, ldx, n_valid, d, t0, vec);  // the first tile lands meanwhile
  cp_async_commit();

  for (int i = threadIdx.x; i < d * KP; i += blockDim.x) {
    const int j = i / KP, k = i - j * KP;
    Ys[i] = k < K ? to_f(Y[j * K + k]) : 0.f;
  }
  // the sums accumulate in shared memory where they fit, else in the
  // CTA's slab of part (generic addresses either way)
  float* slab = part + static_cast<long long>(blockIdx.x) * K * d;
  float* acc = acc_smem ? acc_s : slab;
  for (int p = threadIdx.x; p < K * d; p += blockDim.x) acc[p] = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) cnt_s[k] = 0;
  __syncthreads();
  for (int k = threadIdx.x; k < KP; k += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(Ys[j * KP + k], Ys[j * KP + k], s);
    sq[k] = k < K ? s : CUDART_INF_F;
  }

  // the sums' owners: jt_n threads a cluster, clusters kk, kk + cps, ...
  const int cps = blockDim.x / jt_n;
  const int kk = threadIdx.x / jt_n, jt = threadIdx.x - kk * jt_n;

  for (int t = t0; t < t1; ++t) {
    const int buf = nbuf == 2 ? (t - t0) & 1 : 0;
    if (nbuf == 2) {
      if (t + 1 < t1) stage_tile<T, H>(Xs + (buf ^ 1) * stage_elems, X, ldx, n_valid, d, t + 1,
                                       vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if (t > t0) stage_tile<T, H>(Xs, X, ldx, n_valid, d, t, vec);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* xs = Xs + buf * stage_elems;

    // each thread's best cluster of its 8 cells over its groups' clusters
    float best[8];
    int bk[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      best[c] = CUDART_INF_F;
      bk[c] = 0x7fffffff;
    }
    const T* xp = xs + kHalf * h + 4 * cg;
    for (int s = 0; s < passes; ++s) {
      const int g0 = 2 * (pw + pairs * s);  // the pair's first group
      if (kGroup * g0 >= K) break;          // warp-uniform: the rest are padding
      const int k0 = kGroup * (g0 + kq);
      float dot[8][kGroup];
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int q = 0; q < kGroup; ++q) dot[c][q] = 0.f;
      const float* yp = Ys + k0;
#pragma unroll 1
      for (int j = 0; j < d; ++j) {
        const float4 xa = load4(xp + j * TL::kStride);
        const float4 xb = load4(xp + j * TL::kStride + 64);
        const float4 ya = *reinterpret_cast<const float4*>(yp + j * KP);
        const float4 yb = *reinterpret_cast<const float4*>(yp + j * KP + 4);
        const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const float yv[kGroup] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int q = 0; q < kGroup; ++q) dot[c][q] = fmaf(xv[c], yv[q], dot[c][q]);
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        const float sqk = sq[k0 + q];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float v = fmaf(-2.f, dot[c][q], sqk);
          if (v < best[c]) {  // k rises over q and s: the lowest k keeps a tie
            best[c] = v;
            bk[c] = k0 + q;
          }
        }
      }
    }
    {  // source 2 pw + kq of the cells 128 h + 4 cg (+ 64) .. + 3
      const int o = (2 * pw + kq) * kT + kHalf * h + 4 * cg;
      *reinterpret_cast<float4*>(red_v + o) = make_float4(best[0], best[1], best[2], best[3]);
      *reinterpret_cast<float4*>(red_v + o + 64) =
          make_float4(best[4], best[5], best[6], best[7]);
      *reinterpret_cast<int4*>(red_k + o) = make_int4(bk[0], bk[1], bk[2], bk[3]);
      *reinterpret_cast<int4*>(red_k + o + 64) = make_int4(bk[4], bk[5], bk[6], bk[7]);
    }
    __syncthreads();

    // fold the groups' bests in group order; cells past n_valid get none
    const int n0 = t * kT;
    for (int c = threadIdx.x; c < kT; c += blockDim.x) {
      float b = red_v[c];
      int k = red_k[c];
#pragma unroll 2
      for (int v = 1; v < S; ++v) {
        const float x = red_v[v * kT + c];
        const int kx = red_k[v * kT + c];
        if (x < b || (x == b && kx < k)) {
          b = x;
          k = kx;
        }
      }
      label[c] = (n0 + c < n_valid && k < K) ? k : -1;
    }
    for (int i = threadIdx.x; i < KP * kW; i += blockDim.x) bits[i] = 0u;
    __syncthreads();

    // each cluster's cells of the tile as bit masks, one writer a mask
    for (int c = w; c < kW; c += blockDim.x >> 5) {
      const int L = label[32 * c + lane];
      const unsigned m = __match_any_sync(0xffffffffu, L);
      if (L >= 0 && lane == __ffs(m) - 1) bits[L * kW + c] = m;
    }
    __syncthreads();

    // each cluster's sums, its owners' dims of a cell at once, in cell order
    if (kk < cps) {
      for (int k = kk; k < K; k += cps) {
        float a[kMaxDims];
#pragma unroll
        for (int q = 0; q < kMaxDims; ++q) a[q] = 0.f;
        int cnt = 0;
#pragma unroll
        for (int c = 0; c < kW; ++c) {
          unsigned m = bits[k * kW + c];
          cnt += __popc(m);
          while (m) {
            const int i = __ffs(m) - 1;
            m &= m - 1;
            const T* xc = xs + 32 * c + i;
#pragma unroll
            for (int q = 0; q < kMaxDims; ++q) {
              const int j = jt + jt_n * q;
              if (j < d) a[q] += to_f(xc[j * TL::kStride]);
            }
          }
        }
        if (cnt) {
#pragma unroll
          for (int q = 0; q < kMaxDims; ++q) {
            const int j = jt + jt_n * q;
            if (j < d) acc[k * d + j] += a[q];
          }
          if (jt == 0) cnt_s[k] += cnt;
        }
      }
    }
    __syncthreads();
  }
  if (acc_smem)
    for (int p = threadIdx.x; p < K * d; p += blockDim.x) slab[p] = acc[p];
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    part_count[static_cast<long long>(blockIdx.x) * K + k] = cnt_s[k];
}

// The round's new centroids from the CTAs' partials (see the note at the
// top); Y and Y_new are (d, K) in X's dtype. A block takes 32 entries
// (k, dim) = k * d + dim.
template <typename T>
__global__ void __launch_bounds__(kUpdateWarps * 32)
lloyd_update_kernel(const float* __restrict__ part, const int* __restrict__ part_count,
                    int n_blocks, int K, int d, const T* __restrict__ Y, T* __restrict__ Y_new) {
  __shared__ float ps[kUpdateWarps][32];
  __shared__ int pc[kUpdateWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int p = blockIdx.x * 32 + lane;
  const long long stride = static_cast<long long>(K) * d;
  float s = 0.f;
  int cnt = 0;
  if (p < K * d) {
    const int k = p / d;
#pragma unroll 4
    for (int b = w; b < n_blocks; b += kUpdateWarps) {
      s += part[b * stride + p];
      cnt += part_count[static_cast<long long>(b) * K + k];
    }
  }
  ps[w][lane] = s;
  pc[w][lane] = cnt;
  __syncthreads();
  if (w == 0 && p < K * d) {
    s = 0.f;
    cnt = 0;
    for (int v = 0; v < kUpdateWarps; ++v) {
      s += ps[v][lane];
      cnt += pc[v][lane];
    }
    const int k = p / d, j = p - k * d;
    const int o = j * K + k;
    if (cnt > 0)
      from_f(&Y_new[o], s / static_cast<float>(cnt));
    else
      Y_new[o] = Y[o];
  }
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T, int H>
int launch(const void* X, long long ldx, const void* Y, void* Y_new, void* part,
           void* part_count, int n_valid, int K, int d, int warps, int pairs, int passes,
           int jt_n, int tiles_per_block, int n_tiles, int n_blocks, int vec, int nbuf,
           int acc_smem, int smem_bytes, cudaStream_t st) {
  int err = set_smem(reinterpret_cast<const void*>(lloyd_assign_kernel<T, H>), smem_bytes);
  if (err) return err;
  const T* Xt = static_cast<const T*>(X);
  const T* Yt = static_cast<const T*>(Y);
  float* pf = static_cast<float*>(part);
  int* pc = static_cast<int*>(part_count);
  lloyd_assign_kernel<T, H><<<n_blocks, warps * 32, smem_bytes, st>>>(
      Xt, ldx, Yt, n_valid, K, d, pairs, passes, jt_n, tiles_per_block, n_tiles, vec, nbuf,
      acc_smem, pf, pc);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int grid = (K * d + 31) / 32;
  lloyd_update_kernel<T><<<grid, kUpdateWarps * 32, 0, st>>>(pf, pc, n_blocks, K, d, Yt,
                                                              static_cast<T*>(Y_new));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_halves(int halves, const void* X, long long ldx, const void* Y, void* Y_new,
                  void* part, void* part_count, int n_valid, int K, int d, int warps, int pairs,
                  int passes, int jt_n, int tiles_per_block, int n_tiles, int n_blocks, int vec,
                  int nbuf, int acc_smem, int smem_bytes, cudaStream_t st) {
  if (halves == 2)
    return launch<T, 2>(X, ldx, Y, Y_new, part, part_count, n_valid, K, d, warps, pairs,
                        passes, jt_n, tiles_per_block, n_tiles, n_blocks, vec, nbuf, acc_smem,
                        smem_bytes, st);
  if (halves == 1)
    return launch<T, 1>(X, ldx, Y, Y_new, part, part_count, n_valid, K, d, warps, pairs,
                        passes, jt_n, tiles_per_block, n_tiles, n_blocks, vec, nbuf, acc_smem,
                        smem_bytes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// One Lloyd round: X (d, N) with row stride ldx, Y (d, K) -> Y_new (d, K),
// all in the dtype ``dtype`` (0 float, 1 bfloat16, 2 float16); part
// (n_blocks, K, d) float and part_count (n_blocks, K) int are scratch.
// The layout (halves of a tile, warps, cluster pairs a pass, passes,
// threads a cluster in the sums, stages, the sums in shared memory or
// not, its bytes) is ops/kmeans.py lloyd_plan's.
int lloyd_round(const void* X, long long ldx, const void* Y, void* Y_new, void* part,
                void* part_count, int n_valid, int K, int d, int dtype, int halves, int warps,
                int pairs, int passes, int jt_n, int tiles_per_block, int n_tiles,
                int n_blocks, int vec, int nbuf, int acc_smem, int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_halves<float>(halves, X, ldx, Y, Y_new, part, part_count, n_valid, K, d,
                                warps, pairs, passes, jt_n, tiles_per_block, n_tiles, n_blocks,
                                vec, nbuf, acc_smem, smem_bytes, st);
  if (dtype == 1)
    return launch_halves<__nv_bfloat16>(halves, X, ldx, Y, Y_new, part, part_count, n_valid,
                                        K, d, warps, pairs, passes, jt_n, tiles_per_block,
                                        n_tiles, n_blocks, vec, nbuf, acc_smem, smem_bytes, st);
  if (dtype == 2)
    return launch_halves<__half>(halves, X, ldx, Y, Y_new, part, part_count, n_valid, K, d,
                                 warps, pairs, passes, jt_n, tiles_per_block, n_tiles, n_blocks,
                                 vec, nbuf, acc_smem, smem_bytes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
