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
// at 67 TFLOP/s): bytes-bound, with the FMA bound close behind, so the
// kernel has to stream at full rate and keep the FMA pipes fed at once.
// Design. The TPU accumulated every tile into its joint's slot in VMEM
// along a sequential grid. Here the host cuts each joint's tiles into
// chunks of about 512 cells (a static plan), so the grid holds several
// even waves of CTAs (about 1,000 at the main shape, four resident an SM);
// one CTA per (chunk, cluster slice) writes its chunk's moments to a
// partials row and a second launch sums each joint's rows in order, so
// there are no float atomics and every run gives the same bits.
// Inside a CTA, slices of 32 cells of R and Z come in through cp.async,
// double-buffered: the next slice loads while the current one computes,
// one barrier a slice. Shared memory is row-major along the cells, as the
// rows lie in device memory, so each copy is 16 bytes. A thread owns an
// 8 x 8 register tile of the (cluster, dim) table, rows kb + nkb*i and
// columns eb + neb*j (strided, so the threads of a warp read distinct bank
// quads): per 4-cell quad, 16 shared loads of 16 bytes feed 256 FMAs.
// The row sums come from R through a padding column: row d of every staged
// Z slice is a constant row of ones, written once per CTA (nothing is
// staged for it per slice), and fma(r, 1, acc) is an exact add. At the end
// the table goes out through shared memory, coalesced. IEEE fp32 FMA
// throughout.

// K9 replaces harmony_tpu/ops/pallas_ridge.py _tiled_correction_kernel
// (:254), reached through pallas_tiled_correction (:275):
//   Z_corr[:, t] = Z[:, t] - W_joint[j(t)] R_t, the trash row being zero.
// Bound: R and Z read once, Z_corr written once, 0.4 GB (120 us); K*d*N
// = 2.5 G FMA (75 us): bytes-bound, the FMA pipes close behind.
// Design. The grid walks K8's static plan in its order (the layout tiles
// joint by joint, ascending), cut into one equal range of tiles a CTA, one
// wave at three CTAs an SM (72 KB of shared memory each at the main
// shape), so no SM waits on a partial last wave; a joint's betas are
// staged once where its run in a range starts (transposed into K x dp as
// they come in), not once per 64 cells. A trash tile copies Z through
// (its betas are zero). Slices of 64 cells of R come in through cp.async,
// double-buffered, one barrier a slice: the next slice loads while the
// current one computes (where two slices do not fit beside the betas, at
// K (dp + 128) past 58,112 floats, one slice is loaded, then computed, in
// K (dp + 64) floats). Thread (tb, eb) owns a 4-dim x 8-cell register
// tile, dims 4 eb.. and cells 4 tb.. and 32 + 4 tb.. of the slice (so
// eight lanes read 128 contiguous bytes of a row of R: no bank
// conflicts): per cluster one float4 of betas and two of R feed 32 FMAs,
// each output acc = fmaf(w, r, acc) over k = 0..K-1 from 0 (K10's
// sequence, so both give the same bits on the same R). The tile's Z comes
// in as float4s before the product and Z_corr goes out the same way,
// coalesced: eight lanes cover 128 contiguous bytes of a dim. Its memory
// stream, 64-cell pieces of some 200 rows at once, sets most of its time;
// the product's FMAs and shared-memory loads (12 floats per 32 FMAs) add
// the rest. Rows whose cell axis, or layout tiles whose width, is not a
// multiple of 4 take 4-byte copies and scalar loads instead.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// K9
constexpr int kK9Cells = 64;              // cells a slice
constexpr int kK9Half = kK9Cells / 2;     // a tile's second cell quad, past its first
constexpr int kK9MaxThreads = 512;        // 4 x 8 tiles of 256 dims at once
// K8
constexpr int kSub = 32;    // cells a slice
constexpr int kSP = kSub + 4;  // row stride of a staged slice, in floats
constexpr int kStages = 2;  // slices in flight
constexpr int kRT = 8;      // register tile: rows and columns a thread owns
constexpr int kK8Threads = 96;  // at most; four CTAs an SM

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// One CTA: chunk blockIdx.x (up to `chunk` tiles of one joint), cluster
// rows k0 .. k0 + ks - 1 with k0 = blockIdx.y * KS. Thread t < nkb * neb
// owns rows kb + nkb*i and columns eb + neb*j (kb = t % nkb, eb = t / nkb). kAligned: N and tile are
// multiples of 4, so every copy is 16 bytes; else 4.
template <bool kAligned>
__global__ void __launch_bounds__(kK8Threads, 4) tile_moments_kernel(
    const float* __restrict__ R,       // (K, N)
    const float* __restrict__ Z,       // (d, N)
    const int* __restrict__ chunks,    // (n_chunks, chunk) tile ids, -1 pad
    float* __restrict__ part,          // (n_chunks, K, d+1) out
    long long N, int K, int d, int tile, int chunk, int KS, int nkb, int neb) {
  extern __shared__ __align__(16) float smem[];
  const int rows_r = kRT * nkb, rows_z = kRT * neb;
  const int stage = (rows_r + rows_z) * kSP;
  int* tl = reinterpret_cast<int*>(smem + kStages * stage);  // chunk tile ids
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int k0 = blockIdx.y * KS;
  const int ks = min(KS, K - k0);
  const int d1 = d + 1;

  // once: rows past ks and past d stay zero (no copy writes them), and row
  // d of each Z slice holds ones for the row sums
  for (int i = tid; i < kStages * stage; i += nthr) {
    const int r = i % stage - rows_r * kSP;
    smem[i] = (r >= d * kSP && r < (d + 1) * kSP) ? 1.f : 0.f;
  }
  int ntl = 0;
  for (int c = 0; c < chunk; ++c) {
    const int t = chunks[static_cast<long long>(blockIdx.x) * chunk + c];
    if (t < 0) break;
    if (tid == 0) tl[c] = t;
    ++ntl;
  }
  __syncthreads();
  const int spt = (tile + kSub - 1) / kSub;  // slices a tile
  const int ns = ntl * spt;

  auto load = [&](int q) {
    float* Rb = smem + (q % kStages) * stage;
    float* Zb = Rb + rows_r * kSP;
    const int c = q / spt, s0 = (q - c * spt) * kSub;
    const long long n0 = static_cast<long long>(tl[c]) * tile + s0;
    const int nv = static_cast<int>(min(static_cast<long long>(min(kSub, tile - s0)), N - n0));
    if (kAligned) {
      constexpr int kQ = kSub / 4;
      for (int i = tid; i < (ks + d) * kQ; i += nthr) {
        const int row = i / kQ, u = 4 * (i - row * kQ);
        const int bytes = 4 * max(0, min(4, nv - u));
        const float* src = row < ks ? R + (k0 + row) * N : Z + (row - ks) * N;
        float* dst = row < ks ? Rb + row * kSP : Zb + (row - ks) * kSP;
        cp_async16(dst + u, bytes ? src + n0 + u : src, bytes);
      }
    } else {
      for (int i = tid; i < (ks + d) * kSub; i += nthr) {
        const int row = i / kSub, u = i - row * kSub;
        const int bytes = u < nv ? 4 : 0;
        const float* src = row < ks ? R + (k0 + row) * N : Z + (row - ks) * N;
        float* dst = row < ks ? Rb + row * kSP : Zb + (row - ks) * kSP;
        cp_async4(dst + u, bytes ? src + n0 + u : src, bytes);
      }
    }
  };

  const bool active = tid < nkb * neb;
  const int kb = tid % nkb, eb = tid / nkb;
  float acc[kRT][kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int j = 0; j < kRT; ++j) acc[i][j] = 0.f;

  for (int q = 0; q < kStages - 1; ++q) {
    if (q < ns) load(q);
    cp_async_commit();
  }
  for (int q = 0; q < ns; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice q landed; every thread is done with slice q - 1
    if (q + kStages - 1 < ns) load(q + kStages - 1);
    cp_async_commit();
    if (!active) continue;
    const float* Rb = smem + (q % kStages) * stage;
    const float* Zb = Rb + rows_r * kSP;
    for (int u = 0; u < kSub; u += 4) {
      float4 r[kRT];
#pragma unroll
      for (int i = 0; i < kRT; ++i)
        r[i] = *reinterpret_cast<const float4*>(Rb + (kb + nkb * i) * kSP + u);
#pragma unroll
      for (int j = 0; j < kRT; ++j) {
        const float4 z = *reinterpret_cast<const float4*>(Zb + (eb + neb * j) * kSP + u);
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          float a = fmaf(r[i].x, z.x, acc[i][j]);
          a = fmaf(r[i].y, z.y, a);
          a = fmaf(r[i].z, z.z, a);
          acc[i][j] = fmaf(r[i].w, z.w, a);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the table goes out through shared memory in rows of d+1, coalesced
  // (the buffers are free now)
  float* red = smem;  // ks x (d+1)
  if (active) {
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const int k = kb + nkb * i;
      if (k >= ks) continue;
#pragma unroll
      for (int j = 0; j < kRT; ++j) {
        const int e = eb + neb * j;
        if (e < d1) red[k * d1 + e] = acc[i][j];
      }
    }
  }
  __syncthreads();
  float* out = part + static_cast<long long>(blockIdx.x) * K * d1 + static_cast<long long>(k0) * d1;
  for (int i = tid; i < ks * d1; i += nthr) out[i] = red[i];
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

// K9, CTA b: the tiles [lo, hi) of the plan's order, lo = b * n / grid
// (an equal range a CTA, one wave), joint by joint, read from the order
// and the tile table as it goes (no copy in shared memory). Slice q is
// cells [s0, s0 + 64) of the range's tile q / spt, spt = ceil(tile / 64);
// cells past the tile's end (a tile that is not whole slices, tile = 160:
// its last slice holds 32) and at N and past are masked (the last tile
// may be partial). A joint's betas are staged where
// its run in the range starts, after a barrier (a new joint comes once or
// twice a range); a trash tile's slices copy Z through. kWhole: the tiles
// are whole slices (tile a multiple of 64), so no slice is cut at a tile's
// end. stages: slices of
// R staged, 2 (the next in flight) or, where two do not fit beside the
// betas, 1 (load, wait, compute). Past 4 * blockDim.x / 8 dims a thread
// takes its 4-dim tiles in turn.
template <bool kAligned, bool kWhole>
__global__ void __launch_bounds__(kK9MaxThreads) tiled_correction_kernel(
    const float* __restrict__ Wj,      // (n_joint + 1, d, K) betas
    const int* __restrict__ order,     // (n,) the plan's tiles, joint by joint, ascending
    const int* __restrict__ tj,        // (ceil(N / tile),) joint of each tile
    const float* __restrict__ R,       // (K, N)
    const float* __restrict__ Z,       // (d, N)
    float* __restrict__ Zc,            // (d, N) out
    long long N, int n, int K, int d, int dp, int tile, int trash, int stages) {
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;                // K*dp
  float* Rb = Ws + K * dp;         // stages*K*kK9Cells: the slices' R
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lo = static_cast<int>(static_cast<long long>(blockIdx.x) * n / gridDim.x);
  const int hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * n / gridDim.x);
  const int spt = kWhole ? tile / kK9Cells : (tile + kK9Cells - 1) / kK9Cells;
  const int ns = (hi - lo) * spt;
  // slice q's cells start at n0 = t * tile + (q % spt) * 64 of its tile t;
  // cells past the tile's end and at N and past are masked
  auto cells = [&](int q, int t, long long& n0) {
    const int k0 = (q % spt) * kK9Cells;
    n0 = static_cast<long long>(t) * tile + k0;
    const int in_tile = kWhole ? kK9Cells : min(kK9Cells, tile - k0);
    return static_cast<int>(max(0LL, min(static_cast<long long>(in_tile), N - n0)));
  };
  auto load = [&](int q, int t, int jt) {
    if (jt == trash) return;
    float* Rs = Rb + (q % stages) * K * kK9Cells;
    long long n0;
    const int nv = cells(q, t, n0);
    if (kAligned) {
      constexpr int kQ = kK9Cells / 4;
      for (int i = tid; i < K * kQ; i += nthr) {
        const int k = i / kQ, u = 4 * (i - k * kQ);
        const int bytes = 4 * max(0, min(4, nv - u));
        cp_async16(Rs + k * kK9Cells + u, bytes ? R + k * N + n0 + u : R, bytes);
      }
    } else {
      for (int i = tid; i < K * kK9Cells; i += nthr) {
        const int k = i / kK9Cells, u = i - k * kK9Cells;
        cp_async4(Rs + k * kK9Cells + u, u < nv ? R + k * N + n0 + u : R, u < nv ? 4 : 0);
      }
    }
  };
  // a joint's betas, transposed into (K x dp) as they come in; the
  // columns past d are never stored from, so they stay as they are
  auto stage_betas = [&](int jt) {
    const float* W = Wj + static_cast<long long>(jt) * d * K;
    for (int i = tid; i < d * K; i += nthr) {
      const int e = i / K;
      cp_async4(Ws + (i - e * K) * dp + e, W + i, 4);
    }
  };
  // the range's tile c and its joint, read from the order a tile ahead of
  // their use: (tq, jq) the current slice's, (tn, jn) the next tile's
  auto fetch = [&](int c, int& t, int& jt) {
    if (c < hi - lo) {
      t = __ldg(order + lo + c);
      jt = __ldg(tj + t);
    }
  };
  int tq = 0, jq = trash, tn = 0, jn = trash;
  fetch(0, tq, jq);
  fetch(1, tn, jn);
  // the first joint's betas, then (two stages) the first slice
  if (ns > 0 && jq != trash) stage_betas(jq);
  if (stages == 2 && ns > 0) load(0, tq, jq);
  cp_async_commit();
  const int neb = (d + 3) / 4;
  const int tb = tid % (kK9Cells / 8), eb0 = tid / (kK9Cells / 8), ebs = nthr / (kK9Cells / 8);
  int jp = jq;  // the previous slice's joint
  for (int q = 0; q < ns; ++q) {
    if (q > 0 && q % spt == 0) {
      tq = tn;
      jq = jn;
      fetch(q / spt + 1, tn, jn);
    }
    if (stages == 1) {
      __syncthreads();  // every thread is done with slice q - 1
      load(q, tq, jq);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();  // slice q landed; every thread is done with slice q - 1
    const int jt = jq;
    if (q > 0 && jt != trash && jt != jp) {
      // a new joint: its betas, once every thread is done with the last
      stage_betas(jt);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    jp = jt;
    if (stages == 2 && q + 1 < ns) {
      if ((q + 1) % spt)
        load(q + 1, tq, jq);
      else
        load(q + 1, tn, jn);
    }
    cp_async_commit();
    long long n0;
    const int nv = cells(q, tq, n0);
    if (jt == trash) {
      // the trash betas are zero: Z passes through
      if (kAligned) {
        constexpr int kQ = kK9Cells / 4;
        for (int i = tid; i < d * kQ; i += nthr) {
          const int e = i / kQ, u = 4 * (i - e * kQ);
          if (u < nv)
            *reinterpret_cast<float4*>(Zc + e * N + n0 + u) =
                *reinterpret_cast<const float4*>(Z + e * N + n0 + u);
        }
      } else {
        for (int i = tid; i < d * kK9Cells; i += nthr) {
          const int e = i / kK9Cells, u = i - e * kK9Cells;
          if (u < nv) Zc[e * N + n0 + u] = Z[e * N + n0 + u];
        }
      }
      continue;
    }
    if (4 * tb >= nv) continue;
    for (int eb = eb0; eb < neb; eb += ebs) {
      const float* Wp = Ws + 4 * eb;
      // the tile's Z (cells 4 tb + kK9Half h + 0..3, h = 0, 1), in flight during
      // the product
      float zv[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 4 * eb + i;
        if (e >= d) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int u = 4 * tb + kK9Half * h;
          const float* zp = Z + e * N + n0 + u;
          if (kAligned && u + 4 <= nv) {
            const float4 a = *reinterpret_cast<const float4*>(zp);
            zv[i][4 * h] = a.x;
            zv[i][4 * h + 1] = a.y;
            zv[i][4 * h + 2] = a.z;
            zv[i][4 * h + 3] = a.w;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) zv[i][4 * h + j] = u + j < nv ? zp[j] : 0.f;
          }
        }
      }
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      const float* Rs = Rb + (q % stages) * K * kK9Cells + 4 * tb;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(Wp + k * dp);
        const float4 ra = *reinterpret_cast<const float4*>(Rs + k * kK9Cells);
        const float4 rb = *reinterpret_cast<const float4*>(Rs + k * kK9Cells + kK9Half);
        const float wv[4] = {w.x, w.y, w.z, w.w};
        const float rv[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wv[i], rv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 4 * eb + i;
        if (e >= d) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int u = 4 * tb + kK9Half * h;
          float* op = Zc + e * N + n0 + u;
          const int c = 4 * h;
          if (kAligned && u + 4 <= nv) {
            *reinterpret_cast<float4*>(op) =
                make_float4(zv[i][c] - acc[i][c], zv[i][c + 1] - acc[i][c + 1],
                            zv[i][c + 2] - acc[i][c + 2], zv[i][c + 3] - acc[i][c + 3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (u + j < nv) op[j] = zv[i][c + j] - acc[i][c + j];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

using K9Kernel = decltype(&tiled_correction_kernel<true, true>);

// The K9 instance for the alignment and the tile form (whole: the tile is
// a multiple of kK9Cells).
K9Kernel k9_pick(int aligned, int tile) {
  const bool whole = tile % kK9Cells == 0;
  return aligned ? (whole ? tiled_correction_kernel<true, true>
                          : tiled_correction_kernel<true, false>)
                 : (whole ? tiled_correction_kernel<false, true>
                          : tiled_correction_kernel<false, false>);
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
                    int d, int tile, int n_chunks, int n_joint, int KS, int nkb,
                    int neb, int threads, int chunk, int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0) {
    const bool aligned = N % 4 == 0 && tile % 4 == 0;
    const void* kernel = aligned ? reinterpret_cast<const void*>(tile_moments_kernel<true>)
                                 : reinterpret_cast<const void*>(tile_moments_kernel<false>);
    int err = set_smem(kernel, smem_bytes);
    if (err) return err;
    dim3 grid(n_chunks, (K + KS - 1) / KS);
    const float* Rf = static_cast<const float*>(R);
    const float* Zf = static_cast<const float*>(Z);
    const int* cf = static_cast<const int*>(chunks);
    float* pf = static_cast<float*>(part);
    if (aligned)
      tile_moments_kernel<true><<<grid, threads, smem_bytes, st>>>(
          Rf, Zf, cf, pf, N, K, d, tile, chunk, KS, nkb, neb);
    else
      tile_moments_kernel<false><<<grid, threads, smem_bytes, st>>>(
          Rf, Zf, cf, pf, N, K, d, tile, chunk, KS, nkb, neb);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  return sum_joint_rows(part, start, M, n_joint + 1, static_cast<long long>(K) * (d + 1),
                        stream);
}

// CTAs of the K9 instance k9_pick(aligned, tile) an SM holds with
// `threads` threads and smem_bytes each; < 0 is minus a CUDA error.
int k9_occupancy(int threads, int smem_bytes, int aligned, int tile) {
  const void* kern = reinterpret_cast<const void*>(k9_pick(aligned, tile));
  int err = set_smem(kern, smem_bytes);
  if (err) return -err;
  int nb = 0;
  err = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kern, threads, smem_bytes));
  return err ? -err : nb;
}

// K9 over the plan's order (n tiles) in grid equal ranges, stages slices
// of R staged (1 or 2); aligned: N % 4 == 0, tile % 4 == 0 and every
// tensor starts on a 16-byte boundary.
int k9_tiled_correction(const void* Wj, const void* order, const void* tj, const void* R,
                        const void* Z, void* Zc, long long N, int n, int K, int d, int dp,
                        int tile, int trash, int grid, int stages, int threads, int aligned,
                        int smem_bytes, void* stream) {
  const K9Kernel kernel = k9_pick(aligned, tile);
  int err = set_smem(reinterpret_cast<const void*>(kernel), smem_bytes);
  if (err) return err;
  kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Wj), static_cast<const int*>(order),
      static_cast<const int*>(tj), static_cast<const float*>(R), static_cast<const float*>(Z),
      static_cast<float*>(Zc), N, n, K, d, dp, tile, trash, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
