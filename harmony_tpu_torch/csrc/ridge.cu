// K4 and K5: the single-covariate M-step contractions (moe_correct_ridge,
// src/harmony.cpp:345-638), hand-written for Hopper (sm_90a).
//
// Both read the cells of a tile batch by batch. The codes are fixed for a
// run, so the port builds a per-tile index once a run (ops/cuda_ridge.py
// cell_index, kept in engine.MStepLayout.cells): for each tile of T cells
// (T = 128 at the main shape) its cell slots in order of code (stable) and
// the first slot of each run of one batch. Neither kernel uses float
// atomics: every output has one owner, partial sums are folded in a fixed
// order, and two launches give the same bits.
//
// K4 replaces harmony_tpu/ops/pallas_ridge.py _moments_kernel (:41), reached
// through pallas_moments (:66): M[k, b, e] = sum_n R[k,n] [code(n)==b]
// [Z;1][e,n], the O row last (e = d).
// Bound on this card: R and Z read once, 0.3 GB at N = 500k, d = 50,
// K = 100 (90 us at 3.35 TB/s); 2*K*(d+1)*N = 5.1 GFLOP of fp32 FMA (76 us
// at 67 TFLOP/s). Design: a CTA owns KS cluster rows (52 of the 100 at the
// main shape, so Z is staged by two CTAs where the parent's seven did) and a
// contiguous range of tiles. Each tile comes in slot order: a thread copies
// one slot of every row of R, [Z;1] and the codes with 4-byte cp.async from
// the cell the index puts there (a gather inside the tile's 4T-byte segment
// of each row, which the copies of a row fetch whole), double-buffered, so
// a run of one batch is a contiguous range of slots. Each thread owns a
// 4 x 4 register tile of (cluster, dim) outputs and walks the slots in
// 4-slot chunks: four 16-byte loads of R and four of [Z;1] feed 64 FMAs.
// When the batch changes it adds its tile into that batch's accumulator: one
// flush a run, not a read-modify-write a cell, into its own slots, so no
// races. The accumulators (B x d1 x KS) live in shared memory beside the
// stages; where they do not fit (large B) the same kernel keeps them in the
// CTA's slab of the partials in device memory (kGlobalAcc). A second
// launch folds the partials over the cell ranges in range order. The ones
// row of [Z;1] is a constant row of the stages, written once a CTA.
//
// K5 replaces harmony_tpu/ops/pallas_ridge.py _correction_kernel (:382),
// reached through pallas_correction (:394):
//   Z_corr[:, n] = Z[:, n] - sum_k R[k,n] W[k, code(n), :].
// Bound on this card: R and Z read once, Z_corr written once, 0.4 GB at the
// main shape (120 us at 3.35 TB/s); K*d*N = 2.5 GFLOP of FMA. Design: a
// persistent CTA walks tiles, double-buffered: R gathered into slot order
// as K4 gathers it, Z as the cells lie (16-byte cp.async). The tile's slots
// are cut into 4-slot chunks; a chunk that a run boundary cuts gives one
// entry per run, so every entry is one run's. For a K-chunk at a time the
// CTA holds the betas of the tile's runs ([run][k][dim], 33 KB at the main
// shape: ten runs of a 128-cell tile, 16 k) in shared memory, and each
// thread forms one entry's 8 dims x 4 slots: two 16-byte loads of the run's
// betas and one of R feed 32 FMAs, the sums held in registers over the
// K-chunks. The next K-chunk's betas come into registers while this one
// computes, so one barrier a chunk swaps the two W buffers. Each slot's
// sums are subtracted from the staged Z tile at its cell, which goes out
// coalesced. W comes from L2 once a tile per run in it, not once an output.
// Where the tile has more runs than one pass of entries holds, the passes
// repeat the K-chunks.

#include <cuda_runtime.h>

namespace {

constexpr int kK4MaxThreads = 512;  // K4: a 4 x 4 register tile a thread, up to 128 registers
constexpr int kK5Threads = 384;  // K5: one 8 x 4 (dim, slot) register tile a thread
constexpr int kWRegs = 6;  // K5: float4 registers a thread prefetches of W
constexpr int kFoldThreads = 256;

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Tile t's rows in slot order: the thread copies slot `slot` of rows r0,
// r0 + rstep, ...: a 4-byte copy from the cell the slot holds (o; -1 past
// the tile's cells: zeros). The copies of one row read the tile's 4T-byte
// segment of it, which they fetch whole.
__device__ __forceinline__ void gather_rows(void* dst, int TS, const void* src, long long N,
                                            long long n0, int rows, int o, int slot, int r0,
                                            int rstep) {
  const float* s = static_cast<const float*>(src);
  float* d = static_cast<float*>(dst);
  for (int r = r0; r < rows; r += rstep)
    cp_async4(d + r * TS + slot, o >= 0 ? s + r * N + n0 + o : s, o >= 0 ? 4 : 0);
}

template <bool kGlobalAcc>
__global__ void __launch_bounds__(kK4MaxThreads) moments_kernel(
    const float* __restrict__ R,      // (K, N)
    const float* __restrict__ Z,      // (d, N)
    const int* __restrict__ codes,    // (N,) in [0, B)
    const int* __restrict__ order,    // (nt, T) slots by code, -1 past the cells
    float* __restrict__ part,         // (NS, B, d+1, K)
    long long N, int K, int d, int B, int T, int nt, int tpc, int KS, int EP) {
  extern __shared__ __align__(16) float smem[];
  const int d1 = d + 1, TS = T + 4;
  const int stage = (KS + EP) * TS + T;  // R, [Z;1] and the codes, in slot order
  float* accs = smem + 2 * stage;        // B x EP x KS (shared accumulators)
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int k0 = blockIdx.x * KS, ks = min(KS, K - k0);
  const int s = blockIdx.y;
  const int t_begin = s * tpc, ntl = min(nt, t_begin + tpc) - t_begin;
  const int nkb = KS / 4, neb = EP / 4;
  const bool active = tid < nkb * neb;
  const int kb = tid % nkb, eb = tid / nkb;
  const int slot = tid & (T - 1), r0 = tid / T, rstep = nthr / T;

  // rows past ks and past d stay zero (no copy writes them); row d of every
  // staged [Z;1] holds the ones
  for (int i = tid; i < 2 * stage; i += nthr) {
    const int w = i % stage - (KS + d) * TS;
    smem[i] = (w >= 0 && w < TS) ? 1.f : 0.f;
  }
  if (!kGlobalAcc)
    for (int i = tid; i < B * EP * KS; i += nthr) accs[i] = 0.f;

  // slots past the cells hold zeros and code 0: they add nothing
  auto load = [&](int q, int o) {
    float* Rs = smem + (q & 1) * stage;
    float* Zs = Rs + KS * TS;
    const long long n0 = static_cast<long long>(t_begin + q) * T;
    gather_rows(Rs, TS, R + static_cast<long long>(k0) * N, N, n0, ks, o, slot, r0, rstep);
    gather_rows(Zs, TS, Z, N, n0, d, o, slot, r0, rstep);
    if (r0 == 0) gather_rows(Zs + EP * TS, 0, codes, N, n0, 1, o, slot, 0, 1);
  };
  // the cell this thread's slot holds in the CTA's tile q (read ahead)
  auto slot_cell = [&](int q) {
    return q < ntl ? __ldg(order + static_cast<long long>(t_begin + q) * T + slot) : -1;
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // the register tile goes into batch b's accumulator, then restarts
  auto flush = [&](int b) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = kb + nkb * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 4 * eb + j;
        if (kGlobalAcc) {
          if (e < d1 && k < ks)
            part[((static_cast<long long>(s) * B + b) * d1 + e) * K + k0 + k] += acc[i][j];
        } else {
          accs[(static_cast<long long>(b) * EP + e) * KS + k] += acc[i][j];
        }
        acc[i][j] = 0.f;
      }
    }
  };

  int cur = -1;  // the batch the register tile holds
  __syncthreads();
  if (ntl > 0) load(0, slot_cell(0));
  cp_async_commit();
  int o_next = slot_cell(1);
  for (int q = 0; q < ntl; ++q) {
    cp_async_wait_all();
    __syncthreads();  // tile q landed; every thread is done with tile q - 1
    if (q + 1 < ntl) load(q + 1, o_next);
    cp_async_commit();
    o_next = slot_cell(q + 2);
    if (!active) continue;
    const float* Rs = smem + (q & 1) * stage;
    const float* Zs = Rs + KS * TS;
    const int* sc = reinterpret_cast<const int*>(Zs + EP * TS);
    // the slots in 4-slot chunks, in order; a run of one batch sums in the
    // register tile, which goes to the batch's accumulator when it ends
    for (int c = 0; c < T; c += 4) {
      const int4 b4 = *reinterpret_cast<const int4*>(sc + c);
      float4 z[4], r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) z[j] = *reinterpret_cast<const float4*>(Zs + (4 * eb + j) * TS + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = *reinterpret_cast<const float4*>(Rs + (kb + nkb * i) * TS + c);
      if (b4.x == cur && b4.y == cur && b4.z == cur && b4.w == cur) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float a = fmaf(r[i].x, z[j].x, acc[i][j]);
            a = fmaf(r[i].y, z[j].y, a);
            a = fmaf(r[i].z, z[j].z, a);
            acc[i][j] = fmaf(r[i].w, z[j].w, a);
          }
      } else {
        const int bl[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          if (bl[l] != cur) {
            if (cur >= 0) flush(cur);
            cur = bl[l];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float rl = l == 0 ? r[i].x : l == 1 ? r[i].y : l == 2 ? r[i].z : r[i].w;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float zl = l == 0 ? z[j].x : l == 1 ? z[j].y : l == 2 ? z[j].z : z[j].w;
              acc[i][j] = fmaf(rl, zl, acc[i][j]);
            }
          }
        }
      }
    }
  }
  cp_async_wait_all();
  if (active && cur >= 0) flush(cur);
  if (kGlobalAcc) return;
  __syncthreads();
  float* out = part + static_cast<long long>(s) * B * d1 * K + k0;
  for (long long i = tid; i < static_cast<long long>(B) * d1 * ks; i += nthr) {
    const int k = static_cast<int>(i % ks);
    const long long be = i / ks;
    const int e = static_cast<int>(be % d1), b = static_cast<int>(be / d1);
    out[be * K + k] = accs[(static_cast<long long>(b) * EP + e) * KS + k];
  }
}

// M[k, b, e] = sum over the cell ranges s of part[s, b, e, k], in range order.
__global__ void __launch_bounds__(kFoldThreads) fold_kernel(
    const float* __restrict__ part, float* __restrict__ M, int NS, int K, int B, int d1) {
  const long long n = static_cast<long long>(B) * d1 * K;
  const long long i = blockIdx.x * static_cast<long long>(kFoldThreads) + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int s = 0; s < NS; ++s) v += part[s * n + i];
  const int k = static_cast<int>(i % K);
  const long long be = i / K;
  M[static_cast<long long>(k) * B * d1 + be] = v;
}

// The index rows and codes of tile t into a stage: Os = order (T slots),
// Ks = run starts (T + 1), Cs = codes of the tile's cells (0 past N).
__device__ __forceinline__ void stage_index(int* Os, int* Ks, int* Cs, const int* order,
                                            const int* runs, const int* codes, long long N,
                                            int T, int t, int tid, int nthr) {
  const long long n0 = static_cast<long long>(t) * T;
  for (int i = tid; i < T / 4; i += nthr) {
    cp_async16(Os + 4 * i, order + n0 + 4 * i, 16);
    const long long n = n0 + 4 * i;
    const int bytes = static_cast<int>(4 * max(0LL, min(4LL, N - n)));
    cp_async16(Cs + 4 * i, bytes ? codes + n : codes, bytes);
  }
  for (int i = tid; i <= T; i += nthr)
    cp_async4(Ks + i, runs + static_cast<long long>(t) * (T + 1) + i, 4);
}

template <int kStages>
__global__ void __launch_bounds__(kK5Threads) correction_kernel(
    const float* __restrict__ Wt,     // (B, K, dp) betas, dims padded with zeros
    const float* __restrict__ R,      // (K, N)
    const float* __restrict__ Z,      // (d, N)
    const int* __restrict__ codes,    // (N,)
    const int* __restrict__ order,    // (nt, T)
    const int* __restrict__ runs,     // (nt, T + 1)
    float* __restrict__ Zc,           // (d, N) out
    long long N, int K, int d, int T, int nt, int TP, int dp, int WB) {
  extern __shared__ __align__(16) float smem[];
  const int stage = (K + d) * TP + 3 * T + 4;  // R in slot order, Z as the cells lie
  float* Ws = smem + kStages * stage;  // 2 x WB: a step's betas, [run][k][dim]
  int* srun = reinterpret_cast<int*>(Ws + 2 * WB);  // T: the run of each slot, -1: none
  int* rb = srun + T;                  // T: the batch of each run
  int* ent = rb + T;                   // 2T + 1: the blocks' entries, then their count
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int dp4 = dp / 4, ne8 = (dp + 7) / 8, nch = T / 4;
  const int EPp = kK5Threads / ne8;  // entries a pass: a block a thread
  const int ntl = blockIdx.x < nt ? (nt - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int slot = tid & (T - 1), r0 = tid / T, rstep = nthr / T;

  auto load = [&](int q, int o) {
    const int t = blockIdx.x + q * gridDim.x;
    float* Rs = smem + (kStages == 2 ? (q & 1) : 0) * stage;
    float* Zs = Rs + K * TP;
    int* Os = reinterpret_cast<int*>(Zs + d * TP);
    const long long n0 = static_cast<long long>(t) * T;
    gather_rows(Rs, TP, R, N, n0, K, o, slot, r0, rstep);
    if (N % 4 == 0) {
      const int q4 = T / 4;
      for (int i = tid; i < d * q4; i += nthr) {
        const int row = i / q4, u = 4 * (i - row * q4);
        const int bytes = static_cast<int>(4 * max(0LL, min(4LL, N - n0 - u)));
        const float* src = Z + static_cast<long long>(row) * N;
        cp_async16(Zs + row * TP + u, bytes ? src + n0 + u : src, bytes);
      }
    } else {
      for (int i = tid; i < d * T; i += nthr) {
        const int row = i / T, u = i - row * T;
        const int bytes = n0 + u < N ? 4 : 0;
        const float* src = Z + static_cast<long long>(row) * N;
        cp_async4(Zs + row * TP + u, bytes ? src + n0 + u : src, bytes);
      }
    }
    stage_index(Os, Os + T, Os + 2 * T + 4, order, runs, codes, N, T, t, tid, nthr);
  };
  // the cell this thread's slot holds in the CTA's tile q (read ahead)
  auto slot_cell = [&](int q) {
    return q < ntl ? __ldg(order + static_cast<long long>(blockIdx.x + q * gridDim.x) * T +
                           slot)
                   : -1;
  };

  // the W of a step: rows kc0 .. kc0 + kcn - 1 of the betas of runs ra ..
  // ra + nr - 1, [run][k][dim], through registers
  float4 wreg[kWRegs];
  auto wfetch = [&](int ra, int nr, int kc0, int kcn) {
    const int per = kcn * dp4;
#pragma unroll
    for (int j = 0; j < kWRegs; ++j) {
      const int i = tid + j * nthr;
      if (i < nr * per) {
        const int rr = i / per, m = i - rr * per;
        wreg[j] = __ldg(reinterpret_cast<const float4*>(
                            Wt + (static_cast<long long>(rb[ra + rr]) * K + kc0) * dp) + m);
      }
    }
  };
  auto wstore = [&](int wb, int n4) {
    float4* dst = reinterpret_cast<float4*>(Ws + wb * WB);
#pragma unroll
    for (int j = 0; j < kWRegs; ++j) {
      const int i = tid + j * nthr;
      if (i < n4) dst[i] = wreg[j];
    }
  };

  if (kStages == 2 && ntl > 0) load(0, slot_cell(0));
  cp_async_commit();
  int o_next = slot_cell(kStages == 2 ? 1 : 0);
  for (int q = 0; q < ntl; ++q) {
    const int t = blockIdx.x + q * gridDim.x;
    if (kStages == 2) {
      cp_async_wait_all();
      __syncthreads();  // tile q landed; tile q - 1 went out
      if (q + 1 < ntl) load(q + 1, o_next);
      cp_async_commit();
      o_next = slot_cell(q + 2);
    } else {
      load(q, o_next);
      cp_async_commit();
      o_next = slot_cell(q + 1);
      cp_async_wait_all();
      __syncthreads();
    }
    const float* Rs = smem + (kStages == 2 ? (q & 1) : 0) * stage;
    float* Zs = const_cast<float*>(Rs) + K * TP;
    const int* Os = reinterpret_cast<const int*>(Zs + d * TP);
    const int* Ks = Os + T;
    const int* Cs = Ks + T + 4;
    const int nv = Ks[T];
    if (tid < T) {
      if (Ks[tid] < nv) rb[tid] = Cs[Os[Ks[tid]]];
      int lo = 0, hi = T;  // the run of slot tid: Ks[lo] <= tid < Ks[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (Ks[mid] <= tid) lo = mid; else hi = mid;
      }
      srun[tid] = tid < nv ? lo : -1;
    }
    __syncthreads();  // the run table is complete
    // the blocks' entries: each (4-slot chunk, run of a slot in it), in
    // chunk order; a chunk that a run boundary cuts gives one a run
    if (tid < 32) {
      int cnt = 0, r_first = 0;
      for (int ch = tid; ch < nch; ch += 32) {
        // (nch <= 32 wherever T <= 128: one chunk a lane)
        if (4 * ch < nv) {
          r_first = srun[4 * ch];
          cnt = srun[min(4 * ch + 3, nv - 1)] - r_first + 1;
        }
      }
      int inc = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (tid >= o) inc += v;
      }
      for (int j = 0; j < cnt; ++j) ent[inc - cnt + j] = tid | ((r_first + j) << 8);
      if (tid == 31) ent[2 * T] = inc;
    }
    __syncthreads();
    const int n_ent = ent[2 * T];

    // passes over up to EPp entries (their runs' betas), each by K-chunks
    const int n_pass = (n_ent + EPp - 1) / EPp;
    auto pass_runs = [&](int p, int& ra, int& nr, int& kc) {
      const int e0 = p * EPp, e1 = min(n_ent, e0 + EPp) - 1;
      ra = ent[e0] >> 8;
      nr = (ent[e1] >> 8) - ra + 1;
      kc = max(1, min(K, WB / (nr * dp)));
    };
    int p = 0, c = 0, ra, nr, KC;
    pass_runs(0, ra, nr, KC);
    auto next = [&](int& p2, int& c2, int& ra2, int& nr2, int& kc2) {
      p2 = p;
      c2 = c + 1;
      ra2 = ra;
      nr2 = nr;
      kc2 = KC;
      if (c2 * KC >= K) {
        ++p2;
        c2 = 0;
        if (p2 < n_pass) pass_runs(p2, ra2, nr2, kc2);
      }
    };
    wfetch(ra, nr, 0, min(KC, K));
    wstore(0, nr * min(KC, K) * dp4);
    int p2, c2, ra2, nr2, kc2;
    next(p2, c2, ra2, nr2, kc2);
    if (p2 < n_pass) wfetch(ra2, nr2, c2 * kc2, min(kc2, K - c2 * kc2));
    __syncthreads();
    // the thread's block: entry tid % ne_p of the pass (chunk ch of run
    // `run`), dims 8 e8 .. with e8 = tid / ne_p; two loads of the run's
    // betas and one of R feed 32 FMAs; the sums stay over the K-chunks
    float acc[8][4];
    for (int w = 0;; ++w) {
      const int kc0 = c * KC, kcn = min(KC, K - kc0);
      const float* Wb = Ws + (w & 1) * WB;
      const int ebase = p * EPp, ne_p = min(n_ent, ebase + EPp) - ebase;
      const int ei = ebase + tid % ne_p, e8 = tid / ne_p;
      if (e8 < ne8) {
        const int ch = ent[ei] & 255, run = ent[ei] >> 8;
        if (c == 0) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int l = 0; l < 4; ++l) acc[j][l] = 0.f;
        }
        const float* rp = Rs + kc0 * TP + 4 * ch;
        const int e0 = 8 * e8, nw = min(8, dp - e0);  // 8 or 4 dims
        const float* wp = Wb + (run - ra) * kcn * dp + e0;
#pragma unroll 2
        for (int k = 0; k < kcn; ++k) {
          const float4 rv = *reinterpret_cast<const float4*>(rp + k * TP);
          const float4 wa = *reinterpret_cast<const float4*>(wp + k * dp);
          const float4 wc = nw > 4 ? *reinterpret_cast<const float4*>(wp + k * dp + 4)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
          const float ww[8] = {wa.x, wa.y, wa.z, wa.w, wc.x, wc.y, wc.z, wc.w};
          const float rr[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int l = 0; l < 4; ++l) acc[j][l] = fmaf(ww[j], rr[l], acc[j][l]);
        }
        if (kc0 + kcn == K) {
          // the sums are complete: Z_corr of the chunk's cells of this run
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            if (srun[4 * ch + l] != run) continue;
            const int u = Os[4 * ch + l];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int e = e0 + j;
              if (e < d) Zs[e * TP + u] -= acc[j][l];
            }
          }
        }
      }
      if (p2 >= n_pass) break;
      p = p2;
      c = c2;
      ra = ra2;
      nr = nr2;
      KC = kc2;
      wstore((w + 1) & 1, nr * min(KC, K - c * KC) * dp4);  // readers passed the barrier
      next(p2, c2, ra2, nr2, kc2);
      if (p2 < n_pass) wfetch(ra2, nr2, c2 * kc2, min(kc2, K - c2 * kc2));
      __syncthreads();
    }
    __syncthreads();  // the tile's Z_corr is complete
    const long long n0 = static_cast<long long>(t) * T;
    for (int i = tid; i < d * T; i += nthr) {
      const int e = i / T, u = i - e * T;
      if (n0 + u < N) Zc[e * N + n0 + u] = Zs[e * TP + u];
    }
    if (kStages == 1) __syncthreads();  // the next load overwrites the stage
  }
  cp_async_wait_all();
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

const void* k4_kernel(int global_acc) {
  return global_acc ? reinterpret_cast<const void*>(moments_kernel<true>)
                    : reinterpret_cast<const void*>(moments_kernel<false>);
}

const void* k5_kernel(int stages) {
  return stages == 2 ? reinterpret_cast<const void*>(correction_kernel<2>)
                     : reinterpret_cast<const void*>(correction_kernel<1>);
}

}  // namespace

extern "C" {

// CTAs of K4 (which = 0; arg = global accumulators) or K5 (which = 1;
// arg = stages) resident on an SM at these threads and bytes of shared
// memory; a negative CUDA error code on failure.
int ridge_occupancy(int which, int arg, int threads, int smem_bytes) {
  const void* kern = which == 0 ? k4_kernel(arg) : k5_kernel(arg);
  int err = set_smem(kern, smem_bytes);
  if (err) return -err;
  int n = 0;
  err = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads, smem_bytes));
  return err ? -err : n;
}

int k4_moments(const void* R, const void* Z, const void* codes, const void* order,
               void* part, void* M, long long N, int K, int d, int B, int T, int nt,
               int tpc, int NS, int KS, int EP, int global_acc, int threads, int smem_bytes,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = set_smem(k4_kernel(global_acc), smem_bytes);
  if (err) return err;
  dim3 grid((K + KS - 1) / KS, NS);
  const float* Rf = static_cast<const float*>(R);
  const float* Zf = static_cast<const float*>(Z);
  const int* cf = static_cast<const int*>(codes);
  const int* of = static_cast<const int*>(order);
  float* pf = static_cast<float*>(part);
  if (global_acc)
    moments_kernel<true><<<grid, threads, smem_bytes, st>>>(Rf, Zf, cf, of, pf, N, K, d, B, T,
                                                            nt, tpc, KS, EP);
  else
    moments_kernel<false><<<grid, threads, smem_bytes, st>>>(Rf, Zf, cf, of, pf, N, K, d, B,
                                                             T, nt, tpc, KS, EP);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long n = static_cast<long long>(K) * B * (d + 1);
  fold_kernel<<<static_cast<unsigned>((n + kFoldThreads - 1) / kFoldThreads), kFoldThreads,
                0, st>>>(pf, static_cast<float*>(M), NS, K, B, d + 1);
  return static_cast<int>(cudaGetLastError());
}

int k5_correction(const void* Wt, const void* R, const void* Z, const void* codes,
                  const void* order, const void* runs, void* Zc, long long N, int K, int d,
                  int T, int nt, int TP, int dp, int WB, int stages, int grid,
                  int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = set_smem(k5_kernel(stages), smem_bytes);
  if (err) return err;
  const float* Wf = static_cast<const float*>(Wt);
  const float* Rf = static_cast<const float*>(R);
  const float* Zf = static_cast<const float*>(Z);
  const int* cf = static_cast<const int*>(codes);
  const int* of = static_cast<const int*>(order);
  const int* rf = static_cast<const int*>(runs);
  float* zc = static_cast<float*>(Zc);
  if (stages == 2)
    correction_kernel<2><<<grid, kK5Threads, smem_bytes, st>>>(Wf, Rf, Zf, cf, of, rf, zc, N,
                                                               K, d, T, nt, TP, dp, WB);
  else
    correction_kernel<1><<<grid, kK5Threads, smem_bytes, st>>>(Wf, Rf, Zf, cf, of, rf, zc, N,
                                                               K, d, T, nt, TP, dp, WB);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
