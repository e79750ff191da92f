// K1: one reference-exact E-step round (update_R, src/harmony.cpp:269-342),
// and K12: one rotate round without the stats carry; hand-written for
// Hopper (sm_90a). The two share their assign and commit kernels.
//
// Replaces: harmony_tpu/ops/pallas_estep.py, _round_kernel (:43), reached
// through pallas_block_update_round (:127); and
// harmony_tpu/ops/pallas_rotate.py, _round_kernel (:223), reached through
// pallas_rotate_update_round (:1752).
//
// Bound on this card. Per round K1 reads Z (d x N fp32) and the old R
// (K x N) once and writes the new R once: at N = 500k, d = 50, K = 100 that
// is 0.5 GB, 151 us at 3.35 TB/s. The distances are 2*K*d*N = 5 GFLOP of
// fp32 FMA, 75 us at the card's 67 TFLOP/s outside the tensor cores: the
// round is bytes-bound. K12 moves the same bytes.
//
// Design. On the TPU the grid ran in order, so E/O stayed in VMEM across
// blocks. Here CTAs run in parallel and in no order, so a round is a host
// loop over the blocks with two launches each, after the launches that
// take every block's old statistics from the input R:
//   (0) K1: a random R write costs a 32-byte sector per float, so R is
//       carried in each round's block order (the wrapper puts it back in
//       the cells' order once a phase). k1_keys tables, for each column of
//       the input R, the block its cell falls in this round and its batch
//       rows; block_stats_kernel then reads the input R once, coalesced,
//       and sums each span of columns into one row [row sums | batch sums]
//       per block: slices come in through cp.async, warp w owns the blocks
//       b = w mod 8 and its lanes the cluster rows, so each sum has one
//       writer. K12: old_stats_kernel, one row per span of cells (spans
//       never cross a schedule tile). No step of the round writes the
//       input R (the new R is a second buffer), so one pass serves every
//       block.
//   (a) assign_kernel over the block's cells, T a CTA (a multiple of 16 up
//       to 128, which the wrapper sizes so that a block's CTAs fill the
//       card in one even wave). Every
//       cell of the block sees the same committed penalty table
//       ((2E+1)/(O+E+1))^theta. K1's cells are the block's positions of
//       the permutation, read from a cell-major copy of Z (one contiguous
//       row a cell), and R is written at those positions, coalesced; K12's
//       are the block's schedule tiles (v0 + j) mod NT of the physical
//       layout, read and written in place. K12's launches read the block
//       from the round's row of the schedule table on the device (as K7's
//       do), so the host issues the same launches for every schedule and
//       a captured round replays any. The CTA stages Y^T and its
//       cells' Z rows and computes g = Y^T Z with register tiles (4
//       clusters x up to 8 cells a thread, 16-byte shared loads along d).
//       Then each warp takes two cells at a time, its lanes over the
//       clusters: exp(-dist/sigma) once per (cluster, cell), kept in
//       registers (K <= 128; past that it is taken again), the two L1 normalisations with their zero guards and the
//       penalty picked by the cell's batch codes summed over covariates.
//       Every lane adds its r to its warp's own row and batch sums, so all
//       threads work in that pass and no two share a sum; the warps' sums,
//       the k-means error and the entropy go to the CTA's partials row in
//       warp order. A negative code (K12's pad cells) picks no penalty:
//       the cell's R is 0.
//   (b) round_commit_kernel, one CTA per cluster row, reduces the partials in a
//       fixed order (so repeated runs give the same trajectory), adds the
//       block's new contribution to E/O, removes the next block's old
//       contribution (a fixed-order sum of its rows of the table of old
//       statistics) and writes the next penalty table.
// No float atomics anywhere. Op order and zero guards follow
// harmony_tpu/ops/estep.py:block_update_round, which the parity fixtures
// pin. K12 on the TPU does not guard its first normalisation; the guard
// here only differs where every exp(-dist/sigma) of a cell underflows,
// which dist <= 4 at sigma ~0.1 cannot reach.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKI = 4;      // product: cluster rows a thread owns (k = kq + 16 i)
constexpr int kTJ = 8;      // product: cells a thread owns (t = tq + 16 j), T <= 128
constexpr int kKL = 4;      // softmax: exp values a lane keeps in registers a cell
constexpr int kSlices = 8;  // commit: partial rows summed per warp slice
constexpr int kCT = 64;     // K12's old_stats_kernel: cells staged at a time

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
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

// Partials row of one CTA: [row sums K | batch sums K*B | kerr | ent].
// kGather (K1): position p of the round is cell perm[p], Z is (N, d) and
// R (K, N) is written in position order (the round's block order); else
// (K12): the CTA's positions walk the block's schedule tiles of the (d, L)
// layout, and R is written in place. K12's block is the one at position
// pos of the round's order, read where the schedule lies (sched: the
// round's row of the schedule table, [rotation, block order]; blocks:
// (2, nb), the tiles of each block, then its first virtual tile), as K7's
// launches read it: ncells = tiles * tileT from virtual tile v0 =
// (vstart[blk] + rotation) mod NT. The launch has the largest block's
// CTAs, and those past the block's cells return at once, so the host
// issues the same launches for every schedule. K1 passes ncells and v0.
template <bool kGather>
__global__ void __launch_bounds__(kThreads, 2) assign_kernel(
    const float* __restrict__ Yt,     // (K, d)
    const float* __restrict__ Z,      // (N, d) cell-major, or (d, L)
    const int* __restrict__ gcodes,   // (ncov, L) global batch rows; -1 pads
    const int* __restrict__ perm,     // (N,) cell at each position (kGather)
    const float* __restrict__ pen,    // (K, B) committed penalty table
    const float* __restrict__ sigma,  // (K,)
    float* __restrict__ R,            // (K, L) out
    float* __restrict__ part,         // (n_cta, P) out
    long long L, long long cell0, int ncells, int K, int d, int B, int ncov,
    int T, int tileT, int NT, int v0,
    const int* __restrict__ sched,    // (1 + nb,) K12: the round's schedule row
    const int* __restrict__ blocks,   // (2, nb) K12: tiles, first virtual tile
    int pos, int nb) {
  if (!kGather) {
    const int blk = sched[1 + pos];
    ncells = blocks[blk] * tileT;
    if (static_cast<int>(blockIdx.x) * T >= ncells) return;
    v0 = (blocks[nb + blk] + sched[0]) % NT;
  }
  extern __shared__ __align__(16) float smem[];
  const int dp = (d + 3) / 4 * 4, Bp = B | 1, TP = T + 1;
  const int P = K + K * B + 2;
  const int areaA = max((K + T) * dp, kWarps * K * Bp);
  float* Ys = smem;            // K*dp, for the product
  float* Zs = Ys + K * dp;     // T*dp, for the product
  float* Ow = smem;            // kWarps*K*Bp, then: the warps' batch sums
  float* Ls = smem + areaA;    // K*TP: dist, then R
  float* pens = Ls + K * TP;   // K*Bp
  float* sig = pens + K * Bp;  // K
  float* rsw = sig + K;        // kWarps*K: the warps' row sums
  float* red = rsw + kWarps * K;  // 2*kWarps
  int* zidx = reinterpret_cast<int*>(red + 2 * kWarps);  // T: cell of Z and codes
  int* gcs = zidx + T;         // ncov*T

  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int t0 = blockIdx.x * T;
  const int nv = min(T, ncells - t0);
  // the cell of each of the CTA's positions: kGather, through perm (R is
  // written at the position); else the tile walk (R written in place)
  const long long p0 = cell0 + t0;
  for (int t = tid; t < T; t += kThreads) {
    int n = 0;
    if (t < nv) {
      if (kGather) {
        n = perm[p0 + t];
      } else {
        const int v = t0 + t, tl = v / tileT;
        n = ((v0 + tl) % NT) * tileT + (v - tl * tileT);
      }
    }
    zidx[t] = n;
  }
  for (int i = tid; i < K * dp; i += kThreads) {
    const int k = i / dp, e = i - k * dp;
    Ys[i] = e < d ? Yt[k * d + e] : 0.f;
  }
  for (int i = tid; i < K * B; i += kThreads) {
    const int k = i / B;
    pens[k * Bp + i - k * B] = pen[i];
  }
  for (int i = tid; i < K; i += kThreads) sig[i] = sigma[i];
  __syncthreads();
  if (kGather) {  // one contiguous row a cell
    for (int i = tid; i < T * dp; i += kThreads) {
      const int t = i / dp, e = i - t * dp;
      Zs[i] = (t < nv && e < d) ? Z[static_cast<long long>(zidx[t]) * d + e] : 0.f;
    }
  } else {  // rows of d, contiguous along the cells
    for (int i = tid; i < dp * T; i += kThreads) {
      const int e = i / T, t = i - e * T;
      Zs[t * dp + e] = (t < nv && e < d) ? Z[e * L + zidx[t]] : 0.f;
    }
  }
  for (int i = tid; i < ncov * T; i += kThreads) {
    const int c = i / T, t = i - c * T;
    gcs[i] = t < nv ? gcodes[c * L + zidx[t]] : -1;
  }
  __syncthreads();

  // dist = 2 (1 - Y^T Z): thread (kq, tq) owns rows kc + kq + 16 i and
  // cells tq + 16 j; 16-byte loads along d
  const int kq = tid & 15, tq = tid >> 4, tj = T / 16;
  for (int kc = 0; kc < K; kc += 16 * kKI) {
    const int ki = min(kKI, (K - kc + 15) / 16);
    float acc[kKI][kTJ];
#pragma unroll
    for (int i = 0; i < kKI; ++i)
#pragma unroll
      for (int j = 0; j < kTJ; ++j) acc[i][j] = 0.f;
    for (int e = 0; e < dp; e += 4) {
      float4 y[kKI];
#pragma unroll
      for (int i = 0; i < kKI; ++i)
        y[i] = *reinterpret_cast<const float4*>(Ys + min(kc + kq + 16 * i, K - 1) * dp + e);
#pragma unroll
      for (int j = 0; j < kTJ; ++j) {
        if (j >= tj) break;
        const float4 z = *reinterpret_cast<const float4*>(Zs + (tq + 16 * j) * dp + e);
#pragma unroll
        for (int i = 0; i < kKI; ++i) {
          float a = fmaf(y[i].x, z.x, acc[i][j]);
          a = fmaf(y[i].y, z.y, a);
          a = fmaf(y[i].z, z.z, a);
          acc[i][j] = fmaf(y[i].w, z.w, a);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kKI; ++i) {
      const int k = kc + kq + 16 * i;
      if (i >= ki || k >= K) break;
#pragma unroll
      for (int j = 0; j < kTJ; ++j) {
        if (j >= tj) break;
        Ls[k * TP + tq + 16 * j] = 2.f * (1.f - acc[i][j]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kWarps * K * Bp; i += kThreads) Ow[i] = 0.f;
  for (int i = tid; i < kWarps * K; i += kThreads) rsw[i] = 0.f;
  __syncthreads();

  // one warp per two cells, lanes over clusters: R = L1(L1(exp(-dist/sigma))
  // * penalty). exp is taken once per (cluster, cell) and kept in registers
  // for the first 32 * kKL clusters (past them it is taken again in each
  // pass); each lane adds its r to its warp's row and batch sums, so no two
  // lanes or warps share a sum
  float* Om = Ow + w * K * Bp;
  float* rsm = rsw + w * K;
  float kerr = 0.f, ent = 0.f;
  for (int ta = w; ta < nv; ta += 2 * kWarps) {
    const int tb = ta + kWarps;
    const bool lb = tb < nv;
    const int tb_ = lb ? tb : ta;  // a cell to read for the absent second one
    const bool pa = gcs[ta] < 0, pb = !lb || gcs[tb] < 0;  // pads: every code is -1
    auto ex = [&](int k, int t) { return expf(-Ls[k * TP + t] / sig[k]); };
    auto pen_of = [&](int k, int t, bool pad) {
      float pc = 0.f;
      if (!pad)
        for (int c = 0; c < ncov; ++c) pc += pens[k * Bp + gcs[c * T + t]];
      return pc;
    };
    float ea[kKL], eb[kKL];
    float s1a = 0.f, s1b = 0.f;
#pragma unroll
    for (int m = 0; m < kKL; ++m) {
      const int k = lane + 32 * m;
      ea[m] = k < K ? ex(k, ta) : 0.f;
      eb[m] = k < K && lb ? ex(k, tb_) : 0.f;
      s1a += ea[m];
      s1b += eb[m];
    }
    for (int k = lane + 32 * kKL; k < K; k += 32) {
      s1a += ex(k, ta);
      s1b += lb ? ex(k, tb_) : 0.f;
    }
    warp_sum2(s1a, s1b);
    const float ga = s1a == 0.f ? 1.f : s1a, gb = s1b == 0.f ? 1.f : s1b;
    float s2a = 0.f, s2b = 0.f;
#pragma unroll
    for (int m = 0; m < kKL; ++m) {
      const int k = lane + 32 * m;
      if (k < K) {
        ea[m] = (ea[m] / ga) * pen_of(k, ta, pa);
        eb[m] = (eb[m] / gb) * pen_of(k, tb_, pb);
        s2a += ea[m];
        s2b += eb[m];
      }
    }
    for (int k = lane + 32 * kKL; k < K; k += 32) {
      s2a += (ex(k, ta) / ga) * pen_of(k, ta, pa);
      s2b += lb ? (ex(k, tb_) / gb) * pen_of(k, tb_, pb) : 0.f;
    }
    warp_sum2(s2a, s2b);
    const float ha = s2a == 0.f ? 1.f : s2a, hb = s2b == 0.f ? 1.f : s2b;
    for (int m = 0; lane + 32 * m < K; ++m) {
      const int k = lane + 32 * m;
      float ra = 0.f, rb = 0.f;
#pragma unroll
      for (int q = 0; q < kKL; ++q)
        if (q == m) {
          ra = ea[q] / ha;
          rb = eb[q] / hb;
        }
      if (m >= kKL) {
        ra = ((ex(k, ta) / ga) * pen_of(k, ta, pa)) / ha;
        rb = lb ? ((ex(k, tb_) / gb) * pen_of(k, tb_, pb)) / hb : 0.f;
      }
      kerr += ra * Ls[k * TP + ta];
      ent += sig[k] * (ra > 0.f ? ra * logf(ra) : 0.f);
      Ls[k * TP + ta] = ra;
      float rsk = rsm[k] + ra;
      if (!pa)
        for (int c = 0; c < ncov; ++c) Om[k * Bp + gcs[c * T + ta]] += ra;
      if (lb) {
        kerr += rb * Ls[k * TP + tb];
        ent += sig[k] * (rb > 0.f ? rb * logf(rb) : 0.f);
        Ls[k * TP + tb] = rb;
        rsk += rb;
        if (!pb)
          for (int c = 0; c < ncov; ++c) Om[k * Bp + gcs[c * T + tb]] += rb;
      }
      rsm[k] = rsk;
    }
  }
  warp_sum2(kerr, ent);
  if (lane == 0) {
    red[w] = kerr;
    red[kWarps + w] = ent;
  }
  __syncthreads();

  for (int i = tid; i < K * T; i += kThreads) {
    const int k = i / T, u = i - k * T;
    if (u < nv) R[k * L + (kGather ? p0 + u : zidx[u])] = Ls[k * TP + u];
  }
  // the warps' sums, in warp order
  float* prow = part + static_cast<long long>(blockIdx.x) * P;
  for (int k = tid; k < K; k += kThreads) {
    float v = 0.f;
    for (int q = 0; q < kWarps; ++q) v += rsw[q * K + k];
    prow[k] = v;
  }
  for (int i = tid; i < K * B; i += kThreads) {
    const int k = i / B, b = i - k * B;
    float v = 0.f;
    for (int q = 0; q < kWarps; ++q) v += Ow[q * K * Bp + k * Bp + b];
    prow[K + i] = v;
  }
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

// K1, before a round: the block of every cell (perm's positions cut into
// blocks of cpb, the last taking the rest), then the block and batch rows
// of the cell in each column of the round's input R (order: the cells of
// those columns, or none for the identity).
__global__ void __launch_bounds__(kThreads) block_of_cell_kernel(
    const int* __restrict__ perm, int* __restrict__ blk, int N, int cpb, int nb) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < N) blk[perm[i]] = cpb > 0 ? min(i / cpb, nb - 1) : nb - 1;
}

__global__ void __launch_bounds__(kThreads) column_keys_kernel(
    const int* __restrict__ order, const int* __restrict__ blk,
    const int* __restrict__ gcodes, int* __restrict__ bq, int* __restrict__ gq, int N,
    int ncov) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= N) return;
  const int n = order != nullptr ? order[q] : q;
  bq[q] = blk[n];
  for (int c = 0; c < ncov; ++c) gq[c * N + q] = gcodes[c * N + n];
}

// K1's table of old statistics: row (b * n_spans + s) = [row sums K | batch
// sums K*B] of the columns of span s of the input R that fall in block b
// this round; cluster rows k0 .. k0 + ks - 1 of it per CTA (blockIdx.y).
// Slices of 32 columns come in through cp.async, kBSStages in flight;
// warp w owns the blocks b = w mod kWarps and its lanes the cluster rows
// lane + 32 m, so every table entry has one writer and a block's columns
// are added in order.
constexpr int kBSStages = 4;
constexpr int kBSC = 32;  // columns a slice
__global__ void __launch_bounds__(kThreads) block_stats_kernel(
    const float* __restrict__ R,       // (K, N) the round's input R
    const int* __restrict__ bq,        // (N,) block of each column
    const int* __restrict__ gq,        // (ncov, N) batch rows of each column
    float* __restrict__ old,           // (nb * n_spans, P) out
    long long N, int span, int n_spans, int K, int B, int ncov, int nb, int KS) {
  extern __shared__ __align__(16) float smem[];
  const int P = K + K * B + 2;
  const int k0 = blockIdx.y * KS, ks = min(KS, K - k0);
  const int tab_n = nb * (B + 1) * KS;
  const int stage = KS * (kBSC + 1) + (1 + ncov) * kBSC;
  float* tab = smem;  // [nb][B+1][KS]: batch rows, then the row sum at B
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  for (int i = tid; i < tab_n; i += kThreads) tab[i] = 0.f;
  const long long c0 = static_cast<long long>(blockIdx.x) * span;
  const int nc = static_cast<int>(max(0LL, min(static_cast<long long>(span), N - c0)));
  const int nsl = (nc + kBSC - 1) / kBSC;

  auto load = [&](int q) {
    float* Rs = smem + tab_n + (q % kBSStages) * stage;
    int* bs = reinterpret_cast<int*>(Rs + KS * (kBSC + 1));
    const long long p0 = c0 + static_cast<long long>(q) * kBSC;
    const int n = min(kBSC, nc - q * kBSC);
    for (int i = tid; i < ks * kBSC; i += kThreads) {
      const int k = i / kBSC, u = i - k * kBSC;
      cp_async4(Rs + k * (kBSC + 1) + u, u < n ? R + (k0 + k) * N + p0 + u : R, u < n ? 4 : 0);
    }
    for (int i = tid; i < (1 + ncov) * kBSC; i += kThreads) {
      const int c = i / kBSC, u = i - c * kBSC;
      const int* src = c == 0 ? bq + p0 + u : gq + (c - 1) * N + p0 + u;
      cp_async4(bs + i, u < n ? src : bq, u < n ? 4 : 0);
    }
  };
  __syncthreads();
  for (int q = 0; q < kBSStages - 1; ++q) {
    if (q < nsl) load(q);
    cp_async_commit();
  }
  for (int q = 0; q < nsl; ++q) {
    cp_async_wait<kBSStages - 2>();
    __syncthreads();
    if (q + kBSStages - 1 < nsl) load(q + kBSStages - 1);
    cp_async_commit();
    const float* Rs = smem + tab_n + (q % kBSStages) * stage;
    const int* bs = reinterpret_cast<const int*>(Rs + KS * (kBSC + 1));
    const int n = min(kBSC, nc - q * kBSC);
    unsigned mask = __ballot_sync(0xffffffffu, lane < n && bs[lane] % kWarps == w);
    while (mask) {
      const int u = __ffs(mask) - 1;
      mask &= mask - 1;
      float* tb = tab + bs[u] * (B + 1) * KS;
      float r[4], v[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int k = lane + 32 * m;
        r[m] = k < ks ? Rs[k * (kBSC + 1) + u] : 0.f;
      }
      for (int c = -1; c < ncov; ++c) {  // the row sum, then each batch row
        float* row = tb + (c < 0 ? B : bs[(1 + c) * kBSC + u]) * KS;
#pragma unroll
        for (int m = 0; m < 4; ++m) v[m] = lane + 32 * m < ks ? row[lane + 32 * m] : 0.f;
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (lane + 32 * m < ks) row[lane + 32 * m] = v[m] + r[m];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < nb * ks; i += kThreads) {
    const int b = i / ks, k = i - b * ks;
    float* row = old + (static_cast<long long>(b) * n_spans + blockIdx.x) * P;
    const float* tb = tab + b * (B + 1) * KS;
    row[k0 + k] = tb[B * KS + k];
    for (int g = 0; g < B; ++g) row[K + (k0 + k) * B + g] = tb[g * KS + k];
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
// the table `old`; always: write the penalty table row. kSched (K12): the
// commit after the block at position pos of the round's order (pos < 0:
// the round's first commit), the blocks read from the schedule row as the
// assign launch reads them: add the block's ncta = ceil(tiles * tileT /
// Tc) partial rows, and remove the block at pos + 1, if any: its tiles'
// split rows each from (v0 * split) on.
template <bool kSched>
__global__ void __launch_bounds__(kThreads) round_commit_kernel(
    const float* __restrict__ part, int ncta, float* __restrict__ E,
    float* __restrict__ O, const float* __restrict__ old, int old0, int nold,
    int wrap, const float* __restrict__ Pr, const float* __restrict__ theta,
    float* __restrict__ pen, float* __restrict__ acc, int K, int B, int add,
    const int* __restrict__ sched, const int* __restrict__ blocks, int pos, int nb,
    int NT, int split, int tileT, int Tc) {
  if (kSched) {
    const int rt = sched[0];
    const int rm = pos + 1 < nb ? sched[2 + pos] : -1;
    add = pos >= 0;
    ncta = add ? (blocks[sched[1 + pos]] * tileT + Tc - 1) / Tc : 0;
    old0 = rm >= 0 ? ((blocks[nb + rm] + rt) % NT) * split : 0;
    nold = rm >= 0 ? blocks[rm] * split : 0;
  }
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

// K1's positions cell0 .. cell0 + ncells - 1 of perm over the (L, d) copy
// of Z.
int k1_assign(const void* Yt, const void* Z, const void* gcodes, const void* perm,
              const void* pen, const void* sigma, void* R, void* part,
              long long L, long long cell0, int ncells, int K, int d, int B,
              int ncov, int T, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(assign_kernel<true>), cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (ncells + T - 1) / T;
  assign_kernel<true><<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Yt), static_cast<const float*>(Z),
      static_cast<const int*>(gcodes), static_cast<const int*>(perm),
      static_cast<const float*>(pen), static_cast<const float*>(sigma),
      static_cast<float*>(R), static_cast<float*>(part), L, cell0, ncells, K, d, B, ncov, T,
      0, 0, 0, nullptr, nullptr, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

// K12's tile walk over the (d, L) layout for the block at position pos of
// the round's schedule row `sched` (blocks: the (2, nb) block table),
// `grid` CTAs of T cells (the largest block's).
int k12_assign(const void* Yt, const void* Z, const void* gcodes, const void* pen,
               const void* sigma, void* R, void* part, long long L, int K, int d, int B,
               int ncov, int T, int tileT, int NT, const void* sched, const void* blocks,
               int pos, int nb, int grid, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(assign_kernel<false>), cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  assign_kernel<false><<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Yt), static_cast<const float*>(Z),
      static_cast<const int*>(gcodes), nullptr, static_cast<const float*>(pen),
      static_cast<const float*>(sigma), static_cast<float*>(R), static_cast<float*>(part), L,
      0, 0, K, d, B, ncov, T, tileT, NT, 0, static_cast<const int*>(sched),
      static_cast<const int*>(blocks), pos, nb);
  return static_cast<int>(cudaGetLastError());
}

// The block of every cell, then the block and batch rows of each column
// of the input R (order nullptr: the columns are the cells).
int k1_keys(const void* perm, const void* order, const void* gcodes, void* blk, void* bq,
            void* gq, int N, int ncov, int cpb, int nb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((N + kThreads - 1) / kThreads);
  block_of_cell_kernel<<<grid, kThreads, 0, st>>>(static_cast<const int*>(perm),
                                                  static_cast<int*>(blk), N, cpb, nb);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  column_keys_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int*>(order), static_cast<const int*>(blk),
      static_cast<const int*>(gcodes), static_cast<int*>(bq), static_cast<int*>(gq), N, ncov);
  return static_cast<int>(cudaGetLastError());
}

int k1_block_stats(const void* R, const void* bq, const void* gq, void* old, long long N,
                   int span, int n_spans, int K, int B, int ncov, int nb, int KS,
                   int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      block_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_spans, (K + KS - 1) / KS);
  block_stats_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R), static_cast<const int*>(bq),
      static_cast<const int*>(gq), static_cast<float*>(old), N, span, n_spans, K, B, ncov,
      nb, KS);
  return static_cast<int>(cudaGetLastError());
}

int k1_commit(const void* part, int ncta, void* E, void* O, const void* old,
              int old0, int nold, int wrap, const void* Pr, const void* theta,
              void* pen, void* acc, int K, int B, int add, void* stream) {
  const int smem_bytes = (kSlices + 2) * (B + 3) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(round_commit_kernel<false>), cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  round_commit_kernel<false><<<K, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), ncta, static_cast<float*>(E),
      static_cast<float*>(O), static_cast<const float*>(old), old0, nold, wrap,
      static_cast<const float*>(Pr), static_cast<const float*>(theta),
      static_cast<float*>(pen), static_cast<float*>(acc), K, B, add, nullptr, nullptr, 0, 0,
      0, 0, 0, 1);
  return static_cast<int>(cudaGetLastError());
}

// K12's commit after the block at position pos (-1: the round's first) of
// the schedule row `sched`; the table of old statistics has `split` rows a
// tile, NT * split in all, and the assign launches T cells a CTA.
int k12_commit(const void* part, void* E, void* O, const void* old, const void* Pr,
               const void* theta, void* pen, void* acc, int K, int B, const void* sched,
               const void* blocks, int pos, int nb, int NT, int split, int tileT, int T,
               void* stream) {
  const int smem_bytes = (kSlices + 2) * (B + 3) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(round_commit_kernel<true>), cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  round_commit_kernel<true><<<K, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), 0, static_cast<float*>(E), static_cast<float*>(O),
      static_cast<const float*>(old), 0, 0, NT * split, static_cast<const float*>(Pr),
      static_cast<const float*>(theta), static_cast<float*>(pen), static_cast<float*>(acc),
      K, B, 0, static_cast<const int*>(sched), static_cast<const int*>(blocks), pos, nb, NT,
      split, tileT, T);
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
