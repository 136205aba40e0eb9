// Banded unit-cost edit-distance DP with 2-bit traceback codes, for Hopper
// (sm_90a). One warp per alignment for bands up to WARP_MAX_BAND; one
// thread block per alignment past it.
//
// Replaces the Pallas TPU kernel
// genomeworks_tpu/ops/banded_nw_pallas.py:banded_nw_forward_pallas (kernel
// body _kernel), with the semantics of the port's plain version
// aligner/banded_nw.py:banded_nw_forward_plain (which is those of the JAX
// scan genomeworks_tpu/aligner/banded_nw.py:banded_nw_forward):
//   - row 0 is D(0, j) = j for j = dlo + k in [0, tlen], else INF;
//   - per row i: base = min(prev[k] + sub, prev[k + 1] + 1); j == 0 -> i;
//     INF outside j in [0, tlen]; the insertion closure
//     cur[k] = min(k + cummin_k(base[k] - k), INF);
//   - code: insertion (cur == cur[k-1] + 1) before deletion
//     (cur == prev[k+1] + 1) before match/mismatch (sub);
//   - every one of the M rows is computed, rows past qlen included (from
//     the padded query), so the whole (B, M16, W) plane is defined;
//   - fits = W >= |tlen - qlen| + 1;
//   - dist (optional, NULL for none): the edit distance D(qlen, tlen) at
//     band column tlen - qlen - dlo of row qlen; tlen where qlen == 0; INF
//     where the pair does not fit or qlen > M (the JAX scan's ``final``).
//     Written once a pair: by the lane (thread) that holds that cell when it
//     computes row qlen, else by lane 0 (thread 0) before the first row.
//     Each kernel is instantiated with and without it (DIST), so a launch
//     with dist NULL runs the code without the output.
// Codes are packed 16 rows per int32: row i in word (i - 1) / 16 at bits
// 2 * ((i - 1) % 16).
//
// What bounds it on this card, and what the design does about it:
// - The work is M * W cells of a few int32 ops each, and the output is
//   4 bytes per 16 cells; neither bound is near: a row is a chain of
//   dependent steps (the prefix min over the band), so the kernel is bound by
//   the latency of one row times M.
// - banded_nw_warp_kernel<CPT> (W <= WARP_MAX_BAND): one warp per
//   alignment, four a block, no block barrier. Each lane owns CPT =
//   ceil(W / 32) (a power of two, at least 2) adjacent band columns; the
//   previous row stays in registers. The lanes run one row apart (lane l
//   computes row s - l at step s), so the insertion closure is a running
//   min that enters a lane from the lane on its left, computed a step
//   before (one shuffle), in place of a scan over the row: the step's
//   chain is that shuffle, the lane's first column, the up-neighbour of
//   its last column from the next lane (one shuffle of that first column),
//   and its last column; the lane's running min of base - c over its other
//   columns is computed beside the chain. (A scan over the row costs six
//   dependent shuffles a row: 513 cycles a row at W = 64 on an H100,
//   against 334 skewed; experiments/torch_aligner_check.py.)
//   The target bases slide one column a row (j = i + dlo + k): each lane
//   keeps its columns' bases in registers, packed four to a word, and takes
//   the new one from the next lane's second; lane 31's comes from a chunk
//   of 32 bases the warp loads 32 steps ahead, and lane 0's query base
//   likewise (the others take theirs from the lane on their left). Codes
//   of 16 rows stay in registers; every 16 rows a lane stores one word per
//   column.
// - banded_nw_kernel<CPT> (wider bands, up to MAX_THREADS * 32, where a
//   block is faster than one warp): one block per alignment. Each thread
//   owns CPT adjacent band columns. The previous row lives in shared memory
//   (W + 1 ints, the last one INF). A row is: read prev, a sequential
//   prefix min over the thread's columns, a block-wide exclusive prefix min
//   (warp shuffles, then one word per warp scanned by warp 0), write cur,
//   read the left neighbour's cur. Three block barriers a row. Each thread
//   keeps the codes of its columns for 16 rows in registers and stores one
//   word per column every 16 rows.
//
// Debug build (-DNW_STATS=1, off in normal builds): lane 0 of each warp
// kernel alignment adds its clock64() cycles over the rows and its rows to
// g_nw_stats (the NS_* counters), read with banded_nw_stats.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (genomeworks_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INF = 1 << 24;
constexpr int BIG = 0x3fffffff;  // identity of min in the prefix scan
constexpr int RPW = 16;          // rows per code word
constexpr int MAX_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NW_WARPS = 4;  // alignments a block of the warp kernel
// the widest band the warp kernel takes, 16 columns a lane. At 1024 (32
// columns a lane: 231 registers, no spills) one warp took 9.5 ms on 32
// pairs of 10 kb where the block kernel took 5.9; at 512, 5.1 against 5.8
// (an H100 80GB HBM3 at 700 W, experiments/torch_aligner_check.py)
constexpr int WARP_MAX_BAND = 32 * 16;

enum { NS_PAIRS, NS_ROWS, NS_CYCLES, NS_COUNT };
#ifdef NW_STATS
__device__ unsigned long long g_nw_stats[NS_COUNT];
#endif

__device__ __forceinline__ int floor_div2(int e) { return e >= 0 ? e / 2 : -((1 - e) / 2); }

template <int CPT, bool DIST>
__global__ void __launch_bounds__(32 * NW_WARPS)
banded_nw_warp_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                      const int* __restrict__ qlen, const int* __restrict__ tlen,
                      int* __restrict__ codes, uint8_t* __restrict__ fits,
                      int* __restrict__ dist, int B, int M, int N, int W) {
  static_assert(CPT >= 2, "a lane's second base and column feed the wavefront");
  constexpr int TW = (CPT + 3) / 4;  // words of the lane's target bases, 4 a word
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * NW_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps leave; the kernel uses no block barrier
  const int ql = qlen[b], tl = tlen[b];
  const int diff = tl - ql;
  const int ad = diff < 0 ? -diff : diff;
  const int dlo = min(0, diff) - floor_div2(W - 1 - ad);
  const uint8_t* qb = q + (size_t)b * M;
  const uint8_t* tb = t + (size_t)b * N;
  int* out = codes + (size_t)b * ((M + RPW - 1) / RPW) * W;
  const bool fit = W >= ad + 1;
  if (lane == 0) fits[b] = fit;
  // the final cell's band column (or -1, and lane 0 writes dist now), and
  // the step at which the lane that holds it computes row qlen (or -1)
  int kend = -1, s_end = -1;
  if constexpr (DIST) {
    kend = fit && ql >= 1 && ql <= M ? diff - dlo : -1;
    if (lane == 0 && kend < 0) dist[b] = fit && ql == 0 ? tl : INF;
    if (kend >= lane * CPT && kend < (lane + 1) * CPT) s_end = ql + lane;
  }

  // Lane l computes DP row i = s - l at step s: the rows run skewed one
  // lane apart, so a lane's left neighbour (lane l - 1, row i) is from the
  // step before, and the up-neighbour of its last column (lane l + 1, row
  // i - 1) is that lane's first column of this step, which goes first.
  const int k0 = lane * CPT;
  auto tbase = [&](int p) -> unsigned { return tb[min(max(p, 0), N - 1)]; };
  // row 0; the target bases t[clip(j - 1)], j - 1 = i + dlo + k - 1, of the
  // lane's columns at its row before step 1 (i = -lane)
  int pv[CPT];
  unsigned tw[TW], acc[CPT];
#pragma unroll
  for (int w = 0; w < TW; ++w) tw[w] = 0u;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int k = k0 + c, j0 = dlo + k;
    pv[c] = (k < W && j0 >= 0 && j0 <= tl) ? j0 : INF;
    tw[c / 4] |= tbase(-lane + dlo + k - 1) << (8 * (c % 4));
    acc[c] = 0u;
  }
  // lane 0's query base at step s, q[s - 1], and lane 31's new target base
  // (column 32 * CPT - 1 at row s - 31), 32 steps a chunk, one a lane; the
  // next chunk is in flight while the warp computes this one
  auto qat = [&](int s) -> unsigned { return s >= 1 && s <= M ? qb[s - 1] : 0u; };
  auto tat = [&](int s) -> unsigned { return tbase(s + dlo + 32 * CPT - 33); };
  unsigned qc = qat(lane), tc = tat(lane), qn = qat(32 + lane), tn = tat(32 + lane);
  unsigned qv = 0u;  // the query base of the lane's row
  int lastc = INF;   // the lane's last column of its row
#ifdef NW_STATS
  const long long t0 = clock64();
#endif

  for (int s = 1; s <= M + 31; ++s) {
    const int sc = s & 31;
    if (sc == 0) {
      qc = qn;
      tc = tn;
      qn = qat(s + 32 + lane);
      tn = tat(s + 32 + lane);
    }
    // from the step before: the query base and the row's left neighbour
    // from lane l - 1, the target base that enters from lane l + 1 (its
    // second, one row up the diagonal)
    const unsigned qin = __shfl_sync(FULL, qc, sc);
    const unsigned tin = __shfl_sync(FULL, tc, sc);
    const unsigned qup = __shfl_up_sync(FULL, qv, 1);
    const unsigned nb = (__shfl_down_sync(FULL, tw[0], 1) >> 8) & 0xffu;
    int left = __shfl_up_sync(FULL, lastc, 1);
    if (lane == 0) left = INF;
    qv = lane == 0 ? qin : qup;
    const unsigned inc = lane == 31 ? tin : nb;
    if constexpr (CPT < 4) {
      tw[0] = (tw[0] >> 8) | (inc << (8 * (CPT - 1)));
    } else {
#pragma unroll
      for (int w = 0; w + 1 < TW; ++w) tw[w] = __funnelshift_r(tw[w], tw[w + 1], 8);
      tw[TW - 1] = __funnelshift_r(tw[TW - 1], inc, 8);
    }
    const int i = s - lane;
    const bool active = i >= 1 && i <= M;
    const unsigned qrep = qv * 0x01010101u;
    unsigned ne[TW];  // 0xff in each byte whose base differs from the query's
#pragma unroll
    for (int w = 0; w < TW; ++w) ne[w] = __vcmpne4(tw[w], qrep);
    const int jb = i + dlo + k0;  // j of the lane's first column
    const bool edge = jb <= 0 || jb + CPT - 1 > tl;  // a column at j <= 0 or past tlen
    auto sub = [&](int c) -> int { return (ne[c / 4] >> (8 * (c % 4))) & 1; };
    // base = min(diagonal + sub, up + 1); j == 0 -> i, INF outside [0, tlen]
    int base[CPT];
    auto bound = [&](int c) {
      const int j = jb + c;
      if (j == 0) base[c] = i;
      if (unsigned(j) > unsigned(tl)) base[c] = INF;  // j < 0 or j > tlen
    };
#pragma unroll
    for (int c = 0; c + 1 < CPT; ++c) {
      base[c] = min(pv[c] + sub(c), pv[c + 1] + 1);
      if (edge) bound(c);
    }
    // cur = min(base, left + 1, INF) column by column, the insertion closure:
    // cur[c] = min(c + min(run[c], left + 1), INF), run[c] = min over c' <= c
    // of base[c'] - c'. The lane's first column goes first: the lane on its
    // left needs it for the up-neighbour of its last column
    const int cur0 = k0 < W ? min(min(base[0], left + 1), INF) : INF;
    // a lane still before its row 1 offers row 0
    int up_last = __shfl_down_sync(FULL, active ? cur0 : pv[0], 1) + 1;  // prev[k0 + CPT] + 1
    if (lane == 31) up_last = INF + 1;
    base[CPT - 1] = min(pv[CPT - 1] + sub(CPT - 1), up_last);
    if (edge) bound(CPT - 1);
    int cur[CPT];
    int run = BIG;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      run = min(run, base[c] - c);
      cur[c] = k0 + c < W ? min(min(run, left + 1) + c, INF) : INF;
    }
    if (active) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int up = c + 1 < CPT ? pv[c + 1] + 1 : up_last;
        const int lft = c ? cur[c - 1] : left;
        const int code = cur[c] == lft + 1 ? 2 : (cur[c] == up ? 3 : sub(c));
        acc[c] = __funnelshift_r(acc[c], unsigned(code), 2);  // row i enters at the top
      }
      if constexpr (DIST) {
        if (s == s_end) {
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            if (k0 + c == kend) dist[b] = cur[c];
        }
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) pv[c] = cur[c];
      lastc = cur[CPT - 1];
      const int rr = (i - 1) % RPW;
      if (rr == RPW - 1 || i == M) {
        int* o = out + (size_t)((i - 1) / RPW) * W + k0;
        const int sh = 2 * (RPW - 1 - rr);  // a last partial word down to bit 0
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          if (k0 + c < W) o[c] = int(acc[c] >> sh);
      }
    }
  }
#ifdef NW_STATS
  if (lane == 0) {
    atomicAdd(&g_nw_stats[NS_PAIRS], 1ull);
    atomicAdd(&g_nw_stats[NS_ROWS], (unsigned long long)M);
    atomicAdd(&g_nw_stats[NS_CYCLES], (unsigned long long)(clock64() - t0));
  }
#endif
}

template <int CPT, bool DIST>
__global__ void __launch_bounds__(MAX_THREADS)
banded_nw_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                 const int* __restrict__ qlen, const int* __restrict__ tlen,
                 int* __restrict__ codes, uint8_t* __restrict__ fits, int* __restrict__ dist,
                 int M, int N, int W) {
  extern __shared__ int smem[];
  int* row = smem;           // W + 1 ints
  int* wmin = smem + W + 1;  // one per warp
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = blockDim.x >> 5;
  const int ql = qlen[b], tl = tlen[b];
  const int diff = tl - ql;
  const int ad = diff < 0 ? -diff : diff;
  const int dlo = min(0, diff) - floor_div2(W - 1 - ad);
  const int M16 = (M + RPW - 1) / RPW;
  const uint8_t* qb = q + (size_t)b * M;
  const uint8_t* tb = t + (size_t)b * N;
  int* out = codes + (size_t)b * M16 * W;
  const bool fit = W >= ad + 1;
  if (tid == 0) fits[b] = fit;
  // the final cell's band column, or -1 where thread 0 writes dist now
  int kend = -1;
  if constexpr (DIST) {
    kend = fit && ql >= 1 && ql <= M ? diff - dlo : -1;
    if (tid == 0 && kend < 0) dist[b] = fit && ql == 0 ? tl : INF;
  }

  const int k0 = tid * CPT;
  for (int k = tid; k <= W; k += blockDim.x) {
    const int j0 = dlo + k;
    row[k] = (k < W && j0 >= 0 && j0 <= tl) ? j0 : INF;
  }
  __syncthreads();

  unsigned acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0u;

  for (int i = 1; i <= M; ++i) {
    const int qi = qb[i - 1];
    int pv[CPT + 1];
#pragma unroll
    for (int c = 0; c <= CPT; ++c) pv[c] = (k0 + c <= W) ? row[k0 + c] : INF;

    int sub[CPT], up[CPT], x[CPT];
    int run = BIG;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int k = k0 + c;
      const int j = i + dlo + k;
      const int jc = min(max(j - 1, 0), N - 1);
      sub[c] = qi != tb[jc];
      up[c] = pv[c + 1] + 1;
      int base = min(pv[c] + sub[c], up[c]);
      if (j == 0) base = i;
      if (j < 0 || j > tl) base = INF;
      run = min(run, k < W ? base - k : BIG);
      x[c] = run;
    }
    // block-wide exclusive prefix min of the threads' column minima
    int v = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v = min(v, o);
    }
    int excl = __shfl_up_sync(0xffffffffu, v, 1);
    if (lane == 0) excl = BIG;
    if (lane == 31) wmin[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int w = lane < nwarp ? wmin[lane] : BIG;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w = min(w, o);
      }
      const int e = __shfl_up_sync(0xffffffffu, w, 1);
      if (lane < nwarp) wmin[lane] = lane == 0 ? BIG : e;
    }
    __syncthreads();
    excl = min(excl, wmin[warp]);

    int cur[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int k = k0 + c;
      cur[c] = min(min(excl, x[c]) + k, INF);
      if (k < W) row[k] = cur[c];
      if constexpr (DIST) {
        if (i == ql && k == kend) dist[b] = cur[c];
      }
    }
    __syncthreads();

    const int r = (i - 1) % RPW;
    int left = k0 > 0 && k0 <= W ? row[k0 - 1] : INF;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int code = cur[c] == left + 1 ? 2 : (cur[c] == up[c] ? 3 : sub[c]);
      acc[c] |= unsigned(code) << (2 * r);
      left = cur[c];
    }
    if (r == RPW - 1 || i == M) {
      const size_t w0 = (size_t)((i - 1) / RPW) * W;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        if (k0 + c < W) out[w0 + k0 + c] = int(acc[c]);
        acc[c] = 0u;
      }
    }
  }
}

template <int CPT, bool DIST>
int launch_warp(const void* q, const void* t, const void* qlen, const void* tlen, void* codes,
                void* fits, void* dist, int B, int M, int N, int W, cudaStream_t stream) {
  banded_nw_warp_kernel<CPT, DIST><<<(B + NW_WARPS - 1) / NW_WARPS, 32 * NW_WARPS, 0, stream>>>(
      (const uint8_t*)q, (const uint8_t*)t, (const int*)qlen, (const int*)tlen, (int*)codes,
      (uint8_t*)fits, (int*)dist, B, M, N, W);
  return int(cudaGetLastError());
}

template <int CPT, bool DIST>
int launch(const void* q, const void* t, const void* qlen, const void* tlen, void* codes,
           void* fits, void* dist, int B, int M, int N, int W, cudaStream_t stream) {
  const int cols = (W + CPT - 1) / CPT;
  const int threads = ((cols + 31) / 32) * 32;
  const size_t smem = size_t(W + 1 + 32) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        banded_nw_kernel<CPT, DIST>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  banded_nw_kernel<CPT, DIST><<<B, threads, smem, stream>>>(
      (const uint8_t*)q, (const uint8_t*)t, (const int*)qlen, (const int*)tlen, (int*)codes,
      (uint8_t*)fits, (int*)dist, M, N, W);
  return int(cudaGetLastError());
}

// The warp kernel for bands up to WARP_MAX_BAND, the block kernel past it.
template <bool DIST>
int launch_any(const void* q, const void* t, const void* qlen, const void* tlen, void* codes,
               void* fits, void* dist, int B, int M, int N, int W, cudaStream_t s) {
  if (W <= WARP_MAX_BAND) {
    const int cpt = (W + 31) / 32;  // columns a lane must take (at least 2)
    if (cpt <= 2) return launch_warp<2, DIST>(q, t, qlen, tlen, codes, fits, dist, B, M, N, W, s);
    if (cpt <= 4) return launch_warp<4, DIST>(q, t, qlen, tlen, codes, fits, dist, B, M, N, W, s);
    if (cpt <= 8) return launch_warp<8, DIST>(q, t, qlen, tlen, codes, fits, dist, B, M, N, W, s);
    return launch_warp<16, DIST>(q, t, qlen, tlen, codes, fits, dist, B, M, N, W, s);
  }
  const int per = (W + MAX_THREADS - 1) / MAX_THREADS;  // columns a thread must take
  if (per <= 2) return launch<2, DIST>(q, t, qlen, tlen, codes, fits, dist, B, M, N, W, s);
  if (per <= 4) return launch<4, DIST>(q, t, qlen, tlen, codes, fits, dist, B, M, N, W, s);
  if (per <= 8) return launch<8, DIST>(q, t, qlen, tlen, codes, fits, dist, B, M, N, W, s);
  if (per <= 16) return launch<16, DIST>(q, t, qlen, tlen, codes, fits, dist, B, M, N, W, s);
  if (per <= 32) return launch<32, DIST>(q, t, qlen, tlen, codes, fits, dist, B, M, N, W, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launch B alignments on `stream`: the warp kernel for bands up to
// WARP_MAX_BAND, the block kernel past it. `dist` (int32 (B,)) may be NULL,
// and then no distance is written. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a band over MAX_THREADS * 32 (the
// wrapper's MAX_BAND).
int banded_nw_launch(const void* q, const void* t, const void* qlen, const void* tlen,
                     void* codes, void* fits, void* dist, int B, int M, int N, int W,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dist) return launch_any<true>(q, t, qlen, tlen, codes, fits, dist, B, M, N, W, s);
  return launch_any<false>(q, t, qlen, tlen, codes, fits, nullptr, B, M, N, W, s);
}

// The widest band the warp kernel takes; wider bands run the block kernel.
int banded_nw_warp_max_band() { return WARP_MAX_BAND; }

// The debug build's counters (-DNW_STATS=1): copies the NS_COUNT counters
// (warp-kernel alignments, their rows, their cycles) into `out` (host
// memory) and zeroes them when `reset`; returns -1 in a normal build.
int banded_nw_stats(unsigned long long* out, int reset) {
#ifdef NW_STATS
  cudaError_t e = cudaMemcpyFromSymbol(out, g_nw_stats, sizeof(g_nw_stats));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zero[NS_COUNT] = {};
    e = cudaMemcpyToSymbol(g_nw_stats, zero, sizeof(zero));
  }
  return int(e);
#else
  (void)out;
  (void)reset;
  return -1;
#endif
}

}  // extern "C"
