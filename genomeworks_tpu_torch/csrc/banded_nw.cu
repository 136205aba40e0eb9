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
// - banded_nw_kernel<CPT, DIST, SPV, WMAX> (wider bands, up to 16 warps of
//   32 lanes of CPT columns; block_cols): one block per alignment, the warp
//   kernel's layout carried across warps. Global lane g = 32 w + l (warp
//   w) owns band columns g * CPT .. g * CPT + CPT - 1 and computes row
//   gs - g at global step gs, so the whole band is one skewed wavefront;
//   each warp runs its own window of steps (local step gs - 32 w) and loads
//   its own chunks of query and target bases. Inside a warp the closure and
//   the up-neighbour move by shuffles, as in the warp kernel. Across a
//   boundary two words a step move through shared memory, each read a step
//   after it is posted: lane 31's last column (the next warp's lane 0's
//   closure) and lane 0's offer, the base of its next row's first column,
//   min(diagonal + sub, up + 1), which the previous warp's lane 31 finishes
//   with its own last column (the closure) to get its up-neighbour. Each
//   word carries its global step in its top bits and is read by spinning
//   until the tag matches; no block barrier runs in the rows, and no warp
//   can run two steps ahead of a word it owes. (Named barriers between the
//   two warps of a boundary in place of the spin were 4-9 % slower at W =
//   1024 and 2048 and 1-2 % faster past 4096: experiments/
//   torch_aligner_check.py --nw.) A warp step whose committing lanes'
//   columns all lie at j in [1, tlen] takes a path with no bound, clamp or
//   column test, each min of a sum one DPX op (__viaddmin_s32); other steps,
//   at the band's edges, take the general one. The previous row is in
//   registers up to 8192 columns (at most 8 warps, 32 columns a lane); past
//   that in shared memory (SPV: column c of thread x at c * 32 WMAX + x, a
//   stride the compiler knows), 16 warps of 32 columns in at most 128
//   registers a thread. No instantiation spills.
//   (The block kernel before this one took a row as a block-wide prefix
//   min with three __syncthreads: about 1,000 cycles a row at W = 1024.)
//
// Debug build (-DNW_STATS=1, off in normal builds): lane 0 of each warp
// kernel alignment, and thread 0 of each block kernel alignment, adds its
// clock64() cycles over the rows and its rows to g_nw_stats (the NS_*
// counters), read with banded_nw_stats.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (genomeworks_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INF = 1 << 24;
constexpr int BIG = 0x3fffffff;  // identity of min in the prefix scan
constexpr int RPW = 16;          // rows per code word
constexpr unsigned FULL = 0xffffffffu;
constexpr int NW_WARPS = 4;  // alignments a block of the warp kernel
// the widest band the warp kernel takes, 16 columns a lane. At 1024 (32
// columns a lane: 231 registers, no spills) one warp took 9.5 ms on 32
// pairs of 10 kb where the block kernel took 5.9; at 512, 5.1 against 5.8
// (an H100 80GB HBM3 at 700 W, experiments/torch_aligner_check.py)
constexpr int WARP_MAX_BAND = 32 * 16;

constexpr int BLOCK_WARPS = 16;  // the block kernel's most warps an alignment
// a hand-off word: 25 value bits (INF + 1 fits), a flag, and the global
// step's low 6 bits
constexpr int LINK_BITS = 25;
constexpr unsigned LINK_VALUE = (1u << LINK_BITS) - 1u;
constexpr unsigned LINK_FLAG = 1u << LINK_BITS;
constexpr int LINK_TAG = 26;

// the warp kernel's alignments, rows and lane 0's cycles; the block
// kernel's alignments, rows, thread 0's cycles over its steps, its warps and
// their lane 0's cycles in the two waits
enum {
  NS_PAIRS, NS_ROWS, NS_CYCLES,
  NS_BLOCK_PAIRS, NS_BLOCK_ROWS, NS_BLOCK_CYCLES, NS_BLOCK_WARPS, NS_BLOCK_WAIT,
  NS_COUNT
};
#ifdef NW_STATS
__device__ unsigned long long g_nw_stats[NS_COUNT];
#endif

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

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

// A hand-off word between neighbouring warps: the global step's low 6 bits
// over a flag and a 25-bit value (every value posted is at most INF).
__device__ __forceinline__ void post_link(unsigned* slot, int step, unsigned word) {
  *(volatile unsigned*)slot = (unsigned(step) << LINK_TAG) | word;
}

// Spins until `slot` holds the word of global step `step`; its flag and
// value. All lanes of the warp read the same word, so they leave together.
__device__ __forceinline__ unsigned wait_link(const unsigned* slot, int step) {
  const unsigned tag = unsigned(step) << LINK_TAG;
  unsigned v;
  do {
    v = *(const volatile unsigned*)slot;
  } while ((v ^ tag) >> LINK_TAG);
  return v & (LINK_FLAG | LINK_VALUE);
}

template <int CPT, bool DIST, bool SPV, int WMAX>
__global__ void __launch_bounds__(32 * WMAX)
banded_nw_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                 const int* __restrict__ qlen, const int* __restrict__ tlen,
                 int* __restrict__ codes, uint8_t* __restrict__ fits, int* __restrict__ dist,
                 int M, int N, int W) {
  static_assert(CPT >= 3, "a lane's second column is not its last");
  constexpr int TW = (CPT + 3) / 4;  // words of the lane's target bases, 4 a word
  // a word a lane, warp and direction, by step parity: a word is read one
  // step after it is posted, and rewritten two steps after. Every lane
  // posts (no branch); only lane 31's link_a word and lane 0's link_b word
  // are read
  __shared__ unsigned link_a[2][BLOCK_WARPS][32], link_b[2][BLOCK_WARPS][32];
  // SPV: the previous row, column c of thread x at c * SPS + x, this row's
  // values at (CPT + c) * SPS + x and the codes at (2 CPT + c) * SPS + x (a
  // stride the compiler knows: each column is an offset of one address)
  extern __shared__ int spv[];
  constexpr int SPS = 32 * WMAX;
  const int T = blockDim.x, nw = T >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int ql = qlen[b], tl = tlen[b];
  const int diff = tl - ql;
  const int ad = diff < 0 ? -diff : diff;
  const int dlo = min(0, diff) - floor_div2(W - 1 - ad);
  const uint8_t* qb = q + (size_t)b * M;
  const uint8_t* tb = t + (size_t)b * N;
  int* out = codes + (size_t)b * ((M + RPW - 1) / RPW) * W;
  const bool fit = W >= ad + 1;
  // tag 62: the first words read carry tags 32 w + 31 and 32 w + 32 (mod 64:
  // 0, 31, 32 or 63), and each later one the tag after a word its producer
  // has written
  for (int x = threadIdx.x; x < 2 * BLOCK_WARPS * 32; x += T)
    (&link_a[0][0][0])[x] = (&link_b[0][0][0])[x] = 62u << LINK_TAG;
  if (threadIdx.x == 0) fits[b] = fit;
  const int k0 = threadIdx.x * CPT;  // the lane's first band column
  const int cols = W - k0;           // its columns inside the band (if under CPT)
  // the final cell's band column (or -1, and thread 0 writes dist now), and
  // the local step at which the lane that holds it computes row qlen (or -1)
  int kend = -1, s_end = -1;
  if constexpr (DIST) {
    kend = fit && ql >= 1 && ql <= M ? diff - dlo : -1;
    if (threadIdx.x == 0 && kend < 0) dist[b] = fit && ql == 0 ? tl : INF;
    if (kend >= k0 && kend < k0 + CPT) s_end = ql + lane;
  }

  // Lane l of warp w computes row i = s - l at local step s (global step
  // s + 32 w). The previous row: registers, or the thread's CPT words of
  // shared memory.
  int pvr[SPV ? 1 : CPT], curr[SPV ? 1 : CPT];
  int* const pvs = spv + threadIdx.x;
  auto pv = [&](int c) -> int& {
    if constexpr (SPV) return pvs[c * SPS];
    else return pvr[c];
  };
  auto cur = [&](int c) -> int& {
    if constexpr (SPV) return pvs[(CPT + c) * SPS];
    else return curr[c];
  };
  unsigned accr[SPV ? 1 : CPT];
  auto acc = [&](int c) -> unsigned& {
    if constexpr (SPV) return reinterpret_cast<unsigned&>(pvs[(2 * CPT + c) * SPS]);
    else return accr[c];
  };
  auto tbase = [&](int p) -> unsigned { return tb[min(max(p, 0), N - 1)]; };
  unsigned tw[TW];
#pragma unroll
  for (int w = 0; w < TW; ++w) tw[w] = 0u;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int k = k0 + c, j0 = dlo + k;
    pv(c) = (k < W && j0 >= 0 && j0 <= tl) ? j0 : INF;
    tw[c / 4] |= tbase(-lane + dlo + k - 1) << (8 * (c % 4));
    acc(c) = 0u;
  }
  // lane 0's query base at local step s, and lane 31's new target base, 32
  // steps a chunk as in the warp kernel, at this warp's column offset
  const int dlw = dlo + 32 * CPT * warp;
  auto qat = [&](int s) -> unsigned { return s >= 1 && s <= M ? qb[s - 1] : 0u; };
  auto tat = [&](int s) -> unsigned { return tbase(s + dlw + 32 * CPT - 33); };
  unsigned qc = qat(lane), tc = tat(lane), qn = qat(32 + lane), tn = tat(32 + lane);
  unsigned qv = 0u;
  int lastc = INF;
  const bool has_left = warp > 0, has_right = warp + 1 < nw;
  // What lane 0 hands the left warp's lane 31 for its row r (lane 0's
  // previous row in pv, its query base qr and its first column's target
  // base tr): the first column's base, min(diagonal + sub, up + 1) with the
  // band's bounds, from which lane 31 finishes the column itself with its
  // own last column of that row (the closure); or, flagged, the column's
  // value where lane 0 has no row r (row 0 before row 1).
  auto offer_word = [&](int r, unsigned qr, unsigned tr, int p0, int p1) -> unsigned {
    int bc = min(p0 + int(qr != tr), p1 + 1);
    const int j = r + dlo + k0;
    bc = j == 0 ? r : bc;
    bc = unsigned(j) > unsigned(tl) ? INF : bc;
    return r < 1 || r > M ? LINK_FLAG | unsigned(p0) : unsigned(bc);
  };
  // this lane's words, and the two it reads: the left warp's lane 31's and
  // the right warp's lane 0's; step parity p at + p * LINK_PARITY
  constexpr int LINK_PARITY = BLOCK_WARPS * 32;
  unsigned* const link_out_a = &link_a[0][warp][lane];
  unsigned* const link_out_b = &link_b[0][warp][lane];
  const unsigned* const link_in_a = &link_a[0][has_left ? warp - 1 : 0][31];
  const unsigned* const link_in_b = &link_b[0][has_right ? warp + 1 : 0][0];
  __syncthreads();  // the link words are set; the only block barrier
  // lane 0's offers for its rows 0 and 1, read by the left warp's lane 31
  // at global steps 32 w and 32 w + 1
  post_link(link_out_b + ((32 * warp - 1) & 1) * LINK_PARITY, 32 * warp - 1,
            LINK_FLAG | unsigned(pv(0)));
  post_link(link_out_b + ((32 * warp) & 1) * LINK_PARITY, 32 * warp,
            offer_word(1, qat(1), (tw[0] >> 8) & 0xffu, pv(0), pv(1)));
#ifdef NW_STATS
  const long long t0 = clock64();
  long long waited = 0;  // lane 0's cycles in the two waits
#endif

  for (int s = 1; s <= M + 31; ++s) {
    const int gs = s + 32 * warp;  // the global step, the links' tag
    const int sc = s & 31;
    if (sc == 0) {
      qc = qn;
      tc = tn;
      qn = qat(s + 32 + lane);
      tn = tat(s + 32 + lane);
    }
    const unsigned qin = __shfl_sync(FULL, qc, sc);
    const unsigned tin = __shfl_sync(FULL, tc, sc);
    const unsigned qup = __shfl_up_sync(FULL, qv, 1);
    const unsigned nb = (__shfl_down_sync(FULL, tw[0], 1) >> 8) & 0xffu;
    // lane 0's query base at its next row, for its offer
    const unsigned qnext = __shfl_sync(FULL, ((s + 1) & 31) ? qc : qn, (s + 1) & 31);
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
    // a lane past the band's last column (in the last warp) never commits:
    // its previous row stays INF, which is what it offers the lane on its left
    const bool active = i >= 1 && i <= M && cols > 0;
    const unsigned qrep = qv * 0x01010101u;
    unsigned ne[TW];  // 0xff in each byte whose base differs from the query's
#pragma unroll
    for (int w = 0; w < TW; ++w) ne[w] = __vcmpne4(tw[w], qrep);
    auto sub = [&](int c) -> int { return (ne[c / 4] >> (8 * (c % 4))) & 1; };
    const int jb = i + dlo + k0;  // j of the lane's first column
    // base = min(diagonal + sub, up + 1); j == 0 -> i, INF outside [0, tlen]
    auto bound = [&](int c, int v) -> int {
      const int j = jb + c;
      if (j == 0) v = i;
      if (unsigned(j) > unsigned(tl)) v = INF;  // j < 0 or j > tlen
      return v;
    };
    // cur = min(base, left + 1, INF) column by column, the insertion closure:
    // cur[c] = min(c + min(run[c], left + 1), INF), run[c] = min over c' <= c
    // of base[c'] - c'. The runs of all but the last column do not need the
    // left neighbour: they go first, then the wait for the left warp's word.
    // GEN: the general step, for a warp with a lane whose row has a column
    // at j <= 0 or past tlen, or past the band. Otherwise every column of
    // the warp's rows is at j in [1, tlen], so each base and each cur is an
    // edit distance under INF (the band's previous row there is finite): no
    // bound, no clamp, no column test, and each min of a sum is one DPX op.
    int up_last;
    auto step = [&](auto gen) {
      constexpr bool GEN = decltype(gen)::value;
      int run = 0;
#pragma unroll
      for (int c = 0; c + 1 < CPT; ++c) {
        int bc;
        if constexpr (GEN) {
          bc = bound(c, min(pv(c) + sub(c), pv(c + 1) + 1));
        } else {
          bc = __viaddmin_s32(pv(c + 1), 1, pv(c) + sub(c));
        }
        run = c ? __viaddmin_s32(bc, -c, run) : bc;
        cur(c) = run;
      }
      // the left warp's word of the step before: its last column, lane 0's
      // closure
      if (has_left && s <= M) {  // lane 0's row is in 1..M
#ifdef NW_STATS
        const long long w0 = clock64();
#endif
        const unsigned v = wait_link(link_in_a + ((gs - 1) & 1) * LINK_PARITY, gs - 1);
        if (lane == 0) left = int(v & LINK_VALUE);
#ifdef NW_STATS
        waited += clock64() - w0;  // the loop has read its word
#endif
      }
      // the first column goes first: the lane on the left needs it for the
      // up-neighbour of its last column
      const int left1 = left + 1;
      int cur0;
      if constexpr (GEN) {
        cur0 = cols > 0 ? min(min(cur(0), left1), INF) : INF;
      } else {
        cur0 = min(cur(0), left1);
      }
      cur(0) = cur0;
      const int offer = active ? cur0 : pv(0);  // a lane before its row 1 offers row 0
      up_last = __shfl_down_sync(FULL, offer, 1) + 1;  // prev[k0 + CPT] + 1
#pragma unroll
      for (int c = 1; c + 1 < CPT; ++c) {
        if constexpr (GEN) {
          cur(c) = c < cols ? min(min(cur(c), left1) + c, INF) : INF;
        } else {
          cur(c) = min(cur(c), left1) + c;
        }
      }
      // lane 0's offer for its next row (its first column's target base
      // there is its second column's here), read by the left warp's lane 31
      // a step later; every lane posts its own
      post_link(link_out_b + (gs & 1) * LINK_PARITY, gs,
                offer_word(s + 1, qnext, (tw[0] >> 8) & 0xffu, offer, active ? cur(1) : pv(1)));
      // the last column's up-neighbour: the next lane's first column, or for
      // lane 31 the next warp's offer of the step before, finished with its
      // own last column of that row
      if (lane == 31) up_last = INF + 1;
      if (has_right && s >= 32) {  // lane 31's row s - 31 is in 1..M
#ifdef NW_STATS
        const long long w0 = clock64();
#endif
        const unsigned v = wait_link(link_in_b + ((gs - 1) & 1) * LINK_PARITY, gs - 1);
        const int x = int(v & LINK_VALUE);
        if (lane == 31) up_last = (v & LINK_FLAG ? x : min(min(x, lastc + 1), INF)) + 1;
#ifdef NW_STATS
        waited += clock64() - w0;
#endif
      }
      constexpr int c = CPT - 1;
      if constexpr (GEN) {
        const int bc = bound(c, min(pv(c) + sub(c), up_last));
        run = min(run, bc - c);
        cur(c) = c < cols ? min(min(run, left1) + c, INF) : INF;
      } else {
        run = __viaddmin_s32(__viaddmin_s32(pv(c), sub(c), up_last), -c, run);
        cur(c) = min(run, left1) + c;
      }
    };
    // (cols < CPT: the one lane, at most, that ends inside the band)
    const bool gen = active && (jb <= 0 || jb + CPT - 1 > tl || cols < CPT);
    if (__any_sync(FULL, gen)) {
      step(Flag<true>());
    } else {
      step(Flag<false>());
    }
    // lane 31's last column, read by the right warp's lane 0 a step later;
    // every lane posts its own
    if (active) lastc = cur(CPT - 1);
    post_link(link_out_a + (gs & 1) * LINK_PARITY, gs, unsigned(lastc));
    if (active) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        // cur == left + 1, cur == up + 1 (left and up as they entered it)
        const int cm1 = cur(c) - 1;
        const bool ins = cm1 == (c ? cur(c - 1) : left);
        const bool del = c + 1 < CPT ? cm1 == pv(c + 1) : cur(c) == up_last;
        const int code = ins ? 2 : (del ? 3 : sub(c));
        acc(c) = __funnelshift_r(acc(c), unsigned(code), 2);  // row i enters at the top
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) pv(c) = cur(c);
      if constexpr (DIST) {
        if (s == s_end) {
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            if (k0 + c == kend) dist[b] = cur(c);
        }
      }
      const int rr = (i - 1) % RPW;
      if (rr == RPW - 1 || i == M) {
        int* o = out + (size_t)((i - 1) / RPW) * W + k0;
        const int sh = 2 * (RPW - 1 - rr);  // a last partial word down to bit 0
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          if (c < cols) o[c] = int(acc(c) >> sh);
      }
    }
  }
#ifdef NW_STATS
  if (threadIdx.x == 0) {
    atomicAdd(&g_nw_stats[NS_BLOCK_PAIRS], 1ull);
    atomicAdd(&g_nw_stats[NS_BLOCK_ROWS], (unsigned long long)M);
    atomicAdd(&g_nw_stats[NS_BLOCK_CYCLES], (unsigned long long)(clock64() - t0));
  }
  if (lane == 0) {
    atomicAdd(&g_nw_stats[NS_BLOCK_WARPS], 1ull);
    atomicAdd(&g_nw_stats[NS_BLOCK_WAIT], (unsigned long long)waited);
  }
#endif
}

template <int CPT, bool DIST>
int launch_warp(const void* q, const void* t, const void* qlen, const void* tlen, void* codes,
                void* fits, void* dist, int B, int M, int N, int W, cudaStream_t stream) {
  banded_nw_warp_kernel<CPT, DIST><<<(B + NW_WARPS - 1) / NW_WARPS, 32 * NW_WARPS, 0, stream>>>(
      (const uint8_t*)q, (const uint8_t*)t, (const int*)qlen, (const int*)tlen, (int*)codes,
      (uint8_t*)fits, (int*)dist, B, M, N, W);
  return int(cudaGetLastError());
}

template <int CPT, bool DIST, bool SPV, int WMAX>
int launch(const void* q, const void* t, const void* qlen, const void* tlen, void* codes,
           void* fits, void* dist, int B, int M, int N, int W, cudaStream_t stream) {
  const int warps = (W + 32 * CPT - 1) / (32 * CPT);
  const size_t smem = SPV ? size_t(3 * 32 * WMAX * CPT) * sizeof(int) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        banded_nw_kernel<CPT, DIST, SPV, WMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  banded_nw_kernel<CPT, DIST, SPV, WMAX><<<B, 32 * warps, smem, stream>>>(
      (const uint8_t*)q, (const uint8_t*)t, (const int*)qlen, (const int*)tlen, (int*)codes,
      (uint8_t*)fits, (int*)dist, M, N, W);
  return int(cudaGetLastError());
}

// The block kernel's columns a lane at band W (past WARP_MAX_BAND).
int block_cols(int W) { return W <= 768 ? 4 : W <= 2048 ? 8 : W <= 4096 ? 16 : 32; }

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
  if (W > 32 * BLOCK_WARPS * 32) return int(cudaErrorInvalidValue);
  const int cpt = block_cols(W);
  if (cpt == 4) return launch<4, DIST, false, 8>(q, t, qlen, tlen, codes, fits, dist, B, M, N, W, s);
  if (cpt == 8) return launch<8, DIST, false, 8>(q, t, qlen, tlen, codes, fits, dist, B, M, N, W, s);
  if (cpt == 16)
    return launch<16, DIST, false, 8>(q, t, qlen, tlen, codes, fits, dist, B, M, N, W, s);
  if (W <= 8192)
    return launch<32, DIST, false, 8>(q, t, qlen, tlen, codes, fits, dist, B, M, N, W, s);
  return launch<32, DIST, true, BLOCK_WARPS>(q, t, qlen, tlen, codes, fits, dist, B, M, N, W, s);
}

}  // namespace

extern "C" {

// Launch B alignments on `stream`: the warp kernel for bands up to
// WARP_MAX_BAND, the block kernel past it. `dist` (int32 (B,)) may be NULL,
// and then no distance is written. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a band over 32 * BLOCK_WARPS *
// 32 (the wrapper's MAX_BAND).
int banded_nw_launch(const void* q, const void* t, const void* qlen, const void* tlen,
                     void* codes, void* fits, void* dist, int B, int M, int N, int W,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dist) return launch_any<true>(q, t, qlen, tlen, codes, fits, dist, B, M, N, W, s);
  return launch_any<false>(q, t, qlen, tlen, codes, fits, nullptr, B, M, N, W, s);
}

// The widest band the warp kernel takes; wider bands run the block kernel.
int banded_nw_warp_max_band() { return WARP_MAX_BAND; }

// The block kernel's band columns a lane at band W (4, 8, 16 or 32; its warps
// are ceil(W / (32 * that))), or 0 where W runs the warp kernel or is too
// wide.
int banded_nw_block_cols(int W) {
  return W <= WARP_MAX_BAND || W > 32 * BLOCK_WARPS * 32 ? 0 : block_cols(W);
}

// The debug build's counters (-DNW_STATS=1): copies the NS_COUNT counters
// (warp-kernel alignments, their rows, their cycles; then the block
// kernel's) into `out` (host memory) and zeroes them when `reset`; returns
// -1 in a normal build.
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
