// Batched Myers bit-vector edit distance (score only) for Hopper (sm_90a):
// a warp per alignment, a diagonal wavefront across its lanes.
//
// Replaces no TPU kernel: the JAX package runs this scan as XLA ops
// (genomeworks_tpu/aligner/myers.py:106 _myers_scan: lax.scan over target
// positions, a fori_loop over query words). The semantics are those of the
// port's plain version aligner/myers.py:myers_score_plain:
//   - per target position t < tlen, the carry into word 0 is 1 (the global
//     alignment's top row, myers_gpu.cu:414-416), and the carry ripples up
//     the words 0 .. last = max((qlen - 1) / 32, 0);
//   - the high-bit mask of word i is bit 31 below the last word, and bit
//     qlen - 1 - 32 last (clamped to 0..31) in it;
//   - only the last word's carries change the score, which starts at qlen
//     (myers_cpu.hpp:127-131); the empty query's distance (tlen) is set by
//     the caller, as the JAX package does.
//
// What bounds it on this card, and what the design does about it:
// - The work is about 22 int32 operations a query word a target position,
//   and a target position is a chain through the query's words. The first
//   design ran the whole chain in one thread per alignment, with PV and MV
//   in a global scratch (a load and a store a word a position), and 1,024
//   alignments filled 32 warps of the card: 296x its bound.
// - A warp per alignment, four a block. Lane l holds NPL consecutive query
//   words (NPL = ceil(n_words / 32), a template parameter chosen per launch,
//   at most MAX_NPL = 16): their PV, MV and four Peq masks stay in registers
//   for the whole target. At step s lane l works on target position s - l,
//   so a step's chain is the lane's NPL words, and the carry out of its top
//   word goes up one lane (one __shfl_up_sync a step, the carry as two
//   flags). Each lane takes its target codes from two ballots of 32
//   coalesced target bytes, loaded a group ahead, shifted into place once a
//   group and one bit a step. With 1,024 alignments (two warps a scheduler)
//   the kernel is then bound by the integer instructions of a step (the
//   integer pipe takes a warp's instruction in two cycles), so the step
//   carries no work it can avoid: the query is shifted up by phantom words
//   below word 0 (PV 0, MV ~0, Peq 0: they pass the carry +1 through
//   unchanged) so that word `last` is the top word of its lane, whose carry
//   out is then the score's; lane 0 keeps its own carry in in spare bits of
//   the shuffled register. Lanes above the last word's are idle: a warp
//   takes tlen + that lane's index steps.
// - Queries longer than 32 x MAX_NPL words run as chunks of 32 x MAX_NPL
//   words, one after another in the same warp: lane 31 stores each target
//   position's carry out of the chunk's top word as two bit planes (plus and
//   minus, 2 bits a position) in a scratch the wrapper allocates, and lane 0
//   reads them back as the next chunk's carries in.
//
// Debug build (-DMYERS_SCORE_STATS=1, off in normal builds): lane 0 of each
// warp adds its clock64() cycles over the alignment, its steps and chunks to
// g_score_stats (the SS_* counters), read with myers_score_stats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // warps (alignments) a block
constexpr int MAX_NPL = 16;

#ifdef MYERS_SCORE_STATS
enum { SS_ALIGNMENTS, SS_CHUNKS, SS_STEPS, SS_CYCLES, SS_COUNT };
__device__ unsigned long long g_score_stats[SS_COUNT];
#endif

int words_per_lane(int n_words) {
  const int npl = (n_words + 31) / 32;
  return npl < 1 ? 1 : (npl > MAX_NPL ? MAX_NPL : npl);
}

// One chunk of an alignment's words, run by the whole warp: lane l holds
// words u = base + l NPL + k (k < NPL) of the query shifted up by `phantoms`
// words, which lie below word 0 and pass its carry +1 through unchanged
// (PV = 0, MV = ~0, Peq = 0 is a fixed point that sends +1 up). The shift
// puts word `last` on top of its lane, so that lane's carry out is the
// score's. FIRST: word 0's carry in is +1, else lane 0 reads the chunk
// below's carries from `carry`; store (lane 31): the chunk's top carries go
// to `carry` for the chunk above. Returns the lane's sum of its carries out
// over the target (the score of lane `top`).
template <int NPL, bool FIRST>
__device__ __forceinline__ int run_chunk(const uint32_t* __restrict__ my_peq, int n_words,
                                         const uint8_t* __restrict__ my_t, int tl, int last,
                                         int base, int phantoms, int top, int hb_top,
                                         bool store, uint32_t* carry) {
  const int lane = threadIdx.x & 31;
  uint32_t e0[NPL], e1[NPL], e2[NPL], e3[NPL], pv[NPL], mv[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int w = base + lane * NPL + k - phantoms;
    const bool in = w >= 0 && w <= last;  // words above the last are never read
    e0[k] = in ? my_peq[w] : 0u;
    e1[k] = in ? my_peq[n_words + w] : 0u;
    e2[k] = in ? my_peq[2 * n_words + w] : 0u;
    e3[k] = in ? my_peq[3 * n_words + w] : 0u;
    pv[k] = w < 0 ? 0u : FULL;
    mv[k] = w < 0 ? FULL : 0u;
  }
  const int steps = tl > 0 ? tl + top : 0;
  const bool st = store && lane == 31;
  const int sh0 = FIRST && lane == 0 ? 2 : 0;  // lane 0 reads its own carry in
  int score = 0;
  int t = -lane;  // this lane's target position
  // the carry out of this lane's top word, as two flags (+1, -1); lane 0
  // keeps its own carry in (+1) in bits 2-3 and reads them through the shuffle
  uint32_t send = FIRST ? 4u : 0u;
  uint32_t out_p = 0u, out_m = 0u;  // lane 31: carries out of 32 positions
  unsigned p0 = 0u, p1 = 0u;        // the previous group's code planes
  uint32_t next = lane < tl ? my_t[lane] : 0u;
  for (int g = 0; g < steps; g += 32) {
    const unsigned g0 = __ballot_sync(FULL, next & 1u), g1 = __ballot_sync(FULL, next & 2u);
    next = g + 32 + lane < tl ? my_t[g + 32 + lane] : 0u;  // a group ahead
    // this lane's codes for positions g - lane .. g - lane + 31, bit j at step g + j
    unsigned w0 = __funnelshift_l(p0, g0, lane), w1 = __funnelshift_l(p1, g1, lane);
    uint32_t in_p = 0u, in_m = 0u;  // lane 0's carries in from the chunk below
    if (!FIRST && g < tl) {
      in_p = carry[g >> 4];
      in_m = carry[(g >> 4) + 1];
    }
    const int n = steps - g < 32 ? steps - g : 32;
    for (int j = 0; j < n; ++j, ++t) {
      const bool valid = (unsigned)t < (unsigned)tl;
      const bool b0 = w0 & 1u, b1 = w1 & 1u;
      w0 >>= 1;
      w1 >>= 1;
      uint32_t cin = __shfl_up_sync(FULL, send, 1) >> sh0;
      if (!FIRST) {
        if (lane == 0) cin = (in_p & 1u) | ((in_m & 1u) << 1);
        in_p >>= 1;
        in_m >>= 1;
      }
      uint32_t hp = cin & 1u, hm = (cin >> 1) & 1u;
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        const uint32_t eq0 = b1 ? (b0 ? e3[k] : e2[k]) : (b0 ? e1[k] : e0[k]);
        const uint32_t p = pv[k], m = mv[k];
        const uint32_t xv = eq0 | m;
        const uint32_t eq = eq0 | hm;
        const uint32_t xh = (((eq & p) + p) ^ p) | eq;
        const uint32_t ph = m | ~(xh | p);
        const uint32_t mh = p & xh;
        const uint32_t phs = (ph << 1) | hp, mhs = (mh << 1) | hm;
        if (valid) {
          pv[k] = mhs | ~(xv | phs);
          mv[k] = phs & xv;
        }
        // the top word's carry out reads bit hb_top: qlen - 1 in word last
        const int hb = k == NPL - 1 ? hb_top : 31;
        hp = (ph >> hb) & 1u;
        hm = (mh >> hb) & 1u;
      }
      send = hp | (hm << 1) | (FIRST ? 4u : 0u);
      if (valid) score += (int)hp - (int)hm;
      if (st && valid) {
        out_p |= hp << (t & 31);
        out_m |= hm << (t & 31);
        if ((t & 31) == 31 || t == tl - 1) {
          carry[(t >> 5) * 2] = out_p;
          carry[(t >> 5) * 2 + 1] = out_m;
          out_p = out_m = 0u;
        }
      }
    }
    p0 = g0;
    p1 = g1;
  }
  return score;
}

template <int NPL>
__global__ void __launch_bounds__(WARPS * 32)
myers_score_kernel(const uint32_t* __restrict__ peq, const uint8_t* __restrict__ tcodes,
                   const int* __restrict__ qlen, const int* __restrict__ tlen,
                   uint32_t* carries, int* __restrict__ out, int B, int T, int n_words) {
  constexpr int CW = 32 * NPL;  // words a chunk
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp leaves together
#ifdef MYERS_SCORE_STATS
  const long long c0 = clock64();
#endif
  const int ql = qlen[b], tl = tlen[b];
  const int last = ql > 0 ? (ql - 1) / 32 : 0;
  int hb = ql - 1 - last * 32;
  hb = hb < 0 ? 0 : (hb > 31 ? 31 : hb);
  const int phantoms = (NPL - 1 - last % NPL) % NPL;  // puts word last on a lane's top
  const int chunks = (last + phantoms) / CW + 1;
  const int top = (last + phantoms) % CW / NPL;  // the lane that holds word last
  const uint32_t* my_peq = peq + (size_t)b * 4 * n_words;
  const uint8_t* my_t = tcodes + (size_t)b * T;
  const int hb_top = lane == top ? hb : 31;
  int score = 0;
  if (chunks == 1) {
    score = run_chunk<NPL, true>(my_peq, n_words, my_t, tl, last, 0, phantoms, top, hb_top,
                                 false, nullptr);
  } else if constexpr (NPL == MAX_NPL) {
    // longer queries: chunk after chunk, the carries between them in scratch
    uint32_t* carry = carries + (size_t)b * 2 * ((T + 31) / 32);
    run_chunk<NPL, true>(my_peq, n_words, my_t, tl, last, 0, phantoms, 31, 31, true, carry);
    for (int c = 1; c < chunks; ++c) {
      __threadfence_block();  // lane 0 reads what lane 31 stored
      __syncwarp();
      const bool final = c == chunks - 1;
      score = run_chunk<NPL, false>(my_peq, n_words, my_t, tl, last, c * CW, phantoms,
                                    final ? top : 31, final ? hb_top : 31, !final, carry);
    }
  }
  if (lane == top) out[b] = ql + score;
#ifdef MYERS_SCORE_STATS
  if (lane == 0) {
    const long long steps = tl > 0 ? (long long)(chunks - 1) * (tl + 31) + tl + top : 0;
    atomicAdd(&g_score_stats[SS_ALIGNMENTS], 1ull);
    atomicAdd(&g_score_stats[SS_CHUNKS], (unsigned long long)chunks);
    atomicAdd(&g_score_stats[SS_STEPS], (unsigned long long)steps);
    atomicAdd(&g_score_stats[SS_CYCLES], (unsigned long long)(clock64() - c0));
  }
#endif
}

template <int NPL>
void launch(const void* peq, const void* tcodes, const void* qlen, const void* tlen,
            void* carries, void* out, int B, int T, int n_words, cudaStream_t stream) {
  myers_score_kernel<NPL><<<(B + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
      (const uint32_t*)peq, (const uint8_t*)tcodes, (const int*)qlen, (const int*)tlen,
      (uint32_t*)carries, (int*)out, B, T, n_words);
}

}  // namespace

extern "C" {

// Query words a lane for a launch over n_words words (1 .. 16); a query of
// more than 32 times that many words runs in chunks.
int myers_score_words_per_lane(int n_words) { return words_per_lane(n_words); }

// B alignments on `stream`. carries: uint32 (B, 2 ceil(T / 32)) scratch, read
// only when some query has more than 32 x 16 words (else it may be NULL).
// Returns cudaGetLastError() after the launch.
int myers_score_launch(const void* peq, const void* tcodes, const void* qlen, const void* tlen,
                       void* carries, void* out, int B, int T, int n_words, void* stream) {
  if (B > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (words_per_lane(n_words)) {
#define MYERS_SCORE_CASE(n) \
  case n:                   \
    launch<n>(peq, tcodes, qlen, tlen, carries, out, B, T, n_words, s); \
    break;
      MYERS_SCORE_CASE(1) MYERS_SCORE_CASE(2) MYERS_SCORE_CASE(3) MYERS_SCORE_CASE(4)
      MYERS_SCORE_CASE(5) MYERS_SCORE_CASE(6) MYERS_SCORE_CASE(7) MYERS_SCORE_CASE(8)
      MYERS_SCORE_CASE(9) MYERS_SCORE_CASE(10) MYERS_SCORE_CASE(11) MYERS_SCORE_CASE(12)
      MYERS_SCORE_CASE(13) MYERS_SCORE_CASE(14) MYERS_SCORE_CASE(15) MYERS_SCORE_CASE(16)
#undef MYERS_SCORE_CASE
    }
  }
  return (int)cudaGetLastError();
}

// The debug build's counters (alignments, chunks, steps, cycles: lane 0's
// clock64 over each alignment, summed) into `out` (host memory), zeroed when
// `reset`; returns -1 in a normal build.
int myers_score_stats(unsigned long long* out, int reset) {
#ifdef MYERS_SCORE_STATS
  cudaError_t e = cudaMemcpyFromSymbol(out, g_score_stats, sizeof(g_score_stats));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zero[SS_COUNT] = {};
    e = cudaMemcpyToSymbol(g_score_stats, zero, sizeof(zero));
  }
  return int(e);
#else
  (void)out;
  (void)reset;
  return -1;
#endif
}

}  // extern "C"
