// Ungapped X-drop seed extension for Hopper (sm_90a): a warp per seed.
//
// Replaces no TPU kernel: the JAX package computes this with XLA ops
// (genomeworks_tpu/extender/xdrop.py:220 _extend_direction, over
// _make_chunk_body: a lax.while_loop over 128-position chunks of every seed
// in lockstep; and :257 _count_matches). This is the design of the
// reference instead (cudaextender ungapped_xdrop_kernels.cu,
// find_high_scoring_segment_pairs: one warp per seed), with the semantics of
// the port's plain versions extender/xdrop_plain.py (extend_direction_plain,
// count_matches_plain):
//   - right: positions seed + o, o = 0, 1, ...; left: seed - o, o = 1, 2, ...;
//     a position scores sub[8 * target code + query code] when it lies in
//     the sequences (right: below both lengths; left: at or above 0), else 0;
//     reads are clamped to the sequences, so any seed has an answer;
//   - the running maximum of the cumulative score starts at 0 (position -1
//     right, 0 left), keeps the earliest position on ties, and a carried
//     maximum wins ties with a later tile;
//   - the extension stops at the first position where the running maximum
//     exceeds the cumulative score by more than xdrop (the answer is the
//     maximum at the position before it), or after a tile whose last
//     position left the sequences; the answer does not depend on the tile
//     width, so the tiles here give the JAX package's 128-wide answers;
//   - int32 arithmetic throughout (wrapping, as the reference's).
//
// What bounds it on this card, and what the design does about it:
// - A seed reads its diagonal's bases once, two bytes a position, and does
//   about 16 int32 operations a position: the work is small and the
//   extensions are short (a random pair drops in its first 32-64 positions,
//   a homologous one runs to the next indel). Over a batch of millions of
//   seeds the kernel is bound by the integer instructions it issues a
//   position (the card's integer pipe takes a warp's instruction in two
//   cycles); one long extension alone is bound by its tiles' chain of
//   dependent shuffles. The first design gave each lane one position of a
//   32-position tile: a shuffle prefix sum, a running maximum that
//   shuffled two values a step and two ballots, some 70 instructions and 20
//   dependent cross-lane steps every 32 positions (22x its bound).
// - Now lane l scores K = 8 consecutive positions of a tile of 32 K = 256
//   (K = 4 and K = 16 were slower on the card). Inside a lane there are no
//   shuffles: its scores and prefix sums are registers. One warp scan of
//   the lane sums (the tile's base score folded into lane 0) gives each
//   lane its cumulative score e.
// - Where no score of the tile can leave int32 (`exact`: the scores, the
//   base score and the carried maximum within bounds that keep every sum
//   and difference the path forms in int32), each lane's maximum, minimum
//   and largest inner drop are computed before the scans, off their chain;
//   the lanes' maxima go through one scan of values alone (the carried
//   maximum folded into lane 0), a lane drops if its largest deficit,
//   max(R - e - cmin, dmax), exceeds xdrop, and one ballot gives the first
//   lane that drops. Positions are looked up only where the maximum moves
//   or the walk ends: the lowest lane whose own maximum it is (ballot),
//   after the carried maximum, which wins ties. Other tiles run in wrapping
//   int32: a scan of (value, position) pairs and the drop test position by
//   position.
// - A lane's codes come as 4-byte words (K / 4 + 1 aligned loads a
//   sequence and a funnel shift; the left direction reverses the bytes with
//   __byte_perm), after one warp-wide test that the tile's window lies
//   inside both sequences; else (a sequence end, a seed out of range) each
//   lane reads its bytes one by one, clamped. The next tile's loads are
//   issued before this tile runs (their addresses depend only on the
//   tile), so the L2 latency overlaps the tile; the left direction's first
//   tile is loaded before the right one runs.
// - The 64-entry score matrix sits in shared memory (entry 64 scores 0, for
//   positions past the walk), loaded once a block.
// - Both directions of a seed run in one warp, and a whole batch is one
//   launch.
// - The match counts of the seeds the entropy needs are a second kernel,
//   xdrop_count_kernel, bound by the bytes it reads (two a position) and the
//   latency of its loads (a warp a seed, one byte a lane, took 17x its
//   bound in 2-3 serial passes). 8 lanes a seed and 4 seeds a warp; the
//   seed's range inside both sequences is found once, and each lane reads
//   its K positions as aligned words (words_at and a funnel shift, as the
//   extension does) where the seed's whole window lies in both sequences,
//   else clamped bytes. Equal codes below 4 are found four at a time (a
//   zero-byte test of (t ^ q) | (t & ~3)); the counts by base come from
//   four popcounts of bit planes (all, bit 0, bit 1, both), summed over the
//   seed's lanes by shuffles. A seed's segment of 30-100 positions is one
//   or two passes of 64.
//
// Debug build (-DXDROP_STATS=1, off in normal builds): lane 0 of each warp
// adds its seeds, tiles over both directions and clock64() cycles over the
// seed to g_xdrop_stats (the XS_* counters), read with xdrop_stats.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;    // warps (seeds) a block
// positions a lane scores a tile; ops/xdrop_cuda.py LANE_POSITIONS, which the
// edge sets' lane and tile facts read, says the same
constexpr int K = 8;
constexpr int TILE = 32 * K;
constexpr int KW = K / 4;  // 4-byte words of a lane's codes
// the match counts: lanes a seed (a power of two up to 32), seeds a warp,
// warps a block
constexpr int COUNT_LANES = 8;
constexpr int COUNT_SEEDS = 32 / COUNT_LANES;
constexpr int COUNT_WARPS = 8;

#ifdef XDROP_STATS
enum { XS_SEEDS, XS_TILES, XS_CYCLES, XS_COUNT };
__device__ unsigned long long g_xdrop_stats[XS_COUNT];
#endif

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int clamp_index(int p, int L) {
  return p < 0 ? 0 : (p >= L ? L - 1 : p);
}

// A lane's K codes of one sequence as they lie in memory: whole aligned
// words w[0 .. KW] and the byte shift of the first code in w[0] (or the
// codes themselves from shift 0, read one by one where clamps apply).
struct Bytes {
  uint32_t w[KW + 1];
  int sh;
};

struct Codes {
  Bytes t, q;
};

// One direction of one seed: the sequences, the seed, and n, the positions
// of its walk that lie in the sequences (a prefix of the walk).
struct Walk {
  const uint8_t* q;
  const uint8_t* t;
  int Lq, Lt, qs, ts;
  unsigned n;
};

template <bool LEFT>
__device__ __forceinline__ Walk make_walk(const uint8_t* q, const uint8_t* t, int Lq, int Lt,
                                          int qs, int ts) {
  const long long n = LEFT ? (ts < qs ? ts : qs)
                           : ((long long)Lt - ts < (long long)Lq - qs ? (long long)Lt - ts
                                                                      : (long long)Lq - qs);
  return {q, t, Lq, Lt, qs, ts, (unsigned)(n < 0 ? 0 : n)};
}

__device__ __forceinline__ Bytes words_at(const uint8_t* p) {
  Bytes b;
  const uint32_t* a = reinterpret_cast<const uint32_t*>((uintptr_t)p & ~(uintptr_t)3);
#pragma unroll
  for (int i = 0; i <= KW; ++i) b.w[i] = __ldg(a + i);
  b.sh = (int)((uintptr_t)p & 3);
  return b;
}

__device__ __forceinline__ Bytes bytes_clamped(const uint8_t* seq, int L, int lo) {
  Bytes b;
#pragma unroll
  for (int i = 0; i <= KW; ++i) b.w[i] = 0u;
#pragma unroll
  for (int x = 0; x < K; ++x)
    b.w[x >> 2] |= (uint32_t)seq[clamp_index(lo + x, L)] << (8 * (x & 3));
  b.sh = 0;
  return b;
}

// The codes of a tile of 32 K walk positions from walk index `start`: lane
// l's are start + K l .. start + K l + K - 1, right at ts + i, left at
// ts - 1 - i (the query likewise). Where the whole tile's window, with 3
// bytes before it and 4 after, lies in both sequences, each lane reads
// aligned words; else (near a sequence end, or a seed out of range) each
// lane reads its bytes one by one, clamped. Nothing is read past the walk.
template <bool LEFT>
__device__ __forceinline__ Codes load_tile(const Walk& w, unsigned start) {
  const int lane = threadIdx.x & 31;
  Codes c;
  if (start >= w.n) {
#pragma unroll
    for (int i = 0; i <= KW; ++i) c.t.w[i] = c.q.w[i] = 0u;
    c.t.sh = c.q.sh = 0;
    return c;
  }
  // the lowest index of the tile's window, and this lane's K bytes in it
  const int tlo = LEFT ? w.ts - (int)start - TILE : w.ts + (int)start;
  const int qlo = LEFT ? w.qs - (int)start - TILE : w.qs + (int)start;
  const int off = (LEFT ? 31 - lane : lane) * K;
  if (tlo >= 3 && tlo <= w.Lt - TILE - 4 && qlo >= 3 && qlo <= w.Lq - TILE - 4) {
    c.t = words_at(w.t + tlo + off);
    c.q = words_at(w.q + qlo + off);
  } else {
    c.t = bytes_clamped(w.t, w.Lt, tlo + off);
    c.q = bytes_clamped(w.q, w.Lq, qlo + off);
  }
  return c;
}

// The scores of a lane's K positions from walk index i0, in walk order:
// sub[8 target + query], or 0 (sub's entry 64) at and past n.
template <bool LEFT>
__device__ __forceinline__ void scores(const Codes& c, unsigned i0, unsigned n,
                                       const int* sub, int (&s)[K]) {
  uint32_t idx[KW];
#pragma unroll
  for (int i = 0; i < KW; ++i) {
    // the left direction's bytes lie in memory in the reverse walk order
    const int k = LEFT ? KW - 1 - i : i;
    uint32_t a = __funnelshift_r(c.t.w[k], c.t.w[k + 1], 8 * c.t.sh);
    uint32_t b = __funnelshift_r(c.q.w[k], c.q.w[k + 1], 8 * c.q.sh);
    if (LEFT) {
      a = __byte_perm(a, 0, 0x0123);
      b = __byte_perm(b, 0, 0x0123);
    }
    idx[i] = ((a & 0x07070707u) << 3) | (b & 0x07070707u);
  }
  if (i0 + K > n) {  // the walk's last tile: positions at and past n score 0
    const unsigned v = i0 >= n ? 0u : n - i0;
#pragma unroll
    for (int i = 0; i < KW; ++i) {
      const unsigned keep = v >= 4u * (i + 1) ? 0xffffffffu
                            : v <= 4u * i    ? 0u
                                             : (1u << (8 * (v - 4 * i))) - 1u;
      idx[i] = (idx[i] & keep) | (0x40404040u & ~keep);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) s[j] = sub[(idx[j >> 2] >> (8 * (j & 3))) & 0xffu];
}

// What a direction carries from tile to tile, and its answer.
struct State {
  int score;  // cumulative score before the tile
  int mx;     // running maximum
  int mpos;   // and its earliest position
  int best, best_pos;
};

// The exact path's bounds: with no score of the tile above 2^26 / TILE
// in magnitude and the base score and carried maximum within 2^30 - 2^28,
// no sum, maximum or difference the path forms leaves int32.
constexpr int EXACT_SPAN = 1 << 26;
constexpr int EXACT_BASE = (1 << 30) - (1 << 28);

// One tile of 32 K positions from walk index `start`, run by the whole
// warp. Returns true when the direction is done (st.best, st.best_pos set).
//
// The lane's K scores and prefix sums c; a warp scan of the lane sums (the
// tile's base score folded into lane 0) gives e, the cumulative score before
// the lane. Where no score of the tile can leave int32 (`exact`, from the
// bounds above), cumulative scores are e + c, and the lane's summary is
// computed before the scans: cmax (at its first position jmax), cmin and
// dmax, the largest drop inside the lane; the lanes' maxima go through a scan
// of values alone, and a lane drops if max(R - e - cmin, dmax) > xdrop, R
// the running maximum of the lanes below it (and the carried one). Otherwise
// the tile runs in wrapping int32: a scan of (value, position) pairs and the
// drop test position by position.
template <bool LEFT>
__device__ __forceinline__ bool tile(const Walk& w, unsigned start, const Codes& cur,
                                     const int* sub, int span, int xdrop, State& st) {
  const int lane = threadIdx.x & 31;
  const unsigned i0 = start + lane * K;
  const int o0 = (int)i0 + (LEFT ? 1 : 0);  // the lane's first position
  int s[K];
  scores<LEFT>(cur, i0, w.n, sub, s);
  int c[K];  // the lane's prefix sums
  c[0] = s[0];
#pragma unroll
  for (int j = 1; j < K; ++j) c[j] = wrap_add(c[j - 1], s[j]);
  const bool exact = span <= EXACT_SPAN && st.score >= -EXACT_BASE &&
                     st.score <= EXACT_BASE && st.mx <= EXACT_BASE;
  // the lane's summary, off the scans' chain (exact tiles)
  int cmax = c[0], jmax = 0, cmin = c[0], dmax = 0;
#pragma unroll
  for (int j = 1; j < K; ++j) {
    if (c[j] > cmax) {
      cmax = c[j];
      jmax = j;
    }
    cmin = min(cmin, c[j]);
    dmax = max(dmax, cmax - c[j]);
  }
  // the cumulative score at the lane's last position: a scan of lane sums
  int incl = lane == 0 ? wrap_add(c[K - 1], st.score) : c[K - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl = wrap_add(incl, v);
  }
  const int e = wrap_sub(incl, c[K - 1]);  // before the lane
  const bool last_tile = start + 32u * K >= w.n;
  if (exact) {
    const int own = e + cmax;  // the lane's maximum, at o0 + jmax
    int m = lane == 0 ? max(own, st.mx) : own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) m = max(m, __shfl_up_sync(FULL, m, d));
    int rv = __shfl_up_sync(FULL, m, 1);  // the maximum before the lane
    if (lane == 0) rv = st.mx;
    const unsigned dropped = __ballot_sync(FULL, max(rv - e - cmin, dmax) > xdrop);
    const int m31 = __shfl_sync(FULL, m, 31);
    if (dropped || last_tile || m31 > st.mx) {
      // where a value first appears: the carried maximum wins ties, then
      // the lowest lane of `lanes` whose own maximum it is
      auto where = [&](int v, unsigned lanes) {
        const unsigned at = __ballot_sync(FULL, own == v && ((lanes >> lane) & 1u));
        const int p = __shfl_sync(FULL, o0 + jmax, at ? __ffs(at) - 1 : 0);
        return v == st.mx ? st.mpos : p;
      };
      if (dropped) {
        // the first lane that drops finds its first drop and the maximum
        // just before it, which is its own or the lanes' below
        const int f = __ffs(dropped) - 1;
        int av = rv, ap = -1, run = rv, rp = -1;
        bool drop = false;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int cj = e + c[j];
          if (!drop) {
            av = run;
            ap = rp;
          }
          if (cj > run) {
            run = cj;
            rp = o0 + j;
          }
          drop = drop || run - cj > xdrop;
        }
        const int v = __shfl_sync(FULL, av, f);
        const int p = __shfl_sync(FULL, ap, f);
        const int below = where(v, (1u << f) - 1u);
        st.best = v;
        st.best_pos = p >= 0 ? p : below;
        return true;
      }
      const int p31 = where(m31, FULL);
      if (last_tile) {  // the tile left the sequences
        st.best = m31;
        st.best_pos = p31;
        return true;
      }
      st.mx = m31;
      st.mpos = p31;
    }
  } else {
    // the lane's earliest maximum, then a scan of them, the lower lane (and
    // the carried maximum, folded into lane 0) winning ties
    int lm = wrap_add(e, c[0]), lp = o0;
#pragma unroll
    for (int j = 1; j < K; ++j) {
      const int v = wrap_add(e, c[j]);
      if (v > lm) {
        lm = v;
        lp = o0 + j;
      }
    }
    if (lane == 0 && !(lm > st.mx)) {
      lm = st.mx;
      lp = st.mpos;
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, lm, d);
      const int p = __shfl_up_sync(FULL, lp, d);
      if (lane >= d && v >= lm) {
        lm = v;
        lp = p;
      }
    }
    int rv = __shfl_up_sync(FULL, lm, 1), rp = __shfl_up_sync(FULL, lp, 1);
    if (lane == 0) {
      rv = st.mx;
      rp = st.mpos;
    }
    // the lane's first drop; the answer is the maximum just before it
    int av = rv, ap = rp;
    bool drop = false;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int cj = wrap_add(e, c[j]);
      if (!drop) {
        av = rv;
        ap = rp;
      }
      if (cj > rv) {
        rv = cj;
        rp = o0 + j;
      }
      drop = drop || wrap_sub(rv, cj) > xdrop;
    }
    const unsigned dropped = __ballot_sync(FULL, drop);
    if (dropped) {
      const int first = __ffs(dropped) - 1;  // the first lane that drops
      st.best = __shfl_sync(FULL, av, first);
      st.best_pos = __shfl_sync(FULL, ap, first);
      return true;
    }
    const int m31 = __shfl_sync(FULL, lm, 31), p31 = __shfl_sync(FULL, lp, 31);
    if (last_tile) {  // the tile left the sequences
      st.best = m31;
      st.best_pos = p31;
      return true;
    }
    st.mx = m31;
    st.mpos = p31;
  }
  st.score = __shfl_sync(FULL, incl, 31);
  return false;
}

// One direction of one seed, run by the whole warp, from its first tile's
// codes `first`. Each tile's loads of the next tile are issued before it
// runs. Returns the maximum and its position in *best / *best_pos (every
// lane gets them) and the tiles it took.
template <bool LEFT>
__device__ int extend_one(const Walk& w, const Codes& first, const int* sub, int span,
                          int xdrop, int* best, int* best_pos) {
  State st{0, 0, LEFT ? 0 : -1, 0, 0};
  Codes cur = first;
  int tiles = 1;
  for (unsigned start = 0;; start += TILE, ++tiles) {
    const Codes nxt = load_tile<LEFT>(w, start + TILE);
    if (tile<LEFT>(w, start, cur, sub, span, xdrop, st)) break;
    cur = nxt;
  }
  *best = st.best;
  *best_pos = st.best_pos;
  return tiles;
}

__global__ void __launch_bounds__(WARPS * 32)
xdrop_extend_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                    const int* __restrict__ qpos, const int* __restrict__ tpos,
                    const int* __restrict__ sub_g, int* __restrict__ out, int S, int Lq,
                    int Lt, int xdrop) {
  __shared__ int sub[65];  // entry 64: the score of a position past the walk
  __shared__ int span;     // the largest |score| times a tile, saturated
  if (threadIdx.x < 32) {
    const int a = sub_g[threadIdx.x], b = sub_g[threadIdx.x + 32];
    sub[threadIdx.x] = a;
    sub[threadIdx.x + 32] = b;
    // |INT_MIN| saturates; the tiles then take the wrapping path
    const unsigned m = max(a == INT_MIN ? 0x7fffffffu : (unsigned)abs(a),
                           b == INT_MIN ? 0x7fffffffu : (unsigned)abs(b));
    unsigned top = m;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) top = max(top, __shfl_xor_sync(FULL, top, d));
    if (threadIdx.x == 0) {
      sub[64] = 0;
      span = top > 0x7fffffffu / TILE ? 0x7fffffff : (int)(top * TILE);
    }
  }
  __syncthreads();
  const long long seed = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (seed >= S) return;  // a whole warp leaves together
#ifdef XDROP_STATS
  const long long c0 = clock64();
#endif
  const int lane = threadIdx.x & 31;
  const int qs = qpos[seed], ts = tpos[seed];
  const Walk right = make_walk<false>(q, t, Lq, Lt, qs, ts);
  const Walk left = make_walk<true>(q, t, Lq, Lt, qs, ts);
  // both directions' first tiles: the left one's loads wait under the right walk
  const Codes right0 = load_tile<false>(right, 0);
  const Codes left0 = load_tile<true>(left, 0);
  int r_best, r_pos, l_best, l_pos;
  int tiles = extend_one<false>(right, right0, sub, span, xdrop, &r_best, &r_pos);
  tiles += extend_one<true>(left, left0, sub, span, xdrop, &l_best, &l_pos);
  if (lane == 0) {
    int4 r;
    r.x = r_best;
    r.y = r_pos;
    r.z = l_best;
    r.w = l_pos;
    reinterpret_cast<int4*>(out)[seed] = r;
#ifdef XDROP_STATS
    atomicAdd(&g_xdrop_stats[XS_SEEDS], 1ull);
    atomicAdd(&g_xdrop_stats[XS_TILES], (unsigned long long)tiles);
    atomicAdd(&g_xdrop_stats[XS_CYCLES], (unsigned long long)(clock64() - c0));
#endif
  }
  (void)tiles;
}

// 0x80 in each byte of x that is zero, else 0 (exact for every byte value).
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x | 0x7f7f7f7fu);
}

// COUNT_LANES lanes a seed, COUNT_SEEDS seeds a warp. Each lane counts K
// positions of its seed's segment a pass (8 j .. 8 j + 7 of the pass, from
// the first position inside both sequences), so a pass covers COUNT_LANES *
// K positions; the counts are summed over the seed's lanes by shuffles.
__global__ void __launch_bounds__(COUNT_WARPS * 32)
xdrop_count_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                   const int* __restrict__ qpos, const int* __restrict__ tpos,
                   const int* __restrict__ left, const int* __restrict__ right,
                   int* __restrict__ counts, int n, int Lq, int Lt) {
  constexpr int PASS = COUNT_LANES * K;
  const int lane = threadIdx.x & 31, part = lane % COUNT_LANES;
  const long long k = ((long long)blockIdx.x * COUNT_WARPS + (threadIdx.x >> 5)) * COUNT_SEEDS +
                      lane / COUNT_LANES;
  // the positions o in [0, left + right] whose target t0 + o and query
  // q0 + o both lie in their sequences: npos of them from tlo and qlo (a
  // seed past n has none; its lanes stay for the shuffles)
  int tlo = 0, qlo = 0, npos = 0;
  if (k < n) {
    const long long l = left[k];
    const long long span = l + right[k];
    const long long t0 = tpos[k] - l, q0 = qpos[k] - l;
    const long long lo = max(0ll, max(-t0, -q0));
    const long long hi = min(span, min((long long)Lt - 1 - t0, (long long)Lq - 1 - q0));
    if (hi >= lo) {
      tlo = (int)(t0 + lo);
      qlo = (int)(q0 + lo);
      npos = (int)(hi - lo + 1);
    }
  }
  const int passes = (npos + PASS - 1) / PASS;
  // aligned words where the seed's whole window, with 3 bytes before it and
  // 4 after, lies in both sequences (once a seed); else bytes, clamped
  const bool words = tlo >= 3 && qlo >= 3 && (long long)tlo + (long long)passes * PASS + 4 <= Lt &&
                     (long long)qlo + (long long)passes * PASS + 4 <= Lq;
  // matched positions, and of them those whose code has bit 0, bit 1, both
  int n_all = 0, n_b0 = 0, n_b1 = 0, n_11 = 0;
  for (int p = 0; p < passes; ++p) {
    const int x = p * PASS + part * K;
    Bytes tw, qw;
    if (words) {
      tw = words_at(t + tlo + x);
      qw = words_at(q + qlo + x);
    } else {
      tw = bytes_clamped(t, Lt, tlo + x);
      qw = bytes_clamped(q, Lq, qlo + x);
    }
    const int valid = min(npos - x, K);  // positions of this lane inside the segment
#pragma unroll
    for (int h = 0; h < KW; ++h) {
      const uint32_t a = __funnelshift_r(tw.w[h], tw.w[h + 1], 8 * tw.sh);
      const uint32_t b = __funnelshift_r(qw.w[h], qw.w[h + 1], 8 * qw.sh);
      const int vb = valid - 4 * h;  // bytes of this word inside
      const uint32_t vmask = vb >= 4 ? 0x01010101u : vb <= 0 ? 0u : 0x01010101u >> (32 - 8 * vb);
      // equal codes below 4: (a ^ b) | (a & ~3) is a zero byte
      const uint32_t m = (zero_bytes((a ^ b) | (a & 0xfcfcfcfcu)) >> 7) & vmask;
      const uint32_t b0 = a & m, b1 = (a >> 1) & m;
      n_all += __popc(m);
      n_b0 += __popc(b0);
      n_b1 += __popc(b1);
      n_11 += __popc(b0 & b1);
    }
  }
#pragma unroll
  for (int d = COUNT_LANES / 2; d > 0; d >>= 1) {
    n_all += __shfl_xor_sync(FULL, n_all, d);
    n_b0 += __shfl_xor_sync(FULL, n_b0, d);
    n_b1 += __shfl_xor_sync(FULL, n_b1, d);
    n_11 += __shfl_xor_sync(FULL, n_11, d);
  }
  if (part == 0 && k < n) {
    int4 c;
    c.x = n_all - n_b0 - n_b1 + n_11;
    c.y = n_b0 - n_11;
    c.z = n_b1 - n_11;
    c.w = n_11;
    reinterpret_cast<int4*>(counts)[k] = c;
  }
}

}  // namespace

extern "C" {

// Both directions of S seeds: out int32 (S, 4) = (right max, right
// position, left max, left position). Returns cudaGetLastError() after the
// launch.
int xdrop_extend_launch(const void* q, const void* t, const void* qpos, const void* tpos,
                        const void* sub, void* out, int S, int Lq, int Lt, int xdrop,
                        void* stream) {
  if (S > 0) {
    const long long blocks = ((long long)S + WARPS - 1) / WARPS;
    xdrop_extend_kernel<<<(unsigned)blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)q, (const uint8_t*)t, (const int*)qpos, (const int*)tpos,
        (const int*)sub, (int*)out, S, Lq, Lt, xdrop);
  }
  return (int)cudaGetLastError();
}

// The debug build's counters (seeds, tiles over both directions, cycles:
// lane 0's clock64 over each seed, summed) into `out` (host memory), zeroed
// when `reset`; returns -1 in a normal build.
int xdrop_stats(unsigned long long* out, int reset) {
#ifdef XDROP_STATS
  cudaError_t e = cudaMemcpyFromSymbol(out, g_xdrop_stats, sizeof(g_xdrop_stats));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zero[XS_COUNT] = {};
    e = cudaMemcpyToSymbol(g_xdrop_stats, zero, sizeof(zero));
  }
  return int(e);
#else
  (void)out;
  (void)reset;
  return -1;
#endif
}

// A/C/G/T match counts of n final segments: counts int32 (n, 4).
int xdrop_count_launch(const void* q, const void* t, const void* qpos, const void* tpos,
                       const void* left, const void* right, void* counts, int n, int Lq,
                       int Lt, void* stream) {
  if (n > 0) {
    constexpr int per_block = COUNT_WARPS * COUNT_SEEDS;
    const long long blocks = ((long long)n + per_block - 1) / per_block;
    xdrop_count_kernel<<<(unsigned)blocks, COUNT_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)q, (const uint8_t*)t, (const int*)qpos, (const int*)tpos,
        (const int*)left, (const int*)right, (int*)counts, n, Lq, Lt);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
