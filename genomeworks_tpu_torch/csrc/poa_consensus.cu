// POA for Hopper (sm_90a): full-band, static-band and adaptive-band
// consensus or MSA, and the full-band graph, each window's whole chain in
// one kernel.
//
// Replaces the Pallas TPU kernel genomeworks_tpu/ops/poa_pallas.py:
// poa_consensus_pallas (kernel body _poa_kernel) in all its modes: full
// band, band_width > 0 (static; adaptive=True) and msa=True. Like the
// reference's generatePOAKernel (cudapoa_kernels.cuh:78, instantiated per
// band mode x output type at :613-1053) it runs the whole chain of one
// window in one kernel:
//
//   backbone -> [ NW -> traceback -> add alignment -> topological sort ]* ->
//   consensus | MSA | graph export
//
// Two kernels, each one warp per window, several windows a block:
// - Full band: poa_window_kernel<CPL, OUT> (OUT 0 consensus, 1 MSA, 2 the
//   graph).
// - Banded: poa_banded_kernel<BAND, OUT> (BAND 1 static, 2 adaptive; OUT 0
//   consensus, 1 MSA).
//
// Full band has the semantics of the port's plain chain (poa/torch_poa.py):
// int32 scores, the traceback priority codes (diagonal by edge order <
// vertical by edge order < horizontal), the add-alignment, sort and
// consensus tie-breaks, and the error codes 0/1/2/3/100 of jax_poa with its
// status precedence. The banded modes have those of the host oracle
// poa/banded.py (nw_align_banded_with_rerun) and its plain batched version
// poa/banded_plain.py: band rows of bw + 8 int32 slots (slot 0 the merged
// column -1 boundary, which get_score also maps column band_start to), the
// band start from the IEEE f32 gradient (recomputed wherever a row's start
// is needed, so no starts are stored), adaptive rules 1-3 in f64, the
// chunk-of-4 predecessor reads under the conservative guard, the closure
// seeded from the boundary, a traceback that re-derives each move from the
// scores (so no codes are stored), the band-shift rules 7-8 and one re-run
// (rules 5-6, the give-up at 1536), each window's own node cap, and
// cpu_reference's statuses (the first error wins). MSA adds the racon DFS
// ordering, the column map and the gapped rows (cudapoa_generate_msa.cuh).
//
// What bounds it on this card, and what the design does about it:
// - The graph state (per-node fields and the N x E edge / aligned-node
//   lists) and the NW matrices live in a per-window slab of device memory
//   that the wrapper allocates: at N = 1536, E = 50 one list alone is 307 KB,
//   over the 227 KB of shared memory a block can use. The slab holds a few
//   MB per window (poa_mode_slab_bytes), so the wrapper runs a batch in
//   chunks. A banded slab holds (N + 1) rows of the widest band a window
//   can reach (band_width + 8 static, 1544 adaptive), so no window ever
//   leaves the device for a host re-run.
// - A window's chain is a sequence of thousands of dependent steps (an NW
//   row needs its predecessor rows; a walk step needs the last one's node),
//   each a few hundred cycles of latency, not bytes or operations. The full
//   band therefore gives a window one warp, so a row costs no block-wide
//   barrier and no thread idles past the read's end, and many windows a
//   card:
//   * NW: each lane holds CPL consecutive columns of a tile of 32 * CPL in
//     registers (CPL 9 for reads up to 287 bases, 11 beyond; longer reads
//     run in tiles with a carry). Scores are kept less j * gap, so the
//     horizontal closure is a prefix max: in the lane, then one shuffle
//     scan, then the carry of the earlier tiles. The codes' tie-breaks are
//     taken in the same pass over the predecessors. A ring of the last R
//     score rows (R = 8, fewer for long reads) in shared memory serves the
//     predecessor reads at short distance, most of them; the full score
//     matrix in the slab serves the farther ones, so there is no distance
//     cap. A row goes there when the prologue finds a later row reading it
//     from beyond the ring (every row, where no ring fits). The last row
//     stays in registers when the read fits one tile. A row's metadata and
//     predecessor list are loaded a row ahead, and its codes go out a word
//     at a time through a shared-memory stage.
//   * Traceback: one lane's walk over the codes.
//   * Add: the walk's independent loads taken off its chain. The lanes
//     load 32 moves at a time into shared memory (the read's base and
//     weight, the graph node and its base, counts and first in-list slots),
//     and lane 0 walks them: a step that lands on a node no earlier step
//     changed, most steps, reads nothing from device memory. (Scanning the
//     lists one slot a lane, as the lockstep add does, measured no faster:
//     its shuffles and barriers cost what the scans saved.)
//   * Topsort: Kahn's order, from shared memory: the lanes copy each
//     node's out-count and first out-edges there, then one lane per
//     out-edge of the popped node; a ballot enqueues the nodes whose count
//     reached zero, in edge order.
//   * Consensus: one lane per in-edge, a reduction with the reference's
//     tie-breaks.
//   * The MSA's DFS and the emission walk stay on one lane.
//   The add's stage, the topsort's working set and the consensus scores
//   use the ring's shared memory when they fit it (window_paths). Else the
//   add walks on lane 0 alone, the topsort is topsort() on lane 0, and the
//   scores stay in device memory.
// - The banded modes run the same chain a warp per window
//   (poa_banded_kernel), with the full band's add, topsort and consensus:
//   * NW: each lane holds BAND_CPL = 8 consecutive band lanes (two chunks
//     of CELLS = 4, so each chunk's predecessor guard stays in one lane) of
//     a tile of 256; wider bands (adaptive, up to 1536) run in tiles with
//     the closure's carry. The closure is one shuffle scan. A ring of the
//     last R band rows (R = 8 at band 256, fewer for wider bands) in shared
//     memory serves the predecessor reads at short distance, 16 bytes at a
//     time; the farther ones come from the slab, with no distance cap.
//     Every row is also written to the slab, which the traceback reads. A
//     row's metadata and first two predecessors are loaded 32 rows ahead.
//   * Traceback: traceback_banded's walk, each move re-derived from the
//     scores. The warp guesses the next 16 moves to be diagonals to the
//     first predecessor, each lane walking to its cell through a table of
//     the rows in shared memory, checking its move as the reference would
//     and loading its cell's scores, so that a run of such moves costs one
//     round trip; other moves are lane 0's, each a round trip (its scores
//     loaded together). Its start (the first sink row with the highest
//     score at the read's last column) is found by the warp.
//   * Add: add_walk with cpu_reference's precedence (FIRST_WINS); topsort
//     and consensus as the full band (window_paths with BAND_REGION).
//   * MSA: the DFS and the rows on lane 0.
//
// Priority codes are uint8 while 3E + 1 <= 255 (E <= 84) and uint16 above,
// so E reaches 21844; the slab's code matrix grows only for E > 84.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (genomeworks_tpu_torch/ops/_build.py). Never with
// --use_fast_math: the band start needs IEEE f32 division and product.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;  // every lane of a warp
constexpr int NEG_ID = INT_MIN;      // identity of max in the prefix scan
constexpr int NEG_SINK = -(1 << 30); // jax_poa's NEG: "no sink row yet"

// banded modes (poa/banded.py)
constexpr int MIN_SCORE = -(1 << 30);
constexpr int MAX_BAND = 1536;       // MAX_ADAPTIVE_BAND_WIDTH
constexpr int PAD = 8;               // BANDED_MATRIX_RIGHT_PADDING
constexpr int CELLS = 4;             // CELLS_PER_THREAD: a predecessor read's chunk
constexpr int SHIFT_LEFT = -10, SHIFT_RIGHT = -11, LOOP_FAILED = -1;

// Debug build (-DPOA_PHASE_CLOCKS=1, off in normal builds): the chain of
// either kernel sums clock64() cycles per phase over its windows (lane 0's
// clock): NW, traceback, add, topsort, the final consensus / MSA / export;
// and counts windows, NW rows and alignment moves (every pass's, in the
// banded modes). Counters 8-14: the full band's NW row segments, cells and
// predecessor cells; the banded NW's row segments (8-11: the boundary, the
// predecessors, the closure and stores, the row's end) and its traceback's
// rounds and guessed moves (13, 14).
#ifdef POA_PHASE_CLOCKS
constexpr int PHASE_COUNTERS = 15;
__device__ unsigned long long g_phase_clocks[PHASE_COUNTERS];
#define PHASE_T0()                                                     \
  unsigned long long clk_sum_[PHASE_COUNTERS] = {0, 0, 0, 0, 0, 1};       \
  long long clk_t0_ = clock64()
#define PHASE_COUNT(k, n) clk_sum_[k] += (unsigned long long)(n)
// the NW row's segments (counters 8-12): the predecessor rows, the
// closure, the codes and ring writes, the copies to the slab, the best row;
// and the NW's cells and predecessor cells (13, 14), for the bound
#define SEG_INIT() long long seg_t_ = 0; unsigned long long seg_[7] = {}
#define SEG_CELLS(np) (seg_[5] += unsigned(rl + 1), seg_[6] += unsigned(np) * unsigned(rl + 1))
#define SEG_T0() seg_t_ = clock64()
#define SEG(k)                                          \
  do {                                                  \
    const long long seg_u_ = clock64();                 \
    seg_[k] += (unsigned long long)(seg_u_ - seg_t_);   \
    seg_t_ = seg_u_;                                    \
  } while (0)
#define SEG_FLUSH()                                                                   \
  do {                                                                                \
    if ((threadIdx.x & 31) == 0)                                                      \
      for (int k_ = 0; k_ < 7; ++k_) atomicAdd(&g_phase_clocks[8 + k_], seg_[k_]);     \
  } while (0)
#define PHASE_MARK() clk_t0_ = clock64()
#define PHASE_ADD(k)                                        \
  do {                                                      \
    const long long clk_t1_ = clock64();                    \
    clk_sum_[k] += (unsigned long long)(clk_t1_ - clk_t0_); \
    clk_t0_ = clk_t1_;                                      \
  } while (0)
#define PHASE_FLUSH()                                                              \
  do {                                                                             \
    if ((threadIdx.x & 31) == 0)                                                   \
      for (int k_ = 0; k_ < PHASE_COUNTERS; ++k_)                                    \
        atomicAdd(&g_phase_clocks[k_], clk_sum_[k_]);                             \
  } while (0)
#else
#define PHASE_T0()
#define PHASE_COUNT(k, n)
#define SEG_INIT()
#define SEG_CELLS(np)
#define SEG_T0()
#define SEG(k)
#define SEG_FLUSH()
#define PHASE_MARK()
#define PHASE_ADD(k)
#define PHASE_FLUSH()
#endif

__host__ __device__ inline size_t align_up(size_t x) { return (x + 255) & ~size_t(255); }

// Bytes of a priority code: the codes reach 3E + 1.
__host__ __device__ inline int code_bytes(int E) { return 3 * E + 1 > 255 ? 2 : 1; }

// Byte offsets of the per-window slab's arrays (int32 unless stated). The
// full-band consensus layout is slice 1's, its codes widened for E > 84;
// the other modes swap the NW matrices and add the MSA's arrays.
struct Layout {
  size_t nodes, in_count, out_count, al_count, cov, sorted, pos_of, local,
      cscore, cpred, meta, mark, in_edges, in_w, out_edges, rpred, al, ag, ar,
      scores, codes, seq_next, begin, col, chk, stack, total;
  __host__ __device__ Layout(int N, int L, int E, int A, int band = 0, int out = 0, int S = 0,
                             int W = 0) {
    size_t o = 0;
    const size_t n4 = size_t(N) * 4, ne4 = size_t(N) * E * 4;
    const size_t K = size_t(N) + L, cells = size_t(N + 1) * (L + 1);
    nodes = take(o, n4); in_count = take(o, n4); out_count = take(o, n4);
    al_count = take(o, n4); cov = take(o, n4); sorted = take(o, n4);
    pos_of = take(o, n4); local = take(o, n4); cscore = take(o, n4);
    cpred = take(o, n4); meta = take(o, n4); mark = take(o, n4);
    in_edges = take(o, ne4); in_w = take(o, ne4); out_edges = take(o, ne4);
    rpred = take(o, ne4); al = take(o, size_t(N) * A * 4);
    ag = take(o, K * 4); ar = take(o, K * 4);
    if (band == 0) {
      scores = take(o, cells * 4);
      codes = take(o, cells * code_bytes(E));  // uint8, or uint16 past E = 84
    } else {
      scores = take(o, size_t(N + 1) * W * 4);  // band rows, no codes
      codes = 0;
    }
    seq_next = begin = col = chk = stack = 0;
    if (out == 1) {
      seq_next = take(o, size_t(N) * S * 4);
      begin = take(o, size_t(S) * 4);
      col = take(o, n4);
      chk = take(o, n4);
      stack = take(o, size_t(N) * (E + A) * 4);  // see msa_stack_cap
    }
    total = o;
  }
  __host__ __device__ static size_t take(size_t& o, size_t bytes) {
    const size_t r = o;
    o = align_up(o + bytes);
    return r;
  }
};

__device__ __forceinline__ int warp_incl_max(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = max(v, u);
  }
  return v;
}


struct Win {
  int *nodes, *in_count, *out_count, *al_count, *cov, *sorted, *pos_of, *local,
      *cscore, *cpred, *meta, *mark, *in_edges, *in_w, *out_edges, *rpred, *al, *ag, *ar,
      *scores;
  uint8_t* codes;  // full band: cb bytes a code
  int N, L, E, A, cb;
  // MSA only
  int *seq_next, *begin, *col, *chk, *stack;
  int S;
};

// A window's view of the slab at `base`.
__device__ Win slab_win(uint8_t* base, const Layout& lay, int N, int L, int E, int A, int S,
                        bool msa) {
  Win w;
  w.nodes = (int*)(base + lay.nodes);
  w.in_count = (int*)(base + lay.in_count);
  w.out_count = (int*)(base + lay.out_count);
  w.al_count = (int*)(base + lay.al_count);
  w.cov = (int*)(base + lay.cov);
  w.sorted = (int*)(base + lay.sorted);
  w.pos_of = (int*)(base + lay.pos_of);
  w.local = (int*)(base + lay.local);
  w.cscore = (int*)(base + lay.cscore);
  w.cpred = (int*)(base + lay.cpred);
  w.meta = (int*)(base + lay.meta);
  w.mark = (int*)(base + lay.mark);
  w.in_edges = (int*)(base + lay.in_edges);
  w.in_w = (int*)(base + lay.in_w);
  w.out_edges = (int*)(base + lay.out_edges);
  w.rpred = (int*)(base + lay.rpred);
  w.al = (int*)(base + lay.al);
  w.ag = (int*)(base + lay.ag);
  w.ar = (int*)(base + lay.ar);
  w.scores = (int*)(base + lay.scores);
  w.codes = base + lay.codes;
  w.N = N;
  w.L = L;
  w.E = E;
  w.A = A;
  w.cb = code_bytes(E);
  w.seq_next = w.begin = w.col = w.chk = w.stack = nullptr;
  w.S = S;
  if (msa) {
    w.seq_next = (int*)(base + lay.seq_next);
    w.begin = (int*)(base + lay.begin);
    w.col = (int*)(base + lay.col);
    w.chk = (int*)(base + lay.chk);
    w.stack = (int*)(base + lay.stack);
  }
  return w;
}

// -- banded modes (poa/banded.py) ----------------------------------------------

// One NW pass's band (nw_align_banded :69-113).
struct Band {
  float gradient;
  int max_column, bw, shift, W;
};

__device__ __forceinline__ int align128(int x) { return (x + 127) / 128 * 128; }

// Width of a banded row in the slab: the widest band the mode can reach (a
// static band is fixed; adaptive rules 1-3 and 5-6 stop at 1536) plus the
// right padding (ops/poa_cuda.band_alloc).
__host__ __device__ __forceinline__ int band_alloc(int band, int band_width) {
  return band == 0 ? 0 : (band == 2 ? MAX_BAND : band_width) + PAD;
}

// The band of a pass with re-run code `rerun`; false when the pass gives up
// (a re-run whose band reached 1536 returns its code). Every thread computes
// the same values.
__device__ bool band_params(int nc, int rl, int band_width, bool adaptive, int rerun,
                            Band* b) {
  b->gradient = __fdiv_rn(float(rl + 1), float(nc + 1));  // IEEE f32, as the reference
  b->max_column = rl + 1;
  int bw = band_width;
  if (adaptive) {
    const double g = b->gradient;  // rules 1-2 in f64 (f64 literals), left to right
    if (g > 1.1) bw = max(bw, align128(int(double(b->max_column) * 0.08 * g)));
    if (g < 0.8) bw = max(bw, align128(int(double(b->max_column) * 0.1 / g)));
    bw = min(bw, MAX_BAND);  // rule 3
    if (bw == MAX_BAND && rerun != 0) return false;
  }
  int shift = bw / 2;  // rule 4
  if (adaptive && bw <= MAX_BAND / 2) {
    if (rerun == SHIFT_LEFT) {  // rule 5
      bw *= 2;
      shift = int(double(shift) * 2.5);
    } else if (rerun == SHIFT_RIGHT) {  // rule 6
      bw *= 2;
      shift = int(double(shift) * 1.5);
    }
  }
  b->bw = bw;
  b->shift = shift;
  b->W = bw + PAD;
  return true;
}

// get_band_start_for_row (banded._band_start_for_row).
__device__ __forceinline__ int band_start(int row, const Band& b) {
  const int diag = int(__fmul_rn(float(row), b.gradient));
  int start = max(0, diag - b.shift);
  if (b.max_column < start + b.bw) start = max(0, b.max_column - b.bw + CELLS);
  return start - start % CELLS;
}

// The start a pass gave band row `row`: row 0's is 0.
__device__ __forceinline__ int row_start(int row, const Band& b) {
  return row ? band_start(row, b) : 0;
}

// A band row of the slab holds slot s at int SLOT0 + s of its W, so that
// the slots a lane computes (1 + 8l ..) start on 16 bytes.
constexpr int SLOT0 = 3;

// get_score (banded.py :126-133): out of the row's band -> MIN_SCORE, column
// -1 -> slot 0, and column band_start -> slot 0 as well.
__device__ __forceinline__ int get_score(const Win& w, const Band& b, int row, int col) {
  const int bs = row_start(row, b);
  const int be = min(bs + b.bw, b.max_column);
  if ((col > be || col < bs) && col != -1) return MIN_SCORE;
  return w.scores[size_t(row) * b.W + SLOT0 + (col == -1 ? 0 : col - bs)];
}

// Banded traceback (banded.py :196-263) from row i0 (the first strict
// maximum at column rl over the sink rows, banded_best_row) and column rl;
// ag/ar in backward order. Returns the alignment length, or a negative
// code: SHIFT_LEFT / SHIFT_RIGHT when rules 7-8 fire (first pass of the
// adaptive mode only), LOOP_FAILED. By the warp, the reference's moves in
// its order:
// - a round guesses the next TB_GUESS moves to be diagonals to the first
//   predecessor: lane l follows first predecessors l rows down from row i
//   (a table in shared memory) to its cell (I, j - l), and its guess holds
//   where the diagonal to I's first predecessor gives the cell's score
//   (the reference's first check, so its move). The lanes load their
//   cells' scores at once; the moves up to the first guess that fails (or
//   the first at which rules 7-8 fire, or the cap) are taken, their ag/ar
//   written by their lanes;
// - then lane 0 takes the next move as the reference does: its scores (the
//   horizontal one, and the diagonal and vertical ones of its first TB_PRE
//   predecessors) loaded together, then checked in order. The score that
//   decides a move is the next move's own, so it is carried.
// `table` (shared memory, or nullptr) holds each row's metadata and first
// predecessor.
constexpr int TB_PRE = 4, TB_GUESS = 16;
__device__ int traceback_banded(const Win& w, const Band& b, const uint8_t* s_read, int rl,
                                int nc, int i0, int gap, int mismatch, int match,
                                bool rules_78, const int2* table) {
  const int lane = threadIdx.x & 31;
  const int E = w.E, K = w.N + w.L;
  const int cap = rl + nc + 2;
  const int thr = max(1, b.max_column / 1024);
  auto row_meta = [&](int r) {  // (metadata, first predecessor) of band row r >= 1
    return table ? table[r - 1] : make_int2(w.meta[r - 1], w.rpred[size_t(r - 1) * E]);
  };
  auto rule = [&](int r, int c) {  // rules 7-8 at cell (r, c), r and c nonzero
    if (!rules_78 || thr >= c || c >= b.max_column - thr) return 0;
    const int bs = band_start(r, b);
    return c <= bs + thr ? SHIFT_LEFT : (c >= bs + b.bw - thr ? SHIFT_RIGHT : 0);
  };
  int i = i0, j = rl, loops = 0, k = 0;
  int sij = get_score(w, b, i, j);
  while ((i != 0 || j != 0) && loops < cap) {
    // a round of guesses: lanes 0 .. TB_GUESS find their cells
    int I = i;
    for (int t = lane <= TB_GUESS ? lane : 0; t > 0 && I > 0; --t) I = row_meta(I).y;
    const int J = j - lane;
    int fire = 0, s_cur = 0;
    bool hit = false;
    if (lane <= TB_GUESS && J >= 0) s_cur = get_score(w, b, I, J);
    if (lane < TB_GUESS && I > 0 && J > 0) {
      const int2 t = row_meta(I);
      fire = rule(I, J);
      hit = s_cur == get_score(w, b, t.y, J - 1) +
                         ((t.x & 0xff) == s_read[J - 1] ? match : mismatch);
    }
    const bool capped = loops + lane >= cap;
    const unsigned stop = __ballot_sync(FULL, capped || fire != 0 || !hit);
    const int m = __ffs(stop) - 1;  // the moves taken: at most TB_GUESS
#ifdef POA_PHASE_CLOCKS
    if (lane == 0) {  // the banded chain's counters 13-14: rounds, guessed moves
      atomicAdd(&g_phase_clocks[13], 1ull);
      atomicAdd(&g_phase_clocks[14], (unsigned long long)m);
    }
#endif
    if (lane < m && k + lane < K) {
      w.ag[k + lane] = w.sorted[I - 1];
      w.ar[k + lane] = J - 1;
    }
    k += m;
    loops += m;
    i = __shfl_sync(FULL, I, m);
    j -= m;
    sij = __shfl_sync(FULL, s_cur, m);
    if (__shfl_sync(FULL, capped, m)) break;
    const int code = __shfl_sync(FULL, fire, m);
    if (code) return code;
    if (m == TB_GUESS || (i | j) == 0) continue;  // another round, or the walk's end
    // one move as the reference takes it
    int pi_ = 0, pj = 0, next = 0;
    if (lane == 0) {
      ++loops;
      int meta = 0, p0 = 0;
      if (i != 0) {
        const int2 t = row_meta(i);
        meta = t.x;
        p0 = t.y;
      }
      const int np = meta >> 16;  // 0 in row 0
      const int* rp = w.rpred + size_t(i > 0 ? i - 1 : 0) * E;
      const int hs = get_score(w, b, i, j - 1);
      int pr[TB_PRE], ds[TB_PRE], vs[TB_PRE];
#pragma unroll
      for (int e = 0; e < TB_PRE; ++e) {
        pr[e] = e == 0 ? p0 : (e < np ? rp[e] : 0);
        ds[e] = e < np && j != 0 ? get_score(w, b, pr[e], j - 1) : MIN_SCORE;
        vs[e] = e < np ? get_score(w, b, pr[e], j) : MIN_SCORE;
      }
      bool found = false;
      if (i != 0 && j != 0) {
        const int mcost = (meta & 0xff) == s_read[j - 1] ? match : mismatch;
        for (int e = 0; e < np && !found; ++e) {
          const int s = e < TB_PRE ? ds[e] : get_score(w, b, rp[e], j - 1);
          if (sij == s + mcost) {
            pi_ = e < TB_PRE ? pr[e] : rp[e];
            pj = j - 1;
            next = s;
            found = true;
          }
        }
      }
      if (!found && i != 0) {
        for (int e = 0; e < np && !found; ++e) {
          const int s = e < TB_PRE ? vs[e] : get_score(w, b, rp[e], j);
          if (sij == s + gap) {
            pi_ = e < TB_PRE ? pr[e] : rp[e];
            pj = j;
            next = s;
            found = true;
          }
        }
      }
      if (!found && sij == hs + gap) {
        pi_ = i;
        pj = j - 1;
        next = hs;
      }
      if (k < K) {
        w.ag[k] = (pi_ == i) ? -1 : w.sorted[i - 1];
        w.ar[k] = (pj == j) ? -1 : j - 1;
      }
    }
    loops = __shfl_sync(FULL, loops, 0);
    i = __shfl_sync(FULL, pi_, 0);
    j = __shfl_sync(FULL, pj, 0);
    sij = __shfl_sync(FULL, next, 0);
    ++k;
  }
  return loops >= cap ? LOOP_FAILED : k;
}

// True when two columns of the walk touch the same aligned clique, named by
// its least node id (jax_poa.add_alignment_batched's test). Computed at the
// walk's first node overflow rather than before the walk: the walk only
// appends nodes with ids above every pre-walk node, so no clique's least id
// has changed by then. `stamp` marks this read's cliques in `mark`.
__device__ bool walk_conflicts(const Win& w, int aln_len, int stamp) {
  const int A = w.A;
  bool conflict = false;
  for (int pos = 0; pos < aln_len; ++pos) {
    const int gid = w.ag[pos];
    if (w.ar[pos] == -1 || gid == -1) continue;
    int clique = gid;
    const int na = w.al_count[gid];
    for (int a = 0; a < na; ++a) clique = min(clique, w.al[size_t(gid) * A + a]);
    conflict |= w.mark[clique] == stamp;
    w.mark[clique] = stamp;
  }
  return conflict;
}

// The walk's running state: the last node, its read weight, its out-count
// where a staged batch gave it (-1: read it), the node count, the error and
// the clique-conflict test (-1 until computed).
struct Walk {
  int head, prev_w, head_oc, nc, err, conflict;
};

// A batch of 32 of the walk's moves loaded ahead by the warp (full band),
// in shared memory: per move its read position (-1 for a gap in the read),
// graph node, the read's base and weight, and for a graph node the node's
// base, in-count, out-count and first ADD_PRE in-list slots and weights.
constexpr int ADD_PRE = 4;
struct AddStage {
  int rp[32], gid[32], base[32], wt[32], gbase[32], ic[32], oc[32];
  int ie[ADD_PRE][32], iw[ADD_PRE][32];
};

// Sequential alignment-to-graph walk (cudapoa_add_alignment.cuh) with the
// error precedence of jax_poa's chain (torch_poa.add_alignment_batched_seq):
// a walk with a clique conflict stops after the step that raises an error;
// any other walk goes on after a node overflow (1), and a later edge or
// aligned-node overflow (2) replaces it. FIRST_WINS gives the banded chain's
// precedence (cpu_reference.add_alignment): the walk stops after its first
// erring step, where a node overflow wins over a 2. MSA records read
// `stamp`'s path in seq_next and its first node in begin. Walks the moves
// from position `from` down to `to` + 1 (the moves are in backward order)
// from the state k; returns true where the walk stops. One thread.
//
// STAGED: the moves come from `st` (position from - i at slot i), and a
// node's staged fields stand for its own unless an earlier step of the walk
// landed on it (a bit in `touched`, N bits): only the node a step lands on
// has its base, in-list or counts changed, and the step after it its
// out-count (that node is then the head).
template <bool FIRST_WINS, bool MSA, bool STAGED = false>
__device__ bool add_steps(const Win& w, int aln_len, int from, int to, const uint8_t* s_read,
                          const int* wts, int stamp, Walk& k, const AddStage* st = nullptr,
                          unsigned* touched = nullptr) {
  const int N = w.N, E = w.E, A = w.A;
  for (int pos = from; pos > to; --pos) {
    if (FIRST_WINS && k.err) return true;
    if (k.err == 2) return true;
    if (k.err == 1) {
      if (k.conflict < 0) k.conflict = walk_conflicts(w, aln_len, stamp);
      if (k.conflict) return true;
    }
    const int i = from - pos;
    const int rp = STAGED ? st->rp[i] : w.ar[pos];
    if (rp == -1) continue;
    const int gid = STAGED ? st->gid[i] : w.ag[pos];
    const int wt = STAGED ? st->wt[i] : wts[rp];
    const int base = STAGED ? st->base[i] : s_read[rp];
    const bool fresh = STAGED && gid != -1 && !((touched[gid >> 5] >> (gid & 31)) & 1);
    bool reuse_graph = false, reuse_aligned = false;
    int first_aligned = 0, na = 0;
    if (gid != -1) {
      reuse_graph = (fresh ? st->gbase[i] : w.nodes[gid]) == base;
      if (!reuse_graph) {
        na = w.al_count[gid];
        for (int a = 0; a < na; ++a) {
          const int aid = w.al[size_t(gid) * A + a];
          if (w.nodes[aid] == base) {
            first_aligned = aid;
            reuse_aligned = true;
            break;
          }
        }
      }
    }
    const bool new_node = !reuse_graph && !reuse_aligned;
    const bool new_aligned = new_node && gid != -1;
    int cur = reuse_graph ? gid : (reuse_aligned ? first_aligned : k.nc);
    cur = min(cur, N - 1);
    if (new_node) {
      ++k.nc;
      if (k.nc >= N) k.err = 1;
      w.nodes[cur] = base;
      w.out_count[cur] = 0;
      w.in_count[cur] = 0;
      w.al_count[cur] = 0;
      w.cov[cur] = 0;
    }
    if (new_aligned) {
      // cur joins gid's aligned clique
      int* gl = w.al + size_t(gid) * A;
      int* cl = w.al + size_t(cur) * A;
      for (int a = 0; a < na; ++a) {
        const int aid = gl[a];
        const int cnt = w.al_count[aid];
        if (cnt < A) w.al[size_t(aid) * A + cnt] = cur;
        w.al_count[aid] = cnt + 1;
        cl[a] = aid;
      }
      gl[na] = cur;
      w.al_count[gid] = na + 1;
      cl[na] = gid;
      w.al_count[cur] = na + 1;
      if (na + 1 > A - 1 && (!FIRST_WINS || !k.err)) k.err = 2;
    }
    // the step lands on its graph node, whose staged in-list holds
    const bool staged_list = fresh && reuse_graph && st->ic[i] <= ADD_PRE;
    if (k.head != -1) {
      int* il = w.in_edges + size_t(cur) * E;
      int* iw = w.in_w + size_t(cur) * E;
      const int ic = staged_list ? st->ic[i] : w.in_count[cur];
      bool exists = false;
      if (staged_list) {
#pragma unroll
        for (int e = 0; e < ADD_PRE; ++e) {
          if (e < ic && st->ie[e][i] == k.head) {
            exists = true;
            iw[e] = st->iw[e][i] + k.prev_w + wt;
          }
        }
      } else {
        for (int e = 0; e < ic; ++e) {
          if (il[e] == k.head) {
            exists = true;
            iw[e] += k.prev_w + wt;
          }
        }
      }
      if (!exists) {
        il[ic] = k.head;
        iw[ic] = k.prev_w + wt;
        w.in_count[cur] = ic + 1;
        const int oc = k.head_oc >= 0 ? k.head_oc : w.out_count[k.head];
        w.out_edges[size_t(k.head) * E + oc] = cur;
        w.out_count[k.head] = oc + 1;
        if ((oc + 1 >= E || ic + 1 >= E) && (!FIRST_WINS || !k.err)) k.err = 2;
      }
    }
    if (MSA) {
      if (k.head != -1) w.seq_next[size_t(k.head) * w.S + stamp] = cur;
      if (rp == 0) w.begin[stamp] = cur;
    }
    if (STAGED) {
      atomicAdd(&w.cov[cur], 1);  // a reduction: the walk does not wait for it
      touched[cur >> 5] |= 1u << (cur & 31);
      k.head_oc = new_node ? 0 : (fresh && reuse_graph ? st->oc[i] : -1);
    } else {
      w.cov[cur] += 1;
    }
    k.head = cur;
    k.prev_w = wt;
  }
  return false;
}

// Kahn's sort (cudapoa_topsort.cuh:46): seeds by ascending id, FIFO
// expansion in out-edge order. Returns 100 if the graph is not a DAG.
__device__ int topsort(const Win& w, int nc) {
  const int E = w.E;
  int tail = 0;
  for (int n = 0; n < nc; ++n) {
    const int ic = w.in_count[n];
    w.local[n] = ic;
    if (ic == 0) {
      w.sorted[tail] = n;
      w.pos_of[n] = tail++;
    }
  }
  for (int i = 0; i < tail; ++i) {
    const int node = w.sorted[i];
    const int oc = w.out_count[node];
    const int* ol = w.out_edges + size_t(node) * E;
    for (int e = 0; e < oc; ++e) {
      const int out = ol[e];
      if (--w.local[out] == 0) {
        w.sorted[tail] = out;
        w.pos_of[out] = tail++;
      }
    }
  }
  return tail != nc ? 100 : 0;
}

// -- MSA (cudapoa_generate_msa.cuh) -----------------------------------------------

// Stack entries the racon DFS can need: a node is expanded once, and an
// expansion pushes each unfinished predecessor and aligned node, so the
// stack never holds more than N + sum(in_count) + sum(al_count) <=
// N * (E + A - 1) entries (torch_poa.racon_sort_host). The TPU kernel's
// 2N + 8 can overflow; this cannot.
__device__ __forceinline__ size_t msa_stack_cap(const Win& w) {
  return size_t(w.N) * (w.E + w.A);
}

// raconTopologicalSortDeviceUtil (cudapoa_topsort.cuh:104) fused with the
// column map (getNodeIDToMSAPosDevice, cudapoa_generate_msa.cuh:35), as
// torch_poa.racon_sort_host; then one gapped row per sequence along
// seq_next (generateMSADevice :56), at most N + 2 steps each. The rows are
// prefilled with '-'. Returns the MSA length. One thread.
__device__ int msa_emit(const Win& w, int nc, int nseq, int Nrow, uint8_t* msa) {
  const int E = w.E, A = w.A, S = w.S;
  int* mark = w.local;  // free after the last sort
  for (int n = 0; n < nc; ++n) {
    mark[n] = 0;
    w.chk[n] = 1;
  }
  const size_t cap = msa_stack_cap(w);
  int col = 0;
  for (int i = 0; i < nc; ++i) {
    if (mark[i] != 0) continue;
    long long top = 0;
    w.stack[0] = i;
    while (top >= 0) {
      const int nid = w.stack[top];
      bool valid = true;
      if (mark[nid] != 2) {
        const long long top0 = top;
        const int ic = w.in_count[nid];
        for (int e = 0; e < ic; ++e) {
          const int pb = w.in_edges[size_t(nid) * E + e];
          if (mark[pb] != 2 && size_t(top + 1) < cap) w.stack[++top] = pb;
        }
        if (w.chk[nid]) {
          const int na = w.al_count[nid];
          for (int a = 0; a < na; ++a) {
            const int aid = w.al[size_t(nid) * A + a];
            if (mark[aid] != 2 && size_t(top + 1) < cap) {
              w.stack[++top] = aid;
              w.chk[aid] = 0;
            }
          }
        }
        valid = top == top0;
        if (valid) {
          mark[nid] = 2;
          if (w.chk[nid]) {
            w.col[nid] = col;
            const int na = w.al_count[nid];
            for (int a = 0; a < na; ++a) w.col[w.al[size_t(nid) * A + a]] = col;
            ++col;
          }
        } else {
          mark[nid] = 1;
        }
      }
      if (valid) --top;
    }
  }
  for (int sq = 0; sq < nseq; ++sq) {
    int nid = w.begin[sq];
    for (int steps = 0; nid != -1 && steps < Nrow + 2; ++steps) {
      msa[size_t(sq) * Nrow + w.col[nid]] = uint8_t(w.nodes[nid]);
      nid = w.seq_next[size_t(nid) * S + sq];
    }
  }
  return col;
}

// -- full band: one warp per window ------------------------------------------------

constexpr int NEG_HALF = INT_MIN / 2;  // below every score; a score added to it stays below
constexpr int WIN_WARPS = 4;           // windows a block, at most
constexpr int RING_MAX = 8;            // score rows in the shared ring, at most
constexpr int WARP_SMEM_BUDGET = 24 * 1024;  // a window's shared memory, for R
constexpr int META_FAR = 1 << 9;  // a row read from beyond the ring

// Shared memory of one window (warp), 16-aligned: the ring of R score rows
// of RW ints (column j at j: with an odd CPL a lane's columns and 32
// consecutive columns both fall in distinct banks), the read, and two code
// stages of a tile each.
struct WarpSmem {
  int R, RW;
  size_t ring, read, stage, stage_bytes, bytes;
  __host__ __device__ WarpSmem(int L, int cpl, int R_) {
    const int TW = 32 * cpl;
    R = R_;
    RW = (L + TW) / TW * TW;  // whole tiles covering columns 0..L
    stage_bytes = (size_t(TW) * 2 + 4 + 15) / 16 * 16;
    size_t o = 0;
    ring = o;
    o += size_t(R) * RW * 4;
    read = o;
    o += (size_t(L) + 15) / 16 * 16;
    stage = o;
    o += 2 * stage_bytes;
    bytes = o;
  }
};

// Bytes topsort_cached needs for nc nodes: per node its out-count, its
// first OUT_CACHE out-edges, its count of unplaced in-edges and a queue
// slot, 16 bits each.
constexpr int OUT_CACHE = 4;
__host__ __device__ inline size_t topsort_cache_bytes(int nc) {
  return size_t(nc) * (OUT_CACHE + 3) * 2;
}

// Which of its shared-memory paths a window with a ring of ring_bytes, a
// node cap N and nc nodes takes, as bits: WIN_NO_RING, no score ring (all
// rows to the slab); WIN_ADD_UNSTAGED, the add walks on lane 0 without the
// stage; WIN_TOPSORT_SCALAR, topsort() on lane 0 instead of
// topsort_cached; WIN_CSCORE_DEVICE, the consensus scores in device memory.
// The kernel decides by it, and poa_window_paths reports it.
constexpr int WIN_NO_RING = 1, WIN_ADD_UNSTAGED = 2, WIN_TOPSORT_SCALAR = 4,
              WIN_CSCORE_DEVICE = 8;
__host__ __device__ inline int window_paths(size_t ring_bytes, int N, int nc) {
  int p = 0;
  if (ring_bytes == 0) p |= WIN_NO_RING;
  if (ring_bytes < sizeof(AddStage) + size_t(N + 31) / 32 * 4) p |= WIN_ADD_UNSTAGED;
  if (N > 65535 || topsort_cache_bytes(nc) > ring_bytes) p |= WIN_TOPSORT_SCALAR;
  if (ring_bytes < size_t(N) * 4) p |= WIN_CSCORE_DEVICE;
  return p;
}

// Full-band NW of the read in s_read (length rl) against the window's
// graph of nc nodes, by the warp: writes the score and code rows 1..nc of
// the slab; returns (in every lane) the first sink row with the highest
// score at column rl.
template <int CPL, int CB>
__device__ int nw_warp(const Win& w, const uint8_t* s_read, int rl, int nc, int gap,
                       int mismatch, int match, int* ring, int R, int RW, uint8_t* stage0,
                       int stage_bytes) {
  constexpr int TW = 32 * CPL;
  const int lane = threadIdx.x & 31;
  const int E = w.E, LD = w.L + 1, cb = CB;
  const int HORIZ = 2 * E, BIGP = 3 * E + 1;
  int* const scores = w.scores;
  uint8_t* const codes = w.codes;
  int* const metas = w.meta;
  int* const rpred = w.rpred;

  // per-row metadata: base | sink << 8 | far << 9 | npred << 16, and
  // predecessor rows; a row that a later row reads from beyond the ring is
  // flagged far, and only such rows go to the slab's score matrix
  const int ntiles = rl / TW + 1;  // columns 0..rl
  const bool one = ntiles == 1;
  auto in_ring = [&](int d) { return d < R || (one && d == R); };
  for (int r = lane; r < nc; r += 32) metas[r] = 0;
  __syncwarp();
  for (int r = lane; r < nc; r += 32) {
    const int nid = w.sorted[r];
    const int pc = w.in_count[nid];
    int* rp = rpred + size_t(r) * E;
    if (pc == 0) rp[0] = 0;  // a source row's predecessor is the virtual row 0
    for (int e = 0; e < pc; ++e) {
      const int pos = w.pos_of[w.in_edges[size_t(nid) * E + e]];
      rp[e] = pos + 1;
      if (!in_ring(r - pos)) atomicOr(&metas[pos], META_FAR);
    }
    atomicOr(&metas[r], (w.nodes[nid] & 0xff) | ((w.out_count[nid] == 0) << 8) |
                            (max(pc, 1) << 16));
  }
  __syncwarp();

  // Scores are kept as S'[j] = S[j] - j * gap: a vertical move adds gap, a
  // diagonal one sub - gap, the horizontal closure is a prefix max, a
  // horizontal move is S'[j] == S'[j - 1], and row 0 is all 0. Codes and
  // the best sink row compare scores of one column, so they are those of S.
  const int dsub_match = match - gap, dsub_mismatch = mismatch - gap;
  const int rl_tile = rl / TW, rl_lane = (rl % TW) / CPL, rl_c = (rl % TW) % CPL;
  int row[CPL];  // the tile just computed; with one tile, the last row
#pragma unroll
  for (int c = 0; c < CPL; ++c) row[c] = 0;
  uint32_t rb[(CPL + 3) / 4];  // the read's base before each column, four to a word
  int best = NEG_SINK, best_i = 1;
  SEG_INIT();
  int nmeta = metas[0];
  int npred = lane < E ? rpred[lane] : 0, npred0 = rpred[0];
  int tiles_done = 0;  // its parity picks the code stage
  for (int r = 0; r < nc; ++r) {
    const int g = r + 1;
    const int meta = nmeta, mypred = npred, pred0 = npred0;
    if (r + 1 < nc) {  // the next row's, loaded a row ahead
      nmeta = metas[r + 1];
      npred = lane < E ? rpred[size_t(r + 1) * E + lane] : 0;
      npred0 = rpred[size_t(r + 1) * E];
    }
    const int nb = meta & 0xff, sink = (meta >> 8) & 1, np = meta >> 16;
    const int* rp = rpred + size_t(r) * E;
    int carry = NEG_ID;  // max of S' over the earlier tiles' columns
    SEG_T0();
    SEG_CELLS(np);
    for (int t = 0; t < ntiles; ++t, ++tiles_done) {
      const int jt = t * TW, j0 = jt + lane * CPL;
      if (!one || r == 0) {
#pragma unroll
        for (int k = 0; k < (CPL + 3) / 4; ++k) rb[k] = 0;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int j = j0 + c;
          if (j >= 1 && j <= rl) rb[c >> 2] |= uint32_t(s_read[j - 1]) << ((c & 3) * 8);
        }
      }
      // the predecessor row prow's columns of this tile, and the column
      // left of the tile (lane 0's diagonal at t > 0); columns past rl of a
      // row in the slab read NEG_HALF
      auto load = [&](int prow, int* up) {
        const int d = g - prow;
        int left = NEG_HALF;
        if (prow == 0) {
#pragma unroll
          for (int c = 0; c < CPL; ++c) up[c] = 0;
          left = 0;
        } else if (one && d == 1) {
#pragma unroll
          for (int c = 0; c < CPL; ++c) up[c] = row[c];
        } else if (in_ring(d)) {
          const int* src = ring + (prow & (R - 1)) * RW;
#pragma unroll
          for (int c = 0; c < CPL; ++c) up[c] = src[j0 + c];
          if (t) left = src[jt - 1];
        } else {
          const int* src = scores + size_t(prow) * LD;
#pragma unroll
          for (int c = 0; c < CPL; ++c) up[c] = j0 + c <= rl ? src[j0 + c] : NEG_HALF;
          if (t) left = src[jt - 1];
        }
        const int l = __shfl_up_sync(FULL, up[CPL - 1], 1);
        return lane ? l : (t ? left : NEG_HALF);
      };
      // 0xff in each byte of rb equal to the row's base, four columns at once
      uint32_t eq[(CPL + 3) / 4];
#pragma unroll
      for (int k = 0; k < (CPL + 3) / 4; ++k) eq[k] = __vcmpeq4(rb[k], 0x01010101u * nb);
      auto dsub = [&](int c) {
        return (eq[c >> 2] >> ((c & 3) * 8)) & 1 ? dsub_match : dsub_mismatch;
      };
      // per column: the best diagonal and vertical candidates over the
      // predecessors, and (over two or more) the first predecessor reaching
      // each (de | ve << 16)
      int dmax[CPL], vmax[CPL], idx[CPL], up[CPL];
      int left = load(pred0, up);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        vmax[c] = up[c] + gap;
        dmax[c] = (c ? up[c - 1] : left) + dsub(c);
      }
      if (np > 1) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) idx[c] = 0;
        for (int e = 1; e < np; ++e) {
          left = load(e < 32 ? __shfl_sync(FULL, mypred, e) : rp[e], up);
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const int vv = up[c] + gap, dd = (c ? up[c - 1] : left) + dsub(c);
            if (vv > vmax[c]) {
              vmax[c] = vv;
              idx[c] = (idx[c] & 0xffff) | (e << 16);
            }
            if (dd > dmax[c]) {
              dmax[c] = dd;
              idx[c] = (idx[c] & ~0xffff) | e;
            }
          }
        }
      }
      SEG(0);
      // horizontal closure: a prefix max over the lane, the warp and the
      // earlier tiles
      int run = NEG_ID;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        run = max(run, max(dmax[c], vmax[c]));
        row[c] = run;
      }
      const int incl = warp_incl_max(run);
      int excl = __shfl_up_sync(FULL, incl, 1);
      excl = lane ? max(excl, carry) : carry;
#pragma unroll
      for (int c = 0; c < CPL; ++c) row[c] = max(excl, row[c]);
      // the closed S' of the column left of the lane's first is the
      // exclusive prefix (at column 0, NEG_ID, which no score equals)
      const int hleft = excl;
      if (t + 1 < ntiles) carry = max(carry, __shfl_sync(FULL, incl, 31));
      // priority codes against the closed row: diagonal by edge order,
      // vertical by edge order, horizontal; staged at the byte offset the
      // row's destination has in its word
      SEG(1);
      uint8_t* stage = stage0 + (tiles_done & 1) * stage_bytes;
      uint8_t* cdst = codes + (size_t(g) * LD + jt) * cb;
      const int mis = int(uintptr_t(cdst) & 3);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int x = row[c];
        int code = x == (c ? row[c - 1] : hleft) ? HORIZ : BIGP;
        if (np > 1) {
          code = vmax[c] == x ? E + (idx[c] >> 16) : code;
          code = dmax[c] == x ? (idx[c] & 0xffff) : code;
        } else {
          code = vmax[c] == x ? E : code;
          code = dmax[c] == x ? 0 : code;
        }
        const int off = mis + (lane * CPL + c) * CB;
        if (CB == 1)
          stage[off] = uint8_t(code);
        else
          *reinterpret_cast<uint16_t*>(stage + off) = uint16_t(code);
      }
      int* srow = scores + size_t(g) * LD;
      if (R) {
        int* dst = ring + (g & (R - 1)) * RW;
#pragma unroll
        for (int c = 0; c < CPL; ++c) dst[j0 + c] = row[c];
      } else {
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          if (j0 + c <= rl) srow[j0 + c] = row[c];
      }
      SEG(2);
      __syncwarp();  // the stage and the ring row are written
      const int ncols = min(TW, rl + 1 - jt);
      if (R && (meta & META_FAR)) {  // to the slab's score matrix, 32 columns at once
        const int* src = ring + (g & (R - 1)) * RW + jt;
        int* dst = srow + jt;
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const int c = lane + 32 * q;
          if (c < ncols) dst[c] = src[c];
        }
      }
      // the codes: whole words, and the bytes of the partial words at the ends
      uint8_t* cw = cdst - mis;
      const int nbytes = mis + ncols * cb;
#pragma unroll
      for (int q0 = 0; q0 < (TW * CB + 4 + 127) / 128; ++q0) {
        const int lo = 4 * (lane + 32 * q0);
        if (lo >= nbytes) continue;
        if (lo >= mis && lo + 4 <= nbytes) {
          *reinterpret_cast<uint32_t*>(cw + lo) = *reinterpret_cast<const uint32_t*>(stage + lo);
        } else {
#pragma unroll
          for (int k = lo; k < lo + 4; ++k)
            if (k >= mis && k < nbytes) cw[k] = stage[k];
        }
      }
      SEG(3);
      if (sink && t == rl_tile) {  // the first sink row with the highest score at column rl
        int x = row[0];
#pragma unroll
        for (int c = 1; c < CPL; ++c)
          if (c == rl_c) x = row[c];
        x = __shfl_sync(FULL, x, rl_lane) + rl * gap;
        if (x > best) {
          best = x;
          best_i = g;
        }
      }
      SEG(4);
    }
  }
  SEG_FLUSH();
  __syncwarp();  // the codes are visible to the traceback
  return best_i;
}

// Traceback from (best_i, rl) over the codes; ag/ar in backward order.
// Returns the alignment length, or -1 when the walk does not reach (0, 0).
// One lane.
__device__ int traceback(const Win& w, int best_i, int rl) {
  const int E = w.E, LD = w.L + 1, HORIZ = 2 * E, K = w.N + w.L;
  int i = best_i, j = rl, k = 0;
  const uint8_t* codes = w.codes;
  const int *rpred = w.rpred, *sorted = w.sorted;
  int *ag = w.ag, *ar = w.ar;
  const bool wide = w.cb == 2;
  for (int steps = 0; (i != 0 || j != 0) && steps < K + 2; ++steps) {
    // the code, and with it the row's node and first predecessor (the most
    // common move's), so that a step is one round trip
    int code = HORIZ, p0 = 0, nid = 0;
    const int* rp = rpred + size_t(i > 0 ? i - 1 : 0) * E;
    if (i != 0) {
      const size_t at = size_t(i) * LD + j;
      code = wide ? int(reinterpret_cast<const uint16_t*>(codes)[at]) : int(codes[at]);
      p0 = rp[0];
      nid = sorted[i - 1];
    }
    int pi, pj;
    if (code == HORIZ) {
      pi = i;
      pj = j - 1;
    } else {
      const int e = code % E;
      pi = e ? rp[e] : p0;
      pj = code < E ? j - 1 : j;
    }
    if (k < K) {
      ag[k] = (pi == i) ? -1 : nid;
      ar[k] = (pj == j) ? -1 : j - 1;
    }
    ++k;
    i = pi;
    j = pj;
  }
  return (i != 0 || j != 0) ? -1 : k;
}

// The add of an alignment of aln_len moves (add_steps<FIRST_WINS, MSA>:
// false for the full band's precedence, true for the banded modes'), by
// the warp: its lanes load the walk's moves 32 at a time into `st` (shared
// memory), with what the walk reads of each move's graph node (those loads
// do not depend on the walk), and lane 0 walks them (add_steps, STAGED), so
// that a step that lands on its graph node, most steps, waits for no device
// memory. Without shared memory for the stage (st nullptr) lane 0 walks
// alone. Returns the error in every lane.
template <bool FIRST_WINS, bool MSA>
__device__ int add_walk(const Win& w, int aln_len, const uint8_t* s_read, const int* wts,
                        int* node_count, int stamp, AddStage* st, unsigned* touched) {
  const int lane = threadIdx.x & 31;
  const int E = w.E;
  Walk k{-1, 0, -1, *node_count, 0, -1};
  if (st == nullptr) {
    if (lane == 0)
      add_steps<FIRST_WINS, MSA>(w, aln_len, aln_len - 1, -1, s_read, wts, stamp, k);
  } else {
    for (int q = lane; q < (w.N + 31) / 32; q += 32) touched[q] = 0;
    bool stop = false;
    for (int t0 = 0; t0 < aln_len && !stop; t0 += 32) {
      if (t0 + lane < aln_len) {
        const int p = aln_len - 1 - t0 - lane;
        const int rp = w.ar[p];
        st->rp[lane] = rp;
        if (rp != -1) {
          const int gid = w.ag[p];
          st->gid[lane] = gid;
          st->base[lane] = s_read[rp];
          st->wt[lane] = wts[rp];
          if (gid != -1) {
            st->gbase[lane] = w.nodes[gid];
            st->ic[lane] = w.in_count[gid];
            st->oc[lane] = w.out_count[gid];
#pragma unroll
            for (int e = 0; e < ADD_PRE; ++e) {
              if (e < E) {
                st->ie[e][lane] = w.in_edges[size_t(gid) * E + e];
                st->iw[e][lane] = w.in_w[size_t(gid) * E + e];
              }
            }
          }
        }
      }
      __syncwarp();  // the stage (and the bits cleared) before lane 0 walks it
      if (lane == 0)
        stop = add_steps<FIRST_WINS, MSA, true>(w, aln_len, aln_len - 1 - t0,
                                                max(aln_len - 1 - t0 - 32, -1), s_read, wts,
                                                stamp, k, st, touched);
      stop = __shfl_sync(FULL, int(stop), 0);  // lane 0 is done with the stage
    }
  }
  __syncwarp();  // lane 0's writes
  *node_count = __shfl_sync(FULL, k.nc, 0);
  return __shfl_sync(FULL, k.err, 0);
}

// topsort's Kahn order (seeds by ascending id, FIFO expansion in out-edge
// order) by the warp, with its working set in shared memory (`sm`, at
// least topsort_cache_bytes(nc), N <= 65535): the warp first copies each
// node's out-count and first out-edges there, all lanes at once; then one
// lane per out-edge of the popped node decrements its target's count, and
// a ballot enqueues the nodes that reached zero, in edge order. Popping a
// node reads shared memory only (device memory for the out-edges past
// OUT_CACHE). An out-list holds distinct nodes in a graph the walk left
// without error, the only kind sorted. The same order, the same result.
__device__ int topsort_cached(const Win& w, int nc, uint16_t* sm) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int E = w.E;
  uint16_t* s_oc = sm;
  uint16_t* s_out = s_oc + nc;
  uint16_t* s_local = s_out + size_t(nc) * OUT_CACHE;
  uint16_t* s_queue = s_local + nc;
  int* const sorted = w.sorted;
  int* const pos_of = w.pos_of;
  const int* const out_edges = w.out_edges;
  int tail = 0;
  for (int n0 = 0; n0 < nc; n0 += 32) {
    const int n = n0 + lane;
    int ic = 1;
    if (n < nc) {
      ic = w.in_count[n];
      const int oc = w.out_count[n];
      int o[OUT_CACHE];
#pragma unroll
      for (int k = 0; k < OUT_CACHE; ++k) o[k] = k < E ? out_edges[size_t(n) * E + k] : 0;
      s_local[n] = uint16_t(ic);
      s_oc[n] = uint16_t(oc);
#pragma unroll
      for (int k = 0; k < OUT_CACHE; ++k) s_out[size_t(n) * OUT_CACHE + k] = uint16_t(o[k]);
    }
    const unsigned seeds = __ballot_sync(FULL, ic == 0);
    if (ic == 0) {
      const int at = tail + __popc(seeds & below);
      s_queue[at] = uint16_t(n);
      sorted[at] = n;
      pos_of[n] = at;
    }
    tail += __popc(seeds);
  }
  __syncwarp();
  for (int i = 0; i < tail; ++i) {
    const int node = s_queue[i];
    const int oc = s_oc[node];
    for (int e0 = 0; e0 < oc; e0 += 32) {
      const int e = e0 + lane;
      int out = 0;
      bool zero = false;
      if (e < oc) {
        out = e < OUT_CACHE ? s_out[size_t(node) * OUT_CACHE + e]
                            : out_edges[size_t(node) * E + e];
        const int l = s_local[out] - 1;
        s_local[out] = uint16_t(l);
        zero = l == 0;
      }
      const unsigned z = __ballot_sync(FULL, zero);
      if (zero) {
        const int at = tail + __popc(z & below);
        s_queue[at] = uint16_t(out);
        sorted[at] = out;
        pos_of[out] = at;
      }
      tail += __popc(z);
    }
    __syncwarp();
  }
  return tail != nc ? 100 : 0;
}

// One row of the heaviest-edge pass (consensus_row) by the warp, one lane
// per in-edge. The sequential scan from (s0, -1) takes an edge whose weight
// passes s, or ties it with a source scored at least the taken one's: it
// ends on the largest weight M if M > s0 (else on (s0, -1)), and among the
// edges of weight M on the last of those whose source scores highest.
__device__ void consensus_row_warp(const Win& w, const int* cscore, int nid, bool skip_cleared,
                                   int* s_out, int* p_out) {
  const int lane = threadIdx.x & 31;
  const int E = w.E;
  const int pc = w.in_count[nid];
  const int* il = w.in_edges + size_t(nid) * E;
  const int* iw = w.in_w + size_t(nid) * E;
  int s = skip_cleared ? -1 : cscore[nid];
  int p = -1, sp = 0;
  for (int e0 = 0; e0 < pc; e0 += 32) {
    const int e = e0 + lane;
    int ew = INT_MIN, sb = INT_MIN, begin = -1;
    if (e < pc) {
      begin = il[e];
      sb = cscore[begin];
      ew = iw[e];
      if (skip_cleared && sb == -1) ew = INT_MIN;
    }
    const int m = __reduce_max_sync(FULL, ew);
    if (m == INT_MIN) continue;  // no edge of this chunk counts
    const bool tie = ew == m;
    const int sbm = __reduce_max_sync(FULL, tie ? sb : INT_MIN);
    const unsigned at = __ballot_sync(FULL, tie && sb == sbm);
    const int pick = __shfl_sync(FULL, begin, 31 - __clz(at));
    if (m > s || (m == s && p != -1 && sp <= sbm)) {
      s = m;
      p = pick;
      sp = sbm;
    }
  }
  if (p != -1) s += sp;
  *s_out = s;
  *p_out = p;
}

// consensus() by the warp: the heaviest-path passes row by row
// (consensus_row_warp), the branch completion's clearing one lane per
// in-edge, the emission on lane 0. `cscore` is shared or device memory.
// Returns the error (0 or 3) in every lane.
__device__ int consensus_warp(const Win& w, int nc, int* cscore, uint8_t* cons, int* cov_out,
                              int* length) {
  const int lane = threadIdx.x & 31;
  const int E = w.E, A = w.A;
  for (int n = lane; n < nc; n += 32) {
    cscore[n] = -1;
    w.cpred[n] = -1;
  }
  __syncwarp();
  // rows from sorted position `from` on, in order; the best (last at the
  // highest score) from (mx_s, mx_i)
  auto pass = [&](int from, bool skip, int& mx_s, int& mx_i) {
    for (int g0 = from; g0 < nc; g0 += 32) {
      const int mine = g0 + lane < nc ? w.sorted[g0 + lane] : 0;
      for (int q = 0; q < 32 && g0 + q < nc; ++q) {
        const int nid = __shfl_sync(FULL, mine, q);
        int s, p;
        consensus_row_warp(w, cscore, nid, skip, &s, &p);
        __syncwarp();  // every lane has read the scores
        if (lane == 0) {
          cscore[nid] = s;
          w.cpred[nid] = p;
        }
        __syncwarp();
        if (mx_s <= s) {
          mx_s = s;
          mx_i = nid;
        }
      }
    }
  };
  int max_score = -1, max_id = 0;
  pass(0, false, max_score, max_id);
  int loops = 0;
  while (w.out_count[max_id] != 0 && loops < nc) {
    const int pos = w.pos_of[max_id];
    const int oc = w.out_count[max_id];
    for (int oe = 0; oe < oc; ++oe) {
      const int out = w.out_edges[size_t(max_id) * E + oe];
      const int ic = w.in_count[out];
      for (int ie = lane; ie < ic; ie += 32) {
        const int iid = w.in_edges[size_t(out) * E + ie];
        if (iid != max_id) cscore[iid] = -1;
      }
    }
    __syncwarp();
    int mxs = 0, mxi = 0;
    pass(pos + 1, true, mxs, mxi);
    max_id = mxi;
    ++loops;
  }
  if (loops >= nc && loops > 0) return 3;
  int k = 0;
  if (lane == 0) {
    int cur = max_id;
    while (true) {
      int c = w.cov[cur];
      const int nal = w.al_count[cur];
      for (int a = 0; a < nal; ++a) c += w.cov[w.al[size_t(cur) * A + a]];
      if (k < w.N) {
        cons[k] = uint8_t(w.nodes[cur]);
        cov_out[k] = c;
      }
      ++k;
      const int p = w.cpred[cur];
      if (p == -1) break;
      cur = p;
    }
  }
  *length = __shfl_sync(FULL, k, 0);
  return 0;
}

// At least POA_WIN_MIN_BLOCKS blocks of WIN_WARPS warps per SM (at most 128
// registers a thread) for the consensus, one fewer for the MSA and graph
// outputs, which spill at 128: the chain is latency-bound, so windows in
// flight decide its time: 4 blocks (2112 windows on an H100) ran the covid
// bin of 5448 windows in 41.4 ms against 50.7 ms at 3 (1584 windows;
// experiments/torch_poa_window_check.py --min-blocks 3). ptxas reports no
// spills at these bounds.
#ifndef POA_WIN_MIN_BLOCKS
#define POA_WIN_MIN_BLOCKS 4
#endif
// Full band, one warp per window, wpb windows a block. OUT 0 consensus
// (cons, cov, len, err in o0..o3), 1 MSA (rows (B, S, N) uint8, msa_len, err
// in o0..o2), 2 the graph (nodes, in_count, in_edges, in_w, node_count, err
// in o0..o5). R score rows of the ring a window (0, 2, 4 or 8).
template <int CPL, int OUT>
__global__ void __launch_bounds__(WIN_WARPS * 32, OUT == 0 ? POA_WIN_MIN_BLOCKS
                                                           : POA_WIN_MIN_BLOCKS - 1)
poa_window_kernel(const uint8_t* __restrict__ seqs, const int* __restrict__ wts,
                  const int* __restrict__ lens, const int* __restrict__ nseqs, void* o0,
                  void* o1, void* o2, void* o3, void* o4, void* o5,
                  uint8_t* __restrict__ scratch, long long slab_bytes, int w0, int nwin, int wpb,
                  int S, int L, int N, int E, int A, int gap, int mismatch, int match, int R) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * wpb + warp;
  if (i >= nwin) return;
  const size_t b = size_t(w0) + i;
  // Pointers and sizes are recomputed from the parameters where they are
  // used rather than held across the NW, whose columns need the registers.
  auto mine = [&]() { return smem + size_t(warp) * WarpSmem(L, CPL, R).bytes; };
  auto ring_of = [&]() { return reinterpret_cast<int*>(mine() + WarpSmem(L, CPL, R).ring); };
  auto ring_bytes = [&]() { return size_t(R) * WarpSmem(L, CPL, R).RW * 4; };
  // the window's view of its slab, in shared memory: the chain reads a
  // pointer where it uses it instead of holding two dozen in registers
  __shared__ Win s_win[WIN_WARPS];
  if (lane == 0)
    s_win[warp] = slab_win(scratch + size_t(i) * size_t(slab_bytes),
                           Layout(N, L, E, A, 0, OUT, S), N, L, E, A, S, OUT == 1);
  __syncwarp();
  const Win& w = s_win[warp];

  for (int n = lane; n < N; n += 32) w.mark[n] = 0;  // reads are stamped 1..S-1
  if (OUT == 0) {
    for (int n = lane; n < N; n += 32) {
      ((uint8_t*)o0)[b * N + n] = 0;
      ((int*)o1)[b * N + n] = 0;
    }
  }
  if (OUT == 1) {
    for (size_t t = lane; t < size_t(S) * N; t += 32) ((uint8_t*)o0)[b * S * N + t] = '-';
    for (size_t t = lane; t < size_t(N) * S; t += 32) w.seq_next[t] = -1;
    for (int t = lane; t < S; t += 32) w.begin[t] = 0;
    __syncwarp();  // before the backbone writes seq_next
  }

  // backbone (cudapoa_kernels.cuh:200-238)
  const int len0 = lens[b * S];
  for (int j = lane; j < len0; j += 32) {
    const int* wwt = wts + b * S * L;
    w.nodes[j] = seqs[b * S * L + j];
    w.sorted[j] = j;
    w.pos_of[j] = j;
    w.in_count[j] = j == 0 ? 0 : 1;
    w.out_count[j] = j == len0 - 1 ? 0 : 1;
    w.al_count[j] = 0;
    w.cov[j] = 1;
    w.in_edges[size_t(j) * E] = j - 1;
    w.out_edges[size_t(j) * E] = j + 1;
    w.in_w[size_t(j) * E] = j == 0 ? wwt[0] : wwt[j - 1] + wwt[j];
    if (OUT == 1 && j < len0 - 1) w.seq_next[size_t(j) * S] = j + 1;
  }
  __syncwarp();
  const int ns = nseqs[b];
  int nc = len0, err = 0;
  PHASE_T0();
  for (int s = 1; s < ns; ++s) {
    if (nc >= N) {
      err = 1;
      break;
    }
    PHASE_MARK();
    const int rl = lens[b * S + s];
    uint8_t* s_read = mine() + WarpSmem(L, CPL, R).read;
    for (int j = lane; j < rl; j += 32) s_read[j] = seqs[(b * S + s) * L + j];
    __syncwarp();
    int aln_len = 0;
    {
      const WarpSmem sm(L, CPL, R);
      int* ring = ring_of();
      uint8_t* stage = mine() + sm.stage;
      const int best_i =
          w.cb == 1 ? nw_warp<CPL, 1>(w, s_read, rl, nc, gap, mismatch, match, ring, R, sm.RW,
                                      stage, int(sm.stage_bytes))
                    : nw_warp<CPL, 2>(w, s_read, rl, nc, gap, mismatch, match, ring, R, sm.RW,
                                      stage, int(sm.stage_bytes));
      PHASE_ADD(0);
      PHASE_COUNT(6, nc);
      if (lane == 0) aln_len = traceback(w, best_i, rl);
      aln_len = __shfl_sync(FULL, aln_len, 0);
      __syncwarp();  // the moves are visible
      PHASE_ADD(1);
      PHASE_COUNT(7, max(aln_len, 0));
      err = aln_len < 0 ? 3 : 0;
    }
    int* ring = ring_of();
    // the add's stage and its N bits of landed nodes in the ring, where
    // they fit; the sort's working set too (node ids in its 16 bits)
    if (!err) {
      const bool staged = !(window_paths(ring_bytes(), N, nc) & WIN_ADD_UNSTAGED);
      err = add_walk<false, OUT == 1>(w, aln_len, s_read, wts + (b * S + s) * L, &nc, s,
                               staged ? reinterpret_cast<AddStage*>(ring) : nullptr,
                               reinterpret_cast<unsigned*>(ring + sizeof(AddStage) / 4));
    }
    PHASE_ADD(2);
    if (!err) {
      if (window_paths(ring_bytes(), N, nc) & WIN_TOPSORT_SCALAR) {
        if (lane == 0) err = topsort(w, nc);
        __syncwarp();  // lane 0's order
        err = __shfl_sync(FULL, err, 0);
      } else {
        err = topsort_cached(w, nc, reinterpret_cast<uint16_t*>(ring));
      }
    }
    PHASE_ADD(3);
    __syncwarp();  // every lane is done with s_read and the ring
    if (err) break;
  }
  PHASE_MARK();
  if (OUT == 0) {
    // the consensus scores in the ring where N fits it
    int* ring = ring_of();
    int length = 0;
    if (!err)
      err = consensus_warp(w, nc,
                           window_paths(ring_bytes(), N, nc) & WIN_CSCORE_DEVICE ? w.cscore : ring,
                           (uint8_t*)o0 + b * N, (int*)o1 + b * N, &length);
    if (lane == 0) {
      ((int*)o2)[b] = err ? 0 : length;
      ((int*)o3)[b] = err;
    }
  } else if (OUT == 1) {
    if (lane == 0) {
      ((int*)o1)[b] = err ? 0 : msa_emit(w, nc, ns, N, (uint8_t*)o0 + b * S * N);
      ((int*)o2)[b] = err;
    }
  } else {
    // the graph, zero past the node count and each in-count, and all zero
    // but err in a window that failed (torch_poa.export_graph)
    const int gc = err == 0 ? nc : 0;
    int* gn = (int*)o0 + b * N;
    int* gic = (int*)o1 + b * N;
    int* gie = (int*)o2 + b * N * E;
    int* giw = (int*)o3 + b * N * E;
    for (int n = lane; n < N; n += 32) {
      const bool live = n < gc;
      const int ic = live ? w.in_count[n] : 0;
      gn[n] = live ? w.nodes[n] : 0;
      gic[n] = ic;
      for (int e = 0; e < E; ++e) {
        gie[size_t(n) * E + e] = e < ic ? w.in_edges[size_t(n) * E + e] : 0;
        giw[size_t(n) * E + e] = e < ic ? w.in_w[size_t(n) * E + e] : 0;
      }
    }
    if (lane == 0) {
      ((int*)o4)[b] = gc;
      ((int*)o5)[b] = err;
    }
  }
  PHASE_ADD(4);
  PHASE_FLUSH();
}

// -- banded modes: one warp per window ---------------------------------------------

constexpr int BAND_CPL = 2 * CELLS;      // band lanes a lane holds: two chunks of CELLS
constexpr int BAND_TW = 32 * BAND_CPL;   // band lanes a tile
// A banded window's shared memory besides its read: the NW's ring of band
// rows, then the traceback's table, the add's stage, the sort's working
// set or the consensus scores (window_paths). Two rows of the widest
// adaptive band: R = 8 rows at band 256 (1,056 bytes a row), 4 at 512, 2
// from 640 to 1536. Four blocks of four windows fit an SM. (Five, with 10
// KB a window and at most 102 registers a thread, ran the covid file
// slower: 2,640 windows in flight, each row a third slower.)
constexpr int BAND_REGION = 2 * (MAX_BAND + PAD) * 4;
// At least BAND_MIN_BLOCKS blocks of WIN_WARPS warps per SM (at most 128
// registers a thread) for the consensus, one fewer for the MSA, as the full
// band.
constexpr int BAND_MIN_BLOCKS = 4;

// Rows of the ring a pass of band rows of W ints gets: the most of 8, 4, 2
// that fit BAND_REGION, else none (every predecessor row from the slab).
__device__ __forceinline__ int band_ring_rows(int W) {
  for (int r = RING_MAX; r >= 2; r >>= 1)
    if (r * W * 4 <= BAND_REGION) return r;
  return 0;
}

// A banded window's shared memory: the region, then its read (and 4 bytes
// past it, which the NW's word loads may touch).
__host__ __device__ inline size_t banded_warp_bytes(int L) {
  return size_t(BAND_REGION) + (size_t(L) + 4 + 15) / 16 * 16;
}

// Per-row metadata of the banded NW (base | sink << 8 | npred << 16) and
// the predecessor rows (a source's is the virtual row 0), for the graph of
// nc nodes in sorted order, by the warp.
__device__ void banded_rows(const Win& w, int nc) {
  const int lane = threadIdx.x & 31;
  const int E = w.E;
  for (int r = lane; r < nc; r += 32) {
    const int nid = w.sorted[r];
    const int pc = w.in_count[nid];
    w.meta[r] = (w.nodes[nid] & 0xff) | ((w.out_count[nid] == 0) << 8) | (max(pc, 1) << 16);
    int* rp = w.rpred + size_t(r) * E;
    if (pc == 0) rp[0] = 0;
    for (int e = 0; e < pc; ++e) rp[e] = w.pos_of[w.in_edges[size_t(nid) * E + e]] + 1;
  }
  __syncwarp();
}

// One banded NW pass (nw_align_banded :69-193) of the read in s_read
// (length rl) against the graph of nc nodes, by the warp: band rows 0..nc
// of W = b.W ints into the slab, each also into a ring of R rows (ring
// slot g & (R - 1), row stride W) from which rows at distance d < R are
// read. Lane l holds band lanes l * 8 .. l * 8 + 7 of each tile of 256:
// chunks of CELLS lanes whose predecessor reads are guarded one chunk at a
// time, as the reference's threads are.
__device__ void nw_banded_warp(const Win& w, const Band& b, const uint8_t* s_read, int rl,
                               int nc, int gap, int mismatch, int match, int* ring, int R) {
  const int lane = threadIdx.x & 31;
  const int E = w.E, W = b.W, bw = b.bw;
  int* const scores = w.scores;
  for (int k = lane; k <= bw; k += 32) {  // row 0: band start 0
    scores[SLOT0 + k] = k * gap;
    if (R) ring[SLOT0 + k] = k * gap;
  }
  __syncwarp();
  // each row's metadata and first two predecessor rows, lane l holding row
  // r0 + l's, loaded 32 rows ahead of their use (the loads' latency is
  // about a row's time); a longer list is read where a row needs it
  int cm, c0, c1, nm, n0, n1;
  auto chunk = [&](int r0, int& m, int& p0, int& p1) {
    const int r = r0 + lane;
    m = r < nc ? w.meta[r] : 0;
    p0 = r < nc ? w.rpred[size_t(r) * E] : 0;
    p1 = r < nc && E > 1 ? w.rpred[size_t(r) * E + 1] : 0;
  };
  chunk(0, cm, c0, c1);
  chunk(32, nm, n0, n1);
  SEG_INIT();
  for (int r = 0; r < nc; ++r) {
    SEG_T0();
    const int g = r + 1;
    if ((r & 31) == 0 && r) {
      cm = nm;
      c0 = n0;
      c1 = n1;
      chunk(r + 32, nm, n0, n1);
    }
    const int meta = __shfl_sync(FULL, cm, r & 31);
    const int p0 = __shfl_sync(FULL, c0, r & 31), p1 = __shfl_sync(FULL, c1, r & 31);
    const int nb = meta & 0xff, np = meta >> 16;
    const int* rp = w.rpred + size_t(r) * E;
    // slot `lane` of the predecessor list, for rows of more than two
    const int mypred = np > 2 && lane < np ? rp[lane] : 0;
    auto pred = [&](int e) {  // e uniform
      return e == 0 ? p0 : (e == 1 ? p1 : (e < 32 ? __shfl_sync(FULL, mypred, e) : rp[e]));
    };
    // predecessor row pi: in the ring at distance d < R, else in the slab;
    // either holds slot s at int SLOT0 + s
    auto in_ring = [&](int pi) { return g - pi < R; };
    auto row_of = [&](int pi) -> const int* {
      return (in_ring(pi) ? ring + (pi & (R - 1)) * W : scores + size_t(pi) * W) + SLOT0;
    };
    const int bs = band_start(g, b);
    // the column -1 boundary (:147-161)
    int fe;
    if (p0 == 0) {
      fe = gap;  // a source row
    } else if (bs > CELLS && np == 1) {
      fe = MIN_SCORE + gap;
    } else {
      int pen = MIN_SCORE;
      for (int e0 = 0; e0 < np; e0 += 32) {
        const int e = e0 + lane;
        const int pi = e == 0 ? p0 : (e == 1 ? p1 : (e < 32 ? mypred : rp[min(e, np - 1)]));
        const int v = e < np ? row_of(pi)[0] : MIN_SCORE;
        pen = max(pen, __reduce_max_sync(FULL, v));
      }
      fe = pen + gap;
    }
    int* const slab_row = scores + size_t(g) * W + SLOT0;
    int* const ring_row = ring + (g & (R - 1)) * W + SLOT0;
    if (lane == 0) {
      slab_row[0] = fe;
      if (R) ring_row[0] = fe;
    }
    int carry = fe + gap;  // seeds the closure: v[-1] = fe
    SEG(0);
    for (int t0 = 0; t0 < bw; t0 += BAND_TW) {
      const int k0 = t0 + lane * BAND_CPL;  // this lane's two chunks: k0, k0 + 4
      const int rpos = bs + k0;
      const bool live = k0 < bw, live_b = k0 + CELLS < bw;
      // the read's bases at rpos.. (a word of 4 at a time, rpos a multiple
      // of 4; the read's buffer has 4 bytes past L) against the row's base
      uint32_t eq[2] = {0, 0};
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (rpos + CELLS * h < rl)
          eq[h] = __vcmpeq4(*reinterpret_cast<const uint32_t*>(s_read + rpos + CELLS * h),
                            0x01010101u * uint32_t(nb));
      int sub[BAND_CPL], cand[BAND_CPL];
#pragma unroll
      for (int c = 0; c < BAND_CPL; ++c) {
        const bool same = rpos + c < rl && ((eq[c / CELLS] >> (8 * (c % CELLS))) & 1);
        sub[c] = same ? match : mismatch;
        cand[c] = MIN_SCORE;
      }
      for (int e = 0; e < np; ++e) {
        const int pi = pred(e);
        if (!live) continue;
        const int pbs = row_start(pi, b);
        const int pbe = min(pbs + bw - CELLS, b.max_column);
        // a chunk reads its predecessor's 5 values only when its start lies
        // in [pbs, pbe]; else all 5 read MIN_SCORE (the 5th is the next
        // chunk's first: the two guards are separate)
        const bool ga = rpos >= pbs && rpos <= pbe;
        const bool gb = live_b && rpos + CELLS >= pbs && rpos + CELLS <= pbe;
        // slots s .. s + 8 (s = rpos - pbs, a multiple of 4): slot s alone,
        // then s + 1 .. s + 4 and s + 5 .. s + 8, 16 bytes a load (16-aligned
        // at SLOT0 = 3)
        const int* src = row_of(pi) + (rpos - pbs);
        int v[BAND_CPL + 1];
#pragma unroll
        for (int c = 0; c <= BAND_CPL; ++c) v[c] = MIN_SCORE;
        if (ga) v[0] = src[0];
        if (ga || gb) {
          const int4 x = *reinterpret_cast<const int4*>(src + 1);
          v[1] = x.x;
          v[2] = x.y;
          v[3] = x.z;
          v[4] = x.w;
        }
        if (gb) {
          const int4 x = *reinterpret_cast<const int4*>(src + 1 + CELLS);
          v[5] = x.x;
          v[6] = x.y;
          v[7] = x.z;
          v[8] = x.w;
        }
        // each chunk's 5 values read MIN_SCORE unless its own guard holds
        // (slots s + 1 .. s + 4 were loaded for either chunk)
#pragma unroll
        for (int c = 0; c < CELLS; ++c) {
          const int d = ga ? v[c] : MIN_SCORE, u = ga ? v[c + 1] : MIN_SCORE;
          cand[c] = max(cand[c], max(d + sub[c], u + gap));
        }
        if (live_b) {
          const int vb4 = gb ? v[4] : MIN_SCORE;
#pragma unroll
          for (int c = CELLS; c < BAND_CPL; ++c)
            cand[c] = max(cand[c], max((c == CELLS ? vb4 : v[c]) + sub[c], v[c + 1] + gap));
        }
      }
      SEG(1);
      // closure: v[k] = k*gap + max(fe + gap, max_{m<=k}(cand[m] - m*gap))
      int pm[BAND_CPL], run = NEG_ID;
#pragma unroll
      for (int c = 0; c < BAND_CPL; ++c) {
        const int k = k0 + c;
        if (k < bw) run = max(run, cand[c] - k * gap);
        pm[c] = run;
      }
      const int incl = warp_incl_max(run);
      const int excl = __shfl_up_sync(FULL, incl, 1);
      const int pre = lane ? max(carry, excl) : carry;
      int o[BAND_CPL];
#pragma unroll
      for (int c = 0; c < BAND_CPL; ++c) o[c] = max(pre, pm[c]) + (k0 + c) * gap;
      // slots 1 + k0 .. to the slab and the ring, 16 bytes a store
      const int4 oa = make_int4(o[0], o[1], o[2], o[3]), ob = make_int4(o[4], o[5], o[6], o[7]);
      if (live) {
        *reinterpret_cast<int4*>(slab_row + 1 + k0) = oa;
        if (R) *reinterpret_cast<int4*>(ring_row + 1 + k0) = oa;
      }
      if (live_b) {
        *reinterpret_cast<int4*>(slab_row + 1 + k0 + CELLS) = ob;
        if (R) *reinterpret_cast<int4*>(ring_row + 1 + k0 + CELLS) = ob;
      }
      carry = max(carry, __shfl_sync(FULL, incl, 31));
      SEG(2);
    }
    __syncwarp();  // the row is written
    SEG(3);
  }
  SEG_FLUSH();
  __syncwarp();  // the slab's rows are visible to every lane
}

// The traceback's start (banded.py :196-203): the first sink row with the
// strictly highest score at column rl above MIN_SCORE, else 0. By the warp,
// one row a lane.
__device__ int banded_best_row(const Win& w, const Band& b, int rl, int nc) {
  const int lane = threadIdx.x & 31;
  int best = MIN_SCORE, at = 0;  // this lane's first strict maximum
  for (int idx = 1 + lane; idx <= nc; idx += 32) {
    if ((w.meta[idx - 1] >> 8) & 1) {
      const int s = get_score(w, b, idx, rl);
      if (best < s) {
        best = s;
        at = idx;
      }
    }
  }
  const int m = __reduce_max_sync(FULL, best);
  if (m == MIN_SCORE) return 0;
  return int(__reduce_min_sync(FULL, best == m ? unsigned(at) : 0xffffffffu));
}

// The banded modes, one warp per window, wpb windows a block: BAND 1
// static, 2 adaptive; OUT 0 consensus (cons, cov, len, err in o0..o3), 1
// MSA (rows (B, S, N) uint8, msa_len, err in o0..o2). caps (B,): each
// window's node cap; the slab is sized for N.
template <int BAND, int OUT>
__global__ void __launch_bounds__(WIN_WARPS * 32, OUT == 0 ? BAND_MIN_BLOCKS
                                                           : BAND_MIN_BLOCKS - 1)
poa_banded_kernel(const uint8_t* __restrict__ seqs, const int* __restrict__ wts,
                  const int* __restrict__ lens, const int* __restrict__ nseqs,
                  const int* __restrict__ caps, void* o0, void* o1, void* o2, void* o3,
                  uint8_t* __restrict__ scratch, long long slab_bytes, int w0, int nwin, int wpb,
                  int S, int L, int N, int E, int A, int gap, int mismatch, int match,
                  int band_width) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * wpb + warp;
  if (i >= nwin) return;
  const size_t b = size_t(w0) + i;
  uint8_t* const mine = smem + size_t(warp) * banded_warp_bytes(L);
  int* const region = reinterpret_cast<int*>(mine);
  uint8_t* const s_read = mine + BAND_REGION;
  __shared__ Win s_win[WIN_WARPS];
  if (lane == 0) {
    s_win[warp] = slab_win(scratch + size_t(i) * size_t(slab_bytes),
                           Layout(N, L, E, A, BAND, OUT, S, band_alloc(BAND, band_width)), N,
                           L, E, A, S, OUT == 1);
    s_win[warp].N = caps[b];  // the window's own node cap
  }
  __syncwarp();
  const Win& w = s_win[warp];

  for (int n = lane; n < N; n += 32) w.mark[n] = 0;  // reads are stamped 1..S-1
  if (OUT == 0) {
    for (int n = lane; n < N; n += 32) {
      ((uint8_t*)o0)[b * N + n] = 0;
      ((int*)o1)[b * N + n] = 0;
    }
  } else {
    for (size_t t = lane; t < size_t(S) * N; t += 32) ((uint8_t*)o0)[b * S * N + t] = '-';
    for (size_t t = lane; t < size_t(N) * S; t += 32) w.seq_next[t] = -1;
    for (int t = lane; t < S; t += 32) w.begin[t] = 0;
    __syncwarp();  // before the backbone writes seq_next
  }

  // backbone (cudapoa_kernels.cuh:200-238); a window whose first read is
  // longer than its cap fails here (cpu_reference.build_backbone)
  const int len0 = lens[b * S];
  const bool fits = len0 <= w.N;
  const int* wwt = wts + b * S * L;
  for (int j = lane; fits && j < len0; j += 32) {
    w.nodes[j] = seqs[b * S * L + j];
    w.sorted[j] = j;
    w.pos_of[j] = j;
    w.in_count[j] = j == 0 ? 0 : 1;
    w.out_count[j] = j == len0 - 1 ? 0 : 1;
    w.al_count[j] = 0;
    w.cov[j] = 1;
    w.in_edges[size_t(j) * E] = j - 1;
    w.out_edges[size_t(j) * E] = j + 1;
    w.in_w[size_t(j) * E] = j == 0 ? wwt[0] : wwt[j - 1] + wwt[j];
    if (OUT == 1 && j < len0 - 1) w.seq_next[size_t(j) * S] = j + 1;
  }
  __syncwarp();
  const int ns = nseqs[b];
  int nc = fits ? len0 : 0, err = fits ? 0 : 1;
  PHASE_T0();
  for (int s = 1; fits && s < ns; ++s) {
    if (nc >= w.N) {
      err = 1;
      break;
    }
    const int rl = lens[b * S + s];
    for (int j = lane; j < rl; j += 32) s_read[j] = seqs[(b * S + s) * L + j];
    __syncwarp();
    // nw_align_banded_with_rerun: a pass, and after a band-shift code one
    // re-run with it; the alignment length or a negative code (status 3)
    PHASE_MARK();
    banded_rows(w, nc);
    int aln_len = 0, rerun = 0;
    for (int pass = 0; pass < 2; ++pass) {
      Band bd;
      if (!band_params(nc, rl, band_width, BAND == 2, rerun, &bd)) {
        aln_len = rerun;
        break;
      }
      nw_banded_warp(w, bd, s_read, rl, nc, gap, mismatch, match, region,
                     band_ring_rows(bd.W));
      PHASE_ADD(0);
      PHASE_COUNT(6, nc);
      // the traceback's table of each row's metadata and first predecessor
      // in the region, where it fits (the ring is done with)
      int2* const table = size_t(nc) * sizeof(int2) <= BAND_REGION
                              ? reinterpret_cast<int2*>(region) : nullptr;
      for (int r = lane; table && r < nc; r += 32)
        table[r] = make_int2(w.meta[r], w.rpred[size_t(r) * E]);
      __syncwarp();
      const int i0 = banded_best_row(w, bd, rl, nc);
      aln_len = traceback_banded(w, bd, s_read, rl, nc, i0, gap, mismatch, match,
                                 BAND == 2 && rerun == 0 && bd.bw < MAX_BAND, table);
      __syncwarp();  // the moves are visible, the region free
      PHASE_ADD(1);
      PHASE_COUNT(7, max(aln_len, 0));
      if (aln_len != SHIFT_LEFT && aln_len != SHIFT_RIGHT) break;
      rerun = aln_len;
    }
    err = aln_len < 0 ? 3 : 0;
    // the add's stage and its bits of landed nodes, then the sort's working
    // set, in the region where they fit
    const int paths = window_paths(BAND_REGION, w.N, nc);
    if (!err)
      err = add_walk<true, OUT == 1>(w, aln_len, s_read, wwt + size_t(s) * L, &nc, s,
                                     paths & WIN_ADD_UNSTAGED ? nullptr
                                                              : reinterpret_cast<AddStage*>(region),
                                     reinterpret_cast<unsigned*>(region + sizeof(AddStage) / 4));
    PHASE_ADD(2);
    if (!err) {
      if (window_paths(BAND_REGION, w.N, nc) & WIN_TOPSORT_SCALAR) {
        if (lane == 0) err = topsort(w, nc);
        __syncwarp();  // lane 0's order
        err = __shfl_sync(FULL, err, 0);
      } else {
        err = topsort_cached(w, nc, reinterpret_cast<uint16_t*>(region));
      }
    }
    PHASE_ADD(3);
    __syncwarp();  // every lane is done with s_read and the region
    if (err) break;
  }
  PHASE_MARK();
  if (OUT == 0) {
    int length = 0;
    if (!err)
      err = consensus_warp(w, nc,
                           window_paths(BAND_REGION, w.N, nc) & WIN_CSCORE_DEVICE ? w.cscore
                                                                                   : region,
                           (uint8_t*)o0 + b * N, (int*)o1 + b * N, &length);
    if (lane == 0) {
      ((int*)o2)[b] = err ? 0 : length;
      ((int*)o3)[b] = err;
    }
  } else if (lane == 0) {
    ((int*)o1)[b] = err ? 0 : msa_emit(w, nc, ns, N, (uint8_t*)o0 + b * S * N);
    ((int*)o2)[b] = err;
  }
  PHASE_ADD(4);
  PHASE_FLUSH();
}

// Windows a block of poa_banded_kernel<BAND, OUT> takes for reads up to L
// bases (0 where one does not fit the card's shared memory), after setting
// its dynamic shared memory to that many windows'.
template <int BAND, int OUT>
int banded_wpb(int L, cudaError_t* err) {
  const size_t wb = banded_warp_bytes(L);
  int dev = 0, limit = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (*err != cudaSuccess) return 0;
  if (wb > size_t(limit)) {
    *err = cudaErrorInvalidValue;  // a read too long for a warp
    return 0;
  }
  const int wpb = int(min(size_t(WIN_WARPS), size_t(limit) / wb));
  *err = cudaFuncSetAttribute(poa_banded_kernel<BAND, OUT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, int(wpb * wb));
  return *err == cudaSuccess ? wpb : 0;
}

template <int BAND, int OUT>
int launch_banded(const void* seqs, const void* wts, const void* lens, const void* nseqs,
                  const void* caps, void* o0, void* o1, void* o2, void* o3, void* scratch,
                  long long slab_bytes, int w0, int nwin, int S, int L, int N, int E, int A,
                  int gap, int mismatch, int match, int band_width, cudaStream_t stream) {
  cudaError_t e;
  const int wpb = banded_wpb<BAND, OUT>(L, &e);
  if (!wpb) return int(e);
  poa_banded_kernel<BAND, OUT><<<(nwin + wpb - 1) / wpb, wpb * 32,
                                 wpb * banded_warp_bytes(L), stream>>>(
      (const uint8_t*)seqs, (const int*)wts, (const int*)lens, (const int*)nseqs,
      (const int*)caps, o0, o1, o2, o3, (uint8_t*)scratch, slab_bytes, w0, nwin, wpb, S, L, N,
      E, A, gap, mismatch, match, band_width);
  return int(cudaGetLastError());
}

// Windows of reads up to L bases the card holds at once in
// poa_banded_kernel<BAND, OUT> (0 where a read is too long).
template <int BAND, int OUT>
int banded_occupancy(int L) {
  cudaError_t e;
  const int wpb = banded_wpb<BAND, OUT>(L, &e);
  int dev = 0, sms = 0, blocks = 0;
  if (!wpb || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, poa_banded_kernel<BAND, OUT>,
                                                    wpb * 32, wpb * banded_warp_bytes(L)) !=
          cudaSuccess)
    return 0;
  return blocks * sms * wpb;
}

// The ring's rows a window of reads up to L bases gets: the most of 8, 4, 2
// that keeps its shared memory within WARP_SMEM_BUDGET, else none.
inline int ring_rows(int L, int cpl) {
  for (int r = RING_MAX; r >= 2; r >>= 1)
    if (WarpSmem(L, cpl, r).bytes <= size_t(WARP_SMEM_BUDGET)) return r;
  return 0;
}

template <int CPL, int OUT>
int launch_window(const void* seqs, const void* wts, const void* lens, const void* nseqs,
                  void* const* o, void* scratch, long long slab_bytes, int w0, int nwin, int S,
                  int L, int N, int E, int A, int gap, int mismatch, int match,
                  cudaStream_t stream) {
  const int R = ring_rows(L, CPL);
  const size_t wb = WarpSmem(L, CPL, R).bytes;
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return int(e);
  if (wb > size_t(limit)) return int(cudaErrorInvalidValue);  // a read too long for a warp
  const int wpb = int(min(size_t(WIN_WARPS), size_t(limit) / wb));
  e = cudaFuncSetAttribute(poa_window_kernel<CPL, OUT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(wpb * wb));
  if (e != cudaSuccess) return int(e);
  poa_window_kernel<CPL, OUT><<<(nwin + wpb - 1) / wpb, wpb * 32, wpb * wb, stream>>>(
      (const uint8_t*)seqs, (const int*)wts, (const int*)lens, (const int*)nseqs, o[0], o[1],
      o[2], o[3], o[4], o[5], (uint8_t*)scratch, slab_bytes, w0, nwin, wpb, S, L, N, E, A, gap,
      mismatch, match, R);
  return int(cudaGetLastError());
}

// Windows of reads up to L bases the card holds at once in
// poa_window_kernel<CPL, OUT>: its blocks an SM (registers, shared memory,
// warps) x the SMs x the windows a block; 0 where a read is too long.
template <int CPL, int OUT>
int window_occupancy(int L) {
  const size_t wb = WarpSmem(L, CPL, ring_rows(L, CPL)).bytes;
  int dev = 0, limit = 0, sms = 0, blocks = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      wb > size_t(limit))
    return 0;
  const int wpb = int(min(size_t(WIN_WARPS), size_t(limit) / wb));
  if (cudaFuncSetAttribute(poa_window_kernel<CPL, OUT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(wpb * wb)) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, poa_window_kernel<CPL, OUT>,
                                                    wpb * 32, wpb * wb) != cudaSuccess)
    return 0;
  return blocks * sms * wpb;
}

// Columns a lane: 9 (tiles of 288 columns) for reads up to 287 bases, else
// 11 (352), in tiles past 351.
template <int OUT>
int launch_full(const void* seqs, const void* wts, const void* lens, const void* nseqs,
                void* const* o, void* scratch, long long slab_bytes, int w0, int nwin, int S,
                int L, int N, int E, int A, int gap, int mismatch, int match,
                cudaStream_t stream) {
  if (L + 1 <= 32 * 9)
    return launch_window<9, OUT>(seqs, wts, lens, nseqs, o, scratch, slab_bytes, w0, nwin, S, L,
                                 N, E, A, gap, mismatch, match, stream);
  return launch_window<11, OUT>(seqs, wts, lens, nseqs, o, scratch, slab_bytes, w0, nwin, S, L,
                                N, E, A, gap, mismatch, match, stream);
}

}  // namespace

extern "C" {

// Debug build only: copy the fifteen sums (five phases' cycles, windows,
// NW rows, moves, five NW row segments' cycles, NW cells and predecessor
// cells) into out and zero them.
#ifdef POA_PHASE_CLOCKS
int poa_phase_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(g_phase_clocks));
  if (e == cudaSuccess) {
    const unsigned long long zero[PHASE_COUNTERS] = {};
    e = cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero));
  }
  return int(e);
}
#endif

// Windows the full-band kernel with output `out` holds on the card at once
// for reads up to L bases (0 if it cannot run them).
int poa_windows_in_flight(int out, int L) {
  const bool narrow = L + 1 <= 32 * 9;
  if (out == 0) return narrow ? window_occupancy<9, 0>(L) : window_occupancy<11, 0>(L);
  if (out == 1) return narrow ? window_occupancy<9, 1>(L) : window_occupancy<11, 1>(L);
  return narrow ? window_occupancy<9, 2>(L) : window_occupancy<11, 2>(L);
}

// Score rows of the shared ring a full-band window with reads up to L bases
// gets (8, 4, 2 or 0); farther predecessor rows are read from the slab.
int poa_window_ring_rows(int L) {
  return L + 1 <= 32 * 9 ? ring_rows(L, 9) : ring_rows(L, 11);
}

// The shared-memory paths (window_paths bits: 1 no score ring, 2 the add
// unstaged, 4 topsort on one lane, 8 consensus scores in device memory) a
// full-band window with reads up to L bases, node cap N and nc nodes takes.
int poa_window_paths(int L, int N, int nc) {
  const int cpl = L + 1 <= 32 * 9 ? 9 : 11, R = ring_rows(L, cpl);
  return window_paths(size_t(R) * WarpSmem(L, cpl, R).RW * 4, N, nc);
}

// Windows poa_banded_kernel<band, out> (band 1 static, 2 adaptive; out 0
// consensus, 1 MSA) holds on the card at once for reads up to L bases (0
// if it cannot run them or the mode is unknown).
int poa_banded_windows_in_flight(int band, int out, int L) {
  if (band == 1) return out == 0 ? banded_occupancy<1, 0>(L) : banded_occupancy<1, 1>(L);
  if (band == 2) return out == 0 ? banded_occupancy<2, 0>(L) : banded_occupancy<2, 1>(L);
  return 0;
}

// The shared-memory paths (window_paths bits, as poa_window_paths) a banded
// window with node cap N and nc nodes takes.
int poa_banded_paths(int N, int nc) { return window_paths(BAND_REGION, N, nc); }

// Bytes of one window's scratch slab (full-band consensus).
long long poa_slab_bytes(int N, int L, int E, int A) {
  return (long long)Layout(N, L, E, A).total;
}

// Bytes of one window's scratch slab for band kind `band` (0 full, 1
// static, 2 adaptive) and output `out` (0 consensus, 1 MSA, 2 graph); W is
// the banded row width (the widest band plus 8).
long long poa_mode_slab_bytes(int band, int out, int N, int L, int E, int A, int S, int W) {
  return (long long)Layout(N, L, E, A, band, out, S, W).total;
}

// Launch windows [w0, w0 + nwin) of the full-band consensus on `stream`;
// slab i of `scratch` serves window w0 + i. Returns cudaGetLastError()
// after the launch (or the error of its set-up).
int poa_consensus_launch(const void* seqs, const void* wts, const void* lens,
                         const void* nseqs, void* cons, void* cov, void* len, void* err,
                         void* scratch, long long slab_bytes, int w0, int nwin, int S, int L,
                         int N, int E, int A, int gap, int mismatch, int match,
                         void* stream) {
  void* const o[6] = {cons, cov, len, err, nullptr, nullptr};
  return launch_full<0>(seqs, wts, lens, nseqs, o, scratch, slab_bytes, w0, nwin, S, L, N, E, A,
                        gap, mismatch, match, (cudaStream_t)stream);
}

// The same for band kind `band` and output `out` (see poa_mode_slab_bytes),
// every mode but the full-band consensus above; caps is each window's node
// cap (banded modes); the outputs are o0..o5 as the kernels take them.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a mode that has
// no instantiation here.
int poa_mode_launch(int band, int out, const void* seqs, const void* wts, const void* lens,
                    const void* nseqs, const void* caps, void* o0, void* o1, void* o2,
                    void* o3, void* o4, void* o5, void* scratch, long long slab_bytes, int w0,
                    int nwin, int S, int L, int N, int E, int A, int gap, int mismatch,
                    int match, int band_width, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  void* const o[6] = {o0, o1, o2, o3, o4, o5};
  if (band == 0 && out == 1)
    return launch_full<1>(seqs, wts, lens, nseqs, o, scratch, slab_bytes, w0, nwin, S, L, N, E,
                          A, gap, mismatch, match, st);
  if (band == 0 && out == 2)
    return launch_full<2>(seqs, wts, lens, nseqs, o, scratch, slab_bytes, w0, nwin, S, L, N, E,
                          A, gap, mismatch, match, st);
#define POA_MODE(BAND, OUT)                                                                 \
  if (band == BAND && out == OUT)                                                           \
    return launch_banded<BAND, OUT>(seqs, wts, lens, nseqs, caps, o0, o1, o2, o3, scratch,  \
                                    slab_bytes, w0, nwin, S, L, N, E, A, gap, mismatch,     \
                                    match, band_width, st);
  POA_MODE(1, 0)
  POA_MODE(1, 1)
  POA_MODE(2, 0)
  POA_MODE(2, 1)
#undef POA_MODE
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
