// The lockstep POA tier for Hopper (sm_90a): the phases of one read (NW,
// traceback, add alignment, topological sort) and the final consensus, each
// over a whole bucket of windows; a read is two launches, the NW and
// lk_read_kernel (traceback, add and topsort fused).
//
// Replaces the five Pallas TPU kernels of
// genomeworks_tpu/ops/poa_lockstep_pallas.py: nw_lockstep (_nw_kernel),
// tb_lockstep (_tb_kernel), add_lockstep (_add_kernel), topsort_lockstep
// (_topsort_kernel) and consensus_lockstep (_consensus_kernel). Their plain
// PyTorch versions, which these kernels equal bit for bit, are in
// genomeworks_tpu_torch/poa/lockstep_plain.py; the error codes (1, 3, 5, 6,
// 100; first error wins) are documented there.
//
// The TPU ran one window per vector lane, 128 windows in lockstep, with the
// graph as (N, 128) planes and every pointer chase a one-hot gather. Here
// the graph state is the port's (B, N) layout in device memory, and a
// window is one warp:
// - NW (nw_lockstep): one warp per window, several windows a block. Its
//   bound on this card is the bytes of the priority codes it writes (one a
//   cell); what costs is the chain of rows in topological order, a few
//   hundred dependent instructions of one warp each. So a row costs no
//   block-wide barrier and, for most of its predecessors, no device-memory
//   round trip. Each lane holds CPL = ceil((Lr + 1) / 32) consecutive
//   columns in registers (a template parameter). Scores are kept less
//   j * gap, so the horizontal closure is a prefix max: in the lane, then
//   one warp shuffle scan. A row reads its predecessor rows by topological
//   distance d: d = 1 from registers (68 % of the reads on the covid
//   workload), 2 <= d <= NW_C from a ring of the last NW_C rows in shared
//   memory, and only d > NW_C from a ring of D + 1 rows in device memory,
//   to which a row is written only when the prologue found a later row
//   reading it that far. Every lane reads and writes only its own columns
//   of a ring, so the rings need no barrier; the codes go through a
//   shared-memory stage and out a word a lane, one __syncwarp a row. NW_C
//   is 4: at 3 more reads go to device memory, at 5 or 8 fewer windows fit
//   on the card at once (PERF.md).
// - Traceback, add and topsort (tb_lockstep, add_lockstep,
//   topsort_lockstep): lk_read_kernel<PH>, one warp per window, the phases
//   of PH in one launch; the main path runs all three (PH 7), the wrappers
//   of the single phases one each. All three are walks, chains of
//   dependent steps bound by their latency, not by bytes or operations
//   (the codes a traceback reads are a few hundred bytes of megabytes);
//   the kernel's time follows its longest window. So each phase first
//   loads, all lanes at once, what its walk will read into shared memory,
//   and the phases hand each other their data there:
//   * traceback: a table of each row's node and predecessor rows, so that a
//     move needs only its code byte from device memory; and lanes that
//     load the codes of the next 32 moves at once, guessing each to be a
//     diagonal to the row's first predecessor, so that a run of such
//     moves costs one round trip. The moves go to a 16-bit stage in shared
//     memory (fused) instead of device memory.
//   * add: before the walk the warp loads what the walk never writes (the
//     moves, the read's bases and weights, 32 steps at a time) and mirrors
//     in shared memory the per-node fields it reads on every step (base,
//     in-, out- and aligned counts, coverage), writing the counts back
//     after the walk. A step then reads device memory only for the lists
//     it scans, one slot a lane: the aligned list of its graph node (a
//     ballot finds the first member with the read's base) and the in-edge
//     list of the node it lands on.
//   * topsort: Kahn's order from the counts the add left in its mirror and
//     an out-edge cache, one lane per out-edge of the popped node, a ballot
//     to enqueue.
//   Shared memory: about 24 N bytes a window (ReadLayout), so 24 windows an
//   SM at N = 384, the largest covid bucket in one wave.
// - Consensus (consensus_lockstep): one warp per window, several windows a
//   block, the scores and predecessors in shared memory. A chain of
//   dependent steps (the heaviest path, row by row in sorted order), bound
//   by its latency: the lanes load each next 32 rows' in-counts and first
//   in-edges ahead, so that a row of one or two in-edges (most rows) is
//   lane 0's, from shared memory only; longer in-lists take the warp.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (genomeworks_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

// The graph state of B windows, each array int32 and window-major: (B, N)
// fields, (B, N, E) edge lists, (B, N, A) aligned lists, (B,) counts.
struct State {
  int *nodes, *in_edges, *in_count, *in_w, *out_edges, *out_count, *al, *al_count, *cov,
      *sorted, *pos_of, *node_count, *error;
  int N, E, A;
};

// One window's view of the state.
struct Win {
  int *nodes, *in_edges, *in_count, *in_w, *out_edges, *out_count, *al, *al_count, *cov,
      *sorted, *pos_of;
  int N, E, A;
  __device__ Win(const State& s, int b) : N(s.N), E(s.E), A(s.A) {
    const size_t n = size_t(b) * N, ne = n * E, na = n * A;
    nodes = s.nodes + n;
    in_edges = s.in_edges + ne;
    in_count = s.in_count + n;
    in_w = s.in_w + ne;
    out_edges = s.out_edges + ne;
    out_count = s.out_count + n;
    al = s.al + na;
    al_count = s.al_count + n;
    cov = s.cov + n;
    sorted = s.sorted + n;
    pos_of = s.pos_of + n;
  }
};

State make_state(void* const* p, int N, int E, int A) {
  State s;
  int** f[] = {&s.nodes, &s.in_edges, &s.in_count, &s.in_w, &s.out_edges, &s.out_count,
               &s.al, &s.al_count, &s.cov, &s.sorted, &s.pos_of, &s.node_count, &s.error};
  for (int i = 0; i < 13; ++i) *f[i] = (int*)p[i];
  s.N = N;
  s.E = E;
  s.A = A;
  return s;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// ---------------------------------------------------------------------------
// NW (row 1 of the TPU kernels: nw_lockstep)
// ---------------------------------------------------------------------------

constexpr unsigned FULL = 0xffffffffu;
constexpr int NEG_ID = INT_MIN;  // identity of max
constexpr int NEG_HALF = INT_MIN / 2;  // below every score; a score added to it stays below
#ifndef NW_C
#define NW_C 4  // score rows a window keeps in shared memory
#endif
constexpr int NW_WARPS = 4;       // windows per block, at most
constexpr int NW_MAX_CPL = 20;    // columns per lane: read_len + 1 <= 640
constexpr int NW_PRE_E = 8;       // in-edge slots the prologue loads at once
// s_meta: base | sink << 8 | far << 9 | predecessors << 10
constexpr int META_FAR = 1 << 9;

__device__ __forceinline__ int warp_incl_max(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v = max(v, u);
  }
  return v;
}

// Shared memory of one window (warp): the ring of NW_C rows (lane-major),
// per-row metadata, two code stages, predecessor distances; 16-aligned.
inline size_t nw_warp_smem(int N, int E, int cpl) {
  const size_t W = size_t(32) * cpl;
  return (size_t(NW_C) * W * 4 + size_t(N) * 4 + 2 * W + size_t(N) * E + 15) / 16 * 16;
}

// One warp per window; lane l holds columns l*CPL .. l*CPL + CPL - 1. `far`
// is the device ring: (B, D + 1, 32 * CPL) int32, lane-major like the
// shared one (column l*CPL + c of a row at c*32 + l).
template <int CPL>
__global__ void __launch_bounds__(NW_WARPS * 32)
lk_nw_kernel(State st, int B, int wpb, int warp_bytes, const uint8_t* __restrict__ read, int Lr,
             const int* __restrict__ rl_in, const bool* __restrict__ act,
             uint8_t* __restrict__ codes, int Lp, int* __restrict__ best_out,
             int* __restrict__ far_g, int D, int gap, int mismatch, int match) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int W = 32 * CPL;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * wpb + warp;
  if (b >= B) return;
  if (!act[b] || st.error[b] != 0) {
    if (lane == 0) best_out[b] = 0;
    return;
  }
  const Win w(st, b);
  const int N = w.N, E = w.E, HORIZ = 2 * E, BIGP = 3 * E + 1, R = D + 1;
  const int nc = st.node_count[b], rl = rl_in[b];
  unsigned char* p = smem + size_t(warp) * warp_bytes;
  int* ring = (int*)p;  // row g at slot g % NW_C
  p += size_t(NW_C) * W * 4;
  int* s_meta = (int*)p;
  p += size_t(N) * 4;
  uint8_t* s_stage = p;  // codes of row r at (r & 1) * W
  p += 2 * W;
  uint8_t* s_dist = p;  // distance of each predecessor row, edge order
  int* far = far_g + size_t(b) * R * W;

  // per-row metadata; a row read from farther than NW_C is flagged for the
  // device ring; the first row (in order) with an in-count over E (6) or a
  // predecessor outside [1, D] (5) decides the error
  for (int r = lane; r < nc; r += 32) s_meta[r] = 0;
  __syncwarp();
  int first = INT_MAX;
  for (int r = lane; r < nc; r += 32) {
    const int nid = clampi(w.sorted[r], 0, N - 1);
    const int* ie = w.in_edges + size_t(nid) * E;
    // the first NW_PRE_E slots' predecessors and positions are loaded
    // together, under predicates, so a row costs three dependent loads
    int pos[NW_PRE_E];
#pragma unroll
    for (int e = 0; e < NW_PRE_E; ++e) pos[e] = e < E ? ie[e] : 0;
    const int pc = w.in_count[nid], np = min(pc, E);
#pragma unroll
    for (int e = 0; e < NW_PRE_E; ++e)
      if (e < np) pos[e] = w.pos_of[clampi(pos[e], 0, N - 1)];
    int code = pc > E ? 6 : 0;
    auto edge = [&](int e, int d) {
      if (d < 1 || d > D) {
        if (!code) code = 5;
      } else {
        s_dist[size_t(r) * E + e] = uint8_t(d);
        if (d > NW_C && r >= d) atomicOr(&s_meta[r - d], META_FAR);
      }
    };
#pragma unroll
    for (int e = 0; e < NW_PRE_E; ++e)
      if (e < np) edge(e, r - pos[e]);
    for (int e = NW_PRE_E; e < np; ++e) edge(e, r - w.pos_of[clampi(ie[e], 0, N - 1)]);
    atomicOr(&s_meta[r], (w.nodes[nid] & 0xff) | ((w.out_count[nid] == 0) << 8) | (np << 10));
    if (code && first == INT_MAX) first = (r << 3) | code;  // a lane's rows ascend
  }
  first = __reduce_min_sync(FULL, first);
  if (first != INT_MAX) {
    if (lane == 0) {
      st.error[b] = first & 7;
      best_out[b] = 0;
    }
    return;
  }
  __syncwarp();

  const int j0 = lane * CPL;
  // the read's base before each of the lane's columns, four to a word
  uint32_t rb[(CPL + 3) / 4];
#pragma unroll
  for (int k = 0; k < (CPL + 3) / 4; ++k) rb[k] = 0;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int j = j0 + c;
    if (j >= 1 && j <= rl) rb[c >> 2] |= uint32_t(read[size_t(b) * Lr + j - 1]) << ((c & 3) * 8);
  }
  // the codes go out a word a lane where rows start on a word
  const bool words = ((uintptr_t(codes) | uintptr_t(Lp)) & 3) == 0;
  // Scores are kept as S'[j] = S[j] - j * gap: a vertical move adds gap, a
  // diagonal one sub - gap, the horizontal closure is a prefix max, and a
  // horizontal move is S'[j] == S'[j - 1]. Codes and the best sink row
  // compare scores of one column, so they are those of S.
  const int dsub_match = match - gap, dsub_mismatch = mismatch - gap;
  int row[CPL];  // the last row (graph row g - 1), then the new one
#pragma unroll
  for (int c = 0; c < CPL; ++c) row[c] = 0;
  int best = INT_MIN, best_i = 0;
  const int at_rl = (rl % CPL) * 32 + rl / CPL;  // column rl in a ring row

  // Every lane computes all its columns, also those past rl: a column only
  // reads columns at or left of it, so those past rl never reach a column
  // at or left of rl, and nothing past rl is written out. Lane 0 reads
  // NEG_HALF left of column 0, so column 0 takes no diagonal and no
  // horizontal move.
  for (int r = 0; r < nc; ++r) {
    const int g = r + 1;
    const int meta = s_meta[r];
    const int nb = meta & 0xff, sink = (meta >> 8) & 1, np = meta >> 10;
    const uint8_t* rd = s_dist + size_t(r) * E;
    // the predecessor row at distance d (graph row g - d; row 0 is virtual)
    auto load = [&](int d, int* up) {
      const int gp = g - d;
      if (gp == 0) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) up[c] = 0;
      } else if (d == 1) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) up[c] = row[c];
      } else if (d <= NW_C) {
        const int* src = ring + (gp % NW_C) * W;
#pragma unroll
        for (int c = 0; c < CPL; ++c) up[c] = src[c * 32 + lane];
      } else {
        const int* src = far + size_t(gp % R) * W;
#pragma unroll
        for (int c = 0; c < CPL; ++c) up[c] = src[c * 32 + lane];
      }
    };
    auto dsub = [&](int c) {
      return int((rb[c >> 2] >> ((c & 3) * 8)) & 0xff) == nb ? dsub_match : dsub_mismatch;
    };
    // per column: the best diagonal and vertical candidates over the
    // predecessors, and (over two or more) the first predecessor reaching
    // each (de | ve << 8); a source row's predecessor is the virtual row 0
    int dmax[CPL], vmax[CPL], idx[CPL], up[CPL];
    load(np ? rd[0] : g, up);
    int left = __shfl_up_sync(FULL, up[CPL - 1], 1);
    if (lane == 0) left = NEG_HALF;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      vmax[c] = up[c] + gap;
      dmax[c] = (c ? up[c - 1] : left) + dsub(c);
    }
    if (np > 1) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) idx[c] = 0;
      for (int e = 1; e < np; ++e) {
        load(rd[e], up);
        left = __shfl_up_sync(FULL, up[CPL - 1], 1);
        if (lane == 0) left = NEG_HALF;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int vv = up[c] + gap, dd = (c ? up[c - 1] : left) + dsub(c);
          if (vv > vmax[c]) {
            vmax[c] = vv;
            idx[c] = (idx[c] & 0xff) | (e << 8);
          }
          if (dd > dmax[c]) {
            dmax[c] = dd;
            idx[c] = (idx[c] & ~0xff) | e;
          }
        }
      }
    }
    // horizontal closure: a prefix max over the warp
    int run = NEG_ID;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      run = max(run, max(dmax[c], vmax[c]));
      row[c] = run;
    }
    int excl = __shfl_up_sync(FULL, warp_incl_max(run), 1);
    if (lane == 0) excl = NEG_ID;
#pragma unroll
    for (int c = 0; c < CPL; ++c) row[c] = max(excl, row[c]);
    // priority codes against the closed row: diagonal by edge order,
    // vertical by edge order, horizontal
    int hleft = __shfl_up_sync(FULL, row[CPL - 1], 1);
    if (lane == 0) hleft = NEG_HALF;
    uint8_t* stage = s_stage + (r & 1) * W;
    if (np > 1) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int x = row[c];
        int code = x == (c ? row[c - 1] : hleft) ? HORIZ : BIGP;
        code = vmax[c] == x ? E + (idx[c] >> 8) : code;
        code = dmax[c] == x ? (idx[c] & 0xff) : code;
        stage[j0 + c] = uint8_t(code);
      }
    } else {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int x = row[c];
        int code = x == (c ? row[c - 1] : hleft) ? HORIZ : BIGP;
        code = vmax[c] == x ? E : code;
        code = dmax[c] == x ? 0 : code;
        stage[j0 + c] = uint8_t(code);
      }
    }
    int* ring_out = ring + (g % NW_C) * W;
#pragma unroll
    for (int c = 0; c < CPL; ++c) ring_out[c * 32 + lane] = row[c];
    if (meta & META_FAR) {
      int* far_out = far + size_t(g % R) * W;
#pragma unroll
      for (int c = 0; c < CPL; ++c) far_out[c * 32 + lane] = row[c];
    }
    __syncwarp();  // the stage and the ring row are written
    if (sink) {  // the first sink row with the highest score at column rl
      const int x = ring_out[at_rl];
      if (x > best) {
        best = x;
        best_i = g;
      }
    }
    uint8_t* code_out = codes + (size_t(b) * N + r) * Lp;
    if (words) {
      const int nw = (rl + 1) >> 2;
      for (int q = lane; q < nw; q += 32)
        reinterpret_cast<uint32_t*>(code_out)[q] = reinterpret_cast<const uint32_t*>(stage)[q];
      if (lane < ((rl + 1) & 3)) code_out[4 * nw + lane] = stage[4 * nw + lane];
    } else {
      for (int j = lane; j <= rl; j += 32) code_out[j] = stage[j];
    }
  }
  if (lane == 0) best_out[b] = best_i;
}

// ---------------------------------------------------------------------------
// Traceback, add, topsort (rows 2-4): lk_read_kernel, a warp per window
// ---------------------------------------------------------------------------

// The phases lk_read_kernel<PH> runs, bits of PH. The main path runs all
// three in one launch a read (PH_ALL); tb_lockstep, add_lockstep and
// topsort_lockstep launch one phase alone, so that each phase's outputs and
// whole state can be held to its plain version.
constexpr int PH_TB = 1, PH_ADD = 2, PH_SORT = 4, PH_ALL = 7;
constexpr int READ_WARPS = 4;       // windows per block, at most
constexpr int READ_MIN_BLOCKS = 6;  // blocks an SM: 24 warps, at most 80 registers a thread
constexpr int OUT_CACHE = 7;  // out-edge slots the topsort keeps in shared memory
constexpr int TB_ROWS = 2;    // table rows a lane loads at once

// Debug build (-DLK_READ_STATS=1, off in normal builds): lane 0 of each
// window adds its phases' clock64() cycles and counts to g_read_stats
// (the RS_* counters below), read with lk_read_stats.
enum {
  RS_TB_WINDOWS, RS_TB_TABLE_CYCLES, RS_TB_WALK_CYCLES, RS_TB_STEPS, RS_TB_ROUNDS,
  RS_ADD_WINDOWS, RS_ADD_CYCLES, RS_ADD_STEPS, RS_SORT_WINDOWS, RS_SORT_CYCLES, RS_SORT_NODES,
  RS_COUNT
};
#ifdef LK_READ_STATS
__device__ unsigned long long g_read_stats[RS_COUNT];
#define RS_CLOCK() clock64()
#define RS_ADD(k, n)                                                          \
  do {                                                                        \
    if ((threadIdx.x & 31) == 0) atomicAdd(&g_read_stats[k], (unsigned long long)(n)); \
  } while (0)
#else
#define RS_CLOCK() 0LL
#define RS_ADD(k, n) \
  do {               \
  } while (0)
#endif

__host__ __device__ inline int al16(int x) { return (x + 15) & ~15; }

// A window's shared memory in lk_read_kernel<PH>, byte offsets from its
// warp's slice; each phase reuses what the one before left dead:
// - traceback: the predecessor table at 0, a row of E + 1 int16 per graph
//   row r < node_count (its node, then pos_of + 1 of each in-edge slot's
//   node, 0 for every slot where the node has no in-edge), then at `pos`
//   pos_of + 1 of every node (int16) while the table is built, and after
//   it the jump tables of the guessed moves (2 x N int16), so that the
//   traceback's 20 N bytes at E = 7 are no more than the add's;
// - add: the mirror of the per-node fields at 0, int32: in-count, out-count,
//   base, aligned count, coverage (N each);
// - fused only, after both: the moves from the traceback to the add at
//   `stage`, a uint16 a step (ag + 1, and bit 15 where the step consumed a
//   read base), `words` (those bits, 32 steps a word) and `jw` (the read
//   column before each 32nd step), from which a step's ar is rebuilt;
// - topsort: the add's in- and out-counts at 0 (loaded when it runs alone),
//   the out-edge cache at `cache` (OUT_CACHE planes of N uint16 node ids,
//   over the mirror's dead fields) and the queue (N uint16) at `queue`.
// 16-bit ids and positions: N <= 32767 (the wrapper checks).
struct ReadLayout {
  int pos, stage, words, jw, cache, queue, bytes;
  __host__ __device__ ReadLayout(int PH, int N, int E, int K) {
    const int nw = (K + 31) / 32;
    const int table = al16(2 * N * (E + 1));
    pos = table;
    const int jumps = 2 * al16(2 * N);
    const int tb = (PH & PH_TB) ? table + (jumps > 2 * N ? jumps : al16(2 * N)) : 0;
    const int mirror = (PH & PH_ADD) ? al16(20 * N) : 0;
    int top = tb > mirror ? tb : mirror;
    stage = words = jw = top;
    if ((PH & PH_TB) && (PH & PH_ADD)) {
      words = stage + al16(2 * K);
      jw = words + al16(4 * nw);
      top = jw + al16(4 * nw);
    }
    const int oc = E < OUT_CACHE ? E : OUT_CACHE;
    cache = al16(8 * N);
    queue = cache + al16(2 * N * oc);
    const int sort = (PH & PH_SORT) ? queue + al16(2 * N) : 0;
    bytes = top > sort ? top : sort;
  }
};

// Traceback of one window by its warp, from (bi, rl) over the codes `wc`:
// the walk of lockstep_plain.tb_lockstep_plain. Moves k < K go to the stage
// (STAGE) or to ag/ar in device memory. Returns the number of moves, or -1
// when the walk does not reach (0, 0) within K + 2 moves; in every lane.
//
// The prologue builds the predecessor table, all lanes at once; a move then
// needs only its code byte from device memory. A round speculates up to
// 32 moves, one a lane: lane l takes the position l guessed moves ahead (to the
// row's first predecessor, diagonally; vertically in column 0; horizontally
// in row 0), loads its code, all lanes at once, and computes its real move.
// A guessed move goes to row f(r), the row's first predecessor (f(0) = 0),
// and to column max(c - 1, 0), so lane l's position is (f^l(i), max(j - l,
// 0)): f is the table's first slot, the prologue tabulates f^4 and f^16,
// and a lane reaches f^l(i) in at most seven lookups (-1 past the table's
// rows: no guess).
// Lanes 0..c-1 take their moves, c - 1 being the first lane whose real
// move is not the next lane's position (or the last position before (0, 0)
// or the step cap); the next round starts where lane c - 1's move ends. A
// wrong guess costs a round, never a wrong move.
template <bool STAGE>
__device__ int tb_phase(const Win& w, int nc, const uint8_t* __restrict__ wc, int Lp, int bi,
                        int rl, int K, unsigned char* sm, const ReadLayout& lay, int* wag,
                        int* war) {
  const int lane = threadIdx.x & 31;
  const int N = w.N, E = w.E, HORIZ = 2 * E, RW = E + 1;
  int16_t* rt = (int16_t*)sm;
  int16_t* pos16 = (int16_t*)(sm + lay.pos);
  uint16_t* stage = (uint16_t*)(sm + lay.stage);
  int* jw = (int*)(sm + lay.jw);
  long long t0 = RS_CLOCK();
  for (int n0 = 0; n0 < N; n0 += 256) {
    int v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int n = n0 + 32 * u + lane;
      v[u] = n < N ? w.pos_of[n] : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int n = n0 + 32 * u + lane;
      if (n < N) pos16[n] = int16_t(v[u] + 1);
    }
  }
  __syncwarp();
  for (int r0 = 0; r0 < nc; r0 += 32 * TB_ROWS) {
    int nid[TB_ROWS], ic[TB_ROWS], p[TB_ROWS][NW_PRE_E];
#pragma unroll
    for (int u = 0; u < TB_ROWS; ++u) {
      const int r = r0 + 32 * u + lane;
      nid[u] = r < nc ? clampi(w.sorted[r], 0, N - 1) : 0;
    }
#pragma unroll
    for (int u = 0; u < TB_ROWS; ++u) {
      const int* ie = w.in_edges + size_t(nid[u]) * E;
      ic[u] = w.in_count[nid[u]];
#pragma unroll
      for (int e = 0; e < NW_PRE_E; ++e) p[u][e] = e < E ? ie[e] : 0;
    }
#pragma unroll
    for (int u = 0; u < TB_ROWS; ++u) {
      const int r = r0 + 32 * u + lane;
      if (r < nc) {
        int16_t* row = rt + size_t(r) * RW;
        row[0] = int16_t(nid[u]);
#pragma unroll
        for (int e = 0; e < NW_PRE_E; ++e)
          if (e < E) row[1 + e] = ic[u] == 0 ? int16_t(0) : pos16[clampi(p[u][e], 0, N - 1)];
        for (int e = NW_PRE_E; e < E; ++e)
          row[1 + e] = ic[u] == 0 ? int16_t(0)
                                  : pos16[clampi(w.in_edges[size_t(nid[u]) * E + e], 0, N - 1)];
      }
    }
  }
  __syncwarp();  // the table, and the last reads of pos16
  // the jump tables f^4 and f^16 over rows 0..last, where pos16 was
  const int last = min(nc, N - 1);
  int16_t* f4 = pos16;
  int16_t* f16 = f4 + al16(2 * N) / 2;
  auto hop1 = [&](int x) {
    return x < 0 || x > last ? -1 : x == 0 ? 0 : int(rt[size_t(x - 1) * RW + 1]);
  };
  auto hop = [&](const int16_t* f, int x) { return x < 0 || x > last ? -1 : int(f[x]); };
  for (int r = lane; r <= last; r += 32) f4[r] = int16_t(hop1(hop1(hop1(hop1(r)))));
  __syncwarp();
  for (int r = lane; r <= last; r += 32) f16[r] = int16_t(hop(f4, hop(f4, hop(f4, hop(f4, r)))));
  __syncwarp();
  long long t1 = RS_CLOCK();
  int i = bi, j = rl, k = 0, rounds = 0;
  while ((i != 0 || j != 0) && k < K + 2) {
    // lane l's position: l guessed moves from (i, j); live while it is not
    // (0, 0) and every row on the way is in the table
    int mi = i, mj = j;
    bool live = lane == 0;
    if (lane > 0) {
      int ci = lane & 16 ? hop(f16, i) : i;
      for (int q = (lane >> 2) & 3; q > 0; --q) ci = hop(f4, ci);
      for (int q = lane & 3; q > 0; --q) ci = hop1(ci);
      mi = ci;
      mj = max(j - lane, 0);
      live = ci >= 0 && (ci != 0 || mj != 0);
    }
    // the real move from there, as tb_lockstep_plain makes it
    int code = HORIZ;
    if (live && mi != 0) code = wc[size_t(clampi(mi - 1, 0, N - 1)) * Lp + clampi(mj, 0, Lp - 1)];
    int ni = mi, nj = mj - 1, nid = -1;
    if (live && code != HORIZ) {
      // a row in the table: the NW's best_i is at most nc, and a move goes
      // to a smaller row; the clamp only keeps a state the chain never
      // makes inside the table, as hop1 does
      const int r = min(mi - 1, nc - 1), e = code % E;
      nid = rt[size_t(r) * RW];
      ni = rt[size_t(r) * RW + 1 + e];
      nj = code < E ? mj - 1 : mj;
    }
    const int li = __shfl_down_sync(FULL, mi, 1), lj = __shfl_down_sync(FULL, mj, 1);
    const int llive = __shfl_down_sync(FULL, int(live), 1);
    const unsigned steps = __ballot_sync(FULL, live && k + lane < K + 2);
    const unsigned hits = __ballot_sync(FULL, lane < 31 && llive && ni == li && nj == lj);
    const int c = min(~steps ? __ffs(~steps) - 1 : 32, ~hits ? __ffs(~hits) : 32);
    if (lane < c && k + lane < K) {
      const int kk = k + lane, agv = ni == mi ? -1 : nid;
      if (STAGE) {
        stage[kk] = uint16_t((agv + 1) | (nj != mj ? 0x8000 : 0));
        if ((kk & 31) == 0) jw[kk >> 5] = mj;
      } else {
        wag[kk] = agv;
        war[kk] = nj == mj ? -1 : mj - 1;
      }
    }
    i = __shfl_sync(FULL, ni, c - 1);
    j = __shfl_sync(FULL, nj, c - 1);
    k += c;
    ++rounds;
  }
  const bool done = i == 0 && j == 0;
  if (STAGE && done) {  // the consumed-base bits, a word per 32 moves
    uint32_t* words = (uint32_t*)(sm + lay.words);
    __syncwarp();
    const int ks = min(k, K);
    for (int q0 = 0; q0 < ks; q0 += 32) {
      const int q = q0 + lane;
      const unsigned m = __ballot_sync(FULL, q < ks && (stage[q] & 0x8000));
      if (lane == 0) words[q0 >> 5] = m;
    }
  }
  RS_ADD(RS_TB_WINDOWS, 1);
  RS_ADD(RS_TB_TABLE_CYCLES, t1 - t0);
  RS_ADD(RS_TB_WALK_CYCLES, RS_CLOCK() - t1);
  RS_ADD(RS_TB_STEPS, k);
  RS_ADD(RS_TB_ROUNDS, rounds);
  (void)t0;
  (void)t1;
  (void)rounds;
  return done ? k : -1;
}

// The add's moves: ag/ar in device memory (the add alone), or the fused
// kernel's stage, where a step's ar is the read column before it less one:
// the column before its 32-step word less the bases consumed in the word
// before it.
struct DeviceMoves {
  const int* ag;
  const int* ar;
  __device__ int gid(int pos) const { return ag[pos]; }
  __device__ int col(int pos) const { return ar[pos]; }
};
struct StageMoves {
  const uint16_t* stage;
  const uint32_t* words;
  const int* jw;
  __device__ int gid(int pos) const { return (stage[pos] & 0x7fff) - 1; }
  __device__ int col(int pos) const {
    const int q = pos >> 5;
    return (stage[pos] & 0x8000) ? jw[q] - __popc(words[q] & ((1u << (pos & 31)) - 1)) - 1 : -1;
  }
};

// The sequential alignment-to-graph walk at the state's caps (E in- and
// out-edges, A aligned nodes): 1 when a new node makes the count reach N;
// 6 when a clique list or an edge list would overflow (that list is left
// alone). The walk stops after the step that sets the first error.
// Returns the error, in every lane.
//
// The warp walks together. Every lane computes the walk's scalars alike
// (the node count, the error, the head, the node of each step); lane 0
// makes the step's single writes, lane k the writes of a list's slot k.
// The node fields the walk reads on every step live in shared memory for
// the walk (`s_mirror`, ReadLayout): the bases, the in-, out- and aligned
// counts and the coverage; the counts and the coverage go back to device
// memory at its end, a base at once. Correct under the invariant the walk
// keeps: a clique list holds distinct nodes other than its owner, the same
// count for every member.
template <class Moves>
__device__ int add_phase(const State& st, int b, const Win& w, int* s_mirror, const Moves& mv,
                         int kl, int K, const uint8_t* __restrict__ read,
                         const int* __restrict__ wts, int Lr) {
  const int lane = threadIdx.x & 31;
  const int N = w.N, E = w.E, A = w.A;
  int* s_in = s_mirror;
  int* s_out = s_in + N;
  int* s_nodes = s_out + N;
  int* s_alc = s_nodes + N;
  int* s_cov = s_alc + N;
  long long clk0 = RS_CLOCK();
  const int nc0 = st.node_count[b];
  for (int n = lane; n < nc0; n += 32) {
    s_nodes[n] = w.nodes[n];
    s_in[n] = w.in_count[n];
    s_out[n] = w.out_count[n];
    s_alc[n] = w.al_count[n];
    s_cov[n] = w.cov[n];
  }
  const uint8_t* wread = read + size_t(b) * Lr;
  const int* wwt = wts ? wts + size_t(b) * Lr : nullptr;
  int nc = nc0, err = 0, head = -1, prev_w = 0;
  for (int t0 = 0; t0 < kl && err == 0; t0 += 32) {
    // lane i holds step t0 + i: its graph node, the read's base (-1 where
    // the read has a gap) and weight
    int m_gid = -1, m_base = -1, m_w = 0;
    if (t0 + lane < kl) {
      const int pos = clampi(kl - 1 - t0 - lane, 0, K - 1);
      const int a = mv.col(pos);
      if (a != -1) {
        const int rp = clampi(a, 0, Lr - 1);
        m_gid = mv.gid(pos);
        m_base = wread[rp];
        m_w = wwt ? wwt[rp] : 1;
      }
    }
    for (int i = 0; i < min(32, kl - t0) && err == 0; ++i) {
      const int base = __shfl_sync(FULL, m_base, i);
      if (base < 0) continue;
      const int gid = __shfl_sync(FULL, m_gid, i);
      const int wt = __shfl_sync(FULL, m_w, i);
      __syncwarp();  // the previous step's writes
      const bool has_gid = gid != -1;
      const int gid_c = clampi(gid, 0, N - 1);
      const int na = has_gid ? s_alc[gid_c] : 0;
      const bool reuse_graph = has_gid && s_nodes[gid_c] == base;
      // the first member of gid's clique with the read's base
      bool reuse_al = false;
      int first_al = 0, mem0 = 0;
      if (has_gid && !reuse_graph) {
        const int nl = min(na, A);
        for (int a0 = 0; a0 < nl; a0 += 32) {
          const int a = a0 + lane;
          const int m = a < nl ? w.al[size_t(gid_c) * A + a] : 0;
          if (a0 == 0) mem0 = m;
          const unsigned hit = __ballot_sync(FULL, a < nl && s_nodes[clampi(m, 0, N - 1)] == base);
          if (hit) {
            reuse_al = true;
            first_al = __shfl_sync(FULL, m, __ffs(hit) - 1);
            break;
          }
        }
      }
      const bool new_node = !reuse_graph && !reuse_al;
      const int cur = clampi(reuse_graph ? gid_c : (reuse_al ? first_al : nc), 0, N - 1);
      if (new_node) {
        if (++nc >= N) err = 1;
        if (lane == 0) {
          w.nodes[cur] = base;
          s_nodes[cur] = base;
          s_out[cur] = 0;
          s_in[cur] = 0;
          s_alc[cur] = 0;
          s_cov[cur] = 0;
        }
      }
      if (new_node && has_gid) {  // cur joins gid's aligned clique
        if (na + 1 > A - 1) {
          if (!err) err = 6;
        } else {
          int* cl = w.al + size_t(cur) * A;
          for (int a0 = 0; a0 < na; a0 += 32) {
            const int a = a0 + lane;
            if (a < na) {
              const int aid = clampi(a0 ? w.al[size_t(gid_c) * A + a] : mem0, 0, N - 1);
              const int acnt = s_alc[aid];
              w.al[size_t(aid) * A + min(acnt, A - 1)] = cur;
              s_alc[aid] = acnt + 1;
              cl[a] = aid;
            }
          }
          __syncwarp();
          if (lane == 0) {
            w.al[size_t(gid_c) * A + na] = cur;
            cl[na] = gid_c;
            s_alc[gid_c] = na + 1;
            s_alc[cur] = na + 1;
          }
        }
      }
      if (head != -1) {  // edge head -> cur: reweigh every slot holding it, else append
        int* il = w.in_edges + size_t(cur) * E;
        int* iw = w.in_w + size_t(cur) * E;
        const int ic = new_node ? 0 : s_in[cur], oc = s_out[head], dw = prev_w + wt;
        const int nl = min(ic, E);
        __syncwarp();  // every lane has read the counts lane 0 may write below
        bool exists = false;
        for (int e0 = 0; e0 < nl; e0 += 32) {
          const int e = e0 + lane;
          const bool h = e < nl && il[e] == head;
          if (h) iw[e] += dw;
          exists |= __ballot_sync(FULL, h) != 0;
        }
        if (!exists) {
          if (ic >= E || oc >= E) {
            if (!err) err = 6;
          } else if (lane == 0) {
            il[ic] = head;
            iw[ic] = dw;
            w.out_edges[size_t(head) * E + oc] = cur;
            s_in[cur] = ic + 1;
            s_out[head] = oc + 1;
          }
        }
      }
      if (lane == 0) s_cov[cur] += 1;
      head = cur;
      prev_w = wt;
    }
  }
  __syncwarp();
  for (int n = lane; n < min(nc, N); n += 32) {
    w.in_count[n] = s_in[n];
    w.out_count[n] = s_out[n];
    w.al_count[n] = s_alc[n];
    w.cov[n] = s_cov[n];
  }
  if (lane == 0) {
    st.node_count[b] = nc;
    st.error[b] = err;
  }
  RS_ADD(RS_ADD_WINDOWS, 1);
  RS_ADD(RS_ADD_CYCLES, RS_CLOCK() - clk0);
  RS_ADD(RS_ADD_STEPS, kl);
  (void)clk0;
  return err;
}

// Kahn's sort of one window by its warp: seeds by ascending id, FIFO
// expansion in out-edge order (lockstep_plain.topsort_lockstep_plain).
// Rewrites positions 0..nc-1 of sorted and pos_of (-1 where a node is not
// placed); returns 100 when not every node is placed, else 0.
//
// From shared memory (ReadLayout): the in-counts (decremented in place)
// and out-counts the add left in its mirror, or loaded (LOAD, the sort
// alone); the lanes first copy each node's first OUT_CACHE out-edges
// there; then one lane per out-edge of the popped node decrements its
// target's count, and a ballot enqueues the nodes that reached zero, in
// edge order. Popping a node reads shared memory only (device memory for
// out-edge slots past OUT_CACHE). Correct because an out-list holds
// distinct nodes in a graph the add left without error.
template <bool LOAD>
__device__ int sort_phase(const Win& w, int nc, unsigned char* sm, const ReadLayout& lay) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int N = w.N, E = w.E, OC = min(E, OUT_CACHE);
  int* s_loc = (int*)sm;
  const int* s_oc = s_loc + N;
  uint16_t* s_cache = (uint16_t*)(sm + lay.cache);
  uint16_t* s_queue = (uint16_t*)(sm + lay.queue);
  long long t0 = RS_CLOCK();
  if (LOAD) {
    for (int n = lane; n < nc; n += 32) {
      s_loc[n] = w.in_count[n];
      s_loc[N + n] = w.out_count[n];
    }
    __syncwarp();
  }
  int tail = 0;
  for (int n0 = 0; n0 < nc; n0 += 32) {
    const int n = n0 + lane;
    int ic = 1;
    if (n < nc) {
      ic = s_loc[n];
      const int oc = min(s_oc[n], OC);
      int o[OUT_CACHE];
#pragma unroll
      for (int q = 0; q < OUT_CACHE; ++q) o[q] = q < oc ? w.out_edges[size_t(n) * E + q] : 0;
#pragma unroll
      for (int q = 0; q < OUT_CACHE; ++q)
        if (q < oc) s_cache[size_t(q) * N + n] = uint16_t(clampi(o[q], 0, N - 1));
    }
    const unsigned seeds = __ballot_sync(FULL, ic == 0);
    if (ic == 0) {
      const int at = tail + __popc(seeds & below);
      s_queue[at] = uint16_t(n);
      w.sorted[at] = n;
      w.pos_of[n] = at;
    }
    tail += __popc(seeds);
  }
  __syncwarp();
  int node = tail > 0 ? s_queue[0] : 0;
  for (int i = 0; i < tail; ++i) {
    // the next node, where it is already queued; its count and first
    // out-edge slot are loaded with this node's
    const bool ahead = i + 1 < tail;
    const int next = ahead ? s_queue[i + 1] : 0;
    const int oc = s_oc[node];
    const int first = lane < OC ? s_cache[size_t(lane) * N + node] : 0;
    for (int e0 = 0; e0 < oc; e0 += 32) {
      const int e = e0 + lane;
      int out = 0;
      bool zero = false;
      if (e < oc) {
        out = e < OC ? first : clampi(w.out_edges[size_t(node) * E + e], 0, N - 1);
        if (out < nc) {
          const int l = s_loc[out] - 1;
          s_loc[out] = l;
          zero = l == 0;
        }
      }
      const unsigned z = __ballot_sync(FULL, zero);
      if (zero) {
        const int at = tail + __popc(z & below);
        s_queue[at] = uint16_t(out);
        w.sorted[at] = out;
        w.pos_of[out] = at;
      }
      tail += __popc(z);
    }
    __syncwarp();
    node = ahead ? next : (i + 1 < tail ? s_queue[i + 1] : 0);
  }
  if (tail != nc) {  // a node left unplaced: its count never reached zero
    for (int q = tail + lane; q < nc; q += 32) w.sorted[q] = -1;
    for (int n = lane; n < nc; n += 32)
      if (s_loc[n] > 0) w.pos_of[n] = -1;
  }
  RS_ADD(RS_SORT_WINDOWS, 1);
  RS_ADD(RS_SORT_CYCLES, RS_CLOCK() - t0);
  RS_ADD(RS_SORT_NODES, nc);
  (void)t0;
  return tail != nc ? 100 : 0;
}

// One warp per window, the phases of PH in order, each only where the
// window is active and has no error:
// - traceback (lockstep_plain.tb_lockstep_plain): from (best_i, rl) over
//   the codes; writes klen (0 where it does not run or fails, and error 3
//   then), and the moves to the stage (fused) or to ag/ar (alone, prefilled
//   with -1 by the wrapper);
// - add (add_lockstep_plain): the moves from the stage (fused) or ag/ar and
//   klen (alone);
// - topsort (topsort_lockstep_plain).
// Between phases the warp synchronises: lane 0's device-memory writes in
// the add are then visible to every lane of the sort.
template <int PH>
__global__ void __launch_bounds__(READ_WARPS * 32, READ_MIN_BLOCKS)
lk_read_kernel(State st, int B, int wpb, int warp_bytes, const uint8_t* __restrict__ codes,
               int Lp, const int* __restrict__ best_i, const int* __restrict__ rl,
               const bool* __restrict__ act, int* ag, int* ar, int* klen, int K,
               const uint8_t* __restrict__ read, const int* __restrict__ wts, int Lr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * wpb + warp;
  if (b >= B) return;
  if (!act[b] || st.error[b] != 0) {
    if ((PH & PH_TB) && lane == 0) klen[b] = 0;
    return;
  }
  unsigned char* sm = smem + size_t(warp) * warp_bytes;
  const ReadLayout lay(PH, st.N, st.E, K);
  const Win w(st, b);
  int kl = 0;
  if (PH & PH_TB) {
    constexpr bool stage = (PH & PH_ADD) != 0;
    kl = tb_phase<stage>(w, st.node_count[b], codes + size_t(b) * w.N * Lp, Lp, best_i[b], rl[b],
                         K, sm, lay, stage ? nullptr : ag + size_t(b) * K,
                         stage ? nullptr : ar + size_t(b) * K);
    if (lane == 0) {
      klen[b] = kl < 0 ? 0 : kl;
      if (kl < 0) st.error[b] = 3;
    }
    if (kl < 0) return;
    __syncwarp();  // the stage, and the table's last reads before the add's mirror
  } else if (PH & PH_ADD) {
    kl = klen[b];
  }
  int nc = 0;
  if (PH & PH_ADD) {
    int err;
    if constexpr ((PH & PH_TB) != 0) {
      const StageMoves mv{(const uint16_t*)(sm + lay.stage), (const uint32_t*)(sm + lay.words),
                          (const int*)(sm + lay.jw)};
      err = add_phase(st, b, w, (int*)sm, mv, kl, K, read, wts, Lr);
    } else {
      const DeviceMoves mv{ag + size_t(b) * K, ar + size_t(b) * K};
      err = add_phase(st, b, w, (int*)sm, mv, kl, K, read, wts, Lr);
    }
    if (err != 0) return;
    __syncwarp();  // the add's device-memory and mirror writes, before the sort
    nc = st.node_count[b];
  }
  if (PH & PH_SORT) {
    if (!(PH & PH_ADD)) nc = st.node_count[b];
    if (sort_phase<(PH & PH_ADD) == 0>(w, nc, sm, lay) != 0 && lane == 0) st.error[b] = 100;
  }
}

// ---------------------------------------------------------------------------
// Consensus (row 5): one warp per window
// ---------------------------------------------------------------------------

constexpr int CONS_WARPS = 4;  // windows a block, at most
constexpr int CONS_PRE = 2;    // in-edges of a node loaded ahead with it
// blocks an SM the launch bound asks for: at most 64 registers a thread,
// which ptxas then uses without spilling (it spilled at its own choice of 40)
constexpr int CONS_MIN_BLOCKS = 8;

// A window's shared memory: the consensus scores and predecessors (N ints
// each), and the stage of the next 32 sorted nodes: id, in-count and the
// first CONS_PRE in-edges and weights.
struct ConsStage {
  int nid[32], pc[32], ie[CONS_PRE][32], iw[CONS_PRE][32];
};
__host__ __device__ inline size_t cons_warp_bytes(int N) {
  return size_t(N) * 8 + sizeof(ConsStage);
}

// One row of the heaviest-edge pass by the warp, one lane per in-edge: the
// twin of consensus_row_warp in poa_consensus.cu (the full band's, whose
// comment gives the order it equals: the sequential scan's last edge of
// the largest weight whose source scores highest). Returns (score,
// predecessor).
__device__ __forceinline__ int2 cons_row_warp(const Win& w, const int* cscore, int nid, int pc,
                                              bool skip) {
  const int lane = threadIdx.x & 31;
  const int* il = w.in_edges + size_t(nid) * w.E;
  const int* iw = w.in_w + size_t(nid) * w.E;
  int s = skip ? -1 : cscore[nid];
  int p = -1, sp = 0;
  for (int e0 = 0; e0 < pc; e0 += 32) {
    const int e = e0 + lane;
    int ew = INT_MIN, sb = INT_MIN, begin = -1;
    if (e < pc) {
      begin = il[e];
      sb = cscore[begin];
      ew = iw[e];
      if (skip && sb == -1) ew = INT_MIN;
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
  return make_int2(s, p);
}

// Rows from sorted position `from` on, in order, by the warp (the
// kernel's first pass and each branch completion's); returns (in every
// lane) the best, the last at the highest score, from (mx_s, 0).
__device__ __forceinline__ int cons_pass(const Win& w, ConsStage* stage, int* cscore, int* cpred,
                                         int nc, int from, bool skip, int mx_s) {
  const int lane = threadIdx.x & 31;
  const int E = w.E;
  int mx_i = 0;
  for (int g0 = from; g0 < nc; g0 += 32) {
    __syncwarp();  // lane 0 is done with the stage; its scores are visible
    if (g0 + lane < nc) {
      const int nid = w.sorted[g0 + lane];
      stage->nid[lane] = nid;
      stage->pc[lane] = w.in_count[nid];
#pragma unroll
      for (int e = 0; e < CONS_PRE; ++e) {
        if (e < E) {
          stage->ie[e][lane] = w.in_edges[size_t(nid) * E + e];
          stage->iw[e][lane] = w.in_w[size_t(nid) * E + e];
        }
      }
    }
    __syncwarp();
    for (int q = 0; q < 32 && g0 + q < nc; ++q) {
      const int pc = stage->pc[q], nid = stage->nid[q];
      int s, p;
      if (pc <= CONS_PRE) {
        if (lane != 0) continue;
        s = skip ? -1 : cscore[nid];
        p = -1;
        int sp = 0;
#pragma unroll
        for (int e = 0; e < CONS_PRE; ++e) {
          if (e < pc) {
            const int begin = stage->ie[e][q], ew = stage->iw[e][q];
            const int sb = cscore[begin];
            if (skip && sb == -1) continue;
            if (s < ew || (s == ew && p != -1 && sp <= sb)) {
              s = ew;
              p = begin;
              sp = sb;
            }
          }
        }
        if (p != -1) s += sp;
      } else {
        __syncwarp();  // lane 0's scores are visible
        const int2 sp = cons_row_warp(w, cscore, nid, pc, skip);
        s = sp.x;
        p = sp.y;
        __syncwarp();  // every lane has read the scores
        if (lane != 0) continue;
      }
      cscore[nid] = s;
      cpred[nid] = p;
      if (mx_s <= s) {
        mx_s = s;
        mx_i = nid;
      }
    }
  }
  __syncwarp();  // lane 0's scores are visible
  return __shfl_sync(FULL, mx_i, 0);
}

// Heaviest path, branch completion and backward emission
// (cudapoa_generate_consensus.cuh, lockstep_plain.consensus_lockstep_plain)
// a warp per window, several windows a block; cons and cov are zeroed by
// the wrapper. The scores and predecessors live in shared memory. The rows
// run in sorted order: the lanes load the next 32 nodes' in-counts and
// first in-edges and weights at once (independent loads, off the chain),
// lane 0 runs a row of at most CONS_PRE in-edges from them and shared
// memory alone (consensus_row's scan, so its tie-breaks), and a longer
// in-list takes the warp, a lane per in-edge. Branch completion clears a
// lane per in-edge; the emission walks cpred on lane 0 into a node list,
// then the lanes write the bases and coverages.
__global__ void __launch_bounds__(CONS_WARPS * 32, CONS_MIN_BLOCKS)
lk_consensus_kernel(State st, int B, int wpb, const bool* __restrict__ act,
                    uint8_t* __restrict__ cons, int* __restrict__ cov_out,
                    int* __restrict__ len_out, int* __restrict__ err_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * wpb + warp;
  if (b >= B) return;
  if (!act[b] || st.error[b] != 0) {
    if (lane == 0) {
      len_out[b] = 0;
      err_out[b] = st.error[b];
    }
    return;
  }
  const Win w(st, b);
  const int N = w.N, E = w.E, A = w.A, nc = st.node_count[b];
  ConsStage* const stage = reinterpret_cast<ConsStage*>(smem + size_t(warp) * cons_warp_bytes(N));
  int* const cscore = reinterpret_cast<int*>(stage + 1);
  int* const cpred = cscore + N;
  for (int n = lane; n < nc; n += 32) {
    cscore[n] = -1;
    cpred[n] = -1;
  }
  int max_id = cons_pass(w, stage, cscore, cpred, nc, 0, false, -1);
  int loops = 0;
  while (w.out_count[max_id] != 0 && loops < nc) {
    const int pos = w.pos_of[max_id];
    const int oc = w.out_count[max_id];
    for (int o0 = 0; o0 < oc; o0 += 32) {
      int out = 0, ic = 0;
      if (o0 + lane < oc) {
        out = w.out_edges[size_t(max_id) * E + o0 + lane];
        ic = w.in_count[out];
      }
      for (int q = 0; q < 32 && o0 + q < oc; ++q) {
        const int o = __shfl_sync(FULL, out, q), c = __shfl_sync(FULL, ic, q);
        for (int ie = lane; ie < c; ie += 32) {
          const int iid = w.in_edges[size_t(o) * E + ie];
          if (iid != max_id) cscore[iid] = -1;
        }
      }
    }
    max_id = cons_pass(w, stage, cscore, cpred, nc, pos + 1, true, 0);
    ++loops;
  }
  if (loops >= nc && loops > 0) {
    if (lane == 0) {
      len_out[b] = 0;
      err_out[b] = 3;
    }
    return;
  }
  // the path, backward from max_id, into a node list over the scores
  int* const path = cscore;
  int k = 0;
  if (lane == 0) {
    int cur = max_id;
    while (true) {
      if (k < N) path[k] = cur;
      ++k;  // counts on past N, as the plain version's length does
      const int p = cpred[cur];
      if (p == -1) break;
      cur = p;
    }
    len_out[b] = k;
    err_out[b] = 0;
  }
  k = __shfl_sync(FULL, k, 0);
  __syncwarp();  // the list is visible
  uint8_t* const wcons = cons + size_t(b) * N;
  int* const wcov = cov_out + size_t(b) * N;
  for (int t = lane; t < min(k, N); t += 32) {
    const int nid = path[t];
    int c = w.cov[nid];
    const int nal = w.al_count[nid];
    for (int a = 0; a < nal; ++a) c += w.cov[w.al[size_t(nid) * A + a]];
    wcons[t] = uint8_t(w.nodes[nid]);
    wcov[t] = c;
  }
}

// Windows a block of ``max_warps`` warps of ``warp_bytes`` shared memory
// each can hold within the card's opt-in limit (0: not one), after setting
// the kernel's dynamic shared memory to that many.
template <class Kernel>
int warps_per_block(Kernel kernel, size_t warp_bytes, int max_warps, cudaError_t* err) {
  int dev = 0, limit = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (*err != cudaSuccess) return 0;
  const size_t fit = size_t(limit) / warp_bytes;
  const int wpb = fit < size_t(max_warps) ? int(fit) : max_warps;
  if (wpb < 1) {
    *err = cudaErrorInvalidValue;
    return 0;
  }
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(wpb * warp_bytes));
  return *err == cudaSuccess ? wpb : 0;
}

template <int CPL>
int nw_launch(void* const* st, int B, int N, int E, int A, const void* read, int Lr,
              const void* rl, const void* act, void* codes, int Lp, void* best_i, void* ring,
              int D, int gap, int mismatch, int match, cudaStream_t stream) {
  const size_t wb = nw_warp_smem(N, E, CPL);
  cudaError_t e;
  const int wpb = warps_per_block(lk_nw_kernel<CPL>, wb, NW_WARPS, &e);
  if (!wpb) return int(e);
  lk_nw_kernel<CPL><<<(B + wpb - 1) / wpb, wpb * 32, wpb * wb, stream>>>(
      make_state(st, N, E, A), B, wpb, int(wb), (const uint8_t*)read, Lr, (const int*)rl,
      (const bool*)act, (uint8_t*)codes, Lp, (int*)best_i, (int*)ring, D, gap, mismatch, match);
  return int(cudaGetLastError());
}

inline int nw_cols_per_lane(int Lr) { return (Lr + 32) / 32; }

template <int PH>
int read_launch(void* const* st, int B, int N, int E, int A, const void* codes, int Lp,
                const void* best_i, const void* rl, const void* act, void* ag, void* ar,
                void* klen, int K, const void* read, const void* wts, int Lr,
                cudaStream_t stream) {
  const size_t wb = ReadLayout(PH, N, E, K).bytes;
  cudaError_t e;
  const int wpb = warps_per_block(lk_read_kernel<PH>, wb, READ_WARPS, &e);
  if (!wpb) return int(e);
  lk_read_kernel<PH><<<(B + wpb - 1) / wpb, wpb * 32, wpb * wb, stream>>>(
      make_state(st, N, E, A), B, wpb, int(wb), (const uint8_t*)codes, Lp, (const int*)best_i,
      (const int*)rl, (const bool*)act, (int*)ag, (int*)ar, (int*)klen, K, (const uint8_t*)read,
      (const int*)wts, Lr);
  return int(cudaGetLastError());
}

// Windows of lk_read_kernel<PH> the card holds at once (0 on an error).
template <int PH>
int read_in_flight(int N, int E, int K) {
  const size_t wb = ReadLayout(PH, N, E, K).bytes;
  cudaError_t e;
  const int wpb = warps_per_block(lk_read_kernel<PH>, wb, READ_WARPS, &e);
  int dev = 0, sms = 0, blocks = 0;
  if (!wpb || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lk_read_kernel<PH>, wpb * 32,
                                                    wpb * wb) != cudaSuccess)
    return 0;
  return blocks * wpb * sms;
}

}  // namespace

extern "C" {

// Width of a row of lk_nw_launch's device ring for reads of Lr bases: 32
// columns a lane, ceil((Lr + 1) / 32) lanes' worth; 0 when the kernel does
// not take reads that long.
int lk_nw_ring_width(int Lr) {
  const int cpl = nw_cols_per_lane(Lr);
  return Lr >= 0 && cpl <= NW_MAX_CPL ? 32 * cpl : 0;
}

// Every launch returns cudaGetLastError() after it (or the error of its
// set-up). `st` holds the 13 state pointers in the order of
// torch_poa.STATE_KEYS. `ring` is (B, D + 1, lk_nw_ring_width(Lr)) int32
// scratch.
int lk_nw_launch(void* const* st, int B, int N, int E, int A, const void* read, int Lr,
                 const void* rl, const void* act, void* codes, int Lp, void* best_i, void* ring,
                 int D, int gap, int mismatch, int match, void* stream) {
  switch (nw_cols_per_lane(Lr)) {
#define NW_CASE(C)                                                                      \
  case C:                                                                               \
    return nw_launch<C>(st, B, N, E, A, read, Lr, rl, act, codes, Lp, best_i, ring, D, \
                        gap, mismatch, match, (cudaStream_t)stream);
    NW_CASE(1) NW_CASE(2) NW_CASE(3) NW_CASE(4) NW_CASE(5) NW_CASE(6) NW_CASE(7)
    NW_CASE(8) NW_CASE(9) NW_CASE(10) NW_CASE(11) NW_CASE(12) NW_CASE(13) NW_CASE(14)
    NW_CASE(15) NW_CASE(16) NW_CASE(17) NW_CASE(18) NW_CASE(19) NW_CASE(20)
#undef NW_CASE
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The traceback, add and topsort of one read: `phases` 7 runs all three in
// one launch (the stage carries the moves; ag and ar are not used); 1, 2 or
// 4 runs one alone (the traceback writes ag/ar, prefilled with -1, and
// klen; the add reads them). Buffers a launch does not use may be null.
int lk_read_launch(void* const* st, int B, int N, int E, int A, int phases, const void* codes,
                   int Lp, const void* best_i, const void* rl, const void* act, void* ag,
                   void* ar, void* klen, int K, const void* read, const void* wts, int Lr,
                   void* stream) {
  switch (phases) {
#define READ_CASE(PH)                                                                     \
  case PH:                                                                                \
    return read_launch<PH>(st, B, N, E, A, codes, Lp, best_i, rl, act, ag, ar, klen, K, read, \
                           wts, Lr, (cudaStream_t)stream);
    READ_CASE(PH_TB) READ_CASE(PH_ADD) READ_CASE(PH_SORT) READ_CASE(PH_ALL)
#undef READ_CASE
    default:
      return int(cudaErrorInvalidValue);
  }
}

// Windows lk_read_kernel<phases> holds on the card at once for a graph cap
// of N nodes, E edges a list and K moves (0 for an unknown `phases`).
int lk_read_windows_in_flight(int phases, int N, int E, int K) {
  switch (phases) {
    case PH_TB: return read_in_flight<PH_TB>(N, E, K);
    case PH_ADD: return read_in_flight<PH_ADD>(N, E, K);
    case PH_SORT: return read_in_flight<PH_SORT>(N, E, K);
    case PH_ALL: return read_in_flight<PH_ALL>(N, E, K);
    default: return 0;
  }
}

// The debug build's counters (-DLK_READ_STATS=1): copies the RS_COUNT
// counters into `out` (host memory) and zeroes them when `reset`; returns
// -1 in a normal build.
int lk_read_stats(unsigned long long* out, int reset) {
#ifdef LK_READ_STATS
  cudaError_t e = cudaMemcpyFromSymbol(out, g_read_stats, sizeof(g_read_stats));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zero[RS_COUNT] = {};
    e = cudaMemcpyToSymbol(g_read_stats, zero, sizeof(zero));
  }
  return int(e);
#else
  (void)out;
  (void)reset;
  return -1;
#endif
}

// The consensus of each active window without an error; cons and cov
// zeroed by the caller.
int lk_consensus_launch(void* const* st, int B, int N, int E, int A, const void* act,
                        void* cons, void* cov, void* len, void* err, void* stream) {
  cudaError_t e;
  const size_t wb = cons_warp_bytes(N);
  const int wpb = warps_per_block(lk_consensus_kernel, wb, CONS_WARPS, &e);
  if (!wpb) return int(e);
  lk_consensus_kernel<<<(B + wpb - 1) / wpb, wpb * 32, wpb * wb, (cudaStream_t)stream>>>(
      make_state(st, N, E, A), B, wpb, (const bool*)act, (uint8_t*)cons, (int*)cov, (int*)len,
      (int*)err);
  return int(cudaGetLastError());
}

// Windows lk_consensus_kernel holds on the card at once for a node cap of N
// (0 on an error).
int lk_consensus_windows_in_flight(int N) {
  cudaError_t e;
  const size_t wb = cons_warp_bytes(N);
  const int wpb = warps_per_block(lk_consensus_kernel, wb, CONS_WARPS, &e);
  int dev = 0, sms = 0, blocks = 0;
  if (!wpb || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lk_consensus_kernel, wpb * 32,
                                                    wpb * wb) != cudaSuccess)
    return 0;
  return blocks * wpb * sms;
}

}  // extern "C"
