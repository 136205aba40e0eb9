// The lockstep POA tier for Hopper (sm_90a): the five phases of one read
// (NW, traceback, add alignment, topological sort) and the final consensus,
// each a kernel over a whole bucket of windows.
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
// graph as (N, 128) planes and every pointer chase a one-hot gather. Here a
// window is one block (NW) or one thread (the rest), and the graph state is
// the port's (B, N) layout in device memory:
// - NW: one block of 128 threads per window, over the read's columns; rows
//   in topological order. A row reads its predecessor rows by topological
//   distance from a ring of D + 1 int32 rows (int32 scores: the TPU's int16
//   ring clipped at +-32000) in device memory: a ring in shared memory
//   (103 KB at D = 128, Lp = 200) left two blocks an SM and ran 3.4x
//   slower on the covid workload's largest bucket on an H100 (PERF.md).
//   The horizontal closure is a block-wide prefix max (warp shuffles, one
//   word per warp in shared memory); a row costs two barriers and the
//   loads of its predecessor rows. Bound: the bytes of
//   the codes it writes, far below the card's rate; the row chain's
//   latency is what costs, so many blocks an SM matter most.
// - Traceback, add, topsort, consensus: one thread per window, 64 threads
//   a block, so a bucket of thousands of windows spreads over the SMs. They
//   are chains of dependent loads (pointer chases over the graph), bound by
//   their latency, not by bytes or operations; each kernel's time follows
//   its longest window.
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

constexpr int NW_NT = 128;             // threads per block (one window)
constexpr int NW_NWARP = NW_NT / 32;
constexpr int NW_CPT = 4;              // columns per thread per tile
constexpr int NW_TILE = NW_NT * NW_CPT;
constexpr int NEG_ID = INT_MIN;        // identity of max

__device__ __forceinline__ int warp_incl_max(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = max(v, u);
  }
  return v;
}

// Score of a predecessor row at column j; a null row is the virtual row 0.
__device__ __forceinline__ int pred_at(const int* prow, int j, int gap) {
  return prow ? prow[j] : j * gap;
}

// Shared memory of the NW block past its static part: per-row metadata,
// predecessor distances, the read.
inline size_t nw_smem(int N, int E, int Lr) {
  return size_t(N) * 4 + size_t(N) * E + size_t(Lr);
}

__global__ void __launch_bounds__(NW_NT)
lk_nw_kernel(State st, const uint8_t* __restrict__ read, int Lr, const int* __restrict__ rl_in,
             const bool* __restrict__ act, uint8_t* __restrict__ codes, int Lp,
             int* __restrict__ best_out, int* __restrict__ ring_g, int D, int gap,
             int mismatch, int match) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_wtot[NW_NWARP];
  __shared__ int s_first;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (!act[b] || st.error[b] != 0) {
    if (tid == 0) best_out[b] = 0;
    return;
  }
  const Win w(st, b);
  const int N = w.N, E = w.E, HORIZ = 2 * E, BIGP = 3 * E + 1, R = D + 1;
  const int nc = st.node_count[b], rl = rl_in[b];
  int* ring = ring_g + size_t(b) * R * Lp;
  unsigned char* p = smem;
  int* s_meta = (int*)p;  // base | sink << 8 | predecessors << 9
  p += size_t(N) * 4;
  uint8_t* s_dist = p;    // distance of each predecessor row, edge order
  p += size_t(N) * E;
  uint8_t* s_read = p;

  if (tid == 0) s_first = INT_MAX;
  for (int j = tid; j < rl; j += NW_NT) s_read[j] = read[size_t(b) * Lr + j];
  __syncthreads();
  // per-row metadata; the first row (in order) with an in-count over E (6)
  // or a predecessor outside the ring (5) decides the error
  for (int r = tid; r < nc; r += NW_NT) {
    const int nid = clampi(w.sorted[r], 0, N - 1);
    const int pc = w.in_count[nid], np = min(pc, E);
    int code = pc > E ? 6 : 0;
    for (int e = 0; e < np; ++e) {
      const int d = r - w.pos_of[clampi(w.in_edges[size_t(nid) * E + e], 0, N - 1)];
      if (d < 1 || d > D) {
        if (!code) code = 5;
      } else {
        s_dist[size_t(r) * E + e] = uint8_t(d);
      }
    }
    s_meta[r] = (w.nodes[nid] & 0xff) | ((w.out_count[nid] == 0) << 8) | (np << 9);
    if (code) atomicMin(&s_first, (r << 3) | code);
  }
  __syncthreads();
  if (s_first != INT_MAX) {
    if (tid == 0) {
      st.error[b] = s_first & 7;
      best_out[b] = 0;
    }
    return;
  }

  int best = INT_MIN, best_i = 0;  // kept by the thread owning column rl
  for (int r = 0; r < nc; ++r) {
    const int meta = s_meta[r];
    const int nb = meta & 0xff, sink = (meta >> 8) & 1, np = meta >> 9;
    const int npp = max(np, 1);  // a source row's predecessor is row 0
    const uint8_t* rd = s_dist + size_t(r) * E;
#define PROW(e) (np ? ring + size_t((r + 1 - rd[e]) % R) * Lp : nullptr)
    int* row_out = ring + size_t((r + 1) % R) * Lp;
    uint8_t* code_out = codes + (size_t(b) * N + r) * Lp;
    int carry = NEG_ID;  // max of v[j] - j*gap over earlier tiles
    for (int t0 = 0; t0 <= rl; t0 += NW_TILE) {
      const int j0 = t0 + tid * NW_CPT;
      int v[NW_CPT];
#pragma unroll
      for (int c = 0; c < NW_CPT; ++c) v[c] = NEG_ID;
      for (int e = 0; e < npp; ++e) {
        const int* prow = PROW(e);
        int left = (j0 >= 1 && j0 - 1 <= rl) ? pred_at(prow, j0 - 1, gap) : 0;
#pragma unroll
        for (int c = 0; c < NW_CPT; ++c) {
          const int j = j0 + c;
          if (j <= rl) {
            const int up = pred_at(prow, j, gap);
            int cand = up + gap;
            if (j >= 1) cand = max(cand, left + (s_read[j - 1] == nb ? match : mismatch));
            v[c] = max(v[c], cand);
            left = up;
          }
        }
      }
      // horizontal closure: row[j] = max_{k<=j}(v[k] - k*gap) + j*gap
      int pm[NW_CPT], run = NEG_ID;
#pragma unroll
      for (int c = 0; c < NW_CPT; ++c) {
        const int j = j0 + c;
        if (j <= rl) run = max(run, v[c] - j * gap);
        pm[c] = run;
      }
      const int incl = warp_incl_max(run);
      int excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = NEG_ID;
      if (lane == 31) s_wtot[warp] = incl;
      __syncthreads();
      int pre = max(carry, excl), tile_max = carry;
      for (int k = 0; k < NW_NWARP; ++k) {
        if (k < warp) pre = max(pre, s_wtot[k]);
        tile_max = max(tile_max, s_wtot[k]);
      }
      // priority codes against the closed row: diagonal by edge order,
      // vertical by edge order, horizontal; column 0 vertical only
      int prev = 0;  // row[j0 - 1]
      if (j0 >= 1 && j0 <= rl) prev = pre + (j0 - 1) * gap;
#pragma unroll
      for (int c = 0; c < NW_CPT; ++c) {
        const int j = j0 + c;
        if (j > rl) break;
        const int rv = max(pre, pm[c]) + j * gap;
        int code = -1;
        if (j == 0) {
          for (int e = 0; e < npp && code < 0; ++e)
            if (pred_at(PROW(e), 0, gap) + gap == rv) code = E + e;
          if (code < 0) code = BIGP;
        } else {
          const int sub = s_read[j - 1] == nb ? match : mismatch;
          for (int e = 0; e < npp && code < 0; ++e)
            if (pred_at(PROW(e), j - 1, gap) + sub == rv) code = e;
          for (int e = 0; e < npp && code < 0; ++e)
            if (pred_at(PROW(e), j, gap) + gap == rv) code = E + e;
          if (code < 0) code = (rv == prev + gap) ? HORIZ : BIGP;
        }
        row_out[j] = rv;
        code_out[j] = uint8_t(code);
        if (j == rl && sink && rv > best) {
          best = rv;
          best_i = r + 1;
        }
        prev = rv;
      }
      carry = tile_max;
      __syncthreads();  // row visible to the next row; s_wtot free again
    }
#undef PROW
  }
  if (tid == (rl % NW_TILE) / NW_CPT) best_out[b] = best_i;
}

// ---------------------------------------------------------------------------
// Traceback, add, topsort, consensus (rows 2-5): one thread per window
// ---------------------------------------------------------------------------

constexpr int WIN_NT = 64;

// Walk the codes back from (best_i, read_len) to (0, 0); ag/ar (prefilled
// with -1 by the wrapper) get the moves in backward order.
__global__ void __launch_bounds__(WIN_NT)
lk_tb_kernel(State st, int B, const uint8_t* __restrict__ codes, int Lp,
             const int* __restrict__ best_i, const int* __restrict__ rl,
             const bool* __restrict__ act, int* __restrict__ ag, int* __restrict__ ar,
             int* __restrict__ klen, int K) {
  const int b = blockIdx.x * WIN_NT + threadIdx.x;
  if (b >= B) return;
  if (!act[b] || st.error[b] != 0) {
    klen[b] = 0;
    return;
  }
  const Win w(st, b);
  const int N = w.N, E = w.E, HORIZ = 2 * E;
  const uint8_t* wc = codes + size_t(b) * N * Lp;
  int* wag = ag + size_t(b) * K;
  int* war = ar + size_t(b) * K;
  int i = best_i[b], j = rl[b], k = 0;
  for (int steps = 0; (i != 0 || j != 0) && steps < K + 2; ++steps) {
    const int code =
        i == 0 ? HORIZ : wc[size_t(clampi(i - 1, 0, N - 1)) * Lp + clampi(j, 0, Lp - 1)];
    int pi = i, pj = j - 1, nid = -1;
    if (code != HORIZ) {
      nid = clampi(w.sorted[clampi(i - 1, 0, N - 1)], 0, N - 1);
      const int pred = clampi(w.in_edges[size_t(nid) * E + code % E], 0, N - 1);
      pi = w.in_count[nid] == 0 ? 0 : w.pos_of[pred] + 1;
      pj = code < E ? j - 1 : j;
    }
    if (k < K) {
      wag[k] = pi == i ? -1 : nid;
      war[k] = pj == j ? -1 : j - 1;
    }
    ++k;
    i = pi;
    j = pj;
  }
  if (i != 0 || j != 0) {
    st.error[b] = 3;
    klen[b] = 0;
  } else {
    klen[b] = k;
  }
}

// The sequential alignment-to-graph walk at the state's caps (E in- and
// out-edges, A aligned nodes): 1 when a new node makes the count reach N;
// 6 when a clique list or an edge list would overflow (that list is left
// alone). The walk stops after the step that sets the first error.
__global__ void __launch_bounds__(WIN_NT)
lk_add_kernel(State st, int B, const int* __restrict__ ag, const int* __restrict__ ar,
              const int* __restrict__ klen, int K, const uint8_t* __restrict__ read,
              const int* __restrict__ wts, int Lr, const bool* __restrict__ act) {
  const int b = blockIdx.x * WIN_NT + threadIdx.x;
  if (b >= B || !act[b] || st.error[b] != 0) return;
  const Win w(st, b);
  const int N = w.N, E = w.E, A = w.A;
  const int* wag = ag + size_t(b) * K;
  const int* war = ar + size_t(b) * K;
  const uint8_t* wread = read + size_t(b) * Lr;
  const int* wwt = wts ? wts + size_t(b) * Lr : nullptr;
  const int kl = klen[b];
  int nc = st.node_count[b], err = 0, head = -1, prev_w = 0;
  for (int t = 0; t < kl && err == 0; ++t) {
    const int pos = clampi(kl - 1 - t, 0, K - 1);
    if (war[pos] == -1) continue;
    const int rp = clampi(war[pos], 0, Lr - 1);
    const int gid = wag[pos];
    const int base = wread[rp];
    const int wt = wwt ? wwt[rp] : 1;
    const bool has_gid = gid != -1;
    const int gid_c = clampi(gid, 0, N - 1);
    const int na = has_gid ? w.al_count[gid_c] : 0;
    const int* gl = w.al + size_t(gid_c) * A;
    const bool reuse_graph = has_gid && w.nodes[gid_c] == base;
    bool reuse_al = false;
    int first_al = 0;
    if (has_gid && !reuse_graph) {
      for (int a = 0; a < min(na, A); ++a) {
        if (w.nodes[clampi(gl[a], 0, N - 1)] == base) {
          first_al = gl[a];
          reuse_al = true;
          break;
        }
      }
    }
    const bool new_node = !reuse_graph && !reuse_al;
    const int cur = clampi(reuse_graph ? gid_c : (reuse_al ? first_al : nc), 0, N - 1);
    if (new_node) {
      if (++nc >= N) err = 1;
      w.nodes[cur] = base;
      w.out_count[cur] = 0;
      w.in_count[cur] = 0;
      w.al_count[cur] = 0;
      w.cov[cur] = 0;
    }
    if (new_node && has_gid) {  // cur joins gid's aligned clique
      if (na + 1 > A - 1) {
        if (!err) err = 6;
      } else {
        int* cl = w.al + size_t(cur) * A;
        for (int a = 0; a < na; ++a) {
          const int aid = clampi(gl[a], 0, N - 1);
          const int acnt = w.al_count[aid];
          w.al[size_t(aid) * A + min(acnt, A - 1)] = cur;
          w.al_count[aid] = acnt + 1;
          cl[a] = aid;
        }
        w.al[size_t(gid_c) * A + na] = cur;
        cl[na] = gid_c;
        w.al_count[gid_c] = na + 1;
        w.al_count[cur] = na + 1;
      }
    }
    if (head != -1) {  // edge head -> cur: reweigh every slot holding it, else append
      int* il = w.in_edges + size_t(cur) * E;
      int* iw = w.in_w + size_t(cur) * E;
      const int ic = w.in_count[cur], dw = prev_w + wt;
      bool exists = false;
      for (int e = 0; e < min(ic, E); ++e) {
        if (il[e] == head) {
          iw[e] += dw;
          exists = true;
        }
      }
      if (!exists) {
        const int oc = w.out_count[head];
        if (ic >= E || oc >= E) {
          if (!err) err = 6;
        } else {
          il[ic] = head;
          iw[ic] = dw;
          w.out_edges[size_t(head) * E + oc] = cur;
          w.in_count[cur] = ic + 1;
          w.out_count[head] = oc + 1;
        }
      }
    }
    w.cov[cur] += 1;
    head = cur;
    prev_w = wt;
  }
  st.node_count[b] = nc;
  st.error[b] = err;
}

// Kahn's sort: seeds by ascending id, FIFO expansion in out-edge order.
// Rewrites positions 0..node_count-1 of sorted and pos_of (-1 where a node
// is not placed); 100 when not every node is placed.
__global__ void __launch_bounds__(WIN_NT)
lk_topsort_kernel(State st, int B, const bool* __restrict__ act, int* __restrict__ local_g) {
  const int b = blockIdx.x * WIN_NT + threadIdx.x;
  if (b >= B || !act[b] || st.error[b] != 0) return;
  const Win w(st, b);
  const int N = w.N, E = w.E, nc = st.node_count[b];
  int* local = local_g + size_t(b) * N;
  int tail = 0;
  for (int n = 0; n < nc; ++n) {
    const int ic = w.in_count[n];
    local[n] = ic;
    w.pos_of[n] = -1;
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
      const int out = clampi(ol[e], 0, N - 1);
      if (out < nc && --local[out] == 0) {
        w.sorted[tail] = out;
        w.pos_of[out] = tail++;
      }
    }
  }
  for (int q = tail; q < nc; ++q) w.sorted[q] = -1;
  if (tail != nc) st.error[b] = 100;
}

// One row of the heaviest-edge pass with the reference's tie-breaks.
__device__ void consensus_row(const Win& w, const int* cscore, int nid, bool skip_cleared,
                              int* s_out, int* p_out) {
  const int E = w.E;
  const int pc = w.in_count[nid];
  const int* il = w.in_edges + size_t(nid) * E;
  const int* iw = w.in_w + size_t(nid) * E;
  int s = skip_cleared ? -1 : cscore[nid];
  int p = -1;
  for (int e = 0; e < pc; ++e) {
    const int begin = il[e];
    const int sb = cscore[begin];
    if (skip_cleared && sb == -1) continue;
    const int ew = iw[e];
    if (s < ew || (s == ew && p != -1 && cscore[p] <= sb)) {
      s = ew;
      p = begin;
    }
  }
  if (p != -1) s += cscore[p];
  *s_out = s;
  *p_out = p;
}

// Heaviest path, branch completion and backward emission
// (cudapoa_generate_consensus.cuh); cons and cov are zeroed by the wrapper.
__global__ void __launch_bounds__(WIN_NT)
lk_consensus_kernel(State st, int B, const bool* __restrict__ act, uint8_t* __restrict__ cons,
                    int* __restrict__ cov_out, int* __restrict__ len_out,
                    int* __restrict__ err_out, int* __restrict__ scratch) {
  const int b = blockIdx.x * WIN_NT + threadIdx.x;
  if (b >= B) return;
  if (!act[b] || st.error[b] != 0) {
    len_out[b] = 0;
    err_out[b] = st.error[b];
    return;
  }
  const Win w(st, b);
  const int N = w.N, E = w.E, A = w.A, nc = st.node_count[b];
  int* cscore = scratch + size_t(b) * 2 * N;
  int* cpred = cscore + N;
  for (int n = 0; n < nc; ++n) {
    cscore[n] = -1;
    cpred[n] = -1;
  }
  int max_score = -1, max_id = 0;
  for (int gp = 0; gp < nc; ++gp) {
    const int nid = w.sorted[gp];
    int s, p;
    consensus_row(w, cscore, nid, false, &s, &p);
    cscore[nid] = s;
    cpred[nid] = p;
    if (max_score <= s) {
      max_score = s;
      max_id = nid;
    }
  }
  int loops = 0;
  while (w.out_count[max_id] != 0 && loops < nc) {
    const int pos = w.pos_of[max_id];
    const int oc = w.out_count[max_id];
    for (int oe = 0; oe < oc; ++oe) {
      const int out = w.out_edges[size_t(max_id) * E + oe];
      const int ic = w.in_count[out];
      for (int ie = 0; ie < ic; ++ie) {
        const int iid = w.in_edges[size_t(out) * E + ie];
        if (iid != max_id) cscore[iid] = -1;
      }
    }
    int mxs = 0, mxi = 0;
    for (int gp = pos + 1; gp < nc; ++gp) {
      const int nid = w.sorted[gp];
      int s, p;
      consensus_row(w, cscore, nid, true, &s, &p);
      cpred[nid] = p;
      cscore[nid] = s;
      if (mxs <= s) {
        mxs = s;
        mxi = nid;
      }
    }
    max_id = mxi;
    ++loops;
  }
  if (loops >= nc && loops > 0) {
    len_out[b] = 0;
    err_out[b] = 3;
    return;
  }
  uint8_t* wcons = cons + size_t(b) * N;
  int* wcov = cov_out + size_t(b) * N;
  int cur = max_id, k = 0;
  while (true) {
    int c = w.cov[cur];
    const int nal = w.al_count[cur];
    for (int a = 0; a < nal; ++a) c += w.cov[w.al[size_t(cur) * A + a]];
    if (k < N) {
      wcons[k] = uint8_t(w.nodes[cur]);
      wcov[k] = c;
    }
    ++k;
    const int p = cpred[cur];
    if (p == -1) break;
    cur = p;
  }
  len_out[b] = k;
  err_out[b] = 0;
}

inline int win_blocks(int B) { return (B + WIN_NT - 1) / WIN_NT; }

}  // namespace

extern "C" {

// Every launch returns cudaGetLastError() after it. `st` holds the 13
// state pointers in the order of torch_poa.STATE_KEYS. `ring` is (B, D + 1,
// Lp) int32 scratch.
int lk_nw_launch(void* const* st, int B, int N, int E, int A, const void* read, int Lr,
                 const void* rl, const void* act, void* codes, int Lp, void* best_i, void* ring,
                 int D, int gap, int mismatch, int match, void* stream) {
  const size_t smem = nw_smem(N, E, Lr);
  cudaError_t e = cudaFuncSetAttribute(lk_nw_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  lk_nw_kernel<<<B, NW_NT, smem, (cudaStream_t)stream>>>(
      make_state(st, N, E, A), (const uint8_t*)read, Lr, (const int*)rl, (const bool*)act,
      (uint8_t*)codes, Lp, (int*)best_i, (int*)ring, D, gap, mismatch, match);
  return int(cudaGetLastError());
}

int lk_tb_launch(void* const* st, int B, int N, int E, int A, const void* codes, int Lp,
                 const void* best_i, const void* rl, const void* act, void* ag, void* ar,
                 void* klen, int K, void* stream) {
  lk_tb_kernel<<<win_blocks(B), WIN_NT, 0, (cudaStream_t)stream>>>(
      make_state(st, N, E, A), B, (const uint8_t*)codes, Lp, (const int*)best_i,
      (const int*)rl, (const bool*)act, (int*)ag, (int*)ar, (int*)klen, K);
  return int(cudaGetLastError());
}

int lk_add_launch(void* const* st, int B, int N, int E, int A, const void* ag, const void* ar,
                  const void* klen, int K, const void* read, const void* wts, int Lr,
                  const void* act, void* stream) {
  lk_add_kernel<<<win_blocks(B), WIN_NT, 0, (cudaStream_t)stream>>>(
      make_state(st, N, E, A), B, (const int*)ag, (const int*)ar, (const int*)klen, K,
      (const uint8_t*)read, (const int*)wts, Lr, (const bool*)act);
  return int(cudaGetLastError());
}

int lk_topsort_launch(void* const* st, int B, int N, int E, int A, const void* act, void* local,
                      void* stream) {
  lk_topsort_kernel<<<win_blocks(B), WIN_NT, 0, (cudaStream_t)stream>>>(
      make_state(st, N, E, A), B, (const bool*)act, (int*)local);
  return int(cudaGetLastError());
}

int lk_consensus_launch(void* const* st, int B, int N, int E, int A, const void* act,
                        void* cons, void* cov, void* len, void* err, void* scratch,
                        void* stream) {
  lk_consensus_kernel<<<win_blocks(B), WIN_NT, 0, (cudaStream_t)stream>>>(
      make_state(st, N, E, A), B, (const bool*)act, (uint8_t*)cons, (int*)cov, (int*)len,
      (int*)err, (int*)scratch);
  return int(cudaGetLastError());
}

}  // extern "C"
