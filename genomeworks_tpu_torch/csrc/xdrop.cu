// Ungapped X-drop seed extension for Hopper (sm_90a): a warp per seed.
//
// Replaces no TPU kernel: the JAX package computes this with XLA ops
// (genomeworks_tpu/extender/xdrop.py, _make_chunk_body / _extend_direction,
// a lax.while_loop over 128-position chunks of every seed in lockstep, and
// _count_matches). This is the design of the reference instead
// (cudaextender ungapped_xdrop_kernels.cu, find_high_scoring_segment_pairs:
// one warp per seed), with the semantics of the port's plain versions
// extender/xdrop_plain.py (extend_direction_plain, count_matches_plain):
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
//     width, so 32 here against the JAX package's 128 gives the same;
//   - int32 arithmetic throughout (wrapping, as the reference's).
//
// What bounds it on this card, and what the design does about it:
// - A seed reads its diagonal's bases once, two bytes a position, and does
//   about 16 int32 operations a position: the work is small and the
//   extensions are short (a random pair drops in one tile, a homologous one
//   runs to the next indel), so the kernel is bound by the latency of a
//   tile's dependent chain (load, two 5-step scans, a ballot) over many
//   warps in flight. Each lane loads one target and one query byte of a
//   32-position tile (one 32-byte sector each); the prefix sum and the
//   running maximum are shuffle scans; the drop test is one ballot.
// - The 64-entry score matrix sits in shared memory, loaded once a block.
// - Both directions of a seed run in one warp, and a whole batch is one
//   launch; the match counts of the seeds the entropy needs are a second
//   kernel, a warp a seed, four ballots and popcounts a tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // warps (seeds) a block

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int clamp_index(int p, int L) {
  return p < 0 ? 0 : (p >= L ? L - 1 : p);
}

// One direction of one seed, run by the whole warp. Returns the maximum
// and its position in *best / *best_pos (every lane gets them).
__device__ void extend_one(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                           int Lq, int Lt, int qpos, int tpos, const int* sub, int xdrop,
                           bool left, int* best, int* best_pos) {
  const int lane = threadIdx.x & 31;
  int score = 0;             // cumulative score before this tile
  int mx = 0;                // carried running maximum
  int mpos = left ? 0 : -1;  // and its position
  for (int base = left ? 1 : 0;; base += 32) {
    const int o = base + lane;
    const int tp = left ? tpos - o : tpos + o;
    const int qp = left ? qpos - o : qpos + o;
    const bool inb = left ? (tp >= 0 && qp >= 0) : (tp < Lt && qp < Lq);
    const int tc = t[clamp_index(tp, Lt)];
    const int qc = q[clamp_index(qp, Lq)];
    int cum = inb ? sub[tc * 8 + qc] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {  // inclusive prefix sum
      const int v = __shfl_up_sync(FULL, cum, d);
      if (lane >= d) cum = wrap_add(cum, v);
    }
    cum = wrap_add(cum, score);
    int mv = cum, mp = o;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {  // running max, the earlier on ties
      const int v = __shfl_up_sync(FULL, mv, d);
      const int p = __shfl_up_sync(FULL, mp, d);
      if (lane >= d && v >= mv) {
        mv = v;
        mp = p;
      }
    }
    const bool better = mv > mx;  // the carried maximum wins ties
    const int rm = better ? mv : mx;
    const int rp = better ? mp : mpos;
    const bool drop = (int)((unsigned)rm - (unsigned)cum) > xdrop;
    const unsigned dropped = __ballot_sync(FULL, drop);
    const bool edge = (__ballot_sync(FULL, inb) >> 31) == 0u;
    if (dropped) {
      const int first = __ffs(dropped) - 1;  // the first lane that drops
      const int src = first > 0 ? first - 1 : 0;
      const int v = __shfl_sync(FULL, rm, src);
      const int p = __shfl_sync(FULL, rp, src);
      *best = first > 0 ? v : mx;
      *best_pos = first > 0 ? p : mpos;
      return;
    }
    const int rm31 = __shfl_sync(FULL, rm, 31);
    const int rp31 = __shfl_sync(FULL, rp, 31);
    if (edge) {
      *best = rm31;
      *best_pos = rp31;
      return;
    }
    score = __shfl_sync(FULL, cum, 31);
    mx = rm31;
    mpos = rp31;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
xdrop_extend_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                    const int* __restrict__ qpos, const int* __restrict__ tpos,
                    const int* __restrict__ sub_g, int* __restrict__ out, int S, int Lq,
                    int Lt, int xdrop) {
  __shared__ int sub[64];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) sub[i] = sub_g[i];
  __syncthreads();
  const long long seed = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (seed >= S) return;  // a whole warp leaves together
  const int qs = qpos[seed], ts = tpos[seed];
  int r_best, r_pos, l_best, l_pos;
  extend_one(q, t, Lq, Lt, qs, ts, sub, xdrop, false, &r_best, &r_pos);
  extend_one(q, t, Lq, Lt, qs, ts, sub, xdrop, true, &l_best, &l_pos);
  if ((threadIdx.x & 31) == 0) {
    int4 r;
    r.x = r_best;
    r.y = r_pos;
    r.z = l_best;
    r.w = l_pos;
    reinterpret_cast<int4*>(out)[seed] = r;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
xdrop_count_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                   const int* __restrict__ qpos, const int* __restrict__ tpos,
                   const int* __restrict__ left, const int* __restrict__ right,
                   int* __restrict__ counts, int n, int Lq, int Lt) {
  const long long k = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (k >= n) return;
  const int lane = threadIdx.x & 31;
  const long long l = left[k];
  const long long span = l + right[k];
  const long long t0 = tpos[k] - l, q0 = qpos[k] - l;
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  for (long long base = 0; base <= span; base += 32) {
    const long long o = base + lane;
    const long long tp = t0 + o, qp = q0 + o;
    const bool inb = o <= span && tp >= 0 && qp >= 0 && tp < Lt && qp < Lq;
    int tc = 4, qc = 5;
    if (inb) {
      tc = t[tp];
      qc = q[qp];
    }
    const bool m = inb && tc == qc && tc < 4;
    c0 += __popc(__ballot_sync(FULL, m && tc == 0));
    c1 += __popc(__ballot_sync(FULL, m && tc == 1));
    c2 += __popc(__ballot_sync(FULL, m && tc == 2));
    c3 += __popc(__ballot_sync(FULL, m && tc == 3));
  }
  if (lane == 0) {
    int4 c;
    c.x = c0;
    c.y = c1;
    c.z = c2;
    c.w = c3;
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

// A/C/G/T match counts of n final segments: counts int32 (n, 4).
int xdrop_count_launch(const void* q, const void* t, const void* qpos, const void* tpos,
                       const void* left, const void* right, void* counts, int n, int Lq,
                       int Lt, void* stream) {
  if (n > 0) {
    const long long blocks = ((long long)n + WARPS - 1) / WARPS;
    xdrop_count_kernel<<<(unsigned)blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)q, (const uint8_t*)t, (const int*)qpos, (const int*)tpos,
        (const int*)left, (const int*)right, (int*)counts, n, Lq, Lt);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
