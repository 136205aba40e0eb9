// Bit-parallel banded Myers forward pass (Hyyrö bit-vectors) with 2-bit
// traceback codes, for Hopper (sm_90a). A row warp and 1-4 flush warps per
// alignment.
//
// Replaces the Pallas TPU kernel
// genomeworks_tpu/ops/myers_banded_pallas.py:myers_banded_forward_pallas
// (kernel body _kernel, plus its XLA repack _repack_rowmajor), with the
// semantics of the port's plain version
// aligner/myers_banded_model.py:myers_banded_plain, which is bit for bit
// genomeworks_tpu/aligner/myers_banded_model.py:myers_banded_codes(
// windowed=True):
//   - pattern = target, text = query: a serial loop over query rows i; bit
//     xs of the word array is target column j = xs + dlo;
//   - Eq of the row's base against the target (j in [1, tlen], bases
//     compared on their low 2 bits); the multi-word add Eq & PV + PV with
//     carries across words; Ph/Mh shifted in with a carry-in of 1 and 0;
//   - after each row the words outside the next row's window
//     [wlo, wlo + W/32 + 3), wlo = max(0, (i + 1) / 32 - 1), hold the
//     off-band steady states (PV = 1, MV = 0 above; PV = 0, MV = 1 below);
//   - codes PV ? 2 : Ph ? 3 : (Eq ? 0 : 1) for band positions k = xs - i in
//     [0, W), written straight into the row-major (B, M16, W) int32 plane,
//     16 rows per word; rows past qlen are 0.
//
// The window and its state. Words below the window produce Ph = 1, Mh = 0
// and no carry, so the window computes alone, with those shift-ins. The
// model computes the words above it too and keeps the first of them when
// the window moves up a word, so the warp carries NWIN = W/32 + 4 words:
// the window plus one word that starts every row in the steady state above.
// The slack words set the band's bits through the carries and the shifts,
// so the window is not trimmed to the band.
//
// What bounds it on this card, and what the design does about it:
// - The work is NWIN words of about 30 int32 ops per row and the output is
//   4 bytes per 16 cells: far from both the memory and the ALU bound. A row
//   is a dependent chain (the carry across words), and at the aligner's
//   sizes there is about one alignment a scheduler, so the kernel is bound
//   by the latency of a row times qlen. A warp issues in order: whatever
//   the row warp waits on beside the chain delays the next row. So the row
//   warp does the chain and little else, and other warps make the planes.
// - The row warp. Lane l holds window words l * NPL + u (u < NPL) and
//   their state PV, MV and Eq in registers across rows. The carry across
//   lanes is two ballots (generate and propagate of the lane's words as one
//   block, one add), as in the reference's warp-cooperative design
//   (cudaaligner myers_gpu.cu:78-132); inside a lane the carries of its
//   words come from one add of their generate and propagate masks. Ph and
//   Mh of a lane's last word, made for both carries while the ballots are
//   in flight, send their top bits up a lane by two more ballots. Every 32
//   rows the window moves up a word: the state moves down one word (a
//   shuffle for the lane's last word), and the word above restarts steady.
//   Eq is a shared-memory load a word from four per-base masks of the
//   target (Peq), issued two rows ahead (up to 9 words a lane; after the
//   word's last use where registers are short). The query bases come 32
//   rows at a time, one coalesced load a block issued 32 rows ahead, kept
//   as two ballot bit planes from which a row takes its base by shifts.
//   The row warp reaches shared memory by 32-bit addresses made once
//   (`ld.shared`, predicated `st.shared`), and each whole 8-row group is
//   unrolled (up to 9 words a lane), so the window move's branch is in one
//   row of eight. The row's two code bits of window words 0 to W/32 + 1 go
//   to a shared-memory stash of 8 rows as they are (two stores a word); a
//   named barrier with the flush warps every 8 rows hands a stash over
//   (two of them, written and read by turns).
// - The flush warps take the stash of the 8 rows before while the row warp
//   runs the next 8. Lane L takes code bit L & 1 of row (L >> 1) & 7 of
//   band word 2p + (L >> 4), a funnel shift of two stashed window words; a
//   32 x 32 bit transposition by a shuffle-xor butterfly (its 16- and 8-bit
//   stages byte permutes) leaves lane j with column 32 x + j's 8 rows of
//   both words, stored as 16-bit halves of the plane words by 32
//   neighbouring lanes. A flush warp transposes KP = 4 pairs at once (their
//   butterflies interleaved), the pairs left over one at a time, and there
//   is a flush warp for each KP * NPL pairs, at most 4, so a group's
//   transpositions take no longer than its rows: no row waits for them.
// - Up to four alignments share a block while their shared memory fits in
//   48 KB, each with its own named barrier; the block's row warps come
//   first, one a scheduler.
//
// Debug build (-DMYERS_STATS=1, off in normal builds): lane 0 of each row
// warp adds its clock64() cycles over the rows and those spent at the
// barriers, and lane 0 of its first flush warp the cycles of its work
// between barriers, with the rows and 8-row groups, to g_myers_stats (the
// MS_* counters), read with myers_banded_stats. The clock reads after a
// barrier wait for a value loaded after it (clock_after).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (genomeworks_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int RPG = 8;  // rows per stash group: one 16-bit half of a plane word
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_ALIGNMENTS = 4;  // a block's, each with named barrier 1 + its slot

#ifdef MYERS_STATS
enum { MS_PAIRS, MS_ROWS, MS_CYCLES, MS_WAIT_CYCLES, MS_FLUSH_CYCLES, MS_GROUPS, MS_COUNT };
__device__ unsigned long long g_myers_stats[MS_COUNT];

// clock64() read once v is known: the read is predicated on v, so it is
// not issued before v arrives (a plain read may be scheduled before the
// barrier whose wait it should end)
__device__ __forceinline__ long long clock_after(unsigned v) {
  long long t = 0;
  asm volatile("{ .reg .pred p; setp.ne.u32 p, %1, 0x7fffffff; @p mov.u64 %0, %%clock64; }"
               : "+l"(t)
               : "r"(v));
  return t != 0 ? t : clock64();
}
#endif

struct Geometry {
  int WB, NWIN, NW, XS, S;  // band words, window + the word above, array words, bits, stash row
  __host__ __device__ Geometry(int M, int W) {
    WB = W / 32;
    NWIN = WB + 4;
    XS = M + W + 64;
    NW = (XS + 31) / 32;
    S = (WB + 2) | 1;  // window words 0 .. WB + 1, odd so a group's 16 rows take 16 banks
  }
  // 32-bit words of shared memory one alignment uses: Peq, four per-base
  // masks of NW + 1 words (the last one 0, read as the word above the
  // array), and the stash, two groups of 8 rows x 2 code bits x S words
  __host__ __device__ int words() const { return 4 * (NW + 1) + 2 * RPG * 2 * S; }
};

constexpr int KP = 4;  // pairs of band words a flush warp transposes at once

// Flush warps an alignment: a chunk of KP pairs of band words takes a
// flush warp about as long as the row warp takes for 8 rows of one word a
// lane, so one flush warp for each KP * npl pairs, at most 4.
__host__ __device__ inline int flush_warps(int W, int npl) {
  const int NP = (W / 32 + 1) / 2;
  return min(4, max(1, (NP + KP * npl - 1) / (KP * npl)));
}

__device__ __forceinline__ int floor_div2(int e) { return e >= 0 ? e / 2 : -((1 - e) / 2); }

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" : : "r"(id), "r"(n) : "memory");
}

// Shared memory by 32-bit shared-window addresses made once, so the row
// loop recomputes no window base; the store is predicated, not branched.
__device__ __forceinline__ unsigned lds(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts_if(unsigned a, unsigned v, bool p) {
  asm volatile("{ .reg .pred q; setp.ne.u32 q, %2, 0; @q st.shared.u32 [%0], %1; }"
               : : "r"(a), "r"(v), "r"(unsigned(p)) : "memory");
}

// K 32 x 32 bit transpositions at once (lane L's bit j of v[k] goes to
// lane j's bit L): five shuffle-xor stages, each swapping the off-diagonal
// blocks of its size; the 16- and 8-bit stages are byte permutes.
template <int K>
__device__ __forceinline__ void transpose32(unsigned (&v)[K], int lane) {
  const unsigned sel16 = (lane & 16) ? 0x3276u : 0x5410u, sel8 = (lane & 8) ? 0x3715u : 0x6240u;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = __byte_perm(v[k], __shfl_xor_sync(FULL, v[k], 16), sel16);
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = __byte_perm(v[k], __shfl_xor_sync(FULL, v[k], 8), sel8);
#pragma unroll
  for (int s = 4; s >= 1; s >>= 1) {
    const unsigned m = s == 4 ? 0x0f0f0f0fu : s == 2 ? 0x33333333u : 0x55555555u;
    const bool up = lane & s;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const unsigned o = __shfl_xor_sync(FULL, v[k], s);
      v[k] = up ? (v[k] & ~m) | ((o >> s) & m) : (v[k] & m) | ((o << s) & ~m);
    }
  }
}

template <int NPL>
__global__ void myers_banded_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                                    const int* __restrict__ qlen, const int* __restrict__ tlen,
                                    int* __restrict__ codes, uint8_t* __restrict__ fits, int B,
                                    int M, int N, int W, int F) {
  // the lane's words' generate / propagate bits, and the carry out of them
  using Mask = typename std::conditional<(NPL < 32), unsigned, unsigned long long>::type;
  // Eq two rows ahead in registers of their own where the registers allow
  // (its load then has a row to land), else loaded after the row's last use
  constexpr bool EQ_AHEAD = NPL <= 9;
  constexpr int NEQ = EQ_AHEAD ? NPL : 1;
  extern __shared__ unsigned smem_u[];
  const Geometry g(M, W);
  const int lane = threadIdx.x & 31;
  const unsigned lanebit = 1u << lane;
  // warps an alignment: a row warp and F flush warps. The block's A row
  // warps come first, one a scheduler (warp w is on scheduler w % 4), then
  // its flush warps: warp w has alignment slot w % A and role w / A
  const int per = 1 + F, A = blockDim.x / (32 * per);
  const int slot = (threadIdx.x >> 5) % A, role = (threadIdx.x >> 5) / A;
  const int b = blockIdx.x * A + slot;
  if (b >= B) return;  // an alignment's warps leave together
  const int bar = 1 + slot, nbar = 32 * per;
  const int NP1 = g.NW + 1, S = g.S;
  const int peq0 = slot * g.words();  // Peq [4][NW + 1], then the stash [2][8][2][S]
  const int st0 = peq0 + 4 * NP1;

  const int ql = qlen[b], tl = tlen[b];
  const int M16 = (M + 15) / 16;
  int* out = codes + (size_t)b * M16 * W;
  const int G = (ql + RPG - 1) / RPG;  // 8-row groups

  if (role > 0) {
    // a flush warp: the plane half-words of each group, after the row warp
    // has stashed it
    const int f = role - 1;
    const int NP = (g.WB + 1) >> 1;
    const int rr = (lane >> 1) & 7, cb = lane & 1;
#ifdef MYERS_STATS
    long long busy = 0;
#endif
    for (int h = 0; h < G; ++h) {
      named_sync(bar, nbar);
#ifdef MYERS_STATS
      const long long tb0 = clock_after(smem_u[st0 + (h & 1) * RPG * 2 * S + lane]);
      unsigned last = 0;
#endif
      const int r = RPG * h + rr + 1;  // the lane's row
      const bool live = r <= ql;
      const int rel = r - 32 * max(0, r / 32 - 1);  // the band's first bit in its row's window
      const int w0 = rel >> 5, sh = r & 31;
      const int src = st0 + (h & 1) * RPG * 2 * S + (rr * 2 + cb) * S + w0;
      const bool whole = h == G - 1 && (h & 1) == 0;  // the last group, the word's rows 1-8
      const int half = h & 1;
      int* row = out + (size_t)(h >> 1) * W;
      // pairs p0 .. p0 + K - 1: their band words, transposed, to the plane
      auto chunk = [&](auto k_pairs, int p0) {
        constexpr int K = decltype(k_pairs)::value;
        unsigned v[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int x = 2 * (p0 + k) + (lane >> 4);
          v[k] = live && x < g.WB ? __funnelshift_r(smem_u[src + x], smem_u[src + x + 1], sh)
                                  : 0u;
        }
        transpose32<K>(v, lane);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int p = p0 + k;
          int* o = row + 64 * p + lane;
          const bool hi = 2 * p + 1 < g.WB;
          if (whole) {
            o[0] = int(v[k] & 0xffffu);
            if (hi) o[32] = int(v[k] >> 16);
          } else {
            reinterpret_cast<uint16_t*>(o)[half] = uint16_t(v[k]);
            if (hi) reinterpret_cast<uint16_t*>(o + 32)[half] = uint16_t(v[k] >> 16);
          }
#ifdef MYERS_STATS
          last ^= v[k];
#endif
        }
      };
      // whole chunks of KP pairs by turns among the flush warps, then the
      // pairs left over one at a time, by turns too
      const int whole_chunks = NP / KP;
      for (int c = f; c < whole_chunks; c += F) chunk(std::integral_constant<int, KP>(), KP * c);
      for (int p = KP * whole_chunks + f; p < NP; p += F)
        chunk(std::integral_constant<int, 1>(), p);
#ifdef MYERS_STATS
      busy += clock_after(last) - tb0;
#endif
    }
    // rows past qlen are code 0
    for (size_t o = (size_t)((ql + 15) / 16) * W + 32 * f + lane; o < (size_t)M16 * W;
         o += 32 * F)
      out[o] = 0;
#ifdef MYERS_STATS
    if (f == 0 && lane == 0) {
      atomicAdd(&g_myers_stats[MS_FLUSH_CYCLES], (unsigned long long)busy);
      atomicAdd(&g_myers_stats[MS_GROUPS], (unsigned long long)G);
    }
#endif
    return;
  }

  // the row warp
  const int diff = tl - ql;
  const int ad = diff < 0 ? -diff : diff;
  const int dlo = min(0, diff) - floor_div2(W - 1 - ad);
  if (lane == 0) fits[b] = W >= ad + 1;
  if (ql == 0) return;
  const uint8_t* qb = q + (size_t)b * M;
  const uint8_t* tb = t + (size_t)b * N;

  // Peq: bit z of mask c, word w is target column j = 32 w + z + dlo in
  // [1, tlen] holding base c (xs < XS, as the model's array)
  for (int w = lane; w < NP1; w += 32) {
    unsigned m0 = 0, m1 = 0, m2 = 0, m3 = 0;
    for (int z = 0; z < 32; ++z) {
      const int xs = 32 * w + z;
      const int j = xs + dlo;
      if (xs < g.XS && j >= 1 && j <= tl) {
        const int c = tb[j - 1] & 3;
        const unsigned bit = 1u << z;
        m0 |= c == 0 ? bit : 0u;
        m1 |= c == 1 ? bit : 0u;
        m2 |= c == 2 ? bit : 0u;
        m3 |= c == 3 ? bit : 0u;
      }
    }
    smem_u[peq0 + w] = m0;
    smem_u[peq0 + NP1 + w] = m1;
    smem_u[peq0 + 2 * NP1 + w] = m2;
    smem_u[peq0 + 3 * NP1 + w] = m3;
  }
  // query bases 32 rows at a time, one coalesced load a block issued 32
  // rows ahead (qnext), held as two bit planes of the block's bases (bit k:
  // the base of index 32 blk + k), from which a row takes its base by shifts
  const unsigned qcur = lane < ql ? qb[lane] : 0u;
  unsigned qnext = 32 + lane < ql ? qb[32 + lane] : 0u;
  unsigned qp0 = __ballot_sync(FULL, qcur & 1u), qp1 = __ballot_sync(FULL, qcur & 2u);
  auto base_at = [&](int k) { return int(((qp0 >> k) & 1u) | (((qp1 >> k) << 1) & 2u)); };
  __syncwarp();
  const int c1 = base_at(0);
  int cn = base_at(1);   // the next row's base
  int cn2 = base_at(2);  // the base of the row after it

  // the window's words start as row 0: PV = (j >= 1), MV = 0
  unsigned pv[NPL], mv[NPL], eq[NPL];
#pragma unroll
  for (int u = 0; u < NPL; ++u) {
    const int w = lane * NPL + u;
    const int lo = 1 - dlo - 32 * w;  // the word's first bit with j >= 1
    pv[u] = w >= g.NWIN || lo >= 32 ? 0u : lo <= 0 ? FULL : FULL << lo;
    mv[u] = 0u;
    eq[u] = w < g.NWIN ? smem_u[peq0 + c1 * NP1 + w] : 0u;
  }
  // the row loop reaches shared memory by 32-bit addresses made once: the
  // lane's first Peq word and its first stash word
  const unsigned smem_s = (unsigned)__cvta_generic_to_shared(smem_u);
  const unsigned peq_s = smem_s + 4u * (peq0 + lane * NPL);
  const unsigned st_s = smem_s + 4u * (st0 + lane * NPL);
  unsigned eqn[NEQ];  // row 2's Eq (rows 1 and 2 share the first window)
  if constexpr (EQ_AHEAD) {
#pragma unroll
    for (int u = 0; u < NPL; ++u)
      eqn[u] = lane * NPL + u < g.NWIN ? lds(peq_s + 4u * (cn * NP1 + u)) : 0u;
  }
  // the word above the window: the lane holding it, and that word's slot
  const bool has_above = lane == (g.NWIN - 1) / NPL;
  const int above_u = (g.NWIN - 1) % NPL;

#ifdef MYERS_STATS
  const long long t0 = clock64();
  long long wait = 0;
#endif
  int base = 0;  // absolute word of window word 0
  // row i, at r8 of its 8-row group (a constant where groups are unrolled:
  // the window can move only after r8 = 6, rows 63, 95, ..., and the query
  // block turns over only at r8 = 5)
  auto row = [&](const int i, const int r8) {
    const int nbase = max(0, (i + 1) / 32 - 1);  // the next row's window
    const bool moves = r8 == 6 && nbase != base;
    // Eq two rows ahead, issued first: it lands during the next row
    unsigned eqnn[NEQ];
    if constexpr (EQ_AHEAD) {
      const unsigned a = peq_s + 4u * (cn2 * NP1 + max(0, (i + 2) / 32 - 1));
#pragma unroll
      for (int u = 0; u < NPL; ++u) eqnn[u] = lane * NPL + u < g.NWIN ? lds(a + 4u * u) : 0u;
    }
    // the base three rows ahead
    if (r8 == 5 && ((i + 2) & 31) == 0) {
      qp0 = __ballot_sync(FULL, qnext & 1u);
      qp1 = __ballot_sync(FULL, qnext & 2u);
      qnext = i + 34 + lane < ql ? qb[i + 34 + lane] : 0u;
    }
    const int cn3 = base_at((i + 2) & 31);

    // the add Eq & PV + PV: each word's generate and propagate, the lane's
    // words as one carry block, and the carry into each lane by two ballots
    Mask gmask = 0, pmask = 0;
    bool G, P;
#pragma unroll
    for (int u = 0; u < NPL; ++u) {
      const unsigned a = eq[u] & pv[u];
      const unsigned s = a + pv[u];
      gmask |= Mask(s < a) << u;
      pmask |= Mask(s == FULL) << u;
      if constexpr (NPL == 1) {
        G = s < a;
        P = s == FULL;
      }
    }
    const Mask tot = gmask + (gmask | pmask);
    if constexpr (NPL > 1) {
      G = (tot >> NPL) & 1u;
      P = pmask == (Mask(1) << NPL) - 1u;
    }
    const unsigned gm = __ballot_sync(FULL, G), pm = __ballot_sync(FULL, P);
    const unsigned cbits = (gm + (gm | pm)) ^ pm;  // bit l: the carry into lane l
    const bool cin = cbits & lanebit;
    const Mask carry = NPL == 1 ? Mask(cin) : (tot + cin) ^ pmask;  // bit u: into word u

    auto hmove = [&](int u, unsigned& ph, unsigned& mh) {
      const unsigned sum = (eq[u] & pv[u]) + pv[u] + unsigned((carry >> u) & 1u);
      const unsigned xh = (sum ^ pv[u]) | eq[u];
      ph = mv[u] | ~(xh | pv[u]);
      mh = pv[u] & xh;
    };
    // Ph and Mh of the lane's last word, made for either carry before the
    // ballots return, then picked
    constexpr int L = NPL - 1;
    const unsigned sL = (eq[L] & pv[L]) + pv[L];
    const unsigned xh0 = (sL ^ pv[L]) | eq[L], xh1 = ((sL + 1u) ^ pv[L]) | eq[L];
    const bool cL = NPL == 1 ? cin : (carry >> L) & 1u;
    const unsigned phl = cL ? mv[L] | ~(xh1 | pv[L]) : mv[L] | ~(xh0 | pv[L]);
    const unsigned mhl = cL ? pv[L] & xh1 : pv[L] & xh0;
    // their top bits go up a lane by two ballots: bit 31 of phin / mhin is
    // the lower lane's (below lane 0: Ph = 1, Mh = 0)
    const unsigned bph = __ballot_sync(FULL, int(phl) < 0);
    const unsigned bmh = __ballot_sync(FULL, int(mhl) < 0);
    const unsigned phin = ((bph << 1) | 1u) << (31 - lane), mhin = (bmh << 1) << (31 - lane);

    // the row's code bits of window words 0 .. WB + 1 to the stash, as they are
    const unsigned sto = st_s + 4u * ((((i - 1) / RPG) & 1) * RPG + r8) * 2 * S;
    unsigned ph_prev = 0u, mh_prev = 0u;  // the word below's, within the lane
#pragma unroll
    for (int u = 0; u < NPL; ++u) {
      unsigned ph = phl, mh = mhl;
      if (u < L) hmove(u, ph, mh);
      const unsigned phs = __funnelshift_l(u == 0 ? phin : ph_prev, ph, 1);
      const unsigned mhs = __funnelshift_l(u == 0 ? mhin : mh_prev, mh, 1);
      ph_prev = ph;
      mh_prev = mh;
      const unsigned xv = eq[u] | mv[u];
      const unsigned pvn = mhs | ~(xv | phs);
      const bool banded = lane * NPL + u <= g.WB + 1;
      sts_if(sto + 4u * u, ~pvn & (ph | ~eq[u]), banded);  // code bit 0
      sts_if(sto + 4u * (S + u), pvn | ph, banded);         // code bit 1
      // the word above the window starts the next row steady (set here,
      // beside the chain, where the window stays; after a move below)
      const bool steady = !moves && has_above && u == above_u;
      mv[u] = steady ? 0u : phs & xv;
      pv[u] = pvn | (steady ? FULL : 0u);
      if constexpr (EQ_AHEAD) {
        eq[u] = eqn[u];
        eqn[u] = eqnn[u];
      } else {  // the next row's
        eq[u] = lane * NPL + u < g.NWIN ? lds(peq_s + 4u * (cn * NP1 + nbase + u)) : 0u;
      }
    }
    cn = cn2;
    cn2 = cn3;

    if (moves) {  // the window moves up a word: the state moves down
      const unsigned pv0 = __shfl_down_sync(FULL, pv[0], 1);
      const unsigned mv0 = __shfl_down_sync(FULL, mv[0], 1);
#pragma unroll
      for (int u = 0; u + 1 < NPL; ++u) {
        pv[u] = pv[u + 1];
        mv[u] = mv[u + 1];
      }
      pv[L] = pv0;
      mv[L] = mv0;
#pragma unroll
      for (int u = 0; u < NPL; ++u) {  // the word above the window starts steady
        if (has_above && u == above_u) {
          pv[u] = FULL;
          mv[u] = 0u;
        }
      }
    }
    base = nbase;
  };
  auto hand_over = [&]() {  // a group to the flush warps
#ifdef MYERS_STATS
    const long long tw = clock_after(pv[0]);
#endif
    named_sync(bar, nbar);
#ifdef MYERS_STATS
    wait += clock_after(lds(peq_s)) - tw;
#endif
  };
  int i = 1;
  if constexpr (NPL <= 9) {  // whole groups, each unrolled, where registers allow
    for (; i + RPG - 1 <= ql; i += RPG) {
#pragma unroll
      for (int r8 = 0; r8 < RPG; ++r8) row(i + r8, r8);
      hand_over();
    }
  }
  for (; i <= ql; ++i) {
    const int r8 = (i - 1) & (RPG - 1);
    row(i, r8);
    if (r8 == RPG - 1 || i == ql) hand_over();
  }
#ifdef MYERS_STATS
  if (lane == 0) {
    atomicAdd(&g_myers_stats[MS_PAIRS], 1ull);
    atomicAdd(&g_myers_stats[MS_ROWS], (unsigned long long)ql);
    atomicAdd(&g_myers_stats[MS_CYCLES], (unsigned long long)(clock64() - t0));
    atomicAdd(&g_myers_stats[MS_WAIT_CYCLES], (unsigned long long)wait);
  }
#endif
}

template <int NPL>
int launch(const void* q, const void* t, const void* qlen, const void* tlen, void* codes,
           void* fits, int B, int M, int N, int W, cudaStream_t stream) {
  const size_t bytes = size_t(Geometry(M, W).words()) * 4;  // an alignment's
  const int F = flush_warps(W, NPL);
  int A = MAX_ALIGNMENTS;
  while (A > 1 && A * bytes > 48 * 1024) A >>= 1;
  const size_t smem = A * bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        myers_banded_kernel<NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int blocks = (B + A - 1) / A;
  myers_banded_kernel<NPL><<<blocks, 32 * (1 + F) * A, smem, stream>>>(
      (const uint8_t*)q, (const uint8_t*)t, (const int*)qlen, (const int*)tlen, (int*)codes,
      (uint8_t*)fits, B, M, N, W, F);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Window words a lane at (M, W): the instantiation myers_banded_launch
// picks (the fewest of 1, 2, 3, 5, 9, 17, 33 that hold the window of
// W/32 + 4 words), or 0 for a band it does not take (a multiple of 32 up
// to (33 * 32 - 4) * 32, the wrapper's MAX_BAND).
int myers_banded_words_per_lane(int M, int W) {
  if (W < 32 || W % 32) return 0;
  const int per = (Geometry(M, W).NWIN + 31) / 32;  // window words a lane must take
  constexpr int npl[] = {1, 2, 3, 5, 9, 17, 33};
  for (int n : npl)
    if (per <= n) return n;
  return 0;
}

// Launch B alignments on `stream`; returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a band it does not take. The
// wrapper also refuses shapes whose shared memory (Geometry::words) is over
// the 227 KB a block can use.
int myers_banded_launch(const void* q, const void* t, const void* qlen, const void* tlen,
                        void* codes, void* fits, int B, int M, int N, int W, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (myers_banded_words_per_lane(M, W)) {
    case 1: return launch<1>(q, t, qlen, tlen, codes, fits, B, M, N, W, s);
    case 2: return launch<2>(q, t, qlen, tlen, codes, fits, B, M, N, W, s);
    case 3: return launch<3>(q, t, qlen, tlen, codes, fits, B, M, N, W, s);
    case 5: return launch<5>(q, t, qlen, tlen, codes, fits, B, M, N, W, s);
    case 9: return launch<9>(q, t, qlen, tlen, codes, fits, B, M, N, W, s);
    case 17: return launch<17>(q, t, qlen, tlen, codes, fits, B, M, N, W, s);
    case 33: return launch<33>(q, t, qlen, tlen, codes, fits, B, M, N, W, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// The debug build's counters (-DMYERS_STATS=1): copies the MS_COUNT
// counters (alignments, rows, the row warps' cycles over the rows and at
// the barriers, the first flush warps' cycles between barriers, 8-row
// groups) into `out` (host memory) and zeroes them when `reset`; returns -1
// in a normal build.
int myers_banded_stats(unsigned long long* out, int reset) {
#ifdef MYERS_STATS
  cudaError_t e = cudaMemcpyFromSymbol(out, g_myers_stats, sizeof(g_myers_stats));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zero[MS_COUNT] = {};
    e = cudaMemcpyToSymbol(g_myers_stats, zero, sizeof(zero));
  }
  return int(e);
#else
  (void)out;
  (void)reset;
  return -1;
#endif
}

}  // extern "C"
