// Batched Myers bit-vector edit distance (score only) for Hopper (sm_90a):
// one thread per alignment.
//
// Replaces no TPU kernel: the JAX package runs this scan as XLA ops
// (genomeworks_tpu/aligner/myers.py _myers_scan: lax.scan over target
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
// What bounds it on this card, and what the design does about it: the
// work is about 17 int32 operations a word a target position, and a
// target position is a chain through the query's words. A thread per
// alignment runs that chain alone, so the kernel is bound by the chain's
// latency (the PV and MV words of the alignment in a global scratch,
// word-major so a warp's threads read one word of 32 alignments together)
// and by how few alignments there are to fill the card. A warp per
// alignment with the carry across lanes, as the reference's
// myers_gpu.cu does, is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
myers_score_kernel(const uint32_t* __restrict__ peq, const uint8_t* __restrict__ tcodes,
                   const int* __restrict__ qlen, const int* __restrict__ tlen,
                   uint32_t* __restrict__ pv, uint32_t* __restrict__ mv, int* __restrict__ out,
                   int B, int T, int n_words) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const int ql = qlen[b];
  const int last = ql > 0 ? (ql - 1) / 32 : 0;
  int hb = ql - 1 - last * 32;
  hb = hb < 0 ? 0 : (hb > 31 ? 31 : hb);
  const uint32_t last_mask = 1u << hb;
  for (int i = 0; i <= last; ++i) {
    pv[(size_t)i * B + b] = 0xffffffffu;
    mv[(size_t)i * B + b] = 0u;
  }
  const uint32_t* my_peq = peq + (size_t)b * 4 * n_words;
  const uint8_t* my_t = tcodes + (size_t)b * T;
  int score = ql;
  const int tl = tlen[b];
  for (int t = 0; t < tl; ++t) {
    const uint32_t* eq_row = my_peq + (size_t)my_t[t] * n_words;
    int carry = 1;
    for (int i = 0; i <= last; ++i) {
      uint32_t eq = eq_row[i];
      const uint32_t p = pv[(size_t)i * B + b];
      const uint32_t m = mv[(size_t)i * B + b];
      const uint32_t xv = eq | m;
      if (carry < 0) eq |= 1u;
      const uint32_t xh = (((eq & p) + p) ^ p) | eq;
      uint32_t ph = m | ~(xh | p);
      uint32_t mh = p & xh;
      const uint32_t hm = i < last ? 0x80000000u : last_mask;
      const int cout = ((ph & hm) != 0u) - ((mh & hm) != 0u);
      ph = (ph << 1) | (carry > 0 ? 1u : 0u);
      mh = (mh << 1) | (carry < 0 ? 1u : 0u);
      pv[(size_t)i * B + b] = mh | ~(xv | ph);
      mv[(size_t)i * B + b] = ph & xv;
      carry = cout;
    }
    score += carry;  // the last word's carry out
  }
  out[b] = score;
}

}  // namespace

extern "C" {

// B alignments on `stream`; pv and mv are (n_words, B) uint32 scratch.
// Returns cudaGetLastError() after the launch.
int myers_score_launch(const void* peq, const void* tcodes, const void* qlen, const void* tlen,
                       void* pv, void* mv, void* out, int B, int T, int n_words,
                       void* stream) {
  if (B > 0) {
    myers_score_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)peq, (const uint8_t*)tcodes, (const int*)qlen, (const int*)tlen,
        (uint32_t*)pv, (uint32_t*)mv, (int*)out, B, T, n_words);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
