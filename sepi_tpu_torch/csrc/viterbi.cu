// Batched banded Viterbi for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `viterbi_batch` (sepi_tpu/align/viterbi_pallas.py,
// kernel body `_make_kernel`): forced alignment over linear alignment graphs,
// where every state's predecessors are itself (stay), s-1 (advance) and
// s-skip (skip over an optional silence block).  For each utterance b:
//
//   delta_0[s]  = s == 0 ? emit[b,0,0] : -1e30
//   c0 = d[s] + trans[b,0,s]; c1 = d[s-1] + trans[b,1,s]; c2 = d[s-skip] + trans[b,2,s]
//   (a neighbour index below 0 reads -1e30; no wrap-around)
//   best = max(max(c0, c1), c2)
//   bp   = c0 >= max(c1, c2) ? 0 : (c1 >= c2 ? 1 : 2)   (first maximum wins)
//   for 1 <= t < t_len: delta_t = best + emit[b,t,s], bps[b,t-1,s] = bp
//   for t >= t_len:     delta frozen,                  bps[b,t-1,s] = 0
//
// The additions are kept in exactly this order in fp32 (adds only, nothing for
// the compiler to contract into an FMA; no fast-math), so the backpointers
// match the plain version bit for bit over every state, including the
// unreachable ones, where -1e30 absorbs small addends and ties are everywhere.
//
// What bounds it on this card: bytes.  It reads the emissions once over the
// live rows (4 bytes per state and step) and writes one int8 backpointer per
// state and step, three adds and a few compares in between.  Design: one
// block per utterance, threads own states (up to kMaxPerThread each when S
// exceeds the block), delta double-buffered in shared memory (2*S floats),
// the transition rows held in registers, the next step's emission row
// prefetched into registers while the current step computes, one
// __syncthreads() per step, backpointer rows stored coalesced.  It is a chain
// of t_len-1 dependent steps, and a batch of 32 utterances occupies 32 of the
// 132 SMs, so it is latency-bound and far from its bytes bound: a later
// redesign (several utterances per SM, warp-level steps without a block
// barrier) is what would move it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxPerThread = 8;  // states per thread: S <= 8192

template <int K>
__global__ void viterbi_kernel(const float* __restrict__ emit, const int* __restrict__ t_len,
                               const float* __restrict__ trans, int8_t* __restrict__ bps,
                               float* __restrict__ delta_out, int T, int S, int skip) {
  extern __shared__ float buf[];  // [2][S]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const float* e = emit + (size_t)b * T * S;
  const float* tr = trans + (size_t)b * 3 * S;
  int8_t* bp_out = bps + (size_t)b * (T - 1) * S;
  int t_end = t_len[b];
  t_end = t_end < 1 ? 1 : (t_end > T ? T : t_end);

  float tr0[K], tr1[K], tr2[K], e_cur[K], e_nxt[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = tid + j * nth;
    if (s < S) {
      tr0[j] = tr[s];
      tr1[j] = tr[S + s];
      tr2[j] = tr[2 * S + s];
      buf[s] = s == 0 ? e[0] : kNeg;
      e_cur[j] = t_end > 1 ? e[S + s] : 0.0f;
    }
    e_nxt[j] = 0.0f;
  }
  __syncthreads();

  for (int t = 1; t < t_end; ++t) {
    const float* cur = buf + ((t - 1) & 1) * S;
    float* nxt = buf + (t & 1) * S;
    const bool more = t + 1 < t_end;
    int8_t* row = bp_out + (size_t)(t - 1) * S;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int s = tid + j * nth;
      if (s < S) {
        if (more) e_nxt[j] = e[(size_t)(t + 1) * S + s];
        const float c0 = cur[s] + tr0[j];
        const float c1 = (s >= 1 ? cur[s - 1] : kNeg) + tr1[j];
        const float c2 = (s >= skip ? cur[s - skip] : kNeg) + tr2[j];
        const float m12 = c1 >= c2 ? c1 : c2;
        const float best = c0 >= m12 ? c0 : m12;
        const int8_t bp = c0 >= m12 ? 0 : (c1 >= c2 ? 1 : 2);
        nxt[s] = best + e_cur[j];
        row[s] = bp;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < K; ++j) e_cur[j] = e_nxt[j];
  }

  const float* last = buf + ((t_end - 1) & 1) * S;
  for (int s = tid; s < S; s += nth) delta_out[(size_t)b * S + s] = last[s];
  // frozen steps t_end..T-1 carry zero backpointers
  const size_t z0 = (size_t)(t_end - 1) * S, z1 = (size_t)(T - 1) * S;
  for (size_t i = z0 + tid; i < z1; i += nth) bp_out[i] = 0;
}

template <int K>
cudaError_t launch(const float* emit, const int* t_len, const float* trans, int8_t* bps,
                   float* delta, int B, int T, int S, int skip, int threads,
                   cudaStream_t stream) {
  const size_t smem = 2 * (size_t)S * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  viterbi_kernel<K><<<B, threads, smem, stream>>>(emit, t_len, trans, bps, delta, T, S, skip);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sepi_viterbi_batch(const float* emit, const int* t_len, const float* trans,
                                  int8_t* bps, float* delta, int B, int T, int S, int skip,
                                  void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || skip <= 0) return (int)cudaErrorInvalidValue;
  if (S > kMaxThreads * kMaxPerThread) return (int)cudaErrorInvalidValue;
  const int threads = S >= kMaxThreads ? kMaxThreads : ((S + 31) / 32) * 32;
  const int per = (S + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (per <= 1) {
    err = launch<1>(emit, t_len, trans, bps, delta, B, T, S, skip, threads, st);
  } else if (per <= 2) {
    err = launch<2>(emit, t_len, trans, bps, delta, B, T, S, skip, threads, st);
  } else if (per <= 4) {
    err = launch<4>(emit, t_len, trans, bps, delta, B, T, S, skip, threads, st);
  } else {
    err = launch<8>(emit, t_len, trans, bps, delta, B, T, S, skip, threads, st);
  }
  return (int)err;
}
