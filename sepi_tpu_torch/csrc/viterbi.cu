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
// (The warp kernel takes best as fmaxf, which can differ from the `where`
// chain only in the sign of a zero: equal under every comparison and sum.)
//
// What bounds it on this card.  Bytes: it reads the emissions once over the
// live rows (4 bytes per state and step) and writes one int8 backpointer per
// state and step; at B=32 x T=1024 x S=256 that is 33 MB, 0.01 ms at 3.35 TB/s.
// Operations are negligible (7 per state and step).  What really bounds it is
// the dependency chain: T-1 steps, each of which needs every state's previous
// score, so a step costs the latency of one step on whatever computes it.
// A block per utterance (delta in shared memory, a
// __syncthreads() per step) paid a block barrier and a shared-memory round
// trip per step.
//
// Design for S <= 1024 (`viterbi_warp`): one warp per utterance, one warp
// per block, so a batch of 32 utterances spreads over 32 SMs with a
// scheduler each and a ragged utterance retires its block as soon as it ends.
// - Lane l owns the K = S_pad/32 contiguous states [l*K, l*K+K), with delta
//   and the three transition values in registers; states padded past S are
//   dead (delta and transitions -1e30, emissions 0) and never written out.
// - The advance neighbour of a lane's first state is one __shfl_up from the
//   lane below; the skip neighbours come from the lanes skip/K and skip/K+1
//   below (two lanes back when K < skip, as at S=128 with skip 8).  The
//   aligner's skip 4 is a template argument, so every source lane and
//   register is a constant; another skip rotates the register array by
//   skip%K at run time first.  No barrier and no shared-memory delta on the
//   step's critical path.
// - The emissions go from device memory straight into registers.  Steps
//   run in groups of G = 4 (K <= 16; 2 at K = 16 with the skip taken at
//   run time) or 1 (K = 32): at the start of a group each lane loads its
//   own K states of the next group's rows, and at its end the group's
//   backpointer rows are stored, each lane's K as one vector store,
//   coalesced across the warp.
// - tools/viterbi_probe.py builds this kernel and variants of it and times
//   them at 32 x 1024 x S, S = 128-512 (PERF.md, Findings): skip 4 through
//   the run-time rotation is 1.1-1.7x slower than compiled in; an L2
//   prefetch of rows ahead (1.1-1.3x) and a per-warp cp.async ring of 8 or
//   32 emission rows in shared memory (1.2-1.5x) are slower everywhere.
//
// Why the split at S = 1024: above it K > 32, and delta, three transition
// rows and two groups of emission rows no longer fit a lane's 255 registers, while
// the per-step work on one warp keeps growing with K.  There the block
// kernel (`viterbi_block`, many warps sharing a barrier) is the better
// trade, up to MAX_STATES = 8192.  The choice is by S alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpMaxStates = 1024;  // 32 lanes x 32 states
constexpr int kMaxThreads = 1024;
constexpr int kMaxPerThread = 8;      // block kernel: S <= 8192

// steps a group: the group's emission rows are loaded, and its backpointer
// rows stored, in one burst each, so no memory instruction sits among the
// steps' shuffles (the next group's rows are in flight meanwhile).  Longer
// groups spill registers at K = 32, and at K = 16 beside the run-time skip's
// rotated copy of delta; 8 steps at K <= 8 measured no faster, and 2 at
// K = 16 slower (tools/viterbi_probe.py, PERF.md).
template <int K, int SKIP>
__host__ __device__ constexpr int group_steps() {
  return K >= 32 ? 1 : (K >= 16 && SKIP == 0 ? 2 : 4);
}

// One lane's K backpointers (values 0..2) packed little-endian into bytes.
template <int K>
struct BpWords {
  static constexpr int kWords = (K + 3) / 4;
  uint32_t w[kWords];
};

// Store states [s0, s0+K) of a backpointer row: vector stores when the row
// allows them (vec), bytes otherwise; never past S.
template <int K>
__device__ __forceinline__ void store_row(int8_t* row, const BpWords<K>& p, int s0, int S,
                                          bool vec) {
  if (s0 >= S) return;
  if (vec && s0 + K <= S) {
    if constexpr (K == 1) {
      row[s0] = (int8_t)p.w[0];
    } else if constexpr (K == 2) {
      *reinterpret_cast<uint16_t*>(row + s0) = (uint16_t)p.w[0];
    } else if constexpr (K == 4) {
      *reinterpret_cast<uint32_t*>(row + s0) = p.w[0];
    } else if constexpr (K == 8) {
      *reinterpret_cast<uint2*>(row + s0) = make_uint2(p.w[0], p.w[1]);
    } else {
#pragma unroll
      for (int q = 0; q < K / 16; ++q)
        *reinterpret_cast<uint4*>(row + s0 + 16 * q) =
            make_uint4(p.w[4 * q], p.w[4 * q + 1], p.w[4 * q + 2], p.w[4 * q + 3]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (s0 + j < S) row[s0 + j] = (int8_t)((p.w[j / 4] >> (8 * (j % 4))) & 0xff);
}

// sk[j] = delta of global state s0 + j - skip (kNeg below state 0).  With
// SKIP known at compile time the source lane and register of every j are
// constants; SKIP = 0 takes skip at run time and rotates the register array
// by skip % K first (log2 K predicated stages).
template <int K, int SKIP>
__device__ __forceinline__ void skip_neighbours(const float (&d)[K], float (&sk)[K], int lane,
                                                int skip) {
  if constexpr (SKIP > 0) {
    constexpr int kBack = SKIP / K, kRot = SKIP % K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float v = d[(j - kRot + K) % K];
      const int back = j >= kRot ? kBack : kBack + 1;
      if (back == 0) {
        sk[j] = v;
      } else {
        const float u = __shfl_up_sync(kFull, v, back);
        sk[j] = lane >= back ? u : kNeg;
      }
    }
  } else {
    const int lanes_back = skip / K, rot = skip % K;
    float rv[K];
#pragma unroll
    for (int j = 0; j < K; ++j) rv[j] = d[j];
#pragma unroll
    for (int bit = 1; bit < K; bit <<= 1) {
      if (rot & bit) {
        float tmp[K];
#pragma unroll
        for (int j = 0; j < K; ++j) tmp[j] = rv[(j - bit + K) % K];
#pragma unroll
        for (int j = 0; j < K; ++j) rv[j] = tmp[j];
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int back = j >= rot ? lanes_back : lanes_back + 1;
      const float v = __shfl_sync(kFull, rv[j], (lane - back) & 31);
      sk[j] = lane >= back ? v : kNeg;
    }
  }
}

template <int K, int SKIP>
__global__ void __launch_bounds__(32) viterbi_warp(
    const float* __restrict__ emit, const int* __restrict__ t_len,
    const float* __restrict__ trans, int8_t* __restrict__ bps,
    float* __restrict__ delta_out, int T, int S, int skip, int vec_emit, int vec_bp) {
  constexpr int G = group_steps<K, SKIP>();
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int s0 = lane * K;
  const float* e = emit + (size_t)b * T * S;
  const float* tr = trans + (size_t)b * 3 * S;
  int8_t* bp_out = bps + (size_t)b * (T - 1) * S;
  int t_end = t_len[b];
  t_end = t_end < 1 ? 1 : (t_end > T ? T : t_end);

  float d[K], tr0[K], tr1[K], tr2[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = s0 + j;
    const bool live = s < S;
    tr0[j] = live ? tr[s] : kNeg;
    tr1[j] = live ? tr[S + s] : kNeg;
    tr2[j] = live ? tr[2 * S + s] : kNeg;
    d[j] = s == 0 ? e[0] : kNeg;
  }
  const bool whole = vec_emit && K % 4 == 0 && s0 + K <= S;  // one 16-byte load a quad
  // this lane's states of row r (dead states and rows past the end read 0)
  auto load = [&](int r, float (&v)[K]) {
    const float* src = e + (size_t)r * S + s0;
    if (r < t_end && whole) {
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(src) + q);
        v[4 * q] = f.x;
        v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = r < t_end && s0 + j < S ? __ldg(src + j) : 0.f;
    }
  };

  // step t with the emissions ev; its backpointers into p
  auto step = [&](const float (&ev)[K], BpWords<K>& p) {
    // advance neighbour of state s0: the lane below's last state
    float below = __shfl_up_sync(kFull, d[K - 1], 1);
    below = lane == 0 ? kNeg : below;
    float sk[K];
    skip_neighbours<K, SKIP>(d, sk, lane, skip);
#pragma unroll
    for (int q = 0; q < BpWords<K>::kWords; ++q) p.w[q] = 0;
    // in place from the top: state j reads d[j-1] before it is updated
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      const float c0 = d[j] + tr0[j];
      const float c1 = (j == 0 ? below : d[j - 1]) + tr1[j];
      const float c2 = sk[j] + tr2[j];
      const float m12 = fmaxf(c1, c2);
      d[j] = fmaxf(c0, m12) + ev[j];
      const uint32_t bp = c0 >= m12 ? 0u : (c1 >= c2 ? 1u : 2u);
      p.w[j / 4] |= bp << (8 * (j % 4));
    }
  };

  float cur[G][K], nxt[G][K];  // this group's rows, the next group's
#pragma unroll
  for (int i = 0; i < G; ++i) load(1 + i, cur[i]);
  int t = 1;
#pragma unroll 1
  for (; t + G <= t_end; t += G) {
#pragma unroll
    for (int i = 0; i < G; ++i) load(t + G + i, nxt[i]);
    BpWords<K> p[G];
#pragma unroll
    for (int i = 0; i < G; ++i) step(cur[i], p[i]);
#pragma unroll
    for (int i = 0; i < G; ++i) store_row<K>(bp_out + (size_t)(t + i - 1) * S, p[i], s0, S, vec_bp);
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j) cur[i][j] = nxt[i][j];
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {  // the last steps (fewer than G)
    if (t + i < t_end) {
      BpWords<K> p;
      step(cur[i], p);
      store_row<K>(bp_out + (size_t)(t + i - 1) * S, p, s0, S, vec_bp);
    }
  }

#pragma unroll
  for (int j = 0; j < K; ++j)
    if (s0 + j < S) delta_out[(size_t)b * S + s0 + j] = d[j];
  // frozen steps t_end..T-1 carry zero backpointers
  BpWords<K> zero;
#pragma unroll
  for (int q = 0; q < BpWords<K>::kWords; ++q) zero.w[q] = 0;
#pragma unroll 1
  for (int tf = t_end; tf < T; ++tf) store_row<K>(bp_out + (size_t)(tf - 1) * S, zero, s0, S, vec_bp);
}

// S > 1024: one block per utterance, threads own states (up to K each),
// delta double-buffered in shared memory, one __syncthreads() per step.
template <int K>
__global__ void viterbi_block(const float* __restrict__ emit, const int* __restrict__ t_len,
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
  const size_t z0 = (size_t)(t_end - 1) * S, z1 = (size_t)(T - 1) * S;
  for (size_t i = z0 + tid; i < z1; i += nth) bp_out[i] = 0;
}

cudaError_t set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int K, int SKIP>
cudaError_t launch_warp(const float* emit, const int* t_len, const float* trans, int8_t* bps,
                        float* delta, int B, int T, int S, int skip, cudaStream_t stream) {
  const int vec_emit = (S % 4 == 0) && ((uintptr_t)emit % 16 == 0);
  const int w = K < 16 ? K : 16;  // widest backpointer store
  const int vec_bp = (S % w == 0) && ((uintptr_t)bps % 16 == 0);
  viterbi_warp<K, SKIP><<<B, 32, 0, stream>>>(emit, t_len, trans, bps, delta, T, S, skip,
                                              vec_emit, vec_bp);
  return cudaGetLastError();
}

// the aligner's skip (3 states a phone, so 4) gets compile-time lanes
template <int K>
cudaError_t launch_warp_k(const float* emit, const int* t_len, const float* trans, int8_t* bps,
                          float* delta, int B, int T, int S, int skip, cudaStream_t st) {
  if (skip == 4) return launch_warp<K, 4>(emit, t_len, trans, bps, delta, B, T, S, skip, st);
  return launch_warp<K, 0>(emit, t_len, trans, bps, delta, B, T, S, skip, st);
}

template <int K>
cudaError_t launch_block(const float* emit, const int* t_len, const float* trans, int8_t* bps,
                         float* delta, int B, int T, int S, int skip, int threads,
                         cudaStream_t stream) {
  const size_t smem = 2 * (size_t)S * sizeof(float);
  cudaError_t err = set_smem((const void*)viterbi_block<K>, smem);
  if (err != cudaSuccess) return err;
  viterbi_block<K><<<B, threads, smem, stream>>>(emit, t_len, trans, bps, delta, T, S, skip);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sepi_viterbi_batch(const float* emit, const int* t_len, const float* trans,
                                  int8_t* bps, float* delta, int B, int T, int S, int skip,
                                  void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || skip <= 0) return (int)cudaErrorInvalidValue;
  if (S > kMaxThreads * kMaxPerThread) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= kWarpMaxStates) {
    const int per = (S + 31) / 32;
    if (per <= 1) return (int)launch_warp_k<1>(emit, t_len, trans, bps, delta, B, T, S, skip, st);
    if (per <= 2) return (int)launch_warp_k<2>(emit, t_len, trans, bps, delta, B, T, S, skip, st);
    if (per <= 4) return (int)launch_warp_k<4>(emit, t_len, trans, bps, delta, B, T, S, skip, st);
    if (per <= 8) return (int)launch_warp_k<8>(emit, t_len, trans, bps, delta, B, T, S, skip, st);
    if (per <= 16)
      return (int)launch_warp_k<16>(emit, t_len, trans, bps, delta, B, T, S, skip, st);
    return (int)launch_warp_k<32>(emit, t_len, trans, bps, delta, B, T, S, skip, st);
  }
  const int threads = kMaxThreads;
  const int per = (S + threads - 1) / threads;
  if (per <= 2)
    return (int)launch_block<2>(emit, t_len, trans, bps, delta, B, T, S, skip, threads, st);
  if (per <= 4)
    return (int)launch_block<4>(emit, t_len, trans, bps, delta, B, T, S, skip, threads, st);
  return (int)launch_block<8>(emit, t_len, trans, bps, delta, B, T, S, skip, threads, st);
}
