// Fused Kaldi MFCC for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `mfcc_fused` (sepi_tpu/ops/mfcc_pallas.py,
// kernel body `_kernel`): batched MFCC from raw samples, framing, dither,
// DFT, power, mel, log, DCT, lifter and raw-energy C0 in one pass, with no
// frames tensor in device memory.  The same launch also recomputes the few
// tail frames whose window crosses each utterance's end (exact mirror
// gather, their own noise domain), zeroes the frames past the end and
// writes the frame mask: the wrapper launches nothing else.
//
// What bounds it on this card.  Operations: 2*(flen*2K + K*M + M*C) flops a
// frame against 4*shift bytes of input.  At the SRE geometry (200-sample
// frames, 128 bins, 23 mel, 23 ceps) and 16 x 100 s that is 17.5 GFLOP
// against 66 MB: 0.26 ms at the 67 TFLOP/s fp32 rate of the CUDA cores,
// 0.02 ms at 3.35 TB/s.  The DFT is 94% of the operations, so this kernel
// runs it on the tensor cores: as three TF32 products (3 x 17.5 GFLOP at
// 495 TFLOP/s, 0.106 ms), which is its bound; the bytes bound stays far below.
//
// Design:
// - DFT as 3xTF32 `mma.sync.m16n8k8`: each fp32 operand x is split into
//   hi = tf32(x) and lo = tf32(x - hi) (round to nearest on the 13 low
//   mantissa bits), and hi*hi + hi*lo + lo*hi accumulate in fp32, which keeps
//   the cepstra near fp32 accuracy (a one-pass TF32 product would not: the
//   lifter scales cepstra by up to 12).
// - One block per (utterance, 64 frames), 4 warps: 2 along frames x 2 along
//   bins; a warp owns 32 frames x 32 bins (real and imaginary, 64 fp32
//   accumulators a thread) of a 64-bin pass.
// - The block stages its signal span (64 frames plus the overlap) once in
//   shared memory by cp.async (every load in flight at once), then adds the
//   dither in place, in rows of `shift` samples padded to a stride of 4 mod 8
//   words, so the 8 frame rows of an A fragment hit 8 distinct bank quads.
//   A fragments are read from the span by address (a frame is a strided
//   window, not a canonical matrix tile).
// - The basis is pre-permuted on the host into fragment order (a lane's B
//   values for two n-tiles are one 16-byte load) and streams through a
//   3-stage cp.async ring of 2 k-steps a stage, so the next chunk is in
//   flight while the current one multiplies; the first chunks are issued
//   before the span is staged.  ~74 KB of shared memory at the SRE
//   geometry, 3 blocks an SM.
// - Power, mel, log, DCT, lifter and the energy stay on the CUDA cores, ~6%
//   of the operations.  The mel weights (nonzero bins only) and band tables
//   are staged in shared memory with the span, the DCT and lifter into the
//   ring once the spectrum is done.  In the mel and DCT sums the lanes take
//   frames and a warp walks one band or coefficient at a time, so every
//   lane of a warp runs the same trip count; the cepstra leave through the
//   power tile in coalesced rows.
//
// Dither (the TPU kernel's noise map; the transcendentals are the card's
// fast ones, within ~1e-6 of the reference's): the noise field is tied to
// the reference's 256-frame tiles.  For frames of tile tau, padded sample
// position p = frame*shift + n lies at row r = p/shift - tau*256 of a
// (256 + extra)-row map, column p % shift.  Rows r < half take r_mag*cos at
// cell r*shift + col, rows r >= half take r_mag*sin at cell
// (r - half)*shift + col, all keyed by fmix32(seed ^ tau*0x9E3779B9).  A
// block's 64 frames lie in one tile, so each span sample has one noise value.
// Tail frame i (of n_fix, from t0) adds r_mag*cos at counter i*flen + n,
// keyed by fmix32(seed ^ 0x7F4A7C15), with counters offset by n_fix*flen for
// the angle (ops/mfcc_cuda.py `tail_plan` writes the formula out).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // 4 warps: 2 along frames x 2 along bins
constexpr int kFrames = 64;        // frames per block
constexpr int kNoiseTile = 256;    // frame tile of the reference noise map
constexpr int kPassBins = 64;      // bins per pass: 128 basis columns
constexpr int kStepFloats = 8 * 2 * kPassBins;  // one k-step of a pass
constexpr int kStepsPerStage = 2;  // k-steps per ring stage
constexpr int kStageFloats = kStepsPerStage * kStepFloats;
constexpr int kStages = 3;
constexpr int kMaxDevices = 64;   // cards whose shared-memory attribute is tracked
constexpr int kPowStride = kPassBins + 1;  // odd: a warp reads 32 frames' rows conflict-free
constexpr float kFltMin = 1.17549435082228750797e-38f;
constexpr float kInv224 = 5.9604644775390625e-08f;  // 2^-24
// 2*pi*2^-24, rounded to float once as the reference applies it
constexpr float kAngScale = (float)(6.283185307179586 * 5.9604644775390625e-08);
constexpr uint32_t kTileMix = 0x9E3779B9u;
constexpr uint32_t kTailMix = 0x7F4A7C15u;

static_assert(kNoiseTile % kFrames == 0, "a block must lie in one noise tile");
static_assert(kFrames == 64 && kThreads == 128, "warp map is 2 x 2 warps of 32 frames");
static_assert(kStageFloats % (4 * kThreads) == 0, "a stage is whole 16-byte copies");

struct Args {
  const float* x;        // (B, N) samples
  const int* lengths;    // (B,) true sample counts
  const int* seeds;      // (B,) dither seeds (unused when !dithered)
  const float* basis;    // fused DFT basis (DC dropped) in fragment order
  const float* mel_w;    // nonzero mel weights, band by band
  const int* mel_lo;     // (M,) first nonzero row of each band
  const int* mel_hi;     // (M,) one past the last nonzero row
  const int* mel_off;    // (M,) offset of each band's weights in mel_w
  const float* dct;      // (M, C)
  const float* lift;     // (C,)
  float* out;            // (B, T, C)
  uint8_t* mask;         // (B, T)
  int n, t, flen, shift, pad_l, km, n_mel, n_ceps, mel_nnz;
  int ksteps;            // 8-row k-steps per pass (basis rows zero past flen)
  int n_fix;             // tail frames per utterance
  int snip;
  int sp;                // padded row stride of the frame store
  int span_rows;         // rows of the block's span
  int tail_rows;         // rows of one tail frame
  int ring_floats;       // the basis ring, which later holds the DCT and lifter
  int pow_stride;        // floats a frame of the power tile: kPowStride for the power,
                         // n_ceps | 1 for the cepstra it holds last
  int use_energy, remove_dc, has_floor, dithered;
  float log_floor, dither;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float u24(uint32_t seed, uint32_t counter) {
  return (float)(fmix32(seed ^ counter) >> 8);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo, both TF32 (round to nearest on the 13 low mantissa bits)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  const float rest = x - __uint_as_float(hi);
  lo = (__float_as_uint(rest) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a*b in 3xTF32: the small cross terms first, then hi*hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ void load_stage(float* ring, const float* basis, int q, int tid) {
  float* dst = ring + (q % kStages) * kStageFloats;
  const float* src = basis + (size_t)q * kStageFloats;
#pragma unroll
  for (int i = tid; i < kStageFloats / 4; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i);
}

// one more 8-sample k-step for a column tracker: off = (k / shift)*sp + k % shift
__device__ __forceinline__ void advance(int& off, int& rr, int shift, int sp) {
  off += 8;
  rr += 8;
  if (rr >= shift) {
    rr -= shift;
    off += sp - shift;
  }
}

__global__ void __launch_bounds__(kThreads, 3) mfcc_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, c = lane & 3;
  const int len = max(a.lengths[b], 0);
  int t_u;  // ops/framing.num_frames
  if (a.snip) {
    t_u = len >= a.flen ? (len - a.flen) / a.shift + 1 : 0;
  } else {
    t_u = (len + a.shift / 2) / a.shift;
  }
  const int t_valid = min(t_u, a.t);
  const int n_out = min(kFrames, a.t - f0);
  float* out = a.out + ((size_t)b * a.t + f0) * a.n_ceps;
  uint8_t* mask = a.mask + (size_t)b * a.t + f0;
  for (int i = tid; i < n_out; i += kThreads) mask[i] = f0 + i < t_valid;

  if (f0 >= t_valid) {  // the whole block is masked
    for (int i = tid; i < n_out * a.n_ceps; i += kThreads) out[i] = 0.f;
    return;
  }

  float* ring = smem;                                    // ring_floats
  float* span = ring + a.ring_floats;                    // span_rows x sp, then tails
  const int tail_base = a.span_rows * a.sp;              // tail frame i at + i*tail_rows*sp
  float* power = span + tail_base + a.n_fix * a.tail_rows * a.sp;  // kFrames x pow_stride
  const int ms = a.n_mel | 1;                            // odd row stride, as power's
  float* melacc = power + kFrames * a.pow_stride;        // kFrames x ms
  float* log_e = melacc + kFrames * ms;                  // kFrames
  float* mel_w = log_e + kFrames;                        // mel_nnz
  int* band = reinterpret_cast<int*>(mel_w + a.mel_nnz); // lo, hi, off: 3 x n_mel

  // 1. the block's signal span, [left mirror | samples | zeros]: the
  //    samples by cp.async, so every load of the span is in flight at once
  const float* xb = a.x + (size_t)b * a.n;
  const long long base = (long long)f0 * a.shift;
  // (row, col) of span sample s = tid, tid + kThreads, ... without a division a sample
  int row = tid / a.shift, col = tid - row * a.shift;
  const int drow = kThreads / a.shift, dcol = kThreads - drow * a.shift;
  for (int s = tid; s < a.span_rows * a.shift; s += kThreads) {
    float* dst = span + row * a.sp + col;
    const long long q = base + s;
    if (q >= a.pad_l && q - a.pad_l < a.n) {
      cp_async4(dst, xb + (q - a.pad_l));
    } else {
      *dst = q < a.pad_l ? xb[a.pad_l - 1 - q] : 0.f;
    }
    row += drow;
    col += dcol;
    if (col >= a.shift) {
      col -= a.shift;
      ++row;
    }
  }
  // the mel weights and band tables, read in every pass's epilogue
  for (int i = tid; i < a.mel_nnz; i += kThreads) cp_async4(mel_w + i, a.mel_w + i);
  for (int i = tid; i < a.n_mel; i += kThreads) {
    cp_async4(band + i, a.mel_lo + i);
    cp_async4(band + a.n_mel + i, a.mel_hi + i);
    cp_async4(band + 2 * a.n_mel + i, a.mel_off + i);
  }
  cp_async_commit();
  // the basis ring starts filling while the block stages its signal
  const int chunks_per_pass = a.ksteps / kStepsPerStage;
  const int total = (a.km / kPassBins) * chunks_per_pass;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_stage(ring, a.basis, s, tid);
    cp_async_commit();
  }

  // tail frames t0 .. t0+n_fix-1 that lie in this block and are not masked
  const int t0 = min(max(t_valid - a.n_fix, 0), a.t - a.n_fix);
  const int tail_lo = max(t0, f0);
  const int tail_hi = min(min(t0 + a.n_fix, t_valid), f0 + kFrames);
  auto frame_base = [&](int f) {
    const int fi = f0 + f;
    return fi >= tail_lo && fi < tail_hi ? tail_base + (fi - t0) * a.tail_rows * a.sp
                                         : f * a.sp;
  };

  // the dither, in place once the span has landed
  cp_async_wait<kStages - 1>();
  __syncthreads();
  if (a.dithered) {
    const int extra = (a.flen + a.shift - 1) / a.shift;
    const uint32_t tau = (uint32_t)(f0 / kNoiseTile);
    const uint32_t tseed = fmix32((uint32_t)a.seeds[b] ^ (tau * kTileMix));
    const int r0 = f0 % kNoiseTile;
    const int half = (kNoiseTile + extra + 1) / 2;
    const uint32_t span_n = (uint32_t)(half * a.shift);
    int row = tid / a.shift, col = tid - row * a.shift;
    const int drow = kThreads / a.shift, dcol = kThreads - drow * a.shift;
    for (int s = tid; s < a.span_rows * a.shift; s += kThreads) {
      const int r = r0 + row;
      const bool second = r >= half;
      const uint32_t cell = (uint32_t)((second ? r - half : r) * a.shift + col);
      const float u1 = (u24(tseed, cell) + 1.0f) * kInv224;
      const float ang = kAngScale * u24(tseed, cell + span_n);
      // __logf is within 2^-21 of log: clamp so u1 ~ 1 gives 0, not a NaN
      const float rm = sqrtf(fmaxf(-2.0f * __logf(u1), 0.f));
      float* v = span + row * a.sp + col;
      *v = *v + a.dither * (rm * (second ? __sinf(ang) : __cosf(ang)));
      row += drow;
      col += dcol;
      if (col >= a.shift) {
        col -= a.shift;
        ++row;
      }
    }
  }

  // 2. tail frames: exact mirror gather of the clean samples + tail noise
  if (tail_lo < tail_hi) {
    const int tlen = a.tail_rows * a.shift;
    const int lg = min(len, a.n);
    const uint32_t pseed = a.dithered ? fmix32((uint32_t)a.seeds[b] ^ kTailMix) : 0u;
    const uint32_t tspan = (uint32_t)(a.n_fix * a.flen);
    const int off = a.snip ? 0 : a.shift / 2 - a.flen / 2;
    for (int idx = tid; idx < (tail_hi - tail_lo) * tlen; idx += kThreads) {
      const int fi = tail_lo + idx / tlen;
      const int k = idx - (idx / tlen) * tlen;
      const int i = fi - t0;
      float v = 0.f;
      if (k < a.flen) {
        long long id = (long long)fi * a.shift + off + k;
        if (id < 0) id = -id - 1;
        if (id >= lg) id = 2LL * lg - 1 - id;
        if (id < 0) id = -id - 1;
        id = id < 0 ? 0 : (id > lg - 1 ? lg - 1 : id);
        v = xb[id];
        if (a.dithered) {
          const uint32_t cnt = (uint32_t)(i * a.flen + k);
          const float u1 = (u24(pseed, cnt) + 1.0f) * kInv224;
          const float ang = kAngScale * u24(pseed, cnt + tspan);
          v = v + a.dither * (sqrtf(-2.0f * logf(u1)) * __cosf(ang));
        }
      }
      const int row = k / a.shift;
      span[tail_base + (i * a.tail_rows + row) * a.sp + (k - row * a.shift)] = v;
    }
  }
  for (int i = tid; i < kFrames * ms; i += kThreads) melacc[i] = 0.f;
  __syncthreads();

  // 3. raw frame energy: 2 lanes per frame
  if (a.use_energy) {
    const int f = tid >> 1, part = tid & 1;
    const float* fr = span + frame_base(f);
    float s1 = 0.f, s2 = 0.f;
    for (int k0 = 0; k0 < a.flen; k0 += a.shift) {
      const int lim = min(a.shift, a.flen - k0);
      for (int col = part; col < lim; col += 2) {
        const float v = fr[col];
        s1 += v;
        s2 += v * v;
      }
      fr += a.sp;
    }
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
    if (part == 0) {
      const float e = a.remove_dc ? s2 - s1 * s1 / (float)a.flen : s2;
      float le = logf(fmaxf(e, kFltMin));
      if (a.has_floor) le = fmaxf(le, a.log_floor);
      log_e[f] = le;
    }
  }

  // 4. spectrum, one 64-bin pass at a time: thread (g, c) of warp (wm, wn)
  //    holds rows wm*32 + mt*16 + g (+8) and bins wn*32 + l*8 + 2c (+1) of
  //    n-tile l (real l < 4, imaginary l >= 4)
  int rb[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    rb[mt][0] = frame_base(wm * 32 + mt * 16 + g);
    rb[mt][1] = frame_base(wm * 32 + mt * 16 + g + 8);
  }
  float acc[2][8][4];
  int off0 = 0, rr0 = 0, off1 = 0, rr1 = 0;
#pragma unroll 1
  for (int q = 0; q < total; ++q) {
    const int j = q % chunks_per_pass;
    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int l = 0; l < 8; ++l)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][l][i] = 0.f;
      off0 = rr0 = c;
      off1 = rr1 = c + 4;
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk q is in, and every warp is done with chunk q-1
    if (q + kStages - 1 < total) load_stage(ring, a.basis, q + kStages - 1, tid);
    cp_async_commit();
    const float* st = ring + (q % kStages) * kStageFloats;
#pragma unroll
    for (int kk = 0; kk < kStepsPerStage; ++kk) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        split_tf32(span[rb[mt][0] + off0], ah[mt][0], al[mt][0]);
        split_tf32(span[rb[mt][1] + off0], ah[mt][1], al[mt][1]);
        split_tf32(span[rb[mt][0] + off1], ah[mt][2], al[mt][2]);
        split_tf32(span[rb[mt][1] + off1], ah[mt][3], al[mt][3]);
      }
      advance(off0, rr0, a.shift, a.sp);
      advance(off1, rr1, a.shift, a.sp);
      const float4* bs =
          reinterpret_cast<const float4*>(st + kk * kStepFloats + wn * (kStepFloats / 2)) + lane;
#pragma unroll
      for (int pq = 0; pq < 4; ++pq) {
        const float4 v = bs[pq * 32];
        uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
        split_tf32(v.x, h0, l0);
        split_tf32(v.y, h1, l1);
        split_tf32(v.z, h2, l2);
        split_tf32(v.w, h3, l3);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_3xtf32(acc[mt][2 * pq], ah[mt], al[mt], h0, h1, l0, l1);
          mma_3xtf32(acc[mt][2 * pq + 1], ah[mt], al[mt], h2, h3, l2, l3);
        }
      }
    }

    if (j == chunks_per_pass - 1) {
      // power of this pass's bins
      const int pb = (q / chunks_per_pass) * kPassBins;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wm * 32 + mt * 16 + g;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float pw[4];
#pragma unroll
          for (int v = 0; v < 4; ++v)
            pw[v] = acc[mt][i][v] * acc[mt][i][v] + acc[mt][4 + i][v] * acc[mt][4 + i][v];
          float* p0 = power + row * kPowStride + wn * 32 + i * 8 + 2 * c;
          p0[0] = pw[0];
          p0[1] = pw[1];
          p0[8 * kPowStride] = pw[2];
          p0[8 * kPowStride + 1] = pw[3];
        }
      }
      __syncthreads();
      // mel energies: lanes take frames and a warp walks bands (warps 0-1
      // the even ones, 2-3 the odd), so every lane of a warp runs the same
      // bins; each band sums only its nonzero bins of this pass
      const int f = tid & (kFrames - 1);
      const float* pw = power + f * kPowStride - pb;
      for (int m = tid / kFrames; m < a.n_mel; m += kThreads / kFrames) {
        const int lo = max(band[m], pb);
        const int hi = min(band[a.n_mel + m], pb + kPassBins);
        const float* w = mel_w + band[2 * a.n_mel + m] - band[m];  // w[cc]: bin cc's weight
        float s = 0.f;
#pragma unroll 4
        for (int cc = lo; cc < hi; ++cc) s += pw[cc] * w[cc];
        melacc[f * ms + m] += s;
      }
    }
  }
  __syncthreads();
  // the DCT and lifter into the ring, which the spectrum no longer reads
  float* dct = ring;
  float* lift = ring + a.n_mel * a.n_ceps;
  for (int i = tid; i < a.n_mel * a.n_ceps; i += kThreads) cp_async4(dct + i, a.dct + i);
  for (int i = tid; i < a.n_ceps; i += kThreads) cp_async4(lift + i, a.lift + i);
  cp_async_commit();

  // 5. log mel
  for (int i = tid; i < kFrames * ms; i += kThreads) melacc[i] = logf(fmaxf(melacc[i], kFltMin));
  cp_async_wait<0>();
  __syncthreads();

  // 6. DCT, lifter, energy C0 (lanes take frames, a warp walks
  //    coefficients) into the free power tile; then out, coalesced, with
  //    frames past the utterance zero
  {
    const int f = tid & (kFrames - 1);
    const int cs = a.n_ceps | 1;
    const float* lm = melacc + f * ms;
    for (int cc = tid / kFrames; cc < a.n_ceps; cc += kThreads / kFrames) {
      float v;
      if (a.use_energy && cc == 0) {
        v = log_e[f];
      } else {
        float s[4] = {0.f, 0.f, 0.f, 0.f};  // four independent chains
        int m = 0;
        for (; m + 4 <= a.n_mel; m += 4) {
#pragma unroll
          for (int i = 0; i < 4; ++i) s[i] += lm[m + i] * dct[(m + i) * a.n_ceps + cc];
        }
        for (; m < a.n_mel; ++m) s[0] += lm[m] * dct[m * a.n_ceps + cc];
        v = ((s[0] + s[1]) + (s[2] + s[3])) * lift[cc];
      }
      power[f * cs + cc] = v;
    }
    __syncthreads();
    for (int o = tid; o < n_out * a.n_ceps; o += kThreads) {
      const int fo = o / a.n_ceps, cc = o - fo * a.n_ceps;
      out[o] = f0 + fo < t_valid ? power[fo * cs + cc] : 0.f;
    }
  }
}

}  // namespace

extern "C" int sepi_mfcc_fused(
    const float* x, const int* lengths, const int* seeds, const float* basis,
    const float* mel_w, const int* mel_lo, const int* mel_hi, const int* mel_off,
    const float* dct, const float* lift, float* out, uint8_t* mask, int batch, int n, int t,
    int flen, int shift, int pad_l, int km, int n_mel, int n_ceps, int mel_nnz, int ksteps,
    int n_fix, int snip,
    int use_energy, int remove_dc, int has_floor, float log_floor, float dither,
    int dithered, void* stream) {
  if (batch <= 0 || t <= 0 || batch > 65535 || km % kPassBins != 0 || flen <= 0 ||
      shift < 8 || ksteps % kStepsPerStage != 0 || ksteps * 8 < flen || n_fix < 1 ||
      n_fix > t || ((uintptr_t)basis & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.x = x; a.lengths = lengths; a.seeds = seeds; a.basis = basis; a.mel_w = mel_w;
  a.mel_lo = mel_lo; a.mel_hi = mel_hi; a.mel_off = mel_off; a.dct = dct; a.lift = lift;
  a.out = out; a.mel_nnz = mel_nnz;
  a.mask = mask;
  a.n = n; a.t = t; a.flen = flen; a.shift = shift; a.pad_l = pad_l; a.km = km;
  a.n_mel = n_mel; a.n_ceps = n_ceps; a.ksteps = ksteps; a.n_fix = n_fix; a.snip = snip;
  a.use_energy = use_energy; a.remove_dc = remove_dc; a.has_floor = has_floor;
  a.dithered = dithered; a.log_floor = log_floor; a.dither = dither;
  // row stride = 4 mod 8 words: 8 consecutive rows start in 8 distinct bank quads
  a.sp = shift + ((4 - shift % 8) + 8) % 8;
  const int k_rows = (ksteps * 8 + shift - 1) / shift;  // rows a frame's k-steps touch
  a.span_rows = kFrames + k_rows;
  a.tail_rows = k_rows;
  // the ring and the power tile grow past their spectral sizes only where
  // the DCT (n_mel x n_ceps) or a frame's cepstra outgrow them (80 x 80)
  const int dct_floats = (n_mel * n_ceps + n_ceps + 3) / 4 * 4;  // the span 16-byte aligned
  a.ring_floats = dct_floats > kStages * kStageFloats ? dct_floats : kStages * kStageFloats;
  a.pow_stride = (n_ceps | 1) > kPowStride ? (n_ceps | 1) : kPowStride;
  const size_t floats = (size_t)a.ring_floats + (size_t)a.span_rows * a.sp +
                        (size_t)n_fix * a.tail_rows * a.sp + (size_t)kFrames * a.pow_stride +
                        (size_t)kFrames * (n_mel | 1) + kFrames + mel_nnz + 3 * (size_t)n_mel;
  const size_t smem = floats * sizeof(float);
  // a per-device attribute, raised on a card the first time a launch needs
  // more: a launch recorded into a CUDA graph after one eager launch of the
  // same config makes no call besides the kernel's
  static int smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices || (int)smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(mfcc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < kMaxDevices) smem_set[dev] = (int)smem;
  }
  dim3 grid((t + kFrames - 1) / kFrames, batch);
  mfcc_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
