// Fused Kaldi MFCC for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `mfcc_fused` (sepi_tpu/ops/mfcc_pallas.py,
// kernel body `_kernel`): batched MFCC from raw samples, framing, dither,
// DFT, power, mel, log, DCT, lifter and raw-energy C0 in one pass, with no
// frames tensor in device memory.  The wrapper (ops/mfcc_cuda.py) pads
// nothing: the left mirror is read here; it recomputes the few tail frames
// whose window crosses each utterance's end and applies the mask.
//
// What bounds it on this card: operations.  2*(flen*2K + K*M + M*C) flops
// per frame against 4*shift bytes of input per frame: at the SRE geometry
// (200-sample frames, 256 basis columns, 23 mel, 23 ceps) that is ~110
// kflop for 320 bytes, far above the fp32 ridge.  Design: one block per
// (utterance, 64 frames).  The block stages its signal span (64 frames
// plus the overlap, ~21 KB) once in shared memory, with the dither added
// there, and streams the basis through shared memory in slabs of rows.
// Each thread holds a 4-frame x 8-bin register tile of the real and
// imaginary spectrum (64 fp32 accumulators), so each shared-memory load
// feeds several FMAs.  The mel stage walks only each band's nonzero bins.
// Everything is fp32 on the CUDA cores: no TF32, no bf16.
//
// Dither (bit-compatible with the TPU kernel): the noise field is tied to
// the reference's 256-frame tiles.  For frames of tile tau, padded sample
// position p = frame*shift + n lies at row r = p/shift - tau*256 of a
// (256 + extra)-row map, column p % shift.  Rows r < half take r_mag*cos at
// cell r*shift + col, rows r >= half take r_mag*sin at cell
// (r - half)*shift + col, all keyed by fmix32(seed ^ tau*0x9E3779B9).  A
// block's 64 frames lie in one tile, so each span sample has one noise value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 64;        // frames per block
constexpr int kNoiseTile = 256;    // frame tile of the reference noise map
constexpr int kBinsPerPass = 128;  // 16 bin groups x 8 bins
constexpr int kSlabRows = 8;       // basis rows per shared-memory slab
constexpr int kPowStride = kBinsPerPass + 1;
constexpr float kFltMin = 1.17549435082228750797e-38f;
constexpr float kInv224 = 5.9604644775390625e-08f;  // 2^-24
// 2*pi*2^-24, rounded to float once as the reference applies it
constexpr float kAngScale = (float)(6.283185307179586 * 5.9604644775390625e-08);

static_assert(kNoiseTile % kFrames == 0, "a block must lie in one noise tile");
static_assert(kFrames == 64 && kThreads == 256, "thread map is 16 x 16");

struct Args {
  const float* x;        // (B, N) samples
  const int* t_valid;    // (B,) valid frames per utterance
  const int* seeds;      // (B,) dither seeds (unused when !dithered)
  const float* basis;    // (flen, 2K) fused DFT basis, DC bin dropped
  const float* mel;      // (K, M)
  const int* mel_lo;     // (M,) first nonzero row of each band
  const int* mel_hi;     // (M,) one past the last nonzero row
  const float* dct;      // (M, C)
  const float* lift;     // (C,)
  float* out;            // (B, T, C)
  int n, t, flen, shift, pad_l, km, n_mel, n_ceps;
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

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

__host__ __device__ __forceinline__ int span_len(int flen, int shift) {
  return (kFrames + (flen + shift - 1) / shift) * shift;
}

__global__ void __launch_bounds__(kThreads, 2) mfcc_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;
  const int t_valid = min(a.t_valid[b], a.t);
  const int n_out = min(kFrames, a.t - f0);
  float* out = a.out + ((size_t)b * a.t + f0) * a.n_ceps;

  if (f0 >= t_valid) {  // the whole block is masked
    for (int i = tid; i < n_out * a.n_ceps; i += kThreads) out[i] = 0.f;
    return;
  }

  const int extra = (a.flen + a.shift - 1) / a.shift;
  const int slen = span_len(a.flen, a.shift);
  float* span = smem;                                   // slen
  float* slab = span + round4(slen);                    // kSlabRows x 2*kBinsPerPass
  float* power = slab + kSlabRows * 2 * kBinsPerPass;   // kFrames x kPowStride
  float* melacc = power + kFrames * kPowStride;         // kFrames x n_mel
  float* log_e = melacc + kFrames * a.n_mel;            // kFrames

  // 1. the block's signal span: [left mirror | samples | zeros] + dither
  const float* xb = a.x + (size_t)b * a.n;
  const long long base = (long long)f0 * a.shift;
  uint32_t tseed = 0;
  int r0 = 0, half = 0;
  uint32_t span_n = 0;
  if (a.dithered) {
    const uint32_t tau = (uint32_t)(f0 / kNoiseTile);
    tseed = fmix32((uint32_t)a.seeds[b] ^ (tau * 0x9E3779B9u));
    r0 = f0 % kNoiseTile;
    half = (kNoiseTile + extra + 1) / 2;
    span_n = (uint32_t)(half * a.shift);
  }
  for (int s = tid; s < slen; s += kThreads) {
    const long long q = base + s;
    float v = 0.f;
    if (q < a.pad_l) {
      v = xb[a.pad_l - 1 - q];
    } else if (q - a.pad_l < a.n) {
      v = xb[q - a.pad_l];
    }
    if (a.dithered) {
      const int r = r0 + s / a.shift;
      const int col = s - (s / a.shift) * a.shift;
      const bool second = r >= half;
      const uint32_t cell = (uint32_t)((second ? r - half : r) * a.shift + col);
      const float u1 = (u24(tseed, cell) + 1.0f) * kInv224;
      const float ang = kAngScale * u24(tseed, cell + span_n);
      const float rm = sqrtf(-2.0f * logf(u1));
      v = v + a.dither * (rm * (second ? sinf(ang) : cosf(ang)));
    }
    span[s] = v;
  }
  for (int i = tid; i < kFrames * a.n_mel; i += kThreads) melacc[i] = 0.f;
  __syncthreads();

  // 2. raw frame energy: 4 lanes per frame, then a shuffle reduction
  if (a.use_energy) {
    const int f = tid >> 2, part = tid & 3;
    const float* fr = span + f * a.shift;
    float s1 = 0.f, s2 = 0.f;
    for (int i = part; i < a.flen; i += 4) {
      const float v = fr[i];
      s1 += v;
      s2 += v * v;
    }
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
    if (part == 0) {
      const float e = a.remove_dc ? s2 - s1 * s1 / (float)a.flen : s2;
      float le = logf(fmaxf(e, kFltMin));
      if (a.has_floor) le = fmaxf(le, a.log_floor);
      log_e[f] = le;
    }
  }

  // 3. spectrum, one pass per 128 bins: thread (fg, bg) owns frames
  //    fg + 16q (q < 4) and bins bg*4 + j, 64 + bg*4 + j (j < 4)
  const int bg = tid & 15, fg = tid >> 4;
  for (int bp = 0; bp < a.km; bp += kBinsPerPass) {
    float re[4][8], im[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        re[q][j] = 0.f;
        im[q][j] = 0.f;
      }
    }
    for (int k0 = 0; k0 < a.flen; k0 += kSlabRows) {
      const int rows = min(kSlabRows, a.flen - k0);
      __syncthreads();  // the previous slab (and pass) is consumed
      for (int i = tid; i < rows * 64; i += kThreads) {
        const int rr = i >> 6, c4 = i & 63;  // 64 float4 per row: 32 re, 32 im
        const int col = c4 < 32 ? bp + c4 * 4 : a.km + bp + (c4 - 32) * 4;
        reinterpret_cast<float4*>(slab)[i] = __ldg(reinterpret_cast<const float4*>(
            a.basis + (size_t)(k0 + rr) * 2 * a.km + col));
      }
      __syncthreads();
      for (int kk = 0; kk < rows; ++kk) {
        const int n = k0 + kk;
        float xv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = span[(fg + 16 * q) * a.shift + n];
        const float4* srow = reinterpret_cast<const float4*>(slab + kk * 2 * kBinsPerPass);
        const float4 ra = srow[bg], rb = srow[16 + bg], ia = srow[32 + bg], ib = srow[48 + bg];
        const float rv[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
        const float iv[8] = {ia.x, ia.y, ia.z, ia.w, ib.x, ib.y, ib.z, ib.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            re[q][j] += xv[q] * rv[j];
            im[q][j] += xv[q] * iv[j];
          }
        }
      }
    }
    // power of this pass's bins
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float* prow = power + (fg + 16 * q) * kPowStride;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        prow[bg * 4 + j] = re[q][j] * re[q][j] + im[q][j] * im[q][j];
        prow[64 + bg * 4 + j] = re[q][4 + j] * re[q][4 + j] + im[q][4 + j] * im[q][4 + j];
      }
    }
    __syncthreads();
    // mel energies: each band sums only its nonzero bins of this pass
    for (int o = tid; o < kFrames * a.n_mel; o += kThreads) {
      const int f = o / a.n_mel, m = o - f * a.n_mel;
      const int lo = max(__ldg(a.mel_lo + m), bp);
      const int hi = min(__ldg(a.mel_hi + m), bp + kBinsPerPass);
      float acc = 0.f;
      for (int c = lo; c < hi; ++c)
        acc += power[f * kPowStride + (c - bp)] * __ldg(a.mel + (size_t)c * a.n_mel + m);
      melacc[o] += acc;
    }
  }
  __syncthreads();

  // 4. log mel
  for (int i = tid; i < kFrames * a.n_mel; i += kThreads)
    melacc[i] = logf(fmaxf(melacc[i], kFltMin));
  __syncthreads();

  // 5. DCT, lifter, energy C0; frames past the utterance are zero
  for (int o = tid; o < n_out * a.n_ceps; o += kThreads) {
    const int f = o / a.n_ceps, c = o - f * a.n_ceps;
    float v;
    if (a.use_energy && c == 0) {
      v = log_e[f];
    } else {
      float acc = 0.f;
      for (int m = 0; m < a.n_mel; ++m)
        acc += melacc[f * a.n_mel + m] * __ldg(a.dct + m * a.n_ceps + c);
      v = acc * __ldg(a.lift + c);
    }
    out[o] = f0 + f < t_valid ? v : 0.f;
  }
}

}  // namespace

extern "C" int sepi_mfcc_fused(
    const float* x, const int* t_valid, const int* seeds, const float* basis,
    const float* mel, const int* mel_lo, const int* mel_hi, const float* dct,
    const float* lift, float* out, int batch, int n, int t, int flen, int shift,
    int pad_l, int km, int n_mel, int n_ceps, int use_energy, int remove_dc,
    int has_floor, float log_floor, float dither, int dithered, void* stream) {
  if (batch <= 0 || t <= 0 || batch > 65535 || km % kBinsPerPass != 0 ||
      flen <= 0 || shift <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.x = x; a.t_valid = t_valid; a.seeds = seeds; a.basis = basis; a.mel = mel;
  a.mel_lo = mel_lo; a.mel_hi = mel_hi; a.dct = dct; a.lift = lift; a.out = out;
  a.n = n; a.t = t; a.flen = flen; a.shift = shift; a.pad_l = pad_l; a.km = km;
  a.n_mel = n_mel; a.n_ceps = n_ceps; a.use_energy = use_energy;
  a.remove_dc = remove_dc; a.has_floor = has_floor; a.dithered = dithered;
  a.log_floor = log_floor; a.dither = dither;
  const size_t floats = (size_t)round4(span_len(flen, shift)) +
                        kSlabRows * 2 * kBinsPerPass + kFrames * kPowStride +
                        (size_t)kFrames * n_mel + kFrames;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mfcc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + kFrames - 1) / kFrames, batch);
  mfcc_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
