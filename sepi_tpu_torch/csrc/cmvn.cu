// Sliding-window CMVN for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces no Pallas kernel: the JAX package's `sepi_tpu/ops/cmvn.py:sliding_cmvn`
// is plain jnp (a blocked triangular-matmul prefix sum).  The port ran it as
// `torch.cumsum` along the frame axis of (B, T, D) plus about fourteen small
// passes; ATen scans a non-innermost axis with one thread per (utterance,
// column) walking all T frames in order, so a verification request (1 x <= 6,600
// x 23) got 23 threads and paid one memory latency a frame.  This file computes
// the same function (Kaldi `apply-cmvn-sliding`, ops/cmvn.py
// `sliding_cmvn_reference`) in three launches, each parallel over (utterance,
// frame tile, column):
//
//   out[t] = (x[t] - S1(t) / win) [* rsqrt(max(S2(t) / win - mean^2, 1e-10))], 0 off the mask
//
// with x the masked features, n the mask's count, win = clamp(n, 1, w), P the
// exclusive prefix sum of x over frames, c = w - w/2 (centred) or 1, and S(t)
//   - P[win] where n <= w or t + c < w (the left edge),
//   - else P[n] - P[n - w] where t + c > n (the right edge),
//   - else P[t + c] - P[t + c - w] (the interior: a window of exactly w frames,
//     never clipped, since there t + c - w >= 0 and t + c <= n).
// A masked frame counts as zero whatever its stored value.
//
// What bounds it on this card.  Bytes: the features in and the output out once
// (plus one mask byte a frame), 8 bytes a value: 1 x 6,600 x 23 is 1.2 MB, 0.36
// us at 3.35 TB/s; 16 x 32,100 x 23 is 95 MB, 28 us.  Operations are a few a
// value.  So the design keeps the passes over the features few and parallel:
// 1. `tile_sums`: each block reads 64 frames x 32 columns once and writes the
//    column sums of its two 32-frame tiles, in double, and each tile's mask count.
// 2. `tile_scan`: a block per (utterance, 32 columns) turns the tile sums into
//    exclusive tile prefixes in place (double, so P[a] - P[b] of two far tiles
//    loses nothing to cancellation), adds the utterance's total, counts n and
//    writes the two edge rows' sums (each P[k] its tile prefix plus < 32 frames,
//    summed across a warp by shuffles).
// 3. `normalize`: a block per (64 frames, utterance, 32 columns).  Frames of
//    its tile in the interior need P at [t + c] and [t + c - w]: the block
//    scans the two frame windows that hold those indices (each from the 32-frame
//    tile boundary at or below its first index, at most 95 frames) into shared
//    memory, 8 row lanes per column each scanning a contiguous run, so
//    S1(t) = (tile prefix difference, double) + (window scan difference, float).
//    Then it writes every frame of its tile, reading the edge rows elsewhere.
//    A tile with no interior frame (every frame where n <= w, as at a
//    10,000-frame window over short utterances, or padding past n) scans
//    nothing; a masked frame of the tile reads no feature.  For w of a few
//    hundred the two windows overlap the neighbouring tiles' and are read
//    from L2.
// A lane issues its loads together (masks read at clamped rows, so no branch
// guards a load, then the features under them).  Measured on an H100, 64-frame
// tiles beat 128 and 256 (shorter windows, more blocks), and register or
// cp.async staging of both windows at once lost to the occupancy it cost
// (PERF.md, Findings).
// No loop over T is serial in any column: the longest serial run is one lane's
// share of a window (12 frames) or of the tile prefixes (ceil(T / 1024) tiles).
// The kernels allocate nothing; the wrapper hands in the scratch: the tile
// prefixes (B, ceil(T/32) + 1, D) in double (one array more with
// normalize_variance), the counts (B, ceil(T/32) + 1) and the edge rows (B, 4, D).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                  // frames a tile prefix covers
constexpr int kRows = 64;                  // frames a block of tile_sums / normalize covers
constexpr int kCols = 32;                  // columns a block covers, one lane each
constexpr int kLanes = 8;                  // row lanes of tile_sums / normalize
constexpr int kScanLanes = 32;             // row lanes of tile_scan
constexpr int kSpan = kRows + kTile;       // rows of a window's exclusive scan (<= kRows + kTile - 1 used)
constexpr int kSubTiles = kRows / kTile;   // tiles a tile_sums block writes
constexpr int kPerLane = kRows / kLanes;   // frames a lane of tile_sums / normalize covers
constexpr int kRun = (kSpan - 1 + kLanes - 1) / kLanes;  // most frames a lane scans of one window
constexpr int kBatch = 8;                  // tile prefixes a lane of tile_scan reads at once
constexpr int kMaxDevices = 64;            // cards whose shared-memory attribute is tracked
constexpr float kVarFloor = 1e-10f;

static_assert(kRows % kTile == 0 && kPerLane % kSubTiles == 0, "a lane's rows split evenly by tile");
static_assert(kTile == 32 && kCols == 32 && kScanLanes == kCols,
              "tile_scan's edge rows: a warp per column of the block, a lane per frame of a tile");

struct Args {
  const float* x;       // (B, T, D)
  const uint8_t* mask;  // (B, T)
  float* out;           // (B, T, D)
  double* tp1;          // (B, ntiles + 1, D): tile sums, then exclusive tile prefixes
  double* tp2;          // the same of x^2 (normalize_variance only)
  int* cnt;             // (B, ntiles + 1): tile mask counts; [ntiles] = n after tile_scan
  float* edges;         // (B, 4, D): left S1, right S1, left S2, right S2
  int b, t, d, w, ntiles, c, nv;
};

__device__ __forceinline__ size_t row_of(const Args& a, int b, int t) {
  return ((size_t)b * a.t + t) * a.d;
}

__device__ __forceinline__ size_t tile_of(const Args& a, int b, int j) {
  return ((size_t)b * (a.ntiles + 1) + j) * a.d;
}

// Frame t's mask, read at a row clamped into [0, T) so that the load needs
// no branch and every load of an unrolled loop is in flight at once.
__device__ __forceinline__ bool valid(const Args& a, int b, int t) {
  return (a.mask[(size_t)b * a.t + min(max(t, 0), a.t - 1)] != 0) & (t >= 0) & (t < a.t);
}

// Pass 1: column sums of each 32-frame tile (and of squares), mask counts.
// A lane's 16 masks are loaded together, then its features under them.
__global__ void __launch_bounds__(kCols * kLanes) tile_sums(Args a) {
  __shared__ float red1[kLanes][kSubTiles][kCols];
  __shared__ float red2[kLanes][kSubTiles][kCols];
  __shared__ int redn[kLanes][kSubTiles];
  const int dx = threadIdx.x, ry = threadIdx.y;
  const int b = blockIdx.y, col = blockIdx.z * kCols + dx;
  const int r0 = blockIdx.x * kRows;
  const bool live = col < a.d;
  bool m[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) m[i] = valid(a, b, r0 + ry + kLanes * i);
  float v[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
    v[i] = m[i] && live ? a.x[row_of(a, b, r0 + ry + kLanes * i) + col] : 0.f;
  // row r0 + ry + 8i lies in tile i / 4 of the block
#pragma unroll
  for (int k = 0; k < kSubTiles; ++k) {
    float s1 = 0.f, s2 = 0.f;
    int sn = 0;
#pragma unroll
    for (int i = k * (kPerLane / kSubTiles); i < (k + 1) * (kPerLane / kSubTiles); ++i) {
      s1 += v[i];
      s2 += v[i] * v[i];
      sn += m[i];
    }
    red1[ry][k][dx] = s1;
    red2[ry][k][dx] = s2;
    if (dx == 0) redn[ry][k] = sn;
  }
  __syncthreads();
  // lane ry < kSubTiles finishes tile ry of the block
  if (ry < kSubTiles) {
    const int j = blockIdx.x * kSubTiles + ry;
    if (j < a.ntiles) {
      float t1 = 0.f, t2 = 0.f;
      int tn = 0;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        t1 += red1[l][ry][dx];
        t2 += red2[l][ry][dx];
        tn += redn[l][ry];
      }
      if (live) {
        a.tp1[tile_of(a, b, j) + col] = (double)t1;
        if (a.nv) a.tp2[tile_of(a, b, j) + col] = (double)t2;
      }
      if (dx == 0 && blockIdx.z == 0) a.cnt[(size_t)b * (a.ntiles + 1) + j] = tn;
    }
  }
}

// Pass 2: exclusive tile prefixes in place, n, and the edge rows.  Lane ry
// of a column takes a contiguous run of tiles, read and rewritten kBatch
// tiles at a time (the reads of a batch in flight together).
__global__ void __launch_bounds__(kCols * kScanLanes) tile_scan(Args a) {
  __shared__ double tot[2][kScanLanes][kCols + 1];
  __shared__ int totn[kScanLanes];
  const int dx = threadIdx.x, ry = threadIdx.y;
  const int b = blockIdx.x, col = blockIdx.y * kCols + dx;
  const int ccol = min(col, a.d - 1);  // a column to read where col is past D
  const bool live = col < a.d;
  const int per = (a.ntiles + kScanLanes - 1) / kScanLanes;
  const int j0 = ry * per, j1 = min(j0 + per, a.ntiles);
  double run1 = 0.0, run2 = 0.0;
  int runn = 0;
  for (int j = j0; j < j1; j += kBatch) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int jj = min(j + u, j1 - 1);
      const bool in = j + u < j1;
      const double v1 = a.tp1[tile_of(a, b, jj) + ccol];
      const double v2 = a.nv ? a.tp2[tile_of(a, b, jj) + ccol] : 0.0;
      const int vn = a.cnt[(size_t)b * (a.ntiles + 1) + jj];
      run1 += in ? v1 : 0.0;
      run2 += in ? v2 : 0.0;
      runn += in ? vn : 0;
    }
  }
  tot[0][ry][dx] = run1;
  tot[1][ry][dx] = run2;
  if (dx == 0) totn[ry] = runn;
  __syncthreads();
  double off1 = 0.0, off2 = 0.0;
  int n = 0;
#pragma unroll
  for (int l = 0; l < kScanLanes; ++l) {
    if (l < ry) off1 += tot[0][l][dx], off2 += tot[1][l][dx];
    n += totn[l];
  }
  if (live) {
    for (int j = j0; j < j1; j += kBatch) {
      double v1[kBatch], v2[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const size_t o = tile_of(a, b, min(j + u, j1 - 1)) + col;
        v1[u] = a.tp1[o];
        v2[u] = a.nv ? a.tp2[o] : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j + u < j1) {
          const size_t o = tile_of(a, b, j + u) + col;
          a.tp1[o] = off1;
          off1 += v1[u];
          if (a.nv) {
            a.tp2[o] = off2;
            off2 += v2[u];
          }
        }
      }
    }
    if (ry == kScanLanes - 1) {  // the last lane's running offset is the total
      a.tp1[tile_of(a, b, a.ntiles) + col] = off1;
      if (a.nv) a.tp2[tile_of(a, b, a.ntiles) + col] = off2;
    }
  }
  if (dx == 0 && ry == 0 && blockIdx.y == 0) a.cnt[(size_t)b * (a.ntiles + 1) + a.ntiles] = n;
  // The edge rows: P[k] = tp[k / 32] + the frames of k's tile below k, at
  // k = win, n and n - win.  Here warp ry takes column ry of the block and
  // lane dx frame dx of each tile, so a shuffle sums the frames.  The
  // frames are read before the barrier, the prefixes after it.
  const int ecol = blockIdx.y * kCols + ry;
  const int win = min(max(n, 1), a.w);
  const int pts[3] = {win, n, max(n - win, 0)};
  bool m[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const int j = pts[p] / kTile * kTile + dx;
    m[p] = valid(a, b, j) & (j < pts[p]);
  }
  float v[3];
#pragma unroll
  for (int p = 0; p < 3; ++p)
    v[p] = m[p] && ecol < a.d ? a.x[row_of(a, b, pts[p] / kTile * kTile + dx) + ecol] : 0.f;
  __syncthreads();  // the prefixes written above are read back below
  for (int q = 0; q < (a.nv ? 2 : 1); ++q) {
    const double* tp = q ? a.tp2 : a.tp1;
    double s[3];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      s[p] = q ? (double)v[p] * v[p] : (double)v[p];
#pragma unroll
      for (int o = kTile / 2; o > 0; o >>= 1) s[p] += __shfl_xor_sync(0xffffffffu, s[p], o);
    }
    if (dx == 0 && ecol < a.d) {
#pragma unroll
      for (int p = 0; p < 3; ++p) s[p] += tp[tile_of(a, b, pts[p] / kTile) + ecol];
      float* e = a.edges + ((size_t)b * 4 + 2 * q) * a.d + ecol;
      e[0] = (float)s[0];
      e[a.d] = (float)(s[1] - s[2]);
    }
  }
}

// One row lane's run of a window's exclusive scan: frames f0 + [i0, i1) of
// column col, masked, into sc[1 + i] (and their squares into sq); returns the
// run's totals through t1 and t2.  The run's masks, then its features, are
// loaded together into registers before the sums.
__device__ __forceinline__ void scan_run(const Args& a, int b, int col, int f0, int rows,
                                         float* sc, float* sq, float& t1, float& t2) {
  const int dx = threadIdx.x, ry = threadIdx.y;
  const int per = (rows + kLanes - 1) / kLanes;
  const int i0 = ry * per, i1 = min(i0 + per, rows);
  bool m[kRun];
  float v[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) m[i] = valid(a, b, f0 + i0 + i) & (i0 + i < i1);
#pragma unroll
  for (int i = 0; i < kRun; ++i) v[i] = m[i] && col < a.d ? a.x[row_of(a, b, f0 + i0 + i) + col] : 0.f;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    if (i0 + i >= i1) break;
    s1 += v[i];
    s2 += v[i] * v[i];
    sc[(i0 + i + 1) * kCols + dx] = s1;
    if (a.nv) sq[(i0 + i + 1) * kCols + dx] = s2;
  }
  t1 = s1;
  t2 = s2;
}

// Add the lanes below ry's totals to ry's run of a window scan of `rows` frames.
__device__ __forceinline__ void offset_run(const Args& a, int rows, float* sc, float* sq,
                                           const float* tot1, const float* tot2) {
  const int dx = threadIdx.x, ry = threadIdx.y;
  const int per = (rows + kLanes - 1) / kLanes;
  const int i0 = ry * per, i1 = min(i0 + per, rows);
  float o1 = 0.f, o2 = 0.f;
  for (int l = 0; l < ry; ++l) o1 += tot1[l * kCols + dx], o2 += tot2[l * kCols + dx];
  for (int i = i0; i < i1; ++i) {
    sc[(i + 1) * kCols + dx] += o1;
    if (a.nv) sq[(i + 1) * kCols + dx] += o2;
  }
  if (ry == 0) {
    sc[dx] = 0.f;
    if (a.nv) sq[dx] = 0.f;
  }
}

// Pass 3: the normalized frames of one 64-frame tile and 32 columns.
// Dynamic shared memory: the hi and lo windows' scans (kSpan x kCols floats
// each), their squares' with normalize_variance, then the lanes' run totals.
__global__ void __launch_bounds__(kCols * kLanes) normalize(Args a) {
  extern __shared__ float smem[];
  const int dx = threadIdx.x, ry = threadIdx.y;
  const int b = blockIdx.y, col = blockIdx.z * kCols + dx;
  const bool live = col < a.d;
  const int t0 = blockIdx.x * kRows, t1 = min(t0 + kRows, a.t);
  const int n = a.cnt[(size_t)b * (a.ntiles + 1) + a.ntiles];
  const int win = min(max(n, 1), a.w);
  const float winf = (float)win;
  // interior frames: n > w and w - c <= t <= n - c
  const int ia = max(t0, a.w - a.c);
  const int ib = n > a.w ? min(t1, n - a.c + 1) : ia;
  float* hi1 = smem;
  float* lo1 = hi1 + kSpan * kCols;
  float* hi2 = lo1 + kSpan * kCols;
  float* lo2 = a.nv ? hi2 + kSpan * kCols : hi2;
  float* tot = a.nv ? lo2 + kSpan * kCols : hi2;  // [4][kLanes][kCols]
  int ah = 0, al = 0;
  float base1 = 0.f, base2 = 0.f;
  if (ia < ib) {  // the same for every thread of the block
    // the windows: frames [ah, ah + nh) and [al, al + nl), from the tile
    // boundaries at or below ia + c and ia + c - w
    ah = (ia + a.c) / kTile * kTile;
    al = (ia + a.c - a.w) / kTile * kTile;
    const int nh = ib - 1 + a.c - ah, nl = ib - 1 + a.c - a.w - al;
    float h1, h2, l1, l2;
    scan_run(a, b, col, ah, nh, hi1, hi2, h1, h2);
    scan_run(a, b, col, al, nl, lo1, lo2, l1, l2);
    tot[(0 * kLanes + ry) * kCols + dx] = h1;
    tot[(1 * kLanes + ry) * kCols + dx] = h2;
    tot[(2 * kLanes + ry) * kCols + dx] = l1;
    tot[(3 * kLanes + ry) * kCols + dx] = l2;
    __syncthreads();
    offset_run(a, nh, hi1, hi2, tot, tot + kLanes * kCols);
    offset_run(a, nl, lo1, lo2, tot + 2 * kLanes * kCols, tot + 3 * kLanes * kCols);
    __syncthreads();
    if (live) {
      base1 = (float)(a.tp1[tile_of(a, b, ah / kTile) + col] - a.tp1[tile_of(a, b, al / kTile) + col]);
      if (a.nv)
        base2 = (float)(a.tp2[tile_of(a, b, ah / kTile) + col] - a.tp2[tile_of(a, b, al / kTile) + col]);
    }
  }
  if (!live) return;
  const float* e = a.edges + (size_t)b * 4 * a.d + col;
  const float left1 = e[0], right1 = e[a.d];
  const float left2 = a.nv ? e[2 * a.d] : 0.f, right2 = a.nv ? e[3 * a.d] : 0.f;
  // the tile's masks, then its features under them (a masked frame reads none)
  bool m[kPerLane];
  float f[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int t = t0 + ry + kLanes * i;
    m[i] = valid(a, b, t) & (t < t1);
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) f[i] = m[i] ? a.x[row_of(a, b, t0 + ry + kLanes * i) + col] : 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int t = t0 + ry + kLanes * i;
    if (t >= t1) break;
    float v = 0.f;
    if (m[i]) {
      float s1, s2;
      if (t >= ia && t < ib) {
        const int kh = t + a.c - ah, kl = t + a.c - a.w - al;
        s1 = base1 + (hi1[kh * kCols + dx] - lo1[kl * kCols + dx]);
        s2 = a.nv ? base2 + (hi2[kh * kCols + dx] - lo2[kl * kCols + dx]) : 0.f;
      } else if (n <= a.w || t + a.c < a.w) {
        s1 = left1, s2 = left2;
      } else {
        s1 = right1, s2 = right2;
      }
      const float mean = s1 / winf;
      v = f[i] - mean;
      // unfused, as the plain version rounds the quotient and the square apart
      if (a.nv) v *= rsqrtf(fmaxf(__fsub_rn(s2 / winf, __fmul_rn(mean, mean)), kVarFloor));
    }
    a.out[row_of(a, b, t) + col] = v;
  }
}

}  // namespace

extern "C" int sepi_sliding_cmvn(const float* x, const uint8_t* mask, float* out, double* tp1,
                                 double* tp2, int* cnt, float* edges, int batch, int t, int d,
                                 int w, int center, int nv, void* stream) {
  const int ntiles = (t + kTile - 1) / kTile;
  const int groups = (d + kCols - 1) / kCols;
  if (batch <= 0 || batch > 65535 || t <= 0 || d <= 0 || groups > 65535 || w < 1 ||
      (nv && tp2 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.x = x; a.mask = mask; a.out = out; a.tp1 = tp1; a.tp2 = tp2; a.cnt = cnt; a.edges = edges;
  a.b = batch; a.t = t; a.d = d; a.w = w; a.ntiles = ntiles; a.nv = nv;
  a.c = center ? w - w / 2 : 1;
  const int windows = nv ? 4 : 2;
  const size_t smem = ((size_t)windows * kSpan * kCols + 4 * kLanes * kCols) * sizeof(float);
  // a per-device attribute, raised on a card the first time a launch needs
  // more: a launch recorded into a CUDA graph after one eager launch of the
  // same config makes no call besides the kernels'
  static int smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices || (int)smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(normalize, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < kMaxDevices) smem_set[dev] = (int)smem;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 lanes(kCols, kLanes);
  tile_sums<<<dim3((t + kRows - 1) / kRows, batch, groups), lanes, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_scan<<<dim3(batch, groups), dim3(kCols, kScanLanes), 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  normalize<<<dim3((t + kRows - 1) / kRows, batch, groups), lanes, smem, s>>>(a);
  return (int)cudaGetLastError();
}
