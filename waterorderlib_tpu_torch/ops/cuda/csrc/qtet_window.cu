// q_tet over a column window: the Hopper (sm_90a) kernel of the port.
//
// Replaces the Pallas TPU kernel waterorderlib_tpu/ops/pallas/qtet2.py
// `_make_kernel` / `_launch` (with `slab.extract_k_min` in its body), and
// the earlier q kernels the same contract serves: qtet_kernel.py
// `_qtet_frames_kernel` (the brute form over all frames) and qtet_sorted.py
// `_make_sorted_kernel` (the slab form, with per-frame window starts for a
// per-frame z-sort). It computes the same per-row values, not the same
// blocks:
//
//   for each row (a center) and each column of its tile's window:
//     minimum-image displacement (two compare-selects, coordinates wrapped),
//     dsq, the (low, high] shell test, the shell count, and a sorted top-4
//     of (dsq, displacement) kept in registers;
//   epilogue: unit vectors, the 6 pair cosines in the fixed order
//     (0,1),(0,2),(0,3),(1,2),(1,3),(2,3), clipped, with cos = -1 for a pair
//     that misses a neighbor (the 180-degree padding rule),
//     q = 1 - 3/8 sum (cos + 1/3)^2, q = 0 when the shell is empty,
//     ok = 4th slot filled && its dsq <= margin^2.
//
// Tie-break: columns are visited in ascending order and a candidate enters
// the top-4 only when strictly smaller (`<`), so equal distances keep the
// lowest column first -- the rule of slab.extract_k_min that makes the JAX
// tiers bit-identical.
//
// What bounds it on this card: arithmetic and issue rate. Each pair costs
// ~15 FP32 operations plus a compare chain, and the window's coordinates are
// read once per block from device memory (12 bytes a column) and then from
// shared memory by every thread of the block, so device-memory traffic is
// a few percent of the time. The TPU kernel kept an (r, w) distance scratch
// in VMEM and swept it 4 times; here each pair is visited once and the
// top-4 lives in registers, so there is no scratch and no cap on the window
// width. Speed is a later concern: this first version favours being exact
// (compiled with --fmad=false and without fast math so dsq, the tie-breaks
// and `ok` match the plain version).
//
// Launch: one block of kRows threads per (frame, row block); a row block
// lies inside one window tile of `row_tile` rows (row_tile % kRows == 0).
// Window columns stream through shared memory in tiles of kCols. Tile t of
// frame f starts at starts[f * starts_fs + t]: starts_fs = 0 shares one
// start per tile across frames (the frame-0 slab prep, the brute form);
// starts_fs = n_tiles gives each frame its own (a per-frame z-sort).
//
// `qtet_window_hist_launch` is the same body with an epilogue that also
// replaces the fused histogram of waterorderlib_tpu/ops/pallas/qtet_kernel.py
// `_qtet_kernel` (the pallas_call of `order_param_q_pallas`): each row's q
// goes to bin floor(q * 500) (q == 1 to bin 499), rows with q outside [0, 1]
// (a NaN window) to none; a block bins its rows into a shared-memory
// histogram, then adds each non-zero bin to the int32 histogram in device
// memory with one atomicAdd. Integer atomics keep the counts exact and
// independent of the blocks' order (the TPU kernel carried a float32
// histogram across its sequential grid).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 128;
constexpr int kCols = 512;
constexpr int kBins = 500;

__device__ __forceinline__ float min_image(float d, float box, float half) {
  // coordinates are wrapped into [0, L) (pad copies within +/-L), so two
  // compare-selects replace round()
  d = d > half ? d - box : d;
  return d < -half ? d + box : d;
}

template <bool kHist>
__global__ void __launch_bounds__(kRows)
qtet_window_kernel(const float* __restrict__ rows, long long row_fs, long long row_cs,
                   int n_rows, const float* __restrict__ cols, long long col_fs,
                   long long col_cs, int n_cols, const int* __restrict__ starts,
                   long long starts_fs, int w, const float* __restrict__ boxes,
                   int blocks_per_frame, int row_tile, float low_sq, float high_sq,
                   float margin_sq, float* __restrict__ q_out, unsigned char* __restrict__ ok_out,
                   int* __restrict__ hist) {
  __shared__ float sx[kCols], sy[kCols], sz[kCols];
  __shared__ int s_hist[kHist ? kBins : 1];

  const int f = blockIdx.x / blocks_per_frame;
  const int rb = blockIdx.x - f * blocks_per_frame;
  const int row = rb * kRows + threadIdx.x;
  const bool live = row < n_rows;
  const int start = starts[f * starts_fs + (rb * kRows) / row_tile];

  const float bx = boxes[3 * f + 0], by = boxes[3 * f + 1], bz = boxes[3 * f + 2];
  const float hx = bx * 0.5f, hy = by * 0.5f, hz = bz * 0.5f;

  if (start < 0 || start > n_cols - w) {  // a window outside the columns (the whole block)
    if (live) {
      q_out[(long long)f * n_rows + row] = nanf("");
      ok_out[(long long)f * n_rows + row] = 0;
    }
    return;
  }

  float xr = 0.f, yr = 0.f, zr = 0.f;
  if (live) {
    const float* r = rows + f * row_fs + row;
    xr = r[0];
    yr = r[row_cs];
    zr = r[2 * row_cs];
  }

  const float inf = __int_as_float(0x7f800000);
  float d0 = inf, d1 = inf, d2 = inf, d3 = inf;
  float x0 = 0.f, y0 = 0.f, z0 = 0.f, x1 = 0.f, y1 = 0.f, z1 = 0.f;
  float x2 = 0.f, y2 = 0.f, z2 = 0.f, x3 = 0.f, y3 = 0.f, z3 = 0.f;
  int count = 0;

  const float* cx = cols + f * col_fs + start;
  const float* cy = cx + col_cs;
  const float* cz = cx + 2 * col_cs;

  for (int c0 = 0; c0 < w; c0 += kCols) {
    const int nc = min(kCols, w - c0);
    __syncthreads();
    for (int c = threadIdx.x; c < nc; c += kRows) {
      sx[c] = cx[c0 + c];
      sy[c] = cy[c0 + c];
      sz[c] = cz[c0 + c];
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      const float dx = min_image(sx[c] - xr, bx, hx);
      const float dy = min_image(sy[c] - yr, by, hy);
      const float dz = min_image(sz[c] - zr, bz, hz);
      const float dsq = dx * dx + dy * dy + dz * dz;
      if (!(dsq > low_sq && dsq <= high_sq)) continue;
      ++count;
      if (!(dsq < d3)) continue;
      if (dsq < d2) {
        d3 = d2; x3 = x2; y3 = y2; z3 = z2;
        if (dsq < d1) {
          d2 = d1; x2 = x1; y2 = y1; z2 = z1;
          if (dsq < d0) {
            d1 = d0; x1 = x0; y1 = y0; z1 = z0;
            d0 = dsq; x0 = dx; y0 = dy; z0 = dz;
          } else {
            d1 = dsq; x1 = dx; y1 = dy; z1 = dz;
          }
        } else {
          d2 = dsq; x2 = dx; y2 = dy; z2 = dz;
        }
      } else {
        d3 = dsq; x3 = dx; y3 = dy; z3 = dz;
      }
    }
  }
  float ux[4] = {x0, x1, x2, x3}, uy[4] = {y0, y1, y2, y3}, uz[4] = {z0, z1, z2, z3};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float nrm = sqrtf(ux[k] * ux[k] + uy[k] * uy[k] + uz[k] * uz[k]);
    const float inv = nrm > 0.f ? 1.0f / nrm : 0.f;
    ux[k] *= inv;
    uy[k] *= inv;
    uz[k] *= inv;
  }
  float ssum = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = a + 1; b < 4; ++b) {
      float cosv = ux[a] * ux[b] + uy[a] * uy[b] + uz[a] * uz[b];
      // slot b is filled iff more than b shell neighbors were seen (b > a)
      cosv = count > b ? fminf(fmaxf(cosv, -1.0f), 1.0f) : -1.0f;
      const float t = cosv + 1.0f / 3.0f;
      ssum = ssum + t * t;
    }
  }
  const float q = count > 0 ? 1.0f - 0.375f * ssum : 0.0f;
  if (live) {
    const long long o = (long long)f * n_rows + row;
    q_out[o] = q;
    ok_out[o] = (count >= 4 && d3 <= margin_sq) ? 1 : 0;
  }
  if constexpr (kHist) {
    for (int b = threadIdx.x; b < kBins; b += kRows) s_hist[b] = 0;
    __syncthreads();
    if (live && q >= 0.0f && q <= 1.0f) {
      const int b = q == 1.0f ? kBins - 1 : (int)floorf(q * (float)kBins);
      if (b < kBins) atomicAdd(&s_hist[b], 1);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < kBins; b += kRows) {
      if (s_hist[b]) atomicAdd(hist + b, s_hist[b]);
    }
  }
}

template <bool kHist>
int launch(const float* rows, long long row_fs, long long row_cs, int n_rows, const float* cols,
           long long col_fs, long long col_cs, int n_cols, const int* starts, int w,
           const float* boxes, int n_frames, int row_tile, long long starts_fs, float low_sq,
           float high_sq, float margin_sq, float* q_out, unsigned char* ok_out, int* hist,
           void* stream) {
  const int blocks_per_frame = (n_rows + kRows - 1) / kRows;
  const long long n_blocks = (long long)blocks_per_frame * n_frames;
  if (n_blocks == 0) return 0;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  qtet_window_kernel<kHist><<<(unsigned)n_blocks, kRows, 0, (cudaStream_t)stream>>>(
      rows, row_fs, row_cs, n_rows, cols, col_fs, col_cs, n_cols, starts, starts_fs, w, boxes,
      blocks_per_frame, row_tile, low_sq, high_sq, margin_sq, q_out, ok_out, hist);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qtet_window_launch(const float* rows, long long row_fs, long long row_cs,
                                  int n_rows, const float* cols, long long col_fs,
                                  long long col_cs, int n_cols, const int* starts, int w,
                                  const float* boxes, int n_frames, int row_tile,
                                  long long starts_fs, float low_sq, float high_sq,
                                  float margin_sq, float* q_out, unsigned char* ok_out,
                                  void* stream) {
  return launch<false>(rows, row_fs, row_cs, n_rows, cols, col_fs, col_cs, n_cols, starts, w,
                       boxes, n_frames, row_tile, starts_fs, low_sq, high_sq, margin_sq, q_out,
                       ok_out, nullptr, stream);
}

// As qtet_window_launch, and the 500-bin histogram of every row's q over
// [0, 1] added to hist (500,) int32, which must hold zeros.
extern "C" int qtet_window_hist_launch(const float* rows, long long row_fs, long long row_cs,
                                       int n_rows, const float* cols, long long col_fs,
                                       long long col_cs, int n_cols, const int* starts, int w,
                                       const float* boxes, int n_frames, int row_tile,
                                       long long starts_fs, float low_sq, float high_sq,
                                       float margin_sq, float* q_out, unsigned char* ok_out,
                                       int* hist, void* stream) {
  return launch<true>(rows, row_fs, row_cs, n_rows, cols, col_fs, col_cs, n_cols, starts, w,
                      boxes, n_frames, row_tile, starts_fs, low_sq, high_sq, margin_sq, q_out,
                      ok_out, hist, stream);
}

extern "C" int qtet_window_rows_per_block() { return kRows; }
