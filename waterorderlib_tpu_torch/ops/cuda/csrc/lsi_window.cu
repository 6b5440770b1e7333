// The local structure index (LSI) of Shiratani & Sasai over column windows:
// the port's two LSI kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels, which compute the same per-row values:
//   lsi_window_launch (K = 24): waterorderlib_tpu/ops/pallas/lsi_kernel.py
//     `_make_kernel` + `lsi_epilogue`, launched by `lsi_traj`; it also
//     serves the window-chunked (lsi_chunked.py) and HBM-streamed
//     (lsi_hbm.py) variants, which are bit-identical to it, since it has no
//     window cap. Per row: the 24 nearest (low, high+3.7] candidates by
//     imaged distance; the next-shell neighbor is the one of least raw
//     (stored, not imaged) distance among those beyond `high`.
//   lsi_split_launch: waterorderlib_tpu/ops/pallas/lsi_slab2.py
//     `_make_kernel`, launched by `lsi_traj_split`. Pass 1 keeps the 12
//     smallest in-shell (low, high] squared distances over a narrow window
//     and the full in-shell count; pass 2 takes the candidate of least raw
//     distance among ALL (high, high+3.7] candidates of a wide window (the
//     first column among equal ones) with its imaged distance. A row whose
//     in-shell count exceeds 12 is flagged `incomplete`.
// The two differ in the next-shell pick (top 24 against all candidates),
// so they give different LSI where a raw-nearer candidate lies beyond the
// 24 nearest; the dispatch (ops/cuda/lsi.py) keeps the JAX package's tier
// for each system size.
//
// Outputs per row: lsi (F, R) f32, the population variance of the sorted
// in-shell distance gaps plus the final (next - last in-shell) gap, 0 where
// invalid; valid (F, R) bool, >= 2 in-shell neighbors and a next-shell
// candidate; count (F, R) int32, the number of gaps (in-shell count) where
// valid, else 0; the split kernel also writes incomplete (F, R) bool.
//
// The contract is nbr_window.cu's (ops/cuda/window.py): rows and columns
// (F, 3, n) with unit stride along n, one window start per row tile of
// `row_tile` rows, blocks of kRows rows, the window streamed through shared
// memory in tiles of kCols columns, NaN for a window outside the columns.
// Beside the wrapped coordinates both kernels take the raw rows and columns
// in the same layout (slab.raw_ext_t: pad copies keep the stored
// coordinates). The split kernel takes a second window per tile
// (starts_wide, w_wide); the contract's window is its narrow one.
//
// The K = 24 top list keeps (dsq, column) in registers, columns visited in
// ascending order and a candidate moved ahead only when strictly smaller
// (extract_k_min's lowest-column order); the epilogue recomputes each
// slot's raw squared distance from its column. The split kernel's top-12
// keeps distances only (no payload), and its pass 2 keeps one (raw, imaged)
// pair. The epilogue follows lsi_epilogue operation by operation: roots by
// IEEE sqrtf, gaps summed from the final gap in slot order, mean by IEEE
// division, then the variance in the same order. Squared lengths are the
// explicit fmaf chain `dot3` (XLA's contraction of the JAX kernels'
// a*a + b*b + c*c); built with --fmad=false and without fast math, so the
// plain versions (ops/cuda/lsi.py) agree bit for bit.
//
// What bounds it on this card: instruction throughput of the pair scan,
// ~14 FP32 operations per (row, window column) plus the compares, 8 more
// per annulus candidate in the split kernel's pass 2 for the raw distance;
// the window is read once per block from device memory (12 bytes a column,
// 24 with the raw columns) and then from shared memory. One thread per row;
// this first version favours being exact over being fast.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 128;
constexpr int kCols = 512;
constexpr int kTop = 24;  // slots of the K = 24 kernel
constexpr int kIn = 12;   // in-shell slots of the split kernel

__device__ __forceinline__ float min_image(float d, float box, float half) {
  d = d > half ? d - box : d;
  return d < -half ? d + box : d;
}

// a0*b0 + a1*b1 + a2*b2 as fma(a2, b2, fma(a0, b0, a1*b1)), kept explicit
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
  return fmaf(a2, b2, fmaf(a0, b0, a1 * b1));
}

// lsi_kernel.py `lsi_epilogue` over N sorted slots: dist (ascending imaged
// distances, +inf where empty), rawsq (raw squared distances, +inf where the
// slot cannot be the next neighbor), fin (the slot holds a candidate).
template <int N>
__device__ __forceinline__ void lsi_epilogue(const float (&dist)[N], const float (&rawsq)[N],
                                             const bool (&fin)[N], float high, float* var_out,
                                             bool* ok_out, int* n_near_out) {
  const float inf = __int_as_float(0x7f800000);
  int n_near = 0;
  float best_raw = inf, next_dist = 0.f;
  bool has_next = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    n_near += (fin[j] && dist[j] <= high) ? 1 : 0;
    const bool isnext = fin[j] && dist[j] > high;
    const bool better = isnext && rawsq[j] < best_raw;
    best_raw = better ? rawsq[j] : best_raw;
    next_dist = better ? dist[j] : next_dist;
    has_next = has_next || isnext;
  }
  const int last = n_near > 1 ? n_near - 1 : 0;
  float last_near = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) last_near = j == last ? dist[j] : last_near;
  const float final_gap = next_dist - last_near;
  const float denom = (float)(n_near > 1 ? n_near : 1);
  float sum_gaps = final_gap;
#pragma unroll
  for (int j = 0; j < N - 1; ++j) {
    if (j < n_near - 1 && dist[j + 1] < inf) sum_gaps = sum_gaps + (dist[j + 1] - dist[j]);
  }
  const float mean = sum_gaps / denom;
  const float t = final_gap - mean;
  float var = t * t;
#pragma unroll
  for (int j = 0; j < N - 1; ++j) {
    if (j < n_near - 1 && dist[j + 1] < inf) {
      const float g = (dist[j + 1] - dist[j]) - mean;
      var = var + g * g;
    }
  }
  *var_out = var / denom;
  *ok_out = n_near > 1 && has_next;
  *n_near_out = n_near;
}

__global__ void __launch_bounds__(kRows)
lsi_window_kernel(const float* __restrict__ rows, long long row_fs, long long row_cs,
                  int n_rows, const float* __restrict__ cols, long long col_fs,
                  long long col_cs, int n_cols, const int* __restrict__ starts, int w,
                  const float* __restrict__ boxes, int blocks_per_frame, int row_tile,
                  const float* __restrict__ raw_rows, long long rr_fs, long long rr_cs,
                  const float* __restrict__ raw_cols, long long rc_fs, long long rc_cs,
                  float low_sq, float high, float outer_sq, float* __restrict__ lsi_out,
                  bool* __restrict__ valid_out, int* __restrict__ count_out) {
  __shared__ float sx[kCols], sy[kCols], sz[kCols];

  const int f = blockIdx.x / blocks_per_frame;
  const int rb = blockIdx.x - f * blocks_per_frame;
  const int row = rb * kRows + threadIdx.x;
  const bool live = row < n_rows;
  const int start = starts[(rb * kRows) / row_tile];
  const long long o = (long long)f * n_rows + row;

  const float bx = boxes[3 * f + 0], by = boxes[3 * f + 1], bz = boxes[3 * f + 2];
  const float hx = bx * 0.5f, hy = by * 0.5f, hz = bz * 0.5f;

  if (start < 0 || start > n_cols - w) {  // a window outside the columns
    if (live) {
      lsi_out[o] = nanf("");
      valid_out[o] = false;
      count_out[o] = 0;
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
  float d[kTop];
  int ci[kTop];
#pragma unroll
  for (int k = 0; k < kTop; ++k) {
    d[k] = inf;
    ci[k] = 0;
  }

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
      const float dsq = dot3(dx, dx, dy, dy, dz, dz);
      if (!(dsq > low_sq && dsq <= outer_sq)) continue;
      if (!(dsq < d[kTop - 1])) continue;
      const int col = c0 + c;
      // slot k takes slot k-1's entry when the candidate precedes it, or
      // the candidate when it falls between them (old values on the right)
#pragma unroll
      for (int k = kTop - 1; k > 0; --k) {
        const bool up = dsq < d[k - 1];
        const bool here = dsq < d[k];
        ci[k] = up ? ci[k - 1] : (here ? col : ci[k]);
        d[k] = up ? d[k - 1] : (here ? dsq : d[k]);
      }
      if (dsq < d[0]) {
        d[0] = dsq;
        ci[0] = col;
      }
    }
  }
  if (!live) return;

  // roots of the sorted slots and each slot's raw squared distance,
  // recomputed from its column
  const float* rr = raw_rows + f * rr_fs + row;
  const float rxr = rr[0], ryr = rr[rr_cs], rzr = rr[2 * rr_cs];
  const float* rcx = raw_cols + f * rc_fs + start;
  const float* rcy = rcx + rc_cs;
  const float* rcz = rcx + 2 * rc_cs;
  float dist[kTop], rawsq[kTop];
  bool fin[kTop];
#pragma unroll
  for (int k = 0; k < kTop; ++k) {
    fin[k] = d[k] < inf;
    dist[k] = sqrtf(d[k]);
    rawsq[k] = inf;
    if (fin[k]) {
      const int j = ci[k];
      const float ex = rcx[j] - rxr, ey = rcy[j] - ryr, ez = rcz[j] - rzr;
      rawsq[k] = dot3(ex, ex, ey, ey, ez, ez);
    }
  }
  float var;
  bool ok;
  int n_near;
  lsi_epilogue<kTop>(dist, rawsq, fin, high, &var, &ok, &n_near);
  lsi_out[o] = ok ? var : 0.0f;
  valid_out[o] = ok;
  count_out[o] = ok ? n_near : 0;
}

__global__ void __launch_bounds__(kRows)
lsi_split_kernel(const float* __restrict__ rows, long long row_fs, long long row_cs,
                 int n_rows, const float* __restrict__ cols, long long col_fs,
                 long long col_cs, int n_cols, const int* __restrict__ starts, int w,
                 const float* __restrict__ boxes, int blocks_per_frame, int row_tile,
                 const float* __restrict__ raw_rows, long long rr_fs, long long rr_cs,
                 const float* __restrict__ raw_cols, long long rc_fs, long long rc_cs,
                 const int* __restrict__ starts_wide, int w_wide, float low_sq, float high,
                 float high_sq, float outer_sq, float* __restrict__ lsi_out,
                 bool* __restrict__ valid_out, int* __restrict__ count_out,
                 bool* __restrict__ incomplete_out) {
  __shared__ float sx[kCols], sy[kCols], sz[kCols], srx[kCols], sry[kCols], srz[kCols];

  const int f = blockIdx.x / blocks_per_frame;
  const int rb = blockIdx.x - f * blocks_per_frame;
  const int row = rb * kRows + threadIdx.x;
  const bool live = row < n_rows;
  const int tile = (rb * kRows) / row_tile;
  const int start_n = starts[tile];
  const int start_w = starts_wide[tile];
  const long long o = (long long)f * n_rows + row;

  const float bx = boxes[3 * f + 0], by = boxes[3 * f + 1], bz = boxes[3 * f + 2];
  const float hx = bx * 0.5f, hy = by * 0.5f, hz = bz * 0.5f;

  // a window outside the columns: NaN, and the row is uncertified
  if (start_n < 0 || start_n > n_cols - w || start_w < 0 || start_w > n_cols - w_wide) {
    if (live) {
      lsi_out[o] = nanf("");
      valid_out[o] = false;
      count_out[o] = 0;
      incomplete_out[o] = true;
    }
    return;
  }

  float xr = 0.f, yr = 0.f, zr = 0.f, rxr = 0.f, ryr = 0.f, rzr = 0.f;
  if (live) {
    const float* r = rows + f * row_fs + row;
    xr = r[0];
    yr = r[row_cs];
    zr = r[2 * row_cs];
    const float* rr = raw_rows + f * rr_fs + row;
    rxr = rr[0];
    ryr = rr[rr_cs];
    rzr = rr[2 * rr_cs];
  }
  const float inf = __int_as_float(0x7f800000);

  // pass 1: the kIn smallest in-shell squared distances over the narrow
  // window and the full in-shell count
  float cd[kIn];
#pragma unroll
  for (int k = 0; k < kIn; ++k) cd[k] = inf;
  int count = 0;
  {
    const float* cx = cols + f * col_fs + start_n;
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
        const float dsq = dot3(dx, dx, dy, dy, dz, dz);
        if (!(dsq > low_sq && dsq <= high_sq)) continue;
        ++count;
        if (!(dsq < cd[kIn - 1])) continue;
#pragma unroll
        for (int k = kIn - 1; k > 0; --k) {
          cd[k] = dsq < cd[k - 1] ? cd[k - 1] : (dsq < cd[k] ? dsq : cd[k]);
        }
        if (dsq < cd[0]) cd[0] = dsq;
      }
    }
  }

  // pass 2: the (high, high+3.7] candidate of least raw squared distance
  // over the wide window, the first column among equal ones, and its
  // imaged squared distance
  float best_raw = inf, best_img = 0.f;
  {
    const float* cx = cols + f * col_fs + start_w;
    const float* cy = cx + col_cs;
    const float* cz = cx + 2 * col_cs;
    const float* rcx = raw_cols + f * rc_fs + start_w;
    const float* rcy = rcx + rc_cs;
    const float* rcz = rcx + 2 * rc_cs;
    for (int c0 = 0; c0 < w_wide; c0 += kCols) {
      const int nc = min(kCols, w_wide - c0);
      __syncthreads();
      for (int c = threadIdx.x; c < nc; c += kRows) {
        sx[c] = cx[c0 + c];
        sy[c] = cy[c0 + c];
        sz[c] = cz[c0 + c];
        srx[c] = rcx[c0 + c];
        sry[c] = rcy[c0 + c];
        srz[c] = rcz[c0 + c];
      }
      __syncthreads();
      for (int c = 0; c < nc; ++c) {
        const float dx = min_image(sx[c] - xr, bx, hx);
        const float dy = min_image(sy[c] - yr, by, hy);
        const float dz = min_image(sz[c] - zr, bz, hz);
        const float dsq = dot3(dx, dx, dy, dy, dz, dz);
        if (!(dsq > high_sq && dsq <= outer_sq)) continue;
        const float ex = srx[c] - rxr, ey = sry[c] - ryr, ez = srz[c] - rzr;
        const float rsq = dot3(ex, ex, ey, ey, ez, ez);
        if (rsq < best_raw) {
          best_raw = rsq;
          best_img = dsq;
        }
      }
    }
  }
  if (!live) return;

  // kIn sorted in-shell slots and one next-shell slot
  float dist[kIn + 1], rawsq[kIn + 1];
  bool fin[kIn + 1];
#pragma unroll
  for (int k = 0; k < kIn; ++k) {
    fin[k] = cd[k] < inf;
    dist[k] = sqrtf(cd[k]);
    rawsq[k] = inf;
  }
  fin[kIn] = best_raw < inf;
  dist[kIn] = fin[kIn] ? sqrtf(best_img) : inf;
  rawsq[kIn] = best_raw;
  float var;
  bool ok;
  int n_near;
  lsi_epilogue<kIn + 1>(dist, rawsq, fin, high, &var, &ok, &n_near);
  lsi_out[o] = ok ? var : 0.0f;
  valid_out[o] = ok;
  count_out[o] = ok ? n_near : 0;
  incomplete_out[o] = count > kIn;
}

int grid(int n_rows, int n_frames, int* blocks_per_frame, unsigned* n_blocks) {
  *blocks_per_frame = (n_rows + kRows - 1) / kRows;
  const long long nb = (long long)*blocks_per_frame * n_frames;
  if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  *n_blocks = (unsigned)nb;
  return 0;
}

}  // namespace

extern "C" int lsi_window_launch(const float* rows, long long row_fs, long long row_cs,
                                 int n_rows, const float* cols, long long col_fs,
                                 long long col_cs, int n_cols, const int* starts, int w,
                                 const float* boxes, int n_frames, int row_tile,
                                 const float* raw_rows, long long rr_fs, long long rr_cs,
                                 const float* raw_cols, long long rc_fs, long long rc_cs,
                                 float low_sq, float high, float outer_sq, float* lsi,
                                 bool* valid, int* count, void* stream) {
  int blocks_per_frame;
  unsigned n_blocks;
  const int err = grid(n_rows, n_frames, &blocks_per_frame, &n_blocks);
  if (err != 0) return err;
  if (n_blocks == 0) return 0;
  lsi_window_kernel<<<n_blocks, kRows, 0, (cudaStream_t)stream>>>(
      rows, row_fs, row_cs, n_rows, cols, col_fs, col_cs, n_cols, starts, w, boxes,
      blocks_per_frame, row_tile, raw_rows, rr_fs, rr_cs, raw_cols, rc_fs, rc_cs, low_sq, high,
      outer_sq, lsi, valid, count);
  return (int)cudaGetLastError();
}

extern "C" int lsi_split_launch(const float* rows, long long row_fs, long long row_cs,
                                int n_rows, const float* cols, long long col_fs,
                                long long col_cs, int n_cols, const int* starts, int w,
                                const float* boxes, int n_frames, int row_tile,
                                const float* raw_rows, long long rr_fs, long long rr_cs,
                                const float* raw_cols, long long rc_fs, long long rc_cs,
                                const int* starts_wide, int w_wide, float low_sq, float high,
                                float high_sq, float outer_sq, float* lsi, bool* valid,
                                int* count, bool* incomplete, void* stream) {
  int blocks_per_frame;
  unsigned n_blocks;
  const int err = grid(n_rows, n_frames, &blocks_per_frame, &n_blocks);
  if (err != 0) return err;
  if (n_blocks == 0) return 0;
  lsi_split_kernel<<<n_blocks, kRows, 0, (cudaStream_t)stream>>>(
      rows, row_fs, row_cs, n_rows, cols, col_fs, col_cs, n_cols, starts, w, boxes,
      blocks_per_frame, row_tile, raw_rows, rr_fs, rr_cs, raw_cols, rc_fs, rc_cs, starts_wide,
      w_wide, low_sq, high, high_sq, outer_sq, lsi, valid, count, incomplete);
  return (int)cudaGetLastError();
}
