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
//   lsi_split_redo_launch: the split kernel's escalation form, which the
//     JAX package does not have: the listed (frame, row) pairs alone, over
//     the same two windows, with k_in in-shell slots, so that a row the split
//     kernel flags is redone, not served by the K = 24 kernel.
// The two differ in the next-shell pick (top 24 against all candidates),
// so they give different LSI where a raw-nearer candidate lies beyond the
// 24 nearest. The dispatch (ops/cuda/lsi.py) takes the JAX package's tier
// for each system size; on the split tier every row gets the definition's
// pick, the overfull ones through the escalation form, where the JAX
// package falls back to its K = 24 pick.
//
// Outputs per row: lsi (F, R) f32, the population variance of the sorted
// in-shell distance gaps plus the final (next - last in-shell) gap, 0 where
// invalid; valid (F, R) bool, >= 2 in-shell neighbors and a next-shell
// candidate; count (F, R) int32, the number of gaps (in-shell count) where
// valid, else 0; the split kernel also writes incomplete (F, R) bool. The
// escalation form writes the same per listed pair (M,), and shell (M,)
// int32, the pair's full in-shell count.
//
// The contract is nbr_window.cu's (ops/cuda/window.py): rows and columns
// (F, 3, n) with unit stride along n, one window start per row tile of
// `row_tile` rows, blocks of at most 128 rows inside one tile, the window
// streamed through shared memory in tiles of kCols columns, NaN for a window
// outside the columns.
// Beside the wrapped coordinates both kernels take the raw rows and columns
// in the same layout (slab.raw_ext_t: pad copies keep the stored
// coordinates). The split kernel takes a second window per tile
// (starts_wide, w_wide); the contract's window is its narrow one.
//
// The K = 24 kernel keeps a row's 24 nearest candidates by key, (dsq's bits
// << 32) | window column (dsq > low^2 >= 0, so bit order is value order),
// ascending: equal distances keep the lowest column first, extract_k_min's
// order; the epilogue recomputes each slot's raw squared distance from its
// column. The split kernel's top-12 keeps distances only (no payload), and
// its scan keeps one (raw, imaged) pair. The epilogues follow lsi_epilogue
// operation by operation: roots by IEEE sqrtf, gaps summed from the final
// gap in slot order, mean by IEEE division, then the variance in the same
// order. Squared lengths are the explicit fmaf chain `dot3` (XLA's
// contraction of the JAX kernels' a*a + b*b + c*c); built with --fmad=false
// and without fast math, so the plain versions (ops/cuda/lsi.py) agree bit
// for bit.
//
// What bounds them on this card: instruction issue in the pair scan, ~14
// FP32 operations per (row, window column) plus the compares, 8 more per
// annulus candidate of the split kernel for the raw distance; the window is
// read once per block from device memory (12 bytes a column, 24 with the
// raw columns) and then from shared memory.
//
// Both scans take the minimum image by magnitude: for a column - row
// difference d, fminf(|d|, L - |d|) squares to the compare-selects' mi(d)^2
// bit for bit (IEEE subtraction is sign-symmetric and rounding monotone;
// hbond.cu's header gives the argument). Pad copies lie within +/-L in z, so
// d lies in (-2L, 2L); beyond |d| = L both forms are |d| - L up to sign. 3
// instructions an axis in place of ~7.
//
// The K = 24 kernel (lsi_window_kernel) is laid out for that bound:
// - No serial insertion: the lanes of a warp scan the window, lane j the
//   columns j, j + 32, ...; a candidate in (low, high + 3.7] whose key is
//   below the row's current 24th goes into the warp's buffer (a float test
//   of dsq against the 24th key's dsq first, one vote for the warp, the
//   64-bit key test only where a lane passes), and every 32
//   buffered keys are bitonic-sorted across the warp and merged into a
//   register list of 32 >= 24 keys (WarpSelect<1>, warp_select.cuh, shared
//   with voronoi_topk.cu). A row has ~57 candidates in a 2176-column window:
//   2-3 merges a row. The serial form ran a 24-slot shift for each of them
//   in one thread, and for about half of all columns in some lane of a warp.
// - kRowsPerWarp = 4 rows a warp, each with its own list: a column is read
//   from shared memory once for 4 rows (3 bytes a pair of shared-memory
//   traffic, not 12, which was near the SM's 128 B a clock at the target
//   issue rate), and the 4 selections' instructions interleave. On the card
//   (ab_voronoi.py --mappings; H100 80GB HBM3, 700 W) 4 rows a warp beat 2
//   and 1 (14.07 against 15.45 and 17.00 ms a 1024-frame launch at 4096
//   rows), and 8 lost (17.01). kWarps24 = 8 warps
//   a block: 32 rows, inside one 128-row tile of the window contract, so a
//   block stages one window.
// - The epilogue runs slot j in lane j: roots, raw distances and gaps in
//   parallel; the in-shell count and the next-shell pick (the first slot of
//   least raw distance, the sequential scan's strict `<`) by ballots and a
//   min over (raw bits, slot) keys; the sums in slot order as a shuffle
//   chain of n_near - 1 steps, every lane adding the same terms in the same
//   order.
// The split kernel (lsi_split_kernel) is one row a thread (kRowsS rows a
// block), every lane reading the same 4 columns at a time (16-byte
// broadcast loads, one vote for the 4):
// - One scan of the union of its two windows, each distinct column once, in
//   ascending order (up to two column ranges: clamped starts can put the
//   narrow window partly outside the wide one). A column's imaged dsq is
//   taken once; it serves the (low, high] test where the column lies in the
//   narrow window and the (high, high+3.7] test where it lies in the wide
//   one. The two passes of the serial form took 7168 pairs a row at 16,384
//   waters, the union 4608.
// - The vote skips the groups near no row of the warp (beyond
//   max(high, high + 3.7)); the 12-slot in-shell insertion is branch-free
//   under a vote (a row has ~6 in-shell neighbors in ~4600 columns), the
//   raw distance of an annulus candidate predicated. The in-shell slots
//   carry no payload, so equal values need no order; the next-shell pick
//   replaces only on a strictly smaller raw distance, the first column among
//   equal ones in ascending order.
// - A warp of rows with lanes strided over the columns, the K = 24 kernel's
//   form, held 128 registers here (4 rows, a WarpSelect each) and recomputed
//   distances in the annulus path that ~30% of its batches take; one row a
//   thread needs 64. kRowsS 32 / 64 / 128: 5.025 / 4.894 / 4.931 ms a
//   64-frame launch at 16,384 rows (ab_voronoi.py --mappings; H100 80GB
//   HBM3, 700 W).
// The escalation form (lsi_split_redo_kernel) serves the few rows the split
// kernel flags (~0.5 a frame on a 16,384-water jittered lattice), one warp a
// row, its columns read from device memory (L2) by the lanes in turn: the
// in-shell values appended by ballot into k_in slots, ranked into order,
// the epilogue in one lane over k_in + 1 slots in the split kernel's
// layout, so that it equals the plain version at the same k_in bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "warp_select.cuh"

namespace {

constexpr int kCols = 512;
constexpr int kTop = 24;  // slots of the K = 24 kernel
constexpr int kIn = 12;   // in-shell slots of the split kernel
constexpr int kRowsPerWarp = 4;  // rows a warp of the K = 24 kernel selects for at once
constexpr int kWarps24 = 8;      // warps a block of the K = 24 kernel
constexpr int kRows24 = kWarps24 * kRowsPerWarp;
static_assert(128 % kRows24 == 0, "a K = 24 block's rows must lie in one 128-row tile");
constexpr int kRowsS = 64;  // rows a block of the split kernel, one a thread
static_assert(128 % kRowsS == 0, "a split block's rows must lie in one 128-row tile");
constexpr int kWarpsR = 4;  // pairs a block of the escalation form, one a warp
constexpr int kEscS = 32;   // in-shell slots the escalation form holds in shared memory

// a value whose square is the compare-select minimum image's square,
// mi(d)^2 with mi(d) = d - L if d > L/2, then + L if below -L/2, bit for
// bit (header)
__device__ __forceinline__ float mi_abs(float d, float box) {
  const float a = fabsf(d);
  return fminf(a, box - a);
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

// lsi_kernel.py `lsi_epilogue` over slots held one a lane (lane j: slot j;
// the lanes past the last slot hold empty ones): dist (imaged distance,
// +inf where empty), rawsq (raw squared distance, +inf where the slot
// cannot be the next neighbor), fin (the slot holds a candidate). The same
// operations in the same order as the sequential epilogue.
__device__ __forceinline__ void lsi_epilogue_warp(float dist, float rawsq, bool fin, float high,
                                                  float* var_out, bool* ok_out,
                                                  int* n_near_out) {
  const int lane = threadIdx.x & 31;
  const float inf = __int_as_float(0x7f800000);
  const int n_near = __popc(__ballot_sync(kFull, fin && dist <= high));
  const bool isnext = fin && dist > high;
  const bool has_next = __ballot_sync(kFull, isnext) != 0u;
  // the first slot of least raw distance below +inf among the next-shell
  // ones (rawsq >= +0, so its bits order as its value)
  u64 b = isnext && rawsq < inf ? ((u64)__float_as_uint(rawsq) << 32) | (unsigned)lane : kSent;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) b = umin64(b, __shfl_xor_sync(kFull, b, d));
  const float at_best = __shfl_sync(kFull, dist, (int)(b & 31u));
  const float next_dist = b != kSent ? at_best : 0.f;
  const int last = n_near > 1 ? n_near - 1 : 0;
  const float final_gap = next_dist - __shfl_sync(kFull, dist, last);
  const float denom = (float)(n_near > 1 ? n_near : 1);
  const float dnext = __shfl_down_sync(kFull, dist, 1);
  const float gap = dnext - dist;  // slot j's gap in lane j
  const unsigned inner = __ballot_sync(kFull, dnext < inf);
  float sum_gaps = final_gap;
  for (int j = 0; j < n_near - 1; ++j) {
    const float g = __shfl_sync(kFull, gap, j);
    if ((inner >> j) & 1u) sum_gaps = sum_gaps + g;
  }
  const float mean = sum_gaps / denom;
  const float t = final_gap - mean;
  float var = t * t;
  for (int j = 0; j < n_near - 1; ++j) {
    const float g = __shfl_sync(kFull, gap, j) - mean;
    if ((inner >> j) & 1u) var = var + g * g;
  }
  *var_out = var / denom;
  *ok_out = n_near > 1 && has_next;
  *n_near_out = n_near;
}

__global__ void __launch_bounds__(32 * kWarps24)
lsi_window_kernel(const float* __restrict__ rows, long long row_fs, long long row_cs,
                  int n_rows, const float* __restrict__ cols, long long col_fs,
                  long long col_cs, int n_cols, const int* __restrict__ starts, int w,
                  const float* __restrict__ boxes, int blocks_per_frame, int row_tile,
                  const float* __restrict__ raw_rows, long long rr_fs, long long rr_cs,
                  const float* __restrict__ raw_cols, long long rc_fs, long long rc_cs,
                  float low_sq, float high, float outer_sq, float* __restrict__ lsi_out,
                  bool* __restrict__ valid_out, int* __restrict__ count_out) {
  __shared__ float sx[kCols], sy[kCols], sz[kCols];
  __shared__ u64 s_buf[kWarps24][kRowsPerWarp][kBuf];

  const int f = blockIdx.x / blocks_per_frame;
  const int rb = blockIdx.x - f * blocks_per_frame;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int start = starts[(rb * kRows24) / row_tile];
  const float bx = boxes[3 * f + 0], by = boxes[3 * f + 1], bz = boxes[3 * f + 2];

  if (start < 0 || start > n_cols - w) {  // a window outside the columns
    const int row = rb * kRows24 + threadIdx.x;
    if (threadIdx.x < kRows24 && row < n_rows) {
      const long long o = (long long)f * n_rows + row;
      lsi_out[o] = nanf("");
      valid_out[o] = false;
      count_out[o] = 0;
    }
    return;
  }

  // this warp's rows (a row past n_rows offers nothing and writes nothing).
  // lim: no key of dsq above it can enter the row's list -- outer^2, then
  // the dsq of the list's 24th key (NaN while the list is short: fminf
  // keeps outer^2); -1 for a row past n_rows
  const int row0 = rb * kRows24 + warp * kRowsPerWarp;
  float xr[kRowsPerWarp], yr[kRowsPerWarp], zr[kRowsPerWarp], lim[kRowsPerWarp];
  bool live[kRowsPerWarp];
  WarpSelect<1> ws[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    live[r] = row0 + r < n_rows;
    const float* p = rows + f * row_fs + (live[r] ? row0 + r : 0);
    xr[r] = p[0];
    yr[r] = p[row_cs];
    zr[r] = p[2 * row_cs];
    lim[r] = live[r] ? outer_sq : -1.f;
    ws[r].init(s_buf[warp][r], kTop);
  }

  const float* cx = cols + f * col_fs + start;
  const float* cy = cx + col_cs;
  const float* cz = cx + 2 * col_cs;
  for (int c0 = 0; c0 < w; c0 += kCols) {
    const int nc = min(kCols, w - c0);
    __syncthreads();
    for (int c = threadIdx.x; c < nc; c += 32 * kWarps24) {
      sx[c] = cx[c0 + c];
      sy[c] = cy[c0 + c];
      sz[c] = cz[c0 + c];
    }
    __syncthreads();
    for (int j0 = 0; j0 < nc; j0 += 32) {
      const int c = j0 + lane;  // < kCols: a lane past nc reads a stale entry, offered never
      const float x = sx[c], y = sy[c], z = sz[c];
      const unsigned col = (unsigned)(c0 + c);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float ex = mi_abs(x - xr[r], bx);
        const float ey = mi_abs(y - yr[r], by);
        const float ez = mi_abs(z - zr[r], bz);
        const float dsq = dot3(ex, ex, ey, ey, ez, ez);
        const bool real = c < nc && dsq > low_sq && dsq <= lim[r];
        if (__ballot_sync(kFull, real) == 0u) continue;  // most batches: no lane can enter
        ws[r].offer(real, ((u64)__float_as_uint(dsq) << 32) | col);
        lim[r] = fminf(outer_sq, __uint_as_float((unsigned)(ws[r].thr >> 32)));
      }
    }
  }

  const float inf = __int_as_float(0x7f800000);
  const float* rcx = raw_cols + f * rc_fs + start;
  const float* rcy = rcx + rc_cs;
  const float* rcz = rcx + 2 * rc_cs;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    ws[r].flush();
    if (!live[r]) continue;  // the same in every lane
    // slot `lane`: its root and its raw squared distance, recomputed from
    // its column
    const u64 key = ws[r].L[0];
    const bool fin = lane < kTop && key != kSent;
    const float dist = sqrtf(fin ? __uint_as_float((unsigned)(key >> 32)) : inf);
    float rawsq = inf;
    if (fin) {
      const float* rr = raw_rows + f * rr_fs + row0 + r;
      const int j = (int)(unsigned)key;
      const float ex = rcx[j] - rr[0], ey = rcy[j] - rr[rr_cs], ez = rcz[j] - rr[2 * rr_cs];
      rawsq = dot3(ex, ex, ey, ey, ez, ez);
    }
    float var;
    bool ok;
    int n_near;
    lsi_epilogue_warp(dist, rawsq, fin, high, &var, &ok, &n_near);
    if (lane == 0) {
      const long long o = (long long)f * n_rows + row0 + r;
      lsi_out[o] = ok ? var : 0.0f;
      valid_out[o] = ok;
      count_out[o] = ok ? n_near : 0;
    }
  }
}

// the kIn smallest values so far, ascending (+inf where empty): enter dsq
// where `take` (dsq < cd[kIn - 1]), branch-free
__device__ __forceinline__ void insert_in(float (&cd)[kIn], bool take, float dsq) {
  bool p[kIn];
#pragma unroll
  for (int k = 0; k < kIn; ++k) p[k] = take && dsq < cd[k];
#pragma unroll
  for (int k = kIn - 1; k > 0; --k) cd[k] = p[k - 1] ? cd[k - 1] : (p[k] ? dsq : cd[k]);
  cd[0] = p[0] ? dsq : cd[0];
}

__global__ void __launch_bounds__(kRowsS)
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
  __shared__ __align__(16) float sx[kCols], sy[kCols], sz[kCols], srx[kCols], sry[kCols],
      srz[kCols];

  const int f = blockIdx.x / blocks_per_frame;
  const int rb = blockIdx.x - f * blocks_per_frame;
  const int row = rb * kRowsS + threadIdx.x;
  const bool live = row < n_rows;
  const int tile = (rb * kRowsS) / row_tile;
  const int start_n = starts[tile];
  const int start_w = starts_wide[tile];
  const long long o = (long long)f * n_rows + row;
  const float bx = boxes[3 * f + 0], by = boxes[3 * f + 1], bz = boxes[3 * f + 2];

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

  // a row past n_rows has NaN coordinates: no column lies in either shell
  float xr = nanf(""), yr = 0.f, zr = 0.f, rxr = 0.f, ryr = 0.f, rzr = 0.f;
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
  const float lim = fmaxf(high_sq, outer_sq);  // no pair beyond it is in either shell

  // the union of the two windows, each distinct column once, in ascending
  // order: one range where they overlap or touch, else two
  const int end_n = start_n + w, end_w = start_w + w_wide;
  int lo[2], hi[2];
  if (max(start_n, start_w) <= min(end_n, end_w)) {
    lo[0] = min(start_n, start_w);
    hi[0] = max(end_n, end_w);
    lo[1] = hi[1] = 0;
  } else {
    const bool n_first = start_n < start_w;
    lo[0] = n_first ? start_n : start_w;
    hi[0] = n_first ? end_n : end_w;
    lo[1] = n_first ? start_w : start_n;
    hi[1] = n_first ? end_w : end_n;
  }

  // the kIn smallest in-shell squared distances of the narrow window and
  // its full in-shell count; the wide window's (high, high+3.7] candidate of
  // least raw squared distance (the first column among equal ones: columns
  // come in ascending order and only a strictly smaller one replaces it)
  // and its imaged squared distance
  float cd[kIn];
#pragma unroll
  for (int k = 0; k < kIn; ++k) cd[k] = inf;
  int count = 0;
  float best_raw = inf, best_img = 0.f;
  const float* cx = cols + f * col_fs;
  const float* cy = cx + col_cs;
  const float* cz = cx + 2 * col_cs;
  const float* rcx = raw_cols + f * rc_fs;
  const float* rcy = rcx + rc_cs;
  const float* rcz = rcx + 2 * rc_cs;
#pragma unroll 1
  for (int part = 0; part < 2; ++part) {
    for (int c0 = lo[part]; c0 < hi[part]; c0 += kCols) {
      const int nc = min(kCols, hi[part] - c0);
      const int nc4 = (nc + 3) & ~3;  // the tail up to a multiple of 4 is NaN: near no row
      __syncthreads();
      for (int c = threadIdx.x; c < nc4; c += kRowsS) {
        const bool in = c < nc;
        sx[c] = in ? cx[c0 + c] : nanf("");
        sy[c] = in ? cy[c0 + c] : 0.f;
        sz[c] = in ? cz[c0 + c] : 0.f;
        srx[c] = in ? rcx[c0 + c] : 0.f;
        sry[c] = in ? rcy[c0 + c] : 0.f;
        srz[c] = in ? rcz[c0 + c] : 0.f;
      }
      __syncthreads();
      // 4 columns at a time: 16-byte loads of every lane's same 4 columns,
      // one vote for the 4
      for (int c = 0; c < nc4; c += 4) {
        const float4 X = *reinterpret_cast<const float4*>(sx + c);
        const float4 Y = *reinterpret_cast<const float4*>(sy + c);
        const float4 Z = *reinterpret_cast<const float4*>(sz + c);
        const float xs[4] = {X.x, X.y, X.z, X.w}, ys[4] = {Y.x, Y.y, Y.z, Y.w};
        const float zs[4] = {Z.x, Z.y, Z.z, Z.w};
        float dsq[4];
        bool any = false;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float ex = mi_abs(xs[k] - xr, bx);
          const float ey = mi_abs(ys[k] - yr, by);
          const float ez = mi_abs(zs[k] - zr, bz);
          dsq[k] = dot3(ex, ex, ey, ey, ez, ez);
          any = any || dsq[k] <= lim;
        }
        // most groups are near no row of the warp
        if (!__any_sync(kFull, any)) continue;
        const float4 RX = *reinterpret_cast<const float4*>(srx + c);
        const float4 RY = *reinterpret_cast<const float4*>(sry + c);
        const float4 RZ = *reinterpret_cast<const float4*>(srz + c);
        const float rxs[4] = {RX.x, RX.y, RX.z, RX.w}, rys[4] = {RY.x, RY.y, RY.z, RY.w};
        const float rzs[4] = {RZ.x, RZ.y, RZ.z, RZ.w};
        bool take[4], any_take = false;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // the in-shell test applies to the narrow window, the annulus to
          // the wide one (the column is the same in every lane); columns in
          // ascending order, so a strictly smaller raw distance alone
          // replaces the pick
          const int col = c0 + c + k;
          const bool shell = (unsigned)(col - start_n) < (unsigned)w && dsq[k] > low_sq &&
                             dsq[k] <= high_sq;
          count += shell ? 1 : 0;
          take[k] = shell && dsq[k] < cd[kIn - 1];
          any_take = any_take || take[k];
          const bool ann = (unsigned)(col - start_w) < (unsigned)w_wide && dsq[k] > high_sq &&
                           dsq[k] <= outer_sq;
          const float fx = rxs[k] - rxr, fy = rys[k] - ryr, fz = rzs[k] - rzr;
          const float rsq = dot3(fx, fx, fy, fy, fz, fz);
          const bool better = ann && rsq < best_raw;
          best_raw = better ? rsq : best_raw;
          best_img = better ? dsq[k] : best_img;
        }
        if (!__any_sync(kFull, any_take)) continue;
#pragma unroll
        for (int k = 0; k < 4; ++k) insert_in(cd, take[k], dsq[k]);
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

// lsi_epilogue<k_in + 1> over the split kernel's slots with k_in in-shell
// slots, read from memory: slot j < m holds the root of sq[j] (sq: the
// in-shell squared distances, ascending), slots [m, k_in) are empty, slot
// k_in holds the next-shell pick (its imaged distance nd, raw squared
// distance nraw; nfin: there is one). The same operations in the same order.
__device__ void lsi_epilogue_mem(const float* sq, int m, int k_in, float nd, float nraw,
                                 bool nfin, float high, float* var_out, bool* ok_out,
                                 int* n_near_out) {
  const float inf = __int_as_float(0x7f800000);
  auto dist = [&](int j) { return j < m ? sqrtf(sq[j]) : (j < k_in ? inf : nd); };
  auto fin = [&](int j) { return j < m || (j == k_in && nfin); };
  int n_near = 0;
  float best_raw = inf, next_dist = 0.f;
  bool has_next = false;
  for (int j = 0; j <= k_in; ++j) {
    const float d = dist(j);
    const float r = j < k_in ? inf : nraw;
    n_near += (fin(j) && d <= high) ? 1 : 0;
    const bool isnext = fin(j) && d > high;
    const bool better = isnext && r < best_raw;
    best_raw = better ? r : best_raw;
    next_dist = better ? d : next_dist;
    has_next = has_next || isnext;
  }
  const int last = n_near > 1 ? n_near - 1 : 0;
  const float final_gap = next_dist - dist(last);
  const float denom = (float)(n_near > 1 ? n_near : 1);
  float sum_gaps = final_gap;
  for (int j = 0; j < k_in && j < n_near - 1; ++j) {
    if (dist(j + 1) < inf) sum_gaps = sum_gaps + (dist(j + 1) - dist(j));
  }
  const float mean = sum_gaps / denom;
  const float t = final_gap - mean;
  float var = t * t;
  for (int j = 0; j < k_in && j < n_near - 1; ++j) {
    if (dist(j + 1) < inf) {
      const float g = (dist(j + 1) - dist(j)) - mean;
      var = var + g * g;
    }
  }
  *var_out = var / denom;
  *ok_out = n_near > 1 && has_next;
  *n_near_out = n_near;
}

// The escalation form of the split kernel: the listed (frame, row) pairs
// alone, one warp a pair, with k_in in-shell slots (shared memory up to
// kEscS, else 2 * k_in floats of `scratch` a pair). Over the same two
// windows as the split launch, the lanes scan the hull of both (column
// c0 + lane, c0 + lane + 32, ... from device memory), each column's imaged
// dsq taken once: in-shell values of the narrow window are appended to the
// pair's buffer by ballot (their full count kept), and the wide window's
// annulus candidates give the least (raw dsq bits << 32) | column key, the
// first column among equal raw distances, its imaged dsq recomputed from
// its column as in the split kernel. The buffer is ranked into ascending
// order (values only: equal ones need no order) and lane 0 runs the
// epilogue. A pair whose in-shell count exceeds k_in writes NaN, not valid,
// count 0 and its count in `shell`; a window outside the columns NaN and
// shell -1.
__global__ void __launch_bounds__(32 * kWarpsR)
lsi_split_redo_kernel(const float* __restrict__ rows, long long row_fs, long long row_cs,
                      int n_rows, const float* __restrict__ cols, long long col_fs,
                      long long col_cs, int n_cols, const int* __restrict__ starts, int w,
                      const float* __restrict__ boxes, int row_tile,
                      const float* __restrict__ raw_rows, long long rr_fs, long long rr_cs,
                      const float* __restrict__ raw_cols, long long rc_fs, long long rc_cs,
                      const int* __restrict__ starts_wide, int w_wide,
                      const long long* __restrict__ pairs, int n_pairs, int k_in,
                      float* __restrict__ scratch, float low_sq, float high, float high_sq,
                      float outer_sq, float* __restrict__ lsi_out, bool* __restrict__ valid_out,
                      int* __restrict__ count_out, int* __restrict__ shell_out) {
  __shared__ float s_buf[kWarpsR][2][kEscS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kWarpsR + warp;
  if (p >= n_pairs) return;  // the whole warp
  const long long pr = pairs[p];
  const int f = (int)(pr / n_rows);
  const int row = (int)(pr - (long long)f * n_rows);
  const int tile = row / row_tile;
  const int start_n = starts[tile], start_w = starts_wide[tile];
  const float inf = __int_as_float(0x7f800000);
  if (start_n < 0 || start_n > n_cols - w || start_w < 0 || start_w > n_cols - w_wide) {
    if (lane == 0) {
      lsi_out[p] = nanf("");
      valid_out[p] = false;
      count_out[p] = 0;
      shell_out[p] = -1;
    }
    return;
  }
  float* buf = k_in <= kEscS ? s_buf[warp][0] : scratch + p * 2 * k_in;
  float* sorted = k_in <= kEscS ? s_buf[warp][1] : buf + k_in;
  const float bx = boxes[3 * f + 0], by = boxes[3 * f + 1], bz = boxes[3 * f + 2];
  const float* r = rows + f * row_fs + row;
  const float xr = r[0], yr = r[row_cs], zr = r[2 * row_cs];
  const float* rr = raw_rows + f * rr_fs + row;
  const float rxr = rr[0], ryr = rr[rr_cs], rzr = rr[2 * rr_cs];
  const float* cx = cols + f * col_fs;
  const float* rcx = raw_cols + f * rc_fs;

  const int lo = min(start_n, start_w), hi = max(start_n + w, start_w + w_wide);
  int count = 0;
  u64 best = kSent;
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int col = c0 + lane;
    bool shell = false;
    float dsq = 0.f;
    if (col < hi) {
      const float ex = mi_abs(cx[col] - xr, bx);
      const float ey = mi_abs(cx[col_cs + col] - yr, by);
      const float ez = mi_abs(cx[2 * col_cs + col] - zr, bz);
      dsq = dot3(ex, ex, ey, ey, ez, ez);
      shell = (unsigned)(col - start_n) < (unsigned)w && dsq > low_sq && dsq <= high_sq;
      if ((unsigned)(col - start_w) < (unsigned)w_wide && dsq > high_sq && dsq <= outer_sq) {
        const float fx = rcx[col] - rxr, fy = rcx[rc_cs + col] - ryr,
                    fz = rcx[2 * rc_cs + col] - rzr;
        const float rsq = dot3(fx, fx, fy, fy, fz, fz);
        if (rsq < inf) best = umin64(best, ((u64)__float_as_uint(rsq) << 32) | (unsigned)col);
      }
    }
    const unsigned hit = __ballot_sync(kFull, shell);
    const int at = count + __popc(hit & ((1u << lane) - 1u));
    if (shell && at < k_in) buf[at] = dsq;
    count += __popc(hit);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) best = umin64(best, __shfl_xor_sync(kFull, best, d));
  __syncwarp();
  if (count > k_in) {
    if (lane == 0) {
      lsi_out[p] = nanf("");
      valid_out[p] = false;
      count_out[p] = 0;
      shell_out[p] = count;
    }
    return;
  }
  for (int i = lane; i < count; i += 32) {
    const float v = buf[i];
    int rank = 0;
    for (int j = 0; j < count; ++j) {
      const float u = buf[j];
      rank += (u < v || (u == v && j < i)) ? 1 : 0;
    }
    sorted[rank] = v;
  }
  __syncwarp();
  if (lane != 0) return;
  const bool nfin = best != kSent;
  float nd = inf, nraw = inf;
  if (nfin) {
    const int j = (int)(unsigned)best;
    const float ex = mi_abs(cx[j] - xr, bx);
    const float ey = mi_abs(cx[col_cs + j] - yr, by);
    const float ez = mi_abs(cx[2 * col_cs + j] - zr, bz);
    nd = sqrtf(dot3(ex, ex, ey, ey, ez, ez));
    nraw = __uint_as_float((unsigned)(best >> 32));
  }
  float var;
  bool ok;
  int n_near;
  lsi_epilogue_mem(sorted, count, k_in, nd, nraw, nfin, high, &var, &ok, &n_near);
  lsi_out[p] = ok ? var : 0.0f;
  valid_out[p] = ok;
  count_out[p] = ok ? n_near : 0;
  shell_out[p] = count;
}

int grid(int n_rows, int rows_per_block, int n_frames, int* blocks_per_frame,
         unsigned* n_blocks) {
  *blocks_per_frame = (n_rows + rows_per_block - 1) / rows_per_block;
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
  const int err = grid(n_rows, kRows24, n_frames, &blocks_per_frame, &n_blocks);
  if (err != 0) return err;
  if (n_blocks == 0) return 0;
  lsi_window_kernel<<<n_blocks, 32 * kWarps24, 0, (cudaStream_t)stream>>>(
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
  const int err = grid(n_rows, kRowsS, n_frames, &blocks_per_frame, &n_blocks);
  if (err != 0) return err;
  if (n_blocks == 0) return 0;
  lsi_split_kernel<<<n_blocks, kRowsS, 0, (cudaStream_t)stream>>>(
      rows, row_fs, row_cs, n_rows, cols, col_fs, col_cs, n_cols, starts, w, boxes,
      blocks_per_frame, row_tile, raw_rows, rr_fs, rr_cs, raw_cols, rc_fs, rc_cs, starts_wide,
      w_wide, low_sq, high, high_sq, outer_sq, lsi, valid, count, incomplete);
  return (int)cudaGetLastError();
}

extern "C" int lsi_split_redo_launch(const float* rows, long long row_fs, long long row_cs,
                                     int n_rows, const float* cols, long long col_fs,
                                     long long col_cs, int n_cols, const int* starts, int w,
                                     const float* boxes, int n_frames, int row_tile,
                                     const float* raw_rows, long long rr_fs, long long rr_cs,
                                     const float* raw_cols, long long rc_fs, long long rc_cs,
                                     const int* starts_wide, int w_wide, const long long* pairs,
                                     int n_pairs, int k_in, float* scratch, float low_sq,
                                     float high, float high_sq, float outer_sq, float* lsi,
                                     bool* valid, int* count, int* shell, void* stream) {
  (void)n_frames;  // each pair names its frame
  if (n_pairs <= 0) return 0;
  const unsigned n_blocks = (unsigned)((n_pairs + kWarpsR - 1) / kWarpsR);
  lsi_split_redo_kernel<<<n_blocks, 32 * kWarpsR, 0, (cudaStream_t)stream>>>(
      rows, row_fs, row_cs, n_rows, cols, col_fs, col_cs, n_cols, starts, w, boxes, row_tile,
      raw_rows, rr_fs, rr_cs, raw_cols, rc_fs, rc_cs, starts_wide, w_wide, pairs, n_pairs, k_in,
      scratch, low_sq, high, high_sq, outer_sq, lsi, valid, count, shell);
  return (int)cudaGetLastError();
}
