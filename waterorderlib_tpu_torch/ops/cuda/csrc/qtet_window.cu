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
//     minimum-image dsq (coordinates wrapped), the (low, high] shell test,
//     the shell count, and the 4 nearest shell neighbors;
//   epilogue: their minimum-image displacements (two compare-selects),
//     unit vectors, the 6 pair cosines in the fixed order
//     (0,1),(0,2),(0,3),(1,2),(1,3),(2,3), clipped, with cos = -1 for a pair
//     that misses a neighbor (the 180-degree padding rule),
//     q = 1 - 3/8 sum (cos + 1/3)^2, q = 0 when the shell is empty,
//     ok = 4th slot filled && its dsq <= margin^2.
//
// Tie-break: equal distances keep the lowest column first -- the rule of
// slab.extract_k_min that makes the JAX tiers bit-identical. A list visits
// its columns in ascending order and takes a candidate only when strictly
// nearer; lists are merged by the key (dsq's bits << 32) | window column
// (dsq > low^2 >= 0, so bit order is value order).
//
// What bounds it on this card: instruction issue. Each pair costs ~14 FP32
// operations plus the shell test; the window's coordinates are read once
// per block from device memory (12 bytes a column) and then from shared
// memory, so device-memory traffic is a few percent of the time. The TPU
// kernel kept an (r, w) distance scratch in VMEM and swept it 4 times; here
// each pair is visited once and there is no cap on the window width.
// Built with --fmad=false and without fast math, so dsq, the tie-breaks and
// `ok` match the plain version (ops/cuda/qtet2.py).
//
// The layout, for that bound:
// - The scan's minimum image is taken by magnitude: fminf(|d|, L - |d|)
//   squares to the compare-selects' mi(d)^2 bit for bit for d in (-2L, 2L)
//   (IEEE subtraction is sign-symmetric and rounding monotone; pad copies
//   lie within +/-L), 3 instructions an axis in place of ~7. No signed
//   displacement is carried through the scan: the epilogue recomputes each
//   slot's from its column with the compare-selects, so the 4 vectors and
//   everything after them are the operations of the plain version.
// - The serial form ran its 4-slot ladder, divergent, for every shell hit
//   nearer than the 4th so far; z-sorted columns make most hits near the
//   row's own z such ones, and the ladder took half the kernel's time (the
//   serial kernel with its ladder cut out: 6.354 against 13.060 ms at 4096
//   rows x 1024 frames, w 1664; ab_voronoi.py --mappings on an H100 80GB
//   HBM3, 700 W). Here a list takes a hit only when dsq <= filt =
//   min(margin^2, kFilter^2) (~13 of a row's ~140 shell neighbors lie within
//   4.5 A at water density), and the insertion is branch-free under a warp
//   vote, so most columns run none. If at least 4 shell neighbors lie within
//   filt, the 4 nearest all do; a row with fewer within filt and more in its
//   shell (its `ok` fails wherever margin <= kFilter) is scanned again taking
//   every hit. kFilter is a speed choice only: no result depends on it.
// - Two forms of the scan, one body of arithmetic. The row form: one row a
//   thread (kRows rows a block), every lane reading the same 4 columns at a
//   time (16-byte broadcast loads, one vote for the 4); a row's list holds
//   its own 4 nearest, so few hits enter it. The lane form: kLaneRows rows
//   a warp with lanes strided over the window (lane j: the columns j, j +
//   32, ...), each lane a list of its own for each row, merged by key in 4
//   rounds of a warp minimum, the count an integer sum over the lanes. A
//   launch of at least kRowFormMin rows (frames x rows) takes the row form,
//   a smaller one the lane form: row 4's one-frame call of 4096 rows runs
//   256 blocks of 16 rows on the 132 SMs, where the row form's 64 blocks of
//   one long scan a thread wait on latency. (ab_voronoi.py --mappings, as
//   above; ms a launch, row / lane form: 4096 rows x 1024 frames, w 1664,
//   7.717 / 9.716; one frame of 4096 rows, w 4096, 0.160 / 0.064-0.110.)
// - A block's rows lie inside one window tile of `row_tile` rows.
//
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

typedef unsigned long long u64;
constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kSent = ~0ull;  // an empty slot of the lane form's merge: above every real key
constexpr int kCols = 512;
constexpr int kBins = 500;
constexpr int kTop = 4;
constexpr float kFilter = 4.5f;  // A: a list takes shell hits within min(margin, this)
// the row form: one row a thread
constexpr int kRows = 64;  // rows a block
// the lane form: kLaneRows rows a warp, lanes strided over the window
constexpr int kLaneRows = 4;
constexpr int kLaneWarps = 4;  // warps a block
constexpr int kLaneBlockRows = kLaneRows * kLaneWarps;
// launches of at least kRowFormMin rows (frames x rows) take the row form
constexpr long long kRowFormMin = 65536;
static_assert(128 % kRows == 0 && 128 % kLaneBlockRows == 0,
              "a block's rows must lie in one 128-row tile");
static_assert(kLaneRows <= 32, "the lane form's epilogue runs one row a lane");
static_assert(kCols % 4 == 0, "the row form reads columns 4 at a time");

__device__ __forceinline__ float min_image(float d, float box, float half) {
  // coordinates are wrapped into [0, L) (pad copies within +/-L), so two
  // compare-selects replace round()
  d = d > half ? d - box : d;
  return d < -half ? d + box : d;
}

// a value whose square is min_image(d, box, box / 2)^2, bit for bit (header)
__device__ __forceinline__ float mi_abs(float d, float box) {
  const float a = fabsf(d);
  return fminf(a, box - a);
}

__device__ __forceinline__ u64 umin64(u64 a, u64 b) { return a < b ? a : b; }

// kTop nearest so far: (dsq, window column), ascending; +inf where empty.
struct Top4 {
  float d[kTop];
  int c[kTop];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < kTop; ++k) {
      d[k] = __int_as_float(0x7f800000);
      c[k] = 0;
    }
  }

  // enter (dsq, col) where `take` (dsq < d[kTop - 1]), branch-free; columns
  // come in ascending order, so an entry equal to one already held goes
  // after it (the lowest column first)
  __device__ __forceinline__ void insert(bool take, float dsq, int col) {
    bool p[kTop];
#pragma unroll
    for (int k = 0; k < kTop; ++k) p[k] = take && dsq < d[k];
#pragma unroll
    for (int k = kTop - 1; k > 0; --k) {
      d[k] = p[k - 1] ? d[k - 1] : (p[k] ? dsq : d[k]);
      c[k] = p[k - 1] ? c[k - 1] : (p[k] ? col : c[k]);
    }
    d[0] = p[0] ? dsq : d[0];
    c[0] = p[0] ? col : c[0];
  }

  __device__ __forceinline__ int found() const {
    int n = 0;
#pragma unroll
    for (int k = 0; k < kTop; ++k) n += d[k] < __int_as_float(0x7f800000) ? 1 : 0;
    return n;
  }

  // the lane form: the warp's kTop smallest (dsq bits << 32) | column keys
  // over every lane's list, ascending, into this list in every lane: kTop
  // rounds of a warp minimum, the winning lane's list moving up one
  __device__ __forceinline__ void merge_warp() {
    u64 key[kTop];
#pragma unroll
    for (int k = 0; k < kTop; ++k)
      key[k] = d[k] < __int_as_float(0x7f800000)
                   ? ((u64)__float_as_uint(d[k]) << 32) | (unsigned)c[k] : kSent;
#pragma unroll
    for (int t = 0; t < kTop; ++t) {
      u64 m = key[0];
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) m = umin64(m, __shfl_xor_sync(kFull, m, s));
      d[t] = m != kSent ? __uint_as_float((unsigned)(m >> 32)) : __int_as_float(0x7f800000);
      c[t] = (int)(unsigned)m;
      if (key[0] == m && m != kSent) {  // one lane: the columns differ
#pragma unroll
        for (int k = 0; k < kTop - 1; ++k) key[k] = key[k + 1];
        key[kTop - 1] = kSent;
      }
    }
  }
};

// q of one row from its shell count and its nearest slots (the slots below
// min(count, kTop) filled): each slot's displacement recomputed from its
// column as the plain version takes it, then the plain version's operations
__device__ __forceinline__ float q_of(const Top4& t, int count, const float* cx, const float* cy,
                                      const float* cz, float xr, float yr, float zr, float bx,
                                      float by, float bz) {
  const float hx = bx * 0.5f, hy = by * 0.5f, hz = bz * 0.5f;
  float ux[kTop], uy[kTop], uz[kTop];
#pragma unroll
  for (int k = 0; k < kTop; ++k) {
    ux[k] = uy[k] = uz[k] = 0.f;
    if (k < count) {
      const int j = t.c[k];
      ux[k] = min_image(cx[j] - xr, bx, hx);
      uy[k] = min_image(cy[j] - yr, by, hy);
      uz[k] = min_image(cz[j] - zr, bz, hz);
    }
  }
#pragma unroll
  for (int k = 0; k < kTop; ++k) {
    const float nrm = sqrtf(ux[k] * ux[k] + uy[k] * uy[k] + uz[k] * uz[k]);
    const float inv = nrm > 0.f ? 1.0f / nrm : 0.f;
    ux[k] *= inv;
    uy[k] *= inv;
    uz[k] *= inv;
  }
  float ssum = 0.f;
#pragma unroll
  for (int a = 0; a < kTop; ++a) {
#pragma unroll
    for (int b = a + 1; b < kTop; ++b) {
      float cosv = ux[a] * ux[b] + uy[a] * uy[b] + uz[a] * uz[b];
      // slot b is filled iff more than b shell neighbors were seen (b > a)
      cosv = count > b ? fminf(fmaxf(cosv, -1.0f), 1.0f) : -1.0f;
      const float t3 = cosv + 1.0f / 3.0f;
      ssum = ssum + t3 * t3;
    }
  }
  return count > 0 ? 1.0f - 0.375f * ssum : 0.0f;
}

// the fused histogram: the block's rows binned in shared memory (`live`
// rows with q in [0, 1]), then each non-zero bin added to device memory
__device__ __forceinline__ void bin_block(int* s_hist, int* hist, bool live, float q) {
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) s_hist[b] = 0;
  __syncthreads();
  if (live && q >= 0.0f && q <= 1.0f) {
    const int b = q == 1.0f ? kBins - 1 : (int)floorf(q * (float)kBins);
    if (b < kBins) atomicAdd(&s_hist[b], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) {
    if (s_hist[b]) atomicAdd(hist + b, s_hist[b]);
  }
}

// The row form's pass over the window through shared memory: the shell
// count, and each shell hit with dsq <= filt that is nearer than the row's
// 4th so far entered into its list. Columns go 4 at a time (16-byte loads
// of every lane's same 4 columns, one vote for the 4; a tile's tail up to a
// multiple of 4 is NaN, in no shell). `scan`: the warp computes (the
// staging and the barriers are the block's either way).
__device__ __forceinline__ void row_pass(const float* __restrict__ cx,
                                         const float* __restrict__ cy,
                                         const float* __restrict__ cz, int w, float* sx, float* sy,
                                         float* sz, bool scan, float xr, float yr, float zr,
                                         float bx, float by, float bz, float low_sq,
                                         float high_sq, float filt, Top4& t, int& cnt) {
  for (int c0 = 0; c0 < w; c0 += kCols) {
    const int nc = min(kCols, w - c0);
    const int nc4 = (nc + 3) & ~3;
    __syncthreads();
    for (int c = threadIdx.x; c < nc4; c += kRows) {
      const bool in = c < nc;
      sx[c] = in ? cx[c0 + c] : nanf("");
      sy[c] = in ? cy[c0 + c] : 0.f;
      sz[c] = in ? cz[c0 + c] : 0.f;
    }
    __syncthreads();
    if (!scan) continue;
    for (int c = 0; c < nc4; c += 4) {
      const float4 X = *reinterpret_cast<const float4*>(sx + c);
      const float4 Y = *reinterpret_cast<const float4*>(sy + c);
      const float4 Z = *reinterpret_cast<const float4*>(sz + c);
      const float xs[4] = {X.x, X.y, X.z, X.w}, ys[4] = {Y.x, Y.y, Y.z, Y.w};
      const float zs[4] = {Z.x, Z.y, Z.z, Z.w};
      float dsq[4];
      bool take[4], any = false;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float ex = mi_abs(xs[k] - xr, bx);
        const float ey = mi_abs(ys[k] - yr, by);
        const float ez = mi_abs(zs[k] - zr, bz);
        dsq[k] = ex * ex + ey * ey + ez * ez;
        const bool shell = dsq[k] > low_sq && dsq[k] <= high_sq;
        cnt += shell ? 1 : 0;
        take[k] = shell && dsq[k] <= filt && dsq[k] < t.d[kTop - 1];
        any = any || take[k];
      }
      if (!__any_sync(kFull, any)) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) t.insert(take[k], dsq[k], c0 + c + k);  // in column order
    }
  }
}

struct Args {
  const float* rows;
  long long row_fs, row_cs;
  int n_rows;
  const float* cols;
  long long col_fs, col_cs;
  int n_cols;
  const int* starts;
  long long starts_fs;
  int w;
  const float* boxes;
  int blocks_per_frame, row_tile;
  float low_sq, high_sq, margin_sq;
  float* q_out;
  unsigned char* ok_out;
  int* hist;
};

// the block's frame and window; false (rows written NaN) for a window
// outside the columns
__device__ __forceinline__ bool block_window(const Args& a, int block_rows, int* f, int* rb,
                                             int* start) {
  *f = blockIdx.x / a.blocks_per_frame;
  *rb = blockIdx.x - *f * a.blocks_per_frame;
  *start = a.starts[*f * a.starts_fs + (*rb * block_rows) / a.row_tile];
  if (*start >= 0 && *start <= a.n_cols - a.w) return true;
  const int row = *rb * block_rows + threadIdx.x;
  if (threadIdx.x < block_rows && row < a.n_rows) {
    a.q_out[(long long)*f * a.n_rows + row] = nanf("");
    a.ok_out[(long long)*f * a.n_rows + row] = 0;
  }
  return false;
}

template <bool kHist>
__global__ void __launch_bounds__(kRows) qtet_row_kernel(Args a) {
  __shared__ __align__(16) float sx[kCols], sy[kCols], sz[kCols];
  __shared__ int s_hist[kHist ? kBins : 1];
  int f, rb, start;
  if (!block_window(a, kRows, &f, &rb, &start)) return;  // the whole block
  const int row = rb * kRows + threadIdx.x;
  const bool live = row < a.n_rows;
  const float bx = a.boxes[3 * f + 0], by = a.boxes[3 * f + 1], bz = a.boxes[3 * f + 2];
  // a row past n_rows has NaN coordinates: no column lies in its shell
  float xr = nanf(""), yr = 0.f, zr = 0.f;
  if (live) {
    const float* r = a.rows + f * a.row_fs + row;
    xr = r[0];
    yr = r[a.row_cs];
    zr = r[2 * a.row_cs];
  }
  const float* cx = a.cols + f * a.col_fs + start;
  const float* cy = cx + a.col_cs;
  const float* cz = cx + 2 * a.col_cs;

  Top4 t;
  t.clear();
  int count = 0;
  row_pass(cx, cy, cz, a.w, sx, sy, sz, true, xr, yr, zr, bx, by, bz, a.low_sq, a.high_sq,
           fminf(a.margin_sq, kFilter * kFilter), t, count);
  // fewer than 4 hits within the filter and more in the shell: the 4
  // nearest may lie beyond it, so such rows scan again taking every hit
  const int found = t.found();
  const bool again = found < kTop && count > found;
  if (__syncthreads_or(again)) {
    if (again) t.clear();
    int unused = 0;
    row_pass(cx, cy, cz, a.w, sx, sy, sz, __any_sync(kFull, again), xr, yr, zr, bx, by, bz,
             a.low_sq, a.high_sq, again ? a.high_sq : -1.f, t, unused);
  }
  const float q = live ? q_of(t, count, cx, cy, cz, xr, yr, zr, bx, by, bz) : 0.f;
  if (live) {
    const long long o = (long long)f * a.n_rows + row;
    a.q_out[o] = q;
    a.ok_out[o] = (count >= kTop && t.d[kTop - 1] <= a.margin_sq) ? 1 : 0;
  }
  if constexpr (kHist) bin_block(s_hist, a.hist, live, q);
}

template <bool kHist>
__global__ void __launch_bounds__(32 * kLaneWarps) qtet_lane_kernel(Args a) {
  __shared__ float sx[kCols], sy[kCols], sz[kCols];
  __shared__ int s_hist[kHist ? kBins : 1];
  int f, rb, start;
  if (!block_window(a, kLaneBlockRows, &f, &rb, &start)) return;  // the whole block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float bx = a.boxes[3 * f + 0], by = a.boxes[3 * f + 1], bz = a.boxes[3 * f + 2];
  // this warp's rows; a row past n_rows has NaN coordinates
  const int row0 = rb * kLaneBlockRows + warp * kLaneRows;
  float xr[kLaneRows], yr[kLaneRows], zr[kLaneRows];
  int cnt[kLaneRows];
  Top4 t[kLaneRows];
#pragma unroll
  for (int r = 0; r < kLaneRows; ++r) {
    const bool live = row0 + r < a.n_rows;
    const float* p = a.rows + f * a.row_fs + (live ? row0 + r : 0);
    xr[r] = live ? p[0] : nanf("");
    yr[r] = p[a.row_cs];
    zr[r] = p[2 * a.row_cs];
    cnt[r] = 0;
    t[r].clear();
  }
  const float filt = fminf(a.margin_sq, kFilter * kFilter);
  const float* cx = a.cols + f * a.col_fs + start;
  const float* cy = cx + a.col_cs;
  const float* cz = cx + 2 * a.col_cs;
  for (int c0 = 0; c0 < a.w; c0 += kCols) {
    const int nc = min(kCols, a.w - c0);
    __syncthreads();
    for (int c = threadIdx.x; c < nc; c += 32 * kLaneWarps) {
      sx[c] = cx[c0 + c];
      sy[c] = cy[c0 + c];
      sz[c] = cz[c0 + c];
    }
    __syncthreads();
    for (int j0 = 0; j0 < nc; j0 += 32) {
      const int c = j0 + lane;  // < kCols: a lane past nc reads a stale entry, counted never
      const float x = sx[c], y = sy[c], z = sz[c];
      const bool in_col = c < nc;
      float dsq[kLaneRows];
      bool take[kLaneRows], any = false;
#pragma unroll
      for (int r = 0; r < kLaneRows; ++r) {
        const float ex = mi_abs(x - xr[r], bx);
        const float ey = mi_abs(y - yr[r], by);
        const float ez = mi_abs(z - zr[r], bz);
        dsq[r] = ex * ex + ey * ey + ez * ez;
        const bool shell = in_col && dsq[r] > a.low_sq && dsq[r] <= a.high_sq;
        cnt[r] += shell ? 1 : 0;
        take[r] = shell && dsq[r] <= filt && dsq[r] < t[r].d[kTop - 1];
        any = any || take[r];
      }
      if (__ballot_sync(kFull, any) == 0u) continue;
#pragma unroll
      for (int r = 0; r < kLaneRows; ++r) {
        if (__ballot_sync(kFull, take[r]) != 0u) t[r].insert(take[r], dsq[r], c0 + c);
      }
    }
  }
  // per row: the count, the 4 nearest over the lanes' lists; a row whose
  // filtered lists cannot hold its 4 nearest is scanned again by its warp,
  // every shell hit taken, from device memory
#pragma unroll
  for (int r = 0; r < kLaneRows; ++r) {
    cnt[r] = (int)__reduce_add_sync(kFull, (unsigned)cnt[r]);
    t[r].merge_warp();
    const int found = t[r].found();
    if (found < kTop && cnt[r] > found) {  // the same in every lane
      t[r].clear();
      for (int c = lane; c < a.w; c += 32) {
        const float ex = mi_abs(cx[c] - xr[r], bx);
        const float ey = mi_abs(cy[c] - yr[r], by);
        const float ez = mi_abs(cz[c] - zr[r], bz);
        const float dsq = ex * ex + ey * ey + ez * ez;
        t[r].insert(dsq > a.low_sq && dsq <= a.high_sq && dsq < t[r].d[kTop - 1], dsq, c);
      }
      t[r].merge_warp();
    }
  }
  // the epilogue: row `lane` of the warp in lane `lane`
  Top4 mine = t[0];
  int count = cnt[0];
  float xo = xr[0], yo = yr[0], zo = zr[0];
#pragma unroll
  for (int r = 1; r < kLaneRows; ++r) {
    if (lane == r) {
      mine = t[r];
      count = cnt[r];
      xo = xr[r];
      yo = yr[r];
      zo = zr[r];
    }
  }
  const int row = row0 + lane;
  const bool live = lane < kLaneRows && row < a.n_rows;
  const float q = live ? q_of(mine, count, cx, cy, cz, xo, yo, zo, bx, by, bz) : 0.f;
  if (live) {
    const long long o = (long long)f * a.n_rows + row;
    a.q_out[o] = q;
    a.ok_out[o] = (count >= kTop && mine.d[kTop - 1] <= a.margin_sq) ? 1 : 0;
  }
  if constexpr (kHist) bin_block(s_hist, a.hist, live, q);
}

template <bool kHist>
int launch(const float* rows, long long row_fs, long long row_cs, int n_rows, const float* cols,
           long long col_fs, long long col_cs, int n_cols, const int* starts, int w,
           const float* boxes, int n_frames, int row_tile, long long starts_fs, float low_sq,
           float high_sq, float margin_sq, float* q_out, unsigned char* ok_out, int* hist,
           void* stream) {
  const bool row_form = (long long)n_frames * n_rows >= kRowFormMin;
  const int block_rows = row_form ? kRows : kLaneBlockRows;
  const int blocks_per_frame = (n_rows + block_rows - 1) / block_rows;
  const long long n_blocks = (long long)blocks_per_frame * n_frames;
  if (n_blocks == 0) return 0;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const Args a{rows,     row_fs, row_cs,           n_rows,    cols,     col_fs,   col_cs,
               n_cols,   starts, starts_fs,        w,         boxes,    blocks_per_frame,
               row_tile, low_sq, high_sq,          margin_sq, q_out,    ok_out,   hist};
  if (row_form) {
    qtet_row_kernel<kHist><<<(unsigned)n_blocks, kRows, 0, (cudaStream_t)stream>>>(a);
  } else {
    qtet_lane_kernel<kHist><<<(unsigned)n_blocks, 32 * kLaneWarps, 0, (cudaStream_t)stream>>>(a);
  }
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
