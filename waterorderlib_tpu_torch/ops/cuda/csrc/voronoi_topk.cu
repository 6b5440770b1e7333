// K-nearest mirrored candidates of the device Voronoi search: the Hopper
// (sm_90a) kernel of the port's Voronoi volumes slice, one selection with
// two entry points.
//
// Replaces the Pallas TPU kernels of waterorderlib_tpu/ops/pallas/voronoi_topk.py:
// `_topk_pallas` (the pallas_call behind `voronoi_topk_pallas`, the z-window
// form) and `cellgrid_extract_pallas` (the cell-grid form), and the
// `lax.top_k` selections of surface/voronoi_device.py that lead on the TPU
// (`_windowed_topk`, `_cellgrid_topk(select="xla")`, and the full scan of
// `ops.pairs.topk_neighbors` in the last escalation tier). The candidate set
// is the mirrored point set in open space: no periodic wrap, no copies.
//
// For each center row and each candidate lane, in lane order:
//
//   d = center - candidate;  dsq = ((dx*dx) + (dy*dy)) + (dz*dz);
//
// (compiled with --fmad=false: no contraction into fmas, so the plain
// PyTorch versions in ops/cuda/voronoi_topk.py give the same dsq). A lane
// with dsq <= 0 (the center itself and any coincident mirror) or dsq = +inf
// (a parked empty slot) is dropped. The k smallest are kept in ascending
// order, ties to the lowest lane: the order of `lax.top_k` on -dsq and of a
// stable ascending sort. dist = sqrtf(dsq), correctly rounded; empty slots
// hold dist = +inf and payload -1.
//
// `voronoi_window_topk_launch`: rows are z-sorted centers in blocks of
// `row_block` rows; the rows of block b scan the `win` z-sorted candidates
// from starts[b] on, and the payload is the candidate's position in the
// sorted array (mapped back through the z-argsort by the caller). win = P
// with every start 0 is the full scan.
//
// `voronoi_cellgrid_topk_launch`: each row walks the 27 cells around its
// (clamped) grid cell in the order dz, dy, dx in (-1, 0, 1), and in each
// cell the `cap` slots of the bucketed table in table order; the payload is
// the table's int32 candidate id. The table is read as it is, not expanded
// 27-fold as the TPU's lane layout needed.
//
// What bounds it on this card: instructions, not bytes. The distance is 9
// float32 operations per (row, lane); the selection is a ballot per 32
// lanes, and for each lane that beats the current k-th distance an insertion
// into the row's sorted list (a ballot per 32 entries to find its place, a
// shift of the entries behind it). Most lanes fail the k-th distance once
// the list is full, so the insertions are some k (1 + ln(lanes / k)) a row.
//
// Launch: one warp per row, kWarps rows per block; each row's list, up to
// kMaxK (dsq, payload) pairs, in shared memory. The window form stages
// kTile candidates of the block's window in shared memory once for its
// rows (a block's rows lie in one row block, so they share one window).
// The cell-grid form reads its table slots from device memory (a frame's
// table is some 1 MB at 12,288 atoms and stays in L2). Frames are the
// slowest grid dimension: a frame batch is one launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxK = 256;
constexpr int kTile = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Offer the warp's 32 lanes, in lane order, to the row's sorted list
// (ld, lp) of cnt <= k entries. `real`: the lane holds a candidate.
__device__ void offer(float* ld, int* lp, int& cnt, int k, float d, int p, bool real) {
  const int lane = threadIdx.x & 31;
  const float thr = cnt == k ? ld[k - 1] : inf_f();
  unsigned m = __ballot_sync(kFull, real && d > 0.f && d < thr);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float dn = __shfl_sync(kFull, d, src);
    const int pn = __shfl_sync(kFull, p, src);
    if (cnt == k && !(dn < ld[k - 1])) continue;  // an earlier lane of this step raised the bar
    // its place: after every entry <= dn (earlier lanes win ties)
    int at = 0;
    for (int c = 0; c < cnt; c += 32) {
      const int j = c + lane;
      const unsigned b = __ballot_sync(kFull, j < cnt && ld[j] <= dn);
      at += __popc(b);
      if (b != kFull) break;
    }
    // entries [at, top) move up by one; the k-th falls off a full list
    const int top = min(cnt + 1, k) - 1;
    for (int c = (top - 1) & ~31; top > at && c >= (at & ~31); c -= 32) {
      const int j = c + lane;
      const bool mv = j >= at && j < top;
      float vd = 0.f;
      int vp = 0;
      if (mv) {
        vd = ld[j];
        vp = lp[j];
      }
      __syncwarp();
      if (mv) {
        ld[j + 1] = vd;
        lp[j + 1] = vp;
      }
      __syncwarp();
    }
    if (lane == 0) {
      ld[at] = dn;
      lp[at] = pn;
    }
    __syncwarp();
    cnt = top + 1;
  }
}

__device__ void emit(const float* ld, const int* lp, int cnt, int k, float* dist, int* pay) {
  for (int j = threadIdx.x & 31; j < k; j += 32) {
    dist[j] = j < cnt ? sqrtf(ld[j]) : inf_f();
    pay[j] = j < cnt ? lp[j] : -1;
  }
}

// centers (F, n_rows, 3) z-sorted rows, n_rows = n_blocks * row_block;
// exts (F, p4, 3) z-sorted candidates; starts (F, n_blocks) in [0, p4 - win].
__global__ void __launch_bounds__(kThreads)
window_topk_kernel(const float* __restrict__ centers, int n_rows, int row_block,
                   const float* __restrict__ exts, int p4, const int* __restrict__ starts,
                   int n_blocks, int win, int k, float* __restrict__ dist,
                   int* __restrict__ pos) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  __shared__ float s_d[kWarps][kMaxK];
  __shared__ int s_p[kWarps][kMaxK];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_sub = (row_block + kWarps - 1) / kWarps;
  const int sub = blockIdx.x % n_sub;
  const int rest = blockIdx.x / n_sub;
  const int blk = rest % n_blocks, f = rest / n_blocks;
  const int in_blk = sub * kWarps + warp;
  const bool active = in_blk < row_block;  // uniform in the warp
  const long long row = (long long)f * n_rows + (long long)blk * row_block + in_blk;
  const int start = starts[f * n_blocks + blk];
  const float* ext = exts + (long long)f * p4 * 3;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (active) {
    cx = centers[3 * row];
    cy = centers[3 * row + 1];
    cz = centers[3 * row + 2];
  }
  float* ld = s_d[warp];
  int* lp = s_p[warp];
  int cnt = 0;

  for (int t0 = 0; t0 < win; t0 += kTile) {
    const int nt = min(kTile, win - t0);
    __syncthreads();
    for (int t = threadIdx.x; t < nt; t += kThreads) {
      const float* e = ext + 3LL * (start + t0 + t);
      sx[t] = e[0];
      sy[t] = e[1];
      sz[t] = e[2];
    }
    __syncthreads();
    if (!active) continue;
    for (int j0 = 0; j0 < nt; j0 += 32) {
      const int j = j0 + lane;
      const bool real = j < nt;
      float d = 0.f;
      if (real) {
        const float dx = cx - sx[j], dy = cy - sy[j], dz = cz - sz[j];
        d = (dx * dx + dy * dy) + dz * dz;
      }
      offer(ld, lp, cnt, k, d, start + t0 + j, real);
    }
  }
  if (active) emit(ld, lp, cnt, k, dist + row * k, pos + row * k);
}

// centers (F, n_rows, 3); cid (F, n_rows) each row's clamped cell; tbl_pos
// (F, n_cells, 3, cap) the planes x, y, z of each cell's slots (+inf where
// empty); tbl_idx (F, n_cells, cap) the candidate ids (-1 where empty).
__global__ void __launch_bounds__(kThreads)
cellgrid_topk_kernel(const float* __restrict__ centers, const int* __restrict__ cid, int n_rows,
                     int n_frames, const float* __restrict__ tbl_pos,
                     const int* __restrict__ tbl_idx, int n_side, int cap, int k,
                     float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float s_d[kWarps][kMaxK];
  __shared__ int s_p[kWarps][kMaxK];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= (long long)n_frames * n_rows) return;  // uniform in the warp; no block barrier here
  const int f = (int)(row / n_rows);
  const long long n_cells = (long long)n_side * n_side * n_side;
  const float* tp = tbl_pos + f * n_cells * 3 * cap;
  const int* ti = tbl_idx + f * n_cells * cap;
  const int c0 = cid[row];
  const float cx = centers[3 * row], cy = centers[3 * row + 1], cz = centers[3 * row + 2];
  float* ld = s_d[warp];
  int* lp = s_p[warp];
  int cnt = 0;

  const int lanes = 27 * cap;
  for (int l0 = 0; l0 < lanes; l0 += 32) {
    const int l = l0 + lane;
    const bool real = l < lanes;
    float d = 0.f;
    int p = -1;
    if (real) {
      const int o = l / cap, slot = l - o * cap;
      const int oz = o / 9 - 1, oy = (o / 3) % 3 - 1, ox = o % 3 - 1;
      const long long cell = c0 + (oz * n_side + oy) * n_side + ox;
      const float* e = tp + cell * 3 * cap;
      const float dx = cx - e[slot], dy = cy - e[cap + slot], dz = cz - e[2 * cap + slot];
      d = (dx * dx + dy * dy) + dz * dz;
      p = ti[cell * cap + slot];
    }
    offer(ld, lp, cnt, k, d, p, real);
  }
  emit(ld, lp, cnt, k, dist + row * k, idx + row * k);
}

}  // namespace

// The z-window form: every row of block b of frame f against the win
// candidates of exts[f] from starts[f, b] on. pos: sorted positions.
extern "C" int voronoi_window_topk_launch(const float* centers, int n_rows, int row_block,
                                          const float* exts, int p4, const int* starts,
                                          int n_blocks, int win, int k, int n_frames,
                                          float* dist, int* pos, void* stream) {
  if (k < 1 || k > kMaxK || row_block < 1 || win < 1 || win > p4) return (int)cudaErrorInvalidValue;
  if (n_frames == 0 || n_blocks == 0) return 0;
  const long long n_sub = (row_block + kWarps - 1) / kWarps;
  const long long grid = n_sub * n_blocks * n_frames;
  window_topk_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      centers, n_rows, row_block, exts, p4, starts, n_blocks, win, k, dist, pos);
  return (int)cudaGetLastError();
}

// The cell-grid form: every row against the 27 cells around cid[f, row].
extern "C" int voronoi_cellgrid_topk_launch(const float* centers, const int* cid, int n_rows,
                                            const float* tbl_pos, const int* tbl_idx,
                                            int n_side, int cap, int k, int n_frames,
                                            float* dist, int* idx, void* stream) {
  if (k < 1 || k > kMaxK || n_side < 3 || cap < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n_rows * n_frames;
  if (rows == 0) return 0;
  cellgrid_topk_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0,
                         (cudaStream_t)stream>>>(centers, cid, n_rows, n_frames, tbl_pos,
                                                 tbl_idx, n_side, cap, k, dist, idx);
  return (int)cudaGetLastError();
}
