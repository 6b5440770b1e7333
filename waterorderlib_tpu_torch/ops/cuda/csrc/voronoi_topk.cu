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
// `voronoi_cellgrid_topk_launch`: each row takes the 27 cells around its
// (clamped) grid cell, lane o * cap + slot for slot `slot` of neighbor o (o
// in the order dz, dy, dx in (-1, 0, 1)); the payload is the table's int32
// candidate id. The table is read as it is, not expanded 27-fold as the
// TPU's lane layout needed.
//
// The z-window form. What bounds it on this card: the selection's
// instructions and the latency of its loads, not bytes (a frame's
// candidates, 590 KB at 12,294 points, stay in L2). The distance is 9
// float32 operations a (row, lane). The design:
// - Nearest first, with an exact stop. Each row finds its place c in its
//   window (the first candidate whose z is >= the row's, a binary search)
//   and scans outward on both sides, 32 candidates a step. Along a side
//   |fl(cz - z)| does not decrease (the z are sorted and lie on one side of
//   cz; rounding is monotone), and dsq = fl(fl(a + b) + fl(dz*dz)) with a,
//   b >= 0 is >= fl(dz*dz). So a side stops at the first candidate whose
//   fl(dz*dz) is strictly above the row's k-th dsq so far: nothing beyond it
//   can enter (one at exactly the k-th dsq and a lower position still can,
//   hence strict). Parked +inf slots sort last and stop their side. A row
//   then tests the candidates within about its k-th distance of it in z,
//   not its whole window.
// - No serial insertion: keys (dsq's bits << 32 | the sorted position) go
//   into WarpSelect (warp_select.cuh), whose k smallest keys do not depend
//   on the order in which they are offered; equal distances keep position
//   order.
// - Launches with few rows (the last tier's full scans: 64 rows a frame x
//   1-16 frames) give a row `split` warps (the wrapper's `_window_split`):
//   warp w of a row takes chunks w, w + split, ... of each side with a
//   WarpSelect of its own (offer returns whether it merged). After each
//   merge it publishes its list's entry ceil(k / split) - 1 in shared
//   memory; the largest published entry has at least k keys of the row at
//   or below it, so it bounds the row's k-th key and every warp of the row
//   filters and stops by it. At the end the row's first warp merges the
//   others' lists into its own.
// - Blocks of kWarps warps, kWarps / split rows of one row block; frames are
//   the slowest grid dimension: a frame batch is one launch. The candidates
//   are read through L1 and L2, not staged in shared memory: a block's rows
//   are adjacent in z, so their outward ranges overlap, and at tier 1 a
//   frame's candidates (64.5 KB at 2,048 waters) fit in L1 whole.
//
// The cell-grid form. What bounds it on this card: the selection's
// instructions. The lanes cost 9 float32 operations each (~650 filled
// lanes a row at tier 1, 27 cells of ~24 candidates), the bytes are the
// 100 MB of dist and idx a tier-1 launch writes; what a row pays beyond
// those is the work of keeping its k smallest. The design:
// - No serial insertion: a lane below the row's k-th key goes into a
//   buffer; every 32 buffered keys are sorted across the warp (a bitonic
//   sort of one key a lane) and merged into the row's sorted list of 32R >=
//   k keys, which lives in registers (WarpSelect, warp_select.cuh). A key
//   packs dsq's bits and the lane, so equal distances keep lane order.
//   Cells are read nearest first (the wrapper's `scan` order: the row's own
//   cell, its 6 face neighbors, 12 edge, 8 corner), so the k-th key falls
//   early: ~5 merges a row at tier 1.
// - Rows grouped by cell (where a frame's rows are at least GROUP_MIN = 16
//   to a cell, tier 1): the wrapper sorts the rows by cell; a block takes
//   GROUP_ROWS = 32 sorted rows and stages the 27-cell neighborhood of each
//   run of one cell among them in shared memory once, empty slots dropped,
//   so a neighborhood is read from L2 about once a block, not once a row.
//   Elsewhere (the escalation tiers, about one row to a cell) one warp a
//   row reads its cells from L2 (a frame's table is some 1 MB).
// - Buffers are sized from the launch: the list from k (R = 1, 2, 4 or 8
//   registers of keys), the staged neighborhood from cap (dynamic shared
//   memory, 38,768 B at cap 64).

#include <cuda_runtime.h>
#include <math.h>

#include "warp_select.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxK = 256;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// --- the z-window form ---------------------------------------------------------

// the first position in [lo, hi) whose z is >= cz (hi if none), the same in every lane
__device__ __forceinline__ int z_place(const float* ext, int lo, int hi, float cz) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ext[3 * mid + 2] < cz)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// entry i of a WarpSelect's list, in every lane
template <int R>
__device__ __forceinline__ u64 list_entry(const WarpSelect<R>& ws, int i) {
  u64 t = ws.L[0];
#pragma unroll
  for (int r = 1; r < R; ++r)
    if (r == (i >> 5)) t = ws.L[r];
  return __shfl_sync(kFull, t, i & 31);
}

// One side's chunk of 32 candidates, lane j = j0 + dir * lane, j in [s, e):
// offered unless the chunk's nearest candidate (lane 0) lies beyond the bound
// in z alone. Returns false when the side stops there.
template <int R>
__device__ __forceinline__ bool scan_chunk(WarpSelect<R>& ws, bool& merged, float cx, float cy,
                                           float cz, float x, float y, float z, bool in, int j,
                                           u64 bound) {
  const float dz = cz - z, dz2 = dz * dz;
  if (__shfl_sync(kFull, __float_as_uint(dz2), 0) > (unsigned)(bound >> 32))
    return false;
  const float dx = cx - x, dy = cy - y;
  const float d = (dx * dx + dy * dy) + dz2;
  const u64 key = ((u64)__float_as_uint(d) << 32) | (unsigned)j;
  merged |= ws.offer(in && d > 0.f && d < inf_f() && key < bound, key);
  return true;
}

// centers (F, n_rows, 3) z-sorted rows, n_rows = n_blocks * row_block;
// exts (F, p4, 3) z-sorted candidates; starts (F, n_blocks) in [0, p4 - win].
// S warps a row; `tested` (or null) gains the lanes offered.
template <int R, int S>
__global__ void __launch_bounds__(kThreads)
window_topk_kernel(const float* __restrict__ centers, int n_rows, int row_block,
                   const float* __restrict__ exts, int p4, const int* __restrict__ starts,
                   int n_blocks, int win, int k, float* __restrict__ dist, int* __restrict__ pos,
                   unsigned long long* __restrict__ tested) {
  constexpr int kRows = kWarps / S;  // rows a block
  __shared__ u64 s_buf[kWarps][kBuf];
  __shared__ u64 s_list[S > 1 ? kWarps : 1][32 * R];  // the lists of a row's other warps
  __shared__ volatile u64 s_pub[kWarps];               // each warp's published entry

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp / S, w = warp % S;
  const int n_sub = (row_block + kRows - 1) / kRows;
  const int sub = blockIdx.x % n_sub;
  const int rest = blockIdx.x / n_sub;
  const int blk = rest % n_blocks, f = rest / n_blocks;
  const int in_blk = sub * kRows + g;
  const bool active = in_blk < row_block;  // uniform in the row's warps
  const long long row = (long long)f * n_rows + (long long)blk * row_block + in_blk;
  const int s = starts[f * n_blocks + blk], e = s + win;
  const float* ext = exts + (long long)f * p4 * 3;
  if (S > 1) {
    if (lane == 0) s_pub[warp] = kSent;
    __syncthreads();
  }
  WarpSelect<R> ws;
  ws.init(s_buf[warp], k);
  unsigned long long n_tested = 0;
  if (active) {
    const float cx = centers[3 * row], cy = centers[3 * row + 1], cz = centers[3 * row + 2];
    const int c = z_place(ext, s, e, cz);
    const int at = (k + S - 1) / S - 1;  // the entry each warp publishes
    int jr = c + 32 * w, jl = c - 1 - 32 * w;  // each side's next chunk (its nearest candidate)
    while (jr < e || jl >= s) {
      u64 bound = ws.thr;
      if (S > 1) {
        u64 m = s_pub[g * S];
#pragma unroll
        for (int v = 1; v < S; ++v) m = umax64(m, s_pub[g * S + v]);
        bound = umin64(bound, m);
      }
      // both sides' loads first, so that both are in flight
      const int j_r = jr + lane, j_l = jl - lane;
      const bool in_r = j_r < e, in_l = j_l >= s;
      float xr = 0.f, yr = 0.f, zr = 0.f, xl = 0.f, yl = 0.f, zl = 0.f;
      if (in_r) {
        xr = ext[3LL * j_r];
        yr = ext[3LL * j_r + 1];
        zr = ext[3LL * j_r + 2];
      }
      if (in_l) {
        xl = ext[3LL * j_l];
        yl = ext[3LL * j_l + 1];
        zl = ext[3LL * j_l + 2];
      }
      bool merged = false;
      if (jr < e) {
        if (scan_chunk(ws, merged, cx, cy, cz, xr, yr, zr, in_r, j_r, bound)) {
          n_tested += min(32, e - jr);
          jr += 32 * S;
        } else {
          jr = e;
        }
      }
      if (jl >= s) {
        if (scan_chunk(ws, merged, cx, cy, cz, xl, yl, zl, in_l, j_l, bound)) {
          n_tested += min(32, jl - s + 1);
          jl -= 32 * S;
        } else {
          jl = s - 1;
        }
      }
      if (S > 1 && merged) {
        const u64 p = list_entry(ws, at);
        if (lane == 0) s_pub[warp] = p;
      }
    }
  }
  ws.flush();
  if (S > 1) {
    if (w != 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) s_list[warp][r * 32 + lane] = ws.L[r];
    }
    __syncthreads();
    if (w == 0 && active) {
      for (int v = 1; v < S; ++v) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const u64 key = s_list[warp + v][r * 32 + lane];
          ws.offer(key != kSent, key);
        }
      }
      ws.flush();
    }
  }
  if (w == 0 && active) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = r * 32 + lane;
      if (j < k) {
        const bool ok = ws.L[r] != kSent;
        dist[row * k + j] = ok ? sqrtf(__uint_as_float((unsigned)(ws.L[r] >> 32))) : inf_f();
        pos[row * k + j] = ok ? (int)(unsigned)(ws.L[r] & 0xffffffffu) : -1;
      }
    }
  }
  if (tested != nullptr && lane == 0 && n_tested > 0) atomicAdd(tested, n_tested);
}

// --- the cell-grid form (its selection: WarpSelect, warp_select.cuh) ---------

// flat offset of neighbor o (dz, dy, dx = o / 9, o / 3 % 3, o % 3, each - 1)
__device__ __forceinline__ int cell_offset(int o, int n_side) {
  return ((o / 9 - 1) * n_side + (o / 3) % 3 - 1) * n_side + o % 3 - 1;
}

__device__ __forceinline__ float dsq_of(float cx, float cy, float cz, float x, float y, float z) {
  const float dx = cx - x, dy = cy - y, dz = cz - z;
  return (dx * dx + dy * dy) + dz * dz;
}

__device__ __forceinline__ bool finite3(float x, float y, float z) {
  return isfinite(x) && isfinite(y) && isfinite(z);
}

// Grouped: the rows sorted by cell (`order`: each frame's rows, stably by
// their clamped cell, as global row ids), a block takes `group_rows`
// consecutive ones and, for each run of them in one cell of one frame,
// stages the 27 cells' slots with finite coordinates in shared memory once,
// cells in the order `scan`, slots in table order, each with its tag lane
// << 16 | staged position (lane = o * cap + slot, the plain version's lane);
// a slot left out has dsq +inf or NaN for every center, which the
// selection drops. Then each warp scans the staged slots for a row of the
// run at a time.
template <int R>
__global__ void __launch_bounds__(kThreads)
cellgrid_grouped_kernel(const float* __restrict__ centers, const int* __restrict__ cid, int n_rows,
                        int n_frames, const float* __restrict__ tbl_pos,
                        const int* __restrict__ tbl_idx, int n_side, int cap, int k,
                        const int* __restrict__ scan, const int* __restrict__ order,
                        int group_rows, float* __restrict__ dist, int* __restrict__ idx) {
  extern __shared__ u64 s_buf[];  // kWarps x kBuf keys, then the staged slots and their ids
  float4* s_pt = reinterpret_cast<float4*>(s_buf + kWarps * kBuf);
  int* s_id = reinterpret_cast<int*>(s_pt + 27 * cap);
  __shared__ int s_beg[28];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int total = n_rows * n_frames;
  const int first = blockIdx.x * group_rows;
  const int last = min(first + group_rows, total);
  const long long n_cells = (long long)n_side * n_side * n_side;
  for (int a = first; a < last;) {
    // the run [a, b): rows of one frame and one cell (the same in every thread)
    const int f = order[a] / n_rows;
    const int c0 = cid[order[a]];
    int b = a + 1;
    while (b < last && order[b] / n_rows == f && cid[order[b]] == c0) ++b;
    const float* tp = tbl_pos + f * n_cells * 3 * cap;
    const int* ti = tbl_idx + f * n_cells * cap;
    __syncthreads();  // the previous run's rows are done with the staged slots

    // 1. each cell's finite slots: counts, then their places
    for (int p = warp; p < 27; p += kWarps) {
      const float* e = tp + (c0 + cell_offset(scan[p], n_side)) * 3LL * cap;
      int n = 0;
      for (int s0 = 0; s0 < cap; s0 += 32) {
        const int slot = s0 + lane;
        n += __popc(__ballot_sync(kFull, slot < cap && finite3(e[slot], e[cap + slot],
                                                                e[2 * cap + slot])));
      }
      if (lane == 0) s_beg[p + 1] = n;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      s_beg[0] = 0;
      for (int p = 0; p < 27; ++p) s_beg[p + 1] += s_beg[p];
    }
    __syncthreads();
    // 2. stage them
    for (int p = warp; p < 27; p += kWarps) {
      const int o = scan[p];
      const long long cell = c0 + cell_offset(o, n_side);
      const float* e = tp + cell * 3 * cap;
      int at = s_beg[p];
      for (int s0 = 0; s0 < cap; s0 += 32) {
        const int slot = s0 + lane;
        float x = 0.f, y = 0.f, z = 0.f;
        bool fin = false;
        if (slot < cap) {
          x = e[slot];
          y = e[cap + slot];
          z = e[2 * cap + slot];
          fin = finite3(x, y, z);
        }
        const unsigned m = __ballot_sync(kFull, fin);
        if (fin) {
          const int j = at + __popc(m & ((1u << lane) - 1u));
          s_pt[j] = make_float4(x, y, z, __uint_as_float(((unsigned)(o * cap + slot) << 16) | j));
          s_id[j] = ti[cell * cap + slot];
        }
        at += __popc(m);
      }
    }
    __syncthreads();
    const int n_st = s_beg[27];

    // 3. the run's rows, one a warp at a time
    for (int t = a + warp; t < b; t += kWarps) {
      const long long row = order[t];
      const float cx = centers[3 * row], cy = centers[3 * row + 1], cz = centers[3 * row + 2];
      WarpSelect<R> ws;
      ws.init(s_buf + warp * kBuf, k);
      for (int j0 = 0; j0 < n_st; j0 += 32) {
        const int j = j0 + lane;
        bool real = j < n_st;
        u64 key = kSent;
        if (real) {
          const float4 e = s_pt[j];
          const float d = dsq_of(cx, cy, cz, e.x, e.y, e.z);
          real = d > 0.f && d < inf_f();
          key = ((u64)__float_as_uint(d) << 32) | __float_as_uint(e.w);
        }
        ws.offer(real, key);
      }
      ws.flush();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = r * 32 + lane;
        if (j < k) {
          const bool ok = ws.L[r] != kSent;
          dist[row * k + j] = ok ? sqrtf(__uint_as_float((unsigned)(ws.L[r] >> 32))) : inf_f();
          idx[row * k + j] = ok ? s_id[ws.L[r] & 0xffffu] : -1;
        }
      }
    }
    a = b;
  }
}

// Direct: one warp a row, reading its 27 cells (in the order `scan`) from
// device memory, for launches whose rows share few cells (the escalation
// tiers: about one row to an occupied cell, and cells too large to stage).
template <int R>
__global__ void __launch_bounds__(kThreads)
cellgrid_direct_kernel(const float* __restrict__ centers, const int* __restrict__ cid, int n_rows,
                       int n_frames, const float* __restrict__ tbl_pos,
                       const int* __restrict__ tbl_idx, int n_side, int cap, int k,
                       const int* __restrict__ scan, float* __restrict__ dist,
                       int* __restrict__ idx) {
  __shared__ u64 s_buf[kWarps][kBuf];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= (long long)n_frames * n_rows) return;  // uniform in the warp; no block barrier here
  const int f = (int)(row / n_rows);
  const long long n_cells = (long long)n_side * n_side * n_side;
  const float* tp = tbl_pos + f * n_cells * 3 * cap;
  const int* ti = tbl_idx + f * n_cells * cap;
  const int c0 = cid[row];
  const float cx = centers[3 * row], cy = centers[3 * row + 1], cz = centers[3 * row + 2];
  WarpSelect<R> ws;
  ws.init(s_buf[warp], k);
  for (int p = 0; p < 27; ++p) {
    const int o = scan[p];
    const float* e = tp + (c0 + cell_offset(o, n_side)) * 3LL * cap;
    for (int s0 = 0; s0 < cap; s0 += 32) {
      const int slot = s0 + lane;
      bool real = slot < cap;
      u64 key = kSent;
      if (real) {
        const float d = dsq_of(cx, cy, cz, e[slot], e[cap + slot], e[2 * cap + slot]);
        real = d > 0.f && d < inf_f();
        key = ((u64)__float_as_uint(d) << 32) | (unsigned)(o * cap + slot);
      }
      ws.offer(real, key);
    }
  }
  ws.flush();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = r * 32 + lane;
    if (j < k) {
      const bool ok = ws.L[r] != kSent;
      int id = -1;
      if (ok) {
        const int l = (int)(ws.L[r] & 0xffffffffu);
        const int o = l / cap;
        id = ti[(c0 + cell_offset(o, n_side)) * (long long)cap + (l - o * cap)];
      }
      dist[row * k + j] = ok ? sqrtf(__uint_as_float((unsigned)(ws.L[r] >> 32))) : inf_f();
      idx[row * k + j] = id;
    }
  }
}

// dynamic shared memory of a grouped block: the warps' buffers, the staged
// slots (x, y, z, tag) and their ids
__host__ __device__ constexpr long long grouped_smem(int cap) {
  return (long long)kWarps * kBuf * 8 + 27LL * cap * 20;
}
constexpr long long kSmemMax = 232448 - 28 * 4;  // the block's limit, less the static s_beg

template <int R>
int launch_cellgrid(const float* centers, const int* cid, int n_rows, const float* tbl_pos,
                    const int* tbl_idx, int n_side, int cap, int k, int n_frames, const int* scan,
                    const int* order, int group_rows, float* dist, int* idx, cudaStream_t stream) {
  if (order != nullptr) {
    const int smem = (int)grouped_smem(cap);
    cudaError_t e = cudaFuncSetAttribute(cellgrid_grouped_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const long long rows = (long long)n_rows * n_frames;
    cellgrid_grouped_kernel<R><<<(unsigned)((rows + group_rows - 1) / group_rows), kThreads, smem,
                                 stream>>>(centers, cid, n_rows, n_frames, tbl_pos, tbl_idx,
                                           n_side, cap, k, scan, order, group_rows, dist, idx);
  } else {
    const long long rows = (long long)n_rows * n_frames;
    cellgrid_direct_kernel<R><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
        centers, cid, n_rows, n_frames, tbl_pos, tbl_idx, n_side, cap, k, scan, dist, idx);
  }
  return (int)cudaGetLastError();
}

template <int R, int S>
int launch_window_s(const float* centers, int n_rows, int row_block, const float* exts, int p4,
                    const int* starts, int n_blocks, int win, int k, int n_frames,
                    unsigned long long* tested, float* dist, int* pos, cudaStream_t stream) {
  const long long n_sub = (row_block + kWarps / S - 1) / (kWarps / S);
  const long long grid = n_sub * n_blocks * n_frames;
  window_topk_kernel<R, S><<<(unsigned)grid, kThreads, 0, stream>>>(
      centers, n_rows, row_block, exts, p4, starts, n_blocks, win, k, dist, pos, tested);
  return (int)cudaGetLastError();
}

template <int R>
int launch_window(const float* centers, int n_rows, int row_block, const float* exts, int p4,
                  const int* starts, int n_blocks, int win, int k, int n_frames, int split,
                  unsigned long long* tested, float* dist, int* pos, cudaStream_t stream) {
  switch (split) {
    case 1:
      return launch_window_s<R, 1>(centers, n_rows, row_block, exts, p4, starts, n_blocks, win, k,
                                   n_frames, tested, dist, pos, stream);
    case 2:
      return launch_window_s<R, 2>(centers, n_rows, row_block, exts, p4, starts, n_blocks, win, k,
                                   n_frames, tested, dist, pos, stream);
    case 4:
      return launch_window_s<R, 4>(centers, n_rows, row_block, exts, p4, starts, n_blocks, win, k,
                                   n_frames, tested, dist, pos, stream);
    default:
      return launch_window_s<R, 8>(centers, n_rows, row_block, exts, p4, starts, n_blocks, win, k,
                                   n_frames, tested, dist, pos, stream);
  }
}

}  // namespace

// The z-window form: every row of block b of frame f against the win
// candidates of exts[f] from starts[f, b] on, `split` (1, 2, 4 or 8) warps a
// row. pos: sorted positions. `tested` (or null): gains the lanes offered.
extern "C" int voronoi_window_topk_launch(const float* centers, int n_rows, int row_block,
                                          const float* exts, int p4, const int* starts,
                                          int n_blocks, int win, int k, int n_frames, int split,
                                          unsigned long long* tested, float* dist, int* pos,
                                          void* stream) {
  if (k < 1 || k > kMaxK || row_block < 1 || win < 1 || win > p4 ||
      (split != 1 && split != 2 && split != 4 && split != 8))
    return (int)cudaErrorInvalidValue;
  if (n_frames == 0 || n_blocks == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (k <= 32)
    return launch_window<1>(centers, n_rows, row_block, exts, p4, starts, n_blocks, win, k,
                            n_frames, split, tested, dist, pos, st);
  if (k <= 64)
    return launch_window<2>(centers, n_rows, row_block, exts, p4, starts, n_blocks, win, k,
                            n_frames, split, tested, dist, pos, st);
  if (k <= 128)
    return launch_window<4>(centers, n_rows, row_block, exts, p4, starts, n_blocks, win, k,
                            n_frames, split, tested, dist, pos, st);
  return launch_window<8>(centers, n_rows, row_block, exts, p4, starts, n_blocks, win, k,
                          n_frames, split, tested, dist, pos, st);
}

// The cell-grid form: every row against the 27 cells around cid[f, row],
// `scan` (27 ints) the order in which the cells are read. With `order` (the
// rows sorted by cell, see cellgrid_grouped_kernel) the grouped mapping,
// `group_rows` sorted rows a block; without it the direct one.
extern "C" int voronoi_cellgrid_topk_launch(const float* centers, const int* cid, int n_rows,
                                            const float* tbl_pos, const int* tbl_idx,
                                            int n_side, int cap, int k, int n_frames,
                                            const int* scan, const int* order, int group_rows,
                                            float* dist, int* idx, void* stream) {
  if (k < 1 || k > kMaxK || n_side < 3 || cap < 1) return (int)cudaErrorInvalidValue;
  if (order != nullptr && (group_rows < 1 || grouped_smem(cap) > kSmemMax || 27LL * cap > 0xffff))
    return (int)cudaErrorInvalidValue;
  if ((long long)n_rows * n_frames == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (k <= 32)
    return launch_cellgrid<1>(centers, cid, n_rows, tbl_pos, tbl_idx, n_side, cap, k, n_frames,
                              scan, order, group_rows, dist, idx, st);
  if (k <= 64)
    return launch_cellgrid<2>(centers, cid, n_rows, tbl_pos, tbl_idx, n_side, cap, k, n_frames,
                              scan, order, group_rows, dist, idx, st);
  if (k <= 128)
    return launch_cellgrid<4>(centers, cid, n_rows, tbl_pos, tbl_idx, n_side, cap, k, n_frames,
                              scan, order, group_rows, dist, idx, st);
  return launch_cellgrid<8>(centers, cid, n_rows, tbl_pos, tbl_idx, n_side, cap, k, n_frames,
                            scan, order, group_rows, dist, idx, st);
}
