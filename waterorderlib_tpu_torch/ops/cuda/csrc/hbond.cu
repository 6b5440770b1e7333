// H-bond counts per acceptor and per donor: the Hopper (sm_90a) kernels of
// the port's H-bond slice, one kernel body with two entry points.
//
// `hbond_dense_launch` replaces the Pallas TPU kernel
// waterorderlib_tpu/ops/pallas/hbond_kernel.py `_kernel` (the pallas_call of
// `hbond_counts`): every acceptor against every donor. `hbond_slab_launch`
// replaces waterorderlib_tpu/ops/pallas/hbond_slab.py `_make_kernel` (the
// pallas_call of `hbond_counts_slab`): each tile of 128 z-sorted acceptors
// against one window of w columns of the z-sorted, boundary-extended donors.
//
// For each (acceptor A, donor D with hydrogen H and unit vector vhat of
// mi(D - H)), coordinates wrapped by the caller:
//   d = mi(D - A), dsq = |d|^2; the pair bonds when
//   dsq <= dist_sq, dsq > 1e-2 (self pairs), and u . vhat <= cos_cut * |u|
//   with u = mi(A - H) -- the D-H...A angle at the hydrogen is >= ang_cut.
// mi() is two compare-selects, as the TPU kernels' (all coordinates in
// [0, L): the slab form's boundary copies keep their sources' coordinates,
// so a pair meets the same operations in both forms). Sums of products are
// fmaf chains in the order XLA's CPU backend contracts the TPU kernels'
// `a0*b0 + a1*b1 + a2*b2` (fma(a2, b2, fma(a0, b0, a1*b1))); compiled with
// --fmad=false and IEEE sqrtf, so the plain PyTorch versions
// (ops/cuda/hbond.py) give the same counts.
//
// The distance test takes the minimum image by magnitude. For d in (-L, L),
// |mi(d)| = fminf(|d|, L - |d|) bit for bit: half = L * 0.5 is exact; IEEE
// subtraction is sign-symmetric, so the compare-selects' |d - L| (d > half)
// and |d + L| (d < -half) are both L - |d| rounded once; rounding is
// monotone, so L - |d| >= half >= |d| when |d| <= half (no wrap: fminf
// keeps |d|) and L - |d| <= half < |d| otherwise (fminf keeps L - |d|).
// dsq needs only magnitudes (x * x = |x| * |x|), so it is the same dot3 of
// the same values: subtract, subtract from L and min, 3 instructions an axis
// (the abs is an operand modifier) where the compare-selects took ~7. The
// angle test needs the signed u and keeps the compare-selects; it runs only
// for the pairs within the cut (~0.15% at water density).
//
// What bounds it on this card: instruction issue. A pair costs 9 for the
// minimum image, 3 for dsq and a compare; the angle test (~25) runs for the
// rare pairs within the cut; the donors' 36 bytes are read once per block
// from device memory (12 of them staged, the rest read only by the rare
// pairs). The design keeps the loop near those 13 a pair:
// - Register blocking: a block is one tile of kRows = 128 acceptors (the
//   slab form's contract: one window a 128-acceptor tile, so a block's
//   acceptors share it), kAcc = 8 a thread, so kGroups = 8 groups of 16
//   threads (half warps) each hold all 128 and take every 8th column. A
//   column is one broadcast LDS.128 of (x, y, z, pad) that serves 8 pairs
//   (a warp's two halves read two columns in one instruction). On the card
//   (ab_voronoi.py --mappings; H100 80GB HBM3, 700 W) 8 a thread beat 4, 2
//   and 1: 19.74 against 22.19, 24.89 and 34.35 ms the dense launch of
//   4096 waters x 1024 frames.
// - No per-column vote: the TPU kernel carried both sums across its
//   sequential grid; here a donor's count over the block is a shared
//   counter per staged column that a bonding lane raises by a shared-memory
//   atomicAdd, and the nonzero counters go to device memory with one
//   integer atomicAdd each after the tile. The acceptor counts are summed
//   over the groups in shared memory. Integer sums make the counts exact
//   and independent of the blocks' order.
//
// Launch: one block of kRows threads per (frame, acceptor tile of kRows
// rows); donors stream through shared memory in tiles of kCols. A window
// start outside the donor array gives count -1 for the tile's acceptors
// and adds nothing to donors. A dense launch's last tile may hold fewer
// than kRows acceptors: the missing ones take part in the loop with zero
// coordinates and are never counted.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 128;            // acceptors a block: one slab tile
constexpr int kAcc = 8;               // acceptors a thread
constexpr int kGroup = kRows / kAcc;  // threads that hold the block's acceptors once
constexpr int kGroups = kAcc;         // such groups; each takes every kGroups-th column
constexpr int kCols = 512;

__device__ __forceinline__ float min_image(float d, float box, float half) {
  d = d > half ? d - box : d;
  return d < -half ? d + box : d;
}

// |min_image(d, box, box / 2)| for d in (-box, box), bit for bit (header)
__device__ __forceinline__ float mi_abs(float d, float box) {
  const float a = fabsf(d);
  return fminf(a, box - a);
}

__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
  return fmaf(a2, b2, fmaf(a0, b0, a1 * b1));
}

// acc (F, 3, n_acc), don / donh / vhat (F, 3, n_don): contiguous float32.
// starts (F, n_tiles) int32 window starts, or null for all n_don donors.
__global__ void __launch_bounds__(kRows)
hbond_kernel(const float* __restrict__ acc, int n_acc, const float* __restrict__ don,
             const float* __restrict__ donh, const float* __restrict__ vhat, int n_don,
             const int* __restrict__ starts, int w, const float* __restrict__ boxes,
             int blocks_per_frame, float dist_sq, float cos_cut, int* __restrict__ acc_cnt,
             int* __restrict__ don_cnt) {
  __shared__ float4 s_don[kCols];
  __shared__ int s_cnt[kCols];
  __shared__ int s_acc[kGroups][kRows];

  const int f = blockIdx.x / blocks_per_frame;
  const int rb = blockIdx.x - f * blocks_per_frame;
  const int t = threadIdx.x;
  const int g = t / kGroup, i = t - g * kGroup;
  const int row0 = rb * kRows;

  const float bx = boxes[3 * f + 0], by = boxes[3 * f + 1], bz = boxes[3 * f + 2];
  const float hx = bx * 0.5f, hy = by * 0.5f, hz = bz * 0.5f;

  int start = 0;
  if (starts != nullptr) {
    start = starts[(long long)f * blocks_per_frame + rb];
    if (start < 0 || start > n_don - w) {
      if (row0 + t < n_acc) acc_cnt[(long long)f * n_acc + row0 + t] = -1;
      return;
    }
  }

  // acceptors i, i + kGroup, ... of the tile
  float xa[kAcc], ya[kAcc], za[kAcc];
  bool live[kAcc];
  int count[kAcc];
  const float* a = acc + (long long)f * 3 * n_acc;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int row = row0 + i + k * kGroup;
    live[k] = row < n_acc;
    xa[k] = live[k] ? a[row] : 0.f;
    ya[k] = live[k] ? a[n_acc + row] : 0.f;
    za[k] = live[k] ? a[2 * n_acc + row] : 0.f;
    count[k] = 0;
  }

  const long long fo = (long long)f * 3 * n_don + start;
  const float* dx = don + fo;
  const float* hxs = donh + fo;
  const float* vxs = vhat + fo;
  int* dc = don_cnt + (long long)f * n_don + start;

  for (int c0 = 0; c0 < w; c0 += kCols) {
    const int nc = min(kCols, w - c0);
    __syncthreads();
    for (int c = t; c < nc; c += kRows) {
      s_don[c] = make_float4(dx[c0 + c], dx[n_don + c0 + c], dx[2 * n_don + c0 + c], 0.f);
      s_cnt[c] = 0;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = g; c < nc; c += kGroups) {
      const float4 p = s_don[c];
      float dsq[kAcc];
      bool near = false;
#pragma unroll
      for (int k = 0; k < kAcc; ++k) {
        const float ex = mi_abs(p.x - xa[k], bx);
        const float ey = mi_abs(p.y - ya[k], by);
        const float ez = mi_abs(p.z - za[k], bz);
        dsq[k] = dot3(ex, ex, ey, ey, ez, ez);
        near = near || dsq[k] <= dist_sq;
      }
      if (!near) continue;
      const int col = c0 + c;
#pragma unroll
      for (int k = 0; k < kAcc; ++k) {
        if (!(live[k] && dsq[k] <= dist_sq && dsq[k] > 1.0e-2f)) continue;
        const float ux = min_image(xa[k] - hxs[col], bx, hx);
        const float uy = min_image(ya[k] - hxs[n_don + col], by, hy);
        const float uz = min_image(za[k] - hxs[2 * n_don + col], bz, hz);
        const float usq = dot3(ux, ux, uy, uy, uz, uz);
        const float tt = dot3(ux, vxs[col], uy, vxs[n_don + col], uz, vxs[2 * n_don + col]);
        if (tt <= cos_cut * sqrtf(usq)) {
          ++count[k];
          atomicAdd(&s_cnt[c], 1);
        }
      }
    }
    __syncthreads();
    for (int c = t; c < nc; c += kRows) {
      if (s_cnt[c]) atomicAdd(dc + c0 + c, s_cnt[c]);
    }
  }
#pragma unroll
  for (int k = 0; k < kAcc; ++k) s_acc[g][i + k * kGroup] = count[k];
  __syncthreads();
  if (row0 + t < n_acc) {
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) sum += s_acc[q][t];
    acc_cnt[(long long)f * n_acc + row0 + t] = sum;
  }
}

int launch(const float* acc, int n_acc, const float* don, const float* donh, const float* vhat,
           int n_don, const int* starts, int w, const float* boxes, int n_frames, float dist_sq,
           float cos_cut, int* acc_cnt, int* don_cnt, void* stream) {
  const int blocks_per_frame = (n_acc + kRows - 1) / kRows;
  const long long n_blocks = (long long)blocks_per_frame * n_frames;
  if (n_blocks == 0) return 0;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  hbond_kernel<<<(unsigned)n_blocks, kRows, 0, (cudaStream_t)stream>>>(
      acc, n_acc, don, donh, vhat, n_don, starts, w, boxes, blocks_per_frame, dist_sq, cos_cut,
      acc_cnt, don_cnt);
  return (int)cudaGetLastError();
}

}  // namespace

// Every acceptor against all n_don donors. don_cnt must hold zeros.
extern "C" int hbond_dense_launch(const float* acc, int n_acc, const float* don,
                                  const float* donh, const float* vhat, int n_don,
                                  const float* boxes, int n_frames, float dist_sq, float cos_cut,
                                  int* acc_cnt, int* don_cnt, void* stream) {
  return launch(acc, n_acc, don, donh, vhat, n_don, nullptr, n_don, boxes, n_frames, dist_sq,
                cos_cut, acc_cnt, don_cnt, stream);
}

// Each tile of kRows acceptors against donors [start, start + w), start =
// starts[f, tile]. don_cnt (F, n_don) must hold zeros.
extern "C" int hbond_slab_launch(const float* acc, int n_acc, const float* don,
                                 const float* donh, const float* vhat, int n_don,
                                 const int* starts, int w, const float* boxes, int n_frames,
                                 float dist_sq, float cos_cut, int* acc_cnt, int* don_cnt,
                                 void* stream) {
  return launch(acc, n_acc, don, donh, vhat, n_don, starts, w, boxes, n_frames, dist_sq, cos_cut,
                acc_cnt, don_cnt, stream);
}
