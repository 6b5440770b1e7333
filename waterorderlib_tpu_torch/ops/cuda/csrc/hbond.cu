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
// The TPU kernel carried both sums across its sequential grid. Here blocks
// run in no order: each thread owns one acceptor and keeps its count in a
// register; a donor's count is reduced across the block by one warp ballot
// and popcount per donor column into shared memory, then added to device
// memory with one integer atomicAdd per (block, donor) that has a bond.
// Integer atomics make the result independent of the blocks' order, so the
// counts stay exact.
//
// What bounds it on this card: instruction throughput. A pair costs ~14 float32
// operations for the distance test; the angle test (~20 more) runs only
// for the ~0.1% of pairs within the cut, and the donors' 36 bytes are read
// once per block from device memory, then as shared-memory broadcasts.
//
// Launch: one block of kRows threads per (frame, acceptor tile of kRows
// rows); donors stream through shared memory in tiles of kCols. A window
// start outside the donor array gives count -1 for the tile's acceptors
// and adds nothing to donors.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 128;
constexpr int kCols = 256;
constexpr int kWarps = kRows / 32;

__device__ __forceinline__ float min_image(float d, float box, float half) {
  d = d > half ? d - box : d;
  return d < -half ? d + box : d;
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
  __shared__ float s[9][kCols];
  __shared__ int warp_cnt[kWarps][kCols];

  const int f = blockIdx.x / blocks_per_frame;
  const int rb = blockIdx.x - f * blocks_per_frame;
  const int row = rb * kRows + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool live = row < n_acc;

  const float bx = boxes[3 * f + 0], by = boxes[3 * f + 1], bz = boxes[3 * f + 2];
  const float hx = bx * 0.5f, hy = by * 0.5f, hz = bz * 0.5f;

  int start = 0;
  if (starts != nullptr) {
    start = starts[(long long)f * blocks_per_frame + rb];
    if (start < 0 || start > n_don - w) {
      if (live) acc_cnt[(long long)f * n_acc + row] = -1;
      return;
    }
  }

  float xa = 0.f, ya = 0.f, za = 0.f;
  if (live) {
    const float* a = acc + (long long)f * 3 * n_acc + row;
    xa = a[0];
    ya = a[n_acc];
    za = a[2 * n_acc];
  }

  const long long fo = (long long)f * 3 * n_don + start;
  const float* src[9] = {don + fo, don + fo + n_don, don + fo + 2 * n_don,
                         donh + fo, donh + fo + n_don, donh + fo + 2 * n_don,
                         vhat + fo, vhat + fo + n_don, vhat + fo + 2 * n_don};
  int* dc = don_cnt + (long long)f * n_don + start;

  int count = 0;
  for (int c0 = 0; c0 < w; c0 += kCols) {
    const int nc = min(kCols, w - c0);
    __syncthreads();
    for (int c = threadIdx.x; c < nc; c += kRows) {
#pragma unroll
      for (int k = 0; k < 9; ++k) s[k][c] = src[k][c0 + c];
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      bool bond = false;
      if (live) {
        const float dx = min_image(s[0][c] - xa, bx, hx);
        const float dy = min_image(s[1][c] - ya, by, hy);
        const float dz = min_image(s[2][c] - za, bz, hz);
        const float dsq = dot3(dx, dx, dy, dy, dz, dz);
        if (dsq <= dist_sq && dsq > 1.0e-2f) {
          const float ux = min_image(xa - s[3][c], bx, hx);
          const float uy = min_image(ya - s[4][c], by, hy);
          const float uz = min_image(za - s[5][c], bz, hz);
          const float usq = dot3(ux, ux, uy, uy, uz, uz);
          const float t = dot3(ux, s[6][c], uy, s[7][c], uz, s[8][c]);
          bond = t <= cos_cut * sqrtf(usq);
        }
      }
      const unsigned mask = __ballot_sync(0xffffffffu, bond);
      count += bond ? 1 : 0;
      if (lane == 0) warp_cnt[warp][c] = __popc(mask);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < nc; c += kRows) {
      int sum = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) sum += warp_cnt[k][c];
      if (sum) atomicAdd(dc + c0 + c, sum);
    }
  }
  if (live) acc_cnt[(long long)f * n_acc + row] = count;
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
