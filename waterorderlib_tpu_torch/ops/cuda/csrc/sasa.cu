// Shrake-Rupley point occlusion: the Hopper (sm_90a) kernel of the port's
// SASA slice, one kernel body with two entry points.
//
// Replaces the Pallas TPU kernel waterorderlib_tpu/ops/pallas/sasa_kernel.py
// `_make_kernel` (the pallas_call of `_occlusion_pallas`, behind
// `sphere_areas_pallas`). For each atom i (center c, radius r) and each unit
// point u of the P golden-spiral points, the point c + r u is occluded when
// it lies strictly inside an occluder sphere j:
//
//   pt = fma(r, u, c);  d = pt - occ_j;
//   d2 = fma(dz, dz, fma(dy, dy, dx * dx));  occluded iff d2 < r_j^2.
//
// This is the quadratic test of the JAX package's XLA tiers
// (surface/sasa.py `sphere_surface_areas_topk` and `sphere_surface_areas`)
// in the order and with the fused multiply-adds XLA's CPU backend gives
// them; compiled with --fmad=false, so the plain PyTorch versions
// (ops/cuda/sasa.py) give the same visible counts and the JAX pruned and
// brute tiers stay bit-identical. The Pallas kernel's linear form
// (u . delta > b as an MXU product) existed only for the TPU's matrix unit
// and rounds apart at the occlusion boundary; this kernel needs no tensor
// cores.
//
// `sasa_topk_launch` serves the pruned tier: atom i's occluders are its K
// slots (N, K, 3), reimaged around c and gathered by the caller, with r_j^2
// (N, K) and a valid flag (N, K). `sasa_brute_launch` serves the brute tier:
// the occluders are all N atoms, streamed through shared memory, each
// reimaged around c in the loader as pbc.minimum_image does (d - L rint(d /
// L), no wrap where an edge is non-positive); j = i is left out by index,
// so a coincident atom occludes here and not in the pruned tier (whose
// neighbor search drops distance 0).
//
// What bounds it on this card: instruction throughput. A (point, occluder) test
// is 7 float32 instructions (3 subtracts, a product, 2 fmas) and a compare;
// an occluder's 16 bytes are read once per block from device memory, then
// as shared-memory broadcasts. A point stops testing at its first occluding
// slot (the `any` of the XLA tiers), so in a liquid most points stop within
// a few of the nearest slots, and only the visible ones run the whole list.
// The pruned tier's slots are sorted by distance, and each tile stops at its
// last valid slot.
//
// Launch: one block of kThreads threads per atom; each thread holds kPts of
// the atom's points in registers per pass (P = 1000 takes one pass). The
// visible count is a warp ballot and popcount per pass, summed in shared
// memory and written as one integer per atom: exact, and independent of the
// order of the blocks.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPts = 8;
constexpr int kTile = 256;

__device__ __forceinline__ float min_image(float d, float box, float inv) {
  // pbc.minimum_image: rintf rounds half to even, like torch.round; inv = 0
  // (a non-positive edge) leaves d as it is
  return d - box * rintf(d * inv);
}

// centers (N, 3), radii (N,), points (P, 3): contiguous float32. Pruned
// tier: occ (N, k, 3), occ_rsq (N, k), valid (N, k) bytes. Brute tier: occ
// null, box (3,).
template <bool kBrute>
__global__ void __launch_bounds__(kThreads)
sasa_kernel(const float* __restrict__ centers, const float* __restrict__ radii, int n,
            const float* __restrict__ points, int n_pts, const float* __restrict__ occ,
            const float* __restrict__ occ_rsq, const unsigned char* __restrict__ valid, int k,
            const float* __restrict__ box, int* __restrict__ n_vis) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile], sr[kTile];
  __shared__ int s_vis, s_hi;

  const int i = blockIdx.x;
  const float cx = centers[3 * i], cy = centers[3 * i + 1], cz = centers[3 * i + 2];
  const float r = radii[i];
  const int n_occ = kBrute ? n : k;
  const float neg_inf = __int_as_float(0xff800000);
  float bx = 0.f, by = 0.f, bz = 0.f, ix = 0.f, iy = 0.f, iz = 0.f;
  if (kBrute) {
    bx = box[0];
    by = box[1];
    bz = box[2];
    ix = bx > 0.f ? 1.0f / bx : 0.f;
    iy = by > 0.f ? 1.0f / by : 0.f;
    iz = bz > 0.f ? 1.0f / bz : 0.f;
  }
  if (threadIdx.x == 0) s_vis = 0;

  for (int p0 = 0; p0 < n_pts; p0 += kThreads * kPts) {
    float px[kPts], py[kPts], pz[kPts];
    bool open[kPts];  // a real point not yet occluded
    bool any_open = false;
#pragma unroll
    for (int q = 0; q < kPts; ++q) {
      const int p = p0 + q * kThreads + threadIdx.x;
      open[q] = p < n_pts;
      px[q] = py[q] = pz[q] = 0.f;
      if (open[q]) {
        px[q] = fmaf(r, points[3 * p], cx);
        py[q] = fmaf(r, points[3 * p + 1], cy);
        pz[q] = fmaf(r, points[3 * p + 2], cz);
      }
      any_open |= open[q];
    }

    for (int j0 = 0; j0 < n_occ; j0 += kTile) {
      const int nt = min(kTile, n_occ - j0);
      __syncthreads();
      if (threadIdx.x == 0) s_hi = 0;
      __syncthreads();
      for (int t = threadIdx.x; t < nt; t += kThreads) {
        const int j = j0 + t;
        float ox, oy, oz, rsq;
        if (kBrute) {
          ox = cx + min_image(centers[3 * j] - cx, bx, ix);
          oy = cy + min_image(centers[3 * j + 1] - cy, by, iy);
          oz = cz + min_image(centers[3 * j + 2] - cz, bz, iz);
          rsq = j == i ? neg_inf : radii[j] * radii[j];
        } else {
          const long long s = (long long)i * k + j;
          ox = occ[3 * s];
          oy = occ[3 * s + 1];
          oz = occ[3 * s + 2];
          rsq = valid[s] ? occ_rsq[s] : neg_inf;
        }
        sx[t] = ox;
        sy[t] = oy;
        sz[t] = oz;
        sr[t] = rsq;
        if (rsq != neg_inf) atomicMax(&s_hi, t + 1);
      }
      __syncthreads();
      const int hi = s_hi;  // tests stop after the tile's last occluder that can occlude
      if (any_open) {
        for (int t = 0; t < hi; ++t) {
          const float ox = sx[t], oy = sy[t], oz = sz[t], rsq = sr[t];
          bool still = false;
#pragma unroll
          for (int q = 0; q < kPts; ++q) {
            if (open[q]) {
              const float dx = px[q] - ox, dy = py[q] - oy, dz = pz[q] - oz;
              const float d2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
              open[q] = !(d2 < rsq);
            }
            still |= open[q];
          }
          any_open = still;
          if (!still) break;
        }
      }
      if (!__syncthreads_or(any_open)) break;  // every point of this pass is occluded
    }

    int vis = 0;
#pragma unroll
    for (int q = 0; q < kPts; ++q) vis += __popc(__ballot_sync(0xffffffffu, open[q]));
    if ((threadIdx.x & 31) == 0 && vis) atomicAdd(&s_vis, vis);
  }
  __syncthreads();
  if (threadIdx.x == 0) n_vis[i] = s_vis;
}

}  // namespace

// The pruned tier: each atom's points against its k occluder slots.
extern "C" int sasa_topk_launch(const float* centers, const float* radii, int n,
                                const float* points, int n_pts, const float* occ,
                                const float* occ_rsq, const unsigned char* valid, int k,
                                int* n_vis, void* stream) {
  if (n == 0) return 0;
  sasa_kernel<false><<<n, kThreads, 0, (cudaStream_t)stream>>>(
      centers, radii, n, points, n_pts, occ, occ_rsq, valid, k, nullptr, n_vis);
  return (int)cudaGetLastError();
}

// The brute tier: each atom's points against all n atoms, reimaged in box.
extern "C" int sasa_brute_launch(const float* centers, const float* radii, int n,
                                 const float* points, int n_pts, const float* box, int* n_vis,
                                 void* stream) {
  if (n == 0) return 0;
  sasa_kernel<true><<<n, kThreads, 0, (cudaStream_t)stream>>>(
      centers, radii, n, points, n_pts, nullptr, nullptr, nullptr, 0, box, n_vis);
  return (int)cudaGetLastError();
}
