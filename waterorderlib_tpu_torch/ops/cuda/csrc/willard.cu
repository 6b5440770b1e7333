// Willard-Chandler coarse-grained density and its gradient: the Hopper
// (sm_90a) kernels of the port's interface slice, two entry points.
//
// `willard_grid_launch` replaces the two Pallas TPU grid kernels of
// waterorderlib_tpu/ops/pallas/willard_grid.py: `_make_kernel_x` (the
// pallas_call at :358, each x-row scanning a sub-window of its plane's
// x-sorted window) and `_make_kernel` (the pallas_call at :375, each plane
// scanning one window of the z-sorted, z-extended atoms; the brute form
// passes all atoms once). `willard_points_launch` replaces
// waterorderlib_tpu/ops/pallas/willard_kernel.py `_willard_kernel` (the
// pallas_call at :102): the same field at arbitrary points over all atoms.
//
// The field, per grid point p and atom a with d = p - a (minimum image):
//   g = exp(-|d|^2 / (2 sigma^2)) * peak,  peak = (2 pi sigma^2)^-3/2,
//   density  = sum over |d|^2 < 9 sigma^2 of (g - shift), shift = e^-4.5 peak,
//   gradient = -sum over |d|^2 < 9 sigma^2 of d g / sigma^2.
//
// Grid kernel, after willard_grid.py:53-104 and :128-186: the grid
// coordinates and the caller's atoms (coordinates in [0, L) in x and y; z
// and, in the x form, x of boundary copies shifted by +/-L) go through the
// select-form minimum image; a grid coordinate is wrapped into [0, L) as
// v - L floor(v / L). The exponential is separable,
//   g = exp(-dy^2 / (2 sigma^2)) * (exp(-(dx^2 + dz^2) / (2 sigma^2)) * peak),
// and the test is dy^2 + (dx^2 + dz^2) < 9 sigma^2. The density is
// sum(g) - shift * n_in with an integer count n_in (a float in the TPU
// kernel). Compiled with --fmad=false, so the plain PyTorch version
// (ops/cuda/willard.py) does the same float32 operations; expf and the
// summation order differ from it at rounding level.
//
// The TPU kernel ran one z-plane per grid step, the y-points on sublanes,
// and a Python loop over the x-rows. Here one block serves one (plane,
// x-row) pair: 80 planes alone would fill 80 of the card's 132 SMs with one
// block each, while 80 x 80 blocks keep every SM busy. One thread per
// y-point (ny rounded up to a warp multiple) keeps its four sums and its
// count in registers. The row's window streams through shared memory in
// tiles of kTile atoms; the thread that loads an atom also computes the
// (row, atom) terms every y-point shares (dx, dz, dx^2 + dz^2 and the
// x-z exponential). An atom whose dx^2 + dz^2 already reaches 9 sigma^2 is
// skipped by the whole warp (dy^2 + that sum cannot be smaller, so no point
// of the row counts it); of the rest, each (point, atom) pair within 3 sigma
// costs one expf, and a pair outside only its distance test.
//
// Points kernel, after willard_kernel.py:26-64: one thread per point, all
// atoms streamed through shared memory; round-form minimum image
// d - L rint(d / L) (jnp.round is half to even, as rintf); no sentinels.
//
// What bounds them on this card: instruction throughput (expf is a chain of
// float32 instructions; chip_smoke.py counts them from the SASS). The
// atoms' 12 bytes are read once per block from device memory, then as
// shared-memory broadcasts; the outputs are written once.
//
// A window start outside [0, M - w] gives NaN for the row's outputs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 256;        // atoms per shared-memory tile
constexpr int kPointThreads = 128;

__device__ __forceinline__ float min_image(float d, float box, float half) {
  d = d > half ? d - box : d;
  return d < -half ? d + box : d;
}

__device__ __forceinline__ float wrap(float v, float box) { return v - box * floorf(v / box); }

// atoms (n_atom_planes, 3, m): n_atom_planes is 1 (every plane shares the
// array) or nz (one array per plane). starts (nz, nx) int32.
// out (4, nx, ny, nz): density, then the three gradient sums.
__global__ void willard_grid_kernel(const float* __restrict__ atoms, long long plane_stride, int m,
                                    const int* __restrict__ starts, int w, int nx, int ny,
                                    int nz, float bx, float by, float bz,
                                    float gx0, float dgx, float gy0, float dgy, float gz0,
                                    float dgz, float sig2, float inv2sig2, float peak, float shift,
                                    float* __restrict__ out) {
  __shared__ float s_y[kTile], s_dx[kTile], s_dz[kTile], s_dxz[kTile], s_exz[kTile];

  const int kk = blockIdx.x / nx;
  const int i = blockIdx.x - kk * nx;
  const int j = threadIdx.x;
  const float* a = atoms + kk * plane_stride;
  const int start = starts[blockIdx.x];
  const long long plane_size = (long long)nx * ny * nz;
  const long long o = ((long long)i * ny + j) * nz + kk;

  if (start < 0 || start > m - w) {
    if (j < ny) {
      for (int c = 0; c < 4; ++c) out[c * plane_size + o] = nanf("");
    }
    return;
  }

  const float hx = bx * 0.5f, hy = by * 0.5f, hz = bz * 0.5f;
  const float gz = wrap(gz0 + dgz * (float)kk, bz);
  const float gx = wrap(gx0 + dgx * (float)i, bx);
  const float gy = wrap(gy0 + dgy * (float)j, by);
  const float nine_sig2 = 9.0f * sig2;

  float sg = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  int n_in = 0;
  for (int c0 = 0; c0 < w; c0 += kTile) {
    const int nc = min(kTile, w - c0);
    __syncthreads();
    for (int c = threadIdx.x; c < nc; c += blockDim.x) {
      const int idx = start + c0 + c;
      const float dx = min_image(gx - a[idx], bx, hx);
      const float dz = min_image(gz - a[2 * m + idx], bz, hz);
      const float dxz = dx * dx + dz * dz;
      s_y[c] = a[m + idx];
      s_dx[c] = dx;
      s_dz[c] = dz;
      s_dxz[c] = dxz;
      s_exz[c] = expf(-dxz * inv2sig2) * peak;
    }
    __syncthreads();
    if (j < ny) {
      for (int c = 0; c < nc; ++c) {
        const float dxz = s_dxz[c];
        if (!(dxz < nine_sig2)) continue;  // the same for every thread
        const float dy = min_image(gy - s_y[c], by, hy);
        const float dy_sq = dy * dy;
        if (dy_sq + dxz < nine_sig2) {
          const float g = expf(-dy_sq * inv2sig2) * s_exz[c];
          sg += g;
          n_in += 1;
          sx += g * (-s_dx[c]);
          sy += g * (-dy);
          sz += g * (-s_dz[c]);
        }
      }
    }
  }
  if (j < ny) {
    const float inv_sig2 = 1.0f / sig2;
    out[o] = sg - shift * (float)n_in;
    out[plane_size + o] = sx * inv_sig2;
    out[2 * plane_size + o] = sy * inv_sig2;
    out[3 * plane_size + o] = sz * inv_sig2;
  }
}

__device__ __forceinline__ float min_image_round(float d, float box, float inv_box) {
  return d - box * rintf(d * inv_box);
}

// atoms (3, n), points (3, p); out (4, p): density, then the three
// gradient components (already times -1/sigma^2).
__global__ void __launch_bounds__(kPointThreads)
willard_points_kernel(const float* __restrict__ atoms, int n, const float* __restrict__ pts, int p,
                      float bx, float by, float bz, float sig2, float shift, float peak,
                      float* __restrict__ out) {
  __shared__ float s[3][kTile];

  const int q = blockIdx.x * kPointThreads + threadIdx.x;
  const bool live = q < p;
  const float gx = live ? pts[q] : 0.f;
  const float gy = live ? pts[p + q] : 0.f;
  const float gz = live ? pts[2 * p + q] : 0.f;
  const float ibx = 1.0f / bx, iby = 1.0f / by, ibz = 1.0f / bz;
  const float nine_sig2 = 9.0f * sig2;
  const float two_sig2 = 2.0f * sig2;

  float dens = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  for (int c0 = 0; c0 < n; c0 += kTile) {
    const int nc = min(kTile, n - c0);
    __syncthreads();
    for (int c = threadIdx.x; c < nc; c += kPointThreads) {
      s[0][c] = atoms[c0 + c];
      s[1][c] = atoms[n + c0 + c];
      s[2][c] = atoms[2 * n + c0 + c];
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      const float dx = min_image_round(gx - s[0][c], bx, ibx);
      const float dy = min_image_round(gy - s[1][c], by, iby);
      const float dz = min_image_round(gz - s[2][c], bz, ibz);
      const float rsq = dx * dx + dy * dy + dz * dz;
      if (rsq < nine_sig2) {
        const float g = expf(-rsq / two_sig2) * peak;
        dens += g - shift;
        sx += dx * g;
        sy += dy * g;
        sz += dz * g;
      }
    }
  }
  if (live) {
    const float scale = -1.0f / sig2;
    out[q] = dens;
    out[p + q] = sx * scale;
    out[2 * p + q] = sy * scale;
    out[3 * p + q] = sz * scale;
  }
}

}  // namespace

// One block per (grid plane kk, x-row i); the row scans atoms
// [start, start + w) of its plane's array, start = starts[kk, i]. ny must
// not exceed 1024.
extern "C" int willard_grid_launch(const float* atoms, int n_atom_planes, int m,
                                   const int* starts, int w, int nx, int ny, int nz,
                                   float bx, float by, float bz, float gx0, float dgx,
                                   float gy0, float dgy, float gz0, float dgz, float sig2,
                                   float inv2sig2,
                                   float peak, float shift, float* out, void* stream) {
  const long long n_blocks = (long long)nx * nz;
  if (n_blocks == 0 || ny == 0) return 0;
  if (n_blocks > 0x7fffffffLL || ny > 1024) return (int)cudaErrorInvalidConfiguration;
  const int threads = (ny + 31) / 32 * 32;
  const long long plane_stride = n_atom_planes == 1 ? 0 : 3LL * m;
  willard_grid_kernel<<<(unsigned)n_blocks, threads, 0, (cudaStream_t)stream>>>(
      atoms, plane_stride, m, starts, w, nx, ny, nz, bx, by, bz,
      gx0, dgx, gy0, dgy, gz0, dgz, sig2, inv2sig2, peak, shift, out);
  return (int)cudaGetLastError();
}

// One thread per point, every atom.
extern "C" int willard_points_launch(const float* atoms, int n, const float* pts, int p, float bx,
                                     float by, float bz, float sig2, float shift, float peak,
                                     float* out, void* stream) {
  if (p == 0) return 0;
  const long long n_blocks = ((long long)p + kPointThreads - 1) / kPointThreads;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  willard_points_kernel<<<(unsigned)n_blocks, kPointThreads, 0, (cudaStream_t)stream>>>(
      atoms, n, pts, p, bx, by, bz, sig2, shift, peak, out);
  return (int)cudaGetLastError();
}
