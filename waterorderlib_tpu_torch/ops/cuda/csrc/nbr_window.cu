// K nearest shell neighbors over a column window, then a per-center
// epilogue: the port's 3-body angles and psi6 kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels, which compute the same per-row values
// (not the same blocks), both with `slab.extract_k_min` in their bodies:
//   angles_window_launch (K = 16): waterorderlib_tpu/ops/pallas/
//     angles_kernel.py `_make_kernel`, launched by `neighbor_pair_angles_traj`;
//     out (F, R, 128): the 120 pair angles in degrees, slot p = (a, b) with
//     a < b in row-major order, -1 where a slot misses a neighbor and in the
//     8 padding slots;
//   psi6_window_launch (K = 24): waterorderlib_tpu/ops/pallas/psi6_kernel.py
//     `_make_kernel` + `psi6_epilogue`, launched by `psi6_traj`;
//     out (F, R): |mean over neighbor pairs of exp(6 i theta)|, 0 when the
//     shell holds fewer than 2 neighbors.
// Both write count (F, R) int32: the full shell count over the window,
// which can exceed K.
//
// The contract is qtet_window.cu's (ops/cuda/window.py): rows and columns
// (F, 3, n) with unit stride along n, one window start per row tile of
// `row_tile` rows, blocks of kRows rows, the window streamed through shared
// memory in tiles of kCols columns, NaN for a window outside the columns.
//
// Per row and window column: minimum-image displacement (two
// compare-selects, coordinates wrapped), dsq, the (low, high] shell test
// and count, and insertion into a sorted top-K of (dsq, column) kept in
// registers. Columns are visited in ascending order and a candidate moves
// ahead of a slot only when strictly smaller, so equal distances keep the
// lowest column first: the slots come out in extract_k_min's order. The
// insertion is unrolled over the compile-time K so the top-K stays in
// registers; each slot keeps its column, not its displacement (2K registers,
// not 4K), and the epilogue recomputes the K displacements from the columns.
//
// The arccos is the A&S 4.4.46 polynomial evaluated as angles_kernel.py
// `_acos` does (Horner from the highest coefficient, sqrt(max(1 - |x|, 0)),
// pi - r for x < 0), not acosf, and psi6 takes cos 6t = T6(c) and
// sin 6t = sin t U5(c) as psi6_epilogue does, summing the pairs (a, b) over
// a < b for each b = 1..K-1. Squared lengths, pair cosines and the Horner
// steps are explicit fmaf chains (`dot3`, `acos_poly`), the contraction XLA
// applies to the JAX kernels: near 0 and 180 degrees arccos turns one ulp
// of cosine into ~1e-4 degrees, so the rounding is fixed, not left to the
// compiler. Built with --fmad=false and without fast math, so the plain
// PyTorch versions (ops/cuda/angles.py, ops/cuda/psi6.py), which do the
// same operations one at a time, agree.
//
// What bounds it on this card: instruction throughput. Each window pair
// costs ~14 FP32 operations plus the shell compares, for 128 threads of a
// block reading the window once from device memory (12 bytes a column) and
// then from shared memory. The epilogue adds ~26 operations per angle pair (16 slots,
// 120 pairs) or ~22 per psi6 pair (24 slots, 276 pairs) per row. The angles
// output is 512 bytes a row; each thread writes its own row as 32 float4
// stores, which do not coalesce across the warp. This first version favours
// being exact over being fast.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 128;
constexpr int kCols = 512;
constexpr int kPairsPad = 128;

constexpr int kAngles = 0;
constexpr int kPsi6 = 1;

__device__ __forceinline__ float min_image(float d, float box, float half) {
  d = d > half ? d - box : d;
  return d < -half ? d + box : d;
}

// a0*b0 + a1*b1 + a2*b2 as fma(a2, b2, fma(a0, b0, a1*b1)): the
// contraction XLA gives the JAX kernels' expression, kept explicit (the
// file is built with --fmad=false, so nvcc fuses nothing on its own)
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
  return fmaf(a2, b2, fmaf(a0, b0, a1 * b1));
}

// Abramowitz & Stegun 4.4.46, Horner steps as fused multiply-adds; the
// coefficients are rounded from double to float, as jnp.float32 and
// torch.tensor(..., float32) round them.
__device__ __forceinline__ float acos_poly(float x) {
  const float ax = fabsf(x);
  float p = (float)-0.0012624911;
  p = fmaf(p, ax, (float)0.0066700901);
  p = fmaf(p, ax, (float)-0.0170881256);
  p = fmaf(p, ax, (float)0.0308918810);
  p = fmaf(p, ax, (float)-0.0501743046);
  p = fmaf(p, ax, (float)0.0889789874);
  p = fmaf(p, ax, (float)-0.2145988016);
  p = fmaf(p, ax, (float)1.5707963050);
  const float r = sqrtf(fmaxf(1.0f - ax, 0.0f)) * p;
  return x >= 0.0f ? r : (float)3.14159265358979323846 - r;
}

template <int K, int E>
__global__ void __launch_bounds__(kRows)
nbr_window_kernel(const float* __restrict__ rows, long long row_fs, long long row_cs,
                  int n_rows, const float* __restrict__ cols, long long col_fs,
                  long long col_cs, int n_cols, const int* __restrict__ starts, int w,
                  const float* __restrict__ boxes, int blocks_per_frame, int row_tile,
                  float low_sq, float high_sq, float* __restrict__ out,
                  int* __restrict__ count_out) {
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
      if constexpr (E == kAngles) {
        for (int p = 0; p < kPairsPad; ++p) out[o * kPairsPad + p] = nanf("");
      } else {
        out[o] = nanf("");
      }
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
  float d[K];
  int ci[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    d[k] = inf;
    ci[k] = 0;
  }
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
      const float dsq = dot3(dx, dx, dy, dy, dz, dz);
      if (!(dsq > low_sq && dsq <= high_sq)) continue;
      ++count;
      if (!(dsq < d[K - 1])) continue;
      const int col = c0 + c;
      // slot k takes slot k-1's entry when the candidate precedes it, or
      // the candidate when it falls between them (old values on the right)
#pragma unroll
      for (int k = K - 1; k > 0; --k) {
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

  // unit vectors to the filled slots, displacements recomputed from columns
  float ux[K], uy[K], uz[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float vx = 0.f, vy = 0.f, vz = 0.f;
    if (count > k) {
      const int j = ci[k];
      vx = min_image(cx[j] - xr, bx, hx);
      vy = min_image(cy[j] - yr, by, hy);
      vz = min_image(cz[j] - zr, bz, hz);
    }
    const float nrm = sqrtf(dot3(vx, vx, vy, vy, vz, vz));
    const float inv = nrm > 0.f ? 1.0f / nrm : 0.f;
    ux[k] = vx * inv;
    uy[k] = vy * inv;
    uz[k] = vz * inv;
  }

  if constexpr (E == kAngles) {
    const float rad2deg = (float)(180.0 / 3.14159265358979323846);
    float4* o4 = reinterpret_cast<float4*>(out + o * kPairsPad);
    float buf[4];
    int p = 0;
#pragma unroll
    for (int a = 0; a < K; ++a) {
#pragma unroll
      for (int b = a + 1; b < K; ++b) {
        float v = -1.0f;
        if (count > b) {  // slots a < b are both filled
          float cosv = dot3(ux[a], ux[b], uy[a], uy[b], uz[a], uz[b]);
          cosv = fminf(fmaxf(cosv, -1.0f), 1.0f);
          v = acos_poly(cosv) * rad2deg;
        }
        buf[p & 3] = v;
        if ((p & 3) == 3) o4[p >> 2] = make_float4(buf[0], buf[1], buf[2], buf[3]);
        ++p;
      }
    }
#pragma unroll
    for (int q = K * (K - 1) / 2 / 4; q < kPairsPad / 4; ++q) {
      o4[q] = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
    }
  } else {
    float re = 0.f, im = 0.f, npair = 0.f;
#pragma unroll
    for (int b = 1; b < K; ++b) {
      if (count > b) {  // every slot a < b is filled too
        float sre = 0.f, sim = 0.f;
#pragma unroll
        for (int a = 0; a < b; ++a) {
          float c = dot3(ux[a], ux[b], uy[a], uy[b], uz[a], uz[b]);
          c = fminf(fmaxf(c, -1.0f), 1.0f);
          const float c2 = c * c;
          const float cos6 = ((32.0f * c2 - 48.0f) * c2 + 18.0f) * c2 - 1.0f;
          const float sin6 =
              sqrtf(fmaxf(1.0f - c2, 0.0f)) * (((32.0f * c2 - 32.0f) * c2 + 6.0f) * c);
          sre = sre + cos6;
          sim = sim + sin6;
        }
        re = re + sre;
        im = im + sim;
        npair = npair + (float)b;
      }
    }
    const float denom = fmaxf(npair, 1.0f);
    const float mr = re / denom, mi = im / denom;
    out[o] = count > 1 ? sqrtf(mr * mr + mi * mi) : 0.0f;
  }
  count_out[o] = count;
}

template <int K, int E>
int launch(const float* rows, long long row_fs, long long row_cs, int n_rows,
           const float* cols, long long col_fs, long long col_cs, int n_cols,
           const int* starts, int w, const float* boxes, int n_frames, int row_tile,
           float low_sq, float high_sq, float* out, int* count_out, void* stream) {
  const int blocks_per_frame = (n_rows + kRows - 1) / kRows;
  const long long n_blocks = (long long)blocks_per_frame * n_frames;
  if (n_blocks == 0) return 0;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  nbr_window_kernel<K, E><<<(unsigned)n_blocks, kRows, 0, (cudaStream_t)stream>>>(
      rows, row_fs, row_cs, n_rows, cols, col_fs, col_cs, n_cols, starts, w, boxes,
      blocks_per_frame, row_tile, low_sq, high_sq, out, count_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int angles_window_launch(const float* rows, long long row_fs, long long row_cs,
                                    int n_rows, const float* cols, long long col_fs,
                                    long long col_cs, int n_cols, const int* starts, int w,
                                    const float* boxes, int n_frames, int row_tile,
                                    float low_sq, float high_sq, float* ang, int* count,
                                    void* stream) {
  return launch<16, kAngles>(rows, row_fs, row_cs, n_rows, cols, col_fs, col_cs, n_cols,
                             starts, w, boxes, n_frames, row_tile, low_sq, high_sq, ang,
                             count, stream);
}

extern "C" int psi6_window_launch(const float* rows, long long row_fs, long long row_cs,
                                  int n_rows, const float* cols, long long col_fs,
                                  long long col_cs, int n_cols, const int* starts, int w,
                                  const float* boxes, int n_frames, int row_tile,
                                  float low_sq, float high_sq, float* psi, int* count,
                                  void* stream) {
  return launch<24, kPsi6>(rows, row_fs, row_cs, n_rows, cols, col_fs, col_cs, n_cols,
                           starts, w, boxes, n_frames, row_tile, low_sq, high_sq, psi,
                           count, stream);
}
