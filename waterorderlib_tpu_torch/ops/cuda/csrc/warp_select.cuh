// WarpSelect: the k smallest of a stream of 64-bit keys, kept by one warp,
// with no serial insertion. Included by voronoi_topk.cu (the cell-grid
// K-nearest search) and lsi_window.cu (the K = 24 LSI scan).
//
// A caller packs a float32 distance d >= 0 and a tag into a key as
// (d's bits << 32) | tag: a non-negative float's bits order as an unsigned
// integer, so ascending keys are the stable ascending sort of d with equal
// distances in tag order. build.py hashes this header into the library name
// of every source that includes it.

#pragma once

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kSent = ~0ull;  // an empty entry: above every real key
constexpr int kBuf = 64;      // a warp's keys waiting for a merge (at most 63)

__device__ __forceinline__ u64 umin64(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ u64 umax64(u64 a, u64 b) { return a < b ? b : a; }

// One selection, run by a warp. L holds the 32 R smallest keys merged so
// far, ascending, entry i in register i / 32 of lane i % 32; thr is its
// entry k - 1, and a key at or above thr cannot be among the k smallest.
// Keys below thr wait in the warp's buffer (kBuf keys of shared memory);
// every 32 of them are sorted (a bitonic sort over the lanes) and merged
// into L (the lower half of L and the reversed 32 is bitonic; a bitonic
// merge sorts it).
template <int R>
struct WarpSelect {
  u64 L[R];
  u64 thr;
  int cnt;  // keys in buf, the same in every lane
  u64* buf;
  int k;

  __device__ __forceinline__ void init(u64* b, int k_) {
#pragma unroll
    for (int r = 0; r < R; ++r) L[r] = kSent;
    thr = kSent;
    cnt = 0;
    buf = b;
    k = k_;
  }

  // merge 32 keys, one a lane in no order, into L
  __device__ __forceinline__ void merge(u64 v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int d = size >> 1; d > 0; d >>= 1) {
        const u64 o = __shfl_xor_sync(kFull, v, d);
        v = (((lane & d) == 0) == ((lane & size) == 0)) ? umin64(v, o) : umax64(v, o);
      }
    }
    const u64 rv = __shfl_sync(kFull, v, 31 - lane);
    L[R - 1] = umin64(L[R - 1], rv);
#pragma unroll
    for (int dr = R / 2; dr > 0; dr >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if ((r & dr) == 0) {
          const u64 a = L[r], b = L[r + dr];
          L[r] = umin64(a, b);
          L[r + dr] = umax64(a, b);
        }
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const u64 o = __shfl_xor_sync(kFull, L[r], d);
        L[r] = (lane & d) ? umax64(L[r], o) : umin64(L[r], o);
      }
    }
    u64 t = L[0];
#pragma unroll
    for (int r = 1; r < R; ++r)
      if (r == ((k - 1) >> 5)) t = L[r];
    thr = __shfl_sync(kFull, t, (k - 1) & 31);
  }

  // each lane's key, if `real`: into the buffer when below thr; true (in
  // every lane) if the buffer reached 32 keys and was merged into L
  __device__ __forceinline__ bool offer(bool real, u64 key) {
    const int lane = threadIdx.x & 31;
    const bool s = real && key < thr;
    const unsigned m = __ballot_sync(kFull, s);
    if (m == 0) return false;
    if (s) buf[cnt + __popc(m & ((1u << lane) - 1u))] = key;
    cnt += __popc(m);
    if (cnt < 32) return false;
    __syncwarp();
    const u64 v = buf[lane];
    const u64 w = buf[32 + lane];
    __syncwarp();
    if (lane < cnt - 32) buf[lane] = w;
    cnt -= 32;
    merge(v);
    return true;
  }

  __device__ __forceinline__ void flush() {
    if (cnt == 0) return;
    const int lane = threadIdx.x & 31;
    __syncwarp();
    const u64 v = lane < cnt ? buf[lane] : kSent;
    __syncwarp();
    cnt = 0;
    merge(v);
  }
};

}  // namespace
