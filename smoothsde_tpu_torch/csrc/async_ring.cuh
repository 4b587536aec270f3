// Asynchronous global -> shared staging for the per-lane kernels.
//
// The per-lane kernels read (L, rows, lanes) arrays one step at a time, a
// row of a step being `lanes` neighbouring values. A CUDA block that owns
// W consecutive lanes walks their steps in chunks of S steps with one
// thread per (step, lane) item of a chunk; each thread stages its own
// item's rows into shared memory with cp.async (sm_80+), one chunk ahead:
// the copies land while the block computes on the chunk before and cost
// no registers. A warp's copies of one row are one contiguous segment of
// global memory (neighbouring threads, neighbouring lanes), and a thread
// reads back only what it copied itself, so the wait needs no barrier.
// A step below 0 or a lane past the last is zero-filled.
//
// Usage, with two buffers (double buffering):
//   stage_item(chunk 0 into buffer 0); cp_async_commit();
//   for each chunk k:
//     cp_async_wait_all();  // this thread's copies of chunk k have landed
//     stage_item(chunk k + 1 into buffer (k + 1) & 1); cp_async_commit();
//     compute on buffer k & 1 ...
#pragma once

#include <cuda_runtime.h>

namespace ssde {

// One value (4 or 8 bytes) global -> shared, asynchronous; zero-filled
// when !valid (src is then not read).
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async takes 4 or 8 B");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)), "r"(valid ? (int)sizeof(T) : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for all of this thread's committed copies; their bytes are then
// visible to this thread (to others after a barrier).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copies of rows [row0, row0 + nrows) of a (L, row_stride,
// lanes) array src at step l and lane `lane` into dst[r * stride],
// r < nrows; zero-filled when l < 0 or lane >= lanes.
template <typename T>
__device__ __forceinline__ void stage_item(T* dst, int stride,
                                           const T* __restrict__ src,
                                           int row_stride, int row0,
                                           int nrows, int l, int lane,
                                           int lanes) {
  const bool ok = l >= 0 && lane < lanes;
  const T* p =
      ok ? src + ((long long)l * row_stride + row0) * lanes + lane : src;
  const long long step = ok ? lanes : 0;
#pragma unroll
  for (int r = 0; r < nrows; ++r) cp_async(dst + r * stride, p + r * step, ok);
}

}  // namespace ssde
