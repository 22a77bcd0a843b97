// Segment OR for Hopper (sm_90a): out[idx[i], w] |= words[i, w] for every
// item i with idx[i] in [0, n).  Built by repro_torch/kernels/_build.py with
// nvcc into a shared library with a plain C interface; bound with ctypes in
// repro_torch/kernels/segment_or.py.
//
// Replaces repro/core/offload.py::segment_or, which has no Pallas kernel:
// there it is a sort, a segmented associative_scan of OR and a scatter of
// each run's last element.  Torch has neither a segmented scan nor an OR
// scatter, and unpacking the lanes for a max-scatter per bit moves 32x the
// bytes, so the combine of MS-BFS's packed lanes is this kernel.
//
// What bounds it on this card: bytes.  Each item's id and its W words are
// read once, and out (n, W) is written once, against one OR per word.  OR
// does not depend on order, so atomics in any order give the same bits as
// the plain version (ref.segment_or_ref): the result is exact.
//
// Design: one thread per (item, word), a warp over 32 consecutive ones, so
// the loads are coalesced.  A zero word or an id out of range takes no
// atomic.  The rest are merged inside the warp first: __match_any_sync
// groups the lanes that write one address (id * W + word), __reduce_or_sync
// ORs each group, and its lowest lane does one atomicOr.  On a stream
// sorted by destination (the engine's dense step) a run of one RMAT hub's
// in-edges, up to ~1e5 items, then costs one atomic per 32 items; on an
// unsorted stream the merge finds fewer equal ids and changes nothing else.
// All 32 lanes reach both intrinsics on every pass: the loop runs on the
// warp's first index, and lanes past the end take part with no address.
// The wrapper zero-fills out.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    segment_or_kernel(const int* __restrict__ idx,
                      const unsigned* __restrict__ words,
                      unsigned* __restrict__ out, int64_t m, int w_per,
                      int n) {
  const int64_t total = m * w_per;
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t base = (int64_t)blockIdx.x * kThreads + (threadIdx.x & ~31);
       base < total; base += stride) {
    const int64_t t = base + lane;
    long long addr = -1;   // this lane's out offset; -1: nothing to write
    unsigned v = 0;
    if (t < total) {
      const int64_t i = t / w_per;
      const int d = __ldg(idx + i);
      const unsigned x = __ldg(words + t);
      if (d >= 0 && d < n && x != 0u) {
        addr = (long long)d * w_per + (t - i * w_per);
        v = x;
      }
    }
    const unsigned group = __match_any_sync(0xffffffffu, addr);
    const unsigned merged = __reduce_or_sync(group, v);
    if (addr >= 0 && lane == __ffs(group) - 1) atomicOr(out + addr, merged);
  }
}

}  // namespace

extern "C" {

// out (n, w_per) int32, zero-filled by the caller, |= words (m, w_per)
// int32 by idx (m,) int32.  Returns cudaGetLastError() after the launch.
int segment_or(const int* idx, const int* words, int* out, int64_t m,
               int w_per, int n, void* stream) {
  if (m == 0 || w_per == 0 || n == 0) return (int)cudaSuccess;
  const int64_t total = m * w_per;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride past 64 a SM
  segment_or_kernel<<<(unsigned)blocks, kThreads, 0,
                      (cudaStream_t)stream>>>(
      idx, reinterpret_cast<const unsigned*>(words),
      reinterpret_cast<unsigned*>(out), m, w_per, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
