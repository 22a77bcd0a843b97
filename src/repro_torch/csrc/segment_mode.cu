// Weighted label mode and in-order run sums for Hopper (sm_90a).  Built by
// repro_torch/kernels/_build.py with nvcc into a shared library with a plain
// C interface; bound with ctypes in repro_torch/kernels/segment_mode.py.
//
// Replaces repro/core/offload.py::segment_weighted_mode (:124), which has
// no Pallas kernel: there it is a lexsort of (destination, label), a
// jax.ops.segment_sum of the weights over each (destination, label) run and
// a two-plane scatter (max of the run sums, then min of the labels that
// reach it).  On the CPU that segment sum adds each run's weights one after
// the other in stream order, and the labels it picks (LPA's, Louvain's
// candidates) follow from those bits: a last-bit change flips a near tie.
// On the card a scatter-add runs on atomics in no fixed order, so the sums,
// and the labels, would change from run to run.  This kernel adds each run
// in stream order, in f32, the same adds the CPU makes, so its output
// equals the plain version's bit for bit on every run.  The second entry,
// run_sum, is the same in-order sum over any sorted stream (graph.contract's
// parallel coarse edges, the Louvain gain gate's column sums); run_sum_f64
// is it in double, for modularity's per-vertex and per-community sums,
// whose runs are long enough (a community of 10^5 vertices) for f32's
// in-order rounding to show in Q.
//
// What bounds it on this card: bytes, 12 per stream item (destination,
// label, weight) and 8 per destination out; but the sums are a sequential
// chain per run, so one long run (an RMAT hub's votes for one label) is a
// chain of dependent adds that no amount of parallel work can shorten
// without changing the bits.
//
// Design (simple first): a bounds pass writes ptr[v] = the first item whose
// destination is >= v, for v in [0, n], from the sorted stream (each item
// writes the ptr entries between its predecessor's destination and its
// own, so every entry is written once and no atomics are needed); then one
// thread per destination walks [ptr[v], ptr[v+1]) in order.  In the mode
// it closes a run where the label changes and keeps the first run whose sum
// is strictly larger than the best so far (labels ascend within a
// destination, so a tie goes to the smaller label); a run whose sum is
// -inf never wins.  Items with destinations outside [0, n) fall outside
// every [ptr[v], ptr[v+1]) and are ignored.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLabelPad = 1 << 30;   // offload.LABEL_PAD

// ptr[v] = lower_bound(idx, v) for v in [0, n]; idx (m,) sorted ascending
__global__ void __launch_bounds__(kThreads)
    run_bounds(const int* __restrict__ idx, int64_t m, int n,
               int64_t* __restrict__ ptr) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i > m) return;
  const int64_t prev = i == 0 ? -1 : (int64_t)__ldg(idx + i - 1);
  const int64_t cur = i == m ? (int64_t)n : (int64_t)__ldg(idx + i);
  const int64_t lo = prev + 1 > 0 ? prev + 1 : 0;
  const int64_t hi = cur < n ? cur : (int64_t)n;
  for (int64_t v = lo; v <= hi; ++v) ptr[v] = i;
}

__global__ void __launch_bounds__(kThreads)
    mode_walk(const int* __restrict__ label, const float* __restrict__ w,
              const int64_t* __restrict__ ptr, int n,
              float* __restrict__ best_w, int* __restrict__ best_l) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n) return;
  const int64_t lo = ptr[v], hi = ptr[v + 1];
  float best = -INFINITY;
  int bl = -1;
  if (lo < hi) {
    int cur = __ldg(label + lo);
    float acc = 0.0f;
    for (int64_t j = lo; j < hi; ++j) {
      const int l = __ldg(label + j);
      if (l != cur) {
        if (acc > best) {
          best = acc;
          bl = cur;
        }
        cur = l;
        acc = 0.0f;
      }
      acc += __ldg(w + j);
    }
    if (acc > best) {
      best = acc;
      bl = cur;
    }
  }
  // the reference's label plane is padded with LABEL_PAD, read back as -1
  best_w[v] = best;
  best_l[v] = bl >= kLabelPad ? -1 : bl;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sum_walk(const T* __restrict__ w, const int64_t* __restrict__ ptr, int n,
             T* __restrict__ out) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n) return;
  const int64_t hi = ptr[v + 1];
  T acc = 0;
  for (int64_t j = ptr[v]; j < hi; ++j) acc += __ldg(w + j);
  out[v] = acc;
}

int bounds(const int* idx, int64_t m, int n, int64_t* ptr,
           cudaStream_t stream) {
  const int64_t blocks = (m + 1 + kThreads - 1) / kThreads;
  run_bounds<<<(unsigned)blocks, kThreads, 0, stream>>>(idx, m, n, ptr);
  return (int)cudaGetLastError();
}

template <typename T>
int run_sum_t(const int* idx, const T* w, int64_t m, int n, int64_t* ptr,
              T* out, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = bounds(idx, m, n, ptr, s);
  if (err != (int)cudaSuccess) return err;
  sum_walk<T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      w, ptr, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Per destination v in [0, n): the label whose run of weights sums highest
// (ties to the smaller label) and that sum; (-inf, -1) where no run has a
// sum above -inf.  dst, label (m,) int32 and w (m,) f32 sorted by (dst,
// label); ptr (n + 1,) int64 scratch.  Returns cudaGetLastError().
int segment_mode(const int* dst, const int* label, const float* w, int64_t m,
                 int n, int64_t* ptr, float* best_w, int* best_l,
                 void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = bounds(dst, m, n, ptr, s);
  if (err != (int)cudaSuccess) return err;
  mode_walk<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      label, w, ptr, n, best_w, best_l);
  return (int)cudaGetLastError();
}

// out[v] = the weights of the items with idx == v added in stream order
// from 0.0f, for v in [0, n); idx (m,) int32 sorted ascending, ids outside
// [0, n) ignored; ptr (n + 1,) int64 scratch.  Returns cudaGetLastError().
int run_sum(const int* idx, const float* w, int64_t m, int n, int64_t* ptr,
            float* out, void* stream) {
  return run_sum_t<float>(idx, w, m, n, ptr, out, stream);
}

// run_sum with w and out in double.
int run_sum_f64(const int* idx, const double* w, int64_t m, int n,
                int64_t* ptr, double* out, void* stream) {
  return run_sum_t<double>(idx, w, m, n, ptr, out, stream);
}

}  // extern "C"
