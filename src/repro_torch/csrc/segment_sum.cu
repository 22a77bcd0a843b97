// Segment sum for Hopper (sm_90a) as a CSR row reduction:
//
//     out[s] = sum over j in [offsets[s], offsets[s + 1]) of table[rows[j]]
//
// with rows = null meaning rows[j] = j, and a rows[j] outside [0, t_rows)
// adding 0.  Built by repro_torch/kernels/_build.py with nvcc into a shared
// library with a plain C interface; bound with ctypes in
// repro_torch/kernels/segment_sum.py, which also builds the plan (a stable
// sort of the segment ids and their offsets) that turns a segment-id stream
// into this form.
//
// Replaces repro/kernels/segment_sum.py::segment_sum_kernel_call (body
// _kernel).  The TPU kernel keeps all of out resident in VMEM and adds a
// one-hot (M, block_n) x (block_n, d) product per grid step, in order.  Here
// out (M, d) is far larger than shared memory (2,449,029 x 64 floats on
// gin-tu's ogb_products batch), and blocks run in no order.
//
// What bounds it on this card: bytes.  Each entry reads one table row (d
// floats, 256 B at d 64) at a random place, against one add per float; the
// rows are gathered in place, so the (E, d) messages of a gather followed by
// a sum are never written.
//
// Design: one group of gw lanes (gw = d / 4 rounded up to a power of two,
// at most 32; 16 at d 64, so two groups a warp) owns one output row at a
// time; each lane holds 4 columns in a float4 (one float where d is not a
// multiple of 4 or the table not 16-byte aligned), adds the row's entries in
// the order of j in f32 registers, and writes the row once.  There are no
// atomics and no zero fill: an empty row is written as 0.  Each group loads
// kUnroll entries' ids and then their rows before it adds them, so several
// gathered rows are in flight; a run of kUnroll entries may span row ends,
// which the in-order adds emit as they pass them.
//
// Work split (merge path): the path of M row ends and E entries, in CSR
// order, is cut into shares of `share` items (the wrapper's block_n); group
// g walks share g, finding its start and end by binary search over
// r + offsets[r].  A row whose items straddle shares (every row longer than
// a share, so hub rows with tens of thousands of entries are spread over
// many groups) is summed in pieces: the group where it starts writes its
// piece to slot 1 of its two scratch rows, each later group to slot 0, and
// a second pass (segment_sum_fix) adds the pieces in share order.  So every
// row's bits depend on offsets, rows, table and share alone: the result is
// bit-reproducible from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;   // entries whose rows are loaded before their adds

__device__ __forceinline__ float4 load(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ void zero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void zero(float& a) { a = 0.f; }
__device__ __forceinline__ void add(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void add(float& a, float b) { a += b; }

template <int V> struct Vec { using T = float; };
template <> struct Vec<4> { using T = float4; };

// The largest r in [0, m] with r + off[r] - base <= k: the row whose items
// hold path position k (row m: the end of the path).
__device__ __forceinline__ long long find_row(const long long* off,
                                              long long m, long long base,
                                              long long k) {
  long long lo = 0, hi = m;
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if (mid + __ldg(off + mid) - base <= k) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Pass 1: group g sums the rows of its share; a piece of a row that
// straddles shares goes to part[g][0] (the row began in an earlier share)
// or part[g][1] (it begins here), and tail[g] names the row of slot 1, -1
// when there is none.
template <int V>
__global__ void __launch_bounds__(kThreads)
    segment_sum_rows(const float* __restrict__ table,
                     const int* __restrict__ rows,
                     const long long* __restrict__ off,
                     float* __restrict__ out, float* __restrict__ part,
                     long long* __restrict__ tail, long long m,
                     long long t_rows, int d, int gw, long long share,
                     long long n_groups) {
  using T = typename Vec<V>::T;
  const int lane = threadIdx.x % gw;
  const long long g = ((long long)blockIdx.x * kThreads + threadIdx.x) / gw;
  if (g >= n_groups) return;
  const int col = blockIdx.y * 32 * V + lane * V;
  const bool on = col < d;
  const bool writes_tail = blockIdx.y == 0 && lane == 0;
  const long long base = __ldg(off);
  const long long total = m + __ldg(off + m) - base;
  const long long k0 = g * share;
  if (k0 >= total) {
    if (writes_tail) tail[g] = -1;
    return;
  }
  const long long k1 = k0 + share < total ? k0 + share : total;
  const long long r0 = find_row(off, m, base, k0);
  const long long r1 = find_row(off, m, base, k1);
  const long long j0 = base + k0 - r0, j1 = base + k1 - r1;
  const bool cont = j0 > __ldg(off + r0);    // row r0 began in a share before
  float* slot0 = part + 2 * g * d;
  float* slot1 = slot0 + d;

  T acc;
  zero(acc);
  long long r = r0, j = j0;
  long long row_end = __ldg(off + r + 1);    // r0 < m: k0 < total
  // every lane of the group takes the same branches: the row ends and the
  // entry counts are the group's, only the columns differ
  auto emit = [&]() {
    float* dst = (r == r0 && cont) ? slot0 : out + r * d;
    if (on) *reinterpret_cast<T*>(dst + col) = acc;
    zero(acc);
    ++r;
  };
  while (true) {
    while (r < r1 && row_end <= j) {
      emit();
      row_end = r < m ? __ldg(off + r + 1) : 0;
    }
    if (j >= j1) break;
    const int n = j1 - j < kUnroll ? (int)(j1 - j) : kUnroll;
    T x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      zero(x[u]);
      if (u < n) {
        const long long id = rows ? (long long)__ldg(rows + j + u) : j + u;
        if (on && id >= 0 && id < t_rows)
          x[u] = load(reinterpret_cast<const T*>(table + id * d + col));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u < n) {
        // entry j + u lies before j1, so its row is at most r1 < m
        while (row_end <= j + u) {
          emit();
          row_end = __ldg(off + r + 1);
        }
        add(acc, x[u]);
      }
    }
    j += n;
  }
  // r == r1 now; its entries consumed here, if any, are a piece
  bool tailed = false;
  if (r1 < m) {
    const long long o = __ldg(off + r1);
    if (j1 > (j0 > o ? j0 : o)) {
      const bool middle = r1 == r0 && cont;
      if (on) *reinterpret_cast<T*>((middle ? slot0 : slot1) + col) = acc;
      tailed = !middle;
    }
  }
  if (writes_tail) tail[g] = tailed ? r1 : -1;
}

// Pass 2: the group whose share holds the first piece of a straddling row
// adds that row's pieces in share order and writes the row.
template <int V>
__global__ void __launch_bounds__(kThreads)
    segment_sum_fix(const long long* __restrict__ off,
                    const float* __restrict__ part,
                    const long long* __restrict__ tail,
                    float* __restrict__ out, int d, int gw, long long share,
                    long long n_groups) {
  using T = typename Vec<V>::T;
  const int lane = threadIdx.x % gw;
  const long long g = ((long long)blockIdx.x * kThreads + threadIdx.x) / gw;
  if (g >= n_groups) return;
  const long long r = tail[g];
  const int col = blockIdx.y * 32 * V + lane * V;
  if (r < 0 || col >= d) return;
  const long long last = (r + __ldg(off + r + 1) - __ldg(off)) / share;
  T acc = load(reinterpret_cast<const T*>(part + (2 * g + 1) * d + col));
  for (long long h = g + 1; h <= last; ++h)
    add(acc, load(reinterpret_cast<const T*>(part + 2 * h * d + col)));
  *reinterpret_cast<T*>(out + r * d + col) = acc;
}

template <int V>
int run(const float* table, const int* rows, const long long* off, float* out,
        float* part, long long* tail, long long m, long long t_rows, int d,
        long long share, long long n_groups, cudaStream_t stream) {
  const int per = (d < 32 * V ? d : 32 * V);
  int gw = 1;
  while (gw * V < per) gw *= 2;
  const long long blocks = (n_groups * gw + kThreads - 1) / kThreads;
  const long long chunks = (d + 32 * V - 1) / (32 * V);
  if (blocks > 0x7fffffff || chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)chunks);
  segment_sum_rows<V><<<grid, kThreads, 0, stream>>>(
      table, rows, off, out, part, tail, m, t_rows, d, gw, share, n_groups);
  int err = (int)cudaGetLastError();
  if (err != (int)cudaSuccess) return err;
  segment_sum_fix<V><<<grid, kThreads, 0, stream>>>(off, part, tail, out, d,
                                                    gw, share, n_groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (m, d) f32: out[s] = sum of table (t_rows, d) f32 rows rows[j] (int32;
// null: j) for j in [off[s], off[s + 1]) (int64, non-decreasing).  part
// (n_groups, 2, d) f32 and tail (n_groups,) int64 are scratch, n_groups at
// least (m + off[m] - off[0]) / share rounded up.  vec: 4 for float4 lanes
// (d a multiple of 4, table 16-byte aligned), else 1.  Returns
// cudaGetLastError() after the launches.
int segment_sum_csr(const float* table, const int* rows, const long long* off,
                    float* out, float* part, long long* tail, long long m,
                    long long t_rows, int d, long long share,
                    long long n_groups, int vec, void* stream) {
  if (m == 0 || d == 0) return (int)cudaSuccess;
  if (share < 1 || n_groups < 1 || (vec == 4 && d % 4 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4)
    return run<4>(table, rows, off, out, part, tail, m, t_rows, d, share,
                  n_groups, s);
  return run<1>(table, rows, off, out, part, tail, m, t_rows, d, share,
                n_groups, s);
}

}  // extern "C"
