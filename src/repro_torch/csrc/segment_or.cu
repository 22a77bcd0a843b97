// Segment OR for Hopper (sm_90a), two entries.  Built by
// repro_torch/kernels/_build.py with nvcc into a shared library with a plain
// C interface; bound with ctypes in repro_torch/kernels/segment_or.py.
//
// ---------------------------------------------------------------------------
// segment_or_rows: out[v, w] = OR over j in [offsets[v], offsets[v + 1]) of
// msg[src[j], w], a source outside [0, t_rows) adding nothing.
//
// Replaces repro/core/offload.py::segment_or (:154) with presorted=True as
// the reference's packed dense step calls it (repro/core/engine.py:643:
// segment_or(p_dst, take(msg, p_src), n, presorted=True)), plain jnp, no
// Pallas kernel.  MS-BFS's pull stream is sorted by destination and its sort
// is kept per CSR, so the step is a CSR row reduction with a row gather:
// offsets by destination and int32 sources in that order.  The gather is
// fused in, so no (m, W) array of gathered words is written anywhere.
//
// What bounds it on this card: the sources are read once from HBM (4 bytes
// an edge), offsets and out once (4 (n + 1) and 4 n W bytes); at RMAT-20
// that is 72.7 MB, 0.0217 ms at 3.35 TB/s.  But the gathered words come
// from a table of 4 n W bytes (4.2 MB at RMAT-20 and W 1) at random rows:
// each gather that misses L1 is one 32-byte L2 sector for 4 useful bytes,
// and that traffic, not HBM, sets the floor.  chip_smoke.py measures it
// with a probe that reads the sources and gathers the words and does
// nothing else (0.095 ms at RMAT-20 on an H100; 0.199 ms with the gathers
// kept out of L1, 0.029 ms when the table fits L1).  So the design keeps
// L1 for the table: the sources and offsets are read past L1
// (L1::no_allocate), shared memory takes a quarter of the SM's 256 KB, and
// every gather a thread makes is requested before any is used.
//
// Design (merge path, as csrc/segment_sum.cu): the path of n row ends and
// the items, in CSR order, is cut into shares of kShare positions, one a
// CTA, so a hub row with tens of thousands of in-edges spreads over many
// CTAs and a run of empty rows costs a CTA no more than its share.
//   1. segment_or_plan, a thread a row: the row spans its path positions,
//      so it writes the start of each share that begins there (split[b])
//      and zeroes the row if a share's edge cuts it.  No search.
//   2. segment_or_rows_kernel, a CTA a share (launched as the plan's
//      programmatic dependent, so its launch overlaps the plan): it reads
//      its first and last row from split, stages its sources (16 bytes a
//      thread where aligned) and its rows' ends in shared memory, and
//      counts the row ends that fall in each thread's kPer positions; an
//      exclusive scan of those counts gives each thread its rows and items
//      with no search.  Each thread gathers its items' words into
//      registers, then walks its positions: an item ORs its words in, a row
//      end emits the row.  A row that a thread both starts and ends is
//      stored at once, with no atomic.  The piece of a row still open at a
//      thread's end is its carry; a segmented inclusive OR-scan of the
//      carries by row (shuffles in a warp, the warps' totals through shared
//      memory) gives each thread the pieces of its first row held by the
//      threads before it.  A row cut at a CTA's edge is ORed into out with
//      atomicOr, which is exact: OR is order-free and idempotent, and the
//      plan zeroed exactly those rows.  Every other row, empty ones too, is
//      stored once.  W (words a row) above kMaxWords runs in column chunks
//      of the same shares.
//
// ---------------------------------------------------------------------------
// segment_or: out[idx[i], w] |= words[i, w] for every item i with idx[i] in
// [0, n), ids in any order; the combine of the push step's and the owners'
// unsorted streams.
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
// sorted by destination a run of one RMAT hub's in-edges, up to ~1e5
// items, then costs one atomic per 32 items; on an unsorted stream the
// merge finds fewer equal ids and changes nothing else.
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


// ---- segment_or_rows ------------------------------------------------------

constexpr int kRowThreads = 512;
constexpr int kPer = 4;                      // path positions a thread
constexpr int kShare = kRowThreads * kPer;   // path positions a CTA
constexpr int kWarps = kRowThreads / 32;
// The share of the SM's 256 KB of L1 and shared memory given to shared
// memory, in percent: 64 KB, four CTAs.  The rest is L1, which holds the
// gathered rows of RMAT's hub sources (a larger carveout, with more CTAs
// resident, ran 8% slower on an H100).
constexpr int kCarveout = 25;
constexpr int kMaxWords = 4;                 // words of a column chunk
// 16-byte source loads a thread makes to stage a share's items (the share's
// first item may sit up to 3 past a 16-byte boundary)
constexpr int kVecIter =
    (kShare + 3 + 4 * kRowThreads - 1) / (4 * kRowThreads);

// Loads that do not allocate in L1: the sources and offsets stream past, so
// L1 keeps the gathered rows of msg, which RMAT's hubs make worth keeping.
__device__ __forceinline__ int ld_stream(const int* p) {
  int v;
  asm volatile("ld.global.nc.L1::no_allocate.s32 %0, [%1];"
               : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int4 ld_stream4(const int* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// The plan, one thread a row: share b of the merge path (kShare positions
// of rows' items and ends, in CSR order) starts in row split[b] & kRowMask,
// with bit 31 set where it starts after that row's first position (the
// row began in share b - 1).  Row r spans positions [f(r), f(r + 1)), f(r)
// = r + off[r] - off[0], so it writes the splits of the shares that start
// there, and a row that a share edge cuts is zeroed: the main pass ORs its
// pieces in with atomics.  The main pass is launched as this grid's
// programmatic dependent and waits for it before it reads a split.
constexpr int kRowMask = 0x7fffffff;

__global__ void __launch_bounds__(kThreads)
    segment_or_plan(const int* __restrict__ off, int* __restrict__ split,
                    unsigned* __restrict__ out, int n, int w_per) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const int base = __ldg(off);
  const long long f0 = (long long)r + (ld_stream(off + r) - base);
  const long long f1 = (long long)r + 1 + (ld_stream(off + r + 1) - base);
  bool cut = false;
  for (long long b = (f0 + kShare - 1) / kShare; b * kShare < f1; ++b) {
    cut |= b * kShare > f0;
    split[b] = r | (b * kShare > f0 ? (int)0x80000000u : 0);
  }
  if (cut)
    for (int w = 0; w < w_per; ++w) out[(long long)r * w_per + w] = 0u;
}

// One CTA a share of kShare path positions; KW words of each row, from
// column col of msg (t_rows, w_per) and out (n, w_per).
template <int KW>
__global__ void __launch_bounds__(kRowThreads)
    segment_or_rows_kernel(const int* __restrict__ off,
                           const int* __restrict__ src,
                           const unsigned* __restrict__ msg,
                           const int* __restrict__ split,
                           unsigned* __restrict__ out, int n, int t_rows,
                           int w_per, int col, bool vec) {
  // the share's sources from buf[lag], its rows' ends after them
  __shared__ __align__(16) int buf[kShare + 8];
  __shared__ int warp_key[kWarps];
  __shared__ unsigned warp_val[kWarps * KW];
  __shared__ unsigned scan[kRowThreads * KW];   // the carries, scanned
  __shared__ int cnt[kRowThreads];           // row ends in a thread's kPer
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  cnt[tid] = 0;
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the plan's splits

  const int base = __ldg(off);
  const long long total = (long long)n + (__ldg(off + n) - base);
  const long long k0 = (long long)blockIdx.x * kShare;
  if (k0 >= total) return;                   // the same on every thread
  const long long k1 = k0 + kShare < total ? k0 + kShare : total;
  const int s0 = __ldg(split + blockIdx.x);
  const int s1 = k1 < total ? __ldg(split + blockIdx.x + 1) : n;
  const int r0 = s0 & kRowMask, r1 = s1 & kRowMask;
  const bool cont0 = s0 < 0;                 // r0 began before this share
  const bool cont1 = s1 < 0;                 // r1 goes on past it
  const int j0 = base + (int)(k0 - r0), j1 = base + (int)(k1 - r1);
  const int n_ends = r1 - r0;                // rows r0 .. r1 - 1 end here
  const int n_items = j1 - j0;
  const int len = (int)(k1 - k0);
  __syncthreads();                           // cnt is zero

  // Stage: item j's source at buf[j - a], a = j0 rounded down to 4 items,
  // read 16 bytes a thread; row r0 + i's end at ends[i].
  const int lag = j0 & 3, a = j0 - lag;
  int* ends = buf + ((n_items + lag + 3) & ~3);
#pragma unroll
  for (int it = 0; it < kVecIter; ++it) {
    const int c = 4 * (tid + it * kRowThreads);
    const int p = a + c;
    if (c < n_items + lag) {
      int4 v;
      if (vec && p >= j0 && p + 4 <= j1) {
        v = ld_stream4(src + p);
      } else {
        v.x = p >= j0 && p < j1 ? ld_stream(src + p) : -1;
        v.y = p + 1 >= j0 && p + 1 < j1 ? ld_stream(src + p + 1) : -1;
        v.z = p + 2 >= j0 && p + 2 < j1 ? ld_stream(src + p + 2) : -1;
        v.w = p + 3 < j1 ? ld_stream(src + p + 3) : -1;
      }
      *reinterpret_cast<int4*>(buf + c) = v;
    }
  }
  // row end i lies at local position i + ends[i], in thread (that) / kPer
  for (int i = tid; i < n_ends; i += kRowThreads) {
    const int v = ld_stream(off + r0 + 1 + i) - j0;
    ends[i] = v;
    atomicAdd(&cnt[(i + v) / kPer], 1);
  }
  __syncthreads();

  // This thread's path positions [d, e) hold row ends [x, xe) (an exclusive
  // scan of the counts) and items [q, q + n_mine)
  int xe = cnt[tid];
#pragma unroll
  for (int dd = 1; dd < 32; dd <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, xe, dd);
    if (lane >= dd) xe += v;
  }
  if (lane == 31) warp_key[warp] = xe;
  __syncthreads();
  for (int ww = 0; ww < warp; ++ww) xe += warp_key[ww];
  const int x = xe - cnt[tid];
  const int d = tid * kPer < len ? tid * kPer : len;
  const int e = d + kPer < len ? d + kPer : len;
  const int q = d - x, n_mine = (e - d) - (xe - x);
  // every word this thread ORs, requested before any is used
  unsigned g[kPer][KW];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int v = k < n_mine ? buf[lag + q + k] : -1;
    const bool ok = v >= 0 && v < t_rows;
    const unsigned* row = msg + (long long)(ok ? v : 0) * w_per + col;
#pragma unroll
    for (int w = 0; w < KW; ++w) g[k][w] = ok ? __ldg(row + w) : 0u;
  }

  // Walk: before item k, every row that ends at it; then the rows ending
  // at this thread's last position.  A row begun and ended here is whole
  // and stored; the first row's value waits for the threads before it.
  unsigned acc[KW], head[KW];
#pragma unroll
  for (int w = 0; w < KW; ++w) acc[w] = head[w] = 0u;
  bool head_ends = false;                    // this thread ends row x
  int i = x;
  auto emit = [&]() {
    if (i == x) {
      head_ends = true;
#pragma unroll
      for (int w = 0; w < KW; ++w) head[w] = acc[w];
    } else {
      unsigned* o = out + (long long)(r0 + i) * w_per + col;
#pragma unroll
      for (int w = 0; w < KW; ++w) o[w] = acc[w];
    }
#pragma unroll
    for (int w = 0; w < KW; ++w) acc[w] = 0u;
    ++i;
  };
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (k < n_mine) {
      while (i < xe && ends[i] == q + k) emit();
#pragma unroll
      for (int w = 0; w < KW; ++w) acc[w] |= g[k][w];
    }
  }
  while (i < xe) emit();

  // Segmented inclusive OR-scan of the carries (row r0 + i, acc) by row:
  // the rows do not decrease from thread to thread, so two threads with the
  // same row hold it on every thread between them.
  const int key = i;
#pragma unroll
  for (int dd = 1; dd < 32; dd <<= 1) {
    const int other = __shfl_up_sync(0xffffffffu, key, dd);
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const unsigned v = __shfl_up_sync(0xffffffffu, acc[w], dd);
      if (lane >= dd && other == key) acc[w] |= v;
    }
  }
  __syncthreads();                           // warp_key is read above
  if (lane == 31) {
    warp_key[warp] = key;
#pragma unroll
    for (int w = 0; w < KW; ++w) warp_val[warp * KW + w] = acc[w];
  }
  __syncthreads();
  for (int ww = 0; ww < warp; ++ww)
    if (warp_key[ww] == key)
#pragma unroll
      for (int w = 0; w < KW; ++w) acc[w] |= warp_val[ww * KW + w];
#pragma unroll
  for (int w = 0; w < KW; ++w) scan[tid * KW + w] = acc[w];
  __syncthreads();

  // This thread's first row, if it ends here, with the pieces of the
  // threads before it; row r0 begun in an earlier share is ORed in, once
  // the plan has zeroed it.
  if (head_ends) {
    if (tid > 0)
#pragma unroll
      for (int w = 0; w < KW; ++w) head[w] |= scan[(tid - 1) * KW + w];
    unsigned* o = out + (long long)(r0 + x) * w_per + col;
    if (x == 0 && cont0) {
#pragma unroll
      for (int w = 0; w < KW; ++w)
        if (head[w]) atomicOr(o + w, head[w]);
    } else {
#pragma unroll
      for (int w = 0; w < KW; ++w) o[w] = head[w];
    }
  }
  // Row r1 goes on past this share: its piece here, scanned into the last
  // thread's carry, is ORed in.
  if (tid == kRowThreads - 1 && cont1) {
    unsigned* o = out + (long long)r1 * w_per + col;
#pragma unroll
    for (int w = 0; w < KW; ++w)
      if (acc[w]) atomicOr(o + w, acc[w]);
  }
}

template <int KW>
int run_rows(const int* off, const int* src, const unsigned* msg,
             const int* split, unsigned* out, int n, int t_rows, int w_per,
             int col, bool vec, long long n_ctas, cudaStream_t stream) {
  const int err = (int)cudaFuncSetAttribute(
      segment_or_rows_kernel<KW>,
      cudaFuncAttributePreferredSharedMemoryCarveout, kCarveout);
  if (err != (int)cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_ctas);
  cfg.blockDim = dim3(kRowThreads);
  cfg.stream = stream;
  // a programmatic dependent of segment_or_plan (or, for a later column
  // chunk, of the chunk before, which starts it only when it completes)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, segment_or_rows_kernel<KW>, off, src,
                                 msg, split, out, n, t_rows, w_per, col,
                                 vec);
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

// out (n, w_per) int32: out[v, w] = OR of msg (t_rows, w_per) int32 rows
// src[j] (int32; outside [0, t_rows): nothing) for j in [off[v], off[v + 1])
// (off (n + 1,) int32, non-decreasing, off[n] <= m = len(src)).  split is
// scratch of segment_or_rows_shares(n, m) ints.  Every row of out is
// written; out needs no fill.  Returns cudaGetLastError() after the
// launches.
int segment_or_rows(const int* off, const int* src, const int* msg,
                    int* split, int* out, int n, int64_t m, int w_per,
                    int t_rows, void* stream) {
  if (n == 0 || w_per == 0) return (int)cudaSuccess;
  if (n < 0 || m < 0 || m > 0x7fffffffLL || w_per < 0 || t_rows < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // the path has n row ends and at most m items
  const long long n_ctas = ((long long)n + m + kShare - 1) / kShare;
  unsigned* o = reinterpret_cast<unsigned*>(out);
  const unsigned* x = reinterpret_cast<const unsigned*>(msg);
  segment_or_plan<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                    s>>>(off, split, o, n, w_per);
  int err = (int)cudaGetLastError();
  if (err != (int)cudaSuccess) return err;
  const bool vec = reinterpret_cast<uintptr_t>(src) % 16 == 0;
  for (int col = 0; col < w_per;) {
    const int left = w_per - col;
    const int kw = left >= kMaxWords ? kMaxWords : left >= 2 ? 2 : 1;
    err = kw == kMaxWords
              ? run_rows<kMaxWords>(off, src, x, split, o, n, t_rows, w_per,
                                    col, vec, n_ctas, s)
          : kw == 2 ? run_rows<2>(off, src, x, split, o, n, t_rows, w_per,
                                  col, vec, n_ctas, s)
                    : run_rows<1>(off, src, x, split, o, n, t_rows, w_per,
                                  col, vec, n_ctas, s);
    if (err != (int)cudaSuccess) return err;
    col += kw;
  }
  return (int)cudaSuccess;
}

// The ints of segment_or_rows' split scratch for n rows and m items.
int64_t segment_or_rows_shares(int n, int64_t m) {
  return ((int64_t)n + m + kShare - 1) / kShare + 1;
}

}  // extern "C"
