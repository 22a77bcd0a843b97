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
// and the labels, would change from run to run.  These kernels add each run
// in stream order, in f32, the same adds the CPU makes, so their output
// equals the plain version's bit for bit on every run.  The second entry,
// run_sum, is the same in-order sum over any sorted stream (graph.contract's
// parallel coarse edges, the Louvain gain gate's column sums); run_sum_f64
// is it in double, for modularity's per-vertex and per-community sums,
// whose runs are long enough (a community of 10^5 vertices) for f32's
// in-order rounding to show in Q.
//
// What bounds it on this card: bytes, 12 per stream item (destination,
// label, weight; 20 with int64 ids, which are read as they are) and 8 per
// destination out; and the order.  A run's sum is a chain of dependent adds
// that no parallel work can shorten without changing the bits, so a run of
// L items takes at least L add latencies (about 4.2 cycles each in f32).
// The design keeps each chain fed from shared memory and runs every chain
// at once:
//
//   1. run_bounds: ptr[v] = the first item whose destination is >= v, for
//      v in [0, n] (each item writes the entries between its predecessor's
//      destination and its own, so no atomics); run_sum's empty
//      destinations get 0 there.
//   2. run_tiles: a CTA takes the kTile items [t0, t0 + kTile) and every
//      run that starts among them.  It copies the weights of a window
//      [t0, e) into shared memory (e reaches past the tile to the end of
//      the run holding the tile's last item, at most 2 kTile items) and
//      marks each item that starts a run in a bitmap.  Each thread takes
//      kPer items and adds every run starting there, in order, from shared
//      memory; a run never splits.  A run longer than kLongRun items (at
//      most one can start in a tile) is streamed after that: one producer
//      thread copies its weights into a ring of kStages stages in shared
//      memory with TMA bulk copies (cp.async.bulk, completing on an
//      mbarrier) and one consumer thread adds them in order, from 16-byte
//      reads of shared memory, loaded one group ahead of the adds.  Every
//      long run has its own CTA, so all chains run at once and the longest
//      sets the time.  The mode writes each run's (sum, label) at its first
//      item and the start bitmap, for step 3.  What holds this pass back:
//      a CTA lasts as long as its longest chain in the tile, and 64
//      registers a thread leave room for four CTAs an SM.
//   3. mode_pick (segment_mode only): the reference's second stage.  Per
//      destination, the best (sum, label) over its runs: the largest sum,
//      ties to the smaller label, a sum of -inf (or NaN) never winning.  It
//      reads the start bitmap and the runs' records only, and only
//      compares, so it is exact in any order: one thread scans a
//      destination of at most kSmall items, a warp a larger one, the whole
//      CTA one of more than kTile items.
//
// No atomics on values, so two calls give the same bits.  Ids outside
// [0, n) are ignored.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;               // items a CTA takes (TILE)
constexpr int kLongRun = kTile;           // longer runs stream (LONG_RUN)
constexpr int kPer = kTile / kThreads;    // items a thread takes
constexpr int kWindow = 2 * kTile;        // the most a window holds
constexpr int kStageBytes = 4096;
constexpr int kStages = 8;
constexpr int kBufBytes = kStages * kStageBytes;   // ring, or a window
constexpr int kSmall = 32;                // the pick's thread-alone size
constexpr int kLabelPad = 1 << 30;        // offload.LABEL_PAD
constexpr unsigned kFull = 0xffffffffu;

static_assert(kPer == 8, "a thread's start flags are one byte");
static_assert(kWindow * sizeof(double) <= kBufBytes, "window fits the ring");

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// 16-byte vectors of weights, added in order
template <typename W>
struct Vec;
template <>
struct Vec<float> {
  using T = float4;
  static __device__ __forceinline__ float add(float acc, const float4& v) {
    acc = __fadd_rn(acc, v.x);
    acc = __fadd_rn(acc, v.y);
    acc = __fadd_rn(acc, v.z);
    return __fadd_rn(acc, v.w);
  }
};
template <>
struct Vec<double> {
  using T = double2;
  static __device__ __forceinline__ double add(double acc, const double2& v) {
    acc = __dadd_rn(acc, v.x);
    return __dadd_rn(acc, v.y);
  }
};

// a run of the mode: its in-order sum and its label (clipped to LABEL_PAD,
// which every larger label reads as too), at the run's first item
struct alignas(8) Rec {
  float w;
  int l;
};

// -- mbarriers and bulk copies (PTX) -----------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16) from 16-byte aligned global src to shared dst
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// -- ids ---------------------------------------------------------------------

// kPer ids at p (kPer-aligned from a 16-byte aligned base), the first cnt of
// them read, as 64-bit values (the ids are int32 or int64)
template <typename I>
__device__ __forceinline__ void load_ids(const I* __restrict__ p, int cnt,
                                         int64_t (&v)[kPer]) {
  if (cnt == kPer) {
    constexpr int kQ = kPer * sizeof(I) / 16;
    I t[kPer];
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      reinterpret_cast<uint4*>(t)[q] =
          __ldg(reinterpret_cast<const uint4*>(p) + q);
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = t[k];
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = k < cnt ? (int64_t)__ldg(p + k) : 0;
  }
}

// the number of items, of kPer from item g on, before item e
__device__ __forceinline__ int count_from(int64_t g, int64_t e) {
  return e - g <= 0 ? 0 : (e - g < kPer ? (int)(e - g) : kPer);
}

// -- pass 1: bounds ----------------------------------------------------------

// ptr[v] = lower_bound(idx, v) for v in [0, n]; idx (m,) sorted ascending;
// kPer items a thread.  zero (run_sum's output, or null) gets 0 at every
// destination with no item.
template <typename I, typename W>
__global__ void __launch_bounds__(kThreads)
    run_bounds(const I* __restrict__ idx, int64_t m, int n,
               int64_t* __restrict__ ptr, W* __restrict__ zero) {
  const int64_t i0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kPer;
  if (i0 > m) return;
  int64_t a[kPer];
  load_ids(idx + i0, count_from(i0, m), a);
  int64_t prev = i0 == 0 ? -1 : (int64_t)__ldg(idx + i0 - 1);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t i = i0 + k;
    if (i > m) break;
    const int64_t cur = i == m ? (int64_t)n : a[k];
    const int64_t lo = prev + 1 > 0 ? prev + 1 : 0;
    const int64_t hi = cur < n ? cur : (int64_t)n;
    for (int64_t v = lo; v <= hi; ++v) ptr[v] = i;
    // every v in [lo, hi) has ptr[v] == ptr[v + 1] == i: no item
    if (zero != nullptr)
      for (int64_t v = lo; v < hi; ++v) zero[v] = W(0);
    prev = cur;
  }
}

// -- pass 2: run sums --------------------------------------------------------

// the weights of [from, to) added in order from shared memory, 16 bytes a
// read between a scalar head and tail
template <typename W>
__device__ __forceinline__ W add_span(const W* __restrict__ s, int from,
                                      int to) {
  using V = typename Vec<W>::T;
  constexpr int kV = sizeof(V) / sizeof(W);
  W acc = W(0);
  int j = from;
  const int up = (from + kV - 1) / kV * kV;
  for (; j < (up < to ? up : to); ++j) acc = add_rn(acc, s[j]);
  const V* p = reinterpret_cast<const V*>(s);
  const int qe = to / kV;
#pragma unroll 4
  for (int q = j / kV; q < qe; ++q) acc = Vec<W>::add(acc, p[q]);
  for (j = j > qe * kV ? j : qe * kV; j < to; ++j) acc = add_rn(acc, s[j]);
  return acc;
}

// acc plus the cnt weights (a multiple of the vector width) at stage, in
// order; each group of kGroup vectors is read while the one before is added
template <typename W>
__device__ __forceinline__ W add_stage(const unsigned char* stage, int cnt,
                                       W acc) {
  using V = typename Vec<W>::T;
  constexpr int kGroup = 8;
  const V* p = reinterpret_cast<const V*>(stage);
  const int nv = cnt / (int)(sizeof(V) / sizeof(W));
  int q = 0;
  if (nv >= kGroup) {
    V cur[kGroup], nxt[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) cur[g] = p[g];
    for (q = kGroup; q + kGroup <= nv; q += kGroup) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) nxt[g] = p[q + g];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) acc = Vec<W>::add(acc, cur[g]);
#pragma unroll
      for (int g = 0; g < kGroup; ++g) cur[g] = nxt[g];
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) acc = Vec<W>::add(acc, cur[g]);
  }
  for (; q < nv; ++q) acc = Vec<W>::add(acc, p[q]);
  return acc;
}

__device__ __forceinline__ int clip_label(int64_t l) {
  return l < kLabelPad ? (int)l : kLabelPad;
}

// The in-order sum of every run that starts in this CTA's tile.  run_sum
// (kMode false): runs of equal idx, out[id] = the sum.  segment_mode (kMode
// true): runs of equal (idx, label), recs[first item] = (the sum, the
// label), and startb gets the tile's start flags, a bit an item.
template <typename I, typename W, bool kMode>
__global__ void __launch_bounds__(kThreads, 4)
    run_tiles(const I* __restrict__ idx, const I* __restrict__ label,
              const W* __restrict__ w, const int64_t* __restrict__ ptr,
              int64_t m, int n, W* __restrict__ out, Rec* __restrict__ recs,
              unsigned char* __restrict__ startb) {
  __shared__ alignas(128) unsigned char buf[kBufBytes];
  __shared__ uint32_t starts[kWindow / 32];
  __shared__ alignas(8) uint64_t full[kStages], empty[kStages];
  __shared__ int64_t win_end, long_from, long_to;
  __shared__ int win_closed, long_id;
  W* sw = reinterpret_cast<W*>(buf);
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t t0 = (int64_t)blockIdx.x * kTile;
  const int64_t t1 = t0 + kTile < m ? t0 + kTile : m;

  if (tid == 0) {
    for (int r = 0; r < kStages; ++r) {
      mbar_init(&full[r], 1);
      mbar_init(&empty[r], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // The window ends where the run holding the tile's last item ends (a
    // run starting in the tile that is not streamed ends there or before),
    // at most kWindow items in.  It is closed where a run ends at e.
    const int64_t v = __ldg(idx + t1 - 1);
    int64_t e = t1;
    bool closed = true;   // an invalid last id ends every valid run before it
    if (v >= 0 && v < n) {
      const int64_t lo = __ldg(ptr + v), hi = __ldg(ptr + v + 1);
      e = hi < t0 + kWindow ? hi : t0 + kWindow;
      // run_sum's run is the destination: a long one streams, unread here
      if (!kMode && hi - lo > kLongRun) e = t1;
      closed = e == hi || e == m;
    }
    win_end = e;
    win_closed = closed;
    long_from = -1;
  }
  __syncthreads();

  // the window: weights into shared memory, run starts into the bitmap; the
  // ids (valid ones, else -1) and clipped labels of this thread's own kPer
  // tile items stay in registers
  const int64_t e = win_end;
  const int len = (int)(e - t0);
  int ids[kPer], labs[kPer];
  for (int r = 0; r * kTile < len; ++r) {
    const int j0 = r * kTile + tid * kPer;
    const int64_t g0 = t0 + j0;
    const int cnt = count_from(g0, e);
    int64_t a[kPer], b[kPer] = {};
    load_ids(idx + g0, cnt, a);
    if (kMode) load_ids(label + g0, cnt, b);
    if (cnt == kPer) {
      constexpr int kQ = kPer * sizeof(W) / 16;
      const uint4* src = reinterpret_cast<const uint4*>(w + g0);
      uint4* dst = reinterpret_cast<uint4*>(sw + j0);
#pragma unroll
      for (int q = 0; q < kQ; ++q) dst[q] = __ldg(src + q);
    } else {
      for (int k = 0; k < cnt; ++k) sw[j0 + k] = __ldg(w + g0 + k);
    }
    // the key before this thread's first item: the previous lane's last
    // (a lane with fewer than kPer items has only empty lanes after it)
    int64_t pa = __shfl_up_sync(kFull, (long long)a[kPer - 1], 1);
    int64_t pb = __shfl_up_sync(kFull, (long long)b[kPer - 1], 1);
    if (lane == 0 && cnt > 0 && g0 > 0) {
      pa = __ldg(idx + g0 - 1);
      if (kMode) pb = __ldg(label + g0 - 1);
    }
    uint32_t bits = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k < cnt && (g0 + k == 0 || a[k] != pa || b[k] != pb))
        bits |= 1u << k;
      pa = a[k];
      pb = b[k];
    }
    reinterpret_cast<unsigned char*>(starts)[j0 / kPer] = (unsigned char)bits;
    if (r == 0) {
      if (kMode && cnt > 0) startb[g0 / kPer] = (unsigned char)bits;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        ids[k] = a[k] >= 0 && a[k] < n ? (int)a[k] : -1;
        labs[k] = clip_label(b[k]);
      }
    }
  }
  __syncthreads();

  // each run that starts among this thread's items, added whole
  const bool closed = win_closed;
  const unsigned mine = reinterpret_cast<const unsigned char*>(starts)[tid];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int v = ids[k];
    if (!((mine >> k) & 1u) || v < 0) continue;
    const int s = tid * kPer + k;
    // its end: the next start in the window, else the window's end
    int end = len;
    bool found = false;
    for (int wi = (s + 1) >> 5; wi * 32 < len; ++wi) {
      uint32_t word = starts[wi];
      if (wi == (s + 1) >> 5) word &= kFull << ((s + 1) & 31);
      if (word) {
        end = wi * 32 + __ffs(word) - 1;
        found = end < len;
        if (!found) end = len;
        break;
      }
    }
    const bool open = !found && !closed;   // it may go on past the window
    if (open || end - s > kLongRun) {
      // at most one run longer than kTile starts in kTile items
      long_from = t0 + s;
      long_to = open ? (kMode ? -1 : __ldg(ptr + v + 1)) : t0 + end;
      long_id = v;
      continue;
    }
    const W acc = add_span(sw, s, end);
    if (kMode)
      recs[t0 + s] = Rec{(float)acc, labs[k]};
    else
      out[v] = acc;
  }
  // the generic proxy's window accesses come before the bulk copies' writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int64_t a = long_from;
  if (a < 0) return;
  int64_t b = long_to;
  if (kMode && b < 0) {
    // the mode's run goes on past the window: the first item in [e, the
    // destination's end) whose label differs (labels ascend there), found
    // by kThreads probes a round.  Items in [a, lo) all belong to the run.
    const int64_t lab = __ldg(label + a);
    int64_t lo = e, hi = __ldg(ptr + long_id + 1);
    while (lo < hi) {
      const int64_t step = (hi - lo + kThreads - 1) / kThreads;
      const int64_t p = lo + tid * step;
      const int c =
          __syncthreads_count(p < hi && (int64_t)__ldg(label + p) == lab);
      if (c == 0) break;   // the run ends at lo
      const int64_t nhi = lo + c * step < hi ? lo + c * step : hi;
      lo = lo + (c - 1) * step + 1;
      hi = nhi;
    }
    b = lo;
  }

  // the long run [a, b): its 16-byte aligned body [a16, b16) streams
  // through the ring; the few items on either side are read directly
  constexpr int kVec = 16 / sizeof(W);
  constexpr int kChunk = kStageBytes / sizeof(W);
  const int64_t a16 = (a + kVec - 1) / kVec * kVec, b16 = b / kVec * kVec;
  const int64_t chunks = (b16 - a16 + kChunk - 1) / kChunk;
  if (tid == 32) {   // producer
    for (int64_t c = 0; c < chunks; ++c) {
      const int r = (int)(c % kStages);
      if (c >= kStages) mbar_wait(&empty[r], (unsigned)((c / kStages - 1) & 1));
      const int64_t from = a16 + c * kChunk;
      const int64_t cnt = b16 - from < kChunk ? b16 - from : kChunk;
      const uint32_t bytes = (uint32_t)(cnt * sizeof(W));
      mbar_expect(&full[r], bytes);
      bulk_load(buf + r * kStageBytes, w + from, bytes, &full[r]);
    }
  } else if (tid == 0) {   // consumer: the one chain of adds
    W acc = W(0);
    for (int64_t j = a; j < a16; ++j) acc = add_rn(acc, __ldg(w + j));
    for (int64_t c = 0; c < chunks; ++c) {
      const int r = (int)(c % kStages);
      mbar_wait(&full[r], (unsigned)((c / kStages) & 1));
      const int64_t from = a16 + c * kChunk;
      const int cnt = (int)(b16 - from < kChunk ? b16 - from : kChunk);
      acc = add_stage<W>(buf + r * kStageBytes, cnt, acc);
      mbar_arrive(&empty[r]);
    }
    for (int64_t j = b16; j < b; ++j) acc = add_rn(acc, __ldg(w + j));
    if (kMode)
      recs[a] = Rec{(float)acc, clip_label(__ldg(label + a))};
    else
      out[long_id] = acc;
  }
}

// -- pass 3: the mode's pick -------------------------------------------------

struct Pick {
  float w;
  int l;
};

// (w, l) beats b: a larger sum, or an equal one with a smaller label
__device__ __forceinline__ bool beats(float w, int l, const Pick& b) {
  return w > b.w || (w == b.w && l < b.l);
}

// the start flags of the 32 items from item p on, those at or past hi clear
__device__ __forceinline__ uint32_t flags_at(const uint32_t* __restrict__ bits,
                                             int64_t p, int64_t hi) {
  const int64_t wi = p >> 5;
  const uint32_t got =
      __funnelshift_r(__ldg(bits + wi), __ldg(bits + wi + 1), (int)(p & 31));
  return hi - p >= 32 ? got : got & ((1u << (hi - p)) - 1u);
}

// best, improved by the runs that start at the flagged items of the 32
// from item p; four records' loads issued together
__device__ __forceinline__ void take_runs(const Rec* __restrict__ recs,
                                          int64_t p, uint32_t flags,
                                          Pick& best) {
  while (flags) {
    int64_t q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      q[u] = flags ? p + __ffs(flags) - 1 : -1;
      flags &= flags - 1;
    }
    Rec r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      r[u] = q[u] >= 0 ? recs[q[u]] : Rec{-INFINITY, 0};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (r[u].w > -INFINITY && beats(r[u].w, r[u].l, best))
        best = Pick{r[u].w, r[u].l};
  }
}

// the best run of the items [lo, hi), from 32-item chunks c0, c0 + stride,
// ... of it
__device__ __forceinline__ Pick best_run(const uint32_t* __restrict__ bits,
                                         const Rec* __restrict__ recs,
                                         int64_t lo, int64_t hi, int c0,
                                         int stride) {
  Pick best{-INFINITY, -1};
  for (int64_t p = lo + 32 * (int64_t)c0; p < hi; p += 32 * (int64_t)stride)
    take_runs(recs, p, flags_at(bits, p, hi), best);
  return best;
}

__device__ __forceinline__ Pick warp_best(Pick p) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, p.w, o);
    const int l = __shfl_xor_sync(kFull, p.l, o);
    if (beats(w, l, p)) p = Pick{w, l};
  }
  return p;
}

__device__ __forceinline__ void put(float* best_w, int* best_l, int v,
                                    const Pick& p) {
  // the reference's label plane is padded with LABEL_PAD, read back as -1
  best_w[v] = p.w;
  best_l[v] = p.l >= kLabelPad ? -1 : p.l;
}

// Two parts in one grid, block b.  First one thread a destination: d = b
// kThreads + tid with at most kSmall items, scanned alone (so a stream with
// few items and many destinations is as parallel as one with many).  Then,
// for b below the tile count, the destinations of more than kSmall items
// whose items start in tile b: a warp each, and the whole CTA for one of
// more than kTile items (at most one starts in a tile).
template <typename I>
__global__ void __launch_bounds__(kThreads)
    mode_pick(const I* __restrict__ dst, const int64_t* __restrict__ ptr,
              const Rec* __restrict__ recs, const uint32_t* __restrict__ bits,
              int64_t m, int n, float* __restrict__ best_w,
              int* __restrict__ best_l) {
  __shared__ int hub, nbig;
  __shared__ int big[kTile / kSmall + 1];
  __shared__ Pick part[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t d = (int64_t)blockIdx.x * kThreads + tid;
  if (d < n) {
    const int64_t lo = __ldg(ptr + d), hi = __ldg(ptr + d + 1);
    if (hi - lo <= kSmall) {
      Pick best{-INFINITY, -1};
      if (lo < hi) take_runs(recs, lo, flags_at(bits, lo, hi), best);
      put(best_w, best_l, (int)d, best);
    }
  }
  const int64_t t0 = (int64_t)blockIdx.x * kTile;
  if (t0 >= m) return;   // uniform: a block past the tiles
  if (tid == 0) hub = -1, nbig = 0;
  __syncthreads();
  // the destinations whose first item lies in [t0, t0 + kTile): those
  // after the item before t0, up to the one holding the tile's last item
  const int64_t before = t0 == 0 ? -1 : (int64_t)__ldg(dst + t0 - 1);
  const int64_t last = t0 + kTile < m ? t0 + kTile : m;
  const int64_t at_end = __ldg(dst + last - 1);
  const int64_t d0 = before + 1 > 0 ? before + 1 : 0;
  const int64_t d1 = at_end + 1 < n ? at_end + 1 : n;
  for (int64_t v = d0 + tid; v < d1; v += kThreads) {
    const int64_t lo = __ldg(ptr + v), hi = __ldg(ptr + v + 1);
    if (hi - lo > kTile)
      hub = (int)v;
    else if (hi - lo > kSmall)
      big[atomicAdd(&nbig, 1)] = (int)v;   // a slot each; the order is free
  }
  __syncthreads();
  for (int j = warp; j < nbig; j += kThreads / 32) {
    const int v = big[j];
    const Pick p = warp_best(
        best_run(bits, recs, __ldg(ptr + v), __ldg(ptr + v + 1), lane, 32));
    if (lane == 0) put(best_w, best_l, v, p);
  }
  const int h = hub;
  if (h < 0) return;   // uniform
  Pick p = warp_best(
      best_run(bits, recs, __ldg(ptr + h), __ldg(ptr + h + 1), tid, kThreads));
  if (lane == 0) part[warp] = p;
  __syncthreads();
  if (warp == 0) {
    p = lane < kThreads / 32 ? part[lane] : Pick{-INFINITY, -1};
    p = warp_best(p);
    if (lane == 0) put(best_w, best_l, h, p);
  }
}

template <typename I, typename W>
int bounds(const I* idx, int64_t m, int n, int64_t* ptr, W* zero,
           cudaStream_t stream) {
  const int64_t per_block = (int64_t)kThreads * kPer;
  const int64_t blocks = (m + 1 + per_block - 1) / per_block;
  run_bounds<I, W><<<(unsigned)blocks, kThreads, 0, stream>>>(idx, m, n, ptr,
                                                              zero);
  return (int)cudaGetLastError();
}

template <typename I, typename W>
int run_sum_t(const I* idx, const W* w, int64_t m, int n, int64_t* ptr,
              W* out, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = bounds<I, W>(idx, m, n, ptr, out, s);
  if (err != (int)cudaSuccess || m == 0) return err;
  run_tiles<I, W, false>
      <<<(unsigned)((m + kTile - 1) / kTile), kThreads, 0, s>>>(
          idx, nullptr, w, ptr, m, n, out, nullptr, nullptr);
  return (int)cudaGetLastError();
}

template <typename I>
int segment_mode_t(const I* dst, const I* label, const float* w, int64_t m,
                   int n, int64_t* ptr, void* recs, void* bits, float* best_w,
                   int* best_l, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  int err = bounds<I, float>(dst, m, n, ptr, nullptr, s);
  if (err != (int)cudaSuccess) return err;
  const int64_t tiles = (m + kTile - 1) / kTile;
  if (m > 0) {
    run_tiles<I, float, true><<<(unsigned)tiles, kThreads, 0, s>>>(
        dst, label, w, ptr, m, n, nullptr, static_cast<Rec*>(recs),
        static_cast<unsigned char*>(bits));
    err = (int)cudaGetLastError();
    if (err != (int)cudaSuccess) return err;
  }
  const int64_t dests = ((int64_t)n + kThreads - 1) / kThreads;
  mode_pick<I><<<(unsigned)(tiles > dests ? tiles : dests), kThreads, 0, s>>>(
      dst, ptr, static_cast<const Rec*>(recs),
      static_cast<const uint32_t*>(bits), m, n, best_w, best_l);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Per destination v in [0, n): the label whose run of weights sums highest
// (ties to the smaller label) and that sum; (-inf, -1) where no run has a
// sum above -inf.  dst, label (m,) int32 (int64 in segment_mode_i64) and w
// (m,) f32 sorted by (dst, label), each 16-byte aligned.  Scratch: ptr
// (n + 1,) int64, recs (m,) 8-byte records and bits (m / 32 + 2,) 32-bit
// words.  Returns cudaGetLastError().
int segment_mode(const int* dst, const int* label, const float* w, int64_t m,
                 int n, int64_t* ptr, void* recs, void* bits, float* best_w,
                 int* best_l, void* stream) {
  return segment_mode_t<int>(dst, label, w, m, n, ptr, recs, bits, best_w,
                             best_l, stream);
}

int segment_mode_i64(const int64_t* dst, const int64_t* label, const float* w,
                     int64_t m, int n, int64_t* ptr, void* recs, void* bits,
                     float* best_w, int* best_l, void* stream) {
  return segment_mode_t<int64_t>(dst, label, w, m, n, ptr, recs, bits, best_w,
                                 best_l, stream);
}

// out[v] = the weights of the items with idx == v added in stream order
// from 0.0f, for v in [0, n); idx (m,) int32 (int64 in the _i64 entries)
// sorted ascending, ids outside [0, n) ignored; idx and w 16-byte aligned;
// ptr (n + 1,) int64 scratch.  Returns cudaGetLastError().
int run_sum(const int* idx, const float* w, int64_t m, int n, int64_t* ptr,
            float* out, void* stream) {
  return run_sum_t<int, float>(idx, w, m, n, ptr, out, stream);
}

int run_sum_i64(const int64_t* idx, const float* w, int64_t m, int n,
                int64_t* ptr, float* out, void* stream) {
  return run_sum_t<int64_t, float>(idx, w, m, n, ptr, out, stream);
}

// run_sum with w and out in double.
int run_sum_f64(const int* idx, const double* w, int64_t m, int n,
                int64_t* ptr, double* out, void* stream) {
  return run_sum_t<int, double>(idx, w, m, n, ptr, out, stream);
}

int run_sum_f64_i64(const int64_t* idx, const double* w, int64_t m, int n,
                    int64_t* ptr, double* out, void* stream) {
  return run_sum_t<int64_t, double>(idx, w, m, n, ptr, out, stream);
}

}  // extern "C"
