// EmbeddingBag for Hopper (sm_90a): out[b] = sum over the bag's run of the
// bag-sorted stream of w_i * table[idx_i], or that sum over the sum of the
// weights of the valid lookups ('mean').  Built by
// repro_torch/kernels/_build.py with nvcc into a shared library with a plain
// C interface; bound with ctypes in repro_torch/kernels/embedding_bag.py.
//
// Replaces repro/kernels/embedding_bag.py::embedding_bag_kernel_call (body
// _kernel).  The TPU kernel DMAs one requested table row per grid step,
// addressed by a scalar-prefetched index, and accumulates the bag's output
// row across consecutive steps.  Here the stream is cut into equal chunks of
// kChunk = 512 lookups, one CTA of 256 threads each, whatever the bags'
// lengths:
//
//   1. each thread loads the index, weight and bag of lookups t and t + 256
//      (one coalesced load each); then each warp gathers the rows of its 32
//      + 32 lookups.  Rows of up to 13 floats are read as aligned 16-byte
//      loads over the row's 16-byte window, a lane per float4, a few rows
//      per warp instruction (fm's 11-float row starts at byte 44 r, so it
//      spans 3 or 4 of them, 4 lanes a row); wider rows a tile of kTile
//      columns at a time, a half warp per row.  A bag of 39 lookups
//      therefore costs two dependent rounds, indices then rows, and every
//      lane has loads in flight;
//   2. the weighted rows go to shared memory; the chunk's pieces (maximal
//      runs of one bag, found where bag[i] != bag[i - 1]) are listed with
//      one ballot per 32 lookups;
//   3. a thread per (piece, column) sums the piece's rows in stream order,
//      starting from 0.  A piece that is a whole bag is written to out; the
//      first piece of a chunk that continues the chunk before, and the last
//      piece when the bag runs on into the next chunk, go to a scratch of
//      partial sums (with their weight sums), two slots and a header per
//      chunk;
//   4. bag_merge: a thread per chunk whose last piece starts a bag that
//      runs on adds that bag's partials in chunk order and writes it.
//
// Bags with no lookup are written as 0 by the piece that follows them (and
// those after the last lookup by the last chunk).  Every sum has a fixed
// order and there are no float atomics, so the result is bit-reproducible
// from run to run; the order is stream order inside a chunk, then chunk
// order, which kernels/ref.py::embedding_bag_pieces_ref mirrors.
//
// What bounds it on this card: the latency of the two rounds of loads and
// of the chunk's passes through shared memory, hidden only by the CTAs an SM
// holds (six, by shared memory and registers).  Only the requested rows
// cross device memory; ids repeat (Zipf-distributed in the recsys
// workload), so repeated rows hit the 50 MB L2.  A 44-byte row touches at
// least two 32-byte sectors, so the sectors moved exceed the bytes the rows
// hold.
//
// idx < 0 (padding, and the wrapper's one sentinel per bag) and idx >= V
// add 0 and count nothing toward the 'mean' divisor.  Bag ids outside
// [0, n_bags) are dropped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 2;                // lookups a thread loads
constexpr int kChunk = kThreads * kPer;  // lookups per CTA
constexpr int kTile = 16;              // wide rows: columns staged per pass
constexpr int kStride = kTile + 1;     // their staged row stride (odd:
                                       // spreads banks; narrow rows d | 1)
constexpr int kGroups = kChunk / 32;    // ballots per chunk
constexpr int kMergeThreads = 256;
constexpr int kWideUnroll = 8;         // wide rows: loads in flight a lane
constexpr int kMinBlocks = 6;          // CTAs an SM holds: 1536 threads
constexpr int kRowLanes = 4;           // narrow rows: lanes a row, a float4
constexpr int kNarrowMax = 4 * kRowLanes - 3;  // floats: 13

// Words of the partials scratch per chunk: slot 0 (the first piece, where it
// continues the chunk before) and slot 1 (the last piece, where its bag runs
// on), each d sums and a weight sum, then a header of two ints: the flags
// below and the bag of the last piece.
__host__ __device__ __forceinline__ int64_t part_words(int d) {
  return 2 * (int64_t)(d + 1) + 2;
}
constexpr int kStartsRun = 1;    // the last piece starts a bag that runs on
constexpr int kRunsThrough = 2;  // one piece, continuing on both sides

// The chunk's weighted rows (one tile of wide rows) are staged in dynamic
// shared memory sized by the row width: fm's rows take 22.5 KB, so that six
// CTAs fit an SM.
struct Stage {
  float wt[kChunk];              // each lookup's weight, 0 where invalid
  float piece_w[kChunk];         // each piece's summed weights ('mean')
  int bag[kChunk];
  int piece[kChunk + 1];         // piece starts, local; piece[n] = len
  int count[kGroups];            // piece starts per 32 lookups
  int n_pieces, prev_bag, next_bag;
};

// Round 2 for rows of at most kNarrowMax floats: kRowLanes lanes per row,
// each one aligned float4 of the row's 16-byte window, so that one warp
// instruction reads 32 / kRowLanes whole rows (a request per row, not per
// lane).  The warp's 32 lookups of a slot take kRowLanes such loads, all in
// flight together; each lane's row and weight come from the lane that
// loaded them.
__device__ __forceinline__ void gather_narrow(
    float* rows, int stride, const float* __restrict__ table, int row,
    float wt, int slot, int len, int d, int64_t total, bool vec) {
  constexpr int kRows = 32 / kRowLanes;  // rows a warp instruction reads
  const int lane = threadIdx.x & 31, k = lane % kRowLanes;
  const int g = lane / kRowLanes;
  const int j = 4 * k;  // this lane's first float of the window
  float4 q[kRowLanes];
  float wts[kRowLanes];
  int off[kRowLanes];
#pragma unroll
  for (int it = 0; it < kRowLanes; ++it) {
    const int r = __shfl_sync(0xffffffffu, row, it * kRows + g);
    wts[it] = __shfl_sync(0xffffffffu, wt, it * kRows + g);
    const int64_t e0 = (int64_t)(r < 0 ? 0 : r) * d;
    const int64_t base = e0 & ~(int64_t)3;
    off[it] = (int)(e0 - base);
    const float* p = table + base;
    const int o = off[it];
    q[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r >= 0 && j < o + d) {
      if (vec && base + j + 4 <= total) {
        q[it] = __ldg(reinterpret_cast<const float4*>(p) + k);
      } else {
        // a table not 16-byte aligned, or the float4 past its last float
        q[it].x = (j >= o && j < o + d) ? __ldg(p + j) : 0.f;
        q[it].y = (j + 1 >= o && j + 1 < o + d) ? __ldg(p + j + 1) : 0.f;
        q[it].z = (j + 2 >= o && j + 2 < o + d) ? __ldg(p + j + 2) : 0.f;
        q[it].w = (j + 3 >= o && j + 3 < o + d) ? __ldg(p + j + 3) : 0.f;
      }
    }
  }
#pragma unroll
  for (int it = 0; it < kRowLanes; ++it) {
    // the local lookup: slot * kThreads + the warp's first thread + ...
    const int i = slot * kThreads + (threadIdx.x & ~31) + it * kRows + g;
    if (i < len) {
      const int c = j - off[it];
      const float v[4] = {q[it].x, q[it].y, q[it].z, q[it].w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + u >= 0 && c + u < d)
          rows[i * stride + c + u] = v[u] * wts[it];
    }
  }
}

// Round 2 for wider rows: columns [t0, t0 + width) of every lookup of the
// chunk, a half warp per row, a lane per column.
__device__ __forceinline__ void gather_wide(
    const Stage& s, float* rows, const int* idx_s,
    const float* __restrict__ table, int len, int d, int t0, int width) {
  const int lane = threadIdx.x & 31, c = lane & 15;
  const int first = (threadIdx.x >> 5) * 2 + (lane >> 4);
  constexpr int kStep = kThreads / 16;  // rows a pass of the CTA covers
  for (int i0 = first; i0 < len; i0 += kStep * kWideUnroll) {
    float x[kWideUnroll];
#pragma unroll
    for (int u = 0; u < kWideUnroll; ++u) {
      const int i = i0 + u * kStep;
      const int row = i < len ? idx_s[i] : -1;
      x[u] = (row >= 0 && c < width)
                 ? __ldg(table + (int64_t)row * d + t0 + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kWideUnroll; ++u) {
      const int i = i0 + u * kStep;
      if (i < len && c < width) rows[i * kStride + c] = x[u] * s.wt[i];
    }
  }
}

// Step 3 for columns [t0, t0 + width): a thread per (piece, column).
__device__ __forceinline__ void sum_pieces(
    const Stage& s, const float* rows, int stride, float* __restrict__ out,
    float* __restrict__ part, int64_t n_bags, int d, int mean, int t0,
    int width, bool head_cont, bool tail_cont, bool last_chunk) {
  const int n_pieces = s.n_pieces;
  const int64_t slot0 = (int64_t)blockIdx.x * part_words(d);
  for (int q = threadIdx.x; q < n_pieces * width; q += kThreads) {
    const int p = q / width, c = q - p * width, col = t0 + c;
    const int a = s.piece[p], e = s.piece[p + 1];
    float acc = 0.f;
#pragma unroll 4
    for (int i = a; i < e; ++i) acc += rows[i * stride + c];
    const int64_t b = s.bag[a];
    const bool head = p == 0 && head_cont;
    if (head) {
      part[slot0 + col] = acc;
    } else if (p == n_pieces - 1 && tail_cont) {
      part[slot0 + (d + 1) + col] = acc;
    } else if (b >= 0 && b < n_bags) {
      out[b * d + col] = mean ? acc / fmaxf(s.piece_w[p], 1e-9f) : acc;
    }
    if (!head) {  // the bags between the lookup before and this one
      const int64_t prev = a > 0 ? s.bag[a - 1] : s.prev_bag;
      const int64_t hi = b < n_bags ? b : n_bags;
      for (int64_t z = prev + 1 < 0 ? 0 : prev + 1; z < hi; ++z)
        out[z * d + col] = 0.f;
    }
    if (last_chunk && p == n_pieces - 1) {  // the bags after the last one
      for (int64_t z = b + 1 < 0 ? 0 : b + 1; z < n_bags; ++z)
        out[z * d + col] = 0.f;
    }
  }
}

// kNarrow: rows of at most kNarrowMax floats, kRowLanes lanes a row;
// otherwise wider rows, kTile columns at a time.
template <bool kNarrow>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bag_chunks(const float* __restrict__ table, const int* __restrict__ idx,
               const float* __restrict__ w, const int* __restrict__ bag,
               float* __restrict__ out, float* __restrict__ part, int64_t n,
               int64_t n_bags, int d, int64_t n_rows, int mean, int vec) {
  __shared__ Stage s;
  extern __shared__ __align__(16) float rows[];  // kChunk x stride, then
                                                 // (wide) idx
  const int stride = kNarrow ? (d | 1) : kStride;
  int* idx_s = reinterpret_cast<int*>(rows + kChunk * kStride);
  const int t = threadIdx.x, lane = t & 31;
  const int64_t c0 = (int64_t)blockIdx.x * kChunk;
  const int len = (int)(n - c0 < kChunk ? n - c0 : kChunk);
  const bool last_chunk = c0 + len == n;

  // round 1: index, weight and bag of this thread's lookups, i = t, t +
  // kThreads, ...
  int row[kPer];
  float wt[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = u * kThreads + t;
    row[u] = -1;
    wt[u] = 0.f;
    if (i < len) {
      const int r = __ldg(idx + c0 + i);
      const float wv = w != nullptr ? __ldg(w + c0 + i) : 1.0f;
      s.bag[i] = __ldg(bag + c0 + i);
      if (r >= 0 && r < n_rows) {
        row[u] = r;
        wt[u] = wv;
      }
      s.wt[i] = wt[u];
      if (!kNarrow) idx_s[i] = row[u];
    }
  }
  if (t == 0) {
    s.prev_bag = c0 > 0 ? __ldg(bag + c0 - 1) : -1;
    s.next_bag = last_chunk ? 0 : __ldg(bag + c0 + len);
  }
  // round 2 (narrow rows): each warp's rows
  if (kNarrow) {
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      gather_narrow(rows, stride, table, row[u], wt[u], u, len, d,
                    n_rows * d, vec != 0);
  }
  __syncthreads();

  // the chunk's pieces: a start wherever the bag changes
  bool start[kPer];
  unsigned starts[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = u * kThreads + t;
    start[u] = i < len && (i == 0 || s.bag[i] != s.bag[i - 1]);
    starts[u] = __ballot_sync(0xffffffffu, start[u]);
    if (lane == 0) s.count[i >> 5] = __popc(starts[u]);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = u * kThreads + t;
    if (start[u]) {
      int before = 0;
      for (int g = 0; g < (i >> 5); ++g) before += s.count[g];
      s.piece[before + __popc(starts[u] & ((1u << lane) - 1))] = i;
    }
  }
  if (t == 0) {
    int total = 0;
    for (int g = 0; g < kGroups; ++g) total += s.count[g];
    s.n_pieces = total;
    s.piece[total] = len;
  }
  __syncthreads();
  const bool head_cont = c0 > 0 && s.prev_bag == s.bag[0];
  const bool tail_cont = !last_chunk && s.next_bag == s.bag[len - 1];
  if (t == 0) {  // the header bag_merge reads
    int* hdr = reinterpret_cast<int*>(part + (int64_t)blockIdx.x *
                                                 part_words(d) + 2 * (d + 1));
    const bool one = s.n_pieces == 1 && head_cont;
    hdr[0] = (tail_cont && !one ? kStartsRun : 0) |
             (tail_cont && one ? kRunsThrough : 0);
    hdr[1] = s.bag[len - 1];
  }

  if (mean) {  // each piece's weights, in stream order
    const int64_t slot0 = (int64_t)blockIdx.x * part_words(d);
    for (int p = t; p < s.n_pieces; p += kThreads) {
      float acc = 0.f;
      for (int i = s.piece[p]; i < s.piece[p + 1]; ++i) acc += s.wt[i];
      s.piece_w[p] = acc;
      if (p == 0 && head_cont)
        part[slot0 + d] = acc;
      else if (p == s.n_pieces - 1 && tail_cont)
        part[slot0 + (d + 1) + d] = acc;
    }
    __syncthreads();
  }

  if (kNarrow) {
    sum_pieces(s, rows, stride, out, part, n_bags, d, mean, 0, d, head_cont,
               tail_cont, last_chunk);
    return;
  }
  for (int t0 = 0; t0 < d; t0 += kTile) {
    const int width = d - t0 < kTile ? d - t0 : kTile;
    gather_wide(s, rows, idx_s, table, len, d, t0, width);
    __syncthreads();
    sum_pieces(s, rows, kStride, out, part, n_bags, d, mean, t0, width,
               head_cont, tail_cont, last_chunk);
    __syncthreads();
  }
}

// A thread per chunk: where the chunk's last piece starts a bag that runs
// on past the chunk's end (its header says so), add that bag's partials in
// chunk order and write it.
__global__ void __launch_bounds__(kMergeThreads)
    bag_merge(const float* __restrict__ part, float* __restrict__ out,
              int64_t n_bags, int d, int mean, int64_t n_chunks) {
  const int64_t k = (int64_t)blockIdx.x * kMergeThreads + threadIdx.x;
  if (k >= n_chunks) return;
  const int64_t words = part_words(d), head = 2 * (int64_t)(d + 1);
  const int* hdr = reinterpret_cast<const int*>(part + k * words + head);
  if (!(hdr[0] & kStartsRun)) return;
  const int64_t b = hdr[1];
  if (b < 0 || b >= n_bags) return;
  // the bag's last chunk: the first after k it does not run through
  int64_t last = k + 1;
  while (reinterpret_cast<const int*>(part + last * words + head)[0] &
         kRunsThrough)
    ++last;
  const float* first = part + k * words + (d + 1);  // chunk k's slot 1
  float* row = out + b * d;
  if (last == k + 1) {  // fm's case: the sums below, loads in one round
    const float* second = part + last * words;
    const float ws = mean ? fmaxf(first[d] + second[d], 1e-9f) : 1.f;
    for (int c = 0; c < d; ++c) {
      const float acc = first[c] + second[c];
      row[c] = mean ? acc / ws : acc;
    }
    return;
  }
  float ws = 1.f;
  if (mean) {
    ws = first[d];
    for (int64_t j = k + 1; j <= last; ++j) ws += part[j * words + d];
    ws = fmaxf(ws, 1e-9f);
  }
  for (int c = 0; c < d; ++c) {
    float acc = first[c];
    for (int64_t j = k + 1; j <= last; ++j) acc += part[j * words + c];
    row[c] = mean ? acc / ws : acc;
  }
}

template <bool kNarrow>
void launch_chunks(unsigned grid, cudaStream_t s, const float* table,
                   const int* idx, const float* w, const int* bag, float* out,
                   float* part, int64_t n, int64_t n_bags, int d,
                   int64_t n_rows, int mean, int vec) {
  const size_t smem = kNarrow
                          ? (size_t)kChunk * (d | 1) * sizeof(float)
                          : (size_t)kChunk * (kStride + 1) * sizeof(float);
  bag_chunks<kNarrow><<<grid, kThreads, smem, s>>>(
      table, idx, w, bag, out, part, n, n_bags, d, n_rows, mean, vec);
}

}  // namespace

extern "C" {

// Lookups per chunk.
int embedding_bag_chunk(void) { return kChunk; }

// Floats of the partials scratch a stream of n lookups of width d needs.
int64_t embedding_bag_scratch(int64_t n, int d) {
  return (n + kChunk - 1) / kChunk * part_words(d);
}

// table (n_rows, d) f32; idx (n,) int32 sorted by bag; w (n,) f32 or null;
// bag (n,) int32, non-decreasing; out (n_bags, d) f32; part scratch of
// embedding_bag_scratch(n, d) f32.  mean != 0 divides by the
// bag's sum of valid weights (floored at 1e-9).  Returns cudaGetLastError()
// (or the memset's error for an empty stream).
int embedding_bag(const float* table, const int* idx, const float* w,
                  const int* bag, float* out, float* part, int64_t n,
                  int64_t n_bags, int d, int64_t n_rows, int mean,
                  void* stream) {
  if (n_bags == 0 || d == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0)
    return (int)cudaMemsetAsync(out, 0, (size_t)n_bags * d * sizeof(float),
                                s);
  const int64_t n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)n_chunks;
  const int vec = ((uintptr_t)table & 15) == 0;
  if (d <= kNarrowMax)
    launch_chunks<true>(grid, s, table, idx, w, bag, out, part, n, n_bags, d,
                        n_rows, mean, vec);
  else
    launch_chunks<false>(grid, s, table, idx, w, bag, out, part, n, n_bags,
                         d, n_rows, mean, vec);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int64_t merge_blocks = (n_chunks + kMergeThreads - 1) / kMergeThreads;
  bag_merge<<<(unsigned)merge_blocks, kMergeThreads, 0, s>>>(
      part, out, n_bags, d, mean, n_chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
