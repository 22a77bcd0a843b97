// BBCSR SpMV / SpMSpV for Hopper (sm_90a), one source templated on the
// destination combine.  Built by repro_torch/kernels/_build.py with nvcc into
// a shared library with a plain C interface; bound with ctypes in
// repro_torch/kernels/spmv_dma.py.
//
// Replaces the three Pallas bodies of repro/kernels/spmv_dma.py:
//   bbcsr_spmv                 <- spmv_bbcsr_kernel_call (_kernel, _tile_yblk)
//   bbcsr_spmspv, combine 0    <- spmspv_bbcsr_kernel_call, combine='add'
//                                 (_spmspv_kernel)
//   bbcsr_spmspv, combine 1|2  <- spmspv_bbcsr_kernel_call, combine='min'|'max'
//                                 (_spmspv_select_kernel, _tile_yblk_select)
//
// What bounds it on this card: bytes.  Each real slot costs 12 B of tile data
// (rows_local, cols_local, vals) plus one 4 B gather of x, against one add or
// min per slot, far below the card's ~20 operations per byte.  The padded
// tile array is mostly padding on skewed graphs, so only the first
// tile_cnt[t] slots of a tile are read (padding is always a tile's tail).
//
// Design: the work is split by live slots, not by row block.  A plan lists
// the live tiles (tile_cnt > 0 and, for SpMSpV, tile_active != 0) with the
// exclusive prefix sum of their counts (list_ptr), so live slot s lies in
// the list entry i with list_ptr[i] <= s < list_ptr[i+1].  The live slots
// are cut into equal shares of a few thousand (fewer when few slots are
// live, so that a sparse frontier still fills the card), and each warp of a
// persistent grid takes shares in turn.  A hub row block is spread over many
// warps and light row blocks share one, so no warp's time follows the
// heaviest row block (the first design's one CTA per row block walked the
// 504,695 slots of RMAT-20's heaviest block alone).  The plan is built on
// the device (bbcsr_plan: two passes over the per-tile counts, no host
// read), once per operand for SpMV and at each call for SpMSpV, so
// inactive tiles never reach the product kernel.
//
// A warp walks its share 128 live slots at a time, 32 per step, so its 32
// lanes hold 32 real slots whatever the tile sizes (on RMAT-20 a tile holds
// 9.1 real slots on average; the first design left over 90% of its lanes on
// padding).  It keeps a window of up to 128 list entries (where the entry's
// slots lie, its prefix, its column block, its row block) in its part of
// shared memory, loaded in one coalesced pass and reused until the walk
// leaves it.  Lane l looks at the (l+1)-th entry after the current one; the
// entries that start inside a 128-slot stretch mark a 128-bit map, so a lane
// finds its slot's entry with one popcount.  The warp accumulates into its
// own shared rows, indexed by the row within the block: a stretch spans at
// most kSlices row blocks (pieces of the share), each in its own row, and a
// row is flushed when its piece ends.  More slices let a stretch cover more
// light row blocks (sparse frontiers); fewer leave more of the SM's memory
// to L1, which the dense product needs for its x gathers.
//
// Combining, and why 'add' is bit-reproducible:
//   - 'add': a segmented warp scan sums each run of equal rows in adjacent
//     lanes into its last lane.  A step that crosses a tile boundary can
//     hold one row in two runs (hub rows sit in nearly every tile of their
//     row block), but the run ends of one tile hold distinct rows, so the
//     step's tiles update the row in tile order.  Each piece is summed by
//     one warp in a fixed order.  A row block whose live slots all lie in
//     one share is written to y by that warp; a split row block leaves a
//     piece in scratch (slot 1 of its first share, slot 0 of each later
//     one), and bbcsr_fixup sums them in share order.  No float atomics
//     anywhere, so two launches on the same inputs give equal bits.
//   - 'min' / 'max': floats map to unsigned keys whose order is the float
//     order, and each slot takes a shared atomicMin / atomicMax on its row:
//     exact in any order, so no scan.  Split row blocks are combined by the
//     same fixup pass, which spares seeding y with the identity.
//   Rows no live slot reaches come out as the combine identity: a flush
//   writes every row of its block, and the fixup writes the identity for
//   row blocks with no live slot (all padding, all inactive).  Columns at
//   or past x's length read the identity, as the padded x of the TPU
//   kernels does.
//
// What still bounds it: the padded layout.  A tile's live slots are the head
// of a 4 * tile_nnz-byte row in each of the three tile arrays, so the
// product reads short runs at a large stride rather than the 12 B per slot
// the byte bound counts (scripts/profile_bbcsr.py times that read alone).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Combine { kAdd = 0, kMin = 1, kMax = 2 };

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;              // product kernel: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                 // 32-slot steps per stretch
constexpr int kWin = 32 * kUnroll;         // window entries, stretch slots
constexpr int kSlices = 2;                 // row blocks a stretch may span
constexpr int kPlanThreads = 256;
constexpr int kPlanPer = 8;                // tiles per plan thread
constexpr int kPlanTiles = kPlanThreads * kPlanPer;

__device__ __forceinline__ unsigned int float_key(float f) {
  unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

template <int OP>
__device__ __forceinline__ float identity() {
  return OP == kAdd ? 0.0f
                    : (OP == kMin ? __int_as_float(0x7f800000)
                                  : __int_as_float(0xff800000));
}

// combine of two finished partials: min/max on the keys, so -0.0 / +0.0 and
// the infinities order as the plain version's amin / amax order them
template <int OP>
__device__ __forceinline__ float combine_exact(float a, float b) {
  if (OP == kAdd) return a + b;
  const unsigned ka = float_key(a), kb = float_key(b);
  return key_float(OP == kMin ? min(ka, kb) : max(ka, kb));
}

// an accumulator word as a float: the float itself for 'add', a key else
template <int OP>
__device__ __forceinline__ float acc_value(unsigned int k) {
  return OP == kAdd ? __uint_as_float(k) : key_float(k);
}

// ---------------------------------------------------------------------------
// Plan: live tiles, their live-slot prefix, the share, share starts and
// row-block starts
// ---------------------------------------------------------------------------

// block-wide sum of (a, b) over kPlanThreads threads; every thread gets the
// totals
__device__ __forceinline__ void block_sum2(int* a, int* b, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = *a, y = *b;
  for (int d = 16; d > 0; d >>= 1) {
    x += __shfl_xor_sync(kFull, x, d);
    y += __shfl_xor_sync(kFull, y, d);
  }
  if (lane == 0) {
    red[2 * warp] = x;
    red[2 * warp + 1] = y;
  }
  __syncthreads();
  x = 0;
  y = 0;
  for (int w = 0; w < kPlanThreads / 32; ++w) {
    x += red[2 * w];
    y += red[2 * w + 1];
  }
  __syncthreads();
  *a = x;
  *b = y;
}

// the live slots of tile t: tile_cnt[t] if the tile is live, else 0
__device__ __forceinline__ int live_count(const int* tile_cnt,
                                          const int* tile_active, int t,
                                          int n_tiles) {
  if (t >= n_tiles) return 0;
  const int c = tile_cnt[t];
  return (tile_active == nullptr || tile_active[t] != 0) ? c : 0;
}

// pass 1: per plan CTA, its live tiles and live slots
__global__ void __launch_bounds__(kPlanThreads)
    plan_count(const int* __restrict__ tile_cnt,
               const int* __restrict__ tile_active, int n_tiles,
               int* __restrict__ gsum) {
  __shared__ int red[2 * kPlanThreads / 32];
  const int base = blockIdx.x * kPlanTiles;
  int e = 0, s = 0;
#pragma unroll
  for (int i = 0; i < kPlanPer; ++i) {
    const int c = live_count(tile_cnt, tile_active,
                             base + i * kPlanThreads + threadIdx.x, n_tiles);
    e += c > 0;
    s += c;
  }
  block_sum2(&e, &s, red);
  if (threadIdx.x == 0) {
    gsum[2 * blockIdx.x] = e;
    gsum[2 * blockIdx.x + 1] = s;
  }
}

// live slots per share: the total over `shares`, a multiple of 32, within
// [share_min, share_max]
__device__ __forceinline__ int share_size(int total, int shares,
                                          int share_min, int share_max) {
  const int per = (int)(((long long)total + shares - 1) / shares);
  return min(share_max, max(share_min, (per + 31) / 32 * 32));
}

// pass 2: each plan CTA adds up the counts of the CTAs before it (and of
// all, for the share), scans its own tiles in shared memory, then writes
// its list entries, the share starts that fall in them and the live-slot
// offset of each row block that starts in it, consecutive threads on
// consecutive tiles; the last CTA writes the totals and the sentinels
__global__ void __launch_bounds__(kPlanThreads)
    plan_build(const int* __restrict__ tile_cnt,
               const int* __restrict__ tile_active,
               const int* __restrict__ tile_rb, int n_tiles, int n_rb,
               const int* __restrict__ gsum, int shares, int share_min,
               int share_max, int* __restrict__ list_tile,
               int* __restrict__ list_ptr, int* __restrict__ chunk_first,
               int* __restrict__ rb_slot, int* __restrict__ meta) {
  __shared__ int cnt_s[kPlanTiles];
  __shared__ int rb_s[kPlanTiles + 1];
  __shared__ int e_s[kPlanTiles];          // entries before the tile
  __shared__ int s_s[kPlanTiles];          // live slots before the tile
  __shared__ int red[2 * kPlanThreads / 32];
  __shared__ int wsum[2 * kPlanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kPlanTiles;
#pragma unroll
  for (int i = 0; i < kPlanPer; ++i) {
    const int k = i * kPlanThreads + threadIdx.x;
    cnt_s[k] = live_count(tile_cnt, tile_active, base + k, n_tiles);
    rb_s[k + 1] = base + k < n_tiles ? tile_rb[base + k] : -1;
  }
  if (threadIdx.x == 0) rb_s[0] = base > 0 ? tile_rb[base - 1] : -1;
  int be = 0, bs = 0, all_s = 0, unused = 0;
  for (int g = threadIdx.x; g < (int)gridDim.x; g += kPlanThreads) {
    if (g < (int)blockIdx.x) {
      be += gsum[2 * g];
      bs += gsum[2 * g + 1];
    }
    all_s += gsum[2 * g + 1];
  }
  block_sum2(&be, &bs, red);              // also orders the smem writes
  block_sum2(&all_s, &unused, red);
  const int share = share_size(all_s, shares, share_min, share_max);

  const int k0 = threadIdx.x * kPlanPer;
  int le = 0, ls = 0;
#pragma unroll
  for (int i = 0; i < kPlanPer; ++i) {
    le += cnt_s[k0 + i] > 0;
    ls += cnt_s[k0 + i];
  }
  // exclusive block scan of (le, ls)
  int ie = le, is = ls;
  for (int d = 1; d < 32; d <<= 1) {
    const int oe = __shfl_up_sync(kFull, ie, d);
    const int os = __shfl_up_sync(kFull, is, d);
    if (lane >= d) {
      ie += oe;
      is += os;
    }
  }
  if (lane == 31) {
    wsum[2 * warp] = ie;
    wsum[2 * warp + 1] = is;
  }
  __syncthreads();
  int we = 0, ws = 0, te = 0, ts = 0;
  for (int w = 0; w < kPlanThreads / 32; ++w) {
    if (w < warp) {
      we += wsum[2 * w];
      ws += wsum[2 * w + 1];
    }
    te += wsum[2 * w];
    ts += wsum[2 * w + 1];
  }
  int e = be + we + ie - le, s = bs + ws + is - ls;
#pragma unroll
  for (int i = 0; i < kPlanPer; ++i) {
    e_s[k0 + i] = e;
    s_s[k0 + i] = s;
    e += cnt_s[k0 + i] > 0;
    s += cnt_s[k0 + i];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kPlanTiles && base + k < n_tiles;
       k += kPlanThreads) {
    const int c = cnt_s[k], sk = s_s[k];
    if (rb_s[k + 1] != rb_s[k]) rb_slot[rb_s[k + 1]] = sk;
    if (c > 0) {
      list_tile[e_s[k]] = base + k;
      list_ptr[e_s[k]] = sk;
      for (long long q = ((long long)sk + share - 1) / share;
           q * share < (long long)sk + c; ++q) {
        chunk_first[q] = e_s[k];
      }
    }
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    const int n_list = be + te, total = bs + ts;
    const int n_chunks = (int)(((long long)total + share - 1) / share);
    list_ptr[n_list] = total;
    chunk_first[n_chunks] = n_list;
    rb_slot[n_rb] = total;
    meta[0] = n_list;
    meta[1] = n_chunks;
    meta[2] = share;
  }
}

int plan_launch(const int* tile_cnt, const int* tile_active,
                const int* tile_rb, int n_tiles, int n_rb, int shares,
                int share_min, int share_max, int* gsum, int* list_tile,
                int* list_ptr, int* chunk_first, int* rb_slot, int* meta,
                cudaStream_t stream) {
  const int grid = (n_tiles + kPlanTiles - 1) / kPlanTiles;
  plan_count<<<grid, kPlanThreads, 0, stream>>>(tile_cnt, tile_active,
                                                n_tiles, gsum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  plan_build<<<grid, kPlanThreads, 0, stream>>>(
      tile_cnt, tile_active, tile_rb, n_tiles, n_rb, gsum, shares,
      share_min, share_max, list_tile, list_ptr, chunk_first, rb_slot, meta);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Product: one share per warp step
// ---------------------------------------------------------------------------

// shared memory of the product kernel, per warp: its window of kWin
// entries (where the entry's live slots sit in the tile arrays, as int64
// tile * tile_nnz - prefix so that slot s is at base + s; its prefix; its
// first column in x; its row block), then its kSlices accumulator rows,
// padded to keep the next warp's int64s aligned
__host__ __device__ __forceinline__ int warp_words(int block_rows) {
  return 5 * kWin + ((kSlices * block_rows + 1) & ~1);
}

size_t smem_bytes(int block_rows) {
  return 4 * (size_t)kWarps * warp_words(block_rows);
}

// a warp writes its accumulator row for row block b and resets it: to y
// when the block's live slots [r0, r1) all lie in the share [s0, s1), else
// to the share's scratch slot for the fixup pass (0 when the block started
// in an earlier share)
template <int OP>
__device__ __forceinline__ void flush_piece(unsigned int* acc, int b, int r0,
                                            int r1, int s0, int s1, int c,
                                            float* y, float* scratch,
                                            int n_rows, int block_rows,
                                            unsigned int ident, int lane) {
  __syncwarp();
  const bool whole = r0 >= s0 && r1 <= s1;
  const int64_t row0 = (int64_t)b * block_rows;
  float* dst = whole ? y + row0
                     : scratch + ((int64_t)2 * c + (r0 < s0 ? 0 : 1)) *
                                     block_rows;
  for (int rr = lane; rr < block_rows; rr += 32) {
    const float out = acc_value<OP>(acc[rr]);
    acc[rr] = ident;
    if (!whole || row0 + rr < n_rows) dst[rr] = out;
  }
  __syncwarp();
}

// at most 64 registers a thread, so that 4 CTAs (32 warps) fit an SM
template <int OP>
__global__ void __launch_bounds__(kThreads, 4)
    bbcsr_product(const int* __restrict__ rows_local,
                  const int* __restrict__ cols_local,
                  const float* __restrict__ vals,
                  const int* __restrict__ tile_cb,
                  const int* __restrict__ tile_rb,
                  const int* __restrict__ list_tile,
                  const int* __restrict__ list_ptr,
                  const int* __restrict__ chunk_first,
                  const int* __restrict__ rb_slot,
                  const int* __restrict__ meta, const float* __restrict__ x,
                  int n_x, float* __restrict__ y, float* __restrict__ scratch,
                  int n_rows, int block_rows, int block_cols, int tile_nnz) {
  extern __shared__ int64_t smem_words[];
  unsigned int* smem = reinterpret_cast<unsigned int*>(smem_words);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t* w_base =
      reinterpret_cast<int64_t*>(smem + warp * warp_words(block_rows));
  int* w_ptr = reinterpret_cast<int*>(w_base + kWin);
  int* w_x = w_ptr + kWin;
  int* w_rb = w_x + kWin;
  unsigned int* acc = reinterpret_cast<unsigned int*>(w_rb + kWin);
  const unsigned int ident = OP == kAdd ? 0u : float_key(identity<OP>());
  for (int r = lane; r < kSlices * block_rows; r += 32) acc[r] = ident;
  const int n_list = meta[0], n_chunks = meta[1], share = meta[2];
  const int total = list_ptr[n_list];
  const unsigned int upto = kFull >> (31 - lane);   // lanes 0..lane

  for (int c = blockIdx.x * kWarps + warp; c < n_chunks;
       c += gridDim.x * kWarps) {
    const int s0 = c * share;
    const int s1 = min(s0 + share, total);
    int cur = chunk_first[c];            // the entry holding slot p
    int wbase = cur, wn = 0, wend = 0;   // window [wbase, wbase + wn)
    // the piece (row block) being accumulated, its live slots, its slice
    int b = -1, r0 = 0, r1 = 0, slice = 0;
    for (int p = s0; p < s1;) {
      // the window must hold the 32 entries after cur (or run to the end
      // of the list); wend is where the entry after the window starts
      if (cur - wbase + 32 >= wn && (cur - wbase >= wn ||
                                     wbase + wn < n_list)) {
        __syncwarp();
        wbase = cur;
        wn = min(kWin, n_list - wbase);
        for (int k = lane; k < wn; k += 32) {
          const int t = list_tile[wbase + k];
          const int pk = list_ptr[wbase + k];
          w_base[k] = (int64_t)t * tile_nnz - pk;
          w_ptr[k] = pk;
          w_x[k] = tile_cb[t] * block_cols;
          w_rb[k] = tile_rb[t];
        }
        wend = list_ptr[wbase + wn];
        __syncwarp();
      }
      const int kc = cur - wbase;
      const int rb = w_rb[kc];
      if (rb != b) {                     // the last stretch ended a piece
        if (b >= 0) {
          flush_piece<OP>(acc + slice * block_rows, b, r0, r1, s0, s1, c, y,
                          scratch, n_rows, block_rows, ident, lane);
          slice = (slice + 1) % kSlices;
        }
        b = rb;
        r0 = rb_slot[b];
        r1 = rb_slot[b + 1];
      }
      // lane l looks at entry kc + 1 + l.  The stretch [p, pe) ends at 128
      // slots, the share's end, the start of entry kc + 32 (so at most 31
      // entries start inside it) and where its kSlices-th row block would
      // start; the entries starting inside it mark bit (start - p) of a
      // 128-bit map, and each row block it spans takes the next slice
      const int kl = kc + 1 + lane;
      const int pk = kl < wn ? w_ptr[kl] : wend;
      const int rbl = kl < wn ? w_rb[kl] : -1;
      const int rb_up = __shfl_up_sync(kFull, rbl, 1);
      const int rb_before = lane == 0 ? rb : rb_up;
      const int lim = min(min(p + kWin, s1), __shfl_sync(kFull, pk, 31));
      const unsigned chg =
          __ballot_sync(kFull, kl < wn && pk < lim && rbl != rb_before);
      int pe = lim;
      if (__popc(chg) >= kSlices) {
        unsigned m = chg;
        for (int i = 1; i < kSlices; ++i) m &= m - 1;
        pe = __shfl_sync(kFull, pk, __ffs(m) - 1);
      }
      const bool in = pk < pe;
      const unsigned chg_in = chg & __ballot_sync(kFull, in);
      const int piece_l = __popc(chg_in & upto);   // of entry kc + 1 + lane
      // the row block a piece starting here would take, and its live slots
      int r0l = 0, r1l = 0;
      if ((chg_in >> lane) & 1u) {
        r0l = rb_slot[rbl];
        r1l = rb_slot[rbl + 1];
      }
      const int q = pk - p;
      unsigned int words[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        words[u] = __reduce_or_sync(
            kFull, in && (q >> 5) == u ? 1u << (q & 31) : 0u);
      }
      const int n_in = __popc(__ballot_sync(kFull, in));

      int key[kUnroll];                  // slice * block_rows + row
      int rank[kUnroll];                 // the slot's entry, from cur
      float v[kUnroll];
      int before = 0;                    // entry starts in earlier words
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = p + 32 * u + lane;
        rank[u] = before + __popc(words[u] & upto);
        const int pc = __shfl_sync(kFull, piece_l, (rank[u] + 31) & 31);
        key[u] = -1;
        v[u] = identity<OP>();
        if (s < pe) {
          const int k = kc + rank[u];
          const int64_t slot = w_base[k] + s;
          // each slot is read once: stream it past the caches, which then
          // keep x for the gathers
          const int col = w_x[k] + __ldcs(cols_local + slot);
          const float val = __ldcs(vals + slot);
          const int row = __ldcs(rows_local + slot);
          const float xv = col < n_x ? __ldg(x + col) : identity<OP>();
          v[u] = OP == kAdd ? val * xv : xv + val;
          key[u] = ((slice + (rank[u] ? pc : 0)) % kSlices) * block_rows + row;
        }
        before += __popc(words[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (OP != kAdd) {
          // min / max: the keys' atomics are exact in any order
          if (key[u] >= 0) {
            if (OP == kMin) atomicMin(acc + key[u], float_key(v[u]));
            else atomicMax(acc + key[u], float_key(v[u]));
          }
          continue;
        }
        // 'add': a segmented scan sums each run of equal keys in adjacent
        // lanes into its last lane (a run starts where the key changes, so
        // two runs of one row split by another row stay apart; steps with
        // no two adjacent equal keys skip it)
        const int prev = __shfl_up_sync(kFull, key[u], 1);
        const unsigned heads =
            __ballot_sync(kFull, lane == 0 || prev != key[u]);
        if (heads != kFull) {
          const int start = 31 - __clz(heads & upto);
          for (int d = 1; d < 32; d <<= 1) {
            const float o = __shfl_up_sync(kFull, v[u], d);
            if (lane - d >= start) v[u] += o;
          }
        }
        const bool end =
            key[u] >= 0 && (lane == 31 || ((heads >> (lane + 1)) & 1u));
        // the run ends of one entry (tile) hold distinct keys, as a tile's
        // slots are sorted by row; a step that spans entries can hold one
        // row in several, so the entries update in order
        float* accf = reinterpret_cast<float*>(acc);
        const int e0 = __shfl_sync(kFull, rank[u], 0);
        const int e1 = __reduce_max_sync(kFull, end ? rank[u] : e0);
        for (int e = e0; e <= e1; ++e) {
          if (end && rank[u] == e) accf[key[u]] += v[u];
          __syncwarp();
        }
      }
      // the pieces that ended inside the stretch, in order; the last one
      // it reached stays open
      for (unsigned m = chg_in; m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        flush_piece<OP>(acc + slice * block_rows, b, r0, r1, s0, s1, c, y,
                        scratch, n_rows, block_rows, ident, lane);
        slice = (slice + 1) % kSlices;
        b = __shfl_sync(kFull, rbl, src);
        r0 = __shfl_sync(kFull, r0l, src);
        r1 = __shfl_sync(kFull, r1l, src);
      }
      // the entry holding pe: cur's successors that start at or before it
      const int nxt_ptr = __shfl_sync(kFull, pk, n_in & 31);
      cur = wbase + kc + n_in + (n_in < 32 && nxt_ptr <= pe ? 1 : 0);
      p = pe;
    }
    if (b >= 0) {
      flush_piece<OP>(acc + slice * block_rows, b, r0, r1, s0, s1, c, y,
                      scratch, n_rows, block_rows, ident, lane);
    }
  }
}

// row blocks whose live slots span shares: combine their pieces in share
// order, loading a batch of pieces ahead of the combine; row blocks with no
// live slot: the identity
template <int OP>
__global__ void __launch_bounds__(kThreads)
    bbcsr_fixup(const int* __restrict__ rb_slot,
                const int* __restrict__ meta,
                const float* __restrict__ scratch, float* __restrict__ y,
                int n_rows, int block_rows) {
  constexpr int kBatch = 32;
  const int b = blockIdx.x;
  const int share = meta[2];
  const int r0 = rb_slot[b], r1 = rb_slot[b + 1];
  const int64_t row0 = (int64_t)b * block_rows;
  const int c0 = r0 / share, c1 = r1 > r0 ? (r1 - 1) / share : c0;
  if (r1 > r0 && c0 == c1) return;        // written by the product kernel
  for (int rr = threadIdx.x; rr < block_rows; rr += kThreads) {
    if (row0 + rr >= n_rows) break;
    float v = identity<OP>();
    if (r1 > r0) {
      // the first share's piece sits in its slot 1, later ones in slot 0
      v = scratch[((int64_t)2 * c0 + 1) * block_rows + rr];
      for (int c = c0 + 1; c <= c1; c += kBatch) {
        float o[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          o[i] = c + i <= c1
                     ? scratch[(int64_t)2 * (c + i) * block_rows + rr]
                     : identity<OP>();
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          if (c + i <= c1) v = combine_exact<OP>(v, o[i]);
        }
      }
    }
    y[row0 + rr] = v;
  }
}

// launch geometry of the product kernel, found once per combine and
// block_rows: the dynamic shared memory opt-in and the resident CTAs
template <int OP>
int product_grid(int block_rows, size_t smem, int* grid) {
  static int cached_dev = -1, cached_rows = -1, cached_grid = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (cached_dev != dev || cached_rows != block_rows) {
    cudaError_t err = cudaFuncSetAttribute(
        bbcsr_product<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    int n_sm = 0, per_sm = 0;
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bbcsr_product<OP>, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached_grid = n_sm * per_sm;
    cached_dev = dev;
    cached_rows = block_rows;
  }
  *grid = cached_grid;
  return (int)cudaSuccess;
}

template <int OP>
int product_launch(const int* rows_local, const int* cols_local,
                   const float* vals, const int* tile_cb, const int* tile_rb,
                   const int* list_tile, const int* list_ptr,
                   const int* chunk_first, const int* rb_slot,
                   const int* meta, const float* x, int n_x, float* y,
                   float* scratch, int n_rows, int n_rb, int block_rows,
                   int block_cols, int tile_nnz, int max_chunks,
                   cudaStream_t stream) {
  if (n_rb == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes(block_rows);
  int grid = 0;
  int err = product_grid<OP>(block_rows, smem, &grid);
  if (err != 0) return err;
  grid = max(1, min(grid, (max_chunks + kWarps - 1) / kWarps));
  bbcsr_product<OP><<<grid, kThreads, smem, stream>>>(
      rows_local, cols_local, vals, tile_cb, tile_rb, list_tile, list_ptr,
      chunk_first, rb_slot, meta, x, n_x, y, scratch, n_rows, block_rows,
      block_cols, tile_nnz);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bbcsr_fixup<OP><<<n_rb, kThreads, 0, stream>>>(rb_slot, meta, scratch, y,
                                                 n_rows, block_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the product kernel needs per CTA for this block_rows.
long long bbcsr_smem_bytes(int block_rows) {
  return (long long)smem_bytes(block_rows);
}

// The plan of the live tiles (tile_cnt > 0, and tile_active != 0 unless it
// is null), with shares of ceil(live slots / shares) live slots rounded up
// to 32 and held within [share_min, share_max]: list_tile / list_ptr
// (n_tiles and n_tiles + 1 entries, the first meta[0] and meta[0] + 1
// written), chunk_first (the list entry holding live slot k * share, for
// k < meta[1], then meta[0]), rb_slot (n_rb + 1: live slots before each row
// block, then the total), meta = {n_list, n_chunks, share}; gsum is 2 ints
// of scratch per 2,048 tiles.  Two launches, no host read.
int bbcsr_plan(const int* tile_cnt, const int* tile_active,
               const int* tile_rb, int n_tiles, int n_rb, int shares,
               int share_min, int share_max, int* gsum, int* list_tile,
               int* list_ptr, int* chunk_first, int* rb_slot, int* meta,
               void* stream) {
  if (n_tiles == 0 || shares <= 0 || share_min <= 0 ||
      share_min % 32 != 0 || share_max < share_min) {
    return (int)cudaErrorInvalidValue;
  }
  return plan_launch(tile_cnt, tile_active, tile_rb, n_tiles, n_rb, shares,
                     share_min, share_max, gsum, list_tile, list_ptr,
                     chunk_first, rb_slot, meta, (cudaStream_t)stream);
}

// y = A x over the live tiles of a plan built with no tile_active (B1); x
// holds n_x entries, columns past it read 0.  scratch holds 2 * max_chunks
// * block_rows floats, max_chunks at least the plan's meta[1].  Returns
// cudaGetLastError() after the launches.
int bbcsr_spmv(const int* rows_local, const int* cols_local, const float* vals,
               const int* tile_cb, const int* tile_rb, const int* list_tile,
               const int* list_ptr, const int* chunk_first,
               const int* rb_slot, const int* meta, const float* x, int n_x,
               float* y, float* scratch, int n_rows, int n_rb, int block_rows,
               int block_cols, int tile_nnz, int max_chunks, void* stream) {
  return product_launch<kAdd>(rows_local, cols_local, vals, tile_cb, tile_rb,
                              list_tile, list_ptr, chunk_first, rb_slot, meta,
                              x, n_x, y, scratch, n_rows, n_rb, block_rows,
                              block_cols, tile_nnz, max_chunks,
                              (cudaStream_t)stream);
}

// y = A x (combine 0), or y[r] = min (1) / max (2) of x[c] + val, over the
// real slots of the tiles with tile_active != 0 (B2, B3): builds the plan
// into the work ints (laid out as bbcsr_plan's arguments gsum, list_tile,
// list_ptr, chunk_first, rb_slot, meta), then runs the product.
int bbcsr_spmspv(const int* rows_local, const int* cols_local,
                 const float* vals, const int* tile_cb, const int* tile_cnt,
                 const int* tile_rb, const int* tile_active, const float* x,
                 int n_x, float* y, int* work, float* scratch, int n_rows,
                 int n_tiles, int n_rb, int block_rows, int block_cols,
                 int tile_nnz, int shares, int share_min, int share_max,
                 int max_chunks, int combine, void* stream) {
  if (combine < kAdd || combine > kMax) return (int)cudaErrorInvalidValue;
  const int n_groups = (n_tiles + kPlanTiles - 1) / kPlanTiles;
  int* gsum = work;
  int* list_tile = gsum + 2 * n_groups;
  int* list_ptr = list_tile + n_tiles;
  int* chunk_first = list_ptr + n_tiles + 1;
  int* rb_slot = chunk_first + max_chunks + 1;
  int* meta = rb_slot + n_rb + 1;
  int err = bbcsr_plan(tile_cnt, tile_active, tile_rb, n_tiles, n_rb, shares,
                       share_min, share_max, gsum, list_tile, list_ptr,
                       chunk_first, rb_slot, meta, stream);
  if (err != 0) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (combine == kAdd) {
    return product_launch<kAdd>(rows_local, cols_local, vals, tile_cb,
                                tile_rb, list_tile, list_ptr, chunk_first,
                                rb_slot, meta, x, n_x, y, scratch, n_rows,
                                n_rb, block_rows, block_cols, tile_nnz,
                                max_chunks, s);
  }
  if (combine == kMin) {
    return product_launch<kMin>(rows_local, cols_local, vals, tile_cb,
                                tile_rb, list_tile, list_ptr, chunk_first,
                                rb_slot, meta, x, n_x, y, scratch, n_rows,
                                n_rb, block_rows, block_cols, tile_nnz,
                                max_chunks, s);
  }
  return product_launch<kMax>(rows_local, cols_local, vals, tile_cb, tile_rb,
                              list_tile, list_ptr, chunk_first, rb_slot, meta,
                              x, n_x, y, scratch, n_rows, n_rb, block_rows,
                              block_cols, tile_nnz, max_chunks, s);
}

}  // extern "C"
