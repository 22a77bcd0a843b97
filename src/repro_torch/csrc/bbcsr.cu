// BBCSR SpMV / SpMSpV for Hopper (sm_90a), one source templated on the
// destination combine.  Built by repro_torch/kernels/_build.py with nvcc into
// a shared library with a plain C interface; bound with ctypes in
// repro_torch/kernels/spmv_dma.py.
//
// Replaces the three Pallas bodies of repro/kernels/spmv_dma.py:
//   bbcsr_spmv           <- spmv_bbcsr_kernel_call (_kernel, _tile_yblk)
//   bbcsr_spmspv_add     <- spmspv_bbcsr_kernel_call, combine='add'
//                           (_spmspv_kernel)
//   bbcsr_spmspv_select  <- spmspv_bbcsr_kernel_call, combine='min'|'max'
//                           (_spmspv_select_kernel, _tile_yblk_select)
//
// What bounds it on this card: bytes.  Each real slot costs 12 B of tile data
// (rows_local, cols_local, vals) plus one 4 B gather of x, against one add or
// min per slot, far below the card's ~20 operations per byte.  The padded
// tile array is mostly padding on skewed graphs (56 slots per real nonzero at
// RMAT-20 on the default 256/512/512 geometry), so the design reads only the
// first tile_cnt[t] slots of each tile, which is exact for 'add' too because
// padding is always a tile's tail and padding vals are 0.  Inactive tiles
// (SpMSpV) are skipped without touching their slots, which keeps the TPU
// kernel's contract of no work for inactive tiles (its x-block DMA schedule,
// collapse_inactive_blocks, has no counterpart here).
//
// Design: one CTA per row block.  The block's block_rows outputs live in
// shared memory, initialised to the combine identity, so a row block whose
// tiles are all inactive (or all padding) comes out as the identity.  Each
// warp takes every nwarps-th tile of the row block's range
// rb_ptr[b]..rb_ptr[b+1] and reads the tile's real slots 128 at a time.  A
// tile's slots are sorted by row, so a segmented warp scan combines each
// row's run of slots and one lane per run updates shared memory with an
// atomic: a hub row's 32 slots cost one atomic, not 32.  min/max map floats
// to unsigned keys whose order is the float order, so atomicMin/atomicMax
// give exact, order-independent results.  'add' uses shared-memory float
// atomicAdd: the order of the sum varies from run to run, so the 'add'
// result is not bit-reproducible (it is within f32 rounding of the plain
// version).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Combine { kAdd = 0, kMin = 1, kMax = 2 };

__device__ __forceinline__ unsigned int float_key(float f) {
  unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  return OP == kAdd ? a + b : (OP == kMin ? fminf(a, b) : fmaxf(a, b));
}

// 1024 threads: the heaviest row blocks (the in-edges of RMAT's hubs) are
// each walked by one CTA, whose time bounds the launch, so that CTA gets as
// many warps as a block can hold; kUnroll chunks per step keep several
// loads in flight per lane.
constexpr int kThreads = 1024;
constexpr int kUnroll = 4;

template <int OP>
__global__ void __launch_bounds__(kThreads)
    bbcsr_kernel(const int* __restrict__ rows_local,
                 const int* __restrict__ cols_local,
                 const float* __restrict__ vals,
                 const int* __restrict__ tile_cb,
                 const int* __restrict__ tile_cnt,
                 const int* __restrict__ tile_active,
                 const int* __restrict__ rb_ptr, const float* __restrict__ x,
                 float* __restrict__ y, int n_rows, int block_rows,
                 int block_cols, int tile_nnz) {
  extern __shared__ unsigned int sy[];
  const int b = blockIdx.x;
  const unsigned int ident =
      OP == kAdd ? __float_as_uint(0.0f)
                 : float_key(OP == kMin ? __int_as_float(0x7f800000)
                                        : __int_as_float(0xff800000));
  for (int r = threadIdx.x; r < block_rows; r += blockDim.x) sy[r] = ident;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const float fident = OP == kAdd ? 0.0f
                       : (OP == kMin ? __int_as_float(0x7f800000)
                                     : __int_as_float(0xff800000));
  const int t_end = rb_ptr[b + 1];
  for (int t = rb_ptr[b] + (threadIdx.x >> 5); t < t_end; t += nwarps) {
    if (tile_active != nullptr && tile_active[t] == 0) continue;
    const int cnt = tile_cnt[t];
    const float* xb = x + (int64_t)tile_cb[t] * block_cols;
    const int64_t base = (int64_t)t * tile_nnz;
    // kUnroll chunks of 32 consecutive slots per step, their loads issued
    // together; cnt is the same for the whole warp, so every lane takes
    // part in the shuffles
    for (int s0 = 0; s0 < cnt; s0 += 32 * kUnroll) {
      int r[kUnroll];
      float c[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + 32 * u + lane;
        r[u] = -1;
        c[u] = fident;
        if (s < cnt) {
          r[u] = rows_local[base + s];
          const float xv = __ldg(xb + cols_local[base + s]);
          const float v = vals[base + s];
          c[u] = OP == kAdd ? v * xv : xv + v;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // slots are sorted by row within a tile, so equal rows sit in
        // adjacent lanes: a segmented inclusive scan leaves each row's
        // partial in the last lane of its run, and only that lane updates
        // shared memory (padding lanes carry row -1 and write nothing)
        for (int d = 1; d < 32; d <<= 1) {
          const float oc = __shfl_up_sync(0xffffffffu, c[u], d);
          const int orow = __shfl_up_sync(0xffffffffu, r[u], d);
          if (lane >= d && orow == r[u]) c[u] = combine<OP>(c[u], oc);
        }
        const int next = __shfl_down_sync(0xffffffffu, r[u], 1);
        if (r[u] >= 0 && (lane == 31 || next != r[u])) {
          if (OP == kAdd) {
            atomicAdd(reinterpret_cast<float*>(sy) + r[u], c[u]);
          } else if (OP == kMin) {
            atomicMin(sy + r[u], float_key(c[u]));
          } else {
            atomicMax(sy + r[u], float_key(c[u]));
          }
        }
      }
    }
  }
  __syncthreads();

  const int64_t row0 = (int64_t)b * block_rows;
  for (int r = threadIdx.x; r < block_rows; r += blockDim.x) {
    if (row0 + r < n_rows) {
      y[row0 + r] = OP == kAdd ? __uint_as_float(sy[r]) : key_float(sy[r]);
    }
  }
}

template <int OP>
int launch(const int* rows_local, const int* cols_local, const float* vals,
           const int* tile_cb, const int* tile_cnt, const int* tile_active,
           const int* rb_ptr, const float* x, float* y, int n_rows,
           int n_row_blocks, int block_rows, int block_cols, int tile_nnz,
           void* stream) {
  if (n_row_blocks == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(unsigned int) * (size_t)block_rows;
  bbcsr_kernel<OP><<<n_row_blocks, kThreads, smem, (cudaStream_t)stream>>>(
      rows_local, cols_local, vals, tile_cb, tile_cnt, tile_active, rb_ptr, x,
      y, n_rows, block_rows, block_cols, tile_nnz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y = A x over every tile (B1).  Returns cudaGetLastError() after launch.
int bbcsr_spmv(const int* rows_local, const int* cols_local, const float* vals,
               const int* tile_cb, const int* tile_cnt, const int* rb_ptr,
               const float* x, float* y, int n_rows, int n_row_blocks,
               int block_rows, int block_cols, int tile_nnz, void* stream) {
  return launch<kAdd>(rows_local, cols_local, vals, tile_cb, tile_cnt, nullptr,
                      rb_ptr, x, y, n_rows, n_row_blocks, block_rows,
                      block_cols, tile_nnz, stream);
}

// y = A x over the tiles with tile_active != 0 (B2).
int bbcsr_spmspv_add(const int* rows_local, const int* cols_local,
                     const float* vals, const int* tile_cb,
                     const int* tile_cnt, const int* tile_active,
                     const int* rb_ptr, const float* x, float* y, int n_rows,
                     int n_row_blocks, int block_rows, int block_cols,
                     int tile_nnz, void* stream) {
  return launch<kAdd>(rows_local, cols_local, vals, tile_cb, tile_cnt,
                      tile_active, rb_ptr, x, y, n_rows, n_row_blocks,
                      block_rows, block_cols, tile_nnz, stream);
}

// y[r] = min (combine 1) or max (combine 2) of x[c] + val over the real slots
// of the active tiles (B3).
int bbcsr_spmspv_select(const int* rows_local, const int* cols_local,
                        const float* vals, const int* tile_cb,
                        const int* tile_cnt, const int* tile_active,
                        const int* rb_ptr, const float* x, float* y,
                        int n_rows, int n_row_blocks, int block_rows,
                        int block_cols, int tile_nnz, int combine,
                        void* stream) {
  if (combine == kMin) {
    return launch<kMin>(rows_local, cols_local, vals, tile_cb, tile_cnt,
                        tile_active, rb_ptr, x, y, n_rows, n_row_blocks,
                        block_rows, block_cols, tile_nnz, stream);
  }
  if (combine == kMax) {
    return launch<kMax>(rows_local, cols_local, vals, tile_cb, tile_cnt,
                        tile_active, rb_ptr, x, y, n_rows, n_row_blocks,
                        block_rows, block_cols, tile_nnz, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
