// Flash attention forward for Hopper (sm_90a): online-softmax attention with
// GQA, a causal mask that puts the queries at the last Sq of the Skv
// positions, and an optional sliding window.  Built by
// repro_torch/kernels/_build.py with nvcc into a shared library with a plain
// C interface; bound with ctypes in repro_torch/kernels/flash_attention.py,
// whose docstring gives the rule that picks a kernel for a call.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_kernel_call
// (body _kernel).  The TPU kernel runs one (batch, query head, q block) per
// grid row and walks every key block in order, masking what the causal or
// window band hides; (m, l, acc) live in VMEM scratch across the key steps.
// Here every kernel keeps (m, l, acc) in registers, scales the logits by
// scale * log2(e) and exponentiates with exp2, skips the key blocks wholly
// outside the band of its rows (the TPU kernel computes and masks them; the
// result is the same) and masks the others element by element, so ragged Sq
// and Skv need no divisibility.  A row that sees no key outputs 0 (the
// wrapper refuses such inputs, on which the TPU kernel and its oracle
// disagree).
//
// flash_wgmma (bf16, D = 128, Sq of a tile or more: prefill and window,
// bound by the tensor cores).  One CTA per (batch, query head, tile of 128
// query positions); the g query heads of one kv head are next to each other
// in launch order, so their k / v blocks come from L2, and under a causal
// mask the query tiles launch heaviest first, so the last wave is short.  A
// producer warp loads q once and k / v blocks of 128 keys into a
// three-stage ring with TMA, over 3-D tensor maps (D, S, batch * head) so
// that a box never crosses into the next head and rows past S arrive as
// zeros; each stage has full and empty mbarriers.  Two consumer warpgroups
// own 64 query rows each: S = Q K^T by wgmma m64n128k16 from shared memory
// (both K-major), the softmax in registers, then O += P V with P rounded to
// bf16 in registers (the accumulator layout of S is the A-fragment layout of
// the register form) and V read MN-major through the transpose bit, so v
// needs no transposed copy.  A warpgroup issues P V of one block together
// with Q K^T of the next, and the two warpgroups take turns at that through
// a pair of named barriers, so one's softmax runs while the other's
// products keep the tensor cores busy.  The 128-byte swizzle caps a box row
// at 64 bf16, so each tile arrives as two halves of D: the K-major
// descriptors step 32 bytes per k16 slice inside a half and move to the
// other half for the upper 64 dims; the MN-major one steps 16 keys (2 KB)
// per slice and finds the other half of D one leading-byte offset away.
// setmaxnreg gives the producer warpgroup 24 registers a thread and the
// consumers 240.
//
// flash_mma (the other bf16 calls: decode, where Sq * g is a few rows) and
// flash_simt (f32): one CTA serves one (batch, kv head) and a tile of
// block_q rows of the folded (query position, group head) space: row r is
// query position r / g of query head kv_head * g + r % g.  The g query heads
// that share a kv head are in one CTA, so each k/v tile is read from device
// memory once per group, not g times: decode is bound by the bytes of k and
// v.  Where the (batch, kv head, row tile) CTAs are too few to fill the card
// (batch-1 decode), the wrapper cuts each CTA's key blocks into `splits`
// contiguous pieces served by CTAs of their own; a piece writes its (m, l,
// acc) in f32 to scratch, and flash_combine merges the pieces of a row in
// split order, so a result has the same bits from run to run.
//   flash_mma: both products on the tensor cores with mma.sync m16n8k16
// (bf16 in, f32 accumulate); each warp owns 16 rows; k and v tiles of
// block_k keys go to shared memory with cp.async, two stages deep, keys
// past Skv zero-filled; q's fragments stay in registers, k's and v's come by
// ldmatrix (v transposed), and shared rows are padded by 16 bytes, so the
// eight rows one ldmatrix reads fall in distinct banks.  The probabilities are rounded to bf16 for the second
// product, as the flash attention papers do.
//   flash_simt: plain f32 FMA, never TF32 (wgmma on f32 would be TF32), so
// f32 results stay within the reference's 2e-4: lane n scores keys n and
// n + 32 against the warp's 16 query rows, which sit in shared memory, and
// owns output columns n, n + 32, ... for the second product.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxThreads = 256;   // folded kernels, block_q = 128: 8 warps

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part_acc;     // splits > 1: (B, Hkv, rows, splits, D) f32 pieces
  float* part_ml;      // splits > 1: (B, Hkv, rows, splits, 2): m, l
  int Hq, Hkv, Sq, Skv, g;
  int rows;            // Sq * g, the folded rows of one (batch, kv head)
  int block_q;         // rows per CTA, 16 per warp
  int splits;          // key pieces per row tile (1: write o directly)
  int causal, window;  // window 0: none
  float scale_log2;    // softmax scale * log2(e)
};

__device__ __forceinline__ bool visible(int pos, int key, int skv, int causal,
                                        int window) {
  return key >= 0 && key < skv && (!causal || key <= pos) &&
         (window <= 0 || key > pos - window);
}

__device__ __forceinline__ bool visible(const Params& p, int pos, int key) {
  return visible(pos, key, p.Skv, p.causal, p.window);
}

// The key blocks [*kb0, *kb1) that any row of the CTA whose folded rows
// start at r0 can see (key_blocks in kernels/flash_attention.py).
__device__ __forceinline__ void key_blocks(const Params& p, int r0, int bk,
                                           int* kb0, int* kb1) {
  const int off = p.Skv - p.Sq;
  const int r_last = min(r0 + p.block_q, p.rows) - 1;
  const int p_lo = r0 / p.g + off;
  const int p_hi = r_last / p.g + off;
  const int hi = p.causal ? min(p.Skv, p_hi + 1) : p.Skv;
  const int lo = p.window > 0 ? max(0, p_lo - p.window + 1) : 0;
  *kb0 = lo / bk;
  *kb1 = hi > lo ? (hi + bk - 1) / bk : *kb0;
}

// Piece `split` of those blocks: p.splits contiguous pieces of balanced
// length (split_range in kernels/flash_attention.py).
__device__ __forceinline__ void split_blocks(const Params& p, int split,
                                             int* kb0, int* kb1) {
  const int a = *kb0, n = *kb1 - *kb0;
  *kb0 = a + (int)((int64_t)n * split / p.splits);
  *kb1 = a + (int)((int64_t)n * (split + 1) / p.splits);
}

// element offset of folded row r of (b, kv head) in q / o
__device__ __forceinline__ int64_t row_offset(const Params& p, int b, int kvh,
                                              int r, int D) {
  const int i = r / p.g, j = r % p.g;
  return (((int64_t)b * p.Hq + (int64_t)kvh * p.g + j) * p.Sq + i) * D;
}

// index of the piece (b, kv head, folded row r, split) in the scratch
__device__ __forceinline__ int64_t piece(const Params& p, int b, int kvh,
                                         int r, int split) {
  return (((int64_t)b * p.Hkv + kvh) * p.rows + r) * p.splits + split;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  // src-size 0 zero-fills the 16 bytes (keys past Skv)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// -- bf16, folded rows: mma.sync ----------------------------------------------

// kSplit: p.splits > 1, pieces to scratch; else the normalised rows to o
template <int D, int BK, bool kSplit>
__global__ void __launch_bounds__(kMaxThreads)
    flash_mma(const Params p) {
  constexpr int kStride = D + 8;            // bf16 per shared row (+16 B)
  constexpr int kTile = BK * kStride;       // bf16 per k or v tile
  constexpr int kChunks = D / 8;            // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][tile]
  __nv_bfloat16* sV = sK + 2 * kTile;                           // [2][tile]

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int split = kSplit ? blockIdx.x % p.splits : 0;
  const int r0 = (kSplit ? blockIdx.x / p.splits : blockIdx.x) * p.block_q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr0 = r0 + warp * 16;
  const bool active = wr0 < p.rows;
  const int off = p.Skv - p.Sq;
  const int ra = wr0 + (lane >> 2), rb = ra + 8;   // this lane's two rows
  const bool va = ra < p.rows, vb = rb < p.rows;
  const int pa = va ? ra / p.g + off : 0, pb = vb ? rb / p.g + off : 0;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* kbase = static_cast<const __nv_bfloat16*>(p.k) +
                               ((int64_t)b * p.Hkv + kvh) * p.Skv * D;
  const __nv_bfloat16* vbase = static_cast<const __nv_bfloat16*>(p.v) +
                               ((int64_t)b * p.Hkv + kvh) * p.Skv * D;

  // q fragments (A operand, 16 rows x D) for the warp's rows
  uint32_t qa[D / 16][4];
  {
    const int c = 2 * (lane & 3);
    const __nv_bfloat16* qra = va ? q + row_offset(p, b, kvh, ra, D) : q;
    const __nv_bfloat16* qrb = vb ? q + row_offset(p, b, kvh, rb, D) : q;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int d0 = ks * 16 + c;
      qa[ks][0] = va ? *reinterpret_cast<const uint32_t*>(qra + d0) : 0u;
      qa[ks][1] = vb ? *reinterpret_cast<const uint32_t*>(qrb + d0) : 0u;
      qa[ks][2] = va ? *reinterpret_cast<const uint32_t*>(qra + d0 + 8) : 0u;
      qa[ks][3] = vb ? *reinterpret_cast<const uint32_t*>(qrb + d0 + 8) : 0u;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.0f, l_b = 0.0f;

  int kb0, kb1;
  key_blocks(p, r0, BK, &kb0, &kb1);
  if (kSplit) split_blocks(p, split, &kb0, &kb1);

  auto load_tile = [&](int kb, int stage) {
    __nv_bfloat16* dk = sK + stage * kTile;
    __nv_bfloat16* dv = sV + stage * kTile;
    for (int c = threadIdx.x; c < BK * kChunks; c += blockDim.x) {
      const int row = c / kChunks, ch = c % kChunks;
      const int key = kb * BK + row;
      const bool ok = key < p.Skv;
      const int64_t src = (int64_t)(ok ? key : 0) * D + ch * 8;
      cp_async16(dk + row * kStride + ch * 8, kbase + src, ok);
      cp_async16(dv + row * kStride + ch * 8, vbase + src, ok);
    }
    cp_async_commit();
  };

  if (kb0 < kb1) load_tile(kb0, 0);
  for (int kb = kb0, it = 0; kb < kb1; ++kb, ++it) {
    // the next tile's load goes out before this one is waited for, so two
    // tiles are in flight while a warp waits
    const int stage = it & 1;
    if (kb + 1 < kb1) {
      load_tile(kb + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      const __nv_bfloat16* tk = sK + stage * kTile;
      const __nv_bfloat16* tv = sV + stage * kTile;
      // S = Q K^T: BK / 8 n-tiles of 16 x 8
      float s[BK / 8][4];
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.0f;
      const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
        for (int n2 = 0; n2 < BK / 16; ++n2) {
          // matrices: (keys +0, dims +0), (keys +0, dims +8),
          //           (keys +8, dims +0), (keys +8, dims +8)
          uint32_t bk[4];
          ldmatrix_x4(bk, tk + (n2 * 16 + (mi >> 1) * 8 + mr) * kStride +
                              ks * 16 + (mi & 1) * 8);
          mma_bf16(s[2 * n2], qa[ks], bk[0], bk[1]);
          mma_bf16(s[2 * n2 + 1], qa[ks], bk[2], bk[3]);
        }
      }
      // scale, mask, row max
      float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb * BK + nt * 8 + 2 * (lane & 3) + (e & 1);
          const bool top = e < 2;
          const bool ok = top ? (va && visible(p, pa, key))
                              : (vb && visible(p, pb, key));
          const float x = ok ? s[nt][e] * p.scale_log2 : -CUDART_INF_F;
          s[nt][e] = x;
          if (top) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      // a row that has seen no key yet keeps m = -inf: subtract 0 instead
      const float mu_a = mn_a == -CUDART_INF_F ? 0.0f : mn_a;
      const float mu_b = mn_b == -CUDART_INF_F ? 0.0f : mn_b;
      const float al_a = exp2f(m_a - mu_a), al_b = exp2f(m_b - mu_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        s[nt][0] = exp2f(s[nt][0] - mu_a);
        s[nt][1] = exp2f(s[nt][1] - mu_a);
        s[nt][2] = exp2f(s[nt][2] - mu_b);
        s[nt][3] = exp2f(s[nt][3] - mu_b);
        sum_a += s[nt][0] + s[nt][1];
        sum_b += s[nt][2] + s[nt][3];
      }
      // l stays a per-lane partial (its quad is summed at the end): the
      // rescale alpha is the same across the quad
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        acc[dn][0] *= al_a;
        acc[dn][1] *= al_a;
        acc[dn][2] *= al_b;
        acc[dn][3] *= al_b;
      }
      // O += P V: the S accumulators of two n-tiles form one A fragment
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa4[4];
        pa4[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa4[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa4[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa4[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int d2 = 0; d2 < D / 16; ++d2) {
          // matrices: (keys +0, dims +0), (keys +8, dims +0),
          //           (keys +0, dims +8), (keys +8, dims +8), transposed
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, tv + (kk * 16 + (mi & 1) * 8 + mr) * kStride +
                                    d2 * 16 + (mi >> 1) * 8);
          mma_bf16(acc[2 * d2], pa4, bv[0], bv[1]);
          mma_bf16(acc[2 * d2 + 1], pa4, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
  }
  const int c = 2 * (lane & 3);
  if (kSplit) {
    // the piece, unnormalised: (m, l) from the quad's first lane
    if (va) {
      const int64_t i = piece(p, b, kvh, ra, split);
      float* dst = p.part_acc + i * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<float2*>(dst + dn * 8 + c) =
            make_float2(acc[dn][0], acc[dn][1]);
      if (c == 0)
        *reinterpret_cast<float2*>(p.part_ml + 2 * i) = make_float2(m_a, l_a);
    }
    if (vb) {
      const int64_t i = piece(p, b, kvh, rb, split);
      float* dst = p.part_acc + i * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<float2*>(dst + dn * 8 + c) =
            make_float2(acc[dn][2], acc[dn][3]);
      if (c == 0)
        *reinterpret_cast<float2*>(p.part_ml + 2 * i) = make_float2(m_b, l_b);
    }
    return;
  }
  const float inv_a = l_a > 0.0f ? 1.0f / l_a : 0.0f;
  const float inv_b = l_b > 0.0f ? 1.0f / l_b : 0.0f;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);
  if (va) {
    __nv_bfloat16* orow = o + row_offset(p, b, kvh, ra, D);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8 + c) =
          __floats2bfloat162_rn(acc[dn][0] * inv_a, acc[dn][1] * inv_a);
  }
  if (vb) {
    __nv_bfloat16* orow = o + row_offset(p, b, kvh, rb, D);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8 + c) =
          __floats2bfloat162_rn(acc[dn][2] * inv_b, acc[dn][3] * inv_b);
  }
}

// -- f32: plain FMA -----------------------------------------------------------

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, int BK>
__global__ void __launch_bounds__(kMaxThreads)
    flash_simt(const Params p) {
  constexpr int kKeys = BK / 32;          // keys per lane
  constexpr int kDims = (D + 31) / 32;    // output columns per lane
  constexpr int kKStride = D + 1;         // keys on distinct banks
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  float* sK = reinterpret_cast<float*>(smem);       // [BK][D + 1]
  float* sV = sK + BK * kKStride;                   // [BK][D]
  float* sQ = sV + BK * D;                          // [warps][16][D]
  float* sP = sQ + warps * 16 * D;                  // [warps][16][BK]

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int split = blockIdx.x % p.splits;
  const int r0 = (blockIdx.x / p.splits) * p.block_q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr0 = r0 + warp * 16;
  const bool active = wr0 < p.rows;
  const int off = p.Skv - p.Sq;
  const float* q = static_cast<const float*>(p.q);
  const float* kbase =
      static_cast<const float*>(p.k) + ((int64_t)b * p.Hkv + kvh) * p.Skv * D;
  const float* vbase =
      static_cast<const float*>(p.v) + ((int64_t)b * p.Hkv + kvh) * p.Skv * D;
  float* wq = sQ + warp * 16 * D;
  float* wp = sP + warp * 16 * BK;

  int pos[16];   // query position of each row (negative where Sq > Skv)
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = wr0 + r;
    pos[r] = row < p.rows ? row / p.g + off : 0;
    for (int d = lane; d < D; d += 32)
      wq[r * D + d] =
          row < p.rows ? q[row_offset(p, b, kvh, row, D) + d] : 0.0f;
  }
  __syncwarp();

  float acc[16][kDims], m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.0f;
#pragma unroll
    for (int v = 0; v < kDims; ++v) acc[r][v] = 0.0f;
  }

  int kb0, kb1;
  key_blocks(p, r0, BK, &kb0, &kb1);
  split_blocks(p, split, &kb0, &kb1);
  for (int kb = kb0; kb < kb1; ++kb) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK * D; i += blockDim.x) {
      const int row = i / D, col = i % D;
      const int key = kb * BK + row;
      const bool ok = key < p.Skv;
      sK[row * kKStride + col] = ok ? kbase[(int64_t)key * D + col] : 0.0f;
      sV[row * D + col] = ok ? vbase[(int64_t)key * D + col] : 0.0f;
    }
    __syncthreads();
    if (!active) continue;

    float s[16][kKeys];
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int u = 0; u < kKeys; ++u) s[r][u] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float kd[kKeys];
#pragma unroll
      for (int u = 0; u < kKeys; ++u) kd[u] = sK[(lane + 32 * u) * kKStride + d];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float qd = wq[r * D + d];
#pragma unroll
        for (int u = 0; u < kKeys; ++u) s[r][u] = fmaf(qd, kd[u], s[r][u]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const int key = kb * BK + lane + 32 * u;
        s[r][u] = (wr0 + r < p.rows && visible(p, pos[r], key))
                      ? s[r][u] * p.scale_log2 : -CUDART_INF_F;
        mx = fmaxf(mx, s[r][u]);
      }
      const float mn = fmaxf(m[r], warp_max(mx));
      const float mu = mn == -CUDART_INF_F ? 0.0f : mn;
      const float alpha = exp2f(m[r] - mu);
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const float e = exp2f(s[r][u] - mu);
        sum += e;
        wp[r * BK + lane + 32 * u] = e;
      }
      l[r] = l[r] * alpha + warp_sum(sum);
      m[r] = mn;
#pragma unroll
      for (int v = 0; v < kDims; ++v) acc[r][v] *= alpha;
    }
    __syncwarp();
    for (int n = 0; n < BK; ++n) {
      float vd[kDims];
#pragma unroll
      for (int v = 0; v < kDims; ++v) {
        const int d = lane + 32 * v;
        vd[v] = d < D ? sV[n * D + d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float pr = wp[r * BK + n];
#pragma unroll
        for (int v = 0; v < kDims; ++v) acc[r][v] = fmaf(pr, vd[v], acc[r][v]);
      }
    }
    __syncwarp();
  }

  if (!active) return;
  float* o = static_cast<float*>(p.o);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = wr0 + r;
    if (row >= p.rows) break;
    float* dst;
    float inv = 1.0f;
    if (p.splits > 1) {   // the piece, unnormalised
      const int64_t i = piece(p, b, kvh, row, split);
      dst = p.part_acc + i * D;
      if (lane == 0)
        *reinterpret_cast<float2*>(p.part_ml + 2 * i) = make_float2(m[r], l[r]);
    } else {
      dst = o + row_offset(p, b, kvh, row, D);
      inv = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
    }
#pragma unroll
    for (int v = 0; v < kDims; ++v) {
      const int d = lane + 32 * v;
      if (d < D) dst[d] = acc[r][v] * inv;
    }
  }
}

// -- the pieces of a split row, merged in split order ---------------------------

__device__ __forceinline__ void store_out(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// One warp per folded row of every (batch, kv head): rescales each piece by
// exp2(m_s - max m) and sums the pieces in split order.
template <int D, typename T>
__global__ void __launch_bounds__(kMaxThreads)
    flash_combine(const Params p, int n_rows) {
  constexpr int kDims = (D + 31) / 32;
  const int row = blockIdx.x * (kMaxThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int r = row % p.rows, bk = row / p.rows;
  const int kvh = bk % p.Hkv, b = bk / p.Hkv;
  const float* ml = p.part_ml + (int64_t)row * p.splits * 2;
  const float* acc = p.part_acc + (int64_t)row * p.splits * D;
  float mx = -CUDART_INF_F;
  for (int s = 0; s < p.splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  const float mu = mx == -CUDART_INF_F ? 0.0f : mx;
  float l = 0.0f, out[kDims];
#pragma unroll
  for (int v = 0; v < kDims; ++v) out[v] = 0.0f;
  for (int s = 0; s < p.splits; ++s) {
    const float w = exp2f(ml[2 * s] - mu);   // 0 for an empty piece
    l += w * ml[2 * s + 1];
#pragma unroll
    for (int v = 0; v < kDims; ++v) {
      const int d = lane + 32 * v;
      if (d < D) out[v] += w * acc[(int64_t)s * D + d];
    }
  }
  const float inv = l > 0.0f ? 1.0f / l : 0.0f;
  T* o = static_cast<T*>(p.o) + row_offset(p, b, kvh, r, D);
#pragma unroll
  for (int v = 0; v < kDims; ++v) {
    const int d = lane + 32 * v;
    if (d < D) store_out(o + d, out[v] * inv);
  }
}

// -- bf16, D = 128, one query head per CTA: TMA + wgmma -------------------------

constexpr int kWgRows = 128;                  // query positions per CTA
constexpr int kWgKeys = 128;                  // keys per block
constexpr int kWgD = 128;                     // head dim
constexpr int kWgStages = 3;                  // k / v ring depth
constexpr int kWgThreads = 384;               // producer + 2 consumer WGs
constexpr int kHalf = kWgRows * 64;           // bf16 in half a tile (64 dims)
constexpr uint32_t kHalfBytes = kHalf * 2;    // 16 KB: 128 rows of 128 B

struct WgParams {
  void* o;
  int B, Hq, Hkv, Sq, Skv, g;
  int n_tiles;          // query tiles of 128 positions
  int causal, window;   // window 0: none
  float scale_log2;
};

// Each half tile is 128 rows of 128 bytes in the 128-byte swizzle, which
// repeats every 1,024 bytes: every half starts on a 1,024-byte boundary.
struct WgSmem {
  __nv_bfloat16 q[2][kHalf];
  __nv_bfloat16 k[kWgStages][2][kHalf];
  __nv_bfloat16 v[kWgStages][2][kHalf];
  uint64_t full_q, full_k[kWgStages], full_v[kWgStages], empty[kWgStages];
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-D tensor map to shared memory, completion to `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of an operand in shared memory, 128-byte swizzle; byte
// offsets: lbo between the 64-element column blocks of an MN-major operand
// (unused K-major), sbo between groups of 8 rows
__device__ __forceinline__ uint64_t smem_desc(const void* ptr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(ptr) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products that own them
__device__ __forceinline__ void fence_regs(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// named barriers 1 and 2 over the two consumer warpgroups (0 is
// __syncthreads)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (the m64n128 f32 accumulator fragment) = A * B (+ d when accumulate),
// A and B from shared memory through their descriptors, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A * B, A (this warpgroup's 64 x 16 bf16) from registers in the
// mma.sync A-fragment layout, B from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const WgParams p) {
  extern __shared__ unsigned char smem_raw[];
  WgSmem& sm = *reinterpret_cast<WgSmem*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  // the g heads of one kv head are adjacent; causal: last query tile first
  const int BH = p.B * p.Hq;
  const int rank = blockIdx.x / BH, bh = blockIdx.x - rank * BH;
  const int tile = p.causal ? p.n_tiles - 1 - rank : rank;
  const int b = bh / p.Hq, h = bh - b * p.Hq;
  const int kv_row = b * p.Hkv + h / p.g;   // (batch, kv head) in k / v
  const int s0 = tile * kWgRows, off = p.Skv - p.Sq;
  const int p_lo = s0 + off, p_hi = min(s0 + kWgRows, p.Sq) - 1 + off;
  const int hi = p.causal ? min(p.Skv, p_hi + 1) : p.Skv;
  const int lo = p.window > 0 ? max(0, p_lo - p.window + 1) : 0;
  const int kb0 = lo / kWgKeys;
  const int nblk = hi > lo ? (hi + kWgKeys - 1) / kWgKeys - kb0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.full_q, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&sm.full_k[s], 1);
      mbar_init(&sm.full_v[s], 1);
      mbar_init(&sm.empty[s], kWgThreads - 128);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.full_q, 2 * kHalfBytes);
      tma_load(sm.q[0], &tm_q, 0, s0, bh, &sm.full_q);
      tma_load(sm.q[1], &tm_q, 64, s0, bh, &sm.full_q);
      for (int i = 0; i < nblk; ++i) {
        const int st = i % kWgStages;
        // a fresh barrier counts as having completed the phase before its
        // first, so the first pass through the ring does not wait
        mbar_wait(&sm.empty[st], ((i / kWgStages) & 1) ^ 1);
        const int key0 = (kb0 + i) * kWgKeys;
        mbar_expect_tx(&sm.full_k[st], 2 * kHalfBytes);
        tma_load(sm.k[st][0], &tm_k, 0, key0, kv_row, &sm.full_k[st]);
        tma_load(sm.k[st][1], &tm_k, 64, key0, kv_row, &sm.full_k[st]);
        mbar_expect_tx(&sm.full_v[st], 2 * kHalfBytes);
        tma_load(sm.v[st][0], &tm_v, 0, key0, kv_row, &sm.full_v[st]);
        tma_load(sm.v[st][1], &tm_v, 64, key0, kv_row, &sm.full_v[st]);
      }
    }
    return;
  }

  // consumer warpgroup wg owns query rows s0 + 64 wg ... s0 + 64 wg + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int ra = s0 + wg * 64 + warp * 16 + (lane >> 2), rb = ra + 8;
  const int pa = ra + off, pb = rb + off;          // their positions
  const int wg_lo = s0 + wg * 64 + off, wg_hi = wg_lo + 63;
  const uint32_t q_off = wg * 64 * 128;            // bytes into a q half

  float o[64], s[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) o[j] = s[j] = 0.0f;
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.0f, l_b = 0.0f;
  uint32_t pf[kWgKeys / 16][4];   // P of the previous block, bf16 A slices

  mbar_wait(&sm.full_q, 0);
  // The two warpgroups take turns on the tensor cores (named barriers 1
  // and 2): one issues its products while the other runs its softmax.
  if (wg == 1) named_arrive(1);                    // warpgroup 0 goes first
  for (int i = 0; i <= nblk; ++i) {
    // pass i: O += P V of block i - 1 (i > 0) and S = Q K^T of block i
    // (i < nblk), issued together in this warpgroup's turn
    const int st = i % kWgStages, pst = (i + kWgStages - 1) % kWgStages;
    if (i < nblk) mbar_wait(&sm.full_k[st], (i / kWgStages) & 1);
    if (i > 0) mbar_wait(&sm.full_v[pst], ((i - 1) / kWgStages) & 1);
    named_sync(1 + wg);
    fence_regs(o);
    fence_regs(s);
    wgmma_fence();
    if (i > 0) {
      // k16 slice kk of V is keys 16 kk.., 2 KB into the low half of D; the
      // high half of D is 16 KB (one half tile) further
#pragma unroll
      for (int kk = 0; kk < kWgKeys / 16; ++kk) {
        const unsigned char* vs =
            reinterpret_cast<const unsigned char*>(sm.v[pst][0]) + kk * 2048;
        wgmma_rs(o, pf[kk], smem_desc(vs, kHalfBytes, 1024));
      }
    }
    if (i < nblk) {
      // k16 slice kk of Q and K is bytes 32 (kk % 4) of half kk / 4
#pragma unroll
      for (int kk = 0; kk < kWgD / 16; ++kk) {
        const unsigned char* qs =
            reinterpret_cast<const unsigned char*>(sm.q[kk >> 2]) + q_off +
            (kk & 3) * 32;
        const unsigned char* ks =
            reinterpret_cast<const unsigned char*>(sm.k[st][kk >> 2]) +
            (kk & 3) * 32;
        wgmma_ss(s, smem_desc(qs, 16, 1024), smem_desc(ks, 16, 1024),
                 kk > 0);
      }
    }
    wgmma_commit();
    named_arrive(2 - wg);                          // the other one's turn
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(s);
    if (i > 0) mbar_arrive(&sm.empty[pst]);        // block i - 1 is done
    if (i == nblk) break;

    // softmax of block i.  Accumulator element j: row ra (j & 2 == 0) or
    // rb, key key0 + 8 (j / 4) + 2 (lane % 4) + j % 2
    const int key0 = (kb0 + i) * kWgKeys;
#pragma unroll
    for (int j = 0; j < 64; ++j) s[j] *= p.scale_log2;
    if (key0 + kWgKeys > p.Skv || (p.causal && key0 + kWgKeys - 1 > wg_lo) ||
        (p.window > 0 && key0 <= wg_hi - p.window)) {
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        const int key = key0 + (j >> 2) * 8 + 2 * (lane & 3) + (j & 1);
        if (!visible((j & 2) ? pb : pa, key, p.Skv, p.causal, p.window))
          s[j] = -CUDART_INF_F;
      }
    }
    float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      if (j & 2) mx_b = fmaxf(mx_b, s[j]);
      else mx_a = fmaxf(mx_a, s[j]);
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row that has seen no key yet keeps m = -inf: subtract 0 instead
    const float mu_a = mn_a == -CUDART_INF_F ? 0.0f : mn_a;
    const float mu_b = mn_b == -CUDART_INF_F ? 0.0f : mn_b;
    const float al_a = fast_exp2(m_a - mu_a), al_b = fast_exp2(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      s[j] = fast_exp2(s[j] - ((j & 2) ? mu_b : mu_a));
      if (j & 2) sum_b += s[j];
      else sum_a += s[j];
    }
    // l stays a per-lane partial (its quad is summed at the end)
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int j = 0; j < 64; ++j) o[j] *= (j & 2) ? al_b : al_a;
    // P as bf16 A fragments: n8 blocks 2 kk and 2 kk + 1 form slice kk
#pragma unroll
    for (int kk = 0; kk < kWgKeys / 16; ++kk) {
      pf[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
  }
  const float inv_a = l_a > 0.0f ? 1.0f / l_a : 0.0f;
  const float inv_b = l_b > 0.0f ? 1.0f / l_b : 0.0f;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) +
                       (int64_t)bh * p.Sq * kWgD + 2 * (lane & 3);
  if (ra < p.Sq) {
    __nv_bfloat16* orow = out + (int64_t)ra * kWgD;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
  }
  if (rb < p.Sq) {
    __nv_bfloat16* orow = out + (int64_t)rb * kWgD;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
}

// cuTensorMapEncodeTiled, found through the runtime (the build links only
// the runtime, not the driver library)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// the map of a contiguous bf16 (BH, S, 128) array as (128, S, BH), boxes of
// (64, 128, 1) in the 128-byte swizzle; rows past S read as zeros
CUresult encode_map(CUtensorMap* map, const void* ptr, int S, int BH) {
  EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)kWgD, (cuuint64_t)S,
                              (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)kWgD * 2,
                                 (cuuint64_t)S * kWgD * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)kWgRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D, int BK>
int launch(const Params& p, int B, int bf16, cudaStream_t stream) {
  const dim3 grid(((p.rows + p.block_q - 1) / p.block_q) * p.splits, p.Hkv,
                  B);
  const int threads = p.block_q * 2;   // 16 rows per 32-lane warp
  if (bf16) {
    const size_t smem = 2 * 2 * (size_t)BK * (D + 8) * 2;
    auto kernel = p.splits > 1 ? flash_mma<D, BK, true>
                               : flash_mma<D, BK, false>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, threads, smem, stream>>>(p);
  } else {
    const size_t smem = sizeof(float) * ((size_t)BK * (D + 1) + BK * D +
                                         (threads / 32) * 16 * (D + BK));
    cudaError_t e = cudaFuncSetAttribute(
        flash_simt<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    flash_simt<D, BK><<<grid, threads, smem, stream>>>(p);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return (int)e;
  const int n_rows = B * p.Hkv * p.rows;
  const int per_cta = kMaxThreads / 32;
  const dim3 cgrid((n_rows + per_cta - 1) / per_cta);
  if (bf16)
    flash_combine<D, __nv_bfloat16><<<cgrid, kMaxThreads, 0, stream>>>(
        p, n_rows);
  else
    flash_combine<D, float><<<cgrid, kMaxThreads, 0, stream>>>(p, n_rows);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bk(const Params& p, int B, int block_k, int bf16,
              cudaStream_t stream) {
  if (block_k == 32) return launch<D, 32>(p, B, bf16, stream);
  if (block_k == 64) return launch<D, 64>(p, B, bf16, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The folded kernels.  q (B, Hq, Sq, D), k / v (B, Hkv, Skv, D), o like q;
// all contiguous, of one type: bf16 (bf16 != 0) or f32.  D in {16, 32, 64,
// 128}; block_q in {16, 32, 64, 128}; block_k in {32, 64}; window 0 for
// none.  splits > 1 cuts each row tile's key blocks into that many pieces
// and merges them with flash_combine; part_acc (B, Hkv, Sq * Hq / Hkv,
// splits, D) and part_ml (..., splits, 2) are its f32 scratch (unread when
// splits is 1).  Returns cudaGetLastError() after the launches.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* part_acc, void* part_ml, int B, int Hq, int Hkv,
                        int Sq, int Skv, int D, int causal, int window,
                        float scale, int block_q, int block_k, int splits,
                        int bf16, void* stream) {
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0 || splits < 1 ||
      (block_q != 16 && block_q != 32 && block_q != 64 && block_q != 128) ||
      B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.g = Hq / Hkv;
  p.rows = Sq * p.g;
  p.block_q = block_q;
  p.splits = splits;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_bk<16>(p, B, block_k, bf16, s);
    case 32: return launch_bk<32>(p, B, block_k, bf16, s);
    case 64: return launch_bk<64>(p, B, block_k, bf16, s);
    case 128: return launch_bk<128>(p, B, block_k, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The TMA + wgmma kernel: bf16 q (B, Hq, Sq, 128), k / v (B, Hkv, Skv,
// 128), o like q, contiguous, 16-byte aligned.  Returns cudaGetLastError()
// after the launch, or minus the driver's error where a tensor map could not
// be encoded.
int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v,
                              void* o, int B, int Hq, int Hkv, int Sq,
                              int Skv, int causal, int window, float scale,
                              void* stream) {
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0) return (int)cudaErrorInvalidValue;
  WgParams p;
  p.o = o;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.g = Hq / Hkv;
  p.n_tiles = (Sq + kWgRows - 1) / kWgRows;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * kLog2e;
  if ((int64_t)B * Hq * p.n_tiles > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  CUresult r = encode_map(&tq, q, Sq, B * Hq);
  if (r == CUDA_SUCCESS) r = encode_map(&tk, k, Skv, B * Hkv);
  if (r == CUDA_SUCCESS) r = encode_map(&tv, v, Skv, B * Hkv);
  if (r != CUDA_SUCCESS) return -(int)r;
  const size_t smem = sizeof(WgSmem) + 1024;   // + alignment to 1,024 B
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_wgmma<<<B * Hq * p.n_tiles, kWgThreads, smem,
                (cudaStream_t)stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
