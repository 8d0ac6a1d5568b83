// Fused HQQ dequantize x matmul for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernels dequant_matmul_batched_pallas and
// dequant_matmul_slots_pallas (src/repro/kernels/dequant_matmul.py:109 and
// :145), and dequant_matmul_pallas (:57) as the B = 1 case, together with the
// _meta_dequantize the reference runs before them (src/repro/quant/hqq.py:194):
//
//   out[b, m, n] = sum_k x[b, m, k] * W_s[k, n],   s = slots[b] (or b)
//   W_s[k, n]    = (code_s[k, n] - zero_s[k/g, n]) * scale_s[k/g, n]
//   scale_s[G,n] = q_scale[G, n] * s_scale[G/sg, n] + s_min[G/sg, n]   (same for zero)
//
// The weights are read exactly as they are stored: uint8 codes packed along
// the group axis (2-bit 4 per byte, 4-bit 2, 8-bit 1, 3-bit 8 codes in three
// planar bytes), uint8 meta-quantized scale/zero and four float16 meta arrays.
// Scale and zero are de-meta-quantized in registers, so no float32 copy of
// them ever exists in device memory.
//
// What bounds it: bytes.  The main path calls it at M = 1 (batch-1 decode,
// one row per (token, expert)), where each stored weight byte feeds one to
// four multiply-adds; the card's memory rate, not its arithmetic, sets the
// floor.  The design therefore spends its effort on the loads: each thread
// owns 4 neighbouring columns and reads them as one 32-bit word per byte row
// (N is the contiguous axis of the (G, g*bits/8, N) layout, so a half-warp
// reads 64 contiguous bytes), and the block splits the K loop over TY thread
// rows that are summed in shared memory at the end, so that the down
// projection (N = 4096) still fills the card with blocks.  x is read through
// the L1 cache (every thread of a row reads the same element).  Every output
// row is computed independently, in the same order, whatever B, M and the
// slot map are.
//
// Simple first: no cp.async/TMA pipeline, no split-K across blocks, no
// tensor cores.  It serves float32 activations, more than 8 rows per record
// and shapes outside the tensor-core kernels' scope: bfloat16 decode runs
// csrc/dequant_gemv.cu and bfloat16 prefill groups csrc/dequant_grouped.cu.  Ragged row groups
// (dequant_matmul_ragged) take the same code, one block row per group.
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 16;             // threads along N
constexpr int TY = 16;             // threads along the group (K) axis
constexpr int CPT = 4;             // columns per thread
constexpr int TILE_N = TX * CPT;   // columns per block

struct Leaves {
  const uint8_t* packed;  long long packed_stride;  // per slot, in elements
  const uint8_t* scale;   long long scale_stride;
  const uint8_t* zero;    long long zero_stride;
  const __half* s_scale;
  const __half* s_min;
  const __half* z_scale;
  const __half* z_min;    long long meta_stride;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// one weight column value, rounded exactly like the reference:
// (q - zero) * scale in float32, no fused multiply-add
__device__ __forceinline__ float dq(uint32_t code, float z, float s) {
  return __fmul_rn(__fsub_rn(static_cast<float>(code), z), s);
}

template <int MT, typename XT>
__device__ __forceinline__ void fma_row(const XT* __restrict__ xg, int K, int mrem,
                                        int j, const float (&w)[CPT],
                                        float (&acc)[MT][CPT]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < mrem) {
      const float xv = to_f32(xg[static_cast<long long>(m) * K + j]);
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
    }
  }
}

// codes of one group for this thread's 4 columns, accumulated into acc
template <int BITS, int MT, typename XT>
__device__ __forceinline__ void group_fma(const uint8_t* __restrict__ p, int N, int gs,
                                          const XT* __restrict__ xg, int K, int mrem,
                                          const float (&sc)[CPT], const float (&zr)[CPT],
                                          float (&acc)[MT][CPT]) {
  if constexpr (BITS == 3) {
    // planar 3-bit: unit r of the group holds codes 8r..8r+7 in the 24-bit
    // word p[r] | p[n8 + r] << 8 | p[2 n8 + r] << 16
    const int n8 = gs / 8;
#pragma unroll 2
    for (int r = 0; r < n8; ++r) {
      const uchar4 b0 = *reinterpret_cast<const uchar4*>(p + static_cast<long long>(r) * N);
      const uchar4 b1 = *reinterpret_cast<const uchar4*>(p + static_cast<long long>(n8 + r) * N);
      const uchar4 b2 = *reinterpret_cast<const uchar4*>(p + static_cast<long long>(2 * n8 + r) * N);
      const uint32_t word[CPT] = {
          b0.x | (uint32_t(b1.x) << 8) | (uint32_t(b2.x) << 16),
          b0.y | (uint32_t(b1.y) << 8) | (uint32_t(b2.y) << 16),
          b0.z | (uint32_t(b1.z) << 8) | (uint32_t(b2.z) << 16),
          b0.w | (uint32_t(b1.w) << 8) | (uint32_t(b2.w) << 16)};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float w[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) w[c] = dq((word[c] >> (3 * i)) & 7u, zr[c], sc[c]);
        fma_row<MT>(xg, K, mrem, 8 * r + i, w, acc);
      }
    }
  } else {
    // 2/4/8-bit: byte row r holds codes P*r .. P*r+P-1, code i at bits*i
    constexpr int P = 8 / BITS;
    constexpr uint32_t MASK = (1u << BITS) - 1u;
    const int rows = gs / P;
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const uchar4 v = *reinterpret_cast<const uchar4*>(p + static_cast<long long>(r) * N);
      const uint32_t byte[CPT] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < P; ++i) {
        float w[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) w[c] = dq((byte[c] >> (BITS * i)) & MASK, zr[c], sc[c]);
        fma_row<MT>(xg, K, mrem, P * r + i, w, acc);
      }
    }
  }
}

// The M rows of xb (M, K) times record s of the weights into ob (M, N), for
// this block's TILE_N columns.
template <int BITS, int MT, typename XT>
__device__ __forceinline__ void dequant_rows(const XT* __restrict__ xb, float* __restrict__ ob,
                                             long long s, const Leaves& w, int M, int K, int N,
                                             int gs, int sg) {
  __shared__ float red[TY][MT][TILE_N];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n0 = blockIdx.x * TILE_N + tx * CPT;
  const bool col_ok = n0 < N;  // N % CPT == 0: a thread's columns are all in or all out
  const int G = K / gs;
  const int pg = gs * BITS / 8;

  const uint8_t* P = w.packed + s * w.packed_stride;
  const uint8_t* QS = w.scale + s * w.scale_stride;
  const uint8_t* QZ = w.zero + s * w.zero_stride;
  const __half* SS = w.s_scale + s * w.meta_stride;
  const __half* SM = w.s_min + s * w.meta_stride;
  const __half* ZS = w.z_scale + s * w.meta_stride;
  const __half* ZM = w.z_min + s * w.meta_stride;

  for (int m0 = 0; m0 < M; m0 += MT) {
    float acc[MT][CPT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;

    if (col_ok) {
      for (int g = ty; g < G; g += TY) {
        const long long gi = static_cast<long long>(g) * N + n0;
        const long long mi = static_cast<long long>(g / sg) * N + n0;
        const uchar4 qs = *reinterpret_cast<const uchar4*>(QS + gi);
        const uchar4 qz = *reinterpret_cast<const uchar4*>(QZ + gi);
        const uint32_t qsv[CPT] = {qs.x, qs.y, qs.z, qs.w};
        const uint32_t qzv[CPT] = {qz.x, qz.y, qz.z, qz.w};
        float sc[CPT], zr[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          sc[c] = __fadd_rn(__fmul_rn(static_cast<float>(qsv[c]), __half2float(SS[mi + c])),
                            __half2float(SM[mi + c]));
          zr[c] = __fadd_rn(__fmul_rn(static_cast<float>(qzv[c]), __half2float(ZS[mi + c])),
                            __half2float(ZM[mi + c]));
        }
        group_fma<BITS, MT>(P + static_cast<long long>(g) * pg * N + n0, N, gs,
                            xb + static_cast<long long>(m0) * K + static_cast<long long>(g) * gs,
                            K, M - m0, sc, zr, acc);
      }
    }

#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < CPT; ++c) red[ty][m][tx * CPT + c] = acc[m][c];
    __syncthreads();
    for (int e = ty * TX + tx; e < MT * TILE_N; e += TX * TY) {
      const int m = e / TILE_N, col = e % TILE_N;
      const int n = blockIdx.x * TILE_N + col;
      if (m0 + m < M && n < N) {
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < TY; ++t) sum += red[t][m][col];
        ob[static_cast<long long>(m0 + m) * N + n] = sum;
      }
    }
    __syncthreads();
  }
}

template <int BITS, int MT, typename XT>
__global__ void __launch_bounds__(TX * TY)
dequant_matmul_kernel(const XT* __restrict__ x, float* __restrict__ out,
                      const int* __restrict__ slots, Leaves w,
                      int M, int K, int N, int gs, int sg) {
  const int b = blockIdx.y;
  const long long s = slots ? static_cast<long long>(slots[b]) : static_cast<long long>(b);
  dequant_rows<BITS, MT>(x + static_cast<long long>(b) * M * K,
                         out + static_cast<long long>(b) * M * N, s, w, M, K, N, gs, sg);
}

// Ragged row groups (float32 x): group u, rows off[u] .. off[u + 1] of x
// and out, reads record u.
constexpr int MAX_GROUPS = 256;
struct Offsets {
  int v[MAX_GROUPS + 1];  // passed by value
};

template <int BITS, int MT>
__global__ void __launch_bounds__(TX * TY)
dequant_ragged_kernel(const float* __restrict__ x, float* __restrict__ out, const Offsets off,
                      Leaves w, int K, int N, int gs, int sg) {
  const int u = blockIdx.y, r0 = off.v[u], M = off.v[u + 1] - r0;
  if (M <= 0) return;
  dequant_rows<BITS, MT>(x + static_cast<long long>(r0) * K, out + static_cast<long long>(r0) * N,
                         u, w, M, K, N, gs, sg);
}

template <int BITS, int MT>
void launch_ragged(const float* x, float* out, const Offsets& off, const Leaves& w, int U, int K,
                   int N, int gs, int sg, cudaStream_t stream) {
  const dim3 block(TX, TY);
  const dim3 grid((N + TILE_N - 1) / TILE_N, U);
  dequant_ragged_kernel<BITS, MT><<<grid, block, 0, stream>>>(x, out, off, w, K, N, gs, sg);
}

template <int BITS, int MT, typename XT>
void launch(const void* x, float* out, const int* slots, const Leaves& w, int B,
            int M, int K, int N, int gs, int sg, cudaStream_t stream) {
  const dim3 block(TX, TY);
  const dim3 grid((N + TILE_N - 1) / TILE_N, B);
  dequant_matmul_kernel<BITS, MT, XT><<<grid, block, 0, stream>>>(
      static_cast<const XT*>(x), out, slots, w, M, K, N, gs, sg);
}

template <int BITS, typename XT>
void launch_m(const void* x, float* out, const int* slots, const Leaves& w, int B,
              int M, int K, int N, int gs, int sg, cudaStream_t stream) {
  if (M == 1)
    launch<BITS, 1, XT>(x, out, slots, w, B, M, K, N, gs, sg, stream);
  else
    launch<BITS, 8, XT>(x, out, slots, w, B, M, K, N, gs, sg, stream);
}

template <typename XT>
int launch_bits(const void* x, float* out, const int* slots, const Leaves& w, int B,
                int M, int K, int N, int bits, int gs, int sg, cudaStream_t stream) {
  switch (bits) {
    case 2: launch_m<2, XT>(x, out, slots, w, B, M, K, N, gs, sg, stream); break;
    case 3: launch_m<3, XT>(x, out, slots, w, B, M, K, N, gs, sg, stream); break;
    case 4: launch_m<4, XT>(x, out, slots, w, B, M, K, N, gs, sg, stream); break;
    case 8: launch_m<8, XT>(x, out, slots, w, B, M, K, N, gs, sg, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// x: (B, M, K) contiguous, dtype 0 = float32, 1 = bfloat16.
// out: (B, M, N) float32 contiguous.  slots: (B,) int32 on the device, or
// null for slot b = b.  Each weight leaf is a per-slot contiguous block at
// base + slot * stride (strides in elements of the leaf's type):
// packed (G, g*bits/8, N) u8, scale/zero (G, N) u8, meta (G/sg, N) f16.
extern "C" int dequant_matmul(const void* x, int x_dtype, float* out, const int* slots,
                              int B, int M, int K, int N, int bits, int group_size,
                              int scale_group, const uint8_t* packed,
                              long long packed_stride, const uint8_t* scale,
                              long long scale_stride, const uint8_t* zero,
                              long long zero_stride, const void* s_scale,
                              const void* s_min, const void* z_scale, const void* z_min,
                              long long meta_stride, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || N % CPT || group_size <= 0 || K % group_size ||
      scale_group <= 0 || (K / group_size) % scale_group || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((bits == 3 && group_size % 8) || (bits != 3 && group_size % (8 / bits)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Leaves w{packed, packed_stride, scale, scale_stride, zero, zero_stride,
                 static_cast<const __half*>(s_scale), static_cast<const __half*>(s_min),
                 static_cast<const __half*>(z_scale), static_cast<const __half*>(z_min),
                 meta_stride};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (x_dtype) {
    case 0: rc = launch_bits<float>(x, out, slots, w, B, M, K, N, bits, group_size, scale_group, st); break;
    case 1: rc = launch_bits<__nv_bfloat16>(x, out, slots, w, B, M, K, N, bits, group_size, scale_group, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

// x: (R, K) float32 contiguous, rows sorted by group; offsets: U + 1 row
// offsets in host memory (offsets[0] = 0); out: (R, N) float32.  Group u
// reads record u of the leaves, laid out as for dequant_matmul.
extern "C" int dequant_matmul_ragged(const float* x, float* out, const int* offsets, int U, int K,
                                     int N, int bits, int group_size, int scale_group,
                                     const uint8_t* packed, long long packed_stride,
                                     const uint8_t* scale, long long scale_stride,
                                     const uint8_t* zero, long long zero_stride,
                                     const void* s_scale, const void* s_min, const void* z_scale,
                                     const void* z_min, long long meta_stride, void* stream) {
  if (U <= 0 || U > MAX_GROUPS || N <= 0 || N % CPT || group_size <= 0 || K % group_size ||
      scale_group <= 0 || (K / group_size) % scale_group || offsets[0] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((bits == 3 && group_size % 8) || (bits != 3 && group_size % (8 / bits)))
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets off;
  int max_rows = 0;
  off.v[0] = 0;
  for (int u = 0; u < U; ++u) {
    off.v[u + 1] = offsets[u + 1];
    const int c = off.v[u + 1] - off.v[u];
    if (c < 0) return static_cast<int>(cudaErrorInvalidValue);
    max_rows = c > max_rows ? c : max_rows;
  }
  if (max_rows == 0) return 0;
  const Leaves w{packed, packed_stride, scale, scale_stride, zero, zero_stride,
                 static_cast<const __half*>(s_scale), static_cast<const __half*>(s_min),
                 static_cast<const __half*>(z_scale), static_cast<const __half*>(z_min),
                 meta_stride};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool one = max_rows == 1;
  switch (bits) {
    case 2: one ? launch_ragged<2, 1>(x, out, off, w, U, K, N, group_size, scale_group, st)
                : launch_ragged<2, 8>(x, out, off, w, U, K, N, group_size, scale_group, st); break;
    case 3: one ? launch_ragged<3, 1>(x, out, off, w, U, K, N, group_size, scale_group, st)
                : launch_ragged<3, 8>(x, out, off, w, U, K, N, group_size, scale_group, st); break;
    case 4: one ? launch_ragged<4, 1>(x, out, off, w, U, K, N, group_size, scale_group, st)
                : launch_ragged<4, 8>(x, out, off, w, U, K, N, group_size, scale_group, st); break;
    case 8: one ? launch_ragged<8, 1>(x, out, off, w, U, K, N, group_size, scale_group, st)
                : launch_ragged<8, 8>(x, out, off, w, U, K, N, group_size, scale_group, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
