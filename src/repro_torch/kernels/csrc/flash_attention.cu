// Blockwise (flash) causal GQA attention for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:92).  For every batch b, query head h
// (KV head h / G, G = H / Hkv) and query row i at position qpos = q_offset + i:
//
//   out[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / G, j] / sqrt(D)) v[b, h / G, j]
//
// over the keys j (at position j) with j <= qpos when causal and qpos - j <
// window when a window is given; float32 scores, softmax and P.V, the output
// rounded once to the input type; a row with no valid key gives 0.
//
// Every operand is read in place through its (batch, head, row) strides, the
// head dimension contiguous, so the model's (B, S, H, D) chunk queries and its
// (B, W, Hkv, D) KV ring need no transposing copy.
//
// What bounds it: at long sequences, operations (2 x 2 x D multiply-adds per
// (query, visited key) against about 2 x D x (Sq + 2 Skv) bytes per head);
// at a short prefill chunk, bytes.
//
// Design.  The Pallas kernel walks the KV blocks as the last, sequential grid
// axis with m / l / acc in VMEM scratch; a GPU grid has no order.  So one
// block owns one (query tile of 64 rows, query head, batch) and loops over
// the KV tiles itself, with the online softmax (m, l, acc) in registers.
// With causal masking and a window it visits only the KV tiles that can
// intersect (qpos - window, qpos] for some row of its tile: the TPU kernel's
// block skip, so a windowed long sequence reads O(window) keys per query
// tile.  Rows are masked per key (position, causal, window) and the tiles'
// ragged edges are zero-filled, so any Sq >= 1 and any Skv work.  Query
// tiles are issued longest-first, so the causal grid's long rows start early.
//
// Two instances of that design:
//  * bfloat16 with 16-byte aligned rows (the model's case), namespace tc: the
//    tensor cores through warp-level mma.sync m16n8k16 tiles, one warp per 16
//    query rows; S = Q K^T exact products in f32 sums, P split into two bf16
//    terms for P.V so that it keeps ~16 bits of each weight (an f32 P.V up to
//    2^-17 of each term), K / V tiles streamed through shared memory in two
//    cp.async stages.  Simple still: no wgmma, no TMA, no warp specialisation,
//    and every query head reloads its KV head's tiles (L2 serves the repeats).
//  * float32, or unaligned bfloat16: float32 FMAs outside the tensor cores,
//    the first version.  Tiles of Q (pre-scaled by log2(e) / sqrt(D)), K and
//    V are staged in shared memory as float32; each of the 16 x 16 threads
//    owns 4 query rows and 4 keys of the score tile (float4 reads along D,
//    padded rows so the reads are free of bank conflicts) and 4 rows x D/16
//    columns of the output; P goes through shared memory between the two
//    products.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TX = 16;            // threads along the keys / output columns
constexpr int TY = 16;            // threads along the query rows
constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per KV tile
constexpr int RPT = BQ / TY;      // query rows per thread
constexpr int CPT = BK / TX;      // score columns (keys) per thread
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s;  // elements between batches, heads and rows
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int D>
struct Layout {
  static constexpr int QLD = D + 4;  // padded: 8 rows' float4 reads hit 32 banks
  static constexpr int KLD = D + 4;
  static constexpr int VLD = D;
  static constexpr int PLD = BK + 4;
  static constexpr int FLOATS = BQ * QLD + BK * KLD + BK * VLD + BQ * PLD;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// dst[r][d] = src[r * row_stride + d] * mul for r < valid, 0 for valid <= r < rows
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const T* __restrict__ src, long long row_stride,
                                          int valid, int rows, float mul) {
  for (int e = threadIdx.y * TX + threadIdx.x; e < rows * D; e += TX * TY) {
    const int r = e / D, d = e - (e / D) * D;
    dst[r * ld + d] = r < valid ? to_f32(src[static_cast<long long>(r) * row_stride + d]) * mul
                                : 0.f;
  }
}

__device__ __forceinline__ float group_max(float v) {  // over the 16 lanes of a row group
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(TX * TY)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, Strides qs,
                       Strides ks, Strides vs, Strides os, int G, int Sq, int Skv,
                       int causal, int window, int q_offset, float qmul) {
  using Lay = Layout<D>;
  constexpr int DPT = D / TX;  // output columns per thread: d = tx + TX * u
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * Lay::QLD;
  float* Vs = Ks + BK * Lay::KLD;
  float* Ps = Vs + BK * Lay::VLD;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int nq = min(BQ, Sq - q0);
  const T* qb = q + b * qs.b + h * qs.h + static_cast<long long>(q0) * qs.s;
  const T* kb = k + b * ks.b + (h / G) * ks.h;
  const T* vb = v + b * vs.b + (h / G) * vs.h;

  // the keys any row of this tile can see: the TPU kernel's block skip
  const int first = q_offset + q0, last = q_offset + q0 + nq - 1;
  int lo = 0, hi = Skv;
  if (causal) hi = min(hi, last + 1);
  if (window > 0) lo = max(lo, first - window + 1);

  load_tile<D>(Qs, Lay::QLD, qb, qs.s, nq, BQ, qmul);

  float m[RPT], l[RPT], o[RPT][DPT];
  int qpos[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    qpos[i] = first + ty + TY * i;
#pragma unroll
    for (int u = 0; u < DPT; ++u) o[i][u] = 0.f;
  }

  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    const int nk = min(BK, Skv - k0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, Lay::KLD, kb + static_cast<long long>(k0) * ks.s, ks.s, nk, BK, 1.f);
    load_tile<D>(Vs, Lay::VLD, vb + static_cast<long long>(k0) * vs.s, vs.s, nk, BK, 1.f);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + TY * i) * Lay::QLD + d);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + TX * j) * Lay::KLD + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // mask, then the online softmax in base 2 (qmul carries log2(e) / sqrt(D))
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + TX * j;
        const bool ok = kpos < Skv && (!causal || kpos <= qpos[i]) &&
                        (window <= 0 || qpos[i] - kpos < window);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], group_max(mx));
      const float mu = mn == -INFINITY ? 0.f : mn;  // no valid key yet: p = 0
      const float alpha = exp2f(m[i] - mu);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = exp2f(s[i][j] - mu);
        sum += p;
        Ps[(ty + TY * i) * Lay::PLD + tx + TX * j] = p;
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = mn;
#pragma unroll
      for (int u = 0; u < DPT; ++u) o[i][u] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float p[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(Ps + (ty + TY * i) * Lay::PLD + kk);
        p[i][0] = pv.x;
        p[i][1] = pv.y;
        p[i][2] = pv.z;
        p[i][3] = pv.w;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float vv[DPT];
#pragma unroll
        for (int u = 0; u < DPT; ++u) vv[u] = Vs[(kk + c) * Lay::VLD + tx + TX * u];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int u = 0; u < DPT; ++u) o[i][u] = fmaf(p[i][c], vv[u], o[i][u]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = ty + TY * i;
    if (row < nq) {
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // no valid key: 0
      T* ob = out + b * os.b + h * os.h + static_cast<long long>(q0 + row) * os.s;
#pragma unroll
      for (int u = 0; u < DPT; ++u) store(ob + tx + TX * u, o[i][u] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, Strides qs,
           Strides ks, Strides vs, Strides os, int B, int H, int G, int Sq, int Skv,
           int causal, int window, int q_offset, cudaStream_t stream) {
  const size_t smem = Layout<D>::BYTES;
  const cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const dim3 block(TX, TY);
  flash_attention_kernel<T, D><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), qs, ks, vs, os, G, Sq, Skv, causal, window, q_offset,
      LOG2E / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, Strides qs,
             Strides ks, Strides vs, Strides os, int B, int H, int G, int Sq, int Skv,
             int D, int causal, int window, int q_offset, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, qs, ks, vs, os, B, H, G, Sq, Skv, causal, window, q_offset, stream);
    case 64: return launch<T, 64>(q, k, v, out, qs, ks, vs, os, B, H, G, Sq, Skv, causal, window, q_offset, stream);
    case 128: return launch<T, 128>(q, k, v, out, qs, ks, vs, os, B, H, G, Sq, Skv, causal, window, q_offset, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: warp-level mma.sync m16n8k16 tiles
namespace tc {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per block: 16 per warp
constexpr int BK = 64;          // keys per KV tile
constexpr int PAD = 8;          // bf16 per smem row: 8 rows of an ldmatrix hit 8 bank groups

template <int D>
struct Layout {
  static constexpr int LD = D + PAD;
  static constexpr int TILE = BK * LD;
  static constexpr size_t BYTES = static_cast<size_t>(BQ * LD + 4 * TILE) * sizeof(__nv_bfloat16);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (the tile's ragged edge)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (a, b) = hi + lo in bfloat16 pairs: hi + lo keeps ~16 bits of each value
__device__ __forceinline__ void split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

template <int D>
__device__ __forceinline__ void load_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long row_stride, int valid, int rows) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < rows * CH; e += THREADS) {
    const int r = e / CH, c = e - (e / CH) * CH;
    const bool ok = r < valid;
    cp_async16(dst + r * Layout<D>::LD + c * 8, src + (ok ? r * row_stride : 0) + c * 8, ok);
  }
}

// The same function as the float32 kernel above, one warp per 16 query rows:
// S = Q K^T with bf16 operands (exact products, f32 sums), the online
// softmax on the f32 accumulators in registers, and O += P V with P split
// into two bf16 terms (hi + lo), so that P.V keeps ~16 bits of each weight
// where one bf16 P would keep 8.  K / V tiles stream through shared memory in
// two cp.async stages; fragments come from ldmatrix (V transposed).
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                Strides qs, Strides ks, Strides vs, Strides os, int G, int Sq, int Skv,
                int causal, int window, int q_offset, float smul) {
  using Lay = Layout<D>;
  constexpr int LD = Lay::LD;
  constexpr int KS = D / 16;  // k-steps of Q K^T
  constexpr int NT = BK / 8;  // score n-tiles
  constexpr int DT = D / 8;   // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* KV = Qs + BQ * LD;  // stage st: K at st * 2 * TILE, V after it

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int nq = min(BQ, Sq - q0);
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h + static_cast<long long>(q0) * qs.s;
  const __nv_bfloat16* kb = k + b * ks.b + (h / G) * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + (h / G) * vs.h;

  const int first = q_offset + q0, last = q_offset + q0 + nq - 1;
  int lo = 0, hi = Skv;
  if (causal) hi = min(hi, last + 1);
  if (window > 0) lo = max(lo, first - window + 1);
  const int t0 = lo / BK, t1 = hi > lo ? (hi + BK - 1) / BK : t0;

  auto load_kv = [&](int tile, int st) {
    const int k0 = tile * BK, nk = min(BK, Skv - k0);
    __nv_bfloat16* Kt = KV + st * 2 * Lay::TILE;
    load_async<D>(Kt, kb + static_cast<long long>(k0) * ks.s, ks.s, nk, BK);
    load_async<D>(Kt + Lay::TILE, vb + static_cast<long long>(k0) * vs.s, vs.s, nk, BK);
  };
  load_async<D>(Qs, qb, qs.s, nq, BQ);
  if (t0 < t1) load_kv(t0, 0);
  cp_commit();

  float o[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int qp[2] = {first + w * 16 + g, first + w * 16 + g + 8};
  uint32_t qf[KS][4];

  for (int it = t0; it < t1; ++it) {
    const int st = (it - t0) & 1;
    if (it + 1 < t1) load_kv(it + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();  // this tile (and Q) have landed
    __syncthreads();
    if (it == t0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], Qs + (w * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + kk * 16 +
                            (lane >> 4) * 8);
    }
    const __nv_bfloat16* Kt = KV + st * 2 * Lay::TILE;
    const __nv_bfloat16* Vt = Kt + Lay::TILE;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, Kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma(s[2 * np], qf[kk], bb[0], bb[1]);
        mma(s[2 * np + 1], qf[kk], bb[2], bb[3]);
      }

    // mask, then the online softmax in base 2 for rows g (r = 0) and g + 8 (r = 1)
    const int k0 = it * BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nt * 8 + 2 * t + (e & 1), p = qp[e >> 1];
        const bool ok = kpos < Skv && (!causal || kpos <= p) && (window <= 0 || p - kpos < window);
        s[nt][e] = ok ? s[nt][e] * smul : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float mu[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      mu[r] = mn == -INFINITY ? 0.f : mn;  // no valid key yet: p = 0
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - mu[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

    // O += P V: the score accumulators of n-tiles 2j, 2j + 1 are the A
    // fragment of key step j
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t ph[4], pl[4];
      split(s[2 * j][0], s[2 * j][1], ph[0], pl[0]);
      split(s[2 * j][2], s[2 * j][3], ph[1], pl[1]);
      split(s[2 * j + 1][0], s[2 * j + 1][1], ph[2], pl[2]);
      split(s[2 * j + 1][2], s[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bb[4];
        ldsm_x4_t(bb, Vt + (j * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + dp * 16 +
                          (lane >> 4) * 8);
        mma(o[2 * dp], ph, bb[0], bb[1]);
        mma(o[2 * dp], pl, bb[0], bb[1]);
        mma(o[2 * dp + 1], ph, bb[2], bb[3]);
        mma(o[2 * dp + 1], pl, bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w * 16 + g + 8 * r;
    if (row < nq) {
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no valid key: 0
      __nv_bfloat16* ob = out + b * os.b + h * os.h + static_cast<long long>(q0 + row) * os.s;
#pragma unroll
      for (int dn = 0; dn < DT; ++dn)
        *reinterpret_cast<__nv_bfloat162*>(ob + dn * 8 + 2 * t) =
            __floats2bfloat162_rn(o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, Strides qs, Strides ks,
           Strides vs, Strides os, int B, int H, int G, int Sq, int Skv, int causal, int window,
           int q_offset, cudaStream_t stream) {
  const size_t smem = Layout<D>::BYTES;
  const cudaError_t e = cudaFuncSetAttribute(flash_tc_kernel<D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_tc_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), qs, ks, vs, os, G,
      Sq, Skv, causal, window, q_offset, LOG2E / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

int launch_d(const void* q, const void* k, const void* v, void* out, Strides qs, Strides ks,
             Strides vs, Strides os, int B, int H, int G, int Sq, int Skv, int D, int causal,
             int window, int q_offset, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32>(q, k, v, out, qs, ks, vs, os, B, H, G, Sq, Skv, causal, window, q_offset, stream);
    case 64: return launch<64>(q, k, v, out, qs, ks, vs, os, B, H, G, Sq, Skv, causal, window, q_offset, stream);
    case 128: return launch<128>(q, k, v, out, qs, ks, vs, os, B, H, G, Sq, Skv, causal, window, q_offset, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// 16-byte rows: every base and every batch / head / row stride a multiple of
// 8 bf16, as cp.async and the paired output stores need
bool aligned(const void* q, const void* k, const void* v, const void* out,
             const Strides (&st)[4]) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  long long m = 0;
  for (const Strides& s : st) m |= s.b | s.h | s.s;
  return p % 16 == 0 && m % 8 == 0;
}

}  // namespace tc

}  // namespace

// q (B, H, Sq, D), k / v (B, Hkv, Skv, D), out (B, H, Sq, D), each addressed
// as base + b * s_b + h * s_h + row * s_s + d (strides in elements, d
// contiguous); dtype 0 = float32, 1 = bfloat16, all four alike.  window <= 0:
// no window.  Query row i sits at position q_offset + i, key row j at j.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int dtype, int B, int H, int Hkv, int Sq, int Skv, int D,
                               long long q_sb, long long q_sh, long long q_ss,
                               long long k_sb, long long k_sh, long long k_ss,
                               long long v_sb, long long v_sh, long long v_ss,
                               long long o_sb, long long o_sh, long long o_ss,
                               int causal, int window, int q_offset, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Skv < 0 || q_offset < 0 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  const Strides all[4] = {qs, ks, vs, os};
  switch (dtype) {
    case 0: return launch_d<float>(q, k, v, out, qs, ks, vs, os, B, H, G, Sq, Skv, D, causal, window, q_offset, st);
    case 1:
      if (tc::aligned(q, k, v, out, all))
        return tc::launch_d(q, k, v, out, qs, ks, vs, os, B, H, G, Sq, Skv, D, causal, window, q_offset, st);
      return launch_d<__nv_bfloat16>(q, k, v, out, qs, ks, vs, os, B, H, G, Sq, Skv, D, causal, window, q_offset, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
