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
// block owns one query tile (of one query head, or of all the query heads of
// one KV head: see below) and loops over
// the KV tiles itself, with the online softmax (m, l, acc) in registers.
// With causal masking and a window it visits only the KV tiles that can
// intersect (qpos - window, qpos] for some row of its tile: the TPU kernel's
// block skip, so a windowed long sequence reads O(window) keys per query
// tile.  Rows are masked per key (position, causal, window) and the tiles'
// ragged edges are zero-filled, so any Sq >= 1 and any Skv work.  Query
// tiles are issued longest-first, so the causal grid's long rows start early.
//
// Two instances of that design:
//  * bfloat16, head_dim 64 or 128, 16-byte aligned rows (the model's case),
//    namespace tc, on the tensor cores through warpgroup wgmma.  A block owns
//    (query tile, KV head, batch) and stacks the G query heads of its KV head
//    as its rows (4 heads x 32 positions = 128 rows for Mixtral), so each
//    K / V tile is loaded once for G heads instead of G times.  One producer
//    thread streams Q and the K / V tiles of 64 keys by TMA (128-byte
//    swizzle, rows past the end zero-filled) through a ring of three
//    shared-memory stages, completion on mbarriers; each of one or two
//    consumer warpgroups owns 64 rows: S = Q K^T as wgmma m64n64k16 with
//    both operands in shared memory (exact products, f32 sums), the online
//    softmax on the f32 accumulators in registers, then O += P V as wgmma
//    m64nDk16 with P from registers in two bf16 terms (hi + lo), so that P.V
//    keeps ~16 bits of each weight (an f32 P.V up to 2^-17 of each term).
//    (Queueing the next tile's Q K^T behind P V measured slower: the
//    compiler then serializes the wgmmas.)  A short chunk, whose
//    128-row blocks would not fill the card, runs 64-row blocks.  Still
//    simple: no ping-pong schedule between the warpgroups, no overlap of a
//    tile's softmax with its own products.
//  * float32, unaligned bfloat16 or head_dim 32: float32 FMAs outside the tensor cores,
//    the first version.  Tiles of Q (pre-scaled by log2(e) / sqrt(D)), K and
//    V are staged in shared memory as float32; each of the 16 x 16 threads
//    owns 4 query rows and 4 keys of the score tile (float4 reads along D,
//    padded rows so the reads are free of bank conflicts) and 4 rows x D/16
//    columns of the output; P goes through shared memory between the two
//    products.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
#include <cuda.h>  // CUtensorMap (types only: the encoder comes through the runtime)
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
// bfloat16 on the tensor cores: warpgroup wgmma, one block per KV head, K/V
// tiles by TMA
namespace tc {

constexpr int BK = 64;      // keys per KV tile
constexpr int STAGES = 3;   // K/V ring depth
constexpr int SW = 128;     // bytes per swizzled row: 64 bf16 of one column panel

template <int D, int NWG>
struct Cfg {
  static constexpr int ROWS = 64 * NWG;             // block rows: G heads x P positions
  static constexpr int THREADS = 128 * NWG + 32;    // consumer warpgroups + one producer warp
  static constexpr int PANELS = D / 64;             // 64-column panels of a row
  static constexpr int Q_BYTES = PANELS * ROWS * SW;
  static constexpr int KV_BYTES = PANELS * BK * SW; // one K (or V) tile
  static constexpr int BAR = Q_BYTES + STAGES * 2 * KV_BYTES;  // mbarriers after the tiles
  static constexpr size_t BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive and expect `bytes` more from TMA copies before the phase completes
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one box of a 4-D / 5-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma4(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                     int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma5(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                     int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// smem matrix descriptor, 128-byte swizzle: start, leading and stride byte offsets
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }
// keep the compiler from moving reads or writes of v across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(v[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&v)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(v[i][j])::"memory");
}

// d (64 x 64) (+)= A (64 x 16, smem, K-major) . B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, registers) . B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A (64 x 16, registers) . B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n128(d, a, db);
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

// S = Q K^T for one warpgroup's 64 rows against a K tile of BK keys: Q and
// K in 64-column panels of 128-byte rows, 128-byte swizzled (K-major)
template <int D, int ROWS>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t qa, uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 16 columns into the panel's swizzled rows
    wgmma_ss_n64(s, desc(qa + (kk / 4) * ROWS * SW + off, 16, 1024),
                 desc(kt + (kk / 4) * BK * SW + off, 16, 1024), kk > 0);
  }
}

// The same function as the float32 kernel above.  A block owns (query tile,
// KV head, batch) and stacks that KV head's G query heads as its rows: row
// r holds head r / P at position q0 + r % P, P = ROWS / G.  Each K/V tile is
// thus loaded once for G heads.  One producer thread streams Q and then the
// K/V tiles of BK keys by TMA (tensor maps built per launch, 128-byte
// swizzle, rows past the end zero-filled) through a ring of STAGES
// shared-memory stages, completion on mbarriers; each consumer warpgroup
// owns 64 rows and runs S = Q K^T as wgmma m64nBKk16 from shared memory,
// the online softmax on the f32 accumulators in registers, and O += P V as
// wgmma m64nDk16 with P from registers, split into two bf16 terms (hi + lo)
// so that P.V keeps ~16 bits of each weight.
template <int D, int NWG>
__global__ void __launch_bounds__(Cfg<D, NWG>::THREADS, 1)
flash_wg_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                Strides os, int G, int Sq, int Skv, int causal, int window, int q_offset,
                float smul) {
  using C = Cfg<D, NWG>;
  constexpr int ROWS = C::ROWS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms are 1024-byte aligned
  const uint32_t Qs = base, KV = base + C::Q_BYTES;
  const uint32_t full = base + C::BAR, empty = full + STAGES * 8, qbar = empty + STAGES * 8;

  const int P = ROWS / G;  // query positions per block
  const int q0 = (gridDim.x - 1 - blockIdx.x) * P;  // longest causal rows first
  const int hkv = blockIdx.y, b = blockIdx.z;
  const int nq = min(P, Sq - q0);
  const int first = q_offset + q0, last = q_offset + q0 + nq - 1;
  int lo = 0, hi = Skv;  // the keys some row can see: the TPU kernel's block skip
  if (causal) hi = min(hi, last + 1);
  if (window > 0) lo = max(lo, first - window + 1);
  const int t0 = lo / BK, n = hi > lo ? (hi + BK - 1) / BK - t0 : 0;

  // warp and warpgroup indices broadcast from lane 0, so that the compiler
  // sees the role branch as warp-uniform (else it serializes the wgmmas)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x & 31;
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + 8 * s, 1);         // the producer's expect_tx, then the bytes
      bar_init(empty + 8 * s, 4 * NWG);  // every consumer warp
    }
    bar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == NWG) {  // ---- producer: the last warp
    if (lane == 0) {
      bar_expect(qbar, C::PANELS * G * P * SW);
      for (int p = 0; p < C::PANELS; ++p) tma5(Qs + p * ROWS * SW, &tq, qbar, 64 * p, q0, 0, hkv, b);
      for (int i = 0; i < n; ++i) {
        const int st = i % STAGES, k0 = (t0 + i) * BK;
        bar_wait(empty + 8 * st, ((i / STAGES) & 1) ^ 1);  // the consumers freed this stage
        bar_expect(full + 8 * st, 2 * C::KV_BYTES);
        const uint32_t kt = KV + 2 * st * C::KV_BYTES;
        for (int p = 0; p < C::PANELS; ++p) {
          tma4(kt + p * BK * SW, &tk, full + 8 * st, 64 * p, k0, hkv, b);
          tma4(kt + C::KV_BYTES + p * BK * SW, &tv, full + 8 * st, 64 * p, k0, hkv, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: wg owns block rows 64 wg .. 64 wg + 63
  const int wg = wgi, g = lane >> 2, t = lane & 3;
  const int row0 = 64 * wg + 16 * (warp % 4) + g;  // this thread's rows: row0, row0 + 8
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) qpos[r] = q_offset + q0 + (row0 + 8 * r) % P;
  if (G * P < ROWS) {  // rows no head fills: zero them for the products
    for (int e = threadIdx.x; e < C::PANELS * (ROWS - G * P) * (SW / 16); e += 128 * NWG) {
      const int per = (ROWS - G * P) * (SW / 16), p = e / per, r = G * P + (e % per) / (SW / 16);
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(Qs + p * ROWS * SW + r * SW +
                                                                      (e % (SW / 16)) * 16),
                   "r"(0)
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NWG) : "memory");
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const uint32_t qa = Qs + wg * 64 * SW;  // this warpgroup's 64 rows of panel 0
  bar_wait(qbar, 0);

  for (int i = 0; i < n; ++i) {
    const int st = i % STAGES, k0 = (t0 + i) * BK;
    const uint32_t kt = KV + 2 * st * C::KV_BYTES, vt = kt + C::KV_BYTES;
    bar_wait(full + 8 * st, (i / STAGES) & 1);
    float s[BK / 2];  // S = Q K^T: 64 rows x BK keys
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] = 0.f;
    fence_regs(s);
    wg_fence();
    issue_qk<D, ROWS>(s, qa, kt);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);

    // mask (only where the tile is not wholly visible to every row), then the
    // online softmax in base 2 for rows row0 (r = 0) and row0 + 8 (r = 1);
    // smul > 0 scales the scores inside the exponent
    const bool whole = k0 + BK <= Skv && (!causal || k0 + BK - 1 <= first) &&
                       (window <= 0 || last - k0 < window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!whole) {
          const int kpos = k0 + nt * 8 + 2 * t + (e & 1), p = qpos[e >> 1];
          const bool ok = kpos < Skv && (!causal || kpos <= p) && (window <= 0 || p - kpos < window);
          s[4 * nt + e] = ok ? s[4 * nt + e] : -INFINITY;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * nt + e]);
      }
    float mu[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r] * smul);
      mu[r] = mn == -INFINITY ? 0.f : mn;  // no valid key yet: p = 0
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = mn;
    }
    // P in two bf16 terms: the score accumulators of key blocks 2j, 2j + 1
    // are the A fragment of key step j
    uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e & 1;
        const float p0 = exp2f(fmaf(s[8 * j + 2 * e], smul, -mu[r]));
        const float p1 = exp2f(fmaf(s[8 * j + 2 * e + 1], smul, -mu[r]));
        sum[r] += p0 + p1;
        split(p0, p1, ph[j][e], pl[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

    // O += P V (V, keys x D, is MN-major: 8-key groups 1024 bytes apart,
    // panels BK * SW apart)
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint64_t dv = desc(vt + j * 16 * SW, BK * SW, 1024);
      wgmma_rs<D>(o, ph[j], dv);
      wgmma_rs<D>(o, pl[j], dv);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    __syncwarp();
    if (lane == 0) bar_arrive(empty + 8 * st);  // this warp is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r, hl = row / P, pos = q0 + row % P;
    if (hl < G && pos < Sq) {
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no valid key: 0
      __nv_bfloat16* ob = out + b * os.b + (hkv * G + hl) * os.h + static_cast<long long>(pos) * os.s;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<__nv_bfloat162*>(ob + dn * 8 + 2 * t) =
            __floats2bfloat162_rn(o[4 * dn + 2 * r] * inv, o[4 * dn + 2 * r + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that this library needs no link to libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor map: dims[0] = D (contiguous), strides (elements) of dims
// 1 .. rank-1, a box of 64 columns x box[1..]; 128-byte swizzle, zeros
// outside the tensor
bool make_map(CUtensorMap* map, const void* ptr, int rank, const long long* dims,
              const long long* strides, const int* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  cuuint64_t gd[5], gs[4];
  cuuint32_t bx[5], es[5];
  for (int i = 0; i < rank; ++i) {
    gd[i] = static_cast<cuuint64_t>(dims[i] > 0 ? dims[i] : 1);
    bx[i] = static_cast<cuuint32_t>(box[i]);
    es[i] = 1;
  }
  for (int i = 0; i + 1 < rank; ++i) gs[i] = static_cast<cuuint64_t>(strides[i]) * 2;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), gd, gs, bx, es,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int NWG>
int launch(const void* q, const void* k, const void* v, void* out, Strides qs, Strides ks,
           Strides vs, Strides os, int B, int Hkv, int G, int Sq, int Skv, int causal, int window,
           int q_offset, cudaStream_t stream) {
  using C = Cfg<D, NWG>;
  const int P = C::ROWS / G;
  // q as (D, Sq, G, Hkv, B): a box is the P positions x G heads of a block
  const long long qd[5] = {D, Sq, G, Hkv, B}, qst[4] = {qs.s, qs.h, qs.h * G, qs.b};
  const int qb[5] = {64, P, G, 1, 1};
  const long long kd[4] = {D, Skv, Hkv, B}, kst[3] = {ks.s, ks.h, ks.b}, vst[3] = {vs.s, vs.h, vs.b};
  const int kb[4] = {64, BK, 1, 1};
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, 5, qd, qst, qb) || !make_map(&tk, k, 4, kd, kst, kb) ||
      !make_map(&tv, v, 4, kd, vst, kb))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(flash_wg_kernel<D, NWG>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(C::BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + P - 1) / P, Hkv, B);
  flash_wg_kernel<D, NWG><<<grid, C::THREADS, C::BYTES, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), os, G, Sq, Skv, causal, window, q_offset,
      LOG2E / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// Two consumer warpgroups (128 rows) unless that leaves fewer blocks than the
// card has SMs (a short chunk): then one (64 rows), twice the blocks.
template <int D>
int launch_nwg(const void* q, const void* k, const void* v, void* out, Strides qs, Strides ks,
               Strides vs, Strides os, int B, int Hkv, int G, int Sq, int Skv, int causal,
               int window, int q_offset, cudaStream_t stream) {
  const long long blocks2 = static_cast<long long>((Sq + 128 / G - 1) / (128 / G)) * Hkv * B;
  if (blocks2 < 132)
    return launch<D, 1>(q, k, v, out, qs, ks, vs, os, B, Hkv, G, Sq, Skv, causal, window, q_offset, stream);
  return launch<D, 2>(q, k, v, out, qs, ks, vs, os, B, Hkv, G, Sq, Skv, causal, window, q_offset, stream);
}

// the wgmma instance: bfloat16 rows of 64 or 128, at most 64 query heads per
// KV head, and 16-byte rows (every base and every batch / head / row stride
// a multiple of 8 bf16, as TMA and the paired output stores need)
bool takes(int D, int G, const void* q, const void* k, const void* v, const void* out,
           const Strides (&st)[4]) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  long long m = 0;
  for (const Strides& s : st) m |= s.b | s.h | s.s;
  return (D == 64 || D == 128) && G <= 64 && p % 16 == 0 && m % 8 == 0;
}

int launch_d(const void* q, const void* k, const void* v, void* out, Strides qs, Strides ks,
             Strides vs, Strides os, int B, int Hkv, int G, int Sq, int Skv, int D, int causal,
             int window, int q_offset, cudaStream_t stream) {
  if (D == 64)
    return launch_nwg<64>(q, k, v, out, qs, ks, vs, os, B, Hkv, G, Sq, Skv, causal, window, q_offset, stream);
  return launch_nwg<128>(q, k, v, out, qs, ks, vs, os, B, Hkv, G, Sq, Skv, causal, window, q_offset, stream);
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
      if (tc::takes(D, G, q, k, v, out, all))
        return tc::launch_d(q, k, v, out, qs, ks, vs, os, B, Hkv, G, Sq, Skv, D, causal, window, q_offset, st);
      return launch_d<__nv_bfloat16>(q, k, v, out, qs, ks, vs, os, B, H, G, Sq, Skv, D, causal, window, q_offset, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
