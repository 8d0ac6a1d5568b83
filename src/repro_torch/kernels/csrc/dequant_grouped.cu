// Grouped HQQ dequantize x matmul on the tensor cores for Hopper (sm_90a),
// over ragged row groups, with a plain C interface.
//
// Replaces the TPU kernel dequant_matmul_batched_pallas
// (src/repro/kernels/dequant_matmul.py:109) for bfloat16 activations: the
// rows of a prefill chunk, sorted by the expert they were routed to, each
// group multiplied by its own expert's packed weight record:
//
//   out[r, n] = sum_k x[r, k] * W_u[k, n]     for offsets[u] <= r < offsets[u + 1]
//   W_u[k, n] = (code_u[k, n] - zero_u[k/g, n]) * scale_u[k/g, n]
//
// with scale/zero de-meta-quantized from their stored uint8 codes and float16
// meta, as in csrc/dequant_matmul.cu.  No group is padded: a group of c rows
// costs ceil(c / BM) row tiles.
//
// What bounds it: at the main path's prefill (8 experts of ~16 rows, 2-bit)
// bytes, since each stored weight byte feeds ~16 rows; at a long prompt
// (~1000 rows per expert) operations.  The design:
//
//  * One block owns (expert u, a tile of BM rows of its group, 128 columns).
//    BM (16, 32 or 64) is chosen per launch from the group sizes, so that the
//    main path's ~16-row groups run 16-row tiles.  Blocks past their group's
//    end return at once.
//  * The block streams its columns' packed codes, uint8 scale/zero and x
//    through a ring of shared-memory stages of 256 k (128 at 64-row tiles;
//    cp.async, 16 bytes a thread), so every weight byte is read once per
//    row tile: once in total where a group fits one tile.  Each stage's
//    scales and zeros are de-meta-quantized once, by the whole block, into
//    shared memory as (scale, scale * zero) pairs.
//  * Integer codes (0 ... 2^bits - 1) are exact in bfloat16 and products of
//    two bfloat16 values are exact in float32.  So the tensor cores
//    (mma.sync m16n8k16, float32 accumulate) compute each k16 step's raw
//    products P[m, n] = sum_k x[m, k] code[k, n] and, through a column of
//    ones, S[m] = sum_k x[m, k]; the step's group's scale and zero are then
//    applied in float32: acc += scale * P - scale * zero * S.  This
//    reassociates the reference's (code - zero) * scale product; only the
//    float32 summation order differs.
//  * The B fragments are built in registers straight from the packed bytes:
//    k and n are permuted consistently in A, B and the output so that each
//    thread's four k values of a step are one packed byte (2-bit) and its
//    eight columns are eight neighbouring bytes, read as two 4-byte words.
//    A code c becomes the bfloat16 128 + c by a byte permutation, minus 128
//    in bfloat16 (exact); 8-bit codes convert through float32.  Each
//    n-tile's products are scaled as soon as they are made, which keeps the
//    live registers within two blocks per SM.
//  * Eight warps: two along the 128 columns, the rest over the row tile's
//    m16 tiles and the stage's four k16 steps; partial sums over k meet in
//    shared memory at the end, and the output is written once, coalesced.
//
// Scope: bfloat16 x, N a multiple of 64, K a multiple of 256, group sizes
// 16 (2-bit) and 64 (3/4/8-bit), meta groups of a multiple of 256 / group
// size groups (as hqq.quantize makes them), at most 256 row groups.  float32 x runs the
// FMA kernel of csrc/dequant_matmul.cu.  Launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_GROUPS = 256;
struct Offsets {
  int v[MAX_GROUPS + 1];  // row offsets of the groups, passed by value
};

constexpr int BN = 128;            // columns per block: two warps of 64
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROW = 160;           // smem bytes per 128-byte code row: +32 keeps the 8-byte fragment reads free of bank conflicts
constexpr int SROW = 8 * 36;       // floats per group of decoded (scale, scale * zero): 16 columns in 36 floats, conflict-free
constexpr int SMEM_SM = 227 * 1024;  // shared memory a Hopper SM gives its blocks
constexpr uint32_t K43 = 0x43434343u;      // bfloat16 0x43cc = 128 + cc for cc < 128
constexpr uint32_t B128X2 = 0x43004300u;   // bfloat16 pair (128, 128)
constexpr uint32_t ONE2 = 0x3f803f80u;     // bfloat16 pair (1, 1)

struct Leaves {
  const uint8_t* packed;  long long packed_stride;  // per record, in elements
  const uint8_t* scale;   long long scale_stride;
  const uint8_t* zero;    long long zero_stride;
  const __half* s_scale;
  const __half* s_min;
  const __half* z_scale;
  const __half* z_min;    long long meta_stride;
};

template <int BITS, int GS, int BM>
struct Cfg {
  static constexpr int KS = BM == 64 ? 128 : 256;  // k per pipeline stage
  static constexpr int MT = BM / 16;              // m16 tiles of a row tile
  static constexpr int KW = 4 / MT;               // warps over a stage's k16 steps
  static constexpr int STEPS = KS / 16 / KW;      // k16 steps per warp per stage
  static constexpr int XROW = 2 * KS + 32;        // smem bytes per x row (+32: conflict-free)
  static constexpr int CODE_ROWS = KS * BITS / 8; // packed byte rows per stage
  static constexpr int NG = KS / GS;              // quantization groups per stage
  static constexpr int CODE_BYTES = CODE_ROWS * ROW;
  static constexpr int SZ_BYTES = NG * BN;
  static constexpr int X_BYTES = BM * XROW;
  static constexpr int STAGE = CODE_BYTES + 2 * SZ_BYTES + X_BYTES;
  static constexpr int SBUF = NG * SROW * 4;      // the stage's decoded scales
  // ring depth: as deep as two blocks per SM allow, 2 to 4 stages
  static constexpr int NST = 2 * (4 * STAGE + SBUF) <= SMEM_SM - 4096 ? 4
                             : 2 * (3 * STAGE + SBUF) <= SMEM_SM - 4096 ? 3 : 2;
  static constexpr int RING = NST * STAGE;
  static constexpr int RED = KW * BM * BN * 4;    // the final sum over k
  static constexpr int MAIN = RING > RED ? RING : RED;
  static constexpr size_t BYTES = MAIN + SBUF;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// c += a (16 x 16, row) . b (16 x 8, col), bfloat16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bfloat16 pairs (128 + c0, 128 + c1) -> (c0, c1), exact
__device__ __forceinline__ uint32_t minus128(uint32_t v) {
  __nv_bfloat162 a, b;
  *reinterpret_cast<uint32_t*>(&a) = v;
  *reinterpret_cast<uint32_t*>(&b) = B128X2;
  const __nv_bfloat162 r = __hsub2(a, b);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// lo/hi hold one small code per byte for four columns; out[c] = bfloat16
// pair (lo.byte c, hi.byte c) for column c
__device__ __forceinline__ void pairs4(uint32_t lo, uint32_t hi, uint32_t* out, int stride) {
  const uint32_t a = __byte_perm(lo, hi, 0x5140);  // lo0 hi0 lo1 hi1
  const uint32_t b = __byte_perm(lo, hi, 0x7362);  // lo2 hi2 lo3 hi3
  out[0] = minus128(__byte_perm(a, K43, 0x4140));
  out[stride] = minus128(__byte_perm(a, K43, 0x4342));
  out[2 * stride] = minus128(__byte_perm(b, K43, 0x4140));
  out[3 * stride] = minus128(__byte_perm(b, K43, 0x4342));
}

__device__ __forceinline__ uint32_t bf16_pair(uint32_t c0, uint32_t c1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(c0), static_cast<float>(c1));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The B fragments of k16 step s of a stage for the thread (g, t), for the
// four columns c of word h of its eight (bytes cb + 4h .. cb + 4h + 3 of a
// row): b[c][0] = codes (k 4t, 4t+1) and b[c][1] = codes (4t+2, 4t+3), k
// relative to the step.
template <int BITS, int GS>
__device__ __forceinline__ void codes_b(const unsigned char* codes, int s, int t, int cb,
                                        uint32_t (&b)[4][2]) {
  uint32_t* f = &b[0][0];
  if constexpr (BITS == 2) {  // byte row 4s + t holds the four codes
    const uint32_t w = *reinterpret_cast<const uint32_t*>(codes + (4 * s + t) * ROW + cb);
    const uint32_t m = 0x03030303u;
    pairs4(w & m, (w >> 2) & m, f, 2);
    pairs4((w >> 4) & m, (w >> 6) & m, f + 1, 2);
  } else if constexpr (BITS == 4) {  // byte rows 8s + 2t (+1), low nibble first
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(codes + (8 * s + 2 * t) * ROW + cb);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(codes + (8 * s + 2 * t + 1) * ROW + cb);
    const uint32_t m = 0x0f0f0f0fu;
    pairs4(w0 & m, (w0 >> 4) & m, f, 2);
    pairs4(w1 & m, (w1 >> 4) & m, f + 1, 2);
  } else if constexpr (BITS == 8) {  // byte rows 16s + 4t + i
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *reinterpret_cast<const uint32_t*>(codes + (16 * s + 4 * t + i) * ROW + cb);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      b[c][0] = bf16_pair((w[0] >> (8 * c)) & 0xffu, (w[1] >> (8 * c)) & 0xffu);
      b[c][1] = bf16_pair((w[2] >> (8 * c)) & 0xffu, (w[3] >> (8 * c)) & 0xffu);
    }
  } else {  // 3-bit, planar: unit j of a group holds codes 8j .. 8j+7 in
            // bytes (plane 0, 1, 2) at rows j, n8 + j, 2 n8 + j of the group
    constexpr int N8 = GS / 8;
    const int gi = (16 * s) / GS, unit = ((16 * s) % GS) / 8 + (t >> 1);
    const unsigned char* base = codes + (gi * 3 * N8 + unit) * ROW + cb;
    const uint32_t p0 = *reinterpret_cast<const uint32_t*>(base);
    const uint32_t p1 = *reinterpret_cast<const uint32_t*>(base + N8 * ROW);
    const uint32_t p2 = *reinterpret_cast<const uint32_t*>(base + 2 * N8 * ROW);
    const int sh0 = 12 * (t & 1);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int sh = 8 * c;
      const uint32_t word = (p0 >> sh & 0xffu) | (p1 >> sh & 0xffu) << 8 | (p2 >> sh & 0xffu) << 16;
      const uint32_t q = word >> sh0;
      b[c][0] = minus128(B128X2 | (q & 7u) | ((q >> 3) & 7u) << 16);
      b[c][1] = minus128(B128X2 | ((q >> 6) & 7u) | ((q >> 9) & 7u) << 16);
    }
  }
}

__device__ __forceinline__ float u8f(uint32_t v) {  // exact for v < 2^23
  return __int_as_float(0x4B000000 | v) - 8388608.f;
}

template <int BITS, int GS, int BM>
__global__ void __launch_bounds__(THREADS, 2)
dequant_grouped_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ out, const Offsets off,
               const Leaves w, int K, int N, int sg) {
  using C = Cfg<BITS, GS, BM>;
  constexpr int KS = C::KS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int u = blockIdx.z;
  const int r0 = off.v[u] + blockIdx.y * BM;
  const int nrows = min(BM, off.v[u + 1] - r0);
  if (nrows <= 0) return;  // past this group's end
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp & 1, wm = (warp >> 1) % C::MT, wk = (warp >> 1) / C::MT;
  const long long su = u;
  const uint8_t* P = w.packed + su * w.packed_stride;
  const uint8_t* QS = w.scale + su * w.scale_stride;
  const uint8_t* QZ = w.zero + su * w.zero_stride;
  const __half* SS = w.s_scale + su * w.meta_stride;
  const __half* SM = w.s_min + su * w.meta_stride;
  const __half* ZS = w.z_scale + su * w.meta_stride;
  const __half* ZM = w.z_min + su * w.meta_stride;
  const int NK = K / KS;
  float* sbuf = reinterpret_cast<float*>(smem + C::MAIN);

  // this thread's cp.async chunks: fixed offsets, advanced per stage.  Code
  // and scale rows: 16-byte column chunk c8 of rows r8, r8 + 32, ...; x:
  // chunk xc of rows xm, xm + THREADS / XCH, ...
  constexpr int XCH = KS / 8;  // 16-byte chunks per x row of a stage
  const int c8 = tid & 7, r8 = tid >> 3;
  const bool c8_ok = n0 + 16 * c8 < N;
  const int col8 = n0 + (c8_ok ? 16 * c8 : 0);
  const uint8_t* pcode = P + static_cast<long long>(r8) * N + col8;
  const long long pscale = static_cast<long long>(r8) * N + col8;
  const int xm = tid / XCH, xc = tid % XCH;
  const __nv_bfloat16* px = x + static_cast<long long>(r0) * K + 8 * xc;
  auto load_stage = [&](int kt) {
    unsigned char* base = smem + (kt % C::NST) * C::STAGE;
    const long long crow = static_cast<long long>(kt) * C::CODE_ROWS * N;
#pragma unroll
    for (int i = 0; i < (C::CODE_ROWS + 31) / 32; ++i)
      if (C::CODE_ROWS % 32 == 0 || r8 + 32 * i < C::CODE_ROWS)
        cp_async16(base + (r8 + 32 * i) * ROW + 16 * c8, pcode + crow + 32 * i * N, c8_ok);
    if (r8 < C::NG) {  // NG <= 16
      const long long srow = pscale + static_cast<long long>(kt) * C::NG * N;
      cp_async16(base + C::CODE_BYTES + r8 * BN + 16 * c8, QS + srow, c8_ok);
      cp_async16(base + C::CODE_BYTES + C::SZ_BYTES + r8 * BN + 16 * c8, QZ + srow, c8_ok);
    }
#pragma unroll
    for (int i = 0; i < BM * XCH / THREADS; ++i) {
      const int m = xm + (THREADS / XCH) * i;
      const bool ok = m < nrows;
      cp_async16(base + C::CODE_BYTES + 2 * C::SZ_BYTES + m * C::XROW + 16 * xc,
                 px + (ok ? m : 0) * K + kt * KS, ok);
    }
  };

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // the scale decode: this thread's column and every second group of a stage
  // (a stage's groups share one meta row: sg % NG == 0)
  const int dc = tid & (BN - 1), dg = tid >> 7;
  const bool dc_ok = n0 + dc < N;
  const long long dcol = n0 + (dc_ok ? dc : 0);
  const int dq = dg * BN + dc;                                     // its scale byte in a stage
  const int ds = dg * SROW + (dc >> 4) * 36 + (dc & 15) * 2;        // its (scale, scale * zero)
  int mrow = -1;
  float mss = 0.f, msm = 0.f, mzs = 0.f, mzm = 0.f;

#pragma unroll 1
  for (int s = 0; s < C::NST - 1; ++s) {
    if (s < NK) load_stage(s);
    cp_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < NK; ++kt) {
    cp_wait<C::NST - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt - 1 and the scales are free
    if (kt + C::NST - 1 < NK) load_stage(kt + C::NST - 1);
    cp_commit();
    const unsigned char* codes = smem + (kt % C::NST) * C::STAGE;
    const unsigned char* qs = codes + C::CODE_BYTES;
    const unsigned char* qz = qs + C::SZ_BYTES;
    const unsigned char* xs = qz + C::SZ_BYTES;
    // scale and scale * zero of the stage's groups, de-meta-quantized once per block
    const int mr = kt * C::NG / sg;
    if (mr != mrow) {
      mrow = mr;
      const long long mi = static_cast<long long>(mr) * N + dcol;
      mss = __half2float(SS[mi]);
      msm = __half2float(SM[mi]);
      mzs = __half2float(ZS[mi]);
      mzm = __half2float(ZM[mi]);
    }
#pragma unroll
    for (int gi = 0; gi < C::NG; gi += 2) {
      if (C::NG % 2 == 0 || gi + dg < C::NG) {
        const float sc = __fadd_rn(__fmul_rn(u8f(qs[gi * BN + dq]), mss), msm);
        const float zr = __fadd_rn(__fmul_rn(u8f(qz[gi * BN + dq]), mzs), mzm);
        *reinterpret_cast<float2*>(sbuf + gi * SROW + ds) = make_float2(sc, sc * zr);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < C::STEPS; ++i) {
      const int s = wk + C::KW * i;  // this warp's k16 step of the stage
      // A: rows wm*16 + g and + 8, k 4t .. 4t+3 of the step (the k permutation)
      const uint2 xa = *reinterpret_cast<const uint2*>(xs + (wm * 16 + g) * C::XROW + (16 * s + 4 * t) * 2);
      const uint2 xb = *reinterpret_cast<const uint2*>(xs + (wm * 16 + g + 8) * C::XROW + (16 * s + 4 * t) * 2);
      const uint32_t a[4] = {xa.x, xb.x, xa.y, xb.y};
      float xsum[4] = {0.f, 0.f, 0.f, 0.f};
      mma(xsum, a, ONE2, ONE2);  // row sums of x over the step
      // this thread's output columns are 16t + j and 16t + 8 + j of n-tile j
      // (of the warp's 64): (scale, scale * zero) of the step's group; each
      // n-tile's products are scaled as soon as they are made
      const float* sz = sbuf + ((16 * s) / GS) * SROW + (wn * 4 + t) * 36;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t b[4][2];
        codes_b<BITS, GS>(codes, s, t, wn * 64 + 8 * g + 4 * h, b);
#pragma unroll
        for (int c = 0; c < 4; c += 2) {
          const int j = 4 * h + c;
          const float4 lo = *reinterpret_cast<const float4*>(sz + 2 * j);
          const float4 hi = *reinterpret_cast<const float4*>(sz + 16 + 2 * j);
          float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
          mma(p0, a, b[c][0], b[c][1]);
          mma(p1, a, b[c + 1][0], b[c + 1][1]);
          acc[j][0] = fmaf(lo.x, p0[0], fmaf(-lo.y, xsum[0], acc[j][0]));
          acc[j][1] = fmaf(hi.x, p0[1], fmaf(-hi.y, xsum[0], acc[j][1]));
          acc[j][2] = fmaf(lo.x, p0[2], fmaf(-lo.y, xsum[2], acc[j][2]));
          acc[j][3] = fmaf(hi.x, p0[3], fmaf(-hi.y, xsum[2], acc[j][3]));
          acc[j + 1][0] = fmaf(lo.z, p1[0], fmaf(-lo.w, xsum[0], acc[j + 1][0]));
          acc[j + 1][1] = fmaf(hi.z, p1[1], fmaf(-hi.w, xsum[0], acc[j + 1][1]));
          acc[j + 1][2] = fmaf(lo.z, p1[2], fmaf(-lo.w, xsum[2], acc[j + 1][2]));
          acc[j + 1][3] = fmaf(hi.z, p1[3], fmaf(-hi.w, xsum[2], acc[j + 1][3]));
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it holds the sum over k now

  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = wm * 16 + g + 8 * (e >> 1);
      const int c = wn * 64 + 16 * t + 8 * (e & 1) + j;
      red[(wk * BM + row) * BN + c] = acc[j][e];
    }
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int m = e / BN, c = e % BN;
    if (m < nrows && n0 + c < N) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < C::KW; ++q) sum += red[(q * BM + m) * BN + c];
      out[static_cast<long long>(r0 + m) * N + n0 + c] = sum;
    }
  }
}

template <int BITS, int GS, int BM>
int launch(const __nv_bfloat16* x, float* out, const Offsets& off, const Leaves& w, int U,
           int max_rows, int K, int N, int sg, cudaStream_t stream) {
  using C = Cfg<BITS, GS, BM>;
  const cudaError_t e = cudaFuncSetAttribute(dequant_grouped_kernel<BITS, GS, BM>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(C::BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + BN - 1) / BN, (max_rows + BM - 1) / BM, U);
  dequant_grouped_kernel<BITS, GS, BM><<<grid, THREADS, C::BYTES, stream>>>(x, out, off, w, K, N, sg);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, int GS>
int launch_bm(int bm, const __nv_bfloat16* x, float* out, const Offsets& off, const Leaves& w,
              int U, int max_rows, int K, int N, int sg, cudaStream_t st) {
  switch (bm) {
    case 16: return launch<BITS, GS, 16>(x, out, off, w, U, max_rows, K, N, sg, st);
    case 32: return launch<BITS, GS, 32>(x, out, off, w, U, max_rows, K, N, sg, st);
    default: return launch<BITS, GS, 64>(x, out, off, w, U, max_rows, K, N, sg, st);
  }
}

// The row tile: fewest launched rows, a tile's weight read counted as 16
// more rows (at 16 rows the kernel's arithmetic and its bytes take about
// as long), so small groups take 16-row tiles and large ones 64.
int pick_bm(const Offsets& off, int U) {
  const int bms[3] = {16, 32, 64};
  int best = 16;
  long long best_cost = -1;
  for (int bm : bms) {
    long long cost = 0;
    for (int u = 0; u < U; ++u) cost += static_cast<long long>((off.v[u + 1] - off.v[u] + bm - 1) / bm) * (bm + 16);
    if (best_cost < 0 || cost < best_cost) best = bm, best_cost = cost;
  }
  return best;
}

}  // namespace

// x: (R, K) bfloat16 contiguous, rows sorted by group; offsets: U + 1 row
// offsets in host memory (offsets[0] = 0, offsets[U] = R); out: (R, N)
// float32.  Group u reads weight record u, each leaf a per-record contiguous
// block at base + u * stride (strides in elements of the leaf's type):
// packed (G, g*bits/8, N) u8, scale/zero (G, N) u8, meta (G/sg, N) f16.
// Returns the row tile it launched (16, 32, 64) through *bm_out.
extern "C" int dequant_grouped(const void* x, float* out, const int* offsets, int U, int K, int N,
                               int bits, int group_size, int scale_group, const uint8_t* packed,
                               long long packed_stride, const uint8_t* scale,
                               long long scale_stride, const uint8_t* zero, long long zero_stride,
                               const void* s_scale, const void* s_min, const void* z_scale,
                               const void* z_min, long long meta_stride, int* bm_out,
                               void* stream) {
  if (U <= 0 || U > MAX_GROUPS || K <= 0 || K % 256 || N <= 0 || N % 64 || scale_group <= 0 ||
      (K / group_size) % scale_group)
    return static_cast<int>(cudaErrorInvalidValue);
  // a stage's groups (256 / group_size of them at most) share one meta row
  if (group_size != (bits == 2 ? 16 : 64) || scale_group % (256 / group_size))
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets off;
  int max_rows = 0;
  off.v[0] = offsets[0];
  if (off.v[0] != 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int u = 0; u < U; ++u) {
    off.v[u + 1] = offsets[u + 1];
    const int c = off.v[u + 1] - off.v[u];
    if (c < 0) return static_cast<int>(cudaErrorInvalidValue);
    max_rows = c > max_rows ? c : max_rows;
  }
  if (max_rows == 0) return 0;
  if ((max_rows + 15) / 16 > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Leaves w{packed, packed_stride, scale, scale_stride, zero, zero_stride,
                 static_cast<const __half*>(s_scale), static_cast<const __half*>(s_min),
                 static_cast<const __half*>(z_scale), static_cast<const __half*>(z_min),
                 meta_stride};
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bm = pick_bm(off, U);
  if (bm_out) *bm_out = bm;
  switch (bits) {
    case 2: return launch_bm<2, 16>(bm, xb, out, off, w, U, max_rows, K, N, scale_group, st);
    case 3: return launch_bm<3, 64>(bm, xb, out, off, w, U, max_rows, K, N, scale_group, st);
    case 4: return launch_bm<4, 64>(bm, xb, out, off, w, U, max_rows, K, N, scale_group, st);
    case 8: return launch_bm<8, 64>(bm, xb, out, off, w, U, max_rows, K, N, scale_group, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
