// HQQ dequantize x matmul for decode (at most 8 x rows per record) on the
// tensor cores of Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernels dequant_matmul_slots_pallas
// (src/repro/kernels/dequant_matmul.py:145) and dequant_matmul_pallas (:57,
// as the slot b = b case) for bfloat16 activations:
//
//   out[b, m, n] = sum_k x[b, m, k] * W_s[k, n],   s = slots[b] (or b)
//   W_s[k, n]    = (code_s[k, n] - zero_s[k/g, n]) * scale_s[k/g, n]
//
// with scale/zero de-meta-quantized from their stored uint8 codes and
// float16 meta (src/repro/quant/hqq.py:194).  The weights are read where
// they lie: a record of the pool (or of its overflow tier) through the
// per-leaf slot stride.
//
// What bounds it: bytes.  At decode every stored weight byte feeds M <= 8
// multiply-adds, so the floor is the records' bytes over the memory rate,
// and the budget is a few instructions per weight.  The design:
//
//  * "Swap AB" on mma.sync m16n8k16: 16 output columns are the m16 rows of
//    A, built in registers from the packed codes; the record's x rows are
//    the n8 columns of B.
//  * No int-to-float conversion per weight.  Integer codes are exact in
//    bfloat16 and products of two bfloat16 values exact in float32, so the
//    tensor cores multiply x by the raw codes.  A code c < 128 becomes the
//    bfloat16 128 + c by a byte permutation (0x43cc), minus 128 in
//    bfloat16 (exact); an 8-bit code is two nibbles, lo + 16 hi, the high
//    one as 2048 + 16 hi (0x45hh) minus 2048.  k and n are permuted
//    consistently in A, B and the output: thread (g, t) owns the 16
//    neighbouring columns 16g .. 16g + 15 (one 16-byte read of a code row)
//    and the four k values 4t .. 4t + 3 of a k16 step (one packed byte at
//    2 bits).
//  * Scale and zero once per (group, column), in float32: the group's raw
//    products P = sum x code and row sums S = sum x (an mma with a ones
//    A operand) are combined as acc += s P - s z S, the reference's
//    (code - zero) * scale reassociated; only the float32 summation order
//    differs.  Each (group, column) is de-meta-quantized once per stage, by
//    one lane, into shared memory; the meta is read once per meta group.
//    At one x row and 2 bits (a group is one k16 step) step s puts x in B
//    column s, so a stage's four groups land in four columns of one
//    accumulator and are scaled together, once per stage instead of once
//    per step; 3/4/8-bit groups (64) span a stage's four steps anyway.
//  * Streaming: each warp owns a contiguous run of 64-k stages and streams
//    its codes, uint8 scale/zero and x rows through its own cp.async ring
//    (2 stages at 2 bits, 3 otherwise; 16-byte copies from fixed per-lane
//    offsets), 3 blocks (12 warps) per SM.
//  * Filling the card: K is split over the 4 warps of a block and, where
//    the column tiles alone are fewer than the SMs, over the 2 blocks of a
//    thread block cluster (the caller picks 1 or 2 from K and N only).
//    Partial sums meet in a fixed order: the block's warps through shared
//    memory, then the cluster's blocks through distributed shared memory,
//    each rank summing a slice of the columns over ranks 0 .. CL-1.  No
//    workspace, no atomics, and each output row comes out the same
//    whatever B and the slot map are.
//
// What still limits it (times in PERF.md): the loads alone and the math
// alone each take most of the kernel's time; more bytes in flight or more
// warps per SM did not help.
//
// Scope: bfloat16 x, 1 <= M <= 8 rows per record, K a multiple of 64, N of
// 16, group sizes 16 (2-bit) and 64 (3/4/8-bit), meta groups of a
// multiple of 64 / group size groups, 16-byte aligned leaves and records.
// Everything else runs the FMA kernel of csrc/dequant_matmul.cu.  Launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 3;  // blocks per SM the registers must allow (12 warps)
constexpr int BN = 128;     // columns per block: 16 per thread row g
constexpr int KS = 64;      // k per pipeline stage
constexpr int MMAX = 8;     // x rows per record
constexpr int ROW = 160;    // smem bytes per 128-byte code row: +32 keeps the fragment reads conflict-free
constexpr int XROW = 160;   // smem bytes per x row of a stage (64 bf16 + 32)
constexpr int DROW = 146;   // float2 (scale, scale * zero) per group: 16 columns in 18 slots, +2 between groups
constexpr uint32_t K43 = 0x43434343u;     // bfloat16 0x43cc = 128 + cc
constexpr uint32_t B128X2 = 0x43004300u;  // bfloat16 pair (128, 128)
constexpr uint32_t K45 = 0x45454545u;     // bfloat16 0x45hh = 2048 + 16 hh
constexpr uint32_t B2048X2 = 0x45004500u; // bfloat16 pair (2048, 2048)
constexpr uint32_t ONE2 = 0x3f803f80u;    // bfloat16 pair (1, 1)

struct Leaves {
  const uint8_t* packed;  long long packed_stride;  // per record, in elements
  const uint8_t* scale;   long long scale_stride;
  const uint8_t* zero;    long long zero_stride;
  const __half* s_scale;
  const __half* s_min;
  const __half* z_scale;
  const __half* z_min;    long long meta_stride;
};

template <int BITS>
struct Cfg {
  static constexpr int GS = BITS == 2 ? 16 : 64;
  static constexpr int NG = KS / GS;            // groups per stage
  static constexpr int SPG = GS / 16;           // k16 steps per group
  static constexpr int CODE_ROWS = KS * BITS / 8;
  static constexpr int CODE = CODE_ROWS * ROW;
  static constexpr int SZ = NG * BN;            // a stage's scale bytes (zero the same)
  static constexpr int X = MMAX * XROW;
  static constexpr int STAGE = CODE + 2 * SZ + X;
  static constexpr int NST = BITS == 2 ? 2 : 3;  // cp.async stages: 3 blocks per SM fit
  static constexpr int DEC = NG * DROW * 8;      // the stage's decoded scales
  static constexpr int WARP_BYTES = NST * STAGE + DEC;
  static constexpr int RED = (WARPS + 1) * MMAX * BN * 4;  // per-warp sums, then the block's
  static constexpr int BYTES = WARPS * WARP_BYTES > RED ? WARPS * WARP_BYTES : RED;
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
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bsub(uint32_t v, uint32_t sub) {  // bfloat16 pairs, exact here
  __nv_bfloat162 a, b;
  *reinterpret_cast<uint32_t*>(&a) = v;
  *reinterpret_cast<uint32_t*>(&b) = sub;
  const __nv_bfloat162 r = __hsub2(a, b);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// lo/hi hold one small code per byte for four columns; o[c] = bfloat16 pair
// (lo.byte c, hi.byte c) scaled by the magic's power (1 or 16)
template <uint32_t MAGIC, uint32_t SUB>
__device__ __forceinline__ void pairs4(uint32_t lo, uint32_t hi, uint32_t (&o)[4]) {
  const uint32_t a = __byte_perm(lo, hi, 0x5140);  // lo0 hi0 lo1 hi1
  const uint32_t b = __byte_perm(lo, hi, 0x7362);  // lo2 hi2 lo3 hi3
  o[0] = bsub(__byte_perm(a, MAGIC, 0x4140), SUB);
  o[1] = bsub(__byte_perm(a, MAGIC, 0x4342), SUB);
  o[2] = bsub(__byte_perm(b, MAGIC, 0x4140), SUB);
  o[3] = bsub(__byte_perm(b, MAGIC, 0x4342), SUB);
}

// Word h of the thread's 16 code bytes holds columns 16g + 4h .. + 3, which
// are rows g / g + 8 of n-tiles 2h and 2h + 1.  u0..u3 hold, per column
// byte, the codes of k 4t .. 4t + 3; their A fragments go to a[2h], a[2h+1].
template <uint32_t MAGIC, uint32_t SUB>
__device__ __forceinline__ void place(uint32_t u0, uint32_t u1, uint32_t u2, uint32_t u3, int h,
                                      uint32_t (&a)[8][4]) {
  uint32_t o[4];
  pairs4<MAGIC, SUB>(u0, u1, o);
  a[2 * h][0] = o[0]; a[2 * h][1] = o[1]; a[2 * h + 1][0] = o[2]; a[2 * h + 1][1] = o[3];
  pairs4<MAGIC, SUB>(u2, u3, o);
  a[2 * h][2] = o[0]; a[2 * h][3] = o[1]; a[2 * h + 1][2] = o[2]; a[2 * h + 1][3] = o[3];
}

__device__ __forceinline__ uint4 lds128(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint32_t word(const uint4& v, int h) {
  return h == 0 ? v.x : h == 1 ? v.y : h == 2 ? v.z : v.w;
}

// k16 step s of a stage: A fragments of the thread's 8 n-tiles from the
// stage's code rows, each multiplied into p with the x fragment (b0, b1)
template <int BITS>
__device__ __forceinline__ void step_mma(const unsigned char* codes, int s, int g, int t,
                                         uint32_t b0, uint32_t b1, float (&p)[8][4]) {
  uint32_t a[8][4];
  if constexpr (BITS == 2) {  // byte row 4s + t: codes k 4t .. 4t+3 at bits 0, 2, 4, 6
    const uint4 w = lds128(codes + (4 * s + t) * ROW + 16 * g);
    const uint32_t m = 0x03030303u;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const uint32_t v = word(w, h);
      place<K43, B128X2>(v & m, (v >> 2) & m, (v >> 4) & m, (v >> 6) & m, h, a);
    }
  } else if constexpr (BITS == 4) {  // byte rows 8s + 2t (+1), low nibble first
    const uint4 w0 = lds128(codes + (8 * s + 2 * t) * ROW + 16 * g);
    const uint4 w1 = lds128(codes + (8 * s + 2 * t + 1) * ROW + 16 * g);
    const uint32_t m = 0x0f0f0f0fu;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const uint32_t v0 = word(w0, h), v1 = word(w1, h);
      place<K43, B128X2>(v0 & m, (v0 >> 4) & m, v1 & m, (v1 >> 4) & m, h, a);
    }
  } else if constexpr (BITS == 3) {
    // planar: unit j of the group holds codes 8j .. 8j+7 in the 24-bit word
    // (rows j, 8 + j, 16 + j); this thread's four codes are bits 12 (t & 1)
    // .. + 11 of unit 2s + t/2, read per byte lane as 8 low bits A and 4
    // high bits B
    const int unit = 2 * s + (t >> 1);
    const uint4 w0 = lds128(codes + unit * ROW + 16 * g);
    const uint4 w1 = lds128(codes + (8 + unit) * ROW + 16 * g);
    const uint4 w2 = lds128(codes + (16 + unit) * ROW + 16 * g);
    const bool odd = t & 1;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const uint32_t p0 = word(w0, h), p1 = word(w1, h), p2 = word(w2, h);
      const uint32_t A = odd ? (((p1 >> 4) & 0x0f0f0f0fu) | ((p2 << 4) & 0xf0f0f0f0u)) : p0;
      const uint32_t B = odd ? ((p2 >> 4) & 0x0f0f0f0fu) : (p1 & 0x0f0f0f0fu);
      place<K43, B128X2>(A & 0x07070707u, (A >> 3) & 0x07070707u,
                         ((A >> 6) & 0x03030303u) | ((B << 2) & 0x04040404u),
                         (B >> 1) & 0x07070707u, h, a);
    }
  } else {  // 8-bit: byte rows 16s + 4t + i; code = lo + 16 hi, two products
    uint4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = lds128(codes + (16 * s + 4 * t + i) * ROW + 16 * g);
    const uint32_t m = 0x0f0f0f0fu;
#pragma unroll
    for (int h = 0; h < 4; ++h)
      place<K45, B2048X2>((word(w[0], h) >> 4) & m, (word(w[1], h) >> 4) & m,
                          (word(w[2], h) >> 4) & m, (word(w[3], h) >> 4) & m, h, a);
#pragma unroll
    for (int j = 0; j < 8; ++j) mma(p[j], a[j][0], a[j][1], a[j][2], a[j][3], b0, b1);
#pragma unroll
    for (int h = 0; h < 4; ++h)
      place<K43, B128X2>(word(w[0], h) & m, word(w[1], h) & m, word(w[2], h) & m,
                         word(w[3], h) & m, h, a);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) mma(p[j], a[j][0], a[j][1], a[j][2], a[j][3], b0, b1);
}

__device__ __forceinline__ float u8f(uint32_t v) {  // exact for v < 2^23
  return __int_as_float(0x4B000000 | v) - 8388608.f;
}

template <int BITS, bool M1>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dequant_gemv_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ out,
                    const int* __restrict__ slots, const Leaves w, int M, int K, int N, int sg) {
  using C = Cfg<BITS>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / CL) * BN;
  const int b = blockIdx.y;
  const long long rec = slots ? static_cast<long long>(slots[b]) : static_cast<long long>(b);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint8_t* P = w.packed + rec * w.packed_stride;
  const uint8_t* QS = w.scale + rec * w.scale_stride;
  const uint8_t* QZ = w.zero + rec * w.zero_stride;
  const long long mo = rec * w.meta_stride;
  const __nv_bfloat16* xb = x + static_cast<long long>(b) * M * K;

  // this warp's stages: part rank * WARPS + warp of CL * WARPS equal runs
  const long long NS = K / KS, parts = static_cast<long long>(CL) * WARPS;
  const long long part = static_cast<long long>(rank) * WARPS + warp;
  const int lo = static_cast<int>(part * NS / parts), hi = static_cast<int>((part + 1) * NS / parts);
  unsigned char* ring = smem + warp * C::WARP_BYTES;
  float2* dec = reinterpret_cast<float2*>(ring + C::NST * C::STAGE);

  // this lane's cp.async chunks, fixed per stage: 16-byte column chunk
  // lane & 7 of code rows lane / 8 + 4i, of the scale (or zero) rows, and
  // of the x rows; each stage advances the global offsets by a stage
  const int c8 = lane & 7, r8 = lane >> 3;
  const bool c8_ok = n0 + 16 * c8 < N;
  const long long col = c8_ok ? n0 + 16 * c8 : 0;
  const uint8_t* pcode = P + r8 * static_cast<long long>(N) + col;
  constexpr int SZ_CHUNKS = 2 * C::NG * 8;  // 64 at 2 bits, 16 otherwise
  const int sz_e = lane % SZ_CHUNKS;
  const bool sz_lane = lane < SZ_CHUNKS;
  const int sz_which = sz_e / (C::NG * 8), sz_row = (sz_e >> 3) % C::NG;
  const uint8_t* psz = (sz_which ? QZ : QS) + sz_row * static_cast<long long>(N) + col;
  const uint8_t* pzero = QZ + sz_row * static_cast<long long>(N) + col;  // 2 bits: lane's zero chunk
  const int sz_dst = C::CODE + sz_which * C::SZ + sz_row * BN + 16 * c8;
  auto load_stage = [&](int st, int slot) {
    unsigned char* base = ring + slot * C::STAGE;
    const uint8_t* pc = pcode + static_cast<long long>(st) * C::CODE_ROWS * N;
#pragma unroll
    for (int i = 0; i < C::CODE_ROWS / 4; ++i)
      cp_async16(base + (r8 + 4 * i) * ROW + 16 * c8, pc + 4LL * i * N, c8_ok);
    const long long so = static_cast<long long>(st) * C::NG * N;
    if (sz_lane) cp_async16(base + sz_dst, psz + so, c8_ok);
    if (SZ_CHUNKS > 32) cp_async16(base + sz_dst + C::SZ, pzero + so, c8_ok);
    const __nv_bfloat16* px = xb + static_cast<long long>(st) * KS + 8 * c8;
#pragma unroll
    for (int i = 0; i < MMAX / 4; ++i) {
      const int m = r8 + 4 * i;
      if (m < M) cp_async16(base + C::CODE + 2 * C::SZ + m * XROW + 16 * c8,
                            px + static_cast<long long>(m) * K, true);
    }
  };

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // the decode: lane owns columns 4 lane .. + 3 of every group
  const int dcol = n0 + 4 * lane;
  const bool dok = dcol < N;
  int mrow = -1;
  float ss[4], sm[4], zs[4], zm[4];

#pragma unroll 1
  for (int i = 0; i < C::NST - 1; ++i) {
    if (lo + i < hi) load_stage(lo + i, i);
    cp_commit();
  }
#pragma unroll 1
  for (int st = lo, i = 0; st < hi; ++st, ++i) {
    cp_wait<C::NST - 2>();
    __syncwarp();  // stage i landed for every lane; slot i - 1 is free
    if (st + C::NST - 1 < hi) load_stage(st + C::NST - 1, (i + C::NST - 1) % C::NST);
    cp_commit();
    const unsigned char* base = ring + (i % C::NST) * C::STAGE;
    const int mr = st * C::NG / sg;
    if (mr != mrow) {
      mrow = mr;
      const long long mi = mo + static_cast<long long>(mr) * N + (dok ? dcol : 0);
      const uint2 a = *reinterpret_cast<const uint2*>(w.s_scale + mi);
      const uint2 bq = *reinterpret_cast<const uint2*>(w.s_min + mi);
      const uint2 c = *reinterpret_cast<const uint2*>(w.z_scale + mi);
      const uint2 d = *reinterpret_cast<const uint2*>(w.z_min + mi);
      const __half* ha = reinterpret_cast<const __half*>(&a);
      const __half* hb = reinterpret_cast<const __half*>(&bq);
      const __half* hc = reinterpret_cast<const __half*>(&c);
      const __half* hd = reinterpret_cast<const __half*>(&d);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ss[q] = __half2float(ha[q]);
        sm[q] = __half2float(hb[q]);
        zs[q] = __half2float(hc[q]);
        zm[q] = __half2float(hd[q]);
      }
    }
    // (scale, scale * zero) of the stage's groups, this lane's 4 columns;
    // the previous stage's readers are past the __syncwarp above
#pragma unroll
    for (int gi = 0; gi < C::NG; ++gi) {
      const uint32_t qs = *reinterpret_cast<const uint32_t*>(base + C::CODE + gi * BN + 4 * lane);
      const uint32_t qz = *reinterpret_cast<const uint32_t*>(base + C::CODE + C::SZ + gi * BN + 4 * lane);
      float v[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // the reference's rounding: no fused multiply-add
        const float sc = __fadd_rn(__fmul_rn(u8f((qs >> (8 * q)) & 0xffu), ss[q]), sm[q]);
        const float zr = __fadd_rn(__fmul_rn(u8f((qz >> (8 * q)) & 0xffu), zs[q]), zm[q]);
        v[2 * q] = sc;
        v[2 * q + 1] = sc * zr;
      }
      float4* dw = reinterpret_cast<float4*>(dec + gi * DROW + 4 * lane + 2 * (lane >> 2));
      dw[0] = make_float4(v[0], v[1], v[2], v[3]);
      dw[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncwarp();
    const unsigned char* xs = base + C::CODE + 2 * C::SZ;
    float p[8][4], sx[4];
    if constexpr (M1) {
      // one x row, 2-bit: step s (group s) puts x in B column s, so the
      // stage's four groups land in four columns of one accumulator and
      // are scaled once: thread (g, t) holds groups 2t and 2t + 1 (t < 2)
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
      sx[0] = sx[1] = sx[2] = sx[3] = 0.f;
#pragma unroll
      for (int s = 0; s < KS / 16; ++s) {
        uint32_t b0 = 0u, b1 = 0u;
        if (g == s) {
          const uint2 xv = *reinterpret_cast<const uint2*>(xs + (16 * s + 4 * t) * 2);
          b0 = xv.x;
          b1 = xv.y;
        }
        mma(sx, ONE2, ONE2, ONE2, ONE2, b0, b1);  // sx[0] = S of group 2t, sx[1] of 2t + 1
        step_mma<BITS>(base, s, g, t, b0, b1, p);
      }
      const float4* d0 = reinterpret_cast<const float4*>(dec + ((2 * t) & 3) * DROW) + 9 * g;
      const float4* d1 = reinterpret_cast<const float4*>(dec + ((2 * t + 1) & 3) * DROW) + 9 * g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // p and sx are 0 for t >= 2
        const float4 v0 = d0[j], v1 = d1[j];
        acc[j][0] = fmaf(v0.x, p[j][0], fmaf(-v0.y, sx[0], acc[j][0]));
        acc[j][1] = fmaf(v1.x, p[j][1], fmaf(-v1.y, sx[1], acc[j][1]));
        acc[j][2] = fmaf(v0.z, p[j][2], fmaf(-v0.w, sx[0], acc[j][2]));
        acc[j][3] = fmaf(v1.z, p[j][3], fmaf(-v1.w, sx[1], acc[j][3]));
      }
    } else {
#pragma unroll
      for (int s = 0; s < KS / 16; ++s) {
        if (s % C::SPG == 0) {
#pragma unroll
          for (int j = 0; j < 8; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
          sx[0] = sx[1] = sx[2] = sx[3] = 0.f;
        }
        // B: x row g, k 16s + 4t .. + 3 (the k permutation); rows >= M are 0
        uint32_t b0 = 0u, b1 = 0u;
        if (g < M) {
          const uint2 xv = *reinterpret_cast<const uint2*>(xs + g * XROW + (16 * s + 4 * t) * 2);
          b0 = xv.x;
          b1 = xv.y;
        }
        mma(sx, ONE2, ONE2, ONE2, ONE2, b0, b1);  // sx[0] = S of row 2t, sx[1] of row 2t + 1
        step_mma<BITS>(base, s, g, t, b0, b1, p);
        if (s % C::SPG == C::SPG - 1) {
          // columns 16g + 2j (p[j][0..1]) and 16g + 2j + 1 (p[j][2..3])
          const float4* d = reinterpret_cast<const float4*>(dec + (s / C::SPG) * DROW) + 9 * g;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 v = d[j];
            acc[j][0] = fmaf(v.x, p[j][0], fmaf(-v.y, sx[0], acc[j][0]));
            acc[j][1] = fmaf(v.x, p[j][1], fmaf(-v.y, sx[1], acc[j][1]));
            acc[j][2] = fmaf(v.z, p[j][2], fmaf(-v.w, sx[0], acc[j][2]));
            acc[j][3] = fmaf(v.z, p[j][3], fmaf(-v.w, sx[1], acc[j][3]));
          }
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // every warp is done with its ring: it holds the sums now

  float* red = reinterpret_cast<float*>(smem);               // (WARPS, MMAX, BN)
  float* part_sum = red + WARPS * MMAX * BN;                 // (MMAX, BN): this block's
  if constexpr (M1) {
    // column 16g + 2j sums groups 2t, 2t + 1 over the quad's lanes t
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float va = acc[j][0] + acc[j][1], vb = acc[j][2] + acc[j][3];
      va += __shfl_xor_sync(0xffffffffu, va, 1);
      vb += __shfl_xor_sync(0xffffffffu, vb, 1);
      va += __shfl_xor_sync(0xffffffffu, va, 2);
      vb += __shfl_xor_sync(0xffffffffu, vb, 2);
      if (t == 0) {
        red[warp * MMAX * BN + 16 * g + 2 * j] = va;
        red[warp * MMAX * BN + 16 * g + 2 * j + 1] = vb;
      }
    }
  } else {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float* r0 = red + (warp * MMAX + 2 * t) * BN + 16 * g + 2 * j;
    if (2 * t < M) {
      r0[0] = acc[j][0];
      r0[1] = acc[j][2];
    }
    if (2 * t + 1 < M) {
      r0[BN] = acc[j][1];
      r0[BN + 1] = acc[j][3];
    }
  }
  }
  __syncthreads();
  for (int e = tid; e < M * BN; e += THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) sum += red[q * MMAX * BN + e];
    part_sum[e] = sum;
  }
  cluster.sync();  // every block's sums are visible to the cluster
  const int span = BN / CL;
  for (int e = tid; e < M * span; e += THREADS) {
    const int m = e / span, c = rank * span + e % span;
    float sum = 0.f;
    for (int r = 0; r < CL; ++r) sum += cluster.map_shared_rank(part_sum, r)[m * BN + c];
    if (n0 + c < N) out[(static_cast<long long>(b) * M + m) * N + n0 + c] = sum;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int BITS, bool M1>
int launch1(const __nv_bfloat16* x, float* out, const int* slots, const Leaves& w, int B, int M,
           int K, int N, int sg, int cl, cudaStream_t stream) {
  using C = Cfg<BITS>;
  static bool allowed = false;  // the instance's shared memory, set once
  cudaError_t e;
  if (!allowed) {
    e = cudaFuncSetAttribute(dequant_gemv_kernel<BITS, M1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + BN - 1) / BN) * cl, B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = C::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, dequant_gemv_kernel<BITS, M1>, x, out, slots, w, M, K, N, sg);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, M, K) bfloat16 contiguous; out: (B, M, N) float32; slots: (B,)
// int32 on the device, or null for record b = b; cl: blocks of a cluster
// that split K (1, 2, 4, 8).  Each weight leaf is a per-record contiguous
// block at base + record * stride (strides in elements of the leaf's type):
// packed (G, g*bits/8, N) u8, scale/zero (G, N) u8, meta (G/sg, N) f16.
extern "C" int dequant_gemv(const void* x, float* out, const int* slots, int B, int M, int K,
                            int N, int bits, int group_size, int scale_group, int cl,
                            const uint8_t* packed, long long packed_stride, const uint8_t* scale,
                            long long scale_stride, const uint8_t* zero, long long zero_stride,
                            const void* s_scale, const void* s_min, const void* z_scale,
                            const void* z_min, long long meta_stride, void* stream) {
  if (B <= 0 || B > 65535 || M < 1 || M > MMAX || K <= 0 || K % KS || N <= 0 || N % 16 ||
      group_size != (bits == 2 ? 16 : 64) || scale_group <= 0 || (K / group_size) % scale_group ||
      scale_group % (KS / group_size) || !(cl == 1 || cl == 2 || cl == 4 || cl == 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Leaves w{packed, packed_stride, scale, scale_stride, zero, zero_stride,
                 static_cast<const __half*>(s_scale), static_cast<const __half*>(s_min),
                 static_cast<const __half*>(z_scale), static_cast<const __half*>(z_min),
                 meta_stride};
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2:
      return M == 1 ? launch1<2, true>(xb, out, slots, w, B, M, K, N, scale_group, cl, st)
                    : launch1<2, false>(xb, out, slots, w, B, M, K, N, scale_group, cl, st);
    case 3: return launch1<3, false>(xb, out, slots, w, B, M, K, N, scale_group, cl, st);
    case 4: return launch1<4, false>(xb, out, slots, w, B, M, K, N, scale_group, cl, st);
    case 8: return launch1<8, false>(xb, out, slots, w, B, M, K, N, scale_group, cl, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
