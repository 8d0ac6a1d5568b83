// Ragged paged-KV attention on the tensor cores of Hopper (sm_90a), with a
// plain C interface: the bfloat16 route of the ragged attention binding.
//
// Replaces the TPU kernel ragged_attention_pallas
// (src/repro/kernels/ragged_attention.py:206).  For every listed row b,
// query c and head h = kvh * G + gh (G = H / Hkv):
//
//   out[b, c, h] = sum_t softmax_t(q . k_t / sqrt(hd)) v_t
//
// over the keys t of the row's listed pages (kp/vp: (P, ps, Hkv, hd),
// ppos: (P, ps)) with kpos >= 0, kpos <= qpos[b, c] and, with a window,
// qpos[b, c] - kpos < window; float32 accumulation; out = 0 where no key is
// valid and for rows with no work item.  The work list is
// csrc/ragged_attention.cu's (pack_worklist): row_seg (B + 1) | segments
// (row, lo, hi) | listed pages.
//
// What bounds it: bytes, the visited pages' K/V slices over the memory
// rate, at decode and at admission alike.  The design:
//
//  * One block owns (segment, KV head, query tile).  The tile's queries x
//    the G heads of the KV head are the rows of mma.sync m16n8k16 tiles:
//    64 rows at admission (16 queries x 4 heads, one m16 tile per warp),
//    4 rows padded to 16 at decode.  Q stays in registers as A fragments;
//    each staged page's K (16 keys x hd, ldmatrix) is the B operand of
//    Q.K^T and V (ldmatrix.trans) the B operand of P.V.
//  * P.V keeps ~16 bits of each weight: P is split into two bfloat16 terms
//    (hi = bf16(p), lo = bf16(p - hi)), two mma's on one accumulator.
//    Scores, the online softmax (base 2) and the sums stay in float32;
//    masks are per key from the staged kpos, and a 16-key tile that no row
//    of the warp may see is skipped.
//  * Decode (one m16 tile): the 4 warps take different pages of the
//    segment (warp w the pages w, w + 4, ...), 4 pages per cp.async stage,
//    3 stages; admission: every warp its own m16 tile over every page.  The
//    segment's page ids are staged in shared memory first.  Warps that
//    shared a tile merge (m, l, acc) through shared memory in a fixed
//    order, fragment by fragment, and write their rows from the fragments
//    (bfloat16 pairs): no per-element index arithmetic.
//  * One launch per call.  A row of one segment writes its output; a row
//    of several writes partials, and the last of its blocks to finish
//    (a per-(row, KV head, query tile) counter, reset by that block)
//    merges them in segment order, one online pass, 4 dims a thread and 4
//    segments' loads in flight; rows without work are zeroed by B extra
//    blocks.  No combine pass.
//
// Scope: bfloat16, head_dim 64, 96, 128 or 256, page size a multiple of 16,
// G <= 64 (at 96 a key row is 208 bytes: 13 16-byte units, odd, so ldmatrix
// stays conflict-free; 6 k16 chunks of q.k, 12 n8 tiles of the output).  At
// 256 (recurrentgemma, G = 16: decode fills one m16 tile) a key row is 528
// bytes, 33 units; a 16-position page is 16.9 KB, so 3 stages x 4 pages take
// 199 KB, and the warps' merge area (66 KB) reuses that ring after the loop;
// a thread holds Q as 16 k16 fragments and 32 n8 accumulator tiles.
// float32, head_dim 32 and other page sizes run csrc/ragged_attention.cu.
// Launches on the caller's stream, allocates nothing (the caller passes
// the scratch and the zeroed counters), and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int NST = 3;           // cp.async stages
constexpr int MAX_SEG = 64;      // listed pages of a segment, staged as ids

template <int HD>
struct Cfg {
  static constexpr int KROW = HD * 2 + 16;  // smem bytes per key row: +16, conflict-free ldmatrix
  static constexpr int KC = HD / 16;        // k16 chunks of q.k
  static constexpr int NT = HD / 8;         // n8 tiles of the output
  static __host__ __device__ int page_bytes(int ps) { return 2 * ps * KROW + 4 * ps; }
  static __host__ __device__ int merge_bytes() { return WARPS * 32 * (4 + HD / 2) * 4; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
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

// c += a (16 x 16, row) . b (16 x 8, col), bfloat16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as bfloat16 pairs hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
ragged_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                  const __nv_bfloat16* __restrict__ vp, const int* __restrict__ ppos,
                  const int* __restrict__ qpos, const int* __restrict__ work, int n_seg,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  int* __restrict__ counters, __nv_bfloat16* __restrict__ out, int B, int C,
                  int H, int Hkv, int ps, int ct, int ksplit, int window, float scale_log2) {
  using Cf = Cfg<HD>;
  constexpr int KROW = Cf::KROW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / Hkv, R = ct * G, RT = (R + 15) / 16;
  const int kvh = blockIdx.y, c0 = blockIdx.x * ct, z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long CH = static_cast<long long>(C) * H;

  if (z >= n_seg) {  // the zero block of row z - n_seg, if it has no work
    const int b = z - n_seg;
    if (work[b + 1] > work[b]) return;
    for (int e = tid; e < R * HD; e += THREADS) {
      const int r = e / HD, c = c0 + r / G;
      if (c < C)
        out[(b * CH + static_cast<long long>(c) * H + kvh * G + r % G) * HD + e % HD] =
            __float2bfloat16(0.f);
    }
    return;
  }
  const int* seg = work + B + 1 + 3 * z;
  const int b = seg[0], start = seg[1], end = seg[2];
  const int* wpage = work + B + 1 + 3 * n_seg;
  const int rt = warp % RT, ks = warp / RT;
  const bool computes = ks < ksplit;

  // this thread's rows: rt * 16 + g (hh = 0) and + 8 (hh = 1)
  int qp[2];
  uint32_t qa[Cf::KC][4];
  {
    const __nv_bfloat16* qrow[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rt * 16 + g + 8 * hh, c = c0 + r / G;
      const bool ok = computes && r < R && c < C;
      qp[hh] = ok ? qpos[b * C + c] : -1;  // -1: no key is valid
      qrow[hh] = ok ? q + (b * CH + static_cast<long long>(c) * H + kvh * G + r % G) * HD : nullptr;
    }
#pragma unroll
    for (int kc = 0; kc < Cf::KC; ++kc) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16* p = qrow[i & 1];
        qa[kc][i] = p ? *reinterpret_cast<const uint32_t*>(p + 16 * kc + 8 * (i >> 1) + 2 * t) : 0u;
      }
    }
  }

  const int page_bytes = Cf::page_bytes(ps);
  const int np = end - start, n_stages = (np + ksplit - 1) / ksplit;
  __shared__ int seg_pages[MAX_SEG];  // the segment's page ids, read once
  for (int i = tid; i < np && i < MAX_SEG; i += THREADS) seg_pages[i] = wpage[start + i];
  __syncthreads();
  auto issue = [&](int si, int slot) {
    unsigned char* base = smem + slot * ksplit * page_bytes;
    constexpr int CH16 = HD / 8;  // 16-byte chunks per key row
    for (int j = 0; j < ksplit; ++j) {
      const int wi = si * ksplit + j;
      if (wi >= np) break;
      const long long page = wi < MAX_SEG ? seg_pages[wi] : wpage[start + wi];
      unsigned char* pg = base + j * page_bytes;
      for (int e = tid; e < ps * CH16; e += THREADS) {
        const int key = e / CH16, c = e % CH16;
        const long long src = ((page * ps + key) * Hkv + kvh) * HD + 8 * c;
        cp_async16(pg + key * KROW + 16 * c, kp + src);
        cp_async16(pg + (ps + key) * KROW + 16 * c, vp + src);
      }
      for (int e = tid; e < ps / 4; e += THREADS)
        cp_async16(pg + 2 * ps * KROW + 16 * e, ppos + page * ps + 4 * e);
    }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[Cf::NT][4];
#pragma unroll
  for (int d = 0; d < Cf::NT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

#pragma unroll 1
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_stages) issue(s, s);
    cp_commit();
  }
#pragma unroll 1
  for (int si = 0; si < n_stages; ++si) {
    cp_wait<NST - 2>();
    __syncthreads();  // stage si landed for every thread; stage si - 1 is free
    if (si + NST - 1 < n_stages) issue(si + NST - 1, (si + NST - 1) % NST);
    cp_commit();
    if (!computes || start + si * ksplit + ks >= end) continue;  // uniform per warp
    const unsigned char* Ks = smem + ((si % NST) * ksplit + ks) * page_bytes;
    const unsigned char* Vs = Ks + ps * KROW;
    const int* kpos = reinterpret_cast<const int*>(Ks + 2 * ps * KROW);
#pragma unroll 1
    for (int k0 = 0; k0 < ps; k0 += 16) {
      // masks of this thread's scores: (row hh, n-tile nt, key 2t + e2)
      bool ok[2][2][2];
      bool any = false;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int kv = kpos[k0 + 8 * nt + 2 * t + e2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            ok[hh][nt][e2] = kv >= 0 && kv <= qp[hh] && (window <= 0 || qp[hh] - kv < window);
            any |= ok[hh][nt][e2];
          }
        }
      if (!__any_sync(0xffffffffu, any)) continue;  // no row of the warp sees these keys
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kc = 0; kc < Cf::KC; ++kc) {
        uint32_t r[4];
        ldsm_x4(r, Ks + (k0 + (lane >> 4) * 8 + (lane & 7)) * KROW + (16 * kc + ((lane >> 3) & 1) * 8) * 2);
        mma(s[0], qa[kc], r[0], r[1]);
        mma(s[1], qa[kc], r[2], r[3]);
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const float v = ok[hh][nt][e & 1] ? s[nt][e] * scale_log2 : -INFINITY;
          s[nt][e] = v;
          mx[hh] = fmaxf(mx[hh], v);
        }
      float alpha[2], msub[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m[hh], mx[hh]);
        alpha[hh] = m_new == -INFINITY ? 1.f : exp2f(m[hh] - m_new);
        msub[hh] = m_new == -INFINITY ? 0.f : m_new;
        m[hh] = m_new;
      }
      float p[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[nt][e] = exp2f(s[nt][e] - msub[e >> 1]);  // 0 where masked
      l[0] = l[0] * alpha[0] + (p[0][0] + p[0][1] + p[1][0] + p[1][1]);
      l[1] = l[1] * alpha[1] + (p[0][2] + p[0][3] + p[1][2] + p[1][3]);
#pragma unroll
      for (int d = 0; d < Cf::NT; ++d) {
        acc[d][0] *= alpha[0];
        acc[d][1] *= alpha[0];
        acc[d][2] *= alpha[1];
        acc[d][3] *= alpha[1];
      }
      // P as A fragments (rows g / g + 8, keys 2t.. and 8 + 2t..), two terms
      uint32_t ph[4], pl[4];
      split2(p[0][0], p[0][1], ph[0], pl[0]);
      split2(p[0][2], p[0][3], ph[1], pl[1]);
      split2(p[1][0], p[1][1], ph[2], pl[2]);
      split2(p[1][2], p[1][3], ph[3], pl[3]);
#pragma unroll
      for (int d2 = 0; d2 < Cf::NT / 2; ++d2) {
        uint32_t r[4];
        ldsm_x4_t(r, Vs + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * KROW + (16 * d2 + (lane >> 4) * 8) * 2);
        mma(acc[2 * d2], ph, r[0], r[1]);
        mma(acc[2 * d2], pl, r[0], r[1]);
        mma(acc[2 * d2 + 1], ph, r[2], r[3]);
        mma(acc[2 * d2 + 1], pl, r[2], r[3]);
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  cp_wait<0>();
  if (ksplit > 1) {
    // the warps that shared a tile meet in warp ks = 0, in key-split order,
    // fragment by fragment: lane l of warp w keeps (m, l) of its two rows and
    // its acc fragments at the same place
    __syncthreads();  // the ring is free
    float* mls = reinterpret_cast<float*>(smem);                 // (WARPS, 32, 4)
    float4* accs = reinterpret_cast<float4*>(mls + WARPS * 32 * 4);  // (WARPS, NT, 32)
    if (computes && ks > 0) {
      *reinterpret_cast<float4*>(mls + (warp * 32 + lane) * 4) = make_float4(m[0], l[0], m[1], l[1]);
#pragma unroll
      for (int d = 0; d < Cf::NT; ++d)
        accs[(warp * Cf::NT + d) * 32 + lane] = make_float4(acc[d][0], acc[d][1], acc[d][2], acc[d][3]);
    }
    __syncthreads();
    if (computes && ks == 0) {
      for (int k = 1; k < ksplit; ++k) {
        const int w = rt + RT * k;
        const float4 ml = *reinterpret_cast<const float4*>(mls + (w * 32 + lane) * 4);
        const float mk[2] = {ml.x, ml.z}, lk[2] = {ml.y, ml.w};
        float wo[2], wn[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float M2 = fmaxf(m[hh], mk[hh]);
          wo[hh] = M2 == -INFINITY ? 0.f : exp2f(m[hh] - M2);
          wn[hh] = M2 == -INFINITY ? 0.f : exp2f(mk[hh] - M2);
          l[hh] = l[hh] * wo[hh] + lk[hh] * wn[hh];
          m[hh] = M2;
        }
#pragma unroll
        for (int d = 0; d < Cf::NT; ++d) {
          const float4 v = accs[(w * Cf::NT + d) * 32 + lane];
          acc[d][0] = acc[d][0] * wo[0] + v.x * wn[0];
          acc[d][1] = acc[d][1] * wo[0] + v.y * wn[0];
          acc[d][2] = acc[d][2] * wo[1] + v.z * wn[1];
          acc[d][3] = acc[d][3] * wo[1] + v.w * wn[1];
        }
      }
    }
  }
  const bool alone = work[b + 1] - work[b] == 1;
  if (computes && ks == 0) {  // the tile's rows, from the fragments
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rt * 16 + g + 8 * hh, c = c0 + r / G;
      if (r >= R || c >= C) continue;
      const long long item = static_cast<long long>(c) * H + kvh * G + r % G;
      if (alone) {
        const float inv = l[hh] > 0.f ? 1.f / l[hh] : 0.f;
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + (b * CH + item) * HD + 2 * t);
#pragma unroll
        for (int d = 0; d < Cf::NT; ++d)
          o[4 * d] = __floats2bfloat162_rn(acc[d][2 * hh] * inv, acc[d][2 * hh + 1] * inv);
      } else {
        float2* pa = reinterpret_cast<float2*>(part_acc + (z * CH + item) * HD + 2 * t);
#pragma unroll
        for (int d = 0; d < Cf::NT; ++d) pa[4 * d] = make_float2(acc[d][2 * hh], acc[d][2 * hh + 1]);
        if (t == 0) reinterpret_cast<float2*>(part_ml)[z * CH + item] = make_float2(m[hh], l[hh]);
      }
    }
  }
  if (alone) return;

  // the last of the row's blocks (for this KV head and query tile) merges
  __shared__ int last;
  __threadfence();
  __syncthreads();
  const long long cidx = (static_cast<long long>(b) * Hkv + kvh) * gridDim.x + blockIdx.x;
  if (tid == 0) {
    const int done = atomicAdd(counters + cidx, 1);
    last = done == work[b + 1] - work[b] - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int s0 = work[b], s1 = work[b + 1];
  // one online pass over the segments in order, 4 dims a thread, the loads
  // of 4 segments in flight together
  for (int e = 4 * tid; e < R * HD; e += 4 * THREADS) {
    const int r = e / HD, d = e % HD, c = c0 + r / G;
    if (c >= C) continue;
    const long long item = static_cast<long long>(c) * H + kvh * G + r % G;
    float M = -INFINITY, L = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    auto merge = [&](float2 ml, float4 a) {
      if (ml.x == -INFINITY) return;  // a segment without a valid key
      const float M2 = fmaxf(M, ml.x);
      const float wo = exp2f(M - M2), wn = exp2f(ml.x - M2);
      L = L * wo + ml.y * wn;
      o = make_float4(o.x * wo + a.x * wn, o.y * wo + a.y * wn, o.z * wo + a.z * wn,
                      o.w * wo + a.w * wn);
      M = M2;
    };
    const float2* pml = reinterpret_cast<const float2*>(part_ml) + item;
    const float4* pacc = reinterpret_cast<const float4*>(part_acc + item * HD + d);
    int sg = s0;
    for (; sg + 4 <= s1; sg += 4) {
      float2 ml[4];
      float4 a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ml[u] = __ldcg(pml + (sg + u) * CH);
        a[u] = __ldcg(pacc + (sg + u) * CH * (HD / 4));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) merge(ml[u], a[u]);
    }
    for (; sg < s1; ++sg) merge(__ldcg(pml + sg * CH), __ldcg(pacc + sg * CH * (HD / 4)));
    const float inv = L > 0.f ? 1.f / L : 0.f;
    __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(out + (b * CH + item) * HD + d);
    po[0] = __floats2bfloat162_rn(o.x * inv, o.y * inv);
    po[1] = __floats2bfloat162_rn(o.z * inv, o.w * inv);
  }
  if (tid == 0) counters[cidx] = 0;  // ready for the next launch
}

template <int HD>
int launch(const void* q, const void* kp, const void* vp, const int* ppos, const int* qpos,
           const int* work, int n_seg, float* part_acc, float* part_ml, int* counters, void* out,
           int B, int C, int H, int Hkv, int ps, int ct, int ksplit, int window,
           cudaStream_t stream) {
  using Cf = Cfg<HD>;
  const int ring = NST * ksplit * Cf::page_bytes(ps);
  const int bytes = ring > Cf::merge_bytes() ? ring : Cf::merge_bytes();
  static int allowed = 0;  // the shared memory the instance may use, raised as needed
  if (bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(ragged_mma_kernel<HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = bytes;
  }
  const dim3 grid((C + ct - 1) / ct, Hkv, n_seg + B);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  ragged_mma_kernel<HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), ppos, qpos, work, n_seg, part_acc, part_ml, counters,
      static_cast<__nv_bfloat16*>(out), B, C, H, Hkv, ps, ct, ksplit, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 q (B, C, H, hd), kp/vp (P, ps, Hkv, hd), out like q; ppos (P,
// ps) and qpos (B, C) int32; the packed work list; ct queries per block
// (ct * H / Hkv <= 64 rows), ksplit warps sharing a row tile (1, 2 or 4:
// 4 / the tile count); window <= 0: none.  part_acc (n_seg, C, H, hd) and
// part_ml (n_seg, C, H, 2) float32 are the caller's scratch; counters
// (B * Hkv * ceil(C / ct)) int32 must be zero and are left zero.
extern "C" int ragged_mma(const void* q, const void* kp, const void* vp, const int* ppos,
                          const int* qpos, const int* work, int n_seg, float* part_acc,
                          float* part_ml, int* counters, void* out, int B, int C, int H, int Hkv,
                          int hd, int ps, int ct, int ksplit, int window, void* stream) {
  if (B < 1 || C < 1 || Hkv < 1 || H % Hkv || ps < 16 || ps % 16 || n_seg < 0 || ct < 1 ||
      ct * (H / Hkv) > 64 || !(ksplit == 1 || ksplit == 2 || ksplit == 4) ||
      ksplit * ((ct * (H / Hkv) + 15) / 16) > WARPS || n_seg + B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(q, kp, vp, ppos, qpos, work, n_seg, part_acc, part_ml, counters,
                               out, B, C, H, Hkv, ps, ct, ksplit, window, s);
    case 96: return launch<96>(q, kp, vp, ppos, qpos, work, n_seg, part_acc, part_ml, counters,
                               out, B, C, H, Hkv, ps, ct, ksplit, window, s);
    case 128: return launch<128>(q, kp, vp, ppos, qpos, work, n_seg, part_acc, part_ml, counters,
                                 out, B, C, H, Hkv, ps, ct, ksplit, window, s);
    case 256: return launch<256>(q, kp, vp, ppos, qpos, work, n_seg, part_acc, part_ml, counters,
                                 out, B, C, H, Hkv, ps, ct, ksplit, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
