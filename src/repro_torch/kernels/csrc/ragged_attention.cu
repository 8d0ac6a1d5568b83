// Ragged paged-KV attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel ragged_attention_pallas
// (src/repro/kernels/ragged_attention.py:206).  It computes, for every
// listed row b, query c and head h = kvh * G + g (G = H / Hkv):
//
//   out[b, c, h] = sum_t softmax_t(q . k_t / sqrt(hd)) v_t
//
// over the keys t of the row's listed pages (kp/vp: (P, ps, Hkv, hd),
// ppos: (P, ps)) with kpos >= 0, kpos <= qpos[b, c] and, with a window,
// qpos[b, c] - kpos < window; float32 accumulation; out = 0 where no key is
// valid, and for rows with no work item at all.
//
// The work list is built on the host (build_page_worklist) and packed
// (pack_worklist) into one int32 buffer: row_seg (B + 1) | n_seg segments of
// (row, lo, hi) | the listed pages, padding dropped.  A segment is a run of
// at most a fixed number of one row's consecutive listed pages, pages
// [lo, hi); row b's segments are [row_seg[b], row_seg[b + 1]).  Pages beyond
// a row's live length or wholly outside the window are not listed, so the
// kernel reads only the pages it needs.
//
// What bounds it: bytes.  Each K/V element read is used by G * (query tile)
// rows, a handful of multiply-adds per byte at decode, far below the card's
// ~295 operations per byte, so the floor is the visited pages' bytes over the
// memory rate.
//
// Design, simple first.  The Pallas kernel carries m/l/acc across sequential
// grid steps in VMEM; a GPU grid has no order.  So one block owns one
// (segment, KV head, query tile) and walks the segment's pages in a loop,
// keeping the online-softmax state in registers.  A row of one segment
// writes its output directly; a longer row's blocks write their partials
// (m, l, unnormalised acc) to scratch, and a second kernel merges them (and
// zero-fills rows without work).  Splitting long rows into segments is what
// fills the card at decode, where B * Hkv (32 for Mixtral's 4 rows) blocks
// alone would leave most SMs idle.  Each page's K and V slice for the block's KV head is staged
// through shared memory in NSTAGE stages: cp.async streams the next pages in
// while the current one is scored, and the page id NSTAGE ahead is read one
// iteration early.  Each warp owns up to RMAX (query, group head) rows, each
// lane DPL of the head's dimensions (lane + 32 j); a dot product is a warp
// reduction, and the KC keys of a chunk are scored as independent reductions
// before one online-softmax update per chunk.  Masking is per key, so pages
// the window skip keeps are still masked inside.
//
// The binding's bfloat16 route (head_dim 64/96/128/256, pages of a multiple
// of 16) runs csrc/ragged_mma.cu on the tensor cores; this kernel serves
// float32, head_dim 32 and other page sizes (head_dim 32, 64, 96, 128, 256).  Launches on the
// caller's stream, allocates nothing (the caller passes the scratch), and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int MIN_WARPS = 4;  // warps that stage pages even with fewer rows
constexpr int MAX_WARPS = 8;
constexpr int RMAX = 4;       // rows per warp
constexpr int KC = 16;        // keys scored together (independent reductions)
constexpr int NSTAGE = 3;     // pages in flight through shared memory
constexpr int STATIC_SMEM = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// all but the NSTAGE - 1 most recent groups are complete
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTAGE - 1));
}

// stage x of the shared buffer: K (ps, HD) | V (ps, HD), then all kpos
template <int HD, typename T>
__device__ __forceinline__ T* stage_kv(unsigned char* smem, int x, int ps) {
  return reinterpret_cast<T*>(smem) + 2 * x * ps * HD;
}
template <int HD, typename T>
__device__ __forceinline__ int* stage_kpos(unsigned char* smem, int x, int ps) {
  return reinterpret_cast<int*>(reinterpret_cast<T*>(smem) + 2 * NSTAGE * ps * HD) + x * ps;
}

template <int HD, typename T>
__device__ __forceinline__ void issue_page(unsigned char* smem, int x,
                                           const T* __restrict__ kp,
                                           const T* __restrict__ vp,
                                           const int* __restrict__ ppos, long long page,
                                           int ps, int Hkv, int kvh) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  T* ks = stage_kv<HD, T>(smem, x, ps);
  T* vs = ks + ps * HD;
  int* kpos = stage_kpos<HD, T>(smem, x, ps);
  const int vecs = ps * HD / VEC;
  for (int e = threadIdx.x; e < vecs; e += blockDim.x) {
    const int t = e * VEC / HD, d = e * VEC % HD;
    const long long src = ((page * ps + t) * Hkv + kvh) * HD + d;
    cp_async16(ks + e * VEC, kp + src);
    cp_async16(vs + e * VEC, vp + src);
  }
  for (int t = threadIdx.x; t < ps; t += blockDim.x) cp_async4(kpos + t, ppos + page * ps + t);
}

// one (segment, KV head, query tile): the segment's online-softmax partial,
// or the row's output when the segment is the row's only one
template <int DPL, typename T>
__global__ void __launch_bounds__(WARP * MAX_WARPS)
ragged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp, const int* __restrict__ ppos,
                        const int* __restrict__ qpos, const int* __restrict__ work,
                        int n_seg, float* __restrict__ part_acc,
                        float* __restrict__ part_ml, T* __restrict__ out, int B,
                        int C, int H, int Hkv, int ps, int ct, int rpw, int window,
                        float scale) {
  constexpr int HD = DPL * WARP;
  extern __shared__ __align__(16) unsigned char smem[];

  const int z = blockIdx.z, kvh = blockIdx.y, c0 = blockIdx.x * ct;
  const int* seg = work + B + 1 + 3 * z;
  const int b = seg[0], start = seg[1], end = seg[2];
  const int* wpage = work + B + 1 + 3 * n_seg;
  const int G = H / Hkv;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;

  // this warp's rows: r = warp * rpw + i -> query c0 + r / G, head kvh*G + r % G
  float qr[RMAX][DPL], acc[RMAX][DPL], m[RMAX], l[RMAX];
  int qp[RMAX];
  bool live[RMAX];
#pragma unroll
  for (int i = 0; i < RMAX; ++i) {
    const int r = warp * rpw + i;
    const int c = c0 + r / G;
    live[i] = i < rpw && r < ct * G && c < C;
    m[i] = -INFINITY;
    l[i] = 0.f;
    qp[i] = live[i] ? qpos[b * C + c] : 0;
    const long long qoff = live[i] ? ((static_cast<long long>(b) * C + c) * H + kvh * G + r % G) * HD : 0;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      qr[i][j] = live[i] ? to_f32(q[qoff + lane + WARP * j]) : 0.f;
      acc[i][j] = 0.f;
    }
  }

#pragma unroll
  for (int x = 0; x < NSTAGE - 1; ++x) {  // prologue: the first pages in flight
    if (start + x < end) issue_page<HD>(smem, x, kp, vp, ppos, wpage[start + x], ps, Hkv, kvh);
    cp_async_commit();
  }
  int ahead = start + NSTAGE - 1 < end ? wpage[start + NSTAGE - 1] : 0;
  for (int w = start, k = 0; w < end; ++w, ++k) {
    if (w + NSTAGE - 1 < end)
      issue_page<HD>(smem, (k + NSTAGE - 1) % NSTAGE, kp, vp, ppos, ahead, ps, Hkv, kvh);
    cp_async_commit();
    ahead = w + NSTAGE < end ? wpage[w + NSTAGE] : 0;  // lands during the scoring
    cp_async_wait_oldest();  // this page's copies are done; later ones fly
    __syncthreads();
    const T* ks = stage_kv<HD, T>(smem, k % NSTAGE, ps);
    const T* vs = ks + ps * HD;
    const int* kpos_s = stage_kpos<HD, T>(smem, k % NSTAGE, ps);
#pragma unroll
    for (int i = 0; i < RMAX; ++i) {
      if (!live[i]) continue;  // uniform across the warp
      for (int t0 = 0; t0 < ps; t0 += KC) {
        float s[KC];
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < KC; ++u) {
          const int t = t0 + u;
          float part = 0.f;
          if (t < ps) {
#pragma unroll
            for (int j = 0; j < DPL; ++j)
              part = fmaf(qr[i][j], to_f32(ks[t * HD + lane + WARP * j]), part);
          }
          const float sc = warp_sum(part) * scale;
          const int kpos = t < ps ? kpos_s[t] : -1;
          const bool ok = kpos >= 0 && kpos <= qp[i] && (window <= 0 || qp[i] - kpos < window);
          s[u] = ok ? sc : -INFINITY;
          mx = fmaxf(mx, s[u]);
        }
        if (mx == -INFINITY) continue;  // no valid key in this chunk
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        float psum = 0.f, pv[DPL];
#pragma unroll
        for (int j = 0; j < DPL; ++j) pv[j] = 0.f;
#pragma unroll
        for (int u = 0; u < KC; ++u) {
          const int t = t0 + u;
          const float p = expf(s[u] - m_new);  // 0 for masked keys
          psum += p;
          if (t < ps) {
#pragma unroll
            for (int j = 0; j < DPL; ++j)
              pv[j] = fmaf(p, to_f32(vs[t * HD + lane + WARP * j]), pv[j]);
          }
        }
        l[i] = l[i] * alpha + psum;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[i][j] = fmaf(acc[i][j], alpha, pv[j]);
        m[i] = m_new;
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  const bool alone = work[b + 1] - work[b] == 1;  // the row's only segment
#pragma unroll
  for (int i = 0; i < RMAX; ++i) {
    if (!live[i]) continue;
    const int r = warp * rpw + i;
    const long long ch = static_cast<long long>(c0 + r / G) * H + kvh * G + r % G;
    if (alone) {
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        store(out + (static_cast<long long>(b) * C * H + ch) * HD + lane + WARP * j, acc[i][j] * inv);
      continue;
    }
    const long long item = static_cast<long long>(z) * C * H + ch;
#pragma unroll
    for (int j = 0; j < DPL; ++j) part_acc[item * HD + lane + WARP * j] = acc[i][j];
    if (lane == 0) {
      part_ml[2 * item] = m[i];
      part_ml[2 * item + 1] = l[i];
    }
  }
}

// one warp per (row, query, head) of a row with no segment (zeros) or with
// several (their merged partials); rows of one segment were written directly
template <int DPL, typename T>
__global__ void ragged_combine_kernel(const int* __restrict__ work,
                                      const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      T* __restrict__ out, int B, int C, int H) {
  constexpr int HD = DPL * WARP;
  const long long item = static_cast<long long>(blockIdx.x) * (blockDim.x / WARP) + threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  if (item >= static_cast<long long>(B) * C * H) return;
  const int b = static_cast<int>(item / (static_cast<long long>(C) * H));
  const long long ch = item % (static_cast<long long>(C) * H);
  const int s0 = work[b], s1 = work[b + 1];
  if (s1 - s0 == 1) return;
  float M = -INFINITY;
  for (int s = s0; s < s1; ++s) M = fmaxf(M, part_ml[2 * (s * static_cast<long long>(C) * H + ch)]);
  float L = 0.f, o[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) o[j] = 0.f;
  if (M != -INFINITY) {  // else no valid key: the output stays 0
    for (int s = s0; s < s1; ++s) {
      const long long p = s * static_cast<long long>(C) * H + ch;
      const float wgt = expf(part_ml[2 * p] - M);  // 0 for a segment without keys
      L = fmaf(part_ml[2 * p + 1], wgt, L);
#pragma unroll
      for (int j = 0; j < DPL; ++j) o[j] = fmaf(part_acc[p * HD + lane + WARP * j], wgt, o[j]);
    }
  }
  const float inv = L > 0.f ? 1.f / L : 0.f;
#pragma unroll
  for (int j = 0; j < DPL; ++j) store(out + item * HD + lane + WARP * j, o[j] * inv);
}

template <int DPL, typename T>
int launch_dpl(const T* q, const T* kp, const T* vp, const int* ppos, const int* qpos,
               const int* work, int n_seg, float* part_acc, float* part_ml, T* out,
               int B, int C, int H, int Hkv, int ps, int window, cudaStream_t stream) {
  constexpr int HD = DPL * WARP;
  const int G = H / Hkv;
  const int max_rows = MAX_WARPS * RMAX;
  const int ct = C < max_rows / G ? C : max_rows / G;  // queries per block
  const int rows = ct * G;
  int warps = rows < MAX_WARPS ? rows : MAX_WARPS;
  const int rpw = (rows + warps - 1) / warps;
  if (warps < MIN_WARPS) warps = MIN_WARPS;  // the extra warps only stage pages
  const size_t shmem = NSTAGE * (2 * static_cast<size_t>(ps) * HD * sizeof(T) + ps * sizeof(int));
  if (shmem > STATIC_SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(ragged_attention_kernel<DPL, T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n_seg > 0) {
    const dim3 grid((C + ct - 1) / ct, Hkv, n_seg);
    ragged_attention_kernel<DPL, T><<<grid, WARP * warps, shmem, stream>>>(
        q, kp, vp, ppos, qpos, work, n_seg, part_acc, part_ml, out, B, C, H, Hkv, ps,
        ct, rpw, window, 1.f / sqrtf(static_cast<float>(HD)));
  }
  const long long items = static_cast<long long>(B) * C * H;
  constexpr int PER_BLOCK = 4;  // warps, one item each
  ragged_combine_kernel<DPL, T><<<static_cast<unsigned>((items + PER_BLOCK - 1) / PER_BLOCK),
                                  WARP * PER_BLOCK, 0, stream>>>(work, part_acc, part_ml, out,
                                                                 B, C, H);
  return 0;
}

template <typename T>
int launch_typed(const void* q, const void* kp, const void* vp, const int* ppos,
                 const int* qpos, const int* work, int n_seg, float* part_acc,
                 float* part_ml, void* out, int B, int C, int H, int Hkv, int hd, int ps,
                 int window, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(kp);
  const T* vt = static_cast<const T*>(vp);
  T* ot = static_cast<T*>(out);
  switch (hd) {
    case 32: return launch_dpl<1, T>(qt, kt, vt, ppos, qpos, work, n_seg, part_acc, part_ml,
                                     ot, B, C, H, Hkv, ps, window, stream);
    case 64: return launch_dpl<2, T>(qt, kt, vt, ppos, qpos, work, n_seg, part_acc, part_ml,
                                     ot, B, C, H, Hkv, ps, window, stream);
    case 96: return launch_dpl<3, T>(qt, kt, vt, ppos, qpos, work, n_seg, part_acc, part_ml,
                                     ot, B, C, H, Hkv, ps, window, stream);
    case 128: return launch_dpl<4, T>(qt, kt, vt, ppos, qpos, work, n_seg, part_acc, part_ml,
                                      ot, B, C, H, Hkv, ps, window, stream);
    case 256: return launch_dpl<8, T>(qt, kt, vt, ppos, qpos, work, n_seg, part_acc, part_ml,
                                      ot, B, C, H, Hkv, ps, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window <= 0: no sliding window.  part_acc
// (n_seg, C, H, hd) and part_ml (n_seg, C, H, 2) float32 are the caller's
// scratch.
extern "C" int ragged_attention(const void* q, const void* kp, const void* vp,
                                const int* ppos, const int* qpos, const int* work,
                                int n_seg, float* part_acc, float* part_ml, void* out,
                                int dtype, int B, int C, int H, int Hkv, int hd, int ps,
                                int window, void* stream) {
  if (B < 1 || C < 1 || Hkv < 1 || H % Hkv || H / Hkv > MAX_WARPS * RMAX || ps < 1 ||
      n_seg < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case 0: rc = launch_typed<float>(q, kp, vp, ppos, qpos, work, n_seg, part_acc, part_ml,
                                     out, B, C, H, Hkv, hd, ps, window, s); break;
    case 1: rc = launch_typed<__nv_bfloat16>(q, kp, vp, ppos, qpos, work, n_seg, part_acc,
                                             part_ml, out, B, C, H, Hkv, hd, ps, window, s);
            break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
