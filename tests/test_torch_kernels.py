"""The dequant-matmul bindings of the port (``repro_torch.kernels.ops``)
against the JAX reference's ``kernels/ops`` and, for the 2-D binding,
its ``dequant_matmul_pallas`` (interpret mode) and ``ref.dequant_matmul_ref``.

On the CPU the port's bindings run the plain version; the reference runs
its Pallas kernel in interpret mode where ``ops`` admits the shape (M % 8
== 0, N % 128 == 0, 2/4/8-bit) and its jnp path otherwise.  Tolerance
rtol = atol = 1e-5 in float32: the same products summed in another order.
The kernel itself is tested on the card by ``test_torch_kernels_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.kernels.dequant_matmul import (dequant_matmul_batched_pallas,
                                          dequant_matmul_pallas)
from repro.quant import hqq as J
from repro_torch.kernels import ops as PO
from repro_torch.quant import hqq as P

from test_torch_hqq import to_port

SHAPES = [(1, 256, 96), (8, 256, 96), (8, 256, 128)]  # (M, K, N); last = Pallas for 2/4-bit


def _case(bits, M, K, N, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((4, K, N)).astype(np.float32) * 0.05
    x = rng.standard_normal((3, M, K)).astype(np.float32)
    return J.quantize(jnp.asarray(w), bits), x


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plain_batched_matches_reference(bits, M, K, N):
    qj, x = _case(bits, M, K, N, seed=bits * 7 + M)
    qj = J.QTensor(qj.packed[:3], qj.scale[:3], qj.zero[:3],
                   {k: v[:3] for k, v in qj.meta.items()}, bits,
                   qj.group_size, (3, K, N))
    yj = np.asarray(JO.dequant_matmul_batched(jnp.asarray(x), qj))
    yt = PO.dequant_matmul_batched(torch.from_numpy(x), to_port(qj)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plain_slots_matches_reference(bits, M, K, N):
    qj, x = _case(bits, M, K, N, seed=bits * 11 + M)
    slots = np.array([3, 0, 3], np.int32)
    yj = np.asarray(JO.dequant_matmul_slots(jnp.asarray(x), qj,
                                            jnp.asarray(slots)))
    yt = PO.dequant_matmul_slots(torch.from_numpy(x), to_port(qj),
                                 torch.from_numpy(slots)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("M", [1, 8, 16])
def test_plain_2d_matches_reference_kernel(bits, M):
    """``ops.dequant_matmul`` (x (M, K) @ one 2-D weight) on the CPU
    against the reference's Pallas kernel in interpret mode (2/4/8-bit;
    the kernel has no 3-bit path) or its jnp oracle (3-bit), on a
    record of a stack as the unrolled plane passes it.  Within 1e-5 of
    max |reference|: float32 sums in another order."""
    K, N = 256, 256
    qj, x = _case(bits, M, K, N, seed=bits * 13 + M)
    one = J.QTensor(qj.packed[2], qj.scale[2], qj.zero[2],
                    {k: v[2] for k, v in qj.meta.items()}, bits,
                    qj.group_size, (K, N))
    scale, zero = J._meta_dequantize(one)
    args = (jnp.asarray(x[0]), one.packed, scale, zero)
    kw = dict(bits=bits, group_size=one.group_size)
    yj = np.asarray(JR.dequant_matmul_ref(*args, **kw) if bits == 3 else
                    dequant_matmul_pallas(*args, interpret=True, **kw))
    qp = to_port(qj)
    yt = PO.dequant_matmul(torch.from_numpy(x[0]),
                           P.slice_leading(qp, 2)).numpy()
    assert yt.shape == (M, N)
    np.testing.assert_allclose(yt, yj, rtol=0,
                               atol=1e-5 * float(np.abs(yj).max()))


GROUP_COUNTS = [0, 1, 15, 16, 17, 64]  # empty, one row, tile +- 1, a full group


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_plain_grouped_matches_reference_kernel(bits):
    """``ops.dequant_matmul_batched`` with row offsets (ragged groups, the
    plain ``ref.dequant_matmul_grouped`` on the CPU) against the
    reference's ``dequant_matmul_batched_pallas`` in interpret mode, each
    group zero-padded to the largest for the reference and compared on
    its real rows only.  Within 1e-5 of max |reference|: float32 sums in
    another order."""
    K, N, U = 256, 128, len(GROUP_COUNTS)
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((U, K, N)).astype(np.float32) * 0.05
    qj = J.quantize(jnp.asarray(w), bits)
    off = np.concatenate([[0], np.cumsum(GROUP_COUNTS)])
    x = rng.standard_normal((int(off[-1]), K)).astype(np.float32)
    xpad = np.zeros((U, max(GROUP_COUNTS), K), np.float32)
    for u, c in enumerate(GROUP_COUNTS):
        xpad[u, :c] = x[off[u]:off[u + 1]]
    scale, zero = J._meta_dequantize(qj)
    yj = np.asarray(dequant_matmul_batched_pallas(
        jnp.asarray(xpad), qj.packed, scale, zero, bits=bits,
        group_size=qj.group_size, bm=8, interpret=True))
    PO.reset_launches()
    yt = PO.dequant_matmul_batched(torch.from_numpy(x), to_port(qj), off).numpy()
    assert yt.shape == (off[-1], N) and PO.launches()["dequant_matmul_batched"] == 0
    atol = 1e-5 * float(np.abs(yj).max())
    for u, c in enumerate(GROUP_COUNTS):
        np.testing.assert_allclose(yt[off[u]:off[u + 1]], yj[u, :c], rtol=0,
                                   atol=atol)


def test_plain_uniform_batch_is_the_grouped_case():
    """Without offsets the batched binding is the grouped one with
    ``offsets = arange(B + 1) * M``: the same values."""
    qj, x = _case(4, 8, 256, 128, seed=3)
    qj = J.QTensor(qj.packed[:3], qj.scale[:3], qj.zero[:3],
                   {k: v[:3] for k, v in qj.meta.items()}, 4, qj.group_size,
                   (3, 256, 128))
    qp = to_port(qj)
    xt = torch.from_numpy(x)
    uniform = PO.dequant_matmul_batched(xt, qp)
    grouped = PO.dequant_matmul_batched(xt.reshape(24, 256), qp,
                                        np.arange(4) * 8)
    torch.testing.assert_close(grouped.reshape(3, 8, 128), uniform,
                               rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_plain_version_and_do_not_count():
    qj, x = _case(3, 1, 256, 96, seed=5)
    PO.reset_launches()
    y = PO.dequant_matmul_slots(torch.from_numpy(x), to_port(qj),
                                torch.tensor([1, 2, 3], dtype=torch.int32))
    assert y.dtype == torch.float32 and tuple(y.shape) == (3, 1, 96)
    y2 = PO.dequant_matmul(torch.from_numpy(x[0]),
                           P.slice_leading(to_port(qj), 0))
    assert y2.dtype == torch.float32 and tuple(y2.shape) == (1, 96)
    assert PO.launches() == {"dequant_matmul": 0,
                             "dequant_matmul_batched": 0,
                             "dequant_matmul_slots": 0,
                             "flash_attention": 0,
                             "ragged_attention": 0}


# ----------------------------------------------------------------------
# the tensor-core decode GEMV (csrc/dequant_gemv.cu): its arithmetic and
# its host-side plan
KERNEL_RTOL = 1e-4  # of max |reference|: float32 sums in another order


def _gemv_emulation(x, qt, slots):
    """The GEMV's arithmetic in plain torch: x rounded to bfloat16, the
    codes as exact bfloat16 integers, per quantization group the raw
    products P = x . codes and row sums S = sum x in float32, scale and
    zero applied once per (group, column) as s P - (s z) S, the groups
    summed in order."""
    from repro_torch.kernels import ref as PR
    g = PR.gather_slots(qt, slots)
    scale, zero = P._meta_dequantize(g)                    # (B, G, 1, N)
    codes = P.unpack_codes(g.packed, g.bits, g.group_size).float()  # (B, G, gs, N)
    B, G, gs, N = codes.shape
    xb = x.to(torch.bfloat16).float().reshape(B, -1, G, gs)
    prod = torch.einsum("bmgk,bgkn->bmgn", xb, codes)      # exact products, f32 sums
    rows = xb.sum(-1)                                      # (B, M, G)
    s, sz = scale[:, None, :, 0], (scale * zero)[:, None, :, 0]
    terms = s * prod - sz * rows[..., None]
    acc = torch.zeros_like(terms[:, :, 0])
    for gi in range(G):
        acc = acc + terms[:, :, gi]
    return acc


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_gemv_emulation_matches_references(bits):
    """The emulated GEMV against the port's plain slot binding and, record
    by record, the JAX reference's ``dequant_matmul_ref``, on the same
    bfloat16-rounded x, within 1e-4 of max |reference|."""
    qj, x = _case(bits, 1, 512, 128, seed=bits * 17)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    slots = np.array([3, 0, 3], np.int32)
    qp = to_port(qj)
    y = _gemv_emulation(torch.from_numpy(x), qp, torch.from_numpy(slots)).numpy()
    yp = PO.dequant_matmul_slots(torch.from_numpy(x), qp,
                                 torch.from_numpy(slots)).numpy()
    scale, zero = J._meta_dequantize(qj)
    yj = np.stack([np.asarray(JR.dequant_matmul_ref(
        jnp.asarray(x[b]), qj.packed[s], scale[s], zero[s], bits=bits,
        group_size=qj.group_size)) for b, s in enumerate(slots)])
    for want in (yp, yj):
        np.testing.assert_allclose(y, want, rtol=0,
                                   atol=KERNEL_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("K", [64, 512, 4096, 14336])
@pytest.mark.parametrize("cl", [1, 2, 4, 8])
def test_gemv_parts_cover_every_stage_once(K, cl):
    """The (cluster rank, warp) runs of 64-k stages the kernel walks cover
    every stage, hence every quantization group, exactly once, in rank
    then warp order."""
    from repro_torch.kernels import dequant_matmul as DM
    parts = DM.gemv_parts(K, cl)
    assert [(r, w) for r, w, _, _ in parts] == [(r, w) for r in range(cl)
                                              for w in range(DM.GEMV_WARPS)]
    seen = [s for _, _, lo, hi in parts for s in range(lo, hi)]
    assert seen == list(range(K // DM.GEMV_KS))


def test_gemv_cluster_depends_on_the_shape_only():
    """The cluster split: 2 where the column tiles are fewer than the SMs
    (Mixtral's gate/up and down), 1 for small K or wide N; never more
    than the portable cluster size, never below two stages a warp."""
    from repro_torch.kernels import dequant_matmul as DM
    assert DM.gemv_cluster(4096, 14336) == 2 and DM.gemv_cluster(14336, 4096) == 2
    assert DM.gemv_cluster(512, 320) == 1 and DM.gemv_cluster(4096, 20000) == 1
    for K in (64, 512, 1024, 4096, 14336):
        for N in (16, 320, 4096, 14336, 30000):
            cl = DM.gemv_cluster(K, N)
            assert cl in (1, 2)
            assert cl == 1 or K // DM.GEMV_KS >= 2 * cl * DM.GEMV_WARPS


# ----------------------------------------------------------------------
# the tensor-core ragged kernel (csrc/ragged_mma.cu): its arithmetic and
# its host-side plan
RAGGED_BF16_RTOL = 2 ** -7  # of each row's max |plain in f32|


def _ragged_emulation(q, kp, vp, ppos, pages, qpos, lens, window, seg_pages):
    """The kernel's arithmetic in plain torch, in its order: per (segment,
    KV head) the query tile's rows, each warp of a tile over its pages
    (``mma_pages``) in 16-key tiles: float32 scores of the bfloat16
    inputs, masks by kpos, base-2 online softmax, P.V with P split into
    two bfloat16 terms; the warps merged in order, then the row's
    segments in order; the output rounded to bfloat16."""
    from repro_torch.kernels import ragged_attention as RA
    B, C, H, hd = q.shape
    ps, Hkv = kp.shape[1], kp.shape[2]
    G = H // Hkv
    qp = qpos.numpy()
    wl = RA.build_page_worklist(pages.numpy(), lens, qp[:, 0], qp[:, -1], ps,
                                window=window)
    packed, n_seg = RA.pack_worklist(*wl, B, seg_pages=seg_pages)
    row_seg = packed[:B + 1]
    segs = packed[B + 1:B + 1 + 3 * n_seg].reshape(-1, 3)
    wpage = packed[B + 1 + 3 * n_seg:]
    _, _, ksplit = RA.mma_tiles(C, G)
    l2 = float(np.log2(np.e)) / float(np.sqrt(hd))
    bf = lambda t: t.to(torch.bfloat16).float()
    out = torch.zeros((B, C, H, hd))
    neg = float("-inf")

    def merge(states):  # (m, l, acc) in order, base 2
        M = torch.stack([s[0] for s in states]).amax(0)
        L, A = torch.zeros_like(M), torch.zeros_like(states[0][2])
        for m, l, a in states:
            w = torch.where(M == neg, torch.zeros_like(M), torch.exp2(m - M))
            L, A = L + l * w, A + a * w[:, None]
        return M, L, A

    for b in range(B):
        for kvh in range(Hkv):
            rows_q = bf(q[b, :, kvh * G:(kvh + 1) * G]).reshape(C * G, hd)
            rqpos = torch.as_tensor(qp[b]).repeat_interleave(G).float()
            seg_states = []
            for z in range(row_seg[b], row_seg[b + 1]):
                _, lo, hi = segs[z]
                warps = [(torch.full((C * G,), neg), torch.zeros(C * G),
                          torch.zeros((C * G, hd))) for _ in range(ksplit)]
                for _, j, wi in RA.mma_pages(int(lo), int(hi), ksplit):
                    m, l, acc = warps[j]
                    page = int(wpage[wi])
                    for k0 in range(0, ps, 16):
                        k = bf(kp[page, k0:k0 + 16, kvh])
                        v = bf(vp[page, k0:k0 + 16, kvh])
                        kv = ppos[page, k0:k0 + 16].float()
                        ok = (kv[None] >= 0) & (kv[None] <= rqpos[:, None])
                        if window is not None:
                            ok &= rqpos[:, None] - kv[None] < window
                        s = torch.where(ok, (rows_q @ k.T) * l2, torch.full((1,), neg))
                        m_new = torch.maximum(m, s.amax(1))
                        alive = m_new != neg
                        alpha = torch.where(alive, torch.exp2(m - m_new), torch.ones_like(m))
                        p = torch.exp2(s - torch.where(alive, m_new, torch.zeros_like(m))[:, None])
                        phi = bf(p)
                        l = l * alpha + p.sum(1)
                        acc = acc * alpha[:, None] + phi @ v + bf(p - phi) @ v
                        m = m_new
                    warps[j] = (m, l, acc)
                seg_states.append(merge(warps))
            if seg_states:
                _, L, A = merge(seg_states)
                o = torch.where(L[:, None] > 0, A / L[:, None], torch.zeros_like(A))
                out[b, :, kvh * G:(kvh + 1) * G] = bf(o).reshape(C, G, hd)
    return out


RAGGED_EMULATION_CASES = {  # lens, C, H, Hkv, hd, ps, window, seg_pages
    "decode_g4_segments": ([37, 150, 0, 90], 1, 8, 2, 64, 16, 80, 2),
    "admission": ([60], 20, 8, 2, 64, 16, None, 16),
    "g1_pages32": ([70, 33], 3, 4, 4, 64, 32, None, 1),
}


@pytest.mark.parametrize("case", sorted(RAGGED_EMULATION_CASES))
def test_ragged_split_p_emulation_matches_reference(case):
    """The emulated kernel against ``ragged_attention_reference`` in
    float32 on the same bfloat16 inputs: each active row within 2^-7 of
    its own max |reference|; rows without work are 0."""
    from repro_torch.kernels import ragged_attention as RA
    lens, C, H, Hkv, hd, ps, window, seg_pages = RAGGED_EMULATION_CASES[case]
    rng = np.random.default_rng(len(case))
    B, T = len(lens), max(-(-max(lens) // ps), 1) + 1
    Pn = sum(-(-n // ps) for n in lens) + 2
    kp = torch.from_numpy(rng.standard_normal((Pn, ps, Hkv, hd)).astype(np.float32)).to(torch.bfloat16)
    vp = torch.from_numpy(rng.standard_normal((Pn, ps, Hkv, hd)).astype(np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((B, C, H, hd)).astype(np.float32)).to(torch.bfloat16)
    ppos = torch.full((Pn, ps), -1, dtype=torch.int32)
    pages = torch.full((B, T), -1, dtype=torch.int32)
    ids = list(rng.permutation(Pn))
    for b, n in enumerate(lens):
        for o in range(-(-n // ps)):
            pid = int(ids.pop())
            pages[b, o] = pid
            for j in range(min(ps, n - o * ps)):
                ppos[pid, j] = o * ps + j
    qpos = (torch.tensor(lens).clamp(min=C)[:, None] - C + torch.arange(C)).to(torch.int32)
    y = _ragged_emulation(q, kp, vp, ppos, pages, qpos, lens, window, seg_pages)
    ref = RA.ragged_attention_reference(q.float(), kp.float(), vp.float(), ppos, pages,
                                        qpos, window=window)
    for b, n in enumerate(lens):
        if n == 0:
            assert (y[b] == 0).all()
            continue
        err = float((y[b] - ref[b]).abs().max())
        assert err <= RAGGED_BF16_RTOL * float(ref[b].abs().max()), (b, err)


@pytest.mark.parametrize("G", [1, 2, 3, 4, 8, 32])
def test_ragged_mma_tiles_cover_every_row_once(G):
    """Query tiles x heads: every (query, head) row of a KV head falls in
    exactly one block's m16 tile; at most 64 rows and 4 warps a block."""
    from repro_torch.kernels import ragged_attention as RA
    for C in (1, 2, 3, 15, 16, 17, 70, 128, 130):
        ct, tiles, ksplit = RA.mma_tiles(C, G)
        assert 1 <= ct * G <= max(64, G) and tiles * 16 >= ct * G
        assert tiles * ksplit <= 4 and ksplit in (1, 2, 4)
        rows = [(c0 + r // G, r % G) for c0 in range(0, C, ct)
                for r in range(ct * G) if c0 + r // G < C]
        assert sorted(rows) == [(c, h) for c in range(C) for h in range(G)]


@pytest.mark.parametrize("ksplit", [1, 2, 4])
def test_ragged_mma_pages_cover_every_listed_page_once(ksplit):
    """The pages of a packed segment, as the kernel's stages and warps read
    them: every listed entry exactly once, stage by stage."""
    from repro_torch.kernels import ragged_attention as RA
    pages = np.array([[3, 1, 5, -1], [-1, -1, -1, -1], [0, 2, 4, 6]], np.int32)
    wl = RA.build_page_worklist(pages, [40, 0, 60], [39, 0, 59], [39, 0, 59], 16)
    for seg_pages in (1, 2, 3, 16):
        packed, n_seg = RA.pack_worklist(*wl, 3, seg_pages=seg_pages)
        segs = packed[4:4 + 3 * n_seg].reshape(-1, 3)
        seen = [wi for _, lo, hi in segs for _, _, wi in RA.mma_pages(int(lo), int(hi), ksplit)]
        assert seen == list(range(len(packed) - 4 - 3 * n_seg))


def test_wgmma_scope_mirrors_the_flash_kernel_dispatch():
    """The flash wrapper counts a launch as ``wgmma`` exactly where the
    kernel's own dispatch (``tc::takes``) picks that instance: bfloat16,
    head_dim 64 or 128, at most 64 query heads per KV head, 16-byte
    aligned bases, batch / head / row strides a multiple of 8."""
    from repro_torch.kernels import flash_attention as FA
    mk = lambda shape, dt=torch.bfloat16: torch.zeros(shape, dtype=dt)
    q, k = mk((1, 8, 5, 64)), mk((1, 2, 9, 64))
    assert FA.wgmma_scope(q, k, k, torch.empty_like(q))
    assert FA.wgmma_scope(mk((1, 5, 8, 128)).transpose(1, 2),
                          mk((1, 9, 2, 128)).transpose(1, 2),
                          mk((1, 9, 2, 128)).transpose(1, 2), torch.empty_like(q))
    assert not FA.wgmma_scope(q.float(), k.float(), k.float(), q.float())
    q32, k32 = mk((1, 8, 5, 32)), mk((1, 2, 9, 32))
    assert not FA.wgmma_scope(q32, k32, k32, q32)
    assert not FA.wgmma_scope(mk((1, 130, 5, 64)), mk((1, 2, 9, 64)),
                              mk((1, 2, 9, 64)), mk((1, 130, 5, 64)))
    off = mk(q.numel() + 1).reshape(-1)[1:].view(q.shape)  # 2 bytes off
    assert not FA.wgmma_scope(off, k, k, torch.empty_like(q))
    odd = mk((1, 8, 5, 68))[..., :64]  # row stride 68: a multiple of 4 only
    assert not FA.wgmma_scope(odd, k, k, torch.empty_like(q))
