"""The Hopper kernels (dequant-matmul, flash attention, ragged paged
attention) against their plain PyTorch versions, on the card.  Every
test is marked ``cuda`` and skips without a GPU (the kernel has no CPU
mode).  The file imports no JAX, so it also runs on a
GPU machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import ops as PO, ref as PR
from repro_torch.quant import hqq as P


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 3, 8, 19])
def test_kernel_matches_plain_on_card(bits, xdtype, M):
    """Both bindings against the plain version on the same card tensors;
    float32 sums in another order, so 1e-4 of the output's scale."""
    _need_cuda()
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(bits * 100 + M)
    K, N = 512, 320
    qt = P.quantize(torch.randn((5, K, N), generator=gen, device=dev) * 0.05,
                    bits)
    x = torch.randn((4, M, K), generator=gen, device=dev).to(getattr(torch, xdtype))
    slots = torch.tensor([4, 0, 4, 2], dtype=torch.int32, device=dev)
    for y, yp in ((PO.dequant_matmul_slots(x, qt, slots),
                   PR.dequant_matmul_slots(x, qt, slots)),
                  (PO.dequant_matmul_batched(x, qt),
                   PR.dequant_matmul_batched(x, P.QTensor(
                       qt.packed[:4], qt.scale[:4], qt.zero[:4],
                       {k: v[:4] for k, v in qt.meta.items()}, bits,
                       qt.group_size, (4, K, N))))):
        torch.cuda.synchronize()
        tol = 1e-4 * float(yp.abs().max())
        assert float((y - yp).abs().max()) <= tol


# ragged row groups (empty, one row, each row tile 16 / 32 / 64 +- 1,
# groups above 128 rows) and the row tile the kernel picks for them
GROUPED_COUNTS = {"small": ([0, 1, 15, 16, 17, 31, 33, 63], 32),
                  "large": ([130, 0, 200, 1, 64, 129, 65, 256], 64),
                  "tiny": ([3, 5, 1, 2, 0, 4, 7, 1], 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GROUPED_COUNTS))
def test_grouped_kernel_matches_plain_on_card(bits, xdtype, case):
    """``ops.dequant_matmul_batched`` with row offsets (bfloat16: the
    tensor-core kernel, whose row tile follows the group sizes; float32:
    the FMA kernel's ragged entry) against ``ref.dequant_matmul_grouped``
    on the same card tensors, N = 320 (a half-empty last column tile);
    one launch counted per call.  Float32 sums in another order (the
    tensor-core kernel also reassociates (code - zero) * scale), so 1e-4
    of the output's scale."""
    _need_cuda()
    import numpy as np
    from repro_torch.kernels import dequant_matmul as DM
    counts, bm = GROUPED_COUNTS[case]
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(bits * 1000 + sum(counts))
    K, N = 512, 320
    qt = P.quantize(torch.randn((9, K, N), generator=gen, device=dev) * 0.05,
                    bits)
    off = np.concatenate([[0], np.cumsum(counts)])
    x = torch.randn((int(off[-1]), K), generator=gen, device=dev).to(getattr(torch, xdtype))
    before = PO.dequant_matmul_batched.launches
    y = PO.dequant_matmul_batched(x, qt, off)
    yp = PR.dequant_matmul_grouped(x, qt, off)
    torch.cuda.synchronize()
    assert PO.dequant_matmul_batched.launches == before + 1
    assert y.shape == (off[-1], N) and y.dtype == torch.float32
    assert float((y - yp).abs().max()) <= 1e-4 * float(yp.abs().max())
    if xdtype == "bfloat16":
        assert DM.launch_grouped.last_bm == bm


@pytest.mark.cuda
def test_grouped_kernel_refuses_what_it_cannot_read():
    """Offsets that do not rise from 0 to the row count, more groups than
    records, and shapes outside the tensor-core kernel's scope raise."""
    _need_cuda()
    dev = torch.device("cuda")
    qt = P.quantize(torch.randn((2, 256, 128), device=dev), 4)
    x = torch.randn((6, 256), device=dev).to(torch.bfloat16)
    for off in ([0, 4, 5], [1, 3, 6], [0, 4, 2, 6], [0, 2, 4, 6]):
        with pytest.raises(ValueError):
            PO.dequant_matmul_batched(x, qt, off)
    odd = P.quantize(torch.randn((2, 256, 96), device=dev), 4)  # N % 64
    with pytest.raises(ValueError):
        PO.dequant_matmul_batched(x, odd, [0, 3, 6])
    g32 = P.quantize(torch.randn((2, 256, 128), device=dev), 4, group_size=32)
    with pytest.raises(ValueError):
        PO.dequant_matmul_batched(x, g32, [0, 3, 6])
    y = PO.dequant_matmul_batched(x.float(), odd, [0, 3, 6])  # float32: FMA kernel
    torch.cuda.synchronize()
    assert y.shape == (6, 96)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_read():
    """On the card there is no fall back: a QTensor without meta, a
    non-contiguous x, an x dtype the kernel does not read or a CPU slot
    map raise."""
    _need_cuda()
    dev = torch.device("cuda")
    w = torch.randn((2, 256, 128), device=dev)
    x = torch.randn((2, 1, 256), device=dev)
    with pytest.raises(ValueError):
        PO.dequant_matmul_batched(x, P.quantize(w, 4, scale_group=0))
    qt = P.quantize(w, 4)
    strided = torch.randn((2, 1, 512), device=dev)[..., ::2]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError):
        PO.dequant_matmul_batched(strided, qt)
    with pytest.raises(TypeError):
        PO.dequant_matmul_batched(x.half(), qt)
    with pytest.raises(ValueError):
        PO.dequant_matmul_slots(x, qt, torch.tensor([0, 1], dtype=torch.int32))


# ----------------------------------------------------------------------
# the ragged paged-attention kernel
def _paged_case(gen, dev, dtype, lens, C, H, Hkv, hd, ps, pad=0, spare=3):
    """Random pages for rows of live lengths ``lens`` (0 = idle row), the
    queries at the last C positions of each row, and the work list."""
    from repro_torch.kernels import ragged_attention as RA
    B, T = len(lens), max(-(-max(lens) // ps), 1) + 1
    P = sum(-(-n // ps) for n in lens) + spare
    kp = torch.randn((P, ps, Hkv, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, ps, Hkv, hd), generator=gen, device=dev).to(dtype)
    ppos = torch.full((P, ps), -1, dtype=torch.int32)
    pages = torch.full((B, T), -1, dtype=torch.int32)
    ids = torch.randperm(P, generator=torch.Generator().manual_seed(P)).tolist()
    for b, n in enumerate(lens):
        for o in range(-(-n // ps)):
            pid = ids.pop()
            pages[b, o] = pid
            for j in range(ps):
                if o * ps + j < n:
                    ppos[pid, j] = o * ps + j
    lens_t = torch.tensor(lens)
    qpos = (lens_t.clamp(min=C)[:, None] - C + torch.arange(C)).to(torch.int32)
    q = torch.randn((B, C, H, hd), generator=gen, device=dev).to(dtype)
    return q, kp, vp, ppos.to(dev), pages, qpos.to(dev), lens


def _device_worklist(wl, n_rows, dev, **kw):
    from repro_torch.kernels import ragged_attention as RA
    packed, n_seg = RA.pack_worklist(*wl, n_rows, **kw)
    return RA.DeviceWorklist(torch.from_numpy(packed).to(dev), n_seg)


def _row_errors_within(out, plain32, active, rtol):
    """Each active row's max |out - plain32| within ``rtol`` of that row's
    own max |plain32|."""
    for b in torch.nonzero(active).flatten().tolist():
        ref = plain32[b]
        err = (out[b].float() - ref).abs().max().item()
        assert err <= rtol * ref.abs().max().item(), (b, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("C", [1, 3, 70])
def test_ragged_kernel_matches_plain_on_card(dtype, window, C):
    """Rows of different live lengths, an idle row (no work item: zeros),
    padding entries, rows split into several segments; active rows
    against the plain version run in float32 on the same (upcast)
    inputs.  float32 within 2e-5 (the same sums in another order);
    bfloat16 within 2^-7 of each row's own max |plain|: the kernel
    accumulates in float32 and rounds only its output to bfloat16, at
    most half a unit in the last place (2^-8 of the value)."""
    _need_cuda()
    from repro_torch.kernels import ops, ragged_attention as RA
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(7 + C)
    dt = getattr(torch, dtype)
    rtol = 2 ** -7 if dtype == "bfloat16" else None
    for H, Hkv, hd, ps in ((8, 4, 32, 16), (32, 8, 128, 16), (4, 4, 64, 8)):
        q, kp, vp, ppos, pages, qpos, lens = _paged_case(
            gen, dev, dt, [C + 40, 0, C + 5, C + 130], C, H, Hkv, hd, ps)
        qp = qpos.cpu().numpy()
        wl = RA.build_page_worklist(pages.numpy(), lens, qp[:, 0], qp[:, -1],
                                    ps, window=window, pad_to=64)
        before = ops.ragged_attention.launches
        out = ops.ragged_attention(q, kp, vp, ppos, pages, qpos,
                                   window=window,
                                   worklist=_device_worklist(wl, len(lens), dev))
        plain = RA.ragged_attention_reference(q.float(), kp.float(),
                                              vp.float(), ppos, pages, qpos,
                                              window=window)
        torch.cuda.synchronize()
        assert ops.ragged_attention.launches == before + 1
        active = torch.tensor([n > 0 for n in lens], device=dev)
        # rows cut into segments of 3 pages: the combine pass merges them
        split_wl = _device_worklist(wl, len(lens), dev, seg_pages=3)
        split = RA.launch(q, kp, vp, ppos, qpos, split_wl, window=window)
        torch.cuda.synchronize()
        assert split_wl.n_seg > sum(n > 0 for n in lens)
        for y in (out, split):
            if rtol is None:
                err = (y[active] - plain[active]).abs().max().item()
                assert err <= 2e-5, (H, hd, err)
            else:
                _row_errors_within(y, plain, active, rtol)
            assert (y[~active] == 0).all()


@pytest.mark.cuda
def test_ragged_kernel_refuses_what_it_cannot_read():
    """No quiet plain path on the card: no work list, a work list of host
    arrays, a float16 or non-contiguous q, a head_dim the kernel has no
    instance for."""
    _need_cuda()
    from repro_torch.kernels import ops, ragged_attention as RA
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    q, kp, vp, ppos, pages, qpos, lens = _paged_case(
        gen, dev, torch.float32, [20, 9], 1, 8, 4, 32, 16)
    host_wl = RA.build_page_worklist(pages.numpy(), lens, qpos.cpu()[:, 0],
                                     qpos.cpu()[:, -1], 16)
    wl = _device_worklist(host_wl, len(lens), dev)
    with pytest.raises(ValueError):
        ops.ragged_attention(q, kp, vp, ppos, pages, qpos)
    with pytest.raises(TypeError):  # host arrays: the caller packs and uploads
        ops.ragged_attention(q, kp, vp, ppos, pages, qpos, worklist=host_wl)
    with pytest.raises(ValueError):
        ops.ragged_attention(q.half(), kp.half(), vp.half(), ppos, pages,
                             qpos, worklist=wl)
    strided = torch.randn((2, 1, 16, 32), device=dev)[:, :, ::2]
    with pytest.raises(ValueError):
        ops.ragged_attention(strided, kp, vp, ppos, pages, qpos, worklist=wl)
    q48 = torch.randn((2, 1, 8, 48), device=dev)
    kp48 = torch.randn(kp.shape[:3] + (48,), device=dev)
    with pytest.raises(ValueError):
        ops.ragged_attention(q48, kp48, kp48, ppos, pages, qpos, worklist=wl)


# ----------------------------------------------------------------------
# the 2-D binding of the dequant-matmul kernel (its B = 1 case)
@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("M", [1, 5, 16])
def test_dequant_matmul_2d_matches_plain_on_card(bits, M):
    """``ops.dequant_matmul`` on one 2-D weight, and on a view of one
    record of a stack (read in place), against the plain version; counts
    one launch per call.  1e-4 of the output's scale: float32 sums in
    another order."""
    _need_cuda()
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(bits * 10 + M)
    K, N = 512, 320
    stack = P.quantize(torch.randn((3, K, N), generator=gen, device=dev) * 0.05,
                       bits)
    one = P.quantize(torch.randn((K, N), generator=gen, device=dev) * 0.05, bits)
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    before = PO.dequant_matmul.launches
    for qt in (one, P.slice_leading(stack, 2)):
        y, yp = PO.dequant_matmul(x, qt), PR.dequant_matmul(x, qt)
        torch.cuda.synchronize()
        assert y.shape == (M, N) and y.dtype == torch.float32
        assert float((y - yp).abs().max()) <= 1e-4 * float(yp.abs().max())
    assert PO.dequant_matmul.launches == before + 2


@pytest.mark.cuda
def test_dequant_matmul_2d_refuses_what_it_cannot_read():
    """A stacked weight, a non-contiguous x and a float16 x raise."""
    _need_cuda()
    dev = torch.device("cuda")
    qt = P.quantize(torch.randn((256, 128), device=dev), 4)
    with pytest.raises(AssertionError):
        PO.dequant_matmul(torch.randn((1, 256), device=dev),
                          P.quantize(torch.randn((2, 256, 128), device=dev), 4))
    with pytest.raises(ValueError):
        PO.dequant_matmul(torch.randn((2, 512), device=dev)[:, ::2], qt)
    with pytest.raises(TypeError):
        PO.dequant_matmul(torch.randn((2, 256), device=dev).half(), qt)


# ----------------------------------------------------------------------
# the flash-attention kernel
FLASH_CASES = [  # (B, H, Hkv, Sq, Skv, hd, causal, window, q_offset)
    (1, 4, 4, 64, 64, 32, True, None, 0),
    (2, 8, 4, 70, 200, 64, True, None, 130),     # ragged edges, GQA 2
    (1, 32, 8, 64, 64, 128, True, 4096, 0),      # the main path's chunk
    (1, 8, 2, 130, 400, 128, True, 96, 270),     # window skips KV tiles
    (2, 4, 1, 1, 37, 64, True, 8, 36),           # one query row
    (1, 4, 2, 33, 90, 32, False, None, 0),       # not causal
    (1, 4, 2, 40, 50, 32, True, 5, 100),         # rows with no valid key
    # the wgmma instance (head_dim 64 / 128): G = 1, 4, 8 query heads per KV
    # head stacked as rows, Sq off the tile, one row, windows, q_offset, and
    # both 64-row (few blocks) and 128-row blocks
    (1, 8, 8, 100, 300, 128, True, None, 200),   # G 1
    (1, 16, 4, 77, 77, 64, True, None, 0),       # G 4
    (1, 16, 2, 45, 180, 128, True, 64, 135),     # G 8, window
    (2, 32, 8, 1, 500, 128, True, 4096, 499),    # one row
    (1, 32, 8, 300, 300, 128, True, None, 0),    # Sq off the tile
    (1, 8, 1, 90, 90, 64, False, None, 0),       # G 8, not causal
    (1, 32, 8, 700, 700, 128, True, None, 0),    # 128-row blocks
    (1, 32, 8, 600, 2000, 128, True, 256, 1400), # 128-row blocks, window
    (1, 4, 4, 40, 50, 64, True, 5, 100),         # rows with no valid key
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_matches_plain_on_card(dtype, case):
    """``ops.flash_attention`` on (B, H, S, d) views of (B, S, H, d)
    tensors (the model's layout, read through strides) against the plain
    version run in float32 on the same (upcast) inputs.  float32 within
    2e-5 of each (head, row)'s max |plain| (the same sums in another
    order); bfloat16 within 2^-7 of it: the kernel accumulates in float32
    and rounds only its output (the wgmma instance keeps P to ~16 bits
    through P.V).  Rows without a valid key are 0.  The 3-D (BH, S,
    d) layout gives the same bits; an unaligned q takes the other
    instance and the same tolerance."""
    _need_cuda()
    from repro_torch.kernels import flash_attention as FA
    B, H, Hkv, Sq, Skv, hd, causal, window, q_offset = case
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(Sq * 7 + Skv)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Sq, H, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((B, Skv, Hkv, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((B, Skv, Hkv, hd), generator=gen, device=dev).to(dt)
    qv, kv, vv = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = PO.flash_attention.launches
    out = PO.flash_attention(qv, kv, vv, **kw)
    plain = FA.flash_attention_reference(qv.float(), kv.float(), vv.float(), **kw)
    flat = PO.flash_attention(qv.reshape(B * H, Sq, hd),
                              kv.contiguous().reshape(B * Hkv, Skv, hd),
                              vv.contiguous().reshape(B * Hkv, Skv, hd), **kw)
    # q one element off its 16-byte alignment: bfloat16 takes the kernel's
    # float32-FMA instance instead of the tensor-core one
    qu = torch.empty(q.numel() + 1, dtype=dt, device=dev)[1:].view(q.shape)
    qu.copy_(q)
    off = PO.flash_attention(qu.transpose(1, 2), kv, vv, **kw)
    torch.cuda.synchronize()
    assert PO.flash_attention.launches == before + 3
    assert out.shape == qv.shape and out.dtype == dt
    assert out.transpose(1, 2).is_contiguous()  # written in q's layout
    assert torch.equal(flat.reshape(B, H, Sq, hd), out)
    rtol = 2e-5 if dtype == "float32" else 2 ** -7
    scale = plain.abs().amax(-1)
    for y in (out, off):
        err = (y.float() - plain).abs().amax(-1)
        assert bool((err <= rtol * scale).all()), float((err - rtol * scale).max())
    empty = ~FA._valid(Sq, Skv, causal, window, q_offset, dev).any(-1)
    assert bool((out[:, :, empty] == 0).all())


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_cannot_read():
    """No quiet plain path on the card: float16, a head_dim without an
    instance, a strided last dimension, heads that do not divide, mixed
    dtypes."""
    _need_cuda()
    dev = torch.device("cuda")
    q = torch.randn((4, 8, 32), device=dev)
    k = torch.randn((2, 16, 32), device=dev)
    with pytest.raises(ValueError):
        PO.flash_attention(q.half(), k.half(), k.half())
    q48, k48 = torch.randn((4, 8, 48), device=dev), torch.randn((2, 16, 48), device=dev)
    with pytest.raises(ValueError):
        PO.flash_attention(q48, k48, k48)
    with pytest.raises(ValueError):
        PO.flash_attention(torch.randn((4, 8, 64), device=dev)[..., ::2], k, k)
    with pytest.raises(ValueError):
        PO.flash_attention(q, torch.randn((3, 16, 32), device=dev),
                           torch.randn((3, 16, 32), device=dev))
    with pytest.raises(ValueError):
        PO.flash_attention(q, k.to(torch.bfloat16), k.to(torch.bfloat16))


# ----------------------------------------------------------------------
# the tensor-core decode GEMV (csrc/dequant_gemv.cu): the slot and 2-D
# bindings' route for bfloat16 x with at most 8 rows per record
def _gemv_case(bits, S, K, N, seed):
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(seed)
    qt = P.quantize(torch.randn((S, K, N), generator=gen, device=dev) * 0.05, bits)
    return dev, gen, qt


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("M", [1, 2, 8, 9])
def test_gemv_matches_plain_on_card(bits, B, M):
    """``ops.dequant_matmul_slots`` with bfloat16 x against the plain
    version, repeated slots, N = 320 (a half-empty last column tile):
    M <= 8 takes the tensor-core GEMV, M = 9 the FMA kernel; one launch
    counted per call.  1e-4 of the output's scale: float32 sums in
    another order (the GEMV also reassociates (code - zero) * scale)."""
    _need_cuda()
    from repro_torch.kernels import dequant_matmul as DM
    dev, gen, qt = _gemv_case(bits, 5, 512, 320, bits * 1000 + B * 10 + M)
    x = torch.randn((B, M, 512), generator=gen, device=dev).to(torch.bfloat16)
    slots = torch.tensor([4, 0, 4, 2, 1, 1, 3, 4][:B], dtype=torch.int32, device=dev)
    before, routes = PO.dequant_matmul_slots.launches, dict(DM.launch.routes)
    y = PO.dequant_matmul_slots(x, qt, slots)
    yp = PR.dequant_matmul_slots(x, qt, slots)
    torch.cuda.synchronize()
    assert PO.dequant_matmul_slots.launches == before + 1
    assert DM.launch.routes["gemv" if M <= 8 else "fma"] == routes["gemv" if M <= 8 else "fma"] + 1
    assert y.shape == (B, M, 320) and y.dtype == torch.float32
    assert float((y - yp).abs().max()) <= 1e-4 * float(yp.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 3])
def test_gemv_cluster_split_at_mixtral_shape(bits):
    """The down projection's shape (K = 14336, N = 4096): K split over a
    cluster of 2 blocks, the partial sums met through distributed shared
    memory; the 2-D binding on one record of the stack agrees."""
    _need_cuda()
    from repro_torch.kernels import dequant_matmul as DM
    dev, gen, qt = _gemv_case(bits, 3, 14336, 4096, bits)
    assert DM.gemv_cluster(14336, 4096) == 2
    x = torch.randn((2, 1, 14336), generator=gen, device=dev).to(torch.bfloat16)
    slots = torch.tensor([2, 0], dtype=torch.int32, device=dev)
    gemv = DM.launch.routes["gemv"]
    y = PO.dequant_matmul_slots(x, qt, slots)
    yp = PR.dequant_matmul_slots(x, qt, slots)
    y2 = PO.dequant_matmul(x[1], P.slice_leading(qt, 0))
    torch.cuda.synchronize()
    assert DM.launch.routes["gemv"] == gemv + 2
    assert float((y - yp).abs().max()) <= 1e-4 * float(yp.abs().max())
    assert torch.equal(y2, y[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_gemv_rows_do_not_depend_on_batch_or_slot_map(bits):
    """A record's output row is the same bits whatever B, the slot map
    and the row's place in the batch are, and the 2-D binding gives the
    same bits: the planes' tokens depend on it."""
    _need_cuda()
    dev, gen, qt = _gemv_case(bits, 6, 4096, 1024, 7 * bits)
    x = torch.randn((1, 1, 4096), generator=gen, device=dev).to(torch.bfloat16)
    ys = []
    for slot_list in ([3], [1, 3], [5, 0, 2, 3, 3, 1, 4, 0]):
        B = len(slot_list)
        xb = torch.randn((B, 1, 4096), generator=gen, device=dev).to(torch.bfloat16)
        i = slot_list.index(3)
        xb[i] = x[0]
        slots = torch.tensor(slot_list, dtype=torch.int32, device=dev)
        ys.append(PO.dequant_matmul_slots(xb, qt, slots)[i])
    ys.append(PO.dequant_matmul(x[0], P.slice_leading(qt, 3)))
    torch.cuda.synchronize()
    for y in ys[1:]:
        assert torch.equal(y, ys[0])


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 3])
def test_gemv_reads_overflow_records_in_place(bits):
    """Slots into the overflow records of a pool's served view (one
    buffer, records after the layer's own slots, read in place through
    the per-leaf record stride), repeated, against the plain version."""
    _need_cuda()
    from repro_torch.core import expert_pool as EP
    from repro_torch.kernels import dequant_matmul as DM
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(11 * bits)
    D, F = 256, 320
    experts = {"w_gate": torch.randn((4, D, F), generator=gen, device=dev) * 0.05,
               "w_up": torch.randn((4, D, F), generator=gen, device=dev) * 0.05,
               "w_down": torch.randn((4, F, D), generator=gen, device=dev) * 0.05}
    qts = EP.quantize_experts(experts, bits)
    layout = EP.RecordLayout.of(qts, 1)
    src = EP.Tier(layout, 1, 4, dev)
    EP.write_layer(src, 0, qts)
    tier = EP.Tier(layout, 2, 2, dev, extra=4)
    for i in range(tier.flat.shape[0]):
        tier.flat[i].copy_(src.flat[i % 4])
    view = tier.served(1)  # records 0, 1: layer 1's slots; 2 .. 5: overflow
    slots = torch.tensor([5, tier.extra_index(1, 0), 5, 1], dtype=torch.int32, device=dev)
    x = torch.randn((4, 1, D), generator=gen, device=dev).to(torch.bfloat16)
    for qt in (view.w_gate, view.w_up):
        gemv = DM.launch.routes["gemv"]
        y, yp = PO.dequant_matmul_slots(x, qt, slots), PR.dequant_matmul_slots(x, qt, slots)
        torch.cuda.synchronize()
        assert DM.launch.routes["gemv"] == gemv + 1
        assert float((y - yp).abs().max()) <= 1e-4 * float(yp.abs().max())


@pytest.mark.cuda
def test_gemv_refuses_what_it_cannot_read():
    """``launch_gemv`` alone raises outside its scope: float32 x, 9 rows
    per record, K off the 64-k stage, N off 16 columns, a group size the
    kernel has no instance for, an x off its 16-byte alignment."""
    _need_cuda()
    from repro_torch.kernels import dequant_matmul as DM
    dev = torch.device("cuda")
    qt = P.quantize(torch.randn((2, 256, 128), device=dev), 4)
    x = torch.randn((2, 1, 256), device=dev).to(torch.bfloat16)
    DM.launch_gemv(x, qt, None)
    for bad in (x.float(), torch.randn((2, 9, 256), device=dev).to(torch.bfloat16)):
        with pytest.raises(ValueError):
            DM.launch_gemv(bad, qt, None)
    with pytest.raises(ValueError):  # K = 80: 2-bit groups of 16, not whole stages
        DM.launch_gemv(torch.randn((2, 1, 80), device=dev).to(torch.bfloat16),
                       P.quantize(torch.randn((2, 80, 128), device=dev), 2), None)
    with pytest.raises(ValueError):  # N = 40
        DM.launch_gemv(x, P.quantize(torch.randn((2, 256, 40), device=dev), 4), None)
    with pytest.raises(ValueError):  # group size 32
        DM.launch_gemv(x, P.quantize(torch.randn((2, 256, 128), device=dev), 4,
                                     group_size=32), None)
    xu = torch.empty(2 * 256 + 1, dtype=torch.bfloat16, device=dev)[1:].view(2, 1, 256)
    xu.copy_(x)
    with pytest.raises(ValueError):
        DM.launch_gemv(xu, qt, None)
    y = PO.dequant_matmul_batched(xu.float(), qt)  # the binding still serves it elsewhere
    torch.cuda.synchronize()
    assert y.shape == (2, 1, 128)


# ----------------------------------------------------------------------
# the tensor-core ragged kernel (csrc/ragged_mma.cu): bfloat16, head_dim
# 64/128, pages of a multiple of 16 positions
RAGGED_MMA_CASES = {  # name: (lens, C, H, Hkv, hd, ps, window)
    "decode_g4": ([37, 300, 1500, 4200], 1, 32, 8, 128, 16, 4096),
    "decode_idle_rows": ([0, 700, 0, 45], 1, 32, 8, 128, 16, None),
    "admission": ([200], 128, 32, 8, 128, 16, 4096),
    "admission_window": ([300, 0, 180], 70, 16, 4, 64, 16, 40),
    "g1_pages32": ([90, 600], 3, 8, 8, 128, 32, None),
    "g8_hd64": ([33, 250], 5, 16, 2, 64, 16, 100),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", sorted(RAGGED_MMA_CASES))
def test_ragged_mma_matches_plain_on_card(dtype, case):
    """``ops.ragged_attention``: bfloat16 takes the tensor-core kernel,
    float32 the warp-reduction kernel; active rows against the plain
    version run in float32 on the same (upcast) inputs: bfloat16 within
    2^-7 of each row's own max |plain| (float32 sums, P kept to ~16 bits,
    the output rounded once), float32 within 2e-5.  Idle rows are 0.  A
    second call gives the same bits (the merge counters are left zero),
    and rows cut into segments of 3 pages agree too."""
    _need_cuda()
    from repro_torch.kernels import ops, ragged_attention as RA
    lens, C, H, Hkv, hd, ps, window = RAGGED_MMA_CASES[case]
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(sum(lens) + C)
    dt = getattr(torch, dtype)
    q, kp, vp, ppos, pages, qpos, lens = _paged_case(gen, dev, dt, lens, C, H, Hkv, hd, ps)
    qp = qpos.cpu().numpy()
    n_live = [n if n > 0 else 0 for n in lens]
    wl = RA.build_page_worklist(pages.numpy(), n_live, qp[:, 0], qp[:, -1], ps,
                                window=window)
    work = _device_worklist(wl, len(lens), dev)
    before, routes = ops.ragged_attention.launches, dict(RA.launch.routes)
    out = ops.ragged_attention(q, kp, vp, ppos, pages, qpos, window=window, worklist=work)
    route = next(r for r, n in RA.launch.routes.items() if n == routes[r] + 1)
    again = ops.ragged_attention(q, kp, vp, ppos, pages, qpos, window=window, worklist=work)
    split = RA.launch(q, kp, vp, ppos, qpos, _device_worklist(wl, len(lens), dev, seg_pages=3),
                      window=window)
    plain = RA.ragged_attention_reference(q.float(), kp.float(), vp.float(), ppos, pages,
                                          qpos, window=window)
    torch.cuda.synchronize()
    assert ops.ragged_attention.launches == before + 2
    assert route == ("mma" if dtype == "bfloat16" else "warp")
    assert torch.equal(out, again)
    active = torch.tensor([n > 0 for n in lens], device=dev)
    for y in (out, split):
        if dtype == "float32":
            err = (y[active] - plain[active]).abs().max().item()
            assert err <= 2e-5, err
        else:
            _row_errors_within(y, plain, active, 2 ** -7)
        assert (y[~active] == 0).all()
    if dtype == "bfloat16":
        assert int(RA._counters(dev, 1).abs().sum()) == 0


@pytest.mark.cuda
def test_ragged_mma_refuses_what_it_cannot_read():
    """``launch_mma`` alone raises outside its scope: float32, head_dim
    32, pages of 8 positions; the binding serves those on the other
    kernel."""
    _need_cuda()
    from repro_torch.kernels import ragged_attention as RA
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(5)
    for dt, hd, ps in ((torch.float32, 64, 16), (torch.bfloat16, 32, 16),
                       (torch.bfloat16, 64, 8)):
        q, kp, vp, ppos, pages, qpos, lens = _paged_case(gen, dev, dt, [20, 9], 1, 8, 4, hd, ps)
        qp = qpos.cpu().numpy()
        wl = _device_worklist(RA.build_page_worklist(pages.numpy(), lens, qp[:, 0],
                                                     qp[:, -1], ps), 2, dev)
        with pytest.raises(ValueError):
            RA.launch_mma(q, kp, vp, ppos, qpos, wl)
        warp = RA.launch.routes["warp"]
        RA.launch(q, kp, vp, ppos, qpos, wl)
        torch.cuda.synchronize()
        assert RA.launch.routes["warp"] == warp + 1


@pytest.mark.cuda
def test_flash_and_grouped_launches_count_their_routes():
    """``flash_attention.launch.routes`` and
    ``dequant_matmul.launch_grouped.routes`` count each launch under the
    instance it ran: bfloat16 head_dim 64 on ``wgmma``, float32 and an
    unaligned q on the FMA instance; bfloat16 groups on the grouped
    kernel, float32 on the FMA kernel's ragged entry."""
    _need_cuda()
    from repro_torch.kernels import dequant_matmul as DM, flash_attention as FA
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(16)
    q = torch.randn((1, 8, 70, 64), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((1, 2, 90, 64), generator=gen, device=dev).to(torch.bfloat16)
    qu = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(q.shape)
    qu.copy_(q)
    before = dict(FA.launch.routes)
    for args in ((q, k, k), (q.float(), k.float(), k.float()), (qu, k, k)):
        PO.flash_attention(*args, causal=True)
    assert FA.launch.routes["wgmma"] == before["wgmma"] + 1
    assert FA.launch.routes["fma"] == before["fma"] + 2
    qt = P.quantize(torch.randn((3, 256, 128), generator=gen, device=dev) * 0.05, 3)
    x = torch.randn((7, 256), generator=gen, device=dev)
    before = dict(DM.launch_grouped.routes)
    for xx in (x.to(torch.bfloat16), x):
        PO.dequant_matmul_batched(xx, qt, [0, 2, 2, 7])
    torch.cuda.synchronize()
    assert DM.launch_grouped.routes["grouped"] == before["grouped"] + 1
    assert DM.launch_grouped.routes["fma"] == before["fma"] + 1
