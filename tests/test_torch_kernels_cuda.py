"""The Hopper kernels (dequant-matmul, ragged paged attention) against
their plain PyTorch versions, on the card.  Every test is marked ``cuda`` and skips without a GPU (the
kernel has no CPU mode).  The file imports no JAX, so it also runs on a
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
