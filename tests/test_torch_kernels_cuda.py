"""The Hopper dequant-matmul kernel against its plain PyTorch version, on
the card.  Every test is marked ``cuda`` and skips without a GPU (the
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
