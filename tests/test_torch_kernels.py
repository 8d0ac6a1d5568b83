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
