"""The dequant-matmul bindings of the port (``repro_torch.kernels.ops``)
against the JAX reference's ``kernels/ops``.

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
from repro.quant import hqq as J
from repro_torch.kernels import ops as PO

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


def test_cpu_tensors_take_plain_version_and_do_not_count():
    qj, x = _case(3, 1, 256, 96, seed=5)
    PO.reset_launches()
    y = PO.dequant_matmul_slots(torch.from_numpy(x), to_port(qj),
                                torch.tensor([1, 2, 3], dtype=torch.int32))
    assert y.dtype == torch.float32 and tuple(y.shape) == (3, 1, 96)
    assert PO.launches() == {"dequant_matmul_batched": 0,
                             "dequant_matmul_slots": 0,
                             "ragged_attention": 0}
