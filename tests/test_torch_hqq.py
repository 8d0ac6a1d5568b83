"""The port's HQQ quantizer (``repro_torch.quant.hqq``) against the JAX
reference's, on the same seeded numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import hqq as J
from repro_torch.quant import hqq as P


def to_port(qt: J.QTensor) -> P.QTensor:
    t = lambda a: torch.from_numpy(np.array(a))
    meta = None if qt.meta is None else {k: t(v) for k, v in qt.meta.items()}
    return P.QTensor(t(qt.packed), t(qt.scale), t(qt.zero), meta, qt.bits,
                     qt.group_size, tuple(qt.shape))


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_pack_unpack_bytes_equal(bits):
    """Packing and unpacking give the reference's bytes, both ways."""
    rng = np.random.default_rng(bits)
    g = 64 if bits == 3 else 16
    q = rng.integers(0, 2 ** bits, (3, 5, g, 24)).astype(np.uint8)
    pj = np.asarray(J.pack_codes(jnp.asarray(q), bits))
    pt = P.pack_codes(torch.from_numpy(q), bits).numpy()
    np.testing.assert_array_equal(pt, pj)
    uj = np.asarray(J.unpack_codes(jnp.asarray(pj), bits, g))
    ut = P.unpack_codes(torch.from_numpy(pj.copy()), bits, g).numpy()
    np.testing.assert_array_equal(ut, uj)
    np.testing.assert_array_equal(ut, q)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_dequantize_of_reference_qtensor_exact(bits):
    """_meta_dequantize and dequantize of a QTensor quantized by the
    reference agree to the bit (atol=0): both compute q*s + m and
    (q - zero)*scale as separate float32 roundings."""
    rng = np.random.default_rng(10 + bits)
    w = rng.standard_normal((2, 256, 96)).astype(np.float32) * 0.05
    qj = J.quantize(jnp.asarray(w), bits)
    qt = to_port(qj)
    sj, zj = J._meta_dequantize(qj)
    st, zt = P._meta_dequantize(qt)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(P.dequantize(qt).numpy(),
                                  np.asarray(J.dequantize(qj)))
    assert P.nbytes(qt) == J.nbytes(qj)
    sub_j, sub_t = J.slice_leading(qj, 1), P.slice_leading(qt, 1)
    assert sub_t.shape == sub_j.shape
    np.testing.assert_array_equal(P.dequantize(sub_t).numpy(),
                                  np.asarray(J.dequantize(sub_j)))


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_quantize_agrees_with_reference(bits):
    """The HQQ zero-point iteration is a float optimisation, so codes may
    differ where a value sits on a rounding edge: require >= 99% of codes
    equal, and relative dequant errors within 1e-3 of each other."""
    rng = np.random.default_rng(20 + bits)
    w = rng.standard_normal((2, 512, 128)).astype(np.float32) * 0.05
    qj = J.quantize(jnp.asarray(w), bits)
    qp = P.quantize(torch.from_numpy(w), bits)
    cj = np.asarray(J.unpack_codes(qj.packed, bits, qj.group_size))
    cp = P.unpack_codes(qp.packed, bits, qp.group_size).numpy()
    agree = float((cj == cp).mean())
    ej = np.linalg.norm(np.asarray(J.dequantize(qj)) - w) / np.linalg.norm(w)
    ep = np.linalg.norm(P.dequantize(qp).numpy() - w) / np.linalg.norm(w)
    print(f"{bits}-bit: code agreement {agree:.5f}, rel err jax {ej:.6f} "
          f"port {ep:.6f}")
    assert agree >= 0.99
    assert abs(ej - ep) <= 1e-3
    assert P.nbytes(qp) == J.nbytes(qj)
