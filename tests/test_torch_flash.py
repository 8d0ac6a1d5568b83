"""The port's flash attention against the JAX reference, on the CPU.

* The plain version (``kernels/flash_attention.flash_attention_reference``,
  what ``ops.flash_attention`` runs for CPU tensors) against the
  reference's ``flash_attention_pallas`` in interpret mode (its KV-block
  skip under a causal window, and the dense grid) and, off the Pallas
  kernel's 8 x 128 tiling, against ``flash_attention_ref``: within 2e-5
  of max |reference| (float32, the same sums in another order).
* The dense-ring prefill chunk of ``layers.attention_decode``, which
  takes the flash binding while the ring has not wrapped, against the
  reference's ``attention_decode`` (its ``attention_core``): float32
  within 1e-5; bfloat16 within 2^-6 of the output's max, because the
  reference rounds the softmax weights P to bfloat16 before P.V and the
  flash path keeps them in float32 (one bfloat16 rounding of P, at most
  2^-9 of each weight, carried through P.V and the output projection);
  a chunk that wraps the ring and decode steps take ``attention_core``
  and stay within the float32 tolerance in both dtypes (the reference's
  own computation, cast for cast); the wrapped chunk is held to the
  reference's token-by-token decode, since the reference's own wrapped
  chunk loses keys (ROADMAP queue 3, F1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import ref as JR
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config as pget
from repro_torch.kernels import ops
from repro_torch.models import layers as PL

RTOL = 2e-5


def _qkv(BH, BKV, Sq, Skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BH, Sq, d)).astype(np.float32),
            rng.standard_normal((BKV, Skv, d)).astype(np.float32),
            rng.standard_normal((BKV, Skv, d)).astype(np.float32))


def _port(q, k, v, **kw):
    return ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               **kw).numpy()


PALLAS_CASES = [  # (BH, BKV, Sq, Skv, d, causal, window, q_offset, bq)
    (4, 4, 128, 256, 32, True, None, 128, 128),    # G = 1
    (4, 2, 64, 512, 32, True, 64, 448, 64),        # G = 2, window skips blocks
    (2, 1, 8, 128, 32, True, 16, 100, 8),          # one 8-row query block
    (4, 2, 16, 128, 64, False, None, 0, 8),        # not causal
    (4, 4, 64, 128, 96, True, None, 64, 64),       # head_dim 96 (phi-3)
    (4, 2, 32, 256, 96, True, 48, 224, 32),        # head_dim 96, G = 2, window
]


@pytest.mark.parametrize("case", PALLAS_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_plain_matches_reference_kernel(case):
    """Against ``flash_attention_pallas`` (interpret mode), with the
    windowed KV-block skip and with the dense grid (the same bits)."""
    BH, BKV, Sq, Skv, d, causal, window, q_offset, bq = case
    q, k, v = _qkv(BH, BKV, Sq, Skv, d, seed=Sq + Skv)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ys = [np.asarray(flash_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v)), bq=bq, interpret=True,
        skip_window_blocks=skip, **kw)) for skip in (True, False)]
    np.testing.assert_array_equal(ys[0], ys[1])
    yt = _port(q, k, v, **kw)
    np.testing.assert_allclose(yt, ys[0], rtol=0,
                               atol=RTOL * float(np.abs(ys[0]).max()))


@pytest.mark.parametrize("Sq,Skv,window,q_offset",
                         [(5, 77, None, 72), (13, 200, 24, 150), (1, 9, 4, 8),
                          (70, 70, None, 0)])
def test_plain_off_the_tiling_matches_reference_oracle(Sq, Skv, window,
                                                       q_offset):
    """Shapes the Pallas kernel does not tile (Sq % 8, Skv % 128), GQA
    G = 2, against ``flash_attention_ref``."""
    q, k, v = _qkv(4, 2, Sq, Skv, 32, seed=Sq * Skv)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    yj = np.asarray(JR.flash_attention_ref(
        *(jnp.asarray(a) for a in (q, k, v)), **kw))
    np.testing.assert_allclose(_port(q, k, v, **kw), yj, rtol=0,
                               atol=RTOL * float(np.abs(yj).max()))


def test_rows_without_a_valid_key_are_zero():
    """Rows whose every key lies outside the window give 0 (the kernel's
    ``l == 0`` rule); the others are the reference oracle's."""
    q, k, v = _qkv(2, 1, 6, 20, 32, seed=3)
    kw = dict(causal=True, window=4, q_offset=20)  # rows 20..25 see keys 17..19
    yt = _port(q, k, v, **kw)
    yj = np.asarray(JR.flash_attention_ref(
        *(jnp.asarray(a) for a in (q, k, v)), **kw))
    np.testing.assert_array_equal(yt[:, 3:], 0)
    np.testing.assert_allclose(yt[:, :3], yj[:, :3], rtol=0,
                               atol=RTOL * float(np.abs(yj).max()))


# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def attn():
    jcfg = jget("tiny-moe").replace(n_layers=2, sliding_window=64)
    pcfg = pget("tiny-moe").replace(n_layers=2, sliding_window=64)
    params = JT.init_model(jax.random.key(5), jcfg)
    pparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       pcfg, "cpu")
    p = {k: np.asarray(v) for k, v in JT.layer_params(params, jcfg, 0)["attn"].items()}
    return jcfg, pcfg, p, pparams["layers"][0]["attn"]


# (position, chunk): three flash chunks up to the ring's width 64, then a
# chunk past the wrap and two decode steps through attention_core
CHUNKS = [(0, 16), (16, 24), (40, 24), (64, 8), (72, 1), (73, 1)]
FLASH_CHUNKS = 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_chunks_match_reference(attn, dtype, monkeypatch):
    jcfg, pcfg, p, pp = attn
    jcfg, pcfg = jcfg.replace(dtype=dtype), pcfg.replace(dtype=dtype)
    tdt = getattr(torch, dtype)
    jp = {k: jnp.asarray(v).astype(dtype) for k, v in p.items()}
    pp = {k: v.to(tdt) for k, v in pp.items()}
    calls = []
    flash = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or flash(*a, **kw))
    W = jcfg.sliding_window
    jc = JL.init_attn_cache(jcfg, 2, 128, window=W)
    jd = JL.init_attn_cache(jcfg, 2, 128, window=W)  # token by token
    pc = PL.init_attn_cache(pcfg, 2, 128, "cpu", window=W)
    rng = np.random.default_rng(11)
    for i, (pos, C) in enumerate(CHUNKS):
        x = rng.standard_normal((2, C, jcfg.d_model)).astype(np.float32)
        xj = jnp.asarray(x).astype(dtype)
        yj, jc = JL.attention_decode(jp, jcfg, xj, jc,
                                     jnp.asarray(pos, jnp.int32), window=W)
        yd = []
        for j in range(C):
            y1, jd = JL.attention_decode(jp, jcfg, xj[:, j:j + 1], jd,
                                         jnp.asarray(pos + j, jnp.int32),
                                         window=W)
            yd.append(y1)
        yp, pc = PL.attention_decode(pp, pcfg, torch.from_numpy(x).to(tdt),
                                     pc, pos, window=W)
        if pos + C > W:  # a chunk that wraps: the reference's own chunk
            yj = jnp.concatenate(yd, 1)  # loses keys (ROADMAP queue 3, F1)
        yj = np.asarray(yj.astype(jnp.float32))
        yp = yp.float().numpy()
        flash_path = i < FLASH_CHUNKS
        assert len(calls) == min(i + 1, FLASH_CHUNKS)
        if flash_path:
            assert calls[-1] == dict(causal=True, window=W, q_offset=pos)
        if dtype == "float32" or not flash_path:
            np.testing.assert_allclose(yp, yj, rtol=1e-5, atol=1e-5,
                                       err_msg=f"chunk {i}")
        else:
            np.testing.assert_allclose(yp, yj, rtol=0,
                                       atol=2 ** -6 * float(np.abs(yj).max()),
                                       err_msg=f"chunk {i}")
        np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
