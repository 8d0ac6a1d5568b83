"""The port's recurrent mixers (``repro_torch.models.recurrent``: RG-LRU,
mLSTM, sLSTM) against the reference's ``repro.models.recurrent`` on the
same numpy inputs, on the CPU in float32, at the ``reduced()`` widths of
``recurrentgemma-9b`` and ``xlstm-1.3b``.

* ``*_decode`` and ``*_chunk``: outputs and carries within rtol = atol =
  2e-5, from the zero state and from a carried nonzero one, at C = 1 and
  C > 1 (both sides fold the chunk step by step).
* ``*_train``: outputs and final carries within rtol 2e-4, atol 2e-5, the
  tolerance the reference holds its own scan form to its step form with
  (the RG-LRU's doubling scan groups the products otherwise).
* ``mlstm_scan_core`` against ``mlstm_recurrent_ref`` inside the port at
  the reference's (S, chunk) cases, 17 over 8 included; the extreme-gate
  case stays finite.

Parameters are the reference-layout numpy draws of ``tests/zoo_models.py``
(its recurrent init distributions), one layer's mixer leaves each.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoo_models as Z
from repro.models import recurrent as JR
from repro_torch.models import recurrent as PR

MIXERS = {"rglru": ("recurrentgemma-9b", 0), "mlstm": ("xlstm-1.3b", 0),
          "slstm": ("xlstm-1.3b", 5)}


@pytest.fixture(scope="module")
def mixers():
    """mixer: (jcfg, pcfg, reference params (jax), port params (torch))."""
    out, trees = {}, {}
    for mixer, (arch, pos) in MIXERS.items():
        if arch not in trees:
            trees[arch] = (*Z.configs(arch),
                           Z.random_params(Z.configs(arch)[0]))
        jc, pc, tree = trees[arch]
        leaves = {k: np.asarray(v)[0]
                  for k, v in tree["stack"][pos][mixer].items()}
        out[mixer] = (jc, pc, {k: jnp.asarray(v) for k, v in leaves.items()},
                      {k: torch.from_numpy(v) for k, v in leaves.items()})
    return out


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _close(got, want, rtol, atol, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], rtol, atol, f"{what}[{k}]")
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


def _jstate(mixer, cfg, B):
    return getattr(JR, f"init_{mixer}_state")(cfg, B)


def _carried(mixer, jc, jp, B):
    """A nonzero carry: the reference's training form over 7 positions."""
    _, st = getattr(JR, f"{mixer}_train")(jp, jc, jnp.asarray(_x(jc, B, 7, 11)))
    return st


@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("start", ["zero", "carried"])
@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_decode_and_chunk_match_reference(mixers, mixer, start, C):
    jc, pc, jp, pp = mixers[mixer]
    B = 2
    jst = (_jstate(mixer, jc, B) if start == "zero"
           else _carried(mixer, jc, jp, B))
    pst = {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}
    x = _x(jc, B, C, 3 + C)
    forms = ["chunk"] + (["decode"] if C == 1 else [])
    for form in forms:
        want_y, want_st = getattr(JR, f"{mixer}_{form}")(jp, jc,
                                                         jnp.asarray(x), jst)
        got_y, got_st = getattr(PR, f"{mixer}_{form}")(pp, pc,
                                                       torch.from_numpy(x),
                                                       pst)
        _close(got_y, want_y, 2e-5, 2e-5, f"{mixer}_{form} y")
        _close(got_st, want_st, 2e-5, 2e-5, f"{mixer}_{form} state")
    # a chunk folds exactly like C decode steps inside the port
    if C > 1:
        st, ys = pst, []
        for t in range(C):
            y, st = getattr(PR, f"{mixer}_decode")(
                pp, pc, torch.from_numpy(x[:, t: t + 1]), st)
            ys.append(y)
        y_c, st_c = getattr(PR, f"{mixer}_chunk")(pp, pc, torch.from_numpy(x),
                                                  pst)
        _close(torch.cat(ys, 1), y_c.detach().numpy(), 1e-6, 1e-6,
               f"{mixer} decode steps vs chunk")
        _close(st, {k: v.numpy() for k, v in st_c.items()}, 1e-6, 1e-6,
               f"{mixer} decode steps vs chunk state")


@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_train_matches_reference(mixers, mixer):
    """S = 32: two mLSTM chunks of 16; the RG-LRU's doubling scan over 5
    levels."""
    jc, pc, jp, pp = mixers[mixer]
    x = _x(jc, 2, 32, 21)
    want_y, want_st = getattr(JR, f"{mixer}_train")(jp, jc, jnp.asarray(x))
    got_y, got_st = getattr(PR, f"{mixer}_train")(pp, pc, torch.from_numpy(x))
    _close(got_y, want_y, 2e-4, 2e-5, f"{mixer}_train y")
    _close(got_st, want_st, 2e-4, 2e-5, f"{mixer}_train state")


def _qkv(B, S, H, dh, seed, lf_shift=2.0, li_shift=-1.0):
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, k, v = n(B, S, H, dh), n(B, S, H, dh), n(B, S, H, dh)
    lf = torch.nn.functional.logsigmoid(n(B, S, H) + lf_shift)
    li = n(B, S, H) + li_shift
    state = {"C": torch.zeros((B, H, dh, dh)), "n": torch.zeros((B, H, dh)),
             "m": torch.zeros((B, H))}
    return q, k, v, lf, li, state


@pytest.mark.parametrize("S,chunk", [(16, 4), (32, 8), (24, 24), (17, 8)])
def test_mlstm_chunkwise_equals_recurrent(S, chunk):
    """The reference's cases, inside the port (17 over 8 runs one chunk
    of 17)."""
    q, k, v, lf, li, state = _qkv(2, S, 2, 16, S * 31 + chunk)
    h_ref, st_ref = PR.mlstm_recurrent_ref(q, k, v, lf, li, state)
    h_chk, st_chk = PR.mlstm_scan_core(q, k, v, lf, li, state, chunk)
    _close(h_chk, h_ref.numpy(), 2e-5, 2e-5, "h")
    _close(st_chk, {k_: t.numpy() for k_, t in st_ref.items()}, 2e-5, 2e-5,
           "state")


def test_mlstm_extreme_gates_stable():
    """Input gates of 50 (e^50 overflows float32 unstabilised) stay
    finite through the chunkwise core and the step form."""
    q, k, v, lf, li, state = _qkv(1, 12, 1, 8, 0)
    lf = torch.full_like(lf, -0.01)
    li = torch.full_like(li, 50.0)
    for h, st in (PR.mlstm_scan_core(q, k, v, lf, li, state, 4),
                  PR.mlstm_recurrent_ref(q, k, v, lf, li, state)):
        assert bool(torch.isfinite(h).all())
        assert all(bool(torch.isfinite(t).all()) for t in st.values())


def test_rglru_softplus_and_gelu_forms():
    """``lam`` far above torch's softplus threshold (20) and the gate
    branch's tanh gelu: the port's gates equal the reference's."""
    jc, pc = Z.configs("recurrentgemma-9b")
    rng = np.random.default_rng(5)
    R = jc.d_model
    leaves = {"w_rec_gate": rng.standard_normal((R, R)) / np.sqrt(R),
              "w_in_gate": rng.standard_normal((R, R)) / np.sqrt(R),
              "lam": np.linspace(-30.0, 30.0, R)}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    xi = rng.standard_normal((2, 3, R)).astype(np.float32)
    wa, wb = JR._rglru_gates({k: jnp.asarray(v) for k, v in leaves.items()},
                             jnp.asarray(xi))
    ga, gb = PR._rglru_gates({k: torch.from_numpy(v)
                              for k, v in leaves.items()}, torch.from_numpy(xi))
    _close(ga, wa, 2e-6, 1e-7, "a")
    _close(gb, wb, 2e-6, 1e-7, "b")
    z = rng.standard_normal(50).astype(np.float32) * 4
    _close(PR._gelu(torch.from_numpy(z)), jax.nn.gelu(jnp.asarray(z)), 1e-6,
           1e-6, "gelu")
