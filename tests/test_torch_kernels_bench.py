"""The port's kernels suite (``repro_torch.benchmarks.kernels_bench``) on
the CPU, against the reference's ``benchmarks/kernels_bench.py``.

* ``run(quick=..., device="cpu")`` prints and writes one row for each of
  the reference's rows under the port's names (its ``*_ref_*_jit`` rows
  as ``*_plain_*``), never a kernel row: no kernel runs on the CPU.
* Group (a)'s inputs, drawn with numpy, through the reference's
  functions and the port's plain versions in float32, within 1e-5 of the
  reference's largest value: ``dequant_matmul_ref`` on the reference's
  ``hqq.quantize`` output against the port's ``ref.dequant_matmul`` on
  the same codes, scales and meta; ``flash_attention_ref``;
  ``attention_core``.
* The shape-derived bounds of group (b) against the figures PERF.md
  states, the stored bytes of a record against ``hqq.quantize``'s
  leaves, a group (b) case for each of the five kernel bindings, and the
  kernels line's entries built from the records.

Group (b) itself runs on the card only (``python -m
repro_torch.benchmarks.run --only kernels``, and ``chip_smoke.py``).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.common as JC
import benchmarks.kernels_bench as JKB
from repro.kernels import ref as JR
from repro.models import layers as JL
from repro.quant import hqq as J
from repro_torch.benchmarks import common, kernels_bench as KB
from repro_torch.kernels import flash_attention as FA, ops, ref as PR
from repro_torch.models import layers as PL
from repro_torch.quant import hqq as P

from test_torch_hqq import to_port


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_name(name):
    """The port's name of a reference row."""
    return name.replace("_ref_", "_plain_").removesuffix("_jit")


@pytest.fixture(scope="module")
def reference_quick_rows(tmp_path_factory):
    """The reference suite's quick rows (its jnp paths), written aside."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JC, "BENCH_OUT", tmp_path_factory.mktemp("ref_bench"))
    try:
        yield JKB.run(quick=True)
    finally:
        mp.undo()


@pytest.mark.parametrize("quick", [True, False])
def test_suite_runs_on_cpu(quick, reference_quick_rows, monkeypatch,
                           tmp_path, capsys):
    monkeypatch.setattr(common, "BENCH_OUT", tmp_path)
    rows = KB.run(quick=quick, device="cpu")
    want = [_port_name(r["name"]) for r in reference_quick_rows]
    assert want == ["dequant_matmul_plain_2bit", "dequant_matmul_plain_4bit",
                    "dequant_matmul_plain_8bit", "flash_attention_plain",
                    "model_chunked_attention"]
    assert [r["name"] for r in rows] == want
    out = capsys.readouterr().out.splitlines()
    for r in rows:
        assert float(r["us_per_call"]) > 0 and r["device"] == "cpu"
        assert f"{r['name']},{r['us_per_call']},{r['derived']}" in out
    gflops = [r for r in rows if r["name"] != "model_chunked_attention"]
    assert all(r["derived"].startswith("gflops=") for r in gflops)
    assert json.loads((tmp_path / "kernels.json").read_text()) == rows


def _allclose(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("bits", KB.REF_BITS)
def test_plain_dequant_matmul_matches_reference(bits):
    a = KB.reference_inputs(quick=True)
    qj = J.quantize(jnp.asarray(a["w"]), bits, group_size=KB.REF_GROUP,
                    scale_group=None)
    scale, zero = J._meta_dequantize(qj)
    want = np.asarray(JR.dequant_matmul_ref(
        jnp.asarray(a["x"]), qj.packed, scale, zero, bits=bits,
        group_size=KB.REF_GROUP))
    got = PR.dequant_matmul(torch.from_numpy(a["x"]), to_port(qj)).numpy()
    _allclose(got, want)
    # and the port's own quantization of the same weights: the same codes
    qp = P.quantize(torch.from_numpy(a["w"]), bits, group_size=KB.REF_GROUP,
                    scale_group=None)
    np.testing.assert_array_equal(qp.packed.numpy(), np.asarray(qj.packed))


def test_plain_flash_attention_matches_reference():
    a = KB.reference_inputs(quick=True)
    want = np.asarray(JR.flash_attention_ref(
        *(jnp.asarray(a[k]) for k in "qkv"), causal=True))
    got = FA.flash_attention_reference(
        *(torch.from_numpy(a[k]) for k in "qkv"), causal=True).numpy()
    _allclose(got, want)


def test_model_chunked_attention_matches_reference():
    a = KB.reference_inputs(quick=True)
    S = a["qq"].shape[1]
    want = np.asarray(JL.attention_core(
        *(jnp.asarray(a[k]) for k in ("qq", "kk", "vv")),
        jnp.arange(S, dtype=jnp.int32), jnp.arange(S, dtype=jnp.int32),
        causal=True, window=None))
    pos = torch.arange(S, dtype=torch.int32)
    got = PL.attention_core(*(torch.from_numpy(a[k]) for k in ("qq", "kk", "vv")),
                            pos, pos, causal=True, window=None).numpy()
    _allclose(got, want)


# PERF.md §6, the kernel table's bounds: the 2-bit slot binding at B = 2
# and the 2-D binding over Mixtral's three expert matrices, and the flash
# kernel's 64 x 64 prefill chunk at H 32 / Hkv 8 / hd 128, window 4096
@pytest.mark.parametrize("case,perf_ms", [
    ("dequant_matmul_slots", 0.0400),
    ("dequant_matmul", 0.0200),
    ("flash_chunk", 0.00039)])
def test_bounds_match_perf(case, perf_ms):
    if case == "flash_chunk":
        name, Sq, Skv, q_offset, window = KB.FLASH_CASES[0]
        assert name == "prefill_chunk"
        work = KB.flash_work(Sq, Skv, q_offset, window, *KB.MIXTRAL_HEADS)
    else:
        work = KB.dequant_layer_work(case, 2)
    ms, by = KB.bound(*work)
    assert by == "bytes"
    assert ms == pytest.approx(perf_ms, rel=5e-3)  # three significant digits


def test_reference_flash_bound_counts_causal_pairs():
    """Group (a)'s causal flash row is bound by the S (S + 1) / 2 pairs
    the kernel computes, not the reference's full square (which only its
    GFLOP/s counts): 0.0160 ms at the f32 peak (PERF.md §6)."""
    _, (BH, BKV, S, d), _ = KB.ref_shapes(quick=False)
    nbytes, ops_ = KB.flash_work(S, S, 0, None, BH, BKV, d, elem=4)
    assert ops_ == 4 * BH * d * S * (S + 1) // 2
    assert nbytes == 2 * BH * S * d * 4 + 2 * BKV * S * d * 4
    ms, by = KB.bound(nbytes, ops_, KB.F32_FLOP_PER_S)
    assert by == "operations"
    assert ms == pytest.approx(0.0160, rel=5e-3)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_record_bytes_match_quantize(bits):
    """The shape-derived bytes of a record equal ``hqq.quantize``'s
    leaves: the Mixtral shapes' K at the scheme's groups (N cut to 8: the
    bytes are linear in N) and group (a)'s groups of 64."""
    for K, N, gs in ((4096, 8, None), (14336, 8, None), (1024, 16, 64)):
        w = torch.from_numpy(np.random.default_rng(K).standard_normal(
            (1, K, N)).astype(np.float32))
        qt = P.quantize(w, bits, group_size=gs, iters=1)
        assert KB.record_bytes(K, N, bits, gs) == KB.stored_bytes(qt, 1)
        rows, want = 3, (KB.stored_bytes(qt, 1) + 3 * K * 2 + 3 * N * 4,
                         2 * 3 * K * N)
        assert KB.dequant_work(rows, K, N, bits, 1, group_size=gs) == want


def test_every_binding_has_a_case():
    """The case tables give each of the five bindings a group (b) case,
    and the kernels line's entry of each is a case the tables name."""
    bindings = {fn.__name__ for fn in ops.BINDINGS}
    assert set(KB.MAIN_CASES) == bindings
    assert set(KB.DEQUANT_CASES) == bindings - {"ragged_attention",
                                                "flash_attention"}
    assert all(ragged and flash for _, _, ragged, _, flash in KB.ATTENTION_MODELS)
    names = {f"{n}_{bits}bit" for n in KB.DEQUANT_CASES for bits in KB.DEQUANT_BITS}
    for suffix, _, ragged, _, flash in KB.ATTENTION_MODELS:
        names |= {f"ragged{suffix}_{c[0]}" for c in ragged}
        names |= {f"flash{suffix}_{c[0]}" for c in flash}
    assert set(KB.MAIN_CASES.values()) <= names


def test_entries_take_the_main_case_and_the_largest_errors():
    recs = [dict(name="ragged_decode", binding="ragged_attention", ms=1.0,
                 max_abs_err=0.1),
            dict(name="ragged-hd96_decode", binding="ragged_attention", ms=2.0,
                 max_abs_err=0.3),
            dict(name="dequant_matmul_2bit", binding="dequant_matmul", ms=3.0,
                 max_abs_err=0.0, max_rel_err=0.0, previous_max_abs_err=0.5),
            dict(name="dequant_matmul_3bit", binding="dequant_matmul", ms=4.0,
                 max_abs_err=0.2, max_rel_err=0.1, previous_max_abs_err=0.4),
            dict(name="dequant_matmul_tiny_moe_256x512", binding="dequant_matmul",
                 ms=5.0, max_abs_err=0.6, max_rel_err=0.2)]
    got = KB.entries(recs)
    assert set(got) == {"ragged_attention", "dequant_matmul"}
    assert got["ragged_attention"]["ms"] == 1.0
    assert got["ragged_attention"]["max_abs_err"] == 0.3
    assert got["dequant_matmul"]["ms"] == 3.0
    assert (got["dequant_matmul"]["max_abs_err"], got["dequant_matmul"]["max_rel_err"],
            got["dequant_matmul"]["previous_max_abs_err"]) == (0.6, 0.2, 0.5)
    assert recs[0]["max_abs_err"] == 0.1  # the records are left as they were


def test_ragged_work_counts_visible_keys():
    """The ragged bound's operations count each query's visible keys:
    causal and inside the window, over the live positions of its row."""
    lens, C, heads, window = [37, 300, 1500, 4200], 1, KB.MIXTRAL_HEADS, 4096
    nbytes, flops, wl, visited = KB.ragged_work(lens, C, heads, window)
    keys = sum(min(n, window) for n in lens)  # decode: the last position each
    assert flops == 4 * heads[0] * heads[2] * keys
    pages_needed = sum(-(-n // KB.PAGE) - max(0, (n - window) // KB.PAGE)
                       for n in lens)
    assert visited == pages_needed
    page = 2 * KB.PAGE * heads[1] * heads[2] * 2 + KB.PAGE * 4
    assert nbytes == visited * page + 2 * len(lens) * C * heads[0] * heads[2] * 2


def test_timeit_host_clock_on_cpu():
    calls = []
    us, out = common.timeit(lambda t: calls.append(1) or t + 1,
                            torch.zeros(3), warmup=2, iters=4)
    assert us > 0 and len(calls) == 6 and out.tolist() == [1.0, 1.0, 1.0]
