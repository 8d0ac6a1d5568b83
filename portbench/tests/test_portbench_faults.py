"""A whole run on the CPU at small widths, past the look for a card: sound,
it is correct; with the timed path broken underneath, ``correct`` comes
out false, for each fault a cell can have: a token altered where it is
produced, a step that returns its state unchanged, half of the batch
left out, and a wrong record in the expert pool.  One chip, so no
exchange between chips to leave out.  The judge compares the numbers
that the cell's limits name (the Granite-shaped case, which has no cell
yet, Mixtral chat's), each held at these widths to 1e-3.  The control's
readings (``portbench/control.py``) at small widths: the program
correct, the float8 control and the planted expert fault not."""
import contextlib
import json

import numpy as np
import pytest

from portbench import control as C, run as R
from portbench.tests.conftest import ROOT, small, small_mix

# case: (configuration, mix, the cell whose limits and metrics it takes)
CELLS = {"mixtral-offload.chat": ("mixtral-offload", "chat", "mixtral-offload.chat"),
         "granite-moe-1b-a400m.chat": ("granite-moe-1b-a400m", "chat",
                                       "mixtral-offload.chat"),
         "mixtral-offload.long_prompt": ("mixtral-offload", "long_prompt",
                                         "mixtral-offload.long_prompt")}


def _limits(cell):
    """The cell's compared numbers at small widths: in float32 the program
    and the reference agree to rounding there (sound runs read 0), so each
    is held to 1e-3, and the small mixes compare tens of tokens."""
    lim = R.load_limits(CELLS[cell][2])
    return dict({k: 1e-3 for k in lim}, min_positions=10)


def _metrics(cell):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return R.cell_metrics(bench, CELLS[cell][2])


def _run(cell, seed=2**31 + 3):
    cfg, mix = small(CELLS[cell][0]), small_mix(CELLS[cell][1])
    e2e, per = _metrics(cell)
    return R.run_cell(cfg, mix, seed, 1.0, False, "cpu", e2e, per,
                      _limits(cell), log=lambda m: None)


@contextlib.contextmanager
def altered_tokens():
    from repro_torch.core import offload_engine as OE
    from repro_torch.serving import engine as EN
    rows, one = EN.ContinuousEngine._sample_rows, OE.sample

    def wrong_rows(self, *a, **kw):
        return (rows(self, *a, **kw) + 1) % 256

    def wrong_one(*a, **kw):
        return (one(*a, **kw) + 1) % 256
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(EN.ContinuousEngine, "_sample_rows", wrong_rows)
        mp.setattr(OE, "sample", wrong_one)
        yield


@contextlib.contextmanager
def state_unchanged():
    from repro_torch.models import transformer as T
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "advance", lambda state, C, **kw: state["pos"])
        yield


@contextlib.contextmanager
def half_the_batch():
    from repro_torch.runtime.executor import Executor
    orig = Executor.decode

    def decode(self, state, tokens, pstate=None, active=None, **kw):
        if active is not None and active.sum() > 1:
            active = active.copy()
            active[np.flatnonzero(active)[::2]] = False
        return orig(self, state, tokens, pstate, active, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Executor, "decode", decode)
        yield


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    # the result line's schema: the reader's keys, the compared numbers last,
    # each beside its limit; on the CPU no peak of device memory is read
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    assert out["failed"] == 0 and out["attempted"] > 0
    # every end-to-end metric of the cell but the device's peak
    e2e, _ = _metrics(cell)
    assert set(out["metrics"]) == {m["name"] for m in e2e} - {"peak_device_gib"}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())


FAULTS = [(c, f) for c in sorted(CELLS) for f in ("token", "state", "half", "expert")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_path_is_not_correct(cell, fault):
    ctx = {"token": altered_tokens, "state": state_unchanged,
           "half": half_the_batch, "expert": C.wrong_expert_slots}[fault]
    with ctx():
        out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["mixtral-offload.chat", "mixtral-offload.long_prompt"])
def test_traced_run_reports_per_layer_metrics(cell):
    """A traced run reports the cell's per-layer metrics and no end-to-end
    one; on the CPU only the counters' and the host clock's (the profiler
    sees no device)."""
    cfg, mix = small(CELLS[cell][0]), small_mix(CELLS[cell][1])
    e2e, per = _metrics(cell)
    out = R.run_cell(cfg, mix, 5, 1.0, True, "cpu", e2e, per,
                     _limits(cell), log=lambda m: None)
    assert out["correct"]
    names = set(out["metrics"])
    assert names <= {m["name"] for m in per}
    counted = {"expert_hit_ratio", "h2d_bytes_per_token", "rows_per_step",
               "prefill_tokens_per_s", "output_tokens_per_s", "ttft_p95_ms",
               "itl_p95_ms"}
    assert {n.split(".")[0] for n in names} == counted & {m["name"].split(".")[0] for m in per}


@pytest.mark.parametrize("cell", ["mixtral-offload.chat", "mixtral-offload.long_prompt"])
def test_control_readings_decide_as_a_run_does(cell):
    """The control's readings go through the judge's own decision: the
    sound program correct, the float8 control and the planted expert
    fault not."""
    cfg, mix = small(CELLS[cell][0]), small_mix(CELLS[cell][1])
    out = C.readings(cfg, mix, _limits(cell), 2**31 + 5, 1.0, "cpu",
                     fault_seconds=1.0)
    assert out["program"]["correct"], out["program"]
    assert not out["control"]["correct"], out["control"]
    assert not out["fault"]["correct"], out["fault"]
    served = [g for r in out["gaps"]["served"] for g in r]
    assert len(served) == out["program"]["positions"]
    assert max(served) == out["program"]["served_gap"]
