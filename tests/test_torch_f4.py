"""F4 (ROADMAP §3), repaired in the port: chunked admission with
preemption.  In the reference a decoding row that needs its next page
finds no victim while the rows still admitting hold the free pages in
their reservations, and ``_grow_running_rows`` raises mid-serve although
``submit`` accepted every request.  The port then preempts an admitting
row instead: its partial KV and reservation are released and it waits,
ahead of new arrivals of its priority, for a recompute from its prompt.

On ``tiny-moe`` cut to 2 layers (the reference's seeded weights crossed
over by ``repro_torch.bridge``), on the CPU: the minimal case (two
prompts of 19 and 21 tokens, pages of 4, an 11-page pool, chunks of 4)
and a 5-request case, with recompute, with host swap and with a prefix
cache.  The reference raises on each; the port finishes with the B = 1
oracle's tokens (``parity.oracle_streams``), ``check_invariants=True``
after every step, every page back in the pool and the host pool empty.
"""
import jax
import numpy as np
import pytest
import torch

import parity
from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.serving.engine import ContinuousEngine as JContinuous
from repro_torch import bridge
from repro_torch.configs import get_config as pget
from repro_torch.serving.engine import ContinuousEngine as PContinuous

BASE = dict(slot_len=48, kv_page=4, kv_pages_total=11, preemption=True,
            prefill_chunk=4)
CASES = {
    "minimal": ((19, 21), dict(BASE, max_slots=2)),
    "five_recompute": ((19, 21, 13, 17, 9), dict(BASE, max_slots=3)),
    "five_swap": ((19, 21, 13, 17, 9), dict(BASE, max_slots=3,
                                            kv_host_pages=8)),
    "five_prefix": ((19, 21, 13, 17, 9), dict(BASE, max_slots=3,
                                              prefix_cache_pages=4)),
}
NEW = 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jget("tiny-moe").replace(n_layers=2)
    pcfg = pget("tiny-moe").replace(n_layers=2)
    params = JT.init_model(jax.random.key(0), jcfg)
    pp = bridge.params_from_numpy(jax.tree.map(np.asarray, params), pcfg,
                                  "cpu")
    prompts = parity.make_prompts(jcfg, CASES["five_recompute"][0], seed=5)
    oracle = parity.oracle_streams(params, jcfg, prompts, [NEW] * 5)
    return jcfg, pcfg, params, pp, prompts, oracle


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_admission_with_preemption_terminates(model, case):
    jcfg, pcfg, params, pp, prompts, oracle = model
    lens, kw = CASES[case]
    n = len(lens)
    assert [len(p) for p in prompts[:n]] == list(lens)
    jce = JContinuous(params, jcfg, **kw)
    for p in prompts[:n]:
        jce.submit(p, NEW)
    with pytest.raises(RuntimeError, match="nothing left to preempt"):
        jce.run(max_steps=400)
    eng = PContinuous(pp, pcfg, device="cpu", check_invariants=True, **kw)
    reqs = [eng.submit(p, NEW) for p in prompts[:n]]
    eng.run(max_steps=400)
    assert [r.generated for r in reqs] == oracle[:n]
    assert all(r.status == "completed" for r in reqs)
    s = eng.stats()
    assert s["kv_host_preemptions"] > 0
    assert s["kv_host_recomputes"] > 0
    assert s["kv_host_pages_in_use"] == 0 and not eng._swapped
    cached = len(eng._prefix.pages()) if eng._prefix is not None else 0
    assert eng.kv.pool.n_free + cached == eng.kv.pool.n_pages
