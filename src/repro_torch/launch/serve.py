"""Serving launcher of the port (the reference's ``launch/serve.py``), all
three modes, on the card unless ``--device cpu``:

* static batched serving (``ServeEngine.serve_batch``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny-moe \\
        --prompt "def main(" --max-new 64

* continuous batching with simulated arrivals::

    ... --continuous [--n-requests 16] [--arrival-rate 0.5] \\
        [--max-slots 4] [--slot-len 256] [--policy overlap] [--kv-page 16]

* the paper's offloaded interactive mode, batch 1 (MoE archs)::

    ... --offload [--quantize] [--cache-size 4] [--num-speculative 2]

  (``--quantize`` runs the packed mode: HQQ-packed experts streamed
  through the device pool, the expert matmuls on the dequant kernels);

* continuous batching over the offloaded pool:
  ``--continuous --offload --quantize``, with the paged plane's prefix
  cache, preemption, host pages, ``--inject-faults``, ``--cancel-every``,
  deadlines, the queue cap and drafts as flags.

Every flag of the reference's parser is here with its default, except
``--roofline-hw``: the port's cost model has one measured row, ``h100``,
the default; the reference's rows are refused by name.  One flag is
added, ``--device``.  ``--metrics-json`` / ``--trace`` write the
telemetry plane's snapshot and Chrome trace, which
``tools/check_metrics_schema.py`` validates.

Width: on the CPU a config with ``d_model > 1024`` or a vocabulary over
100k is served as its ``reduced()`` variant, as the reference's launcher
does on its host; on the card it is served as published, and the
launcher says so.  A packed offload run without a checkpoint draws its
weights one layer at a time (``offload_engine.init_packed_model``), so
a model whose dense experts exceed the card's memory still starts.  A
model whose resident weights exceed the card's free memory (a 64-layer
``command-r-plus-104b``: ~208 GB in bf16) is refused with the bytes it
needs and the bytes free (``cost_model.check_fits``); there is no
layer-cut flag.  The recurrent configs (``recurrentgemma-9b``,
``xlstm-1.3b``) serve like the others.  The encoder-decoder
(``whisper-medium``, 1024 wide, not reduced) serves with ``--continuous``:
each request gets a seeded stub frontend (``default_rng(seed + 1)``,
``(encoder_seq, d_model)`` float32 frames), encoded once at admission;
static mode is refused, as in the reference.  Random weights come
from ``--seed`` through the port's own generator, so the tokens equal
the reference's only on shared weights: ``--checkpoint`` reads the
reference's checkpoint files.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import OffloadSpec
from repro_torch.core import cost_model as CM
from repro_torch.data.pipeline import decode_bytes, encode_text
from repro_torch.models import transformer as T
from repro_torch.obs import Telemetry
from repro_torch.obs.roofline import hardware
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.sampler import SamplerConfig


def resolve_offload_spec(spec, cache_size=None, num_speculative=None):
    """Overlay CLI offload overrides on an arch's :class:`OffloadSpec`.

    ``None`` means "flag not given"; 0 is a real value: the paper's k = 0
    (no cache) and no-speculation ablations must not fall back to the
    arch defaults."""
    if cache_size is None and num_speculative is None:
        return spec
    return dataclasses.replace(
        spec,
        cache_size=spec.cache_size if cache_size is None else cache_size,
        num_speculative=(spec.num_speculative if num_speculative is None
                         else num_speculative))


def resolve_top_k(cfg, top_k_override):
    """Router top-k override: serve an MoE arch with fewer experts per
    token than it was trained with; each dropped expert is h2d traffic
    the offloaded decode never pays.  ``None`` keeps the arch's top_k; 0
    or negative is an error (never a fall-through to the default); values
    above the arch's top_k clamp down to it."""
    if top_k_override is None:
        return cfg
    if cfg.moe is None:
        raise ValueError(
            f"--top-k-override targets MoE routing; {cfg.name} is dense")
    k = int(top_k_override)
    if k <= 0:
        raise ValueError(
            f"--top-k-override must be >= 1 (got {k}); every token "
            f"routes to at least one expert")
    k = min(k, cfg.moe.top_k)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, top_k=k))


def resolve_draft(draft_config, num_draft_tokens):
    """CLI speculation flags -> ``(draft_config_name, k)``: on iff a draft
    config is given and k resolves >= 1; k defaults to 4 with a draft;
    ``--num-draft-tokens 0`` disables."""
    if draft_config is None:
        return None, 0
    k = 4 if num_draft_tokens is None else int(num_draft_tokens)
    if k <= 0:
        return None, 0
    return draft_config, k


def resolve_kv_features(prefix_cache, preemption, kv_host_pages):
    """CLI prefix-cache / preemption flags -> ``(prefix_cache_pages,
    preemption_bool, kv_host_pages)``.  ``None`` means "flag not given";
    0 is a real value (``--prefix-cache 0``: no cache; ``--kv-host-pages
    0``: every preemption recomputes)."""
    pc = 0 if prefix_cache is None else int(prefix_cache)
    if pc < 0:
        raise ValueError(f"--prefix-cache must be >= 0 pages (got {pc}); "
                         f"0 disables the cache")
    pre = preemption == "on"
    if kv_host_pages is not None and not pre:
        raise ValueError(
            "--kv-host-pages sizes the swap pool preemption stages "
            "pages into; add --preemption on (0 with preemption on is "
            "the recompute-only ablation)")
    hp = 0 if kv_host_pages is None else int(kv_host_pages)
    if hp < 0:
        raise ValueError(f"--kv-host-pages must be >= 0 (got {hp}); "
                         f"0 means every preemption recomputes")
    return pc, pre, hp


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", "--config", dest="arch", default="tiny-moe",
                    choices=list_archs(),
                    help="config id (--config is an alias); the "
                         "reference's zoo names are refused at run time")
    ap.add_argument("--top-k-override", type=int, default=None,
                    metavar="K",
                    help="route each token to min(K, arch top_k) experts "
                         "(0/negative is an error)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--prompt", action="append", default=None)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--offload", action="store_true")
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--cache-size", type=int, default=None)
    ap.add_argument("--num-speculative", type=int, default=None)
    ap.add_argument("--draft-config", default=None, choices=list_archs(),
                    help="draft-and-verify decoding with this dense draft "
                         "(greedy output equal to plain decode)")
    ap.add_argument("--num-draft-tokens", type=int, default=None,
                    help="draft tokens per verify round (default 4 with "
                         "--draft-config; 0 disables)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching with simulated arrivals")
    ap.add_argument("--n-requests", type=int, default=12)
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="P(new request arrives) per decode step")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--slot-len", type=int, default=256)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="admit prompts C tokens per step")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="per-step token cap (decode rows + prefill "
                         "chunks); default max_slots + prefill_chunk")
    ap.add_argument("--kv-page", type=int, default=None,
                    help="block-paged KV: page size in positions")
    ap.add_argument("--kv-pages-total", type=int, default=None,
                    help="shared page-pool size (default: full "
                         "provisioning)")
    ap.add_argument("--prefix-cache", type=int, default=None,
                    metavar="PAGES",
                    help="radix prefix cache of up to PAGES full prompt "
                         "pages (needs --kv-page; 0 disables)")
    ap.add_argument("--preemption", default="off", choices=["off", "on"],
                    help="optimistic admission with preemption (needs "
                         "--kv-page)")
    ap.add_argument("--kv-host-pages", type=int, default=None, metavar="N",
                    help="host swap pool in pages (needs --preemption on; "
                         "0: every preemption recomputes)")
    ap.add_argument("--inject-faults", default=None, metavar="SPEC",
                    help="seeded fault schedule, e.g. "
                         "'expert_fetch=0.05,nan_logits@2,slow_step@5:25' "
                         "(seeded by --seed; needs --continuous)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request wall-clock deadline")
    ap.add_argument("--queue-cap", type=int, default=None,
                    help="bounded admission queue")
    ap.add_argument("--cancel-every", type=int, default=None, metavar="N",
                    help="cancel every Nth submitted request once it has "
                         "emitted a token")
    ap.add_argument("--policy", default="overlap",
                    choices=["fcfs", "overlap"])
    ap.add_argument("--sampler", default="greedy",
                    choices=["greedy", "categorical", "topk"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the namespaced metrics snapshot (validated "
                         "by tools/check_metrics_schema.py) and turn on "
                         "step/request timing and the roofline")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace_event JSON of the request "
                         "lifecycles and step phases")
    ap.add_argument("--roofline-hw", default="h100",
                    help="cost-model row of the roofline: the port has "
                         "h100 only (measured on the card)")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    return ap


def make_telemetry(args) -> Telemetry:
    """CLI flags -> :class:`Telemetry` (off when neither output was asked
    for: the engines then carry no instrumentation)."""
    if args.metrics_json is None and args.trace is None:
        return Telemetry.off()
    return Telemetry(timing=True, trace=args.trace is not None,
                     roofline_hw=args.roofline_hw)


def write_outputs(args, obs, mode) -> None:
    if args.metrics_json is not None:
        obs.write_metrics(args.metrics_json, mode)
        print(f"[obs] metrics -> {args.metrics_json}")
    if args.trace is not None:
        obs.write_trace(args.trace)
        print(f"[obs] trace   -> {args.trace} "
              f"({len(obs.tracer.events)} events; load in chrome://tracing)")


def print_telemetry_summary(obs) -> None:
    """End-of-run summary from the registry: the numbers the snapshot
    carries."""
    snap = obs.snapshot()
    phases = ("plan", "chunk", "dispatch", "sync", "sample", "host")
    step = snap.get("step")
    if step and step["timed"]:
        total = sum(step[f"{p}_ns"] for p in phases)
        shares = " ".join(f"{p}={100 * step[f'{p}_ns'] / max(1, total):.0f}%"
                          for p in phases)
        wall = step["wall_ms"]
        print(f"[obs] step wall p50={wall['p50']:.2f}ms "
              f"p95={wall['p95']:.2f}ms over {step['timed']} timed steps; "
              f"phases: {shares}")
    roof = snap.get("roofline")
    if roof and roof["windows"]:
        print(f"[obs] roofline({roof['hw']}): measured "
              f"{roof['measured_tok_s']:.2f} tok/s vs predicted "
              f"{roof['predicted_tok_s']:.2f} tok/s "
              f"(delta x{roof['delta_ratio']:.2f}); h2d "
              f"{roof['measured_h2d_bytes_per_token']/1e6:.2f}MB/tok vs "
              f"naive {roof['naive_h2d_bytes_per_token']/1e6:.2f}MB/tok "
              f"(saves x{roof['h2d_savings_ratio']:.1f})")


def print_spec_summary(obs) -> None:
    spec = obs.snapshot().get("spec")
    if spec and spec["rounds"]:
        print(f"[spec] {spec['rounds']} verify rounds, acceptance "
              f"{spec['acceptance_rate']:.2f}, "
              f"{spec['bytes_h2d_per_accepted']/1e6:.2f}MB h2d per "
              f"emitted token")


def _check_flags(args):
    """The reference's flag combinations; returns the resolved
    (prefix pages, preemption, host pages, draft name, draft k)."""
    if args.kv_page is not None and not args.continuous:
        raise SystemExit("--kv-page targets the continuous engine's "
                         "slotted KV plane; add --continuous")
    try:
        prefix_pages, preempt, host_pages = resolve_kv_features(
            args.prefix_cache, args.preemption, args.kv_host_pages)
    except ValueError as e:
        raise SystemExit(str(e))
    if (prefix_pages or preempt) and not args.continuous:
        raise SystemExit("--prefix-cache/--preemption target the "
                         "continuous engine's paged KV plane; add "
                         "--continuous --kv-page")
    if ((args.inject_faults or args.deadline_ms is not None
         or args.queue_cap is not None or args.cancel_every is not None)
            and not args.continuous):
        raise SystemExit("--inject-faults/--deadline-ms/--queue-cap/"
                         "--cancel-every target the continuous engine's "
                         "request lifecycle; add --continuous")
    if ((args.metrics_json is not None or args.trace is not None)
            and not (args.continuous or args.offload)):
        raise SystemExit("--metrics-json/--trace instrument the continuous "
                         "and offload engines; add --continuous or "
                         "--offload")
    draft_name, draft_k = resolve_draft(args.draft_config,
                                        args.num_draft_tokens)
    if draft_name is not None and not (args.offload or args.continuous):
        raise SystemExit("--draft-config targets the offload and "
                         "continuous engines; add --offload or "
                         "--continuous")
    if draft_name is not None and args.sampler != "greedy":
        raise SystemExit("--draft-config needs --sampler greedy (the "
                         "acceptance rule compares argmax streams)")
    try:
        hardware(args.roofline_hw)
    except ValueError as e:
        raise SystemExit(f"--roofline-hw: {e}")
    return prefix_pages, preempt, host_pages, draft_name, draft_k


def _config(args, dev):
    """The served config: on the CPU a config wider than d_model 1024 or a
    vocabulary of 100k reduced as the reference's launcher does; the
    router top-k override applied; an encoder-decoder refused outside
    ``--continuous``."""
    cfg = get_config(args.arch)
    if cfg.vocab_size > 100_000 or cfg.d_model > 1024:
        if dev.type == "cpu":
            cfg = cfg.reduced()
            print(f"[serve] using reduced variant: {cfg.name}")
        else:
            print(f"[serve] {cfg.name} at its published width on "
                  f"{torch.cuda.get_device_name(dev)}: {cfg.n_layers} "
                  f"layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}")
    try:
        cfg = resolve_top_k(cfg, args.top_k_override)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.top_k_override is not None:
        print(f"[serve] router top-k override: {cfg.moe.top_k} "
              f"experts/token")
    if cfg.is_encoder_decoder and not args.continuous:
        raise SystemExit(
            f"{cfg.name} is encoder-decoder: serve it with --continuous "
            f"(the frontend output is encoded once at admission into the "
            f"shared encoder-KV plane)")
    return cfg


def main(argv=None):
    args = build_parser().parse_args(argv)
    prefix_pages, preempt, host_pages, draft_name, draft_k = \
        _check_flags(args)
    telem = make_telemetry(args)
    dev = resolve_device(args.device)
    t_setup = time.perf_counter()
    cfg = _config(args, dev)
    if args.offload and cfg.moe is None:
        raise SystemExit("--offload targets MoE archs (the paper's "
                         "technique needs routed experts)")
    spec = resolve_offload_spec(cfg.offload or OffloadSpec(),
                                args.cache_size, args.num_speculative)
    CM.check_fits(CM.resident_bytes(cfg, packed=args.offload and args.quantize),
                  f"{cfg.name} ({cfg.n_layers} layers, {cfg.dtype} weights)",
                  dev)
    packed = None  # (size report, store) of a packed model drawn here
    if args.checkpoint:
        from repro_torch.checkpoint.checkpointer import restore
        params = restore(args.checkpoint, cfg, device=dev)
    elif args.offload and args.quantize:
        from repro_torch.core.offload_engine import init_packed_model
        params, *packed = init_packed_model(cfg, spec, seed=args.seed,
                                            device=dev)
    else:
        params = T.init_model(cfg, seed=args.seed, device=dev)
    prompts = args.prompt or ["def main(", "import os\n"]
    enc = [encode_text(p) % cfg.vocab_size for p in prompts]

    offload_eng = None
    if args.offload:
        from repro_torch.core.offload_engine import OffloadEngine
        if args.continuous and not args.quantize:
            raise SystemExit("--continuous --offload needs --quantize (the "
                             "buffer pool serves HQQ-packed experts)")
        draft = None
        if draft_name is not None and not args.continuous:
            from repro_torch.core.draft import make_draft
            draft = make_draft(draft_name, seed=args.seed, device=dev)
        eng = OffloadEngine(params, cfg, spec, quantized=args.quantize,
                            store=packed[1] if packed else None, device=dev,
                            telemetry=None if args.continuous else telem,
                            draft=draft, num_draft_tokens=draft_k)
        if packed:
            eng.size_report = packed[0]
        offload_eng = eng if args.continuous else None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"[serve] setup {time.perf_counter() - t_setup:.1f} s "
              f"(weights, quantization, store of "
              f"{(eng.store.nbytes() if eng.store is not None else 0) / 2**30:.2f}"
              f" GiB)")
    if args.offload and not args.continuous:
        _serve_offload(args, eng, cfg, prompts, enc, draft_k)
    elif args.continuous:
        _serve_continuous(args, params, cfg, dev, enc, offload_eng, telem,
                          prefix_pages, preempt, host_pages, draft_name,
                          draft_k)
    else:
        eng = ServeEngine(params, cfg, SamplerConfig(kind=args.sampler),
                          device=dev)
        try:
            served = eng.serve_batch([Request(e, args.max_new) for e in enc],
                                     seed=args.seed)
        except ValueError as e:
            raise SystemExit(f"serve_batch: {e}")
        for p, r in zip(prompts, served):
            print(f"--- prompt {p!r}\n"
                  f"gen: {decode_bytes(np.array(r.completed))!r}")


def _serve_offload(args, eng, cfg, prompts, enc, draft_k):
    """Batch-1 offloaded generation of each prompt, with the cost model's
    estimate on the port's one hardware row."""
    for p, e in zip(prompts, enc):
        out, stats = eng.generate(e[None], args.max_new)
        t = eng.last_timing
        print(f"--- prompt {p!r}")
        print("gen:", repr(decode_bytes(out[0])))
        print(f"stats: hit_ratio={stats.hit_ratio:.3f} "
              f"demand={stats.demand_loads} spec_hits={stats.spec_hits} "
              f"spec_loads={stats.spec_loads} "
              f"h2d={stats.bytes_h2d/1e6:.1f}MB")
        print(f"timing: prefill {t['prefill_s']:.3f} s, decode "
              f"{t['decode_steps'] / max(1e-9, t['decode_s']):.2f} tok/s "
              f"({t['decode_steps']} steps) on {eng.device}")
        print(f"  h100  : {eng.throughput_estimate(stats, 'h100'):.2f} "
              f"tok/s (cost model @ {cfg.name} scale)")
    if eng.size_report:
        print("quantized sizes:", {k: f"{v/1e6:.1f}MB"
                                   for k, v in eng.size_report.items()})
    if eng.device.type == "cuda":
        print(f"[serve] peak device memory "
              f"{torch.cuda.max_memory_allocated(eng.device) / 2**30:.2f} GiB")
    print_telemetry_summary(eng.obs)
    print_spec_summary(eng.obs)
    write_outputs(args, eng.obs, {
        "engine": "offload", "arch": cfg.name,
        "offloaded": True, "timing": eng.obs.timing,
        "plane": eng._exec.plane, "roofline": eng.obs.timing,
        "speculative": draft_k > 0})


def _serve_continuous(args, params, cfg, dev, enc, offload_eng, telem,
                      prefix_pages, preempt, host_pages, draft_name,
                      draft_k):
    """Seeded Bernoulli arrivals per step into the continuous engine,
    requests streamed as they finish (the reference's loop)."""
    from repro_torch.serving.engine import ContinuousEngine
    from repro_torch.serving.scheduler import ExpertOverlapPolicy, fcfs_policy
    policy = (ExpertOverlapPolicy(params, cfg)
              if args.policy == "overlap" and cfg.moe is not None
              else fcfs_policy)
    draft_params, draft_cfg = None, None
    if draft_name is not None:
        draft_cfg = get_config(draft_name)
        draft_params = T.init_model(draft_cfg, seed=args.seed, device=dev)
    faults = None
    if args.inject_faults:
        from repro_torch.serving.faults import FaultInjector
        try:
            faults = FaultInjector.parse(args.inject_faults, seed=args.seed)
        except ValueError as e:
            raise SystemExit(f"--inject-faults: {e}")
    try:
        eng = ContinuousEngine(
            params, cfg, max_slots=args.max_slots, slot_len=args.slot_len,
            sampler=SamplerConfig(kind=args.sampler), policy=policy,
            prefill_chunk=args.prefill_chunk,
            token_budget=args.token_budget, seed=args.seed,
            offload=offload_eng, kv_page=args.kv_page,
            kv_pages_total=args.kv_pages_total,
            prefix_cache_pages=prefix_pages, preemption=preempt,
            kv_host_pages=host_pages, telemetry=telem,
            draft_params=draft_params, draft_cfg=draft_cfg,
            num_draft_tokens=draft_k, faults=faults,
            queue_cap=args.queue_cap, deadline_ms=args.deadline_ms,
            device=dev)
    except ValueError as e:
        raise SystemExit(f"--continuous: {e}")

    def on_finish(req):
        print(f"[step {eng.step_count:4d}] req {req.rid} finished "
              f"({req.finish_reason}, waited "
              f"{req.arrival}→{eng.step_count}): "
              f"{decode_bytes(np.array(req.generated))!r}")

    arrivals = np.random.default_rng(args.seed)
    # an encoder-decoder's requests need a frontend output each; with no
    # audio pipeline a seeded stub stands in for it (the reference's)
    frontend = np.random.default_rng(args.seed + 1)
    submitted = 0
    pending_cancel = []
    # a preempted request is neither waiting nor running while off the
    # device: the loop drains the swapped ones too
    while (submitted < args.n_requests or eng.sched.has_waiting
           or eng.sched.n_running or eng._swapped):
        idle = (not eng.sched.has_waiting and eng.sched.n_running == 0
                and not eng._swapped)
        while (submitted < args.n_requests
               and (idle or arrivals.random() < args.arrival_rate)):
            idle = False
            extras = None
            if cfg.is_encoder_decoder:
                extras = {"audio_embeds": frontend.standard_normal(
                    (cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
            try:
                req = eng.submit(enc[submitted % len(enc)], args.max_new,
                                 on_finish=on_finish, extras=extras)
            except ValueError as err:
                raise SystemExit(f"--continuous: {err} (raise --slot-len "
                                 f"or lower --max-new)")
            if (req.status != "rejected" and args.cancel_every
                    and submitted % args.cancel_every
                    == args.cancel_every - 1):
                pending_cancel.append(req)
            submitted += 1
        eng.step()
        # abandon marked requests once they have streamed a token
        for req in list(pending_cancel):
            if req.state == "finished":
                pending_cancel.remove(req)
            elif req.generated:
                eng.cancel(req.rid)
                pending_cancel.remove(req)
    _print_continuous(args, eng, offload_eng, prefix_pages, preempt)
    write_outputs(args, eng.obs, {
        "engine": "continuous", "arch": cfg.name,
        "kv_layout": "paged" if args.kv_page is not None else "dense",
        "offloaded": offload_eng is not None,
        "timing": eng.obs.timing, "plane": eng._exec.plane,
        "roofline": eng.obs.timing, "speculative": draft_k > 0,
        "prefix_cache": prefix_pages > 0, "kv_host": preempt,
        "faults": True})


def _print_continuous(args, eng, offload_eng, prefix_pages, preempt):
    s = eng.stats()
    print(f"[continuous] {s['finished']} requests, {s['tokens']} tokens in "
          f"{s['steps']} steps ({s['tokens_per_step']:.2f} tok/step, "
          f"{args.max_slots} slots)")
    if args.kv_page is not None:
        print(f"[paged-kv] pool {s['kv_pages_total']} pages x "
              f"{s['kv_page_size']} positions ({s['kv_pages_free']} free at "
              f"exit)")
    if offload_eng is not None:
        print(f"[offloaded] pool traffic: {s['offload_demand_loads']} demand "
              f"+ {s['offload_spec_loads']} spec loads, {s['offload_hits']} "
              f"hits ({s['offload_bytes_h2d']/1e6:.1f}MB h2d measured)")
    m = eng.metrics()
    if prefix_pages:
        pm = m["prefix"]
        print(f"[prefix] {pm['prefills_skipped']} prefills hit the cache "
              f"({pm['hit_tokens']} prompt tokens skipped); {pm['nodes']} "
              f"pages indexed, {pm['evicted_pages']} evicted")
    if preempt:
        km = m["kv_host"]
        print(f"[preempt] {km['preemptions']} preemptions, {km['resumes']} "
              f"resumes ({km['recomputes']} by recompute); swap traffic "
              f"{(km['swap_out_bytes'] + km['swap_in_bytes'])/1e6:.1f}MB "
              f"over a {km['pages_total']}-page host pool")
    if (args.inject_faults or args.cancel_every or args.queue_cap
            or args.deadline_ms is not None):
        fm = m["faults"]
        print(f"[faults] {fm['injected']} injected "
              f"(fetch={fm['fired_expert_fetch']} "
              f"retries={fm['fetch_retries']} "
              f"degraded={fm['fetch_degraded']} "
              f"nan={fm['nan_quarantined']}); terminal statuses: "
              f"{fm['completed']} completed, {fm['cancelled']} cancelled, "
              f"{fm['deadline_exceeded']} deadline_exceeded, "
              f"{fm['rejected']} rejected, {fm['failed']} failed")
    print_telemetry_summary(eng.obs)
    print_spec_summary(eng.obs)


if __name__ == "__main__":
    main()
