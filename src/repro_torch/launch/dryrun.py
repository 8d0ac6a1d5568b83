"""Multi-pod dry-run on ``torch.distributed``: the port of the reference's
``launch/dryrun.py``.  Every (architecture x input shape) runs as one
rank's share of the production mesh (16x16, or 2x16x16 with
``--multi-pod``) under a fake world of 256 or 512 ranks
(``mesh.start_fake_world``: collectives move nothing).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device meta \\
        --arch mixtral-8x7b --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device meta --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device meta \
        --arch xlstm-1.3b --shape prefill_32k --seq-len 4096
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch mixtral-8x7b --shape decode_32k         # on the card

Every parameter, optimizer moment, batch input and decode-state leaf is
a DTensor laid out by ``sharding/specs.py``, of which this process holds
rank 0's shard only; the whole model is never materialised.

* ``--device meta``: shards on ``meta``, nothing is allocated and
  nothing is timed.  The step is counted (``launch/roofline.py``) at one
  and two periods of the block pattern (and one and two microbatches)
  and extrapolated to the config's depth, the counterpart of the
  reference's trip-count scaling.
* On the card (the default): the same counts (they depend on the shapes
  alone), and each shard is drawn at its local shape from a seeded
  generator and the step runs for real, at full depth or at
  ``--card-layers``, timed with CUDA events (a step under 2 s twice, the
  warm run kept).  The values are
  meaningless (collectives move nothing); the shapes, the allocations,
  the launches and the time are real, and ``peak_estimate_bytes`` is
  ``torch.cuda.max_memory_allocated``.

``--seq-len`` cuts the shape's sequence (a quick check; the report's
``seq_len`` says so).

Per combo it writes the reference's JSON schema into
``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``, with
``collective_ops`` for the reference's ``hlo_collective_ops``;
``memory_analysis.argument_bytes`` is exact from the spec trees.  The
reference's ``_tpu_peak_adjustment`` (XLA-CPU's f32 shadow of bf16
weights) has no counterpart: the card runs bf16 matmuls natively.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, SKIPS,
                                 config_for_shape)
from repro_torch.launch import roofline
from repro_torch.launch.mesh import (make_production_mesh, mesh_context,
                                     start_fake_world)
from repro_torch.models import transformer as T
from repro_torch.sharding import specs as SP
from repro_torch.training import optimizer as O
from repro_torch.training.trainer import make_train_step

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

# gradient-accumulation factor per arch for train_4k (the reference's)
MICROBATCHES = {
    "smollm-360m": 2,
    "command-r-plus-104b": 8,
    "mixtral-8x7b": 8,
    "recurrentgemma-9b": 8,
    "granite-moe-1b-a400m": 2,
    "stablelm-1.6b": 2,
    "qwen1.5-4b": 4,
    "phi-3-vision-4.2b": 4,
    "whisper-medium": 2,
    "xlstm-1.3b": 4,
}

SEQ_SHARD_TRAIN = {"command-r-plus-104b"}
# bf16 AdamW moments for the largest config
BF16_MOMENTS = {"command-r-plus-104b"}


def input_shape(shape_name: str, seq_len: int = None):
    """``INPUT_SHAPES[shape_name]``, its sequence cut to ``seq_len`` when
    given."""
    shp = INPUT_SHAPES[shape_name]
    return shp if seq_len is None else dataclasses.replace(shp,
                                                           seq_len=seq_len)


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def step_config(arch: str, shape_name: str, mesh):
    """The config a combo runs (the reference's ``build_lowering``
    choices): the SWA variant for long_500k, sequence-sharded activations
    for SEQ_SHARD_TRAIN in training, MoE dispatch groups = batch shards."""
    cfg = config_for_shape(arch, shape_name)
    shp = INPUT_SHAPES[shape_name]
    if shp.kind == "train" and arch in SEQ_SHARD_TRAIN:
        cfg = cfg.replace(act_seq_shard=True)
    if cfg.moe is not None:
        cfg = cfg.replace(moe_dispatch_groups=n_batch_shards(mesh))
    return cfg


def n_batch_shards(mesh) -> int:
    return mesh.size() // SP.mesh_axis_size(mesh, "model")


def serve_tp_only(cfg, kind: str, mesh) -> bool:
    """Decode runs pure-TP weights when the TP shard fits comfortably
    (FSDP would re-gather every weight every token)."""
    if kind != "decode":
        return False
    return 2 * T.count_params_analytic(cfg) / SP.mesh_axis_size(
        mesh, "model") < 8e9


def microbatches(arch: str, shape_name: str, mesh) -> int:
    shp = INPUT_SHAPES[shape_name]
    micro = MICROBATCHES.get(arch, 1)
    # each microbatch must still split over every batch shard
    return max(1, min(micro, shp.global_batch // n_batch_shards(mesh)))


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [_tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _layout(cfg, shape_name: str, mesh, arch: str, seq_len: int = None):
    """(tree of (global shape, dtype) leaves, spec tree) of every argument
    of the combo's step, keyed by argument name, at ``cfg``'s depth."""
    shp = input_shape(shape_name, seq_len)
    B, S = shp.global_batch, shp.seq_len
    tp_only = serve_tp_only(cfg, shp.kind, mesh)
    pshapes = T.param_specs(cfg)
    out = {"params": (pshapes, SP.param_spec_tree(
        cfg, mesh, pshapes, serve_tp_only=tp_only))}
    b_ax = SP.batch_spec(mesh, B)
    if shp.kind == "decode":
        st = T.init_decode_state(cfg, B, S, "meta")
        sshapes = _tree_map(lambda t: (tuple(t.shape), t.dtype)
                            if isinstance(t, torch.Tensor) else t, st)
        sspecs = SP.decode_state_spec_tree(cfg, mesh, B, st)
        out["state"] = (sshapes, sspecs)
        out["tokens"] = (((B, 1), torch.int32), SP.Spec(b_ax, None))
        return out
    batch = {"tokens": ((B, S), torch.int32)}
    if shp.kind == "train":
        batch["labels"] = ((B, S), torch.int32)
    dt = getattr(torch, cfg.dtype)
    if cfg.is_encoder_decoder:
        batch["audio_embeds"] = ((B, cfg.encoder_seq, cfg.d_model), dt)
    if cfg.num_image_tokens:
        batch["image_embeds"] = ((B, cfg.num_image_tokens, cfg.d_model), dt)
    out["batch"] = (batch, {k: SP.Spec(b_ax, *[None] * (len(v[0]) - 1))
                            for k, v in batch.items()})
    if shp.kind == "train":
        mdt = getattr(torch, "bfloat16" if arch in BF16_MOMENTS
                      else "float32")
        mom = _tree_map(lambda l: (l[0], mdt), pshapes)
        out["opt_state"] = ({"mu": mom, "nu": mom},
                            {"mu": out["params"][1], "nu": out["params"][1]})
    return out


def argument_bytes(layout, mesh) -> int:
    """One rank's bytes of every tensor argument, from the spec trees."""
    total = 0
    for shapes, specs in layout.values():
        for leaf, spec in zip(_leaves(shapes), _leaves(specs)):
            if isinstance(leaf, tuple) and len(leaf) == 2 \
                    and isinstance(leaf[1], torch.dtype):
                total += _nbytes(SP.local_shape(mesh, leaf[0], spec), leaf[1])
    return total


def _materialise(layout, mesh, device, seed: int, cfg, next_pos: int):
    """The step's arguments as DTensors holding only this rank's shards:
    on ``meta`` empty; on the card drawn from a seeded generator
    (weights, batch embeddings and KV at N(0, 0.02), token ids uniform,
    moments 0, ring positions the rank's own slot numbers so every slot
    is valid)."""
    gen = None if device.type == "meta" else torch.Generator(device)
    if gen is not None:
        gen.manual_seed(seed)

    def leaf(l, spec, name=""):
        if not (isinstance(l, tuple) and len(l) == 2
                and isinstance(l[1], torch.dtype)):
            return l
        shape, dt = l
        loc = SP.local_shape(mesh, shape, spec)
        if gen is None:
            t = torch.empty(loc, dtype=dt, device=device)
        elif dt in (torch.int32, torch.int64):
            t = torch.randint(0, cfg.vocab_size, loc, generator=gen,
                              device=device, dtype=dt)
        else:
            t = (torch.randn(loc, generator=gen, device=device) * 0.02).to(dt)
        return SP.from_local(mesh, t, shape, spec)

    args = {}
    for name, (shapes, specs) in layout.items():
        if name == "opt_state":
            args[name] = _tree_map(
                lambda l, sp: SP.from_local(
                    mesh, torch.zeros(SP.local_shape(mesh, l[0], sp),
                                      dtype=l[1], device=device), l[0], sp),
                shapes, specs)
            args[name]["step"] = 0
        elif name in ("params", "batch", "state", "tokens"):
            args[name] = _tree_map(leaf, shapes, specs)
    if "state" in args:
        args["state"]["pos"] = next_pos
        if gen is not None:
            _fill_rings(args["state"])
    return args


def _fill_rings(state):
    """Ring positions = the slot numbers: every slot holds a past
    position."""
    for blk in state["layers"]:
        if "kv" in blk:
            pos = blk["kv"]["pos"]
            off, w = SP.shard_offset(pos, 1)
            loc = pos.to_local()
            loc.copy_(torch.arange(off, off + w, dtype=loc.dtype,
                                   device=loc.device).expand_as(loc))


def _step_fn(cfg, shape_name: str, micro: int, arch: str,
             seq_len: int = None):
    shp = input_shape(shape_name, seq_len)
    if shp.kind == "train":
        opt_cfg = O.OptimizerConfig(
            moment_dtype="bfloat16" if arch in BF16_MOMENTS else "float32")
        step = make_train_step(cfg, opt_cfg, microbatches=micro, remat=True)
        return lambda a: step(a["params"], a["opt_state"], a["batch"])
    if shp.kind == "prefill":
        def prefill_step(a):
            with torch.no_grad():
                return T.prefill(a["params"], cfg, a["batch"], shp.seq_len)
        return prefill_step

    def serve_step(a):
        with torch.no_grad():
            logits, state = T.decode_step(a["params"], cfg, a["state"],
                                          a["tokens"])
            last = logits[:, -1]
            if SP.is_dtensor(last):  # the argmax over the whole vocabulary
                from torch.distributed.tensor import Replicate
                last = last.redistribute(last.device_mesh, tuple(
                    Replicate() if p.is_shard() and p.dim == 1 else p
                    for p in last.placements))
            nxt = last.argmax(-1).to(torch.int32)
        return nxt[:, None], state
    return serve_step


def _run(fn, args, mesh, count: bool, record: bool = False):
    from torch.distributed.tensor.experimental import implicit_replication
    with mesh_context(mesh), implicit_replication():
        if not count:
            return fn(args), None, []
        return roofline.analyze_step(fn, args, n_devices=mesh.size(),
                                     record=record)


def _out_bytes(out) -> int:
    total = 0
    for t in _leaves(list(out) if isinstance(out, tuple) else out):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if SP.is_dtensor(t) else t
            total += loc.numel() * loc.element_size()
    return total


def _arg_bytes_held(args) -> int:
    """One rank's bytes of the arguments as allocated (the local shards)."""
    return sum(t.to_local().numel() * t.to_local().element_size()
               for t in _leaves(args) if SP.is_dtensor(t))


def count_combo(arch: str, shape_name: str, mesh, device, *, seed: int = 0,
                record: bool = False, card_layers: int = None,
                seq_len: int = None):
    """Build and count one combo (:func:`_count_meta`); on the card also
    run the step once for its time and peak memory (a step under 2 s
    again, warm), at full depth or at ``card_layers`` layers (whole
    periods, plus the tail; the counts stay the full depth's).  Returns
    (meta dict, RooflineReport, recorded ops, measurements dict)."""
    shp = input_shape(shape_name, seq_len)
    cfg = step_config(arch, shape_name, mesh)
    micro = microbatches(arch, shape_name, mesh) if shp.kind == "train" \
        else 1
    B, S = shp.global_batch, shp.seq_len
    layout = _layout(cfg, shape_name, mesh, arch, seq_len)
    meta = {"arch": arch, "shape": shape_name, "kind": shp.kind,
            "global_batch": B, "seq_len": S,
            "n_params": T.count_params_analytic(cfg),
            "n_layers": cfg.n_layers,
            "serve_tp_only": serve_tp_only(cfg, shp.kind, mesh)}
    if shp.kind == "train":
        meta.update(microbatches=micro, act_seq_shard=cfg.act_seq_shard,
                    moment_dtype="bfloat16" if arch in BF16_MOMENTS
                    else "float32")
    meta["tokens_per_step"] = B if shp.kind == "decode" else B * S
    meas = {"argument_bytes": argument_bytes(layout, mesh)}
    t0 = time.perf_counter()
    if device.type == "meta":
        rep, ops = _count_meta(arch, shape_name, cfg, micro, mesh, seed,
                               record, seq_len)
        meas.update(build_s=time.perf_counter() - t0, step_ms=None,
                    peak_bytes=None, output_bytes=None,
                    argument_bytes_held=None, step_layers=None,
                    step_argument_bytes=None)
        return meta, rep, ops, meas
    # on the card: the counts from meta (they depend on the shapes only),
    # the time and the memory from a clean run of the full-depth step
    from torch.distributed.device_mesh import DeviceMesh
    cpu_mesh = DeviceMesh("cpu", mesh.mesh, mesh_dim_names=mesh.mesh_dim_names)
    rep, ops = _count_meta(arch, shape_name, cfg, micro, cpu_mesh, seed,
                           record, seq_len)
    run_cfg = cfg if card_layers is None else cfg.replace(
        n_layers=card_layers)
    if run_cfg.is_encoder_decoder:
        run_cfg = run_cfg.replace(encoder_layers=run_cfg.n_layers)
    run_layout = _layout(run_cfg, shape_name, mesh, arch, seq_len)
    meas["step_layers"] = run_cfg.n_layers
    meas["step_argument_bytes"] = argument_bytes(run_layout, mesh)
    args = _materialise(run_layout, mesh, device, seed, run_cfg, S - 1)
    meas["argument_bytes_held"] = _arg_bytes_held(args)
    meas["build_s"] = time.perf_counter() - t0
    fn = _step_fn(run_cfg, shape_name, micro, arch, seq_len)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    for _ in range(2):  # a short step is timed again, warm
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = _run(fn, args, mesh, False)[0]
        ev[1].record()
        torch.cuda.synchronize(device)
        meas["output_bytes"] = _out_bytes(out)
        del out
        meas["step_ms"] = ev[0].elapsed_time(ev[1])
        if meas["step_ms"] > 2000:
            break
    meas["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return meta, rep, ops, meas


def _count_meta(arch: str, shape_name: str, cfg, micro: int, mesh, seed: int,
                record: bool, seq_len: int = None):
    """The step counted on ``meta`` at one and two periods (x one and two
    microbatches) and extrapolated to ``cfg``'s depth; returns (report,
    the recorded ops of one period and microbatch)."""
    device = torch.device("meta")
    shp = input_shape(shape_name, seq_len)
    B, S = shp.global_batch, shp.seq_len
    per, tail = cfg.pattern_period, cfg.n_layers % cfg.pattern_period
    reps, ops = {}, []
    periods = (1, 2) if cfg.n_periods > 1 else (1,)
    micros = (1, 2) if micro > 1 else (1,)
    for p in periods:
        for m in micros:
            c = cfg.replace(n_layers=p * per + tail)
            if cfg.is_encoder_decoder:
                c = c.replace(encoder_layers=p)
            sub = B // micro * m  # m microbatches of the real size
            lay = _layout(c, shape_name, mesh, arch, seq_len)
            if "batch" in lay:
                lay["batch"] = (_tree_map(
                    lambda l: ((sub,) + tuple(l[0][1:]), l[1]),
                    lay["batch"][0]), lay["batch"][1])
            args = _materialise(lay, mesh, device, seed, c, S - 1)
            _, rep, o = _run(_step_fn(c, shape_name, m, arch, seq_len), args,
                             mesh, True, record and (p, m) == (1, 1))
            reps[(p, m)] = rep
            ops = ops or o
    if len(periods) == 1:
        reps[(2, 1)] = reps[(1, 1)]
        if (1, 2) in reps:
            reps[(2, 2)] = reps[(1, 2)]
    n_p = cfg.n_periods
    if cfg.is_encoder_decoder:
        n_p = cfg.n_layers // per  # encoder and decoder share a depth
    return roofline.extrapolate(reps, n_p, micro), ops


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
            device=None, *, seed: int = 0, card_layers: int = None,
            seq_len: int = None) -> dict:
    mname = mesh_name(multi_pod)
    if (arch, shape_name) in SKIPS:
        result = {"arch": arch, "shape": shape_name, "mesh": mname,
                  "status": "skipped", "reason": SKIPS[(arch, shape_name)]}
        _write(out_dir, result)
        print(f"[dryrun] SKIP {(arch, shape_name)}: {result['reason']}")
        return result
    dev = resolve_device(device)
    n = 512 if multi_pod else 256
    import torch.distributed as dist
    if not dist.is_initialized():
        start_fake_world(n)
    mesh = make_production_mesh(multi_pod=multi_pod,
                                device_type="cpu" if dev.type == "meta"
                                else dev.type)
    meta, rep, _, meas = count_combo(arch, shape_name, mesh, dev, seed=seed,
                                     card_layers=card_layers, seq_len=seq_len)
    cfg = config_for_shape(arch, shape_name)
    mf = roofline.model_flops(cfg, meta["tokens_per_step"],
                              "train" if meta["kind"] == "train" else "serve")
    peak = meas["peak_bytes"]
    result = {
        **meta,
        "mesh": mname,
        "n_devices": mesh.size(),
        "device": _device_label(dev),
        "status": "ok",
        "lower_s": round(meas["build_s"], 2),
        "compile_s": None,
        "step_ms": meas["step_ms"],
        "step_layers": meas["step_layers"],
        "cost_analysis": {"flops": rep.flops,
                          "bytes_accessed": rep.hbm_bytes},
        "memory_analysis": {
            "argument_bytes": meas["argument_bytes"],
            "step_argument_bytes": meas["step_argument_bytes"],
            "argument_bytes_held": meas["argument_bytes_held"],
            "output_bytes": meas["output_bytes"],
            "temp_bytes": None if peak is None else max(
                0, peak - meas["argument_bytes_held"] - meas["output_bytes"]),
            "alias_bytes": None,
            "peak_estimate_bytes": peak,
        },
        "roofline": rep.to_dict(),
        "model_flops_global": mf,
        "useful_flops_ratio": mf / max(1.0, rep.flops * mesh.size()),
        "collective_ops": rep.coll_count,
    }
    _write(out_dir, result)
    step = "-" if meas["step_ms"] is None else f"{meas['step_ms']:.1f}ms"
    print(f"[dryrun] {arch} x {shape_name} x {mname}: OK "
          f"step={step} bottleneck={rep.bottleneck} "
          f"t=({rep.t_compute:.4f},{rep.t_memory:.4f},"
          f"{rep.t_collective:.4f})s")
    return result


def _device_label(dev) -> str:
    if dev.type != "cuda":
        return dev.type
    return torch.cuda.get_device_name(dev)


def _write(out_dir: Path, result: dict):
    out_dir.mkdir(parents=True, exist_ok=True)
    fn = out_dir / f"{result['arch']}__{result['shape']}__{result['mesh']}.json"
    fn.write_text(json.dumps(result, indent=1))


def run_all(out_dir: Path, multi_pod_list=(False, True), archs=None,
            shapes=None, device: str = "meta") -> int:
    """Each combo in a subprocess (isolation: a process group per
    process)."""
    archs = archs or ASSIGNED_ARCHS
    shapes = shapes or list(INPUT_SHAPES)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in multi_pod_list:
                if (arch, shape) in SKIPS:
                    run_one(arch, shape, mp, out_dir)  # writes skip marker
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--device", device,
                       "--out", str(out_dir)]
                if mp:
                    cmd.append("--multi-pod")
                r = subprocess.run(cmd, capture_output=True, text=True)
                tail = (r.stdout + r.stderr).strip().splitlines()[-3:]
                if r.returncode != 0:
                    failures.append((arch, shape, mp))
                    print(f"[dryrun] FAIL {arch} x {shape} mp={mp}:")
                    print("\n".join(tail))
                else:
                    print("\n".join(t for t in tail if "[dryrun]" in t))
    print(f"[dryrun] done, {len(failures)} failures: {failures}")
    return 1 if failures else 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default=None,
                    help="meta (count only) or cuda; the card by default")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--card-layers", type=int, default=None,
                    help="run the timed step on the card at this depth "
                         "(the counts stay the full depth's)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="cut the shape's sequence to this length")
    args = ap.parse_args(argv)
    out = Path(args.out)
    dev = resolve_device(args.device)  # no card and no --device: an error
    if args.all:
        sys.exit(run_all(out, device=str(dev.type)))
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    run_one(args.arch, args.shape, args.multi_pod, out, dev, seed=args.seed,
            card_layers=args.card_layers, seq_len=args.seq_len)


if __name__ == "__main__":
    main()
