"""Perf-iteration workbench: run one (arch x shape x mesh) of the dry-run
and break the roofline terms down to the responsible ops, each labelled
with the port function that issued it (``layers.attention_train``,
``moe.moe_apply_dispatch``, ...; the counterpart of jax's ``op_name``
metadata): the port of the reference's ``launch/perf_probe.py``.

    PYTHONPATH=src python -m repro_torch.launch.perf_probe --device meta \\
        --arch X --shape Y [--multi-pod] [--top 15]

On ``meta`` the ops listed are those of one period and one microbatch
(``x1``), and the totals are extrapolated to the config's depth as in
the dry-run; on the card the whole step is listed.
"""
from __future__ import annotations

import argparse
from collections import defaultdict

from repro_torch import resolve_device
from repro_torch.configs import INPUT_SHAPES
from repro_torch.launch import roofline as R
from repro_torch.launch.dryrun import count_combo
from repro_torch.launch.mesh import make_production_mesh, start_fake_world


def top_ops(ops, top: int = 15) -> str:
    """The top ``top`` collectives and memory ops by bytes, and the
    per-type totals of the ops given, as text."""
    colls, mems = R.top_ops(ops, top)
    by_type = defaultdict(float)
    for o in ops:
        if o.kind == "collective":
            by_type[o.op] += o.bytes
    out = [f"\n== top {top} collectives (bytes) =="]
    for o in colls:
        out.append(f"{o.bytes / 1e9:9.3f} GB  {o.op:18s} g={o.group:<4d} "
                   f"{o.shape:28s} {o.label[:70]}")
    out.append(f"\n== top {top} memory ops (output bytes) ==")
    for o in mems:
        out.append(f"{o.bytes / 1e9:9.3f} GB  {o.op:18s} {o.shape:28s} "
                   f"{o.label[:70]}")
    out.append("\ncollectives by type (listed ops): "
               + str({k: round(v / 1e9, 3) for k, v in by_type.items()})
               + " GB")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--device", default=None,
                    help="meta (count only) or cuda; the card by default")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    start_fake_world(512 if args.multi_pod else 256)
    mesh = make_production_mesh(multi_pod=args.multi_pod,
                                device_type="cpu" if dev.type == "meta"
                                else dev.type)
    _, rep, ops, meas = count_combo(args.arch, args.shape, mesh, dev,
                                    record=True)
    print(f"terms: compute={rep.t_compute:.4f}s memory={rep.t_memory:.4f}s "
          f"collective={rep.t_collective:.4f}s bottleneck={rep.bottleneck}")
    peak = meas["peak_bytes"]
    print(f"argument bytes/rank {meas['argument_bytes'] / 1e9:.3f} GB; peak "
          + ("-" if peak is None else f"{peak / 1e9:.2f} GB"))
    print("collectives by type: "
          f"{ {k: round(v / 1e9, 1) for k, v in rep.coll_by_type.items()} } GB")
    print(top_ops(ops, args.top))


if __name__ == "__main__":
    main()
