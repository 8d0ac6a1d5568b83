"""One rank of the gloo check of ``tests/test_torch_sharding.py``: the
port's train step and prefill + decode step on a ("data", "model") mesh
of CPU processes (2x2 unless ``MESH`` says otherwise, e.g. ``1x4``),
against the unsharded port on the same weights.

    python tests/torch_sharding_worker.py RANK WORLD PORT ARCH OUT \
        [N_EXPERTS [MESH]]

``xlstm-1.3b`` runs one period (5 mLSTM + 1 sLSTM) at d_model 128 with 2
heads of 64: on a 4-way "model" axis one shard of D (32 columns) is
narrower than one head, as the published 2048 on 16 ranks (128 columns)
is against heads of 512.  Its 128 positions make each rank's projection
output larger than the weight in the train step and the prefill (the
weight is gathered) and smaller in the decode step (the output is
reduced).
"""
import dataclasses
import json
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import transformer as T
from repro_torch.sharding import specs as SP
from repro_torch.training import optimizer as O
from repro_torch.training.trainer import make_train_step


def tmap(f, a, b):
    if isinstance(a, dict):
        return {k: tmap(f, a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [tmap(f, x, y) for x, y in zip(a, b)]
    return f(a, b)


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def main(rank, world, port, arch, out, n_experts=0, mesh_shape="2x2"):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    n_data, n_model = (int(n) for n in mesh_shape.split("x"))
    mesh = make_smoke_mesh(n_data, n_model, device_type="cpu")
    cfg = get_config(arch).reduced()
    if arch == "xlstm-1.3b":
        cfg = cfg.replace(d_model=128, n_heads=2, n_kv_heads=2, head_dim=64)
    if n_experts:  # experts that do not divide "model": tensor parallel
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  num_experts=n_experts))
    n_batch = mesh.size() // mesh.size(1)
    if cfg.moe is not None:
        cfg = cfg.replace(moe_dispatch_groups=n_batch)
    params = T.init_model(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    B, S = 4, (128 if arch == "xlstm-1.3b" else 16)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                          dtype=torch.int32)
    lab = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                          dtype=torch.int32)
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 1)),
                          dtype=torch.int32)
    opt = O.OptimizerConfig()
    step = make_train_step(cfg, opt, microbatches=2, remat=True)

    # the unsharded port, its rows in the order of the mesh's microbatches
    # (each takes a block of every data rank's rows: specs.micro_slice)
    n_data, blk = mesh.size(0), B // mesh.size(0) // 2
    order = [r * (B // n_data) + i * blk + j for i in range(2)
             for r in range(n_data) for j in range(blk)]
    _, _, m_ref = step(params, O.init_opt_state(params, opt),
                       {"tokens": tok[order], "labels": lab[order]})
    with torch.no_grad():
        _, st = T.prefill(params, cfg, {"tokens": tok}, 2 * S)
        lg_ref, _ = T.decode_step(params, cfg, st, nxt)

    # the same on the mesh
    pspecs = SP.param_spec_tree(cfg, mesh, params)
    dparams = tmap(lambda t, sp: distribute_tensor(
        t, mesh, SP.placements(mesh, sp), src_data_rank=None),
        params, pspecs)
    b_ax = SP.batch_spec(mesh, B)
    bat = lambda t: distribute_tensor(
        t, mesh, SP.placements(mesh, SP.Spec(b_ax, None)), src_data_rank=None)
    with SP.mesh_context(mesh), implicit_replication():
        _, _, m = step(dparams, O.init_opt_state(dparams, opt),
                       {"tokens": bat(tok), "labels": bat(lab)})
        with torch.no_grad():
            _, dst = T.prefill(dparams, cfg, {"tokens": bat(tok)}, 2 * S)
            lg, _ = T.decode_step(dparams, cfg, dst, bat(nxt))
    res = {"loss_ref": float(m_ref["loss"]), "loss": float(full(m["loss"])),
           "gnorm_ref": float(m_ref["grad_norm"]),
           "gnorm": float(full(m["grad_norm"])),
           "logits_ref": lg_ref[:, -1].tolist(),
           "logits": full(lg)[:, -1].tolist()}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    r, w, port, arch, out = sys.argv[1:6]
    main(int(r), int(w), int(port), arch, out,
         int(sys.argv[6]) if len(sys.argv) > 6 else 0,
         sys.argv[7] if len(sys.argv) > 7 else "2x2")
