"""The port's sharding rules, dry-run sizes and counting against the JAX
reference (``repro.sharding.specs``, ``repro.launch.roofline``,
``repro.launch.summarize``): spec trees and decode-state spec trees on
both production meshes, ``_filter_spec``/``batch_spec``, the configs'
``INPUT_SHAPES``/``SKIPS``/``param_count``, ``model_flops``, per-rank
argument bytes, the counting mode (exact matmul flops, the period
extrapolation, the ring model on a fake group), the sharded train and
decode steps on a 2x2 gloo mesh of CPU processes against the unsharded
port, and ``summarize.table``.

Process groups live only in subprocesses (``tests/torch_sharding_worker.py``
and ``python -c`` children): a process group is global to its process."""
import json
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as RC
from repro.launch import roofline as RR
from repro.launch import summarize as RSum
from repro.models import transformer as RT
from repro.sharding import specs as RS
from repro.training import optimizer as RO
from repro_torch import configs as C
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch import summarize as Sum
from repro_torch.models import transformer as T
from repro_torch.sharding import specs as SP

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
ARCHS = list(RC.ASSIGNED_ARCHS) + ["mixtral-offload", "tiny-moe"]


class FakeMesh:
    """The attributes both packages' rules read of a mesh: the
    reference's ``axis_names``/``shape``, the port's
    ``mesh_dim_names``/``mesh.shape``/``size()``."""

    def __init__(self, names, sizes):
        self.axis_names = self.mesh_dim_names = tuple(names)
        self.shape = dict(zip(names, sizes))
        self.mesh = np.empty(sizes, dtype=np.int8)

    def size(self, dim=None):
        return int(self.mesh.size if dim is None else self.mesh.shape[dim])


MESHES = {"pod16x16": FakeMesh(("data", "model"), (16, 16)),
          "pod2x16x16": FakeMesh(("pod", "data", "model"), (2, 16, 16))}


def _is_p(s):
    return isinstance(s, P)


def _plain(tree):
    """A spec tree as nested dicts/lists of plain tuples."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    return tuple(tree)


def _per_layer(ref, cfg):
    """The reference's stacked spec tree in the port's per-layer layout:
    ``stack[l % period]`` without its leading period entry, then the
    tail; the encoder's ``stack[0]`` once per encoder layer."""
    def cut(t):
        if isinstance(t, dict):
            return {k: cut(v) for k, v in t.items()}
        if isinstance(t, list):
            return [cut(v) for v in t]
        return tuple(t)[1:]

    per = cfg.pattern_period
    out = {k: v for k, v in ref.items()
           if k not in ("stack", "tail", "encoder")}
    out["layers"] = [cut(ref["stack"][l % per])
                     for l in range(cfg.n_periods * per)] + list(ref["tail"])
    if "encoder" in ref:
        out["encoder"] = {"final_norm": ref["encoder"]["final_norm"],
                          "layers": [cut(ref["encoder"]["stack"][0])]
                          * cfg.encoder_layers}
    return _plain(out)


def _ref_params(cfg):
    return jax.eval_shape(lambda: RT.init_model(jax.random.key(0), cfg))


@pytest.fixture(scope="module")
def ref_param_shapes():
    return {a: _ref_params(RC.get_config(a)) for a in ARCHS}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_spec_trees_match_reference(mesh_name, ref_param_shapes):
    mesh = MESHES[mesh_name]
    for arch in ARCHS:
        cfg, pcfg = RC.get_config(arch), C.get_config(arch)
        for tp_only in (False, True):
            ref = RS.param_spec_tree(cfg, mesh, ref_param_shapes[arch],
                                     serve_tp_only=tp_only)
            port = SP.param_spec_tree(pcfg, mesh, T.param_specs(pcfg),
                                      serve_tp_only=tp_only)
            assert _plain(port) == _per_layer(ref, cfg), (arch, tp_only)


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_decode_state_spec_trees_match_reference(shape_name, mesh_name):
    mesh = MESHES[mesh_name]
    shp = RC.INPUT_SHAPES[shape_name]
    for arch in RC.ASSIGNED_ARCHS:
        if (arch, shape_name) in RC.SKIPS:
            continue
        cfg = RC.config_for_shape(arch, shape_name)
        pcfg = C.config_for_shape(arch, shape_name)
        st = jax.eval_shape(lambda: RT.init_decode_state(
            cfg, shp.global_batch, shp.seq_len))
        ref = RS.decode_state_spec_tree(cfg, mesh, shp.global_batch, st)
        ref_enc = ref.pop("enc_kv", None)
        want = _per_layer(ref, cfg)
        pst = T.init_decode_state(pcfg, shp.global_batch, shp.seq_len,
                                  "meta")
        port = _plain(SP.decode_state_spec_tree(pcfg, mesh,
                                                shp.global_batch, pst))
        port_enc = port.pop("enc_kv", None)
        assert port == want, (arch, shape_name)
        if ref_enc is not None:  # the port keeps no enc_kv positions
            assert port_enc == {k: tuple(ref_enc[k]) for k in ("k", "v")}


def test_filter_spec_and_batch_spec_match_reference():
    entries = [None, "data", "model", "pod", ("pod", "data"),
               ("data", "model"), ("data", "pod"), ("pod", "data", "model")]
    for mesh in MESHES.values():
        for dims in [(1,), (16,), (15, 32), (32, 48, 1), (512, 2, 256),
                     (256, 16, 3, 8)]:
            for e in entries:
                spec = [e] + [entries[(i * 3) % len(entries)]
                              for i in range(1, len(dims))]
                ref = RS._filter_spec(mesh, dims, spec)
                assert SP._filter_spec(mesh, dims, spec) == tuple(ref)
        for b in (1, 2, 16, 32, 96, 128, 256, 512, 1000):
            assert SP.batch_spec(mesh, b) == RS.batch_spec(mesh, b)


def test_configs_input_shapes_skips_param_count_match_reference():
    assert C.SKIPS == RC.SKIPS
    assert list(C.INPUT_SHAPES) == list(RC.INPUT_SHAPES)
    for k, s in C.INPUT_SHAPES.items():
        r = RC.INPUT_SHAPES[k]
        assert (s.name, s.kind, s.seq_len, s.global_batch) == \
            (r.name, r.kind, r.seq_len, r.global_batch)
    from repro.configs.base import param_count as ref_count
    from repro_torch.configs.base import param_count
    for arch in ARCHS:
        assert param_count(C.get_config(arch)) == \
            ref_count(RC.get_config(arch)), arch


def test_model_flops_match_reference():
    for arch in ARCHS:
        for shape in RC.INPUT_SHAPES:
            for kind in ("train", "serve"):
                assert R.model_flops(C.config_for_shape(arch, shape), 4096,
                                     kind) == RR.model_flops(
                    RC.config_for_shape(arch, shape), 4096, kind)


def _ref_local_bytes(shapes, specs, mesh):
    total = 0
    for sh, sp in zip(jax.tree.leaves(shapes),
                      jax.tree.leaves(specs, is_leaf=_is_p)):
        n = 1
        for d, dim in enumerate(sh.shape):
            e = tuple(sp)[d] if d < len(tuple(sp)) else None
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            div = math.prod(mesh.shape[a] for a in axes)
            assert dim % div == 0
            n *= dim // div
        total += n * sh.dtype.itemsize
    return total


def _ref_argument_bytes(arch, shape_name, mesh, params):
    """The reference's per-rank bytes of every argument of its dry-run
    step (``build_lowering``'s arguments), less the scalars the port
    keeps on the host: the optimizer's step, the decode position and the
    encoder-KV plane's positions."""
    cfg = RC.config_for_shape(arch, shape_name)
    shp = RC.INPUT_SHAPES[shape_name]
    B, S = shp.global_batch, shp.seq_len
    tp = shp.kind == "decode" and \
        2 * RT.count_params_analytic(cfg) / mesh.shape["model"] < 8e9
    pspecs = RS.param_spec_tree(cfg, mesh, params, serve_tp_only=tp)
    total = _ref_local_bytes(params, pspecs, mesh)
    b_ax = RS.batch_spec(mesh, B)
    if shp.kind == "decode":
        st = jax.eval_shape(lambda: RT.init_decode_state(cfg, B, S))
        st.pop("pos")
        if "enc_kv" in st:
            st["enc_kv"].pop("pos")
        total += _ref_local_bytes(st, RS.decode_state_spec_tree(
            cfg, mesh, B, st), mesh)
        return total + _ref_local_bytes(
            [jax.ShapeDtypeStruct((B, 1), np.int32)], [P(b_ax, None)], mesh)
    batch = [jax.ShapeDtypeStruct((B, S), np.int32)] * (
        2 if shp.kind == "train" else 1)
    if cfg.is_encoder_decoder:
        batch.append(jax.ShapeDtypeStruct((B, cfg.encoder_seq, cfg.d_model),
                                          jax.numpy.bfloat16))
    if cfg.num_image_tokens:
        batch.append(jax.ShapeDtypeStruct(
            (B, cfg.num_image_tokens, cfg.d_model), jax.numpy.bfloat16))
    total += _ref_local_bytes(batch, [P(b_ax, *[None] * (len(s.shape) - 1))
                                      for s in batch], mesh)
    if shp.kind == "train":
        oc = RO.OptimizerConfig(moment_dtype="bfloat16"
                                if arch in D.BF16_MOMENTS else "float32")
        opt = jax.eval_shape(lambda: RO.init_opt_state(params, oc))
        total += _ref_local_bytes([opt["mu"], opt["nu"]], [pspecs, pspecs],
                                  mesh)
    return total


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_argument_bytes_per_rank_match_reference(mesh_name,
                                                 ref_param_shapes):
    mesh = MESHES[mesh_name]
    for arch in RC.ASSIGNED_ARCHS:
        for shape in RC.INPUT_SHAPES:
            if (arch, shape) in RC.SKIPS:
                continue
            cfg = RC.config_for_shape(arch, shape)
            params = ref_param_shapes[arch] if shape != "long_500k" \
                else _ref_params(cfg)
            ref = _ref_argument_bytes(arch, shape, mesh, params)
            pcfg = D.step_config(arch, shape, mesh)
            port = D.argument_bytes(D._layout(pcfg, shape, mesh, arch), mesh)
            assert port == ref, (arch, shape, mesh_name)


def test_matmul_loop_counts_exact_flops():
    M, K, L = 48, 32, 7
    w = torch.randn(K, K)

    def f(x):
        for _ in range(L):
            x = x @ w
        return x

    _, rep, _ = R.analyze_step(f, torch.randn(M, K))
    assert rep.flops == L * 2 * M * K * K
    # operands + output of each product
    assert rep.hbm_bytes == L * 4 * (M * K + K * K + M * K)
    assert rep.coll_bytes == 0 and rep.bottleneck == "memory"


def _child(code: str, timeout: int = 300) -> dict:
    """Run ``code`` in a fresh interpreter; its last line is JSON."""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_ring_model_bytes_per_collective_type():
    out = _child(
        "import json, torch\n"
        "import torch.distributed._functional_collectives as F\n"
        "from repro_torch.launch.mesh import start_fake_world, make_smoke_mesh\n"
        "from repro_torch.launch import roofline as R\n"
        "start_fake_world(8)\n"
        "m = make_smoke_mesh(2, 4, device_type='cpu')\n"
        "x = torch.ones(8, 16)\n"
        "def f():\n"
        "    F.all_gather_tensor(x, 0, (m, 1)).wait()\n"
        "    F.reduce_scatter_tensor(x, 'sum', 0, (m, 1)).wait()\n"
        "    F.all_reduce(x, 'sum', (m, 0)).wait()\n"
        "    F.all_to_all_single(x, None, None, (m, 1)).wait()\n"
        "_, rep, _ = R.analyze_step(f)\n"
        "print(json.dumps(rep.coll_by_type))\n")
    b = 8 * 16 * 4
    assert out == {"all-gather": 4 * b * 3 / 4, "reduce-scatter": b / 4 * 3 / 4,
                   "all-reduce": 2 * b * 1 / 2, "all-to-all": b * 3 / 4}


def test_period_extrapolation_equals_full_count():
    """Counts at one and two periods (x one and two microbatches) of a
    reduced MoE stack on a 2x2 fake mesh, extrapolated to four periods
    and two microbatches, equal the count of the 4-layer step."""
    out = _child(
        "import json, torch\n"
        "from torch.distributed.tensor.experimental import implicit_replication\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch import roofline as R, dryrun as D\n"
        "from repro_torch.launch.mesh import start_fake_world, make_smoke_mesh\n"
        "from repro_torch.models import transformer as T\n"
        "from repro_torch.sharding import specs as SP\n"
        "from repro_torch.training import optimizer as O\n"
        "from repro_torch.training.trainer import make_train_step\n"
        "start_fake_world(4)\n"
        "mesh = make_smoke_mesh(2, 2, device_type='cpu')\n"
        "base = get_config('granite-moe-1b-a400m').reduced().replace(\n"
        "    moe_dispatch_groups=2, dtype='bfloat16')\n"
        "def count(layers, micro):\n"
        "    cfg = base.replace(n_layers=layers)\n"
        "    ps = T.param_specs(cfg)\n"
        "    sp = SP.param_spec_tree(cfg, mesh, ps)\n"
        "    mk = lambda l, s: SP.from_local(mesh, torch.empty(\n"
        "        SP.local_shape(mesh, l[0], s), dtype=l[1], device='meta'), l[0], s)\n"
        "    params = D._tree_map(mk, ps, sp)\n"
        "    opt = O.init_opt_state(params)\n"
        "    B = 4 * micro\n"
        "    tok = mk(((B, 16), torch.int32), SP.Spec('data', None))\n"
        "    step = make_train_step(cfg, O.OptimizerConfig(), micro, remat=True)\n"
        "    with SP.mesh_context(mesh), implicit_replication():\n"
        "        _, rep, _ = R.analyze_step(step, params, opt,\n"
        "            {'tokens': tok, 'labels': tok})\n"
        "    return rep\n"
        "reps = {(p, m): count(p, m) for p in (1, 2) for m in (1, 2)}\n"
        "ext, full = R.extrapolate(reps, 4, 2), count(4, 2)\n"
        "keys = ('flops', 'hbm_bytes', 'coll_bytes', 'coll_count')\n"
        "print(json.dumps({k: [getattr(ext, k), getattr(full, k)] for k in keys}))\n")
    for k, (ext, full) in out.items():
        assert full > 0 and ext == pytest.approx(full, rel=1e-12), k


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo_steps(tmp_path, arch, n_experts=0, mesh="2x2"):
    """The worker's four CPU processes on one mesh; their result file."""
    out, port = tmp_path / "res.json", _free_port()
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_sharding_worker.py"),
         str(r), "4", str(port), arch, str(out), str(n_experts), mesh],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=240)[1])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), errs[0][-3000:]
    return json.loads(out.read_text())


def _assert_steps_match(res):
    """Loss and gradient norm of the train step, prefill + decode logits
    within 1e-5 relative; greedy tokens equal."""
    assert res["loss"] == pytest.approx(res["loss_ref"], rel=1e-5)
    assert res["gnorm"] == pytest.approx(res["gnorm_ref"], rel=1e-5)
    a, b = np.array(res["logits_ref"]), np.array(res["logits"])
    assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()
    assert (a.argmax(-1) == b.argmax(-1)).all()


@pytest.mark.parametrize("arch,n_experts", [
    ("mixtral-8x7b", 0), ("mixtral-8x7b", 3), ("smollm-360m", 0)])
def test_sharded_steps_match_unsharded_on_gloo_mesh(arch, n_experts,
                                                    tmp_path):
    """Reduced configs in float32 on a 2x2 ("data", "model") mesh of four
    CPU processes: mixtral expert-parallel (4 experts on 2 ranks, the KV
    window split on "model"), mixtral with 3 experts (tensor-parallel over
    their hidden dim, as the published 8 on 16), smollm with whole kv
    heads.  The train
    step's loss and gradient norm, the prefill + decode step's logits
    within 1e-5 relative, and the greedy tokens equal the unsharded
    port's."""
    _assert_steps_match(_gloo_steps(tmp_path, arch, n_experts))


def test_sharded_xlstm_matches_unsharded_on_gloo_mesh(tmp_path):
    """One period of xlstm-1.3b (5 mLSTM + 1 sLSTM), float32, d_model 128
    with 2 heads of 64 on a 1x4 mesh: one "model" shard of D (32 columns)
    is narrower than a head, as 2048 on 16 ranks is against heads of 512
    in the published config.  The heads' merge, the scans and the
    projections run in local regions (the merge's backward was a view
    DTensor could not shard).  128 positions: the train step and the
    prefill gather the projection weights, the decode step reduces the
    projection outputs.  Tolerances as the other gloo cases."""
    _assert_steps_match(_gloo_steps(tmp_path, "xlstm-1.3b", mesh="1x4"))


_COUNT_CHILD = """
import json, torch
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.launch import roofline as R, dryrun as D
from repro_torch.launch.mesh import start_fake_world, make_smoke_mesh
from repro_torch.models import recurrent as Rec, transformer as T
from repro_torch.sharding import specs as SP
n_data, n_model = {n_data}, {n_model}
start_fake_world(n_data * n_model)
mesh = make_smoke_mesh(n_data, n_model, device_type="cpu")
cfg = get_config("xlstm-1.3b").reduced().replace(
    d_model=128, n_heads=2, n_kv_heads=2, head_dim=64)
ps = T.param_specs(cfg)
sp = SP.param_spec_tree(cfg, mesh, ps)
B = 4 * n_data

class Split(R.CountMode):  # HBM bytes of the copies (clone, cat) apart
    copies = 0.0
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.rep.hbm_bytes
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func._overloadpacket.__name__ in ("clone", "cat"):
            self.copies += self.rep.hbm_bytes - before
        return out

def count(S, sharded):
    def leaf(l, s):
        t = torch.empty(SP.local_shape(mesh, l[0], s) if sharded else l[0],
                        dtype=l[1], device="meta").requires_grad_()
        return SP.from_local(mesh, t, l[0], s) if sharded else t
    params = D._tree_map(leaf, ps, sp)
    rows = B if sharded else B // n_data
    x = leaf(((rows, S, cfg.d_model), torch.float32),
             SP.Spec("data", None, None))
    leaves = [x] + list(D._leaves(params))
    with SP.mesh_context(mesh), implicit_replication(), Split() as m:
        ys = [Rec.TRAIN[k.split("+")[0]](lp[k.split("+")[0]], cfg, x)[0]
              for lp, k in zip(params["layers"], cfg.layer_kinds())]
        torch.autograd.grad(sum(y.sum() for y in ys), leaves,
                            allow_unused=True)
    r = m.rep
    return dict(flops=r.flops, other=r.hbm_bytes - m.copies,
                copies=m.copies, coll_count=r.coll_count)
print(json.dumps({{S: [count(S, True), count(S, False)] for S in (32, 64)}}))
"""


@pytest.mark.parametrize("n_data,n_model", [(4, 1), (2, 2)])
def test_xlstm_regions_count_the_plain_work(n_data, n_model):
    """One xlstm period's mixers (5 mLSTM + 1 sLSTM, d_model 128, 2 heads
    of 64), forward and backward on ``meta`` DTensors of a fake mesh,
    counted at 32 and 64 positions against the plain mixers on one
    rank's rows (4).  On a data-parallel mesh (4x1) the regions replicate
    nothing: flops and every HBM byte but the copies (clone, cat) equal
    the plain counts exactly, and the copies are fewer (the plain sLSTM
    step copies ``r_gates`` into its product's layout at every position;
    the region lays it out once).  On 2x2 the regions split the
    projections over "model" and replicate the scans: no more flops or
    bytes than the plain work.  On both, the collectives are a fixed set
    per layer: their count does not grow with the sequence (none per
    position)."""
    out = _child(_COUNT_CHILD.format(n_data=n_data, n_model=n_model))
    for S in ("32", "64"):
        mesh, plain = out[S]
        if n_model == 1:
            assert mesh["flops"] == plain["flops"] > 0
            assert mesh["other"] == plain["other"] > 0
        else:
            assert 0 < mesh["flops"] <= plain["flops"]
            assert 0 < mesh["other"] <= plain["other"]
        assert mesh["copies"] < plain["copies"]
        assert plain["coll_count"] == 0
    assert out["32"][0]["coll_count"] == out["64"][0]["coll_count"] > 0


@pytest.mark.parametrize("mixer", ["slstm", "mlstm"])
@pytest.mark.parametrize("grad,carry_grad,final", [
    (False, False, "all"), (True, False, "all"), (True, True, "all"),
    (True, False, "h")])
def test_meta_scans_count_every_step(mixer, grad, carry_grad, final):
    """The sLSTM position loop and the mLSTM chunk loop on ``meta``
    tensors run one step and count it as the loop's trip count
    (``roofline.repeat``, the reference's scaling of a ``while`` body);
    their counts equal the loops' on real tensors exactly, forward and
    backward, with and without a gradient for the initial carry, and
    with a gradient for every final carry or for the outputs alone."""
    from repro_torch.models import recurrent as Rec

    def count(dev):
        g = torch.Generator().manual_seed(0)
        B, H, dh, S = 2, 2, 8, 12
        mk = lambda *sh, rg=grad: torch.randn(*sh, generator=g).to(
            dev).requires_grad_(rg)
        if mixer == "slstm":
            p = {"r_gates": mk(4, H, dh, dh), "b_gates": mk(4, H, dh)}
            carry = [mk(B, H, dh, rg=carry_grad) for _ in range(4)]
            run = lambda: Rec._slstm_scan(p, carry, pre)[::-1]
            pre = mk(B, S, 4, H, dh)
        else:
            st = {"C": mk(B, H, dh, dh, rg=carry_grad),
                  "n": mk(B, H, dh, rg=carry_grad),
                  "m": mk(B, H, rg=carry_grad)}
            xs = [mk(B, S, H, dh) for _ in range(3)] + [mk(B, S, H)
                                                         for _ in range(2)]
            run = lambda: (lambda h, c: (h, list(c.values())))(
                *Rec.mlstm_scan_core(*xs, st, 4))
        with R.CountMode() as m:
            hs, carry_out = run()
            if grad:
                loss = hs.sum() + (sum(c.sum() for c in carry_out)
                                   if final == "all" else 0)
                loss.backward()
        return m.rep.flops, m.rep.hbm_bytes

    real, meta = count("cpu"), count("meta")
    assert meta == real and real[0] > 0


def test_summarize_table_matches_reference(tmp_path):
    rows = [
        {"arch": "mixtral-8x7b", "shape": "decode_32k", "status": "ok",
         "roofline": {"t_compute_s": 2e-5, "t_memory_s": 0.0123,
                      "t_collective_s": 1.5, "bottleneck": "collective"},
         "useful_flops_ratio": 0.25,
         "memory_analysis": {"peak_estimate_bytes": 7.5e9}},
        {"arch": "mixtral-8x7b", "shape": "train_4k", "status": "ok",
         "roofline": {"t_compute_s": 3.0, "t_memory_s": 0.5,
                      "t_collective_s": 2e-4, "bottleneck": "compute"},
         "useful_flops_ratio": 0.81234,
         "memory_analysis": {"peak_estimate_bytes": 14e9}},
        {"arch": "whisper-medium", "shape": "long_500k", "status": "skipped",
         "reason": "x"},
    ]
    for r in rows:
        (tmp_path / f"{r['arch']}__{r['shape']}__pod16x16.json").write_text(
            json.dumps(r))
    RSum.DRY = tmp_path
    want = RSum.table("pod16x16")
    assert Sum.table("pod16x16", rows=Sum.load("pod16x16", tmp_path)) == want
    assert Sum.bottleneck_stats("pod16x16", rows=rows)[0] == \
        RSum.bottleneck_stats("pod16x16")[0]
    # a combo counted on meta has no peak
    rows[0]["memory_analysis"]["peak_estimate_bytes"] = None
    assert Sum.table("pod16x16", rows=rows).splitlines()[3] == (
        "| mixtral-8x7b | decode_32k | ok | 20us | 12.3ms | 1.50s | "
        "collective | 0.250 | - |")
