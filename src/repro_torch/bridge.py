"""Carry weights between the port and nested dicts of numpy arrays in
the reference's layout, both ways.

The reference keeps each block-pattern position's parameters stacked over
periods (``params["stack"][pos]``, leading axis = period, for
``lax.scan``) and the layers past the last whole period unstacked in
``params["tail"]``; the port keeps one dict per layer.  An encoder-decoder's
encoder is one pattern position stacked over its layers in the reference
(``encoder["stack"][0]``) and a list of layers in the port
(``encoder["layers"]``).  The packed expert store
arrives as the reference's per-matrix leaves, ``(L_moe, E, ...)``, and is
rebuilt into the port's one-record-per-(layer, expert) store, bit for bit.
The caller converts its arrays to numpy; nothing here imports the
reference.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, OffloadSpec
from repro_torch.core import expert_pool as EP
from repro_torch.quant import hqq


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v, device) for v in tree)
    a = np.array(tree)
    if a.dtype.name == "bfloat16":  # numpy's bfloat16 extension type
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device=None):
    """The reference's parameter tree (numpy leaves) -> the port's layout:
    ``stack[l % period]`` sliced at period ``l // period`` becomes
    ``layers[l]`` for the layers of whole periods, and ``tail[i]`` (an
    unstacked block) becomes ``layers[n_periods * period + i]``.  Every
    other leaf carries across as it is, in its own dtype: attention and
    its biases, norms, the dense ``mlp`` of ``attn+mlp``/``swa+mlp``
    blocks, the recurrent mixers' ``rglru``/``mlstm``/``slstm`` leaves
    (``lam``, ``wf``, ``bf``, ``wi``, ``bi``, ``headnorm`` and ``b_gates``
    float32 as the reference keeps them), ``img_proj``, and the dense
    expert stacks of a non-packed tree (what the plain plane
    and accounting mode compute with), each decoder block's ``norm_x`` and
    ``xattn``.  The encoder's stacked ``stack[0]`` becomes ``layers[i]``
    (its ``final_norm`` as it is).  Zero-size leaves (the reference's
    placeholders for packed experts) are dropped."""
    dev = resolve_device(device)
    period = cfg.pattern_period

    def take(t, per=None):
        if isinstance(t, dict):
            out = {k: take(v, per) for k, v in t.items()}
            return {k: v for k, v in out.items() if v is not None and
                    not (isinstance(v, dict) and not v)}
        a = np.asarray(t) if per is None else np.asarray(t)[per]
        return None if a.size == 0 else a

    layers = [take(tree["stack"][l % period], l // period)
              for l in range(cfg.n_periods * period)]
    layers += [take(blk) for blk in tree["tail"]]
    assert len(layers) == cfg.n_layers, (len(layers), cfg.n_layers)
    out = {k: v for k, v in tree.items()
           if k not in ("stack", "tail", "encoder")}
    out["layers"] = layers
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": [take(enc["stack"][0], i)
                       for i in range(cfg.encoder_layers)],
            "final_norm": enc["final_norm"]}
    return _to_torch(out, dev)


def params_to_numpy(params, cfg: ModelConfig) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: the port's ``layers[l]``
    of whole periods re-stacked into the reference's ``stack[l % period]``
    with a leading period axis, the tail layers as the unstacked blocks of
    ``tail``, the encoder's layers stacked into ``encoder["stack"][0]``,
    every leaf a numpy array on the host.  bfloat16 leaves come
    out as float32 (numpy has no bfloat16; the widening is exact and a
    reader casts back to its own dtype)."""
    period = cfg.pattern_period
    n_body = cfg.n_periods * period

    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def stack(blocks):
        if isinstance(blocks[0], dict):
            return {k: stack([b[k] for b in blocks]) for k in blocks[0]}
        return np.stack([host(b) for b in blocks])

    out = {k: hqq.tree_map(host, v) for k, v in params.items()
           if k not in ("layers", "encoder")}
    out["stack"] = [stack(params["layers"][i:n_body:period])
                    for i in range(period)]
    out["tail"] = [hqq.tree_map(host, blk)
                   for blk in params["layers"][n_body:]]
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {"stack": [stack(enc["layers"])],
                          "final_norm": hqq.tree_map(host, enc["final_norm"])}
    return out


def enc_kv_from_numpy(tree, device=None):
    """The reference's encoder-KV pytree (``{"k", "v": (n_layers, B, S_e,
    Hkv, hd), "pos": (n_layers, S_e)}``, numpy leaves) -> the port's plane
    ``{"k", "v"}`` (its positions are ``arange(S_e)``, implicit)."""
    dev = resolve_device(device)
    return {k: _to_torch(tree[k], dev) for k in ("k", "v")}


def store_from_numpy(leaves: Dict[str, Dict[str, Any]], cfg: ModelConfig,
                     spec: OffloadSpec, device=None) -> EP.Tier:
    """Rebuild the packed host store from the reference's ``PackedExperts``
    leaves: ``leaves[mat] = {"packed", "scale", "zero", "meta": {...}}``
    for each of ``w_gate``/``w_up``/``w_down``, every array ``(L_moe, E,
    ...)``.  Pinned when ``device`` is the card."""
    dev = resolve_device(device)
    gs = hqq.PAPER_SCHEMES[spec.expert_bits]["group_size"]
    qts = {}
    for mat in EP.EXPERT_MATS:
        d = leaves[mat]
        t = lambda a: torch.from_numpy(np.array(a))
        meta = None if d.get("meta") is None else \
            {k: t(d["meta"][k]) for k in hqq.META_KEYS}
        packed = t(d["packed"])
        L, E, G = packed.shape[:3]
        qts[mat] = hqq.QTensor(packed, t(d["scale"]), t(d["zero"]), meta,
                               spec.expert_bits, gs,
                               (L, E, G * gs, packed.shape[-1]))
    L, E = qts["w_gate"].packed.shape[:2]
    store = EP.new_store(EP.RecordLayout.of(qts, 2), L, E, dev)
    for l in range(L):
        EP.write_layer(store, l, {m: hqq.slice_leading(qt, l)
                                  for m, qt in qts.items()})
    return store
