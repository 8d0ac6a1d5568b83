"""Flat-npz checkpoints in the reference's format (port of its
``checkpoint/checkpointer.py``).

One npz file, one entry per leaf keyed by its path in the reference's
layout (``/embed/table``, ``/stack/<pos>/attn/wq`` with a leading period
axis, ...) plus ``__meta__`` (JSON).  The port's per-layer parameters
cross through ``bridge.params_to_numpy`` / ``params_from_numpy``, so the
reference's ``restore`` reads a file this module wrote and
:func:`restore` reads one the reference wrote.  Writes are atomic (a
temporary file in the target directory, then a rename).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np

from repro_torch import bridge
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
    else:
        out[prefix] = np.asarray(tree)
    return out


def save(path: str, params, cfg: ModelConfig, meta: Optional[dict] = None
         ) -> None:
    """Write the port's ``params`` of ``cfg`` to ``path`` (atomically)."""
    flat = _flatten(bridge.params_to_numpy(params, cfg))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
    os.close(fd)
    try:
        np.savez(tmp, __meta__=json.dumps(meta or {}), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_meta(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__meta__"]))


def restore(path: str, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """Read a checkpoint of ``cfg`` into the port's layout on ``device``
    (the card unless ``device="cpu"``), each leaf in the dtype
    ``init_model`` gives it.  Raises ``ValueError`` where a leaf's shape
    differs from the one ``cfg`` implies, ``KeyError`` where one is
    missing."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    period = cfg.pattern_period
    specs = T.param_specs(cfg)
    want = {k: v for k, v in specs.items() if k != "layers"}
    want["stack"] = [_stack_specs(specs["layers"][i::period])
                     for i in range(period)]

    def rebuild(tmpl, prefix=""):
        if isinstance(tmpl, dict):
            return {k: rebuild(v, f"{prefix}/{k}") for k, v in tmpl.items()}
        if isinstance(tmpl, list):
            return [rebuild(v, f"{prefix}/{i}") for i, v in enumerate(tmpl)]
        shape, _ = tmpl
        arr = flat[prefix]
        if arr.shape != shape:
            raise ValueError(f"{prefix}: checkpoint {arr.shape} != "
                             f"config {shape}")
        return arr

    tree = rebuild(want)
    params = bridge.params_from_numpy(tree, cfg, device)
    return _cast(params, specs)


def _stack_specs(blocks):
    if isinstance(blocks[0], dict):
        return {k: _stack_specs([b[k] for b in blocks]) for k in blocks[0]}
    shape, dt = blocks[0]
    return ((len(blocks),) + shape, dt)


def _cast(tree, specs):
    if isinstance(tree, dict):
        return {k: _cast(v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, s) for v, s in zip(tree, specs)]
    dt = specs[1]
    return tree if tree.dtype == dt else tree.to(dt)
