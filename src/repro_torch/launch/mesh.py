"""Production mesh construction on ``torch.distributed``: the port of
the reference's ``launch/mesh.py``.

Defined as FUNCTIONS (never module-level state) so importing this module
never touches process-group state.  A mesh is an ``init_device_mesh``
over the current process group; :func:`start_fake_world` starts a
process group of any size in this one process (torch's ``fake`` backend:
its collectives move nothing), which is what the dry-run runs under.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.sharding.specs import mesh_context  # noqa: F401  (re-export)


def default_device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def start_fake_world(world_size: int, rank: int = 0) -> None:
    """Initialise the default process group as a fake world of
    ``world_size`` ranks in which this process is ``rank``: every
    collective returns at once and moves no data (the reference's
    ``--xla_force_host_platform_device_count`` placeholder devices).  On a
    card, rank 0's tensors live on ``cuda:0``.  The backend is
    ``torch.testing._internal.distributed.fake_pg``, private torch API."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def _mesh(shape, axes, device_type=None):
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {have} — run under "
            f"dryrun.py (which starts a fake world of that size)")
    from torch.distributed.device_mesh import DeviceMesh

    dt = device_type or default_device_type()
    if have == n:
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh(dt, tuple(shape), mesh_dim_names=tuple(axes))
    return DeviceMesh(dt, torch.arange(n).view(*shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16x16 = 256 ranks as ``("data", "model")``; 2x16x16 = 512 ranks as
    ``("pod", "data", "model")`` multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_smoke_mesh(n_data: int = 2, n_model: int = 2, device_type=None):
    """Small mesh for multi-process sharding tests."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)
