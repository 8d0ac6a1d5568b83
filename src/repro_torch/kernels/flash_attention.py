"""Blockwise causal GQA attention with an online softmax (port of the
reference's ``kernels/flash_attention.py``).

Layout as in the reference: q (BH, Sq, d), k and v (BKV, Skv, d) with
BH = BKV * G (query head ``bh`` reads KV head ``bh // G``).  Query row
``i`` sits at position ``q_offset + i``, key row ``j`` at ``j``; with
``causal`` a key is valid for ``j <= qpos``, with ``window`` for ``qpos -
j < window``.  Every function also takes 4-D (B, H, S, d) tensors of any
strides with ``d`` contiguous, so a model can pass views of its (B, S,
H, d) activations and KV ring without a copy.

* :func:`flash_attention_reference`, the plain version: the reference's
  ``flash_attention_ref`` (float32 scores, softmax and P.V, the output
  rounded once to q's dtype), except that a row without a valid key
  gives 0, as the TPU kernel's ``l == 0 -> 1`` rule means it to.  The
  CPU path runs it.
* :func:`launch`, the Hopper kernel (``csrc/flash_attention.cu``): a
  block loops over the KV tiles that can intersect its query tile's
  window, with the online softmax in registers; bf16 (head_dim 64 / 128)
  on ``wgmma`` with one block per (query tile, KV head, batch) and that
  KV head's query heads stacked as rows, K/V tiles loaded by TMA.
* :func:`flash_attention`, the dispatch: a CPU tensor takes the plain
  version; a CUDA tensor launches the kernel (or raises) and counts the
  launch in ``flash_attention.launches``.  ``launch.routes`` counts the
  kernel's launches by the instance the kernel picks ("wgmma", "fma"),
  mirroring its dispatch (:func:`wgmma_scope`).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
NEG_INF = -1e30


def _valid(Sq: int, Skv: int, causal: bool, window: Optional[int],
           q_offset: int, device) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query row may attend to."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=device)[None, :]
    valid = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        valid &= kpos <= qpos
    if window is not None:
        valid &= (qpos - kpos) < window
    return valid


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              window: Optional[int] = None,
                              q_offset: int = 0) -> torch.Tensor:
    """The plain version (module docstring): q (..., H, Sq, d), k/v (...,
    Hkv, Skv, d) -> (..., H, Sq, d) in q's dtype."""
    G = q.shape[-3] // k.shape[-3]
    kk = k.repeat_interleave(G, dim=-3).to(torch.float32)
    vv = v.repeat_interleave(G, dim=-3).to(torch.float32)
    d = q.shape[-1]
    s = torch.einsum("...qd,...kd->...qk", q.to(torch.float32), kk) / math.sqrt(d)
    valid = _valid(q.shape[-2], k.shape[-2], causal, window, q_offset, q.device)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    o = torch.einsum("...qk,...kd->...qd", torch.softmax(s, dim=-1), vv)
    o = torch.where(valid.any(-1)[:, None], o, torch.zeros_like(o))
    return o.to(q.dtype)


# ----------------------------------------------------------------------
def _lib():
    fn = build.load("flash_attention").flash_attention
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                       _I, _I, _I, _P]
        fn.restype = _I
    return fn


def _as_4d(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.dim() == 3:
        return t[None]
    if t.dim() != 4:
        raise ValueError(f"{what} must be (BH, S, d) or (B, H, S, d), got "
                         f"{tuple(t.shape)}")
    return t


def wgmma_scope(q4, k4, v4, out) -> bool:
    """Whether the kernel runs its ``wgmma`` instance on these 4-D
    tensors (the kernel's own dispatch, ``tc::takes``): bfloat16, head_dim
    64 or 128, at most 64 query heads per KV head, 16-byte aligned bases
    and batch / head / row strides a multiple of 8 elements."""
    ts = (q4, k4, v4, out)
    return (q4.dtype == torch.bfloat16 and q4.shape[-1] in (64, 128)
            and q4.shape[1] // k4.shape[1] <= 64
            and all(t.data_ptr() % 16 == 0 for t in ts)
            and all(t.stride(i) % 8 == 0 for t in ts for i in range(3)))


def launch(q, k, v, *, causal: bool = True, window: Optional[int] = None,
           q_offset: int = 0) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on PyTorch's current stream: q
    (BH, Sq, d) or (B, H, Sq, d), k/v of the same rank with Hkv dividing
    H; any strides with the last dimension contiguous.  Returns the output
    in q's shape, dtype and memory layout.  Checks every input and raises
    on what the kernel cannot read; never synchronises."""
    if not q.is_cuda:
        raise ValueError("the CUDA kernel takes tensors on the card")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype} not in {list(_DTYPES)}")
    q4, k4, v4 = _as_4d(q, "q"), _as_4d(k, "k"), _as_4d(v, "v")
    if q.dim() != k.dim() or k.dim() != v.dim():
        raise ValueError("q, k and v must have the same rank")
    B, H, Sq, d = q4.shape
    _, Hkv, Skv, _ = k4.shape
    for t, what in ((k4, "k"), (v4, "v")):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{what} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
    if tuple(v4.shape) != tuple(k4.shape) or k4.shape[0] != B or k4.shape[3] != d:
        raise ValueError(f"k {tuple(k4.shape)} / v {tuple(v4.shape)} do not "
                         f"match q {tuple(q4.shape)}")
    if d not in _HEAD_DIMS or H % Hkv:
        raise ValueError(f"head_dim {d} not in {_HEAD_DIMS}, or {H} heads "
                         f"over {Hkv} KV heads")
    if any(t.stride(-1) != 1 for t in (q4, k4, v4)):
        raise ValueError("the last dimension must be contiguous")
    if Sq == 0 or q_offset < 0 or (window is not None and window <= 0):
        raise ValueError(f"Sq={Sq}, q_offset={q_offset}, window={window}")
    out = torch.empty_like(q4)  # q's layout: a view of (B, S, H, d) stays one
    st = lambda t: (t.stride(0), t.stride(1), t.stride(2))
    rc = _lib()(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, H, Hkv, Sq, Skv, d,
                *st(q4), *st(k4), *st(v4), *st(out),
                int(causal), 0 if window is None else int(window),
                int(q_offset), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    launch.routes["wgmma" if wgmma_scope(q4, k4, v4, out) else "fma"] += 1
    return out[0] if q.dim() == 3 else out


launch.routes = {"wgmma": 0, "fma": 0}  # launches by route, never reset here


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Dispatch on q's device (module docstring)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset)
    out = launch(q, k, v, causal=causal, window=window, q_offset=q_offset)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
