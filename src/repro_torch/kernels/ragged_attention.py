"""Ragged, page-aware attention over block-paged KV (port of the
reference's ``kernels/ragged_attention.py``).

The paged KV plane keeps every attention layer's KV in a pool of
fixed-size pages, ``kp/vp: (P, page_size, Hkv, hd)`` with the absolute
position of every entry in ``ppos: (P, page_size)`` (-1 = never written
or scrubbed), and each batch row owns an ordered page-table row
``pages: (B, max_pages)`` (-1 = unallocated): position ``p`` of row ``b``
lives at page ``pages[b, p // page_size]``, offset ``p % page_size``.

* :func:`ragged_attention_reference`, the plain version: gathers each
  row's pages into a dense view (:func:`ragged_gather`) and runs the
  model's ``attention_core`` on it.  The CPU path runs it.
* :func:`launch`, the Hopper kernels: a flat (row, page) work list built
  on the host (:func:`build_page_worklist`) says which pages each row
  reads, so pages beyond a row's live length or wholly outside the
  window are never read; :func:`pack_worklist` cuts each row's pages
  into segments of at most ``SEG_PAGES``, one block each.  Two routes:
  bfloat16 with head_dim 64/128 and pages of a multiple of 16 positions
  (:func:`mma_scope`) run the tensor-core kernel ``csrc/ragged_mma.cu``
  (:func:`launch_mma`: query tiles x heads as ``mma.sync`` rows, one
  launch); float32, head_dim 32 and other pages the warp-reduction
  kernel ``csrc/ragged_attention.cu`` and its combine pass.
  ``launch.routes`` counts the launches of each route ("mma", "warp").
* :func:`ragged_attention`, the dispatch: a CPU tensor takes the plain
  version; a CUDA tensor with a work list launches the kernel and counts
  the launch in ``ragged_attention.launches``; a CUDA tensor without a
  work list raises.  There is no fall back from the card to the plain
  version.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_SMEM_LIMIT = 227 * 1024  # shared memory a block may use on Hopper
SEG_PAGES = 16  # pages one block reads: long rows split over more blocks
_P = ctypes.c_void_p
_I = ctypes.c_int


# ----------------------------------------------------------------------
# plain version
def ragged_gather(kp, vp, ppos, pages):
    """Each row's pages as one dense KV view.  pages: (B, T) int page ids
    (-1 = unallocated).  Returns (k, v, kpos): k/v (B, T*ps, Hkv, hd) and
    kpos (B, T*ps), -1 under unallocated table slots (whose k/v are page
    0's, masked like empty ring slots)."""
    pages = pages.to(device=kp.device, dtype=torch.long)
    B, T = pages.shape
    pidc = pages.clamp(min=0)
    k, v = kp[pidc], vp[pidc]                      # (B, T, ps, Hkv, hd)
    kpos = torch.where(pages[:, :, None] >= 0, ppos[pidc],
                       torch.full_like(ppos[pidc], -1))
    ps = k.shape[2]
    return (k.reshape(B, T * ps, *k.shape[3:]),
            v.reshape(B, T * ps, *v.shape[3:]),
            kpos.reshape(B, T * ps))


def ragged_attention_reference(q, kp, vp, ppos, pages, qpos, *,
                               window: Optional[int] = None):
    """``attention_core`` over the gathered view: q (B, C, H, hd), qpos
    (B, C) int absolute query positions."""
    from repro_torch.models.layers import attention_core  # layers imports us
    k, v, kpos = ragged_gather(kp, vp, ppos, pages)
    return attention_core(q, k, v, qpos, kpos, causal=True, window=window)


# ----------------------------------------------------------------------
# the work list, built on the host
def build_page_worklist(pages, n_live, q_lo, q_hi, page_size: int, *,
                        window: Optional[int] = None,
                        pad_to: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten the (row, page) work of one decode step or prompt chunk.

    pages: (B, T) page tables; ``n_live[b]``: live tokens of row b (0 =
    idle row, no work); row b's queries sit at positions ``[q_lo[b],
    q_hi[b]]``.  A page is listed only if it holds a position ``<= q_hi``
    and, with a ``window``, one ``> q_lo - window``.  Returns (wrow,
    wpage, wflags) int32 arrays padded to ``pad_to`` with inert entries
    that repeat the last pair; ``wflags[:, 0/1/2]`` = first/last/valid.
    Integer output equal to the reference's."""
    pages = np.asarray(pages)
    n_live = np.asarray(n_live)
    q_lo = np.broadcast_to(np.asarray(q_lo), (pages.shape[0],))
    q_hi = np.broadcast_to(np.asarray(q_hi), (pages.shape[0],))
    B, T = pages.shape
    wrow, wpage, wflags = [], [], []
    for b in range(B):
        n_pages = -(-int(n_live[b]) // page_size)
        keep = []
        for o in range(min(n_pages, T)):
            pid = int(pages[b, o])
            if pid < 0:
                continue
            page_lo, page_hi = o * page_size, (o + 1) * page_size - 1
            if page_lo > q_hi[b]:
                continue  # wholly beyond the causal frontier
            if window is not None and page_hi <= q_lo[b] - window:
                continue  # wholly outside the sliding window
            keep.append(pid)
        for j, pid in enumerate(keep):
            wrow.append(b)
            wpage.append(pid)
            wflags.append((int(j == 0), int(j == len(keep) - 1), 1))
    n = len(wrow)
    pad_to = max(pad_to or n, n, 1)
    pr, pp = (wrow[-1], wpage[-1]) if n else (0, 0)
    while len(wrow) < pad_to:
        wrow.append(pr)
        wpage.append(pp)
        wflags.append((0, 0, 0))
    return (np.asarray(wrow, np.int32), np.asarray(wpage, np.int32),
            np.asarray(wflags, np.int32).reshape(pad_to, 3))


class DeviceWorklist(NamedTuple):
    """A packed work list (:func:`pack_worklist`) on the card."""

    buf: torch.Tensor  # int32
    n_seg: int


def pack_worklist(wrow, wpage, wflags, n_rows: int,
                  seg_pages: int = SEG_PAGES) -> Tuple[np.ndarray, int]:
    """The kernel's view of a work list: one int32 array row_seg
    (n_rows + 1) | n_seg segments (row, lo, hi) | the listed pages, and
    n_seg.  Padding entries (valid 0) are dropped, so they contribute
    nothing; the rest must come in row order, as
    :func:`build_page_worklist` lists them.  Each row's pages are cut
    into segments of at most ``seg_pages`` consecutive entries ``[lo,
    hi)``; row b's segments are ``[row_seg[b], row_seg[b + 1])``."""
    real = np.asarray(wflags, np.int32)[:, 2] != 0
    wrow = np.asarray(wrow, np.int64)[real]
    if wrow.size and ((np.diff(wrow) < 0).any() or wrow.min() < 0
                      or wrow.max() >= n_rows):
        raise ValueError(f"work-list rows must be in row order, in "
                         f"[0, {n_rows})")
    starts = np.searchsorted(wrow, np.arange(n_rows + 1), side="left")
    segs, row_seg = [], [0]
    for b in range(n_rows):
        for lo in range(starts[b], starts[b + 1], seg_pages):
            segs.append((b, lo, min(lo + seg_pages, starts[b + 1])))
        row_seg.append(len(segs))
    return (np.concatenate([np.asarray(row_seg, np.int32),
                            np.asarray(segs, np.int32).reshape(-1),
                            np.asarray(wpage, np.int32)[real]]), len(segs))


# ----------------------------------------------------------------------
# the kernel
def _lib():
    fn = build.load("ragged_attention").ragged_attention
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                       _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    return fn


def _check(t: torch.Tensor, what: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {tuple(shape)} tensor, "
                         f"got {tuple(t.shape)} with strides {t.stride()}")


def _checked(q, kp, vp, ppos, qpos, work: DeviceWorklist):
    """Checks shared by both routes; returns (B, C, H, hd, P, ps, Hkv)."""
    if not q.is_cuda:
        raise ValueError("the CUDA kernel takes tensors on the card")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype} not in {list(_DTYPES)}")
    if q.dim() != 4 or kp.dim() != 4:
        raise ValueError("q must be (B, C, H, hd) and kp/vp (P, ps, Hkv, hd)")
    B, C, H, hd = q.shape
    P, ps, Hkv, _ = kp.shape
    dev = q.device
    _check(q, "q", (B, C, H, hd), q.dtype, dev)
    _check(kp, "kp", (P, ps, Hkv, hd), q.dtype, dev)
    _check(vp, "vp", (P, ps, Hkv, hd), q.dtype, dev)
    _check(ppos, "ppos", (P, ps), torch.int32, dev)
    _check(qpos, "qpos", (B, C), torch.int32, dev)
    n_seg, buf = work.n_seg, work.buf
    if buf.dim() != 1 or buf.numel() < B + 1 + 3 * n_seg:
        raise ValueError(f"work list of {buf.numel()} entries for {B} rows "
                         f"and {n_seg} segments")
    _check(buf, "work list", (buf.numel(),), torch.int32, dev)
    if hd not in _HEAD_DIMS or H % Hkv or H // Hkv > 32:
        raise ValueError(f"head_dim {hd} not in {_HEAD_DIMS}, or {H} heads "
                         f"over {Hkv} KV heads")
    if kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError("kp/vp must start on 16-byte boundaries")
    return B, C, H, hd, P, ps, Hkv


def _launch_warp(q, kp, vp, ppos, qpos, work: DeviceWorklist, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """``csrc/ragged_attention.cu`` alone (the segment kernel, dot products
    as warp reductions, and its combine pass): the route outside
    :func:`mma_scope`, and the previous kernel, timed beside the new one."""
    B, C, H, hd, P, ps, Hkv = _checked(q, kp, vp, ppos, qpos, work)
    if 3 * (2 * ps * hd * q.element_size() + 4 * ps) > _SMEM_LIMIT:  # 3 stages
        raise ValueError(f"a page of {ps} x {hd} does not fit the kernel's "
                         f"shared memory")
    dev, n_seg = q.device, work.n_seg
    out = torch.empty_like(q)
    part_acc = torch.empty((n_seg, C, H, hd), dtype=torch.float32, device=dev)
    part_ml = torch.empty((n_seg, C, H, 2), dtype=torch.float32, device=dev)
    rc = _lib()(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ppos.data_ptr(),
                qpos.data_ptr(), work.buf.data_ptr(), n_seg, part_acc.data_ptr(),
                part_ml.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, C, H, Hkv, hd, ps,
                0 if window is None else int(window),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ragged_attention launch failed: CUDA error {rc}")
    return out


MMA_ROWS = 64    # rows (queries x heads of a KV head) per block
MMA_WARPS = 4
MMA_STAGES = 3


def mma_tiles(C: int, G: int) -> Tuple[int, int, int]:
    """(queries per block ct, m16 row tiles, warps sharing a tile) of the
    tensor-core kernel: ct * G <= 64 rows; a block of one tile (decode)
    splits its pages over the 4 warps, one of two tiles over 2."""
    ct = min(C, max(1, MMA_ROWS // G))
    tiles = -(-ct * G // 16)
    return ct, tiles, max(1, MMA_WARPS // tiles) if tiles != 3 else 1


def mma_pages(start: int, end: int, ksplit: int):
    """(stage, warp of the tile, listed entry) in the order the kernel
    reads a segment [start, end): stage i stages entries start + i *
    ksplit .. + ksplit - 1, warp j of a tile scores entry start + i *
    ksplit + j."""
    n = -(-(end - start) // ksplit)
    return [(i, j, start + i * ksplit + j) for i in range(n)
            for j in range(ksplit) if start + i * ksplit + j < end]


def _mma_smem(ps: int, hd: int, ksplit: int) -> int:
    """The kernel's dynamic shared memory: its page ring or, after the
    loop, the warps' merge area, whichever is larger."""
    krow = 2 * hd + 16
    ring = MMA_STAGES * ksplit * (2 * ps * krow + 4 * ps)
    return max(ring, MMA_WARPS * 32 * (4 + hd // 2) * 4)


def mma_scope(q, kp, ppos) -> Optional[str]:
    """None when the tensor-core kernel reads q against the pages of kp
    and ppos, else why not (the warp-reduction kernel's case)."""
    B, C, H, hd = q.shape
    ps, Hkv = kp.shape[1], kp.shape[2]
    if q.dtype != torch.bfloat16:
        return f"q is {q.dtype}, the tensor-core kernel reads bfloat16"
    if hd not in (64, 128) or ps % 16 or H % Hkv or H // Hkv > MMA_ROWS:
        return (f"head_dim {hd} (64 or 128), page size {ps} (a multiple of "
                f"16) or {H} heads over {Hkv}")
    if _mma_smem(ps, hd, mma_tiles(C, H // Hkv)[2]) > _SMEM_LIMIT:
        return f"pages of {ps} x {hd} do not fit the kernel's shared memory"
    if any(t.data_ptr() % 16 for t in (q, kp, ppos)):
        return "the tensor-core kernel reads 16-byte aligned rows"
    return None


_COUNTERS: dict = {}


def _counters(dev, n: int) -> torch.Tensor:
    """The kernel's per-(row, KV head, query tile) arrival counters on
    ``dev``: zero, and left zero by every launch."""
    buf = _COUNTERS.get(dev)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[dev] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=dev)
    return buf


def _mma(q, kp, vp, ppos, qpos, work, window, dims) -> torch.Tensor:
    B, C, H, hd, P, ps, Hkv = dims
    dev, n_seg = q.device, work.n_seg
    ct, tiles, ksplit = mma_tiles(C, H // Hkv)
    out = torch.empty_like(q)
    part_acc = torch.empty((n_seg, C, H, hd), dtype=torch.float32, device=dev)
    part_ml = torch.empty((n_seg, C, H, 2), dtype=torch.float32, device=dev)
    counters = _counters(dev, B * Hkv * -(-C // ct))
    fn = build.load("ragged_mma").ragged_mma
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                       _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    rc = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ppos.data_ptr(),
            qpos.data_ptr(), work.buf.data_ptr(), n_seg, part_acc.data_ptr(),
            part_ml.data_ptr(), counters.data_ptr(), out.data_ptr(),
            B, C, H, Hkv, hd, ps, ct, ksplit,
            0 if window is None else int(window),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ragged_mma launch failed: CUDA error {rc}")
    return out


def launch_mma(q, kp, vp, ppos, qpos, work: DeviceWorklist, *,
               window: Optional[int] = None) -> torch.Tensor:
    """``csrc/ragged_mma.cu`` alone: raises ValueError outside
    :func:`mma_scope`."""
    dims = _checked(q, kp, vp, ppos, qpos, work)
    why = mma_scope(q, kp, ppos)
    if why is not None:
        raise ValueError(why)
    return _mma(q, kp, vp, ppos, qpos, work, window, dims)


def launch(q, kp, vp, ppos, qpos, work: DeviceWorklist, *,
           window: Optional[int] = None) -> torch.Tensor:
    """Ragged attention on the card: q (B, C, H, hd) against kp/vp (P,
    ps, Hkv, hd) through a packed work list on the card; returns out (B,
    C, H, hd) in q's dtype (zeros for rows without work).  The
    tensor-core kernel where :func:`mma_scope` admits the inputs, else
    the warp-reduction kernel.  Allocates the output and the segments'
    scratch; checks every input and raises on what the kernels cannot
    read (the page ids in the list index the pool: the kernel cannot
    check them without a device round trip); never synchronises."""
    dims = _checked(q, kp, vp, ppos, qpos, work)
    if mma_scope(q, kp, ppos) is None:
        out = _mma(q, kp, vp, ppos, qpos, work, window, dims)
        launch.routes["mma"] += 1
    else:
        out = _launch_warp(q, kp, vp, ppos, qpos, work, window=window)
        launch.routes["warp"] += 1
    return out


launch.routes = {"mma": 0, "warp": 0}  # launches by route, never reset here


# ----------------------------------------------------------------------
def ragged_attention(q, kp, vp, ppos, pages, qpos, *,
                     window: Optional[int] = None,
                     worklist: Optional[DeviceWorklist] = None):
    """Dispatch on q's device (module docstring).  ``worklist`` is the
    step's :class:`DeviceWorklist`, packed (:func:`pack_worklist`) and
    uploaded by the caller; the card ignores ``pages`` (the work list
    holds the page ids) and raises without it."""
    if worklist is not None and not isinstance(worklist, DeviceWorklist):
        raise TypeError(f"worklist must be a DeviceWorklist, got "
                        f"{type(worklist).__name__}")
    if q.device.type == "cpu":
        return ragged_attention_reference(q, kp, vp, ppos, pages, qpos,
                                          window=window)
    if worklist is None:
        raise ValueError("ragged_attention on the card needs a work list "
                         "(build_page_worklist, pack_worklist)")
    out = launch(q, kp, vp, ppos, qpos, worklist, window=window)
    ragged_attention.launches += 1
    return out


ragged_attention.launches = 0
