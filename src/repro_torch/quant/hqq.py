"""Half-Quadratic Quantization (HQQ, Badri & Shaji 2023) in PyTorch.

The port of the reference's ``quant/hqq.py``: group-wise affine
quantization along the contraction axis K of a ``(..., K, N)`` matrix,
with the zero point refined by half-quadratic (proximal) steps under an
l_p (p < 1) residual norm, and the per-group scale/zero meta-quantized to
8 bits over ``scale_group`` groups.

Layout (identical to the reference, so stores carry across bit for bit):
codes ``(..., G, g*bits/8, N)`` uint8 packed along ``g``; scale/zero
``(..., G, 1, N)``, or ``(..., M, sg, 1, N)`` uint8 when meta-quantized
(meta arrays ``(..., M, 1, 1, N)`` float16).  4-bit packs 2 codes per
byte, 2-bit 4, and 3-bit 8 codes into 3 planar bytes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

# the paper's group-size table (section 4.2)
PAPER_SCHEMES = {
    16: dict(bits=16, group_size=None, scale_group=None),
    8: dict(bits=8, group_size=64, scale_group=256),
    4: dict(bits=4, group_size=64, scale_group=256),
    3: dict(bits=3, group_size=64, scale_group=128),
    2: dict(bits=2, group_size=16, scale_group=128),
}

META_KEYS = ("s_scale", "s_min", "z_scale", "z_min")


@dataclasses.dataclass
class QTensor:
    """Packed quantized tensor. ``packed``: uint8 (..., G, g*bits//8, N)."""

    packed: torch.Tensor
    scale: torch.Tensor  # (..., G, 1, N) f16, or meta-quantized uint8
    zero: torch.Tensor
    meta: Optional[dict]  # {s_scale, s_min, z_scale, z_min} f16, or None
    bits: int
    group_size: int
    shape: Tuple[int, ...]  # original (..., K, N)


# ----------------------------------------------------------------------
# bit packing along axis -2 (the ``g`` axis of (..., G, g, N))
def pack_codes(q: torch.Tensor, bits: int) -> torch.Tensor:
    q = q.to(torch.uint8)
    if bits == 8:
        return q
    if bits == 4:
        return q[..., 0::2, :] | (q[..., 1::2, :] << 4)
    if bits == 2:
        return (q[..., 0::4, :] | (q[..., 1::4, :] << 2)
                | (q[..., 2::4, :] << 4) | (q[..., 3::4, :] << 6))
    if bits == 3:
        g = q.shape[-2]
        assert g % 8 == 0, "3-bit packing needs g % 8 == 0"
        qi = q.to(torch.int32)
        word = sum(qi[..., i::8, :] << (3 * i) for i in range(8))  # 24 bits
        planes = [((word >> s) & 0xFF).to(torch.uint8) for s in (0, 8, 16)]
        return torch.cat(planes, dim=-2)
    raise ValueError(f"unsupported bits={bits}")


def unpack_codes(p: torch.Tensor, bits: int, g: int) -> torch.Tensor:
    if bits == 8:
        return p
    if bits == 4:
        return _interleave([p & 0x0F, p >> 4], g)
    if bits == 2:
        return _interleave([(p >> (2 * i)) & 0x03 for i in range(4)], g)
    if bits == 3:
        n8 = g // 8
        b0 = p[..., :n8, :].to(torch.int32)
        b1 = p[..., n8: 2 * n8, :].to(torch.int32)
        b2 = p[..., 2 * n8:, :].to(torch.int32)
        word = b0 | (b1 << 8) | (b2 << 16)
        return _interleave([((word >> (3 * i)) & 0x7).to(torch.uint8)
                            for i in range(8)], g)
    raise ValueError(f"unsupported bits={bits}")


def _interleave(parts, g):
    # parts[i] holds the codes at positions i::len(parts) along axis -2;
    # the original index is j = c*P + i, so (c, i) merges c-major.
    stacked = torch.stack(parts, dim=-2)  # (..., C, P, N)
    sh = stacked.shape
    return stacked.reshape(sh[:-3] + (g,) + sh[-1:])


# ----------------------------------------------------------------------
def _shrink_lp(x, beta, p):
    """Generalized soft-threshold (HQQ proximal operator for l_p, p<1)."""
    return torch.sign(x) * torch.relu(
        x.abs() - (1.0 / beta) * torch.pow(x.abs() + 1e-8, p - 1.0))


def _quantize_groups(wg, bits, iters, lp=0.7, beta0=10.0, kappa=1.01):
    """wg: (..., G, g, N) f32 -> (codes u8, scale, zero) with HQQ zero opt.

    ``beta`` and ``lp`` are float32 tensors, as in the reference (they are
    traced f32 values there), so the shrink threshold rounds alike."""
    f32 = dict(dtype=torch.float32, device=wg.device)
    maxv = 2.0 ** bits - 1.0
    lp = torch.tensor(lp, **f32)
    beta = torch.tensor(beta0, **f32)
    kappa = torch.tensor(kappa, **f32)
    wmin = wg.amin(dim=-2, keepdim=True)
    wmax = wg.amax(dim=-2, keepdim=True)
    scale = (wmax - wmin) / maxv
    scale = torch.where(scale <= 1e-8, torch.ones_like(scale), scale)
    zero = -wmin / scale  # code-space zero point
    for _ in range(iters):
        q = torch.clamp(torch.round(wg / scale + zero), 0, maxv)
        wr = (q - zero) * scale
        we = _shrink_lp(wg - wr, beta, lp)
        zero = torch.mean(q - (wg - we) / scale, dim=-2, keepdim=True)
        beta = beta * kappa
    q = torch.clamp(torch.round(wg / scale + zero), 0, maxv).to(torch.uint8)
    return q, scale, zero


def quantize(w: torch.Tensor, bits: int, group_size: Optional[int] = None,
             scale_group: Optional[int] = None, iters: int = 20) -> QTensor:
    """Quantize ``w (..., K, N)`` grouped along K.  bits in {2,3,4,8}.
    Runs on ``w``'s device."""
    scheme = PAPER_SCHEMES[bits]
    group_size = group_size or scheme["group_size"]
    scale_group = scale_group if scale_group is not None else scheme["scale_group"]
    *lead, K, N = w.shape
    assert K % group_size == 0, (K, group_size)
    G = K // group_size
    wg = w.reshape(*lead, G, group_size, N).to(torch.float32)
    q, scale, zero = _quantize_groups(wg, bits, iters)
    packed = pack_codes(q, bits)
    meta = None
    if scale_group:
        scale, zero, meta = _meta_quantize(scale, zero, scale_group)
    else:
        scale = scale.to(torch.float16)
        zero = zero.to(torch.float16)
    return QTensor(packed, scale, zero, meta, bits, group_size, tuple(w.shape))


def meta_group(G: int, scale_group: int) -> int:
    """Groups per meta group: ``min(scale_group, G)`` halved until it
    divides G."""
    sg = min(scale_group, G)
    while G % sg:
        sg //= 2
    return sg


def _meta_quantize(scale, zero, scale_group):
    """8-bit meta-quantization of the per-group scale/zero, in groups of
    ``sg`` along the G axis."""
    def mq(a):
        *lead, G, one, N = a.shape
        sg = meta_group(G, scale_group)
        ar = a.reshape(*lead, G // sg, sg, one, N)
        mn = ar.amin(dim=-3, keepdim=True)
        mx = ar.amax(dim=-3, keepdim=True)
        s = torch.where(mx - mn <= 1e-12, torch.ones_like(mx), (mx - mn) / 255.0)
        q = torch.clamp(torch.round((ar - mn) / s), 0, 255).to(torch.uint8)
        return q, s.to(torch.float16), mn.to(torch.float16)

    sq, ss, sm = mq(scale)
    zq, zs, zm = mq(zero)
    meta = {"s_scale": ss, "s_min": sm, "z_scale": zs, "z_min": zm}
    return sq, zq, meta


def _meta_dequantize(qt: QTensor):
    """(scale, zero) as f32 ``(..., G, 1, N)``."""
    if qt.meta is None:
        return qt.scale.to(torch.float32), qt.zero.to(torch.float32)

    def dq(q, s, m):
        a = q.to(torch.float32) * s.to(torch.float32) + m.to(torch.float32)
        sh = q.shape
        return a.reshape(*sh[:-4], sh[-4] * sh[-3], sh[-2], sh[-1])

    scale = dq(qt.scale, qt.meta["s_scale"], qt.meta["s_min"])
    zero = dq(qt.zero, qt.meta["z_scale"], qt.meta["z_min"])
    return scale, zero


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    scale, zero = _meta_dequantize(qt)
    q = unpack_codes(qt.packed, qt.bits, qt.group_size).to(torch.float32)
    w = (q - zero) * scale
    return w.reshape(qt.shape).to(dtype)


def slice_leading(qt: QTensor, idx) -> QTensor:
    """Index a stacked :class:`QTensor` along its leading (batch) axes;
    the leaves of the result are views."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    nd = len(idx)
    assert nd < len(qt.shape) - 1, (idx, qt.shape)
    meta = None if qt.meta is None else {k: v[idx] for k, v in qt.meta.items()}
    return QTensor(qt.packed[idx], qt.scale[idx], qt.zero[idx], meta,
                   qt.bits, qt.group_size, tuple(qt.shape[nd:]))


def leaves(qt: QTensor):
    """(name, tensor) of every stored leaf, in storage order."""
    out = [("packed", qt.packed), ("scale", qt.scale), ("zero", qt.zero)]
    if qt.meta is not None:
        out += [(k, qt.meta[k]) for k in META_KEYS]
    return out


# ----------------------------------------------------------------------
# size accounting (Table 1)
def nbytes(qt: QTensor) -> int:
    return int(sum(a.numel() * a.element_size() for _, a in leaves(qt)))


def bits_per_param(qt: QTensor) -> float:
    return 8.0 * nbytes(qt) / math.prod(qt.shape)


def quant_error(w: torch.Tensor, qt: QTensor) -> dict:
    wd = dequantize(qt)
    diff = wd - w.to(torch.float32)
    rel = torch.linalg.vector_norm(diff) / (
        torch.linalg.vector_norm(w.to(torch.float32)) + 1e-9)
    return {"max_abs": float(diff.abs().max()), "rel_fro": float(rel),
            "bits_per_param": bits_per_param(qt)}


# ----------------------------------------------------------------------
# model-level helpers over nested dicts / lists of tensors (the
# reference's pytrees; a QTensor counts as its leaves unless asked)
def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree, keep_qtensors: bool = False):
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in tree_leaves(v, keep_qtensors)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in tree_leaves(v, keep_qtensors)]
    if isinstance(tree, QTensor) and not keep_qtensors:
        return [a for _, a in leaves(tree)]
    return [] if tree is None else [tree]


def dense_nbytes(tree, bytes_per_el: int = 2) -> int:
    return sum(a.numel() * bytes_per_el for a in tree_leaves(tree))


def quantize_tree(tree, bits: int, **kw):
    """Quantize every >= 2-D leaf of a parameter subtree whose K (axis -2)
    the group size divides; the others stay as they are."""
    gs = kw.get("group_size") or PAPER_SCHEMES[bits]["group_size"]

    def q(leaf):
        if leaf.dim() >= 2 and leaf.shape[-2] % gs == 0:
            return quantize(leaf, bits, **kw)
        return leaf

    return tree_map(q, tree)


def dequantize_tree(tree, dtype=torch.float32):
    return tree_map(lambda a: dequantize(a, dtype) if isinstance(a, QTensor)
                else a, tree)


def tree_nbytes(tree) -> int:
    """Packed bytes of the quantized leaves, 2 bytes per element of the
    others."""
    return sum(nbytes(a) if isinstance(a, QTensor) else a.numel() * 2
               for a in tree_leaves(tree, keep_qtensors=True))
