"""Frozen copy of the HQQ arithmetic the benchmark's reference needs.

The layout and the formula are those of the port's ``quant/hqq.py`` as
the benchmark was written: codes ``(..., G, g*bits/8, N)`` uint8 packed
along ``g`` (4-bit: 2 codes per byte, 2-bit: 4, 3-bit: 8 codes in 3
planar bytes), the per-group scale and zero meta-quantized to 8 bits in
meta groups along G with float16 meta leaves, and ``w = (q - zero) *
scale``.  The quantizer (half-quadratic refinement of the zero point,
20 steps) is copied too, so that the reference can work out again what
the program's set-up derives from the drawn raw weights: the packed
experts and the 4-bit attention projections.
Nothing here imports the program.
"""
from __future__ import annotations

import torch

SCHEMES = {
    2: dict(group_size=16, scale_group=128),
    3: dict(group_size=64, scale_group=128),
    4: dict(group_size=64, scale_group=256),
    8: dict(group_size=64, scale_group=256),
}
META_KEYS = ("s_scale", "s_min", "z_scale", "z_min")


def meta_group(G: int, scale_group: int) -> int:
    """Groups per meta group: ``min(scale_group, G)`` halved until it
    divides G."""
    sg = min(scale_group, G)
    while G % sg:
        sg //= 2
    return sg


def _interleave(parts, g):
    stacked = torch.stack(parts, dim=-2)  # (..., C, P, N)
    sh = stacked.shape
    return stacked.reshape(sh[:-3] + (g,) + sh[-1:])


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
        qi = q.to(torch.int32)
        word = sum(qi[..., i::8, :] << (3 * i) for i in range(8))
        return torch.cat([((word >> s) & 0xFF).to(torch.uint8)
                          for s in (0, 8, 16)], dim=-2)
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
        word = (p[..., :n8, :].to(torch.int32)
                | (p[..., n8: 2 * n8, :].to(torch.int32) << 8)
                | (p[..., 2 * n8:, :].to(torch.int32) << 16))
        return _interleave([((word >> (3 * i)) & 0x7).to(torch.uint8)
                            for i in range(8)], g)
    raise ValueError(f"unsupported bits={bits}")


def meta_dequantize(q, s, m):
    """8-bit codes ``(..., M, sg, 1, N)`` with meta ``(..., M, 1, 1, N)``
    -> float32 ``(..., M * sg, 1, N)``."""
    a = q.to(torch.float32) * s.to(torch.float32) + m.to(torch.float32)
    sh = q.shape
    return a.reshape(*sh[:-4], sh[-4] * sh[-3], sh[-2], sh[-1])


def dequantize(packed, scale, zero, meta, bits: int, group_size: int,
               shape) -> torch.Tensor:
    """The float32 weight ``shape`` (..., K, N) of one packed record set."""
    if meta is None:
        sc, ze = scale.to(torch.float32), zero.to(torch.float32)
    else:
        sc = meta_dequantize(scale, meta["s_scale"], meta["s_min"])
        ze = meta_dequantize(zero, meta["z_scale"], meta["z_min"])
    q = unpack_codes(packed, bits, group_size).to(torch.float32)
    return ((q - ze) * sc).reshape(shape)


# ----------------------------------------------------------------------
def _shrink_lp(x, beta, p):
    return torch.sign(x) * torch.relu(
        x.abs() - (1.0 / beta) * torch.pow(x.abs() + 1e-8, p - 1.0))


def _quantize_groups(wg, bits, iters=20, lp=0.7, beta0=10.0, kappa=1.01):
    f32 = dict(dtype=torch.float32, device=wg.device)
    maxv = 2.0 ** bits - 1.0
    lp = torch.tensor(lp, **f32)
    beta = torch.tensor(beta0, **f32)
    kappa = torch.tensor(kappa, **f32)
    wmin = wg.amin(dim=-2, keepdim=True)
    wmax = wg.amax(dim=-2, keepdim=True)
    scale = (wmax - wmin) / maxv
    scale = torch.where(scale <= 1e-8, torch.ones_like(scale), scale)
    zero = -wmin / scale
    for _ in range(iters):
        q = torch.clamp(torch.round(wg / scale + zero), 0, maxv)
        wr = (q - zero) * scale
        we = _shrink_lp(wg - wr, beta, lp)
        zero = torch.mean(q - (wg - we) / scale, dim=-2, keepdim=True)
        beta = beta * kappa
    q = torch.clamp(torch.round(wg / scale + zero), 0, maxv).to(torch.uint8)
    return q, scale, zero


def _meta_quantize(a, scale_group):
    *lead, G, one, N = a.shape
    sg = meta_group(G, scale_group)
    ar = a.reshape(*lead, G // sg, sg, one, N)
    mn = ar.amin(dim=-3, keepdim=True)
    mx = ar.amax(dim=-3, keepdim=True)
    s = torch.where(mx - mn <= 1e-12, torch.ones_like(mx), (mx - mn) / 255.0)
    q = torch.clamp(torch.round((ar - mn) / s), 0, 255).to(torch.uint8)
    return q, s.to(torch.float16), mn.to(torch.float16)


def quantize_dequantize(w: torch.Tensor, bits: int) -> torch.Tensor:
    """``w`` (..., K, N) through the quantizer and back, float32: what the
    program's set-up makes of a dense weight it quantizes."""
    scheme = SCHEMES[bits]
    gs = scheme["group_size"]
    *lead, K, N = w.shape
    wg = w.reshape(*lead, K // gs, gs, N).to(torch.float32)
    q, scale, zero = _quantize_groups(wg, bits)
    packed = pack_codes(q, bits)
    sq, ss, sm = _meta_quantize(scale, scheme["scale_group"])
    zq, zs, zm = _meta_quantize(zero, scheme["scale_group"])
    meta = {"s_scale": ss, "s_min": sm, "z_scale": zs, "z_min": zm}
    return dequantize(packed, sq, zq, meta, bits, gs, tuple(w.shape))
