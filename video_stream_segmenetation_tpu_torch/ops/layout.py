"""Space-to-depth frame layout (port of ``ops/layout.py``).

Frames ride packed as ``[S, H/b, W/b, b*b*3]`` u8, patch lane order
``(dy, dx, c)``.  The guide is a lane selection of the packed frames; the
composites (one alpha, or K class maps with one effect a class) upsample
at mask resolution and blend in the packed layout.
"""

from __future__ import annotations

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.ops.blur import gaussian_blur_planar_mxu
from video_stream_segmenetation_tpu_torch.ops.consts import device_const
from video_stream_segmenetation_tpu_torch.ops.resize import (
    _interp_matrix,
    _nearest_taps,
    interp_matrix,
)


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """``[..., H, W, C] -> [..., H/b, W/b, b*b*C]``, patch order (dy,dx,c)."""
    *lead, h, w, c = x.shape
    b = block
    if h % b or w % b:
        raise ValueError(f"space_to_depth: {h}x{w} not divisible by {b}")
    nd = len(lead)
    x = x.reshape(*lead, h // b, b, w // b, b, c)
    x = x.permute(*range(nd), nd, nd + 2, nd + 1, nd + 3, nd + 4)
    return x.reshape(*lead, h // b, w // b, b * b * c)


def depth_to_space(x: torch.Tensor, block: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    *lead, hp, wp, cc = x.shape
    b = block
    c = cc // (b * b)
    if cc != b * b * c:
        raise ValueError(f"depth_to_space: channel dim {cc} not {b}*{b}*c")
    nd = len(lead)
    x = x.reshape(*lead, hp, wp, b, b, c)
    x = x.permute(*range(nd), nd, nd + 2, nd + 1, nd + 3, nd + 4)
    return x.reshape(*lead, hp * b, wp * b, c)


def guide_s2d_sel(frame_hw, out_hw, block, channels=3, method="half_pixel"):
    """Lane indices that pick the nearest (half-pixel) guide taps out of
    each packed patch, channel-major (the reference's ``planar=True``
    order), or ``None`` where the taps do not repeat per patch."""
    fh, fw = frame_hw
    oh, ow = out_hw
    hp, wp = fh // block, fw // block
    if (oh % hp) or (ow % wp):
        raise ValueError(f"guide_from_s2d: {out_hw} not a multiple of {(hp, wp)}")
    fy, fx = oh // hp, ow // wp
    iy = _nearest_taps(oh, fh, method)
    ix = _nearest_taps(ow, fw, method)
    offs_y, offs_x = iy % block, ix % block
    ok = (
        np.array_equal(iy // block, np.repeat(np.arange(hp), fy))
        and np.array_equal(ix // block, np.repeat(np.arange(wp), fx))
        and np.array_equal(offs_y, np.tile(offs_y[:fy], hp))
        and np.array_equal(offs_x, np.tile(offs_x[:fx], wp))
    )
    if not ok:
        return None
    return (
        np.arange(channels)[:, None, None]
        + (offs_y[None, :fy, None] * block + offs_x[None, None, :fx]) * channels
    ).reshape(-1)


def guide_from_s2d(xp: torch.Tensor, frame_hw, out_hw, block, channels=3,
                   method="half_pixel") -> torch.Tensor:
    """Nearest-neighbour guide of packed frames ``[..., hp, wp, b*b*C]`` u8,
    planar: ``[..., C, oh, ow]`` u8 (the reference's ``planar=True``)."""
    sel = guide_s2d_sel(frame_hw, out_hw, block, channels, method)
    if sel is None:
        raise NotImplementedError(
            f"guide_from_s2d: the taps of {frame_hw} -> {out_hw} do not repeat per patch")
    oh, ow = out_hw
    hp, wp = frame_hw[0] // block, frame_hw[1] // block
    fy, fx = oh // hp, ow // wp
    g = xp[..., device_const(("guide_sel", tuple(sel)), xp.device,
                             lambda: torch.as_tensor(sel))]  # [..., hp, wp, nl]
    *lead, _, _, _ = g.shape
    nd = len(lead)
    g = g.reshape(*lead, hp, wp, channels, fy, fx)
    g = g.permute(*range(nd), nd + 2, nd, nd + 3, nd + 1, nd + 4)
    return g.reshape(*lead, channels, oh, ow)


def guide_lanes_s2d(xp: torch.Tensor, frame_hw, out_hw, block, channels=3,
                    method="half_pixel"):
    """The guide's raw tap lanes of packed frames ``[S, hp, wp, b*b*C]`` u8:
    ``([nl, S, hp, wp] u8, (fy, fx))``, lane ``k = (c*fy + yy)*fx + xx``
    holding guide pixel ``(c, fy*i + yy, fx*j + xx)`` at patch ``(i, j)``
    (the reference's ``guide_lanes_s2d``, there a one-hot product, exact
    for u8; here the lane gather).  ``None`` where the taps do not repeat
    per patch."""
    sel = guide_s2d_sel(frame_hw, out_hw, block, channels, method)
    if sel is None:
        return None
    hp, wp = frame_hw[0] // block, frame_hw[1] // block
    idx = device_const(("guide_sel", tuple(sel)), xp.device, lambda: torch.as_tensor(sel))
    lanes = xp[..., idx].permute(3, 0, 1, 2).contiguous()
    return lanes, (out_hw[0] // hp, out_hw[1] // wp)


def lanes_to_planar(lanes: torch.Tensor, geom, channels=3) -> torch.Tensor:
    """Reassemble tap lanes ``[nl, K, hp, wp]`` (:func:`guide_lanes_s2d`)
    into the planar guide ``[K, C, hp*fy, wp*fx]`` u8 (the reference's
    ``guide_from_gathered`` with block 1)."""
    fy, fx = geom
    _, k, hp, wp = lanes.shape
    g = lanes.reshape(channels, fy, fx, k, hp, wp).permute(3, 0, 4, 1, 5, 2)
    return g.reshape(k, channels, hp * fy, wp * fx)


def packed_color(color_f32, block: int, device="cpu") -> torch.Tensor:
    """Solid RGB colour (floats 0..1) as one packed patch vector
    ``[block*block*3]`` u8."""
    c = torch.as_tensor(color_f32, dtype=torch.float32, device=device)
    c_u8 = torch.clamp(torch.floor(c * 255.0 + 0.5), 0, 255).to(torch.uint8)
    return c_u8.repeat(block * block)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16 and back (a DEFAULT-precision product's operand
    or result on the reference)."""
    return x.to(torch.bfloat16).float()


def alpha_composite_s2d(frame_p: torch.Tensor, alpha: torch.Tensor,
                        bg_p: torch.Tensor, frame_hw, block: int,
                        method: str = "half_pixel", precision: str = "fast") -> torch.Tensor:
    """Upsample ``alpha [S, mh, mw]`` to the frame and blend
    ``frame*a + bg*(1-a)`` in the packed layout; u8 out, round half up.

    Same semantics as the reference's packed composite: the ``method``
    taps as two interpolation products, the upsampled alpha clamped to
    [0, 1].  ``precision`` (``upsample_precision``): ``'fast'``, the
    reference's DEFAULT-precision matmuls, whose operands and results round
    to bf16; ``'exact'``, its HIGHEST: both products in f32, nothing
    rounded to bf16 (f32 products need TF32 off, which the engine pins for
    its steps, runtime/precision.py).
    """
    fh, fw = frame_hw
    s = frame_p.shape[0]
    dev = frame_p.device
    rnd = _bf16 if precision == "fast" else (lambda x: x)
    a_h = rnd(interp_matrix(fh, alpha.shape[-2], method, device=dev))
    a_w = rnd(interp_matrix(fw, alpha.shape[-1], method, device=dev))
    c = rnd(torch.matmul(a_h, rnd(alpha.float())))  # [S, fh, mw]
    up = torch.clamp(rnd(torch.matmul(c, a_w.t())), 0.0, 1.0)  # [S, fh, fw]
    a_p = space_to_depth(up.unsqueeze(-1), block)  # [S, hp, wp, b*b]
    a_p = a_p.repeat_interleave(3, dim=-1)
    f = frame_p.float()
    g = bg_p.expand(s, *frame_p.shape[1:]).float()
    blend = f * a_p + g * (1.0 - a_p)
    return torch.clamp(torch.floor(blend + 0.5), 0, 255).to(torch.uint8)


def effect_algebra(effects) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One effect a class as the affine layer ``alpha_w[k] * frame +
    beta_w[k] * blurred + cmat[k]`` (keep: alpha 1 | tint s: alpha 1-s,
    c = s*tint*255 | color: c = color*255 | blur: beta 1).  Returns
    (alpha_w [K], beta_w [K], cmat [K, 3]) f32; an unknown effect is
    refused by name."""
    k = len(effects)
    alpha_w = np.zeros((k,), np.float32)
    beta_w = np.zeros((k,), np.float32)
    cmat = np.zeros((k, 3), np.float32)
    for ci, eff in enumerate(effects):
        if eff.get("keep"):
            alpha_w[ci] = 1.0
        elif "color" in eff:
            cmat[ci] = np.asarray(eff["color"], np.float32) * 255.0
        elif "blur" in eff:
            beta_w[ci] = 1.0
        elif "tint" in eff:
            st = float(eff.get("strength", 0.5))
            alpha_w[ci] = 1.0 - st
            cmat[ci] = np.asarray(eff["tint"], np.float32) * 255.0 * st
        else:
            raise ValueError(f"unknown effect {eff!r}: the effects are keep, color, "
                             "blur and tint")
    return alpha_w, beta_w, cmat


def multiclass_composite_s2d(frame_p: torch.Tensor, class_alpha: torch.Tensor, effects,
                             frame_hw, block: int, method: str = "half_pixel",
                             highest: bool = False) -> torch.Tensor:
    """Per-class-effect composite in the packed layout (port of
    ``multiclass_composite_s2d``): every effect layer is affine in (frame,
    blurred, constant), so the blend collapses to two fields composed at
    class-map resolution and upsampled once,

        out = up(w_f) * frame + up(R),   w_f = sum_k alpha_k a_k,
        R = blurred * 255 * sum_k beta_k a_k + sum_k c_k a_k,

    with ``a`` the class simplex ``class_alpha [S, mh, mw, K]`` (taken as it
    is: the caller renormalises, as the reference's ``assume_simplex=True``
    caller does) and the blur over the nearest planar guide
    at sigma ``max(sigma * mh / fh, 0.5)``.  The field contraction is f32
    (the reference's HIGHEST); the upsample is the reference's
    DEFAULT-precision dtype flow unless ``highest``: its operands and its
    H-pass and per-dy W-pass results round to bf16.  The H pass takes the
    rows dy-major and each dy slice of the packed output is made from its
    own row block.  frame_p ``[S, H/b, W/b, b*b*3]`` u8 -> packed u8."""
    fh, fw = frame_hw
    b = block
    hp, wp = fh // b, fw // b
    s = frame_p.shape[0]
    mh, mw, k = class_alpha.shape[-3:]
    if len(effects) != k:
        raise ValueError(f"need {k} effects, got {len(effects)}")
    dev = frame_p.device
    rnd = (lambda x: x) if highest else _bf16
    alpha_w, beta_w, cmat = effect_algebra(effects)

    ca = class_alpha.to(torch.float32)
    coef = torch.tensor(np.concatenate([alpha_w[:, None], beta_w[:, None], cmat], axis=1),
                        device=dev)  # [K, 5]: (w_f, w_b, c_r, c_g, c_b)
    planes = torch.einsum("smwk,kp->spmw", ca, coef)  # [S, 5, mh, mw]
    w_f = planes[:, 0]
    rgb = planes[:, 2:5]
    if beta_w.any():
        guide = guide_from_s2d(frame_p, frame_hw, (mh, mw), b, method=method)
        sigma = float(next(e["blur"] for e in effects if "blur" in e))
        sigma_small = max(sigma * mh / fh, 0.5)
        blurred = torch.clamp(gaussian_blur_planar_mxu(guide.float() / 255.0, sigma_small),
                              0.0, 1.0)  # [S, 3, mh, mw]
        rgb = rgb + blurred * 255.0 * planes[:, 1:2]

    a_h = _interp_matrix(fh, mh, method)
    a_h_perm = rnd(torch.tensor(np.concatenate([a_h[dy::b] for dy in range(b)], axis=0),
                                device=dev))  # rows (dy, i) = a_h[i*b + dy]
    a_w_t = rnd(interp_matrix(fw, mw, method, device=dev)).t()  # [mw, fw]
    cmat_f = rnd(torch.matmul(a_h_perm, rnd(w_f)))  # [S, b*hp, mw]
    hmat_r = rnd(torch.matmul(a_h_perm, rnd(rgb)))  # [S, 3, b*hp, mw]
    out_slices = []
    for dy in range(b):
        rows = slice(dy * hp, (dy + 1) * hp)
        wf_sl = rnd(torch.matmul(cmat_f[:, rows], a_w_t))  # [S, hp, fw]
        r_sl = rnd(torch.matmul(hmat_r[:, :, rows], a_w_t))  # [S, 3, hp, fw]
        # packed lanes (dx, c) of row block dy
        r_p = r_sl.permute(0, 2, 3, 1).reshape(s, hp, wp, 3 * b)
        wf3 = wf_sl.reshape(s, hp, wp, b, 1).expand(s, hp, wp, b, 3).reshape(s, hp, wp, 3 * b)
        f_sl = frame_p[..., 3 * b * dy: 3 * b * (dy + 1)].float()
        acc = f_sl * wf3 + r_p
        out_slices.append(torch.clamp(torch.floor(acc + 0.5), 0, 255).to(torch.uint8))
    return torch.cat(out_slices, dim=-1)
