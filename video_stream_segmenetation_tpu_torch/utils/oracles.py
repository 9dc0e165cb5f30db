"""The literal per-pixel numpy oracles of the reference application's JS
loops that parity_matting.py chains (the port's own copy of the JAX
package's ``tests/oracles.py``, those eight functions unchanged).

Each is a straight-line port of one formula of the reference's
``frameProcessorTest.ts`` (the file:line is each docstring), written as
plain Python loops so that the batched ops can be held against them on
moving video.  Deliberately slow and literal: about a minute a frame at
288x512.
"""

from __future__ import annotations

import math

import numpy as np


def ema_oracle(prev: np.ndarray | None, current: np.ndarray, k: float):
    """frameProcessorTest.ts:218-227."""
    if prev is None:
        return current.copy(), current.copy()
    new_prev = k * prev + (1 - k) * current
    return new_prev, new_prev


def opening_oracle(alpha: np.ndarray) -> np.ndarray:
    """frameProcessorTest.ts:644-685 -- interior-only, zero borders."""
    h, w = alpha.shape
    eroded = np.zeros_like(alpha)
    for y in range(1, h - 1):
        for x in range(1, w - 1):
            m = 1.0
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    v = alpha[y + dy, x + dx]
                    if v < m:
                        m = v
            eroded[y, x] = m
    dilated = np.zeros_like(alpha)
    for y in range(1, h - 1):
        for x in range(1, w - 1):
            m = 0.0
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    v = eroded[y + dy, x + dx]
                    if v > m:
                        m = v
            dilated[y, x] = m
    return dilated


def closing_in_prior_oracle(alpha: np.ndarray, prior: np.ndarray | None) -> np.ndarray:
    """frameProcessorTest.ts:743-787."""
    if prior is None:
        return alpha
    h, w = alpha.shape
    dilated = np.zeros_like(alpha)
    for y in range(1, h - 1):
        for x in range(1, w - 1):
            if prior[y, x] <= 0:
                dilated[y, x] = alpha[y, x]
                continue
            m = 0.0
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    v = alpha[y + dy, x + dx]
                    if v > m:
                        m = v
            dilated[y, x] = m
    closed = np.zeros_like(alpha)
    for y in range(1, h - 1):
        for x in range(1, w - 1):
            if prior[y, x] <= 0:
                closed[y, x] = dilated[y, x]
                continue
            m = 1.0
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    v = dilated[y + dy, x + dx]
                    if v < m:
                        m = v
            closed[y, x] = m
    return closed


def bilateral_oracle(
    alpha: np.ndarray, guide_rgb: np.ndarray, sigma_s: float, sigma_r: float
) -> np.ndarray:
    """frameProcessorTest.ts:230-266. guide_rgb: [H, W, 3] in 0..255."""
    h, w = alpha.shape
    out = np.zeros_like(alpha)
    two_ss2 = 2 * sigma_s * sigma_s
    two_sr2 = 2 * sigma_r * sigma_r
    for y in range(h):
        for x in range(w):
            r0, g0, b0 = guide_rgb[y, x, :3].astype(np.float64)
            sw = 0.0
            sa = 0.0
            for dy in (-1, 0, 1):
                yy = y + dy
                if yy < 0 or yy >= h:
                    continue
                for dx in (-1, 0, 1):
                    xx = x + dx
                    if xx < 0 or xx >= w:
                        continue
                    dr = guide_rgb[yy, xx, 0] - r0
                    dg = guide_rgb[yy, xx, 1] - g0
                    db = guide_rgb[yy, xx, 2] - b0
                    range2 = dr * dr + dg * dg + db * db
                    spatial2 = dx * dx + dy * dy
                    wgt = math.exp(-spatial2 / two_ss2) * math.exp(-range2 / two_sr2)
                    sw += wgt
                    sa += wgt * alpha[yy, xx]
            out[y, x] = sa / sw if sw > 0 else alpha[y, x]
    return out


def refine_oracle(
    a: np.ndarray,
    low: float,
    high: float,
    gamma: float,
    prior: np.ndarray | None = None,
) -> np.ndarray:
    """frameProcessorTest.ts:270-313."""
    out = np.zeros_like(a)
    denom = max(1e-6, high - low)
    flat = a.ravel()
    pflat = prior.ravel() if prior is not None else None
    oflat = out.ravel()
    for i in range(flat.size):
        v = flat[i]
        if v <= low:
            v = 0.0
        elif v >= high:
            v = 1.0
        else:
            v = ((v - low) / denom) ** gamma
        if pflat is not None:
            p = pflat[i]
            if p > 0.25:
                v = max(v, min(1.0, 0.55 * p + 0.15))
            elif p > 0:
                v = min(v, 0.35 + 0.15 * p)
        oflat[i] = v
    return out


def face_prior_oracle(
    box: tuple[float, float, float, float],
    video_w: int,
    video_h: int,
    mask_w: int,
    mask_h: int,
) -> np.ndarray:
    """frameProcessorTest.ts:697-741."""
    out = np.zeros((mask_h, mask_w), dtype=np.float32)
    sx = mask_w / video_w
    sy = mask_h / video_h
    x0 = math.floor(box[0] * sx)
    y0 = math.floor(box[1] * sy)
    x1 = math.ceil(box[2] * sx)
    y1 = math.ceil(box[3] * sy)
    cx = (x0 + x1) / 2
    cy = (y0 + y1) / 2
    rx = (x1 - x0) * 0.56
    ry = (y1 - y0) * 0.70
    pad = max(4, math.floor(min(mask_w, mask_h) * 0.02))
    for y in range(mask_h):
        for x in range(mask_w):
            dx = (x - cx) / max(1e-6, rx)
            dy = (y - cy) / max(1e-6, ry)
            d2 = dx * dx + dy * dy
            v = 0.0
            if d2 <= 1:
                t = math.sqrt(max(0.0, min(1.0, d2)))
                v = 0.5 - 0.5 * math.cos(math.pi * (1 - t))
                if d2 > 1 - (pad / max(rx, ry)):
                    v = max(v, 0.25)
            out[y, x] = v
    return out


def warp_affine_nearest_oracle(src: np.ndarray, affine: tuple) -> np.ndarray:
    """frameProcessorTest.ts:323-353 (invert + nearest warp, Math.round)."""
    a11, a12, tx, a21, a22, ty = affine
    h, w = src.shape
    det = a11 * a22 - a12 * a21
    d = det if det != 0 else 1e-6
    ia11 = a22 / d
    ia12 = -a12 / d
    ia21 = -a21 / d
    ia22 = a11 / d
    itx = -(ia11 * tx + ia12 * ty)
    ity = -(ia21 * tx + ia22 * ty)
    out = np.zeros_like(src)
    for y in range(h):
        for x in range(w):
            sx = ia11 * x + ia12 * y + itx
            sy = ia21 * x + ia22 * y + ity
            xi = math.floor(sx + 0.5)  # JS Math.round
            yi = math.floor(sy + 0.5)
            if 0 <= xi < w and 0 <= yi < h:
                out[y, x] = src[yi, xi]
    return out


def resize_bilinear_tfjs_oracle(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """tf.image.resizeBilinear default (alignCorners=false,
    halfPixelCenters=false): src = dst * in/out, clamped taps."""
    in_h, in_w = img.shape[:2]
    out = np.zeros((out_h, out_w) + img.shape[2:], dtype=np.float64)
    for y in range(out_h):
        sy = y * in_h / out_h
        y0 = int(math.floor(sy))
        y1 = min(y0 + 1, in_h - 1)
        wy = sy - y0
        for x in range(out_w):
            sx = x * in_w / out_w
            x0 = int(math.floor(sx))
            x1 = min(x0 + 1, in_w - 1)
            wx = sx - x0
            out[y, x] = (
                img[y0, x0] * (1 - wx) * (1 - wy)
                + img[y0, x1] * wx * (1 - wy)
                + img[y1, x0] * (1 - wx) * wy
                + img[y1, x1] * wx * wy
            )
    return out
