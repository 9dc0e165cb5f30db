"""The mask path's refine stages as CUDA kernels (``csrc/refine_fused.cuh``).

Replaces the Pallas kernels of
``video_stream_segmenetation_tpu/kernels/refine_fused.py``:

* :func:`fused_temporal_refine`: ``fused_temporal_refine`` (pallas_call at
  line 752) in its analytic-prior form (``_temporal_refine_kernel_analytic``):
  separable nearest warp + blend, motion-gated EMA, opening, closing inside
  the face prior, joint bilateral on the planar u8 guide, threshold/gamma
  with the prior clamps;
* :func:`fused_temporal_refine_plane`: the same call's plane-prior form
  (``_temporal_refine_kernel``, ``prior_impl='plane'``), the prior read from
  an ``[S, H, W]`` plane;
* :func:`fused_temporal_refine_fast`: the same call's fast form
  (``_temporal_refine_kernel_fast`` with ``_guide_from_lanes``), analytic
  prior: from the head-grid logits (``refine_alpha_src='lowres'``, the
  upsample and sigmoid in the kernel) and/or the guide's raw tap lanes
  (``guide_kernel_unfold=True``, unfolded in the kernel);
* :func:`fused_refine`: ``fused_refine`` (pallas_call at line 522,
  ``_refine_kernel``): stages 5, 7, 8 and 9 alone on an alpha already
  warped and smoothed (``warp_impl='exact'``), with the prior plane.

new_prev stays f32; the temporal forms' refined alpha is bf16 or f32
(``out_dtype``, the reference's ``refined_dtype``), fused_refine's f32.
The EMA's motion gate, ``(t0, 1 / (t1 - t0))`` (Python floats, each
rounded once to f32 where it is used), is read from
runtime/config.py::ema_gate at each call, as the reference reads
``EMA_ADAPT_T0/T1`` when it traces its kernel; the kernel takes it as two
arguments of the launch.

The temporal forms take the reference's bench-only ``debug`` tokens
(``'no_morph'``: stages 5 and 7 skipped; ``'no_bilateral'``: stage 8
skipped): compile-time variants of the body (``csrc/refine_debug.cu``),
which count in the same wrapper's ``launches``; any other token raises.

Bound on an H100: bytes (15-23 bytes a pixel) -- see the source's header
for the design (a block rolls down one stream's strip of columns, a row a
step, its stages chained through rings of rows in shared memory).  One call
is one launch and counts once in its wrapper's ``launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.kernels import _build
from video_stream_segmenetation_tpu_torch.ops.bilateral import joint_bilateral3x3
from video_stream_segmenetation_tpu_torch.ops.consts import device_const
from video_stream_segmenetation_tpu_torch.ops.layout import lanes_to_planar
from video_stream_segmenetation_tpu_torch.ops.morphology import (
    morphological_closing_in_prior,
    morphological_opening,
)
from video_stream_segmenetation_tpu_torch.ops.prior import (
    prior_pad,
    prior_plane_from_params,
)
from video_stream_segmenetation_tpu_torch.ops.refine import refine_alpha
from video_stream_segmenetation_tpu_torch.ops.resize import _interp_matrix, resize_bilinear_mxu
from video_stream_segmenetation_tpu_torch.ops.temporal import temporal_ema
from video_stream_segmenetation_tpu_torch.ops.warp import (
    separable_warp_indices,
    warp_separable_gather,
)
from video_stream_segmenetation_tpu_torch.runtime.config import ema_gate

# column order of the per-stream scalar table the kernel reads
KNOB_COLUMNS = (
    "low", "high", "gamma", "use_bilateral", "sigma_spatial", "sigma_range",
    "has_prior", "ema", "ema_adapt", "use_warp", "initialized", "warp_blend",
    "prior_cx", "prior_cy", "prior_rx", "prior_ry",
)


def scalar_table(knobs, use_warp, initialized, warp_blend, prior_params,
                 has_prior) -> torch.Tensor:
    """The 16 per-stream scalars as one ``[S, 16]`` f32 table (flags 0/1)."""
    s = use_warp.shape[0]
    dev = use_warp.device
    cols = [
        knobs.noise_cutoff, knobs.high_threshold, knobs.gamma,
        knobs.use_bilateral, knobs.sigma_spatial, knobs.sigma_range,
        has_prior, knobs.ema, knobs.ema_adapt, use_warp, initialized,
        torch.full((s,), warp_blend, dtype=torch.float32, device=dev),
        prior_params[:, 0], prior_params[:, 1], prior_params[:, 2],
        prior_params[:, 3],
    ]
    return torch.stack([c.to(torch.float32) for c in cols], dim=1).contiguous()


# the debug tokens and their bits in the kernel (csrc/refine_fused.cuh)
DEBUG_BITS = {"no_morph": 1, "no_bilateral": 2}


def debug_bits(debug) -> int:
    """The kernel's variant of the ``debug`` tokens; an unknown token raises."""
    unknown = [t for t in debug if t not in DEBUG_BITS]
    if unknown:
        raise ValueError(f"fused_temporal_refine: unknown debug token {unknown[0]!r}; "
                         f"the tokens are {tuple(DEBUG_BITS)}")
    return sum(DEBUG_BITS[t] for t in set(debug))


def _chain_plain(a, guide, prior, k, flag, debug=()):
    """Stages 5, 7, 8 and 9 (the reference's ``_chain_body``) from ops/*;
    ``prior`` is already zero for the streams without one; ``debug``:
    ``'no_morph'`` skips stages 5 and 7, ``'no_bilateral'`` stage 8."""
    if "no_morph" not in debug:
        a = morphological_opening(a)
        a = morphological_closing_in_prior(a, prior, flag["has_prior"])
    if "no_bilateral" not in debug:
        a_bi = joint_bilateral3x3(a, guide, k["sigma_spatial"], k["sigma_range"])
        a = torch.where(flag["use_bilateral"][:, None, None], a_bi, a)
    return refine_alpha(a, k["low"], k["high"], k["gamma"], prior, flag["has_prior"])


def _columns(table):
    k = dict(zip(KNOB_COLUMNS, table.unbind(1)))
    flag = {n: k[n] > 0 for n in ("use_bilateral", "has_prior", "use_warp", "initialized")}
    return k, flag


def _gated(prior, has_prior):
    return torch.where(has_prior[:, None, None], prior, torch.zeros((), device=prior.device))


def fused_temporal_refine_plain(alpha_raw, prev_alpha, yi, xi, guide, table,
                                out_dtype=torch.bfloat16, prior_plane=None,
                                alpha_lowres_hw=None, guide_lanes_geom=None, debug=()):
    """Plain PyTorch version, built from ops/*: same arguments as the
    kernel's wrapper after index and scalar preparation; the prior
    rasterised from the table's scalars, or ``prior_plane [S, H, W]``.
    With ``alpha_lowres_hw`` alpha_raw is the head-grid logits, upsampled
    (f32 interpolation products) and put through the sigmoid here; with
    ``guide_lanes_geom`` guide is the tap lanes, reassembled here;
    ``debug`` the tokens of :func:`_chain_plain`."""
    debug_bits(debug)
    if alpha_lowres_hw is not None:
        alpha_raw = torch.sigmoid(resize_bilinear_mxu(alpha_raw, alpha_lowres_hw, "half_pixel",
                                                      channel_last=False))
    if guide_lanes_geom is not None:
        guide = lanes_to_planar(guide, guide_lanes_geom)
    k, flag = _columns(table)
    h, w = alpha_raw.shape[-2:]
    wb = k["warp_blend"][:, None, None]
    warped = warp_separable_gather(prev_alpha, yi, xi)
    base = torch.where(flag["use_warp"][:, None, None],
                       warped * wb + alpha_raw * (1.0 - wb), alpha_raw)
    new_prev, a = temporal_ema(prev_alpha, base, k["ema"], flag["initialized"],
                               adapt=k["ema_adapt"])
    if prior_plane is None:
        params = torch.stack([k["prior_cx"], k["prior_cy"], k["prior_rx"], k["prior_ry"]], 1)
        prior_plane = prior_plane_from_params(params, (h, w))
    a = _chain_plain(a, guide, _gated(prior_plane, flag["has_prior"]), k, flag, debug)
    return new_prev, a.to(out_dtype)


def _check(what, ref, specs):
    for name, t, dt, shape in specs:
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.device != ref.device:
            raise ValueError(f"{what}: {name} must be contiguous {dt} {shape} on {ref.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(alpha_src, prev_alpha, yi, xi, guide_src, table, out_dtype=torch.bfloat16,
            prior_plane=None, alpha_lowres_hw=None, guide_lanes_geom=None, debug=()):
    """One launch of the temporal refine: the analytic form; the plane form
    with ``prior_plane``; the fast form (analytic prior) with
    ``alpha_lowres_hw`` and/or ``guide_lanes_geom``; the debug variant of
    the ``debug`` tokens.  Returns (new_prev, refined)."""
    bits = debug_bits(debug)
    s, h, w = prev_alpha.shape
    lowres, lanes = alpha_lowres_hw is not None, guide_lanes_geom is not None
    if prior_plane is not None and (lowres or lanes):
        raise ValueError("fused_temporal_refine: the fast form takes the analytic prior only")
    if lowres and tuple(alpha_lowres_hw) != (h, w):
        raise ValueError(f"alpha_lowres_hw {alpha_lowres_hw} is not prev_alpha's {(h, w)}")
    h0, w0 = alpha_src.shape[-2:] if lowres else (h, w)
    if h0 > h or w0 > w:
        raise ValueError(f"fused_temporal_refine: head-grid logits {(h0, w0)} larger than "
                         f"the plane {(h, w)}")
    fy, fx = guide_lanes_geom if lanes else (1, 1)
    if h % fy or w % fx:
        raise ValueError(f"guide_lanes_geom {(fy, fx)} does not divide {(h, w)}")
    specs = [
        ("alpha_src", alpha_src, torch.float32, (s, h0, w0)),
        ("prev_alpha", prev_alpha, torch.float32, (s, h, w)),
        ("yi", yi, torch.int32, (s, h)),
        ("xi", xi, torch.int32, (s, w)),
        ("guide_src", guide_src, torch.uint8,
         (3 * fy * fx, s, h // fy, w // fx) if lanes else (s, 3, h, w)),
        ("table", table, torch.float32, (s, len(KNOB_COLUMNS))),
    ]
    if prior_plane is not None:
        specs.append(("prior_plane", prior_plane, torch.float32, (s, h, w)))
    _check("fused_temporal_refine", prev_alpha, specs)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_temporal_refine: out_dtype {out_dtype} is not bf16 or f32")
    dev = prev_alpha.device
    taps, wts = lowres_taps((h, w), (h0, w0), dev) if lowres else (None, None)
    lib = _build.library()
    new_prev = torch.empty_like(prev_alpha)
    out = torch.empty((s, h, w), dtype=out_dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (alpha_src.data_ptr(), prev_alpha.data_ptr(), yi.data_ptr(), xi.data_ptr(),
            guide_src.data_ptr(), table.data_ptr(), _ptr(prior_plane), _ptr(taps), _ptr(wts),
            new_prev.data_ptr(), out.data_ptr(), int(out_dtype == torch.float32),
            int(lanes), s, h, w, h0, w0, fy, fx, prior_pad((h, w)))
    t0, inv_ramp = ema_gate()
    if bits:
        code = lib.vst_temporal_refine_debug(*args, bits, t0, inv_ramp, stream)
    else:
        code = lib.vst_temporal_refine(*args, t0, inv_ramp, stream)
    _build.check(lib, code, "temporal_refine")
    if lowres or lanes:
        counter = fused_temporal_refine_fast
    else:
        counter = fused_temporal_refine if prior_plane is None else fused_temporal_refine_plane
    counter.launches += 1
    return new_prev, out


def fused_temporal_refine(alpha_raw, prev_alpha, affine, use_warp, initialized,
                          warp_blend, guide, prior_params, has_prior, knobs,
                          out_dtype=torch.bfloat16, debug=()):
    """Stages 3-9.  alpha_raw, prev_alpha ``[S, H, W]`` f32; affine ``[S, 6]``
    (its scale+translate part warps prev); use_warp, initialized, has_prior
    ``[S]`` bool; guide ``[S, 3, H, W]`` u8; prior_params ``[S, 4]``
    (cx, cy, rx, ry); knobs a PipelineKnobs; out_dtype bf16 or f32; debug
    the bench-only tokens (module docstring).  Returns (new_prev f32,
    refined in out_dtype).  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    h, w = alpha_raw.shape[-2:]
    yi, xi = separable_warp_indices(affine, (h, w))
    table = scalar_table(knobs, use_warp, initialized, warp_blend,
                         prior_params, has_prior)
    if alpha_raw.device.type == "cpu":
        return fused_temporal_refine_plain(alpha_raw, prev_alpha, yi, xi, guide,
                                           table, out_dtype, debug=debug)
    return _launch(alpha_raw, prev_alpha, yi, xi, guide, table, out_dtype, debug=debug)


fused_temporal_refine.launches = 0


def fused_temporal_refine_plane(alpha_raw, prev_alpha, affine, use_warp, initialized,
                                warp_blend, guide, prior_plane, has_prior, knobs,
                                out_dtype=torch.bfloat16, debug=()):
    """Stages 3-9 with the prior as a plane ``prior_plane [S, H, W]`` f32
    (the face path's rendered prior, zero where no face was found); the
    rest as :func:`fused_temporal_refine`.  Returns (new_prev f32, refined
    in out_dtype).  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    h, w = alpha_raw.shape[-2:]
    yi, xi = separable_warp_indices(affine, (h, w))
    table = scalar_table(knobs, use_warp, initialized, warp_blend,
                         torch.zeros((alpha_raw.shape[0], 4), device=alpha_raw.device),
                         has_prior)
    if alpha_raw.device.type == "cpu":
        return fused_temporal_refine_plain(alpha_raw, prev_alpha, yi, xi, guide, table,
                                           out_dtype, prior_plane, debug=debug)
    return _launch(alpha_raw, prev_alpha, yi, xi, guide, table, out_dtype, prior_plane,
                   debug=debug)


fused_temporal_refine_plane.launches = 0


def _two_taps(out_size: int, in_size: int) -> tuple[np.ndarray, np.ndarray]:
    """The nonzero columns of each row of the half-pixel interpolation
    matrix ``[out, in]`` (at most two, in ascending order; a row with one
    repeats it with weight 0) and their weights."""
    m = _interp_matrix(out_size, in_size, "half_pixel")
    taps = np.zeros((out_size, 2), np.int32)
    wts = np.zeros((out_size, 2), np.float32)
    for r in range(out_size):
        (cols,) = np.nonzero(m[r])
        taps[r] = cols[0], cols[-1]
        wts[r, :len(cols)] = m[r, cols]
    return taps, wts


def lowres_taps(hw, hw0, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``taps [H + W, 2]`` int32 and ``wts [H + W, 2]`` f32: the two taps
    of each output row (``hw0[0]`` -> ``hw[0]``), then of each output
    column, kept on ``device``."""
    def make(n):
        rows, cols = _two_taps(hw[0], hw0[0]), _two_taps(hw[1], hw0[1])
        return np.ascontiguousarray(np.concatenate([rows[n], cols[n]]))
    key = ("lowres_taps", tuple(hw), tuple(hw0))
    return (device_const(key + (0,), device, lambda: make(0)),
            device_const(key + (1,), device, lambda: make(1)))


def fused_temporal_refine_fast(alpha_src, prev_alpha, affine, use_warp, initialized,
                               warp_blend, guide_src, prior_params, has_prior, knobs,
                               out_dtype=torch.bfloat16, alpha_lowres_hw=None,
                               guide_lanes_geom=None, debug=()):
    """Stages 3-9 with the analytic prior, as :func:`fused_temporal_refine`,
    with one or both of the fast form's inputs: ``alpha_lowres_hw=(H, W)``
    takes ``alpha_src`` as the head-grid logits ``[S, h0, w0]`` f32 (the
    half-pixel upsample to ``(H, W)`` and the sigmoid in the kernel, else
    the raw alpha ``[S, H, W]``); ``guide_lanes_geom=(fy, fx)`` takes
    ``guide_src`` as the tap lanes ``[3*fy*fx, S, H/fy, W/fx]`` u8
    (ops/layout.py::guide_lanes_s2d; else the planar guide).  Returns
    (new_prev f32, refined in out_dtype).  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    h, w = prev_alpha.shape[-2:]
    yi, xi = separable_warp_indices(affine, (h, w))
    table = scalar_table(knobs, use_warp, initialized, warp_blend,
                         prior_params, has_prior)
    if prev_alpha.device.type == "cpu":
        return fused_temporal_refine_plain(alpha_src, prev_alpha, yi, xi, guide_src, table,
                                           out_dtype, None, alpha_lowres_hw, guide_lanes_geom,
                                           debug)
    return _launch(alpha_src, prev_alpha, yi, xi, guide_src, table, out_dtype, None,
                   alpha_lowres_hw, guide_lanes_geom, debug)


fused_temporal_refine_fast.launches = 0


def refine_table(knobs, has_prior) -> torch.Tensor:
    """:func:`scalar_table` for :func:`fused_refine`: the knobs and
    has_prior; the temporal columns zero (the kernel reads none of them)."""
    s = has_prior.shape[0]
    zero = torch.zeros((s,), dtype=torch.bool, device=has_prior.device)
    return scalar_table(knobs, zero, zero, 0.0,
                        torch.zeros((s, 4), device=has_prior.device), has_prior)


def fused_refine_plain(alpha, guide, prior_plane, table):
    """Plain PyTorch version of :func:`fused_refine`: stages 5, 7, 8 and 9
    from ops/*, f32 out."""
    k, flag = _columns(table)
    return _chain_plain(alpha, guide, _gated(prior_plane, flag["has_prior"]), k, flag)


def fused_refine(alpha, guide, prior_plane, has_prior, knobs) -> torch.Tensor:
    """Stages 5, 7, 8 and 9 on ``alpha [S, H, W]`` f32 (already warped and
    smoothed): opening, closing inside the prior, joint bilateral on the
    planar u8 guide ``[S, 3, H, W]``, threshold/gamma with the prior clamps.
    prior_plane ``[S, H, W]`` f32, has_prior ``[S]`` bool, knobs a
    PipelineKnobs.  Returns the refined alpha f32 (the reference applies
    no ``refined_dtype`` here).  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    table = refine_table(knobs, has_prior)
    if alpha.device.type == "cpu":
        return fused_refine_plain(alpha, guide, prior_plane, table)
    s, h, w = alpha.shape
    _check("fused_refine", alpha, (
        ("alpha", alpha, torch.float32, (s, h, w)),
        ("guide", guide, torch.uint8, (s, 3, h, w)),
        ("prior_plane", prior_plane, torch.float32, (s, h, w)),
        ("table", table, torch.float32, (s, len(KNOB_COLUMNS))),
    ))
    lib = _build.library()
    out = torch.empty_like(alpha)
    stream = torch.cuda.current_stream(alpha.device).cuda_stream
    _build.check(lib, lib.vst_refine(alpha.data_ptr(), guide.data_ptr(), table.data_ptr(),
                                     prior_plane.data_ptr(), out.data_ptr(), s, h, w,
                                     stream), "refine")
    fused_refine.launches += 1
    return out


fused_refine.launches = 0
