"""The mask path's refine stages as CUDA kernels (``csrc/refine_fused.cu``).

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
* :func:`fused_refine`: ``fused_refine`` (pallas_call at line 522,
  ``_refine_kernel``): stages 5, 7, 8 and 9 alone on an alpha already
  warped and smoothed (``warp_impl='exact'``), with the prior plane.

new_prev stays f32; the temporal forms' refined alpha is bf16 or f32
(``out_dtype``, the reference's ``refined_dtype``), fused_refine's f32.

Bound on an H100: bytes (15-23 bytes a pixel) -- see the source's header
for the row-tiled design.  One call is one launch and counts once in its
wrapper's ``launches``.
"""

from __future__ import annotations

import torch

from video_stream_segmenetation_tpu_torch.kernels import _build
from video_stream_segmenetation_tpu_torch.ops.bilateral import joint_bilateral3x3
from video_stream_segmenetation_tpu_torch.ops.morphology import (
    morphological_closing_in_prior,
    morphological_opening,
)
from video_stream_segmenetation_tpu_torch.ops.prior import (
    prior_pad,
    prior_plane_from_params,
)
from video_stream_segmenetation_tpu_torch.ops.refine import refine_alpha
from video_stream_segmenetation_tpu_torch.ops.temporal import temporal_ema
from video_stream_segmenetation_tpu_torch.ops.warp import (
    separable_warp_indices,
    warp_separable_gather,
)

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


def _chain_plain(a, guide, prior, k, flag):
    """Stages 5, 7, 8 and 9 (the reference's ``_chain_body``) from ops/*;
    ``prior`` is already zero for the streams without one."""
    a = morphological_opening(a)
    a = morphological_closing_in_prior(a, prior, flag["has_prior"])
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
                                out_dtype=torch.bfloat16, prior_plane=None):
    """Plain PyTorch version, built from ops/*: same arguments as the
    kernel's wrapper after index and scalar preparation; the prior
    rasterised from the table's scalars, or ``prior_plane [S, H, W]``."""
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
    a = _chain_plain(a, guide, _gated(prior_plane, flag["has_prior"]), k, flag)
    return new_prev, a.to(out_dtype)


def _check(what, ref, specs):
    for name, t, dt, shape in specs:
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.device != ref.device:
            raise ValueError(f"{what}: {name} must be contiguous {dt} {shape} on {ref.device}")


def _launch(alpha_raw, prev_alpha, yi, xi, guide, table, out_dtype=torch.bfloat16,
            prior_plane=None):
    """One launch of the temporal refine: the analytic form, or the plane
    form with ``prior_plane``.  Returns (new_prev, refined)."""
    s, h, w = alpha_raw.shape
    specs = [
        ("alpha_raw", alpha_raw, torch.float32, (s, h, w)),
        ("prev_alpha", prev_alpha, torch.float32, (s, h, w)),
        ("yi", yi, torch.int32, (s, h)),
        ("xi", xi, torch.int32, (s, w)),
        ("guide", guide, torch.uint8, (s, 3, h, w)),
        ("table", table, torch.float32, (s, len(KNOB_COLUMNS))),
    ]
    if prior_plane is not None:
        specs.append(("prior_plane", prior_plane, torch.float32, (s, h, w)))
    _check("fused_temporal_refine", alpha_raw, specs)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_temporal_refine: out_dtype {out_dtype} is not bf16 or f32")
    lib = _build.library()
    new_prev = torch.empty_like(alpha_raw)
    out = torch.empty((s, h, w), dtype=out_dtype, device=alpha_raw.device)
    stream = torch.cuda.current_stream(alpha_raw.device).cuda_stream
    _build.check(lib, lib.vst_temporal_refine(
        alpha_raw.data_ptr(), prev_alpha.data_ptr(), yi.data_ptr(), xi.data_ptr(),
        guide.data_ptr(), table.data_ptr(),
        None if prior_plane is None else prior_plane.data_ptr(),
        new_prev.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.float32), s, h, w, prior_pad((h, w)), stream,
    ), "temporal_refine")
    counter = fused_temporal_refine if prior_plane is None else fused_temporal_refine_plane
    counter.launches += 1
    return new_prev, out


def fused_temporal_refine(alpha_raw, prev_alpha, affine, use_warp, initialized,
                          warp_blend, guide, prior_params, has_prior, knobs,
                          out_dtype=torch.bfloat16):
    """Stages 3-9.  alpha_raw, prev_alpha ``[S, H, W]`` f32; affine ``[S, 6]``
    (its scale+translate part warps prev); use_warp, initialized, has_prior
    ``[S]`` bool; guide ``[S, 3, H, W]`` u8; prior_params ``[S, 4]``
    (cx, cy, rx, ry); knobs a PipelineKnobs; out_dtype bf16 or f32.
    Returns (new_prev f32, refined in out_dtype).  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    h, w = alpha_raw.shape[-2:]
    yi, xi = separable_warp_indices(affine, (h, w))
    table = scalar_table(knobs, use_warp, initialized, warp_blend,
                         prior_params, has_prior)
    if alpha_raw.device.type == "cpu":
        return fused_temporal_refine_plain(alpha_raw, prev_alpha, yi, xi, guide,
                                           table, out_dtype)
    return _launch(alpha_raw, prev_alpha, yi, xi, guide, table, out_dtype)


fused_temporal_refine.launches = 0


def fused_temporal_refine_plane(alpha_raw, prev_alpha, affine, use_warp, initialized,
                                warp_blend, guide, prior_plane, has_prior, knobs,
                                out_dtype=torch.bfloat16):
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
                                           out_dtype, prior_plane)
    return _launch(alpha_raw, prev_alpha, yi, xi, guide, table, out_dtype, prior_plane)


fused_temporal_refine_plane.launches = 0


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
