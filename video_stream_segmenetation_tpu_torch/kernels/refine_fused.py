"""Stages 3-9 of the mask path as one CUDA kernel (``csrc/refine_fused.cu``).

Replaces the Pallas kernel
``video_stream_segmenetation_tpu/kernels/refine_fused.py::
fused_temporal_refine`` (pallas_call at line 752) in its analytic-prior
form (``_temporal_refine_kernel_analytic``): separable nearest warp + blend,
motion-gated EMA, opening, closing inside the face prior, joint bilateral on
the planar u8 guide, threshold/gamma with the prior clamps.  new_prev stays
f32, the refined alpha is bf16.

Bound on an H100: bytes (about 17 bytes a pixel) -- see the source's
header for the row-tiled design.  One call is one launch and counts once
in ``fused_temporal_refine.launches``.
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


def fused_temporal_refine_plain(alpha_raw, prev_alpha, yi, xi, guide, table):
    """Plain PyTorch version, built from ops/*: same arguments as the
    kernel's wrapper after index and scalar preparation."""
    k = dict(zip(KNOB_COLUMNS, table.unbind(1)))
    flag = {n: k[n] > 0 for n in ("use_bilateral", "has_prior", "use_warp", "initialized")}
    h, w = alpha_raw.shape[-2:]
    wb = k["warp_blend"][:, None, None]
    warped = warp_separable_gather(prev_alpha, yi, xi)
    base = torch.where(flag["use_warp"][:, None, None],
                       warped * wb + alpha_raw * (1.0 - wb), alpha_raw)
    new_prev, a = temporal_ema(prev_alpha, base, k["ema"], flag["initialized"],
                               adapt=k["ema_adapt"])
    params = torch.stack([k["prior_cx"], k["prior_cy"], k["prior_rx"], k["prior_ry"]], 1)
    prior = torch.where(flag["has_prior"][:, None, None],
                        prior_plane_from_params(params, (h, w)),
                        torch.zeros((), device=alpha_raw.device))
    a = morphological_opening(a)
    a = morphological_closing_in_prior(a, prior, flag["has_prior"])
    a_bi = joint_bilateral3x3(a, guide, k["sigma_spatial"], k["sigma_range"])
    a = torch.where(flag["use_bilateral"][:, None, None], a_bi, a)
    a = refine_alpha(a, k["low"], k["high"], k["gamma"], prior, flag["has_prior"])
    return new_prev, a.to(torch.bfloat16)


def _launch(alpha_raw, prev_alpha, yi, xi, guide, table):
    s, h, w = alpha_raw.shape
    for name, t, dt, shape in (
        ("alpha_raw", alpha_raw, torch.float32, (s, h, w)),
        ("prev_alpha", prev_alpha, torch.float32, (s, h, w)),
        ("yi", yi, torch.int32, (s, h)),
        ("xi", xi, torch.int32, (s, w)),
        ("guide", guide, torch.uint8, (s, 3, h, w)),
        ("table", table, torch.float32, (s, len(KNOB_COLUMNS))),
    ):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.device != alpha_raw.device:
            raise ValueError(f"fused_temporal_refine: {name} must be contiguous "
                             f"{dt} {shape} on {alpha_raw.device}")
    lib = _build.library()
    new_prev = torch.empty_like(alpha_raw)
    out = torch.empty((s, h, w), dtype=torch.bfloat16, device=alpha_raw.device)
    stream = torch.cuda.current_stream(alpha_raw.device).cuda_stream
    _build.check(lib, lib.vst_temporal_refine(
        alpha_raw.data_ptr(), prev_alpha.data_ptr(), yi.data_ptr(), xi.data_ptr(),
        guide.data_ptr(), table.data_ptr(), new_prev.data_ptr(), out.data_ptr(),
        s, h, w, prior_pad((h, w)), stream,
    ), "temporal_refine")
    fused_temporal_refine.launches += 1
    return new_prev, out


def fused_temporal_refine(alpha_raw, prev_alpha, affine, use_warp, initialized,
                          warp_blend, guide, prior_params, has_prior, knobs):
    """Stages 3-9.  alpha_raw, prev_alpha ``[S, H, W]`` f32; affine ``[S, 6]``
    (its scale+translate part warps prev); use_warp, initialized, has_prior
    ``[S]`` bool; guide ``[S, 3, H, W]`` u8; prior_params ``[S, 4]``
    (cx, cy, rx, ry); knobs a PipelineKnobs.  Returns (new_prev f32,
    refined bf16).  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    h, w = alpha_raw.shape[-2:]
    yi, xi = separable_warp_indices(affine, (h, w))
    table = scalar_table(knobs, use_warp, initialized, warp_blend,
                         prior_params, has_prior)
    if alpha_raw.device.type == "cpu":
        return fused_temporal_refine_plain(alpha_raw, prev_alpha, yi, xi, guide, table)
    return _launch(alpha_raw, prev_alpha, yi, xi, guide, table)


fused_temporal_refine.launches = 0
