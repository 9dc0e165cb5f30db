"""The stateless entry points (port of ``api.py``): ``segment(frame) ->
mask``, ``composite(frame, mask, background) -> frame`` and
``process_frame`` (both in one call).  The stateful multi-stream loop is
:class:`service.engine.Engine`.

Every call runs on the card (``device='cuda'``) unless the caller passes
``device='cpu'``; it raises where ``cuda`` is asked for and there is none.
Results are tensors on that device.
"""

from __future__ import annotations

import functools
import warnings
import zipfile

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.bridge import WEIGHTS_DIR, load_export
from video_stream_segmenetation_tpu_torch.models.backbones import freeze
from video_stream_segmenetation_tpu_torch.models.registry import get_spec
from video_stream_segmenetation_tpu_torch.ops.blur import gaussian_blur_auto
from video_stream_segmenetation_tpu_torch.ops.composite import alpha_composite
from video_stream_segmenetation_tpu_torch.ops.resize import resize_bilinear, resize_frames_u8
from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
from video_stream_segmenetation_tpu_torch.service.engine import resolve_device


@functools.lru_cache(maxsize=4)
def _default_matting(model_name: str, device: torch.device) -> torch.nn.Module:
    """The module serving ``weights/<model_name>.npz`` where that export
    exists (the trained weights), else the registry's tree from seed 0; a
    present export that fails to load is said, not hidden."""
    spec = get_spec(model_name)
    path = WEIGHTS_DIR / f"{model_name}.npz"
    if path.is_file():
        try:
            return freeze(spec.build(load_export(path), device))
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            # a silent fallback would serve garbage masks with no signal
            warnings.warn(f"weights restore failed for {str(path)!r} ({e!r}); serving "
                          f"randomly-initialized {model_name} weights", stacklevel=3)
    model, _ = spec.init_params(0, device)
    return freeze(model)


def _model(params, model_name: str, device: torch.device) -> torch.nn.Module:
    if params is None:
        return _default_matting(model_name, device)
    if isinstance(params, torch.nn.Module):
        return params
    return freeze(get_spec(model_name).build(params, device))


def _batched(x, rank: int, device: torch.device):
    """``x`` on ``device``, with a leading axis added to a single item."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    t = t.to(device)
    if t.ndim == rank - 1:
        return t[None], True
    return t, False


def _alpha(model, frames_u8: torch.Tensor, mask_hw) -> torch.Tensor:
    small = resize_frames_u8(frames_u8, tuple(mask_hw), "asymmetric")
    return model(small)["alpha"].to(torch.float32)


def _background(f: torch.Tensor, background, bg_blur_sigma) -> torch.Tensor:
    """The composite's f32 background for frames ``f`` (0..1): the frame
    blurred, a colour (black when none is given), or an image (u8 or 0..1,
    any size, resized half-pixel bilinear to the frame)."""
    if background is None and bg_blur_sigma is not None:
        return gaussian_blur_auto(f, float(bg_blur_sigma))
    if background is None:
        return torch.zeros(3, dtype=torch.float32, device=f.device)
    if isinstance(background, (tuple, list)) and len(background) == 3:
        return torch.tensor(background, dtype=torch.float32, device=f.device)
    bg = background if isinstance(background, torch.Tensor) \
        else torch.as_tensor(np.asarray(background))
    bg = bg.to(f.device)
    bg = bg.to(torch.float32) / 255.0 if bg.dtype == torch.uint8 else bg.to(torch.float32)
    if tuple(bg.shape[-3:-1]) != tuple(f.shape[-3:-1]):
        bg = resize_bilinear(bg, tuple(f.shape[-3:-1]), method="half_pixel")
    return bg


def segment(frame, params=None, model_name: str = "mattenet", mask_hw=(288, 512),
            device="cuda"):
    """``segment(frame) -> mask``: frame u8 ``[H, W, 3]`` or ``[S, H, W,
    3]``; returns the f32 alpha at mask resolution (``[h, w]`` or ``[S, h,
    w]``).  ``params``: a tree for ``model_name`` (models/registry.py) or
    a built module; None serves ``weights/<model_name>.npz`` where it
    exists, else the registry's seeded tree."""
    dev = resolve_device(device)
    frames, squeezed = _batched(frame, 4, dev)
    with pinned():
        a = _alpha(_model(params, model_name, dev), frames, mask_hw)
    return a[0] if squeezed else a


def composite(frame, mask, background=None, bg_blur_sigma: float | None = None,
              upsample_method: str = "half_pixel", device="cuda"):
    """``composite(frame, mask, background) -> frame``: frame u8 ``[H, W,
    3]`` or ``[S, H, W, 3]``; mask an f32 alpha at any resolution
    (upsampled here); background None (the frame blurred by
    ``bg_blur_sigma``, else black), an RGB image (any size, resized here)
    or a colour 3-tuple in 0..1.  Returns u8 frames."""
    dev = resolve_device(device)
    frames, squeezed = _batched(frame, 4, dev)
    m = mask if isinstance(mask, torch.Tensor) else torch.as_tensor(np.asarray(mask))
    m = m.to(dev, torch.float32)
    if squeezed and m.ndim == 2:
        m = m[None]
    f = frames.to(torch.float32) / 255.0
    with pinned():
        out = alpha_composite(f, m, background=_background(f, background, bg_blur_sigma),
                              upsample_method=upsample_method, out_u8=True)
    return out[0] if squeezed else out


def process_frame(frame, background=None, params=None, model_name: str = "mattenet",
                  mask_hw=(288, 512), bg_blur_sigma: float | None = None,
                  upsample_method: str = "half_pixel", device="cuda"):
    """:func:`segment` then :func:`composite` in one call, the frame
    uploaded once; returns ``(composited u8 frames, f32 mask)`` on the
    device.  For stateful many-stream serving use ``Engine``."""
    dev = resolve_device(device)
    frames, squeezed = _batched(frame, 4, dev)
    f = frames.to(torch.float32) / 255.0
    with pinned():
        alpha = _alpha(_model(params, model_name, dev), frames, mask_hw)
        out = alpha_composite(f, alpha, background=_background(f, background, bg_blur_sigma),
                              upsample_method=upsample_method, out_u8=True)
    if squeezed:
        return out[0], alpha[0]
    return out, alpha
