"""Training data over real photographic backgrounds (port of
``train/realdata.py``).

A bank of photographs is loaded once (:func:`load_background_bank`) and
moved to the device once; each batch composites a procedural person (the
two-ellipse person of train/loop.py, or the articulated one of
train/person.py) over augmented random crops of the photos (scale, flip,
colour gain): the ``data_fn(generator, batch, hw)`` hook of
train/loop.py::fit.  As the other generators, each is split into draws
and a render of given draws, so that a test can render the reference's
own draws.  The repository holds no photographs: the caller names the
directory.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.train import person as P
from video_stream_segmenetation_tpu_torch.train.loop import (
    person_draws,
    person_parts,
    synthetic_matting_batch,
    uniform,
)


def render_person_alpha(d: dict, hw: tuple[int, int]) -> torch.Tensor:
    """The person matte ``[B, H, W]`` (body and head soft ellipses) of
    train/loop.py::person_draws."""
    parts = person_parts(d, hw)
    return torch.maximum(parts["a_body"], parts["a_head"])


def person_alpha(gen: torch.Generator, batch: int, hw: tuple[int, int]) -> torch.Tensor:
    """The procedural person matte, the foreground half of
    train/loop.py::synthetic_matting_batch, over any background."""
    return render_person_alpha(person_draws(gen, batch, hw), hw)


def load_background_bank(hw: tuple[int, int], directory, max_images: int = 16,
                         oversample: float = 2, as_uint8: bool = False) -> np.ndarray:
    """The photos under ``directory`` (png/jpg/jpeg, sorted by name, at
    most ``max_images``) resized bilinearly (PIL) to ``oversample`` times
    ``hw`` -> ``[N, oversample*H, oversample*W, 3]`` host numpy, larger than
    the training geometry so that random crops have room: f32 in [0, 1],
    or u8 with ``as_uint8`` (the crops convert).  FileNotFoundError when
    the directory is absent or holds no photo."""
    from PIL import Image

    if oversample < 1:
        raise ValueError(f"oversample must be >= 1, got {oversample}")
    if not os.path.isdir(directory):
        raise FileNotFoundError(directory)
    names = sorted(n for n in os.listdir(directory)
                   if n.lower().endswith((".png", ".jpg", ".jpeg")))[:max_images]
    if not names:
        raise FileNotFoundError(f"no images under {directory}")
    h, w = int(hw[0] * oversample), int(hw[1] * oversample)
    bank = np.empty((len(names), h, w, 3), np.uint8 if as_uint8 else np.float32)
    for i, n in enumerate(names):
        img = Image.open(os.path.join(directory, n)).convert("RGB").resize(
            (w, h), Image.BILINEAR)
        a = np.asarray(img, np.float32)
        bank[i] = a.astype(np.uint8) if as_uint8 else a / 255.0
    return bank


def crop_draws(gen: torch.Generator, batch: int, n: int, bank_hw, hw) -> dict:
    """The background crops' draws: the photo ``idx`` ``[B]``, the window's
    ``scale`` ``[B]`` in [1, bank height / H), its offsets' fractions
    ``y0u``, ``x0u`` ``[B]``, ``flip_u`` ``[B]`` (a mirror where below 0.5)
    and the colour ``gain`` ``[B, 1, 1, 3]`` in [0.7, 1.2)."""
    return {"idx": torch.randint(0, n, (batch,), generator=gen, device=gen.device),
            "scale": uniform(gen, (batch,), 1.0, bank_hw[0] / hw[0]),
            "y0u": uniform(gen, (batch,)), "x0u": uniform(gen, (batch,)),
            "flip_u": uniform(gen, (batch,)), "gain": uniform(gen, (batch, 1, 1, 3), 0.7, 1.2)}


def crop_backgrounds(bank: torch.Tensor, d: dict, hw) -> torch.Tensor:
    """Augmented crops ``[B, H, W, 3]`` in [0, 1] of the device bank ``[N,
    bh, bw, 3]`` (f32 or u8) from :func:`crop_draws`: a window of ``scale``
    times the target at the drawn offset, sampled at nearest (truncated)
    taps, mirrored, times the gain, clipped."""
    h, w = hw
    _, bh, bw, _ = bank.shape
    scale = d["scale"]
    y0 = d["y0u"] * (bh - scale * h)
    x0 = d["x0u"] * (bw - scale * w)
    yy = torch.arange(h, dtype=torch.float32, device=bank.device)[None, :]
    xx = torch.arange(w, dtype=torch.float32, device=bank.device)[None, :]
    ys = torch.clamp((y0[:, None] + yy * scale[:, None]).to(torch.int64), 0, bh - 1)
    xs = torch.clamp((x0[:, None] + xx * scale[:, None]).to(torch.int64), 0, bw - 1)
    bg = bank[d["idx"][:, None, None], ys[:, :, None], xs[:, None, :]]
    if bg.dtype == torch.uint8:  # a u8 bank: the crop alone converts
        bg = bg.to(torch.float32) / 255.0
    bg = torch.where((d["flip_u"] < 0.5)[:, None, None, None], bg.flip(2), bg)
    return torch.clamp(bg * d["gain"], 0.0, 1.0)


def ellipse_draws(gen: torch.Generator, batch: int, hw, n: int, bank_hw) -> dict:
    """The draws of the two-ellipse batch over photos: the person, the
    crop, the foreground colour ``fg_color`` and texture ``fg_tex``, the
    sensor ``noise`` (a standard normal)."""
    img = (batch, *hw, 3)
    return {"person": person_draws(gen, batch, hw),
            "crop": crop_draws(gen, batch, n, bank_hw, hw),
            "fg_color": uniform(gen, (batch, 1, 1, 3), 0.25, 0.9),
            "fg_tex": uniform(gen, img, -0.15, 0.15),
            "noise": torch.randn(img, generator=gen, device=gen.device)}


def render_ellipse_batch(bank: torch.Tensor, d: dict, hw):
    """``(frames [B, H, W, 3], alpha [B, H, W])`` of :func:`ellipse_draws`:
    the textured person over the augmented photo crop, plus noise."""
    alpha = render_person_alpha(d["person"], hw)
    bg = crop_backgrounds(bank, d["crop"], hw)
    fg = d["fg_color"] + d["fg_tex"]
    frame = torch.clamp(fg * alpha[..., None] + bg * (1 - alpha[..., None]) + d["noise"] * 0.02,
                        0, 1)
    return frame, alpha


def articulated_draws(gen: torch.Generator, batch: int, n: int, bank_hw, hw) -> dict:
    """The draws of the articulated batch over photos: the ``crop``
    (:func:`crop_draws`), then the ``scene`` (train/person.py::
    scene_draws)."""
    return {"crop": crop_draws(gen, batch, n, bank_hw, hw),
            "scene": P.scene_draws(gen, batch, hw)}


def render_articulated(bank: torch.Tensor, d: dict, hw, return_parts: bool = False):
    """``(frames [B, H, W, 3], alpha [B, H, W])`` of
    :func:`articulated_draws`: the articulated person with face features
    and an occluder at probability 0.3 over the augmented photo crop; with
    ``return_parts`` the occluder-cut parts third."""
    bg = crop_backgrounds(bank, d["crop"], hw)
    out = P.render_scene(d["scene"], hw, bg, features=True, occluder_p=0.3,
                         return_parts=return_parts)
    return (out[0], out[1], out[3]) if return_parts else out[:2]


def make_real_bg_data_fn(bank: np.ndarray, device_bank: torch.Tensor | None = None,
                         person: str = "ellipse", return_parts: bool = False, device="cuda"):
    """``data_fn(generator, batch, hw)`` compositing procedural people over
    augmented crops of the photo bank (moved to ``device`` once, unless
    ``device_bank`` is given).  ``person='articulated'`` takes the
    articulated person (train/person.py, with face features and an
    occluder at probability 0.3), the train side of the clip harness's
    people; ``'ellipse'`` the two-ellipse person.  ``return_parts``
    (articulated only): the data_fn returns ``(frames, gt, parts)`` with
    the occluder-cut class-simplex parts."""
    if return_parts and person != "articulated":
        raise ValueError("return_parts requires person='articulated'")
    bank_t = torch.as_tensor(bank).to(device) if device_bank is None else device_bank
    n, bh, bw, _ = bank_t.shape

    if person == "articulated":
        def articulated_fn(gen, batch: int, hw):
            return render_articulated(bank_t, articulated_draws(gen, batch, n, (bh, bw), hw),
                                      hw, return_parts)

        return articulated_fn

    def data_fn(gen, batch: int, hw):
        return render_ellipse_batch(bank_t, ellipse_draws(gen, batch, hw, n, (bh, bw)), hw)

    return data_fn


def make_mixed_data_fn(real_fn, real_frac: float = 0.5):
    """``data_fn`` with ``real_frac`` of each batch from the photo bank's
    ``real_fn`` and the rest fully procedural (train/loop.py's batch): the
    standard fix for single-distribution training trading one eval for
    the other.  A batch of 1 cannot mix: it takes ``real_fn`` alone."""

    def data_fn(gen, batch: int, hw):
        if batch < 2:
            return real_fn(gen, batch, hw)
        b_real = max(1, min(batch - 1, int(round(batch * real_frac))))
        fr_r, a_r = real_fn(gen, b_real, hw)
        fr_s, a_s = synthetic_matting_batch(gen, batch - b_real, hw)
        return torch.cat([fr_r, fr_s], dim=0), torch.cat([a_r, a_s], dim=0)

    return data_fn
