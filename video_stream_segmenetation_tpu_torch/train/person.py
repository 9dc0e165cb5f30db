"""Articulated procedural people, rendered on the device (port of
``train/person.py``).

The one source of person geometry for the photo-background training
batches (train/realdata.py, ``person='articulated'``) and the clip
harness's people (utils/clips.py::articulated_clip), so that the train and
eval foreground distributions match:

* a capsule and ellipse skeleton: head, neck, shoulder bar, torso, two
  two-segment arms with hands, leaning as a whole;
* hair with a band-limited radial fringe (stray-strand edges);
* clothing with a stripe or check pattern distinct from the skin;
* optionally an occluder in front (a desk strip or a held blob), cut out
  of the ground-truth alpha;
* facial features at the head-relative template positions the face
  models train on (train/face.py).

As the reference's, each random part is split from its render: the draws
(:func:`sample_identity`, :func:`sample_pose`, :func:`occluder_draws`, on a
``torch.Generator``) and the renders of given draws (:func:`render`,
:func:`render_occluder`, :func:`render_scene`), so that a test can render
the reference's own draws.
"""

from __future__ import annotations

import torch

from video_stream_segmenetation_tpu_torch.train.loop import grid, uniform


def _capsule(xx, yy, ax, ay, bx, by, r):
    """Signed distance to a capsule (a segment and a radius), batched."""
    px, py = xx - ax, yy - ay
    vx, vy = bx - ax, by - ay
    t = torch.clamp((px * vx + py * vy) / (vx * vx + vy * vy + 1e-6), 0.0, 1.0)
    dx, dy = px - t * vx, py - t * vy
    return torch.sqrt(dx * dx + dy * dy + 1e-12) - r


def _soft(d, edge):
    """Signed distance -> soft alpha (1 inside, 0 outside, an ``edge`` px
    transition)."""
    return torch.clamp(0.5 - d / torch.clamp(edge, min=1e-3), 0.0, 1.0)


def sample_identity(gen: torch.Generator, batch: int) -> dict:
    """Static per-person draws: proportions, colours, hair, clothing (the
    reference's ranges)."""
    b1, b3 = (batch, 1, 1), (batch, 1, 1, 3)

    def u(lo, hi, shape=b1):
        return uniform(gen, shape, lo, hi)

    # band-limited hair fringe: 4 sinusoids of integer angular frequencies
    ffreq = torch.randint(7, 41, (batch, 4), generator=gen, device=gen.device).to(torch.float32)
    famp = u(0.2, 1.0, (batch, 4))
    fphase = u(0.0, 6.283, (batch, 4))
    skin_base = torch.stack([u(0.45, 0.85)[..., 0], u(0.32, 0.62)[..., 0],
                             u(0.25, 0.52)[..., 0]], dim=-1)  # [B, 1, 3]
    skin_rgb = torch.sort(skin_base, dim=-1, descending=True).values  # r > g > b
    return {
        "hr_x": u(0.26, 0.34), "hr_y": u(0.34, 0.44),  # head radii, units of s
        "hair_vol": u(1.04, 1.30),  # hair ellipse inflation
        "hairline": u(-0.55, -0.10),  # v (head units) above which hair
        "fringe_amp": u(0.02, 0.12),
        "ffreq": ffreq, "famp": famp, "fphase": fphase,
        "edge_rel": u(0.010, 0.030),  # matte edge, units of s
        "skin_rgb": skin_rgb[:, None],
        "shirt_rgb": u(0.08, 0.95, b3),
        "hair_rgb": u(0.03, 0.45, b3) * torch.tensor([1.0, 0.8, 0.7], device=gen.device),
        "pat_f": u(2.0, 14.0, (batch, 1, 1, 2)),  # stripe frequencies
        "pat_amp": u(0.0, 0.22),
        "pat_phase": u(0.0, 6.283, (batch, 1, 1, 2)),
        "feat_strength": u(0.45, 0.75),
    }


def sample_pose(gen: torch.Generator, batch: int, hw) -> dict:
    """A random single-frame pose (training; the clips move the same
    fields smoothly).  Each arm hangs (up to 0.55 rad) or, with
    probability 0.25, is raised (1.1-2.5 rad), so that the clips' waves
    lie inside the training distribution."""
    h, w = hw

    def u(lo, hi):
        return uniform(gen, (batch, 1, 1), lo, hi)

    def arm_u():
        raised = uniform(gen, (batch, 1, 1)) < 0.25
        return torch.where(raised, u(1.1, 2.5), u(0.0, 0.55))

    return {
        "cx": u(0.30 * w, 0.70 * w),
        "cy_s": u(0.38 * h, 0.62 * h),  # the shoulder line
        "s": u(0.13 * w, 0.26 * w),  # shoulder half-width px
        "lean": u(-0.16, 0.16),  # rad
        "head_dx": u(-0.18, 0.18),  # units of s
        "head_bob": u(-0.08, 0.08),
        # arm angles from straight down, outward positive
        "armL_u": arm_u(), "armL_d": u(-0.15, 0.95),  # forearm delta (inward)
        "armR_u": arm_u(), "armR_d": u(-0.15, 0.95),
    }


def render(ident: dict, pose: dict, hw, features: bool = False,
           return_parts: bool = False) -> dict:
    """Render the batch on the draws' device: ``{"alpha" [B, H, W], "rgb"
    [B, H, W, 3] (valid where alpha > 0), "head_box" [B, 4] px}``, the
    ground truth before any occluder.  ``return_parts`` adds ``"parts"``:
    ``a_body`` (the whole person's alpha), ``a_head`` (head and visible
    hair) and ``feat`` (the darkened features, zeros without
    ``features``), the multi-class trainers' class-simplex inputs."""
    yy0, xx0 = grid(hw, pose["s"].device)
    s = pose["s"]
    cx, cy = pose["cx"], pose["cy_s"]
    # lean: rotate the person frame about the shoulder centre
    cl, sl = torch.cos(pose["lean"]), torch.sin(pose["lean"])
    xr = cl * (xx0 - cx) + sl * (yy0 - cy)
    yr = -sl * (xx0 - cx) + cl * (yy0 - cy)
    u_, v_ = xr / s, yr / s  # person space, units of s
    edge = torch.clamp(ident["edge_rel"] * s, min=1.0)
    one = torch.ones_like(s)

    def cap(ax, ay, bx, by, r):
        return _soft(_capsule(u_, v_, ax, ay, bx, by, r) * s, edge)

    z = torch.zeros_like(s)
    # shirt: shoulders, torso, arms
    a_shoulder = cap(-0.74 * one, 0.02 * one, 0.74 * one, 0.02 * one, 0.32 * one)
    a_torso = cap(z, 0.25 * one, z, 2.6 * one, 0.88 * one)
    arms, hands = [], []
    for side, au_k, ad_k in ((-1.0, "armL_u", "armL_d"), (1.0, "armR_u", "armR_d")):
        sx, sy = side * 0.72 * one, 0.08 * one
        au = pose[au_k] * side  # outward positive -> signed angle
        ex = sx + 0.95 * torch.sin(au)
        ey = sy + 0.95 * torch.cos(au)
        ad = au - side * pose[ad_k]
        wx = ex + 0.85 * torch.sin(ad)
        wy = ey + 0.85 * torch.cos(ad)
        arms.append(cap(sx, sy, ex, ey, 0.165 * one))
        arms.append(cap(ex, ey, wx, wy, 0.135 * one))
        hands.append(cap(wx, wy, wx, wy + 0.12, 0.15 * one))
    a_shirt = torch.maximum(torch.maximum(a_shoulder, a_torso),
                            torch.maximum(torch.maximum(arms[0], arms[1]),
                                          torch.maximum(arms[2], arms[3])))

    # skin: neck, head, hands
    a_neck = cap(z, 0.10 * one, z, -0.52 * one, 0.19 * one)
    hrx, hry = ident["hr_x"], ident["hr_y"]
    hcx = pose["head_dx"]
    hcy = -0.50 - hry + pose["head_bob"]
    d_head = torch.sqrt(((u_ - hcx) / hrx) ** 2 + ((v_ - hcy) / hry) ** 2)
    r_head = 0.5 * (hrx + hry) * s  # the normalized distance in px by the mean radius
    a_head = _soft((d_head - 1.0) * r_head, edge)
    a_skin = torch.maximum(torch.maximum(a_neck, a_head), torch.maximum(hands[0], hands[1]))

    # hair: the inflated head ellipse with a band-limited radial fringe
    hx = (u_ - hcx) / (hrx * ident["hair_vol"])
    hy = (v_ - (hcy - 0.10)) / (hry * ident["hair_vol"])
    d_hair = torch.sqrt(hx * hx + hy * hy + 1e-12)
    theta = torch.atan2(hy, hx)
    fr = torch.zeros_like(d_hair)
    for k in range(4):
        fr = fr + ident["famp"][:, k, None, None] * torch.sin(
            ident["ffreq"][:, k, None, None] * theta + ident["fphase"][:, k, None, None])
    fr = fr * ident["fringe_amp"] / 2.0
    a_hair_full = _soft((d_hair - 1.0 + fr) * r_head, 0.6 * edge)
    # visible hair: above the (noisy) hairline, or outside the face
    vv = (v_ - hcy) / hry
    hairline = ident["hairline"] + 0.35 * fr
    above = _soft((vv - hairline) * hry * s, 2.0 * edge)
    outside_face = _soft((1.0 - 0.06 - d_head) * r_head, edge)
    a_hair = a_hair_full * torch.maximum(1.0 - above, 1.0 - outside_face)

    alpha = torch.maximum(torch.maximum(a_shirt, a_skin), a_hair)

    # colours
    pat = (0.5 * torch.sin(ident["pat_f"][..., 0:1] * u_[..., None] * 2.0
                           + ident["pat_phase"][..., 0:1])
           + 0.5 * torch.sin(ident["pat_f"][..., 1:2] * v_[..., None] * 2.0
                             + ident["pat_phase"][..., 1:2]))
    shirt = torch.clamp(ident["shirt_rgb"] * (1.0 + ident["pat_amp"][..., None] * pat), 0.0, 1.0)
    skin = ident["skin_rgb"] * torch.ones_like(shirt)
    if features:
        # dark ellipses at train/face.py's head-template positions
        def feat(fu, fv, ru, rv):
            d = torch.sqrt(((u_ - (hcx + fu * hrx)) / (ru * hrx)) ** 2
                           + ((v_ - (hcy + fv * hry)) / (rv * hrx)) ** 2)
            return torch.clamp(1.2 - d, 0.0, 1.0)

        dark = torch.clamp(feat(-0.42, -0.22, 0.16, 0.10) + feat(0.42, -0.22, 0.16, 0.10)
                           + feat(0.0, 0.47, 0.34, 0.12) + 0.6 * feat(0.0, 0.12, 0.09, 0.14),
                           0.0, 1.0)
        skin = skin * (1.0 - (dark * ident["feat_strength"])[..., None])
    else:
        dark = torch.zeros_like(a_head)
    rgb = shirt * (1.0 - a_skin[..., None]) + skin * a_skin[..., None]
    rgb = (rgb * (1.0 - a_hair[..., None])
           + ident["hair_rgb"] * torch.ones_like(rgb) * a_hair[..., None])

    # the head ellipse's box in px: the head centre mapped back through
    # the lean's rotation, the rotated ellipse's envelope as half-extents
    _cl, _sl = cl[..., 0], sl[..., 0]
    _hcx, _hcy = hcx[..., 0], hcy[..., 0]
    _hrx, _hry = hrx[..., 0], hry[..., 0]
    hx_px = cx[..., 0] + s[..., 0] * (_cl * _hcx - _sl * _hcy)
    hy_px = cy[..., 0] + s[..., 0] * (_sl * _hcx + _cl * _hcy)
    hw_px = s[..., 0] * torch.sqrt((_hrx * _cl) ** 2 + (_hry * _sl) ** 2)
    hh_px = s[..., 0] * torch.sqrt((_hrx * _sl) ** 2 + (_hry * _cl) ** 2)
    head_box = torch.cat([hx_px - hw_px, hy_px - hh_px, hx_px + hw_px, hy_px + hh_px], dim=-1)
    out = {"alpha": alpha, "rgb": rgb, "head_box": head_box}
    if return_parts:
        # 'feat' is the raw feature intensity: the class simplex multiplies
        # it by a_head itself
        out["parts"] = {"a_body": alpha, "a_head": torch.maximum(a_head, a_hair), "feat": dark}
    return out


def occluder_draws(gen: torch.Generator, batch: int, hw) -> dict:
    """An occluder's draws: ``present_u`` and ``kind_u`` (present where
    below the render's ``p``; a desk strip where below 0.5, else a blob),
    the desk edge (``y0``, ``slope``), the blob (``bx``, ``by``, ``brx``,
    ``bry``), its colour ``base`` and texture phase ``tex_phase``."""
    h, w = hw
    b1 = (batch, 1, 1)

    def u(lo, hi, shape=b1):
        return uniform(gen, shape, lo, hi)

    return {"present_u": u(0.0, 1.0), "kind_u": u(0.0, 1.0),
            "y0": u(0.80 * h, 0.97 * h), "slope": u(-0.06, 0.06),
            "bx": u(0.2 * w, 0.8 * w), "by": u(0.62 * h, 0.95 * h),
            "brx": u(0.04 * w, 0.13 * w), "bry": u(0.05 * h, 0.16 * h),
            "base": u(0.05, 0.9, (batch, 1, 1, 3)), "tex_phase": u(0.0, 6.283, (batch, 1, 1, 1))}


def render_occluder(d: dict, hw, p: float = 0.35, shift=None) -> dict:
    """An occluder in front of the person from :func:`occluder_draws`,
    present with probability ``p``: ``{"alpha" [B, H, W], "rgb" [B, H, W,
    3]}``; the ground truth must be cut by it.  ``shift`` = (dy, dx) px
    pans it with the scene (the clips' camera shake)."""
    h, w = hw
    yy, xx = grid(hw, d["y0"].device)
    if shift is not None:
        yy = yy - shift[0]
        xx = xx - shift[1]
    present = (d["present_u"] < p).to(torch.float32)
    kind_desk = (d["kind_u"] < 0.5).to(torch.float32)
    d_desk = (d["y0"] + d["slope"] * (xx - 0.5 * w)) - yy
    a_desk = torch.clamp(0.5 - d_desk / 1.5, 0.0, 1.0)
    brx, bry = d["brx"], d["bry"]
    d_blob = torch.sqrt(((xx - d["bx"]) / brx) ** 2 + ((yy - d["by"]) / bry) ** 2)
    a_blob = torch.clamp((1.0 - d_blob) * 0.5 * (brx + bry) / 1.5, 0.0, 1.0)
    alpha = present * (kind_desk * a_desk + (1.0 - kind_desk) * a_blob)
    tex = 0.06 * torch.sin(xx[..., None] * 0.21 + yy[..., None] * 0.07 + d["tex_phase"])
    return {"alpha": alpha, "rgb": torch.clamp(d["base"] + tex, 0.0, 1.0)}


def sample_occluder(gen: torch.Generator, batch: int, hw, p: float = 0.35,
                    shift=None) -> dict:
    """:func:`render_occluder` of fresh draws."""
    return render_occluder(occluder_draws(gen, batch, hw), hw, p, shift)


def scene_draws(gen: torch.Generator, batch: int, hw) -> dict:
    """The draws of :func:`person_scene`: ``ident``, ``pose``, ``occ`` and
    the sensor ``noise`` ``[B, H, W, 3]`` (a standard normal)."""
    return {"ident": sample_identity(gen, batch), "pose": sample_pose(gen, batch, hw),
            "occ": occluder_draws(gen, batch, hw),
            "noise": torch.randn((batch, *hw, 3), generator=gen, device=gen.device)}


def render_scene(d: dict, hw, bg: torch.Tensor, features: bool = False,
                 occluder_p: float = 0.35, return_parts: bool = False):
    """A person (and an occluder) of :func:`scene_draws` over ``bg [B, H,
    W, 3]`` in [0, 1] -> ``(frame [B, H, W, 3], gt_alpha [B, H, W],
    head_box [B, 4])`` with sensor noise; with ``return_parts`` a fourth
    element, the parts cut by the occluder (occluded pixels fall to the
    background, as the alpha's ground truth)."""
    r = render(d["ident"], d["pose"], hw, features=features, return_parts=return_parts)
    occ = render_occluder(d["occ"], hw, p=occluder_p)
    a = r["alpha"][..., None]
    frame = r["rgb"] * a + bg * (1.0 - a)
    oa = occ["alpha"][..., None]
    frame = occ["rgb"] * oa + frame * (1.0 - oa)
    gt = r["alpha"] * (1.0 - occ["alpha"])
    frame = torch.clamp(frame + d["noise"] * 0.016, 0.0, 1.0)
    if return_parts:
        cut = 1.0 - occ["alpha"]
        return frame, gt, r["head_box"], {k: v * cut for k, v in r["parts"].items()}
    return frame, gt, r["head_box"]


def person_scene(gen: torch.Generator, batch: int, hw, bg: torch.Tensor,
                 features: bool = False, occluder_p: float = 0.35, return_parts: bool = False):
    """:func:`render_scene` of fresh draws on ``gen``'s device."""
    return render_scene(scene_draws(gen, batch, hw), hw, bg, features, occluder_p, return_parts)
