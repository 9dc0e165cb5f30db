"""Shared pieces of the photo-background trainers' parity tests
(tests/test_torch_realbg_*.py): the port's train/realbg.py against the
reference's tools/train_realbg.py, train_flagship_realbg.py,
finetune_active_realbg.py, finetune_u2_realbg.py and
finetune_variants_realbg.py, on a directory of photos the test writes.

The reference's trainers are closures inside the tools' functions: each
tool is run with its ``fit`` (or ``chunked_train``) replaced by one that
hands over what it was given (the data function, the loss, the warm tree),
its photo bank read from the test's directory, its checkpoint restore
returning the flax init (``like``), nothing saved, nothing written under
benchmarks/.  PRNGs differ, so the port renders the reference's own draws
(:func:`ref_mix_draws`: each part's draws from the key the reference's
closure hands that part).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests import torch_train_helpers as H  # (puts tools/ on the path)
from tests.torch_train_helpers import ref_occluder_draws
from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu import utils as jutils
from video_stream_segmenetation_tpu.train import face as JF
from video_stream_segmenetation_tpu.train import losses as JL
from video_stream_segmenetation_tpu.train import person as JP
from video_stream_segmenetation_tpu.train import realdata as JR
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet
from video_stream_segmenetation_tpu_torch.models.rvm import RecurrentMatteNet
from video_stream_segmenetation_tpu_torch.models.u2net import SaliencyNet
from video_stream_segmenetation_tpu_torch.train import losses as TL
from video_stream_segmenetation_tpu_torch.train import realbg as RB
from video_stream_segmenetation_tpu_torch.train import realdata as PR
from video_stream_segmenetation_tpu_torch.train import variants as PV
from video_stream_segmenetation_tpu_torch.train.face import render_face_batch
from video_stream_segmenetation_tpu_torch.train.loop import render_matting_batch

_cache_dir = jax.config.jax_compilation_cache_dir
import finetune_active_realbg as FA  # noqa: E402  (tools/)
import finetune_u2_realbg as FU  # noqa: E402
import finetune_variants_realbg as FV  # noqa: E402
import train_flagship_realbg as FF  # noqa: E402
import train_realbg as TR  # noqa: E402

# the tools point the compilation cache at their own machine's directory
jax.config.update("jax_compilation_cache_dir", _cache_dir)

T = torch.as_tensor


def write_photos(directory, n: int = 3, hw=(90, 160)) -> None:
    """``n`` seeded PNG photos (numpy noise with smooth gradients)."""
    g = np.random.default_rng(11)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    for i in range(n):
        base = (yy * (i + 1) + xx * (3 - i))[..., None] % 256
        img = (0.6 * base + 0.4 * g.integers(0, 256, (*hw, 3))).astype(np.uint8)
        Image.fromarray(img).save(directory / f"photo{i}.png")


def _t(d: dict) -> dict:
    return {k: T(np.array(v)) for k, v in d.items()}


def ref_synthetic_draws(key, batch: int, hw, face: bool = False) -> dict:
    """The draws of the reference's synthetic_matting_batch(key) (with
    ``face``: synthetic_face_batch's, which adds ``feat_strength``), by the
    port's names (``ks[10]`` drawn twice, as the reference does)."""
    h, w = hw
    ks = jax.random.split(key, 14 if face else 12)

    def u(k, shape, lo=0.0, hi=1.0):
        return jax.random.uniform(k, shape, minval=lo, maxval=hi)

    b1, b3, img = (batch, 1, 1), (batch, 1, 1, 3), (batch, h, w, 3)
    d = {"cx": u(ks[0], b1, 0.25 * w, 0.75 * w), "cy": u(ks[1], b1, 0.45 * h, 0.85 * h),
         "rx": u(ks[2], b1, 0.12 * w, 0.28 * w), "ry": u(ks[3], b1, 0.28 * h, 0.5 * h),
         "edge": u(ks[4], b1, 0.05, 0.2), "head_dy": u(ks[5], b1, 0.9, 1.2),
         "head_r": u(ks[6], b1, 0.35, 0.55), "fg_color": u(ks[7], b3, 0.25, 0.9),
         "fg_tex": u(ks[8], img, -0.15, 0.15), "bg_base": u(ks[9], b3, 0.0, 0.5),
         "bg_tex": u(ks[10], img), "bg_gain": u(ks[10], (batch, 1, 1, 1), 0.1, 0.4),
         "noise": jax.random.normal(ks[11], img)}
    if face:
        d["feat_strength"] = u(ks[12], b1, 0.45, 0.75)
    return _t(d)


def ref_articulated_draws(key, batch: int, n: int, bank_hw, hw) -> dict:
    """The draws of the reference's articulated data_fn over a bank of
    ``n`` photos (make_real_bg_data_fn(person='articulated')(key)): the
    crop from ``split(key, 7)[:6]``, the scene from the seventh."""
    ks = jax.random.split(key, 7)
    crop = {"idx": jax.random.randint(ks[0], (batch,), 0, n),
            "scale": jax.random.uniform(ks[1], (batch,), minval=1.0, maxval=bank_hw[0] / hw[0]),
            "y0u": jax.random.uniform(ks[2], (batch,)), "x0u": jax.random.uniform(ks[3], (batch,)),
            "flip_u": jax.random.uniform(ks[4], (batch,)),
            "gain": jax.random.uniform(ks[5], (batch, 1, 1, 3), minval=0.7, maxval=1.2)}
    k1, k2, k3, k4 = jax.random.split(ks[6], 4)
    scene = {"ident": _t(JP.sample_identity(k1, batch)), "pose": _t(JP.sample_pose(k2, batch, hw)),
             "occ": _t(ref_occluder_draws(k3, batch, hw)),
             "noise": T(np.array(jax.random.normal(k4, (batch, *hw, 3))))}
    return {"crop": _t(crop), "scene": scene}


def ref_mix_draws(key, plan: tuple, n: int, bank_hw, hw, render_hw) -> list:
    """The reference's draws of a mixed batch of ``plan``
    (train/realbg.py's THREE_WAY, TWO_WAY, CLASS_MIX) as realbg.mix_draws
    returns them: the parts' keys ``split(key, len(plan))``."""
    out = []
    for k, (kind, rows, rendered) in zip(jax.random.split(key, len(plan)), plan):
        at = render_hw if rendered else hw
        if kind == "real":
            d = ref_articulated_draws(k, rows, n, bank_hw, at)
        else:
            d = ref_synthetic_draws(k, rows, at, face=kind == "face")
        out.append((kind, rendered, d))
    return out


def run_tool(mp, tmp_path, tool: str, jdt=jnp.float32, **geom) -> list:
    """Run the reference's tool ``tool`` ('realbg', 'flagship', 'active',
    'u2', 'rvm' or 'multiclass_pico') at the test geometry ``geom`` with its
    models in ``jdt``, on the photos under ``tmp_path / "photos"`` -> the
    calls its trainer received: for fit ``(kwargs)``, for chunked_train
    ``{"loss_fn", "params", "steps", "lr"}``."""
    photos = str(tmp_path / "photos")
    (tmp_path / "benchmarks").mkdir(exist_ok=True)
    bank = functools.partial(JR.load_background_bank, directory=photos)
    calls = []

    def fake_fit(model, **kw):
        calls.append(kw)
        return kw.get("init_params"), [{"step": 0, "loss": 0.0}]

    def fake_chunked(name, params, loss_fn, steps, lr, chunk=50):
        calls.append({"loss_fn": loss_fn, "params": params, "steps": steps, "lr": lr})
        return params

    mp.setattr(jutils, "restore_params", lambda path, like=None: like)
    mp.setattr(jutils, "save_params", lambda path, tree: None)
    for name in ("MatteNet", "MatteNetHD", "SaliencyNet", "RecurrentMatteNet"):
        mp.setattr(jm, name, functools.partial(getattr(jm, name), dtype=jdt))
    if tool == "realbg":
        mp.setattr(TR, "load_background_bank", bank)
        mp.setattr(TR, "fit", fake_fit)
        mp.setattr(TR, "evaluate", lambda *a, **k: 0.0)
        mp.setattr(TR, "ROOT", str(tmp_path))
        mp.setattr(TR, "HW", geom["hw"])
        mp.setattr(TR, "BATCH", geom["batch"])
        TR.main(1)
    elif tool == "flagship":
        mp.setattr(FF, "load_background_bank", bank)
        mp.setattr(FF, "fit", fake_fit)
        mp.setattr(FF, "evaluate", lambda *a, **k: 0.0)
        mp.setattr(FF, "ROOT", str(tmp_path))
        mp.setattr(FF, "SERVE_HW", geom["hw"])
        mp.setattr(FF, "BATCH", geom["batch"])
        FF.main(1)
    elif tool == "active":
        mp.setattr(FA, "load_background_bank", bank)
        mp.setattr(FA, "fit", fake_fit)
        mp.setattr(FA, "HW", geom["hw"])
        mp.setattr(FA, "BATCH", geom["batch"])
        FA.main(1, render_hw=geom["render_hw"])
    elif tool == "u2":
        mp.setattr(FU, "load_background_bank", bank)
        mp.setattr(FU, "fit", fake_fit)
        mp.setattr(FU, "HW", geom["hw"])
        mp.setattr(FU, "BATCH", geom["batch"])
        FU.main(1, render_hw=geom["render_hw"])
    else:
        mp.setattr(FV, "load_background_bank", bank)
        mp.setattr(FV, "chunked_train", fake_chunked)
        if tool == "rvm":
            FV.finetune_rvm(1, hw=geom["hw"], batch=geom["batch"], unroll=geom["unroll"],
                            render_hw=geom["render_hw"])
        else:
            FV.finetune_multiclass_pico(1, hw=geom["hw"], batch=geom["batch"],
                                        small_hw=geom["small_hw"],
                                        small_batch=geom["small_batch"])
    return calls


def assert_step_close(ref: tuple, got: tuple, dtype: str, ref_f32: tuple | None = None) -> None:
    """One step's (loss, gradient leaves) of the port against the
    reference's: f32, the loss within 1e-5 relative and every leaf's
    gradient cosine at least 0.9999; bf16, tests/torch_train_helpers.py's
    rule (the loss within 1e-2 relative, a leaf's cosine at least
    ``min(0.99, 1 - 2 (1 - cos(reference bf16, reference f32)))``)."""
    if dtype == "bf16":
        H.assert_grads_close(ref, got, "bf16", ref_f32=ref_f32)
        return
    (jl, jg), (tl, tg) = ref, got
    assert tg.keys() == jg.keys()
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    for k, w in jg.items():
        cos = H.cosine(tg[k], w)
        assert cos >= 0.9999, (k, cos)


def job_steps(tmp, geoms: dict) -> dict:
    """``{(job, dtype): (reference, port)}``: one step's (loss, gradient
    leaves) on both sides for each job of ``geoms`` (its tool's geometry)."""
    (tmp / "photos").mkdir()
    write_photos(tmp / "photos")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for job, geom in geoms.items():
            batch = tree = None
            for dtype, (jdt, tdt) in H.DTYPES.items():
                calls = run_tool(mp, tmp, job, jdt, **geom)
                c = calls[-1] if job == "realbg" else calls[0]
                if job == "realbg":  # fit initialises the model itself
                    tree = tree or H.np_tree(jm.MatteNet(width=0.75).init(
                        jax.random.PRNGKey(0), jnp.zeros((1, *geom["hw"], 3))))
                else:
                    tree = H.np_tree(c["init_params"])
                if batch is None:
                    batch = tuple(np.array(x) for x in c["data_fn"](
                        jax.random.PRNGKey(7), geom["batch"], geom["hw"]))
                fr, gt = batch
                if job == "realbg":  # the reference's fit: its default matting loss
                    net = jm.MatteNet(width=0.75, dtype=jdt)
                    ref_loss = lambda p, f, g, net=net: JL.matting_loss(  # noqa: E731
                        net.apply(p, f, train=False), g, f)
                else:
                    ref_loss = c["loss_fn"]
                ref = H.ref_grads(lambda p: ref_loss(p, jnp.asarray(fr), jnp.asarray(gt)), tree)
                if job == "flagship":
                    model = MatteNetHD(10, 4, "pico", dtype=tdt, params=tree, device="cpu")
                else:
                    model = MatteNet(tree, device="cpu", dtype=tdt)
                if job == "realbg":
                    loss = lambda m=model: TL.matting_loss(  # noqa: E731
                        m(torch.as_tensor(fr)), torch.as_tensor(gt), torch.as_tensor(fr))
                else:
                    loss = lambda m=model: TL.make_pipeline_loss(m)(  # noqa: E731
                        torch.as_tensor(fr), torch.as_tensor(gt))
                out[job, dtype] = ref, H.port_grads(model, loss)
    return out


# ---- the variant jobs' steps (tests/test_torch_realbg_variants.py, _rvm.py)

KEY = jax.random.PRNGKey(8)


def _bank(tmp, hw):
    return torch.as_tensor(PR.load_background_bank(hw, tmp / "photos", oversample=2.0,
                                                   as_uint8=True))


def _sources(mp, tmp, job: str, g: dict):
    """Route the tool's data sources to the port's renders of the
    reference's draws of KEY -> ``(draws, bank)`` for
    realbg.render_mix."""
    b = g["batch"]
    if job == "rvm":
        plan, at, classes = RB.TWO_WAY(b), g["hw"], False
        bank = _bank(tmp, g["render_hw"])
    else:
        plan, at, classes = RB.CLASS_MIX(b), g["hw"], True
        bank = _bank(tmp, g["hw"])
    draws = ref_mix_draws(KEY, plan, len(bank), tuple(bank.shape[1:3]), at,
                          g.get("render_hw", at))
    parts = {}
    for kind, rendered, d in draws:
        hw = g["render_hw"] if rendered else at
        if kind == "real":
            parts[kind] = PR.render_articulated(bank, d, hw, return_parts=classes)
        elif kind == "face":
            parts[kind] = render_face_batch(d, hw, return_parts=True)
        else:
            parts[kind] = render_matting_batch(d, hw)

    def numpy(part):
        return tuple({k: v.numpy() for k, v in x.items()} if isinstance(x, dict) else x.numpy()
                     for x in part)

    mp.setattr(FV, "make_real_bg_data_fn",
               lambda *a, **k: lambda key, b, hw: numpy(parts["real"]))
    mp.setattr(FV, "synthetic_matting_batch", lambda key, b, hw: numpy(parts["synthetic"]))
    if "face" in parts:
        mp.setattr(JF, "synthetic_face_batch",
                   lambda key, b, hw, return_parts=False: numpy(parts["face"]))
    return draws, bank


def variant_steps(tmp, geoms: dict) -> dict:
    """``{(job, dtype): (reference, port)}`` for the variant jobs of
    ``geoms`` (u2, rvm, multiclass_pico at their tools' test geometry)."""
    (tmp / "photos").mkdir()
    write_photos(tmp / "photos")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for job, g in geoms.items():
            for dtype, (jdt, tdt) in H.DTYPES.items():
                if job == "u2":
                    calls = run_tool(mp, tmp, job, jdt, **g)
                    c = calls[0]
                    tree = H.np_tree(c["init_params"])
                    if dtype == "f32":
                        fr, gt = (np.array(x)
                                  for x in c["data_fn"](KEY, g["batch"], g["hw"]))
                    ref = H.ref_grads(lambda p: c["loss_fn"](p, jnp.asarray(fr), jnp.asarray(gt)),
                                      tree)
                    model = SaliencyNet(tree, device="cpu", dtype=tdt)
                    port = functools.partial(RB.u2_loss_fn(model), torch.as_tensor(fr),
                                             torch.as_tensor(gt))
                else:
                    draws, bank = _sources(mp, tmp, job, g)
                    calls = run_tool(mp, tmp, job, jdt, **g)
                    # the K-class job's phase at the test's training geometry
                    c = calls[1] if job == "multiclass_pico" else calls[0]
                    tree = H.np_tree(c["params"])
                    ref = H.ref_grads(lambda p: c["loss_fn"](p, KEY), tree)
                    hw = g["hw"]
                    frames, gt = RB.render_mix(bank, draws, hw, g.get("render_hw", hw),
                                               classes=job != "rvm")
                    if job == "rvm":
                        model = RecurrentMatteNet(tree, device="cpu", dtype=tdt)
                        shift = torch.as_tensor(np.array(
                            jax.random.randint(KEY, (), -12, 13)))
                        port = functools.partial(PV.rvm_loss, model, frames, gt, shift,
                                                 g["unroll"])
                    else:
                        model = MatteNetHD(10, 4, "pico", dtype=tdt, params=tree, device="cpu")
                        port = functools.partial(
                            lambda m, f, t: PV.class_loss(m(f)["alpha"], t), model, frames, gt)
                out[job, dtype] = ref, H.port_grads(model, port)
    return out
