"""Shared runners of the engine comparisons of the float MatteNetHD and the
upsample and warp options (tests/test_torch_s2d_options.py,
test_torch_s2d_int8_options.py, test_torch_multiclass_plans.py): the JAX
Engine and the port's over the same 8 steps of
tests/test_torch_face_options.py::drive (its frames and backgrounds,
stream 0 evicted and re-admitted at step 3).  :func:`run_engines`: the face
path off, the matting model's seeded tree handed to both;
:func:`run_pico`: fast_int8_pico's trained weights, face path on, and a
teacher-forced port run besides.  The JAX side gets a ``ModelBundle`` (no
flax init) and ``use_fused_refine=True``, so that its refine kernels run
in Pallas interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np

from tests import torch_natural_engines as NE
from tests.test_torch_face_options import (
    FACE_CKPTS,
    PICO_CKPT,
    S2D_GEOM,
    _np,
    drive,
    forced_run,
)
from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.service import Engine as JaxEngine
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine

GEOM = dict(frame_hw=(80, 160), mask_hw=(32, 64), face_path=False)


def run_engines(name: str, over: dict, jax_model, tree: dict, port_params=None):
    """``(jouts, touts)``: the JAX Engine of preset ``name`` with ``over``
    and ``jax_model`` over the float ``tree`` (quantized by the reference's
    Engine where the preset serves int8), and the port's Engine on
    ``port_params`` (by default the same tree), each driven by ``drive``."""
    over = {**GEOM, **over}
    jst = jax_preset(name, use_fused_refine=True, **over)
    bundle = ModelBundle(jax_model, jax.tree_util.tree_map(jnp.asarray, tree))
    je = JaxEngine(num_streams=2, statics=jst, bundle=bundle, donate_state=False)
    frames = NE.engine_frames()
    rng = np.random.default_rng(3)
    bgs = [rng.integers(0, 256, (80, 160, 3), dtype=np.uint8) for _ in range(2)]
    jouts = drive(je, frames, bgs)
    if port_params is None:
        port_params = tree
    elif callable(port_params):
        port_params = port_params(je)
    touts = drive(Engine(2, preset(name, **over), params=port_params, device="cpu"), frames,
                  bgs)
    return jouts, touts


def gaps(jouts, touts, key="alpha"):
    """Per step: the largest gap of ``key``, of the new state's prev_alpha,
    and the composited frames' largest gap and share of values apart."""
    out = []
    for j, g in zip(jouts, touts):
        a = np.abs(g[key].float().numpy() - np.asarray(j[key], np.float32))
        p = np.abs(g["state"]["prev_alpha"] - j["state"]["prev_alpha"])
        f = np.abs(g["frame"].numpy().astype(np.int32) - np.asarray(j["frame"]).astype(np.int32))
        out.append((a.max(), p.max(), f.max(), (f > 0).mean()))
    return out


def run_pico(over: dict):
    """``(jouts, touts, forced)``: tests/test_torch_face_options.py::run_s2d
    for fast_int8_pico with ``over``, the JAX side with
    ``debug_face_outputs=True`` as well, so that its plane prior (the exact
    warp's route) is exported for the teacher-forced run."""
    restored = {c: restore_params(c) for c in (PICO_CKPT, *FACE_CKPTS)}
    jst = jax_preset("fast_int8_pico", use_fused_refine=True, int8_decoder_impl="trunk",
                     debug_face_outputs=True, **over, **S2D_GEOM)
    bundle = ModelBundle(jm.MatteNetHD(stem_stride=10, head_upsample=4, decoder="pico"),
                         restored[PICO_CKPT], jm.FaceFinder(input_size=jst.fd_size),
                         restored[FACE_CKPTS[0]], jm.LandmarkNet(), restored[FACE_CKPTS[1]])
    je = JaxEngine(num_streams=2, statics=jst, bundle=bundle, donate_state=False)
    frames = NE.engine_frames()
    rng = np.random.default_rng(3)
    bgs = [rng.integers(0, 256, (80, 160, 3), dtype=np.uint8) for _ in range(2)]
    jouts = drive(je, frames, bgs)
    st = preset("fast_int8_pico", **over, **S2D_GEOM)
    kw = dict(params=bridge.load_quantized(_np(je.bundle.matte_params)),
              face_params={"face": bridge.float_tree(_np(restored[FACE_CKPTS[0]])),
                           "lmk": bridge.float_tree(_np(restored[FACE_CKPTS[1]]))},
              device="cpu")
    touts = drive(Engine(2, st, **kw), frames, bgs)
    return jouts, touts, forced_run(Engine(2, st, **kw), st, jouts, frames, bgs)
