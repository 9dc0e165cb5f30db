"""Shared runner of the 720p engine comparisons that set chip_smoke.py's
bars for the float MatteNetHD and the s2d options
(tests/test_torch_s2d_options_720p.py, test_torch_float_hd_720p.py): the
JAX Engine and the port's, both as they serve (the reference takes its CPU
route, the unfused refine chain), the two committed 720p frames swapped
between S=2 streams each step, the wall-clock face gate off."""

import jax
import jax.numpy as jnp
import numpy as np

from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.service import Engine as JaxEngine
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine

S, STEPS = 2, 8


def iou(alpha, truth) -> float:
    pred = alpha > 0.5
    inter = (pred & truth).sum(axis=(1, 2))
    return float(np.mean(inter / np.maximum((pred | truth).sum(axis=(1, 2)), 1)))


def run(name: str, over: dict, jax_model, tree: dict, port_params: dict | None = None,
        jax_over: dict | None = None):
    """8 steps of preset ``name`` with ``over`` on both engines: the JAX one
    with ``jax_model`` over the float ``tree`` (quantized by it where the
    preset serves int8; ``jax_over`` added to its statics), the port's on
    ``port_params`` (by default ``tree``); both with the committed face
    models of the preset's geometry.  Returns ``[(reference outputs, port
    outputs, truth)]`` a step."""
    st = preset(name, **over)
    faces = bridge.face_weights(st)
    jt = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    bundle = ModelBundle(jax_model, jt(tree), jm.FaceFinder(input_size=st.fd_size),
                         jt(faces["face"]), jm.LandmarkNet(), jt(faces["lmk"]))
    je = JaxEngine(num_streams=S, statics=jax_preset(name, **over, **(jax_over or {})),
                   bundle=bundle, donate_state=False)
    te = Engine(S, st, params=tree if port_params is None else port_params,
                face_params=faces, device="cpu")
    frames, gt = bridge.load_frames()
    order = [np.arange(S) % 2, (np.arange(S) + 1) % 2]
    steps = []
    for t in range(STEPS):
        outs = []
        for e in (je, te):
            e.face_min_interval_s = 0.0
            if t == 0:
                e.admit_all()
            outs.append(e.process(frames[order[t % 2]]))
        steps.append((*outs, gt[order[t % 2]] > 127))
    assert te.stats()["passthrough_steps"] == 0
    return steps
