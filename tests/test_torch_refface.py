"""``fast_int8_pico_refface`` (the pico trunk with the reference
application's MediaPipe face graphs at 256/192) and ``face_precision=
'int8'`` (the int8 FaceFinder and LandmarkNet), the port's Engine against
the JAX Engine at 80x160 / mask 32x64, S=2, 8 steps
(tests/test_torch_face_options.py's runner and tolerances); the swap
lifecycle of tests/test_onnx_port.py::test_engine_reference_face_swap_lifecycle
on the port's Engine; and every preset of the reference building a port
Engine on the CPU."""

import warnings

import numpy as np
import pytest

from tests import torch_natural_engines as NE
from tests.test_torch_face_options import assert_face_matches, assert_step_matches, run_s2d
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu.runtime.presets import _PRESETS as REFERENCE_PRESETS
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.blazeface import FaceFinder
from video_stream_segmenetation_tpu_torch.models.facemesh import LandmarkNet
from video_stream_segmenetation_tpu_torch.models.quantized_face import (
    QuantizedFaceFinder,
    QuantizedLandmarkNet,
)
from video_stream_segmenetation_tpu_torch.models.reference_face import (
    ReferenceFaceFinder,
    ReferenceLandmarkNet,
)
from video_stream_segmenetation_tpu_torch.runtime.config import PipelineStatics
from video_stream_segmenetation_tpu_torch.runtime.presets import list_presets, preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine

RUNS = {
    # (preset, overrides, geometry); the MediaPipe detector scores these
    # small rendered faces 0.27-0.46, under the preset's 0.6, and the
    # landmark graph scores them about 1e-3 (it takes them for no face, on
    # both sides), so the run lowers both thresholds to reach the landmark
    # graph's points and the affine
    "refface": ("fast_int8_pico_refface", {"face_score_thresh": 0.2, "lmk_score_thresh": 0.0},
                dict(frame_hw=(80, 160), mask_hw=(32, 64))),
    "pico_int8_face": ("fast_int8_pico", {"face_precision": "int8"}, None),
}


@pytest.fixture(scope="module", params=sorted(RUNS))
def engines(request):
    name, over, geom = RUNS[request.param]
    return (request.param, *run_s2d(over, name=name, geom=geom))


def test_face_outputs_match(engines):
    _, jouts, touts, _ = engines
    assert_face_matches(jouts, touts)


@pytest.mark.parametrize("step", range(NE.ENGINE_T))
def test_step_matches_teacher_forced(engines, step):
    _, jouts, _, forced = engines
    assert_step_matches(jouts[step], forced[step], 4e-3, 1e-4)


def test_refface_preset_serves_the_graphs():
    """The preset swaps the graphs in at build (the face stays float) and
    serves through the s2d int8 path."""
    st = preset("fast_int8_pico_refface", frame_hw=(80, 160), mask_hw=(32, 64),
                background="color")
    assert (st.fd_size, st.lmk_size, st.face_models) == (256, 192, "reference")
    eng = Engine(2, st, device="cpu")
    assert isinstance(eng.face_models.face, ReferenceFaceFinder)
    assert isinstance(eng.face_models.lmk, ReferenceLandmarkNet)
    eng.admit_all()
    frames = np.random.default_rng(0).integers(0, 255, (2, 80, 160, 3), dtype=np.uint8)
    for _ in range(2):
        out = eng.process(frames)
    assert out["metrics"]["health"]["state"] == "ok" and not out["passthrough"]
    assert tuple(out["alpha"].shape) == (2, 32, 64)


def test_engine_reference_face_swap_lifecycle():
    """use_reference_face_models checks the geometry (a mismatch raises and
    leaves the engine serving), swaps both graphs in and rebuilds the
    steps and the cached round steps; a later load_face_params reinstalls
    the fast FaceFinder, and the fast LandmarkNet with its tree only."""
    frame = np.random.default_rng(0).integers(0, 255, (1, 144, 256, 3)).astype(np.uint8)
    bad = Engine(1, PipelineStatics(frame_hw=(144, 256), mask_hw=(64, 128), fd_size=64,
                                    lmk_size=48), device="cpu")
    bad.admit()
    with pytest.raises(ValueError, match="fd_size=256"):
        bad.use_reference_face_models()
    assert isinstance(bad.face_models.face, FaceFinder)
    bad.process(frame)
    assert bad.health.state.name == "OK"

    eng = Engine(1, PipelineStatics(frame_hw=(144, 256), mask_hw=(64, 128), fd_size=256,
                                    lmk_size=192), device="cpu")
    eng.admit()
    eng._round_steps["cached"] = object()
    step = eng._step
    eng.use_reference_face_models()
    assert isinstance(eng.face_models.face, ReferenceFaceFinder)
    assert isinstance(eng.face_models.lmk, ReferenceLandmarkNet)
    assert eng._step is not step and "cached" not in eng._round_steps
    eng.process(frame)
    assert eng.health.state.name == "OK"

    fd = bridge.WEIGHTS_DIR / "facefinder.npz"
    lm = bridge.WEIGHTS_DIR / "landmarknet.npz"
    eng.load_face_params(fd)
    assert isinstance(eng.face_models.face, FaceFinder)
    assert isinstance(eng.face_models.lmk, ReferenceLandmarkNet)  # no lmk tree: it stays
    eng.process(frame)
    eng.load_face_params(fd, lm)
    assert isinstance(eng.face_models.lmk, LandmarkNet)
    eng.process(frame)
    assert eng.health.state.name == "OK" and eng.stats()["passthrough_steps"] == 0


def test_int8_face_precision_swaps_and_warns():
    """face_precision='int8' serves the quantized fast models, again after
    load_face_params; the MediaPipe graphs stay float under it, with a
    warning."""
    st = PipelineStatics(frame_hw=(144, 256), mask_hw=(64, 128), fd_size=256, lmk_size=192,
                         face_precision="int8")
    eng = Engine(1, st, device="cpu")
    assert isinstance(eng.face_models.face, QuantizedFaceFinder)
    assert isinstance(eng.face_models.lmk, QuantizedLandmarkNet)
    with pytest.warns(UserWarning, match="int8"):
        eng.use_reference_face_models()
    assert isinstance(eng.face_models.face, ReferenceFaceFinder)
    eng.load_face_params(bridge.WEIGHTS_DIR / "facefinder.npz",
                         bridge.WEIGHTS_DIR / "landmarknet.npz")
    assert isinstance(eng.face_models.face, QuantizedFaceFinder)
    assert isinstance(eng.face_models.lmk, QuantizedLandmarkNet)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Engine(1, preset("fast_int8_pico_refface", frame_hw=(80, 160), mask_hw=(32, 64)),
               device="cpu")
    with pytest.warns(UserWarning, match="int8"):
        Engine(1, preset("fast_int8_pico_refface", frame_hw=(80, 160), mask_hw=(32, 64),
                         face_precision="int8"), device="cpu")


def test_refface_needs_its_geometry():
    with pytest.raises(ValueError, match="lmk_size=192"):
        Engine(1, preset("fast_int8_pico_refface", frame_hw=(80, 160), mask_hw=(32, 64),
                         lmk_size=128), device="cpu")


# every preset of the reference, at a small geometry: the mask the
# preset's model needs (the K=4 pico head grid; u2's square)
_MASKS = {"multiclass_fast_pico": (8, 16), "u2": (320, 320)}


@pytest.mark.parametrize("name", sorted(REFERENCE_PRESETS))
def test_every_reference_preset_builds(name):
    assert name in list_presets()
    st = preset(name, frame_hw=(80, 160), mask_hw=_MASKS.get(name, (32, 64)))
    eng = Engine(1, st, device="cpu")
    assert (eng.face_models is None) == (not st.face_path)


def test_presets_are_the_reference_sixteen():
    assert sorted(REFERENCE_PRESETS) == list_presets() and len(list_presets()) == 16
