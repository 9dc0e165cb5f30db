"""The port's HTTP control endpoint (service/server.py): the cases of
tests/test_server.py on the port's Engine (active, 48x64 frames, a 32x64
mask, the face path off, on the CPU), and /healthz answering 503 while the
engine is DEGRADED.  Requests go to 127.0.0.1 through http.client (no
proxy is consulted)."""

import http.client
import json

import numpy as np
import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu_torch import background as bgm
from video_stream_segmenetation_tpu_torch.runtime.config import PipelineStatics
from video_stream_segmenetation_tpu_torch.service.engine import Engine
from video_stream_segmenetation_tpu_torch.service.server import ControlServer

FRAME_HW = (48, 64)
MASK_HW = (32, 64)


@pytest.fixture()
def served():
    statics = PipelineStatics(frame_hw=FRAME_HW, mask_hw=MASK_HW, fd_size=64, lmk_size=48,
                              background="image", face_path=False)
    eng = Engine(2, statics, device="cpu")
    data = bgm.sample_app_data()
    emp = data.employees["demo"]
    r = bgm.BackgroundRenderer(data.templates[emp.default_template_id], emp,
                               canvas_hw=FRAME_HW)
    srv = ControlServer(eng, renderers={0: r}).start()
    yield eng, srv
    srv.stop()


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _get(port, path):
    return _req(port, "GET", path)


def _post(port, path, body=None):
    return _req(port, "POST", path, body or {})


def _frames(rng):
    return (rng.random((2, *FRAME_HW, 3)) * 255).astype(np.uint8)


def test_stats_and_health(served):
    eng, srv = served
    code, body = _get(srv.port, "/stats")
    assert code == 200 and "fps" in body and "health" in body
    assert body["passthrough_steps"] == 0
    code, body = _get(srv.port, "/healthz")
    assert code == 200 and body["state"] == "ok"


def test_healthz_is_503_while_degraded(served, rng):
    eng, srv = served

    def broken(*args):
        raise RuntimeError("injected step failure")

    step, eng._step = eng._step, broken
    for _ in range(3):
        eng.process(_frames(rng))
    code, body = _get(srv.port, "/healthz")
    assert code == 503 and body == {"state": "degraded"}
    code, body = _get(srv.port, "/stats")
    assert body["health"]["state"] == "degraded" and body["passthrough_steps"] == 3
    eng._step = step
    eng.health._degraded_at = 0.0
    eng.process(_frames(rng))
    assert _get(srv.port, "/healthz") == (200, {"state": "ok"})


def test_admit_and_knobs_roundtrip(served, rng):
    eng, srv = served
    code, body = _post(srv.port, "/streams")
    assert code == 200
    slot = body["slot"]
    code, _ = _post(srv.port, f"/streams/{slot}/knobs", {"gamma": 1.9, "use_bilateral": False})
    assert code == 200
    eng.process(_frames(rng))
    assert float(eng.knobs.gamma[slot]) == pytest.approx(1.9)
    assert not bool(eng.knobs.use_bilateral[slot])
    code, _ = _post(srv.port, f"/streams/{slot}/reset")
    assert code == 200
    eng.process(_frames(rng))
    assert float(eng.knobs.gamma[slot]) == pytest.approx(0.4)


def test_unknown_knob_rejected(served):
    _, srv = served
    code, body = _post(srv.port, "/streams/0/knobs", {"EMA_WRONG": 1})
    assert code == 400 and "unknown knobs" in body["error"]


def test_privacy_updates_background(served):
    eng, srv = served
    before = eng.backgrounds[0].clone()
    code, body = _post(srv.port, "/streams/0/privacy", {"level": "high"})
    assert code == 200 and body["level"] == "high"
    assert not np.array_equal(before.numpy(), eng.backgrounds[0].numpy())
    code, _ = _post(srv.port, "/streams/1/privacy", {"level": "low"})
    assert code == 409
    code, body = _post(srv.port, "/streams/0/privacy", {"level": "top-secret"})
    assert code == 400 and "privacy" in body["error"]


def test_per_stream_stats(served, rng):
    eng, srv = served
    eng.process(_frames(rng))
    code, body = _get(srv.port, "/streams")
    assert code == 200
    assert body["capacity"] == 2 and len(body["streams"]) == 2
    assert body["streams"][0]["frames"] >= 1
    assert {"slot", "active", "frames", "face_affine"} <= set(body["streams"][0])
    assert body["streams"] == eng.stream_stats()


def test_404s_and_full_engine(served):
    eng, srv = served
    assert _get(srv.port, "/nope")[0] == 404
    assert _post(srv.port, "/streams/99/knobs", {"gamma": 1})[0] == 404
    assert _post(srv.port, "/streams/0/dance")[0] == 404
    eng.admit_all()
    code, body = _post(srv.port, "/streams")
    assert code == 409 and "full" in body["error"]


def test_evict(served):
    eng, srv = served
    eng.admit_all()
    assert _post(srv.port, "/streams/1/evict")[0] == 200
    assert not eng.active[1]
    assert _get(srv.port, "/streams")[1]["active"] == [0]


def test_background_endpoint(served):
    """Solid colour, template re-render, raw image rows."""
    eng, srv = served
    code, body = _post(srv.port, "/streams/0/background", {"color": [10, 200, 30]})
    assert code == 200 and body["ok"]
    assert (eng.backgrounds[0].numpy() == np.asarray([10, 200, 30], np.uint8)).all()
    tid = list(bgm.sample_app_data().templates)[1]
    before = eng.backgrounds[0].clone()
    code, body = _post(srv.port, "/streams/0/background", {"template_id": tid})
    assert code == 200 and body["ok"]
    assert not np.array_equal(before.numpy(), eng.backgrounds[0].numpy())
    assert _post(srv.port, "/streams/0/background", {"template_id": "nope"})[0] == 400
    rows = np.full((*FRAME_HW, 3), 77, np.uint8).tolist()
    code, _ = _post(srv.port, "/streams/1/background", {"image": rows})
    assert code == 200 and (eng.backgrounds[1].numpy() == 77).all()
    assert _post(srv.port, "/streams/1/background", {"pattern": 1})[0] == 400
