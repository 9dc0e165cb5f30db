"""The port's background generator (background/) against the reference's:
the schema, the sample data and the PIL renderer, pixel for pixel (the
same PIL and fonts in the same process), for every template, privacy
level and a few canvas sizes, with uploaded images and live edits."""

import dataclasses
import json

import numpy as np
import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import background as jbg
from video_stream_segmenetation_tpu_torch import background as tbg
from video_stream_segmenetation_tpu_torch.background import data as tdata

LEVELS = ("low", "medium", "high")
TEMPLATES = ("badge_left", "minimal_center")


def _pair(template, employee, **kw):
    jd, td = jbg.sample_app_data(), tbg.sample_app_data()
    return (jbg.BackgroundRenderer(jd.templates[template], jd.employees[employee], **kw),
            tbg.BackgroundRenderer(td.templates[template], td.employees[employee], **kw))


def test_sample_data_and_schema_match_the_reference():
    jd, td = jbg.sample_app_data(), tbg.sample_app_data()
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    assert tbg.PRIVACY_RANK == jbg.PRIVACY_RANK
    raw = {"templates": {"t": {"layers": [{
        "type": "text", "privacy": "high", "content": "email", "x": 1, "y": 2,
        "lineHeight": 55, "shadow": {"color": "#111", "blur": 3, "offsetX": 1, "offsetY": -1}}]}},
        "employees": {"e": {"full_name": "A B", "unknown_field": "x"}}}
    got = tbg.AppData.from_json(json.dumps(raw))
    assert dataclasses.asdict(got) == dataclasses.asdict(jbg.AppData.from_json(json.dumps(raw)))
    assert got.templates["t"].layers[0].line_height == 55
    assert got.templates["t"].layers[0].shadow.offset_y == -1
    assert tdata.SAMPLE_DATA == jbg.data.SAMPLE_DATA


def test_text_for_layer_matches_the_reference():
    jd, td = jbg.sample_app_data(), tbg.sample_app_data()
    for name in TEMPLATES:
        for jl, tl in zip(jd.templates[name].layers, td.templates[name].layers):
            for emp in td.employees:
                assert tbg.text_for_layer(tl, td.employees[emp]) == \
                    jbg.text_for_layer(jl, jd.employees[emp])


@pytest.mark.parametrize("template", TEMPLATES)
@pytest.mark.parametrize("privacy", LEVELS)
@pytest.mark.parametrize("hw", [(270, 480), (135, 240), (80, 160)])
def test_render_matches_the_reference(template, privacy, hw):
    j, t = _pair(template, "demo", privacy=privacy, canvas_hw=hw)
    got = t.render()
    assert got.shape == (*hw, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, j.render())
    assert t.render() is got  # cached until the next change


def test_uploads_and_edits_match_the_reference():
    j, t = _pair("badge_left", "demo2", canvas_hw=(135, 240))
    grad = (np.mgrid[0:64, 0:64][0] * 4).astype(np.uint8)
    qr = np.random.default_rng(0).integers(0, 255, (32, 32, 3), dtype=np.uint8)
    for r in (j, t):
        r.set_image("background", np.stack([grad, grad // 2, grad // 3], axis=-1))
        r.set_image("qr_code", qr)
        r.set_image("company_logo", qr[:16])
    np.testing.assert_array_equal(t.render(), j.render())
    before = t.render()
    for r in (j, t):
        r.set_employee_field("full_name", "Different Name")
        r.set_privacy("high")
    assert not np.array_equal(before, t.render())
    np.testing.assert_array_equal(t.render(), j.render())
    for r in (j, t):
        r.set_template(tbg.sample_app_data().templates["minimal_center"])
    np.testing.assert_array_equal(t.render(), j.render())


def test_privacy_gating_and_validation():
    def painted(privacy):
        _, t = _pair("badge_left", "demo", privacy=privacy, canvas_hw=(270, 480))
        return (t.render().sum(-1) > 0).sum()

    assert painted("low") < painted("medium") <= painted("high")
    _, t = _pair("minimal_center", "demo")
    with pytest.raises(ValueError, match="privacy"):
        t.set_privacy("top-secret")
