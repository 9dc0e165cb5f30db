"""The float MatteNetHD's serving routes and the natural layout's upsample
methods, the port's Engine against the JAX Engine on the CPU: 8 steps at
80x160 (mask 32x64), S=2, the face path off, seeded trees handed to both
(tests/torch_s2d_engines.py):

* ``matting_precision='bf16'`` over packed frames at plans A (``fast``
  with ``frame_layout='s2d'``, block 5), B, C and D (``fast_int8``,
  ``fast_int8_lite``, ``fast_int8_micro`` at block 10): the float alpha
  into the fused temporal refine with the planar u8 guide;
* the natural layout's native input at ``s2d_block=10`` (plan B over the
  natural frames);
* ``active`` with ``upsample_method='asymmetric'`` through the composite
  kernel's plain version, and with ``'align_corners'`` through the plain
  composite.

Also the weight bridge's answers for these forms.  The int8 pico routes
(exact warp, exact upsample, bilinear guide, asymmetric taps on s2d):
tests/test_torch_s2d_int8_options.py.

Tolerances, with their reasons (free-running: no face decision to
teacher-force):
* the refined alpha within 5e-3 and new_prev within 1e-3 at every step
  (tests/test_torch_active.py's natural bars: bf16 layers rounded apart by
  PyTorch and XLA, about 1e-3 in the model's alpha);
* the frame within one u8 step at under 1 % of the values: the packed
  composite's bf16 products (as tests/test_torch_ops.py), the composite
  kernel's rows (tests/test_torch_composite.py); the natural routes take
  ``upsample_precision='exact'``, f32 products on both sides (with 'fast'
  the port's bf16 pass departs from the CPU reference's f32 one, which
  tests/test_torch_active.py holds apart).
"""

import numpy as np
import pytest

from tests import torch_s2d_engines as SE
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD, init_params
from video_stream_segmenetation_tpu_torch.models.modnet import init_mattenet_params
from video_stream_segmenetation_tpu_torch.runtime.pipeline import fast_routing
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine

# route: (preset, overrides, (decoder, stem stride, head upsample) or None
# for the MatteNet)
ROUTES = {
    "s2d_plan_a": ("fast", {"frame_layout": "s2d"}, ("full", 5, 2)),
    "s2d_plan_b": ("fast_int8", {"matting_precision": "bf16"}, ("full", 10, 4)),
    "s2d_plan_c": ("fast_int8_lite", {"matting_precision": "bf16"}, ("light", 10, 4)),
    "s2d_plan_d": ("fast_int8_micro", {"matting_precision": "bf16"}, ("micro", 10, 4)),
    "natural_plan_b": ("fast", {"s2d_block": 10, "upsample_precision": "exact"},
                       ("full", 10, 4)),
    "active_asymmetric_kernel": ("active", {"upsample_method": "asymmetric",
                                            "use_fused_composite": True}, None),
    "active_align_corners": ("active", {"upsample_method": "align_corners",
                                        "upsample_precision": "exact"}, None),
}


@pytest.fixture(scope="module", params=sorted(ROUTES))
def engines(request):
    name, over, hd = ROUTES[request.param]
    if hd is None:
        return SE.run_engines(name, over, jm.MatteNet(), init_mattenet_params(0))
    dec, ss, uf = hd
    return SE.run_engines(name, over, jm.MatteNetHD(stem_stride=ss, head_upsample=uf,
                                                    decoder=dec), init_params(dec, 0, ss))


def test_engine_matches(engines):
    jouts, touts = engines
    for t, (alpha, prev, frame, share) in enumerate(SE.gaps(jouts, touts)):
        assert alpha <= 5e-3 and prev <= 1e-3, (t, alpha, prev)
        assert frame <= 1 and share < 1e-2, (t, frame, share)
    for g in touts:
        assert g["alpha"].dtype.is_floating_point and tuple(g["alpha"].shape) == (2, 32, 64)
        assert not g["passthrough"]


@pytest.mark.parametrize("plan", ["A", "B"])
def test_float_model_over_packed_frames_is_built(plan):
    """matting_precision='bf16' on s2d builds the float MatteNetHD (the
    full f32 alpha, never the head-grid logits: it has no lowres output);
    the planar u8 guide still feeds the fused temporal refine; the mask
    must be uf x the stem grid, as the reference's error says."""
    name, over = ("fast", {"frame_layout": "s2d"}) if plan == "A" else \
        ("fast_int8", {"matting_precision": "bf16", "refine_alpha_src": "lowres"})
    st = preset(name, **over, **SE.GEOM)
    e = Engine(1, st, device="cpu")
    assert isinstance(e.model, MatteNetHD) and e.model.plan_a == (plan == "A")
    assert not fast_routing(e.model, st)["use_lowres_alpha"]
    with pytest.raises(ValueError, match="integer multiple of the stem grid"):
        Engine(1, preset(name, **over, **{**SE.GEOM, "mask_hw": (30, 64)}), device="cpu")


def test_trained_weights_of_the_float_forms():
    """Plan A over packed frames serves the committed mattenet_hd tree, the
    float K=4 pico its committed float export (mattenet_hd10_mc_pico_f32);
    the other float forms have no committed export, and the KeyError names
    the reference's checkpoint; params_from_jax passes a float tree through
    for them."""
    st = preset("fast", frame_layout="s2d")
    w = bridge.trained_weights(st)
    assert set(w["params"]) == {"params", "batch_stats"}
    Engine(1, st, **w, device="cpu")
    with pytest.raises(KeyError, match="checkpoints/mattenet_hd10_lite"):
        bridge.trained_weights(preset("fast_int8_lite", matting_precision="bf16"))
    st = preset("multiclass_fast_pico", matting_precision="bf16")
    w = bridge.trained_weights(st)
    assert set(w["params"]) == {"params", "batch_stats"}
    assert Engine(1, st, **w, device="cpu").model.num_classes == 4
    with pytest.raises(KeyError, match="checkpoints/mattenet_hd10"):
        bridge.trained_weights(preset("fast", s2d_block=10))
    tree = init_params("full", 0, 10)
    back = bridge.params_from_jax(tree, 10, "full", statics=preset("fast_int8",
                                                                  matting_precision="bf16"))
    np.testing.assert_array_equal(back["params"]["Conv_2"]["kernel"],
                                  tree["params"]["Conv_2"]["kernel"])
    assert "stem_w" in bridge.params_from_jax(tree, 10, "full")
