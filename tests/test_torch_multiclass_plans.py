"""K-class MatteNetHD engines on the s2d layout, the port's Engine against
the JAX Engine on the CPU (tests/torch_s2d_engines.py: 8 steps at 80x160,
mask 32x64, S=2, seeded trees handed to both): the float model
(``matting_precision='bf16'``) at plans A (block 5), B, C and D (block 10),
and the int8 graph with K = 4 on the micro, light and full plans (the
reference's K-class head outside the trunk megakernel; the JAX Engine
quantizes the float tree and the port serves the reference's quantized
dict).

Tolerances, with their reasons:
* int8: the class maps, alpha and new_prev within 1e-5 (exact s32 sums,
  the same f32 epilogues; tests/test_torch_multiclass.py's bar);
* float: within 2e-3 (bf16 layers rounded apart by PyTorch and XLA,
  tests/test_torch_float_hd.py's bar on the model's softmax maps, which
  the simplex EMA only averages);
* the frame within one u8 step on the int8 maps (the packed per-class
  composite's bf16 products, tests/test_torch_multiclass.py); on the
  float maps within two at under 3 % of the values (1.5 % seen): the composite rounds
  its colour field (0..255) to bf16, whose step is one u8 unit above 128,
  so a gap of 1e-4 in a class map can move it by a whole step.
"""

import jax
import numpy as np
import pytest

from tests import torch_s2d_engines as SE
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD, init_params
from video_stream_segmenetation_tpu_torch.models.quantized import QuantizedMatteNetHD
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine

K = 4
# route: (decoder, stem stride, head upsample, matting precision)
ROUTES = {"float_plan_a": ("full", 5, 2, "bf16"), "float_plan_b": ("full", 10, 4, "bf16"),
          "float_plan_c": ("light", 10, 4, "bf16"), "float_plan_d": ("micro", 10, 4, "bf16"),
          "int8_micro": ("micro", 10, 4, "int8"), "int8_light": ("light", 10, 4, "int8"),
          "int8_full": ("full", 10, 4, "int8")}


def _quantized(je):
    return bridge.load_quantized(jax.tree_util.tree_map(np.asarray, je.bundle.matte_params))


@pytest.fixture(scope="module", params=sorted(ROUTES))
def engines(request):
    dec, ss, uf, prec = ROUTES[request.param]
    over = {"matting_decoder": dec, "s2d_block": ss, "matting_precision": prec}
    model = jm.MatteNetHD(stem_stride=ss, head_upsample=uf, num_classes=K, decoder=dec)
    jouts, touts = SE.run_engines("multiclass_fast", over, model, init_params(dec, 0, ss, K),
                                  port_params=_quantized if prec == "int8" else None)
    return prec, jouts, touts


def test_engine_matches(engines):
    prec, jouts, touts = engines
    tol = 1e-5 if prec == "int8" else 2e-3
    for t, (j, g) in enumerate(zip(jouts, touts)):
        ca = g["class_alpha"].numpy()
        assert ca.shape == (2, 32, 64, K) and not g["passthrough"]
        np.testing.assert_allclose(ca, np.asarray(j["class_alpha"]), rtol=0, atol=tol,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(ca.sum(-1), 1.0, rtol=0, atol=1e-5)
    for t, (alpha, prev, frame, share) in enumerate(SE.gaps(jouts, touts)):
        assert alpha <= tol and prev <= tol, (t, alpha, prev)
        if prec == "int8":
            assert frame <= 1, (t, frame)
        else:
            assert frame <= 2 and share < 3e-2, (t, frame, share)


@pytest.mark.parametrize("dec", ["micro", "light", "full"])
def test_int8_k_classes_build_on_every_plan(dec):
    """The K=4 int8 graph builds on the plans that once served one class
    only, and a K=4 micro engine steps; the float one builds the float
    MatteNetHD with K heads."""
    st = preset("multiclass_fast", matting_decoder=dec, **SE.GEOM)
    e = Engine(1, st, device="cpu")
    assert isinstance(e.model, QuantizedMatteNetHD) and e.model.num_classes == K
    out = e.process(np.zeros((1, 80, 160, 3), np.uint8))
    assert tuple(out["class_alpha"].shape) == (1, 32, 64, K) and not out["passthrough"]
    f = Engine(1, preset("multiclass_fast", matting_decoder=dec, matting_precision="bf16",
                         **SE.GEOM), device="cpu")
    assert isinstance(f.model, MatteNetHD) and f.model.num_classes == K
    with pytest.raises(ValueError, match="classes"):
        Engine(1, preset("multiclass_fast", matting_decoder=dec, matting_precision="bf16",
                         **SE.GEOM), params=init_params(dec, 0, 10, 1), device="cpu")


def test_natural_native_input_with_k_classes_stays_refused():
    """The reference's natural multi-class step feeds the MatteNetHD the
    mask-size resize, whose alpha is off the mask grid: it fails at its
    first step (sub got incompatible shapes for broadcasting), so the port
    refuses it when the engine is built."""
    with pytest.raises(NotImplementedError, match="matting_input"):
        Engine(1, preset("multiclass", matting_input="native", frame_hw=(80, 160),
                         mask_hw=(32, 64)), device="cpu")
