"""The float MatteNetHD's forms that serve seeded weights on the card (no
committed float export: ROADMAP.md), at 720p on the committed frames, the
port's Engine against the JAX Engine (tests/torch_720p_engines.py), the
seed-0 tree of models/mattenet_hd.py::init_params handed to both, the
committed face models: fast_int8 with ``matting_precision='bf16'`` and
the face path off (float plan B over packed frames; with the face path on
the means would depend on the stream count, as the compacted face path
takes ceil(S / 6) streams a step) and multiclass_fast_pico with
``matting_precision='bf16'`` (the K=4 float pico at the 72x128 head grid).
Seeded nets find no person, so they are held by their maps' means: the
reference's mean over the last step's two streams is the bar chip_smoke.py
holds the card to (REFERENCE_MEANS, within 5e-3).

Tolerance: the port's means within 1e-3 of the reference's at every step
(tests/test_torch_multiclass_natural.py's: bf16 layers rounded apart move
the means by well under that); the served maps in range (the class maps
on the simplex).
"""

import numpy as np
import pytest

from tests import torch_720p_engines as E
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params

# run: (preset, overrides, decoder, K, output)
RUNS = {"fast_int8_bf16": ("fast_int8", {"matting_precision": "bf16", "face_path": False},
                           "full", 1, "alpha"),
        "multiclass_fast_pico_bf16": ("multiclass_fast_pico", {"matting_precision": "bf16"},
                                      "pico", 4, "class_alpha")}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_seeded_engine_means_720p(run, record_property):
    name, over, dec, k, key = RUNS[run]
    uf = 4 if k == 1 else 1
    model = jm.MatteNetHD(stem_stride=10, head_upsample=uf, num_classes=k, decoder=dec)
    means = []
    for t, (j, g, _) in enumerate(E.run(name, over, model, init_params(dec, 0, 10, k))):
        axes = (0, 1, 2)
        want = np.asarray(j[key], np.float64).mean(axis=axes)
        got = g[key].double().numpy().mean(axis=axes)
        print(f"[{run}, 720p, step {t}] {key} means: reference {np.round(want, 6)}, "
              f"port {np.round(got, 6)}")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        means.append(want.tolist())
        if k > 1:
            np.testing.assert_allclose(g[key].sum(-1).numpy(), 1.0, rtol=0, atol=1e-3)
    record_property("means_reference_last", means[-1])
