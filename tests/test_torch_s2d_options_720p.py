"""The s2d layout's new serving forms at 720p with trained weights, the
port's Engine against the JAX Engine (tests/torch_720p_engines.py), held by
their IoU against the committed frames' ground truth: ``fast`` with
``frame_layout='s2d'`` (the trained plan-A ``mattenet_hd`` over packed
frames at block 5, mask 288x512 = 2 x the 144x256 stem grid) and
fast_int8_pico with ``warp_impl='exact'``, ``upsample_precision='exact'``
and ``upsample_method='align_corners'`` (the trained pico checkpoint).
The reference's least IoU over the 8 steps is the bar chip_smoke.py holds
the card to (REFERENCE_IOU, within 0.02).

Tolerance: the port's IoU within 0.01 of the reference's at every step
(tests/test_torch_fast.py's: trained bf16 nets on knife edges are held
by IoU, not element by element).
"""

import jax
import numpy as np
import pytest

from tests import torch_720p_engines as E
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu_torch import bridge


def _pico():
    tree = bridge.float_tree(jax.tree_util.tree_map(
        np.asarray, restore_params("checkpoints/mattenet_hd10_pico")))
    return ("fast_int8_pico", {"warp_impl": "exact", "upsample_precision": "exact",
                               "upsample_method": "align_corners"},
            jm.MatteNetHD(stem_stride=10, head_upsample=4, decoder="pico"), tree,
            bridge.load_export(bridge.WEIGHTS_DIR / "mattenet_hd10_pico.npz"),
            {"int8_decoder_impl": "trunk"})


def _fast_s2d():
    tree = bridge.load_export(bridge.WEIGHTS_DIR / "mattenet_hd.npz")
    return "fast", {"frame_layout": "s2d"}, jm.MatteNetHD(), tree, None, None


RUNS = {"fast_s2d": _fast_s2d, "fast_int8_pico_exact_align_corners": _pico}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_trained_engine_iou_720p(run, record_property):
    name, over, model, tree, port_params, jax_over = RUNS[run]()
    ious = []
    for t, (j, g, truth) in enumerate(E.run(name, over, model, tree, port_params, jax_over)):
        step = (E.iou(np.asarray(j["alpha"], np.float32), truth),
                E.iou(g["alpha"].float().numpy(), truth))
        print(f"[{run}, 720p, step {t}] IoU vs ground truth: reference {step[0]:.4f}, "
              f"port {step[1]:.4f}")
        ious.append(step)
        assert abs(step[0] - step[1]) < 0.01
    record_property("iou_reference", [r for r, _ in ious])
    record_property("iou_port", [p for _, p in ious])
    assert min(r for r, _ in ious) > 0.3
