"""The float MatteNetHD on the trained trees, in the port against the JAX
package on the CPU, over tests/torch_natural_engines.py's rendered people
at 80x160, natural and packed: plan A (the committed ``mattenet_hd``
export), plans B, C and D and the pico trunk's float tree
(``checkpoints/mattenet_hd10``, ``_lite``, ``_micro``, ``_pico``), and the
K = 4 trees of pico and nano (``checkpoints/mattenet_hd10_mc_pico``,
``_mc``), restored by the reference's ``restore_params``.  No float export
of the trees of stem stride 10 is committed: the card serves those forms
on seeded weights (ROADMAP.md).

Tolerance, with its reason: trained bf16 nets sit on knife edges, where
the reference's own forwards disagree: its op-by-op forward
(``jax.disable_jit``) departs from its jitted one by REF_GAP (measured on
these frames and trees: the mean and 99th percentile of the alpha's
absolute gap, and the count of mask pixels whose decision flips: alpha >
0.5, or with K the argmax class).  The port is held to twice that gap
against the jitted forward, as tests/test_torch_fast.py holds plan A.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_natural_engines as NE
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models
from video_stream_segmenetation_tpu.ops.layout import space_to_depth
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD

# name: (source, decoder, stem stride, head upsample)
TREES = {"A": ("mattenet_hd.npz", "full", 5, 2),
         "B": ("checkpoints/mattenet_hd10", "full", 10, 4),
         "C": ("checkpoints/mattenet_hd10_lite", "light", 10, 4),
         "D": ("checkpoints/mattenet_hd10_micro", "micro", 10, 4),
         "pico": ("checkpoints/mattenet_hd10_pico", "pico", 10, 4),
         "mc_pico": ("checkpoints/mattenet_hd10_mc_pico", "pico", 10, 4),
         "mc_nano": ("checkpoints/mattenet_hd10_mc", "nano", 10, 4)}
# the reference's jitted against op-by-op gap: (mean, p99, flipped pixels
# of the 4096 in the two 32x64 masks)
REF_GAP = {("A", "natural"): (1.031e-3, 1.709e-2, 3), ("A", "packed"): (2.034e-3, 3.765e-2, 4),
           ("B", "natural"): (1.136e-3, 7.376e-3, 3), ("B", "packed"): (8.665e-4, 6.430e-3, 3),
           ("C", "natural"): (5.723e-4, 3.361e-3, 2), ("C", "packed"): (8.266e-4, 5.719e-3, 6),
           ("D", "natural"): (5.186e-4, 4.293e-3, 4), ("D", "packed"): (5.947e-4, 5.867e-3, 4),
           ("pico", "natural"): (6.817e-4, 4.686e-3, 1),
           ("pico", "packed"): (1.371e-3, 1.980e-2, 6),
           ("mc_pico", "natural"): (7.081e-4, 5.152e-3, 14),
           ("mc_pico", "packed"): (8.334e-4, 6.271e-3, 7),
           ("mc_nano", "natural"): (6.544e-4, 5.675e-3, 7),
           ("mc_nano", "packed"): (6.061e-4, 4.637e-3, 7)}


def _tree(source):
    if source.endswith(".npz"):
        return bridge.load_export(bridge.WEIGHTS_DIR / source)
    return bridge.float_tree(jax.tree_util.tree_map(np.asarray, restore_params(source)))


@pytest.mark.parametrize("layout", ["natural", "packed"])
@pytest.mark.parametrize("name", sorted(TREES))
def test_trained_forward_within_twice_the_reference_gap(name, layout):
    source, dec, ss, uf = TREES[name]
    tree = _tree(source)
    k = tree["params"]["Conv_2"]["kernel"].shape[-1]
    frames = NE.engine_frames()[0]
    x = np.asarray(space_to_depth(jnp.asarray(frames), ss)) if layout == "packed" else frames
    jm = models.MatteNetHD(stem_stride=ss, head_upsample=uf, num_classes=k, decoder=dec)
    want = np.asarray(jax.jit(jm.apply)(jax.tree_util.tree_map(jnp.asarray, tree),
                                        jnp.asarray(x))["alpha"])
    with torch.no_grad():
        got = MatteNetHD(ss, uf, dec, params=tree, device="cpu")(torch.tensor(x))["alpha"]
    got = got.numpy()
    assert got.shape == want.shape == ((2, 32, 64) if k == 1 else (2, 32, 64, k))
    gap = np.abs(got - want)
    flips = (((got > 0.5) != (want > 0.5)).sum() if k == 1
             else (got.argmax(-1) != want.argmax(-1)).sum())
    mean, p99, pixels = REF_GAP[(name, layout)]
    assert gap.mean() <= 2 * mean, gap.mean()
    assert np.quantile(gap, 0.99) <= 2 * p99, np.quantile(gap, 0.99)
    assert flips <= 2 * pixels, flips
