"""Weight bridge from the JAX package's parameters, as numpy trees.

The machine with the card has no JAX, flax or orbax, so nothing here reads
a checkpoint: a caller that has the reference restores its checkpoint
there and hands the arrays over as nested dicts of numpy arrays.  Serving
trained weights on the card needs such an export committed as numpy.

* :func:`params_from_jax`: the reference's float MatteNetHD tree
  (``{"params", "batch_stats"}``) -> the port's int8 serving dict, through
  the port's own quantizer.
* :func:`load_quantized`: the reference's already-quantized dict
  (``quantize_mattenet_hd`` output) -> the same serving dict.

Either result goes to ``Engine(params=...)``.
"""

from __future__ import annotations

import numpy as np

from video_stream_segmenetation_tpu_torch.models.quantized import quantize_mattenet_hd

# keys of the serving dict; per-layer dicts keep these fields
_LAYERS = ("d2dn", "d2b", "d3dn", "d3b", "ctx", "u2red", "u1red", "alpha_q")
_DENSE = ("ctxse/Dense_0", "ctxse/Dense_1")


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def params_from_jax(float_tree: dict, stem_stride: int = 10) -> dict:
    """Float pico tree (numpy leaves, or anything ``np.asarray`` takes)
    -> int8 serving dict."""
    return quantize_mattenet_hd(_numpy_tree(float_tree), stem_stride)


def load_quantized(q: dict) -> dict:
    """The reference's quantized dict (numpy leaves; ``stem_w`` may be a
    bfloat16 array) -> the port's serving dict.  Keys the port does not
    serve (``det``/``sem`` heads, the int8-stem variant) are dropped."""
    out = {
        "stem_w": np.asarray(q["stem_w"]).astype(np.float32),
        "stem_b": np.asarray(q["stem_b"], np.float32),
    }
    for name in _LAYERS:
        out[name] = {
            "wq": np.asarray(q[name]["wq"], np.int8),
            "mult": np.asarray(q[name]["mult"], np.float32),
            "bias": np.asarray(q[name]["bias"], np.float32),
        }
    for name in _DENSE:
        out[name] = {f: np.asarray(q[name][f], np.float32) for f in ("kernel", "bias")}
    return out
