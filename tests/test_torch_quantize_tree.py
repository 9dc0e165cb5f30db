"""The port's ``quantize_tree``, ``dequantize_tree`` and
``quantization_error`` (utils/quantize.py) against the JAX package's on
trees of numpy leaves in bfloat16, float16 and float32, above and below
``min_size``, with integer leaves beside them.

numpy sees ``ml_dtypes.bfloat16`` as kind ``'V'``, so a test of
``np.floating`` alone passes such a leaf through unquantized where the
reference (``jnp.issubdtype``) quantizes it.  Held here: ``q`` and
``scale`` bit for bit, ``orig_dtype``, the dequantized leaf's dtype and
values (bit for bit: one f32 product, one cast), the error within 1e-7.
"""

import ml_dtypes
import numpy as np
import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu_torch.utils import quantize as TQ

DTYPES = {"bfloat16": ml_dtypes.bfloat16, "float16": np.float16, "float32": np.float32}
ERR_TOL = 1e-7


@pytest.fixture(scope="module")
def jq():
    from video_stream_segmenetation_tpu.utils import quantize

    return quantize


def _tree(dtype, seed):
    rng = np.random.default_rng(seed)

    def leaf(shape, sd=0.2):
        return rng.normal(0.0, sd, shape).astype(np.float32).astype(dtype)

    return {
        "conv": {"kernel": leaf((3, 3, 16, 32)), "bias": leaf((32,))},
        "dense": [leaf((64, 48), 2.0), leaf((1024,), 0.01)],  # a 1-D leaf at min_size
        "small": leaf((31, 33)),  # 1023 elements: below min_size
        "steps": rng.integers(0, 100, (64, 32)).astype(np.int32),
    }


def _flat(tree, prefix=()):
    if isinstance(tree, dict) and not tree.get("__quant__"):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (i,)))
        return out
    return {prefix: tree}


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_tree_matches_reference(jq, dtype, bits):
    tree = _tree(DTYPES[dtype], 11 + bits)
    want, got = _flat(jq.quantize_tree(tree, bits=bits)), _flat(TQ.quantize_tree(tree, bits=bits))
    assert want.keys() == got.keys()
    quantized = 0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert isinstance(g, dict), (k, "passed through where the reference quantizes")
            quantized += 1
            assert g["orig_dtype"] == w["orig_dtype"] == dtype
            assert g["bits"] == w["bits"] == bits
            for f in ("q", "scale"):
                assert np.asarray(g[f]).dtype == np.asarray(w[f]).dtype, (k, f)
                assert _bits(g[f]) == _bits(w[f]), (k, f)
        else:
            assert not isinstance(g, dict), (k, "quantized where the reference passes through")
            assert g is tree_leaf(tree, k)
    assert quantized == 3


def tree_leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dequantize_tree_matches_reference(jq, dtype):
    tree = _tree(DTYPES[dtype], 5)
    want = _flat(jq.dequantize_tree(jq.quantize_tree(tree)))
    got = _flat(TQ.dequantize_tree(TQ.quantize_tree(tree)))
    assert want.keys() == got.keys()
    for k, w in want.items():
        g = got[k]
        assert str(np.asarray(g).dtype) == str(np.asarray(w).dtype), k
        assert _bits(g) == _bits(w), k
    assert str(got[("conv", "kernel")].dtype) == dtype


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantization_error_matches_reference(jq, dtype, bits):
    tree = _tree(DTYPES[dtype], 23)
    want = jq.quantization_error(tree, bits)
    got = TQ.quantization_error(tree, bits)
    assert want > 0.0
    assert abs(got - want) <= ERR_TOL, (got, want)
