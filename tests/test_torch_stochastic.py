"""The port's weight quantization (utils/quantize.py) and stochastic
rounding (kernels/stochastic_round.py) against the JAX package.

``quantize_tree``, ``dequantize_tree`` and ``quantization_error`` equal the
reference's bit for bit.  The reference rounds with the TPU's own random
bits, which cannot be matched, and off the TPU it rounds to nearest
(``utils/quantize.py:87-90``); the port draws from a Philox4x32-10 on both
the CPU and the card, so it is held to the distribution: every output one
of the input's two bf16 neighbours, exact values unchanged, the special
values as the kernel's source states them, the mean over seeds within 5
sigma of the input.  The Philox itself is held to Random123's known
answers.  The ``gpu`` case holds the CUDA kernel against the plain version
bit for bit; the JAX package is imported inside the tests that use it, so
that the card's machine (no JAX) can run that case with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_stochastic.py -q
"""

import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu_torch.kernels import stochastic_round as SR
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params
from video_stream_segmenetation_tpu_torch.utils import quantize as TQ


@pytest.fixture(scope="module")
def jq():
    from video_stream_segmenetation_tpu.utils import quantize

    return quantize


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8)


def _seeded_tree():
    tree = init_params("micro", 3)
    # a 2-D leaf too (the per-channel scale over one axis)
    tree["params"]["extra"] = {"kernel": np.random.default_rng(1).normal(
        0, 0.3, (40, 48)).astype(np.float32)}
    return tree


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_quantize_tree_matches_reference_bit_for_bit(jq, bits, kind):
    import jax.numpy as jnp

    tree = _seeded_tree()
    want = jq.quantize_tree(_map_np(tree, jnp.asarray), bits=bits)
    got = TQ.quantize_tree(tree if kind == "numpy" else _map_np(tree, torch.as_tensor),
                           bits=bits)
    fw, fg = _flat(want), _flat(got)
    assert fw.keys() == fg.keys()
    n_quant = 0
    for k, w in fw.items():
        g = fg[k]
        if k[-1] in ("q", "scale"):
            g = g.numpy() if isinstance(g, torch.Tensor) else g
            assert g.dtype == np.asarray(w).dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(k))
            n_quant += k[-1] == "q"
        elif k[-1] in ("orig_dtype", "bits", "__quant__"):
            assert g == w, k
        else:  # a small leaf passes through
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert n_quant >= 10
    # dequantized both ways, and across: the reference's quantized tree
    # through the port's dequantizer and the port's through the reference's
    deq_w = _flat(jq.dequantize_tree(want))
    for k, d in _flat(TQ.dequantize_tree(got)).items():
        d = d.numpy() if isinstance(d, torch.Tensor) else d
        np.testing.assert_array_equal(_bits(d), _bits(deq_w[k]), err_msg=str(k))
    for k, d in _flat(TQ.dequantize_tree(_map_np(want, np.asarray))).items():
        np.testing.assert_array_equal(_bits(d), _bits(deq_w[k]), err_msg=str(k))
    across = _flat(jq.dequantize_tree(_map_np(TQ.quantize_tree(tree, bits=bits), jnp.asarray)))
    for k, d in across.items():
        np.testing.assert_array_equal(_bits(d), _bits(deq_w[k]), err_msg=str(k))
    assert TQ.quantization_error(tree, bits) == jq.quantization_error(
        _map_np(tree, jnp.asarray), bits)


def _map_np(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_np(v, fn) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, np.generic)) or hasattr(tree, "dtype"):
        return fn(tree)
    return tree


# Random123's known-answer vectors for philox4x32-10 (kat_vectors)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    got = SR.philox4x32_10(torch.tensor([counter], dtype=torch.int64), key)
    assert tuple(got[0].tolist()) == want


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _neighbours(x: np.ndarray):
    """The bf16 patterns at and above |x| in magnitude: truncation toward
    zero, and one step further from zero."""
    lo = (x.view(np.uint32) >> 16).astype(np.uint32)
    return lo, lo + 1


def _mixed_values(n=4096, seed=0):
    g = np.random.default_rng(seed)
    x = (g.standard_normal(n) * 10.0 ** g.integers(-30, 30, n)).astype(np.float32)
    exact = (g.standard_normal(n // 4).astype(np.float32).view(np.uint32) & 0xFFFF0000)
    sub = g.integers(1, 2 ** 23, n // 8, dtype=np.uint32) | (g.integers(0, 2, n // 8,
                                                                        dtype=np.uint32) << 31)
    return np.concatenate([x, exact.view(np.float32), sub.view(np.float32)])


def test_outputs_are_neighbours_and_exact_values_match_reference(jq):
    import jax.numpy as jnp

    x = _mixed_values()
    stand_in = np.asarray(jq.stochastic_round_bf16(jnp.asarray(x))).view(np.uint16)
    lo, hi = _neighbours(x)
    exact = (x.view(np.uint32) & 0xFFFF) == 0
    assert exact.sum() > 1000
    for seed in (0, 1, 12345, -7):
        got = _bf16_bits(TQ.stochastic_round_bf16(torch.as_tensor(x), seed)).astype(np.uint32)
        assert np.all((got == lo) | (got == hi))
        np.testing.assert_array_equal(got[exact], stand_in[exact])
        # both neighbours occur where x is not exact in bf16
        assert 0.3 < np.mean(got[~exact] == hi[~exact]) < 0.7


def test_special_values():
    f32 = np.float32
    big = np.asarray([0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000], np.uint32).view(f32)
    nans = np.asarray([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FFFFFFF,
                       0xFFFFFFFF, 0x7FBFFFFF], np.uint32).view(f32)
    x = np.concatenate([[f32(0.0), f32(-0.0), f32(np.inf), f32(-np.inf)], nans, big])
    outs = np.stack([_bf16_bits(TQ.stochastic_round_bf16(torch.as_tensor(x), s))
                     for s in range(512)]).astype(np.uint32)
    xb = x.view(np.uint32)
    # +-0 and +-inf unchanged
    np.testing.assert_array_equal(outs[:, :4], np.broadcast_to(xb[:4] >> 16, (512, 4)))
    # NaN: a quiet NaN of the same sign, its top payload bits kept
    nb = outs[:, 4:4 + len(nans)]
    np.testing.assert_array_equal(nb, np.broadcast_to((xb[4:4 + len(nans)] >> 16) | 0x40,
                                                      nb.shape))
    assert np.all((nb & 0x7F80) == 0x7F80) and np.all(nb & 0x7F)
    # near bf16's largest finite value: that value or inf of the same sign,
    # inf with the probability the addition gives (2^16 - 1 and 2^15 of 2^16)
    bb = outs[:, -3:]
    top = xb[-3:] >> 16
    assert np.all((bb == top) | (bb == top + 1))
    for j, p in ((0, 0xFFFF / 0x10000), (1, 0xFFFF / 0x10000), (2, 0.5)):
        share = np.mean(bb[:, j] == top[j] + 1)
        assert abs(share - p) <= 5 * np.sqrt(p * (1 - p) / 512) + 1 / 512, (j, share)


def test_mean_over_seeds_is_unbiased():
    g = np.random.default_rng(5)
    x = np.concatenate([g.standard_normal(12).astype(np.float32),
                        np.asarray([1.0 + 2.0 ** -9, -3.0 - 2.0 ** -12, 1e-30, 7.5e-39],
                                   np.float32)])
    n = 4096
    acc = np.zeros(x.shape, np.float64)
    xt = torch.as_tensor(x)
    for seed in range(n):
        acc += TQ.stochastic_round_bf16(xt, seed).double().numpy()
    mean = acc / n
    lo, hi = _neighbours(x)
    lo_f = (lo << 16).astype(np.uint32).view(np.float32).astype(np.float64)
    hi_f = (hi << 16).astype(np.uint32).view(np.float32).astype(np.float64)
    gap = np.abs(hi_f - lo_f)
    p = np.abs(x.astype(np.float64) - lo_f) / gap
    sigma = gap * np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(mean - x) <= 5 * sigma + 1e-12 * gap), (mean - x) / sigma


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    x = torch.as_tensor(_mixed_values(1001))
    n = SR.stochastic_round_bf16.launches
    got = SR.stochastic_round_bf16(x, 9)
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(
        SR.stochastic_round_bf16_plain(x, 9)))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert SR.stochastic_round_bf16.launches == n


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,offset", [((4096,), 0), ((3, 5, 11), 0), ((1001,), 1),
                                          ((1 << 20, 7), 0)])
def test_kernel_matches_plain_bit_for_bit(card, shape, offset):
    """Aligned and unaligned inputs (``offset`` elements into a buffer), a
    ragged last group, and more groups than the grid has threads (the
    grid-stride loop)."""
    n = int(np.prod(shape))
    x = torch.as_tensor(np.resize(_mixed_values(), n + offset)).to(card)[offset:].reshape(shape)
    launches = SR.stochastic_round_bf16.launches
    for seed in (0, 77, -1):
        got = SR.stochastic_round_bf16(x, seed)
        want = SR.stochastic_round_bf16_plain(x, seed)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert SR.stochastic_round_bf16.launches == launches + 3
