"""The routed 3x3 convs (``int8_conv_impl='pallas'``) on the CPU: the OHWI
weights the trunks hand to ``conv3x3_i8_fused`` (the layout its CUDA kernel
reads), and the wrapper's CPU route with and without them against the
reference's Pallas kernel in interpret mode, in all four forms."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu.kernels.conv_int8 import conv3x3_i8_fused as jax_conv3x3
from video_stream_segmenetation_tpu_torch.kernels import conv_int8 as TC
from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
from video_stream_segmenetation_tpu_torch.models import quantized as TQ
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params

# the layers each plan routes through conv3x3_i8_fused (the reference's
# _qconv with conv_impl='pallas'): every block's first conv, plan C's b1c
# and u2, plans B's and C's ctx2
ROUTED = {"full": ("b1/c0", "d2b/c0", "d3b/c0", "ctx2"),
          "light": ("b1c", "d2b/c0", "d3b/c0", "ctx2", "u2"),
          "micro": ("d2b/c0", "d3b/c0")}


def _layer(tp, name):
    pfx, _, sub = name.partition("/")
    return tp[pfx][sub] if sub else tp[pfx]


def _carrying_wq(tp):
    """The names of the layers that carry HWIO ``wq`` (``ctx2``, ``d2b/c0``)."""
    names = []
    for k, v in tp.items():
        if isinstance(v, dict):
            names += [k] if "wq" in v else [f"{k}/{s}" for s, layer in v.items()
                                             if isinstance(layer, dict) and "wq" in layer]
    return sorted(names)


@pytest.mark.parametrize("plan", sorted(ROUTED))
def test_routed_layers_pass_ohwi_weights(plan, monkeypatch):
    """For every layer the plan routes (seeded weights through the port's
    quantizer), ``_qconv`` hands conv3x3_i8_fused the layer's OHWI copy,
    and that copy is the HWIO ``wq`` transposed; no other layer carries
    ``wq``."""
    tp = TQ.trunk_params(TQ.quantize_mattenet_hd(init_params(plan, 0, 10), 10, plan))
    assert _carrying_wq(tp) == sorted(ROUTED[plan])
    seen = []

    def spy(x, wq, mult, bias, residual=None, act=True, dilation=1, w_ohwi=None):
        seen.append((wq, w_ohwi))
        return TC.conv3x3_i8_plain(x, wq, mult, bias, residual, act, dilation)

    monkeypatch.setattr(TK, "conv3x3_i8_fused", spy)
    for name in ROUTED[plan]:
        layer = _layer(tp, name)
        x = torch.zeros((1, 4, 4, layer["wq"].shape[2]), dtype=torch.int8)
        TK._qconv(None, None, x, layer, "pallas")
        wq, w_ohwi = seen[-1]
        assert wq is layer["wq"] and w_ohwi is layer["w"]
        assert w_ohwi.dtype == torch.int8 and w_ohwi.is_contiguous()
        assert torch.equal(w_ohwi, wq.permute(3, 0, 1, 2)), name
    assert len(seen) == len(ROUTED[plan])


def _inputs(dilation):
    g = np.random.default_rng(12 + dilation)
    x = g.integers(0, 128, (2, 9, 16, 32), dtype=np.int8)
    wq = g.integers(-127, 128, (3, 3, 32, 36), dtype=np.int8)
    # large enough that the act form's relu6 and the no-act form's clip bind
    mult = (g.random(36) * 0.02).astype(np.float32)
    bias = (g.random(36) - 0.5).astype(np.float32)
    res = g.integers(0, 128, (2, 9, 16, 36), dtype=np.int8)
    return x, wq, mult, bias, res


@functools.lru_cache(maxsize=None)
def _reference(act, residual, dilation):
    x, wq, mult, bias, res = _inputs(dilation)
    return np.asarray(jax_conv3x3(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(mult),
                                  jnp.asarray(bias),
                                  residual=jnp.asarray(res) if residual else None,
                                  with_residual=residual, act=act, dilation=dilation,
                                  interpret=True))


@pytest.mark.parametrize("ohwi", [False, True], ids=["hwio", "ohwi"])
@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("act", [True, False], ids=["act", "noact"])
@pytest.mark.parametrize("residual", [False, True], ids=["nores", "res"])
def test_conv3x3_cpu_route_matches_pallas(residual, act, dilation, ohwi):
    """conv3x3_i8_fused on CPU tensors, given the OHWI weights or not, equals
    the reference's Pallas kernel in interpret mode exactly (S=2, 9x16,
    32 -> 36 channels), and launches nothing."""
    x, wq, mult, bias, res = _inputs(dilation)
    wq_t = torch.tensor(wq)
    n = TC.conv3x3_i8_fused.launches
    got = TC.conv3x3_i8_fused(torch.tensor(x), wq_t, torch.tensor(mult), torch.tensor(bias),
                              torch.tensor(res) if residual else None, act=act,
                              dilation=dilation,
                              w_ohwi=wq_t.permute(3, 0, 1, 2).contiguous() if ohwi else None)
    assert TC.conv3x3_i8_fused.launches == n
    want = _reference(act, residual, dilation)
    assert got.dtype == torch.int8 and got.shape == want.shape == (2, 9, 16, 36)
    np.testing.assert_array_equal(got.numpy(), want)
    lo = 0 if act else -127
    assert got.min().item() == lo and got.max().item() == 127


def test_conv3x3_cpu_route_refuses_other_ohwi_weights():
    """On CPU tensors the wrapper holds ``w_ohwi`` to ``wq.permute(3, 0, 1,
    2)``: OHWI weights that differ from ``wq`` in one byte raise, and the
    plain version is never handed them."""
    x, wq, mult, bias, _ = _inputs(1)
    wq_t = torch.tensor(wq)
    w_ohwi = wq_t.permute(3, 0, 1, 2).contiguous()
    w_ohwi[5, 1, 2, 7] += 1
    with pytest.raises(ValueError, match="w_ohwi"):
        TC.conv3x3_i8_fused(torch.tensor(x), wq_t, torch.tensor(mult), torch.tensor(bias),
                            w_ohwi=w_ohwi)
