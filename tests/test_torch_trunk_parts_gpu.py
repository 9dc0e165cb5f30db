"""The int8 trunk's head, SE and decoder pairs (csrc/trunk_int8.cu's
alpha_head_i8_kernel and se_partial/se_apply kernels; u2red and u1red
through csrc/decoder_int8.cu) against their plain PyTorch versions, on the
card.  Marked ``gpu``: without a card each test skips.  The machine with
the card has no JAX, so this file imports none; run it there with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_trunk_parts_gpu.py -q
"""

import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
from video_stream_segmenetation_tpu_torch.models import quantized as Q
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params
from video_stream_segmenetation_tpu_torch.ops.layout import space_to_depth
from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

BLOCK = 10
# the trunk forms' tolerances (chip_smoke.py: TRUNK_TOL, TRUNK_K4_TOL,
# TRUNK_WIDTHS_TOL, U1_TOL): the seeded pico's logits within 1e-5 (its SE's
# float64 mean summed in another order than the plain version's may move a
# u1 element on a rounding edge), the trained forms and u1 exact
SEEDED_TOL = 1e-5
# the SE alone (chip_smoke.py: SE_TRAINED_TOL, SE_SEEDED_TOL), in s8 steps
SE_TRAINED_TOL, SE_SEEDED_TOL = 0, 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


class CountingLib:
    """The kernel library with every C entry point's calls recorded."""

    def __init__(self, lib):
        self.lib, self.calls = lib, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if not name.startswith("vst_") or name == "vst_error_string":
            return fn

        def call(*args):
            self.calls.append(name)
            return fn(*args)
        return call


@pytest.fixture
def counting(card, monkeypatch):
    """TK._launcher handing out a CountingLib; returns it."""
    lib, stream = TK._launcher(torch.zeros(1, device=card))
    counted = CountingLib(lib)
    monkeypatch.setattr(TK, "_launcher", lambda x0: (counted, stream))
    return counted


def _seeded(device, plan="pico", k=1):
    return Q.trunk_params(Q.quantize_mattenet_hd(init_params(plan, 0, BLOCK, k), BLOCK, plan),
                          device)


def _trained(device, export):
    return Q.QuantizedMatteNetHD(bridge.load_export(bridge.WEIGHTS_DIR / f"{export}.npz"),
                                 BLOCK, 1, device=device)


def _stem_out(model, s=2):
    clip, _ = bridge.load_frames()
    fp = space_to_depth(torch.as_tensor(clip[np.arange(s) % 2], device=model.stem_w.device),
                        BLOCK).contiguous()
    with pinned():
        return model.stem(fp)


def _head(device, k, cin, seed):
    g = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return {"w": t(g.integers(-127, 128, (k, 3, 3, cin), dtype=np.int8)),
            "mult": t((g.random(k) * 1e-3).astype(np.float32)),
            "bias": t(g.normal(0, 1, k).astype(np.float32))}


# (S, H, W): the pico trunk's 720p grid; a last band and a last strip that
# are partial; fewer rows than a band and a ragged width; two column tiles,
# the last of 2 columns
HEAD_GRIDS = [(2, 72, 128), (3, 70, 120), (1, 3, 37), (2, 9, 130)]


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 4, 16])
@pytest.mark.parametrize("grid", HEAD_GRIDS, ids=["x".join(map(str, g)) for g in HEAD_GRIDS])
def test_head_kernel_matches_plain(card, counting, k, grid):
    """The head kernel alone, logits equal to models/quantized.py::
    alpha_head (tolerance 0) at Cin 128, the width every trunk of the port
    feeds it, one launch of its entry point."""
    s, h, w = grid
    head = _head(card, k, 128, seed=k + h + w)
    u1 = torch.as_tensor(np.random.default_rng(h * w + k).integers(0, 128, (s, h, w, 128),
                                                                   dtype=np.int8), device=card)
    lib, stream = TK._launcher(u1)
    got = TK._alpha_head(lib, stream, u1, head)
    want = Q.alpha_head(u1, head)
    torch.cuda.synchronize()
    assert counting.calls == ["vst_alpha_head_i8"]
    assert got.shape == want.shape == ((s, h, w) if k == 1 else (s, h, w, k))
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("k,cin", [(17, 128), (1, 48)])
def test_head_refuses_before_any_launch(card, counting, k, cin):
    """K = 17 classes, or input channels not a multiple of 32: the wrapper
    raises by name and calls no entry point."""
    head = _head(card, k, cin, seed=0)
    u1 = torch.zeros((1, 8, 16, cin), dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="classes" if k > TK.ALPHA_HEAD_MAX_K else "32"):
        TK._alpha_head(*TK._launcher(u1), u1, head)
    assert counting.calls == []


def _plane(device, s, hw, c, seed):
    """A seeded f32 plane on [0, 6] (relu6), as the ctx conv gives."""
    g = np.random.default_rng(seed)
    return torch.as_tensor((g.random((s, *hw, c)) * 6.0).astype(np.float32), device=device)


# (grid, streams): pico's 18x32 ctx grid (P = 576); P = 7 x 9 = 63, no
# multiple of a chunk; P = 40 x 41 = 1640 (chunks of 103 pixels, a ragged
# last one)
SE_GRIDS = [((18, 32), 4), ((7, 9), 3), ((40, 41), 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("residual", [False, True], ids=["ctx", "block"])
@pytest.mark.parametrize("grid,s", SE_GRIDS, ids=["x".join(map(str, g)) for g, _ in SE_GRIDS])
def test_se_kernel_matches_plain_on_seeded_planes(card, counting, residual, grid, s):
    """The SE alone against models/quantized.py::_se then _requant (with
    the residual as _block adds it: the micro trunk's blocks): no element
    more than one s8 step apart, on the seeded pico's ctx SE (C 192) and
    the seeded micro's d2b block SE (C 192, with the residual)."""
    if residual:
        se = _seeded(card, "micro")["d2b"]["se"]
    else:
        se = _seeded(card)["se"]
    c = se["k1"].shape[1]
    x = _plane(card, s, grid, c, seed=grid[0] * grid[1] + int(residual))
    res = (torch.as_tensor(np.random.default_rng(5).integers(0, 128, (s, *grid, c),
                                                            dtype=np.int8), device=card)
           if residual else None)
    lib, stream = TK._launcher(x)
    got = TK._se_requant(lib, stream, x, se, res=res)
    y = Q._se(x, se)
    want = Q._requant(y if res is None else y + res.to(torch.float32) * Q.ACT_SCALE)
    torch.cuda.synchronize()
    assert counting.calls == ["vst_se_requant"]
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert 0 < want.float().mean().item() < 127  # not a saturated plane
    assert (got.int() - want.int()).abs().max().item() <= SE_SEEDED_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("c,contiguous", [(24, True), (192, False)],
                         ids=["channels", "strides"])
def test_se_refuses_before_any_launch(card, counting, c, contiguous):
    """A plane of channels not a multiple of 16, or one that is not
    contiguous: the wrapper raises by name and calls no entry point."""
    g = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, device=card)  # noqa: E731
    se = {"k0": t(g.normal(0, 0.1, (c, 8)).astype(np.float32)),
          "b0": t(np.zeros(8, np.float32)),
          "k1": t(g.normal(0, 0.1, (8, c)).astype(np.float32)),
          "b1": t(np.zeros(c, np.float32))}
    x = _plane(card, 2, (4, 6), c, seed=0)
    if not contiguous:
        x = x.transpose(1, 2)
    with pytest.raises(ValueError, match="16" if contiguous else "contiguous"):
        TK._se_requant(*TK._launcher(x), x, se)
    assert counting.calls == []


@pytest.mark.gpu
def test_se_entry_point_refuses_channels_not_a_multiple_of_16(card):
    """The C entry point itself refuses C % 16 (and a scratch buffer of no
    chunk) with cudaErrorInvalidValue before it reads a pointer."""
    from video_stream_segmenetation_tpu_torch.kernels import _build

    lib, stream = _build.library(), torch.cuda.current_stream(card).cuda_stream
    for c, chunks in ((24, TK.SE_MAX_CHUNKS), (192, 0)):
        with pytest.raises(RuntimeError, match="se_requant"):
            _build.check(lib, lib.vst_se_requant(None, None, None, None, None, None, None,
                                                 None, 1, 576, c, 8, chunks, stream),
                         "se_requant")


@pytest.mark.gpu
def test_se_kernel_equals_plain_on_the_trained_pico(card):
    """The trained pico's ctx plane on the committed frames: the SE's s8
    output equals the plain version's."""
    model = _trained(card, "mattenet_hd10_pico")
    tp = model.trunk
    x0 = _stem_out(model)
    d2 = Q._qconv(Q._down(x0, tp["d2dn"]), tp["d2b"])
    d3 = Q._qconv(Q._down(d2, tp["d3dn"]), tp["d3b"])
    ctx_f = torch.clamp(Q._conv_i8(d3, tp["ctx"], dilation=3) + d3.to(torch.float32)
                        * Q.ACT_SCALE, 0.0, 6.0).contiguous()  # NHWC, as the ctx conv writes it
    got = TK._se_requant(*TK._launcher(x0), ctx_f, tp["se"])
    want = Q._requant(Q._se(ctx_f, tp["se"]))
    torch.cuda.synchronize()
    assert (got.int() - want.int()).abs().max().item() <= SE_TRAINED_TOL


# every trunk form: (label, weights, head, tolerance)
FORMS = [("pico seeded", "seeded", True, SEEDED_TOL),
         ("pico trained K=4", "mattenet_hd10_mc_pico", True, 0),
         ("nano trained", "mattenet_hd10_nano", True, 0),
         ("femto trained", "mattenet_hd10_femto", True, 0),
         ("u1-out pico seeded", "seeded", False, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("label,weights,head,tol", FORMS, ids=[f[0] for f in FORMS])
def test_trunk_forms_match_plain(card, counting, label, weights, head, tol):
    """Each trunk form, u2red and u1red through the decoder kernel, against
    its plain version (models/quantized.py) on the committed frames' stem
    output (trained) or random s8 (seeded), at the 720p grid: 9 entry-point
    calls with the head (five convs, the SE, two decoder levels, the head),
    8 without; the trunk counts one call, the decoder's own count none."""
    from video_stream_segmenetation_tpu_torch.kernels import decoder_int8 as DK

    if weights == "seeded":
        tp = _seeded(card)
        x0 = torch.as_tensor(np.random.default_rng(1).integers(0, 128, (2, 72, 128, 128),
                                                                dtype=np.int8), device=card)
    else:
        model = _trained(card, weights)
        tp, x0 = model.trunk, _stem_out(model)
    fn, plain = ((TK.fused_nano_trunk_alpha, Q.xla_trunk_alpha) if head
                 else (TK.fused_nano_trunk, Q.xla_trunk))
    n, n_dec = fn.launches, DK.fused_decoder_level.launches
    got = fn(x0, tp)
    want = plain(x0, tp)
    torch.cuda.synchronize()
    assert fn.launches == n + 1 and DK.fused_decoder_level.launches == n_dec
    convs = ["vst_conv_i8"] * 5 + ["vst_se_requant"] + ["vst_decoder_level_i8"] * 2
    assert counting.calls == convs + (["vst_alpha_head_i8"] if head else [])
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (got.float() - want.float()).abs().max().item() <= tol
