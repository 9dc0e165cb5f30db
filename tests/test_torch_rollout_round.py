"""The port's round rollout (runtime/rollout.py::make_round_rollout: n whole
rounds of the production rotation, rows written in place) against the
reference's on the CPU, n=3 rounds in groups [3, 1], the reference's
rollout jitted with its Pallas kernels in interpret mode
(tests/torch_rollout_engines.py's fast_int8_pico on the fast route, face
off, S=4; the natural engine's round: tests/test_torch_rollout.py); and
against the port's own sequential round steps, bit for bit.

Tolerances as tests/test_torch_rollout.py's: the per-step bars of the
port's step-parity tests times n (the refined alpha 4e-3 a round on
pico's bf16, 5e-3 on the natural layout's f32; new_prev 2e-5 a round,
1e-3 natural; a composited frame value one u8 step a round, modulo 256),
and for the 'reduce' sums those times the values a stream has (the frame
at most 1 % of its values a step apart).  The face clock is equal.
"""

import numpy as np
import pytest
import torch

from tests import torch_rollout_engines as RE
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu_torch.runtime import make_round_rollout
from video_stream_segmenetation_tpu_torch.runtime import rollout as TR
from video_stream_segmenetation_tpu_torch.runtime.pipeline import make_round_step
from video_stream_segmenetation_tpu_torch.runtime.state import map_state

N = RE.N
SIZES, TICK = RE.SIZES, RE.TICK
CASES = [("pico_fast", "buffer", "xor"), ("pico_fast", "reduce", "weights")]


@pytest.fixture(scope="module")
def pairs():
    return {}


@pytest.mark.parametrize("kind,acc,perturb", CASES)
def test_round_rollout_matches_reference(pairs, kind, acc, perturb):
    RE.assert_round_rollout_matches(RE.pair(pairs, kind), kind, acc, perturb)


def test_round_rollout_equals_sequential_rounds(pairs):
    """n chained rounds are the port's own n sequential round steps on the
    tagged frames at the advancing clock, bit for bit."""
    _, te = RE.pair(pairs, "pico_fast")
    groups = RE.groups(te, RE.frames_for("pico_fast", 2))
    st_r = map_state(torch.clone, te.state)
    last_r, now0, mi = RE.clock()
    _, last_r, accs = make_round_rollout(te.model, te.statics, SIZES, te.face_models)(
        st_r, groups, te.backgrounds, te.knobs, last_r, now0, mi, N)
    rstep = make_round_step(te.model, te.statics, SIZES, te.face_models)
    st = map_state(torch.clone, te.state)
    last = RE.clock()[0]
    exp = None
    for i in range(N):
        now = now0 + float(np.float32(i) * np.float32(TICK))
        fl = groups if i == 0 else [TR._perturb(f, i) for f in groups]
        st, last, outs = rstep(st, fl, te.backgrounds, te.knobs, last, now, mi)
        got = [(o["frame"], o["alpha"]) for o in outs]
        exp = got if exp is None else [(a + f, b + al) for (a, b), (f, al) in zip(exp, got)]
    for (af, aa), (ef, ea) in zip(accs, exp):
        assert torch.equal(af, ef) and torch.equal(aa, ea)
    assert torch.equal(st_r.prev_alpha, st.prev_alpha) and torch.equal(last_r, last)
