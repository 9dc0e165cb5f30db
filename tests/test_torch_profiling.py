"""utils/profiling.py: the timers' keys and counts on the host clock, the
Chrome trace written on the CPU, and the refusal of ``device='cuda'``
where there is no card (a measurement that finds no card must not fall
back to the CPU)."""

import json
import os

import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu_torch import utils
from video_stream_segmenetation_tpu_torch.utils import profiling


def test_time_fn_keys_and_counts():
    calls = []
    res = utils.time_fn(lambda x, k=0: calls.append((x, k)), 3, warmup=2, iters=5,
                        device="cpu", k=1)
    assert set(res) == {"mean_ms", "min_ms", "p50_ms", "samples"}
    assert len(res["samples"]) == 5 and len(calls) == 7 and calls[0] == (3, 1)
    assert res["min_ms"] <= res["p50_ms"] and res["min_ms"] <= res["mean_ms"]
    assert all(t >= 0 for t in res["samples"])


def test_device_timer_writes_its_key():
    out = {}
    with utils.device_timer(out, "span", device="cpu"):
        torch.ones(4).sum()
    assert set(out) == {"span"} and out["span"] >= 0


def test_event_ms_returns_the_last_result():
    n = []
    ms, out = profiling.event_ms(lambda: n.append(1) or len(n), iters=3, device="cpu")
    assert ms >= 0 and out == 4 and len(n) == 4  # one warm-up call and three


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "tr")
    with utils.trace(logdir, device="cpu") as d:
        assert d == logdir
        torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    files = [f for f in os.listdir(logdir) if f.endswith(".json")]
    assert len(files) == 1
    with open(os.path.join(logdir, files[0])) as fh:
        trace = json.load(fh)
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        utils.time_fn(lambda: None, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        with utils.device_timer({}, "x"):
            pass
    with pytest.raises(RuntimeError, match="is_available"):
        with utils.trace(str(tmp_path / "tr")):
            pass
    with pytest.raises(RuntimeError, match="is_available"):
        profiling.event_ms(lambda: None)
