"""Minimal HTTP control/observability endpoint for the engine (port of the
reference's ``service/server.py``).

The serving-side equivalent of the reference's L4 surface: the perf
overlay (main.ts:96-105) becomes GET /stats; the settings panel's slider
writes (script.ts:20-25) become POST /streams/<id>/knobs; the privacy
selector (script.ts:82-111 -> customization.ts:33) becomes POST
/streams/<id>/privacy; reset (script.ts:43-46) POST /streams/<id>/reset.

Stdlib http.server only (no external deps); JSON in/out; runs on a
daemon thread next to the scheduler.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_KNOB_KEYS = {
    "ema",
    "ema_adapt",
    "noise_cutoff",
    "high_threshold",
    "gamma",
    "use_bilateral",
    "sigma_spatial",
    "sigma_range",
}


def make_handler(engine, renderers=None):
    """renderers: optional dict slot -> BackgroundRenderer for privacy/
    content updates."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            if self.path == "/stats":
                return self._json(200, engine.stats())
            if self.path == "/healthz":
                state = engine.health.state.value
                return self._json(200 if state == "ok" else 503, {"state": state})
            if self.path == "/streams":
                return self._json(
                    200,
                    {
                        "active": [int(i) for i in range(engine.num_streams)
                                   if engine.active[i]],
                        "capacity": engine.num_streams,
                        "streams": engine.stream_stats(),
                    },
                )
            return self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                m = re.fullmatch(r"/streams/(\d+)/(\w+)", self.path)
                if self.path == "/streams":
                    slot = engine.admit()
                    return self._json(200, {"slot": slot})
                if not m:
                    return self._json(404, {"error": "not found"})
                slot, action = int(m.group(1)), m.group(2)
                if slot >= engine.num_streams:
                    return self._json(404, {"error": "no such stream"})
                if action == "knobs":
                    body = self._body()
                    unknown = set(body) - _KNOB_KEYS
                    if unknown:
                        return self._json(400, {"error": f"unknown knobs: {sorted(unknown)}"})
                    engine.set_knobs(slot, **body)
                    return self._json(200, {"ok": True})
                if action == "reset":
                    engine.reset_knobs(slot)
                    return self._json(200, {"ok": True})
                if action == "evict":
                    engine.evict(slot)
                    return self._json(200, {"ok": True})
                if action == "privacy":
                    level = self._body().get("level")
                    if renderers and slot in renderers:
                        renderers[slot].set_privacy(level)
                        engine.set_background(slot, renderers[slot].render())
                        return self._json(200, {"ok": True, "level": level})
                    return self._json(409, {"error": "no renderer for stream"})
                if action == "background":
                    # the settings panel's background selector
                    # (script.ts:82-111): solid color, template re-render,
                    # or raw image rows
                    body = self._body()
                    if "color" in body:
                        r, g, b = (int(c) for c in body["color"])
                        fh, fw = engine.statics.frame_hw
                        img = np.broadcast_to(
                            np.asarray([r, g, b], np.uint8), (fh, fw, 3)
                        )
                        engine.set_background(slot, img)
                        return self._json(200, {"ok": True})
                    if "template_id" in body and renderers and slot in renderers:
                        from video_stream_segmenetation_tpu_torch import background as _bgm

                        tid = body["template_id"]
                        templates = _bgm.sample_app_data().templates
                        if tid not in templates:
                            return self._json(
                                400, {"error": f"unknown template {tid!r}"}
                            )
                        renderers[slot].set_template(templates[tid])
                        engine.set_background(slot, renderers[slot].render())
                        return self._json(200, {"ok": True})
                    if "image" in body:  # nested lists, uint8 RGB
                        engine.set_background(
                            slot, np.asarray(body["image"], np.uint8)
                        )
                        return self._json(200, {"ok": True})
                    return self._json(400, {"error": "need color/template_id/image"})
                return self._json(404, {"error": "unknown action"})
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            except RuntimeError as e:
                return self._json(409, {"error": str(e)})

    return Handler


class ControlServer:
    def __init__(self, engine, host="127.0.0.1", port=0, renderers=None):
        self._httpd = ThreadingHTTPServer(
            (host, port), make_handler(engine, renderers)
        )
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=3)
