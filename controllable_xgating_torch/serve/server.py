"""Minimal production HTTP front-end for the ServingEngine (stdlib-only).

Counterpart of `controllable_xgating_tpu/serve/server.py`, on the port's
engine and its numpy feature store.

Endpoints (JSON in/out):

  POST /caption   {"video": "<id>"}                      — by corpus video id
                  {"app": [[...]], "motion": [[...]],    — raw features
                   "nframes": 12, "pos_tags": "DT NN VBZ"}
                  -> {"caption", "pos_sequence", "controlled", "score",
                      "latency_ms", "batch_size"[, "nbest": [{caption,
                      score}...] when the engine runs with nbest>0]}
  GET  /healthz   -> {"ok": true}
  GET  /stats     -> ServingEngine.stats()
  GET  /metrics   -> the engine's counters as Prometheus text

A ThreadingHTTPServer handles each connection on its own thread, so
concurrent clients' requests coalesce inside the engine's micro-batching
window — the server IS the load generator the engine was built for.
No third-party web framework is used: stdlib http is sufficient for a
JSON API at these request sizes.
"""

from __future__ import annotations

import json
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from controllable_xgating_torch.data.features import FeatureStore
from controllable_xgating_torch.serve.engine import (
    EngineOverloaded,
    ServingEngine,
)


def make_handler(engine: ServingEngine, store: Optional[FeatureStore],
                 video_ids: Optional[list[str]]):
    id_to_idx = (
        {v: i for i, v in enumerate(video_ids)} if video_ids else {}
    )

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet by default; stats() has counters
            pass

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/stats":
                self._send(200, engine.stats())
            elif self.path == "/metrics":
                # Prometheus text exposition of the engine counters
                s = engine.stats()
                lines = []
                for key, mtype in (
                    ("requests", "counter"), ("batches", "counter"),
                    ("rejected", "counter"), ("cancelled", "counter"),
                    ("deadline_expired", "counter"),
                    ("queue_depth", "gauge"),
                    ("batches_in_flight", "gauge"),
                    ("mean_batch_occupancy", "gauge"),
                    ("latency_ms_p50", "gauge"), ("latency_ms_p99", "gauge"),
                ):
                    val = s.get(key)
                    if val is None:
                        continue
                    name = f"cxg_serve_{key}"
                    lines.append(f"# TYPE {name} {mtype}")
                    lines.append(f"{name} {float(val)}")
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/caption":
                # drain the body first: under HTTP/1.1 keep-alive an unread
                # body would be parsed as the NEXT request on this socket
                length = int(self.headers.get("Content-Length", 0) or 0)
                while length > 0:
                    chunk = self.rfile.read(min(length, 1 << 16))
                    if not chunk:
                        break
                    length -= len(chunk)
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if "video" in req:
                    if store is None:
                        raise ValueError("server started without a corpus")
                    vid = req["video"]
                    if vid not in id_to_idx:
                        raise ValueError(f"unknown video id {vid!r}")
                    idx = np.array([id_to_idx[vid]])
                    app, motion = store.get_batch(idx)
                    app, motion = app[0], motion[0]
                    mask = store.frame_mask(idx)
                    nframes = (
                        int(mask[0].sum()) if mask is not None else None
                    )
                else:
                    app = np.asarray(req["app"], np.float32)
                    motion = np.asarray(req["motion"], np.float32)
                    nframes = req.get("nframes")
                tags = req.get("pos_tags")
                if isinstance(tags, str):
                    tags = tags.split()
                deadline_ms = req.get("deadline_ms")
                timeout = (float(deadline_ms) / 1e3
                           if deadline_ms is not None else None)
                if timeout is not None and timeout <= 0:
                    # a deadline-propagating client's budget already ran
                    # out (e.g. deadline_ms: 0) — that is the retryable
                    # deadline-exceeded outcome, not a malformed request;
                    # engine.caption(timeout<=0) would raise ValueError
                    self._send(503, {"error": "deadline exceeded",
                                     "retry": True})
                    return
                res = engine.caption(app, motion, nframes, tags,
                                     timeout=timeout)
                self._send(200, {
                    "caption": res.caption,
                    "pos_sequence": res.pos_sequence,
                    "controlled": res.controlled,
                    "score": res.score,
                    "latency_ms": res.latency_ms,
                    "batch_size": res.batch_size,
                    **({"nbest": [
                        {"caption": c, "score": s} for c, s in res.nbest
                    ]} if res.nbest else {}),
                })
            except EngineOverloaded as e:
                self._send(503, {"error": str(e), "retry": True})
            # concurrent.futures.TimeoutError is a distinct class on
            # py3.10 (aliased to the builtin only from 3.11)
            except (TimeoutError, FutureTimeoutError):
                # deadline passed while the request was queued or running;
                # engine.caption() already cancelled the queued row
                self._send(503, {"error": "deadline exceeded",
                                 "retry": True})
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — report, keep serving
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class _Server(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 resets the
    # connections of clients beyond the fifth that connect at once
    request_queue_size = 1024


def serve(engine: ServingEngine, host: str, port: int,
          store: Optional[FeatureStore] = None,
          video_ids: Optional[list[str]] = None) -> ThreadingHTTPServer:
    """Bind and return the server (caller runs serve_forever / shutdown)."""
    handler = make_handler(engine, store, video_ids)
    httpd = _Server((host, port), handler)
    httpd.daemon_threads = True
    return httpd
