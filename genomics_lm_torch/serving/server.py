"""HTTP inference server over the continuous-batching engine.

Twin of ``genomics_lm_tpu/serving/server.py``, with the same routes and
JSON. Stdlib-only (``http.server``): POST /generate submits a request and
returns the completed result, or — with ``"stream": true`` — a chunked
response of one JSON event line per decoded token delta. GET /stats and
GET /health expose the scheduler snapshot.

Threading model: ``ServingEngine`` is single-threaded by design (one
device state, host-side bookkeeping), so ALL engine calls happen on one
scheduler thread. HTTP handler threads communicate with it through
queues only: submissions go in via ``_subs`` and token events come back
per-request via the queue registered at submission time. The scheduler
drains the engine with ``ServingEngine.stream`` (pipelined chunks) and
interleaves new submissions between chunk events. The server runs on the
engine's device.
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from genomics_lm_torch.serving.engine import ServingEngine
from genomics_lm_torch.tokenizers.codon import BOS_ID, decode_ids, to_ids

_MAX_CHUNKS = 10**9  # the server drains indefinitely


class _Submission:
    __slots__ = ("payload", "reply", "events")

    def __init__(self, payload: dict):
        self.payload = payload
        self.reply: queue.Queue = queue.Queue(maxsize=1)
        self.events: queue.Queue = queue.Queue()


class InferenceServer:
    """Owns the engine scheduler thread and the HTTP front-end."""

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 8000):
        self.engine = engine
        self._subs: queue.Queue[_Submission] = queue.Queue()
        self._events: dict[int, queue.Queue] = {}
        self._stop = threading.Event()
        self._sched = threading.Thread(target=self._schedule, daemon=True)
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # chunked TE is 1.1-only

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/health":
                    self._json(200, {"status": "ok"})
                elif self.path == "/stats":
                    self._json(200, server.engine.stats())
                else:
                    self._json(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path != "/generate":
                    self._json(404, {"error": "unknown path"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": f"bad request body: {e}"})
                    return
                sub = _Submission(payload)
                server._subs.put(sub)
                kind, value = sub.reply.get()
                if kind == "error":
                    self._json(400, {"error": value})
                    return
                rid = value
                if payload.get("stream"):
                    self.send_response(200)
                    self.send_header("Content-Type", "application/jsonl")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    for event in iter(sub.events.get, None):
                        _, toks, reason = event
                        line = json.dumps({
                            "request_id": rid, "tokens": toks,
                            "dna": decode_ids(toks),
                            "finish_reason": reason,
                        }).encode() + b"\n"
                        self.wfile.write(
                            f"{len(line):x}\r\n".encode() + line + b"\r\n")
                        self.wfile.flush()
                        if reason:
                            break
                    self.wfile.write(b"0\r\n\r\n")
                else:
                    toks: list[int] = []
                    reason = ""
                    for event in iter(sub.events.get, None):
                        _, delta, reason = event
                        toks.extend(delta)
                        if reason:
                            break
                    self._json(200, {
                        "request_id": rid, "tokens": toks,
                        "dna": decode_ids(toks), "finish_reason": reason,
                    })

            def _json(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)

    # -- scheduler ---------------------------------------------------------
    def _admit_submissions(self) -> None:
        while True:
            try:
                sub = self._subs.get_nowait()
            except queue.Empty:
                return
            p = sub.payload
            try:
                if "prompt" in p:
                    prompt = [int(t) for t in p["prompt"]]
                elif "dna" in p:
                    prompt = [BOS_ID] + to_ids(str(p["dna"]), termination="none")
                else:
                    raise ValueError("request needs 'prompt' (ids) or 'dna'")
                rid = self.engine.submit(
                    prompt,
                    int(p.get("max_new_tokens", 64)),
                    temperature=float(p.get("temperature", 0.0)),
                    stop_ids=tuple(int(t) for t in p.get("stop_ids", ())),
                    top_k=int(p.get("top_k", 0)),
                    top_p=float(p.get("top_p", 0.0)),
                )
            except (ValueError, KeyError, TypeError) as e:
                sub.reply.put(("error", str(e)))
                continue
            self._events[rid] = sub.events
            sub.reply.put(("ok", rid))

    def _schedule(self) -> None:
        while not self._stop.is_set():
            try:
                sub = self._subs.get(timeout=0.05)
                self._subs.put(sub)  # _admit_submissions pulls it back off
            except queue.Empty:
                continue
            self._admit_submissions()
            try:
                for rid, toks, reason in self.engine.stream(_MAX_CHUNKS):
                    q = self._events.get(rid)
                    if q is not None:
                        q.put((rid, list(toks), reason))
                        if reason:
                            del self._events[rid]
                    self._admit_submissions()
                    if self._stop.is_set():
                        return
            except Exception as e:  # noqa: BLE001 — the scheduler must survive
                # fail the requests that were in flight, keep serving: a
                # dead scheduler thread would hang every future request
                # while /health still answered
                import traceback

                traceback.print_exc()
                for rid, q in list(self._events.items()):
                    q.put((rid, [], f"error: {type(e).__name__}: {e}"))
                    del self._events[rid]
                    try:
                        self.engine.cancel(rid)
                    except Exception:  # noqa: BLE001
                        pass

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._sched.start()
        self._http_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()

    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]


__all__ = ["InferenceServer"]
