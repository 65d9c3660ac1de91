"""HTTP and in-process front ends of the serving engines (port of
``paddle_tpu/serving/server.py:80-435``).

Stdlib only (http.server + json), as the reference:

    POST /v1/infer   {"inputs": {name: nested lists}, "deadline_ms"?}
             200 ->  {"outputs": {fetch name: nested lists},
                      "model_version", "latency_ms", "trace_id"} — the
                     micro-batching ServingEngine (serving/engine.py)
             400 bad request (missing or ragged inputs)
             429 ServerOverloadedError (Retry-After)
             503 EngineClosedError (draining / shut down)
             504 DeadlineExceededError
             500 anything else (per request; the engine keeps serving)
    POST /v1/admin/swap {"model_dir": path, "version"?, "reload_config"?,
                         "serving_flags"?}
                     the replica side of a rolling swap: verify the
                     dir's COMMIT manifest when it has one, build the new
                     predictor on the serving one's device, warm it on
                     every bucket, flip (ServingEngine.swap_predictor);
                     reload_config flips a ServingConfig built from the
                     flags, serving_flags ({flag: value}) over them;
                     200 {"status": "ok", "model_version",
                     "warmup_compiles"}, 500 with the old model serving
    POST /v1/generate {"prompt_ids": [ints], "max_new_tokens"?,
                      "temperature"?, "seed"?, "deadline_ms"?,
                      "stop_at_eos"?, "request_id"?, "prior_tokens"?,
                      "rng_state"?}
             200 ->  {"tokens": [ints], "num_tokens", "ttft_ms",
                      "model_version", "latency_ms"} (+ "request_id" when
                     the body or an X-Request-Id header names one,
                     "resumed" for a resumed session) — the generative
                     DecodeEngine (serving/decode.py); 429 carries
                     error_type "KVCacheExhaustedError" when the pages
                     can never fit
    POST /v1/prefill {"prompt": [ints]} -> the KV page shipment
                     (application/octet-stream, serving/disagg.py), with
                     the same error codes
    GET  /healthz    READINESS (serving/health.py): 200 {"status": "ok"}
                     only when the replica can serve now, else 503 with
                     "starting" / "swapping" / "draining" / "stopped"
    GET  /livez      LIVENESS: 200 in any state but stopped, else 503
    GET  /v1/stats   ServingEngine.stats() (empty without one), plus
                     {"decode": DecodeEngine.stats()} with a decode engine
    GET  /metrics    Prometheus text of the live registry

A route whose engine is not attached answers 404. Tracing: each
/v1/infer, /v1/generate and /v1/prefill request opens a root span
(``serving.http_request``, core/trace.py); an ``X-Request-Id`` header
forces sampling and pins the trace id, and a sampled request answers
with an ``X-Trace-Id`` header.

``serve(model_dir)`` wires an inference-model dir -> predictor -> warmed
ServingEngine -> started server in one call, ``serve_decode(model_dir)``
a decoder-LM servable dir -> warmed DecodeEngine -> started server;
``LocalClient`` is the in-process twin of /v1/infer. ``device=None``
means ``cuda:0`` (raising without CUDA); tests pass ``device="cpu"``.

The SLO watchdog (``core/incidents.py``): ``start()`` arms it (under
FLAGS_slo_watchdog 'auto') and ``shutdown()`` disarms it; the engines'
loops evaluate the rules through ``incidents.tick()``, and ``/v1/stats``
carries its ``health`` section. The reference's ``serve`` also starts
the watchdog's own thread, which evaluates while the replica idles; here
evaluation rides the engines' ticks.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from ..core import flags as _flags
from ..core import incidents, telemetry, trace
from .admission import (DeadlineExceededError, EngineClosedError,
                        KVCacheExhaustedError, ServerOverloadedError)
from .engine import ServingConfig, ServingEngine


class LocalClient:
    """In-process client: the /v1/infer request and response shape
    (outputs keyed by fetch name) without the socket."""

    def __init__(self, engine: ServingEngine):
        self.engine = engine

    def infer(self, inputs: Dict[str, Any],
              deadline_ms: Optional[float] = None,
              timeout: Optional[float] = None) -> Dict[str, np.ndarray]:
        outs = self.engine.infer(inputs, deadline_ms=deadline_ms,
                                 timeout=timeout)
        return dict(zip(self.engine.fetch_names, outs))


class BackloggedHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog of 128 connections. The
    stdlib's default of 5 drops the connects of a burst of clients beyond
    it, and each retries its SYN after a second: 64 requests sent at once
    put that second into the tail of the request wall."""

    daemon_threads = True
    request_queue_size = 128


def _coerce_inputs(engine: ServingEngine,
                   raw: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """JSON lists -> arrays of the feeds' declared dtypes."""
    specs = engine.predictor.feed_specs()
    return {name: np.asarray(value, dtype=np.dtype(
                specs.get(name, ((), "float32"))[1]))
            for name, value in raw.items()}


class _Handler(BaseHTTPRequestHandler):
    # the engines are attached to the server object by ServingHTTPServer
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # no per-request stderr lines
        pass

    def _reply(self, code: int, payload: Dict[str, Any],
               headers: Optional[Dict[str, str]] = None):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length") or 0)
        doc = json.loads(self.rfile.read(length) or b"{}")
        if not isinstance(doc, dict):
            raise TypeError(f"expected a JSON object, got "
                            f"{type(doc).__name__}")
        return doc

    def do_GET(self):
        engine = self.server.engine or self.server.decode_engine
        if self.path == "/healthz":
            snap = engine.health.snapshot(queue_depth=engine.queue.depth(),
                                          model_version=engine.version)
            self._reply(200 if snap["ready"] else 503, snap)
        elif self.path == "/livez":
            alive = engine.health.is_alive()
            self._reply(200 if alive else 503,
                        {"status": "alive" if alive else "stopped"})
        elif self.path == "/v1/stats":
            stats = self.server.engine.stats() \
                if self.server.engine is not None else {}
            if self.server.decode_engine is not None:
                stats["decode"] = self.server.decode_engine.stats()
            stats["health"] = incidents.health()
            self._reply(200, stats)
        elif self.path == "/metrics":
            body = telemetry.prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def _traced(self, handler):
        """Run ``handler(headers)`` under the request's root span."""
        rid = self.headers.get("X-Request-Id")
        headers: Dict[str, str] = {}
        with trace.root_span("serving.http_request", trace_id=rid,
                             force=bool(rid), path=self.path) as tctx:
            if tctx is not None:
                headers["X-Trace-Id"] = tctx.trace_id
            handler(headers)

    def _reply_error(self, e: BaseException, headers: Dict[str, str]):
        """The reference's status code and error_type for each typed
        failure."""
        if isinstance(e, ValueError):
            self._reply(400, {"error": str(e)}, headers)
        elif isinstance(e, KVCacheExhaustedError):
            # typed would-OOM refusal: shrink, or retry on a bigger pool
            self._reply(429, {"error": str(e),
                              "error_type": "KVCacheExhaustedError"},
                        headers)
        elif isinstance(e, ServerOverloadedError):
            self._reply(429, {"error": str(e)},
                        dict(headers, **{"Retry-After": "0.05"}))
        elif isinstance(e, EngineClosedError):
            self._reply(503, {"error": str(e)}, headers)
        elif isinstance(e, DeadlineExceededError):
            self._reply(504, {"error": str(e)}, headers)
        else:
            self._reply(500, {"error": f"{type(e).__name__}: {e}"},
                        headers)

    def _handle_infer(self, headers: Dict[str, str]):
        engine = self.server.engine
        t0 = time.perf_counter()
        try:
            doc = self._read_json()
            feeds = _coerce_inputs(engine, doc.get("inputs") or {})
        except (ValueError, TypeError) as e:
            self._reply(400, {"error": f"bad request body: {e}"}, headers)
            return
        try:
            req = engine.submit(feeds, deadline_ms=doc.get("deadline_ms"))
            outs = req.result()
        except Exception as e:
            self._reply_error(e, headers)
            return
        self._reply(200, {
            "outputs": {n: np.asarray(o).tolist()
                        for n, o in zip(engine.fetch_names, outs)},
            "model_version": req.served_version,
            "latency_ms": round((time.perf_counter() - t0) * 1e3, 3),
            "trace_id": headers.get("X-Trace-Id")}, headers)

    def _handle_swap(self):
        engine = self.server.engine
        try:
            doc = self._read_json()
            model_dir = doc["model_dir"]
        except (ValueError, TypeError, KeyError) as e:
            self._reply(400, {"error": f"bad swap request: {e!r}"})
            return
        try:
            from .. import checkpoint as _ckpt
            from ..inference import AnalysisConfig, create_predictor

            version = doc.get("version")
            if os.path.exists(os.path.join(model_dir, _ckpt.MANIFEST_NAME)):
                manifest = _ckpt.verify_model_dir(model_dir)
                if version is None:
                    version = manifest.get("version")
            predictor = create_predictor(AnalysisConfig(model_dir),
                                         device=engine.predictor.device)
            # reload_config: a ServingConfig from the current flags,
            # overridden by the controller's serving_flags when it sends
            # them (cluster.retune_replica), flipped with the predictor
            config = None
            if doc.get("reload_config"):
                with _flags.overrides(doc.get("serving_flags") or {}):
                    config = ServingConfig()
            fresh = engine.swap_predictor(predictor, version=version,
                                          config=config)
        except Exception as e:   # the old predictor is still live
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._reply(200, {"status": "ok", "model_version": engine.version,
                          "warmup_compiles": fresh})

    def _handle_generate(self, headers: Dict[str, str]):
        de = self.server.decode_engine
        try:
            doc = self._read_json()
            prompt = doc["prompt_ids"]
        except (ValueError, TypeError, KeyError) as e:
            self._reply(400, {"error": f"bad generate request: {e!r}"},
                        headers)
            return
        t0 = time.perf_counter()
        # session identity: the body's request_id, else the X-Request-Id
        # the router forwards; either opts the generation into journaling
        request_id = (doc.get("request_id")
                      or self.headers.get("X-Request-Id"))
        try:
            req = de.submit(prompt,
                            max_new_tokens=doc.get("max_new_tokens"),
                            deadline_ms=doc.get("deadline_ms"),
                            temperature=float(doc.get("temperature", 0.0)),
                            seed=doc.get("seed"),
                            stop_at_eos=bool(doc.get("stop_at_eos", True)),
                            request_id=request_id,
                            prior_tokens=doc.get("prior_tokens"),
                            rng_state=doc.get("rng_state"))
            tokens = req.result()
        except Exception as e:
            self._reply_error(e, headers)
            return
        payload = {
            "tokens": np.asarray(tokens).tolist(),
            "num_tokens": int(np.asarray(tokens).size),
            "ttft_ms": round(req.ttft_ms, 3)
            if req.ttft_ms is not None else None,
            "model_version": de.version,
            "latency_ms": round((time.perf_counter() - t0) * 1e3, 3)}
        if request_id is not None:
            payload["request_id"] = request_id
        if doc.get("prior_tokens"):
            # a resumed session: the tokens are the TAIL only; the router
            # joins them to the journaled prefix
            payload["resumed"] = True
        self._reply(200, payload, headers)

    def _handle_prefill(self, headers: Dict[str, str]):
        de = self.server.decode_engine
        try:
            doc = self._read_json()
            prompt = doc["prompt"]
        except (ValueError, TypeError, KeyError) as e:
            self._reply(400, {"error": f"bad prefill request: {e!r}"},
                        headers)
            return
        try:
            blob = de.submit_prefill(
                prompt, deadline_ms=doc.get("deadline_ms")).result()
        except Exception as e:
            self._reply_error(e, headers)
            return
        body = bytes(blob)
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        srv = self.server
        if self.path == "/v1/infer" and srv.engine is not None:
            self._traced(self._handle_infer)
        elif self.path == "/v1/admin/swap" and srv.engine is not None:
            self._handle_swap()
        elif self.path == "/v1/generate" and srv.decode_engine is not None:
            self._traced(self._handle_generate)
        elif self.path == "/v1/prefill" and srv.decode_engine is not None:
            self._traced(self._handle_prefill)
        elif self.path in ("/v1/infer", "/v1/admin/swap"):
            self._reply(404, {"error": "no micro-batching engine "
                                       "attached — this replica serves "
                                       "/v1/generate only"})
        elif self.path in ("/v1/generate", "/v1/prefill"):
            self._reply(404, {"error": "no decode engine attached — "
                                       "this replica serves /v1/infer "
                                       "only"})
        else:
            self._reply(404, {"error": f"no route {self.path}"})


class ServingHTTPServer:
    """Bound-but-not-yet-serving HTTP wrapper around a ServingEngine
    and/or a DecodeEngine; start()/shutdown() own the acceptor thread.
    port=0 binds an ephemeral port."""

    def __init__(self, engine: Optional[ServingEngine] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 decode_engine=None):
        if engine is None and decode_engine is None:
            raise ValueError("ServingHTTPServer needs an engine and/or a "
                             "decode_engine")
        self.engine = engine
        self.decode_engine = decode_engine
        self._httpd = BackloggedHTTPServer((host, port), _Handler)
        self._httpd.engine = engine
        self._httpd.decode_engine = decode_engine
        self._thread: Optional[threading.Thread] = None

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServingHTTPServer":
        if self._thread is None:
            incidents.arm()
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="pt-torch-serving-http", daemon=True)
            self._thread.start()
        return self

    def shutdown(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        incidents.disarm()


def serve(model_dir: str, host: str = "127.0.0.1", port: int = 0,
          config: Optional[ServingConfig] = None, warmup: bool = True,
          device=None) -> ServingHTTPServer:
    """Inference-model dir -> predictor on ``device`` (None: cuda:0) ->
    warmed ServingEngine -> started HTTP server (POST /v1/infer)."""
    from ..inference import AnalysisConfig, create_predictor

    predictor = create_predictor(AnalysisConfig(model_dir), device=device)
    engine = ServingEngine(predictor, config=config)
    engine.start(warmup=warmup)
    return ServingHTTPServer(engine, host=host, port=port).start()


def serve_decode(model_dir: str, host: str = "127.0.0.1", port: int = 0,
                 config=None, warmup: bool = True,
                 device=None) -> ServingHTTPServer:
    """Decoder-LM servable dir -> started generative HTTP server (POST
    /v1/generate) over a DecodeEngine on ``device`` (None: cuda:0)."""
    from .decode import decode_engine_from_dir

    de = decode_engine_from_dir(model_dir, config=config, device=device)
    de.start(warmup=warmup)
    return ServingHTTPServer(None, host=host, port=port,
                             decode_engine=de).start()
