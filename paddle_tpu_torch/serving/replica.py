"""Replica runner: one generative serving process of a cluster (port of
``paddle_tpu/serving/replica.py``'s decode replica).

    python -m paddle_tpu_torch.serving.replica --decode-model-dir DIR \
        [--role unified|prefill|decode] [--prefill-urls URL[,URL]] \
        [--prefix-cache] [--journal-url URL] [--device cuda|cpu] \
        [--host H] [--port P]

builds a DecodeEngine over a decoder-LM servable dir on ``--device``
(default cuda, which raises without CUDA), binds the HTTP server first so
a controller can watch ``/healthz`` go from ``starting`` to ``ok`` while
the engine warms up, and serves until told to stop. On the card the
engine loads the kernel libraries that ``kernels/_build.py`` built into
``build/torch_kernels/``, building any that is missing.

The process announces itself on stdout with one machine-readable line::

    PT_REPLICA_READY {"url": ..., "port": ..., "pid": ..., "version": ...,
                      "model_dir": ..., "decode": true, "role": ...}

which is the only contract serving/cluster.py parses. SIGTERM/SIGINT
drain the queue and exit 0; SIGKILL is the crash the router's failover
and session journal exist for. The process inherits FLAGS_* and
PT_FAULT_SPEC / PT_FAULT_SEED from its environment, so a chaos run arms
``decode.step`` / ``decode.kv_alloc`` in every replica without code
changes.

Not in the port yet: the predictor replica (``--model-root`` /
``--model-dir``, ``run_replica``; ROADMAP A5b) and the JSONL run log
(``--telemetry-log``; ROADMAP A10): both options are refused with a
message that names their item.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading


def _journal_sink(url: str):
    """A journal sink that POSTs each batch of session records to the
    router (``/v1/session/journal``). Short timeout: a slow router must
    never stall the decode step; the engine counts a failure in
    ``session.journal_errors``."""
    import http.client
    import urllib.parse

    u = urllib.parse.urlparse(url)
    path = u.path or "/v1/session/journal"

    def sink(records):
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=2.0)
        try:
            conn.request("POST", path,
                         body=json.dumps({"records": records}).encode(),
                         headers={"Content-Type": "application/json"})
            conn.getresponse().read()
        finally:
            conn.close()

    return sink


def run_decode_replica(args) -> int:
    """One generative replica: DecodeEngine over a decoder-LM servable dir
    behind the HTTP server, with the PT_REPLICA_READY / SIGTERM-drain
    contract."""
    from .decode import DecodeConfig, decode_engine_from_dir
    from .server import ServingHTTPServer

    config = None
    if args.role != "unified" or args.prefill_urls or args.prefix_cache:
        config = DecodeConfig(role=args.role,
                              prefill_urls=args.prefill_urls,
                              prefix_cache=args.prefix_cache or None)
    engine = decode_engine_from_dir(args.decode_model_dir, config=config,
                                    device=args.device)
    if args.journal_url:
        engine.journal_sink = _journal_sink(args.journal_url)
    server = ServingHTTPServer(None, host=args.host, port=args.port,
                               decode_engine=engine).start()
    print("PT_REPLICA_READY " + json.dumps(
        {"url": server.url, "port": server.port, "pid": os.getpid(),
         "version": engine.version, "model_dir": args.decode_model_dir,
         "decode": True, "role": engine.config.role,
         "device": str(engine.device)}), flush=True)

    stop = threading.Event()

    def _graceful(_sig, _frm):
        stop.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    engine.start(warmup=True)
    try:
        stop.wait()
    finally:
        engine.close(drain=True, timeout=30)
        server.shutdown()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="one generative serving replica process "
                    "(serving/cluster.py launches these; standalone use "
                    "works too)")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--decode-model-dir",
                     help="decoder-LM servable dir (save_decoder_lm "
                          "layout): POST /v1/generate through the "
                          "continuous-batching decode engine")
    src.add_argument("--model-root", help=argparse.SUPPRESS)
    src.add_argument("--model-dir", help=argparse.SUPPRESS)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 binds an ephemeral port (announced on stdout)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine: 'cuda' (cuda:0, "
                         "the default; raises without CUDA) or 'cpu' "
                         "(the kernels' plain versions)")
    ap.add_argument("--role", default="unified",
                    choices=("unified", "prefill", "decode"),
                    help="disaggregated-serving tier (serving/disagg.py): "
                         "'prefill' ships KV pages over POST /v1/prefill, "
                         "'decode' installs them, 'unified' does both "
                         "locally")
    ap.add_argument("--prefill-urls", default="",
                    help="comma-separated prefill-tier URLs (or the "
                         "router's) a decode-role replica fetches KV "
                         "shipments from")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable the content-addressed prefix store "
                         "(serving/prefix_store.py)")
    ap.add_argument("--journal-url", default="",
                    help="router endpoint the replica posts session "
                         "journals to (ROUTER_URL/v1/session/journal); "
                         "empty disables journaling")
    ap.add_argument("--telemetry-log", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.model_root or args.model_dir:
        ap.error("--model-root / --model-dir serve the micro-batching "
                 "predictor replica, which is not in the port yet "
                 "(ROADMAP A5b)")
    if args.telemetry_log:
        ap.error("--telemetry-log: the JSONL run-log sink is not in the "
                 "port yet (ROADMAP A10)")
    return run_decode_replica(args)


if __name__ == "__main__":
    sys.exit(main())
