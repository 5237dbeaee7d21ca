"""Serving CLI: batch mode (JSON file in / out) or a local HTTP endpoint.

Port of echoscene_tpu/serve/cli.py with the same flags and defaults, plus
`--device` (default `cuda`).  Usage:
  # batch: read a JSON list of requests, write a JSON list of results
  python -m echoscene_torch.serve.cli --exp EXP --epoch N \
      --requests in.json --out out.json [--device cpu]

  # online: POST a JSON list of requests to http://HOST:PORT/generate
  python -m echoscene_torch.serve.cli --exp EXP --port 8765 [--device cpu]

Request format:
  {"objects": ["bed", "wardrobe"], "triples": [[0, "left", 1]], "id": "x"}

Interactive manipulation (sample_with_changes / _additions): name a previous
response by id and apply a change; untouched objects keep their previous
boxes / shapes (keep mask):
  {"previous": "x", "id": "x2",
   "manipulation": {"type": "addition", "object": "lamp",
                    "triples": [[-1, "left", 0]]}}      # -1 = the new node
  {"previous": "x", "id": "x3",
   "manipulation": {"type": "relationship", "index": 0,
                    "predicate": "right"}}

`--dp_devices N` spreads the request groups of a call over `cuda:0 ..
cuda:N-1`, one group a card at a time (parallel/dp.py `DPSampler`; the
micro-batcher then takes up to N buckets a call), and raises when fewer
cards are visible.  `--sample_dtype int8` serves with int8 W8A8
shape-UNet convolutions (nn/quant.py; bench.py's fast profile with
`--layout_sampler dpmpp --layout_steps 50 --shape_sampler dpmpp
--shape_steps 20`); it runs on one card or more, not under tensor
parallelism.
"""
from __future__ import annotations

import argparse
import json
import threading

from .service import service_from_experiment


def run_http(service, host: str, port: int, batch_window_ms: float = 0.0):
    """Serve POST /generate (and GET /stats) until the process ends."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    lock = threading.Lock()   # one generation call at a time (one card)

    # batch_window_ms > 0: concurrent clients' requests coalesce into shared
    # padded generation calls (serve/batcher.py) instead of queueing one by
    # one behind the lock
    batcher = None
    if batch_window_ms > 0:
        from .batcher import MicroBatcher
        batcher = MicroBatcher(service, max_wait_ms=batch_window_ms)

    MAX_BODY = 64 * 1024 * 1024   # reject absurd Content-Length up front

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/") != "/stats":
                self.send_error(404)
                return
            body = json.dumps(batcher.stats() if batcher else
                              {"batching": "off"}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path.rstrip("/") not in ("", "/generate", "/v1/generate"):
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > MAX_BODY:
                    raise ValueError(
                        f"request body {length} bytes exceeds {MAX_BODY}")
                payload = json.loads(self.rfile.read(length) or b"[]")
                if isinstance(payload, dict):
                    payload = [payload]
                if batcher is not None:
                    # bounded wait: an unbounded Future.result would hang
                    # this client thread forever if the batcher worker died
                    results = batcher.generate(payload, timeout=1800.0)
                else:
                    with lock:
                        results = service.generate(payload)
                body = json.dumps({"results": results}).encode()
                self.send_response(200)
            except Exception as e:  # the HTTP boundary: report to the client
                body = json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
                # client errors (malformed / oversized requests) -> 400;
                # anything else is a server fault -> 500
                is_client = isinstance(
                    e, (ValueError, KeyError, IndexError, TypeError,
                        json.JSONDecodeError))
                self.send_response(400 if is_client else 500)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            print(f"[serve] {self.address_string()} {fmt % args}")

    server = ThreadingHTTPServer((host, port), Handler)
    print(f"[serve] listening on http://{host}:{port}/generate")
    server.serve_forever()


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--exp", required=True)
    p.add_argument("--dataset", default=None)
    p.add_argument("--epoch", type=int, default=None,
                   help="checkpoint epoch to serve; defaults to the latest "
                        "checkpoint in <exp>/checkpoint (error if none). "
                        "Pass -1 explicitly to serve uninitialized params.")
    p.add_argument("--gen_shape", action="store_true")
    p.add_argument("--meshes", action="store_true",
                   help="return marching-tetrahedra meshes instead of SDFs")
    p.add_argument("--max_nodes", type=int, default=48)
    p.add_argument("--max_triples", type=int, default=160)
    p.add_argument("--max_scenes", type=int, default=8)
    p.add_argument("--sample_dtype", default=None,
                   choices=["float32", "bfloat16", "int8"])
    p.add_argument("--layout_sampler", default=None,
                   choices=["ddpm", "ddim", "dpmpp"])
    p.add_argument("--layout_steps", type=int, default=0)
    p.add_argument("--shape_sampler", default=None, choices=["ddim", "dpmpp"])
    p.add_argument("--shape_steps", type=int, default=0)
    p.add_argument("--requests", default=None, help="JSON file (batch mode)")
    p.add_argument("--out", default=None, help="output JSON (batch mode)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0, help="HTTP mode when > 0")
    p.add_argument("--dp_devices", type=int, default=1,
                   help="spread a call's request groups over this many "
                        "cards (cuda:0 .. N-1), one group a card at a time")
    p.add_argument("--batch_window_ms", type=float, default=10.0,
                   help="coalesce concurrent requests into shared generation "
                        "calls, waiting up to this long for companions "
                        "(serve/batcher.py); 0 = serve one POST at a time")
    p.add_argument("--row_buckets", default="16,32,48",
                   help="comma-separated row ladder the chains are pinned to "
                        "(empty = every multiple-of-4 row count, more "
                        "variants)")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip running the row ladder at start (the first "
                        "requests then run their shapes cold)")
    p.add_argument("--device", default="cuda",
                   help="device the model samples on (cuda, cuda:N or cpu)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    service = service_from_experiment(
        args.exp, dataset=args.dataset, epoch=args.epoch,
        gen_shape=args.gen_shape, return_meshes=args.meshes,
        max_nodes=args.max_nodes, max_triples=args.max_triples,
        max_scenes=args.max_scenes, sample_dtype=args.sample_dtype,
        layout_sampler=args.layout_sampler, layout_steps=args.layout_steps,
        shape_sampler=args.shape_sampler, shape_steps=args.shape_steps,
        dp_devices=args.dp_devices,
        row_buckets=[int(r) for r in args.row_buckets.split(",") if r]
        if args.row_buckets else None, device=args.device)
    if args.port and not args.no_warmup:
        # online serving runs the whole (rows, manip) ladder before it
        # accepts connections
        n = service.warmup()
        print(f"[serve] warmed {n} variants")
    if args.port:
        run_http(service, args.host, args.port,
                 batch_window_ms=args.batch_window_ms)
        return None
    if not args.requests:
        raise SystemExit("--requests or --port required")
    with open(args.requests) as f:
        reqs = json.load(f)
    results = service.generate(reqs)
    out = args.out or "serve_results.json"
    with open(out, "w") as f:
        json.dump({"results": results}, f)
    print(f"[serve] wrote {len(results)} results to {out}")
    return results


if __name__ == "__main__":
    main()
