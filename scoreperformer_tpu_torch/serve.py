"""JSON-lines render server of the PyTorch port: load a checkpoint once, serve
many requests.

Usage:
  python -m scoreperformer_tpu_torch.serve --checkpoint results/.../checkpoint_best
      [--tokenizer t.json] [--bucket 128] [--max-len 2048] [--port 7512]
      [--device cuda|cpu]

Without --port: one JSON request per stdin line, one JSON response per stdout
line (logs go to stderr). With --port: a threaded TCP server speaking the same
line protocol.

Request:  {"id": 1, "score": "in.mid" | "score_b64": "<base64 SMF>",
           "out": "out.mid" (optional; without it the response carries
           "midi_b64"), "temperature": 1.0, "greedy": false, "seed": 0,
           "style_delta": [floats, length = style latent dim] (optional)}
Special:  {"cmd": "ping"}  /  {"cmd": "shutdown"}
Response: {"id": 1, "ok": true, "out": "out.mid" | "midi_b64": "...",
           "notes": N, "wall_ms": T, "padded_to": L, "batched": B}

TCP mode with --max-batch N coalesces concurrent requests (those that arrive
within --batch-window-ms of the first) into ONE batched render; decode
throughput grows with the batch, so N concurrent clients cost far less than
N renders one after another. The port's copy of the repository's `serve.py`;
it runs on the GPU unless --device cpu is given.
"""
import argparse
import json
import queue
import socketserver
import sys
import threading
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="ScorePerformer render server (PyTorch port)")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--tokenizer", default=None)
    parser.add_argument("--bucket", type=int, default=128)
    parser.add_argument("--max-len", type=int, default=2048)
    parser.add_argument("--port", type=int, default=None, help="TCP mode on this port")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument(
        "--warmup", default=None,
        help="comma-separated lengths to run once before accepting requests, "
             "e.g. --warmup 128,256 (sampling path; add the greedy one with --warmup-greedy)",
    )
    parser.add_argument("--warmup-greedy", action="store_true")
    parser.add_argument(
        "--cache-dtype", choices=("auto", "fp32", "bf16", "int8"), default="fp32",
        help="decoder KV-cache precision: fp32, bf16, int8 (quantized prefix, "
             "not bit-stable against fp32), or auto (int8 at model dim >= 1024, else fp32)",
    )
    parser.add_argument("--chunk-size", type=int, default=16)
    parser.add_argument(
        "--max-batch", type=int, default=1,
        help="TCP mode: coalesce up to N concurrent requests into one batched render",
    )
    parser.add_argument(
        "--batch-window-ms", type=float, default=5.0,
        help="how long the coalescer waits for more requests once one arrives "
             "(only with --max-batch > 1)",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from .inference.server import RenderServer

    server = RenderServer(
        args.checkpoint, tokenizer_path=args.tokenizer, bucket=args.bucket, max_len=args.max_len,
        cache_dtype=args.cache_dtype, chunk_size=args.chunk_size, device=args.device,
    )
    if args.warmup:
        lengths = [int(x) for x in args.warmup.split(",") if x.strip()]
        variants = (False, True) if args.warmup_greedy else (False,)
        batches = (1,) if args.max_batch <= 1 else (1, args.max_batch)
        print(f"warming up {lengths} (greedy={args.warmup_greedy}, batches={batches})...",
              file=sys.stderr, flush=True)
        server.warmup(lengths, greedy_variants=variants, batch_sizes=batches)
    print(f"ready (device={server.device}, bucket={args.bucket}, max_len={server.max_len})",
          file=sys.stderr, flush=True)

    if args.port is None:
        _serve_stdio(server)
    else:
        _serve_tcp(server, args.host, args.port, max_batch=args.max_batch, window_ms=args.batch_window_ms)


def _serve_stdio(server):
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            print(json.dumps({"ok": False, "error": f"bad json: {e}"}), flush=True)
            continue
        if req.get("cmd") == "shutdown":
            print(json.dumps({"id": req.get("id"), "ok": True, "bye": True}), flush=True)
            return
        print(json.dumps(server.handle_request(req)), flush=True)


class _Coalescer:
    """Collects concurrent requests into batches for RenderServer.handle_batch.

    One dispatcher thread: the first request opens a window of `window_ms`;
    whatever arrives before it closes (up to `max_batch`) renders as ONE
    batched call. Each client handler thread blocks on its own event until
    its response is filled in.
    """

    def __init__(self, server, max_batch: int, window_ms: float):
        self.server = server
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1000.0
        self.q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, req):
        box, ev = {}, threading.Event()
        self.q.put((req, box, ev))
        ev.wait()
        return box["resp"]

    def stop(self):
        self.q.put(None)

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            batch = [item]
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self.q.put(None)  # re-post the stop for after this batch
                    break
                batch.append(nxt)
            resps = self.server.handle_batch([b[0] for b in batch])
            for (_, box, ev), resp in zip(batch, resps):
                box["resp"] = resp
                ev.set()


def make_tcp_server(server, host, port, max_batch=1, window_ms=5.0):
    """Build (but do not start) the threaded TCP server; returns (srv,
    coalescer-or-None). Split out so that a caller can drive it in-process."""
    coalescer = _Coalescer(server, max_batch, window_ms) if max_batch > 1 else None

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for raw in self.rfile:
                line = raw.decode("utf-8", "replace").strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    resp = {"ok": False, "error": f"bad json: {e}"}
                else:
                    if req.get("cmd") == "shutdown":
                        self.wfile.write(
                            (json.dumps({"id": req.get("id"), "ok": True, "bye": True}) + "\n").encode()
                        )
                        self.server.shutdown()
                        return
                    if coalescer is not None and req.get("cmd") is None:
                        resp = coalescer.submit(req)
                    else:
                        resp = server.handle_request(req)
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()

    class TCPServer(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    return TCPServer((host, port), Handler), coalescer


def _serve_tcp(server, host, port, max_batch=1, window_ms=5.0):
    srv, coalescer = make_tcp_server(server, host, port, max_batch, window_ms)
    with srv:
        print(f"listening on {host}:{port} (max_batch={max_batch})", file=sys.stderr, flush=True)
        try:
            srv.serve_forever()
        finally:
            if coalescer is not None:
                coalescer.stop()


if __name__ == "__main__":
    main()
