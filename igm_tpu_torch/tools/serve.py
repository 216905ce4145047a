"""Serve an exported sampler over HTTP: the port's counterpart of
``tools/serve.py``.

    # export once (python -m igm_tpu_torch.tools.export), then serve it:
    python -m igm_tpu_torch.tools.serve sampler.pt [--port 8787] [--host 127.0.0.1] \\
        [--device cpu]

    # latency and throughput through the whole HTTP stack, one JSON line:
    python -m igm_tpu_torch.tools.serve sampler.pt --bench 20

Endpoints:
    GET  /healthz   -> {"ok": true, "artifact", "model", "n", "sampler", "steps",
                        "out_shape", "device"}
    GET  /stats     -> requests, p50_ms, p95_ms, p99_ms, batch_per_request,
                       samples_per_sec (``igm_tpu``'s keys and formulas);
                       queue_p50_ms, queue_p95_ms, encode_p50_ms,
                       sampler_step_host_ms (the spans below)
    POST /sample    -> body {"seed": int, "format": "npy"|"png"}
                       npy: np.save bytes of the batch; png: its grid
    other routes 404; a request that fails 500 with the exception's text.

:class:`SamplerService` loads the artifact on the card (or ``--device``)
with the port's model code (``tools/export.py`` ``load_sampler``), and
makes one warm-up request: on the card that captures the sampler network's
CUDA graphs (``models/base.py`` ``network``), which later requests replay.
A lock serialises requests (one device, one batch at a time: the batch size
is fixed at export).  A request's ``seed`` draws from
``torch.Generator(device).manual_seed(seed)``, so a response is the batch
``python -m igm_tpu_torch.cli`` draws with the same weights, sampler,
steps, n and seed on the device, bit for bit.  Latency is timed around the
sampler call and the device-to-host copy of its output, which waits for
the device.  ``ThreadingHTTPServer`` handles each request on a thread of
its own: graphs captured on the warm-up's thread are replayed from others.

Spans (``core/trace.py``), each of a ``POST /sample`` under one request id:
``server.request`` the whole request, ``server.queue`` the wait for the
lock, ``server.service`` the timed region above, ``server.encode`` the
response's bytes and their write; inside the sampler ``sampler.step`` and
``sampler.network`` (``models/ddpm.py`` ``dpm_sample``).  ``/stats``' span
keys cover the service's life, warm-up included, over the records the
registry keeps (the last 4,096 of each thread): the queue's median and
95th percentile, the encoding's median, and the host's time a sampler
step outside the network call (``sampler.step``'s self time, its mean).
"""
from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..core import trace


class SamplerService:
    """The artifact's sampler on a device: warm-up, serialised and timed
    requests."""

    def __init__(self, artifact: str, device=None):
        from ..utils.platform import set_numerics
        from .export import load_sampler

        set_numerics()
        self.path = str(artifact)
        self._draw, self.model, loaded = load_sampler(self.path, device)
        self.meta = {k: loaded[k] for k in ("n", "sampler", "steps", "step")}
        self.meta["model"] = str(loaded["config"]["model"].get("_target_", "?"))
        self._lock = threading.Lock()
        self.latencies_ms: list = []
        self.meta["out_shape"] = [list(self.sample(seed=0).shape)]   # the warm-up
        self.latencies_ms.clear()

    def sample(self, seed: int) -> np.ndarray:
        with trace.span("server.queue"):
            self._lock.acquire()
        try:
            with trace.span("server.service"):
                t0 = time.perf_counter()
                out = self._draw(int(seed)).float().cpu().numpy()   # the copy waits for the device
                self.latencies_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            self._lock.release()
        return out

    def stats(self) -> dict:
        lat = sorted(self.latencies_ms)
        pct = (lambda p: round(float(np.percentile(lat, p)), 2)) if lat else (lambda p: None)
        n = len(lat)
        batch = self.meta.get("n")
        spans = trace.spans()

        def ms(name: str, key: str):
            v = spans.get(name, {}).get(key)
            return None if v is None else round(1e3 * v, 3)

        step = spans.get("sampler.step")
        return {"requests": n, "p50_ms": pct(50), "p95_ms": pct(95), "p99_ms": pct(99),
                "batch_per_request": batch,
                "samples_per_sec": (round(batch * n / (sum(lat) / 1e3), 1)
                                    if lat and batch else None),
                "queue_p50_ms": ms("server.queue", "p50_s"),
                "queue_p95_ms": ms("server.queue", "p95_s"),
                "encode_p50_ms": ms("server.encode", "p50_s"),
                "sampler_step_host_ms": (round(1e3 * step["self_s"] / step["count"], 4)
                                         if step else None)}


def png_bytes(imgs: np.ndarray, model) -> bytes:
    """The grid of ``imgs`` as the sampling CLI draws it, PNG-encoded."""
    from PIL import Image

    from ..callbacks.visualization import get_grid_images

    grid = get_grid_images(imgs, model, nimgs=len(imgs))
    buf = io.BytesIO()
    Image.fromarray((np.clip(grid, 0.0, 1.0) * 255).astype(np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def make_handler(svc: SamplerService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "artifact": svc.path,
                                 "device": str(svc.model.device),
                                 **{k: svc.meta.get(k) for k in
                                    ("model", "n", "sampler", "steps", "out_shape")}})
            elif self.path == "/stats":
                self._json(200, svc.stats())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/sample":
                self._json(404, {"error": f"no route {self.path}"})
                return
            with trace.request(), trace.span("server.request"):
                try:
                    ln = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(ln) or b"{}")
                    imgs = svc.sample(int(req.get("seed", 0)))
                    with trace.span("server.encode"):
                        if req.get("format", "npy") == "png":
                            self._send(200, png_bytes(imgs, svc.model), "image/png")
                        else:
                            buf = io.BytesIO()
                            np.save(buf, imgs)
                            self._send(200, buf.getvalue(), "application/x-npy")
                except Exception as exc:  # the error goes back to the client
                    self._json(500, {"error": f"{type(exc).__name__}: {exc}"})

    return Handler


def serve(artifact: str, host: str, port: int, device=None) -> ThreadingHTTPServer:
    svc = SamplerService(artifact, device)
    httpd = ThreadingHTTPServer((host, port), make_handler(svc))
    httpd.service = svc
    return httpd


def bench(artifact: str, n_requests: int, device=None) -> dict:
    """Latency through the whole HTTP stack (the server in this process):
    ``/stats`` after ``n_requests`` sequential requests, with the wall time
    and the HTTP request rate."""
    import urllib.request

    httpd = serve(artifact, "127.0.0.1", 0, device)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        t0 = time.perf_counter()
        for i in range(n_requests):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/sample",
                                         data=json.dumps({"seed": i}).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as r:
                if r.status != 200:
                    raise RuntimeError(f"request {i}: HTTP {r.status}")
                r.read()
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats") as r:
            stats = json.loads(r.read())
        stats["wall_s"] = round(wall, 3)
        stats["http_requests_per_sec"] = round(n_requests / wall, 2)
        return stats
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m igm_tpu_torch.tools.serve")
    ap.add_argument("artifact")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--bench", type=int, default=0,
                    help="run N requests through the HTTP stack and print one JSON "
                         "stats line instead of serving")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.bench:
        print(json.dumps(bench(args.artifact, args.bench, args.device)))
        return
    httpd = serve(args.artifact, args.host, args.port, args.device)
    print(f"serving {args.artifact} on http://{args.host}:{httpd.server_address[1]}  "
          "(POST /sample, GET /healthz /stats)")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
