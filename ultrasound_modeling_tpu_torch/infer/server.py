"""HTTP serving of the port: ``InferenceServer`` and its micro-batcher,
copied from ``ultrasound_modeling_tpu/infer/server.py`` as they are (stdlib
plus numpy), so that the port imports nothing of the JAX package.  The
server takes any forward callable ``[B, H, W, C] -> [B, H, W, K]`` (numpy);
``cli.make_forward`` wraps the port's model.

Production inference serving: one resident compiled forward behind a
stdlib HTTP server, with dynamic cross-request micro-batching.

The reference's serving story forks one process PER FRAME and reloads the
whole Keras SavedModel inside each child (reference: TBIEvaluator.py:191-206
fan-out, :235-236 per-process load_model) — ~16 model loads per 16 frames.
The TPU-native replacement inverts that: the model is loaded and compiled
ONCE, and concurrency comes from coalescing concurrent requests into
device-filling batches.  Requests enqueue their frames; a batcher thread
gathers rows for up to ``window_ms`` (or until ``max_batch`` rows), pads the
coalesced batch to a power-of-two bucket (a bounded set of compiled shapes),
runs ONE forward, and scatters the rows back to their callers.

Endpoints:
  GET  /healthz   — liveness + model metadata
  GET  /stats     — request/frame/batch counters, mean rows per device batch
  POST /predict   — body = ``.npy`` bytes ``[N,H,W,C] float32`` (response
                    ``.npy`` probabilities ``[N,H,W,num_classes]``), or JSON
                    ``{"instances": [...]}`` (response ``{"probabilities",
                    "classes"}``).  A single frame ``[H,W,C]`` is accepted
                    and batched transparently.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple

import numpy as np


class ServerOverloadedError(RuntimeError):
    """Raised at submit time when the batcher's pending-frame budget is
    exhausted — the backpressure signal (HTTP 503) instead of unbounded
    queue growth."""


def _bucket_sizes(max_batch: int, min_batch: int = 1):
    """Padding buckets ``min_batch * 2^k`` up to ``max_batch`` (ascending).

    ``min_batch > 1`` floors every device batch (data-parallel serving: the
    coalesced batch must divide evenly over the mesh's ``data`` axis)."""
    sizes, b = [], min_batch
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return sizes


@dataclass
class _Pending:
    x: np.ndarray                      # [n, H, W, C]
    done: threading.Event = field(default_factory=threading.Event)
    probs: Optional[np.ndarray] = None
    error: Optional[Exception] = None
    cancelled: bool = False            # caller timed out; skip device work


class DynamicBatcher:
    """Coalesce concurrent predict calls into padded device batches.

    ``fn`` is the compiled forward ``[B,H,W,C] -> [B,H,W,K]``.  Distinct
    batch sizes would each trigger an XLA compile, so coalesced batches are
    zero-padded up to the nearest bucket in ``_bucket_sizes(max_batch)`` —
    at most log2(max_batch)+1 compiled shapes ever exist.
    """

    def __init__(self, fn: Callable, max_batch: int = 64,
                 window_ms: float = 2.0, min_batch: int = 1,
                 max_pending: int = 0):
        if not 1 <= min_batch <= max_batch:
            raise ValueError("need 1 <= min_batch <= max_batch")
        if max_batch % min_batch:
            raise ValueError("max_batch must be a multiple of min_batch")
        self.fn = fn
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1e3
        self.buckets = _bucket_sizes(self.max_batch, int(min_batch))
        # Admission budget in FRAMES: submits beyond it raise
        # ServerOverloadedError instead of growing the queue without bound.
        # 0 = default 8 device batches of headroom.
        self.max_pending = int(max_pending) or 8 * self.max_batch
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._inflight = 0                 # admitted frames not yet drained
        self.n_requests = 0
        self.n_frames = 0                  # frames that actually EXECUTED
        self.n_rejected = 0                # requests refused at admission
        self.n_timeouts = 0                # predict() deadline expiries
        self.n_batches = 0
        self.n_padded_rows = 0
        # ring buffer of recent device-batch wall times (seconds)
        self._lat = deque(maxlen=512)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client side --------------------------------------------------------
    def predict(self, x: np.ndarray, timeout: Optional[float] = None
                ) -> np.ndarray:
        """Blocking predict; splits oversize requests into <=max_batch
        chunks so one caller can never monopolize a device batch.

        ``timeout`` bounds the WHOLE call (one shared deadline across the
        chunks, not per chunk); on expiry the not-yet-run chunks are marked
        cancelled so the batcher drops them instead of burning device
        batches whose results nobody reads.

        Raises :class:`ServerOverloadedError` (without enqueuing anything)
        when admitting the request would exceed ``max_pending`` frames —
        memory stays bounded under bursts and callers get an explicit
        back-off signal."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.shape[0] == 0:
            raise ValueError("empty batch")
        n = x.shape[0]
        with self._lock:
            if self._inflight + n > self.max_pending:
                self.n_rejected += 1
                raise ServerOverloadedError(
                    f"server overloaded: {self._inflight} frames pending "
                    f"(budget {self.max_pending}), retry later")
            self._inflight += n
            self.n_requests += 1
        parts = [_Pending(x[i:i + self.max_batch])
                 for i in range(0, n, self.max_batch)]
        for p in parts:
            self._q.put(p)
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            for p in parts:
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                if not p.done.wait(remaining):
                    with self._lock:
                        self.n_timeouts += 1
                    raise TimeoutError("predict timed out")
                if p.error is not None:
                    raise p.error
        except BaseException:
            for p in parts:
                p.cancelled = True
            raise
        return np.concatenate([p.probs for p in parts], axis=0)

    def warmup(self, sample_shape: Tuple[int, ...], buckets=None) -> None:
        """Pre-compile the bucket shapes (first compile is the slow one)."""
        for b in (buckets or self.buckets):
            np.asarray(self.fn(np.zeros((b,) + tuple(sample_shape),
                                        np.float32)))

    def stop(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=5)

    # -- batcher thread ------------------------------------------------------
    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            batch, rows = [item], item.x.shape[0]
            deadline = time.monotonic() + self.window_s
            while rows < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._run(batch)
                    return
                if rows + nxt.x.shape[0] > self.max_batch:
                    # would overflow the device batch: run what we have,
                    # start the next batch with this item
                    self._run(batch)
                    batch, rows = [nxt], nxt.x.shape[0]
                    deadline = time.monotonic() + self.window_s
                    continue
                batch.append(nxt)
                rows += nxt.x.shape[0]
            self._run(batch)

    def _run(self, items):
        try:
            self._run_inner(items)
        finally:
            # every drained chunk — cancelled, failed, or served — releases
            # its admission budget only once its device work is over, so
            # ``max_pending`` bounds queued AND executing frames together
            with self._lock:
                self._inflight -= sum(it.x.shape[0] for it in items)

    def _run_inner(self, items):
        items = [it for it in items if not it.cancelled]
        if not items:
            return
        x = (items[0].x if len(items) == 1
             else np.concatenate([it.x for it in items], axis=0))
        n = x.shape[0]
        bucket = next(b for b in self.buckets if b >= n)
        if bucket > n:
            x = np.concatenate(
                [x, np.zeros((bucket - n,) + x.shape[1:], x.dtype)], axis=0)
        t0 = time.monotonic()
        try:
            probs = np.asarray(self.fn(x))[:n]
        except Exception as e:  # surface compile/shape errors to callers
            for it in items:
                it.error = e
                it.done.set()
            return
        dt = time.monotonic() - t0
        with self._lock:
            self.n_batches += 1
            # counted at EXECUTION time (not submit), so cancelled/timed-out
            # chunks never inflate frames / mean_rows_per_batch
            self.n_frames += n
            self.n_padded_rows += bucket - n
            self._lat.append(dt)
        ofs = 0
        for it in items:
            k = it.x.shape[0]
            it.probs = probs[ofs:ofs + k]
            ofs += k
            it.done.set()

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            return {
                "requests": self.n_requests,
                "frames": self.n_frames,
                "rejected": self.n_rejected,
                "timeouts": self.n_timeouts,
                "inflight_frames": self._inflight,
                "max_pending": self.max_pending,
                "device_batches": self.n_batches,
                "padded_rows": self.n_padded_rows,
                "mean_rows_per_batch": (
                    self.n_frames / self.n_batches if self.n_batches else 0.0),
                # wall time of the recent device batches (includes the
                # host<->device link; first entries include compiles unless
                # warmup() ran)
                "batch_ms_p50": (1e3 * lat[len(lat) // 2] if lat else 0.0),
                "batch_ms_p95": (1e3 * lat[int(len(lat) * 0.95)]
                                 if lat else 0.0),
            }


class _Handler(BaseHTTPRequestHandler):
    # quiet: no per-request stderr lines
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        srv: "InferenceServer" = self.server.app  # type: ignore[attr-defined]
        if self.path == "/healthz":
            self._send_json(200, {"status": "ok",
                                  "sample_shape": list(srv.sample_shape),
                                  "max_batch": srv.batcher.max_batch,
                                  "model": srv.model_name})
        elif self.path == "/stats":
            self._send_json(200, srv.batcher.stats())
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        srv: "InferenceServer" = self.server.app  # type: ignore[attr-defined]
        if self.path != "/predict":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        length = self.headers.get("Content-Length")
        if length is None:
            self.close_connection = True
            self._send_json(411, {"error": "Content-Length required"})
            return
        length = int(length)
        if length > srv.max_body_bytes:
            # refuse WITHOUT reading the body: a burst of oversized posts
            # must not be able to grow memory
            self.close_connection = True
            self._send_json(413, {
                "error": f"body {length} bytes exceeds the "
                         f"{srv.max_body_bytes}-byte limit"})
            return
        try:
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "application/octet-stream")
            as_json = ctype.startswith("application/json")
            if as_json:
                payload = json.loads(body)
                x = np.asarray(payload["instances"], dtype=np.float32)
            else:
                x = np.load(io.BytesIO(body), allow_pickle=False)
            single = (x.ndim == len(srv.sample_shape))
            if single:
                x = x[None]
            if x.ndim != len(srv.sample_shape) + 1 or \
                    tuple(x.shape[1:]) != tuple(srv.sample_shape):
                raise ValueError(
                    f"expected frames shaped {tuple(srv.sample_shape)}, "
                    f"got {x.shape}")
            if x.shape[0] == 0:
                raise ValueError("empty batch")
        except Exception as e:
            self._send_json(400, {"error": str(e)})
            return
        try:
            probs = srv.batcher.predict(x, timeout=srv.request_timeout)
        except ServerOverloadedError as e:
            # expected overload signal — distinct from model failures so
            # clients can back off (Retry-After is advisory)
            self.send_response(503)
            body = json.dumps({"error": str(e)}).encode()
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Retry-After", "1")
            self.end_headers()
            self.wfile.write(body)
            return
        except TimeoutError as e:
            self._send_json(504, {"error": str(e)})
            return
        except Exception as e:
            self._send_json(500, {"error": str(e)})
            return
        if single:
            probs = probs[0]
        if as_json:
            self._send_json(200, {
                "probabilities": probs.tolist(),
                "classes": np.argmax(probs, axis=-1).tolist()})
        else:
            buf = io.BytesIO()
            np.save(buf, probs, allow_pickle=False)
            self._send(200, buf.getvalue(), "application/octet-stream")


class InferenceServer:
    """HTTP front over a :class:`DynamicBatcher` (stdlib only)."""

    def __init__(self, fn: Callable, sample_shape: Tuple[int, ...],
                 host: str = "127.0.0.1", port: int = 8000,
                 max_batch: int = 64, window_ms: float = 2.0,
                 model_name: str = "model",
                 request_timeout: float = 120.0, min_batch: int = 1,
                 max_pending: int = 0, max_body_bytes: int = 0):
        self.sample_shape = tuple(sample_shape)
        self.model_name = model_name
        self.request_timeout = request_timeout
        # body cap: the largest legal binary request is max_pending frames;
        # JSON encodes ~5x wider than 4-byte binary, so allow 8x + slack.
        frame_bytes = 4 * int(np.prod(sample_shape))
        pending = int(max_pending) or 8 * int(max_batch)
        self.max_body_bytes = int(max_body_bytes) or (
            8 * frame_bytes * pending + (1 << 20))
        self.batcher = DynamicBatcher(fn, max_batch=max_batch,
                                      window_ms=window_ms,
                                      min_batch=min_batch,
                                      max_pending=max_pending)
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.app = self  # type: ignore[attr-defined]

    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.stop()
