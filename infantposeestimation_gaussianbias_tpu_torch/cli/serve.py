"""Batched HTTP pose server.

Port of infantposeestimation_gaussianbias_tpu/cli/serve.py.  The card
wants large batches, so the server micro-batches concurrent requests:
handler threads enqueue frames, one dispatcher thread drains the queue
every ``--batch-window`` ms (up to ``--max-batch``), groups frames of one
shape, and runs one ``PoseInference.predict_batch`` per group, up to
``--dispatch-depth`` groups in flight.  A full pending queue answers 503
with ``Retry-After``; a request whose deadline passes in the queue is
dropped before it reaches the card and answers 504.  Serving folds
BatchNorm by default (``--no-fold`` serves it unfolded).

    python -m infantposeestimation_gaussianbias_tpu_torch.cli.serve \
        --variant hrformer_base --port 8000

    POST /predict          image body (JPEG/PNG, or .npy (H,W,3) uint8
                           with Content-Type: application/x-npy);
                           optional ?bbox=x1,y1,x2,y2 (xyxy, defaults
                           to the full frame)
                           -> {"keypoints": [[x, y], ...],
                               "scores": [...], "keypoint_names": [...]}
    GET  /healthz          -> {"status": "ok", "backbone": ...}

``--checkpoint`` takes a ``torch.save``d state dict in the reference's
naming; ``--int8`` serves int8 PTQ, calibrated on ``--calibration-dir``'s
images or else on the first request batch (``/healthz`` then reports
``"precision": "int8-ptq"``).

``--mesh [MODEL_AXIS]`` serves over a process grid launched by torchrun
(cli/common.py; above one, the weights are cut over the model axis).
Rank 0 runs the HTTP front and the micro-batcher; before each formed
batch it broadcasts the batch (a header with its shape, then the frames
and the boxes) to the other ranks, which serve it with it in lockstep
(``follow``).  Under a grid one group is in flight at a time, so that the
ranks issue their collectives in one order; shutdown broadcasts a stop.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import queue
import threading
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .common import (add_config_args, add_serving_args, make_grid,
                     make_inference, resolve_config)

class Overloaded(Exception):
    """Request rejected at admission: the pending queue is full."""


class _Pending:
    """One enqueued request: the frame to predict and a door to wait at."""

    __slots__ = ("frame", "bbox", "done", "result", "error", "deadline")

    def __init__(self, frame: np.ndarray, bbox: np.ndarray,
                 deadline: float = float("inf")):
        self.frame = frame
        self.bbox = bbox
        self.done = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None
        # absolute time.monotonic() after which nobody is waiting for the
        # answer; the dispatcher drops expired requests BEFORE burning
        # device time on them.
        self.deadline = deadline


class MicroBatcher:
    """Collects concurrent requests into device batches.

    One dispatcher thread blocks for the first pending request, then
    waits ``window_s`` for company, drains up to ``max_batch``, groups
    by frame shape (predict_batch needs equal-size frames), and runs
    one batched forward per group.
    """

    def __init__(self, infer, max_batch: int = 64,
                 window_s: float = 0.005, depth: int = 2,
                 queue_depth: int = 0):
        self.infer = infer
        self.max_batch = max_batch
        self.window_s = window_s
        # Bounded admission queue: under sustained overload, accepting
        # work the device can never catch up on only grows p95 without
        # bound AND burns device time on answers nobody is waiting for.
        # Default bound = 4 batches per in-flight slot: deep enough to
        # absorb a burst, shallow enough that queue wait stays a few
        # batch-times.  0/negative -> explicit bound given by the caller.
        if queue_depth <= 0:
            queue_depth = max_batch * max(1, depth) * 4
        self.queue_depth = queue_depth
        self.q: "queue.Queue[_Pending]" = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        # Pipelined dispatch: the drain thread hands each shape-group to
        # a small pool so batch N+1 forms and dispatches while batch N is
        # still on device / converting to numpy (a single blocking
        # predict_batch would idle the device between batches). `depth`
        # bounds in-flight batches — enough to overlap, small enough that
        # per-request latency stays one batch deep.
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=max(1, depth),
                                        thread_name_prefix="ipe-dispatch")
        self._inflight = threading.Semaphore(max(1, depth))
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, frame: np.ndarray, bbox: np.ndarray,
               timeout: float = 60.0):
        import time

        p = _Pending(frame, bbox, deadline=time.monotonic() + timeout)
        try:
            self.q.put_nowait(p)  # shed load at admission, don't block
        except queue.Full:
            raise Overloaded(
                f"pending queue full ({self.queue_depth} requests)")
        if not p.done.wait(timeout):
            # Waiter gives up; the dispatcher will drop the pending via
            # its deadline instead of dispatching it to the device.
            raise TimeoutError("prediction timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._pool.shutdown(wait=False)

    @staticmethod
    def _expire(pendings: list) -> list:
        """Drop requests whose waiter has already timed out; returns the
        still-live ones.  Without this, a timed-out request's frame was
        STILL dispatched later — under sustained overload the server
        burned device time on answers nobody was waiting for and p95
        grew without bound."""
        import time

        now = time.monotonic()
        live = []
        for p in pendings:
            if p.deadline < now:
                p.error = TimeoutError("expired in queue")
                p.done.set()
            else:
                live.append(p)
        return live

    def _drain(self) -> list:
        try:
            first = self.q.get(timeout=0.1)
        except queue.Empty:
            return []
        if self.window_s > 0:
            self._stop.wait(self.window_s)  # let a burst accumulate
        batch = [first]
        while len(batch) < self.max_batch:
            try:
                batch.append(self.q.get_nowait())
            except queue.Empty:
                break
        return self._expire(batch)

    def _predict_group(self, members: list) -> None:
        try:
            # re-check deadlines: time may have passed queued behind the
            # in-flight semaphore between drain and dispatch.
            members = self._expire(members)
            if not members:
                return
            frames = np.stack([p.frame for p in members])
            bboxes = np.stack([p.bbox for p in members])
            kpts, scores = self.infer.predict_batch(frames, bboxes)
            for i, p in enumerate(members):
                p.result = (kpts[i], scores[i])
        except Exception as e:  # report, don't kill the server
            for p in members:
                p.error = e
        finally:
            for p in members:
                p.done.set()
            self._inflight.release()

    def _acquire_slot(self) -> bool:
        while not self._stop.is_set():
            if self._inflight.acquire(timeout=0.1):
                return True
        return False

    def _run(self):
        while not self._stop.is_set():
            # Back-pressure: take a dispatch slot BEFORE draining. While
            # the pipeline is full the queue keeps accumulating, so the
            # next drain forms one large batch instead of many small ones
            # (eager draining doubles the per-batch fixed dispatch cost).
            if not self._acquire_slot():
                return
            batch = self._drain()
            if not batch:
                self._inflight.release()
                continue
            groups: dict = {}
            for p in batch:
                groups.setdefault(p.frame.shape, []).append(p)
            first = True
            for members in groups.values():
                if not first:
                    if not self._acquire_slot():
                        # shutting down: fail the stragglers loudly
                        for p in members:
                            p.error = RuntimeError("server stopping")
                            p.done.set()
                        continue
                self._pool.submit(self._predict_group, members)
                first = False


def _exchange(grid, frames: Optional[np.ndarray] = None,
              bboxes: Optional[np.ndarray] = None) -> Optional[tuple]:
    """Rank 0 broadcasts a batch (``frames``, ``bboxes``) or, with none, a
    stop; every rank returns the batch, or None for the stop.  The
    tensors cross on the CPU under gloo and on the card under nccl."""
    import torch
    import torch.distributed as dist

    group = grid.world_group
    dev = grid.device if dist.get_backend(group) == "nccl" else "cpu"
    head = torch.zeros(4, dtype=torch.int64, device=dev)
    if grid.rank == 0 and frames is not None:
        head.copy_(torch.tensor([1, *frames.shape[:3]]))
    dist.broadcast(head, 0, group=group)
    go, n, h, w = head.tolist()
    if not go:
        return None
    if grid.rank == 0:
        f = torch.from_numpy(np.ascontiguousarray(frames, np.uint8)).to(dev)
        b = torch.from_numpy(np.ascontiguousarray(bboxes, np.float32)).to(dev)
    else:
        f = torch.empty((n, h, w, 3), dtype=torch.uint8, device=dev)
        b = torch.empty((n, 4), dtype=torch.float32, device=dev)
    dist.broadcast(f, 0, group=group)
    dist.broadcast(b, 0, group=group)
    return f.cpu().numpy(), b.cpu().numpy()


class GridLeader:
    """Rank 0's ``PoseInference`` under ``--mesh``: ``predict_batch``
    broadcasts each batch to the other ranks (``_exchange``) before
    serving it with them; ``stop`` ends their ``follow`` loops.  Calls are
    serialised, so the ranks see one order.  Everything else is the
    wrapped predictor's."""

    def __init__(self, infer, grid):
        self.infer = infer
        self.grid = grid
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self.infer, name)

    def predict_batch(self, frames: np.ndarray, bboxes: np.ndarray):
        with self._lock:
            _exchange(self.grid, frames, bboxes)
            return self.infer.predict_batch(frames, bboxes)

    def stop(self) -> None:
        with self._lock:
            _exchange(self.grid)


def follow(infer, grid) -> None:
    """A rank other than 0 under ``--mesh``: serve every batch rank 0
    broadcasts, until the stop."""
    while True:
        batch = _exchange(grid)
        if batch is None:
            return
        infer.predict_batch(*batch)


def _decode_image(body: bytes, content_type: str) -> np.ndarray:
    if "npy" in content_type:
        arr = np.load(io.BytesIO(body), allow_pickle=False)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(f"npy frame must be (H, W, 3), got {arr.shape}")
        return np.ascontiguousarray(arr, np.uint8)
    # JPEG/PNG bodies: native single-pass decode straight to RGB (no
    # BGR->RGB copy); other formats, or no native build: cv2.
    is_jpeg = body[:3] == b"\xff\xd8\xff"
    if is_jpeg or body[:4] == b"\x89PNG":
        from .. import native as native_mod

        if native_mod.available() and (is_jpeg or native_mod.has_png()):
            return native_mod.decode_rgb(body)
    import cv2

    img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("cannot decode image body")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def make_server(infer, host: str = "127.0.0.1",
                port: int = 8000, max_batch: int = 64,
                window_ms: float = 5.0, depth: int = 2,
                queue_depth: int = 0, request_timeout: float = 60.0):
    """Build (but don't start) the HTTP server; returns (server, batcher).

    ``infer`` is a ``PoseInference``.  Split from main() so tests can run
    it on an ephemeral port.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    batcher = MicroBatcher(infer, max_batch=max_batch,
                           window_s=window_ms / 1e3, depth=depth,
                           queue_depth=queue_depth)
    names = list(infer.schema.keypoint_names)
    health = {
        "status": "ok",
        "backbone": infer.cfg.model.backbone,
        "head": infer.cfg.model.head_type,
        "num_keypoints": infer.schema.num_keypoints,
        "precision": ("int8-ptq" if infer.quantize else "float"),
        "fold": bool(infer.fold),
        "device": str(infer.device),
    }

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: every response carries Content-Length, so
        # persistent connections are safe — without this the HTTP/1.0
        # default closes the socket after each response and clients that
        # reuse connections see ECONNRESET on their next request.
        protocol_version = "HTTP/1.1"

        def _send(self, code: int, payload: dict, retry_after: float = 0):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after > 0:
                self.send_header("Retry-After",
                                 str(max(1, int(round(retry_after)))))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._send(200, health)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/predict":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                frame = _decode_image(
                    self.rfile.read(length),
                    self.headers.get("Content-Type", ""))
                qs = parse_qs(url.query)
                if "bbox" in qs:
                    bbox = np.asarray(
                        [float(v) for v in qs["bbox"][0].split(",")],
                        np.float32)
                    if bbox.shape != (4,):
                        raise ValueError("bbox must be x1,y1,x2,y2")
                else:
                    h, w = frame.shape[:2]
                    bbox = np.asarray([0, 0, w, h], np.float32)
                kpts, scores = batcher.submit(frame, bbox,
                                              timeout=request_timeout)
            except Overloaded as e:
                # Shed load explicitly: a full pending queue means the
                # device is saturated; tell the client when one queue's
                # worth of work will have drained.
                self._send(503, {"error": str(e)},
                           retry_after=min(request_timeout, 1.0))
                return
            except TimeoutError as e:
                self._send(504, {"error": str(e)})
                return
            except ValueError as e:
                self._send(400, {"error": str(e)})
                return
            except Exception as e:
                self._send(500, {"error": str(e)})
                return
            self._send(200, {
                "keypoints": np.asarray(kpts).round(2).tolist(),
                "scores": np.asarray(scores).round(4).tolist(),
                "keypoint_names": names,
            })

        def log_message(self, fmt, *args):  # route through print, quietly
            pass

    class Server(ThreadingHTTPServer):
        # The stdlib default listen backlog is 5: a burst of >5
        # simultaneous connects (128-client overload probe) overflows
        # the SYN queue and clients see ECONNRESET before the app ever
        # got a say.  Admission control belongs to the bounded batcher
        # queue (503), not the kernel backlog.
        request_queue_size = 256

    server = Server((host, port), Handler)
    return server, batcher


def _load_calibration_crops(directory: str, cfg, limit: int) -> np.ndarray:
    """Up to ``limit`` images of ``directory`` (name order) as normalised
    model-input crops for PTQ calibration: resized to the input size,
    (rgb - mean * 255) / (std * 255)."""
    import cv2

    W, H = cfg.data.input_size
    mean = np.asarray(cfg.data.pixel_mean, np.float32) * 255.0
    std = np.asarray(cfg.data.pixel_std, np.float32) * 255.0
    crops = []
    for name in sorted(os.listdir(directory)):
        if not name.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
            continue
        img = cv2.imread(os.path.join(directory, name))
        if img is None:
            continue
        rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        crop = cv2.resize(rgb, (W, H)).astype(np.float32)
        crops.append((crop - mean) / std)
        if len(crops) >= limit:
            break
    if not crops:
        raise SystemExit(f"no readable images in {directory}")
    return np.stack(crops)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Batched pose HTTP server")
    add_config_args(parser)
    add_serving_args(parser)
    parser.add_argument("--calibration-dir", default=None, metavar="DIR",
                        help="directory of representative images for int8 "
                             "PTQ calibration; without it calibration "
                             "happens on the first real request batch")
    parser.add_argument("--calibration-size", type=int, default=64,
                        help="max images read from --calibration-dir")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-batch", type=int, default=64,
                        help="largest device batch one dispatch may form")
    parser.add_argument("--batch-window", type=float, default=5.0,
                        metavar="MS", help="how long the dispatcher waits "
                        "for a burst to accumulate (ms)")
    parser.add_argument("--dispatch-depth", type=int, default=2,
                        help="device batches in flight at once (1 = "
                             "blocking dispatch; 2 overlaps batch N+1's "
                             "host work with batch N's compute)")
    parser.add_argument("--queue-depth", type=int, default=0,
                        help="max pending requests before new ones are "
                             "shed with 503 + Retry-After (default: "
                             "4 x max-batch x dispatch-depth)")
    parser.add_argument("--request-timeout", type=float, default=60.0,
                        metavar="S", help="per-request deadline; expired "
                        "requests are dropped before device dispatch")
    args = parser.parse_args(argv)
    cfg = resolve_config(args)
    calib = None
    if args.int8 and args.calibration_dir:
        calib = _load_calibration_crops(args.calibration_dir, cfg,
                                        args.calibration_size)
        print(f"calibrating int8 PTQ on {len(calib)} crops from "
              f"{args.calibration_dir}", flush=True)
    grid = make_grid(args)
    infer = make_inference(args, cfg, calib, grid)
    if grid is not None:
        if grid.rank != 0:
            follow(infer, grid)
            return
        infer = GridLeader(infer, grid)
        args.dispatch_depth = 1  # one group in flight: one collective order
    W, H = cfg.data.input_size
    if args.int8 and calib is None:
        # a warm-up request would freeze the PTQ ranges on a black frame:
        # leave calibration to the first real batch
        print("int8 without --calibration-dir: PTQ calibrates on the first "
              "request batch", flush=True)
    else:
        # build the kernels and the first batch's plans before taking
        # traffic
        infer.predict_batch(np.zeros((1, H, W, 3), np.uint8),
                            np.asarray([[0, 0, W, H]], np.float32))
    server, batcher = make_server(infer, args.host, args.port,
                                  args.max_batch, args.batch_window,
                                  depth=args.dispatch_depth,
                                  queue_depth=args.queue_depth,
                                  request_timeout=args.request_timeout)
    mode = ("int8" if infer.quantize
            else "folded" if infer.fold else "unfolded")
    print(f"serving {cfg.model.backbone}+{cfg.model.head_type} "
          f"({mode}) on {infer.device} at "
          f"http://{args.host}:{args.port}  (POST /predict, GET /healthz)",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.stop()
        server.server_close()
        if grid is not None:
            infer.stop()


if __name__ == "__main__":
    main()
