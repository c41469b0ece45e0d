"""HTTP serving probe: concurrent clients against the micro-batching server.

Port of infantposeestimation_gaussianbias_tpu/tools/probe_serve_http.py.
It measures the whole serving surface that ``cli/serve.py`` exposes
(HTTP parse -> frame decode -> MicroBatcher -> device batch -> JSON) under
concurrent load on one card: sustained requests/s, the latency of the
accepted requests, the batch sizes the dispatcher formed and the wall
time of each dispatched ``predict_batch`` (so that a request's latency
splits into the batch's own time and the rest: queueing, HTTP, JSON).

    python -m infantposeestimation_gaussianbias_tpu_torch.tools.probe_serve_http

Env: PROBE_CLIENTS (default 32), PROBE_REQS (per client, default 40),
PROBE_QUANT (default 1: int8 PTQ; 0 serves BN-folded bf16),
PROBE_WINDOW_MS (default 5), PROBE_MAX_BATCH (default 64), PROBE_FRAME
(default 256, square npy frame), PROBE_QUEUE_DEPTH (default 0 = 4 x
max-batch x depth), PROBE_TIMEOUT_S (per-request deadline, default 60).

Overload/saturation row: run with clients >> capacity (e.g.
PROBE_CLIENTS=128) and a tight PROBE_QUEUE_DEPTH: 503-shed responses are
counted apart from transport errors, so the output shows goodput (200s/s),
shed rate, and whether p95 of the ACCEPTED requests stays bounded while
the server rejects the excess at admission.
"""

from __future__ import annotations

import http.client
import io
import json
import os
import threading
import time
from typing import Dict

import numpy as np


def probe_config():
    """The probe's model: hrnet_w32 + fusion, bf16, 256x192, no flip."""
    from ..config import Config

    cfg = Config()
    cfg.model.backbone = "hrnet_w32"
    cfg.model.head_type = "fusion"
    cfg.model.compute_dtype = "bfloat16"
    cfg.data.input_size = (192, 256)
    cfg.data.heatmap_size = (48, 64)
    cfg.eval.flip_test = False
    return cfg


def main(cfg=None, device="cuda") -> Dict:
    """Run the probe on ``cfg`` (``probe_config()`` when None) on
    ``device``; prints and returns the result."""
    from ..cli.serve import make_server
    from ..inference import PoseInference

    clients = int(os.environ.get("PROBE_CLIENTS", "32"))
    reqs = int(os.environ.get("PROBE_REQS", "40"))
    quant = os.environ.get("PROBE_QUANT", "1") == "1"
    window_ms = float(os.environ.get("PROBE_WINDOW_MS", "5"))
    max_batch = int(os.environ.get("PROBE_MAX_BATCH", "64"))
    side = int(os.environ.get("PROBE_FRAME", "256"))
    queue_depth = int(os.environ.get("PROBE_QUEUE_DEPTH", "0"))
    timeout_s = float(os.environ.get("PROBE_TIMEOUT_S", "60"))

    cfg = probe_config() if cfg is None else cfg
    W, H = cfg.data.input_size
    rng = np.random.RandomState(0)
    calib = None
    if quant:
        # calibrate the PTQ ranges up front, so that the first request
        # batch does not freeze the scales on a single frame
        calib = rng.randn(64, H, W, 3).astype(np.float32)
    infer = PoseInference(cfg, device=device, quantize=quant,
                          calibration_crops=calib)

    # every batch the dispatcher forms: its size and its wall ms
    batches = []
    real_predict = infer.predict_batch

    def tracked_predict(frames, bboxes):
        t0 = time.perf_counter()
        out = real_predict(frames, bboxes)
        batches.append((len(frames), (time.perf_counter() - t0) * 1e3))
        return out

    infer.predict_batch = tracked_predict

    # warm every power-of-two bucket at the clients' frame shape
    # (predict_batch pads to these buckets: the kernels' plans and cuDNN's
    # algorithms are chosen per batch size on first use)
    b = 1
    while b <= max_batch:
        warm = np.zeros((b, side, side, 3), np.uint8)
        bbox = np.tile(np.asarray([[0, 0, side, side]], np.float32), (b, 1))
        real_predict(warm, bbox)
        b *= 2

    server, batcher = make_server(infer, host="127.0.0.1", port=0,
                                  max_batch=max_batch, window_ms=window_ms,
                                  queue_depth=queue_depth,
                                  request_timeout=timeout_s)
    port = server.server_address[1]
    srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
    srv_thread.start()

    # one npy frame shared by all clients (the server decodes each request)
    frame = rng.randint(0, 255, (side, side, 3), np.uint8)
    buf = io.BytesIO()
    np.save(buf, frame)
    body = buf.getvalue()

    lat_lock = threading.Lock()
    latencies = []
    shed = []       # 503 admission rejections (expected under overload)
    timeouts = []   # 504 deadline expiries
    errors = []     # transport failures / unexpected statuses

    def client(n_requests: int):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        for _ in range(n_requests):
            t0 = time.perf_counter()
            try:
                conn.request("POST", "/predict", body=body,
                             headers={"Content-Type": "application/x-npy"})
                resp = conn.getresponse()
                payload = resp.read()
                if resp.status == 503:
                    with lat_lock:
                        shed.append(resp.headers.get("Retry-After"))
                    continue
                if resp.status == 504:
                    with lat_lock:
                        timeouts.append(time.perf_counter() - t0)
                    continue
                if resp.status != 200:
                    raise RuntimeError(payload[:200])
            except (OSError, http.client.HTTPException, RuntimeError) as e:
                with lat_lock:
                    errors.append(repr(e))
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=120)
                continue
            with lat_lock:
                latencies.append(time.perf_counter() - t0)
        conn.close()

    try:
        # warm-up burst (not timed): the dispatcher and the JSON path
        warm_threads = [threading.Thread(target=client, args=(4,))
                        for _ in range(min(4, clients))]
        for t in warm_threads:
            t.start()
        for t in warm_threads:
            t.join()
        for record in (latencies, shed, timeouts, errors, batches):
            record.clear()

        threads = [threading.Thread(target=client, args=(reqs,))
                   for _ in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        batcher.stop()
        server.server_close()

    n_ok = len(latencies)
    lat = np.sort(np.asarray(latencies)) * 1e3
    if lat.size == 0:
        lat = np.asarray([0.0])
    sizes = np.asarray([n for n, _ in batches] or [0])
    batch_ms = np.asarray([ms for _, ms in batches] or [0.0])
    out = {
        "requests_per_sec": n_ok / wall,
        "clients": clients,
        "requests_ok": n_ok,
        "shed_503": len(shed),
        "timeout_504": len(timeouts),
        "errors": len(errors),
        "queue_depth": batcher.queue_depth,
        "latency_ms_p50": float(np.percentile(lat, 50)),
        "latency_ms_p95": float(np.percentile(lat, 95)),
        "latency_ms_p99": float(np.percentile(lat, 99)),
        "mean_device_batch": float(sizes.mean()),
        "max_device_batch": int(sizes.max()),
        "num_device_batches": len(batches),
        "batch_sizes": sorted({int(n) for n in sizes}),
        "batch_ms_p50": float(np.percentile(batch_ms, 50)),
        "batch_ms_sum": float(batch_ms.sum()),
        "wall_s": wall,
        "window_ms": window_ms,
        "precision": ("int8-ptq" if quant else cfg.model.compute_dtype
                      + ("-fold" if infer.fold else "")),
        "frame": f"{side}x{side} npy",
        "device": str(infer.device),
    }
    if errors:
        out["first_error"] = errors[0]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
