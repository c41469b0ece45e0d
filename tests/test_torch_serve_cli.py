"""PyTorch port, the HTTP server and the inference CLI against the JAX
package on the CPU.

The port's server (``cli.serve.make_server``) and the JAX package's run
side by side on the same tiny HRNet + fusion head (tests/torch_tiny.py;
seeded numpy weights on ``jax.eval_shape``'s tree), each with its
default serving (BN-fold), and get the same ``.npy`` requests: their
answers agree within the answers' rounding (keypoints to 0.01 px, scores
to 1e-4) plus 1e-3 px, off decode ties.  Then, on the port's server:
concurrent requests micro-batched, bad requests, 503 with Retry-After
when the queue is full, 504 for a request past its deadline; and the
``infer`` CLI on an image, a directory and a video, with a ``torch.save``d
checkpoint.  Flip test is off (it is held against JAX by
tests/test_torch_serving.py): the JAX side compiles once per batch
bucket.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from infantposeestimation_gaussianbias_tpu import inference as jinference
from infantposeestimation_gaussianbias_tpu.cli import serve as jserve
from infantposeestimation_gaussianbias_tpu.config import get_config as jget_config
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu_torch import Config, PoseInference
from infantposeestimation_gaussianbias_tpu_torch.cli import infer, serve
from infantposeestimation_gaussianbias_tpu_torch.ops import affine, decode
from infantposeestimation_gaussianbias_tpu_torch.schemas import COCO17
from infantposeestimation_gaussianbias_tpu_torch.weights import (
    state_dict_from_jax,
)
from tests import torch_tiny
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

FRAME_HW = (72, 88)
TINY_SET = ["model.backbone=hrnet_tiny", "model.head_type=fusion",
            "model.hrnet_stage_modules=1,1,1", "model.hidden_dim=16",
            "model.compute_dtype=float32", "data.input_size=64,64",
            "data.heatmap_size=16,16", "eval.flip_test=false"]


class _Recorder:
    """A PoseInference that records the size of every dispatched batch."""

    def __init__(self, inf):
        self._inf = inf
        self.sizes = []

    def __getattr__(self, name):
        return getattr(self._inf, name)

    def predict_batch(self, frames, bboxes):
        self.sizes.append(len(frames))
        return self._inf.predict_batch(frames, bboxes)


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv, batcher):
    srv.shutdown()
    batcher.stop()
    srv.server_close()


@pytest.fixture(scope="module")
def servers():
    """(port base URL, JAX base URL, port Recorder, variables) with
    ``hrnet_tiny`` registered for the module."""
    with torch_tiny.registered():
        jcfg = torch_tiny.tiny_cfg(jget_config(), "fusion")
        cfg = torch_tiny.tiny_cfg(Config(), "fusion")
        for c in (cfg, jcfg):
            c.eval.flip_test = False
        jmodel = jpe.build_model(jcfg)
        variables = torch_tiny.random_variables(jmodel, seed=40)
        jinf = jinference.PoseInference(jcfg, state=SimpleNamespace(
            apply_fn=jmodel.apply,
            variables=jax.tree_util.tree_map(jnp.asarray, variables)))
        port = _Recorder(PoseInference(cfg, state_dict=state_dict_from_jax(
            variables["params"], variables["batch_stats"]), device="cpu"))
        srv, batcher = serve.make_server(port, port=0, max_batch=8,
                                         window_ms=30.0)
        jsrv, jbatcher = jserve.make_server(jinf, port=0, max_batch=8,
                                            window_ms=30.0)
        try:
            yield _start(srv), _start(jsrv), port, variables
        finally:
            _stop(srv, batcher)
            _stop(jsrv, jbatcher)


def _post(base, body, content_type="application/x-npy", query="",
          timeout=120):
    req = urllib.request.Request(base + "/predict" + query, data=body,
                                 headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _npy(frame):
    buf = io.BytesIO()
    np.save(buf, frame)
    return buf.getvalue()


def _ties(inf, frames, bboxes):
    """(B, K) keypoints whose soft-argmax lies within 1e-3 of a
    half-integer, where the refine window may move either way."""
    cfg = inf.cfg
    centers = (bboxes[:, :2] + bboxes[:, 2:]) / 2
    scales = (bboxes[:, 2:] - bboxes[:, :2]) * cfg.data.bbox_padding
    with torch.no_grad():
        crops = affine.crop_and_normalize(
            torch.from_numpy(frames), torch.from_numpy(centers),
            torch.from_numpy(scales), cfg.data.input_size)
        g, _ = decode.soft_argmax(inf.model(crops)["heatmaps"])
    return (np.abs(g.numpy() % 1.0 - 0.5) < 1e-3).any(axis=-1)


def _agree(payloads, jpayloads, ties):
    for p, jp, tie in zip(payloads, jpayloads, ties):
        k, jk = np.asarray(p["keypoints"]), np.asarray(jp["keypoints"])
        np.testing.assert_allclose(k[~tie], jk[~tie], atol=0.011)
        np.testing.assert_allclose(p["scores"], jp["scores"], atol=2e-4)
        assert p["keypoint_names"] == jp["keypoint_names"]


def test_healthz_matches_jax(servers):
    base, jbase, port, _ = servers
    out = []
    for b in (base, jbase):
        with urllib.request.urlopen(b + "/healthz", timeout=30) as r:
            out.append(json.loads(r.read()))
    for key in ("status", "backbone", "head", "num_keypoints", "precision"):
        assert out[0][key] == out[1][key], key
    assert out[0]["status"] == "ok" and out[0]["fold"] is True
    assert out[0]["device"] == "cpu"


def test_answers_match_jax(servers):
    """One frame with a box, one without: the same answers from both
    servers, and the port's equal to its own ``predict_batch``."""
    base, jbase, port, _ = servers
    rng = np.random.RandomState(41)
    frame = rng.randint(0, 256, (*FRAME_HW, 3)).astype(np.uint8)
    for query, box in (("?bbox=5,4,80,70", [5, 4, 80, 70]),
                       ("", [0, 0, FRAME_HW[1], FRAME_HW[0]])):
        status, payload, _ = _post(base, _npy(frame), query=query)
        jstatus, jpayload, _ = _post(jbase, _npy(frame), query=query)
        assert status == jstatus == 200
        bbox = np.asarray([box], np.float32)
        _agree([payload], [jpayload], _ties(port, frame[None], bbox))
        k, s = port.predict_batch(frame[None], bbox)
        np.testing.assert_allclose(payload["keypoints"], k[0], atol=0.006)
        np.testing.assert_allclose(payload["scores"], s[0], atol=6e-5)


def test_concurrent_requests_micro_batch(servers):
    """Eight concurrent same-shape posts to each server: the port's are
    served from shared batches, and every answer agrees with JAX's and
    with one direct batched call."""
    base, jbase, port, _ = servers
    rng = np.random.RandomState(42)
    frames = rng.randint(0, 256, (8, *FRAME_HW, 3)).astype(np.uint8)
    results = {}

    def call(b, i):
        results[(b, i)] = _post(b, _npy(frames[i]))

    port.sizes.clear()
    threads = [threading.Thread(target=call, args=(b, i))
               for b in (base, jbase) for i in range(len(frames))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(results[(b, i)][0] == 200
               for b in (base, jbase) for i in range(len(frames)))
    assert sum(port.sizes) == len(frames) and max(port.sizes) > 1, \
        port.sizes
    bboxes = np.asarray([[0, 0, FRAME_HW[1], FRAME_HW[0]]] * len(frames),
                        np.float32)
    payloads = [results[(base, i)][1] for i in range(len(frames))]
    _agree(payloads, [results[(jbase, i)][1] for i in range(len(frames))],
           _ties(port, frames, bboxes))
    k, _ = port.predict_batch(frames, bboxes)
    for i, p in enumerate(payloads):
        np.testing.assert_allclose(p["keypoints"], k[i], atol=0.006)


def test_image_bodies_and_bad_requests(servers):
    """A PNG body answers as its pixels sent as .npy; a JPEG body
    decodes; an undecodable body, a malformed bbox and a 2-D array are
    400, an unknown path 404."""
    base, _, _, _ = servers
    rng = np.random.RandomState(43)
    frame = cv2.GaussianBlur(rng.randint(0, 256, (*FRAME_HW, 3)).astype(
        np.uint8), (5, 5), 0)
    _, png = cv2.imencode(".png", cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    s_png, p_png, _ = _post(base, png.tobytes(), "image/png")
    s_npy, p_npy, _ = _post(base, _npy(frame))
    assert s_png == s_npy == 200
    assert p_png == p_npy
    _, jpg = cv2.imencode(".jpg", frame)
    assert _post(base, jpg.tobytes(), "image/jpeg")[0] == 200
    assert _post(base, b"not an image", "image/jpeg")[0] == 400
    status, payload, _ = _post(base, _npy(frame), query="?bbox=1,2,3")
    assert status == 400 and "bbox" in payload["error"]
    assert _post(base, _npy(np.zeros((4, 4), np.uint8)))[0] == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/nope", timeout=30)
    assert e.value.code == 404


class _BlockedInfer:
    """A PoseInference stand-in whose card is saturated until ``release``
    is set."""

    def __init__(self):
        self.cfg = torch_tiny.tiny_cfg(Config(), "fusion")
        self.schema = COCO17
        self.quantize, self.fold, self.device = False, True, "cpu"
        self.release = threading.Event()
        self.calls = []

    def predict_batch(self, frames, bboxes):
        self.release.wait(timeout=60)
        self.calls.append(len(frames))
        B, K = len(frames), self.schema.num_keypoints
        return np.zeros((B, K, 2), np.float32), np.ones((B, K), np.float32)


def test_full_queue_503_and_expired_504():
    """Against a blocked card, with one batch in flight and a queue of 2:
    excess posts get 503 with Retry-After; a post whose 0.5 s deadline
    passes gets 504, and an expired request never reaches the card."""
    stub = _BlockedInfer()
    srv, batcher = serve.make_server(stub, port=0, max_batch=1,
                                     window_ms=0.0, depth=1, queue_depth=2,
                                     request_timeout=0.5)
    base = _start(srv)
    try:
        n = 8
        results = [None] * n

        def call(i):
            results[i] = _post(base, _npy(np.zeros((8, 8, 3), np.uint8)),
                               timeout=60)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        codes = [r[0] for r in results]
        assert 503 in codes and 504 in codes, codes
        for status, payload, headers in results:
            if status == 503:
                assert headers.get("Retry-After") is not None
                assert "queue full" in payload["error"]
        stub.release.set()
        deadline = time.monotonic() + 10
        while batcher.q.qsize() and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.2)
        # only the request dispatched before the deadlines passed ran
        assert sum(stub.calls) <= 1, stub.calls
    finally:
        stub.release.set()
        _stop(srv, batcher)


def test_pipelined_dispatch_overlaps_batches():
    """Two shape groups of one drain enter predict_batch together, at most
    ``depth`` at once."""
    lock = threading.Lock()
    state = {"now": 0, "peak": 0}
    overlapped = threading.Event()  # two batches were inside at once

    class SlowInfer:
        def predict_batch(self, frames, bboxes):
            with lock:
                state["now"] += 1
                state["peak"] = max(state["peak"], state["now"])
                if state["now"] == 2:
                    overlapped.set()
            overlapped.wait(timeout=10)
            time.sleep(0.05)
            with lock:
                state["now"] -= 1
            n = len(frames)
            return np.zeros((n, 17, 2)), np.ones((n, 17))

    mb = serve.MicroBatcher(SlowInfer(), max_batch=4, window_s=0.0, depth=2)
    try:
        frames = [np.zeros((8 * (1 + i % 2), 8, 3), np.uint8)
                  for i in range(4)]
        bbox = np.asarray([0, 0, 8, 8], np.float32)
        threads = [threading.Thread(target=mb.submit, args=(f, bbox))
                   for f in frames]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        mb.stop()
    assert state["peak"] == 2


def test_infer_cli(servers, tmp_path, capsys):
    """``infer.main`` with a ``torch.save``d checkpoint on the CPU: an
    image (with the skeleton drawn), a directory and a video print what
    the port's PoseInference predicts; a video's --output (the video with
    the skeleton drawn, every frame) and --clinical-report (the figure);
    the video again with --int8; --mesh without torchrun's environment
    serves as the one process (a 1 x 1 grid) and prints the same."""
    _, _, port, variables = servers
    ckpt = tmp_path / "tiny.pt"
    torch.save(state_dict_from_jax(variables["params"],
                                   variables["batch_stats"]), ckpt)
    args = ["--device", "cpu", "--checkpoint", str(ckpt), "--set",
            *TINY_SET]
    rng = np.random.RandomState(44)
    frame = rng.randint(0, 256, (*FRAME_HW, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "im.png"), cv2.cvtColor(frame,
                                                       cv2.COLOR_RGB2BGR))
    out = tmp_path / "drawn.png"
    with torch_tiny.registered():
        infer.main(["--input", str(tmp_path / "im.png"), "--output",
                    str(out), *args])
        printed = capsys.readouterr().out
        k, s = port.predict(frame)
        first = printed.splitlines()[0]
        assert first.startswith(f"{COCO17.keypoint_names[0]:>16}: "
                                f"({k[0, 0]:7.1f}, {k[0, 1]:7.1f})"), first
        assert cv2.imread(str(out)).shape == (*FRAME_HW, 3)
        infer.main(["--input", str(tmp_path), *args])
        assert "im.png: mean score" in capsys.readouterr().out
        video = str(tmp_path / "clip.avi")
        writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"),
                                 10.0, FRAME_HW[::-1])
        for _ in range(3):
            writer.write(frame)
        writer.release()
        infer.main(["--input", video, *args])
        assert "processed 3 frames @ 10.0 fps" in capsys.readouterr().out
        drawn, report = tmp_path / "drawn.mp4", tmp_path / "report.png"
        infer.main(["--input", video, "--output", str(drawn),
                    "--clinical-report", str(report), *args])
        printed = capsys.readouterr().out
        assert f"wrote {drawn}" in printed and f"wrote {report}" in printed
        cap = cv2.VideoCapture(str(drawn))
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
        ok, first = cap.read()
        cap.release()
        assert ok and first.shape == (*FRAME_HW, 3)
        assert cv2.imread(str(report)) is not None
        # --int8: the video's first batch of 3 frames calibrates (with the
        # small-calibration warning), then every frame is served in int8
        with pytest.warns(UserWarning, match="self-calibrating"):
            infer.main(["--input", video, "--int8", *args])
        assert "processed 3 frames @ 10.0 fps" in capsys.readouterr().out
        infer.main(["--input", str(tmp_path / "im.png"), *args])
        plain = capsys.readouterr().out
        infer.main(["--input", str(tmp_path / "im.png"), "--mesh",
                    "--backend", "gloo", *args])
        assert capsys.readouterr().out == plain
