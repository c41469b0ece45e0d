"""PyTorch port, streamed, directory and video prediction against the JAX
package on the CPU: ``PoseInference.predict_stream`` (with the prefetch
stage), ``predict_directory`` (PNG and JPEG written with cv2) and
``predict_video`` (a short MJPG clip written with ``cv2.VideoWriter``),
each side's default serving (BN-fold) on the tiny HRNet + fusion head of
tests/torch_tiny.py, whose weights are seeded numpy on
``jax.eval_shape``'s tree.  Also the native decoder against cv2 and
``prefetch_to_device`` stopping when its consumer stops.

Flip test is off here (the flip path is held against JAX by
tests/test_torch_serving.py and tests/test_torch_hrnet.py): it halves the
JAX side's compiles, one per batch shape.  Keypoints: float32 on both
sides, within 1e-3 px of frame coordinates off decode ties (a
soft-argmax within 1e-3 of a half-integer), scores within 1e-4.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from infantposeestimation_gaussianbias_tpu import inference as jinference
from infantposeestimation_gaussianbias_tpu.config import get_config as jget_config
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu_torch import (Config, PoseInference,
                                                          native)
from infantposeestimation_gaussianbias_tpu_torch.data import (
    prefetch_to_device)
from infantposeestimation_gaussianbias_tpu_torch.ops import decode
from infantposeestimation_gaussianbias_tpu_torch.weights import (
    state_dict_from_jax,
)
from tests import torch_tiny
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

SIZE = torch_tiny.SIZE
FRAME_HW = (72, 88)


@pytest.fixture(scope="module")
def pair():
    """(port PoseInference, JAX PoseInference), each side's default
    serving (folded), flip off, ``hrnet_tiny`` registered for the
    module."""
    with torch_tiny.registered():
        jcfg = torch_tiny.tiny_cfg(jget_config(), "fusion")
        cfg = torch_tiny.tiny_cfg(Config(), "fusion")
        for c in (cfg, jcfg):
            c.eval.flip_test = False
            c.temporal.enabled = True
        jmodel = jpe.build_model(jcfg)
        variables = torch_tiny.random_variables(jmodel, seed=30)
        jinf = jinference.PoseInference(jcfg, state=SimpleNamespace(
            apply_fn=jmodel.apply,
            variables=jax.tree_util.tree_map(jnp.asarray, variables)))
        port = PoseInference(cfg, state_dict=state_dict_from_jax(
            variables["params"], variables["batch_stats"]), device="cpu")
        assert port.fold
        yield port, jinf


def _ties(port, crops_u8: np.ndarray) -> np.ndarray:
    """(B, K) keypoints whose soft-argmax lies within 1e-3 of a
    half-integer (round() may move the refine window either way)."""
    cfg = port.cfg
    mean = np.asarray(cfg.data.pixel_mean, np.float32) * 255.0
    std = np.asarray(cfg.data.pixel_std, np.float32) * 255.0
    x = torch.from_numpy((crops_u8.astype(np.float32) - mean) / std)
    with torch.no_grad():
        g, _ = decode.soft_argmax(port.model(x)["heatmaps"])
    return (np.abs(g.numpy() % 1.0 - 0.5) < 1e-3).any(axis=-1)


def _close(port_out, jax_out, ties):
    (k, s), (jk, js) = port_out, jax_out
    keep = ~ties
    assert keep.sum() >= keep.size // 2
    np.testing.assert_allclose(k[keep], jk[keep], atol=1e-3)
    np.testing.assert_allclose(s, js, atol=1e-4)


def _stream_batches(sizes, seed=31):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        out.append({
            "image_u8": rng.randint(0, 256, (n, SIZE, SIZE, 3)).astype(
                np.uint8),
            "center": rng.uniform(40, 200, (n, 2)).astype(np.float32),
            "scale": rng.uniform(60, 160, (n, 2)).astype(np.float32),
            "tag": n})
    return out


def test_predict_stream_matches_jax(pair):
    """Three batches (4, 4 and a ragged 3), two in flight: every yielded
    batch equal to the same crops through ``crops_pipeline`` bit for bit,
    and close to JAX's ``predict_stream``."""
    port, jinf = pair
    batches = _stream_batches((4, 4, 3))
    got = list(port.predict_stream(iter(batches), max_in_flight=2))
    want = list(jinf.predict_stream(iter(batches), max_in_flight=2))
    assert len(got) == len(want) == 3
    for b, g, w in zip(batches, got, want):
        assert g[0].shape == (b["tag"], 17, 2) and g[1].shape == (b["tag"],
                                                                   17)
        c, s = port.crops_pipeline(*(torch.from_numpy(b[k]) for k in (
            "image_u8", "center", "scale")))
        np.testing.assert_array_equal(g[0], c.numpy())
        np.testing.assert_array_equal(g[1], s.numpy())
        _close(g, w, _ties(port, b["image_u8"]))


def test_predict_directory_matches_jax(pair, tmp_path):
    """Four images of one shape (PNG and JPEG) and one of another, and a
    file that is not an image: the same names, keypoints and scores."""
    port, jinf = pair
    rng = np.random.RandomState(32)
    for i, ext in enumerate((".png", ".jpg", ".png", ".jpeg")):
        cv2.imwrite(str(tmp_path / f"a{i}{ext}"),
                    rng.randint(0, 256, (*FRAME_HW, 3)).astype(np.uint8))
    cv2.imwrite(str(tmp_path / "b.png"),
                rng.randint(0, 256, (50, 60, 3)).astype(np.uint8))
    (tmp_path / "notes.txt").write_text("not an image")
    got = port.predict_directory(str(tmp_path))
    want = jinf.predict_directory(str(tmp_path))
    assert list(got) == list(want) == ["a0.png", "a1.jpg", "a2.png",
                                       "a3.jpeg", "b.png"]
    for name in got:
        g, w = got[name], want[name]
        assert g["keypoints"].shape == (17, 2)
        np.testing.assert_allclose(g["keypoints"], w["keypoints"], atol=1e-3)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4)


def test_predict_video_matches_jax(pair, tmp_path):
    """An 8-frame MJPG clip, temporal smoothing on (gaussian, window 5):
    the same trajectory, scores and fps."""
    port, jinf = pair
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 12.0,
                             FRAME_HW[::-1])
    rng = np.random.RandomState(33)
    for _ in range(8):
        writer.write(rng.randint(0, 256, (*FRAME_HW, 3)).astype(np.uint8))
    writer.release()
    traj, scores, fps = port.predict_video(path)
    jtraj, jscores, jfps = jinf.predict_video(path)
    assert traj.shape == (8, 17, 2) and scores.shape == (8, 17)
    assert fps == jfps
    np.testing.assert_allclose(traj, jtraj, atol=1e-3)
    np.testing.assert_allclose(scores, jscores, atol=1e-4)
    unsmoothed, _, _ = port.predict_video(path, temporal_smooth=False)
    assert not np.allclose(unsmoothed, traj)


def test_native_decode_matches_cv2():
    """The port's native decoder, where g++ and libjpeg build it: JPEG
    within 1 (libjpeg under both), PNG exact."""
    if not native.available():
        pytest.skip("the native decoder does not build here")
    rng = np.random.RandomState(34)
    img = cv2.GaussianBlur(rng.randint(0, 256, (45, 61, 3)).astype(np.uint8),
                           (5, 5), 0)
    for ext, tol in ((".jpg", 1), (".png", 0)):
        if ext == ".png" and not native.has_png():
            continue
        ok, enc = cv2.imencode(ext, img)
        assert ok
        data = enc.tobytes()
        ref = cv2.cvtColor(cv2.imdecode(enc, cv2.IMREAD_COLOR),
                           cv2.COLOR_BGR2RGB)
        assert native.image_dims(data) == (61, 45)
        dec = native.decode_rgb(data)
        assert dec.shape == ref.shape
        assert int(np.abs(dec.astype(int) - ref.astype(int)).max()) <= tol
    with pytest.raises(ValueError):
        native.decode_rgb(b"\xff\xd8\xff" + b"\0" * 20)


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "ipe-prefetch"]


def test_prefetch_stops_when_the_consumer_breaks():
    """A consumer that stops after one batch of an endless source stops
    the transfer thread; a source that raises raises in the consumer."""
    def endless():
        i = 0
        while True:
            yield {"x": np.full(4, i), "meta": i}
            i += 1

    stream = prefetch_to_device(endless(), size=2, keys=("x",), device="cpu")
    first = next(stream)
    assert torch.equal(first["x"], torch.zeros(4, dtype=torch.int64))
    assert first["meta"] == 0
    stream.close()
    deadline = time.monotonic() + 5.0
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _prefetch_threads()

    def failing():
        yield {"x": np.zeros(2)}
        raise OSError("source failed")

    got = []
    with pytest.raises(OSError, match="source failed"):
        for b in prefetch_to_device(failing(), size=2, device="cpu"):
            got.append(b)
    assert len(got) == 1
