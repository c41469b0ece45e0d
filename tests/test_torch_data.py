"""PyTorch port, data layer: the COCO index and records, the augmentation
transforms, ``PoseDataset`` (cv2 and native paths), the threaded
``DataLoader``, ``build_dataloader``, ``device_batch`` and the native
fused decode + warp, against the JAX package on the CPU.

Everything here is numpy, cv2 and the same C++ source on both sides, with
the same per-sample seeds: crops, keypoints, visibility, centres, scales
and ``valid`` must be equal bit for bit.  ``device_batch`` normalises with
the same float32 operations: equal to 1e-6.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from infantposeestimation_gaussianbias_tpu import data as jdata
from infantposeestimation_gaussianbias_tpu import native as jnative
from infantposeestimation_gaussianbias_tpu.config import get_variant as jget
from infantposeestimation_gaussianbias_tpu.data import pipeline as jpipeline
from infantposeestimation_gaussianbias_tpu_torch import data, native
from infantposeestimation_gaussianbias_tpu_torch.config import get_variant
from infantposeestimation_gaussianbias_tpu_torch.data import pipeline
from infantposeestimation_gaussianbias_tpu_torch.native import binding

N_IMAGES = 10
INPUT = (96, 128)  # (width, height) of the crops
KEYS = ("image_u8", "keypoints", "visible", "center", "scale", "image_id",
        "ann_id", "area", "valid")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: several test processes share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """A synthetic COCO set on disk (the port's generator, equal to the JAX
    package's, images and all), one image as PNG, the annotation JSON;
    returns (root, gt)."""
    root = tmp_path_factory.mktemp("coco")
    os.makedirs(root / "images")
    os.makedirs(root / "jax_images")
    gt = data.synthetic_coco_dataset(num_images=N_IMAGES,
                                     image_dir=str(root / "images"), seed=4)
    assert gt == jdata.synthetic_coco_dataset(
        num_images=N_IMAGES, image_dir=str(root / "jax_images"), seed=4)
    for im in gt["images"]:
        assert (root / "images" / im["file_name"]).read_bytes() == \
            (root / "jax_images" / im["file_name"]).read_bytes()
    img = cv2.imread(str(root / "images" / gt["images"][-1]["file_name"]))
    cv2.imwrite(str(root / "images" / "synth_png.png"), img)
    gt["images"][-1]["file_name"] = "synth_png.png"
    os.makedirs(root / "annotations")
    for name in ("train", "val"):
        with open(root / "annotations" / f"{name}.json", "w") as f:
            json.dump(gt, f)
    return root, gt


def _cfgs(root, **data_fields):
    """(port cfg, JAX cfg) on the disk set, hrformer_base's augmentation
    with every geometric option on."""
    out = []
    for cfg in (get_variant("hrformer_base"), jget("hrformer_base")):
        d = cfg.data
        d.data_root = str(root)
        d.train_ann, d.val_ann = "annotations/train.json", "annotations/val.json"
        d.train_img_prefix = d.val_img_prefix = "images/"
        d.input_size = INPUT
        d.vertical_flip_prob = 0.3
        d.shift_factor, d.shift_prob = 0.16, 0.5
        for k, v in data_fields.items():
            setattr(d, k, v)
        cfg.train.global_batch_size = 4
        cfg.eval.batch_size = 3
        out.append(cfg)
    return out


def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def _records(gt):
    return (data.build_records(data.CocoIndex(dataset=gt)),
            jdata.build_records(jdata.CocoIndex(dataset=gt)))


@pytest.mark.parametrize("one_per_image", [False, True])
def test_records_match_jax(disk, one_per_image):
    _, gt = disk
    gt = json.loads(json.dumps(gt))
    extra = dict(gt["annotations"][0], id=99, bbox=[5.0, 6.0, 40.0, 30.0])
    crowd = dict(gt["annotations"][1], id=100, iscrowd=1)
    empty = dict(gt["annotations"][2], id=101, num_keypoints=0)
    gt["annotations"] += [extra, crowd, empty]
    port = data.build_records(data.CocoIndex(dataset=gt), "pre",
                              bbox_padding=1.3, one_per_image=one_per_image)
    ref = jdata.build_records(jdata.CocoIndex(dataset=gt), "pre",
                              bbox_padding=1.3, one_per_image=one_per_image)
    assert len(port) == len(ref) == N_IMAGES + (0 if one_per_image else 1)
    for a, b in zip(port, ref):
        _assert_samples_equal(a, b)
    index = data.CocoIndex(dataset=gt)
    assert index.num_keypoints == 17
    assert index.get_img_ids() == jdata.CocoIndex(dataset=gt).get_img_ids()


@pytest.mark.parametrize("native_loader", ["off", "on"])
@pytest.mark.parametrize("is_train", [True, False])
def test_dataset_samples_match_jax(disk, is_train, native_loader):
    """get() for every record over two epochs and two seeds, and
    get_batch(), bit for bit; on "on" the JPEGs take the native path (the
    PNG too where libpng linked)."""
    root, gt = disk
    cfg, jcfg = _cfgs(root, native_loader=native_loader)
    recs, jrecs = _records(gt)
    image_root = str(root / "images")
    ds = pipeline.PoseDataset(cfg, recs, image_root, is_train)
    jds = jpipeline.PoseDataset(jcfg, jrecs, image_root, is_train)
    assert ds._native == jds._native == (native_loader == "on")
    for epoch, seed in ((0, 0), (3, 11)):
        for i in range(len(recs)):
            _assert_samples_equal(ds.get(i, epoch, seed),
                                  jds.get(i, epoch, seed))
        idxs = [3, 0, len(recs) - 1, 5]
        for got, want in zip(ds.get_batch(idxs, epoch, seed, nthreads=2),
                             jds.get_batch(idxs, epoch, seed, nthreads=2)):
            _assert_samples_equal(got, want)
    if native_loader == "on":
        png = 1 if native.has_png() else 0
        assert ds.decoded["native"] == 2 * (len(recs) - 1 + png + 3 + png)
    else:
        assert ds.decoded == {"native": 0, "cv2": 2 * (len(recs) + 4)}


@pytest.mark.parametrize("native_loader", ["off", "on"])
@pytest.mark.parametrize("is_train", [True, False])
def test_loader_epochs_match_jax(disk, is_train, native_loader):
    """build_dataloader() and two epochs of batches (train: shuffled,
    drop_last; val: the last batch padded, valid 0 on the padding)."""
    root, _ = disk
    cfg, jcfg = _cfgs(root, native_loader=native_loader)
    loader = pipeline.build_dataloader(cfg, is_train)
    jloader = jpipeline.build_dataloader(jcfg, is_train)
    loader.num_threads = jloader.num_threads = 2
    assert len(loader) == len(jloader) == (2 if is_train else 4)
    for epoch in (0, 1):
        batches = list(loader.epoch(epoch))
        jbatches = list(jloader.epoch(epoch))
        assert len(batches) == len(jbatches) == len(loader)
        for got, want in zip(batches, jbatches):
            assert set(got) == set(KEYS)
            _assert_samples_equal(got, want)
    if not is_train:
        assert batches[-1]["valid"].tolist() == [1.0, 0.0, 0.0]


def test_loader_stops_early_and_raises_errors(disk):
    """A consumer that leaves an epoch stops the producer; an unreadable
    image raises in the consumer."""
    root, gt = disk
    cfg, _ = _cfgs(root, native_loader="off")
    recs, _ = _records(gt)
    loader = pipeline.DataLoader(
        pipeline.PoseDataset(cfg, recs, str(root / "images"), True), 2,
        shuffle=False, num_threads=2, prefetch=1)
    it = loader.epoch(0)
    next(it)
    it.close()
    bad = [dict(r, image_file="missing.jpg") for r in recs]
    loader = pipeline.DataLoader(
        pipeline.PoseDataset(cfg, bad, str(root / "images"), True), 2,
        shuffle=False, num_threads=2)
    with pytest.raises(ValueError, match="Failed to load image"):
        list(loader.epoch(0))


def test_native_on_raises_where_the_library_is_missing(disk, monkeypatch):
    """"on" never runs cv2 quietly; "auto" takes cv2 where the library is
    missing."""
    root, gt = disk
    cfg, _ = _cfgs(root)
    recs, _ = _records(gt)
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native_loader='on'"):
        pipeline.PoseDataset(cfg, recs, str(root), True, native="on")
    ds = pipeline.PoseDataset(cfg, recs, str(root / "images"), True,
                              native="auto")
    assert not ds._native
    ds.get(0)
    assert ds.decoded == {"native": 0, "cv2": 1}


def test_device_batch_matches_jax(disk):
    root, _ = disk
    cfg, jcfg = _cfgs(root, native_loader="off")
    batch = next(iter(pipeline.build_dataloader(cfg, False).epoch(0)))
    got = pipeline.device_batch(batch, cfg.data.pixel_mean,
                                cfg.data.pixel_std, device="cpu")
    want = jpipeline.device_batch(batch, jcfg.data.pixel_mean,
                                  jcfg.data.pixel_std)
    assert set(got) == set(want) and "image_u8" not in got
    assert got["image"].dtype == torch.float32
    np.testing.assert_allclose(got["image"].numpy(),
                               np.asarray(want["image"]), atol=1e-6, rtol=0)
    for k in set(got) - {"image"}:
        np.testing.assert_array_equal(got[k].numpy(), batch[k], err_msg=k)


def _jpegs(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = rng.randint(200, 480), rng.randint(200, 640)
        img = cv2.GaussianBlur(rng.randint(0, 255, (h, w, 3)).astype(
            np.uint8), (5, 5), 0)
        out.append((cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY,
                                               90])[1].tobytes(), w, h))
    return out


def _matrices(jpegs, seed, out_size):
    """Crop matrices of random boxes, rotations and flips (some reaching
    outside the image), through the JAX package's own transforms."""
    from infantposeestimation_gaussianbias_tpu.data import transforms as jT

    rng = np.random.RandomState(seed)
    mats = []
    for _, w, h in jpegs:
        center = rng.uniform([0, 0], [w, h])
        scale = rng.uniform(20, 2 * max(w, h), 2)
        mat = jT.affine_matrix_np(center, scale, out_size,
                                  rng.uniform(-60, 60))
        mats.append(jT.compose_flip(mat, w) if rng.rand() < 0.5 else mat)
    return np.stack(mats)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("threads", [1, 4])
def test_native_decode_warp_matches_jax(fast, threads):
    """decode_warp_batch and decode_warp against the JAX package's build
    of the same source, on the same bytes and matrices, bit for bit."""
    assert native.available() and jnative.available()
    jpegs = _jpegs(9, seed=threads)
    mats = _matrices(jpegs, seed=5, out_size=(48, 64))
    buf = [b for b, _, _ in jpegs]
    got = native.decode_warp_batch(buf, mats, (48, 64), nthreads=threads,
                                   fast=fast)
    want = jnative.decode_warp_batch(buf, mats, (48, 64), nthreads=threads,
                                     fast=fast)
    assert got.shape == (9, 64, 48, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    for i in (0, 4):
        np.testing.assert_array_equal(
            native.decode_warp(buf[i], mats[i], (48, 64), fast=fast), got[i])
    with pytest.raises(ValueError, match="index 1"):
        native.decode_warp_batch([buf[0], b"not a jpeg"], mats[:2], (48, 64))


def test_pillow_libjpeg_build_decodes_like_the_system_build(tmp_path,
                                                            monkeypatch):
    """The build that links Pillow's libjpeg-turbo with the headers of
    native/include (the path of a machine without a system libjpeg) gives
    the system build's crops and full decodes bit for bit."""
    options = binding.link_options()
    lib = binding.pillow_libjpeg()
    assert lib is not None and lib in options[-1]
    path = str(tmp_path / "ipe_loader_pillow.so")
    assert binding._build(path, [options[-1]])
    jpegs = _jpegs(3, seed=8)
    buf = [b for b, _, _ in jpegs]
    mats = _matrices(jpegs, seed=9, out_size=(48, 64))
    want = native.decode_warp_batch(buf, mats, (48, 64), nthreads=2)
    full = native.decode_rgb(buf[0])
    monkeypatch.setattr(binding, "_lib", binding.open_library(path))
    assert not native.has_png()
    np.testing.assert_array_equal(
        native.decode_warp_batch(buf, mats, (48, 64), nthreads=2), want)
    np.testing.assert_array_equal(native.decode_rgb(buf[0]), full)


def test_dataset_tools_match_jax(tmp_path, capsys, monkeypatch):
    """convert_to_coco (custom JSON, validation, the split) and
    analyze_dataset (statistics, report, plots) against the JAX package's
    on the same raw annotations; probe_native_loader runs."""
    from infantposeestimation_gaussianbias_tpu.tools import (
        analyze_dataset as janalyze, convert_to_coco as jconvert)
    from infantposeestimation_gaussianbias_tpu_torch.tools import (
        analyze_dataset, convert_to_coco, probe_native_loader)

    src = tmp_path / "raw"
    src.mkdir()
    rng = np.random.RandomState(0)
    for i in range(6):
        cv2.imwrite(str(src / f"img{i}.jpg"),
                    rng.randint(0, 255, (100, 120, 3)).astype(np.uint8))
        ann = {"image": f"img{i}.jpg",
               "keypoints": [[float(rng.uniform(0, 120)),
                              float(rng.uniform(0, 100)),
                              int(rng.choice([0, 1, 2]))]
                             for _ in range(13)]}
        (src / f"img{i}.json").write_text(json.dumps(ann))
    outs = []
    for name, main in (("port", convert_to_coco.main),
                       ("jax", jconvert.main)):
        out = str(tmp_path / f"{name}.json")
        main(["--input-dir", str(src), "--output", out, "--split"])
        got = {}
        for part in ("", "_train", "_val", "_test"):
            with open(str(tmp_path / f"{name}{part}.json")) as f:
                d = json.load(f)
            d.get("info", {}).pop("date_created", None)
            got[part] = d
        outs.append(got)
    assert outs[0] == outs[1]
    ok, errors = convert_to_coco.validate_coco_format(outs[0][""])
    assert (ok, errors) == jconvert.validate_coco_format(outs[1][""])

    port = analyze_dataset.DatasetAnalyzer(str(tmp_path / "port.json"))
    ref = janalyze.DatasetAnalyzer(str(tmp_path / "jax.json"))
    assert port.text_report() == ref.text_report()
    assert port.quality_warnings() == ref.quality_warnings()
    np.testing.assert_array_equal(port.stats["visibility"],
                                  ref.stats["visibility"])
    capsys.readouterr()
    analyze_dataset.main(["--ann", str(tmp_path / "port.json"),
                          "--out-dir", str(tmp_path / "plots")])
    assert "Dataset analysis" in capsys.readouterr().out
    assert (tmp_path / "plots" / "visibility.png").exists()

    monkeypatch.setenv("PROBE_N", "2")
    monkeypatch.setenv("PROBE_THREADS", "2")
    probe_native_loader.main()
    rows = [json.loads(line) for line in capsys.readouterr().out.split("\n")
            if line.startswith("{")]
    assert [r["case"] for r in rows] == [
        "coco_640x480", "hd_1920x1080", "posedataset_get_off",
        "posedataset_get_auto"]
    assert rows[-1]["native"] and not rows[-2]["native"]


def test_a_library_that_does_not_load_is_built_again(tmp_path, monkeypatch):
    """A library at the build path that does not load (linked on another
    machine against a libjpeg this one lacks) is compiled again."""
    path = tmp_path / "ipe_loader_stale.so"
    path.write_bytes(b"not a shared object")
    monkeypatch.setattr(binding, "_lib_path", lambda: str(path))
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding, "_tried", False)
    lib = binding.load()
    assert lib is not None and path.read_bytes()[:4] == b"\x7fELF"
