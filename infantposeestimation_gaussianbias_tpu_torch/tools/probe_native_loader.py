"""Native against cv2 host loading: decode + warp throughput per sample.

Port of infantposeestimation_gaussianbias_tpu/tools/probe_native_loader.py.
The native loader (native/ipe_loader.cpp) decodes only the source rows a
crop touches, straight to RGB, and warps them into the crop in one call
(in ``fast`` mode with the IDCT at 1/2-1/8 scale where the crop
downsamples anyway).  The probe times every path on synthetic JPEGs at
COCO (640x480) and HD (1920x1080) sizes, one sample at a time and in
batches on the loader's thread pool, and ``PoseDataset.get`` both ways.
Host only: no card is used.

    python -m infantposeestimation_gaussianbias_tpu_torch.tools.probe_native_loader

Env: PROBE_N (timed iterations per case, default 150), PROBE_THREADS
(batch threads, default one per core).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def _make_jpeg(w: int, h: int, seed: int) -> bytes:
    import cv2

    rng = np.random.RandomState(seed)
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    img = cv2.GaussianBlur(img, (0, 0), 3)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 92])
    assert ok
    return enc.tobytes()


def _bench(fn, n: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return n / (time.perf_counter() - t0)


def main() -> None:
    import cv2

    from .. import native
    from ..data.transforms import affine_matrix_np

    if not native.available():
        print(json.dumps({"error": "native loader not buildable"}))
        return

    n = int(os.environ.get("PROBE_N", "150"))
    nthreads = int(os.environ.get("PROBE_THREADS", "0"))
    out_size = (192, 256)
    results = []

    for (w, h), label in (((640, 480), "coco_640x480"),
                          ((1920, 1080), "hd_1920x1080")):
        data = _make_jpeg(w, h, seed=w)
        # A person crop covering ~60% of the frame, slightly rotated.
        mat = affine_matrix_np(np.array([w / 2.0, h / 2.0]),
                               np.array([0.5 * w, 0.75 * h]),
                               out_size, rot_deg=15.0)

        def cv2_path():
            im = cv2.imdecode(np.frombuffer(data, np.uint8),
                              cv2.IMREAD_COLOR)
            im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
            return cv2.warpAffine(im, mat.astype(np.float64), out_size,
                                  flags=cv2.INTER_LINEAR)

        row = {"case": label,
               "cv2_sps": _bench(cv2_path, n),
               "native_sps": _bench(
                   lambda: native.decode_warp(data, mat, out_size), n),
               "native_fast_sps": _bench(
                   lambda: native.decode_warp(data, mat, out_size,
                                              fast=True), n)}

        # Batched-threaded rate (the DataLoader regime).
        bs = 32
        mats = np.stack([mat] * bs)
        jpegs = [data] * bs
        t0 = time.perf_counter()
        reps = max(1, n // bs)
        for _ in range(reps):
            native.decode_warp_batch(jpegs, mats, out_size,
                                     nthreads=nthreads, fast=False)
        row["native_batch_sps"] = reps * bs / (time.perf_counter() - t0)
        results.append(row)
        print(json.dumps(row))

    # End-to-end PoseDataset.get, native vs cv2 (val transform).
    import tempfile

    from ..config import get_config
    from ..data import synthetic_coco_dataset
    from ..data.coco import CocoIndex, build_records
    from ..data.pipeline import PoseDataset
    from ..schemas import COCO17

    with tempfile.TemporaryDirectory() as root:
        img_dir = os.path.join(root, "val2017")
        os.makedirs(img_dir)
        synth = synthetic_coco_dataset(
            num_images=32, num_keypoints=17, image_dir=img_dir, seed=0,
            height=480, width=640, keypoint_names=COCO17.keypoint_names,
            skeleton=COCO17.skeleton)
        ann = os.path.join(root, "ann.json")
        with open(ann, "w") as f:
            json.dump(synth, f)
        records = build_records(CocoIndex(ann))

        for mode in ("off", "auto"):
            cfg = get_config()
            cfg.data.native_loader = mode
            ds = PoseDataset(cfg, records, img_dir, is_train=True)
            t0 = time.perf_counter()
            reps = max(1, n // len(records))
            for r in range(reps):
                for i in range(len(records)):
                    ds.get(i, epoch=r, seed=0)
            sps = reps * len(records) / (time.perf_counter() - t0)
            row = {"case": f"posedataset_get_{mode}",
                   "native": ds._native, "sps": sps}
            results.append(row)
            print(json.dumps(row))


if __name__ == "__main__":
    main()
