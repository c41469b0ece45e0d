"""Host input pipeline: COCO records -> augmented uint8 crop batches ->
normalised batches on the device; and the serving pipeline's
device-transfer prefetch stage.

Port of infantposeestimation_gaussianbias_tpu/data/pipeline.py.  The host
decodes each JPEG and warps it once into the crop (one
``cv2.warpAffine``, or the native fused decode + warp, native/) in a
thread pool, and ships uint8 crops; normalisation (``device_batch``) and
the Gaussian targets (the train step) run on the device.  Each sample's
augmentation draws from a numpy RNG seeded by (seed, epoch, index), so a
sample is the same in every run, on every loader path and in both
packages.

``prefetch_to_device`` (``PoseInference.predict_stream``): a thread copies
the selected entries of upcoming batches to the device, up to ``size``
batches ahead of the consumer, so that the host-to-device copy overlaps
the consumer's compute instead of running on its thread.  On a CUDA
device the thread pins each host array and copies it on a side stream
with ``non_blocking=True``; it records an event after the copies.  When
the consumer takes the batch, its current stream waits on that event (so
no kernel reads the batch before it lands) and each tensor is
``record_stream``-ed on it (so the allocator does not hand the memory to
the side stream again while the consumer's kernels may still read it).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import queue
import threading
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..schemas import KeypointSchema
from . import transforms as T
from .coco import CocoIndex, build_records


class PoseDataset:
    """Record store and per-sample load / augment / warp.

    Where the native loader is available (``native/``), JPEG samples
    (and PNG ones where libpng linked) take the fused decode + warp: the
    crop matrix comes from the record's image size, and one C call decodes
    only the source rows the crop needs and warps them straight into it.
    ``native`` is "auto" (native where it builds, else cv2), "on" (native
    or raise) or "off" (cv2); None reads ``data.native_loader``.
    ``decoded`` counts the samples each path produced.
    """

    def __init__(self, cfg: Config, records: List[Dict], image_root: str,
                 is_train: bool, image_cache: Optional[Dict] = None,
                 native: Optional[str] = None):
        self.cfg = cfg
        self.records = records
        self.image_root = image_root
        self.is_train = is_train
        self.schema: KeypointSchema = cfg.data.keypoint_schema
        self._cache = image_cache  # optional {file_name: ndarray} for tests
        if native is None:
            native = cfg.data.native_loader
        self._native = False
        self._fast = bool(is_train and cfg.data.native_fast)
        if native in ("auto", "on"):
            from .. import native as native_mod

            self._native = native_mod.available()
            if native == "on" and not self._native:
                raise RuntimeError(
                    "native_loader='on' but the native loader could not "
                    "be built (g++/libjpeg missing?)")
        self.decoded = {"native": 0, "cv2": 0}
        self._count_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.records)

    def _count(self, path: str, n: int = 1) -> None:
        with self._count_lock:
            self.decoded[path] += n

    def _load_image(self, rec: Dict) -> np.ndarray:
        import cv2

        if self._cache is not None and rec["image_file"] in self._cache:
            return self._cache[rec["image_file"]]
        path = os.path.join(self.image_root, rec["image_file"])
        img = cv2.imread(path)
        if img is None:
            raise ValueError(f"Failed to load image: {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def _native_eligible(self, rec: Dict) -> bool:
        if not (self._native and self._cache is None and "img_w" in rec):
            return False
        name = rec["image_file"].lower()
        if name.endswith((".jpg", ".jpeg")):
            return True
        if name.endswith(".png"):
            from .. import native as native_mod

            return native_mod.has_png()
        return False

    def _read_bytes(self, rec: Dict) -> bytes:
        path = os.path.join(self.image_root, rec["image_file"])
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError as e:  # the contract of _load_image
            raise ValueError(f"Failed to load image: {path}") from e

    def _transform(self, rec: Dict, idx: int, epoch: int, seed: int,
                   img_w: int, img_h: int) -> Dict:
        """Augmentation and crop matrix (no pixels touched)."""
        sample = {
            "keypoints": rec["keypoints"].copy(),
            "visible": rec["visible"].copy(),
            "center": rec["center"].copy(),
            "scale": rec["scale"].copy(),
        }
        if self.is_train:
            rng = np.random.RandomState(
                (seed * 1_000_003 + epoch * 7919 + idx) % (2**31 - 1))
            return T.train_transform(rng, sample, img_w, self.schema,
                                     self.cfg.data, img_h=img_h)
        return T.val_transform(sample, img_w, self.cfg.data)

    def _finalize(self, rec: Dict, sample: Dict,
                  crop: np.ndarray) -> Dict:
        return {
            "image_u8": crop,
            "keypoints": sample["keypoints"].astype(np.float32),
            "visible": sample["visible"].astype(np.float32),
            "center": sample["center"].astype(np.float32),
            "scale": sample["scale"].astype(np.float32),
            "image_id": np.int64(rec["image_id"]),
            "ann_id": np.int64(rec["ann_id"]),
            "area": np.float32(rec["area"]),
            # a record repeated to equalise the processes' shards
            # (parallel.process_shard)
            "pad": np.float32(bool(rec.get("_pad", False))),
        }

    def get(self, idx: int, epoch: int = 0, seed: int = 0) -> Dict:
        rec = self.records[idx]
        use_native = self._native_eligible(rec)
        if use_native:
            img = None
            img_w, img_h = rec["img_w"], rec["img_h"]
        else:
            img = self._load_image(rec)
            img_h, img_w = img.shape[:2]
        sample = self._transform(rec, idx, epoch, seed, img_w, img_h)

        W, H = self.cfg.data.input_size
        if use_native:
            from .. import native as native_mod

            crop = native_mod.decode_warp(self._read_bytes(rec),
                                          sample["matrix"], (W, H),
                                          fast=self._fast)
            self._count("native")
        else:
            import cv2

            crop = cv2.warpAffine(img, sample["matrix"].astype(np.float64),
                                  (int(W), int(H)), flags=cv2.INTER_LINEAR)
            self._count("cv2")
        return self._finalize(rec, sample, crop)

    def get_batch(self, idxs, epoch: int = 0, seed: int = 0,
                  nthreads: int = 0) -> List[Dict]:
        """One native ``decode_warp_batch`` call (its own thread pool, no
        GIL) for the native-eligible samples, ``get`` for the rest; equal
        to ``[get(i) for i in idxs]`` (the same per-index RNG)."""
        idxs = [int(i) for i in idxs]
        nat = [i for i in idxs if self._native_eligible(self.records[i])]
        if len(nat) < 2:  # nothing to batch
            return [self.get(i, epoch, seed) for i in idxs]
        from .. import native as native_mod

        W, H = self.cfg.data.input_size
        metas, jpegs = {}, []
        for i in nat:
            rec = self.records[i]
            metas[i] = self._transform(rec, i, epoch, seed,
                                       rec["img_w"], rec["img_h"])
            jpegs.append(self._read_bytes(rec))
        mats = np.stack([metas[i]["matrix"] for i in nat])
        crops = native_mod.decode_warp_batch(jpegs, mats, (W, H),
                                             nthreads=nthreads,
                                             fast=self._fast)
        self._count("native", len(nat))
        out = {i: self._finalize(self.records[i], metas[i], crops[j])
               for j, i in enumerate(nat)}
        return [out[i] if i in out else self.get(i, epoch, seed)
                for i in idxs]


def _collate(samples: List[Dict], pad_to: int) -> Dict[str, np.ndarray]:
    """Stack the samples; a short batch is padded to ``pad_to`` rows by
    repeating its last sample, and ``valid`` is 0 on the padding (and on
    shard-equalising records)."""
    n = len(samples)
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    valid = 1.0 - batch.pop("pad", np.zeros(n, np.float32))
    if n < pad_to:
        reps = pad_to - n
        for k, v in batch.items():
            batch[k] = np.concatenate([v] + [v[-1:]] * reps, axis=0)
        valid = np.concatenate([valid, np.zeros(reps, np.float32)])
    batch["valid"] = valid.astype(np.float32)
    return batch


class DataLoader:
    """Threaded prefetching batch iterator over a PoseDataset.

    On the native path one ``get_batch`` call (one C call) makes each
    batch, and two batches are in flight, so that one batch's Python work
    (transforms, file reads; the GIL held) overlaps the other's decode (the
    GIL released).  On the cv2 path the samples of a batch go through the
    pool one by one (cv2 releases the GIL).  Up to ``prefetch`` collated
    batches wait for the consumer.
    """

    def __init__(self, dataset: PoseDataset, batch_size: int,
                 shuffle: bool, seed: int = 0, num_threads: int = 8,
                 prefetch: int = 4, drop_last: bool = False):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        if self.drop_last:
            order = order[: len(order) // self.batch_size * self.batch_size]

        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        use_batch = self.ds._native

        def _put(item) -> bool:
            # a bounded put that re-checks ``stop``: a consumer that left
            # the epoch early leaves this thread parked on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with cf.ThreadPoolExecutor(self.num_threads) as pool:
                    if use_batch:
                        def make(idxs):
                            return self.ds.get_batch(
                                idxs, epoch, self.seed,
                                nthreads=self.num_threads)

                        it = iter(batches)
                        futs = deque(pool.submit(make, idxs)
                                     for _, idxs in zip(range(2), it))
                        while futs:
                            if stop.is_set():
                                return
                            samples = futs.popleft().result()
                            nxt = next(it, None)
                            if nxt is not None:
                                futs.append(pool.submit(make, nxt))
                            if not _put(_collate(samples, self.batch_size)):
                                return
                    else:
                        for idxs in batches:
                            if stop.is_set():
                                return
                            samples = list(pool.map(
                                lambda i: self.ds.get(int(i), epoch,
                                                      self.seed),
                                idxs))
                            if not _put(_collate(samples, self.batch_size)):
                                return
                _put(None)
            except BaseException as e:  # raised in the consumer
                _put(e)

        t = threading.Thread(target=producer, name="ipe-loader", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def build_dataloader(cfg: Config, is_train: bool,
                     image_cache: Optional[Dict] = None,
                     one_per_image: bool = False) -> DataLoader:
    """A loader over ``cfg.data``'s COCO annotation file and images, of
    every record at the whole batch (``train.global_batch_size`` or
    ``eval.batch_size``).  Under a process group every process loads the
    same batches: the grid's train step and validation take each rank's
    rows of the global batch (train/loop.py)."""
    d = cfg.data
    ann = os.path.join(d.data_root, d.train_ann if is_train else d.val_ann)
    prefix = d.train_img_prefix if is_train else d.val_img_prefix
    records = build_records(CocoIndex(ann), img_prefix="",
                            bbox_padding=d.bbox_padding,
                            one_per_image=one_per_image)
    ds = PoseDataset(cfg, records, os.path.join(d.data_root, prefix),
                     is_train, image_cache=image_cache)
    bs = cfg.train.global_batch_size if is_train else cfg.eval.batch_size
    return DataLoader(ds, bs, shuffle=is_train,
                      seed=cfg.train.seed, drop_last=is_train)


def device_batch(batch: Dict[str, np.ndarray], mean, std,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """A collated host batch as tensors on ``device``: the uint8 crops
    become ``image``, (x / 255 - mean) / std in float32, on the device;
    the label arrays pass through.  To a CUDA device every array is
    copied from pinned memory with ``non_blocking=True`` (the copies queue
    behind the work already issued; the host does not wait)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory().to(device, non_blocking=True) if cuda \
            else t.to(device)
    x = out.pop("image_u8").float() / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=device)
    std = torch.tensor(std, dtype=torch.float32, device=device)
    out["image"] = (x - mean) / std
    return out


def _to_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(v))


def prefetch_to_device(batches: Iterable[dict], size: int = 2,
                       keys: Optional[Sequence[str]] = None,
                       device="cuda") -> Iterator[dict]:
    """Yield the dicts of ``batches`` with the entries named in ``keys``
    (all when None) as tensors on ``device``, copied by a thread up to
    ``size`` batches ahead; other entries pass through untouched.  A
    consumer that stops early (break, an error downstream) stops the
    thread; an error in ``batches`` is raised in the consumer."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device=device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def _put(item) -> bool:
        # a bounded put that re-checks ``stop``: a consumer that abandoned
        # the stream leaves this thread parked on a full queue otherwise,
        # holding up to ``size`` batches on the device
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def transfer():
        try:
            for batch in batches:
                if stop.is_set():
                    return
                out = dict(batch)
                event = None
                if cuda:
                    with torch.cuda.stream(stream):
                        for k, v in batch.items():
                            if keys is None or k in keys:
                                out[k] = _to_tensor(v).pin_memory().to(
                                    device, non_blocking=True)
                        event = torch.cuda.Event()
                        event.record(stream)
                else:
                    for k, v in batch.items():
                        if keys is None or k in keys:
                            out[k] = _to_tensor(v).to(device)
                if not _put((out, event)):
                    return
            _put(None)
        except BaseException as e:  # raised in the consumer
            _put(e)

    t = threading.Thread(target=transfer, name="ipe-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            out, event = item
            if event is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for k, v in out.items():
                    if (keys is None or k in keys) and isinstance(
                            v, torch.Tensor):
                        v.record_stream(consumer)
            yield out
    finally:
        stop.set()
