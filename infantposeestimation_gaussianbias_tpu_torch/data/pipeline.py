"""Device-transfer prefetch stage of the serving pipeline.

Port of ``prefetch_to_device`` in infantposeestimation_gaussianbias_tpu/
data/pipeline.py: a thread copies the selected entries of upcoming
batches to the device, up to ``size`` batches ahead of the consumer, so
that the host-to-device copy overlaps the consumer's compute instead of
running on its thread.

On a CUDA device the thread pins each host array and copies it on a side
stream with ``non_blocking=True``; it records an event after the copies.
When the consumer takes the batch, its current stream waits on that event
(so no kernel reads the batch before it lands) and each tensor is
``record_stream``-ed on it (so the allocator does not hand the memory to
the side stream again while the consumer's kernels may still read it).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch


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
