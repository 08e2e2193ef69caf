"""Host batches onto the device ahead of the step (JAX package
``parallel/mesh.py``: ``device_prefetch`` :298 and the single-device part
of ``shard_batch`` :69).

On a CUDA device a background thread copies each batch's arrays into
pinned host memory and from there to the card with ``non_blocking=True``
on a side stream, ``depth`` batches ahead of the consumer, so the copies
overlap the step. Each batch carries the event recorded after its copies;
the consumer's stream waits on it before the step reads the batch, and
each device tensor is marked as used on the consumer's stream
(``record_stream``), so the caching allocator does not hand its memory to
the side stream while the step still reads it. The thread waits for the
event before it lets go of the pinned buffers, so no pinned buffer is
freed or reused while its copy is in flight. On the CPU the batch's
arrays become tensors as they are.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator

import numpy as np
import torch


def _arrays(batch: Dict) -> Dict[str, np.ndarray]:
    """The array fields of a host batch (``folders`` and ``names`` are
    lists and stay on the host)."""
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A host batch's arrays as tensors on ``device``, now, on the current
    stream (validation's path; the train loop uses ``device_prefetch``)."""
    device = torch.device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in _arrays(batch).items()}


def device_prefetch(batches: Iterable[Dict], device, depth: int = 2
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield ``batches`` as dicts of tensors on ``device``, copied up to
    ``depth`` batches ahead of the consumer (see the module docstring)."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            yield to_device(batch, device)
        return

    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream(device)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def transfer():
        try:
            torch.cuda.set_device(device)
            for batch in batches:
                if stop.is_set():
                    return
                pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                          for k, v in _arrays(batch).items()}
                with torch.cuda.stream(side):
                    moved = {k: v.to(device, non_blocking=True)
                             for k, v in pinned.items()}
                    copied = torch.cuda.Event()
                    copied.record(side)
                copied.synchronize()  # the pinned buffers may go now
                q.put((moved, copied))
            q.put(None)
        except BaseException as e:  # surface the thread's error to the consumer
            q.put(e)

    thread = threading.Thread(target=transfer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            moved, copied = item
            stream = torch.cuda.current_stream(device)
            stream.wait_event(copied)
            for t in moved.values():
                t.record_stream(stream)
            yield moved
    finally:
        stop.set()
        while thread.is_alive():  # unblock a producer waiting on a full queue
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        thread.join()
