"""Asynchronous input pipeline: batches made ahead of the step on a
producer thread, and the time the loop waits for them
(``ddlbench_tpu/data/prefetch.py``).

A :class:`Prefetcher` hands out one :class:`EpochStream` per epoch. With
``depth`` > 0 the stream's producer thread asks the data source for
``batch(epoch, step)`` in step order and puts each batch in a queue of
``depth`` places, so batch production (and, on the card, the upload from
pinned memory, the augmentation and the normalisation, all on a side CUDA
stream) overlaps the step. ``depth`` 0 makes each batch inline, through
the same interface (``--no-prefetch``). Batches are the same either way:
the producer asks for them in order, and a sequential source (the on-disk
loader) is read by one thread per epoch.

On the card the producer records an event on its side stream after each
batch; the consumer makes its current stream wait for that event and
records the batch's tensors as used on that stream, so the step never
reads a batch before its upload is done and the allocator never hands its
memory to the side stream while the step still reads it.

``stall_s`` is the time the consumer spent blocked: on the queue, or in
the inline fetch at depth 0. An exception in the producer is re-raised in
the consumer, chained (a producer that dies without delivering one is
noticed by polling its thread); ``close`` stops the producer and joins
its thread, and runs when the epoch is exhausted. The reference's fault
hooks, tracer spans and watchdog heartbeats are not ported.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Any, NamedTuple, Optional, Tuple

import torch

# the step index that marks an exception delivered by the producer
_ERROR = -1


class Fetched(NamedTuple):
    """One prepared step: the (x, y) batch and, on the card, the event
    recorded on the producer's stream after it was made."""

    batch: Tuple[Any, ...]
    ready: Optional[torch.cuda.Event]


def _device(data) -> torch.device:
    return torch.device(getattr(data, "device", "cpu"))


class EpochStream:
    """Iterator over one epoch's batches ``(x, y)`` (one producer thread
    when ``depth`` > 0). Iterate it and :meth:`close` it in a ``finally``;
    closing is idempotent and happens when the epoch is exhausted."""

    def __init__(self, data, epoch: int, steps: int, train: bool,
                 depth: int):
        self._data, self._epoch, self.steps = data, epoch, steps
        self._train = train
        self._served = 0
        self.stall_s = 0.0
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        dev = _device(data)
        self._cuda = dev if dev.type == "cuda" else None
        if depth > 0:
            self._queue = queue.Queue(maxsize=depth)
            self._thread = threading.Thread(
                target=self._produce, daemon=True,
                name=f"prefetch-e{epoch}-{'train' if train else 'eval'}")
            self._thread.start()

    # ---- producer ----

    def _fetch(self, step: int) -> Fetched:
        batch = self._data.batch(self._epoch, step, train=self._train)
        return Fetched(batch, None)

    def _put(self, item) -> bool:
        """A bounded put that polls the stop flag, so a producer never
        blocks against a consumer that gave up."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            side = None
            if self._cuda is not None:
                # the side stream starts after what the source's own
                # tensors (the normalisation table) were made by
                side = torch.cuda.Stream(self._cuda)
                side.wait_stream(torch.cuda.current_stream(self._cuda))
            for step in range(self.steps):
                if self._stop.is_set():
                    return
                if side is None:
                    item = self._fetch(step)
                else:
                    with torch.cuda.stream(side):
                        batch = self._fetch(step).batch
                        ready = torch.cuda.Event()
                        ready.record(side)
                    item = Fetched(batch, ready)
                if not self._put((step, item)):
                    return
        except BaseException as e:  # re-raised in the consumer
            self._put((_ERROR, e))

    # ---- consumer ----

    def __iter__(self) -> "EpochStream":
        return self

    def __next__(self):
        if self._served >= self.steps:
            self.close()
            raise StopIteration
        t0 = time.perf_counter()
        if self._queue is None:
            item = self._fetch(self._served)
        else:
            step, item = self._get_or_fail()
            if step == _ERROR:
                self.close()
                raise RuntimeError(
                    f"prefetch producer failed in epoch {self._epoch}: "
                    f"{item!r}") from item
        self.stall_s += time.perf_counter() - t0
        self._served += 1
        if item.ready is not None:
            current = torch.cuda.current_stream(self._cuda)
            current.wait_event(item.ready)
            for t in item.batch:
                t.record_stream(current)
        return item.batch

    def _get_or_fail(self):
        """A queue get that notices a producer thread that died without
        delivering anything, instead of waiting forever."""
        while True:
            try:
                return self._queue.get(timeout=0.2)
            except queue.Empty:
                if self._thread is not None and not self._thread.is_alive():
                    try:  # it may have put its item and exited
                        return self._queue.get_nowait()
                    except queue.Empty:
                        self.close()
                        raise RuntimeError(
                            f"prefetch producer for epoch {self._epoch} "
                            "died without delivering a batch") from None

    @property
    def stall_ms(self) -> float:
        return self.stall_s * 1e3

    def close(self, grace_s: float = 5.0) -> None:
        """Stop the producer and join its thread (idempotent). A producer
        stuck inside a fetch for ``grace_s`` is left behind (it is a daemon
        thread) with a message, so an exception on its way out is not
        held up by the join."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is None:
            return
        deadline = time.monotonic() + grace_s
        while thread.is_alive():
            try:  # drain, so a blocked put wakes at once
                self._queue.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=0.05)
            if time.monotonic() > deadline and thread.is_alive():
                print(f"prefetch: producer thread {thread.name} did not "
                      f"exit within {grace_s:.0f} s; not joined",
                      file=sys.stderr, flush=True)
                return

    def __enter__(self) -> "EpochStream":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class Prefetcher:
    """Per-epoch :class:`EpochStream` factory over one data source (its
    ``batch(epoch, step, train)`` and ``steps_per_epoch(train)``; its
    ``device`` says where the batches are made). ``depth`` 0 is the
    inline path."""

    def __init__(self, data, depth: int = 2):
        if depth < 0:
            raise ValueError("prefetch depth must be >= 0")
        self.data, self.depth = data, depth

    def stream(self, epoch: int, train: bool = True) -> EpochStream:
        return EpochStream(self.data, epoch,
                           self.data.steps_per_epoch(train=train), train,
                           self.depth)
