"""Batches staged ahead of the step, their host -> card copy overlapped
with it: the counterpart of the JAX solver's ``_device_prefetch``
(``instancerefer_tpu/train/solver.py``), where ``device_put`` is
asynchronous, so batch k+1's copy overlaps step k's compute.

``DevicePrefetcher(loader, spec, device)`` runs the loader on a producer
thread.  For each batch the thread reads the capacity-overflow fractions
(into ``overflow_log``), ``stage``s the batch into a page-locked set of
host buffers (``data/host.stage``: the map checks, collate's dtypes) and
issues its copy into a device set of buffers ``non_blocking`` on a side
stream, then records an event.  The consumer takes the ready batches in the
loader's order; each is a ``Ready``, used as a context manager::

    with DevicePrefetcher(loader, spec, device) as batches:
        for ready in batches:          # the current stream waits on its copy
            with ready as staged:      # staged: {key: tensor} on the card
                dd = finish(staged, spec)   # or StepGraphs.load(staged, ...)
            ...                        # the step

and leaving ``with ready`` hands its sets back.  On the CPU the same thread
stages into plain host buffers and there are no streams or events; the
consumer's ``finish`` reads those buffers.

Buffers: ``depth + 1`` sets, each taken when free, each a ``host.Buffers``
keyed by (name, shape, dtype), so a second language grid adds its
``lang_feat`` to a set and nothing else.  At the configuration's caps and B = 64 a set holds
about 321 MB: about 1 GB page-locked and 1 GB on the card.  Two fences keep
a set from being rewritten while it is read:

* a host set is restaged only after the event recorded after its copy has
  completed (``copied.synchronize()`` on the producer);
* a device set is rewritten only after the consumer's ``finish`` that read
  it: leaving ``with ready`` records ``released`` on the consumer's stream
  and then hands the set back, and the side stream waits on that event
  before its next copy into the set.

Nothing falls back: on a card, a failure to pin or to make the stream
raises, and an exception on the producer is raised in the consumer at that
batch, with its traceback.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from instancerefer_tpu_torch.data.host import Buffers, stage

# batches staged ahead of the step (the JAX solver's depth)
PREFETCH = 2
_POLL_S = 0.05  # how often a blocked producer looks at the stop flag
_END = object()


class _Failed:
    def __init__(self, error: BaseException):
        self.error = error


class _Set:
    """One staging set: host buffers (page-locked on a card), device
    buffers, and the two fences' events."""

    def __init__(self, device: torch.device, side: Optional[torch.cuda.Stream]):
        cuda = device.type == "cuda"
        self.host = Buffers("cpu", pin=cuda)
        # made in the consumer's pool (which the next feed's sets reuse: a
        # pool is a stream's, and each feed has a side stream of its own),
        # written on the side stream: a freed buffer waits for both
        self.device = Buffers(device, made=lambda t: t.record_stream(side)) if cuda else None
        self.copied = torch.cuda.Event() if cuda else None
        self.released = torch.cuda.Event() if cuda else None


class Ready:
    """A staged batch ready for ``finish``: ``with ready as staged`` gives
    {key: tensor} on the device (a set's buffers), and leaving it hands the
    set back.  ``load``: the consumer's seconds waiting for it; ``stage``:
    the producer's host seconds staging it and issuing its copy."""

    def __init__(self, prefetcher: "DevicePrefetcher", slot: _Set, tensors: Dict[str, torch.Tensor],
                 stage_s: float):
        self._prefetcher, self._slot = prefetcher, slot
        self.tensors = tensors
        self.stage = stage_s
        self.load = 0.0

    def __enter__(self) -> Dict[str, torch.Tensor]:
        return self.tensors

    def __exit__(self, *exc) -> None:
        """Hand the set back once what the current stream has queued (the
        ``finish`` that read it) is done."""
        if self._slot is None:
            return
        slot, self._slot = self._slot, None
        if slot.released is not None:
            slot.released.record(torch.cuda.current_stream(self._prefetcher.device))
        self._prefetcher._free.put(slot)


class DevicePrefetcher:
    """Iterates ``loader`` on a producer thread, ``depth`` batches staged
    ahead of the consumer (see the module docstring).  ``overflow_log``
    ({"scene": [], "inst": []}) gathers each batch's capacity-overflow
    fractions from the host arrays; read it after the prefetcher closed.
    ``close`` (also on leaving ``with``, and when iteration ends, breaks or
    raises) stops the producer and joins it: the producer closes its own
    iterator, so the loader's ``finally`` blocks (its thread pools) run."""

    def __init__(self, loader, spec, device, depth: int = PREFETCH,
                 overflow_log: Optional[Dict[str, List[float]]] = None):
        self.loader, self.spec = loader, spec
        self.device = torch.device(device)
        self.overflow_log = overflow_log
        cuda = self.device.type == "cuda"
        self.consumer = torch.cuda.current_stream(self.device) if cuda else None
        # the producer's stream: the copies, and whatever the loader runs
        # on the card (``PredictedClassLoader``'s language pass)
        self.side = torch.cuda.Stream(self.device) if cuda else None
        self._free: queue.Queue = queue.Queue()  # the sets no batch holds, oldest first
        for _ in range(depth + 1):
            self._free.put(_Set(self.device, self.side))
        self._queue: queue.Queue = queue.Queue(maxsize=depth + 1)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __iter__(self) -> Iterator[Ready]:
        if self._thread is not None:
            raise RuntimeError("a DevicePrefetcher is iterated once")
        if self.side is not None:
            # the loader's device work (the language pass of
            # ``PredictedClassLoader``) reads the weights as of this point
            self.side.wait_stream(self.consumer)
        self._thread = threading.Thread(target=self._produce, name="DevicePrefetcher",
                                        daemon=True)
        self._thread.start()
        try:
            while True:
                start = time.perf_counter()
                item = self._queue.get()
                wait = time.perf_counter() - start
                if item is _END:
                    return
                if isinstance(item, _Failed):
                    raise item.error
                if item._slot.copied is not None:
                    torch.cuda.current_stream(self.device).wait_event(item._slot.copied)
                item.load = wait
                yield item
        finally:
            self.close()

    def close(self) -> None:
        """Stop the producer and join it (idempotent).  The queue is drained
        meanwhile, so a producer blocked on it sees the flag."""
        self._stop.set()
        thread = self._thread
        while thread is not None and thread.is_alive():
            with contextlib.suppress(queue.Empty):
                while True:
                    self._queue.get_nowait()
            thread.join(_POLL_S)

    # ------------------------------------------------------------- producer
    def _produce(self) -> None:
        try:
            with contextlib.ExitStack() as ctx:
                if self.side is not None:
                    # the current device and stream are the thread's own:
                    # without this, under DDP rank r's copies go to card 0
                    ctx.enter_context(torch.cuda.device(self.device))
                    ctx.enter_context(torch.cuda.stream(self.side))
                it = iter(self.loader)
                if hasattr(it, "close"):  # a generator is closed by the thread that runs it
                    ctx.callback(it.close)
                for batch in it:
                    if self._stop.is_set():
                        return
                    self._log_overflow(batch)
                    slot = self._acquire()
                    if slot is None:
                        return
                    start = time.perf_counter()
                    tensors = self._stage(slot, batch)
                    if not self._put(Ready(self, slot, tensors, time.perf_counter() - start)):
                        return
        except BaseException as e:  # raised in the consumer at this batch (a loader's
            self._put(_Failed(e))   # KeyboardInterrupt too: the consumer's run ends there)
        finally:
            self._put(_END)

    def _stage(self, slot: _Set, batch) -> Dict[str, torch.Tensor]:
        """``stage`` into the set's host buffers, then (on a card) the copy
        into its device buffers on the side stream, behind both fences."""
        if slot.copied is not None:
            slot.copied.synchronize()  # the set's last copy has read its host buffers
        staged = stage(batch, self.spec, slot.host)
        if slot.device is None:
            return staged
        made = len(slot.device.tensors)
        with torch.cuda.stream(self.consumer):
            on_card = {k: slot.device.get(k, t.shape, t.dtype) for k, t in staged.items()}
        if len(slot.device.tensors) > made:
            # a new buffer may be memory the consumer's queued work still reads
            self.side.wait_stream(self.consumer)
        self.side.wait_event(slot.released)  # the last finish has read its device buffers
        for k, t in staged.items():
            on_card[k].copy_(t, non_blocking=True)
        slot.copied.record(self.side)
        return on_card

    def _log_overflow(self, batch) -> None:
        log = self.overflow_log
        if log is None or not isinstance(batch.get("scene_overflow"), np.ndarray):
            return
        log["scene"].append(float(batch["scene_overflow"].mean()))
        log["inst"].append(float(batch["inst_overflow"].mean()))
        co = batch.get("cand_overflow")
        if isinstance(co, np.ndarray):
            log.setdefault("cand", []).append(float(co.mean()))

    def _acquire(self) -> Optional[_Set]:
        """The oldest free set, or None once stopped."""
        while not self._stop.is_set():
            with contextlib.suppress(queue.Empty):
                return self._free.get(timeout=_POLL_S)
        return None

    def _put(self, item) -> bool:
        """``item`` into the queue, or False once stopped."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                pass
        return False
