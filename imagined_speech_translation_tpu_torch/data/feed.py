"""Batching and the asynchronous host -> device feed.

Port of ``imagined_speech_translation_tpu.data.feed``.  ``batch_iterator``
and ``threaded_producer`` are plain Python, as in the original: a background
thread prepares numpy batches while the consumer runs.  ``device_prefetch``
keeps ``size`` batches in flight on the card: each array is copied from
pinned host memory on a side CUDA stream, and the consumer's stream waits for
that copy before it gets the batch.

The trainer does not use this feed (it reads ``dataset.get_batch`` between
steps, as the JAX trainer does).  ``sharding=`` has no meaning on one card
and is refused: multi-device placement is ROADMAP item 1.7.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch


def batch_iterator(
    dataset,
    indices,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    epoch: int = 0,
    drop_last: bool = True,
) -> Iterator[dict[str, np.ndarray]]:
    """Yield stacked numpy batches from ``dataset.get_batch``."""
    idx = np.asarray(indices)
    if shuffle:
        rng = np.random.default_rng((seed, epoch))
        idx = rng.permutation(idx)
    n_full = len(idx) // batch_size
    end = n_full * batch_size if drop_last else len(idx)
    for start in range(0, end, batch_size):
        chunk = idx[start : start + batch_size]
        if len(chunk) == 0:
            continue
        yield dataset.get_batch(chunk, epoch=epoch)


def threaded_producer(make_iter: Callable[[], Iterable], depth: int = 4):
    """Run an iterator in a background thread with a bounded queue; an
    exception in the thread is raised on the consumer side."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()
    err: list[BaseException] = []

    def work():
        try:
            for item in make_iter():
                q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=work, daemon=True)
    t.start()

    def gen():
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item

    return gen()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def device_prefetch(
    iterator: Iterable,
    *,
    size: int = 2,
    device: torch.device | str | None = None,
    sharding=None,
) -> Iterator:
    """Keep ``size`` batches in flight on ``device`` (double buffering by
    default); yields each batch with its numpy arrays as tensors there.
    ``device`` defaults to the card; ``"cpu"`` yields CPU tensors.

    On the card each array is pinned and copied on a side stream; before a
    batch is yielded, the current stream waits for that batch's copies (an
    event recorded after them) and each tensor is recorded on it, so the
    caching allocator does not reuse the memory while the consumer's work is
    in flight.  The arguments are checked when it is called, not at the
    first batch."""
    if sharding is not None:
        raise ValueError("device_prefetch(sharding=...) places batches across devices; the "
                         "port feeds one device: multi-device is ROADMAP item 1.7, not ported")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' to feed the CPU")

    def as_tensor(x):
        return torch.from_numpy(x) if isinstance(x, np.ndarray) else x

    def is_array(x):
        return isinstance(x, (np.ndarray, torch.Tensor))

    if device.type != "cuda":
        def place(batch):
            return _tree_map(lambda x: as_tensor(x).to(device) if is_array(x) else x, batch)

        def hand_over(batch):
            return batch
    else:
        stream = torch.cuda.Stream(device)

        def place(batch):
            copied = []

            def copy(x):
                if not is_array(x):
                    return x
                copied.append(as_tensor(x).pin_memory().to(device, non_blocking=True))
                return copied[-1]

            with torch.cuda.stream(stream):
                out = _tree_map(copy, batch)
                done = torch.cuda.Event()
                done.record(stream)
            return out, copied, done

        def hand_over(placed):
            batch, copied, done = placed
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in copied:
                t.record_stream(consumer)
            return batch

    def gen():
        buf = collections.deque()
        it = iter(iterator)
        try:
            while len(buf) < size:
                buf.append(place(next(it)))
        except StopIteration:
            pass
        while buf:
            out = buf.popleft()
            try:
                buf.append(place(next(it)))
            except StopIteration:
                pass
            yield hand_over(out)

    return gen()
