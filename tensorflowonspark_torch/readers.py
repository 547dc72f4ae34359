"""The prefetch pump of the input pipelines.

A copy of ``tensorflowonspark_tpu/readers.py::prefetched`` with its imports
rewritten: the port never imports the JAX package.  The TFRecord and
Parquet readers of that module are not ported yet.
"""

from __future__ import annotations

import queue as _queue_mod
import threading
from typing import Any, Callable, Iterator

_END = object()  # sentinel: a producer finished


def prefetched(batch_gen_fn: Callable[[], Iterator[Any]],
               prefetch: int) -> Iterator[Any]:
    """Run ``batch_gen_fn()`` in a pipeline thread, ``prefetch`` items ahead.

    ``prefetch <= 0`` degrades to the plain generator.  Producer exceptions
    re-raise on the consumer side; abandoning the iterator (break /
    GeneratorExit) stops the pump and the underlying generator's cleanup
    (``finally`` blocks, reader pools) runs promptly.

    The serving data plane (``pipeline._RunModel``: batch N+1 assembled and
    copied to the device while batch N computes) double-buffers through it.
    """
    if prefetch <= 0:
        yield from batch_gen_fn()
        return

    out: _queue_mod.Queue = _queue_mod.Queue(maxsize=prefetch)
    err: list[BaseException] = []
    abandoned = threading.Event()  # consumer gave up (break / GeneratorExit)

    def pump() -> None:
        gen = batch_gen_fn()
        try:
            for b in gen:
                while not abandoned.is_set():
                    try:
                        out.put(b, timeout=0.1)
                        break
                    except _queue_mod.Full:
                        continue
                if abandoned.is_set():
                    return
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            gen.close()  # runs the source's finally → pool.stop()
            # The sentinel MUST reach a live consumer even when the queue is
            # momentarily full of staged batches; dropping it is only safe
            # once the consumer has abandoned the iterator.
            while True:
                try:
                    out.put(_END, timeout=0.1)
                    break
                except _queue_mod.Full:
                    if abandoned.is_set():
                        break

    t = threading.Thread(target=pump, daemon=True, name="tfos-prefetch")
    t.start()
    try:
        while True:
            item = out.get()
            if item is _END:
                break
            yield item
    finally:
        abandoned.set()
        while True:  # drain so a blocked timed put wakes promptly
            try:
                out.get_nowait()
            except _queue_mod.Empty:
                break
        t.join(timeout=10.0)
    if err:
        raise err[0]
