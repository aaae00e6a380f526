"""Single-worker host-prep prefetch (copy of ``ospo_tpu/utils/prefetch.py``).

Host halves (PNG decode, tokenize, preprocessing, collate) run on ONE
worker thread while the device executes the previous item's device half.
One worker, one item ahead: enough to hide host prep under device time
without unbounded image/RAM growth.  Used by the trainer's batches
(``train/trainer.SimPOTrainer.fit``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Tuple, TypeVar

T = TypeVar("T")
P = TypeVar("P")

_END = object()


def prefetch_iter(
    iterable: Iterable[T],
    prepare: Callable[[T], P] = None,
    name: str = "prefetch",
) -> Iterator[Tuple[T, P]]:
    """Yield ``(item, prepare(item))`` with the NEXT pair computed on a
    worker thread while the caller consumes the current one.

    Both the source pull (``next``) and ``prepare`` run on the worker —
    lazily-materializing iterators (e.g. ``PreferenceDataset.iter_batches``,
    whose ``__getitem__`` PNG-decode happens at ``next()``) are prefetched
    in full, not just their cheap tail transform.  Exceptions from either
    surface in the CALLER at ``yield`` time (via ``Future.result()``), so
    per-item fault handling stays at the call site.  Early exit (break /
    close) abandons the in-flight pull without blocking on it.
    """
    it = iter(iterable)
    if prepare is None:
        prepare = lambda x: x  # noqa: E731

    def pull():
        try:
            item = next(it)
        except StopIteration:
            return _END
        return item, prepare(item)

    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix=name)
    try:
        nxt = pool.submit(pull)
        while True:
            got = nxt.result()
            if got is _END:
                return
            nxt = pool.submit(pull)
            yield got
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
