"""Host-side batch iteration over a window dataset.

Counterpart of ``deepards_tpu/train/loader.py``, unchanged in behaviour:
the whole cache is a dense array, so an epoch is a shuffled index array
cut into batches, each one ``gather``; ``PrefetchLoader`` prepares the
next batch (gather, pad, copy to the device) on a thread while the device
runs the current one.  The trainer's default epoch gathers on the device
instead and bypasses both.
"""
import numpy as np


class EpochLoader:
    def __init__(self, dataset, batch_size, shuffle=True, rng=None,
                 drop_last=False, indices=None, start_batch=0):
        """``indices`` pins the exact (already shuffled) epoch order and
        ``start_batch`` skips the first N batches — the mid-epoch resume
        hooks (SURVEY §5.4): a step checkpoint records the permutation and
        position so resumption replays the identical remaining batches."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = rng or np.random.default_rng(0)
        self.drop_last = drop_last
        self.indices = indices
        self.start_batch = start_batch

    def _rows(self):
        if self.indices is not None:
            return len(self.indices)
        return len(self.dataset.current_indices())

    def __len__(self):
        n = self._rows()
        if self.drop_last:
            total = n // self.batch_size
        else:
            total = int(np.ceil(n / self.batch_size))
        return max(total - self.start_batch, 0)

    def batch_sizes(self):
        """The rows of each batch the epoch yields."""
        starts = np.arange(self.start_batch,
                           self.start_batch + len(self)) * self.batch_size
        return np.minimum(self._rows() - starts, self.batch_size)

    def __iter__(self):
        if self.indices is not None:
            idx = np.asarray(self.indices)
        else:
            idx = np.asarray(self.dataset.current_indices())
            if self.shuffle:
                idx = self.rng.permutation(idx)
        n = len(idx)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(self.start_batch * self.batch_size, stop,
                           self.batch_size):
            yield self.dataset.gather(idx[start : start + self.batch_size])


class _PrefetchError:
    def __init__(self, exc):
        self.exc = exc


class PrefetchLoader:
    """Double-buffered host->device prefetch.

    A background thread runs the wrapped iterable (gather, augmentation,
    copy to the device via ``map_fn``) while the device executes the current
    batch, overlapping input preparation with compute — the equivalent of
    the reference's ``DataLoader(num_workers=...)`` worker processes
    (reference: train_ards_detector.py:329-336).  ``depth`` bounds how
    many prepared batches may be in flight (2 = classic double buffer).
    """

    _DONE = object()

    def __init__(self, iterable, map_fn=None, depth=2):
        self.iterable = iterable
        self.map_fn = map_fn
        self.depth = depth

    def __len__(self):
        return len(self.iterable)

    def __iter__(self):
        import queue
        import threading

        q = queue.Queue(maxsize=self.depth)

        def worker():
            try:
                for item in self.iterable:
                    q.put(self.map_fn(item) if self.map_fn else item)
            except BaseException as exc:  # surface in the consumer thread
                q.put(_PrefetchError(exc))
                return
            q.put(self._DONE)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is self._DONE:
                break
            if isinstance(item, _PrefetchError):
                raise item.exc
            yield item
