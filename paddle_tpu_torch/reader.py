"""Reader decorators (counterpart of ``paddle_tpu/reader.py``).

Generator-composition utilities predating the DataLoader, with the JAX
package's host-side semantics (no device involvement).
"""

import itertools
import random as _random
from queue import Queue
from threading import Thread

__all__ = [
    "cache", "map_readers", "shuffle", "chain", "compose", "buffered",
    "firstn", "xmap_readers", "multiprocess_reader", "ComposeNotAligned",
]


def cache(reader):
    """Cache all items in memory on first pass (reference: reader.cache)."""
    all_data = tuple(reader())

    def cached_reader():
        yield from all_data
    return cached_reader


def map_readers(func, *readers):
    """Zip readers, map func over the tuples (reference: map_readers)."""
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)
    return reader


def shuffle(reader, buf_size):
    """Shuffle within a sliding buffer (reference: reader.shuffle)."""
    def shuffled():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf
    return shuffled


def chain(*readers):
    """Concatenate readers (reference: reader.chain)."""
    def chained():
        yield from itertools.chain(*[r() for r in readers])
    return chained


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, check_alignment=True):
    """Zip readers into flat tuples (reference: reader.compose)."""
    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def composed():
        rs = [r() for r in readers]
        if check_alignment:
            for items in itertools.zip_longest(*rs):
                if any(i is None for i in items):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum((make_tuple(i) for i in items), ())
        else:
            for items in zip(*rs):
                yield sum((make_tuple(i) for i in items), ())
    return composed


def buffered(reader, size):
    """Prefetch into a bounded queue on a thread (reference: buffered)."""
    class _End:
        pass

    def buffered_reader():
        q = Queue(maxsize=size)

        def fill():
            for item in reader():
                q.put(item)
            q.put(_End)
        Thread(target=fill, daemon=True).start()
        while True:
            item = q.get()
            if item is _End:
                return
            yield item
    return buffered_reader


def firstn(reader, n):
    """First n items (reference: reader.firstn)."""
    def firstn_reader():
        yield from itertools.islice(reader(), n)
    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Thread-pool map over a STREAMING reader through bounded queues
    (reference: xmap_readers — same contract: items flow through
    process_num workers; order=True preserves input order)."""
    class _End:
        pass

    class _Error:
        def __init__(self, exc):
            self.exc = exc

    def xreader():
        in_q = Queue(maxsize=buffer_size)
        out_q = Queue(maxsize=buffer_size)

        def feed():
            try:
                for i, item in enumerate(reader()):
                    in_q.put((i, item))
            except BaseException as e:  # surface in the consumer
                out_q.put(_Error(e))
            finally:
                for _ in range(process_num):
                    in_q.put(_End)

        def work():
            try:
                while True:
                    got = in_q.get()
                    if got is _End:
                        return
                    i, item = got
                    out_q.put((i, mapper(item)))
            except BaseException as e:
                out_q.put(_Error(e))
            finally:
                out_q.put(_End)

        Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            Thread(target=work, daemon=True).start()
        done = 0
        pending = {}
        next_i = 0
        while done < process_num:
            got = out_q.get()
            if got is _End:
                done += 1
                continue
            if isinstance(got, _Error):
                raise got.exc
            i, val = got
            if order:
                pending[i] = val
                while next_i in pending:
                    yield pending.pop(next_i)
                    next_i += 1
            else:
                yield val
        for i in sorted(pending):
            yield pending[i]
    return xreader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Interleave multiple readers (reference: multiprocess_reader; the
    host pipeline here is thread-based)."""
    def reader():
        iters = [r() for r in readers]
        alive = [True] * len(iters)
        while any(alive):
            for i, it in enumerate(iters):
                if not alive[i]:
                    continue
                try:
                    yield next(it)
                except StopIteration:
                    alive[i] = False
    return reader
