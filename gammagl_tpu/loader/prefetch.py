"""Double-buffered host -> device prefetch.

The successor of the reference's gglspeedup tier (SURVEY.md
section 2.6: GPU feature caches / IPC-shared samplers): a background thread
runs the host sampler + collation and `jax.device_put`s the next batch while
the current step computes, hiding transfer latency behind the step.
"""

import queue
import threading

import jax

__all__ = ["PrefetchLoader", "prefetch_to_device", "pipeline"]


def pipeline(iterator, size=2, transform=None):
    """Run `iterator` in a background thread, `size` items ahead.

    `transform` (applied in the worker thread) defaults to identity — use
    it for host-side work you want off the consumer's critical path. Use
    the bare form for iterators that already produce device-resident
    batches (e.g. via DeviceFeatureCache) carrying static metadata that
    must NOT be device_put (jit static_argnames)."""
    q = queue.Queue(maxsize=size)
    sentinel = object()
    err = []

    def worker():
        try:
            for item in iterator:
                if transform is not None:
                    item = transform(item)
                q.put(item)
        except Exception as e:  # surface in consumer thread
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


def prefetch_to_device(iterator, size=2, device=None):
    """Generator wrapping `iterator`; keeps `size` batches resident
    on device ahead of the consumer."""
    return pipeline(iterator, size,
                    transform=lambda item: jax.device_put(item, device))


class PrefetchLoader:
    """Wrap any host loader with device prefetching."""

    def __init__(self, loader, size=2, device=None):
        self.loader = loader
        self.size = size
        self.device = device

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        return prefetch_to_device(iter(self.loader), self.size, self.device)
