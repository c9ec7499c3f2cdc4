"""Epoch-level sample caching: amortize the host sampler across epochs.

On a host whose sampler is slower than the device step, the standard trick is to reuse each epoch's sampled subgraphs for several
epochs ("lazy resampling"): epoch 0 pays the full sampling cost, epochs
1..k-1 replay the cached batches (optionally in a new order), so their
wall-clock is the pure device time. Gradient noise from reused samples is
negligible for small k (the minibatch ordering still reshuffles).

The reference has no counterpart — its loaders resample every epoch
(gammagl/loader/neighbor_sampler.py); with its CPU sampler this is the
dominant epoch cost (profiler/sampler/readme.md: 11.26 s/epoch on Reddit).

Works with any re-iterable loader whose items are host objects
(NeighborSamplerLoader, NodeLoader, ...). Items are held as-is: at the
Reddit protocol that's ids + edge blocks (~6 MB/batch, ~1.4 GB/epoch),
NOT features — those stay in the device cache. For an epoch too large to
hold, keep `resample_every=1` (no caching) or shrink the seed set.
"""

__all__ = ["EpochCache"]

import numpy as np


class EpochCache:
    """Iterate a loader; replay cached batches between resampling epochs.

    Parameters
    ----------
    loader : any re-iterable yielding per-batch host objects
    resample_every : int — re-run the underlying loader every k-th epoch
        (1 = no caching, behave like the plain loader).
    reshuffle : bool — permute the replay order each cached epoch (the
        usual SGD ordering noise without resampling cost).
    seed : int — reshuffle RNG seed.
    """

    def __init__(self, loader, resample_every=5, reshuffle=True, seed=0):
        if resample_every < 1:
            raise ValueError("resample_every must be >= 1")
        self.loader = loader
        self.resample_every = resample_every
        self.reshuffle = reshuffle
        self._rng = np.random.default_rng(seed)
        self._cache = None
        self._epoch = 0

    def __len__(self):
        if self._cache is not None:
            return len(self._cache)
        return len(self.loader)

    def invalidate(self):
        """Drop the cache; the next epoch resamples."""
        self._cache = None
        self._epoch = 0

    def __getattr__(self, name):
        # delegate loader attributes (e.g. NeighborSamplerLoader.sample)
        return getattr(self.loader, name)

    def __iter__(self):
        fresh = (self._cache is None
                 or self._epoch % self.resample_every == 0)
        self._epoch += 1
        if fresh:
            cache = []
            for item in self.loader:
                cache.append(item)
                yield item
            self._cache = cache
            return
        order = (self._rng.permutation(len(self._cache))
                 if self.reshuffle else range(len(self._cache)))
        for i in order:
            yield self._cache[i]
