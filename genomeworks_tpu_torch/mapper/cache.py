"""Index caches — recompute-avoidance across index-pair batches.

Reference: cudamapper's IndexHostCopy / HostIndexCache / DeviceIndexCache
(src/index_host_copy.cuh:33, src/index_cache.cuh:46-160): indices built
once per batch run are kept on the host and re-staged to the device as
batches need them, with separate query/target cache types.

Counterpart of genomeworks_tpu/mapper/cache.py: ``HostIndexCache`` is a
copy (an LRU cache of host indexes); ``DeviceIndexCache`` stages each host
index once as a :class:`~genomeworks_tpu_torch.mapper.device_pipeline.DeviceIndex`
of tensors on the device.
"""

from __future__ import annotations

import collections
import enum
from typing import Callable

import torch

from genomeworks_tpu_torch.mapper.batcher import IndexDescriptor
from genomeworks_tpu_torch.mapper.index import Index


class CacheType(enum.Enum):
    """index_cache.cuh:46 — query_cache / target_cache."""

    query_cache = 0
    target_cache = 1


class HostIndexCache:
    """LRU cache of built indices keyed by IndexDescriptor
    (HostIndexCache::generate_content / get_index_from_cache semantics,
    index_cache.cuh:132)."""

    def __init__(
        self,
        cache_type: CacheType,
        build_fn: Callable[[IndexDescriptor], Index],
        capacity: int | None = None,
    ) -> None:
        self.cache_type = cache_type
        self._build = build_fn
        self._capacity = capacity
        self._store: collections.OrderedDict[IndexDescriptor, Index] = (
            collections.OrderedDict()
        )
        self.hits = 0
        self.misses = 0

    def generate_content(self, descriptors: list[IndexDescriptor]) -> None:
        """Pre-build (or refresh) the given descriptors' indices."""
        for d in descriptors:
            self.get_index(d)

    def get_index(self, descriptor: IndexDescriptor) -> Index:
        idx = self._store.get(descriptor)
        if idx is not None:
            self.hits += 1
            self._store.move_to_end(descriptor)
            return idx
        self.misses += 1
        idx = self._build(descriptor)
        self._store[descriptor] = idx
        if self._capacity is not None:
            while len(self._store) > self._capacity:
                self._store.popitem(last=False)
        return idx

    def __len__(self) -> int:
        return len(self._store)


class DeviceIndexCache:
    """Device-resident index cache (the reference's DeviceIndexCache,
    index_cache.cuh:55, which stages host copies into device memory per
    batch): ``get_index`` uploads the host index's arrays once to
    ``device`` (``None`` = the CUDA card) and returns a cached
    :class:`~genomeworks_tpu_torch.mapper.device_pipeline.DeviceIndex`.
    ``wait_for_data_to_be_ready`` blocks until the uploads are done (the
    reference's copy-event wait, index_cache.cuh:96)."""

    def __init__(
        self,
        host_cache: HostIndexCache,
        capacity: int | None = None,
        device=None,
    ) -> None:
        from genomeworks_tpu_torch.core.device import resolve_device

        self._host = host_cache
        self._capacity = capacity
        self.device = resolve_device(device)
        self._store: collections.OrderedDict = collections.OrderedDict()

    def get_index(self, descriptor: IndexDescriptor):
        dev = self._store.get(descriptor)
        if dev is not None:
            self._store.move_to_end(descriptor)
            return dev
        from genomeworks_tpu_torch.mapper.device_pipeline import DeviceIndex

        dev = DeviceIndex.from_index(self._host.get_index(descriptor), self.device)
        self._store[descriptor] = dev
        if self._capacity is not None:
            while len(self._store) > self._capacity:
                self._store.popitem(last=False)
        return dev

    def wait_for_data_to_be_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __len__(self) -> int:
        return len(self._store)
