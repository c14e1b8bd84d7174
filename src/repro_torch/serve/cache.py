"""Query-result LRU cache of the serving engine.

Keys are ``(index epoch, delta sequence, dynamic-params bytes + canonical
query bytes)`` (``core.query.query_key``, ``DynamicParams.key_bytes``): a
hot-swap bumps the epoch, so results of a retired index can never be served
again. Hit and miss counters live in ``ServeStats`` (the engine owns the
probe); the cache itself counts evictions.
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class QueryResultCache:
    """Thread-safe LRU over hashable query keys. get() refreshes recency;
    put() inserts at the most-recent end and evicts from the least-recent."""

    def __init__(self, capacity: int = 1024):
        if capacity <= 0:
            raise ValueError("use cache_size=0 on the engine to disable caching")
        self.capacity = capacity
        self.evictions = 0
        self._od: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def get(self, key):
        """The cached value, or None. A hit becomes the most recently used entry."""
        with self._lock:
            if key not in self._od:
                return None
            self._od.move_to_end(key)
            return self._od[key]

    def put(self, key, value) -> None:
        with self._lock:
            self._od[key] = value
            self._od.move_to_end(key)
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)
                self.evictions += 1

    def purge(self, pred) -> int:
        """Drop every entry whose key satisfies ``pred``; returns the count
        dropped. After a hot-swap the engine purges the retired epochs, whose
        entries can never hit again, to return their capacity at once."""
        with self._lock:
            dead = [k for k in self._od if pred(k)]
            for k in dead:
                del self._od[k]
            return len(dead)

    def clear(self) -> None:
        with self._lock:
            self._od.clear()
