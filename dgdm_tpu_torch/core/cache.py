"""The bounded least-recently-used map of the port's host work (no JAX
counterpart: the JAX package's engines keep plain dicts of their own).

Keys are bytes (a design's control points, with whatever else selects the
value); values are whatever the host work made. A hit moves its key to the
newest end, and eviction drops the oldest keys first.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence


class LRU:
    """At most ``capacity`` entries, least recently used evicted first."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._items: Dict[bytes, object] = {}

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, key: bytes) -> bool:
        return key in self._items

    def get(self, key: bytes, make: Callable[[], object]):
        """The value of ``key``, made by ``make()`` on a miss; a miss into
        a full map evicts the oldest entry once the value is made."""
        value = self._items.pop(key, None)
        if value is None:
            value = make()
            if len(self._items) >= self.capacity:
                self._items.pop(next(iter(self._items)))
        self._items[key] = value
        return value

    def get_many(self, keys: Sequence[bytes],
                 make: Callable[[List[int]], Sequence]) -> list:
        """The values of ``keys`` in order. The misses are made in one call,
        ``make(indices of the missed keys)``, and every key is then touched
        in order; eviction comes only after, so a batch larger than the
        capacity is still returned whole."""
        miss = [i for i, k in enumerate(keys) if k not in self._items]
        fresh = dict(zip([keys[i] for i in miss], make(miss))) if miss \
            else {}
        values = []
        for k in keys:
            v = fresh.get(k)
            if v is None:
                v = self._items.pop(k)
            self._items[k] = v
            values.append(v)
        while len(self._items) > self.capacity:
            self._items.pop(next(iter(self._items)))
        return values
