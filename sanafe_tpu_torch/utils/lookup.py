"""Step-function lookup table (reference: ``src/utils.hpp:19-45``).

Used for table-driven per-timestep synchronization delays keyed on the number
of mapped tiles (``arch/loihi.yaml:13-16``): returns the value for the largest
key that is <= x, or a default when no key qualifies.
"""

from __future__ import annotations

from bisect import bisect_right


class LookupTable:
    def __init__(self, entries: dict[int, float] | None = None, default: float = 0.0):
        self.default = default
        items = sorted((entries or {}).items())
        self._keys = [k for k, _ in items]
        self._values = [v for _, v in items]

    def set(self, key: int, value: float) -> None:
        idx = bisect_right(self._keys, key)
        if idx > 0 and self._keys[idx - 1] == key:
            self._values[idx - 1] = value
        else:
            self._keys.insert(idx, key)
            self._values.insert(idx, value)

    def get(self, x: int) -> float:
        idx = bisect_right(self._keys, x)
        if idx == 0:
            return self.default
        return self._values[idx - 1]

    def __bool__(self) -> bool:
        return bool(self._keys)

    def as_dict(self) -> dict[int, float]:
        return dict(zip(self._keys, self._values))
