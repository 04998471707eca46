"""Host-side stores: key -> bin-count storage with dynamic growth (PyTorch port).

Counterpart of ``sketches_tpu/store.py``, copied as is: ``Store``,
``DenseStore``, ``CollapsingLowestDenseStore`` and
``CollapsingHighestDenseStore`` (parity target: reference
``ddsketch/store.py``).  Plain Python lists with dynamic resizing, used as
the pure-Python single-sketch backend and as the oracle the batched device
tier is tested against.  The wire encoder's chunk padding
(``pb/wire.py``, ``_CHUNK``) follows ``DenseStore._get_new_length``, so
neither may change without the other.

The device counterpart lives in ``sketches_tpu_torch/batched.py``: a static
``[n_streams, n_bins]`` tensor with clamp-to-edge (always-collapsing)
semantics.
"""

from __future__ import annotations

import abc
import math
from typing import Iterator, Optional

__all__ = [
    "Store",
    "DenseStore",
    "CollapsingLowestDenseStore",
    "CollapsingHighestDenseStore",
]

CHUNK_SIZE = 128


class Store(abc.ABC):
    """Bin-count storage contract: integer keys -> float weights.

    Reference seam: ``ddsketch/store.py . Store``.

    Failure modes: ``merge`` raises ``TypeError`` for an incompatible
    store type; ``key_at_rank`` on an empty store is undefined --
    callers guard on ``is_empty`` (the sketches return ``None``/NaN for
    empty-sketch quantiles instead of calling in).
    """

    count: float

    @abc.abstractmethod
    def add(self, key: int, weight: float = 1.0) -> None:
        """Accumulate ``weight`` into bucket ``key``."""

    @abc.abstractmethod
    def key_at_rank(self, rank: float, lower: bool = True) -> int:
        """Key of the bucket containing the value of cumulative rank ``rank``.

        ``lower=True``: smallest key whose cumulative count exceeds ``rank``;
        ``lower=False``: smallest key whose cumulative count reaches
        ``rank + 1``.
        """

    @abc.abstractmethod
    def merge(self, store: "Store") -> None:
        """Fold another store's mass into this one (same-key addition)."""

    @abc.abstractmethod
    def copy(self) -> "Store":
        """Deep copy."""

    @property
    @abc.abstractmethod
    def is_empty(self) -> bool:
        ...


class DenseStore(Store):
    """Contiguous bins over ``[offset, offset + len(bins))``; grows on demand.

    Reference seam: ``ddsketch/store.py . DenseStore``.  Growth happens in
    ``CHUNK_SIZE`` steps; ``key_at_rank`` is a linear cumulative walk.

    Failure modes: ``merge`` of a non-dense store raises ``TypeError``;
    growth is unbounded by design (the collapsing subclasses bound it by
    folding overflow mass into the edge bins instead of failing), and
    ``key_at_rank`` on an empty store is undefined (guard on
    ``is_empty``).
    """

    def __init__(self, chunk_size: int = CHUNK_SIZE):
        self.chunk_size = chunk_size
        self.bins: list[float] = []
        self.count = 0.0
        self.min_key = math.inf
        self.max_key = -math.inf
        self.offset = 0

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(count={self.count}, offset={self.offset},"
            f" bins={{{', '.join(f'{i + self.offset}: {b}' for i, b in enumerate(self.bins) if b > 0)}}})"
        )

    @property
    def is_empty(self) -> bool:
        return self.count == 0

    def keys(self) -> Iterator[int]:
        for i, b in enumerate(self.bins):
            if b > 0:
                yield i + self.offset

    def add(self, key: int, weight: float = 1.0) -> None:
        idx = self._get_index(key)
        self.bins[idx] += weight
        self.count += weight

    def _get_index(self, key: int) -> int:
        if key < self.min_key:
            self._extend_range(key)
        elif key > self.max_key:
            self._extend_range(key)
        return key - self.offset

    def _get_new_length(self, new_min_key: int, new_max_key: int) -> int:
        desired = new_max_key - new_min_key + 1
        return self.chunk_size * int(math.ceil(desired / self.chunk_size))

    def _extend_range(self, key: int, second_key: Optional[int] = None) -> None:
        second_key = key if second_key is None else second_key
        new_min_key = min(key, second_key, self.min_key)
        new_max_key = max(key, second_key, self.max_key)

        if self.is_empty and not self.bins:
            self.bins = [0.0] * self._get_new_length(new_min_key, new_max_key)
            self.offset = new_min_key
            self._adjust(new_min_key, new_max_key)
        elif new_min_key >= self.offset and new_max_key < self.offset + len(self.bins):
            self.min_key = min(self.min_key, new_min_key)
            self.max_key = max(self.max_key, new_max_key)
        else:
            new_length = self._get_new_length(new_min_key, new_max_key)
            if new_length > len(self.bins):
                self.bins.extend([0.0] * (new_length - len(self.bins)))
            self._adjust(new_min_key, new_max_key)

    def _adjust(self, new_min_key: int, new_max_key: int) -> None:
        """Recenter the physical array on the new key range (no collapsing)."""
        self._center_bins(new_min_key, new_max_key)
        self.min_key = min(self.min_key, new_min_key)
        self.max_key = max(self.max_key, new_max_key)

    def _shift_bins(self, shift: int) -> None:
        """Physically move bin contents by ``shift`` slots (offset -= shift)."""
        if shift > 0:
            self.bins = [0.0] * shift + self.bins[: len(self.bins) - shift]
        else:
            self.bins = self.bins[-shift:] + [0.0] * (-shift)
        self.offset -= shift

    def _center_bins(self, new_min_key: int, new_max_key: int) -> None:
        middle_key = new_min_key + (new_max_key - new_min_key + 1) // 2
        self._shift_bins(self.offset + len(self.bins) // 2 - middle_key)

    def key_at_rank(self, rank: float, lower: bool = True) -> int:
        running = 0.0
        for i, b in enumerate(self.bins):
            running += b
            if (lower and running > rank) or (not lower and running >= rank + 1):
                return i + self.offset
        return int(self.max_key)

    def merge(self, store: Store) -> None:
        if not isinstance(store, DenseStore):
            raise TypeError(f"Cannot merge {type(self).__name__} with {type(store).__name__}")
        if store.is_empty:
            return
        # The fast path (adopt the operand's bins wholesale) is only sound
        # when both stores share collapse semantics; otherwise an unbounded
        # store could inherit collapsed state, or a bounded one could exceed
        # its bin_limit.  Mixed types re-bin through add_raw, which clamps.
        if self.is_empty and type(store) is type(self) and (
            getattr(self, "bin_limit", None) == getattr(store, "bin_limit", None)
        ):
            self._copy_from(store)
            return
        self._extend_range(int(store.min_key), int(store.max_key))
        for i, b in enumerate(store.bins):
            if b > 0:
                self.add_raw(i + store.offset, b)

    def add_raw(self, key: int, weight: float) -> None:
        """Merge helper: same as add() (subclasses clamp here too)."""
        self.add(key, weight)

    def _copy_from(self, store: "DenseStore") -> None:
        self.bins = list(store.bins)
        self.offset = store.offset
        self.min_key = store.min_key
        self.max_key = store.max_key
        self.count = store.count

    def copy(self) -> "DenseStore":
        new = type(self).__new__(type(self))
        new.__dict__.update(self.__dict__)
        new.bins = list(self.bins)
        return new


class CollapsingLowestDenseStore(DenseStore):
    """DenseStore bounded by ``bin_limit``: keys below the representable floor
    collapse into the lowest bin (mass conserved, resolution lost at the low
    end).  Reference seam: ``ddsketch/store.py . CollapsingLowestDenseStore``.
    """

    def __init__(self, bin_limit: int, chunk_size: int = CHUNK_SIZE):
        super().__init__(chunk_size)
        self.bin_limit = bin_limit
        self.is_collapsed = False

    def _get_new_length(self, new_min_key: int, new_max_key: int) -> int:
        return min(super()._get_new_length(new_min_key, new_max_key), self.bin_limit)

    def _get_index(self, key: int) -> int:
        if key < self.min_key:
            if self.is_collapsed:
                return 0
            self._extend_range(key)
            if self.is_collapsed:
                return 0
        elif key > self.max_key:
            self._extend_range(key)
        return key - self.offset

    def _adjust(self, new_min_key: int, new_max_key: int) -> None:
        if new_max_key - new_min_key + 1 > len(self.bins):
            # Range exceeds capacity: pin to the top, collapse the bottom.
            new_min_key = new_max_key - len(self.bins) + 1
            if new_min_key >= self.max_key:
                # Everything currently stored collapses into the new floor bin.
                self.offset = new_min_key
                self.min_key = new_min_key
                self.bins = [0.0] * len(self.bins)
                self.bins[0] = self.count
            else:
                shift = self.offset - new_min_key
                if shift < 0:
                    collapsed = sum(self.bins[: -shift])
                    self.bins[: -shift] = [0.0] * (-shift)
                    self._shift_bins(shift)
                    self.bins[0] += collapsed
                else:
                    self._shift_bins(shift)
                self.min_key = new_min_key
            self.max_key = new_max_key
            self.is_collapsed = True
        else:
            self._center_bins(new_min_key, new_max_key)
            self.min_key = min(self.min_key, new_min_key)
            self.max_key = max(self.max_key, new_max_key)

    def _copy_from(self, store: DenseStore) -> None:
        super()._copy_from(store)
        if isinstance(store, CollapsingLowestDenseStore):
            self.is_collapsed = store.is_collapsed


class CollapsingHighestDenseStore(DenseStore):
    """Mirror image of CollapsingLowestDenseStore: overflow keys collapse into
    the highest bin.  Reference seam:
    ``ddsketch/store.py . CollapsingHighestDenseStore``.
    """

    def __init__(self, bin_limit: int, chunk_size: int = CHUNK_SIZE):
        super().__init__(chunk_size)
        self.bin_limit = bin_limit
        self.is_collapsed = False

    def _get_new_length(self, new_min_key: int, new_max_key: int) -> int:
        return min(super()._get_new_length(new_min_key, new_max_key), self.bin_limit)

    def _get_index(self, key: int) -> int:
        if key > self.max_key:
            if self.is_collapsed:
                return len(self.bins) - 1
            self._extend_range(key)
            if self.is_collapsed:
                return len(self.bins) - 1
        elif key < self.min_key:
            self._extend_range(key)
        return key - self.offset

    def _adjust(self, new_min_key: int, new_max_key: int) -> None:
        if new_max_key - new_min_key + 1 > len(self.bins):
            # Range exceeds capacity: pin to the bottom, collapse the top.
            new_max_key = new_min_key + len(self.bins) - 1
            if new_max_key <= self.min_key:
                self.offset = new_min_key
                self.min_key = new_min_key
                self.max_key = new_max_key
                self.bins = [0.0] * len(self.bins)
                self.bins[-1] = self.count
            else:
                shift = self.offset - new_min_key
                if shift > 0:
                    collapsed = sum(self.bins[len(self.bins) - shift :])
                    self.bins[len(self.bins) - shift :] = [0.0] * shift
                    self._shift_bins(shift)
                    self.bins[-1] += collapsed
                else:
                    self._shift_bins(shift)
                self.max_key = new_max_key
            self.min_key = new_min_key
            self.is_collapsed = True
        else:
            self._center_bins(new_min_key, new_max_key)
            self.min_key = min(self.min_key, new_min_key)
            self.max_key = max(self.max_key, new_max_key)

    def _copy_from(self, store: DenseStore) -> None:
        super()._copy_from(store)
        if isinstance(store, CollapsingHighestDenseStore):
            self.is_collapsed = store.is_collapsed
