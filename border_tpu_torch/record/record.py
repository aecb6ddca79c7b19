"""Record: a typed key→value map for training telemetry
(own copy of border_tpu/record/record.py; the port imports nothing of the
JAX package).

≙ border-core Record (record/base.rs:33-341): RecordValue variants
Scalar/DateTime/Array1/Array2/Array3/String become plain Python
scalars/numpy arrays/datetimes/strings; ``merge`` (base.rs:166-186) and the
typed getters carry over.  RecordStorage (storage.rs:21-358) aggregates
buffered scalars at flush into ``{key}_min/_max/_mean/_median`` and keeps the
most recent value for non-scalars (storage.rs:284-307).
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from border_tpu_torch.errors import RecordKeyError, RecordValueTypeError


def _is_scalar(v: Any) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) or (
        hasattr(v, "shape") and getattr(v, "shape", None) == ()
    )


class Record:
    """Dict-like container of telemetry values."""

    def __init__(self, items: Optional[Dict[str, Any]] = None):
        self._items: Dict[str, Any] = dict(items or {})

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_scalar(cls, key: str, value: float) -> "Record":
        return cls({key: float(value)})

    @classmethod
    def empty(cls) -> "Record":
        return cls()

    @classmethod
    def now(cls, key: str = "datetime") -> "Record":
        return cls({key: datetime.datetime.now()})

    # -- mapping protocol --------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._items[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._items[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._items.items())

    def keys(self):
        return self._items.keys()

    def items(self):
        return self._items.items()

    def is_empty(self) -> bool:
        return not self._items

    # -- reference API parity ----------------------------------------------
    def merge(self, other: "Record") -> "Record":
        """Right-biased merge (≙ Record::merge, base.rs:166-186)."""
        merged = dict(self._items)
        merged.update(other._items)
        return Record(merged)

    def merge_inplace(self, other: "Record") -> None:
        self._items.update(other._items)

    def _get(self, key: str):
        try:
            return self._items[key]
        except KeyError:
            raise RecordKeyError(key) from None

    def get_scalar(self, key: str) -> float:
        """Typed getter (≙ base.rs get_scalar; raises the LrrError-style
        RecordKeyError/RecordValueTypeError, border-core/src/error.rs:1-14,
        both also catchable as plain KeyError/TypeError)."""
        v = self._get(key)
        if not _is_scalar(v):
            raise RecordValueTypeError(key, "scalar", type(v).__name__)
        return float(v)

    def get_scalar_without_key(self) -> float:
        """The single scalar in a one-entry record (≙ base.rs:330-341)."""
        scalars = [v for v in self._items.values() if _is_scalar(v)]
        if len(scalars) != 1:
            raise ValueError(
                f"expected exactly one scalar, found {len(scalars)}"
            )
        return float(scalars[0])

    def get_array(self, key: str) -> np.ndarray:
        return np.asarray(self._get(key))

    def get_string(self, key: str) -> str:
        v = self._get(key)
        if not isinstance(v, str):
            raise RecordValueTypeError(key, "string", type(v).__name__)
        return v

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._items)

    def __repr__(self) -> str:
        return f"Record({self._items!r})"


class RecordStorage:
    """Buffers records between flushes and aggregates scalars.

    ≙ RecordStorage (record/storage.rs:21-358): at flush, scalar keys with
    >1 stored values become ``{key}_min/_max/_mean/_median``; single values
    pass through unchanged; non-scalars keep the most recent value
    (storage.rs:284-307, aggregate :338).
    """

    def __init__(self) -> None:
        self._store: Dict[str, List[Any]] = {}

    def store(self, record: Record) -> None:
        for k, v in record.items():
            self._store.setdefault(k, []).append(v)

    def aggregate(self) -> Record:
        out: Dict[str, Any] = {}
        for k, vs in self._store.items():
            if all(_is_scalar(v) for v in vs):
                if len(vs) == 1:
                    out[k] = float(vs[0])
                else:
                    arr = np.asarray([float(v) for v in vs])
                    out[f"{k}_min"] = float(arr.min())
                    out[f"{k}_max"] = float(arr.max())
                    out[f"{k}_mean"] = float(arr.mean())
                    out[f"{k}_median"] = float(np.median(arr))
            else:
                out[k] = vs[-1]
        self._store.clear()
        return Record(out)

    def __len__(self) -> int:
        return len(self._store)
