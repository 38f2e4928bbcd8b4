"""Memoization table (paper §2.4, Figs. 8–9).

Faithful to the paper's surface: bounded table, replacement policy on
collision (Replace flag), approximate float keys (drop `approx` mantissa
bits), persistence (fileToLoad/FileToSave), a fully-offline mode (lookup
only, never update), and a runtime stop/run toggle exposed to the autotuner.

Keys may be scalars, strings, tuples, numpy arrays or CPU tensors; values are
arbitrary nested containers (stored by reference; callers must not mutate).
"""

from __future__ import annotations

import hashlib
import pickle
from collections import OrderedDict
from typing import Any

import numpy as np


def _quantize(x: np.ndarray, approx_bits: int) -> np.ndarray:
    """Drop `approx_bits` mantissa bits of float32 keys (paper's 'approx')."""
    if approx_bits <= 0 or not np.issubdtype(x.dtype, np.floating):
        return x
    xi = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    mask = np.uint32(0xFFFFFFFF) << np.uint32(approx_bits)
    return (xi & mask).view(np.float32)


class MemoTable:
    def __init__(
        self,
        *,
        size: int = 65536,
        replace: bool = True,
        approx_bits: int = 0,
        load_path: str | None = None,
        save_path: str | None = None,
        full_offline: bool = False,
    ):
        self.size = size
        self.replace = replace
        self.approx_bits = approx_bits
        self.save_path = save_path
        self.full_offline = full_offline
        self.running = True  # the paper's dynamic stop/run knob
        self.hits = 0
        self.misses = 0
        self._data: OrderedDict[str, Any] = OrderedDict()
        if load_path:
            self.load(load_path)

    # -- keys -----------------------------------------------------------------

    def key_of(self, key: Any) -> str:
        h = hashlib.blake2b(digest_size=16)

        def feed(obj):
            if isinstance(obj, (bytes, str)):
                h.update(obj.encode() if isinstance(obj, str) else obj)
            elif isinstance(obj, (int, bool)):
                h.update(str(obj).encode())
            elif isinstance(obj, float):
                h.update(_quantize(np.asarray(obj, np.float32), self.approx_bits).tobytes())
            elif isinstance(obj, (tuple, list)):
                for o in obj:
                    feed(o)
            elif isinstance(obj, dict):
                for k in sorted(obj):
                    feed(k)
                    feed(obj[k])
            elif obj is None:
                h.update(b"\0")
            else:  # array-like (numpy / CPU tensor)
                arr = np.asarray(obj)
                h.update(str(arr.dtype).encode() + str(arr.shape).encode())
                h.update(_quantize(arr, self.approx_bits).tobytes())

        feed(key)
        return h.hexdigest()

    # -- core ops ----------------------------------------------------------------

    def lookup(self, key: Any) -> tuple[bool, Any]:
        k = self.key_of(key)
        if k in self._data:
            self.hits += 1
            self._data.move_to_end(k)  # LRU refresh
            return True, self._data[k]
        self.misses += 1
        return False, None

    def update(self, key: Any, value: Any) -> None:
        if self.full_offline or not self.running:
            return
        k = self.key_of(key)
        if k in self._data:
            if self.replace:
                self._data[k] = value
                self._data.move_to_end(k)
            return
        if len(self._data) >= self.size:
            if not self.replace:
                return
            self._data.popitem(last=False)  # evict LRU
        self._data[k] = value

    def wrap(self, fn):
        """The paper's foo_wrapper (Fig. 8)."""

        def wrapper(*args):
            if not self.running:
                return fn(*args)
            hit, value = self.lookup(args)
            if hit:
                return value
            value = fn(*args)
            self.update(args, value)
            return value

        wrapper.__wrapped__ = fn
        wrapper.table = self
        return wrapper

    # -- stats / persistence --------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __len__(self):
        return len(self._data)

    def save(self, path: str | None = None) -> None:
        path = path or self.save_path
        if not path:
            return
        with open(path, "wb") as f:
            pickle.dump(dict(self._data), f)

    def load(self, path: str) -> None:
        try:
            with open(path, "rb") as f:
                self._data = OrderedDict(pickle.load(f))
        except FileNotFoundError:
            pass
