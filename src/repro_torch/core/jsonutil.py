"""Bytes-in/bytes-out JSON with orjson as the fast path.

Owns the orjson-vs-stdlib decision in ONE place: when orjson is installed
its ``dumps``/``loads`` are re-exported directly; otherwise a stdlib shim
with the same bytes contract takes over, so the whole stack (KVStore items,
asset manifests, index/checkpoint metadata) works on a bare environment.
Callers import unconditionally::

    from repro_torch.core import jsonutil as orjson
"""

from __future__ import annotations

import json
import math
from typing import Any

import numpy as np

JSONDecodeError = json.JSONDecodeError


def _default(obj: Any):
    # orjson serializes numpy scalars/arrays natively with OPT_SERIALIZE_NUMPY;
    # metadata here only carries scalars, but accept arrays for parity.
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"not JSON serializable: {type(obj)!r}")


def _sanitize(obj: Any) -> Any:
    """NaN/Infinity (Python or numpy float) → null, matching orjson."""
    if isinstance(obj, (float, np.floating)) and not math.isfinite(obj):
        return None
    if isinstance(obj, np.ndarray):
        return _sanitize(obj.tolist())
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


def dumps(obj: Any) -> bytes:
    # ensure_ascii=False: orjson emits raw UTF-8, so stored byte sizes
    # (index-size accounting) must not depend on which path is installed.
    # orjson serializes non-finite floats as null; stdlib would emit the
    # non-standard NaN/Infinity tokens orjson can't parse back — sanitize
    # (rare path) so both environments produce identical, valid bytes
    try:
        return json.dumps(obj, separators=(",", ":"), default=_default,
                          allow_nan=False, ensure_ascii=False).encode()
    except ValueError:
        return json.dumps(_sanitize(obj), separators=(",", ":"),
                          default=_default, allow_nan=False,
                          ensure_ascii=False).encode()


def loads(data: bytes | bytearray | memoryview | str) -> Any:
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = bytes(data).decode()
    return json.loads(data)


try:
    import orjson as _orjson

    JSONDecodeError = _orjson.JSONDecodeError          # noqa: F811
    loads = _orjson.loads                              # noqa: F811

    def dumps(obj: Any) -> bytes:                      # noqa: F811
        # numpy option keeps the fast path exactly as permissive as the shim
        return _orjson.dumps(obj, option=_orjson.OPT_SERIALIZE_NUMPY)
except ImportError:
    pass
