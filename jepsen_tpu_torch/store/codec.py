"""Value codec for persisted tests and histories (the port's copy of
`jepsen_tpu/store/codec.py`: the same encoding, so both packages write
the same bytes for plain data).

Equivalent of the reference's fressian read/write handlers
(`jepsen/src/jepsen/store/fressian.clj`, SURVEY.md §2.1): a tagged-JSON
encoding that round-trips the value types op histories actually contain —
tuples (micro-ops like ``("append", k, v)``), dicts with non-string keys
(read results ``{k: v}``), sets, bytes, and numpy scalars — none of which
plain JSON preserves.

Tags use a "§" prefix, which cannot collide with workload data keys in
practice; a literal dict key starting with "§" is itself escaped.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

_TUPLE = "§t"
_DICT = "§d"  # dict with non-string keys, as [[k, v], ...]
_SET = "§s"
_FSET = "§fs"
_BYTES = "§b"
_ESCAPE = "§§"  # literal dict whose keys start with §


def _encode(v: Any) -> Any:
    if isinstance(v, tuple):
        return {_TUPLE: [_encode(x) for x in v]}
    if isinstance(v, frozenset):
        return {_FSET: [_encode(x) for x in sorted(v, key=repr)]}
    if isinstance(v, set):
        return {_SET: [_encode(x) for x in sorted(v, key=repr)]}
    if isinstance(v, (bytes, bytearray)):
        return {_BYTES: bytes(v).hex()}
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.ndarray):
        return {_TUPLE: [_encode(x) for x in v.tolist()]}
    if isinstance(v, dict):
        if all(isinstance(k, str) for k in v):
            if any(k.startswith("§") for k in v):
                return {_ESCAPE: [[k, _encode(x)] for k, x in v.items()]}
            return {k: _encode(x) for k, x in v.items()}
        return {_DICT: [[_encode(k), _encode(x)] for k, x in v.items()]}
    if isinstance(v, list):
        return [_encode(x) for x in v]
    return v


def _decode(v: Any) -> Any:
    if isinstance(v, dict):
        if len(v) == 1:
            ((tag, payload),) = v.items()
            if tag == _TUPLE:
                return tuple(_decode(x) for x in payload)
            if tag == _SET:
                return set(_decode(x) for x in payload)
            if tag == _FSET:
                return frozenset(_decode(x) for x in payload)
            if tag == _BYTES:
                return bytes.fromhex(payload)
            if tag == _DICT:
                return {_decode(k): _decode(x) for k, x in payload}
            if tag == _ESCAPE:
                return {k: _decode(x) for k, x in payload}
        return {k: _decode(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode(x) for x in v]
    return v


def dumps(v: Any) -> bytes:
    """Encode a value to tagged-JSON bytes."""
    return json.dumps(_encode(v), separators=(",", ":"), default=_fallback).encode()


def loads(b: bytes) -> Any:
    """Decode tagged-JSON bytes back to the original value."""
    return _decode(json.loads(b.decode()))


def _fallback(v: Any) -> Any:
    # Non-data objects in a test map (clients, DBs, generators) are not
    # persisted structurally; store a readable placeholder, as the reference
    # does for unserializable test-map entries.  It names the object's own
    # module, so a placeholder for one of this package's objects differs
    # from the JAX package's.
    return {"§obj": f"{type(v).__module__}.{type(v).__qualname__}"}
