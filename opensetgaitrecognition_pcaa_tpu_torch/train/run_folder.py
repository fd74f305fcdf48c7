"""Run-folder I/O: the files the JAX package's training writes.

Port of ``opensetgaitrecognition_pcaa_tpu/train/run_folder.py:36-59`` and
``:123-131``. A run folder holds ``config.json``, ``<NAME>_<TAG>.msgpack``
parameter trees, ``discriminator_means.npy`` and, once training ended,
``run_complete.json``. The full resume state (``train_state.msgpack``) is
not ported yet. The JAX package writes the trees with
``flax.serialization.msgpack_serialize``; this module reads and writes the
same bytes with a small pure-Python codec for the subset of msgpack that
flax uses, so the port needs neither flax nor the msgpack package:

- maps with str keys, nested;
- ext type 1 (ndarray) whose payload is the msgpack of
  ``(shape, dtype.name, C-order bytes)``; ext type 3 (numpy scalar) is
  decoded the same way.

Arrays above flax's 1 GiB chunking limit are not supported.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _pack_len(out: bytearray, n: int, fix: Optional[int], codes: tuple) -> None:
    """Type byte(s) and length of a str, bin, array, map or ext: the
    fix-size form (below 32 for str, 16 for array and map) when ``fix`` is
    given, else the 8-, 16- or 32-bit length form; ``None`` marks a width
    the type lacks."""
    if fix is not None and n < (32 if fix == 0xA0 else 16):
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n < 1 << 32:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack object too large: {n}")


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack(obj: Any, out: bytearray) -> None:
    """msgpack as the ``msgpack`` package writes it (``use_bin_type``),
    for the types of a flax tree and of its ndarray payloads."""
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject or arr.dtype.fields is not None:
            raise TypeError(f"unsupported dtype {arr.dtype}")
        payload = bytearray()
        _pack((list(arr.shape), arr.dtype.name, arr.tobytes("C")), payload)
        n = len(payload)
        if n in _FIXEXT:
            out.append(_FIXEXT[n])
        else:
            _pack_len(out, n, None, (0xC7, 0xC8, 0xC9))
        out.append(_EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR)
        out += payload
    elif isinstance(obj, int) and not isinstance(obj, bool) and obj >= 0:
        # array shapes: the only ints a flax tree holds
        if obj < 0x80:
            out.append(obj)
            return
        for code, fmt, bound in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if obj < bound:
                out.append(code)
                out += struct.pack(fmt, obj)
                return
        raise ValueError(f"int too large for msgpack: {obj}")
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, bytes):
        _pack_len(out, len(obj), None, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, (None, 0xDE, 0xDF))
        for key, value in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"map keys must be str, got {type(key)}")
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj)} in a parameter tree")


def packb(obj: Any) -> bytes:
    """Encode a tree of dicts (str keys) with ndarray leaves as flax does."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def uint(self, nbytes: int) -> int:
        return int.from_bytes(self.take(nbytes), "big")

    def read(self) -> Any:
        b = self.uint(1)
        if b < 0x80:
            return b
        if b <= 0x8F:
            return self._map(b & 0x0F)
        if b <= 0x9F:
            return self._array(b & 0x0F)
        if b <= 0xBF:
            return self._str(b & 0x1F)
        if 0xC4 <= b <= 0xC6:
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if 0xC7 <= b <= 0xC9:
            return self._ext(self.uint(1 << (b - 0xC7)))
        if 0xCC <= b <= 0xCF:
            return self.uint(1 << (b - 0xCC))
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return self._str(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return self._array(self.uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):
            return self._map(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in a flax tree")

    def _str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, n: int):
        code = self.uint(1)
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, buf = unpackb(payload)
        if dtype_name == "bfloat16":
            raise ValueError("bfloat16 arrays are not supported")
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr if code == _EXT_NDARRAY else arr[()]


def unpackb(data: bytes) -> Any:
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return obj


def _sorted_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return np.asarray(tree)


def save_params(variables: Dict[str, Any], path: str) -> None:
    """Write a tree of dicts with array leaves (``{"params": ...,
    "batch_stats": ...}``) byte for byte as the JAX package's
    ``save_params`` does: keys sorted, as a jax tree map leaves them."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(packb(_sorted_tree(variables)))


def load_params(path: str) -> Dict[str, Any]:
    """Read a ``<NAME>_<TAG>.msgpack`` tree; leaves are read-only ndarrays."""
    with open(path, "rb") as f:
        return unpackb(f.read())


def save_array(arr, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, np.asarray(arr))


def load_array(path: str) -> np.ndarray:
    return np.load(path)


def module_path(run_dir: str, model_name: str, tag: str) -> str:
    """``models/<NAME>/<NAME>_<TAG>.msgpack`` (reference file-stem contract)."""
    return os.path.join(run_dir, f"{model_name}_{tag}.msgpack")


def run_completed(run_dir: str) -> bool:
    """True if the run folder has its completion marker."""
    return os.path.exists(os.path.join(run_dir, "run_complete.json"))


def mark_run_completed(run_dir: str, final_metrics: dict) -> None:
    with open(os.path.join(run_dir, "run_complete.json"), "w") as f:
        json.dump({k: float(v) for k, v in final_metrics.items()}, f)
