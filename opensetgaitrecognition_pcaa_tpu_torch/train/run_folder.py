"""Run-folder I/O: the files the JAX package's training writes.

Port of ``opensetgaitrecognition_pcaa_tpu/train/run_folder.py:36-131``. A
run folder holds ``config.json``, ``<NAME>_<TAG>.msgpack`` parameter trees,
``discriminator_means.npy``, with ``SAVE_RESUME_STATE`` the resume state
``train_state.msgpack`` (+ ``.meta.json``, ``.best``) and, once training
ended, ``run_complete.json``. The JAX package writes the trees with
``flax.serialization.msgpack_serialize``; this module reads and writes the
same bytes with a small pure-Python codec for the subset of msgpack that
flax uses, so the port needs neither flax nor the msgpack package:

- maps with str keys, nested;
- ext type 1 (ndarray) whose payload is the msgpack of
  ``(shape, dtype.name, C-order bytes)``; ext type 3 (numpy scalar) is
  decoded the same way. numpy has no bfloat16, so a ``"bfloat16"`` array
  (flax writes the bits of ``ml_dtypes.bfloat16``) is read as uint16 bits
  viewed as a ``torch.bfloat16`` tensor, and a bf16 tensor is written in
  that layout: a bf16 run's resume state round-trips, and a flax-written
  bf16 tree reads with the same bits.

Arrays above flax's 1 GiB chunking limit are not supported. A file is
written as a list of chunks, each array's data a view of its buffer, and
read into one buffer that the arrays it holds share: neither direction
copies an array's bytes in Python.

The resume state is the port's own format, not the JAX package's: JAX
writes its ``PCAAState`` with ``flax.serialization.to_bytes``, PRNG key
included, and JAX's PRNG cannot be replayed by torch. The port writes a
tree of numpy arrays (the trainer's ``state_dict``, its Adam states, its
noise ``torch.Generator`` state) through the same codec, no pickle, and
tags the ``.meta.json`` with ``RESUME_FORMAT``. A state file whose meta
lacks the tag (a JAX-written one) raises ``ValueError``: it is never read
as the port's state, and the run is never quietly restarted over it.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Bf16Bits(np.ndarray):
    """The int16 bits of a bf16 array, written with dtype name "bfloat16"."""

    def __new__(cls, bits: np.ndarray) -> "_Bf16Bits":
        return np.asarray(bits, order="C").view(cls)


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


class _Chunks:
    """The encoding as a list of chunks: the small parts gathered in a
    bytearray, each array's data a view of the array (``data``)."""

    def __init__(self):
        self.chunks = []
        self.head = bytearray()

    def append(self, byte: int) -> None:
        self.head.append(byte)

    def __iadd__(self, raw) -> "_Chunks":
        self.head += raw
        return self

    def _flush(self) -> None:
        if self.head:
            self.chunks.append(bytes(self.head))
            self.head = bytearray()

    def data(self, view: memoryview) -> None:
        self._flush()
        self.chunks.append(view)

    def finish(self) -> list:
        self._flush()
        return self.chunks


def _pack(obj: Any, out) -> None:
    """msgpack as the ``msgpack`` package writes it (``use_bin_type``),
    for the types of a flax tree and of its ndarray payloads, into a
    ``_Chunks`` (or a bytearray, for trees without arrays)."""
    if isinstance(obj, torch.Tensor):
        if obj.dtype != torch.bfloat16:
            raise TypeError(f"only bf16 tensors are written as such, got {obj.dtype}")
        _pack(_Bf16Bits(obj.detach().cpu().contiguous().view(torch.int16).numpy()), out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj, order="C")
        if arr.dtype.hasobject or arr.dtype.fields is not None:
            raise TypeError(f"unsupported dtype {arr.dtype}")
        # the payload: the msgpack of (shape, dtype name, C-order bytes)
        head = bytearray((0x93,))
        _pack(list(arr.shape), head)
        _pack("bfloat16" if isinstance(obj, _Bf16Bits) else arr.dtype.name, head)
        _pack_len(head, arr.nbytes, None, (0xC4, 0xC5, 0xC6))
        n = len(head) + arr.nbytes
        if n in _FIXEXT:
            out.append(_FIXEXT[n])
        else:
            _pack_len(out, n, None, (0xC7, 0xC8, 0xC9))
        out.append(_EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR)
        out += head
        out.data(memoryview(arr.reshape(-1).view(np.uint8)))
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


def _chunks(obj: Any) -> list:
    out = _Chunks()
    _pack(obj, out)
    return out.finish()


def packb(obj: Any) -> bytes:
    """Encode a tree of dicts (str keys) with ndarray leaves as flax does."""
    return b"".join(_chunks(obj))


def _write(obj: Any, path: str) -> None:
    """``packb(obj)`` into the file ``path``, chunk by chunk."""
    with open(path, "wb") as f:
        f.writelines(_chunks(obj))


def _read(path: str) -> Any:
    """``unpackb`` of the file ``path``, read into one writable buffer that
    the arrays of the tree share."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: short read")
    return unpackb(buf)


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
        if 0xC4 <= b <= 0xC6:  # bin: a view of the data, not a copy
            return self.take(self.uint(1 << (b - 0xC4)))
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
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, buf = unpackb(payload)
        if dtype_name == "bfloat16":
            bits = np.frombuffer(buf, dtype=np.int16).reshape(shape)
            arr = torch.from_numpy(bits).view(torch.bfloat16)
        else:
            arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr if code == _EXT_NDARRAY else arr[()]


def unpackb(data) -> Any:
    """Decode ``data`` (bytes-like); the arrays are views of it, writable
    where ``data`` is."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return obj


def _sorted_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree if isinstance(tree, torch.Tensor) else np.asarray(tree)


def save_params(variables: Dict[str, Any], path: str) -> None:
    """Write a tree of dicts with array leaves (``{"params": ...,
    "batch_stats": ...}``) byte for byte as the JAX package's
    ``save_params`` does: keys sorted, as a jax tree map leaves them."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _write(_sorted_tree(variables), path)


def load_params(path: str) -> Dict[str, Any]:
    """Read a ``<NAME>_<TAG>.msgpack`` tree; its ndarray leaves share the
    file's buffer."""
    return _read(path)


def save_array(arr, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, np.asarray(arr))


def load_array(path: str) -> np.ndarray:
    return np.load(path)


def module_path(run_dir: str, model_name: str, tag: str) -> str:
    """``models/<NAME>/<NAME>_<TAG>.msgpack`` (reference file-stem contract)."""
    return os.path.join(run_dir, f"{model_name}_{tag}.msgpack")


RESUME_FORMAT = "opensetgaitrecognition_pcaa_tpu_torch/train_state/1"


def save_train_state(tree: Dict[str, Any], epoch: int, host_rng_state: dict, path: str,
                     extra: Optional[dict] = None) -> None:
    """Write the resume state ``tree`` (dicts with str keys, numpy leaves)
    to ``path`` and ``path + ".meta.json"``: ``format``, ``epoch`` (the
    last epoch done), the host shuffle generator's ``host_rng_state`` and
    ``extra`` (``best_valid_acc``)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _write(tree, path)
    meta = {"format": RESUME_FORMAT, "epoch": epoch, "host_rng_state": host_rng_state}
    meta.update(extra or {})
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def load_train_state(path: str):
    """→ ``(tree, next_epoch, meta)``, or ``None`` if ``path`` does not
    exist. ``ValueError`` if it exists but its meta is missing or was not
    written by the port (a JAX package's ``train_state.msgpack``)."""
    if not os.path.exists(path):
        return None
    meta = None
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    if not isinstance(meta, dict) or meta.get("format") != RESUME_FORMAT:
        raise ValueError(
            f"{path} is not a resume state of the PyTorch port (its .meta.json lacks "
            f"format {RESUME_FORMAT!r}; a JAX package's state cannot be resumed here): "
            "move it away to train the run afresh"
        )
    return _read(path), meta["epoch"] + 1, meta


def save_best_payload(payload: Dict[str, Any], path: str) -> None:
    """Write the best-by-validation weights (a flat dict of arrays or
    tensors) to ``path + ".best"``, so that a resumed run whose restored
    best accuracy is never beaten still writes them as its module files."""
    _write({k: _host(v) for k, v in payload.items()}, path + ".best")


def load_best_payload(path: str) -> Optional[Dict[str, np.ndarray]]:
    """→ the payload ``save_best_payload`` wrote, or ``None`` if none was."""
    if not os.path.exists(path + ".best"):
        return None
    return _read(path + ".best")


def _host(value: Any) -> np.ndarray:
    """A numpy array of ``value``, a torch tensor (on any device) or array."""
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def run_completed(run_dir: str) -> bool:
    """True if the run folder has its completion marker."""
    return os.path.exists(os.path.join(run_dir, "run_complete.json"))


def mark_run_completed(run_dir: str, final_metrics: dict) -> None:
    with open(os.path.join(run_dir, "run_complete.json"), "w") as f:
        json.dump({k: float(v) for k, v in final_metrics.items()}, f)
