"""Checkpoints in the JAX package's format (``repro/checkpoint/io.py``).

The file is msgpack of {"tree": nested lists/dicts with leaf descriptors,
"blobs": raw bytes}: an array leaf is {"__leaf__": blob index, "dtype",
"shape"}, a tuple {"__tuple__": [...]}, anything else that is not a dict or
list {"__scalar__": value}.  Dtypes and shapes round-trip exactly; ``load``
returns numpy, as the JAX package does (callers put leaves on a device with
``convert.params_from_jax``).  ``save`` writes a temp file and renames it,
so a reader never sees half a checkpoint.

``save`` takes the port's trees of tensors through
``convert.params_to_numpy``, which sorts dict keys as ``jax.tree.map``
does, so the port and the JAX package write the same bytes for the same
tree.  A bf16 leaf's blob is its raw 16-bit payload under the dtype string
"bfloat16", as JAX writes it; ``load`` returns it as a
``convert.BFloat16Bits`` uint16 view (numpy has no bf16 without
``ml_dtypes``), which ``convert.tensor_from_numpy`` turns into bf16.

The machine with the card has no ``msgpack`` package, so the encoder and
decoder below cover the subset the format uses (map, array, str, bin,
int, float, bool, nil) and give the bytes of ``msgpack.packb(obj,
use_bin_type=True)``: the shortest form of each, floats as float64.
"""
from __future__ import annotations

import os
import struct
import tempfile
from typing import Any

import numpy as np

from repro_torch.convert import BFloat16Bits, params_to_numpy

_LEAF = "__leaf__"


# ---------------------------------------------------------------------------
# the tree <-> descriptors + blobs, as repro/checkpoint/io.py
# ---------------------------------------------------------------------------
def _pack(tree: Any, blobs: list):
    if isinstance(tree, dict):
        return {k: _pack(v, blobs) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        t = [_pack(v, blobs) for v in tree]
        return {"__tuple__": t} if isinstance(tree, tuple) else t
    if hasattr(tree, "shape"):
        arr = np.asarray(tree)
        blobs.append(arr.tobytes())
        dtype = "bfloat16" if isinstance(tree, BFloat16Bits) else str(arr.dtype)
        return {_LEAF: len(blobs) - 1, "dtype": dtype,
                "shape": list(arr.shape)}
    return {"__scalar__": tree}


def _unpack(node: Any, blobs: list):
    if isinstance(node, dict):
        if _LEAF in node:
            if node["dtype"] == "bfloat16":
                arr = np.frombuffer(blobs[node[_LEAF]], dtype=np.uint16)
                return arr.reshape(node["shape"]).copy().view(BFloat16Bits)
            arr = np.frombuffer(blobs[node[_LEAF]], dtype=node["dtype"])
            return arr.reshape(node["shape"]).copy()
        if "__scalar__" in node:
            return node["__scalar__"]
        if "__tuple__" in node:
            return tuple(_unpack(v, blobs) for v in node["__tuple__"])
        return {k: _unpack(v, blobs) for k, v in node.items()}
    if isinstance(node, list):
        return [_unpack(v, blobs) for v in node]
    return node


def save(path: str, tree: Any) -> None:
    blobs: list = []
    packed = _pack(params_to_numpy(tree), blobs)
    payload = packb({"tree": packed, "blobs": blobs})
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)) or ".")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load(path: str) -> Any:
    with open(path, "rb") as f:
        obj = unpackb(f.read())
    return _unpack(obj["tree"], obj["blobs"])


# ---------------------------------------------------------------------------
# msgpack, the subset above
# ---------------------------------------------------------------------------
def _header(n: int, fix: int, fix_max: int, wide: tuple) -> bytes:
    """A length header: the fix form below fix_max, else the first of
    (8-, 16-, 32-bit tag) forms that holds n."""
    if n < fix_max:
        return bytes([fix | n])
    for tag, fmt in zip(wide, (">B", ">H", ">I")):
        if tag is not None and n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _int(n: int) -> bytes:
    if 0 <= n < 128 or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    if n > 0:
        for tag, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                         (0xCF, ">Q")):
            if n < 1 << (8 * struct.calcsize(fmt)):
                return bytes([tag]) + struct.pack(fmt, n)
    else:
        for tag, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                         (0xD3, ">q")):
            if n >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: integer {n} out of range")


def _encode(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(int(obj)))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_header(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.append(_header(len(b), 0, 0, (0xC4, 0xC5, 0xC6)) + b)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 16, (None, 0xDC, 0xDD)))
        for v in obj:
            _encode(v, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 16, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _encode(k, out)
            _encode(v, out)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset above."""
    out: list = []
    _encode(obj, out)
    return b"".join(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LENGTH = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
           0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
           0xDC: (">H", "array"), 0xDD: (">I", "array"),
           0xDE: (">H", "map"), 0xDF: (">I", "map")}


def unpackb(data: bytes):
    """``msgpack.unpackb(data, raw=False)`` for the subset above."""
    view = memoryview(data)

    def take(fmt, pos):
        n = struct.calcsize(fmt)
        if pos + n > len(view):
            raise ValueError("msgpack: truncated data")
        return struct.unpack_from(fmt, view, pos)[0], pos + n

    def read(pos):
        if pos >= len(view):
            raise ValueError("msgpack: truncated data")
        tag = view[pos]
        pos += 1
        if tag < 0x80:
            return tag, pos
        if tag >= 0xE0:
            return tag - 0x100, pos
        if tag == 0xC0:
            return None, pos
        if tag in (0xC2, 0xC3):
            return tag == 0xC3, pos
        if tag in _FIXED:
            return take(_FIXED[tag], pos)
        if 0xA0 <= tag <= 0xBF:
            kind, n = "str", tag & 0x1F
        elif 0x90 <= tag <= 0x9F:
            kind, n = "array", tag & 0x0F
        elif 0x80 <= tag <= 0x8F:
            kind, n = "map", tag & 0x0F
        elif tag in _LENGTH:
            fmt, kind = _LENGTH[tag]
            n, pos = take(fmt, pos)
        else:
            raise ValueError(f"msgpack: unsupported type byte {tag:#x}")
        if kind in ("str", "bin"):
            if pos + n > len(view):
                raise ValueError("msgpack: truncated data")
            raw = bytes(view[pos:pos + n])
            return (raw.decode("utf-8") if kind == "str" else raw), pos + n
        if kind == "array":
            items = []
            for _ in range(n):
                v, pos = read(pos)
                items.append(v)
            return items, pos
        d = {}
        for _ in range(n):
            k, pos = read(pos)
            d[k], pos = read(pos)
        return d, pos

    obj, end = read(0)
    if end != len(view):
        raise ValueError("msgpack: trailing bytes")
    return obj
