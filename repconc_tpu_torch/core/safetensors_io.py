"""The safetensors format, read and written with numpy and torch only.

The card's machine has no `safetensors` package, and HF checkpoints keep
their weights in `model.safetensors` (the JAX package reads and writes them
with safetensors.numpy, repconc_tpu/models/auto.py:76-102,246-276). A file
is

  8 bytes       the header's length n, little-endian uint64
  n bytes       a JSON object: an optional "__metadata__" map of strings,
                then for every tensor {"dtype", "shape", "data_offsets":
                [begin, end]} (offsets into the data that follows), padded
                with spaces so that 8 + n is a multiple of 8
  data          the tensors' little-endian C-order bytes, back to back

`save_file` writes the bytes safetensors.numpy.save_file writes: tensors
ordered by dtype (safetensors' Dtype enum, largest first), then by name; the
header in that order with compact separators. `load_file` reads any such
file, BF16 included, which numpy lacks: it is widened to fp32 through torch,
as the JAX package widens the bf16 tensors of a pytorch_model.bin.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import numpy as np

# safetensors' Dtype enum order (the write order is the reverse), for the
# dtypes numpy holds, and BF16, which the reader widens
_ORDER = ("BOOL", "U8", "I8", "I16", "U16", "F16", "BF16", "I32", "U32",
          "F32", "C64", "F64", "I64", "U64")
_TO_NUMPY = {"BOOL": "bool", "U8": "u1", "I8": "i1", "I16": "<i2",
             "U16": "<u2", "F16": "<f2", "I32": "<i4", "U32": "<u4",
             "F32": "<f4", "C64": "<c8", "F64": "<f8", "I64": "<i8",
             "U64": "<u8"}
_FROM_NUMPY = {np.dtype(v): k for k, v in _TO_NUMPY.items()}


def _dtype_name(arr: np.ndarray) -> str:
    try:
        return _FROM_NUMPY[arr.dtype.newbyteorder("<")]
    except KeyError:
        raise TypeError(f"safetensors holds no {arr.dtype} tensors") from None


def save_bytes(tensors: Dict[str, np.ndarray],
               metadata: Optional[Dict[str, str]] = None) -> bytes:
    """The file's bytes for a {name: numpy array} dict."""
    arrays = {k: np.asarray(v) for k, v in tensors.items()}
    names = {k: _dtype_name(a) for k, a in arrays.items()}
    order = sorted(arrays, key=lambda k: (-_ORDER.index(names[k]), k))
    header: Dict[str, object] = {}
    if metadata is not None:
        header["__metadata__"] = metadata
    blobs, offset = [], 0
    for k in order:
        a = arrays[k]
        raw = np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("<")).tobytes()
        header[k] = {"dtype": names[k], "shape": list(a.shape),
                     "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-(8 + len(text)) % 8)
    return b"".join([struct.pack("<Q", len(text)), text] + blobs)


def save_file(tensors: Dict[str, np.ndarray], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` to `path` atomically (tmp + rename)."""
    with open(path + ".tmp", "wb") as f:
        f.write(save_bytes(tensors, metadata))
    os.replace(path + ".tmp", path)


def load_bytes(data) -> Dict[str, np.ndarray]:
    """{name: numpy array} of a file's bytes; BF16 tensors come back fp32."""
    buf = memoryview(data)
    if len(buf) < 8:
        raise ValueError("safetensors data shorter than its length prefix")
    n = struct.unpack("<Q", buf[:8])[0]
    if 8 + n > len(buf):
        raise ValueError("safetensors header runs past the end of the data")
    header = json.loads(bytes(buf[8:8 + n]))
    body = buf[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        if not 0 <= begin <= end <= len(body):
            raise ValueError(f"tensor {name!r} lies outside the data")
        raw, shape = body[begin:end], tuple(info["shape"])
        if info["dtype"] == "BF16":
            import torch

            bits = np.frombuffer(raw, dtype="<i2").copy()
            arr = torch.from_numpy(bits).view(torch.bfloat16).float().numpy()
        else:
            arr = np.frombuffer(raw, dtype=_TO_NUMPY[info["dtype"]]).copy()
        out[name] = arr.reshape(shape)
    return out


def load_file(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        return load_bytes(f.read())
