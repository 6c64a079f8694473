"""Model directories, in the layout both packages read and write.

Counterpart of repconc_tpu/core/checkpoint.py:32-70. A model directory holds

  repconc_config.json   RepConcConfig (encoder arch + quantizer hparams)
  params.msgpack        the flax parameter tree, as flax.serialization
                        writes it
  tokenizer files       a saved HF tokenizer

flax and msgpack are not dependencies of the port, so params.msgpack is
encoded and decoded here with numpy and the standard library. The format is
msgpack holding a map of maps whose leaves are the ndarray extension type
(code 1): a msgpack array [shape, dtype name, C-order bytes]. Leaves above
MAX_CHUNK_SIZE bytes are split into flat chunks under a map marked
"__msgpack_chunked_array__", as flax does to stay under msgpack's 2 GiB
object limit. The writer emits every map with its keys sorted, the order
the JAX package writes (jax.tree.map sorts dict keys), so the same tree
gives the same bytes in both packages.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict, Tuple

import numpy as np

from repconc_tpu_torch.core.config import RepConcConfig

PARAMS_NAME = "params.msgpack"
MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


def atomic_np_save(path: str, arr: np.ndarray) -> None:
    """np.save via tmp + rename: skip-if-exists caching treats file
    existence as validity, so a crash mid-write must never leave a partial
    file under the final name."""
    tmp = path + ".tmp.npy"
    np.save(tmp, arr)
    os.replace(tmp, path)


# -- msgpack encoding --------------------------------------------------------


def _pack_len(out: list, n: int, fix: int, fix_limit: int, b8: int,
              b16: int, b32: int) -> None:
    """A length header: the fix form below fix_limit, else the smallest of
    the 8 (b8 may be None), 16 and 32-bit forms."""
    if fix is not None and n < fix_limit:
        out.append(bytes([fix | n]))
    elif b8 is not None and n < 1 << 8:
        out.append(struct.pack(">BB", b8, n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", b16, n))
    else:
        out.append(struct.pack(">BI", b32, n))


def _pack_int(out: list, v: int) -> None:
    if 0 <= v < 128:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, limit in ((0xcc, ">BB", 1 << 8), (0xcd, ">BH", 1 << 16),
                                 (0xce, ">BI", 1 << 32), (0xcf, ">BQ", 1 << 64)):
            if v < limit:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(v)
    else:
        for code, fmt, limit in ((0xd0, ">Bb", 1 << 7), (0xd1, ">Bh", 1 << 15),
                                 (0xd2, ">Bi", 1 << 31), (0xd3, ">Bq", 1 << 63)):
            if v >= -limit:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(v)


def _pack_str(out: list, s: str) -> None:
    raw = s.encode("utf-8")
    _pack_len(out, len(raw), 0xa0, 32, 0xd9, 0xda, 0xdb)
    out.append(raw)


def _pack_bin(out: list, raw) -> None:
    _pack_len(out, len(raw), None, 0, 0xc4, 0xc5, 0xc6)
    out.append(raw)


def _pack_ext(out: list, code: int, data: bytes) -> None:
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    n = len(data)
    if n in fixext:
        out.append(bytes([fixext[n], code]))
    else:
        _pack_len(out, n, None, 0, 0xc7, 0xc8, 0xc9)
        out.append(bytes([code]))
    out.append(data)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ndarray payload: msgpack [shape, dtype name, C-order bytes]."""
    out: list = []
    _pack_len(out, 3, 0x90, 16, None, 0xdc, 0xdd)
    _pack_len(out, arr.ndim, 0x90, 16, None, 0xdc, 0xdd)
    for d in arr.shape:
        _pack_int(out, int(d))
    _pack_str(out, arr.dtype.name)
    _pack_bin(out, arr.tobytes("C"))
    return b"".join(out)


def _chunk(arr: np.ndarray) -> Dict[str, Any]:
    chunksize = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[s:s + chunksize] for i, s in
                       enumerate(range(0, flat.size, chunksize))}}


def _pack(out: list, v, sort_keys: bool) -> None:
    if isinstance(v, dict):
        _pack_len(out, len(v), 0x80, 16, None, 0xde, 0xdf)
        for k in (sorted(v) if sort_keys else v):
            _pack_str(out, k)
            _pack(out, v[k], sort_keys)
    elif isinstance(v, (np.ndarray, np.generic)):
        v = np.asarray(v)  # a numpy scalar is written as a 0-d array, as
        #                    the JAX package's save_params does
        if v.size * v.dtype.itemsize > MAX_CHUNK_SIZE:
            _pack(out, _chunk(v), sort_keys=False)
        else:
            _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(v))
    elif v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        _pack_int(out, v)
    else:
        raise TypeError(f"cannot write {type(v).__name__} to params.msgpack")


def params_to_bytes(tree: Dict[str, Any]) -> bytes:
    """The bytes flax.serialization.to_bytes gives for the tree that the
    JAX package's save_params writes (maps with sorted keys, numpy leaves,
    oversized leaves chunked)."""
    out: list = []
    _pack(out, tree, sort_keys=True)
    return b"".join(out)


# -- msgpack decoding --------------------------------------------------------


class _Reader:
    """Decodes the msgpack subset that flax writes for parameter trees:
    maps, arrays, strings, bins, ints, floats, bools, nil and the ndarray
    and numpy-scalar extension types."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("params.msgpack is truncated")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        t = self._unpack(">B")
        if t < 0x80:
            return t
        if t >= 0xe0:
            return t - 0x100
        if t < 0x90:
            return self._map(t & 0x0f)
        if t < 0xa0:
            return self._array(t & 0x0f)
        if t < 0xc0:
            return str(self._take(t & 0x1f), "utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if t in simple:
            return simple[t]
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
                0xca: ">f", 0xcb: ">d"}
        if t in ints:
            return self._unpack(ints[t])
        lengths = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",      # bin
                   0xd9: ">B", 0xda: ">H", 0xdb: ">I",      # str
                   0xdc: ">H", 0xdd: ">I",                  # array
                   0xde: ">H", 0xdf: ">I",                  # map
                   0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}      # ext
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if t in fixext:
            return self._ext(fixext[t])
        if t not in lengths:
            raise ValueError(f"unexpected msgpack type byte 0x{t:02x}")
        n = self._unpack(lengths[t])
        if t <= 0xc6:
            return self._take(n)
        if t >= 0xd9 and t <= 0xdb:
            return str(self._take(n), "utf-8")
        if t in (0xdc, 0xdd):
            return self._array(n)
        if t in (0xde, 0xdf):
            return self._map(n)
        return self._ext(n)

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _ext(self, n: int):
        code = self._unpack(">b")
        payload = self._take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unexpected msgpack extension type {code}")
        shape, dtype_name, raw = _Reader(payload).read()
        if dtype_name == "bfloat16":
            raise NotImplementedError("bfloat16 leaves in params.msgpack")
        arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(
            shape, order="C")
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree):
    """Join the leaves flax split into numbered chunks."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def params_from_bytes(data) -> Dict[str, Any]:
    """params.msgpack bytes -> nested dict of numpy arrays (read-only views
    of `data`), as flax.serialization.msgpack_restore gives."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


# -- model directories -------------------------------------------------------


def save_params(output_dir: str, params: Dict[str, Any]) -> None:
    """Write params.msgpack atomically (tmp + rename): a crash mid-write
    must never leave a truncated file where the previous best/ stood."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, PARAMS_NAME)
    with open(path + ".tmp", "wb") as f:
        f.write(params_to_bytes(params))
    os.replace(path + ".tmp", path)


def load_params(load_dir: str) -> Dict[str, Any]:
    """params.msgpack -> nested dict of numpy arrays (flax's layout)."""
    with open(os.path.join(load_dir, PARAMS_NAME), "rb") as f:
        data = f.read()
    return params_from_bytes(data)


def save_model(output_dir: str, config: RepConcConfig,
               params: Dict[str, Any]) -> None:
    config.save(output_dir)
    save_params(output_dir, params)


def load_model(load_dir: str) -> Tuple[RepConcConfig, Dict[str, Any]]:
    """(config, numpy param tree) of a model directory."""
    return RepConcConfig.load(load_dir), load_params(load_dir)
