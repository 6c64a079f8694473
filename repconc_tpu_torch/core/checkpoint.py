"""Reading model directories written by repconc_tpu.

Counterpart of repconc_tpu/core/checkpoint.py:32-70. A model directory holds

  repconc_config.json   RepConcConfig (encoder arch + quantizer hparams)
  params.msgpack        the flax parameter tree, written by
                        flax.serialization.to_bytes
  tokenizer files       a saved HF tokenizer

flax is not a dependency of the port, so params.msgpack is decoded here
with `msgpack` (imported lazily: only this loader needs it) and the port's
own reading of flax's ndarray extension type.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np

from repconc_tpu_torch.core.config import RepConcConfig

PARAMS_NAME = "params.msgpack"

# flax.serialization._MsgpackExtType (parameter trees hold no complex leaves)
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


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        raise NotImplementedError("bfloat16 leaves in params.msgpack")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape, order="C")


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    """flax splits leaves above 1 GiB into numbered chunks; join them."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_params(load_dir: str) -> Dict[str, Any]:
    """params.msgpack -> nested dict of numpy arrays (flax's layout)."""
    import msgpack

    with open(os.path.join(load_dir, PARAMS_NAME), "rb") as f:
        data = f.read()
    return _unchunk(msgpack.unpackb(data, ext_hook=_ext_hook, raw=False))


def load_model(load_dir: str) -> Tuple[RepConcConfig, Dict[str, Any]]:
    """(config, numpy param tree) of a model directory."""
    return RepConcConfig.load(load_dir), load_params(load_dir)
