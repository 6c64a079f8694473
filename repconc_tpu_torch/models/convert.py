"""Carry a flax RepCONC parameter tree across to the port's modules.

The flax tree (repconc_tpu/models/repconc_model.py:1-20) is

    {"encoder": {"transformer": {"word_embeddings": {"embedding"},
                                 "position_embeddings", "token_type_embeddings",
                                 "embeddings_ln": {"scale", "bias"},
                                 "layer_i": {"attention": {"query", "key",
                                             "value", "out"}, "attention_ln",
                                             "mlp_up", "mlp_down", "mlp_ln"}},
                 "projection", "projection_ln"},
     "rotation": (D, D), "centroids": (M, K, dsub)}

flax Dense kernels are (in, out); torch Linear weights are (out, in), so
they are transposed. `param_table` is the one mapping between the two
namings; both directions and the trainer's weight-decay mask
(train/stage1.py::_decay_mask) read it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repconc_tpu_torch.core.config import RepConcConfig

FlaxPath = Tuple[str, ...]


def _dense(path: FlaxPath, name: str):
    return [(path + ("kernel",), f"{name}.weight", True),
            (path + ("bias",), f"{name}.bias", False)]


def _ln(path: FlaxPath, name: str):
    return [(path + ("scale",), f"{name}.weight", False),
            (path + ("bias",), f"{name}.bias", False)]


def _embedding(path: FlaxPath, name: str):
    return [(path + ("embedding",), f"{name}.weight", False)]


def _encoder_rows(num_layers: int, token_types: bool, projection: bool):
    t, tt = ("encoder", "transformer"), "encoder.transformer"
    rows = (_embedding(t + ("word_embeddings",), f"{tt}.word_embeddings")
            + _embedding(t + ("position_embeddings",),
                         f"{tt}.position_embeddings"))
    if token_types:
        rows += _embedding(t + ("token_type_embeddings",),
                           f"{tt}.token_type_embeddings")
    rows += _ln(t + ("embeddings_ln",), f"{tt}.embeddings_ln")
    for i in range(num_layers):
        src, dst = t + (f"layer_{i}",), f"{tt}.layers.{i}"
        for name in ("query", "key", "value", "out"):
            rows += _dense(src + ("attention", name), f"{dst}.attention.{name}")
        rows += _ln(src + ("attention_ln",), f"{dst}.attention_ln")
        rows += _dense(src + ("mlp_up",), f"{dst}.mlp_up")
        rows += _dense(src + ("mlp_down",), f"{dst}.mlp_down")
        rows += _ln(src + ("mlp_ln",), f"{dst}.mlp_ln")
    if projection:
        rows += _dense(("encoder", "projection"), "encoder.projection")
        rows += _ln(("encoder", "projection_ln"), "encoder.projection_ln")
    return rows


def param_table(config: RepConcConfig) -> List[Tuple[FlaxPath, str, bool]]:
    """(flax path, torch state-dict name, transposed) for every parameter
    of a RepConcModel built from `config`."""
    enc = config.encoder
    return _encoder_rows(enc.num_hidden_layers, enc.type_vocab_size > 0,
                         enc.projection) + [
        (("rotation",), "rotation", False),
        (("centroids",), "centroids", False)]


def _get(tree: Dict[str, Any], path: FlaxPath):
    for key in path:
        tree = tree[key]
    return tree


def encoder_state_dict(enc: Dict[str, Any], num_layers: int) -> Dict[str, np.ndarray]:
    """flax DenseEncoder params -> the port's DenseEncoder state dict."""
    rows = _encoder_rows(num_layers, "token_type_embeddings" in enc["transformer"],
                         "projection" in enc)
    tree = {"encoder": enc}
    return {name[len("encoder."):]: (np.asarray(_get(tree, path)).T if transposed
                                     else np.asarray(_get(tree, path)))
            for path, name, transposed in rows}


def from_jax_params(config: RepConcConfig, params: Dict[str, Any]):
    """RepConcModel (on the CPU, eval mode) holding a flax param tree's
    weights. `params` holds numpy arrays (or anything np.asarray takes)."""
    from repconc_tpu_torch.models.repconc_model import RepConcModel

    model = RepConcModel(config)
    sd = {}
    for path, name, transposed in param_table(config):
        v = np.asarray(_get(params, path), dtype=np.float32)
        sd[name] = torch.from_numpy(np.array(v.T if transposed else v))
    model.load_state_dict(sd, strict=True)
    return model.eval()


def to_jax_params(model) -> Dict[str, Any]:
    """The model's weights as the flax param tree of numpy arrays, the
    inverse of from_jax_params."""
    sd = model.state_dict()
    tree: Dict[str, Any] = {}
    for path, name, transposed in param_table(model.config):
        v = sd[name].detach().cpu().numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(v.T if transposed else v)
    return tree
