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
they are transposed.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repconc_tpu_torch.core.config import RepConcConfig


def _dense(prefix: str, p) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": np.asarray(p["kernel"]).T,
            f"{prefix}.bias": np.asarray(p["bias"])}


def _ln(prefix: str, p) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": np.asarray(p["scale"]),
            f"{prefix}.bias": np.asarray(p["bias"])}


def encoder_state_dict(enc: Dict[str, Any], num_layers: int) -> Dict[str, np.ndarray]:
    """flax DenseEncoder params -> the port's DenseEncoder state dict."""
    t = enc["transformer"]
    sd = {"transformer.word_embeddings.weight": t["word_embeddings"]["embedding"],
          "transformer.position_embeddings.weight":
              t["position_embeddings"]["embedding"]}
    if "token_type_embeddings" in t:
        sd["transformer.token_type_embeddings.weight"] = (
            t["token_type_embeddings"]["embedding"])
    sd.update(_ln("transformer.embeddings_ln", t["embeddings_ln"]))
    for i in range(num_layers):
        src, dst = t[f"layer_{i}"], f"transformer.layers.{i}"
        for name in ("query", "key", "value", "out"):
            sd.update(_dense(f"{dst}.attention.{name}", src["attention"][name]))
        sd.update(_ln(f"{dst}.attention_ln", src["attention_ln"]))
        sd.update(_dense(f"{dst}.mlp_up", src["mlp_up"]))
        sd.update(_dense(f"{dst}.mlp_down", src["mlp_down"]))
        sd.update(_ln(f"{dst}.mlp_ln", src["mlp_ln"]))
    if "projection" in enc:
        sd.update(_dense("projection", enc["projection"]))
        sd.update(_ln("projection_ln", enc["projection_ln"]))
    return sd


def from_jax_params(config: RepConcConfig, params: Dict[str, Any]):
    """RepConcModel (on the CPU, eval mode) holding a flax param tree's
    weights. `params` holds numpy arrays (or anything np.asarray takes)."""
    from repconc_tpu_torch.models.repconc_model import RepConcModel

    model = RepConcModel(config)
    sd = {f"encoder.{k}": v for k, v in encoder_state_dict(
        params["encoder"], config.encoder.num_hidden_layers).items()}
    sd["rotation"] = params["rotation"]
    sd["centroids"] = params["centroids"]
    model.load_state_dict({k: torch.from_numpy(np.array(v, dtype=np.float32))
                           for k, v in sd.items()}, strict=True)
    return model.eval()
