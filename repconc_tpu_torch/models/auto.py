"""HF dense-encoder checkpoints in and out of the port's DenseEncoder.

Counterpart of repconc_tpu/models/auto.py:22-294. It reads an HF config.json
(with the `pooling` / `similarity_metric` fields the pipeline stamps into
it) and the weights of model*.safetensors or pytorch_model*.bin, and maps
them onto models/transformer.py::DenseEncoder. Covers bert, roberta and
distilbert, and the ance (projection head) and tct (mean_skip4 pooling)
adapter variants.

An HF Linear weight is (out, in), as the port's nn.Linear keeps it, so the
conversion is a renaming (`hf_name_table`) with no transpose, and bit-exact
both ways. safetensors files go through core/safetensors_io.py: the port
never imports the safetensors package.
"""
from __future__ import annotations

import glob
import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repconc_tpu_torch.core import safetensors_io
from repconc_tpu_torch.core.config import EncoderConfig
from repconc_tpu_torch.core.device import resolve_device


def encoder_config_from_hf(hf: dict, model_type: Optional[str] = None) -> EncoderConfig:
    """Translate an HF config dict into an EncoderConfig (auto.py:22-73)."""
    mt = model_type or hf.get("model_type", "bert")
    if mt == "distilbert":
        cfg = EncoderConfig(
            model_type=mt,
            vocab_size=hf["vocab_size"],
            hidden_size=hf["dim"],
            num_hidden_layers=hf["n_layers"],
            num_attention_heads=hf["n_heads"],
            intermediate_size=hf["hidden_dim"],
            max_position_embeddings=hf["max_position_embeddings"],
            type_vocab_size=0,
            layer_norm_eps=1e-12,
            hidden_act=hf.get("activation", "gelu"),
            position_offset=0,
            pad_token_id=hf.get("pad_token_id", 0),
            hidden_dropout=hf.get("dropout", 0.1),
            attention_dropout=hf.get("attention_dropout", 0.1),
        )
    elif mt in ("bert", "roberta", "ance", "tct"):
        base = "roberta" if mt == "ance" else mt
        pad = hf.get("pad_token_id", 1 if base == "roberta" else 0)
        if pad is None:
            pad = 1 if base == "roberta" else 0
        cfg = EncoderConfig(
            model_type=mt,
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"],
            max_position_embeddings=hf["max_position_embeddings"],
            type_vocab_size=hf.get("type_vocab_size", 2),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
            hidden_act=hf.get("hidden_act", "gelu"),
            # roberta's positions start after the pad id (auto.py:53)
            position_offset=(pad + 1) if base == "roberta" else 0,
            pad_token_id=pad,
            hidden_dropout=hf.get("hidden_dropout_prob", 0.1),
            attention_dropout=hf.get("attention_probs_dropout_prob", 0.1),
        )
    else:
        raise NotImplementedError(f"model_type {mt}")
    if "pooling" in hf:  # stamped by customize (customize_trained_dense.py:62-63)
        cfg.pooling = hf["pooling"]
    if mt == "ance":
        cfg.projection = True
        cfg.pooling = "cls"
    if mt == "tct":
        cfg.pooling = "mean_skip4"
    return cfg


def _load_state_dict(model_dir: str) -> Dict[str, np.ndarray]:
    """The weights of model*.safetensors, else pytorch_model*.bin (a single
    file or an HF shard series, in sorted order); bf16 widened to fp32."""
    st_paths = sorted(glob.glob(os.path.join(model_dir, "model*.safetensors")))
    if st_paths:
        sd = {}
        for path in st_paths:
            sd.update(safetensors_io.load_file(path))
        return sd
    pt_paths = sorted(glob.glob(os.path.join(model_dir, "pytorch_model*.bin")))
    if pt_paths:
        sd = {}
        for path in pt_paths:
            sd.update(torch.load(path, map_location="cpu", weights_only=True))
        return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                for k, v in sd.items()}
    raise FileNotFoundError(f"no model weights in {model_dir}")


def _strip_prefix(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Remove the backbone attribute prefix (bert. / roberta. /
    distilbert.); keys outside it (the ANCE head) keep their names."""
    probe = "embeddings.word_embeddings.weight"
    for key in sd:
        if key.endswith(probe):
            prefix = key[: -len(probe)]
            if prefix in ("bert.", "roberta.", "distilbert."):
                return {(k[len(prefix):] if k.startswith(prefix) else k): v
                        for k, v in sd.items()}
            if prefix == "":
                return dict(sd)
    return dict(sd)


def _pair(hf: str, port: str) -> List[Tuple[str, str]]:
    return [(f"{hf}.weight", f"{port}.weight"), (f"{hf}.bias", f"{port}.bias")]


def hf_name_table(cfg: EncoderConfig) -> List[Tuple[str, str]]:
    """(HF state-dict name without the backbone prefix, DenseEncoder
    state-dict name) for every weight of a DenseEncoder built from `cfg`
    (auto.py:131-195)."""
    t = "transformer"
    rows = [("embeddings.word_embeddings.weight", f"{t}.word_embeddings.weight"),
            ("embeddings.position_embeddings.weight",
             f"{t}.position_embeddings.weight")]
    if cfg.type_vocab_size > 0:
        rows.append(("embeddings.token_type_embeddings.weight",
                     f"{t}.token_type_embeddings.weight"))
    rows += _pair("embeddings.LayerNorm", f"{t}.embeddings_ln")
    distil = cfg.model_type == "distilbert"
    for i in range(cfg.num_hidden_layers):
        dst = f"{t}.layers.{i}"
        if distil:
            p = f"transformer.layer.{i}"
            names = {"attention.query": "attention.q_lin",
                     "attention.key": "attention.k_lin",
                     "attention.value": "attention.v_lin",
                     "attention.out": "attention.out_lin",
                     "attention_ln": "sa_layer_norm", "mlp_up": "ffn.lin1",
                     "mlp_down": "ffn.lin2", "mlp_ln": "output_layer_norm"}
        else:
            p = f"encoder.layer.{i}"
            names = {"attention.query": "attention.self.query",
                     "attention.key": "attention.self.key",
                     "attention.value": "attention.self.value",
                     "attention.out": "attention.output.dense",
                     "attention_ln": "attention.output.LayerNorm",
                     "mlp_up": "intermediate.dense", "mlp_down": "output.dense",
                     "mlp_ln": "output.LayerNorm"}
        for port, hf in names.items():
            rows += _pair(f"{p}.{hf}", f"{dst}.{port}")
    if cfg.projection:  # the ANCE head, outside the backbone prefix
        rows += _pair("embeddingHead", "projection")
        rows += _pair("norm", "projection_ln")
    return rows


def convert_hf_weights(sd: Dict[str, np.ndarray], cfg: EncoderConfig
                       ) -> Dict[str, torch.Tensor]:
    """An HF state dict (numpy arrays) -> the DenseEncoder state dict, fp32
    CPU tensors holding the same values."""
    sd = _strip_prefix(sd)
    return {port: torch.from_numpy(np.array(sd[hf], dtype=np.float32))
            for hf, port in hf_name_table(cfg)}


def export_hf_weights(encoder_state: Dict[str, torch.Tensor],
                      cfg: EncoderConfig) -> Dict[str, np.ndarray]:
    """Inverse of convert_hf_weights: a DenseEncoder state dict -> the HF
    state dict with no backbone prefix (the bare-model layout BertModel
    saves), fp32 numpy arrays (auto.py:198-243)."""
    return {hf: np.ascontiguousarray(
                torch.as_tensor(encoder_state[port]).detach().cpu().numpy(),
                dtype=np.float32)
            for hf, port in hf_name_table(cfg)}


def save_hf_checkpoint(output_dir: str, src_model_dir: str,
                       encoder_state: Dict[str, torch.Tensor],
                       cfg: EncoderConfig,
                       similarity_metric: Optional[str] = None) -> None:
    """Write an HF-format checkpoint dir (auto.py:246-276): src's config.json
    and tokenizer files, plus model.safetensors holding `encoder_state`, with
    the pooling (and metric) actually used stamped into config.json."""
    os.makedirs(output_dir, exist_ok=True)
    safetensors_io.save_file(export_hf_weights(encoder_state, cfg),
                             os.path.join(output_dir, "model.safetensors"))
    for name in os.listdir(src_model_dir):
        if name in ("model.safetensors", "pytorch_model.bin") or \
                name.startswith(("checkpoint", "pytorch_model-", "model-")):
            continue
        src = os.path.join(src_model_dir, name)
        if os.path.isfile(src):
            shutil.copy(src, os.path.join(output_dir, name))
    cfg_path = os.path.join(output_dir, "config.json")
    with open(cfg_path) as f:
        hf = json.load(f)
    hf["pooling"] = cfg.pooling
    if similarity_metric is not None:
        hf["similarity_metric"] = similarity_metric
    with open(cfg_path, "w") as f:
        json.dump(hf, f, indent=2)


def load_dense_encoder(model_dir: str, adapter: Optional[str] = None,
                       device="cuda"
                       ) -> Tuple[EncoderConfig, Dict[str, torch.Tensor], str]:
    """(EncoderConfig, DenseEncoder state dict on `device`,
    similarity_metric) of an HF dir (auto.py:279-294). `adapter` forces an
    architecture variant ("ance", "tct") whatever model_type the checkpoint
    declares: real ANCE / TCT checkpoints declare plain roberta / bert."""
    dev = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    cfg = encoder_config_from_hf(hf, model_type=adapter)
    state = convert_hf_weights(_load_state_dict(model_dir), cfg)
    metric = hf.get("similarity_metric", "METRIC_IP")
    return cfg, {k: v.to(dev) for k, v in state.items()}, metric
