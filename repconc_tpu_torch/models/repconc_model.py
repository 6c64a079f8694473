"""The RepCONC model: dense encoder + OPQ rotation + PQ codebook head.

Counterpart of repconc_tpu/models/repconc_model.py:32-122 as one
nn.Module: `encoder` (DenseEncoder), `rotation` (D, D), applied as
x @ rotation.T, and `centroids` (M, K, dsub).

The rotation is a parameter that no optimizer updates. In the JAX package
it sits in the parameter tree, gets a gradient, and that gradient counts
in the global clip norm before the optimizer zeroes its update
(train/stage1.py:103-110): stage-1 training here does the same
(repconc_tpu_torch/train/stage1.py).
"""
from __future__ import annotations

import os
import shutil
from typing import NamedTuple, Optional

import torch
from torch import nn

from repconc_tpu_torch.core import checkpoint
from repconc_tpu_torch.core.config import METRIC_CENTROID_COS, RepConcConfig
from repconc_tpu_torch.core.device import resolve_device
from repconc_tpu_torch.models.auto import load_dense_encoder
from repconc_tpu_torch.models.transformer import DenseEncoder
from repconc_tpu_torch.quant import codebook


class QuantizeOutput(NamedTuple):
    continuous_embeds: torch.Tensor
    quantized_embeds: Optional[torch.Tensor] = None
    discrete_codes: Optional[torch.Tensor] = None


class RepConcModel(nn.Module):
    def __init__(self, config: RepConcConfig):
        super().__init__()
        self.config = config
        D = config.hidden_size
        self.encoder = DenseEncoder(config.encoder, config.similarity_metric)
        self.rotation = nn.Parameter(torch.eye(D))  # never updated
        self.centroids = nn.Parameter(
            torch.zeros(config.MCQ_M, config.MCQ_K, config.dsub))

    def encode_continuous(self, input_ids, attention_mask,
                          generator=None) -> torch.Tensor:
        """Dense encode -> rotate -> per-subvector normalize for CENTROID_COS
        (repconc_model.py:61-79). `generator` switches dropout on and
        draws its masks (models/transformer.py)."""
        embeds = self.encoder(input_ids, attention_mask, generator)
        rotated = embeds @ self.rotation.T
        if self.config.similarity_metric == METRIC_CENTROID_COS:
            rotated = codebook.normalize_subvectors(rotated, self.config.MCQ_M)
        return rotated

    def forward(self, input_ids, attention_mask, discrete_codes=None,
                return_code: bool = False,
                return_quantized_embedding: bool = False,
                use_constraint: bool = False) -> QuantizeOutput:
        """repconc_model.py:82-106; the constraint takes the config's
        sk_epsilon and sk_iters."""
        rotated = self.encode_continuous(input_ids, attention_mask)
        if discrete_codes is None and (return_code or return_quantized_embedding):
            discrete_codes = codebook.encode(
                rotated, self.centroids, use_constraint=use_constraint,
                sk_epsilon=self.config.sk_epsilon,
                sk_iters=self.config.sk_iters)
        quantized = (codebook.decode(discrete_codes, self.centroids)
                     if return_quantized_embedding else None)
        return QuantizeOutput(rotated, quantized, discrete_codes)


@torch.no_grad()
def init_random_(model: RepConcModel, generator: torch.Generator,
                 std: float = 0.02) -> RepConcModel:
    """Seeded random weights in place: N(0, std) for Linear and Embedding
    weights (HF BERT's initializer_range), zero biases, unit LayerNorms,
    identity rotation and N(0, 1) centroids (repconc_model.py:40-58)."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Embedding)):
            module.weight.copy_(torch.randn(module.weight.shape,
                                            generator=generator) * std)
            if getattr(module, "bias", None) is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    model.rotation.copy_(torch.eye(model.rotation.shape[0]))
    cent = torch.randn(model.centroids.shape, generator=generator)
    if model.config.similarity_metric == METRIC_CENTROID_COS:
        cent = codebook.normalize_centroids(cent)
    model.centroids.copy_(cent)
    return model


TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.txt",
                   "vocab.json", "merges.txt", "special_tokens_map.json")


def save_pretrained(output_dir: str, model: RepConcModel,
                    tokenizer_dir: Optional[str] = None) -> None:
    """Write a model dir that both packages load (repconc_model.py:109-117):
    repconc_config.json, params.msgpack in flax's layout, and the tokenizer
    files found in `tokenizer_dir`."""
    from repconc_tpu_torch.models.convert import to_jax_params

    checkpoint.save_model(output_dir, model.config, to_jax_params(model))
    if tokenizer_dir and os.path.isdir(tokenizer_dir):
        for name in TOKENIZER_FILES:
            src = os.path.join(tokenizer_dir, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(output_dir, name))


def from_pretrained(load_dir: str, device="cuda") -> RepConcModel:
    """Load a repconc_tpu model dir (repconc_config.json + params.msgpack)."""
    from repconc_tpu_torch.models.convert import from_jax_params

    config, params = checkpoint.load_model(load_dir)
    return from_jax_params(config, params).to(resolve_device(device))


@torch.no_grad()
def from_dense_encoder(model_dir: str, MCQ_M: int, MCQ_K: int = 256,
                       similarity_metric: Optional[str] = None,
                       pooling: Optional[str] = None,
                       sk_epsilon: float = 0.003, sk_iters: int = 100,
                       seed: int = 2022, adapter: Optional[str] = None,
                       device="cuda") -> RepConcModel:
    """A fresh RepCONC model around an HF dense-encoder checkpoint
    (repconc_model.py:125-152): the checkpoint's encoder, an identity
    rotation and N(0, 1) centroids drawn from a generator seeded with
    `seed` (normalised per centroid for METRIC_CENTROID_COS). jax.random
    draws other centroids at the same seed."""
    from repconc_tpu_torch.models.auto import load_dense_encoder

    dev = resolve_device(device)
    enc_cfg, enc_state, metric = load_dense_encoder(model_dir, adapter=adapter,
                                                    device="cpu")
    if pooling is not None:
        enc_cfg.pooling = pooling
    config = RepConcConfig(encoder=enc_cfg, MCQ_M=MCQ_M, MCQ_K=MCQ_K,
                           similarity_metric=similarity_metric or metric,
                           sk_epsilon=sk_epsilon, sk_iters=sk_iters)
    model = RepConcModel(config)
    model.encoder.load_state_dict(enc_state, strict=True)
    cent = torch.randn(model.centroids.shape,
                       generator=torch.Generator().manual_seed(seed))
    if config.similarity_metric == METRIC_CENTROID_COS:
        cent = codebook.normalize_centroids(cent)
    model.centroids.copy_(cent)
    return model.eval().to(dev)
