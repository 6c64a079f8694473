"""Model/quantizer configuration persisted alongside checkpoints.

A copy of repconc_tpu/core/config.py:1-103 (the port imports nothing of the
JAX package). A single `repconc_config.json` in every model directory
carries both the encoder architecture and the quantizer hyperparameters, so
either package reads what the other wrote.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field

METRIC_IP = "METRIC_IP"
METRIC_COS = "METRIC_COS"
METRIC_CENTROID_COS = "METRIC_CENTROID_COS"
VALID_METRICS = (METRIC_IP, METRIC_COS, METRIC_CENTROID_COS)

CONFIG_NAME = "repconc_config.json"


@dataclass
class EncoderConfig:
    """Architecture of the dense text encoder (BERT-family).

    roberta: position_offset = pad_token_id + 1; distilbert:
    type_vocab_size = 0; ance: projection = True; tct: pooling =
    "mean_skip4".
    """

    model_type: str = "bert"  # bert | roberta | distilbert | ance | tct
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2            # 0 => no token-type embeddings
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    position_offset: int = 0            # roberta uses pad_token_id + 1 = 2
    pad_token_id: int = 0
    pooling: str = "cls"                # cls | mean | mean_skip4 (TCT)
    projection: bool = False            # ANCE-style Linear+LayerNorm head
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    dtype: str = "float32"              # activation dtype: float32 | bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass
class RepConcConfig:
    """Quantizer + retrieval configuration: MCQ_M subvectors x MCQ_K
    centroids over hidden_size dims."""

    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    MCQ_M: int = 48
    MCQ_K: int = 256
    similarity_metric: str = METRIC_IP
    sk_epsilon: float = 0.003
    sk_iters: int = 100

    def __post_init__(self):
        if isinstance(self.encoder, dict):
            self.encoder = EncoderConfig(**self.encoder)
        if self.similarity_metric not in VALID_METRICS:
            raise ValueError(f"unknown similarity_metric {self.similarity_metric}")
        if self.encoder.hidden_size % self.MCQ_M != 0:
            raise ValueError(f"hidden_size {self.encoder.hidden_size} not "
                             f"divisible by M {self.MCQ_M}")

    @property
    def hidden_size(self) -> int:
        return self.encoder.hidden_size

    @property
    def dsub(self) -> int:
        return self.encoder.hidden_size // self.MCQ_M

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, output_dir: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, CONFIG_NAME), "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    @classmethod
    def load(cls, load_dir: str) -> "RepConcConfig":
        with open(os.path.join(load_dir, CONFIG_NAME)) as f:
            data = json.load(f)
        return cls(**data)
