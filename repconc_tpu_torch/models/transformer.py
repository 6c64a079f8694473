"""Unified BERT-family dense encoder as an nn.Module.

Counterpart of repconc_tpu/models/transformer.py:25-173, which covers BERT /
RoBERTa / DistilBERT plus the ANCE projection head and TCT pooling through
EncoderConfig data:

  * roberta:    position_offset = pad_token_id + 1, pad positions stay at
                pad_token_id (:99-106)
  * distilbert: type_vocab_size = 0 (no token-type embeddings)
  * ance:       projection = True (Linear + LayerNorm head after pooling)
  * tct:        pooling = "mean_skip4" (mean over tokens[4:])

Post-LayerNorm throughout. Attention is written as explicit matmul +
softmax with the reference's -1e9 additive mask (:120) rather than
scaled_dot_product_attention, so the masking and the fp32 arithmetic are
the reference's. Submodule names follow the flax parameter tree, which
keeps models/convert.py a plain renaming.

Dropout is on exactly when a forward is given a `generator`, the
counterpart of flax's deterministic=False with a dropout key: its masks
come from that generator and never from the global RNG, so a forward
recomputed under torch.utils.checkpoint from a generator seeded alike
draws the same masks. The module's train()/eval() mode plays no part.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repconc_tpu_torch.core.config import METRIC_COS, EncoderConfig

# HF "gelu" is the EXACT erf GELU (transformer.py:25-30)
ACT = {"gelu": lambda x: F.gelu(x, approximate="none"), "relu": F.relu,
       "gelu_new": lambda x: F.gelu(x, approximate="tanh")}


def dropout(x: torch.Tensor, p: float, generator) -> torch.Tensor:
    """Inverted dropout with masks from `generator`; identity when the
    generator is None (no dropout asked) or p is 0."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) >= p
    return x * keep / (1.0 - p)


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        H = cfg.hidden_size
        self.num_heads, self.head_dim = cfg.num_attention_heads, cfg.head_dim
        self.query = nn.Linear(H, H)
        self.key = nn.Linear(H, H)
        self.value = nn.Linear(H, H)
        self.out = nn.Linear(H, H)
        self.attn_dropout = cfg.attention_dropout

    def forward(self, hidden: torch.Tensor, attention_bias: torch.Tensor,
                generator=None):
        B, L, H = hidden.shape

        def heads(x):  # (B, L, H) -> (B, nh, L, hd)
            return x.view(B, L, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = (heads(self.query(hidden)), heads(self.key(hidden)),
                   heads(self.value(hidden)))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(self.head_dim)
        scores = scores + attention_bias  # (B, 1, 1, L) additive mask
        probs = dropout(torch.softmax(scores, dim=-1), self.attn_dropout,
                        generator)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, H)
        return self.out(ctx)


class TransformerLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.attention = SelfAttention(cfg)
        self.attention_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp_up = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.mlp_down = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.mlp_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.hidden_dropout = cfg.hidden_dropout
        self.act = ACT[cfg.hidden_act]

    def forward(self, hidden, attention_bias, generator=None):
        attn = dropout(self.attention(hidden, attention_bias, generator),
                       self.hidden_dropout, generator)
        hidden = self.attention_ln(hidden + attn)
        down = dropout(self.mlp_down(self.act(self.mlp_up(hidden))),
                       self.hidden_dropout, generator)
        return self.mlp_ln(hidden + down)


class TransformerEncoder(nn.Module):
    """Token ids -> last hidden states (B, L, H)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        if cfg.dtype != "float32":
            raise NotImplementedError(
                f"activation dtype {cfg.dtype}: the port runs fp32 only "
                "(ROADMAP.md, Queue 1 item 3)")
        self.cfg = cfg
        H = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, H)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, H)
        self.token_type_embeddings = (nn.Embedding(cfg.type_vocab_size, H)
                                      if cfg.type_vocab_size > 0 else None)
        self.embeddings_ln = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(TransformerLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                generator=None):
        cfg = self.cfg
        L = input_ids.shape[1]
        positions = torch.arange(L, device=input_ids.device)[None, :]
        positions = positions + cfg.position_offset
        if cfg.position_offset:
            positions = torch.where(attention_mask > 0, positions,
                                    cfg.pad_token_id)
        # clamp: sequences longer than the table must not read past its end
        positions = positions.clamp(max=cfg.max_position_embeddings - 1)
        hidden = self.word_embeddings(input_ids) + self.position_embeddings(positions)
        if self.token_type_embeddings is not None:
            hidden = hidden + self.token_type_embeddings(torch.zeros_like(input_ids))
        hidden = dropout(self.embeddings_ln(hidden), cfg.hidden_dropout,
                         generator)
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9)
        bias = bias.to(hidden.dtype)
        for layer in self.layers:
            hidden = layer(hidden, bias, generator)
        return hidden


class DenseEncoder(nn.Module):
    """transformer -> pooling -> optional projection -> optional METRIC_COS
    normalization (transformer.py:126-173). METRIC_IP and
    METRIC_CENTROID_COS pass through here."""

    def __init__(self, cfg: EncoderConfig, similarity_metric: str = "METRIC_IP"):
        super().__init__()
        if cfg.pooling not in ("cls", "mean", "mean_skip4"):
            raise NotImplementedError(cfg.pooling)
        self.cfg = cfg
        self.similarity_metric = similarity_metric
        self.transformer = TransformerEncoder(cfg)
        if cfg.projection:
            self.projection = nn.Linear(cfg.hidden_size, cfg.hidden_size)
            self.projection_ln = nn.LayerNorm(cfg.hidden_size,
                                              eps=cfg.layer_norm_eps)

    def forward(self, input_ids, attention_mask, generator=None):
        cfg = self.cfg
        hidden = self.transformer(input_ids, attention_mask, generator)
        if cfg.pooling == "cls":
            embeds = hidden[:, 0]
        else:
            skip = 4 if cfg.pooling == "mean_skip4" else 0
            mask = attention_mask[:, skip:, None].to(hidden.dtype)
            embeds = (hidden[:, skip:] * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
        if cfg.projection:
            embeds = self.projection_ln(self.projection(embeds))
        if self.similarity_metric == METRIC_COS:
            embeds = embeds / embeds.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        return embeds
