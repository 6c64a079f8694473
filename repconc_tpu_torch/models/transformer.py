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

Activations run in cfg.dtype (float32 or bfloat16) with fp32 parameters,
cast where the JAX package casts them, never under torch.autocast (whose
op policies round elsewhere): embeddings looked up and added in the
activation dtype (:97-114); each Dense takes its input, kernel and bias in
the activation dtype, as flax's Dense(dtype=...) does (:43-45,61,75-77);
attention scores, the -1e9 bias and the softmax in fp32, the context
accumulated in fp32 and then cast (:49-58,120-121); residual adds in the
activation dtype, every LayerNorm in fp32 with its output cast back
(:72-83,115-116); the hidden states cast to fp32 before pooling, and the
ANCE head in fp32 (:146,163-167). At float32 no cast is made: the
encoder computes in its parameters' dtype, fp32, or fp64 when a caller
converts the whole model (a reference step in fp64).

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


ACTIVATION_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def activation_dtype(cfg: EncoderConfig):
    """The reduced activation dtype of cfg.dtype (torch.bfloat16), or None
    for "float32": no cast, the parameters' own dtype. Any other name
    raises."""
    if cfg.dtype not in ACTIVATION_DTYPES:
        raise ValueError(f"activation dtype {cfg.dtype!r}: want one of "
                         f"{sorted(ACTIVATION_DTYPES)}")
    return ACTIVATION_DTYPES[cfg.dtype]


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """x in the activation dtype; x itself when dtype is None."""
    return x if dtype is None else x.to(dtype)


def dropout(x: torch.Tensor, p: float, generator) -> torch.Tensor:
    """Inverted dropout with masks from `generator`; identity when the
    generator is None (no dropout asked) or p is 0. The uniforms are drawn
    in fp32 whatever x's dtype: bf16 uniforms would put the keep
    probability on a 1/256 grid."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) >= p
    return x * keep / (1.0 - p)


def dense(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax's Dense(dtype=dtype) over fp32 master params: input, kernel and
    bias cast to dtype, the product accumulated in fp32 (TF32 and bf16
    reduced-precision reductions are off, core/device.py)."""
    return F.linear(cast(x, dtype), cast(layer.weight, dtype),
                    cast(layer.bias, dtype))


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax's LayerNorm(dtype=float32): statistics and affine in fp32, the
    output cast to the activation dtype."""
    if dtype is None:
        return ln(x)
    return ln(x.float()).to(dtype)


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
        self.dtype = activation_dtype(cfg)

    def forward(self, hidden: torch.Tensor, attention_bias: torch.Tensor,
                generator=None):
        B, L, H = hidden.shape
        dt = self.dtype

        def heads(x):  # (B, L, H) -> (B, nh, L, hd)
            return x.view(B, L, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = (heads(dense(self.query, hidden, dt)),
                   heads(dense(self.key, hidden, dt)),
                   heads(dense(self.value, hidden, dt)))
        if dt is not None:
            # fp32 scores and context from bf16 values
            # (preferred_element_type=f32): a product of two bf16 values is
            # exact in fp32
            q, k, v = q.float(), k.float(), v.float()
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(self.head_dim)
        scores = scores + attention_bias  # (B, 1, 1, L) additive mask
        probs = dropout(cast(torch.softmax(scores, dim=-1), dt),
                        self.attn_dropout, generator)
        if dt is not None:
            probs = probs.float()
        ctx = cast(torch.matmul(probs, v), dt)
        return dense(self.out, ctx.transpose(1, 2).reshape(B, L, H), dt)


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
        self.dtype = activation_dtype(cfg)

    def forward(self, hidden, attention_bias, generator=None):
        dt = self.dtype
        attn = dropout(self.attention(hidden, attention_bias, generator),
                       self.hidden_dropout, generator)
        hidden = layer_norm(self.attention_ln, hidden + attn, dt)
        up = self.act(dense(self.mlp_up, hidden, dt))
        down = dropout(dense(self.mlp_down, up, dt), self.hidden_dropout,
                       generator)
        return layer_norm(self.mlp_ln, hidden + down, dt)


class TransformerEncoder(nn.Module):
    """Token ids -> last hidden states (B, L, H)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = activation_dtype(cfg)
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
        dt = self.dtype
        # the rows of the tables cast to dt: the rows of the cast tables
        hidden = (cast(self.word_embeddings(input_ids), dt)
                  + cast(self.position_embeddings(positions), dt))
        if self.token_type_embeddings is not None:
            hidden = hidden + cast(self.token_type_embeddings(
                torch.zeros_like(input_ids)), dt)
        hidden = dropout(layer_norm(self.embeddings_ln, hidden, dt),
                         cfg.hidden_dropout, generator)
        # -1e9 is added to the scores, fp32 under bf16 activations
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9)
        bias = bias.to(hidden.dtype if dt is None else torch.float32)
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
        if self.transformer.dtype is not None:
            hidden = hidden.float()  # pooled in fp32 (:146)
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
