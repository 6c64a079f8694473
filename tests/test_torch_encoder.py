"""The port's encoder, RepCONC head, config and checkpoint reading against
the JAX package on the same weights (numpy-seeded inputs, toy shapes of
__graft_entry__._flagship_config(tiny=True))."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_config
from repconc_tpu.core import checkpoint as jax_checkpoint
from repconc_tpu.models import repconc_model as jax_model
from repconc_tpu.models.transformer import DenseEncoder as JaxDenseEncoder
from repconc_tpu_torch.core import checkpoint
from repconc_tpu_torch.core.config import RepConcConfig
from repconc_tpu_torch.models.convert import encoder_state_dict, from_jax_params
from repconc_tpu_torch.models.repconc_model import RepConcModel, from_pretrained
from repconc_tpu_torch.models.transformer import DenseEncoder

TOL = dict(rtol=0, atol=1e-5)  # fp32 on both sides; sums in another order

VARIANTS = {
    "cls": dict(pooling="cls"),
    "mean": dict(pooling="mean"),
    "mean_skip4": dict(pooling="mean_skip4"),
    "roberta_offset": dict(position_offset=2, pad_token_id=1, pooling="mean"),
    "no_token_types": dict(type_vocab_size=0),
    "projection_head": dict(projection=True, pooling="cls"),
    "gelu_new": dict(hidden_act="gelu_new", pooling="mean"),
}


def _inputs(rng, vocab, pad_id=0, B=3, L=12):
    ids = rng.integers(4, vocab, size=(B, L)).astype(np.int64)
    mask = np.ones((B, L), dtype=np.int64)
    for b, length in enumerate((L, 9, 5)[:B]):  # masked padding
        mask[b, length:] = 0
        ids[b, length:] = pad_id
    return ids, mask


def _tiny_config(**overrides):
    config = _flagship_config(tiny=True)
    enc = dataclasses.replace(config.encoder, **overrides)
    return dataclasses.replace(config, encoder=enc)


def _jax_encoder(enc_cfg, metric, ids, mask, seed=0):
    module = JaxDenseEncoder(enc_cfg, metric)
    params = module.init(jax.random.key(seed), jnp.asarray(ids[:1]),
                         jnp.asarray(mask[:1]))["params"]
    out = np.asarray(module.apply({"params": params}, jnp.asarray(ids),
                                  jnp.asarray(mask)))
    return jax.tree.map(np.asarray, params), out


def _port_encoder(enc_cfg, metric, params):
    from repconc_tpu_torch.core.config import EncoderConfig

    cfg = EncoderConfig(**dataclasses.asdict(enc_cfg))
    enc = DenseEncoder(cfg, metric)
    sd = encoder_state_dict(params, cfg.num_hidden_layers)
    enc.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return enc.eval()


@pytest.mark.parametrize("metric", ["METRIC_IP", "METRIC_COS"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dense_encoder_matches_flax(variant, metric):
    rng = np.random.default_rng(11)
    config = _tiny_config(**VARIANTS[variant])
    enc = config.encoder
    ids, mask = _inputs(rng, enc.vocab_size, enc.pad_token_id)
    params, want = _jax_encoder(enc, metric, ids, mask)
    port = _port_encoder(enc, metric, params)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("metric", ["METRIC_IP", "METRIC_CENTROID_COS"])
def test_repconc_model_matches_jax(metric):
    """encode_continuous (rotation as x @ R.T, CENTROID_COS subvector
    normalize) and forward(return_code=True) on a non-identity rotation."""
    rng = np.random.default_rng(3)
    config = dataclasses.replace(_flagship_config(tiny=True),
                                 similarity_metric=metric)
    params = jax_model.init_params(config, jax.random.key(5))
    rot, _ = np.linalg.qr(rng.normal(size=(config.hidden_size,) * 2))
    params["rotation"] = jnp.asarray(rot.astype(np.float32))
    ids, mask = _inputs(rng, config.encoder.vocab_size)
    want = jax_model.forward(config, params, jnp.asarray(ids), jnp.asarray(mask),
                             return_code=True, return_quantized_embedding=True)
    model = from_jax_params(RepConcConfig(**config.to_dict()),
                            jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    return_code=True, return_quantized_embedding=True)
    np.testing.assert_allclose(got.continuous_embeds.numpy(),
                               np.asarray(want.continuous_embeds), **TOL)
    np.testing.assert_array_equal(got.discrete_codes.numpy(),
                                  np.asarray(want.discrete_codes))
    np.testing.assert_allclose(got.quantized_embeds.numpy(),
                               np.asarray(want.quantized_embeds), **TOL)


def test_config_json_round_trip(tmp_path):
    """The port reads the JAX package's repconc_config.json and writes the
    same file back."""
    config = _tiny_config(pooling="mean", projection=True)
    config.save(str(tmp_path / "jax"))
    port = RepConcConfig.load(str(tmp_path / "jax"))
    port.save(str(tmp_path / "port"))
    assert (json.loads((tmp_path / "port" / "repconc_config.json").read_text())
            == json.loads((tmp_path / "jax" / "repconc_config.json").read_text()))
    assert port.dsub == config.dsub and port.encoder.head_dim == config.encoder.head_dim


def test_checkpoint_load_matches_flax(tmp_path):
    """params.msgpack decoded without flax equals flax's own restore, leaf
    for leaf; from_pretrained gives the model from_jax_params gives."""
    config = _tiny_config(projection=True)
    params = jax_model.init_params(config, jax.random.key(1))
    jax_checkpoint.save_model(str(tmp_path), config, params)
    _, want = jax_checkpoint.load_model(str(tmp_path))
    port_config, got = checkpoint.load_model(str(tmp_path))
    assert port_config.to_dict() == config.to_dict()
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in want_leaves] == [p for p, _ in got_leaves]
    for (_, w), (_, g) in zip(want_leaves, got_leaves):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    model = from_pretrained(str(tmp_path), device="cpu")
    ref = from_jax_params(port_config, got)
    for (name, a), (_, b) in zip(model.state_dict().items(),
                                 ref.state_dict().items()):
        assert torch.equal(a, b), name


def test_unported_dtype_raises():
    """bf16 activations are ported: a bfloat16 config builds, keeps fp32
    parameters and encodes to fp32 (tests/test_torch_bf16.py holds it to
    the JAX package); an activation dtype neither package has raises."""
    config = RepConcConfig(**_tiny_config(dtype="bfloat16").to_dict())
    model = RepConcModel(config)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    ids, mask = _inputs(np.random.default_rng(0), config.encoder.vocab_size)
    with torch.no_grad():
        out = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    return_code=True)
    assert out.continuous_embeds.dtype == torch.float32
    assert torch.isfinite(out.continuous_embeds).all()
    assert out.discrete_codes.shape == (3, config.MCQ_M)
    with pytest.raises(ValueError):
        RepConcModel(RepConcConfig(**_tiny_config(dtype="float16").to_dict()))
