"""The port's numpy-only params.msgpack writer and reader against flax's
serialization, the flax-tree export of a RepConcModel, and model dirs that
each package loads from the other."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from repconc_tpu.core import checkpoint as jax_ckpt
from repconc_tpu.core.config import EncoderConfig, RepConcConfig
from repconc_tpu.models import repconc_model as jax_model
from repconc_tpu_torch.core import checkpoint
from repconc_tpu_torch.core.config import RepConcConfig as PortConfig
from repconc_tpu_torch.models import repconc_model
from repconc_tpu_torch.models.convert import from_jax_params, to_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def toy(similarity_metric="METRIC_IP", projection=False, type_vocab_size=2):
    enc = EncoderConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=64,
                        max_position_embeddings=64, pooling="mean",
                        projection=projection,
                        type_vocab_size=type_vocab_size,
                        hidden_dropout=0.0, attention_dropout=0.0)
    cfg = RepConcConfig(encoder=enc, MCQ_M=4, MCQ_K=16,
                        similarity_metric=similarity_metric)
    params = jax.tree.map(np.asarray, jax_model.init_params(cfg, jax.random.key(0)))
    return cfg, params


def assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def extra_leaves(rng):
    """Leaves a parameter tree can hold besides fp32 matrices: ints, a 0-d
    array, an empty array, a 3-d array and a numpy scalar."""
    return {"ints": np.arange(300, dtype=np.int32).reshape(3, 100),
            "scalar0d": np.asarray(np.float32(2.5)),
            "empty": np.zeros((2, 0), np.float32),
            "cube": rng.normal(size=(3, 4, 5)).astype(np.float64),
            "npscalar": np.int64(-7)}


@pytest.mark.parametrize("variant", ["plain", "projection", "no_token_types"])
def test_writer_bytes_equal_flax(variant, tmp_path):
    cfg, params = toy(projection=variant == "projection",
                      type_vocab_size=0 if variant == "no_token_types" else 2)
    tree = dict(params, extra=extra_leaves(np.random.default_rng(1)))
    want = serialization.to_bytes(jax.tree.map(np.asarray, tree))
    assert checkpoint.params_to_bytes(tree) == want
    # and equal to the file the JAX package's save_params writes
    jax_ckpt.save_params(str(tmp_path), tree)
    assert (tmp_path / "params.msgpack").read_bytes() == want


def test_reader_equals_flax_restore():
    cfg, params = toy()
    tree = dict(params, extra=extra_leaves(np.random.default_rng(2)))
    data = serialization.to_bytes(jax.tree.map(np.asarray, tree))
    assert_trees_equal(checkpoint.params_from_bytes(data),
                       serialization.msgpack_restore(data))


def test_chunked_leaf_round_trip(monkeypatch):
    """Leaves above the chunk limit (lowered from 1 GiB to 1 kB here) are
    chunked as flax chunks them, and read back whole."""
    from flax import serialization as fser

    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 1000)
    monkeypatch.setattr(checkpoint, "MAX_CHUNK_SIZE", 1000)
    cfg, params = toy()
    want = fser.to_bytes(jax.tree.map(np.asarray, params))
    assert b"__msgpack_chunked_array__" in want
    assert checkpoint.params_to_bytes(params) == want
    got = checkpoint.params_from_bytes(want)
    assert_trees_equal(got, fser.msgpack_restore(want))
    assert_trees_equal(got, params)


def test_reader_rejects_truncated_bytes():
    cfg, params = toy()
    data = checkpoint.params_to_bytes(params)
    with pytest.raises(ValueError):
        checkpoint.params_from_bytes(data[:-10])
    with pytest.raises(ValueError):
        checkpoint.params_from_bytes(data + b"\x00")


def test_load_params_needs_no_msgpack(tmp_path):
    """A JAX model dir loads with `msgpack` unimportable, as on the card's
    machine."""
    cfg, params = toy()
    jax_ckpt.save_params(str(tmp_path), params)
    code = ("import sys\nsys.modules['msgpack'] = None\n"
            "from repconc_tpu_torch.core.checkpoint import load_params\n"
            f"p = load_params({str(tmp_path)!r})\n"
            "print(p['centroids'].shape)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "(4, 16, 8)"


@pytest.mark.parametrize("variant", ["plain", "projection", "no_token_types"])
def test_to_jax_params_inverts_from_jax_params(variant):
    cfg, params = toy(projection=variant == "projection",
                      type_vocab_size=0 if variant == "no_token_types" else 2)
    model = from_jax_params(PortConfig(**cfg.to_dict()), params)
    assert_trees_equal(to_jax_params(model), params)


@pytest.mark.parametrize("metric", ["METRIC_IP", "METRIC_CENTROID_COS"])
def test_save_pretrained_loads_in_jax(metric, tmp_path):
    """The port's model dir loads in the JAX package's from_pretrained,
    and JAX's encode_continuous there equals the port's encode."""
    cfg, params = toy(similarity_metric=metric)
    gen = torch.Generator().manual_seed(3)
    model = from_jax_params(PortConfig(**cfg.to_dict()), params)
    with torch.no_grad():  # move every weight off the JAX init
        for p in model.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=gen))
    tok_dir = tmp_path / "tok"
    tok_dir.mkdir()
    (tok_dir / "vocab.txt").write_text("[PAD]\n[UNK]\n")
    repconc_model.save_pretrained(str(tmp_path / "m"), model,
                                  tokenizer_dir=str(tok_dir))
    assert (tmp_path / "m" / "vocab.txt").exists()
    jcfg, jparams = jax_model.from_pretrained(str(tmp_path / "m"))
    assert jcfg.to_dict() == model.config.to_dict()
    assert_trees_equal(jparams, to_jax_params(model))
    rng = np.random.default_rng(4)
    ids = rng.integers(4, 64, size=(5, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    want = np.asarray(jax_model.encode_continuous(
        jcfg, jparams, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = model.encode_continuous(torch.tensor(ids), torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # and back: the port reads what it wrote
    again = repconc_model.from_pretrained(str(tmp_path / "m"), device="cpu")
    assert_trees_equal(to_jax_params(again), to_jax_params(model))
