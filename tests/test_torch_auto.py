"""HF dense-encoder checkpoints on the port (models/auto.py, the adapter
tokenizers, core/safetensors_io.py) against HF's torch models built from a
config (no download) and against the JAX package: the same weights bit for
bit, pooled embeddings within 1e-5, and model dirs that each package
writes and the other reads."""
import dataclasses
import json
import os
import tarfile

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_file
from safetensors.numpy import save as st_save
from safetensors.numpy import save_file as st_save_file

import jax.numpy as jnp
from repconc_tpu.models import adapters as jax_adapters
from repconc_tpu.models import auto as jax_auto
from repconc_tpu.models.transformer import DenseEncoder as JaxDenseEncoder
from repconc_tpu_torch.core import safetensors_io
from repconc_tpu_torch.models import adapters, auto
from repconc_tpu_torch.models.convert import encoder_state_dict
from repconc_tpu_torch.models.repconc_model import from_dense_encoder
from repconc_tpu_torch.models.transformer import DenseEncoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORT_TAR = os.path.join(ROOT, "artifacts", "r5h_export_hf.tar")
TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64)
TOL = dict(rtol=1e-5, atol=1e-5)


def _same_config(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _inputs(rng, pad_id, B=3, L=12, pad_from=9):
    ids = rng.integers(5, 64, size=(B, L)).astype(np.int64)
    mask = np.ones((B, L), dtype=np.int64)
    mask[1:, pad_from:] = 0
    ids[mask == 0] = pad_id
    return ids, mask


def _hf_model(kind):
    """(HF config dict, state dict of numpy arrays, fn(ids, mask) -> the
    pooled embeddings HF's torch modules give) for a tiny random model."""
    from transformers import (BertConfig, BertModel, DistilBertConfig,
                              DistilBertModel, RobertaConfig, RobertaModel)

    torch.manual_seed(3)
    if kind == "distilbert":
        cfg = DistilBertConfig(vocab_size=64, dim=32, n_layers=2, n_heads=4,
                               hidden_dim=64, max_position_embeddings=64)
        model, prefix = DistilBertModel(cfg), ""
    elif kind in ("roberta", "ance"):
        cfg = RobertaConfig(**TINY, pad_token_id=1)
        model = RobertaModel(cfg, add_pooling_layer=False)
        prefix = "roberta." if kind == "ance" else ""
    else:
        cfg = BertConfig(**TINY, pad_token_id=0)
        model, prefix = BertModel(cfg, add_pooling_layer=False), ""
    model.eval()
    sd = {prefix + k: v.numpy() for k, v in model.state_dict().items()}
    hf = cfg.to_dict()
    head = norm = None
    if kind == "ance":
        # the head's LayerNorm takes the config's layer_norm_eps (1e-12)
        # in both packages; examples/ance builds nn.LayerNorm(768), eps 1e-5
        head = torch.nn.Linear(32, 32)
        norm = torch.nn.LayerNorm(32, eps=cfg.layer_norm_eps)
        torch.nn.init.normal_(norm.weight)  # not the identity
        sd.update({f"embeddingHead.{k}": v.detach().numpy()
                   for k, v in head.state_dict().items()})
        sd.update({f"norm.{k}": v.detach().numpy()
                   for k, v in norm.state_dict().items()})
        hf["model_type"] = "ance"
    if kind == "tct":
        hf["model_type"] = "tct"
    if kind in ("bert", "distilbert"):
        hf["pooling"] = "mean"

    @torch.no_grad()
    def pooled(ids, mask):
        h = model(torch.tensor(ids), torch.tensor(mask)).last_hidden_state
        if kind == "ance":
            return norm(head(h[:, 0])).numpy()
        if kind == "roberta":
            return h[:, 0].numpy()
        skip = 4 if kind == "tct" else 0
        m = torch.tensor(mask)[:, skip:, None].float()
        return ((h[:, skip:] * m).sum(1) / m.sum(1).clamp(min=1e-9)).numpy()

    return hf, sd, pooled


@pytest.mark.parametrize("kind", ["bert", "roberta", "distilbert", "ance", "tct"])
def test_pooled_embeddings_match_hf_and_jax(kind, rng):
    hf, sd, hf_pooled = _hf_model(kind)
    cfg = auto.encoder_config_from_hf(hf)
    assert _same_config(cfg, jax_auto.encoder_config_from_hf(hf))
    state = auto.convert_hf_weights(sd, cfg)
    jax_params = jax_auto.convert_hf_weights(sd, cfg)
    want_state = encoder_state_dict(jax_params, cfg.num_hidden_layers)
    assert set(state) == set(want_state)
    for name, v in want_state.items():  # the JAX conversion, bit for bit
        np.testing.assert_array_equal(state[name].numpy(), v, err_msg=name)
    module = DenseEncoder(cfg, "METRIC_IP")
    module.load_state_dict(state, strict=True)
    ids, mask = _inputs(rng, cfg.pad_token_id)
    with torch.no_grad():
        got = module(torch.tensor(ids), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, hf_pooled(ids, mask), **TOL)
    want = np.asarray(JaxDenseEncoder(cfg, "METRIC_IP").apply(
        {"params": jax_params}, jnp.asarray(ids, jnp.int32),
        jnp.asarray(mask, jnp.int32)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kind", ["bert", "distilbert", "ance"])
def test_export_hf_weights_round_trip(kind):
    hf, sd, _ = _hf_model(kind)
    cfg = auto.encoder_config_from_hf(hf)
    out = auto.export_hf_weights(auto.convert_hf_weights(sd, cfg), cfg)
    stripped = auto._strip_prefix(sd)
    assert set(out) == set(stripped)
    for k, v in stripped.items():
        assert out[k].dtype == np.float32 and out[k].flags.c_contiguous
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    jax_out = jax_auto.export_hf_weights(jax_auto.convert_hf_weights(sd, cfg),
                                         cfg)
    assert st_save(out) == st_save(jax_out)


def test_strip_prefix_keeps_keys_outside_the_backbone():
    sd = {"bert.embeddings.word_embeddings.weight": 1, "norm.weight": 2}
    assert auto._strip_prefix(sd) == jax_auto._strip_prefix(sd) == {
        "embeddings.word_embeddings.weight": 1, "norm.weight": 2}
    other = {"model.embeddings.word_embeddings.weight": 1}
    assert auto._strip_prefix(other) == jax_auto._strip_prefix(other) == other


def _tensors(rng):
    return {"b.weight": rng.normal(size=(5, 3)).astype(np.float32),
            "a": np.arange(7, dtype=np.int64),
            "half": rng.normal(size=(2, 2)).astype(np.float16),
            "u8": np.arange(3, dtype=np.uint8),
            "scalar": np.array(2.5, np.float64),
            "empty": np.zeros((0, 4), np.float32),
            "flags": np.array([True, False]),
            "i32": np.arange(-2, 2, dtype=np.int32)}


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}])
def test_safetensors_bytes_equal_the_package(rng, tmp_path, metadata):
    tensors = _tensors(rng)
    assert safetensors_io.save_bytes(tensors, metadata) == st_save(
        tensors, metadata=metadata)
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "theirs.safetensors"
    safetensors_io.save_file(tensors, str(ours), metadata)
    st_save_file(tensors, str(theirs), metadata=metadata)
    assert ours.read_bytes() == theirs.read_bytes()
    back = safetensors_io.load_file(str(theirs))
    want = st_load_file(str(theirs))
    assert set(back) == set(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_safetensors_reads_bf16_widened_to_fp32(tmp_path):
    from safetensors.torch import save_file as st_torch_save_file

    t = {"w": torch.randn(4, 6, generator=torch.Generator().manual_seed(1)
                          ).to(torch.bfloat16), "b": torch.randn(3)}
    st_torch_save_file(t, str(tmp_path / "model.safetensors"))
    back = safetensors_io.load_file(str(tmp_path / "model.safetensors"))
    assert back["w"].dtype == np.float32
    np.testing.assert_array_equal(back["w"], t["w"].float().numpy())
    np.testing.assert_array_equal(back["b"], t["b"].numpy())


def test_safetensors_refuses_a_truncated_file():
    data = st_save({"w": np.ones((4, 4), np.float32)})
    for cut in (data[:5], data[:20], data[:-8]):
        with pytest.raises(ValueError):
            safetensors_io.load_bytes(cut)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_shard_series_and_bf16_bin_load_as_jax_loads_them(tmp_path, fmt):
    """A shard series (model-0000k-of-0000n), in sorted order, with bf16
    tensors in the .bin case."""
    hf, sd, _ = _hf_model("bert")
    names = sorted(sd)
    halves = [names[::2], names[1::2]]
    for k, part in enumerate(halves):
        if fmt == "safetensors":
            st_save_file({n: sd[n] for n in part}, str(
                tmp_path / f"model-0000{k + 1}-of-00002.safetensors"))
        else:
            torch.save({n: torch.from_numpy(sd[n]).to(torch.bfloat16)
                        for n in part},
                       tmp_path / f"pytorch_model-0000{k + 1}-of-00002.bin")
    (tmp_path / "config.json").write_text(json.dumps(hf))
    got = auto._load_state_dict(str(tmp_path))
    want = jax_auto._load_state_dict(str(tmp_path))
    assert set(got) == set(want) == set(sd)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cfg, state, metric = auto.load_dense_encoder(str(tmp_path), device="cpu")
    _, jax_params, jax_metric = jax_auto.load_dense_encoder(str(tmp_path))
    assert metric == jax_metric == "METRIC_IP"
    for name, v in encoder_state_dict(jax_params,
                                      cfg.num_hidden_layers).items():
        np.testing.assert_array_equal(state[name].numpy(), v, err_msg=name)


def _hf_dir(tmp_path, name="hf"):
    from transformers import BertConfig, BertModel, BertTokenizerFast

    torch.manual_seed(5)
    d = tmp_path / name
    d.mkdir()
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        f"w{i}" for i in range(59)]
    (d / "vocab.txt").write_text("\n".join(vocab))
    BertTokenizerFast(vocab_file=str(d / "vocab.txt")).save_pretrained(d)
    cfg = BertConfig(**TINY, pad_token_id=0)
    cfg.pooling = "mean"
    BertModel(cfg, add_pooling_layer=False).save_pretrained(d)
    return d


def test_save_hf_checkpoint_dirs_cross_load(tmp_path):
    """The port's dir loads in the JAX package with bit-equal tensors, the
    JAX package's in the port, and both files hold the same bytes."""
    src = _hf_dir(tmp_path)
    cfg, state, _ = auto.load_dense_encoder(str(src), device="cpu")
    state = {k: v + 0.25 for k, v in state.items()}  # not the source's
    auto.save_hf_checkpoint(str(tmp_path / "port"), str(src), state, cfg,
                            similarity_metric="METRIC_COS")
    jax_cfg, jax_params, jax_metric = jax_auto.load_dense_encoder(
        str(tmp_path / "port"))
    assert jax_metric == "METRIC_COS" and _same_config(jax_cfg, cfg)
    for name, v in encoder_state_dict(jax_params,
                                      cfg.num_hidden_layers).items():
        np.testing.assert_array_equal(v, state[name].numpy(), err_msg=name)
    assert (tmp_path / "port" / "vocab.txt").exists()

    jax_auto.save_hf_checkpoint(str(tmp_path / "jax"), str(src), jax_params,
                                jax_cfg, similarity_metric="METRIC_COS")
    cfg2, state2, metric2 = auto.load_dense_encoder(str(tmp_path / "jax"),
                                                    device="cpu")
    assert metric2 == "METRIC_COS" and cfg2 == cfg
    for name, t in state.items():
        assert torch.equal(state2[name], t), name
    for name in ("model.safetensors", "config.json"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


@pytest.mark.parametrize("metric", ["METRIC_IP", "METRIC_CENTROID_COS"])
def test_from_dense_encoder(tmp_path, metric):
    src = _hf_dir(tmp_path)
    model = from_dense_encoder(str(src), MCQ_M=8, MCQ_K=16,
                               similarity_metric=metric, device="cpu")
    assert model.config.similarity_metric == metric
    assert model.config.encoder.pooling == "mean"
    assert torch.equal(model.rotation, torch.eye(32))
    assert model.centroids.shape == (8, 16, 4)
    if metric == "METRIC_CENTROID_COS":
        torch.testing.assert_close(model.centroids.norm(dim=-1),
                                   torch.ones(8, 16))
    again = from_dense_encoder(str(src), MCQ_M=8, MCQ_K=16,
                               similarity_metric=metric, device="cpu")
    assert torch.equal(again.centroids, model.centroids)  # seeded
    _, state, _ = auto.load_dense_encoder(str(src), device="cpu")
    for name, t in state.items():
        assert torch.equal(model.encoder.state_dict()[name], t), name


def test_tct_tokenizer_matches_jax(tmp_path):
    from transformers import BertTokenizerFast

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[Q]", "[D]",
             "hello", "world"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab))
    base = BertTokenizerFast(vocab_file=str(tmp_path / "vocab.txt"))
    base.add_special_tokens({"additional_special_tokens": ["[Q]", "[D]"]})
    base.save_pretrained(tmp_path)
    tok = adapters.load_adapter_tokenizer(str(tmp_path), "tct")
    jax_tok = jax_adapters.load_adapter_tokenizer(str(tmp_path), "tct")
    for texts, kind, kw in ((["hello", "hello world"], "query", {}),
                            (["hello world"], "doc", {"max_length": 8})):
        got = tok(texts, input_text_type=kind, **kw)
        assert got["input_ids"] == jax_tok(texts, input_text_type=kind,
                                           **kw)["input_ids"]
    q = tok.convert_ids_to_tokens(tok(["hello"], input_text_type="query")
                                  ["input_ids"][0])
    assert q[:3] == ["[CLS]", "[Q]", "hello"] and len(q) == 36
    from repconc_tpu_torch.eval.encode import accepts_text_type

    assert accepts_text_type(tok)


def test_ance_tokenizer_lowercases_as_jax_does(tmp_path):
    from transformers import RobertaTokenizerFast

    chars = {c: i + 5 for i, c in enumerate("helloHELLO")}
    vocab = {"<s>": 0, "</s>": 1, "<unk>": 2, "<pad>": 3, "<mask>": 4, **chars}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n")
    base = RobertaTokenizerFast(vocab_file=str(tmp_path / "vocab.json"),
                                merges_file=str(tmp_path / "merges.txt"))
    base.save_pretrained(tmp_path)
    tok = adapters.load_adapter_tokenizer(str(tmp_path), "ance")
    jax_tok = jax_adapters.load_adapter_tokenizer(str(tmp_path), "ance")
    got = tok(["Hello", "hELLo"])["input_ids"]
    assert got == jax_tok(["Hello", "hELLo"])["input_ids"]
    assert got[0] == base(["hello"])["input_ids"][0] != base(["Hello"])["input_ids"][0]
    with pytest.raises(TypeError):
        tok("Hello")


def test_real_export_matches_jax(tmp_path):
    """The real M=12 pipeline's stage-0 export: every tensor of
    export_hf/model.safetensors, read from the tar (never extracted into
    the repo), equals the JAX package's conversion, and 16 texts through
    its own tokenizer encode within 1e-4 of the JAX encoder."""
    if not os.path.exists(EXPORT_TAR):
        pytest.skip("artifacts/r5h_export_hf.tar is not in this checkout")
    from transformers import AutoTokenizer

    with tarfile.open(EXPORT_TAR) as tar:
        raw = tar.extractfile("export_hf/model.safetensors").read()
        for member in tar.getmembers():
            name = os.path.basename(member.name)
            if member.isfile() and name != "model.safetensors":
                (tmp_path / name).write_bytes(tar.extractfile(member).read())
    hf = json.loads((tmp_path / "config.json").read_text())
    sd = safetensors_io.load_bytes(raw)
    from safetensors.numpy import load as st_load

    want_sd = st_load(raw)
    del raw
    assert set(sd) == set(want_sd)
    cfg = auto.encoder_config_from_hf(hf)
    state = auto.convert_hf_weights(sd, cfg)
    jax_params = jax_auto.convert_hf_weights(want_sd, cfg)
    del sd, want_sd
    for name, v in encoder_state_dict(jax_params,
                                      cfg.num_hidden_layers).items():
        np.testing.assert_array_equal(state[name].numpy(), v, err_msg=name)

    tok = AutoTokenizer.from_pretrained(str(tmp_path))
    rng = np.random.default_rng(16)
    words = [w for w in tok.get_vocab() if not w.startswith(("[", "##"))]
    texts = [" ".join(rng.choice(words, size=int(rng.integers(3, 40))))
             for _ in range(16)]
    out = tok(texts, padding=True, truncation=True, max_length=64)
    ids = np.asarray(out["input_ids"], np.int64)
    mask = np.asarray(out["attention_mask"], np.int64)
    metric = hf.get("similarity_metric", "METRIC_IP")
    module = DenseEncoder(cfg, metric)
    module.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = module(torch.tensor(ids), torch.tensor(mask)).numpy()
    want = np.asarray(JaxDenseEncoder(cfg, metric).apply(
        {"params": jax_params}, jnp.asarray(ids, jnp.int32),
        jnp.asarray(mask, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
