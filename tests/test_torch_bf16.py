"""bf16 activations on the port against the JAX package, on the CPU.

The JAX package runs its encoder in bf16 when a config says
"dtype": "bfloat16", with fp32 parameters, LayerNorms, softmax and
attention scores (repconc_tpu/models/transformer.py). The two frameworks
round bf16 at different places (XLA may keep a fused chain of bf16 ops in
fp32), so bit equality is not the bar. The bar is JAX's own rounding: on
the same inputs and weights, the port's bf16 result lies from JAX's bf16
result at most twice as far as JAX's bf16 result lies from JAX's fp32 one.
A missed cast (a bf16 softmax, LayerNorm, score or -1e9 bias) shows as a
gap several times larger.

Codes and retrieved negatives are discrete: where the two packages' bf16
embeddings differ, a code or a negative may flip. Each flip is held to be
a near-tie that the measured embedding gap explains. The one-step tests
are tests/test_torch_bf16_steps.py.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from __graft_entry__ import _flagship_config
from repconc_tpu.models import repconc_model as jax_model
from repconc_tpu.models.transformer import DenseEncoder as JaxDenseEncoder
from repconc_tpu_torch.core.config import RepConcConfig
from repconc_tpu_torch.models import repconc_model
from repconc_tpu_torch.models.convert import from_jax_params
from repconc_tpu_torch.train import stage1
from test_torch_encoder import _inputs, _port_encoder, _tiny_config
from test_torch_eval import (_cli_args, _write_toy_files, toy_data,  # noqa: F401
                             toy_model_dir)
from test_torch_heldout import near_tie_gaps

RATIO = 2.0  # the port's gap to JAX's bf16 over JAX's bf16-vs-fp32 gap

VARIANTS = {
    "cls": dict(pooling="cls"),
    "mean": dict(pooling="mean"),
    "mean_skip4": dict(pooling="mean_skip4"),
    "projection": dict(projection=True, pooling="cls"),
    "roberta_offset": dict(position_offset=2, pad_token_id=1, pooling="mean"),
}


def bf16(cfg):
    """The same config with bf16 activations (either package's)."""
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, dtype="bfloat16"))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bf16_encoder_matches_jax(variant):
    """Pooled embeddings of the bf16 encoder, port against JAX, both on
    the CPU: within twice JAX's own bf16-vs-fp32 gap, and fp32 out."""
    rng = np.random.default_rng(11)
    enc = _tiny_config(**VARIANTS[variant]).encoder
    ids, mask = _inputs(rng, enc.vocab_size, enc.pad_token_id, B=3, L=12)
    module = JaxDenseEncoder(enc, "METRIC_IP")
    params = module.init(jax.random.key(0), jnp.asarray(ids[:1]),
                         jnp.asarray(mask[:1]))["params"]
    j32 = np.asarray(module.apply({"params": params}, jnp.asarray(ids),
                                  jnp.asarray(mask)))
    enc16 = dataclasses.replace(enc, dtype="bfloat16")
    j16 = np.asarray(JaxDenseEncoder(enc16, "METRIC_IP").apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    port = _port_encoder(enc16, "METRIC_IP", jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    jax_gap = float(np.abs(j16 - j32).max())
    port_gap = float(np.abs(got.numpy() - j16).max())
    assert 0.0 < jax_gap and port_gap <= RATIO * jax_gap, (port_gap, jax_gap)


class _OpDtypes(TorchFunctionMode):
    """Records (op name, tensor input dtypes, output dtype) of every torch
    call inside the block."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [a.dtype for a in (*args, *(kwargs or {}).values())
               if isinstance(a, torch.Tensor)]
        self.calls.append((getattr(func, "__name__", str(func)), ins,
                           out.dtype if isinstance(out, torch.Tensor) else None))
        return out


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bf16_rounding_points(dtype):
    """The casts themselves, op by op, since the gap bars above do not see
    them at toy widths (the bf16 rounding of weights and Dense outputs
    dominates; a bf16 softmax, score or LayerNorm moves the gap ratio by
    less than 0.5): every Dense of the transformer takes input, kernel and
    bias in the activation dtype; attention scores and context are fp32
    matmuls; the -1e9 bias is added and the softmax taken in fp32; every
    LayerNorm reads fp32 with fp32 parameters; GELU and the residual adds
    run in the activation dtype; the ANCE head is fp32, and so is the
    pooled output."""
    dt = getattr(torch, dtype)
    enc = _tiny_config(projection=True, pooling="cls", dtype=dtype).encoder
    from repconc_tpu_torch.core.config import EncoderConfig
    from repconc_tpu_torch.models.transformer import DenseEncoder

    model = DenseEncoder(EncoderConfig(**dataclasses.asdict(enc)))
    ids, mask = _inputs(np.random.default_rng(0), enc.vocab_size)
    with _OpDtypes() as log, torch.no_grad():
        out = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert out.dtype == torch.float32
    by = {}
    for name, ins, res in log.calls:
        by.setdefault(name, []).append((ins, res))
    f32 = torch.float32
    layers = enc.num_hidden_layers
    assert [i for i, _ in by["linear"]] == (
        [[dt] * 3] * (6 * layers) + [[f32] * 3])    # ... then the ANCE head
    assert all(i == [f32, f32] and r == f32 for i, r in by["matmul"])
    assert len(by["matmul"]) == 2 * layers
    assert all(i == [f32] for i, _ in by["softmax"])
    assert all(i == [f32, f32, f32] for i, _ in by["layer_norm"])
    assert len(by["layer_norm"]) == 1 + 2 * layers + 1
    assert all(i == [dt] for i, _ in by["gelu"])
    adds = [i for i, _ in by["add"] if torch.int64 not in i]
    # the scores + the -1e9 bias in fp32; the embedding sums and the
    # residuals in the activation dtype
    assert adds == ([[dt, dt]] * 2
                    + [[f32, f32], [dt, dt], [dt, dt]] * layers)


@pytest.mark.parametrize("metric", ["METRIC_IP", "METRIC_CENTROID_COS"])
def test_bf16_codes_match_jax_except_near_ties(metric):
    """forward(return_code=True) in bf16: continuous embeddings within
    twice JAX's bf16-vs-fp32 gap; a code that differs from JAX's bf16 code
    is a near-tie that the embedding gap explains. For an embedding moved
    by delta, the squared distances to centroids a and b move apart by at
    most 2 |delta| |c_a - c_b|: that, over the operands' squared norms
    (near_tie_gaps' scale), is each flip's bar."""
    rng = np.random.default_rng(4)
    config = bf16(dataclasses.replace(_flagship_config(tiny=True),
                                      similarity_metric=metric))
    params = jax_model.init_params(config, jax.random.key(6))
    ids, mask = _inputs(rng, config.encoder.vocab_size, B=3, L=12)
    ids = np.concatenate([ids, rng.integers(4, 512, size=(61, 12))])
    mask = np.concatenate([mask, np.ones((61, 12), np.int64)])
    jids, jmask = jnp.asarray(ids), jnp.asarray(mask)
    want = jax_model.forward(config, params, jids, jmask, return_code=True)
    x32 = np.asarray(jax_model.encode_continuous(
        dataclasses.replace(config, encoder=dataclasses.replace(
            config.encoder, dtype="float32")), params, jids, jmask))
    model = from_jax_params(RepConcConfig(**config.to_dict()),
                            jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    return_code=True)
    x16 = np.asarray(want.continuous_embeds)
    x_port = got.continuous_embeds.numpy()
    assert x_port.dtype == np.float32
    assert (np.abs(x_port - x16).max()
            <= RATIO * np.abs(x16 - x32).max())
    codes_j = np.asarray(want.discrete_codes)
    codes_p = got.discrete_codes.numpy()
    assert (codes_p == codes_j).mean() > 0.9
    M = config.MCQ_M
    cent = np.asarray(params["centroids"], np.float64)
    gaps = near_tie_gaps(x16, cent, codes_j, codes_p)
    for g, (r, m) in zip(gaps, zip(*np.nonzero(codes_p != codes_j))):
        xs = x16[r].reshape(M, -1)[m].astype(np.float64)
        ca, cb = cent[m, codes_j[r, m]], cent[m, codes_p[r, m]]
        delta = np.linalg.norm(x_port[r].reshape(M, -1)[m] - xs)
        scale = (xs ** 2).sum() + max((ca ** 2).sum(), (cb ** 2).sum())
        assert g <= 2 * delta * np.linalg.norm(ca - cb) / scale, (r, m, g)


def _bf16_dir(src, dst):
    """A copy of model dir `src` whose repconc_config.json asks for bf16
    activations."""
    shutil.copytree(src, dst)
    path = os.path.join(dst, "repconc_config.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["encoder"]["dtype"] = "bfloat16"
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return str(dst)


def test_bf16_model_dirs_round_trip_both_ways(tmp_path):
    """save_pretrained -> from_pretrained keeps "dtype": "bfloat16"; each
    package opens the other's bf16 dir and encodes the same embeddings
    within twice JAX's bf16-vs-fp32 gap; fp32 dirs stay fp32."""
    config = bf16(_flagship_config(tiny=True))
    params = jax_model.init_params(config, jax.random.key(2))
    jax_model.save_pretrained(str(tmp_path / "jax"), config, params)
    port = repconc_model.from_pretrained(str(tmp_path / "jax"), device="cpu")
    assert port.config.encoder.dtype == "bfloat16"
    repconc_model.save_pretrained(str(tmp_path / "port"), port)
    with open(tmp_path / "port" / "repconc_config.json") as f:
        assert json.load(f) == config.to_dict()
    back_cfg, back_params = jax_model.from_pretrained(str(tmp_path / "port"))
    assert back_cfg.encoder.dtype == "bfloat16"
    for a, b in zip(jax.tree.leaves(back_params), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    rng = np.random.default_rng(8)
    ids, mask = _inputs(rng, config.encoder.vocab_size)
    j16 = np.asarray(jax_model.encode_continuous(
        back_cfg, back_params, jnp.asarray(ids), jnp.asarray(mask)))
    j32 = np.asarray(jax_model.encode_continuous(
        dataclasses.replace(config, encoder=dataclasses.replace(
            config.encoder, dtype="float32")), params, jnp.asarray(ids),
        jnp.asarray(mask)))
    with torch.no_grad():
        got = port.encode_continuous(torch.from_numpy(ids),
                                     torch.from_numpy(mask)).numpy()
    assert np.abs(got - j16).max() <= RATIO * np.abs(j16 - j32).max()
    fp32 = dataclasses.replace(config, encoder=dataclasses.replace(
        config.encoder, dtype="float32"))
    jax_model.save_pretrained(str(tmp_path / "fp32"), fp32, params)
    assert repconc_model.from_pretrained(
        str(tmp_path / "fp32"), device="cpu").config.encoder.dtype == "float32"


def test_bf16_dir_through_the_clis(toy_model_dir, toy_data, tmp_path):
    """A model dir with "dtype": "bfloat16" through the port's CLIs on the
    CPU: run_repconc_eval (flat, then IVF with decoded int8 serving),
    run_train_conc (stage 1) and run_train_jpq (stage 2) over its codes;
    stage 0's dense training is stage1.train(quantize=False), which
    run_train_dense calls on an HF dir (whose config carries no activation
    dtype in either package), here on the bf16 model. The trained dirs keep
    bf16 and the JAX package loads them."""
    from repconc_tpu_torch.cli import (run_repconc_eval, run_train_conc,
                                       run_train_jpq)
    from repconc_tpu_torch.train.data import (FinetuneCollator, QDRelDataset,
                                              batch_iterator)

    d16 = _bf16_dir(toy_model_dir, tmp_path / "m16")
    paths = _write_toy_files(tmp_path, *toy_data)
    cdir, qdir = tmp_path / "c", tmp_path / "q"
    base = _cli_args(d16, paths, cdir, qdir) + ["--device", "cpu"]
    run_repconc_eval.main(base)
    flat = json.load(open(qdir / "metric.json"))
    assert "perquery" in flat and len(flat) > 1
    os.remove(qdir / "metric.json")
    run_repconc_eval.main(base + ["--index_type", "ivf", "--nlist", "8",
                                  "--nprobe", "8", "--serving",
                                  "decoded_int8"])
    assert (qdir / "metric.json").exists()

    common = ["--qrel_path", paths["qrels"], "--query_path", paths["queries"],
              "--per_device_train_batch_size", "8", "--max_steps", "2",
              "--logging_steps", "1", "--learning_rate", "1e-3",
              "--device", "cpu"]
    out1 = tmp_path / "s1"
    run_train_conc.main(["--model_name_or_path", d16, "--corpus_path",
                         paths["corpus"], "--output_dir", str(out1),
                         "--sk_iters", "10"] + common)
    cfg, _ = jax_model.from_pretrained(str(out1 / "final"))
    assert cfg.encoder.dtype == "bfloat16"
    out2 = tmp_path / "s2"
    run_train_jpq.main(["--model_name_or_path", str(out1 / "final"),
                        "--index_dir", str(cdir), "--output_dir", str(out2),
                        "--dynamic_topk_negative", "5"] + common)
    cfg, _ = jax_model.from_pretrained(str(out2 / "final"))
    assert cfg.encoder.dtype == "bfloat16"

    model = repconc_model.from_pretrained(d16, device="cpu")
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(d16)
    ds = QDRelDataset(paths["qrels"], paths["queries"], paths["corpus"],
                      negative="random", negative_per_query=1)
    batches = batch_iterator(ds, FinetuneCollator(tok, 8, 16), 8, seed=3)
    hp = stage1.Stage1Hparams(quantize=False, total_steps=2, logging_steps=1,
                              centroid_learning_rate=0.0, learning_rate=1e-3)
    out0 = stage1.train(model, batches, hp, str(tmp_path / "s0"),
                        tokenizer=tok, device="cpu")
    assert out0["step"] == 2
    assert all(np.isfinite(h["loss"]) for h in out0["history"])

