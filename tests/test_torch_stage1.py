"""The port's stage-1 trainer against repconc_tpu.train.stage1 on the CPU:
the chunked encode and its dropout replay, the optimizer against optax,
one train step against JAX's, the quant-health stats, whole training runs
of both packages over the same batches, resume, and the CLI.

Tolerances: losses within 1e-5 relative; each gradient array within 1e-4
of its own largest |g|; parameters after a step within 1e-6 absolute, at
the CLI's learning rates (2e-5 for the encoder, 5e-4 for the centroids).
Adam's first update is lr * g / (|g| + 1e-8): an element whose gradient is
near 1e-8 moves by a share of lr that fp32 noise in g shifts, so the bar
holds at those rates, not at any rate; the optimizer test, on gradients
of order 1, takes lr 1e-3 and weight decay 0.1, where the decay shows.

One exception, in both directions of the comparison: the attention KEY
biases. Softmax is invariant to adding a constant along a row, and a key
bias adds q . b_k to every score of a query's row, so the key biases'
gradient is zero in exact arithmetic; both packages return fp32 rounding
noise there (~1e-7 against gradients of order 1-10). Those arrays are held
to 1e-6 of the tree's largest |g|. Adam normalises that noise to steps of
up to the learning rate in either direction, so after training the key
biases are held to 2 * lr per update, and the encoders' outputs, which
those steps cannot change, to 1e-5."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from repconc_tpu.core.config import EncoderConfig, RepConcConfig
from repconc_tpu.models import repconc_model as jax_model
from repconc_tpu.train import stage1 as jax_stage1
from repconc_tpu_torch.core.config import RepConcConfig as PortConfig
from repconc_tpu_torch.models import repconc_model
from repconc_tpu_torch.models.convert import (from_jax_params, param_table,
                                              to_jax_params)
from repconc_tpu_torch.train import stage1
from test_torch_eval import make_corpus, toy_model_dir  # noqa: F401

TINY_ENC = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=64, hidden_dropout=0.0,
                attention_dropout=0.0)


def tiny(metric="METRIC_IP", **enc):
    cfg = RepConcConfig(encoder=EncoderConfig(**dict(TINY_ENC, **enc)),
                        MCQ_M=4, MCQ_K=16, similarity_metric=metric,
                        sk_epsilon=0.05, sk_iters=20)
    params = jax.tree.map(np.asarray, jax_model.init_params(cfg, jax.random.key(0)))
    return cfg, params


def port_model(cfg, params):
    return from_jax_params(PortConfig(**cfg.to_dict()), params)


def make_batch(rng, B=8, n_neg=2, Lq=8, Ld=12):
    """tests/test_stage1.py's batch, with padded rows and a duplicate
    negative."""
    def tok(B_, L):
        ids = rng.integers(4, 64, size=(B_, L)).astype(np.int32)
        mask = np.ones((B_, L), dtype=np.int32)
        mask[0, L // 2:] = 0
        ids[0, L // 2:] = 0
        return ids, mask

    q_ids, q_mask = tok(B, Lq)
    p_ids, p_mask = tok(B, Ld)
    n_ids, n_mask = tok(B * n_neg, Ld)
    pos_docids = np.arange(B, dtype=np.int32)
    positives = np.full((B, 4), -1, dtype=np.int32)
    positives[:, 0] = pos_docids
    neg_docids = rng.integers(B, 100, size=(B * n_neg,)).astype(np.int32)
    neg_docids[1] = neg_docids[0]
    return {
        "query_input_ids": q_ids, "query_attention_mask": q_mask,
        "pos_input_ids": p_ids, "pos_attention_mask": p_mask,
        "neg_input_ids": n_ids, "neg_attention_mask": n_mask,
        "qids": np.arange(B, dtype=np.int32),
        "pos_docids": pos_docids, "neg_docids": neg_docids,
        "query_positives": positives,
    }


def torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def port_grads(model):
    """The model's gradients as a flax-layout dict path -> array (zeros
    where no gradient reached, as jax.grad gives)."""
    out = {}
    for path, name, tr in param_table(model.config):
        p = model.get_parameter(name)
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        out[path] = g.T if tr else g
    return out


def is_key_bias(path):
    return path[-2:] == ("key", "bias")


def assert_grads_close(got, want_tree):
    """Each array within 1e-4 of its own largest |g|; the key biases
    (zero in exact arithmetic) within 1e-6 of the tree's largest |g|."""
    top = max(float(np.abs(leaf(want_tree, p)).max()) for p in got)
    for path, g in got.items():
        w = leaf(want_tree, path)
        bar = 1e-6 * top if is_key_bias(path) else 1e-4 * max(
            float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g, w, rtol=0, atol=bar, err_msg=str(path))


def assert_params_close(got_tree, want_tree, key_bias_bar):
    """Every leaf of two flax-layout trees within 1e-6, the key biases
    within key_bias_bar."""
    flat_want = {tuple(getattr(k, "key", k) for k in p): np.asarray(v)
                 for p, v in jax.tree_util.tree_flatten_with_path(want_tree)[0]}
    flat_got = {tuple(getattr(k, "key", k) for k in p): np.asarray(v)
                for p, v in jax.tree_util.tree_flatten_with_path(got_tree)[0]}
    assert flat_got.keys() == flat_want.keys()
    for path, w in flat_want.items():
        bar = key_bias_bar if is_key_bias(path) else 1e-6
        np.testing.assert_allclose(flat_got[path], w, rtol=0, atol=bar,
                                   err_msg=str(path))


# -- the chunked encode -------------------------------------------------------


def test_encode_chunked_matches_unchunked():
    """The GradCache path gives the unchunked values and gradients."""
    cfg, params = tiny()
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(4, 64, size=(16, 8)))
    mask = torch.ones((16, 8), dtype=torch.int64)
    grads = []
    for chunk in (-1, 4, 5):  # 5 rounds down to 4, a divisor of 16
        model = port_model(cfg, params)
        out = stage1.encode_chunked(model, ids, mask, chunk)
        (out ** 2).sum().backward()
        grads.append((out.detach(), {n: p.grad.clone() for n, p in
                                     model.named_parameters()
                                     if p.grad is not None}))
    (full, g_full), *chunked = grads
    for out, g in chunked:
        torch.testing.assert_close(out, full, rtol=1e-5, atol=1e-6)
        assert g.keys() == g_full.keys()
        for name in g_full:
            torch.testing.assert_close(g[name], g_full[name], rtol=1e-4,
                                       atol=5e-5)


def test_dropout_masks_replay_under_checkpoint():
    """With dropout on, the checkpointed chunks give the gradients of the
    same chunks encoded without checkpointing from the same seeds: the
    recompute draws the forward's masks."""
    cfg, params = tiny(hidden_dropout=0.3, attention_dropout=0.3)
    rng = np.random.default_rng(1)
    ids = torch.as_tensor(rng.integers(4, 64, size=(12, 8)))
    mask = torch.ones((12, 8), dtype=torch.int64)
    w = torch.as_tensor(rng.normal(size=(12, 32)).astype(np.float32))

    model = port_model(cfg, params)
    out = stage1.encode_chunked(model, ids, mask, 4,
                                torch.Generator().manual_seed(9))
    (out * w).sum().backward()
    got = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    ref = port_model(cfg, params)
    seeds = stage1.draw_seeds(torch.Generator().manual_seed(9), 3)
    outs = [ref.encode_continuous(ids[4 * i:4 * i + 4], mask[4 * i:4 * i + 4],
                                  torch.Generator().manual_seed(s))
            for i, s in enumerate(seeds)]
    ref_out = torch.cat(outs)
    (ref_out * w).sum().backward()
    torch.testing.assert_close(out.detach(), ref_out.detach(), rtol=0, atol=0)
    for n, p in ref.named_parameters():
        if p.grad is not None:
            torch.testing.assert_close(got[n], p.grad, rtol=0, atol=0)
    # and dropout was on: the no-dropout encode differs
    with torch.no_grad():
        plain = ref.encode_continuous(ids, mask)
    assert (plain - ref_out.detach()).abs().max() > 1e-3


# -- the optimizer ------------------------------------------------------------


def _random_grads(rng, params, rotation_scale):
    g = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32),
                     params)
    g["rotation"] = g["rotation"] * rotation_scale
    return g


@pytest.mark.parametrize("warmup,max_norm,rotation_scale", [
    (2, 1.0, 10.0),    # warm-up, clip active, the rotation's gradient large
    (0, 1e9, 1.0),     # no warm-up: the first update takes the full rate
    (0, 1.0, 0.0),     # clip active, a zero rotation gradient
])
def test_optimizer_matches_optax(warmup, max_norm, rotation_scale):
    """Three updates of the port's optimizer and of the JAX package's optax
    chain on the same parameters and gradients: the parameters within
    1e-6, the rotation unchanged, the returned norm optax's global norm
    over every leaf, the rotation's included."""
    cfg, params = tiny()
    hp = jax_stage1.Stage1Hparams(learning_rate=1e-3,
                                  centroid_learning_rate=1e-2,
                                  weight_decay=0.1, warmup_steps=warmup,
                                  total_steps=5, max_grad_norm=max_norm)
    tx = jax_stage1.make_optimizer(hp, params)
    state = tx.init(params)
    model = port_model(cfg, params)
    ptx = stage1.make_optimizer(stage1.Stage1Hparams(**hp.__dict__), model)
    named = dict(model.named_parameters())
    rng = np.random.default_rng(5)
    jp = params
    for _ in range(3):
        g = _random_grads(rng, params, rotation_scale)
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for path, name, tr in param_table(model.config):
            v = leaf(g, path)
            named[name].grad = torch.tensor(v.T if tr else v)
        norm = ptx.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)),
                                   rtol=1e-6)
        without_rotation = float(optax.global_norm(
            dict(g, rotation=np.zeros_like(g["rotation"]))))
        if rotation_scale:
            assert float(norm) > 1.01 * without_rotation
        if max_norm < 1e3:
            assert float(norm) > max_norm  # the clip is active
    got = to_jax_params(model)
    np.testing.assert_array_equal(got["rotation"], params["rotation"])
    assert_params_close(got, jax.tree.map(np.asarray, jp), key_bias_bar=1e-6)


def test_decay_mask_matches_jax():
    """No decay on biases and LayerNorms, through convert.py's table."""
    cfg, params = tiny(projection=True)
    model = port_model(cfg, params)
    want = jax_stage1._decay_mask(params)
    got = stage1._decay_mask(model)
    for path, name, _ in param_table(model.config):
        assert got[name] == bool(leaf(want, path)), name
    assert not got["encoder.transformer.layers.0.attention_ln.weight"]
    assert not got["encoder.projection.bias"]
    assert got["encoder.transformer.layers.0.mlp_up.weight"]
    groups = stage1.make_optimizer(stage1.Stage1Hparams(), model).optimizer.param_groups
    assert [g["weight_decay"] for g in groups] == [0.01, 0.0, 0.0]
    assert all(not got[n] for n, p in model.named_parameters()
               if any(p is q for q in groups[1]["params"]))


@pytest.mark.parametrize("warmup,total", [(0, 10), (2, 5), (3, 3), (0, 1)])
def test_lr_factor_is_optax_schedule(warmup, total):
    hp = jax_stage1.Stage1Hparams(learning_rate=1.0, warmup_steps=warmup,
                                  total_steps=total)
    base = optax.join_schedules(
        [optax.linear_schedule(0.0, 1.0, max(warmup, 1)),
         optax.linear_schedule(1.0, 0.0, max(total - warmup, 1))], [warmup])
    for k in range(total + 2):
        np.testing.assert_allclose(stage1._lr_factor(k, warmup, total),
                                   float(base(k)), rtol=1e-6, atol=1e-7)
    del hp


# -- one train step -----------------------------------------------------------


STEP_CASES = {  # name: (hparams, metric, negatives)
    "constraint": (dict(use_constraint=True, mse_loss_weight=0.1), "METRIC_IP", True),
    "argmin": (dict(use_constraint=False), "METRIC_IP", True),
    "inbatch": (dict(use_constraint=True), "METRIC_IP", False),
    "centroid_cos": (dict(use_constraint=True, temperature=0.5),
                     "METRIC_CENTROID_COS", True),
    "gradcache_topk": (dict(cache_chunk_size=4, dynamic_topk_hard_negative=3,
                            warmup_steps=2), "METRIC_IP", True),
    "dense": (dict(quantize=False), "METRIC_IP", True),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case):
    """One step of each package from the same parameters and batch: the
    loss and its parts, each gradient array, grad_norm, and the parameters
    after the update (with the CENTROID_COS renormalisation)."""
    extra, metric, negatives = STEP_CASES[case]
    cfg, params = tiny(metric)
    hp = jax_stage1.Stage1Hparams(total_steps=10, **extra)  # the CLI's rates
    batch = make_batch(np.random.default_rng(2))
    if not negatives:
        for k in ("neg_input_ids", "neg_attention_mask", "neg_docids"):
            del batch[k]
    # record the raw gradients in the optimizer state, then update
    record = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    tx = optax.chain(record, jax_stage1.make_optimizer(hp, params))
    step = jax.jit(jax_stage1.make_train_step(cfg, hp, tx))
    jp, state, metrics, _ = step(params, tx.init(params),
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 jax.random.key(0))

    model = port_model(cfg, params)
    phs = stage1.Stage1Hparams(**hp.__dict__)
    ptx = stage1.make_optimizer(phs, model)
    total, parts = stage1.loss_fn(model, phs, torch_batch(batch))
    total.backward()
    assert_grads_close(port_grads(model), state[0])
    got = stage1.make_train_step(model, phs, ptx)(torch_batch(batch))
    for k in ("loss", "contrastive_loss", "mse_loss", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(parts["loss"]), float(metrics["loss"]),
                               rtol=1e-5)
    assert_params_close(to_jax_params(model), jax.tree.map(np.asarray, jp),
                        key_bias_bar=2 * hp.learning_rate)
    if metric == "METRIC_CENTROID_COS":
        np.testing.assert_allclose(
            model.centroids.detach().norm(dim=-1).numpy(), 1.0, rtol=1e-5)


def test_quant_health_matches_jax():
    cfg, params = tiny()
    rng = np.random.default_rng(3)
    ids = rng.integers(4, 64, size=(64, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    want = jax_stage1.make_quant_health_fn(cfg)(params, jnp.asarray(ids),
                                                jnp.asarray(mask))
    got = stage1.make_quant_health_fn(port_model(cfg, params))(
        torch.as_tensor(ids), torch.as_tensor(mask))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert float(got["w_conc_avg_imbalance"]) <= float(got["wo_conc_avg_imbalance"])


@pytest.mark.parametrize("metric", ["METRIC_IP", "METRIC_CENTROID_COS"])
def test_forward_with_constraint_matches_jax(metric):
    """RepConcModel.forward(use_constraint=True): the config's sk_epsilon
    and sk_iters, codes equal to JAX's except near-ties, and the quantized
    embeddings decoded from them."""
    cfg, params = tiny(metric)
    rng = np.random.default_rng(6)
    ids = rng.integers(4, 64, size=(48, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    want = jax_model.forward(cfg, params, jnp.asarray(ids), jnp.asarray(mask),
                             return_code=True, return_quantized_embedding=True,
                             use_constraint=True)
    with torch.no_grad():
        got = port_model(cfg, params)(torch.as_tensor(ids),
                                      torch.as_tensor(mask), return_code=True,
                                      return_quantized_embedding=True,
                                      use_constraint=True)
    np.testing.assert_allclose(got.continuous_embeds.numpy(),
                               np.asarray(want.continuous_embeds), atol=1e-5)
    codes, want_codes = got.discrete_codes.numpy(), np.asarray(want.discrete_codes)
    assert (codes == want_codes).mean() >= 0.99
    np.testing.assert_array_equal(
        got.quantized_embeds.numpy().reshape(48, 4, -1)[codes == want_codes],
        np.asarray(want.quantized_embeds).reshape(48, 4, -1)[codes == want_codes])


# -- whole training runs ------------------------------------------------------


@pytest.fixture(scope="module")
def toy_train(tmp_path_factory, toy_model_dir):
    """Training TSVs over the toy corpus of tests/test_torch_eval.py (a
    query is the start of its doc), a validation set, and the toy model dir
    with dropout set to 0 (dropout RNG differs between the packages)."""
    from transformers import AutoTokenizer

    rng = np.random.default_rng(11)
    corpus = make_corpus(rng, n=120)
    d = tmp_path_factory.mktemp("train_data")
    with open(d / "corpus.tsv", "w") as f:
        f.writelines(f"{k}\t{v}\n" for k, v in corpus.items())
    with open(d / "queries.tsv", "w") as f:
        f.writelines(f"q{i}\t{' '.join(corpus[f'd{i}'].split()[:3])}\n"
                     for i in range(0, 120, 2))
    with open(d / "qrels.tsv", "w") as f:
        f.writelines(f"q{i} 0 d{i} 1\n" for i in range(0, 120, 2))
    queries = {f"v{i}": " ".join(corpus[f"d{i}"].split()[:4])
               for i in range(1, 120, 6)}
    valid = (corpus, queries, {q: {f"d{q[1:]}": 1} for q in queries})
    config, params = jax_model.from_pretrained(toy_model_dir)
    config.encoder.hidden_dropout = config.encoder.attention_dropout = 0.0
    return dict(dir=d, valid=valid, config=config,
                params=jax.tree.map(np.asarray, params),
                tok=AutoTokenizer.from_pretrained(toy_model_dir))


def _port_batches(t, n, batch_size=8, negative="random", n_neg=1):
    from repconc_tpu_torch.train.data import (FinetuneCollator, QDRelDataset,
                                              batch_iterator)

    d = t["dir"]
    ds = QDRelDataset(str(d / "qrels.tsv"), str(d / "queries.tsv"),
                      str(d / "corpus.tsv"), negative=negative,
                      negative_per_query=n_neg)
    it = batch_iterator(ds, FinetuneCollator(t["tok"], 8, 16), batch_size,
                        seed=3)
    return [b for _, b in zip(range(n), it)]


def test_train_matches_jax(toy_train, tmp_path):
    """Both trainers over the same 3 batches from the data copy, with
    validation at step 2 and saves every 2 steps: the same history, the same
    best metric, final parameters within the bars, and each package loads
    the other's final/."""
    t = toy_train
    hp = jax_stage1.Stage1Hparams(total_steps=3, logging_steps=1, eval_steps=2,
                                  save_steps=2, mse_loss_weight=0.1)
    batches = _port_batches(t, 3)
    want = jax_stage1.train(t["config"], t["params"], iter(batches), hp,
                            str(tmp_path / "jax"), tokenizer=t["tok"],
                            valid_set=t["valid"])
    model = port_model(t["config"], t["params"])
    got = stage1.train(model, iter(batches), stage1.Stage1Hparams(**hp.__dict__),
                       str(tmp_path / "port"), tokenizer=t["tok"],
                       valid_set=t["valid"], device="cpu")
    assert got["step"] == want["step"] == 3
    assert [h["step"] for h in got["history"]] == [1, 2, 3]
    for g, w in zip(got["history"], want["history"]):
        assert g.keys() == w.keys()
        for k in ("loss", "contrastive_loss", "mse_loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
        for k in w:  # the quant-health stats, rounded to 4 places
            assert abs(g[k] - w[k]) <= 1e-4 + 1e-6, k
    jax_final = jax.tree.map(np.asarray, want["params"])
    assert_params_close(to_jax_params(model), jax_final,
                        key_bias_bar=2 * hp.learning_rate * 3)
    for name in ("best", "final"):
        assert (tmp_path / "port" / name / "params.msgpack").exists()
        assert (tmp_path / "port" / name / "vocab.txt").exists()
    # best/ holds step 2 (the one validation) in both; each package's
    # validation metric is its own eval of the other's best/ (the toy docs
    # share codes, and the packages order exact score ties differently,
    # so the two evals of one model may differ; tests/test_torch_eval.py
    # holds the eval paths to each other)
    from repconc_tpu.eval import pipeline as jax_pipeline
    from repconc_tpu_torch.eval import pipeline

    corpus, queries, qrels = t["valid"]
    jcfg, jax_best = jax_model.from_pretrained(str(tmp_path / "jax" / "best"))
    port_best = repconc_model.from_pretrained(str(tmp_path / "port" / "best"),
                                              device="cpu")
    assert_params_close(to_jax_params(port_best), jax.tree.map(np.asarray, jax_best),
                        key_bias_bar=2 * hp.learning_rate * 2)
    mine = pipeline.evaluate_repconc_model(
        from_jax_params(port_best.config, jax_best), t["tok"], corpus, queries,
        qrels, max_seq_length=512, topk=10, device="cpu")
    assert got["best_metric"] == mine["MRR@10"]
    theirs = jax_pipeline.evaluate_repconc_model(
        jcfg, to_jax_params(port_best), t["tok"], corpus, queries, qrels,
        max_seq_length=512, topk=10)
    assert want["best_metric"] == theirs["MRR@10"]
    # each package loads the other's final/
    jcfg, from_port = jax_model.from_pretrained(str(tmp_path / "port" / "final"))
    assert_params_close(jax.tree.map(np.asarray, from_port), jax_final,
                        key_bias_bar=2 * hp.learning_rate * 3)
    from_jax = repconc_model.from_pretrained(str(tmp_path / "jax" / "final"),
                                             device="cpu")
    assert_params_close(to_jax_params(from_jax), to_jax_params(model),
                        key_bias_bar=2 * hp.learning_rate * 3)
    # the key biases' steps change no output
    b = batches[0]
    want_emb = np.asarray(jax_model.encode_continuous(
        jcfg, jax_final, jnp.asarray(b["pos_input_ids"]),
        jnp.asarray(b["pos_attention_mask"])))
    with torch.no_grad():
        got_emb = model.encode_continuous(torch.as_tensor(b["pos_input_ids"]),
                                          torch.as_tensor(b["pos_attention_mask"]))
    np.testing.assert_allclose(got_emb.numpy(), want_emb, rtol=1e-5, atol=1e-5)


def test_train_resumes_and_saves_before_eval(toy_train, tmp_path, monkeypatch):
    """tests/test_stage1.py:178-243 on the port: a run resumes where its
    state stands and stops at once; when a save is due at an eval step the
    state is on disk before the eval runs; an unreadable state restarts
    from step 0."""
    t = toy_train
    hp = stage1.Stage1Hparams(total_steps=4, logging_steps=2, save_steps=2,
                              use_constraint=False)
    model = port_model(t["config"], t["params"])
    out = stage1.train(model, iter(_port_batches(t, 6)), hp, str(tmp_path / "a"),
                       device="cpu")
    assert out["step"] == 4 and len(out["history"]) == 2
    assert (tmp_path / "a" / "final" / "params.msgpack").exists()
    before = to_jax_params(model)
    out2 = stage1.train(port_model(t["config"], t["params"]),
                        iter(_port_batches(t, 6)), hp, str(tmp_path / "a"),
                        device="cpu")
    assert out2["step"] == 4 and out2["history"] == []
    assert_params_close(to_jax_params(out2["model"]), before, key_bias_bar=0)

    from repconc_tpu_torch.eval import pipeline

    def wedged_eval(*a, **k):
        raise RuntimeError("simulated wedged eval")

    monkeypatch.setattr(pipeline, "evaluate_repconc_model", wedged_eval)
    hp_eval = stage1.Stage1Hparams(total_steps=4, logging_steps=0, eval_steps=2,
                                   save_steps=2, use_constraint=False)
    with pytest.raises(RuntimeError, match="simulated"):
        stage1.train(port_model(t["config"], t["params"]),
                     iter(_port_batches(t, 6)), hp_eval, str(tmp_path / "b"),
                     valid_set=t["valid"], device="cpu")
    meta = json.load(open(tmp_path / "b" / "checkpoint" / "trainer_meta.json"))
    assert meta["step"] == 2  # saved AT the eval step, before the eval ran
    assert (tmp_path / "b" / "checkpoint" / stage1.STATE_NAME).exists()

    (tmp_path / "a" / "checkpoint" / stage1.STATE_NAME).write_bytes(b"\x93trunc")
    out3 = stage1.train(port_model(t["config"], t["params"]),
                        iter(_port_batches(t, 6)), hp, str(tmp_path / "a"),
                        device="cpu")
    assert out3["step"] == 4 and len(out3["history"]) == 2  # from step 0


def test_resume_continues_the_same_run(toy_train, tmp_path):
    """Two steps, a stop, two more steps from the saved state: the same
    parameters as four steps at once (the optimizer's moments, its update
    count and the dropout seeds come back)."""
    t = toy_train
    cfg = PortConfig(**t["config"].to_dict())
    cfg.encoder.hidden_dropout = 0.1
    batches = _port_batches(t, 4)
    hp = dict(learning_rate=1e-3, logging_steps=0, save_steps=2,
              warmup_steps=1)
    whole = from_jax_params(cfg, t["params"])
    stage1.train(whole, iter(batches), stage1.Stage1Hparams(total_steps=4, **hp),
                 str(tmp_path / "whole"), device="cpu")
    split = from_jax_params(cfg, t["params"])
    stage1.train(split, iter(batches[:2]),
                 stage1.Stage1Hparams(total_steps=4, **hp),
                 str(tmp_path / "split"), device="cpu")
    resumed = from_jax_params(cfg, t["params"])
    out = stage1.train(resumed, iter(batches[2:]),
                       stage1.Stage1Hparams(total_steps=4, **hp),
                       str(tmp_path / "split"), device="cpu")
    assert out["step"] == 4
    for (n, a), (_, b) in zip(whole.state_dict().items(),
                              resumed.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)


def test_stage0_trains_and_its_validation_is_not_ported(toy_train, tmp_path):
    t = toy_train
    model = port_model(t["config"], t["params"])
    hp = stage1.Stage1Hparams(quantize=False, total_steps=2, logging_steps=1)
    before = model.centroids.detach().clone()
    out = stage1.train(model, iter(_port_batches(t, 2)), hp, str(tmp_path),
                       device="cpu")
    assert out["step"] == 2 and np.isfinite(out["history"][-1]["loss"])
    assert "w_conc_rmse" not in out["history"][-1]
    torch.testing.assert_close(model.centroids.detach(), before)
    # its validation is the dense flat search: the logged metrics equal the
    # JAX package's evaluate_dense_model on the same weights
    logs = []
    stage1.train(model, iter(_port_batches(t, 2)),
                 stage1.Stage1Hparams(quantize=False, eval_steps=2,
                                      total_steps=2, logging_steps=0),
                 str(tmp_path / "v"), tokenizer=t["tok"], valid_set=t["valid"],
                 log_fn=logs.append, device="cpu")
    from repconc_tpu.eval.pipeline import evaluate_dense_model
    from repconc_tpu_torch.models.convert import to_jax_params

    want = evaluate_dense_model(t["config"], to_jax_params(model), t["tok"],
                                *t["valid"], max_seq_length=512, topk=10)
    assert logs == [{"step": 2, **{f"eval_{k}": v for k, v in want.items()}}]
    assert (tmp_path / "v" / "best" / "params.msgpack").exists()


# -- the CLI ------------------------------------------------------------------


def test_cli_trains_and_jax_loads_its_dirs(toy_train, toy_model_dir, tmp_path):
    from repconc_tpu_torch.cli import run_train_conc

    t = toy_train
    d = t["dir"]
    corpus, queries, qrels = t["valid"]
    vd = tmp_path / "valid"
    vd.mkdir()
    with open(vd / "corpus.tsv", "w") as f:
        f.writelines(f"{k}\t{v}\n" for k, v in corpus.items())
    with open(vd / "queries.tsv", "w") as f:
        f.writelines(f"{k}\t{v}\n" for k, v in queries.items())
    with open(vd / "qrels.tsv", "w") as f:
        f.writelines(f"{q} 0 {doc} 1\n" for q, r in qrels.items() for doc in r)
    out_dir = tmp_path / "out"
    argv = ["--model_name_or_path", toy_model_dir,
            "--qrel_path", str(d / "qrels.tsv"),
            "--query_path", str(d / "queries.tsv"),
            "--corpus_path", str(d / "corpus.tsv"),
            "--valid_qrel_path", str(vd / "qrels.tsv"),
            "--valid_query_path", str(vd / "queries.tsv"),
            "--valid_corpus_path", str(vd / "corpus.tsv"),
            "--output_dir", str(out_dir), "--per_device_train_batch_size", "8",
            "--max_steps", "4", "--eval_steps", "2", "--save_steps", "2",
            "--logging_steps", "2", "--learning_rate", "1e-3",
            "--sk_iters", "20", "--device", "cpu"]
    out = run_train_conc.main(argv)
    assert out["step"] == 4 and out["best_metric"] >= 0.0
    for name in ("best", "final"):
        cfg, params = jax_model.from_pretrained(str(out_dir / name))
        assert cfg.sk_iters == 20
        assert params["centroids"].shape == (8, 32, 4)
        assert (out_dir / name / "vocab.txt").exists()
    meta = json.load(open(out_dir / "checkpoint" / "trainer_meta.json"))
    assert meta["step"] == 4
    with pytest.raises(NotImplementedError, match="item 10"):
        run_train_conc.main(argv[:-2] + ["--data_parallel"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # the default device is the card
            run_train_conc.main(argv[:-2])
