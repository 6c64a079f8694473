"""The port's stage-2 (JPQ) trainer against repconc_tpu.train.stage2 on the
CPU: one step through either search branch, the retrieved-positive mask,
k > N, whole training runs of both packages over the same batches, resume,
and the CLI.

Tolerances, as tests/test_torch_stage1.py holds stage 1: losses within
1e-5 relative; each gradient array within 1e-4 of its own largest |g|;
parameters after a step within 1e-6 absolute at the CLI's learning rates
(5e-6 for the encoder, 2e-4 for the centroids), the attention key biases
(a gradient that is zero in exact arithmetic) within 2 lr per update.
The retrieved ids are equal. Doc codes are drawn as distinct rows, so no
two docs tie on their score by sharing their codes, and every comparison
runs with dropout 0 (the packages' dropout generators differ)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from repconc_tpu.core.config import EncoderConfig, RepConcConfig
from repconc_tpu.index import adc as jax_adc
from repconc_tpu.index import pallas_adc
from repconc_tpu.models import repconc_model as jax_model
from repconc_tpu.train import stage1 as jax_stage1
from repconc_tpu.train import stage2 as jax_stage2
from repconc_tpu_torch.core.config import RepConcConfig as PortConfig
from repconc_tpu_torch.index.adc import plain_topk
from repconc_tpu_torch.models import repconc_model
from repconc_tpu_torch.models.convert import from_jax_params, to_jax_params
from repconc_tpu_torch.train import stage1, stage2
from test_torch_eval import make_corpus, toy_model_dir  # noqa: F401
from test_torch_stage1 import (assert_grads_close, assert_params_close,
                               port_grads)

TINY_ENC = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=64, hidden_dropout=0.0,
                attention_dropout=0.0)
M, K = 4, 32  # K=32: the smallest K JAX's kernel branch takes at M=4


def tiny(metric="METRIC_IP"):
    cfg = RepConcConfig(encoder=EncoderConfig(**TINY_ENC), MCQ_M=M, MCQ_K=K,
                        similarity_metric=metric)
    params = jax.tree.map(np.asarray,
                          jax_model.init_params(cfg, jax.random.key(1)))
    return cfg, params


def port_model(cfg, params):
    return from_jax_params(PortConfig(**cfg.to_dict()), params)


def distinct_codes(rng, n, m=M, k=K):
    """n distinct (m,) code rows: no two docs share a score by sharing
    their codes."""
    flat = rng.choice(k ** m, size=n, replace=False)
    return np.stack([(flat // k ** j) % k for j in range(m)],
                    1).astype(np.uint8)


def make_query_batch(rng, n_docs, B=8, Lq=8, P=4):
    """tests/test_stage2.py's batch, with a padded query row and a second
    judged positive for half the queries."""
    ids = rng.integers(4, 64, size=(B, Lq)).astype(np.int32)
    mask = np.ones((B, Lq), dtype=np.int32)
    ids[0, Lq // 2:], mask[0, Lq // 2:] = 0, 0
    pos = rng.choice(n_docs, size=B, replace=False).astype(np.int32)
    positives = np.full((B, P), -1, dtype=np.int32)
    positives[:, 0] = pos
    positives[::2, 1] = rng.integers(0, n_docs, size=(B + 1) // 2)
    return {"query_input_ids": ids, "query_attention_mask": mask,
            "qids": np.arange(B, dtype=np.int32), "pos_docids": pos,
            "query_positives": positives}


def torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def jax_step(cfg, params, hp, codes, batch):
    """One step of the JAX package; returns (params, raw gradients,
    metrics, the retrieved ids). The ids come from the same functions the
    step's `retrieve` calls (stage2.py:118-137) on the same embeddings."""
    record = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    tx = optax.chain(record, jax_stage1.make_optimizer(hp.as_stage1(), params))
    step_fn, codes_dev = jax_stage2.make_train_step(cfg, hp, tx, codes)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp, state, metrics, _ = jax.jit(step_fn)(params, tx.init(params), jb,
                                             jax.random.key(0), codes_dev)
    q = jax_model.encode_continuous(cfg, params, jb["query_input_ids"],
                                    jb["query_attention_mask"])
    lut = jax_adc.build_lut(q, params["centroids"])
    N, k = codes.shape[0], hp.dynamic_topk_negative
    if hp.use_pallas_search:
        gm = pallas_adc._group_size(M, K)
        perm = pallas_adc.permute_lut(lut, gm).astype(jnp.bfloat16)
        perm = jnp.pad(perm, ((0, (-q.shape[0]) % pallas_adc.QUERY_TILE),
                              (0, 0)))
        ids = pallas_adc._search_device(perm, codes_dev, N, k, K,
                                        codes_dev.shape[0], False)[1]
    else:
        ids = jax.lax.approx_max_k(jax_adc.score_codes(lut, codes_dev), k,
                                   recall_target=1.0)[1]
    return (jax.tree.map(np.asarray, jp), state[0], metrics,
            np.asarray(ids)[:q.shape[0]])


def port_step(cfg, params, hp, codes, batch):
    """One step of the port from the same parameters: (model after the
    step, gradients before the clip, metrics, the step's aux)."""
    model = port_model(cfg, params)
    phs = stage2.Stage2Hparams(**hp.__dict__)
    codes_t = torch.as_tensor(codes)
    use_kernel = stage2.takes_kernel(phs.use_pallas_search, "cpu")
    loss, _, aux = stage2.loss_fn(model, phs, torch_batch(batch), codes_t,
                                  len(codes), use_kernel)
    loss.backward()
    grads = port_grads(model)
    tx = stage1.make_optimizer(phs.as_stage1(), model)
    metrics = stage2.make_train_step(model, phs, tx, codes_t)(
        torch_batch(batch))
    return model, grads, metrics, aux


# -- one train step -----------------------------------------------------------


@pytest.mark.parametrize("metric", ["METRIC_IP", "METRIC_CENTROID_COS"])
def test_train_step_matches_jax(metric):
    """use_pallas_search=False in both packages (the plain fp32 scorer and
    JAX's XLA branch): the same retrieved ids, the loss, grad_norm, each
    gradient array and the parameters after the update (with the
    CENTROID_COS renormalisation)."""
    cfg, params = tiny(metric)
    rng = np.random.default_rng(3)
    codes = distinct_codes(rng, 200)
    batch = make_query_batch(rng, 200)
    hp = jax_stage2.Stage2Hparams(dynamic_topk_negative=16, total_steps=10,
                                  use_pallas_search=False)
    jp, jgrads, jmetrics, jids = jax_step(cfg, params, hp, codes, batch)
    model, grads, metrics, aux = port_step(cfg, params, hp, codes, batch)
    np.testing.assert_array_equal(aux["neg_pids"].numpy(), jids)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, err_msg=k)
    assert_grads_close(grads, jgrads)
    assert_params_close(to_jax_params(model), jp,
                        key_bias_bar=2 * hp.learning_rate)
    assert float(np.abs(grads[("centroids",)]).max()) > 0  # decode's gradient
    if metric == "METRIC_CENTROID_COS":
        np.testing.assert_allclose(
            model.centroids.detach().norm(dim=-1).numpy(), 1.0, rtol=1e-5)


def test_kernel_branch_matches_jax_interpret():
    """use_pallas_search=True: on the CPU the port runs the plain versions
    of K1's two passes over the bf16 LUT, JAX its Pallas kernel in
    interpret mode. N = 300 is no multiple of 128 (JAX pads the codes to
    its doc tile) and B = 5 no multiple of JAX's query tile: the same ids,
    all below N, and the same loss."""
    cfg, params = tiny()
    rng = np.random.default_rng(4)
    codes = distinct_codes(rng, 300)
    batch = make_query_batch(rng, 300, B=5)
    hp = jax_stage2.Stage2Hparams(dynamic_topk_negative=8, total_steps=10,
                                  use_pallas_search=True)
    _, _, jmetrics, jids = jax_step(cfg, params, hp, codes, batch)
    _, _, metrics, aux = port_step(cfg, params, hp, codes, batch)
    ids = aux["neg_pids"].numpy()
    assert ids.shape == (5, 8) and (ids < 300).all()
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                               rtol=1e-5)


def test_retrieved_positives_are_masked_as_jax_masks_them():
    """A batch whose judged positives are among the retrieved docs: the
    port's mask counts exactly the overlap of the ids with the positives,
    and the loss equals JAX's, which applies the same mask."""
    cfg, params = tiny()
    rng = np.random.default_rng(5)
    codes = distinct_codes(rng, 96)
    batch = make_query_batch(rng, 96)
    hp = jax_stage2.Stage2Hparams(dynamic_topk_negative=24, total_steps=10,
                                  use_pallas_search=False)
    # the positives: each query's best, fourth and (for half) 30th doc, so
    # two of them are retrieved and the sampled one is the best
    ids = stage2.retrieve(
        port_model(cfg, params).encode_continuous(
            torch.as_tensor(batch["query_input_ids"]),
            torch.as_tensor(batch["query_attention_mask"])),
        torch.tensor(params["centroids"]), torch.as_tensor(codes), 96, 96,
        False).numpy()
    batch["pos_docids"] = ids[:, 0].astype(np.int32)
    batch["query_positives"][:, 0] = ids[:, 0]
    batch["query_positives"][:, 1] = ids[:, 3]
    batch["query_positives"][::2, 2] = ids[::2, 30]
    _, _, jmetrics, jids = jax_step(cfg, params, hp, codes, batch)
    _, _, metrics, aux = port_step(cfg, params, hp, codes, batch)
    got = aux["neg_pids"].numpy()
    np.testing.assert_array_equal(got, jids)
    overlap = [len(set(row) & {p for p in pos if p >= 0})
               for row, pos in zip(got, batch["query_positives"])]
    assert overlap == [2] * 8
    assert aux["masked"].sum(1).tolist() == overlap
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                               rtol=1e-5)


def test_k_above_n_raises_as_jax_does():
    """k > N: JAX's default CPU branch (XLA) raises ValueError, and so does
    the port, in every branch and before any step; k = N retrieves every
    doc once."""
    cfg, params = tiny()
    rng = np.random.default_rng(6)
    codes = distinct_codes(rng, 20)
    batch = make_query_batch(rng, 20, B=3)
    hp = jax_stage2.Stage2Hparams(dynamic_topk_negative=21, total_steps=1)
    with pytest.raises(ValueError):
        jax_step(cfg, params, hp, codes, batch)
    model = port_model(cfg, params)
    for use in (None, False, True):
        phs = stage2.Stage2Hparams(dynamic_topk_negative=21,
                                   use_pallas_search=use)
        tx = stage1.make_optimizer(phs.as_stage1(), model)
        with pytest.raises(ValueError, match="dynamic_topk_negative"):
            stage2.make_train_step(model, phs, tx, torch.as_tensor(codes))
    for use in (False, True):
        ids = stage2.retrieve(torch.randn(3, 32), model.centroids,
                              torch.as_tensor(codes), 20, 20, use)
        assert sorted(ids[0].tolist()) == list(range(20))


def test_search_dispatch():
    """None: the kernel on a CUDA device, the plain scorer on the CPU; an
    explicit True or False holds everywhere. The plain scorer's chunks
    merge to the one-chunk top-k."""
    assert stage2.takes_kernel(None, "cuda") and stage2.takes_kernel(True, "cpu")
    assert not stage2.takes_kernel(None, "cpu")
    assert not stage2.takes_kernel(False, "cuda")
    g = torch.Generator().manual_seed(0)
    lut = torch.randn((5, M, K), generator=g)
    codes = torch.as_tensor(distinct_codes(np.random.default_rng(7), 1000))
    whole = plain_topk(lut, codes, 997, 40, chunk_size=1 << 20)
    chunked = plain_topk(lut, codes, 997, 40, chunk_size=64)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])
    assert int(whole[1].max()) < 997


# -- whole training runs ------------------------------------------------------


@pytest.fixture(scope="module")
def toy_jpq(tmp_path_factory, toy_model_dir):
    """Stage-2 training files over the toy corpus of tests/test_torch_eval.py
    (a query is the start of its doc, judged relevant to it and, for a
    third of the queries, to the next doc too), distinct random codes for
    the corpus in an order that is not the qrels' (M=8, K=32: the toy
    model's), a validation set, and the toy model with dropout 0."""
    from transformers import AutoTokenizer

    rng = np.random.default_rng(12)
    corpus = make_corpus(rng, n=120)
    d = tmp_path_factory.mktemp("jpq_data")
    with open(d / "queries.tsv", "w") as f:
        f.writelines(f"q{i}\t{' '.join(corpus[f'd{i}'].split()[:3])}\n"
                     for i in range(0, 120, 2))
    with open(d / "qrels.tsv", "w") as f:
        f.writelines(f"q{i} 0 d{i} 1\n" + (f"q{i} 0 d{i + 1} 1\n"
                                          if i % 3 == 0 else "")
                     for i in range(0, 120, 2))
    corpus_ids = np.array([f"d{i}" for i in rng.permutation(120)])
    codes = distinct_codes(rng, 120, m=8, k=32)
    queries = {f"v{i}": " ".join(corpus[f"d{i}"].split()[:4])
               for i in range(1, 120, 6)}
    valid = (corpus_ids, queries, {q: {f"d{q[1:]}": 1} for q in queries})
    config, params = jax_model.from_pretrained(toy_model_dir)
    config.encoder.hidden_dropout = config.encoder.attention_dropout = 0.0
    return dict(dir=d, corpus_ids=corpus_ids, codes=codes, valid=valid,
                config=config, params=jax.tree.map(np.asarray, params),
                tok=AutoTokenizer.from_pretrained(toy_model_dir))


def _batches(t, n, batch_size=8):
    from repconc_tpu_torch.train.data import (QueryCollator, QueryDataset,
                                              batch_iterator)

    d = t["dir"]
    ds = QueryDataset(str(d / "qrels.tsv"), str(d / "queries.tsv"),
                      t["corpus_ids"])
    it = batch_iterator(ds, QueryCollator(t["tok"], 8), batch_size, seed=3)
    return [b for _, b in zip(range(n), it)]


def test_train_matches_jax(toy_jpq, tmp_path):
    """Both trainers over the same 3 batches, validation at step 2, saves
    every 2 steps: the same logged losses and norms, the same best metric,
    final parameters within the bars, and each package loads the other's
    final/ and best/."""
    t = toy_jpq
    hp = jax_stage2.Stage2Hparams(total_steps=3, logging_steps=1, eval_steps=2,
                                  save_steps=2, dynamic_topk_negative=20)
    batches = _batches(t, 3)
    want = jax_stage2.train(t["config"], t["params"], t["codes"], iter(batches),
                            hp, str(tmp_path / "jax"), tokenizer=t["tok"],
                            valid_set=t["valid"])
    model = port_model(t["config"], t["params"])
    logs = []
    got = stage2.train(model, t["codes"], iter(batches),
                       stage2.Stage2Hparams(**hp.__dict__),
                       str(tmp_path / "port"), tokenizer=t["tok"],
                       valid_set=t["valid"], log_fn=logs.append, device="cpu")
    assert got["step"] == want["step"] == 3
    assert [h["step"] for h in got["history"]] == [1, 2, 3]
    for g, w in zip(got["history"], want["history"]):
        assert g.keys() == w.keys() == {"loss", "grad_norm", "step"}
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    assert [m["step"] for m in logs if "eval_MRR@10" in m] == [2]
    assert got["best_metric"] == want["best_metric"] >= 0.0
    bar = 2 * hp.learning_rate * 3
    jax_final = jax.tree.map(np.asarray, want["params"])
    assert_params_close(to_jax_params(model), jax_final, key_bias_bar=bar)
    for name in ("best", "final"):
        assert (tmp_path / "port" / name / "vocab.txt").exists()
        _, from_port = jax_model.from_pretrained(str(tmp_path / "port" / name))
        _, from_jax = jax_model.from_pretrained(str(tmp_path / "jax" / name))
        assert_params_close(jax.tree.map(np.asarray, from_port),
                            jax.tree.map(np.asarray, from_jax),
                            key_bias_bar=bar)
    ported = repconc_model.from_pretrained(str(tmp_path / "jax" / "final"),
                                           device="cpu")
    assert_params_close(to_jax_params(ported), to_jax_params(model),
                        key_bias_bar=bar)


def test_train_resumes_saves_and_restarts(toy_jpq, tmp_path):
    """A run resumes where its state stands and stops at once; the state is
    written every save_steps (a run killed after step 2 left step 2); an
    unreadable state restarts from step 0."""
    t = toy_jpq
    hp = stage2.Stage2Hparams(total_steps=4, logging_steps=2, save_steps=2,
                              dynamic_topk_negative=10)
    model = port_model(t["config"], t["params"])
    out = stage2.train(model, t["codes"], iter(_batches(t, 6)), hp,
                       str(tmp_path / "a"), device="cpu")
    assert out["step"] == 4 and len(out["history"]) == 2
    assert (tmp_path / "a" / "final" / "params.msgpack").exists()
    again = stage2.train(port_model(t["config"], t["params"]), t["codes"],
                         iter(_batches(t, 6)), hp, str(tmp_path / "a"),
                         device="cpu")
    assert again["step"] == 4 and again["history"] == []
    assert_params_close(to_jax_params(again["model"]), to_jax_params(model),
                        key_bias_bar=0)

    def killed_after_two():
        yield from _batches(t, 2)
        raise RuntimeError("simulated kill")

    with pytest.raises(RuntimeError, match="simulated"):
        stage2.train(port_model(t["config"], t["params"]), t["codes"],
                     killed_after_two(), hp, str(tmp_path / "b"), device="cpu")
    meta = json.load(open(tmp_path / "b" / "checkpoint" / "trainer_meta.json"))
    assert meta["step"] == 2 and meta["backend"] == "torch"

    (tmp_path / "a" / "checkpoint" / stage1.STATE_NAME).write_bytes(b"\x93trunc")
    fresh = stage2.train(port_model(t["config"], t["params"]), t["codes"],
                         iter(_batches(t, 6)), hp, str(tmp_path / "a"),
                         device="cpu")
    assert fresh["step"] == 4 and len(fresh["history"]) == 2  # from step 0
    with pytest.raises(NotImplementedError, match="item 10"):
        stage2.train(model, t["codes"], iter([]), hp, str(tmp_path / "c"),
                     mesh=object(), device="cpu")


def test_resume_continues_the_same_run(toy_jpq, tmp_path):
    """With dropout on: two steps, a stop, two more from the saved state
    give the parameters of four steps at once (the optimizer's moments, its
    count and the dropout seeds come back)."""
    t = toy_jpq
    cfg = PortConfig(**t["config"].to_dict())
    cfg.encoder.hidden_dropout = 0.1
    batches = _batches(t, 4)
    hp = dict(learning_rate=1e-3, logging_steps=0, save_steps=2,
              warmup_steps=1, dynamic_topk_negative=10, total_steps=4)
    whole = from_jax_params(cfg, t["params"])
    stage2.train(whole, t["codes"], iter(batches), stage2.Stage2Hparams(**hp),
                 str(tmp_path / "whole"), device="cpu")
    split = from_jax_params(cfg, t["params"])
    stage2.train(split, t["codes"], iter(batches[:2]),
                 stage2.Stage2Hparams(**hp), str(tmp_path / "split"),
                 device="cpu")
    resumed = from_jax_params(cfg, t["params"])
    out = stage2.train(resumed, t["codes"], iter(batches[2:]),
                       stage2.Stage2Hparams(**hp), str(tmp_path / "split"),
                       device="cpu")
    assert out["step"] == 4
    for (n, a), (_, b) in zip(whole.state_dict().items(),
                              resumed.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)


# -- the CLI ------------------------------------------------------------------


@pytest.mark.parametrize("index_from", ["numpy", "run_repconc_eval"])
def test_cli_trains_and_jax_loads_its_dirs(toy_jpq, toy_model_dir, tmp_path,
                                           index_from):
    """run_train_jpq --device cpu on the toy model dir, over an --index_dir
    of codes.npy + corpus_ids.npy written with numpy or by the port's
    run_repconc_eval; the JAX package loads its best/ and final/. The
    default device is the card, and --data_parallel raises."""
    from repconc_tpu_torch.cli import run_repconc_eval, run_train_jpq

    t = toy_jpq
    d = t["dir"]
    index_dir = tmp_path / "index"
    if index_from == "numpy":
        index_dir.mkdir()
        np.save(index_dir / "codes.npy", t["codes"])
        np.save(index_dir / "corpus_ids.npy", t["corpus_ids"])
    else:
        corpus = make_corpus(np.random.default_rng(12), n=120)
        with open(d / "corpus.tsv", "w") as f:
            f.writelines(f"{k}\t{v}\n" for k, v in corpus.items())
        run_repconc_eval.main([
            "--model_name_or_path", toy_model_dir, "--max_seq_length", "32",
            "--corpus_path", str(d / "corpus.tsv"),
            "--query_path", str(d / "queries.tsv"),
            "--out_corpus_dir", str(index_dir),
            "--out_query_dir", str(tmp_path / "q"), "--topk", "10",
            "--device", "cpu"])
    vq = tmp_path / "valid_queries.tsv"
    vq.write_text("".join(f"{k}\t{v}\n" for k, v in t["valid"][1].items()))
    vr = tmp_path / "valid_qrels.tsv"
    vr.write_text("".join(f"{q} 0 {doc} 1\n" for q, r in t["valid"][2].items()
                          for doc in r))
    out_dir = tmp_path / "out"
    argv = ["--model_name_or_path", toy_model_dir,
            "--index_dir", str(index_dir),
            "--qrel_path", str(d / "qrels.tsv"),
            "--query_path", str(d / "queries.tsv"),
            "--valid_qrel_path", str(vr), "--valid_query_path", str(vq),
            "--output_dir", str(out_dir), "--per_device_train_batch_size", "8",
            "--max_steps", "4", "--eval_steps", "2", "--save_steps", "2",
            "--logging_steps", "2", "--dynamic_topk_negative", "10",
            "--learning_rate", "1e-3", "--device", "cpu"]
    out = run_train_jpq.main(argv)
    assert out["step"] == 4 and 0.0 <= out["best_metric"] <= 1.0
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    for name in ("best", "final"):
        cfg, params = jax_model.from_pretrained(str(out_dir / name))
        assert params["centroids"].shape == (8, 32, 4)
        assert (out_dir / name / "vocab.txt").exists()
    meta = json.load(open(out_dir / "checkpoint" / "trainer_meta.json"))
    assert meta["step"] == 4
    with pytest.raises(NotImplementedError, match="item 10"):
        run_train_jpq.main(argv[:-2] + ["--data_parallel"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # the default device is the card
            run_train_jpq.main(argv[:-2])


def test_cli_epochs_set_the_step_count(toy_jpq, toy_model_dir, tmp_path):
    """--num_train_epochs as the JAX CLI counts it (run_train_jpq.py:74-80):
    epochs x (queries // batch), at least 1."""
    from repconc_tpu_torch.cli import run_train_jpq

    t = toy_jpq
    index_dir = tmp_path / "index"
    index_dir.mkdir()
    np.save(index_dir / "codes.npy", t["codes"])
    np.save(index_dir / "corpus_ids.npy", t["corpus_ids"])
    base = ["--model_name_or_path", toy_model_dir, "--index_dir",
            str(index_dir), "--qrel_path", str(t["dir"] / "qrels.tsv"),
            "--query_path", str(t["dir"] / "queries.tsv"),
            "--per_device_train_batch_size", "16", "--logging_steps", "0",
            "--dynamic_topk_negative", "10", "--device", "cpu"]
    # 60 queries // 16 = 3 steps an epoch
    out = run_train_jpq.main(base + ["--output_dir", str(tmp_path / "a"),
                                     "--num_train_epochs", "1.5"])
    assert out["step"] == 4
    out = run_train_jpq.main(base + ["--output_dir", str(tmp_path / "b"),
                                     "--num_train_epochs", "0.01"])
    assert out["step"] == 1
