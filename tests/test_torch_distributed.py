"""The port's process groups (repconc_tpu_torch/core/{distributed,mesh}.py)
and data-parallel training and eval, on the CPU under gloo.

Two real processes join through the REPCONC_* env contract, as
tests/test_distributed.py runs the JAX package: this file, run as a
script, is the worker. The workers are launched once for the module; each
test reads what they wrote. Held against the port's one-process result
and the JAX package:

  * one stage-1 step (GradCache chunks of 4 rows, the Sinkhorn
    constraint across the ranks), with dropout 0 and with dropout through
    the one-process masks, and one stage-0 step; one stage-2 step;
  * run_train_conc --data_parallel (rank 0 alone writes; JAX loads
    final/) and run_repconc_eval --data_parallel, flat and IVF.

The bars are tests/test_torch_stage1.py's step bars: losses within 1e-5
relative, each gradient array within 1e-4 of its own largest |g|,
parameters within 1e-6 (the attention key biases, zero in exact
arithmetic, within 2 lr). Both ranks end every step with bit-identical
parameters. The one-process tests cover the env contract, process_slice,
create_mesh and a rendezvous that cannot complete.
"""
from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from repconc_tpu_torch.core import distributed  # noqa: E402
from repconc_tpu_torch.core.mesh import create_mesh  # noqa: E402

if __name__ != "__main__":  # the worker imports nothing of JAX
    from test_torch_eval import toy_model_dir  # noqa: F401

WORLD = 2
ENV_KEYS = (distributed.ENV_COORDINATOR, distributed.ENV_NUM_PROCESSES,
            distributed.ENV_PROCESS_ID)
TINY_ENC = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=64)
STAGE1_CASES = {  # name: (hparams, dropout)
    "constraint": (dict(use_constraint=True, mse_loss_weight=0.1,
                        cache_chunk_size=4), 0.0),
    "dropout": (dict(use_constraint=True, cache_chunk_size=4), 0.1),
    "dense": (dict(quantize=False, cache_chunk_size=4), 0.0),
}
STAGE2_CASES = {"plain": False, "passes": True}  # use_pallas_search
WORKER_TIMEOUT = 240.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def contract_env(world: int, rank: int, port: int) -> dict:
    return {distributed.ENV_COORDINATOR: f"127.0.0.1:{port}",
            distributed.ENV_NUM_PROCESSES: str(world),
            distributed.ENV_PROCESS_ID: str(rank)}


@contextlib.contextmanager
def world1_mesh():
    """A world-1 gloo process group joined through the env contract in
    this process, torn down (and the env restored) on exit."""
    old = {k: os.environ.get(k) for k in ENV_KEYS}
    os.environ.update(contract_env(1, 0, free_port()))
    try:
        mesh = create_mesh("cpu")
        yield mesh
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def launch(script: str, workdir: str, world: int = WORLD,
           timeout: float = WORKER_TIMEOUT):
    """Run `script workdir` as `world` ranks under the env contract; every
    wait has a timeout, and a failure or a timeout kills every rank. Each
    rank takes two threads: ranks whose idle threads spin slow every
    collective of the other down."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="2",
                   **contract_env(world, rank, port))
        procs.append(subprocess.Popen(
            [sys.executable, script, workdir], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-6000:]}"
    return outs


# -- inputs, made from seeds by the test and the workers alike ---------------


def stage1_batch(B=8, n_neg=2, Lq=8, Ld=12):
    """tests/test_torch_stage1.py's batch (a padded row, a duplicate
    negative), numpy only."""
    rng = np.random.default_rng(2)

    def tok(rows, L):
        ids = rng.integers(4, 64, size=(rows, L)).astype(np.int32)
        mask = np.ones((rows, L), dtype=np.int32)
        mask[0, L // 2:], ids[0, L // 2:] = 0, 0
        return ids, mask

    q_ids, q_mask = tok(B, Lq)
    p_ids, p_mask = tok(B, Ld)
    n_ids, n_mask = tok(B * n_neg, Ld)
    pos = np.arange(B, dtype=np.int32)
    positives = np.full((B, 4), -1, dtype=np.int32)
    positives[:, 0] = pos
    neg = rng.integers(B, 100, size=(B * n_neg,)).astype(np.int32)
    neg[1] = neg[0]
    return {"query_input_ids": q_ids, "query_attention_mask": q_mask,
            "pos_input_ids": p_ids, "pos_attention_mask": p_mask,
            "neg_input_ids": n_ids, "neg_attention_mask": n_mask,
            "qids": np.arange(B, dtype=np.int32), "pos_docids": pos,
            "neg_docids": neg, "query_positives": positives}


def stage2_inputs(n_docs=300, M=4, K=32, B=8, Lq=8):
    """Distinct doc codes (no two docs tie by sharing codes) and a query
    batch with a padded row and second positives."""
    rng = np.random.default_rng(3)
    flat = rng.choice(K ** M, size=n_docs, replace=False)
    codes = np.stack([(flat // K ** j) % K for j in range(M)], 1).astype(
        np.uint8)
    ids = rng.integers(4, 64, size=(B, Lq)).astype(np.int32)
    mask = np.ones((B, Lq), dtype=np.int32)
    ids[0, Lq // 2:], mask[0, Lq // 2:] = 0, 0
    pos = rng.choice(n_docs, size=B, replace=False).astype(np.int32)
    positives = np.full((B, 4), -1, dtype=np.int32)
    positives[:, 0] = pos
    positives[::2, 1] = rng.integers(0, n_docs, size=(B + 1) // 2)
    return codes, {"query_input_ids": ids, "query_attention_mask": mask,
                   "qids": np.arange(B, dtype=np.int32), "pos_docids": pos,
                   "query_positives": positives}


def tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def grads_of(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().clone().numpy() for n, p in model.named_parameters()}


def params_of(model):
    return {n: p.detach().clone().numpy() for n, p in model.named_parameters()}


def stage1_step(model_dir, case, mesh=None):
    """One stage-1 step of the port from model_dir: the raw (summed)
    gradients, then the step's metrics and parameters."""
    from repconc_tpu_torch.core.distributed import all_reduce_grads
    from repconc_tpu_torch.models import repconc_model
    from repconc_tpu_torch.train import stage1

    extra, _ = STAGE1_CASES[case]
    hp = stage1.Stage1Hparams(total_steps=10, **extra)
    model = repconc_model.from_pretrained(model_dir, device="cpu")
    batch = tensors(stage1_batch())
    group = None if mesh is None else mesh.group
    seeds = torch.Generator().manual_seed(11)
    total, _ = stage1.loss_fn(model, hp, batch, seeds, mesh)
    total.backward()
    all_reduce_grads(list(model.parameters()), group)
    raw = grads_of(model)
    tx = stage1.make_optimizer(hp, model)
    metrics = stage1.make_train_step(model, hp, tx, mesh)(
        batch, torch.Generator().manual_seed(11))
    return raw, {k: float(v) for k, v in metrics.items()}, params_of(model)


def stage2_step(model_dir, case, mesh=None):
    """One stage-2 step of the port: raw gradients, metrics, parameters
    and this rank's retrieved ids."""
    from repconc_tpu_torch.core.distributed import all_reduce_grads
    from repconc_tpu_torch.models import repconc_model
    from repconc_tpu_torch.train import stage1, stage2

    hp = stage2.Stage2Hparams(total_steps=10, dynamic_topk_negative=20,
                              use_pallas_search=STAGE2_CASES[case])
    model = repconc_model.from_pretrained(model_dir, device="cpu")
    codes, batch = stage2_inputs()
    codes_t, batch = torch.as_tensor(codes), tensors(batch)
    group = None if mesh is None else mesh.group
    loss, _, aux = stage2.loss_fn(model, hp, batch, codes_t, len(codes),
                                  hp.use_pallas_search, None, mesh)
    loss.backward()
    all_reduce_grads(list(model.parameters()), group)
    raw = grads_of(model)
    tx = stage1.make_optimizer(hp.as_stage1(), model)
    metrics = stage2.make_train_step(model, hp, tx, codes_t, mesh=mesh)(batch)
    return (raw, {k: float(v) for k, v in metrics.items()},
            params_of(model), aux["neg_pids"].numpy())


def train_conc_argv(spec, out_dir):
    d = spec["data"]
    return ["--model_name_or_path", spec["toy_model_dir"],
            "--qrel_path", d["qrels"], "--query_path", d["queries"],
            "--corpus_path", d["corpus"], "--valid_qrel_path", d["qrels"],
            "--valid_query_path", d["queries"],
            "--valid_corpus_path", d["corpus"], "--output_dir", out_dir,
            "--per_device_train_batch_size", "8", "--cache_chunk_size", "4",
            "--max_steps", "2", "--eval_steps", "2", "--logging_steps", "1",
            "--sk_iters", "20", "--device", "cpu"]


def eval_argv(spec, out, extra=()):
    d = spec["data"]
    return ["--model_name_or_path", spec["toy_model_dir"],
            "--corpus_path", d["corpus"], "--query_path", d["queries"],
            "--qrel_path", d["qrels"], "--out_corpus_dir", out + "_c",
            "--out_query_dir", out + "_q", "--max_seq_length", "32",
            "--topk", "20", "--device", "cpu", *extra]


IVF_EVAL = ("--index_type", "ivf", "--nlist", "8", "--nprobe", "4")
RECIPE_FLAGS = ["--n_docs", "5003", "--queries", "24", "--topk", "50",
                "--nlist", "16", "--nprobe", "4", "--batch", "8",
                "--time_batch", "8", "--jpq_batch", "8", "--reps", "1"]


# -- the worker ---------------------------------------------------------------


def worker_main(workdir: str) -> None:
    from repconc_tpu_torch.cli import run_repconc_eval, run_train_conc
    from repconc_tpu_torch.recipes import multi_gpu_check
    from repconc_tpu_torch.train import stage1

    t0 = time.perf_counter()

    def tick(what):
        print(f"[rank {r}] {what} at {time.perf_counter() - t0:.2f} s",
              flush=True)

    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    mesh = create_mesh("cpu")
    r = mesh.rank
    tick("joined")
    out = {"backend": mesh.backend, "rank": r, "size": mesh.size,
           "slice": [distributed.process_slice(8).start,
                     distributed.process_slice(8).stop]}
    arrays = {}
    for case in STAGE1_CASES:
        raw, metrics, params = stage1_step(spec["stage1_dirs"][case], case,
                                           mesh)
        out[f"stage1_{case}"] = metrics
        arrays.update({f"stage1_{case}/raw/{k}": v for k, v in raw.items()})
        arrays.update({f"stage1_{case}/param/{k}": v
                       for k, v in params.items()})
    for case in STAGE2_CASES:
        raw, metrics, params, ids = stage2_step(spec["stage2_dir"], case, mesh)
        out[f"stage2_{case}"] = metrics
        arrays.update({f"stage2_{case}/raw/{k}": v for k, v in raw.items()})
        arrays.update({f"stage2_{case}/param/{k}": v
                       for k, v in params.items()})
        arrays[f"stage2_{case}/ids"] = ids
    tick("steps")

    writes = []  # rank 0 alone writes the trainer's dirs
    for name in ("save_model_dir", "save_train_state"):
        real = getattr(stage1, name)

        def counted(*a, _real=real, _name=name, **k):
            writes.append(_name)
            return _real(*a, **k)

        setattr(stage1, name, counted)
    res = run_train_conc.main(train_conc_argv(
        spec, os.path.join(workdir, "conc_dp")) + ["--data_parallel"])
    out["train_conc"] = {"step": res["step"], "best": res["best_metric"],
                         "writes": writes,
                         "history": res["history"]}
    arrays.update({f"train_conc/param/{k}": v
                   for k, v in params_of(res["model"]).items()})
    tick("run_train_conc")
    run_repconc_eval.main(eval_argv(spec, os.path.join(workdir, "eval_dp"))
                          + ["--data_parallel"])
    run_repconc_eval.main(eval_argv(spec, os.path.join(workdir, "ivf_dp"),
                                    IVF_EVAL) + ["--data_parallel"])
    tick("run_repconc_eval")
    np.savez(os.path.join(workdir, f"rank{r}.npz"), **arrays)
    with open(os.path.join(workdir, f"rank{r}.json"), "w") as f:
        json.dump(out, f)
    # last: the recipe ends with the process group
    multi_gpu_check.main(["--device", "cpu", "--tiny"] + RECIPE_FLAGS)
    tick("multi_gpu_check")


# -- the module's two ranks ---------------------------------------------------


def model_dir(root, name, dropout, M=4, K=16, seed=0):
    """A tiny model dir of seeded weights, written by the port (both
    packages load it): returns its path."""
    from repconc_tpu_torch.core.config import EncoderConfig, RepConcConfig
    from repconc_tpu_torch.models import repconc_model

    cfg = RepConcConfig(encoder=EncoderConfig(**TINY_ENC, hidden_dropout=dropout,
                                              attention_dropout=dropout),
                        MCQ_M=M, MCQ_K=K, sk_epsilon=0.05, sk_iters=20)
    model = repconc_model.init_random_(repconc_model.RepConcModel(cfg),
                                       torch.Generator().manual_seed(seed))
    path = os.path.join(root, name)
    repconc_model.save_pretrained(path, model)
    return path


def jax_loaded(path):
    """(config, params) of a model dir, as the JAX package loads it."""
    import jax

    from repconc_tpu.models import repconc_model as jax_model

    cfg, params = jax_model.from_pretrained(path)
    return cfg, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, toy_model_dir):
    """Both ranks' results, and what the test needs to hold them."""
    from test_torch_eval import make_corpus

    root = str(tmp_path_factory.mktemp("dist"))
    made = {case: model_dir(root, f"s1_{case}", dropout)
            for case, (_, dropout) in STAGE1_CASES.items()}
    s2 = model_dir(root, "s2", 0.0, K=32, seed=1)
    rng = np.random.default_rng(2022)
    corpus = make_corpus(rng, n=64)
    qids = [f"q{i}" for i in range(16)]
    targets = [f"d{i * 3}" for i in range(16)]
    data = {k: os.path.join(root, f"{k}.tsv")
            for k in ("corpus", "queries", "qrels")}
    with open(data["corpus"], "w") as f:
        f.writelines(f"{k}\t{v}\n" for k, v in corpus.items())
    with open(data["queries"], "w") as f:
        f.writelines(f"{q}\t{corpus[d]}\n" for q, d in zip(qids, targets))
    with open(data["qrels"], "w") as f:
        f.writelines(f"{q}\t0\t{d}\t1\n" for q, d in zip(qids, targets))
    spec = {"stage1_dirs": made, "stage2_dir": s2,
            "toy_model_dir": toy_model_dir,
            "data": data}
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(spec, f)
    outs = launch(os.path.abspath(__file__), root)
    recipe = [json.loads(line) for line in outs[0].splitlines()
              if line.startswith('{"part"')]
    results = []
    for r in range(WORLD):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            meta = json.load(f)
        results.append((meta, dict(np.load(os.path.join(root,
                                                         f"rank{r}.npz")))))
    return {"root": root, "spec": spec, "results": results,
            "recipe": recipe}


def _section(arrays, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in arrays.items() if k.startswith(prefix + "/")}


def test_ranks_joined_through_gloo(ranks):
    for r, (meta, _) in enumerate(ranks["results"]):
        assert (meta["backend"], meta["rank"], meta["size"]) == ("gloo", r, 2)
        assert meta["slice"] == [4 * r, 4 * r + 4]


def _assert_step_close(got_raw, got_m, got_p, want_raw, want_m, want_p, lr):
    """tests/test_torch_stage1.py's step bars, on named torch arrays."""
    top = max(float(np.abs(w).max()) for w in want_raw.values())
    for name, w in want_raw.items():
        key_bias = name.endswith("key.bias")
        bar = (1e-6 * top if key_bias
               else 1e-4 * max(float(np.abs(w).max()), 1e-12))
        np.testing.assert_allclose(got_raw[name], w, rtol=0, atol=bar,
                                   err_msg=name)
    for k, w in want_m.items():
        np.testing.assert_allclose(got_m[k], w, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for name, w in want_p.items():
        bar = 2 * lr if name.endswith("key.bias") else 1e-6
        np.testing.assert_allclose(got_p[name], w, rtol=0, atol=bar,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(STAGE1_CASES))
def test_stage1_step_matches_one_process(ranks, case):
    """The 2-rank step (rows split, chunk seeds drawn in the one-process
    order, the constraint across the ranks) equals the one-process step on
    the same global batch, dropout masks included."""
    raw, metrics, params = stage1_step(ranks["spec"]["stage1_dirs"][case],
                                       case)
    for meta, arrays in ranks["results"]:
        _assert_step_close(_section(arrays, f"stage1_{case}/raw"),
                           meta[f"stage1_{case}"],
                           _section(arrays, f"stage1_{case}/param"),
                           raw, metrics, params, 2e-5)


@pytest.mark.parametrize("stage", ["stage1_constraint", "stage1_dropout",
                                   "stage1_dense", "stage2_plain",
                                   "stage2_passes"])
def test_ranks_end_with_bit_identical_parameters(ranks, stage):
    (_, a0), (_, a1) = ranks["results"]
    p0, p1 = _section(a0, f"{stage}/param"), _section(a1, f"{stage}/param")
    assert p0.keys() == p1.keys()
    for name in p0:
        np.testing.assert_array_equal(p0[name], p1[name], err_msg=name)


@pytest.mark.parametrize("case", ["constraint", "dense"])
def test_stage1_step_matches_jax(ranks, case):
    """The 2-rank step against JAX's step on the same batch (dropout 0):
    tests/test_torch_stage1.py's bars on the raw gradients, the metrics
    and the parameters after the update."""
    import jax
    import jax.numpy as jnp
    import optax

    from repconc_tpu.train import stage1 as jax_stage1
    from repconc_tpu_torch.models.convert import param_table
    from test_torch_stage1 import assert_grads_close, assert_params_close

    cfg, params = jax_loaded(ranks["spec"]["stage1_dirs"][case])
    extra, _ = STAGE1_CASES[case]
    hp = jax_stage1.Stage1Hparams(total_steps=10, **extra)
    record = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    tx = optax.chain(record, jax_stage1.make_optimizer(hp, params))
    step = jax.jit(jax_stage1.make_train_step(cfg, hp, tx))
    jp, state, metrics, _ = step(params, tx.init(params),
                                 {k: jnp.asarray(v)
                                  for k, v in stage1_batch().items()},
                                 jax.random.key(0))
    from repconc_tpu_torch.core.config import RepConcConfig as PortConfig

    table = param_table(PortConfig(**cfg.to_dict()))
    for meta, arrays in ranks["results"]:
        raw = _section(arrays, f"stage1_{case}/raw")
        got = {path: (raw[name].T if tr else raw[name])
               for path, name, tr in table}
        assert_grads_close(got, state[0])
        for k in ("loss", "contrastive_loss", "mse_loss", "grad_norm"):
            np.testing.assert_allclose(meta[f"stage1_{case}"][k],
                                       float(metrics[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        after = _section(arrays, f"stage1_{case}/param")
        tree = {}
        for path, name, tr in table:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = after[name].T if tr else after[name]
        assert_params_close(tree, jax.tree.map(np.asarray, jp),
                            key_bias_bar=2 * hp.learning_rate)


@pytest.mark.parametrize("case", sorted(STAGE2_CASES))
def test_stage2_step_matches_one_process(ranks, case):
    """Each rank searches and scores its 4 queries; the summed step equals
    the one-process step, and the ranks' retrieved ids are the one-process
    ids of their rows."""
    raw, metrics, params, ids = stage2_step(ranks["spec"]["stage2_dir"], case)
    for r, (meta, arrays) in enumerate(ranks["results"]):
        _assert_step_close(_section(arrays, f"stage2_{case}/raw"),
                           meta[f"stage2_{case}"],
                           _section(arrays, f"stage2_{case}/param"),
                           raw, metrics, params, 5e-6)
        np.testing.assert_array_equal(arrays[f"stage2_{case}/ids"],
                                      ids[4 * r:4 * r + 4])


def test_stage2_step_matches_jax(ranks):
    """The 2-rank step with the plain fp32 search against JAX's XLA
    branch: the metrics and the parameters after the update."""
    import jax

    from repconc_tpu.train import stage2 as jax_stage2
    from repconc_tpu_torch.models.convert import param_table
    from repconc_tpu_torch.core.config import RepConcConfig as PortConfig
    from test_torch_stage1 import assert_params_close
    from test_torch_stage2 import jax_step

    cfg, params = jax_loaded(ranks["spec"]["stage2_dir"])
    hp = jax_stage2.Stage2Hparams(total_steps=10, dynamic_topk_negative=20,
                                  use_pallas_search=False)
    codes, batch = stage2_inputs()
    jp, _, metrics, ids = jax_step(cfg, params, hp, codes, batch)
    table = param_table(PortConfig(**cfg.to_dict()))
    for r, (meta, arrays) in enumerate(ranks["results"]):
        np.testing.assert_array_equal(arrays["stage2_plain/ids"],
                                      ids[4 * r:4 * r + 4])
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(meta["stage2_plain"][k],
                                       float(metrics[k]), rtol=1e-5,
                                       err_msg=k)
        after = _section(arrays, "stage2_plain/param")
        tree = {}
        for path, name, tr in table:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = after[name].T if tr else after[name]
        assert_params_close(tree, jp, key_bias_bar=2 * hp.learning_rate)


def test_train_conc_cli_data_parallel(ranks, tmp_path):
    """run_train_conc --data_parallel for 2 steps with a validation: rank 0
    alone writes, every rank ends with the one-process run's parameters
    (dropout on, GradCache chunks of 4 rows), and the JAX package loads
    final/."""
    from repconc_tpu.models import repconc_model as jax_model
    from repconc_tpu_torch.cli import run_train_conc

    (m0, a0), (m1, a1) = ranks["results"]
    assert m0["train_conc"]["writes"] and not m1["train_conc"]["writes"]
    assert m0["train_conc"]["step"] == m1["train_conc"]["step"] == 2
    assert m0["train_conc"]["best"] == m1["train_conc"]["best"]
    one = run_train_conc.main(train_conc_argv(ranks["spec"],
                                              str(tmp_path / "one")))
    assert one["best_metric"] == m0["train_conc"]["best"]
    want = params_of(one["model"])
    for _, arrays in ranks["results"]:
        got = _section(arrays, "train_conc/param")
        for name, w in want.items():
            bar = 2 * 2 * 2e-5 if name.endswith("key.bias") else 1e-6
            np.testing.assert_allclose(got[name], w, rtol=0, atol=bar,
                                       err_msg=name)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(
            [h[k] for h in m0["train_conc"]["history"]],
            [h[k] for h in one["history"]], rtol=1e-5, err_msg=k)
    cfg, params = jax_model.from_pretrained(
        os.path.join(ranks["root"], "conc_dp", "final"))
    assert params["centroids"].shape == (8, 32, 4) and cfg.sk_iters == 20


def _ranking(path):
    """{qid: (scores, [{docids at a score}, ...])} of a run file, the last
    group of each query left out: two runs that differ only in the order
    of exact ties are equal, whichever docs of a tie the cut at topk
    kept."""
    out = {}
    with open(path) as f:
        for line in f:
            qid, _, doc, _, score, _ = line.split("\t")
            scores, groups = out.setdefault(qid, ([], []))
            if scores and scores[-1] == score:
                groups[-1].add(doc)
            else:
                groups.append({doc})
            scores.append(score)
    return {q: (s, g[:-1]) for q, (s, g) in out.items()}


@pytest.mark.parametrize("name,extra", [("eval_dp", ()),
                                        ("ivf_dp", IVF_EVAL)])
def test_repconc_eval_cli_data_parallel(ranks, tmp_path, name, extra):
    """run_repconc_eval --data_parallel (encode over the ranks, the search
    sharded by corpus rows or by cells) writes the one-process run.tsv, but
    for the order of exact ties (the toy codes tie often): the same scores
    rank for rank, the same docs at each score. The IVF is held to the
    one-process cell-grouped path (--serving pallas)."""
    from repconc_tpu_torch.cli import run_repconc_eval

    one = str(tmp_path / name)
    serving = ("--serving", "pallas") if extra else ()
    run_repconc_eval.main(eval_argv(ranks["spec"], one, (*extra, *serving)))
    dp = os.path.join(ranks["root"], name)
    assert _ranking(dp + "_q/run.tsv") == _ranking(one + "_q/run.tsv")
    np.testing.assert_array_equal(np.load(dp + "_c/codes.npy"),
                                  np.load(one + "_c/codes.npy"))
    assert os.path.exists(dp + "_q/metric.json")


def test_multi_gpu_check_recipe_over_two_ranks(ranks):
    """recipes/multi_gpu_check.py at toy flags over the two gloo ranks: its
    checks pass (a failed one raises on every rank and fails the launch),
    and it reports every part."""
    parts = {p["part"]: p for p in ranks["recipe"]}
    assert set(parts) == {"mesh", "k1", "ivf_bf16", "ivf_int8", "stage1_step",
                          "stage2_step", "done"}
    assert parts["mesh"]["backend"] == "gloo" and parts["mesh"]["world"] == 2
    assert parts["k1"]["rows_per_rank"] == 2502  # ceil(5003 / 2)
    assert parts["ivf_bf16"]["cells_per_rank"] == 8
    for step in ("stage1_step", "stage2_step"):
        assert parts[step]["ranks_bit_identical"]
    assert parts["done"]["ok"]


# -- one process --------------------------------------------------------------


def test_env_contract(monkeypatch):
    for k in ENV_KEYS + distributed.TORCHRUN_VARS + ("LOCAL_RANK",):
        monkeypatch.delenv(k, raising=False)
    assert not distributed.is_distributed_env()
    assert distributed.initialize_from_env(device="cpu") is False
    monkeypatch.setenv(distributed.ENV_COORDINATOR, "10.0.0.1:1234")
    monkeypatch.setenv(distributed.ENV_NUM_PROCESSES, "4")
    monkeypatch.setenv(distributed.ENV_PROCESS_ID, "3")
    assert distributed.is_distributed_env()
    assert distributed._env_contract() == ("10.0.0.1:1234", 4, 3, None)
    # "auto" reads torchrun's variables
    monkeypatch.setenv(distributed.ENV_COORDINATOR, "auto")
    with pytest.raises(RuntimeError, match="torchrun"):
        distributed._env_contract()
    for k, v in (("RANK", "5"), ("WORLD_SIZE", "8"), ("MASTER_ADDR", "h"),
                 ("MASTER_PORT", "29500"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(k, v)
    assert distributed._env_contract() == ("h:29500", 8, 5, 1)
    # torchrun's variables alone count as the contract
    monkeypatch.delenv(distributed.ENV_COORDINATOR)
    assert distributed.is_distributed_env()
    assert distributed._env_contract() == ("h:29500", 8, 5, 1)


def test_process_slice_and_blocks():
    assert distributed.process_slice(8) == slice(0, 8)  # no process group
    assert [distributed.block(12, r, 3) for r in range(3)] == [
        slice(0, 4), slice(4, 8), slice(8, 12)]
    with pytest.raises(ValueError, match="divide"):
        distributed.block(10, 0, 4)
    batch = {"x": np.arange(12).reshape(6, 2)}
    got = distributed.shard_host_batch(batch, "cpu")
    np.testing.assert_array_equal(got["x"].numpy(), batch["x"])


def test_create_mesh_world1():
    """Without the env contract: a world-1 mesh with no process group;
    with it at world 1: a gloo group whose collectives run."""
    for k in ENV_KEYS:
        assert k not in os.environ
    mesh = create_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device.type) == (
        None, 0, 1, "cpu")
    with world1_mesh() as m1:
        assert (m1.backend, m1.rank, m1.size) == ("gloo", 0, 1)
        t = torch.arange(6.0).reshape(3, 2)
        np.testing.assert_array_equal(
            distributed.all_gather(t, m1.group).numpy(), t.numpy())
        assert distributed.initialize_from_env(device="cpu")  # a no-op
    assert not torch.distributed.is_initialized()


def test_rendezvous_that_cannot_complete_raises(tmp_path):
    """Rank 0 of a world of 2 whose rank 1 never comes: the rendezvous
    raises within its timeout; nothing carries on at world size 1."""
    script = tmp_path / "lonely.py"
    script.write_text(
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from repconc_tpu_torch.core import distributed\n"
        "try:\n"
        "    distributed.initialize_from_env(device='cpu', timeout=3)\n"
        "except Exception as e:\n"
        "    print('RAISED', type(e).__name__)\n"
        "    sys.exit(0)\n"
        "print('JOINED')\n"
        "sys.exit(1)\n")
    env = dict(os.environ, **contract_env(2, 0, free_port()))
    t0 = time.monotonic()
    done = subprocess.run([sys.executable, str(script)], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
    assert "RAISED" in done.stdout
    assert time.monotonic() - t0 < 90


def test_profiling_trace_annotate_and_stopwatch(tmp_path):
    """core/profiling.py: trace() writes a Chrome trace holding the
    annotated region, and does nothing without a dir; the Stopwatch's
    summary lists the phases longest first."""
    from repconc_tpu_torch.core.profiling import Stopwatch, annotate, trace

    with trace(None):
        pass
    assert not list(tmp_path.iterdir())
    with trace(str(tmp_path)):
        with annotate("train_step", step_num=3):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    (path,) = tmp_path.glob("trace_*.json")
    assert "train_step[step_num=3]" in path.read_text()
    sw = Stopwatch()
    with sw("short"):
        pass
    with sw("long"):
        time.sleep(0.01)
    assert list(sw.summary()) == ["long", "short"]


if __name__ == "__main__":
    worker_main(sys.argv[1])
