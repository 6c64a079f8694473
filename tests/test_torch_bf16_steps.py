"""One bf16 training step on the port against the JAX package's on the
CPU (stage 1 through make_train_step, stage 2), and the production-step
recipe at toy flags. The bar is tests/test_torch_bf16.py's: the port's gap
to JAX's bf16 result within twice JAX's own bf16-vs-fp32 gap. A loss and
a gradient tree are compared: the loss gap, and the largest |difference|
over every gradient array. The stage-1 step's JAX runs are handed the
port's constrained codes, so that all three steps quantize alike."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from repconc_tpu.models import repconc_model as jax_model
from repconc_tpu.quant import codebook as jax_codebook
from repconc_tpu.train import stage1 as jax_stage1
from repconc_tpu.train import stage2 as jax_stage2
from repconc_tpu_torch.quant import codebook
from repconc_tpu_torch.train import stage1
from test_torch_bf16 import RATIO, bf16
from test_torch_stage1 import leaf, make_batch, port_grads, port_model, tiny
from test_torch_stage1 import torch_batch as torch_batch1
from test_torch_stage2 import (distinct_codes, jax_step, make_query_batch,
                               port_step)
from test_torch_stage2 import tiny as tiny2


def tree_gap(got, want_tree):
    """The largest |difference| over every gradient array."""
    return max(float(np.abs(g - leaf(want_tree, p)).max())
               for p, g in got.items())


def tree_gap_jax(a_tree, b_tree, paths):
    return max(float(np.abs(leaf(a_tree, p) - leaf(b_tree, p)).max())
               for p in paths)


def _jax_stage1_step(cfg, params, hp, batch, codes=None):
    """JAX's make_train_step on one batch: (raw gradients, metrics). With
    `codes`, its codebook.encode returns them, whatever it is given."""
    record = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    tx = optax.chain(record, jax_stage1.make_optimizer(hp, params))
    real = jax_codebook.encode
    if codes is not None:
        jax_codebook.encode = lambda *a, **k: jnp.asarray(codes)
    try:
        step = jax.jit(jax_stage1.make_train_step(cfg, hp, tx))
        _, state, metrics, _ = step(params, tx.init(params),
                                    {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                                    jax.random.key(0))
        jax.block_until_ready(metrics)
    finally:
        jax_codebook.encode = real
    return state[0], metrics


STAGE1_CASES = {  # GradCache chunks under checkpoint, the constraint, MSE
    "constraint_gradcache": dict(use_constraint=True, cache_chunk_size=4,
                                 mse_loss_weight=0.1),
    "dense": dict(quantize=False),  # stage 0
}


@pytest.mark.parametrize("case", sorted(STAGE1_CASES))
def test_bf16_stage1_step_matches_jax(case, monkeypatch):
    """One bf16 stage-1 step, dropout 0: the port's loss and gradients
    against JAX's make_train_step in bf16, each gap within twice JAX's own
    bf16-vs-fp32 gap. The port's constrained codes are recorded and handed
    to both JAX steps; they equal JAX's own bf16 codes except near-ties,
    which test_bf16_codes_match_jax_except_near_ties holds. Gradients land
    on the fp32 master params."""
    cfg32, params = tiny("METRIC_IP")
    cfg16 = bf16(cfg32)
    hp = jax_stage1.Stage1Hparams(total_steps=10, **STAGE1_CASES[case])
    batch = make_batch(np.random.default_rng(2))

    model = port_model(cfg16, params)
    phs = stage1.Stage1Hparams(**hp.__dict__)
    seen = []
    real = codebook.encode
    monkeypatch.setattr(codebook, "encode",
                        lambda *a, **k: seen.append(real(*a, **k)) or seen[-1])
    total, _ = stage1.loss_fn(model, phs, torch_batch1(batch))
    total.backward()
    total = float(total.detach())
    got = port_grads(model)
    assert all(p.grad.dtype == torch.float32 for p in model.parameters()
               if p.grad is not None)
    codes = seen[0].numpy() if seen else None
    assert (codes is None) == (case == "dense")

    g32, m32 = _jax_stage1_step(cfg32, params, hp, batch, codes)
    g16, m16 = _jax_stage1_step(cfg16, params, hp, batch, codes)
    jax_loss_gap = abs(float(m16["loss"]) - float(m32["loss"]))
    port_loss_gap = abs(total - float(m16["loss"]))
    assert port_loss_gap <= RATIO * jax_loss_gap, (port_loss_gap,
                                                   jax_loss_gap)
    jax_grad_gap = tree_gap_jax(g16, g32, got)
    assert 0.0 < jax_grad_gap
    assert tree_gap(got, g16) <= RATIO * jax_grad_gap


BF16_EPS = 2.0 ** -8  # bf16's unit roundoff


@pytest.mark.parametrize("metric", ["METRIC_IP", "METRIC_CENTROID_COS"])
def test_bf16_stage2_step_matches_jax(metric):
    """One bf16 stage-2 step (the query encoder in bf16, the plain search
    in both packages): the gradient gap within twice JAX's own
    bf16-vs-fp32 gap, and so the loss gap under METRIC_IP. A retrieved
    negative that differs from JAX's bf16 set is a near-tie: its score and
    the k-th score, under JAX's bf16 query, differ by no more than the
    port's query gap can move them.

    Under METRIC_CENTROID_COS the mean loss is held to bf16's own roundoff
    of it instead: there JAX's loss gap is 6.0e-5 and the port's 8.8e-4
    on this batch (the query embeddings' gaps 0.0077 and 0.0065, the
    gradients' 0.0106 and 0.0103). Unit subvectors turn rounding noise
    into a shrinkage of every logit, which raises the loss by the noise's
    variance; the port rounds at every rounding point of the JAX source,
    where XLA on the CPU keeps fused bf16 arithmetic in fp32 (PERF.md,
    section 6), so the port's noise, and the shrinkage, are the larger."""
    cfg32, params = tiny2(metric)
    cfg16 = bf16(cfg32)
    rng = np.random.default_rng(3)
    codes = distinct_codes(rng, 200)
    batch = make_query_batch(rng, 200)
    hp = jax_stage2.Stage2Hparams(dynamic_topk_negative=16, total_steps=10,
                                  use_pallas_search=False)
    _, g32, m32, _ = jax_step(cfg32, params, hp, codes, batch)
    _, g16, m16, ids16 = jax_step(cfg16, params, hp, codes, batch)
    _, grads, metrics, aux = port_step(cfg16, params, hp, codes, batch)
    loss16 = float(m16["loss"])
    port_loss_gap = abs(float(metrics["loss"]) - loss16)
    if metric == "METRIC_IP":
        assert port_loss_gap <= RATIO * abs(loss16 - float(m32["loss"]))
    else:
        assert port_loss_gap <= BF16_EPS * abs(loss16)
    assert tree_gap(grads, g16) <= RATIO * tree_gap_jax(g16, g32, grads)

    q16 = np.asarray(jax_model.encode_continuous(
        cfg16, params, jnp.asarray(batch["query_input_ids"]),
        jnp.asarray(batch["query_attention_mask"])), np.float64)
    model = port_model(cfg16, params)
    with torch.no_grad():
        q_port = model.encode_continuous(
            torch.as_tensor(batch["query_input_ids"]),
            torch.as_tensor(batch["query_attention_mask"])).double().numpy()
    docs = np.asarray(jax_codebook.decode(jnp.asarray(codes),
                                          params["centroids"]), np.float64)
    reach = np.linalg.norm(docs, axis=1).max()
    got_ids = aux["neg_pids"].numpy()
    for r in range(len(got_ids)):
        scores = docs @ q16[r]
        kth = np.sort(scores[ids16[r]])[0]
        bar = 2 * np.linalg.norm(q_port[r] - q16[r]) * reach
        for d in set(got_ids[r]) ^ set(ids16[r]):
            assert abs(scores[d] - kth) <= bar, (r, d)


def test_bench_stage1_scale_runs_on_the_cpu():
    """recipes/bench_stage1_scale.py at toy flags on the CPU (bert-base
    width, 2 queries x 2 docs): one warm-up and one timed bf16 step with
    finite metrics; peak memory and the split are card-only (None here);
    the step's FLOPs at the default flags are the issue's 4.44e15 (a
    4.49 s bound at 989 TFLOP/s)."""
    from repconc_tpu_torch.core.config import EncoderConfig
    from repconc_tpu_torch.recipes import bench_stage1_scale as bench

    out = bench.main(["--batch", "2", "--negs", "1", "--cache_chunk", "1",
                      "--query_len", "4", "--doc_len", "8", "--steps", "1",
                      "--device", "cpu"])
    assert out["device"] == "cpu" and out["dtype"] == "bfloat16"
    assert out["docs_per_step"] == 4 and len(out["step_s"]) == 1
    assert all(np.isfinite(v) for v in out["metrics"].values())
    assert out["peak_memory_gb"] is None and out["split_ms"] is None
    flops = bench.step_flops(EncoderConfig(), 4096, 16, 4096 * 12, 128)
    assert abs(flops - 4.4383e15) < 1e11
    assert abs(flops / bench.H100_BF16_FLOPS - 4.4877) < 1e-3
    batch = bench.make_batch(8, 3, 4, 6, 100)
    again = bench.make_batch(8, 3, 4, 6, 100)
    assert all(np.array_equal(batch[k], again[k]) for k in batch)
    assert batch["neg_input_ids"].shape == (24, 6)
    assert (batch["neg_docids"] >= 8).all() and (batch["neg_docids"] < 320).all()
