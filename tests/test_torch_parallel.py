"""The port's corpus- and cell-sharded search, sharded encode and Sinkhorn
marginals across ranks (repconc_tpu_torch/parallel/sharded.py,
index/cuda_ivf.py::ShardedCudaIVFIndex, quant/sinkhorn.py), on the CPU.

Two real processes join under gloo through the REPCONC_* env contract
(tests/test_torch_distributed.py's launcher; this file, run as a script,
is the worker), once for the module. Their results are held against the
port's one-process result and against the JAX package's sharded
functions on the 8-device virtual CPU mesh of tests/conftest.py, as
tests/test_parallel.py runs them:

  * center_distances and sinkhorn_log with group= against axis_name under
    shard_map: log Q within max(1e-5, 8 ulps of 1 / eps) plus 1e-6
    relative (tests/test_torch_sinkhorn.py's bar), the marginals of
    tests/_dcn_worker.py, codes equal except at fp32 near-ties;
  * sharded_flat_search and sharded_adc_search at topk below and above
    N / W, N not a multiple of W: scores to 1e-5, ids equal (JAX), and the
    one-process scores bit for bit;
  * the sharded encode against sharded_encode_fn (2e-4 relative, as
    tests/test_parallel.py);
  * ShardedCudaIVFIndex's CPU path (the passes' plain versions), bf16 and
    int8 LUTs and decoded residency, with a spill, a skewed probe and -1
    padding: the one-process CudaIVFIndex bit for bit, and JAX's
    ShardedPallasIVFIndex (interpret mode) as tests/test_parallel.py
    holds it to one chip.

The one-process tests take merge_topk, the partition of each sharded
search into W ranks' local parts run in one process (W = 2, 3, 4), and
group_pairs' kept pairs.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from repconc_tpu_torch.core.mesh import create_mesh, local_mesh  # noqa: E402
from repconc_tpu_torch.index.cuda_adc import CudaADCIndex  # noqa: E402
from repconc_tpu_torch.index.cuda_ivf import (  # noqa: E402
    CudaIVFIndex, ShardedCudaIVFIndex, group_pairs)
from repconc_tpu_torch.index.ivf import IVFIndex  # noqa: E402
from repconc_tpu_torch.parallel import sharded  # noqa: E402

EPS, ITERS = 0.05, 50
IVF_RUNS = {  # name: (index, query set, topk, nprobe, lut_dtype, serving)
    "bf16": ("spilled", "queries", 10, 8, "bf16", None),
    "int8": ("spilled", "queries", 10, 8, "int8", None),
    "decoded": ("spilled", "queries", 10, 8, "bf16", "decoded"),
    "decoded_int8": ("spilled", "queries", 10, 8, "bf16", "decoded_int8"),
    "skewed": ("spilled", "skewed", 10, 4, "bf16", None),
    "starved": ("built", "queries", 640, 1, "bf16", None),
}


def distances(M=3, B=16, K=8):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, M, 4))
    c = rng.normal(size=(M, K, 4))
    d = ((x[:, :, None, :] - c[None]) ** 2).sum(-1)
    return np.ascontiguousarray(np.transpose(d, (1, 0, 2)).astype(np.float32))


def flat_inputs(N=203, D=16, Q=6):
    rng = np.random.default_rng(6)
    return (rng.normal(size=(Q, D)).astype(np.float32),
            rng.normal(size=(N, D)).astype(np.float32))


def adc_inputs(N=161, M=4, K=16, dsub=8, Q=5):
    rng = np.random.default_rng(7)
    return (rng.normal(size=(Q, M * dsub)).astype(np.float32),
            rng.integers(0, K, size=(N, M)).astype(np.uint8),
            rng.normal(size=(M, K, dsub)).astype(np.float32))


def encode_inputs(B=7, L=10):
    rng = np.random.default_rng(8)
    ids = rng.integers(4, 64, size=(B, L)).astype(np.int64)
    mask = np.ones((B, L), dtype=np.int64)
    ids[2, L // 2:], mask[2, L // 2:] = 0, 0
    return torch.from_numpy(ids), torch.from_numpy(mask)


def sharded_searches(mesh, spec):
    """Every sharded search this file holds, on `mesh`: {name: array}."""
    out = {}
    q, corpus = flat_inputs()
    for k in (10, 150):  # 150 > N / W
        out[f"flat_{k}/s"], out[f"flat_{k}/i"] = sharded.sharded_flat_search(
            mesh, q, corpus, topk=k)
    q, codes, cent = adc_inputs()
    for k in (10, 100):  # 100 > N / W
        out[f"adc_{k}/s"], out[f"adc_{k}/i"] = sharded.sharded_adc_search(
            mesh, q, codes, cent, topk=k)
        out[f"passes_{k}/s"], out[f"passes_{k}/i"] = sharded.ShardedCudaADCIndex(
            mesh, codes, cent).search(q, topk=k)
    indexes = {name: IVFIndex.load(os.path.join(spec["ivf_dir"], name))
               for name in ("spilled", "built")}
    queries = dict(np.load(spec["queries"]))
    for name, (which, qs, k, nprobe, lut, serving) in IVF_RUNS.items():
        ix = ShardedCudaIVFIndex(mesh, indexes[which],
                                 serving=serving or "adc")
        out[f"ivf_{name}/s"], out[f"ivf_{name}/i"] = ix.search(
            queries[qs], topk=k, nprobe=nprobe, lut_dtype=lut)
    return out


def worker_main(workdir: str) -> None:
    from repconc_tpu_torch.models import repconc_model
    from repconc_tpu_torch.quant import sinkhorn

    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    mesh = create_mesh("cpu")
    d = torch.from_numpy(distances())
    rows = mesh.block(d.shape[1])
    local = d[:, rows].contiguous()
    out = {"centered": sinkhorn.center_distances(local, mesh.group).numpy()}
    out["logq"] = sinkhorn.sinkhorn_log(-torch.from_numpy(out["centered"]),
                                        EPS, ITERS, mesh.group).numpy()
    out["codes"] = sinkhorn.sinkhorn_assign(local, EPS, ITERS,
                                            mesh.group).numpy()
    model = repconc_model.from_pretrained(spec["model_dir"], device="cpu")
    ids, mask = encode_inputs()
    with torch.no_grad():
        out["encode"] = sharded.sharded_encode(
            mesh, model.encode_continuous, ids, mask).numpy()
    out.update(sharded_searches(mesh, spec))
    np.savez(os.path.join(workdir, f"rank{mesh.rank}.npz"), **out)
    mesh.barrier()
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ivf_case(tmp_path_factory):
    """test_torch_ivf.py's clustered indexes (JAX-built): "spilled" (M=8, a
    spill segment) and "built" (M=4, none), saved for the workers, with
    JAX copies; the spilled index's queries, and a skewed query set (one
    query repeated: every pair on the same cells)."""
    from test_torch_ivf import _clustered_index, _port_index

    index, *_, queries = _clustered_index(5, M=8, pad_quantile=0.3)
    built = _clustered_index(3)[0]
    assert len(index.spill_ids) > 0 and len(built.spill_ids) == 0
    root = str(tmp_path_factory.mktemp("par"))
    jax_ix = {"spilled": index, "built": built}
    port = {name: _port_index(ix) for name, ix in jax_ix.items()}
    for name, ix in port.items():
        ix.save(os.path.join(root, "ivf", name))
    rng = np.random.default_rng(9)
    skewed = (np.repeat(queries[:1], 40, 0)
              + rng.normal(size=(40, queries.shape[1])).astype(np.float32)
              * 1e-3)
    np.savez(os.path.join(root, "queries.npz"), queries=queries[:16],
             skewed=skewed)
    return {"root": root, "jax": jax_ix, "port": port,
            "queries": {"queries": queries[:16], "skewed": skewed}}


@pytest.fixture(scope="module")
def ranks(ivf_case):
    import jax

    from repconc_tpu.core.config import EncoderConfig, RepConcConfig
    from repconc_tpu.models import repconc_model as jax_model
    from test_torch_distributed import TINY_ENC, launch

    root = ivf_case["root"]
    cfg = RepConcConfig(encoder=EncoderConfig(**TINY_ENC, hidden_dropout=0.0,
                                              attention_dropout=0.0),
                        MCQ_M=4, MCQ_K=16)
    params = jax.tree.map(np.asarray, jax_model.init_params(
        cfg, jax.random.key(0)))
    jax_model.save_pretrained(os.path.join(root, "model"), cfg, params)
    spec = {"model_dir": os.path.join(root, "model"),
            "ivf_dir": os.path.join(root, "ivf"),
            "queries": os.path.join(root, "queries.npz")}
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(spec, f)
    launch(os.path.abspath(__file__), root)
    got = [dict(np.load(os.path.join(root, f"rank{r}.npz"))) for r in (0, 1)]
    return {"spec": spec, "cfg": cfg, "params": params, "ranks": got}


@pytest.fixture(scope="module")
def one_process(ranks):
    """The same searches on a world-1 mesh with no process group."""
    return sharded_searches(local_mesh(0, 1, "cpu"), ranks["spec"])


@pytest.fixture(scope="module")
def jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:8]), ("dp",))


def _both(ranks, key):
    """The key's output, the same on both ranks (the merge gives every rank
    the whole result)."""
    a, b = ranks["ranks"][0][key], ranks["ranks"][1][key]
    np.testing.assert_array_equal(a, b)
    return a


def test_sinkhorn_marginals_across_ranks(ranks, jax_mesh):
    """group= over 2 ranks against axis_name over 8 devices and the
    one-process log Q; the global marginals."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repconc_tpu.quant import sinkhorn as jax_sk
    from repconc_tpu_torch.quant import sinkhorn

    d = distances()
    got = {k: np.concatenate([r[k] for r in ranks["ranks"]],
                             axis=0 if k == "codes" else 1)
           for k in ("centered", "logq", "codes")}
    spec = P(None, "dp", None)
    fn = jax.jit(jax.shard_map(
        lambda x: (jax_sk.center_distances(x, "dp"),
                   jax_sk.sinkhorn_log(-jax_sk.center_distances(x, "dp"),
                                       EPS, ITERS, "dp"),
                   jax_sk.sinkhorn_assign(x, EPS, ITERS, "dp")),
        mesh=jax_mesh, in_specs=spec, out_specs=(spec, spec, P("dp", None))))
    want = [np.asarray(a) for a in fn(d)]
    one = torch.from_numpy(d)
    one_logq = sinkhorn.sinkhorn_log(-sinkhorn.center_distances(one), EPS,
                                     ITERS).numpy()
    bar = max(1e-5, 8 * np.spacing(np.float32(1 / EPS)))
    np.testing.assert_allclose(got["centered"], want[0], rtol=1e-6, atol=1e-6)
    for ref in (want[1], one_logq):
        np.testing.assert_allclose(got["logq"], ref, rtol=1e-6, atol=bar)
    top2 = np.sort(want[1], axis=-1)[..., -2:]
    tied = (top2[..., 1] - top2[..., 0] < 1e-3).T  # (B, M)
    assert np.array_equal(got["codes"][~tied], want[2][~tied])
    q = np.exp(got["logq"])
    B, K = d.shape[1], d.shape[2]
    np.testing.assert_allclose(q.sum(axis=2), 1.0, atol=1e-3)
    np.testing.assert_allclose(q.sum(axis=1), B / K, atol=0.02 * B)


@pytest.mark.parametrize("k", [10, 150])
def test_sharded_flat_search(ranks, one_process, jax_mesh, k):
    from repconc_tpu.parallel.sharded import sharded_flat_search

    s, i = _both(ranks, f"flat_{k}/s"), _both(ranks, f"flat_{k}/i")
    assert s.shape == (6, k)
    np.testing.assert_array_equal(s, one_process[f"flat_{k}/s"])
    q, corpus = flat_inputs()
    js, ji = sharded_flat_search(jax_mesh, q, corpus, topk=k)
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(i, ji)


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("kind", ["adc", "passes"])
def test_sharded_adc_search(ranks, one_process, jax_mesh, kind, k):
    """The fp32 plain scan (the CPU's ShardedADCIndex) and K1's passes
    (ShardedCudaADCIndex, bf16 LUT, their plain versions here): the
    one-process scores bit for bit; the fp32 scan against JAX's
    sharded_adc_search, the passes against the unsharded CudaADCIndex."""
    from repconc_tpu.parallel.sharded import sharded_adc_search

    s, i = _both(ranks, f"{kind}_{k}/s"), _both(ranks, f"{kind}_{k}/i")
    np.testing.assert_array_equal(s, one_process[f"{kind}_{k}/s"])
    np.testing.assert_array_equal(i, one_process[f"{kind}_{k}/i"])
    q, codes, cent = adc_inputs()
    if kind == "adc":
        js, _ = sharded_adc_search(jax_mesh, q, codes, cent, topk=k)
        np.testing.assert_allclose(s, js, rtol=1e-4, atol=1e-4)
    else:
        us, ui = CudaADCIndex(codes, cent, device="cpu").search(q, k)
        np.testing.assert_array_equal(s, us)
        np.testing.assert_array_equal(i, ui)


def test_sharded_encode(ranks, jax_mesh):
    """7 rows over 2 ranks (blocks of 4, the last padded): every rank gets
    the whole batch, the one-process rows and JAX's sharded_encode_fn's
    (rows padded to the 8 devices) to 2e-4 relative."""
    import jax.numpy as jnp

    from repconc_tpu.models import repconc_model as jax_model
    from repconc_tpu.parallel.sharded import sharded_encode_fn
    from repconc_tpu_torch.models import repconc_model

    got = _both(ranks, "encode")
    ids, mask = encode_inputs()
    model = repconc_model.from_pretrained(ranks["spec"]["model_dir"],
                                          device="cpu")
    with torch.no_grad():
        one = model.encode_continuous(ids, mask).numpy()
    np.testing.assert_allclose(got, one, rtol=1e-6, atol=1e-6)
    cfg = ranks["cfg"]
    fn = sharded_encode_fn(jax_mesh, lambda p, i, m: jax_model.encode_continuous(
        cfg, p, i, m))
    pad = (-ids.shape[0]) % 8
    j_ids = jnp.asarray(np.concatenate([ids.numpy(), ids.numpy()[-1:].repeat(
        pad, 0)]), jnp.int32)
    j_mask = jnp.asarray(np.concatenate([mask.numpy(), mask.numpy()[-1:].repeat(
        pad, 0)]), jnp.int32)
    want = np.asarray(fn(ranks["params"], j_ids, j_mask))[:ids.shape[0]]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", sorted(IVF_RUNS))
def test_sharded_ivf_search(ranks, one_process, ivf_case, jax_mesh, name):
    """Cells round-robin over 2 ranks, the spill merged after the gather:
    the one-process (world-1) search bit for bit, and the unsharded
    CudaIVFIndex's scores bit for bit, its ids but for the order of exact
    ties (decoded serving's top-k does not order them by id); JAX's ShardedPallasIVFIndex on 8 devices, rank for rank to 1e-4
    (test_parallel.py's bar), ids equal but where a score ties the cut
    (the spilled corpus shares codes between docs). The skewed set
    puts every pair on the same few cells, hence on one or two ranks: none
    is dropped. The starved probe (1 cell of at most 613 docs, top-640)
    pads with -1 at -inf, never with a duplicate id."""
    from repconc_tpu.index.pallas_ivf import ShardedPallasIVFIndex
    from test_torch_ivf import _assert_ids_near_ties

    which, qs, k, nprobe, lut, serving = IVF_RUNS[name]
    s, i = _both(ranks, f"ivf_{name}/s"), _both(ranks, f"ivf_{name}/i")
    np.testing.assert_array_equal(s, one_process[f"ivf_{name}/s"])
    np.testing.assert_array_equal(i, one_process[f"ivf_{name}/i"])
    queries = ivf_case["queries"][qs]
    us, ui = CudaIVFIndex(ivf_case["port"][which], serving=serving or "adc",
                          device="cpu").search(queries, topk=k, nprobe=nprobe,
                                               lut_dtype=lut)
    assert same_ranking(s, i, us, ui)
    js, ji = ShardedPallasIVFIndex(jax_mesh, ivf_case["jax"][which]).search(
        queries, topk=k, nprobe=nprobe, lut_dtype=lut, serving=serving)
    _assert_ids_near_ties(i, ji, s, js, 1e-4)
    if name == "starved":
        for r in range(len(i)):
            empty = ~np.isfinite(s[r])
            assert empty.any() and (i[r][empty] == -1).all()
            real = i[r][~empty]
            assert len(set(real.tolist())) == len(real)


def same_ranking(s_a, i_a, s_b, i_b) -> bool:
    """Equal scores rank for rank, and at each score the same ids, except
    in each row's last group of equal scores (the cut at topk may keep
    other docs of a tie)."""
    if not np.array_equal(s_a, s_b):
        return False
    for r in range(len(s_a)):
        scores = s_a[r]
        starts = np.flatnonzero(np.r_[True, scores[1:] != scores[:-1]])
        for a, b in zip(starts[:-1], starts[1:]):
            if set(i_a[r, a:b]) != set(i_b[r, a:b]):
                return False
    return True


# -- one process --------------------------------------------------------------


def test_merge_topk_orders_ties_and_pads():
    """(score DESC, id ASC) across the parts; -inf / -1 pads last; topk
    wider than the gathered lists gives their width; -0.0 ranks as +0.0."""
    a_s = torch.tensor([[3.0, 1.0, -torch.inf], [0.0, -0.0, -torch.inf]])
    a_i = torch.tensor([[7, 2, -1], [4, 9, -1]])
    b_s = torch.tensor([[3.0, 1.0, 0.5], [-0.0, -torch.inf, -torch.inf]])
    b_i = torch.tensor([[5, 1, 8], [3, -1, -1]])
    s, i = sharded.merge_topk([a_s, b_s], [a_i, b_i], 4)
    assert i.tolist() == [[5, 7, 1, 2], [3, 4, 9, -1]]
    assert s[0].tolist() == [3.0, 3.0, 1.0, 1.0]
    s, i = sharded.merge_topk([a_s, b_s], [a_i, b_i], 100)
    assert s.shape == (2, 6) and i[0, -1] == -1 and i[1].tolist()[3:] == [
        -1, -1, -1]


@pytest.mark.parametrize("W", [2, 3, 4])
def test_partitions_in_one_process(ivf_case, W):
    """Each rank's local part in turn (local_mesh), merged by merge_topk,
    equals the unsharded search: K1's passes over N = 161 codes (not a
    multiple of W), the bf16 and int8 cell-grouped IVF with its spill."""
    q, codes, cent = adc_inputs()
    for k in (10, 100):
        parts = [sharded.ShardedCudaADCIndex(local_mesh(r, W, "cpu"), codes,
                                             cent).local_search(q, k)
                 for r in range(W)]
        s, i = sharded.merge_topk(*zip(*parts), min(k, len(codes)))
        us, ui = CudaADCIndex(codes, cent, device="cpu").search_device(q, k)
        assert torch.equal(s, us) and torch.equal(i, ui)
    port = ivf_case["port"]["spilled"]
    queries = ivf_case["queries"]["queries"]
    for lut in ("bf16", "int8"):
        ranks = [ShardedCudaIVFIndex(local_mesh(r, W, "cpu"), port)
                 for r in range(W)]
        parts = [ix.local_search(queries, 20, 8, lut) for ix in ranks]
        s, i = sharded.merge_topk(*zip(*parts), parts[0][0].shape[1])
        s, i = ranks[0].merge_spill(s, i, queries, 20)
        us, ui = CudaIVFIndex(port, device="cpu").search_device(
            queries, 20, 8, lut)
        assert torch.equal(s, us) and torch.equal(i, ui)


def test_one_rank_without_a_group_cannot_gather():
    q, codes, cent = adc_inputs()
    ix = sharded.ShardedCudaADCIndex(local_mesh(1, 2, "cpu"), codes, cent)
    assert ix.local_search(q, 10)[0].shape == (5, 10)
    with pytest.raises(ValueError, match="process group"):
        ix.search(q, 10)


def test_group_pairs_gives_kept_pairs_their_slots():
    """Pairs outside `keep` get no slot and row -1; the kept pairs' grid is
    the grid of the kept pairs alone."""
    cells = torch.tensor([[0, 1, 2], [2, 0, 3], [1, 3, 0]])
    keep = cells % 2 == 0
    row, work_cell, slot_pair = group_pairs(torch.where(keep, cells // 2, 0),
                                            3, 2, 3, keep)
    assert (row[~keep.reshape(-1)] == -1).all()
    kept = torch.arange(9)[keep.reshape(-1)]
    occupied = slot_pair[slot_pair >= 0]
    assert sorted(occupied.tolist()) == kept.tolist()
    assert work_cell.tolist() == [0, 1]  # one tile per owned cell


if __name__ == "__main__":
    worker_main(sys.argv[1])
