"""Hold the data-parallel paths across the GPUs of one host against one
GPU, and time them: the corpus-sharded K1 search, the cell-sharded IVF
(K2 / K3's passes) and one stage-1 and one stage-2 step.

    torchrun --nproc_per_node 4 -m repconc_tpu_torch.recipes.multi_gpu_check

Every rank joins through core/mesh.py::create_mesh (torchrun's variables
or the REPCONC_* env; NCCL, or gloo with --device cpu) and draws the same
seeded data on its own device; rank 0 also runs each unsharded
counterpart on its one device and holds the sharded result to it:

  * K1 over --n_docs random M=12 codes (MS MARCO's 8,841,823 by default),
    --queries queries at --topk, each rank scanning its ceil(N / W) rows:
    scores bit-equal to CudaADCIndex, ids equal;
  * the IVF (nlist --nlist over the same codes, built by rank 0 and read
    by the others from a file) at --nprobe, bf16 and int8 LUTs, cells
    round-robin over the ranks: scores bit-equal to CudaIVFIndex, ids
    equal but for the order of exact ties;
  * one stage-1 step of the M=12 model (bert-base widths, seeded weights)
    over a global batch of --batch queries, GradCache chunks of
    --batch / W rows so that one process draws the same dropout masks,
    argmin codes (the constraint's codes at K=256 are near-ties that
    rounding decides; they are held apart, equal but for near-ties), and
    one stage-2 step (--jpq_batch queries, 200 dynamic negatives over the
    codes, dropout off): the metrics within 1e-5 relative, each gradient
    array within 1e-4 of its largest |g|, the parameters within 1e-6
    (2 lr where a gradient is within 1e-4 of its array's max of zero),
    bit-identical on every rank.

Times (CUDA events on rank 0, median of --reps after a warm-up, every rep
started at a barrier): each search sharded and on one GPU, and the
stage-1 step at --time_batch queries over W GPUs and on one. Prints one
JSON line per part from rank 0; a failed check raises on every rank.
--tiny shrinks the encoder, and the flags the rest, for a CPU run.
"""
from __future__ import annotations

import argparse
import copy
import json
import shutil
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repconc_tpu_torch.core.config import EncoderConfig, RepConcConfig
from repconc_tpu_torch.core.mesh import create_mesh
from repconc_tpu_torch.index.cuda_adc import CudaADCIndex
from repconc_tpu_torch.index.cuda_ivf import CudaIVFIndex, ShardedCudaIVFIndex
from repconc_tpu_torch.index.ivf import IVFIndex, build_ivf_from_codes
from repconc_tpu_torch.models.repconc_model import RepConcModel, init_random_
from repconc_tpu_torch.parallel.sharded import ShardedCudaADCIndex, gather
from repconc_tpu_torch.quant import codebook, sinkhorn
from repconc_tpu_torch.train import stage1, stage2

MSMARCO_PASSAGES = 8_841_823


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n_docs", type=int, default=MSMARCO_PASSAGES)
    ap.add_argument("--queries", type=int, default=1200)
    ap.add_argument("--topk", type=int, default=1000)
    ap.add_argument("--nlist", type=int, default=4096)
    ap.add_argument("--nprobe", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--time_batch", type=int, default=256)
    ap.add_argument("--jpq_batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=2022)
    ap.add_argument("--tiny", action="store_true",
                    help="a 2-layer 96-wide encoder, for a CPU run")
    return ap


def m12_config(tiny: bool) -> RepConcConfig:
    """The M=12 checkpoint's config (bert-base, vocab 7905, mean pooling,
    METRIC_IP, K=256), or its 2-layer 96-wide cut."""
    width = dict(hidden_size=96, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=128) if tiny else dict(
        hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
        intermediate_size=3072)
    return RepConcConfig(
        encoder=EncoderConfig(model_type="bert", vocab_size=7905,
                              max_position_embeddings=512, pooling="mean",
                              **width),
        MCQ_M=12, MCQ_K=256, similarity_metric="METRIC_IP")


class Ranks:
    """The mesh, a rank-0 printer, checks every rank takes together, and
    timing."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.cuda = mesh.device.type == "cuda"

    def emit(self, part: str, **fields) -> None:
        if self.mesh.is_main:
            print(json.dumps({"part": part, **fields}), flush=True)

    def check(self, ok: bool, what: str) -> None:
        """Raises on every rank when `ok` is false on any."""
        flag = torch.tensor([int(bool(ok))], device=self.mesh.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.mesh.group)
        if not int(flag):
            raise RuntimeError(f"check failed: {what}")

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.mesh.device)

    def time_ms(self, fn, reps: int, everyone: bool = True) -> float:
        """Median ms of `reps` calls after one warm-up; with `everyone`
        every rank calls fn, each rep from a barrier; else rank 0 alone."""
        def once():
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                stop.record()
                stop.synchronize()
                return start.elapsed_time(stop)
            t = time.perf_counter()
            fn()
            return (time.perf_counter() - t) * 1e3

        times = []
        if everyone or self.mesh.is_main:
            fn()
        for _ in range(reps):
            self.sync()
            self.mesh.barrier()
            if everyone or self.mesh.is_main:
                times.append(once())
        self.mesh.barrier()
        return statistics.median(times) if times else 0.0


def same_everywhere(r: Ranks, t: torch.Tensor) -> bool:
    """t equal on every rank, bit for bit."""
    return bool(all(torch.equal(p, t) for p in gather(r.mesh, t.contiguous())))


def hold_search(r: Ranks, what: str, s, i, ref):
    """The sharded top-k against rank 0's unsharded one: scores bit for
    bit, ids equal but where a score ties its neighbour."""
    ok = same_everywhere(r, s) and same_everywhere(r, i)
    if r.mesh.is_main:
        s0, i0 = ref
        tied = (s0 == s0.roll(1, 1)) | (s0 == s0.roll(-1, 1))
        ok = ok and torch.equal(s, s0) and bool(tied[i != i0].all())
    r.check(ok, f"{what}: every rank holds the unsharded top-k")


def searches(r: Ranks, args, dev):
    M, K, D = 12, 256, 768
    g = torch.Generator(device=dev).manual_seed(args.seed)
    codes = torch.randint(0, K, (args.n_docs, M), generator=g, device=dev,
                          dtype=torch.uint8)
    cent = torch.randn((M, K, D // M), generator=g, device=dev)
    queries = torch.randn((args.queries, D), generator=g, device=dev)
    main = r.mesh.is_main
    sharded = ShardedCudaADCIndex(r.mesh, codes, cent)
    s, i = sharded.search_device(queries, args.topk)
    flat = CudaADCIndex(codes, cent, device=dev) if main else None
    hold_search(r, "K1", s, i,
                flat.search_device(queries, args.topk) if main else None)
    r.emit("k1", N=args.n_docs, Q=args.queries, topk=args.topk,
           world=r.mesh.size, rows_per_rank=sharded.n_local,
           sharded_ms=r.time_ms(lambda: sharded.search_device(
               queries, args.topk), args.reps),
           one_gpu_ms=r.time_ms(lambda: flat.search_device(
               queries, args.topk), args.reps, everyone=False))
    del sharded, flat

    tmp = [tempfile.mkdtemp(prefix="repconc_mgpu_") if main else None]
    dist.broadcast_object_list(tmp, src=0, group=r.mesh.group)
    if main:
        t = time.perf_counter()
        build_ivf_from_codes(codes, cent.cpu().numpy(), nlist=args.nlist,
                             device=dev).save(tmp[0])
        build_s = time.perf_counter() - t
    r.mesh.barrier()
    index = IVFIndex.load(tmp[0])
    r.mesh.barrier()
    if main:
        shutil.rmtree(tmp[0])
    del codes
    one = CudaIVFIndex(index, device=dev) if main else None
    cells = ShardedCudaIVFIndex(r.mesh, index)
    for lut in ("bf16", "int8"):
        s, i = cells.search_device(queries, args.topk, args.nprobe, lut)
        hold_search(r, f"IVF {lut}", s, i, one.search_device(
            queries, args.topk, args.nprobe, lut) if main else None)
        r.emit(f"ivf_{lut}", nlist=index.nlist, Lpad=index.Lpad,
               spill=len(index.spill_ids), nprobe=args.nprobe,
               world=r.mesh.size,
               cells_per_rank=int(cells.cell_codes.shape[0]),
               build_s=build_s if main else None,
               sharded_ms=r.time_ms(lambda: cells.search_device(
                   queries, args.topk, args.nprobe, lut), args.reps),
               one_gpu_ms=r.time_ms(lambda: one.search_device(
                   queries, args.topk, args.nprobe, lut), args.reps,
                   everyone=False))
    del one, cells, index


def stage1_batch(config, B: int, seed: int):
    """B queries of 16 tokens, B positives and B negatives of 128, the
    ids' first rows padded, every doc distinct."""
    rng = np.random.default_rng(seed)

    def tok(rows, L):
        ids = rng.integers(1000, config.encoder.vocab_size,
                           size=(rows, L)).astype(np.int64)
        ids[:, 0] = 101
        mask = np.ones((rows, L), dtype=np.int64)
        mask[0, L // 2:], ids[0, L // 2:] = 0, 0
        return ids, mask

    out = {}
    for key, L in (("query", 16), ("pos", 128), ("neg", 128)):
        out[f"{key}_input_ids"], out[f"{key}_attention_mask"] = tok(B, L)
    out["qids"] = np.arange(B)
    out["pos_docids"] = np.arange(B)
    out["neg_docids"] = np.arange(B, 2 * B)
    positives = np.full((B, 4), -1)
    positives[:, 0] = np.arange(B)
    out["query_positives"] = positives
    return out


def step_result(model, metrics):
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            {n: p.detach().clone() for n, p in model.named_parameters()})


def within_bars(got, want, lr: float, centroid_lr: float):
    """The step bars, (ok, the largest gaps): metrics 1e-5 relative, each
    gradient array 1e-4 of its largest |g| (the attention key biases, zero
    in exact arithmetic, 1e-6 of the largest |g| of any array), parameters
    1e-6, and 2 lr where a gradient lies within 1e-4 of its array's max of
    zero (Adam's first step normalises such noise to the rate)."""
    (m_g, g_g, p_g), (m_w, g_w, p_w) = got, want
    top = max(float(g.abs().max()) for g in g_w.values())
    gaps = {"metrics_rel": max(abs(m_g[k] - m_w[k]) / max(abs(m_w[k]), 1e-12)
                               for k in m_w),
            "grad_rel": 0.0, "key_bias_grad_rel": 0.0, "param_abs": 0.0,
            "near_zero_grad_param_lr": 0.0}
    for n, g in g_w.items():
        key_bias = n.endswith("key.bias")
        diff = float((g_g[n] - g).abs().max())
        if key_bias:
            gaps["key_bias_grad_rel"] = max(gaps["key_bias_grad_rel"],
                                            diff / top)
        else:
            gaps["grad_rel"] = max(gaps["grad_rel"], diff / max(
                float(g.abs().max()), 1e-12))
        free = (torch.ones_like(g, dtype=torch.bool) if key_bias
                else g.abs() <= 1e-4 * g.abs().max())
        d = (p_g[n] - p_w[n]).abs()
        if d[~free].numel():
            gaps["param_abs"] = max(gaps["param_abs"], float(d[~free].max()))
        if d[free].numel():
            gaps["near_zero_grad_param_lr"] = max(
                gaps["near_zero_grad_param_lr"], float(d[free].max())
                / (centroid_lr if n == "centroids" else lr))
    ok = (gaps["metrics_rel"] <= 1e-5 and gaps["grad_rel"] <= 1e-4
          and gaps["key_bias_grad_rel"] <= 1e-6 and gaps["param_abs"] <= 1e-6
          and gaps["near_zero_grad_param_lr"] <= 2.0)
    return ok, gaps


def params_same_everywhere(r: Ranks, model) -> bool:
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    return same_everywhere(r, flat)


def steps(r: Ranks, args, dev):
    config = m12_config(args.tiny)
    W, main = r.mesh.size, r.mesh.is_main
    init = init_random_(RepConcModel(config),
                        torch.Generator().manual_seed(args.seed + 1), std=0.02)

    def batch_of(B, seed):
        return {k: torch.as_tensor(v).to(dev)
                for k, v in stage1_batch(config, B, seed).items()}

    batch = batch_of(args.batch, args.seed)
    hp = stage1.Stage1Hparams(total_steps=10, use_constraint=False,
                              cache_chunk_size=args.batch // W)
    results = {}
    for name, mesh in (("sharded", r.mesh), ("one_gpu", None)):
        if mesh is None and not main:
            continue
        model = copy.deepcopy(init).to(dev)
        tx = stage1.make_optimizer(hp, model)
        results[name] = step_result(model, stage1.make_train_step(
            model, hp, tx, mesh)(batch, torch.Generator().manual_seed(7)))
        if mesh is not None:
            identical = params_same_everywhere(r, model)
        del model, tx
    ok, gaps = (within_bars(results["sharded"], results["one_gpu"],
                            hp.learning_rate, hp.centroid_learning_rate)
                if main else (True, None))
    r.check(identical and ok, f"stage-1 step over {W} ranks == one GPU "
                              f"({gaps})")
    # the constrained codes of the batch's docs across the ranks, against
    # one GPU's, equal but for near-ties
    model = copy.deepcopy(init).to(dev)
    b = args.batch // W
    rows = r.mesh.block(args.batch)
    with torch.no_grad():
        docs = torch.cat([model.encode_continuous(
            batch[f"{k}_input_ids"], batch[f"{k}_attention_mask"])
            for k in ("pos", "neg")])
        codes = codebook.encode(
            torch.cat([docs[:args.batch][rows], docs[args.batch:][rows]]),
            model.centroids, use_constraint=True, group=r.mesh.group)
    everyone = gather(r.mesh, codes)           # (W, 2b, M): positives first
    tied_share, ok = None, True
    if main:
        got = torch.cat([everyone[:, :b].reshape(-1, config.MCQ_M),
                         everyone[:, b:].reshape(-1, config.MCQ_M)])
        one = codebook.encode(docs, model.centroids, use_constraint=True)
        logq = sinkhorn.sinkhorn_log(-sinkhorn.center_distances(
            codebook.pairwise_sqdist(docs, model.centroids)),
            config.sk_epsilon, config.sk_iters)
        top2 = logq.topk(2, dim=-1).values
        tied = (top2[..., 0] - top2[..., 1] < 1e-3).T
        tied_share = float(tied.float().mean())
        ok = bool((got[~tied] == one[~tied]).all())
    r.check(ok, "constrained codes over the ranks == one GPU's except "
                "near-ties")
    del model

    seeds = torch.Generator().manual_seed(7)
    big = batch_of(args.time_batch, args.seed + 2)
    hp_t = stage1.Stage1Hparams(total_steps=100, use_constraint=True,
                                cache_chunk_size=args.time_batch // W)
    times = {}
    for name, mesh in (("sharded_ms", r.mesh), ("one_gpu_ms", None)):
        step = None
        if mesh is not None or main:
            model = copy.deepcopy(init).to(dev)
            step = stage1.make_train_step(model, hp_t, stage1.make_optimizer(
                hp_t, model), mesh)
        times[name] = r.time_ms(lambda: step(big, seeds), args.reps,
                                everyone=mesh is not None)
        del step
        if r.cuda:
            torch.cuda.empty_cache()
    r.emit("stage1_step", world=W, batch=args.batch, gaps=gaps,
           ranks_bit_identical=identical,
           constrained_codes_tied_share=tied_share,
           time_batch=args.time_batch, time_chunk=args.time_batch // W,
           **times)

    # stage 2: every rank searches its queries over all the codes
    N, M, K = args.n_docs, config.MCQ_M, config.MCQ_K
    g = torch.Generator(device=dev).manual_seed(args.seed + 5)
    index = CudaADCIndex(torch.randint(0, K, (N, M), generator=g, device=dev,
                                       dtype=torch.uint8),
                         init.centroids.detach(), device=dev)
    rng = np.random.default_rng(args.seed + 7)
    B = args.jpq_batch
    ids = rng.integers(1000, config.encoder.vocab_size, size=(B, 32))
    ids[:, 0] = 101
    positives = np.full((B, 4), -1)
    positives[:, 0] = rng.choice(N, size=B, replace=False)
    jb = {k: torch.as_tensor(v).to(dev) for k, v in {
        "query_input_ids": ids, "query_attention_mask": np.ones_like(ids),
        "qids": np.arange(B), "pos_docids": positives[:, 0],
        "query_positives": positives}.items()}
    hp2 = stage2.Stage2Hparams(total_steps=10)
    results = {}
    for name, mesh in (("sharded", r.mesh), ("one_gpu", None)):
        if mesh is None and not main:
            continue
        model = copy.deepcopy(init).to(dev)
        tx = stage1.make_optimizer(hp2.as_stage1(), model)
        step = stage2.make_train_step(model, hp2, tx, index.codes, index.N,
                                      mesh=mesh)
        results[name] = step_result(model, step(jb))
        if mesh is not None:
            identical = params_same_everywhere(r, model)
        del model, tx, step
    ok, gaps = (within_bars(results["sharded"], results["one_gpu"],
                            hp2.learning_rate, hp2.centroid_learning_rate)
                if main else (True, None))
    r.check(identical and ok, f"stage-2 step over {W} ranks == one GPU "
                              f"({gaps})")
    r.emit("stage2_step", world=W, batch=B, N=N, gaps=gaps,
           ranks_bit_identical=identical)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    mesh = create_mesh(args.device)
    r = Ranks(mesh)
    dev = mesh.device
    t0 = time.perf_counter()
    r.emit("mesh", backend=mesh.backend, world=mesh.size,
           cards=card_line() if r.cuda else None, torch=torch.__version__)
    searches(r, args, dev)
    if r.cuda:
        torch.cuda.empty_cache()
    steps(r, args, dev)
    r.emit("done", seconds=time.perf_counter() - t0, ok=True)
    mesh.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
