"""Timed runs of the port's recipe twins on a card, each printed as one JSON
line with the card's `nvidia-smi` name and power limit.

    python -m repconc_tpu_torch.recipes.recipe_runs sweep WS
    python -m repconc_tpu_torch.recipes.recipe_runs e2e WS [--n_docs 1000000]

sweep: chip_smoke.py's pipeline_recipe inputs (RECIPE_ENV and the rest
below: make_pipeline_data.py synth at the M=12 model's widths: bert-base,
vocab 7,905, mean pooling; 2 of 12 layers, 40,000 docs), with the stage-7
and stage-9 steps at 20 (SWEEP_ENV), stages 2-4 through run_pipeline.sh,
then compression_sweep.sh once over that family (SWEEP_M, default 48 24
16 8). Each stage's wall seconds per M run from the time its last file
was written (stage_outputs) to the time the stage before wrote its last;
for each M the codes' bytes per doc and the MRR@10 of stages 8 and 10.

e2e: a seeded model dir at the M=12 model's widths (make_pipeline_data.py
synth, 12 layers, 40,000 docs; stages 2, 3 and 5 through run_pipeline.sh:
the OPQ warm-up of the seeded encoder, M=12), then msmarco_scale_e2e.sh
over n_docs docs with it: each line of its output stamped with the seconds
since the start, and its timings.json.

DEVICE (default cuda) reaches every CLI. Every step runs as a subprocess
of the committed scripts; this file only times them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

# chip_smoke.py's pipeline_recipe configuration: the M=12 model's widths
# (bert-base, the 7,905-word synthetic vocabulary, mean pooling, M=12,
# K=256), depth and scale cut to fit about 150 s; each cut is printed.
# 40,000 docs and 32 of 40 cells are the least that makes both passes of
# each search run at top-1000: K1's pass 1 needs 1,000 groups of 32 docs,
# K2's a probe of 1,000 runs of 32 (nprobe * Lpad / 32, Lpad at least the
# mean cell of 1,000 docs); below that every doc passes and pass 1 is
# skipped
RECIPE_DOCS, RECIPE_LAYERS = 40_000, 2
RECIPE_ENV = {"POOLING": "mean", "METRIC_DENSE": "METRIC_IP", "M": "12",
              "GLOBAL_BATCH": "64", "CONC_STEPS": "10", "EVAL_STEPS": "10",
              "JPQ_STEPS": "10", "NLIST": "40", "NPROBE": "32"}
RECIPE_CUTS = {
    "encoder_layers": f"{RECIPE_LAYERS} of bert-base's 12 (widths kept)",
    "corpus": f"{RECIPE_DOCS:,} synthetic docs (make_pipeline_data synth), "
              "not MS MARCO's 8,841,823",
    "queries": "4,000 train and 500 dev (the maker's defaults)",
    "stage_7": "10 steps at 64 queries, one validation (the recipe: "
               "2,000 steps at 4,096, every 40)",
    "stage_9": "10 steps (the recipe: 4,000) at the recipe's 128 queries",
    "ivf": "nlist 40, nprobe 32 (the recipe: 5,000 and 64, for 8.8 M docs)"}
RECIPE_STAGES = ("2", "3", "4", "5", "6", "7", "8", "9", "10")
# the sweep: M from compression_sweep.sh, stages 7 and 9 at 20 steps (its
# runs in PERF.md took 20)
SWEEP_ENV = dict(RECIPE_ENV, M="${M:-12}", CONC_STEPS="20", EVAL_STEPS="20",
                 JPQ_STEPS="20")


def stage_outputs(m="12") -> dict:
    """Each stage's files, under OUT_ROOT, at M=m."""
    e = f"m{m}"
    return {
        "2": ("dense_model/config.json",),
        "3": ("dense/corpus_embeds.npy", "dense/dev/run.tsv",
              "dense/dev/metric.json"),
        "4": ("valid/corpus.tsv", "valid/queries.tsv", "valid/qrels.tsv"),
        "5": (f"{e}/warmup_model/params.msgpack", f"{e}/warmup_index/codes.npy"),
        "6": (f"{e}/warmup_run/train/run.tsv", "hardneg.json"),
        "7": (f"{e}/conc/final/params.msgpack",),
        "8": (f"{e}/conc_index/codes.npy", f"{e}/conc_index/dev/run.tsv",
              f"{e}/conc_index/dev/metric.json"),
        "9": (f"{e}/jpq/final/params.msgpack",),
        "10": (f"{e}/jpq_index/dev/metric.json",)}


def write_env(path: str, ws: str, env: dict = RECIPE_ENV) -> None:
    """The family env of a make_pipeline_data.py synth workspace `ws`."""
    with open(path, "w") as f:
        f.write("FAMILY=synth\n"
                f"HF_MODEL_DIR={ws}/models/synth-bert-base\n"
                f"DATA_DIR={ws}/data\nOUT_ROOT={ws}/experiments/synth\n"
                + "".join(f"{k}={v}\n" for k, v in env.items()))


def stage_seconds(out_root: str, ms, stages, t0: float) -> dict:
    """Per M, each stage's wall seconds in the order they ran: from the
    time.time() at which the stage before (or the run, at t0) wrote its
    last file under m<M>/ to the time this stage wrote its last. Files
    outside m<M>/ are rewritten at each M (stage 6's hardneg.json), so
    they are left out: the extraction's seconds count toward stage 7."""
    out, last = {}, t0
    for m in ms:
        files = stage_outputs(m)
        out[m] = {}
        for stage in stages:
            end = max(os.path.getmtime(os.path.join(out_root, p))
                      for p in files[stage] if p.startswith(f"m{m}/"))
            out[m][stage], last = end - last, end
    return out


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def emit(what: str, **fields) -> None:
    print(json.dumps({"run": what, **fields}), flush=True)


def env_with_repo() -> dict:
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, DEVICE=os.environ.get("DEVICE", "cuda"),
                PATH=os.path.dirname(sys.executable) + os.pathsep
                + os.environ["PATH"],
                PYTHONPATH=REPO + (os.pathsep + path if path else ""))


def run(cmd, env, log_path: str) -> float:
    """Run `cmd` with its output in `log_path`; its wall seconds. A failure
    raises with the log's tail."""
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.run(cmd, env=env, stdout=log,
                              stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        with open(log_path) as f:
            raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                               + f.read()[-4000:])
    return time.perf_counter() - t0


def make_data(ws: str, env: dict, n_docs: int, layers: int, log: str) -> float:
    return run([sys.executable, "-m",
                "repconc_tpu_torch.recipes.make_pipeline_data", "synth",
                "--out_dir", ws, "--n_docs", str(n_docs),
                "--hidden_layers", str(layers)], env, log)


def sweep(ws: str, ms: str, docs: int, layers: int) -> None:
    env = env_with_repo()
    os.makedirs(ws, exist_ok=True)
    emit("sweep_setup", card=card_line(), env=SWEEP_ENV, docs=docs,
         encoder_layers=layers, sweep_m=ms)
    shared = {"data": make_data(ws, env, docs, layers,
                                os.path.join(ws, "data.log"))}
    env_file = os.path.join(ws, "synth.env")
    write_env(env_file, ws, SWEEP_ENV)
    for stage in ("2", "3", "4"):
        shared[stage] = run(["bash", os.path.join(HERE, "run_pipeline.sh"),
                             env_file, stage], env,
                            os.path.join(ws, f"stage{stage}.log"))
    emit("sweep_shared_stages", stage_s=shared)

    out_root = os.path.join(ws, "experiments", "synth")
    t0 = time.time()
    wall = run(["bash", os.path.join(HERE, "compression_sweep.sh")],
               dict(env, FAMILY_ENV=env_file, SWEEP_M=ms),
               os.path.join(ws, "sweep.log"))
    by_m = stage_seconds(out_root, ms.split(), RECIPE_STAGES[3:], t0)
    for m in ms.split():
        stage_s = by_m[m]
        d = os.path.join(out_root, f"m{m}")
        codes = np.load(os.path.join(d, "conc_index", "codes.npy"),
                        mmap_mode="r")
        mrr = {}
        for leg in ("conc_index/dev", "jpq_index/dev"):
            with open(os.path.join(d, leg, "metric.json")) as f:
                mrr[leg] = json.load(f)["mrr"]["MRR@10"]
        emit("sweep_m", M=int(m), stage_s=stage_s,
             stages_5_to_10_s=sum(stage_s.values()),
             index_bytes_per_doc=codes.nbytes / codes.shape[0],
             compression_x=768 * 4 / (codes.nbytes / codes.shape[0]),
             docs=int(codes.shape[0]), mrr_at_10=mrr)
    emit("sweep", wall_s=wall, card=card_line())


def e2e(ws: str, n_docs: int, model_docs: int, model_layers: int) -> None:
    env = env_with_repo()
    model_ws = os.path.join(ws, "model_ws")
    os.makedirs(model_ws, exist_ok=True)
    emit("e2e_setup", card=card_line(), docs=n_docs,
         model=f"seeded bert-base widths ({model_layers} layers, vocab "
               f"7,905, mean pooling), OPQ warm-up at M=12 over "
               f"{model_docs:,} docs")
    prep = {"data": make_data(model_ws, env, model_docs, model_layers,
                              os.path.join(model_ws, "data.log"))}
    env_file = os.path.join(model_ws, "synth.env")
    write_env(env_file, model_ws, {"POOLING": "mean",
                                   "METRIC_DENSE": "METRIC_IP", "M": "12",
                                   "MAX_DOC_LEN_EVAL": "128"})
    for stage in ("2", "3", "5"):
        prep[stage] = run(["bash", os.path.join(HERE, "run_pipeline.sh"),
                           env_file, stage], env,
                          os.path.join(model_ws, f"stage{stage}.log"))
    emit("e2e_model", stage_s=prep)
    model = os.path.join(model_ws, "experiments", "synth", "m12",
                         "warmup_model")
    e2e_ws = os.path.join(ws, "e2e")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        ["bash", os.path.join(HERE, "msmarco_scale_e2e.sh"), e2e_ws, model,
         str(n_docs)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    stamped = []
    with open(os.path.join(ws, "e2e.log"), "w") as log:
        for line in proc.stdout:
            t = time.perf_counter() - t0
            log.write(f"{t:10.2f} {line}")
            stamped.append((t, line.rstrip("\n")))
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError("msmarco_scale_e2e.sh exited "
                           f"{rc}:\n" + "\n".join(l for _, l in stamped[-40:]))
    marks = {}
    for t, line in stamped:
        if "synthetic workspace at" in line:
            marks["data_done_s"] = t
        elif "token cache written" in line:
            marks["pretokenize_done_s"] = t
        elif line.startswith("end-to-end wall:"):
            marks["eval_done_s"] = t
            marks["eval_wall"] = line.split(":", 1)[1].strip()
    with open(os.path.join(e2e_ws, "eval", "dev", "timings.json")) as f:
        timings = json.load(f)
    with open(os.path.join(e2e_ws, "eval", "dev", "metric.json")) as f:
        metric = json.load(f)
    emit("e2e", docs=n_docs, wall_s=time.perf_counter() - t0, marks=marks,
         timings=timings, mrr_at_10=metric["mrr"]["MRR@10"],
         recall_at_100=metric["recall"]["Recall@100"],
         card=card_line())


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("sweep")
    s.add_argument("ws")
    s.add_argument("--sweep_m", default="48 24 16 8")
    s.add_argument("--docs", type=int, default=40_000)
    s.add_argument("--layers", type=int, default=2)
    e = sub.add_parser("e2e")
    e.add_argument("ws")
    e.add_argument("--n_docs", type=int, default=1_000_000)
    e.add_argument("--model_docs", type=int, default=40_000)
    e.add_argument("--model_layers", type=int, default=12)
    args = p.parse_args(argv)
    if args.cmd == "sweep":
        sweep(args.ws, args.sweep_m, args.docs, args.layers)
    else:
        e2e(args.ws, args.n_docs, args.model_docs, args.model_layers)


if __name__ == "__main__":
    main()
