"""The port's run_synth.sh and run_matrix.sh run for real on the CPU
(DEVICE=cpu), through `recipe_runs.py synth` and `recipe_runs.py matrix`
as on the card, over a small make_pipeline_data.py synth workspace (1
layer, 96 wide: 96 divides by 48, 12 and 4; 1,000 docs) at 2 steps a
stage: stage 0 and every stage after it through the port's
run_pipeline.sh, the IVF evals, then the matrix at M=4 (flat) with its
siblings and the -lowmse leg through the symlinked warm-up. Every
metric.json of both closing tables is finite, and recipe_runs.py prints
the cuts, stage times and legs it reads."""
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = {"DEVICE": "cpu", "OMP_NUM_THREADS": "2", "DENSE_STEPS": "2",
         "DENSE_EVAL_STEPS": "2", "DENSE_BATCH": "16", "CONC_STEPS": "2",
         "EVAL_STEPS": "2", "JPQ_STEPS": "2", "GLOBAL_BATCH": "8",
         "JPQ_BATCH": "16", "NLIST": "16", "NPROBE": "8",
         "MATRIX_M": "4", "LOWMSE_M": "4"}
SYNTH_STAGES = ["0", "2", "3", "4", "5", "6", "7", "8", "9", "10",
                "opq-eval", "jpq-train", "jpq-eval"]
MATRIX_STAGES = ([f"matrix_m4/{s}" for s in ("5", "7", "8", "9", "10",
                                              "opq-eval", "jpq-train",
                                              "jpq-eval")]
                 + [f"matrix_m4_lowmse/{s}" for s in ("7", "8", "9", "10")])


def _lines(stdout):
    return [json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith("{")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workspace, recipe_runs.py synth's and matrix's JSON lines."""
    from repconc_tpu_torch.recipes import make_pipeline_data

    ws = tmp_path_factory.mktemp("synth_runs") / "ws"
    make_pipeline_data.main([
        "synth", "--out_dir", str(ws), "--n_docs", "1000",
        "--n_train_queries", "400", "--n_dev_queries", "100",
        "--hidden_layers", "1", "--hidden_size", "96"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(SMALL)
    out = {"ws": ws}
    for cmd in ("synth", "matrix"):
        proc = subprocess.run(
            [sys.executable, "-m", "repconc_tpu_torch.recipes.recipe_runs",
             cmd, str(ws)] + (["--n_docs", "1000"] if cmd == "synth" else []),
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        out[cmd] = _lines(proc.stdout)
    return out


def _finite_metrics(m):
    return all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values())


def test_synth_runs_stage_0_and_every_stage_after_it(runs):
    """Every stage of run_synth.sh, stage 0 first, through the port's
    run_pipeline.sh: each one's files (recipe_runs.stage_outputs), synth.env's
    HF_MODEL_DIR at stage 0's export, and the IVF built at nlist 16."""
    from repconc_tpu_torch.recipes.recipe_runs import stage_outputs

    ws = runs["ws"]
    out_root = ws / "experiments" / "synth"
    synth = runs["synth"][-1]
    assert synth["run"] == "synth"
    assert list(synth["stage_s"]) == SYNTH_STAGES
    outputs = stage_outputs("48")
    for stage in SYNTH_STAGES:
        for name in outputs[stage]:
            # the matrix moved synth's m48/ aside
            path = out_root / name.replace("m48/", "m48.synth/")
            assert path.exists(), (stage, name)
    assert (f"HF_MODEL_DIR={out_root}/dense_pretrain/export_hf\n"
            in (ws / "synth.env").read_text())
    assert synth["widths"] == {
        "num_hidden_layers": 1, "hidden_size": 96, "num_attention_heads": 1,
        "vocab_size": 7905, "queries_train": 400, "queries_dev.small": 100}
    for leg in ("conc_index", "opq_index", "warmup_index"):
        z = np.load(out_root / "m48.synth" / leg / "ivf_index.npz")
        assert z["cell_ids"].shape[0] == 16


def test_synth_closing_table_is_finite(runs):
    """The five metric.json files of run_synth.sh's closing table exist
    with finite metrics in [0, 1]; recipe_runs.py prints each leg's
    metrics, phases, Lpad, spill and planned passes, and the dense leg."""
    root = runs["ws"] / "experiments" / "synth"
    for name in ("dense/dev", "m48.synth/conc_index/dev",
                 "m48.synth/jpq_index/dev", "m48.synth/opq_index/dev",
                 "m48.synth/jpq_only_index/dev"):
        m = json.loads((root / name / "metric.json").read_text())
        assert _finite_metrics({"mrr": m["mrr"]["MRR@10"],
                                "ndcg": m["ndcg"]["NDCG@10"],
                                "r100": m["recall"]["Recall@100"]}), name
    legs = {r["leg"]: r for r in runs["synth"] if r["run"] == "synth_leg"}
    assert sorted(legs) == ["m48/conc_index", "m48/jpq_index",
                            "m48/jpq_only_index", "m48/opq_index"]
    for leg in legs.values():
        assert _finite_metrics(leg["metrics"])
        assert leg["docs"] == 1000 and leg["bytes_per_doc"] == 48.0
        assert leg["nlist"] == 16 and leg["Lpad"] % 128 == 0
        assert isinstance(leg["k2_pass1"], bool) and "search" in leg["timings"]
    assert "encode_corpus" in legs["m48/conc_index"]["timings"]
    assert "encode_corpus" not in legs["m48/jpq_index"]["timings"]
    assert _finite_metrics(runs["synth"][-1]["dense"])


def test_jpq_eval_reused_the_warmup_codes(runs):
    """jpq-eval scored the warm-up index's codes as stage 5 wrote them
    (written before jpq-train's model, loaded, not encoded again), and
    opq-eval's encode with the warm-up model gave those codes again."""
    root = runs["ws"] / "experiments" / "synth"
    for exp in ("m48.synth", "m4"):
        idx = root / exp / "warmup_index" / "codes.npy"
        assert idx.stat().st_mtime < (
            root / exp / "jpq_only" / "final").stat().st_mtime
        np.testing.assert_array_equal(
            np.load(root / exp / "opq_index" / "codes.npy"), np.load(idx))
    legs = {r["leg"]: r for r in runs["synth"] + runs["matrix"]
            if r["run"].endswith("_leg")}
    for leg in ("m48/jpq_only_index", "m4/jpq_only_index"):
        assert "encode_corpus" not in legs[leg]["timings"], leg


def test_matrix_runs_m4_flat_with_its_siblings_and_lowmse(runs):
    """run_matrix.sh at MATRIX_M=4 LOWMSE_M=4 after synth's m48/ was moved
    aside: every stage, the closing table's metric.json for m4 and
    m4-lowmse finite, 4-byte codes, flat searches; the -lowmse stage 7
    trained from the symlinked warm-up (its argv, from the launch log)."""
    from repconc_tpu_torch.recipes.recipe_runs import read_launch_log

    ws = runs["ws"]
    root = ws / "experiments" / "synth"
    setup, matrix = runs["matrix"][0], runs["matrix"][-1]
    assert setup["moved_aside"] == f"{root}/m48 -> {root}/m48.synth"
    assert not (root / "m48").exists()
    assert list(matrix["stage_s"]) == MATRIX_STAGES
    legs = {r["leg"]: r for r in runs["matrix"] if r["run"] == "matrix_leg"}
    assert sorted(legs) == sorted(
        [f"m4/{leg}" for leg in ("opq_index", "jpq_only_index", "conc_index",
                                 "jpq_index")]
        + ["m4-lowmse/conc_index", "m4-lowmse/jpq_index"])
    for leg in legs.values():
        assert _finite_metrics(leg["metrics"])
        assert leg["bytes_per_doc"] == 4.0 and "Lpad" not in leg
        assert isinstance(leg["k1_pass1"], bool)
    link = root / "m4-lowmse" / "warmup_model"
    assert link.is_symlink() and os.readlink(link) == "../m4/warmup_model"
    stage7 = [r["argv"] for r in read_launch_log(str(ws / "launch_log_matrix"))
              if r["argv"][0].endswith("run_train_conc.py")]
    flags = [dict(zip(a, a[1:])) for a in stage7]
    assert [(f["--model_name_or_path"], f["--output_dir"]) for f in flags] == [
        (f"{root}/m4/warmup_model", f"{root}/m4/conc"),
        (f"{root}/m4-lowmse/warmup_model", f"{root}/m4-lowmse/conc")]
    assert [f["--mse_loss_weight"] for f in flags] == ["0.01", "1e-4"]
    assert (root / "m4-lowmse" / "conc" / "final" / "params.msgpack").exists()


def test_recipe_runs_prints_the_cuts_and_stage_seconds(runs):
    """Both commands print their setup line first, with every depth cut
    at the value the environment gave and the scripts' own value, and
    their summary line last, with the card line and each stage's wall
    seconds from the stage-times file."""
    for cmd in ("synth", "matrix"):
        setup, last = runs[cmd][0], runs[cmd][-1]
        assert setup["run"] == f"{cmd}_setup" and last["run"] == cmd
        assert setup["cuts"]["DENSE_STEPS"].startswith("2 (the script: 2000)")
        assert setup["cuts"]["CONC_STEPS"].startswith("2 (the script: 800)")
        assert setup["card"] and last["card"]
        assert all(isinstance(s, int) and s >= 0
                   for s in last["stage_s"].values())
        assert last["wall_s"] >= sum(last["stage_s"].values()) - len(
            last["stage_s"])
    assert runs["synth"][0]["nlist"] == "16"
    assert runs["matrix"][0]["matrix_m"] == "4"
