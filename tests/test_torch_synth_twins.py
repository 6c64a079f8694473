"""The port's twins of recipes/synthetic/run_synth.sh and run_matrix.sh
(repconc_tpu_torch/recipes/), each run beside a stub run_pipeline.sh that
logs every stage it is given and the env file's bytes, against the JAX
script run the same way under the same workspace path: the same stages in
the same order, the same env files byte for byte, the same symlinks. The
twins' listed departures: DEVICE (default cuda) reaches run_pipeline.sh, and
run_matrix.sh's MATRIX_M and LOWMSE_M pick a subset of its loops."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_DIR = ROOT / "recipes" / "synthetic"
PORT_DIR = ROOT / "repconc_tpu_torch" / "recipes"

STUB = """#!/bin/bash
# stub run_pipeline.sh: log the stage, the DEVICE it was given and the env file
{ echo "== $(basename "$1") $2 DEVICE=${DEVICE-unset}"; cat "$1"; } >> "${STUB_LOG}"
"""
# the knobs both scripts read from the environment, at values other than
# their defaults
KNOBS = {"DENSE_STEPS": "7", "DENSE_BATCH": "16", "DENSE_LR": "3e-4",
         "DENSE_EVAL_STEPS": "5", "CACHE_CHUNK": "-1", "GLOBAL_BATCH": "8",
         "CONC_STEPS": "3", "JPQ_STEPS": "4", "JPQ_BATCH": "32",
         "EVAL_STEPS": "2", "MAX_DOC_LEN_EVAL": "64", "NLIST": "16",
         "NPROBE": "8"}


def _run(who, name, ws, env_extra, tmp_path):
    """Run the JAX script (who="jax", reaching ${HERE}/../run_pipeline.sh)
    or its twin (who="port", ${HERE}/run_pipeline.sh) beside the stub, on a
    fresh workspace at `ws` whose corpus exists (so no data step runs).
    Returns the stub's log, the workspace's files (symlinks as their
    targets) and the stage column of its stage-times file."""
    tree = tmp_path / who
    shutil.rmtree(tree, ignore_errors=True)
    script_dir = tree / "synthetic" if who == "jax" else tree
    script_dir.mkdir(parents=True)
    src = (JAX_DIR if who == "jax" else PORT_DIR) / name
    shutil.copy(src, script_dir / name)
    (tree / "run_pipeline.sh").write_text(STUB)
    shutil.rmtree(ws, ignore_errors=True)
    (ws / "data").mkdir(parents=True)
    (ws / "data" / "corpus.tsv").write_text("0\tdoc\n")
    log = tmp_path / f"{who}.log"
    log.unlink(missing_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in KNOBS and k not in ("DEVICE", "PRETRAIN", "MATRIX_M",
                                           "LOWMSE_M")}
    env.update(env_extra, STUB_LOG=str(log))
    args = [str(ws)] + (["500"] if name == "run_synth.sh" else [])
    proc = subprocess.run(["bash", str(script_dir / name)] + args, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    files = {}
    for p in sorted(ws.rglob("*")):
        rel = str(p.relative_to(ws))
        if p.is_symlink():
            files[rel] = "-> " + os.readlink(p)
        elif p.is_file() and not p.name.startswith("stage_times"):
            files[rel] = p.read_bytes()
    times = sorted(ws.glob("stage_times*.tsv"))
    assert len(times) == 1
    stages = [ln.split("\t")[0] for ln in times[0].read_text().splitlines()]
    return log.read_text(), files, stages


def _strip_device(log):
    """The stub's log with each stage line's DEVICE=... cut off, and the
    DEVICE values seen."""
    lines, devices = [], set()
    for ln in log.splitlines():
        if ln.startswith("== "):
            ln, _, dev = ln.rpartition(" DEVICE=")
            devices.add(dev)
        lines.append(ln)
    return "\n".join(lines), devices


@pytest.mark.parametrize("name,env", [
    ("run_synth.sh", {}),
    ("run_synth.sh", {"PRETRAIN": "0"}),
    ("run_synth.sh", KNOBS),
    ("run_matrix.sh", {}),
    ("run_matrix.sh", KNOBS),
], ids=["synth-pretrain", "synth-no-pretrain", "synth-knobs", "matrix",
        "matrix-knobs"])
def test_twin_runs_the_jax_scripts_stages_with_the_same_env_files(
        name, env, tmp_path):
    """The same stages through run_pipeline.sh in the same order, each given
    the same env file bytes; the same files and symlinks left in the
    workspace; the same stage-times rows. DEVICE reaches the port's
    run_pipeline.sh as cuda by default and is unset in the JAX script's."""
    ws = tmp_path / "ws"
    jax_log, jax_files, jax_stages = _run("jax", name, ws, env, tmp_path)
    port_log, port_files, port_stages = _run("port", name, ws, env, tmp_path)
    jax_log, jax_dev = _strip_device(jax_log)
    port_log, port_dev = _strip_device(port_log)
    assert port_log == jax_log
    assert port_files == jax_files
    assert port_stages == jax_stages
    assert jax_dev == {"unset"} and port_dev == {"cuda"}
    heads = [ln[3:] for ln in port_log.splitlines() if ln.startswith("== ")]
    if name == "run_synth.sh":
        after = ["synth.env " + s for s in
                 "2 3 4 5 6 7 8 9 10 opq-eval jpq-train jpq-eval".split()]
        first = [] if env.get("PRETRAIN") == "0" else ["stage0.env 0"]
        assert heads == first + after
        want_hf = ("experiments/synth/dense_pretrain/export_hf"
                   if env.get("PRETRAIN") != "0" else "models/synth-bert-base")
        assert f"HF_MODEL_DIR={ws}/{want_hf}\n".encode() in \
            port_files["synth.env"]
        assert b"IVF=1\nNLIST=" in port_files["synth.env"]
        assert b"\nM=48\n" in port_files["synth.env"]
    else:
        sib = "5 7 8 9 10 opq-eval jpq-train jpq-eval".split()
        assert heads == (
            [f"matrix_m{m}.env {s}" for m in (48, 12, 4) for s in sib]
            + [f"matrix_m{m}_lowmse.env {s}" for m in (4, 12)
               for s in ("7", "8", "9", "10")])
        for m in (4, 12):
            assert port_files[f"experiments/synth/m{m}-lowmse/warmup_model"] \
                == f"-> ../m{m}/warmup_model"
        assert b"IVF" not in port_files["matrix_m48.env"]
        assert port_files["matrix_m4_lowmse.env"].endswith(
            b"MSE_WEIGHT=1e-4\nEXP_TAG=-lowmse\n")
    if env is KNOBS:  # the knobs reached the env files
        env_file = "synth.env" if name == "run_synth.sh" else "matrix_m12.env"
        assert b"CONC_STEPS=3\nJPQ_STEPS=4\n" in port_files[env_file]
        if name == "run_synth.sh":
            assert b"DENSE_STEPS=7\n" in port_files["stage0.env"]


def test_matrix_subset_is_the_defaults_run_at_those_m(tmp_path):
    """MATRIX_M=4 LOWMSE_M=4 (the CPU runs' subset) runs exactly the
    default run's stages at M=4, with the same env files and symlink."""
    ws = tmp_path / "ws"
    full_log, full_files, _ = _run("port", "run_matrix.sh", ws, {}, tmp_path)
    sub_log, sub_files, _ = _run("port", "run_matrix.sh", ws,
                                 {"MATRIX_M": "4", "LOWMSE_M": "4"}, tmp_path)
    blocks = full_log.split("== ")[1:]
    want = [b for b in blocks if b.startswith(("matrix_m4.env",
                                               "matrix_m4_lowmse.env"))]
    assert sub_log.split("== ")[1:] == want
    assert sub_files == {k: v for k, v in full_files.items()
                         if k.startswith("data/")
                         or ("m4" in k and "m48" not in k)}


# -- recipe_runs.py's helpers for the twins' runs ----------------------------------

def test_launch_hook_writes_each_port_process_counts(tmp_path):
    """A process started with recipe_runs.launch_env writes one record at
    exit, its argv and every launch counter (all 0 on the CPU), when it
    loaded the port; a process that did not writes nothing; a
    sitecustomize.py further on PYTHONPATH still runs."""
    from repconc_tpu_torch.index.launches import counts
    from repconc_tpu_torch.recipes.recipe_runs import (launch_env,
                                                       launches_by_output,
                                                       read_launch_log)

    other = tmp_path / "other"
    other.mkdir()
    (other / "sitecustomize.py").write_text(
        "import os\nopen(os.environ['MARK'], 'a').write('x')\n")
    log_dir = tmp_path / "log"
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{other}",
               MARK=str(tmp_path / "mark"))
    env = launch_env(env, str(log_dir))
    for code in ("import repconc_tpu_torch.index.cuda_adc", "pass"):
        proc = subprocess.run([sys.executable, "-c", code, "--out_query_dir",
                               "/o/m4/dev"], env=env, cwd=tmp_path,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
    records = read_launch_log(str(log_dir))
    assert len(records) == 1
    assert records[0]["argv"] == ["-c", "--out_query_dir", "/o/m4/dev"]
    assert records[0]["counts"] == dict.fromkeys(counts(), 0)
    assert (tmp_path / "mark").read_text() == "xx"
    assert launches_by_output(records, "/o") == {}
    records[0]["counts"]["adc_filter"] = 2
    assert launches_by_output(records, "/o") == {"-c m4/dev": {"adc_filter": 2}}


def test_depth_cuts_take_the_environment_first():
    """Each depth cut is recipe_runs' value unless the environment sets
    it, and prints beside the scripts' own value."""
    from repconc_tpu_torch.recipes.recipe_runs import (SYNTH_DEPTH, depth_cuts,
                                                       depth_env)

    env = depth_env({"CONC_STEPS": "5", "NLIST": "16"})
    assert env["CONC_STEPS"] == "5" and env["NLIST"] == "16"
    assert {k: env[k] for k in SYNTH_DEPTH if k != "CONC_STEPS"} == {
        "DENSE_STEPS": "100", "DENSE_EVAL_STEPS": "50", "JPQ_STEPS": "20",
        "EVAL_STEPS": "20"}
    cuts = depth_cuts(env)
    assert cuts["CONC_STEPS"] == "5 (the script: 800): stage 7's steps"
    assert cuts["DENSE_STEPS"].startswith("100 (the script: 2000)")


def test_stage_times_and_metrics_are_read_as_written(tmp_path):
    """stage_times.tsv's rows (run_stage's `<stage>\\t<n>s`) in order, and
    metric.json's three headline numbers."""
    from repconc_tpu_torch.recipes.recipe_runs import (read_metrics,
                                                       read_stage_times)

    (tmp_path / "t.tsv").write_text("0\t12s\nmatrix_m4/opq-eval\t3s\n")
    assert read_stage_times(str(tmp_path / "t.tsv")) == {
        "0": 12, "matrix_m4/opq-eval": 3}
    (tmp_path / "m.json").write_text(json.dumps({
        "mrr": {"MRR@10": 0.5}, "ndcg": {"NDCG@10": 0.25},
        "recall": {"Recall@100": 0.75, "Recall@1000": 1.0}}))
    assert read_metrics(str(tmp_path / "m.json")) == {
        "MRR@10": 0.5, "NDCG@10": 0.25, "R@100": 0.75}
