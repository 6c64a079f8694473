"""The port's twins of the JAX recipes that call `repconc_tpu` by name
(repconc_tpu_torch/recipes/): each carries its JAX script's steps and
flags with only the port's substitutions; make_pipeline_data.py's
complete-qrels and split-heldout write the root scripts' files byte for
byte; compression_sweep.sh runs at two values of M on toy data on the CPU;
beir_eval.sh's metric.json equals the msmarco-format eval of the same model
and data."""
import json
import os
import pathlib
import re
import shlex
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_RECIPES = ROOT / "recipes"
PORT_RECIPES = ROOT / "repconc_tpu_torch" / "recipes"
DEVICE_FLAG = ["--device", '"${DEVICE}"']


def _joined(path):
    return path.read_text().replace("\\\n", " ")


def _module_calls(path):
    """[(module, [argument tokens])] of every `-m <module> ...` call of a
    script, continuation lines joined, in order."""
    calls = []
    for line in _joined(path).split("\n"):
        m = re.search(r"(?:^|\s)-m (repconc_tpu\S*)(.*)$", line.strip())
        if m and not line.strip().startswith("#"):
            calls.append((m.group(1), shlex.split(m.group(2), posix=False)))
    return calls


def _port_name(module):
    return module.replace("repconc_tpu.", "repconc_tpu_torch.", 1)


def _steps(path):
    """[(step name, pipeline arguments)] of a held-out script's
    `step NAME bash "${PIPE}" ...` calls, in order."""
    return [(m.group(1), m.group(2).split())
            for m in re.finditer(r'step (\w+) bash "\$\{PIPE\}" ((?:(?!\|\||&&|;)[^\n])*)',
                                 _joined(path))]


def _heredocs(path):
    """The bodies of the script's `<<EOF` here-documents."""
    return re.findall(r"<<EOF\n(.*?)\nEOF", path.read_text(), re.S)


def test_heldout_matrix_has_the_jax_scripts_legs_and_values():
    """heldout_matrix.sh: round4_heldout.sh's steps through the port's
    run_pipeline.sh in the same order with the same stages (plus the
    stage 2-5 step of a LEGS subset without stage 6), the same stage0.env
    and make_env values, the split through make_pipeline_data, the same
    tars restored, and nothing written into the repository."""
    jax = JAX_RECIPES / "synthetic" / "round4_heldout.sh"
    port = PORT_RECIPES / "heldout_matrix.sh"
    jax_steps, port_steps = _steps(jax), _steps(port)
    assert [s for s in port_steps if s[0] != "shared2to5"] == jax_steps
    assert [n for n, _ in jax_steps] == [
        "stage0", "shared", "opq_eval", "jpq_only", "conc7", "conc8",
        "conc9", "conc10"]
    assert dict(port_steps)["shared2to5"] == ['"${WS}/m12.env"', "2", "3",
                                             "4", "5"]
    # stage0.env and make_env's values (the JAX script's third here-doc is
    # its table, which the twin prints beside the TPU's numbers)
    assert _heredocs(port) == _heredocs(jax)[:2]
    text = port.read_text()
    assert 'make_env "${WS}/m12.env" "CONC_STEPS=${HELDOUT_CONC_STEPS:-800}"' \
        in text
    assert ('step split python -m repconc_tpu_torch.recipes.make_pipeline_data'
            ' \\\n  split-heldout "${SRC}/data" "${WS}"') in text
    for tag in ("r5h_export_hf", "r5h_m12_conc_best"):
        assert f"restore {tag} " in text
    code = "\n".join(ln for ln in text.split("\n")
                     if not ln.lstrip().startswith("#"))
    for word in ("persist_artifacts", "git ", "save r5h", "sleep"):
        assert word not in code, word
    # no workspace default inside the checkout; each step runs whatever
    # failed before it, as in the JAX script
    assert "SRC=$1\nWS=$2\n" in code and "${1:-" not in code
    assert "&& step" not in code and "&&\n" not in code
    assert '"${REPO}/docs/heldout_r5"' in code and "> \"${REPO}" not in code
    assert [m for m, _ in _module_calls(port)] == [
        "repconc_tpu_torch.recipes.make_pipeline_data"]


def test_compression_sweep_has_the_jax_scripts_stages():
    """compression_sweep.sh: stages 5-10 per M in 48 24 16 8 over
    tas-balanced.env, through the port's run_pipeline.sh."""
    jax = _joined(JAX_RECIPES / "compression_sweep.sh")
    port = _joined(PORT_RECIPES / "compression_sweep.sh")
    assert "for M in 48 24 16 8; do" in jax
    assert "for M in ${SWEEP_M:-48 24 16 8}; do" in port
    assert ('M=${M} bash "${HERE}/run_pipeline.sh" tas-balanced.env '
            '5 6 7 8 9 10') in jax
    assert ('M=${M} bash "${HERE}/run_pipeline.sh" '
            '"${FAMILY_ENV:-tas-balanced.env}" 5 6 7 8 9 10') in port
    assert (PORT_RECIPES / "run_pipeline.sh").exists()


@pytest.mark.parametrize("name", ["beir_eval.sh", "msmarco_scale_e2e.sh"])
def test_eval_twins_have_the_jax_scripts_flags(name):
    """beir_eval.sh and msmarco_scale_e2e.sh: the same eval CLI call with
    the same arguments, plus --device; the e2e's corpus from the port's
    synth maker with the JAX maker's flags and ws8m_pretokenize_bg.sh's
    pretokenize with its flags (the tokenizer: the served model's)."""
    jax = dict(_module_calls(JAX_RECIPES / name))
    port = dict(_module_calls(PORT_RECIPES / name))
    cli = "repconc_tpu.cli.run_repconc_eval"
    assert port[_port_name(cli)] == jax[cli] + DEVICE_FLAG
    if name == "beir_eval.sh":
        text = (PORT_RECIPES / name).read_text()
        assert ('LAUNCH=(python -m torch.distributed.run --nproc_per_node '
                '"${NPROC}")') in text
        assert '"${LAUNCH[@]}" -m repconc_tpu_torch.cli.run_repconc_eval' in text
        return
    jax_text = _joined(JAX_RECIPES / name)
    maker = re.search(r'make_synth_data.py" (.*)', jax_text).group(1).split()
    assert port["repconc_tpu_torch.recipes.make_pipeline_data"] == (
        ["synth"] + maker)
    pretok = dict(_module_calls(JAX_RECIPES / "ws8m_pretokenize_bg.sh"))[
        "repconc_tpu.cli.run_pretokenize"]
    got = port["repconc_tpu_torch.cli.run_pretokenize"]
    swap = {'"${WS8M}/token_cache"': '"${WS}/token_cache"',
            '"${WS8M}/data/corpus.tsv"': '"${WS}/data/corpus.tsv"'}
    want = ['"${MODEL}"' if t.endswith("/models/synth-bert-base")
            else swap.get(t, t)
            for t in pretok if t not in (">>", '"${LOG}"', "2>&1")]
    assert sorted(zip(got[::2], got[1::2])) == sorted(zip(want[::2],
                                                          want[1::2]))


# -- the held-out split's data steps, byte for byte -------------------------------

@pytest.fixture(scope="module")
def small_synth(tmp_path_factory):
    from repconc_tpu_torch.recipes import make_pipeline_data

    root = tmp_path_factory.mktemp("synth")
    make_pipeline_data.main([
        "synth", "--out_dir", str(root / "ws"), "--n_docs", "3000",
        "--n_train_queries", "120", "--n_dev_queries", "60",
        "--hidden_layers", "1", "--hidden_size", "64"])
    return root


def _run(cmd, cwd=None, env=None, timeout=600):
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


def _tree(d):
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(pathlib.Path(d).rglob("*")) if p.is_file()}


@pytest.mark.parametrize("mode", ["complete-qrels", "split-heldout"])
def test_heldout_data_steps_equal_the_root_scripts(small_synth, mode, tmp_path):
    """complete-qrels (train and dev) and split-heldout write the files of
    recipes/synthetic/complete_qrels.py and split_queries_heldout.py byte
    for byte, with the same stdout."""
    outs = {}
    for who in ("jax", "port"):
        data = tmp_path / who / "data"
        shutil.copytree(small_synth / "ws" / "data", data)
        if mode == "complete-qrels":
            args = ["--data_dir", str(data), "--splits", "train,dev.small"]
            script = JAX_RECIPES / "synthetic" / "complete_qrels.py"
            check = data
        else:
            args = [str(data), str(tmp_path / who / "split")]
            script = JAX_RECIPES / "synthetic" / "split_queries_heldout.py"
            check = tmp_path / who / "split"
        if who == "jax":
            out = _run([sys.executable, str(script)] + args).stdout
        else:
            out = _run([sys.executable, "-m",
                        "repconc_tpu_torch.recipes.make_pipeline_data", mode]
                       + args, cwd=ROOT).stdout
        outs[who] = (_tree(check), out.replace(str(tmp_path / who), "WS"))
    assert outs["port"] == outs["jax"]
    assert len(outs["port"][0]) >= 5
    if mode == "split-heldout":
        task = tmp_path / "port" / "split" / "data_task" / "corpus.tsv"
        assert task.is_symlink()


# -- compression_sweep.sh and beir_eval.sh on toy data ----------------------------

TOY_ENV = """FAMILY=toy
HF_MODEL_DIR={ws}/models/toy-bert
POOLING=mean
METRIC_DENSE=METRIC_COS
M=${{M:-8}}
DATA_DIR={ws}/data
OUT_ROOT={ws}/experiments/toy
GLOBAL_BATCH=8
CACHE_CHUNK=-1
CONC_STEPS=2
EVAL_STEPS=100
JPQ_STEPS=2
JPQ_BATCH=32
MAX_DOC_LEN_EVAL=32
"""
SWEEP_M = ("16", "8")


@pytest.fixture(scope="module")
def toy_sweep(tmp_path_factory):
    """A toy workspace, its shared stages 2-4 through run_pipeline.sh, then
    compression_sweep.sh at M=16 and M=8 with the toy env (DEVICE=cpu),
    and the time.time() before it."""
    from repconc_tpu_torch.recipes import make_pipeline_data

    ws = tmp_path_factory.mktemp("toy_sweep")
    make_pipeline_data.make_toy(str(ws), n_docs=1000)
    env_file = ws / "toy.env"
    env_file.write_text(TOY_ENV.format(ws=ws))
    env = dict(os.environ, DEVICE="cpu", OMP_NUM_THREADS="2")
    _run(["bash", str(PORT_RECIPES / "run_pipeline.sh"), str(env_file),
          "2", "3", "4"], env=env)
    t0 = time.time()
    proc = _run(["bash", str(PORT_RECIPES / "compression_sweep.sh")],
                env=dict(env, FAMILY_ENV=str(env_file),
                         SWEEP_M=" ".join(SWEEP_M)), timeout=900)
    return ws, env, proc, t0


def test_compression_sweep_runs_two_values_of_m_on_the_cpu(toy_sweep):
    """Every stage 5-10 output at each M (recipe_runs.stage_outputs, which
    times the sweep's stages on the card), codes of M bytes, finite MRR@10
    in conc_index and jpq_index; the stages' times from their files add up
    to no more than the sweep's wall time."""
    from repconc_tpu_torch.recipes.recipe_runs import (RECIPE_STAGES,
                                                       stage_outputs,
                                                       stage_seconds)

    ws, _, _, t0 = toy_sweep
    exp = ws / "experiments" / "toy"
    stages = RECIPE_STAGES[3:]
    assert stages == ("5", "6", "7", "8", "9", "10")
    for m in SWEEP_M:
        d = exp / f"m{m}"
        for stage in stages:
            for name in stage_outputs(m)[stage]:
                assert (exp / name).exists(), (m, stage, name)
        codes = np.load(d / "conc_index" / "codes.npy")
        assert codes.shape == (1000, int(m)) and codes.dtype == np.uint8
        for leg in ("conc_index/dev", "jpq_index/dev"):
            metric = json.loads((d / leg / "metric.json").read_text())
            assert np.isfinite(metric["mrr"]["MRR@10"]), (m, leg)
    by_m = stage_seconds(str(exp), SWEEP_M, stages, t0)
    times = [s for m in SWEEP_M for s in by_m[m].values()]
    assert len(times) == 12 and min(times) > 0
    assert sum(times) <= time.time() - t0


def test_beir_eval_equals_the_msmarco_eval(toy_sweep, tmp_path):
    """beir_eval.sh over a BEIR-layout copy of the toy dev split, with the
    stage-8 model, length and batch: metric.json equal to stage 8's
    msmarco-format eval of the same model and data, and the same run."""
    ws, env, _, _ = toy_sweep
    from repconc_tpu_torch.recipes import make_pipeline_data

    beir = tmp_path / "beir"
    make_pipeline_data.beir_layout(str(ws / "data"), "dev.small", str(beir))
    exp = ws / "experiments" / "toy" / "m8"
    model = exp / "conc" / ("best" if (exp / "conc" / "best").is_dir()
                            else "final")
    out = tmp_path / "out"
    _run(["bash", str(PORT_RECIPES / "beir_eval.sh"), str(beir), str(out),
          str(model)], env=dict(env, MAX_SEQ_LEN="32", EVAL_BATCH="256"))
    got = json.loads((out / "test" / "metric.json").read_text())
    want = json.loads((exp / "conc_index" / "dev" / "metric.json").read_text())
    assert got == want
    assert (out / "test" / "run.tsv").read_text() == (
        exp / "conc_index" / "dev" / "run.tsv").read_text()
    np.testing.assert_array_equal(np.load(out / "codes.npy"),
                                  np.load(exp / "conc_index" / "codes.npy"))
