"""The port's pipeline recipe (repconc_tpu_torch/recipes/): run_pipeline.sh
against the JAX driver's stages and flags, make_pipeline_data.py against the
JAX makers' files byte for byte, its model dir in HF and in the port, and
one end-to-end CPU run of run_toy.sh with `transformers` not importable."""
import json
import math
import os
import pathlib
import re
import shlex
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_RECIPES = ROOT / "repconc_tpu_torch" / "recipes"
DATA_FILES = ("data/corpus.tsv", "data/queries.train.tsv",
              "data/queries.dev.small.tsv", "data/qrels.train.tsv",
              "data/qrels.dev.small.tsv")
TOKENIZER_FILES = ("vocab.txt", "tokenizer.json", "tokenizer_config.json",
                   "special_tokens_map.json")


def _stage_calls(path):
    """{stage: [(cli module's last name, [argument tokens])]} of a driver's
    `case` blocks: every `python -m ...` call, its continuation lines
    joined."""
    text = path.read_text().replace("\\\n", " ")
    body = text[text.index('case $STAGE in'):]
    stages = {}
    for m in re.finditer(r"^([\w-]+)\)\n(.*?)\n\s*;;", body, re.S | re.M):
        calls = []
        for line in m.group(2).split("\n"):
            line = line.strip()
            if line.startswith("python -m "):
                tokens = shlex.split(line, posix=False)
                calls.append((tokens[2].rsplit(".", 1)[-1], tokens[3:]))
        stages[m.group(1)] = calls
    return stages


def test_run_pipeline_has_the_jax_drivers_stages_and_flags():
    """The port's driver runs the JAX driver's stages with the same CLIs
    and, per call, the same arguments, apart from the module prefix and
    `--device "${DEVICE}"` on the CLIs that take a device."""
    jax_stages = _stage_calls(ROOT / "recipes" / "run_pipeline.sh")
    port_stages = _stage_calls(PORT_RECIPES / "run_pipeline.sh")
    assert list(port_stages) == list(jax_stages)
    assert set(jax_stages) >= {"0", "2", "3", "4", "5", "6", "7", "8", "9",
                               "10", "opq-eval", "jpq-train", "jpq-eval"}
    text = (PORT_RECIPES / "run_pipeline.sh").read_text()
    assert "python -m repconc_tpu.cli" not in text
    device_clis = {"run_train_dense", "run_dense_eval", "run_warmup",
                   "run_repconc_eval", "run_train_conc", "run_train_jpq"}
    for stage, calls in jax_stages.items():
        port_calls = port_stages[stage]
        assert [c for c, _ in port_calls] == [c for c, _ in calls], stage
        for (cli, args), (_, port_args) in zip(calls, port_calls):
            want = args + (['--device', '"${DEVICE}"'] if cli in device_clis
                           else [])
            assert port_args == want, (stage, cli)
    for line in re.findall(r"python -m (\S+)", text):
        assert line.startswith("repconc_tpu_torch.cli."), line


def test_every_device_cli_takes_device():
    """The CLIs the driver passes --device to take it; the others do not."""
    for cli in ("run_train_dense", "run_dense_eval", "run_warmup",
                "run_repconc_eval", "run_train_conc", "run_train_jpq"):
        assert '"--device"' in (ROOT / "repconc_tpu_torch" / "cli"
                                / f"{cli}.py").read_text(), cli
    for cli in ("run_customize_dense", "run_gen_valid_set",
                "run_extract_hardneg"):
        assert '"--device"' not in (ROOT / "repconc_tpu_torch" / "cli"
                                    / f"{cli}.py").read_text(), cli


def _run(cmd, cwd, env=None, timeout=600):
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


MAKERS = {
    "toy": (ROOT / "recipes" / "toy" / "make_toy_data.py", "toy-bert",
            ["--n_docs", "300", "--n_queries", "40"]),
    "synth": (ROOT / "recipes" / "synthetic" / "make_synth_data.py",
              "synth-bert-base",
              ["--n_docs", "400", "--n_train_queries", "30",
               "--n_dev_queries", "12", "--n_topics", "6",
               "--subtopics_per_topic", "5", "--judged_per_query", "3",
               "--hidden_layers", "1", "--hidden_size", "64", "--seed", "3"]),
}


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """Each mode's workspace from the JAX maker and from the port's."""
    out = {}
    for mode, (script, model, args) in MAKERS.items():
        root = tmp_path_factory.mktemp(mode)
        _run([sys.executable, str(script), "--out_dir", str(root / "jax")]
             + args, cwd=root)
        from repconc_tpu_torch.recipes import make_pipeline_data

        make_pipeline_data.main([mode, "--out_dir", str(root / "port")] + args)
        out[mode] = (root / "jax", root / "port", model)
    return out


@pytest.mark.parametrize("mode", list(MAKERS))
def test_make_pipeline_data_equals_the_jax_makers(made, mode):
    """corpus, queries, qrels, vocab.txt and the tokenizer files byte for
    byte; the model dir's config at the same widths."""
    jax_root, port_root, model = made[mode]
    for name in DATA_FILES + tuple(f"models/{model}/{f}"
                                   for f in TOKENIZER_FILES):
        assert (port_root / name).read_bytes() == (jax_root / name).read_bytes(), name
    jax_cfg = json.loads((jax_root / "models" / model / "config.json").read_text())
    port_cfg = json.loads((port_root / "models" / model / "config.json").read_text())
    for key, value in port_cfg.items():
        assert jax_cfg[key] == value, key


@pytest.mark.parametrize("mode", list(MAKERS))
def test_made_model_dir_loads_in_hf_and_in_the_port(made, mode):
    """HF's BertModel loads every weight of the port-made dir, and its
    output equals the port's encoder's; AutoTokenizer and the port's
    tokenizer read the dir to the same ids."""
    from transformers import AutoTokenizer, BertModel

    from repconc_tpu_torch.models.adapters import load_adapter_tokenizer
    from repconc_tpu_torch.models.auto import load_dense_encoder
    from repconc_tpu_torch.models.transformer import DenseEncoder

    _, port_root, model = made[mode]
    d = str(port_root / "models" / model)
    hf, info = BertModel.from_pretrained(d, add_pooling_layer=False,
                                         output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"], info
    cfg, state, _ = load_dense_encoder(d, device="cpu")
    cfg.pooling = "cls"
    enc = DenseEncoder(cfg)
    enc.load_state_dict(state)
    enc.eval()
    hf.eval()
    texts = [ln.split("\t", 1)[1].replace("\t", " [SEP] ")
             for ln in (port_root / DATA_FILES[0]).read_text().split("\n")[:8]]
    tok, hf_tok = load_adapter_tokenizer(d), AutoTokenizer.from_pretrained(d)
    batch = tok(texts, padding=True, truncation=True, max_length=32)
    want_batch = hf_tok(texts, padding=True, truncation=True, max_length=32)
    for key in ("input_ids", "attention_mask"):
        assert batch[key] == want_batch[key], key
    ids = torch.tensor(batch["input_ids"])
    mask = torch.tensor(batch["attention_mask"])
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask).last_hidden_state[:, 0]
        got = enc(ids, mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def blocked_env(tmp_path):
    """The environment with a `transformers` package that raises on import
    put first on PYTHONPATH (the rest of PYTHONPATH kept)."""
    block = tmp_path / "block" / "transformers"
    block.mkdir(parents=True)
    (block / "__init__.py").write_text(
        "raise ImportError('transformers is not installed here')\n")
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=str(block.parent) + (
        os.pathsep + path if path else ""))


def test_run_toy_on_the_cpu_without_transformers(tmp_path):
    """The port's run_toy.sh, stages 2-10 through the real CLIs and the
    port's tokenizer, DEVICE=cpu, with `transformers` not importable
    (stages 7 and 9 shortened): every stage's output, and finite MRR@10 in
    the dense, conc and jpq metric.json."""
    env = blocked_env(tmp_path)
    check = subprocess.run([sys.executable, "-c", "import transformers"],
                           env=env, capture_output=True)
    assert check.returncode != 0
    env.update(DEVICE="cpu", CONC_STEPS="3", JPQ_STEPS="3",
               OMP_NUM_THREADS="2")
    ws = tmp_path / "ws"
    proc = _run(["bash", str(PORT_RECIPES / "run_toy.sh"), str(ws)],
                cwd=tmp_path, env=env, timeout=900)
    exp = ws / "experiments" / "toy"
    for name in ("dense_model/config.json", "dense/corpus_embeds.npy",
                 "valid/corpus.tsv", "m8/warmup_model/params.msgpack",
                 "m8/warmup_index/codes.npy", "hardneg.json",
                 "m8/conc/final/params.msgpack", "m8/conc_index/codes.npy",
                 "m8/jpq/final/params.msgpack"):
        assert (exp / name).exists(), name
    for name in ("dense/dev", "m8/conc_index/dev", "m8/jpq_index/dev"):
        metric = json.loads((exp / name / "metric.json").read_text())
        assert math.isfinite(metric["mrr"]["MRR@10"]), name
        assert f"{name}: MRR@10=" in proc.stdout
    assert "transformers" not in proc.stderr


def test_cli_step_times_reads_the_trainers_step_records():
    """cli_step_times keeps each step's log record and leaves out the
    interval that holds a validation."""
    import logging

    from repconc_tpu_torch.recipes.cli_step_times import (StepClock,
                                                           step_intervals_ms)

    clock = StepClock()
    log = logging.getLogger("repconc_tpu_torch.train.stage1")
    log.addHandler(clock)
    level = log.level
    log.setLevel(logging.INFO)
    try:
        for step in range(1, 6):
            log.info("%s", {"loss": 1.0, "step": step})
            if step == 3:
                log.info("%s", {"step": 3, "eval_MRR@10": 0.5})
    finally:
        log.removeHandler(clock)
        log.setLevel(level)
    assert [s for s, _ in clock.steps] == [1, 2, 3, 4, 5]
    assert clock.evals == {3}
    ms = step_intervals_ms([(1, 0.0), (2, 0.1), (3, 0.3), (4, 1.3), (5, 1.4)],
                           {3})
    assert [round(m, 6) for m in ms] == [100.0, 200.0, 100.0]
