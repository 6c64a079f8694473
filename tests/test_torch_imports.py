"""Guards of what the port may load, so that it starts where only torch,
numpy, nvcc and the standard library are installed (no jax, flax, optax,
transformers, tokenizers, msgpack or safetensors), and builds its kernels
with plain nvcc rather than torch.utils.cpp_extension."""
import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "repconc_tpu_torch"
SOURCES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
NEVER = ("jax", "flax", "optax", "orbax", "msgpack",  # nowhere, not
         "safetensors", "repconc_tpu",                  # even lazily
         "transformers", "tokenizers")  # the port's own tokenizers (PR 15)
LAZY_ONLY = ()  # inside functions only
# the modules of stage-1 and stage-2 training and of the hard-negative
# miner, each guarded by the tests below
TRAINING_MODULES = ["repconc_tpu_torch.train", "repconc_tpu_torch.train.data",
                    "repconc_tpu_torch.train.stage1",
                    "repconc_tpu_torch.quant.sinkhorn",
                    "repconc_tpu_torch.quant.losses",
                    "repconc_tpu_torch.core.logging_utils",
                    "repconc_tpu_torch.cli.run_train_conc",
                    "repconc_tpu_torch.train.stage2",
                    "repconc_tpu_torch.cli.run_train_jpq",
                    "repconc_tpu_torch.cli.run_extract_hardneg",
                    "repconc_tpu_torch.eval.run_io"]
# the modules of the pipeline's front (stages 0 and 2-5), each guarded by the
# tests below
FRONT_MODULES = ["repconc_tpu_torch.core.safetensors_io",
                 "repconc_tpu_torch.models.auto",
                 "repconc_tpu_torch.models.adapters",
                 "repconc_tpu_torch.index.flat",
                 "repconc_tpu_torch.index.opq",
                 "repconc_tpu_torch.train.warmup",
                 "repconc_tpu_torch.cli.run_customize_dense",
                 "repconc_tpu_torch.cli.run_dense_eval",
                 "repconc_tpu_torch.cli.run_gen_valid_set",
                 "repconc_tpu_torch.cli.run_train_dense",
                 "repconc_tpu_torch.cli.run_warmup",
                 "repconc_tpu_torch.cli.run_pretokenize"]
# the modules of bf16 training at scale and the rest of IVF, each guarded by
# the tests below
SLICE9_MODULES = ["repconc_tpu_torch.recipes",
                  "repconc_tpu_torch.recipes.bench_stage1_scale",
                  "repconc_tpu_torch.cli.run_ivf_sweep",
                  "repconc_tpu_torch.index.kmeans",
                  "repconc_tpu_torch.index.cuda_ivf"]

# the modules of data parallelism and profiling, each guarded by the tests
# below
SLICE10_MODULES = ["repconc_tpu_torch.core.distributed",
                   "repconc_tpu_torch.core.mesh",
                   "repconc_tpu_torch.core.profiling",
                   "repconc_tpu_torch.parallel",
                   "repconc_tpu_torch.parallel.sharded",
                   "repconc_tpu_torch.recipes.multi_gpu_check"]

# the modules of the port's own tokenizers and of its pipeline recipe, each
# guarded by the tests below
SLICE12_MODULES = ["repconc_tpu_torch.models.tokenization",
                   "repconc_tpu_torch.models.unicode_tables",
                   "repconc_tpu_torch.models.adapters",
                   "repconc_tpu_torch.recipes.make_pipeline_data",
                   "repconc_tpu_torch.recipes.cli_step_times"]


def _module_names():
    names = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node, node.module


def _top(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports(path):
    tree = ast.parse(path.read_text())
    module_level = {id(n) for n in tree.body}
    for node, name in _imports(tree):
        assert _top(name) not in NEVER, f"{path.name} imports {name}"
        if _top(name) in LAZY_ONLY:
            assert id(node) not in module_level, (
                f"{path.name} imports {name} at module level")
    assert "cpp_extension" not in path.read_text(), path


@pytest.mark.parametrize("path", sorted((PACKAGE / "csrc").glob("*.cu*")),
                         ids=lambda p: p.name)
def test_cuda_sources_include_no_torch_headers(path):
    text = path.read_text()
    assert "torch/extension.h" not in text and "<torch/" not in text
    assert 'extern "C"' in text


def test_importing_everything_loads_no_forbidden_module():
    code = (
        "import importlib, sys\n"
        f"for name in {_module_names()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{NEVER + LAZY_ONLY!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name", TRAINING_MODULES)
def test_training_module_is_guarded(name):
    """Each training module is among those the import guards walk."""
    assert name in _module_names()


@pytest.mark.parametrize("name", FRONT_MODULES)
def test_front_module_is_guarded(name):
    """Each module of stages 0 and 2-5 is among those the import guards
    walk, and importing it alone loads no transformers."""
    assert name in _module_names()
    code = (f"import sys, {name}\n"
            "sys.exit(1 if 'transformers' in sys.modules else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name", SLICE9_MODULES)
def test_slice9_module_is_guarded(name):
    """The bench recipe, the sweep CLI and the balanced / decoded IVF
    modules are among those the import guards walk, and importing one
    alone loads neither torch's CUDA state nor transformers."""
    assert name in _module_names()
    code = (f"import sys, torch, {name}\n"
            "sys.exit(1 if 'transformers' in sys.modules\n"
            "         or torch.cuda.is_initialized() else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name", SLICE10_MODULES)
def test_slice10_module_is_guarded(name):
    """The process-group, mesh, profiling and sharded-search modules are
    among those the import guards walk, and importing one alone loads no
    JAX and no transformers, touches no CUDA state and joins no process
    group."""
    assert name in _module_names()
    code = (f"import sys, torch, torch.distributed as dist, {name}\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{NEVER + LAZY_ONLY!r}]\n"
            "sys.exit(1 if bad or torch.cuda.is_initialized()\n"
            "         or dist.is_initialized() else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name", SLICE12_MODULES)
def test_slice12_module_is_guarded(name):
    """The tokenizers, the adapters and the recipe's data maker are among
    those the import guards walk, and importing one alone loads no
    transformers, no tokenizers and no regex, and touches no CUDA state."""
    assert name in _module_names()
    code = (f"import sys, torch, {name}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('transformers', 'tokenizers', 'regex')]\n"
            "sys.exit(1 if bad or torch.cuda.is_initialized() else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


SHELL_RECIPES = sorted((PACKAGE / "recipes").glob("*.sh"))


@pytest.mark.parametrize("path", SHELL_RECIPES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_shell_recipe_invokes_no_jax_module_or_pipeline(path):
    """The port's shell recipes run only the port: no `repconc_tpu.`
    module is invoked (python -m, or a launcher's -m), and neither the JAX
    recipes/run_pipeline.sh nor a root recipes/ script that calls one is
    run (the port's pipeline script is run_pipeline.sh beside them,
    reached as ${HERE}/run_pipeline.sh)."""
    text = path.read_text().replace("\\\n", " ")
    code = "\n".join(ln for ln in text.split("\n")
                     if not ln.lstrip().startswith("#"))
    assert not re.search(r"-m\s+repconc_tpu\.", code), path.name
    assert not re.search(r"import\s+repconc_tpu\b|from\s+repconc_tpu\s",
                         code), path.name
    for m in re.finditer(r'(\S*)run_pipeline\.sh', code):
        assert m.group(1).endswith("${HERE}/"), (path.name, m.group(0))
    for script in ("round4_heldout.sh", "compression_sweep.sh",
                   "beir_eval.sh", "msmarco_scale_e2e.sh", "run_synth.sh",
                   "run_matrix.sh", "persist_artifacts.sh",
                   "split_queries_heldout.py", "complete_qrels.py",
                   "make_synth_data.py", "make_toy_data.py"):
        assert f"recipes/{script}" not in code and \
            f"synthetic/{script}" not in code, (path.name, script)


def test_shell_recipes_are_scanned():
    """The scan above covers every twin of a JAX recipe."""
    names = {p.name for p in SHELL_RECIPES}
    assert names >= {"run_pipeline.sh", "run_toy.sh", "heldout_matrix.sh",
                     "compression_sweep.sh", "beir_eval.sh",
                     "msmarco_scale_e2e.sh", "stage7_across_cards.sh"}


@pytest.mark.parametrize("cli", ["run_repconc_eval", "run_train_conc",
                                 "run_train_jpq", "run_train_dense",
                                 "run_dense_eval", "run_pretokenize"])
def test_tokenizing_clis_run_without_transformers(cli, tmp_path):
    """Each CLI that loads a tokenizer loads the port's: with a
    `transformers` that raises on import first on sys.path, its tokenizer
    loads from a model dir and tokenizes."""
    block = tmp_path / "transformers"
    block.mkdir()
    (block / "__init__.py").write_text("raise ImportError('blocked')\n")
    d = tmp_path / "tok"
    d.mkdir()
    (d / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "world"]))
    code = (f"import sys; sys.path.insert(0, {str(tmp_path)!r})\n"
            f"import repconc_tpu_torch.cli.{cli} as cli\n"
            "from repconc_tpu_torch.models.adapters import "
            "load_adapter_tokenizer\n"
            f"tok = load_adapter_tokenizer({str(d)!r})\n"
            "ids = tok(['hello world', 'Hello'], padding=True)['input_ids']\n"
            "assert ids == [[2, 5, 6, 3], [2, 5, 3, 0]], ids\n"
            "sys.exit(1 if 'transformers' in sys.modules else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_needs_no_jax_flax_or_transformers():
    """chip_smoke.py, imported alone, loads none of them (the card's machine
    has none)."""
    code = ("import sys, chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'transformers', 'repconc_tpu')]\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_create_mesh_refuses_cuda_without_a_gpu(monkeypatch):
    """create_mesh(device="cuda") raises without a card: with no env
    contract, and under one (before any rendezvous: no gloo stands in)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    import torch.distributed as dist

    from repconc_tpu_torch.core import distributed
    from repconc_tpu_torch.core.mesh import create_mesh

    for k in (distributed.ENV_COORDINATOR, distributed.ENV_NUM_PROCESSES,
              distributed.ENV_PROCESS_ID) + distributed.TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError):
        create_mesh(device="cuda")
    monkeypatch.setenv(distributed.ENV_COORDINATOR, "127.0.0.1:1")
    monkeypatch.setenv(distributed.ENV_NUM_PROCESSES, "2")
    monkeypatch.setenv(distributed.ENV_PROCESS_ID, "0")
    with pytest.raises(RuntimeError, match="cuda"):
        create_mesh(device="cuda")
    assert not dist.is_initialized()


def test_train_package_imports_nothing_eagerly():
    code = ("import sys, repconc_tpu_torch.train\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'"
            " or m.startswith('repconc_tpu_torch.')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "['repconc_tpu_torch.train']"


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    return proc, time.perf_counter() - t


def test_chip_smoke_fails_fast_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc, seconds = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert proc.stdout == ""  # no phase ran, no result printed
    assert seconds < 120


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    proc, _ = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("where", ["meta", "mixed"])
def test_kernel_wrapper_raises_instead_of_falling_back(where):
    """adc_scores takes the plain version only for CPU tensors; anything
    else it cannot launch on raises and counts no launch."""
    from repconc_tpu_torch.index.cuda_adc import adc_scores

    lut = torch.zeros((4, 8, 32), dtype=torch.bfloat16)
    codes = torch.zeros((10, 8), dtype=torch.uint8)
    if where == "meta":
        lut, codes = lut.to("meta"), codes.to("meta")
    else:
        codes = codes.to("meta")
    before = adc_scores.launches
    with pytest.raises(ValueError):
        adc_scores(lut, codes)
    assert adc_scores.launches == before


def _int8_scan_inputs():
    from repconc_tpu_torch.index.cuda_adc import adc_scores_int8

    return adc_scores_int8, [torch.zeros((4, 8, 32), dtype=torch.int8),
                             torch.ones((4, 2)),
                             torch.zeros((10, 8), dtype=torch.uint8)]


def _ivf_scan_inputs(lut_dtype):
    from repconc_tpu_torch.index.cuda_ivf import score_work_tiles

    lut = torch.zeros((5, 8, 32), dtype=(torch.int8 if lut_dtype == "int8"
                                         else torch.bfloat16))
    args = [torch.zeros(3, dtype=torch.int32),
            torch.full((3, 32), 4, dtype=torch.int32), lut,
            torch.zeros((2, 128, 8), dtype=torch.uint8)]
    if lut_dtype == "int8":
        args.append(torch.ones((5, 2)))
    return score_work_tiles, args


def _ivf_pass_inputs(kernel):
    """Inputs of a pass of the two-pass IVF search: tiles of one occupied
    slot (pair 0, nprobe 1) over cells of 128 and 5 real docs."""
    from repconc_tpu_torch.index.cuda_ivf import ivf_filter, ivf_group_max

    int8 = kernel.endswith("_i8")
    lut = torch.zeros((5, 8, 32), dtype=torch.int8 if int8 else torch.bfloat16)
    slot_pair = torch.full((3, 32), -1, dtype=torch.int32)
    slot_pair[0, 0] = 0
    tiles = [torch.zeros(3, dtype=torch.int32), slot_pair, lut,
             torch.zeros((2, 128, 8), dtype=torch.uint8)]
    cell_len = torch.tensor([128, 5], dtype=torch.int32)
    scales = torch.ones((5, 2)) if int8 else None
    if kernel.startswith("ivf_group_max"):
        return ivf_group_max, tiles + [cell_len, 1, scales]
    cell_ids = torch.arange(256, dtype=torch.int32).reshape(2, 128)
    return ivf_filter, tiles + [cell_ids, cell_len, 1, torch.zeros(4), 5,
                                None, scales]


@pytest.mark.parametrize("kernel", ["adc_scan_i8", "ivf_scan_bf16",
                                    "ivf_scan_i8", "ivf_group_max_bf16",
                                    "ivf_group_max_i8", "ivf_filter_bf16",
                                    "ivf_filter_i8"])
@pytest.mark.parametrize("where", ["meta", "mixed"])
def test_new_kernel_wrappers_raise_instead_of_falling_back(kernel, where):
    """adc_scores_int8 (K4), score_work_tiles (K2 / K3) and the passes of
    the two-pass IVF search (ivf_group_max, ivf_filter) take their plain
    versions only for CPU tensors; a tensor they cannot launch on raises
    and counts no launch."""
    if kernel == "adc_scan_i8":
        fn, args = _int8_scan_inputs()
    elif kernel.startswith(("ivf_group_max", "ivf_filter")):
        fn, args = _ivf_pass_inputs(kernel)
    else:
        fn, args = _ivf_scan_inputs("int8" if kernel == "ivf_scan_i8" else "bf16")
    before = repr(fn.launches)
    fn(*args)  # CPU tensors: the plain version, no launch
    assert repr(fn.launches) == before
    tensors = [k for k, a in enumerate(args) if torch.is_tensor(a)]
    for k in tensors if where == "meta" else tensors[-1:]:
        args[k] = args[k].to("meta")
    with pytest.raises(ValueError):
        fn(*args)
    assert repr(fn.launches) == before


def test_entry_points_refuse_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from repconc_tpu_torch.core.device import resolve_device
    from repconc_tpu_torch.index.cuda_adc import CudaADCIndex

    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        CudaADCIndex(torch.zeros((4, 2), dtype=torch.uint8),
                     torch.zeros((2, 16, 4)))
    from repconc_tpu_torch.index.ivf import build_ivf_from_codes

    with pytest.raises(RuntimeError):
        build_ivf_from_codes(np.zeros((4, 2), np.uint8),
                             np.zeros((2, 16, 4), np.float32), nlist=2)
