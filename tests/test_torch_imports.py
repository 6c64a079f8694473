"""Guards of what the port may load, so that it starts where only torch,
numpy, nvcc and the standard library are installed (no jax, flax,
transformers, msgpack or safetensors), and builds its kernels with plain
nvcc rather than torch.utils.cpp_extension."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "repconc_tpu_torch"
SOURCES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
NEVER = ("jax", "flax", "repconc_tpu")            # nowhere, not even lazily
LAZY_ONLY = ("transformers", "msgpack", "safetensors")  # inside functions only


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
