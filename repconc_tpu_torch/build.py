"""Build the port's CUDA kernels with nvcc into plain-C shared libraries.

Each source under csrc/ exposes `extern "C"` entry points and is compiled
on its own, at first use, with

    nvcc -O3 -gencode arch=compute_90a,code=sm_90a -std=c++17 -shared
         -Xcompiler -fPIC -Xptxas -v

into `_build/<stem>_<hash>.so`, keyed by a hash of the source and the
flags, and loaded with ctypes. The sources include no PyTorch header, so a
build takes seconds, and PyTorch's own extension builder is not used.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 120


@dataclass
class Build:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str        # nvcc's output (ptxas registers / shared memory per kernel)


_lock = threading.Lock()
_builds: Dict[str, Build] = {}
_libraries: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(source_name: str) -> Build:
    """Compile csrc/<source_name> (once per process and source hash)."""
    with _lock:
        if source_name in _builds:
            return _builds[source_name]
        source = CSRC_DIR / source_name
        digest = hashlib.sha256(source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"{source.stem}_{digest}.so"
        seconds, log = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=NVCC_TIMEOUT_S)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source} "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
        result = Build(out, seconds, log)
        _builds[source_name] = result
        return result


def load_library(source_name: str) -> ctypes.CDLL:
    """The built library of csrc/<source_name>, loaded once per process."""
    path = build(source_name).path
    with _lock:
        if source_name not in _libraries:
            _libraries[source_name] = ctypes.CDLL(str(path))
        return _libraries[source_name]
