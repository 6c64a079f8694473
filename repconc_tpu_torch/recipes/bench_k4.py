"""Time K4, the int8-LUT brute-force ADC scan (csrc/adc_scan_i8.cu), on the
card, against variants of its design and, where given, other sources of
the same entry point (earlier designs), in turns in one process.

    python -m repconc_tpu_torch.recipes.bench_k4 [--source old=PATH ...]
        [--shapes 1200x131072x12,129x100003x48] [--reps 20]
        [--out bench_k4.json]

The variants are the current source with one lever undone each, made by
editing its text before nvcc (each edit must match once):

  docs1     one doc per thread (4-byte stores, codes read for one doc)
  stwb      write-back stores in place of the streaming __stcs
  per_item  one block per (query tile, doc chunk) item, no persistent grid
  qt8       8 queries per tile in place of 16 where 16 fit
  lb3       launch bounds of 3 blocks an SM in place of 2 (fewer registers)
  exp23_literal
            the float 2^23 of the lane conversion as a literal in place of
            a kernel argument

and two diagnostics, which compute something else and are timed only:

  k0        every code read as 0 (a warp's gathers all hit one address: no
            bank conflicts; the code loads stay)
  no_store  the scores computed and not stored (the compute alone)

Every build takes the flags of repconc_tpu_torch/build.py (ptxas prints
registers and spills), every build but the diagnostics is held bit-equal
to the plain version (index/adc.py::score_codes_int8_reference) before it
is timed, and the timings run the --source builds, new and the variants,
then the same in reverse, so that a drift of the card's clock shows as a
gap between the two times of one build. Prints one JSON line: the card's
name and power limit, ptxas's registers and spills of each build, and per
shape each build's median ms (CUDA events over --reps launches after
warm-up). The bound, the plain version's time and the library yardstick
are chip_smoke.py's k4_check.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SEED = 2022

VARIANTS = {
    "docs1": [("constexpr int kDocs = 2;", "constexpr int kDocs = 1;")],
    "stwb": [("__stcs(reinterpret_cast<float2*>(dst + j * N)",
              "__stwb(reinterpret_cast<float2*>(dst + j * N)"),
             ("__stcs(reinterpret_cast<float2*>(dst),",
              "__stwb(reinterpret_cast<float2*>(dst),"),
             ("__stcs(dst + d, acc[d][j])", "__stwb(dst + d, acc[d][j])")],
    "per_item": [("long long blocks = static_cast<long long>(per_sm) * sms;",
                  "long long blocks = items + 0 * per_sm * sms;")],
    "qt8": [("if (16 * per_query + 16 <= kSmemBudget)",
             "if (16 * per_query + 16 <= 0)")],
    "lb3": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)")],
    "exp23_literal": [("__byte_perm(lane[L], exp23, h ? 0x7632 : 0x7610)",
                       "__byte_perm(lane[L], kExp23, h ? 0x7632 : 0x7610)")],
}
DIAGNOSTICS = {
    "k0": [("add_lanes<QT>(base + CL::byte(cw[d], i) * QT, lane[d]);",
            "add_lanes<QT>(base + (CL::byte(cw[d], i) & (K >> 9)) * QT, "
            "lane[d]);")],
    "no_store": [("if (both && q0 + QT <= Q) {",
                  "if (both && q0 + QT <= Q && acc[0][0] == 1.0e30f) {"),
                 ("      float* dst = out + (q0 + j) * N + n0;\n",
                  "      if (acc[0][j] != 1.0e30f) continue;\n"
                  "      float* dst = out + (q0 + j) * N + n0;\n")],
}


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    metavar="TAG=PATH",
                    help="another .cu with the repconc_adc_scan_i8 entry "
                         "point, timed in turns with the current one "
                         "(repeatable)")
    ap.add_argument("--shapes", default="1200x131072x12,129x100003x48",
                    help="comma-separated QxNxM (K=256)")
    ap.add_argument("--variants", default=",".join([*VARIANTS, *DIAGNOSTICS]),
                    help="comma-separated names of VARIANTS and "
                         "DIAGNOSTICS, or empty")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    return ap


def compile_source(text: str, tag: str):
    """nvcc `text` with build.py's flags into _build/bench/; returns the
    entry point (argument types declared) and ptxas's lines."""
    from repconc_tpu_torch import build

    digest = hashlib.sha256(text.encode() + " ".join(build.NVCC_FLAGS)
                            .encode()).hexdigest()[:16]
    out_dir = build.BUILD_DIR / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"k4_{tag}_{digest}.cu"
    lib = src.with_suffix(".so")
    src.write_text(text)
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True, timeout=build.NVCC_TIMEOUT_S)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the {tag} build:\n{log}")
    fn = ctypes.CDLL(str(lib)).repconc_adc_scan_i8
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in log.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    return fn, ptxas


def variant_text(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"variant edit does not match once: {old!r}")
        text = text.replace(old, new)
    return text


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def main(argv=None) -> int:
    import torch

    from repconc_tpu_torch import build
    from repconc_tpu_torch.index.adc import (group_size, quantize_lut_int8,
                                             score_codes_int8_reference)

    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_k4 needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    text = (build.CSRC_DIR / "adc_scan_i8.cu").read_text()
    sources = {}
    for spec in args.source:
        tag, path = spec.split("=", 1)
        sources[tag] = Path(path).read_text()
    sources["new"] = text
    for name in filter(None, args.variants.split(",")):
        sources[name] = variant_text(text, {**VARIANTS, **DIAGNOSTICS}[name])
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each, at once
        builds = dict(zip(sources, pool.map(compile_source, sources.values(),
                                            sources)))
    order = list(sources)
    order = order + order[::-1]

    result = {"card": card_line(), "device": torch.cuda.get_device_name(0),
              "ptxas": {tag: b[1] for tag, b in builds.items()},
              "order": order, "unchecked": [t for t in order[:len(sources)]
                                            if t in DIAGNOSTICS],
              "shapes": []}
    K = 256
    for shape in args.shapes.split(","):
        Q, N, M = (int(x) for x in shape.split("x"))
        g = torch.Generator(device=dev).manual_seed(SEED + Q + N + M)
        gm = group_size(M, K)
        lut_i8, scales = quantize_lut_int8(
            torch.randn((Q, M, K), generator=g, device=dev), gm)
        codes = torch.randint(0, K, (N, M), generator=g, device=dev,
                              dtype=torch.uint8)
        want = score_codes_int8_reference(lut_i8, scales, codes)
        out = torch.empty((Q, N), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run(fn):
            err = fn(lut_i8.data_ptr(), scales.data_ptr(), codes.data_ptr(),
                     out.data_ptr(), Q, N, M, K, gm, 0, stream)
            if err != 0:
                raise RuntimeError(f"launch failed: cudaError {err}")

        for tag, (fn, _) in builds.items():
            if tag in DIAGNOSTICS:
                continue
            out.fill_(float("nan"))
            run(fn)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"{tag} differs from the plain version "
                                   f"at {shape}: max "
                                   f"{float((out - want).abs().max())}")
        times = {tag: [] for tag in builds}
        for tag in order:
            fn = builds[tag][0]
            times[tag].append(time_ms(lambda: run(fn), args.reps))
        result["shapes"].append({
            "Q": Q, "N": N, "M": M, "K": K, "gm": gm,
            "ms": {tag: statistics.median(t) for tag, t in times.items()},
            "ms_each": times})
        del lut_i8, scales, codes, want, out
        torch.cuda.empty_cache()
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
