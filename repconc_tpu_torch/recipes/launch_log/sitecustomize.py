"""Kernel launch counts of a recipe's processes.

A Python process started with this directory first on PYTHONPATH and
REPCONC_LAUNCH_LOG naming a directory writes, when it exits, one JSON file
there, <pid>.json: its argv and, where it loaded the kernel wrappers, their
counters (repconc_tpu_torch/index/launches.py). A process that imported no
part of repconc_tpu_torch writes nothing. recipe_runs.py (launch_env,
read_launch_log) and chip_smoke.py read the files; the counters are the
wrappers' own, so a subprocess's launches count as an in-process run's do.

Python imports one module named sitecustomize at start-up: the first
sitecustomize.py found further on sys.path is run after this one.
"""
import atexit
import json
import os
import sys


def _write() -> None:
    log_dir = os.environ.get("REPCONC_LAUNCH_LOG")
    if not log_dir or "repconc_tpu_torch" not in sys.modules:
        return
    counts = {}
    if ("repconc_tpu_torch.index.cuda_adc" in sys.modules
            or "repconc_tpu_torch.index.cuda_ivf" in sys.modules):
        from repconc_tpu_torch.index.launches import counts as read

        counts = read()
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, f"{os.getpid()}.json"), "w") as f:
        json.dump({"argv": sys.argv, "counts": counts}, f)


atexit.register(_write)

_here = os.path.dirname(os.path.abspath(__file__))
for _d in sys.path:
    _next = os.path.join(os.path.abspath(_d or "."), "sitecustomize.py")
    if os.path.dirname(_next) != _here and os.path.isfile(_next):
        with open(_next) as _f:
            exec(compile(_f.read(), _next, "exec"),
                 {"__name__": "sitecustomize", "__file__": _next})
        break
