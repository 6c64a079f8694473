"""Step times of a training CLI, run as a user runs it, on one process or
across the GPUs of one host.

    python -m repconc_tpu_torch.recipes.cli_step_times run_train_conc ARGS...
    torchrun --nproc_per_node 4 -m repconc_tpu_torch.recipes.cli_step_times \\
        run_train_conc ARGS... --data_parallel

ARGS are the CLI's own (the recipe's stage 7, say), with --logging_steps 1.
The CLI's main() runs in this process unchanged; a logging handler on the
trainer's logger (train/stage1.py, train/stage2.py) keeps the time of each
step's log record, which the trainer emits after the step's metrics reach
the host. Rank 0 prints one JSON line: the intervals between consecutive
steps' records (validations excluded), their median and the world size.
"""
from __future__ import annotations

import importlib
import json
import logging
import statistics
import sys
import time

from repconc_tpu_torch.core.distributed import rank_and_world

TRAINER_LOGGERS = ("repconc_tpu_torch.train.stage1",
                   "repconc_tpu_torch.train.stage2")


class StepClock(logging.Handler):
    """Keeps (step, time) of each logged step and the steps a validation
    followed."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.steps, self.evals = [], set()

    def emit(self, record):
        d = record.args  # logging keeps a lone dict argument as args
        if not isinstance(d, dict) or "step" not in d:
            return
        if "loss" in d:
            self.steps.append((d["step"], time.perf_counter()))
        elif any(k.startswith("eval_") for k in d):
            self.evals.add(d["step"])


def step_intervals_ms(steps, evals):
    """ms between consecutive steps' records, leaving out an interval that
    holds a validation (the one after a validated step)."""
    return [(t1 - t0) * 1e3 for (s0, t0), (s1, t1) in zip(steps, steps[1:])
            if s1 == s0 + 1 and s0 not in evals]


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit(__doc__)
    cli = importlib.import_module(f"repconc_tpu_torch.cli.{argv[0]}")
    clock = StepClock()
    for name in TRAINER_LOGGERS:
        logging.getLogger(name).addHandler(clock)
    t0 = time.perf_counter()
    cli.main(argv[1:])
    wall_s = time.perf_counter() - t0
    rank, world = rank_and_world()
    ms = step_intervals_ms(clock.steps, clock.evals)
    out = {"cli": argv[0], "world_size": world, "steps": len(clock.steps),
           "intervals": len(ms), "wall_s": wall_s,
           "step_ms_median": statistics.median(ms) if ms else None,
           "step_ms_after_first_5": (statistics.median(ms[5:])
                                     if len(ms) > 5 else None),
           "step_ms_all": ms}
    if rank == 0:
        print(json.dumps(out), flush=True)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
