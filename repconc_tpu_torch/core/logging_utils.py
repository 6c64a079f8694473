"""Shared logging setup for CLI entry points (a copy of
repconc_tpu/core/logging_utils.py; reference pattern: run_train_conc.py:
54-59)."""
from __future__ import annotations

import logging


def setup_logging(level=logging.INFO):
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        level=level,
    )
