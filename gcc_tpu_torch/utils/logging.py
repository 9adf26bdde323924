"""File+stream logger (utils/util.py:246-259) plus structured JSONL metrics
(copy of gcc_tpu/utils/logging.py)."""

from __future__ import annotations

import json
import logging
import os
import time


def get_logger(file_path: str, name: str = "gcc-tpu-torch") -> logging.Logger:
    logger = logging.getLogger(name)
    path = os.path.abspath(file_path)
    # same run dir: reuse; different run dir (second experiment in one
    # process, or test processes driving several CLIs): re-point ONLY the
    # file handlers so logs land with their own run. Non-file handlers
    # (our stream handler, anything externally attached) stay untouched.
    if any(isinstance(h, logging.FileHandler)
           and getattr(h, "baseFilename", None) == path
           for h in logger.handlers):
        return logger
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            logger.removeHandler(h)
            h.close()
    fmt = logging.Formatter("%(asctime)s | %(message)s", datefmt="%m/%d %I:%M:%S %p")
    os.makedirs(os.path.dirname(file_path) or ".", exist_ok=True)
    fh = logging.FileHandler(file_path)
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    logger.setLevel(logging.INFO)
    return logger


class JsonlWriter:
    """Append-only metrics stream: one JSON object per line."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def write(self, record: dict):
        record = dict(record)
        record.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")
