"""Structured logging and counters.

The port's copy of the JAX package's ``utils/logging.py``: JSON-lines
event records on stderr (stage timings, minutiae counts, template sizes,
score statistics), in-process counters, and score statistics.
"""
from __future__ import annotations

import json
import logging
import sys
import time
from collections import Counter
from typing import Any, Dict

_logger = logging.getLogger("msu_latentafis_tpu_torch")
if not _logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(message)s"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.INFO)

counters: Counter = Counter()


def event(kind: str, **fields: Any) -> None:
    """Emit one structured JSON event line."""
    rec: Dict[str, Any] = {"ts": round(time.time(), 3), "event": kind}
    rec.update(fields)
    _logger.info(json.dumps(rec, default=str))


def count(name: str, n: int = 1) -> None:
    counters[name] += n


def score_stats(scores) -> Dict[str, float]:
    """n, mean, max and 99th percentile of the scores >= 0 (the skipped
    entries score -1)."""
    import numpy as np
    s = np.asarray(scores, np.float64)
    valid = s[s >= 0]
    if len(valid) == 0:
        return {"n": 0}
    return {"n": int(len(valid)), "mean": float(valid.mean()),
            "max": float(valid.max()),
            "p99": float(np.percentile(valid, 99))}
