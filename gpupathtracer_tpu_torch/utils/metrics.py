"""Structured metrics: a JSONL event stream (one dict per line).

Counterpart of ``gpupathtracer_tpu/utils/metrics.py``, for progressive
renders and the CLI; only rank 0 writes when ``torch.distributed`` is
initialised.
"""

from __future__ import annotations

import json
import os
import time

import torch


def is_host0() -> bool:
    """True unless ``torch.distributed`` is initialised and this is not
    rank 0."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def log_event(path: str, record: dict) -> None:
    """Append ``record`` with a timestamp ``ts`` to the JSONL file ``path``."""
    if not is_host0():
        return
    record = {"ts": round(time.time(), 3), **record}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


# Runtime notices: an in-memory tail of the last events and, when the
# FIREFLY_METRICS environment variable names a file, that JSONL stream too.
RUNTIME_EVENTS: list = []
_MAX_RUNTIME_EVENTS = 256
_ONCE_KEYS: set = set()


def log_runtime_event(record: dict, once_key: str | None = None) -> None:
    """Record a runtime notice; ``once_key`` keeps one per distinct key and
    process."""
    if once_key is not None:
        if once_key in _ONCE_KEYS:
            return
        _ONCE_KEYS.add(once_key)
    record = {"ts": round(time.time(), 3), **record}
    RUNTIME_EVENTS.append(record)
    del RUNTIME_EVENTS[:-_MAX_RUNTIME_EVENTS]
    path = os.environ.get("FIREFLY_METRICS")
    if path:
        log_event(path, record)


def read_events(path: str) -> list[dict]:
    """The records of the JSONL file ``path`` ([] when there is none)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
