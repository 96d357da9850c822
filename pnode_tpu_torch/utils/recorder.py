"""CSV result recorder with an append lock, for sweep aggregation (the
port's copy of ``pnode_tpu/utils/recorder.py``): buffered key/value
records flushed to a CSV under an ``fcntl`` lock, so parallel sweep jobs
can append to one file."""

from __future__ import annotations

import csv
import os
from typing import Any, Dict, List


class Recorder:
    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        self.current: Dict[str, Any] = {}

    def record(self, **kwargs) -> None:
        self.current.update(kwargs)

    def next_record(self) -> None:
        if self.current:
            self.records.append(self.current)
            self.current = {}

    def save(self, path: str) -> None:
        self.next_record()
        if not self.records:
            return
        keys: List[str] = []
        for r in self.records:
            for k in r:
                if k not in keys:
                    keys.append(k)
        exists = os.path.exists(path)
        with open(path, "a", newline="") as f:
            try:
                import fcntl

                fcntl.flock(f, fcntl.LOCK_EX)
            except (ImportError, OSError):
                pass
            w = csv.DictWriter(f, fieldnames=keys)
            if not exists:
                w.writeheader()
            w.writerows(self.records)
        self.records = []
