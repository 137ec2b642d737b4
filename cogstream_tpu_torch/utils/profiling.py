"""Per-stage wall-clock timers and logging (copy of ``StageTimer`` and
``get_logger`` from ``cogstream_tpu/utils/profiling.py``). The JAX
package's ``trace`` / ``profile_to`` wrap the JAX profiler; the port's
device profiles come from ``torch.profiler`` (chip_smoke.py --profile)."""

from __future__ import annotations

import contextlib
import json
import logging
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional


def get_logger(name: str = "cogstream", level=logging.INFO,
               logfile: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        fmt = logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if logfile:
            fh = logging.FileHandler(logfile)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        logger.setLevel(level)
    return logger


class StageTimer:
    """Accumulates per-stage latencies; ``summary()`` gives p50/p95."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self.samples[name].append(seconds)

    @staticmethod
    def _pct(xs: List[float], p: float) -> float:
        xs = sorted(xs)
        i = min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))
        return xs[i]

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            out[name] = {
                "n": len(xs),
                "mean_s": round(sum(xs) / len(xs), 4),
                "p50_s": round(self._pct(xs, 50), 4),
                "p95_s": round(self._pct(xs, 95), 4),
                "total_s": round(sum(xs), 3),
            }
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
