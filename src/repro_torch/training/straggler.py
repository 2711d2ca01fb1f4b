"""Straggler detection and mitigation.

Training side: per-step wall-time EWMA with z-score outlier detection —
flags slow steps/hosts so the launcher can exclude a host (elastic.py) or
enable backup execution.  Serving side: the router's hedged dispatch
(core/router.py) re-enqueues requests whose replica missed its deadline —
for non-preemptive SJF this is safe by construction (nothing mid-flight is
lost except the active request, replayed at the head).

A copy of ``repro.training.straggler`` (plain Python).
"""

from __future__ import annotations

import math
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class StepTimer:
    alpha: float = 0.1          # EWMA coefficient
    z_threshold: float = 3.0    # flag steps slower than mean + z*std
    warmup: int = 5
    mean: float = 0.0
    var: float = 0.0
    count: int = 0
    flagged: List[int] = field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        self.count += 1
        if self.count <= self.warmup:
            # prime the statistics
            d = seconds - self.mean
            self.mean += d / self.count
            self.var += d * (seconds - self.mean)
            return False
        std = math.sqrt(max(self.var / max(self.count - 1, 1), 1e-12))
        # floor at 5% of the mean: near-constant step times must not make
        # ordinary jitter look like a straggler
        std = max(std, 0.05 * self.mean)
        is_straggler = seconds > self.mean + self.z_threshold * std
        if is_straggler:
            self.flagged.append(step)
        else:
            # only track "normal" steps in the running stats
            d = seconds - self.mean
            self.mean = (1 - self.alpha) * self.mean + self.alpha * seconds
            self.var = (1 - self.alpha) * self.var + self.alpha * d * d
        return is_straggler


@dataclass
class HostMonitor:
    """Cross-host step-time comparison (each host reports durations)."""
    slow_ratio: float = 1.5     # host is a straggler at 1.5x median
    window: int = 20
    history: Dict[str, deque] = field(default_factory=dict)

    def observe(self, host: str, seconds: float) -> None:
        self.history.setdefault(
            host, deque(maxlen=self.window)).append(seconds)

    def stragglers(self) -> List[str]:
        if len(self.history) < 2:
            return []
        medians = {h: sorted(v)[len(v) // 2] for h, v in self.history.items()
                   if v}
        overall = sorted(medians.values())[len(medians) // 2]
        return [h for h, m in medians.items() if m > self.slow_ratio * overall]
