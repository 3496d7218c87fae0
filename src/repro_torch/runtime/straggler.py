"""Straggler mitigation: EWMA step-time monitor + ejection policy.

At multi-pod scale a single slow host gates every synchronous step.  The
monitor keeps an EWMA of per-node step contributions; a node persistently
slower than ``factor`` x the fleet median for ``patience`` consecutive
windows is ejected through the same subtractive-transform + MATCHGROW
replacement path as a hard failure (the allocation shape is preserved).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .elastic import ElasticRuntime


@dataclass
class StragglerMonitor:
    factor: float = 1.5
    patience: int = 3
    alpha: float = 0.3                      # EWMA smoothing
    ewma: Dict[str, float] = field(default_factory=dict)
    strikes: Dict[str, int] = field(default_factory=dict)

    def record(self, node_path: str, step_time_s: float) -> None:
        prev = self.ewma.get(node_path)
        self.ewma[node_path] = (step_time_s if prev is None
                                else self.alpha * step_time_s
                                + (1 - self.alpha) * prev)

    def evaluate(self) -> List[str]:
        """Returns nodes that crossed the ejection threshold."""
        if len(self.ewma) < 2:
            return []
        med = float(np.median(list(self.ewma.values())))
        out = []
        for node, t in self.ewma.items():
            if t > self.factor * med:
                self.strikes[node] = self.strikes.get(node, 0) + 1
                if self.strikes[node] >= self.patience:
                    out.append(node)
            else:
                self.strikes[node] = 0
        return out


class StragglerPolicy:
    def __init__(self, runtime: ElasticRuntime,
                 monitor: Optional[StragglerMonitor] = None):
        self.runtime = runtime
        self.monitor = monitor or StragglerMonitor()
        self.ejected: List[str] = []

    def record_and_act(self, node_times: Dict[str, float]) -> List[str]:
        for node, t in node_times.items():
            self.monitor.record(node, t)
        victims = self.monitor.evaluate()
        for node in victims:
            self.runtime.eject_and_replace(node)
            self.ejected.append(node)
            self.monitor.ewma.pop(node, None)
            self.monitor.strikes.pop(node, None)
        return victims
