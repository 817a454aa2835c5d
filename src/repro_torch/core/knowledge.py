"""Knowledge base: the predictions store the load balancer reads (paper
Fig. 1), in memory with optional JSON persistence.  A copy of the
reference's ``core/knowledge.py`` (host bookkeeping, no tensors); the
JSON files of the two are interchangeable."""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


class KnowledgeBase:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._latest: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self._history: Dict[Tuple[str, str], List[Tuple[float, float]]] = \
            defaultdict(list)

    def put(self, app: str, node: str, t: float, rtt_pred: float):
        key = (app, node)
        self._latest[key] = (t, rtt_pred)
        self._history[key].append((t, rtt_pred))

    def latest(self, app: str, node: str) -> Optional[float]:
        v = self._latest.get((app, node))
        return v[1] if v else None

    def latest_with_age(self, app: str, node: str, now: float):
        v = self._latest.get((app, node))
        if v is None:
            return None, None
        return v[1], now - v[0]

    def history(self, app: str, node: str):
        return list(self._history.get((app, node), []))

    def save(self):
        if not self.path:
            return
        data = {f"{a}|{n}": h for (a, n), h in self._history.items()}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, self.path)

    def load(self) -> bool:
        """Restore ``_latest`` and ``_history`` from the JSON file written
        by :meth:`save`.  Returns False (leaving state untouched) when the
        store has no path or the file does not exist."""
        if not self.path or not os.path.exists(self.path):
            return False
        with open(self.path) as f:
            data = json.load(f)
        self._latest.clear()
        self._history.clear()
        for key, hist in data.items():
            a, n = key.split("|", 1)
            for t, rtt_pred in hist:
                self.put(a, n, float(t), float(rtt_pred))
        return True
