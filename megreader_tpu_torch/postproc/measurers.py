"""Recognition measurer: exact-match accuracy and normalized edit distance.

A copy of ``megreader_tpu/postproc/measurers.py::edit_distance`` and
``RecognitionMeasurer`` (plain Python, case-folded by default).
"""

from __future__ import annotations

from typing import Dict, Sequence


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


class RecognitionMeasurer:
    """Exact-match accuracy + mean normalized edit distance (1 - d / max len)."""

    def __init__(self, case_sensitive: bool = False):
        self.case_sensitive = case_sensitive

    def measure(self, preds: Sequence[str], gts: Sequence[str]) -> Dict[str, float]:
        if len(preds) != len(gts):
            raise ValueError(f"{len(preds)} predictions for {len(gts)} ground truths")
        n = len(preds)
        if n == 0:
            return {"accuracy": 0.0, "ned": 0.0, "n": 0}
        correct, ned = 0, 0.0
        for p, g in zip(preds, gts):
            if not self.case_sensitive:
                p, g = p.lower(), g.lower()
            correct += p == g
            denom = max(len(p), len(g), 1)
            ned += 1.0 - edit_distance(p, g) / denom
        return {"accuracy": correct / n, "ned": ned / n, "n": n}
