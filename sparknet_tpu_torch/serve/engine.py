"""Admission refusal and the latency percentile of the serving plane.

Counterpart of ``sparknet_tpu/serve/engine.py``, ``AdmissionRefused`` and
``percentile`` only.  ``ServeEngine`` (the CNN request engine) is ROADMAP
Queue A7.
"""

from __future__ import annotations

import numpy as np

__all__ = ["AdmissionRefused", "percentile"]


class AdmissionRefused(RuntimeError):
    """A model load predicted not to fit the device's usable memory (the
    verdict dict rides on ``.verdict``)."""

    def __init__(self, verdict: dict):
        self.verdict = verdict
        super().__init__(
            f"model load refused: {verdict['family']} at bucket "
            f"{verdict['max_bucket']} predicts "
            f"{verdict['predicted_bytes']:,} B next to "
            f"{verdict['resident_bytes']:,} B resident — over the "
            f"{verdict['budget_bytes']:,} B usable-memory budget")


def percentile(values: list, q: float) -> float:
    """Nearest-rank percentile (p99 of 100 samples is the 99th sorted
    value, no interpolation).  Empty input reads 0.0."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(1, int(np.ceil(q / 100.0 * len(ordered))))
    return float(ordered[rank - 1])
