"""Multi-model device-memory admission pricing for the serving engine.

Counterpart of ``sparknet_tpu/serve/residency.py``.  Before the engine
captures a single bucket, a model's worst-case resident footprint is
priced off a batch-fit table and the load is refused when it would not fit
next to the models already resident.  A refusal costs nothing; running out
of memory mid-serve costs every resident model's traffic.

The inference footprint is derived from the table's TRAIN fit (the only
fit such a table holds), conservatively:

    inference(b) = max(params_bytes, c0 + c1*b - slots_bytes)

the train-step prediction at the model's LARGEST bucket, minus the
optimizer slots a forward never allocates, floored at the raw param bytes.
Every arm is priced at the f32 row, as in the JAX module (its
``residency.py:22``).  ``fold_bn`` keeps the param bytes, less two vectors a
fold.  ``int8`` keeps the float weights (the bias and the uncalibrated
layers read them) and adds each calibrated layer's int8 weight, scales and
product matrix (``quant.prepare``).  A grouped convolution's matrix is
block-diagonal, ``groups`` times its int8 weight: MobileNet's 13 depthwise
layers alone hold about 25 MB of it against about 17 MB of float weights.
The JAX arm has no such matrices (XLA convolves groups natively), so the
port prices them on top of the f32 row: the engine passes
``quant.resident_bytes`` as ``extra_bytes`` for an ``int8`` load.

What differs from the JAX module:

* **No TPU figure carries over.**  The budget is the device's own memory
  times ``HBM_USABLE_FRAC``: ``torch.cuda.get_device_properties(device).
  total_memory`` on a card; a CPU engine must be given ``hbm_bytes``.
* **No table is banked.**  The JAX package's
  ``docs/mem_contracts/batch_fit.json`` was measured on a TPU and is not
  read.  ``load_fit_table()`` with no path returns None, so an engine
  built without a table admits everything (the JAX stance for an unbanked
  table: a refusal that cannot be justified numerically is worse than
  none).  Tests and ``chip_smoke.py`` pass a table explicitly; a fit
  table measured on the card is a later item (ROADMAP Queue A7).
"""

from __future__ import annotations

import json

__all__ = [
    "HBM_USABLE_FRAC",
    "AdmissionPolicy",
    "load_fit_table",
    "predicted_bytes",
    "price_residency",
]

# share of the device's memory a model load or a decoder may plan to fill
# (the JAX package's analysis/mem_model.HBM_USABLE_FRAC)
HBM_USABLE_FRAC = 0.90


def predicted_bytes(c0: float, c1: float, batch: int) -> int:
    """The affine footprint ``c0 + c1 * batch`` of a fit-table row
    (the JAX package's ``analysis/mem_model.predicted_bytes``)."""
    return int(c0 + c1 * batch)


def load_fit_table(path: str | None = None) -> dict | None:
    """The batch-fit table at ``path``, or None when no path is given or
    the file is missing or malformed (an engine without a table admits
    everything)."""
    if path is None:
        return None
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def price_residency(family: str, max_bucket: int,
                    fit_table: dict | None) -> int | None:
    """Predicted resident bytes for one served model at its largest
    bucket, or None when the table has no row for the family (unknown =>
    unpriceable => the policy admits)."""
    entry = (fit_table or {}).get("families", {}).get(family, {}).get("f32")
    if entry is None:
        return None
    train = predicted_bytes(entry["c0"], entry["c1"], max_bucket)
    return max(int(entry.get("params_bytes", 0)),
               train - int(entry.get("slots_bytes", 0)))


class AdmissionPolicy:
    """The load gate: admit/refuse verdicts against the usable-memory
    budget ``hbm_bytes * usable_frac``."""

    def __init__(self, fit_table: dict | None, hbm_bytes: int,
                 usable_frac: float = HBM_USABLE_FRAC):
        self.fit_table = fit_table
        self.budget_bytes = int(hbm_bytes * usable_frac)

    def admit(self, family: str, max_bucket: int, resident_bytes: int,
              extra_bytes=0) -> dict:
        """Verdict for loading ``family`` (largest bucket ``max_bucket``)
        next to ``resident_bytes`` of already-loaded models.  ``fits`` is
        True for unpriceable families: the gate refuses only what it can
        justify numerically.  ``extra_bytes`` (a count, or a function
        that returns one, called only for a priced family) is added to the
        f32 row's price: the ``int8`` arm's matrices."""
        predicted = price_residency(family, max_bucket, self.fit_table)
        if predicted is not None:
            predicted += int(extra_bytes() if callable(extra_bytes) else extra_bytes)
        verdict = {
            "family": family,
            "max_bucket": int(max_bucket),
            "predicted_bytes": 0 if predicted is None else predicted,
            "resident_bytes": int(resident_bytes),
            "budget_bytes": self.budget_bytes,
            "priced": predicted is not None,
            "fits": True,
        }
        if predicted is not None:
            verdict["fits"] = resident_bytes + predicted <= self.budget_bytes
        return verdict
