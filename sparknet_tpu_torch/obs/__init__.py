"""obs: structured runtime observability for the port.

Counterpart of ``sparknet_tpu/obs/``.  Records what a run actually did
(fenced span walls, per-round training metrics, CUDA-graph capture counts,
elastic membership, serving and production-loop lifecycle, control-plane
decisions) as schema-validated JSONL in the JAX package's line format
(``obs/schema.py``), so one validator reads both packages' journals.

Off by default; arm with ``SPARKNET_OBS=<path>.jsonl``.  With obs off the
instrumented hot paths are unchanged: no host sync, no kernel launch, no
allocation and no capture is added (pinned by
``tests/test_torch_port_obs.py``).

CLI: ``python -m sparknet_tpu_torch.obs {report|validate|slo|top|dryrun}``.

This ``__init__`` stays import-light: ``schema`` is stdlib-only, and the
Recorder loads lazily behind :func:`get_recorder`.
"""

from __future__ import annotations

from sparknet_tpu_torch.obs import schema  # noqa: F401  (stdlib-only)

__all__ = ["schema", "get_recorder", "set_recorder"]


def get_recorder():
    """The process Recorder singleton (lazy; built from SPARKNET_OBS)."""
    from sparknet_tpu_torch.obs.recorder import get_recorder as _get

    return _get()


def set_recorder(rec):
    """Replace the singleton (tests / the dryrun CLI); None resets."""
    from sparknet_tpu_torch.obs.recorder import set_recorder as _set

    return _set(rec)
