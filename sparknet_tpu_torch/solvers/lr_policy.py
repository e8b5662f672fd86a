"""Learning-rate policies (ref: caffe/src/caffe/solvers/sgd_solver.cpp:27-66
GetLearningRate).

Counterpart of ``sparknet_tpu/solvers/lr_policy.py``, computed the same way
in float32 (the iteration and every intermediate are float32 tensors, the
config's Python floats enter as float32), so the ``step``/``inv``/``poly``
rates equal the JAX package's.  Policies: fixed, step, exp, inv, multistep,
poly, sigmoid.
"""

from __future__ import annotations

import torch


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def learning_rate(cfg, it) -> torch.Tensor:
    """cfg is a SolverConfig; returns a 0-dim float32 CPU tensor."""
    it = _f32(float(it))
    base = cfg.base_lr
    policy = cfg.lr_policy
    if policy == "fixed":
        return _f32(base)
    if policy == "step":
        return base * torch.pow(_f32(cfg.gamma), torch.floor(it / cfg.stepsize))
    if policy == "exp":
        return base * torch.pow(_f32(cfg.gamma), it)
    if policy == "inv":
        return base * torch.pow(1.0 + cfg.gamma * it, -cfg.power)
    if policy == "multistep":
        steps = _f32(list(cfg.stepvalue))
        current = (it >= steps).float().sum() if steps.numel() else _f32(0.0)
        return base * torch.pow(_f32(cfg.gamma), current)
    if policy == "poly":
        return base * torch.pow(1.0 - it / float(cfg.max_iter), cfg.power)
    if policy == "sigmoid":
        return base * (1.0 / (1.0 + torch.exp(-cfg.gamma * (it - cfg.stepsize))))
    raise ValueError(f"unknown lr_policy {policy!r}")
