"""Optimizer update rules with Caffe solver semantics, blob by blob.

Counterpart of ``sparknet_tpu/solvers/updates.py``: the six-member solver
family (ref: caffe/src/caffe/solvers/{sgd,nesterov,adagrad,rmsprop,
adadelta,adam}_solver.cpp) as plain PyTorch functions of each param blob,
in Caffe's formulations (SGD's V = mu*V + lr*g; W -= V folds the lr into
the momentum buffer, unlike ``torch.optim.SGD``).  Op for op the JAX chain,
which XLA ran outside any Pallas kernel, so here it is PyTorch code and
not a kernel.

Update order of SGDSolver::ApplyUpdate (sgd_solver.cpp:102-117): clip
(global L2, on the raw grads) -> normalize (1/iter_size) -> regularize
(L2/L1 with per-blob decay_mult) -> the rule at local_rate = rate * lr_mult.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from sparknet_tpu_torch.compiler.graph import is_placeholder


class UpdateCtx(NamedTuple):
    rate: torch.Tensor  # global lr for this iter, 0-dim float32
    lr_mult: float
    momentum: float
    momentum2: float  # adam beta2
    rms_decay: float
    delta: float  # numerical epsilon (adagrad/rmsprop/adadelta/adam)
    it: int  # iteration (adam bias correction)


# Each rule: (ctx, w, g, slots) -> (delta_w, new_slots); W_new = w - delta_w.


def _sgd(ctx, w, g, slots):
    """ref: sgd_solver.cpp ComputeUpdateValue — history folds in the lr."""
    (h,) = slots
    h = ctx.momentum * h + (ctx.rate * ctx.lr_mult) * g
    return h, [h]


def _nesterov(ctx, w, g, slots):
    """ref: nesterov_solver.cpp — update = (1+mu)*h_new - mu*h_old."""
    (h,) = slots
    h_new = ctx.momentum * h + (ctx.rate * ctx.lr_mult) * g
    return (1.0 + ctx.momentum) * h_new - ctx.momentum * h, [h_new]


def _adagrad(ctx, w, g, slots):
    (h,) = slots
    h = h + g * g
    return (ctx.rate * ctx.lr_mult) * g / (torch.sqrt(h) + ctx.delta), [h]


def _rmsprop(ctx, w, g, slots):
    (h,) = slots
    h = ctx.rms_decay * h + (1.0 - ctx.rms_decay) * g * g
    return (ctx.rate * ctx.lr_mult) * g / (torch.sqrt(h) + ctx.delta), [h]


def _adadelta(ctx, w, g, slots):
    """ref: adadelta_solver.cpp — momentum is the squared-accumulator decay;
    two histories (grad^2 and update^2); local_rate still applies."""
    h, h2 = slots
    mu = ctx.momentum
    h = mu * h + (1.0 - mu) * g * g
    val = g * torch.sqrt((h2 + ctx.delta) / (h + ctx.delta))
    h2 = mu * h2 + (1.0 - mu) * val * val
    return (ctx.rate * ctx.lr_mult) * val, [h, h2]


def adam_correction(momentum: float, momentum2: float, it, device=None) -> torch.Tensor:
    """sqrt(1 - beta2^t) / (1 - beta1^t) with t = iter + 1, in float32
    (ref: adam_solver.cpp)."""
    t = torch.full((), float(it), dtype=torch.float32, device=device) + 1.0
    b1 = torch.full((), momentum, dtype=torch.float32, device=device)
    b2 = torch.full((), momentum2, dtype=torch.float32, device=device)
    return torch.sqrt(1.0 - torch.pow(b2, t)) / (1.0 - torch.pow(b1, t))


def _adam(ctx, w, g, slots):
    """ref: adam_solver.cpp — beta1=momentum, beta2=momentum2, eps=delta;
    correction uses t = iter+1."""
    m, v = slots
    b1, b2 = ctx.momentum, ctx.momentum2
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    correction = adam_correction(b1, b2, ctx.it, g.device)
    return (ctx.rate * ctx.lr_mult) * correction * m / (torch.sqrt(v) + ctx.delta), [m, v]


OPTIMIZERS: dict[str, tuple[Callable, int]] = {
    # name -> (rule, number of history slots)
    "SGD": (_sgd, 1),
    "Nesterov": (_nesterov, 1),
    "AdaGrad": (_adagrad, 1),
    "RMSProp": (_rmsprop, 1),
    "AdaDelta": (_adadelta, 2),
    "Adam": (_adam, 2),
}


def init_slots(solver_type: str, params: dict) -> dict:
    """Zero history slots shaped like each param blob
    (ref: SGDSolver::PresolveHistory / history_)."""
    _, n_slots = OPTIMIZERS[solver_type]
    return {lname: [[torch.zeros_like(p) for _ in range(n_slots)] for p in plist]
            for lname, plist in params.items()}


def global_grad_norm(grads: dict) -> torch.Tensor:
    """L2 norm of every grad blob together, in float32: the sum of each
    blob's sum of squares, in params-dict order."""
    total = None
    for glist in grads.values():
        for g in glist:
            s = torch.sum(torch.square(g.float()))
            total = s if total is None else total + s
    return torch.sqrt(total)


def clip_scale(clip_gradients: float, norm: torch.Tensor) -> torch.Tensor:
    """clip/norm where the norm exceeds ``clip_gradients``, else 1
    (ref: ClipGradients, sgd_solver.cpp:81-100).  The quotient is a true
    division (a Python float over a tensor would be a reciprocal times)."""
    clip = torch.full_like(norm, clip_gradients)
    return torch.where(norm > clip_gradients, clip / norm, torch.ones_like(norm))


def apply_update(cfg, params: dict, grads: dict, slots: dict, specs: dict,
                 rate: torch.Tensor, it: int):
    """One full Caffe-ordered update.  cfg is a SolverConfig; specs maps
    layer -> [ParamSpec per blob]; ``rate`` is a 0-dim float32 tensor on the
    params' device.  Returns (new_params, new_slots); nothing is written in
    place."""
    rule, _ = OPTIMIZERS[cfg.solver_type]

    # 1. clip on raw accumulated grads (ref: ClipGradients, sgd_solver.cpp:81-100)
    if cfg.clip_gradients > 0:
        scale = clip_scale(cfg.clip_gradients, global_grad_norm(grads))
        grads = {ln: [g * scale for g in gl] for ln, gl in grads.items()}

    new_params: dict[str, list] = {}
    new_slots: dict[str, list] = {}
    for lname, plist in params.items():
        out_p, out_s = [], []
        for i, w in enumerate(plist):
            if is_placeholder(w):
                # a shared param's 0-size placeholder: the owner's blob is
                # the one updated, once, under the owner's multipliers
                out_p.append(w)
                out_s.append(list(slots[lname][i]))
                continue
            g = grads[lname][i].to(w.dtype)
            spec = specs[lname][i]
            # 2. normalize (ref: Normalize — 1/iter_size)
            if cfg.iter_size > 1:
                g = g / cfg.iter_size
            # 3. regularize (ref: Regularize — L2: g += wd*W; L1: g += wd*sign(W))
            wd = cfg.weight_decay * spec.decay_mult
            if wd != 0.0:
                if cfg.regularization_type == "L1":
                    g = g + wd * torch.sign(w)
                else:
                    g = g + wd * w
            ctx = UpdateCtx(
                rate=rate,
                lr_mult=spec.lr_mult,
                momentum=cfg.momentum,
                momentum2=cfg.momentum2,
                rms_decay=cfg.rms_decay,
                delta=cfg.delta,
                it=it,
            )
            dw, s = rule(ctx, w, g, slots[lname][i])
            out_p.append(w - dw.to(w.dtype))
            # rule math promotes a low-precision slot to float32 through the
            # float32 rate; cast back so the slot type is a fixed point
            out_s.append([x.to(w.dtype) for x in s])
        new_params[lname] = out_p
        new_slots[lname] = out_s
    return new_params, new_slots
