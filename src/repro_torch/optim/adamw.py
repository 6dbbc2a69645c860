"""AdamW with decoupled weight decay, global-norm clipping and schedules.

The port of ``repro.optim.adamw``, on trees (nested dicts) of tensors in
the reference's leaf order (:mod:`repro_torch.utils.tree`).  The
optimizer state mirrors the parameters (``m``, ``v``, float32).  The
formulas are the reference's, not ``torch.optim.AdamW``'s or
``clip_grad_norm_``'s, whose epsilons differ: clipping scales by
``min(1, max_norm / max(norm, 1e-12))``; the step is ``mhat /
(sqrt(vhat) + eps)``; the parameter becomes ``p - lr * (step + wd * p)``
in float32; the learning rate is the warmup-cosine schedule in float32.
Unlike the reference, which returns new trees, :func:`adamw_update`
updates the parameters and the state in place (under
``torch.no_grad()``), so a full-size model holds one copy of each.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    schedule: str = "cosine"     # cosine | constant


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), a float32
    0-d tensor on the CPU: linear warmup, then cosine decay to
    ``min_lr_frac * lr`` (or constant), in float32 as the reference."""
    step = _f32(step.cpu() if isinstance(step, torch.Tensor) else step)
    if cfg.warmup_steps > 0:
        warm = torch.clamp(step / cfg.warmup_steps, max=1.0)
    else:
        warm = _f32(1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params) -> dict:
    """Zero ``m`` and ``v``, float32 trees shaped like ``params``."""
    leaves, treedef = tree_flatten(params)
    zeros = lambda: tree_unflatten(treedef, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in leaves])
    return {"m": zeros(), "v": zeros()}


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum over leaves of sum(x^2))`` in float32."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled to at most max_norm, as float32, the norm)``."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    leaves, treedef = tree_flatten(grads)
    return tree_unflatten(treedef, [g.float() * scale for g in leaves]), norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state, step, *,
                 gnorm=None):
    """One AdamW step: clips ``grads`` by global norm, updates ``params``
    and ``opt_state`` (``{"m", "v"}``) in place and returns ``(params,
    opt_state, {"grad_norm", "lr"})``.  ``step`` is the number of steps
    taken before this one.  ``gnorm``: the gradients' global norm when
    the caller computed it (the blocks of a rank-local state sum across
    ranks: :func:`repro_torch.distributed.rank_local.global_norm`); the
    update itself is elementwise, so blocks update as the whole would."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    lr = schedule_lr(cfg, step)
    t = _f32(int(step) + 1)
    bc1 = float(1 - _f32(cfg.beta1) ** t)
    bc2 = float(1 - _f32(cfg.beta2) ** t)
    lr_f = float(lr)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        g = g.float() * scale
        m.mul_(cfg.beta1).add_((1 - cfg.beta1) * g)
        v.mul_(cfg.beta2).add_((1 - cfg.beta2) * g * g)
        del g
        step_ = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        p.copy_(pf - lr_f * (step_ + cfg.weight_decay * pf))
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
