"""AdamW with a warmup-cosine schedule and global-norm clipping (twin of
``repro.train.optimizer``).

Params, gradients and both moments are nested dicts of tensors; the
moments are kept in ``moment_dtype`` (fp32). Every step follows the
reference's order of operations: the global norm of the gradients, the
clip scale ``min(1, grad_clip / (norm + 1e-9))``, the bias-corrected
moments, then the decoupled weight decay ``p * (1 - lr * wd) - lr * d``.
ZeRO-style sharding falls out of FSDP: both moments take the params'
specs (``adam_specs``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import dtype_of
from repro_torch.models.sharding import laid_out_like


class AdamConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup: int = 200
    total_steps: int = 10_000
    moment_dtype: str = "float32"


class AdamState(NamedTuple):
    step: torch.Tensor            # int32, 0-d
    mu: dict
    nu: dict


def init_adam(params, cfg: AdamConfig) -> AdamState:
    dt = dtype_of(cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return AdamState(step, tree_map(zeros, params), tree_map(zeros, params))


def adam_specs(param_specs) -> AdamState:
    """Optimizer-state specs mirroring the parameter specs."""
    return AdamState((), param_specs, param_specs)


def schedule(step, cfg: AdamConfig):
    """The learning rate at ``step`` (an int32 tensor), fp32: linear
    warmup, then a cosine from lr down to 0.1 lr at ``total_steps``."""
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup)
                       / max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree):
    return torch.sqrt(sum((x.float() ** 2).sum() for x in tree_leaves(tree)))


@torch.no_grad()
def adam_update(params, grads, state: AdamState, cfg: AdamConfig):
    """One AdamW step with global-norm clipping. Returns (params, state,
    metrics); the inputs are not written. DTensor gradients are laid out
    as their params first, so the new params and moments keep the
    params' placements (``adam_specs``); the step is replicated."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        g = laid_out_like(g, p).float() * scale
        m2 = b1 * m.float() + (1 - b1) * g
        v2 = b2 * v.float() + (1 - b2) * g * g
        d = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        p2 = p.float() * (1.0 - lr * cfg.weight_decay) - lr * d
        return p2.to(p.dtype), m2.to(m.dtype), v2.to(v.dtype)

    out = tree_map(upd, params, grads, state.mu, state.nu)
    new = [tree_map(lambda o, i=i: o[i], out) for i in range(3)]
    return new[0], AdamState(step, new[1], new[2]), {"grad_norm": gnorm,
                                                     "lr": lr}
