"""Training loop: a step (autograd, then AdamW), checkpoint/restart and
the losses (twin of ``repro.train.train_loop``).

Fault tolerance: checkpoints are atomic and resumable; ``run`` restores
the newest valid checkpoint and continues from there (restart-safe),
saving asynchronously every ``ckpt_every`` steps. It runs on the card
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models import model as Mdl
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train import optimizer as Opt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import TokenPipeline


@dataclass
class TrainResult:
    losses: list
    steps: int
    restored_from: int
    step_seconds: list = field(default_factory=list)   # host clock a step


def make_step(cfg, adam: Opt.AdamConfig):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``:
    the loss and its gradient by autograd, then ``adam_update``. The
    params passed in are not written. bf16 products accumulate in fp32,
    as the reference's dots do."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch)
        params, opt_state, _ = Opt.adam_update(params, grads, opt_state, adam)
        return params, opt_state, loss
    return step


def loss_and_grads(cfg, params, batch):
    """(the loss, its gradient as a tree like ``params``) by autograd;
    ``params`` are not written."""
    params = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = Mdl.loss_fn(cfg, params, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(params),
                                     allow_unused=True,
                                     materialize_grads=True))
    return loss.detach(), tree_map(lambda p: next(grads), params)


def run(cfg, *, steps=50, batch=4, seq=64, ckpt_dir=None, ckpt_every=20,
        seed=0, adam=None, params=None, device="cuda",
        gen: torch.Generator | None = None) -> TrainResult:
    """Train ``cfg`` on ``TokenPipeline`` batches from ``seed`` for
    ``steps`` steps, restoring from and saving to ``ckpt_dir``. The params
    are ``params`` (moved to ``device``), else drawn by ``init_params``
    from ``gen`` (default: a generator on ``device`` seeded with
    ``seed``)."""
    dev = resolve_device(device, "train_loop.run")
    adam = adam or Opt.AdamConfig(lr=1e-3, warmup=10, total_steps=steps)
    if params is None:
        params = Mdl.init_params(
            cfg, gen or torch.Generator(device=dev).manual_seed(seed))
    else:
        params = tree_map(lambda p: p.to(dev), params)
    opt_state = Opt.init_adam(params, adam)
    step_fn = make_step(cfg, adam)
    pipe = TokenPipeline(cfg.vocab, batch, seq, seed=seed)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start, restored = 0, -1
    if mgr is not None:
        s, tree = mgr.restore((params, opt_state))
        if s is not None:
            params, opt_state = tree
            start, restored = s, s

    losses, seconds = [], []
    try:
        for i in range(start, steps):
            t0 = time.perf_counter()
            batch_dev = {k: torch.as_tensor(v, device=dev)
                         for k, v in next(pipe).items()}
            params, opt_state, loss = step_fn(params, opt_state, batch_dev)
            losses.append(float(loss))
            seconds.append(time.perf_counter() - t0)
            if mgr is not None and (i + 1) % ckpt_every == 0:
                mgr.save_async(i + 1, (params, opt_state))
    finally:
        if mgr is not None:
            mgr.wait()
        pipe.close()
    return TrainResult(losses, steps, restored, seconds)
