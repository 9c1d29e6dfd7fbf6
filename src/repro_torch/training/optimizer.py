"""AdamW with gradient clipping by the global norm: port of
``repro/training/optimizer.py`` (``AdamWConfig``, ``OptState``,
``schedule``, ``init_opt_state``, ``global_norm``, ``adamw_update``),
the reference's arithmetic written out (not ``torch.optim.AdamW``): the
schedule and the bias corrections in float32, weight decay only on
leaves of two or more dimensions (the stacked layers' norms [n_p, d]
included, as in the reference), the moments float32 trees mirroring the
parameters.

``adamw_update`` writes the new parameters and moments into the given
tensors (the reference returns new trees, which its train step donates
in place of the old ones); at llama3.2-1b's width that spares a second
copy of 15 GB of state. The ZeRO sharding of the moments
(``zero_shard_specs``) waits for the port's parallel slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.training.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor     # int32 scalar
    mu: Any
    nu: Any


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``; float32
    (a scalar tensor on ``step``'s device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params) -> OptState:
    dev = leaves(params)[0].device
    zeros = tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=zeros, nu=tree_map(torch.clone, zeros))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: returns (params, OptState(step + 1, mu, nu),
    {"lr", "grad_norm"}), the parameters and moments updated in place."""
    step = state.step + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip else 1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.full_like(stepf, cfg.b1) ** stepf
    bc2 = 1 - torch.full_like(stepf, cfg.b2) ** stepf
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                          leaves(state.nu)):
        g = g.float() * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m2 / bc1
        vhat = v2 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2 and cfg.weight_decay:   # no decay on norms/bias
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m2)
        v.copy_(v2)
    return params, OptState(step=step, mu=state.mu, nu=state.nu), \
        {"lr": lr, "grad_norm": gnorm}
