"""Token sampling policies: port of ``repro/serving/sampling.py``.

``greedy`` is the argmax over the last axis (int32, the first index on
ties). ``temperature`` draws from the categorical over ``logits / temp``
with an explicit ``torch.Generator`` on the logits' device; ``top_k``
keeps every logit at or above the k-th largest (ties at the threshold
included), as the reference's ``jax.lax.top_k`` threshold does. The draw
is the Gumbel-max form ``jax.random.categorical`` uses: no host sync, so
it can sit inside a captured step.
"""
from __future__ import annotations

import torch

MASKED = -1e30      # the reference's fill for logits below the top-k cut


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def top_k_mask(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """``logits`` with every entry below the k-th largest of its row set
    to ``MASKED``."""
    thresh = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits < thresh, torch.full_like(logits, MASKED),
                       logits)


def temperature(logits: torch.Tensor, generator: torch.Generator,
                temp: float = 1.0, top_k: int = 0) -> torch.Tensor:
    if temp <= 0:
        return greedy(logits)
    l = logits.float() / temp
    if top_k:
        l = top_k_mask(l, top_k)
    u = torch.rand(l.shape, generator=generator, device=l.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(l - torch.log(-torch.log(u)), dim=-1).to(torch.int32)
