"""The train step and the training loop: port of
``repro/training/train_loop.py`` (``TrainState``, ``make_train_step``,
``TrainerConfig``, ``train``) on one device.

The step differentiates ``Model.loss_fn`` with ``torch.autograd.grad``
(the stack rematerialised per period by ``Runtime.remat``; attention
through the flash kernel's backward on the card), accumulates
``grad_accum`` micro-batches by a loop that sums float32 gradients and
divides (the reference scans), and applies ``adamw_update`` in place.
Batches (numpy, from ``data.pipeline``) move to the model's device as
int32 tensors. ``train`` keeps the reference's history, straggler
monitor, periodic and final checkpoints and resume from the latest
step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.straggler import StragglerMonitor
from repro_torch.training.tree import leaves, tree_map, unflatten


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: opt.OptState

    def tree(self):
        return {"params": self.params, "opt": self.opt_state._asdict()}


def trainable(params):
    """``params`` with every leaf marked as requiring grad (in place)."""
    for p in leaves(params):
        p.requires_grad_(True)
    return params


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A host batch -> int32 tensors on ``device`` (tensors that are
    already there, and float entries such as ``prefix_emb``, keep their
    dtype)."""
    out = {}
    for k, x in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(x)) \
            if isinstance(x, np.ndarray) else x
        if not t.is_floating_point():
            t = t.to(torch.int32)
        out[k] = t.to(device)
    return out


def make_train_step(model: Model, cfg: opt.AdamWConfig, *,
                    grad_accum: int = 1,
                    on_phase: Optional[Callable[[str], None]] = None):
    """Returns (train_step, init_state): ``train_step(state, batch) ->
    (state, metrics)`` (the state's tensors updated in place),
    ``init_state(generator) -> TrainState``. ``on_phase(name)``, where
    given, is called as each phase of the step begins ("forward" and
    "backward" once a micro-batch, "optimizer") and as it ends ("end"),
    for a caller that times them."""
    mark = on_phase or (lambda name: None)

    def grads_of(params, batch):
        mark("forward")
        loss, metrics = model.loss_fn(params, batch)
        ps = leaves(params)
        mark("backward")
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(ps, gs)]
        return loss.detach(), metrics, unflatten(params, gs)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        batch = to_device(batch, model.device)
        if grad_accum > 1:
            n = batch["tokens"].shape[0] // grad_accum
            grads, loss_sum = None, torch.zeros(
                (), dtype=torch.float32, device=model.device)
            for i in range(grad_accum):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                loss, metrics, g = grads_of(state.params, mb)
                grads = (tree_map(lambda x: x.float(), g) if grads is None
                         else tree_map(torch.add, grads, g))
                loss_sum = loss_sum + loss
            grads = tree_map(lambda x: x / grad_accum, grads)
            metrics["loss"] = loss_sum / grad_accum
        else:
            _, metrics, grads = grads_of(state.params, batch)
        mark("optimizer")
        params, opt_state, om = opt.adamw_update(
            cfg, state.params, grads, state.opt_state)
        mark("end")
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(om)
        return TrainState(params, opt_state), metrics

    def init_state(generator: torch.Generator) -> TrainState:
        params = trainable(model.init(generator))
        return TrainState(params, opt.init_opt_state(params))

    return train_step, init_state


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_last: int = 2
    async_ckpt: bool = True
    grad_accum: int = 1


def train(model: Model, data_iter, opt_cfg: opt.AdamWConfig,
          tcfg: TrainerConfig, *, seed: int = 0,
          on_step: Optional[Callable] = None) -> Tuple[Any, Dict]:
    """End-to-end training loop with checkpoint/resume + straggler
    monitoring. Returns (final TrainState, summary). The initial
    parameters come from a ``torch.Generator`` on the model's device
    seeded with ``seed``."""
    step_fn, init_state = make_train_step(model, opt_cfg,
                                          grad_accum=tcfg.grad_accum)
    mgr = (CheckpointManager(tcfg.ckpt_dir, tcfg.keep_last)
           if tcfg.ckpt_dir else None)
    monitor = StragglerMonitor()
    gen = torch.Generator(device=model.device).manual_seed(seed)
    state = init_state(gen)
    start = 0
    if mgr and mgr.latest_step() is not None:
        tree, start = mgr.restore(state.tree())
        state = TrainState(trainable(tree["params"]),
                           opt.OptState(**tree["opt"]))
    history = []
    for step in range(start, tcfg.total_steps):
        batch = next(data_iter)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])          # waits for the step
        dt = time.perf_counter() - t0
        monitor.record(step, dt)
        if on_step:
            on_step(step, metrics)
        if step % tcfg.log_every == 0 or step == tcfg.total_steps - 1:
            history.append((step, loss))
        if mgr and tcfg.ckpt_every and (step + 1) % tcfg.ckpt_every == 0:
            mgr.save(step + 1, state.tree(), async_=tcfg.async_ckpt)
    if mgr:
        mgr.save(tcfg.total_steps, state.tree(), async_=False)
    return state, {"history": history,
                   "stragglers": monitor.events,
                   "mean_step_s": monitor.mean()}
