"""Training launcher: port of ``repro/launch/train.py`` on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
      [--device cpu]

The reference's flags, plus ``--device`` (default ``cuda``; ``cpu`` runs
the plain versions). Prints a line per ``--log-every`` steps and, last,
the reference's JSON line (final_loss, first_loss, mean_step_s,
stragglers). ``--tp`` (a model-parallel mesh) waits for the port's
parallel slice and raises.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import get_arch, smoke_config
from repro_torch.data.pipeline import DataConfig, data_iter
from repro_torch.models import Runtime, build_model
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import TrainerConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config for CPU runs")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--tp", type=int, default=0,
                    help="model-parallel size (0 = single device)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.tp:
        raise NotImplementedError(
            "--tp: the port trains on one device; the model-parallel mesh "
            "waits for its parallel slice")

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    rt = Runtime(
        compute_dtype=torch.float32 if args.fp32 else torch.bfloat16,
        param_dtype=torch.float32, remat=args.remat)
    model = build_model(cfg, rt, device=args.device)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    it = data_iter(dcfg)
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                           decay_steps=args.steps)
    tcfg = TrainerConfig(total_steps=args.steps, log_every=args.log_every,
                         ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                         grad_accum=args.grad_accum)

    def on_step(step, metrics):
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f}", flush=True)

    try:
        state, summary = train(model, it, ocfg, tcfg, on_step=on_step)
    finally:
        if hasattr(it, "close"):
            it.close()
    print(json.dumps({
        "final_loss": summary["history"][-1][1],
        "first_loss": summary["history"][0][1],
        "mean_step_s": round(summary["mean_step_s"], 4),
        "stragglers": len(summary["stragglers"]),
    }))
    return state, summary


if __name__ == "__main__":
    main()
