"""Serving launcher: port of ``repro/launch/serve.py`` (FMMU-paged
continuous batching) on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --smoke --requests 6 --max-new 16 [--device cpu]

The reference's flags, plus ``--device`` (default ``cuda``, which raises
without a card; ``cpu`` runs the plain versions). The same float32
runtime (``capacity_factor`` 100), numpy-seeded prompts of 8..47 tokens,
seeded stub embeddings for the embedding families (a VLM's first
``min(prefix_len, 8)`` patches, an encoder-decoder's 32 source frames,
each 0.02 * N(0, 1) from a ``torch.Generator`` seeded per request), and
the reference's JSON, whose ``fmmu_map`` is ``MapStats.as_dict()``.
Prints the JSON, then the first three requests' first 12 tokens.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_config
from repro_torch.models import Runtime, build_model
from repro_torch.serving import ServeConfig, ServeEngine


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-ctx", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--host-blocks", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    rt = Runtime(compute_dtype=torch.float32, param_dtype=torch.float32,
                 remat="none", page_size=args.page_size,
                 capacity_factor=100.0)
    model = build_model(cfg, rt, device=args.device)
    params = model.init(torch.Generator(device=model.device)
                        .manual_seed(args.seed))
    eng = ServeEngine(model, params, config=ServeConfig(
        n_slots=args.slots, max_ctx=args.max_ctx,
        n_host_blocks=args.host_blocks), device=model.device)

    def stub(seed, n):
        g = torch.Generator(device=model.device).manual_seed(seed)
        return 0.02 * torch.randn((n, cfg.d_model), generator=g,
                                  device=model.device)

    rng = np.random.default_rng(args.seed)
    rids = []
    for i in range(args.requests):
        plen = int(rng.integers(8, 48))
        toks = rng.integers(2, cfg.vocab_size, plen).tolist()
        kw = {}
        if cfg.prefix_len:
            kw["prefix_emb"] = stub(i, min(cfg.prefix_len, 8))
        if cfg.n_enc_layers:
            kw["src_emb"] = stub(100 + i, 32)
        rids.append(eng.submit(toks, max_new=args.max_new, **kw))
    t0 = time.time()
    done = eng.run()
    wall = time.time() - t0
    out = {
        "completed": len(done),
        "generated_tokens": eng.metrics["generated"],
        "decode_steps": eng.metrics["decode_steps"],
        "preemptions": eng.metrics["preemptions"],
        "tok_per_s": round(eng.metrics["generated"] / max(wall, 1e-9), 1),
        "fmmu_map": eng.kvm.hit_stats().as_dict(),
        "pool_peak_blocks": eng.kvm.pool.stats.peak_used,
    }
    print(json.dumps(out, indent=2))
    for rid in rids[:3]:
        print(f"req {rid}: {done.get(rid, [])[:12]}")
    return done


if __name__ == "__main__":
    main()
