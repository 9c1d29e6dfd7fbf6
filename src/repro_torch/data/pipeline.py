"""Deterministic synthetic LM data pipeline: document sampling, packing
with segment ids, host-side prefetch, per-host sharding. The port's
copy of ``repro/data/pipeline.py`` (numpy only): draw for draw, its
batches equal the reference's. The training loop moves them to the
model's device as int32 tensors.

Synthetic corpus: "documents" are integer sequences from a seeded
zipf-ish unigram model with strong local structure (bigram chains) so
that small models show real loss curves. Deterministic per (seed, step,
host): restarts and elastic rescales reproduce the exact stream.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    pack: bool = True
    mean_doc_len: int = 96
    prefetch: int = 2
    host_index: int = 0
    host_count: int = 1


def _doc(rng: np.random.Generator, cfg: DataConfig) -> np.ndarray:
    n = max(8, int(rng.exponential(cfg.mean_doc_len)))
    v = cfg.vocab_size
    start = rng.integers(2, v)
    # bigram chain: next token is a deterministic mix of prev + noise
    toks = [start]
    for _ in range(n - 1):
        nxt = (toks[-1] * 31 + 7) % (v - 2) + 2 if rng.random() < 0.7 \
            else int(rng.integers(2, v))
        toks.append(nxt)
    return np.asarray(toks, np.int32)


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """One deterministic global batch (this host's shard)."""
    per_host = cfg.global_batch // cfg.host_count
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_index]))
    tokens = np.zeros((per_host, cfg.seq_len), np.int32)
    labels = np.full((per_host, cfg.seq_len), -1, np.int32)
    segs = np.zeros((per_host, cfg.seq_len), np.int32)
    pos = np.zeros((per_host, cfg.seq_len), np.int32)
    for b in range(per_host):
        off, seg = 0, 0
        while off < cfg.seq_len:
            d = _doc(rng, cfg)
            take = min(len(d), cfg.seq_len - off)
            tokens[b, off:off + take] = d[:take]
            labels[b, off:off + take - 1] = d[1:take]
            segs[b, off:off + take] = seg
            pos[b, off:off + take] = np.arange(take)
            off += take
            seg += 1
            if not cfg.pack:
                break
    out = {"tokens": tokens, "labels": labels, "positions": pos}
    if cfg.pack:
        out["segment_ids"] = segs
    return out


class Prefetcher:
    """Background-thread batch producer (host-side pipeline overlap)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._step = start_step
        self._t = threading.Thread(target=self._work, daemon=True)
        self._t.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = make_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, batch = self.q.get()
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=2)


def data_iter(cfg: DataConfig, start_step: int = 0, prefetch: bool = True):
    if prefetch:
        return Prefetcher(cfg, start_step)

    def gen():
        step = start_step
        while True:
            yield make_batch(cfg, step)
            step += 1

    return gen()
