"""Training of every served family beyond the dense decoders, on the CPU
against the JAX package: ``Model.loss_fn``'s value, every metric and
every gradient leaf of the port against ``jax.value_and_grad`` at
``smoke_config`` in float32, with the reference's initialisation loaded
through ``convert.params_from_jax`` (``_torch_pairs.train_pair``; loss
within 1e-5 relative, each leaf within 1e-4 of its largest magnitude):

- mamba2-1.3b, packed and unpacked: the gradient through
  ``ops.mamba_chunk_scan`` (on the CPU autograd of the plain scan; the
  state runs across packed documents, as in the reference);
- dbrx-132b: through ``route`` / ``gather_rows`` / ``combine`` and the
  MoE ``aux_loss``;
- seamless-m4t-large-v2: the encoder and cross-attention, with
  ``src_emb`` and a ragged ``src_valid`` made with numpy from a seed;
- llava-next-mistral-7b: with ``prefix_emb`` before the tokens, the loss
  falling only on the text tail.

The llama and gemma2 gradients are held in ``test_torch_train.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pairs import BATCH  # noqa: E402
from _torch_pairs import hold_loss_and_grads, train_batch, train_pair  # noqa: E402


def _emb(rng, shape):
    """Seeded stub embeddings, 0.02 * N(0, 1) (the reference tests'
    scale), float32."""
    return (0.02 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "unpacked"])
def test_mamba2_loss_and_grads_match_jax(pack):
    vg, jp, tm, tp = train_pair("mamba2-1.3b")
    hold_loss_and_grads(vg, jp, tm, tp, train_batch(tm.cfg.vocab_size, pack))


def test_dbrx_loss_and_grads_match_jax():
    """Every leaf, the router's and the experts' included, and the aux
    loss (nonzero) in the metrics."""
    vg, jp, tm, tp = train_pair("dbrx-132b")
    metrics = hold_loss_and_grads(vg, jp, tm, tp,
                                  train_batch(tm.cfg.vocab_size, True))
    assert float(metrics["aux_loss"].detach()) > 0


def test_seamless_loss_and_grads_match_jax():
    """24 source frames a row, rows 1-3 with a seeded number of valid
    frames (row 0 all of them)."""
    vg, jp, tm, tp = train_pair("seamless-m4t-large-v2")
    rng = np.random.default_rng(0)
    n_src = 24
    batch = train_batch(tm.cfg.vocab_size, False)
    batch["src_emb"] = _emb(rng, (BATCH, n_src, tm.cfg.d_model))
    lens = np.concatenate([[n_src], rng.integers(1, n_src, BATCH - 1)])
    batch["src_valid"] = (np.arange(n_src)[None, :] < lens[:, None]).astype(
        np.int32)
    hold_loss_and_grads(vg, jp, tm, tp, batch)


def test_llava_loss_and_grads_match_jax():
    """8 seeded prefix embeddings before each row's tokens (positions
    then run over prefix and text, as the reference makes them); labels
    cover the text alone."""
    vg, jp, tm, tp = train_pair("llava-next-mistral-7b")
    rng = np.random.default_rng(1)
    batch = train_batch(tm.cfg.vocab_size, False)
    del batch["positions"]
    batch["prefix_emb"] = _emb(rng, (BATCH, 8, tm.cfg.d_model))
    hold_loss_and_grads(vg, jp, tm, tp, batch)
