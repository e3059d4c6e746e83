#!/usr/bin/env python
"""End-to-end toy training demo for warp_transducer_tpu_torch.

The PyTorch twin of ``examples/train_toy.py``: trains the Transducer model
(conformer-lite encoder, LSTM prediction network, additive joint) on a
synthetic copy task three ways,

  1. dense  — ``rnnt_loss`` on the full (B, T, U, V) joint;
  2. pruned — the two-stage pruned transducer (the simple loss on the
              factorised heads, then the loss on an S-wide band);
  3. fused  — the joint's output projection fused into the loss (the
              (B, T, U, V) logits are never formed);

then greedy- and beam-decodes a batch, and does the same for a
Token-and-Duration Transducer (a duration head on the joint; greedy decode
skips frames by the duration argmax, the beam search follows every
duration arc). Runs on the CPU in about a minute:

    python examples/train_toy_torch.py

Pass ``--device cuda`` to run it on a card (the loss kernels of ``csrc/``
run there).
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from warp_transducer_tpu_torch.models import (  # noqa: E402
    Transducer, TransducerConfig, beam_search_decode, beam_search_decode_tdt, greedy_decode,
    greedy_decode_tdt, make_fused_train_step, make_pruned_train_step, make_tdt_train_step,
    make_train_step)


def synthetic_batch(cfg, B, T, L, seed, device):
    """Copy task: the labels are drawn per utterance; the features encode
    them, each label smeared over T/L frames, plus noise."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(1, cfg.vocab_size, size=(B, L)).astype(np.int32)
    feats = np.zeros((B, T, cfg.input_dim), np.float32)
    for b in range(B):
        for i, y in enumerate(labels[b]):
            feats[b, (i * T) // L:((i + 1) * T) // L, y % cfg.input_dim] = 1.0
    feats += 0.05 * rng.randn(B, T, cfg.input_dim).astype(np.float32)
    return {"feats": torch.tensor(feats, device=device),
            "feat_lengths": torch.full((B,), T, dtype=torch.int32, device=device),
            "labels": torch.tensor(labels, device=device),
            "label_lengths": torch.full((B,), L, dtype=torch.int32, device=device)}


def train(cfg, make_step, batch, n_steps, device, **kw):
    """A fresh model (seed 0) trained ``n_steps`` Adam steps; (model, losses)."""
    model = Transducer(cfg, device=device, generator=torch.Generator().manual_seed(0))
    step = make_step(model, torch.optim.Adam(model.parameters(), lr=3e-3), **kw)
    return model, [float(step(batch)) for _ in range(n_steps)]


def exact_matches(tokens, n, labels):
    return sum(tokens[b, :int(n[b])].tolist() == labels[b].tolist() for b in range(len(labels)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cpu", help="cpu (default) or cuda")
    device = torch.device(parser.parse_args().device)
    cfg = TransducerConfig(vocab_size=16, encoder_dim=64, encoder_layers=1, encoder_heads=2,
                           prediction_dim=64, joint_dim=64, input_dim=16, conv_kernel=5,
                           dtype=torch.float32)
    B, T, L = 4, 24, 6
    batch = synthetic_batch(cfg, B, T, L, seed=0, device=device)

    steps = {"dense": (make_train_step, {}), "pruned": (make_pruned_train_step, {"s_range": 3}),
             "fused": (make_fused_train_step, {})}
    for name, (make_step, kw) in steps.items():
        _, losses = train(cfg, make_step, batch, 40, device, **kw)
        print(f"{name:6s}: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
        assert losses[-1] < losses[0], f"{name} did not learn"

    # decode with a dense-trained model
    model, losses = train(cfg, make_train_step, batch, 150, device)
    gt, gn = greedy_decode(model, batch["feats"], batch["feat_lengths"], max_symbols=L + 2)
    bt, bn, _ = beam_search_decode(model, batch["feats"], batch["feat_lengths"],
                                   max_symbols=L + 2, beam=4, expansions=3)
    ref = batch["labels"]
    print(f"decode: greedy exact-match {exact_matches(gt, gn, ref)}/{B}, beam exact-match "
          f"{exact_matches(bt[:, 0], bn[:, 0], ref)}/{B} (loss {losses[-1]:.3f})")

    # --- Token-and-Duration Transducer (arXiv 2304.06795) -------------------
    tdt_cfg = dataclasses.replace(cfg, tdt_durations=(0, 1, 2, 4))
    model, losses = train(tdt_cfg, make_tdt_train_step, batch, 150, device, sigma=0.02)
    tt, tn = greedy_decode_tdt(model, batch["feats"], batch["feat_lengths"], max_symbols=L + 2)
    tbt, tbn, _ = beam_search_decode_tdt(model, batch["feats"], batch["feat_lengths"],
                                         max_symbols=L + 2, beam=4, sigma=0.02)
    tdt_ok, tdt_beam_ok = exact_matches(tt, tn, ref), exact_matches(tbt[:, 0], tbn[:, 0], ref)
    print(f"tdt   : loss {losses[0]:.3f} -> {losses[-1]:.3f}, greedy exact-match {tdt_ok}/{B}, "
          f"beam {tdt_beam_ok}/{B}")
    assert losses[-1] < losses[0], "tdt did not learn"
    assert tdt_beam_ok >= tdt_ok, "beam should not decode worse than greedy"


if __name__ == "__main__":
    main()
