"""The joint network of the RNN-Transducer model, in ``torch.nn``.

Counterpart of the ``Joint`` module and the ``TransducerConfig`` of
``warp_transducer_tpu/models/transducer.py``: ``enc_proj`` and ``pred_proj``
bring the encoder and prediction outputs to ``joint_dim``, the joint is
``tanh(e ⊕ p)``, and ``out_proj`` maps it to the vocabulary. ``fused_loss``
and ``pruned_fused_loss`` hand ``out_proj``'s weight and bias to the fused
losses, so the (B, T, U, V) or (B, T, S, V) logits are never formed.
Parameters stay f32; ``cfg.dtype`` is the type of the activations.
``utils/convert.py`` carries the weights of the Flax module across.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.fused_joint import rnnt_loss_fused_joint
from ..ops.pruned_fused import rnnt_loss_pruned_fused


@dataclasses.dataclass(frozen=True)
class TransducerConfig:
    vocab_size: int = 128  # includes blank
    blank: int = 0
    encoder_dim: int = 256
    encoder_layers: int = 4
    encoder_heads: int = 4
    conv_kernel: int = 15
    prediction_dim: int = 256
    joint_dim: int = 256
    input_dim: int = 80  # e.g. log-mel features
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16  # activations; params stay fp32
    # Token-and-Duration Transducer (arXiv:2304.06795): non-empty enables a
    # duration head on the joint. () = standard transducer.
    tdt_durations: tuple = ()


class Joint(nn.Module):
    def __init__(self, cfg: TransducerConfig, device=None):
        super().__init__()
        if cfg.tdt_durations:
            raise NotImplementedError("the duration head of the joint is not ported yet")
        self.cfg = cfg
        kw = dict(device=device, dtype=torch.float32)
        self.enc_proj = nn.Linear(cfg.encoder_dim, cfg.joint_dim, **kw)
        self.pred_proj = nn.Linear(cfg.prediction_dim, cfg.joint_dim, **kw)
        self.out_proj = nn.Linear(cfg.joint_dim, cfg.vocab_size, **kw)

    def _linear(self, layer, x):
        """``layer`` applied in ``cfg.dtype`` (inputs and parameters cast, as
        Flax's ``Dense(dtype=...)``)."""
        dt = self.cfg.dtype
        return nn.functional.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))

    def forward(self, enc, pred):
        """enc (B, T, H_enc), pred (B, U, H_pred) -> logits (B, T, U, V)."""
        e = self._linear(self.enc_proj, enc)  # (B, T, H)
        p = self._linear(self.pred_proj, pred)  # (B, U, H)
        joint = torch.tanh(e[:, :, None, :] + p[:, None, :, :])  # (B, T, U, H)
        return self._linear(self.out_proj, joint)

    def banded(self, enc, pred_banded):
        """Joint on a pruned band: pred_banded (B, T, S, H_pred) -> logits
        (B, T, S, V)."""
        e = self._linear(self.enc_proj, enc)  # (B, T, H)
        p = self._linear(self.pred_proj, pred_banded)  # (B, T, S, H)
        return self._linear(self.out_proj, torch.tanh(e[:, :, None, :] + p))

    def _fused_inputs(self, enc, pred):
        """e, p, and out_proj's weight as (H, V) in ``cfg.dtype``, its bias
        in f32: what the fused losses take."""
        dt = self.cfg.dtype
        e = self._linear(self.enc_proj, enc)
        p = self._linear(self.pred_proj, pred)
        W = self.out_proj.weight.to(dt).t().contiguous()
        return e, p, W, self.out_proj.bias.float()

    def fused_loss(self, enc, pred, labels, input_lengths, label_lengths, reduction="mean",
                   implementation="auto"):
        """RNN-T loss with the output projection fused in: the (B, T, U, V)
        logits are never formed (``ops/fused_joint.py``)."""
        e, p, W, b = self._fused_inputs(enc, pred)
        return rnnt_loss_fused_joint(e, p, W, b, labels, input_lengths, label_lengths,
                                     blank=self.cfg.blank, reduction=reduction,
                                     implementation=implementation)

    def pruned_fused_loss(self, enc, pred, ranges, labels, input_lengths, label_lengths,
                          s_range: int, reduction="mean", implementation="auto"):
        """Pruned band loss with the output projection fused in: above the
        working-set threshold the (B, T, S, V) banded logits are never
        formed (``ops/pruned_fused.py``)."""
        e, p, W, b = self._fused_inputs(enc, pred)
        return rnnt_loss_pruned_fused(e, p, W, b, ranges, labels, input_lengths, label_lengths,
                                      s_range=s_range, blank=self.cfg.blank,
                                      reduction=reduction, implementation=implementation)
