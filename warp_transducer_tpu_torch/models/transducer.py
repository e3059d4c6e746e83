"""The joint network of the RNN-Transducer model, in ``torch.nn``.

Counterpart of the ``Joint`` module and the ``TransducerConfig`` of
``warp_transducer_tpu/models/transducer.py``: ``enc_proj`` and ``pred_proj``
bring the encoder and prediction outputs to ``joint_dim``, the joint is
``tanh(e ⊕ p)``, and ``out_proj`` maps it to the vocabulary; with
``cfg.tdt_durations`` a second head, ``dur_proj``, maps the same features to
the duration logits (``tdt``, ``tdt_step``). ``fused_loss``,
``pruned_fused_loss``, ``multiblank_fused_loss`` and ``tdt_fused_loss`` hand
the heads' weights and biases to the fused losses, so the (B, T, U, V) or
(B, T, S, V) logits are never formed. Parameters stay f32; ``cfg.dtype`` is
the type of the activations.
``utils/convert.py`` carries the weights of the Flax module across.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.fused_joint import rnnt_loss_fused_joint
from ..ops.multiblank_fused import rnnt_loss_multiblank_fused_joint
from ..ops.pruned_fused import rnnt_loss_pruned_fused
from ..ops.tdt_fused import rnnt_loss_tdt_fused_joint


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
    """The joint network: ``enc_proj``, ``pred_proj``, tanh, ``out_proj``
    (and ``dur_proj`` with ``cfg.tdt_durations``).

    Its fused losses (``fused_loss``, ``multiblank_fused_loss``,
    ``tdt_fused_loss``) run the fused joint kernels on a CUDA tensor, which
    take ``cfg.joint_dim`` <= 1024 and raise ``ValueError`` above it;
    ``pruned_fused_loss`` and the plain versions (CPU tensors,
    ``implementation="torch"``) compute at any width.
    """

    def __init__(self, cfg: TransducerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=torch.float32)
        self.enc_proj = nn.Linear(cfg.encoder_dim, cfg.joint_dim, **kw)
        self.pred_proj = nn.Linear(cfg.prediction_dim, cfg.joint_dim, **kw)
        self.out_proj = nn.Linear(cfg.joint_dim, cfg.vocab_size, **kw)
        if cfg.tdt_durations:
            self.dur_proj = nn.Linear(cfg.joint_dim, len(cfg.tdt_durations), **kw)

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

    def step(self, enc_frame, pred_out):
        """Decode-time joint: enc_frame (B, H_enc), pred_out (B, ..., H_pred)
        -> logits (B, ..., V); enc broadcasts over any beam dims."""
        return self._linear(self.out_proj, self._step_features(enc_frame, pred_out))

    def _step_features(self, enc_frame, pred_out):
        e = self._linear(self.enc_proj, enc_frame)
        p = self._linear(self.pred_proj, pred_out)
        while e.dim() < p.dim():
            e = e.unsqueeze(-2)
        return torch.tanh(e + p)

    def _dur_proj(self):
        if not self.cfg.tdt_durations:
            raise ValueError("this Joint has no duration head: cfg.tdt_durations is empty")
        return self.dur_proj

    def tdt(self, enc, pred):
        """(token_logits (B, T, U, V), duration_logits (B, T, U, D)): the two
        TDT heads share the tanh joint features (arXiv:2304.06795)."""
        dur_proj = self._dur_proj()
        e = self._linear(self.enc_proj, enc)
        p = self._linear(self.pred_proj, pred)
        joint = torch.tanh(e[:, :, None, :] + p[:, None, :, :])
        return self._linear(self.out_proj, joint), self._linear(dur_proj, joint)

    def tdt_step(self, enc_frame, pred_out):
        """Decode-time TDT joint -> (token logits, duration logits)."""
        dur_proj = self._dur_proj()
        joint = self._step_features(enc_frame, pred_out)
        return self._linear(self.out_proj, joint), self._linear(dur_proj, joint)

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

    def multiblank_fused_loss(self, enc, pred, labels, input_lengths, label_lengths,
                              big_blank_durations, reduction="mean", sigma=0.0,
                              fastemit_lambda=0.0, delay_penalty=0.0, implementation="auto"):
        """Multi-blank loss with the output projection fused in; the big
        blanks live on the last K vocabulary columns of the standard joint
        (``ops/multiblank_fused.py``)."""
        e, p, W, b = self._fused_inputs(enc, pred)
        return rnnt_loss_multiblank_fused_joint(
            e, p, W, b, labels, input_lengths, label_lengths, big_blank_durations,
            blank=self.cfg.blank, reduction=reduction, sigma=sigma,
            fastemit_lambda=fastemit_lambda, delay_penalty=delay_penalty,
            implementation=implementation)

    def tdt_fused_loss(self, enc, pred, labels, input_lengths, label_lengths, reduction="mean",
                       sigma=0.0, fastemit_lambda=0.0, delay_penalty=0.0,
                       implementation="auto"):
        """TDT loss with both heads fused in: the (B, T, U, V) token logits
        and the (B, T, U, H) joint features are never formed
        (``ops/tdt_fused.py``). The duration head's weight and bias go in as
        f32. Needs ``cfg.tdt_durations``."""
        dur_proj = self._dur_proj()
        e, p, W, b = self._fused_inputs(enc, pred)
        return rnnt_loss_tdt_fused_joint(
            e, p, W, b, dur_proj.weight.float().t().contiguous(), dur_proj.bias.float(),
            labels, input_lengths, label_lengths, durations=self.cfg.tdt_durations,
            blank=self.cfg.blank, reduction=reduction, sigma=sigma,
            fastemit_lambda=fastemit_lambda, delay_penalty=delay_penalty,
            implementation=implementation)
