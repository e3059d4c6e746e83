"""The RNN-Transducer model in ``torch.nn``: encoder, prediction network,
joint, the five loss functions and the eight train steps.

Counterpart of ``warp_transducer_tpu/models/transducer.py``:

* ``Encoder``: an input projection, then ``cfg.encoder_layers`` conformer
  blocks (``FeedForward`` / self-attention / ``ConvModule`` /
  ``FeedForward``, each behind a LayerNorm, and a closing LayerNorm); the
  padded frames are zeroed after the projection and at the end;
* ``Prediction``: an embedding of the blank-prefixed labels (U = L + 1)
  and a unidirectional LSTM, with ``initial_state`` / ``step`` for decoders;
* ``Joint``: ``enc_proj`` and ``pred_proj`` bring the encoder and prediction
  outputs to ``joint_dim``, the joint is ``tanh(e ⊕ p)``, and ``out_proj``
  maps it to the vocabulary; with ``cfg.tdt_durations`` a second head,
  ``dur_proj``, maps the same features to the duration logits. Its fused
  losses hand the heads' weights to the fused kernels, so the (B, T, U, V)
  or (B, T, S, V) logits are never formed;
* ``Transducer``: the three together, with ``am_head`` / ``lm_head`` for
  the factorised (simple / pruned stage-1) loss;
* ``loss_fn``, ``tdt_loss_fn``, ``multiblank_loss_fn``, ``pruned_loss_fn``,
  ``pruned_fused_loss_fn`` and the eight ``make_*_train_step``: a step is
  ``step(batch) -> loss`` running forward, loss, ``backward()`` and a
  ``torch.optim`` optimiser's ``step()``.

Conventions:
* parameters are f32 and activations ``cfg.dtype`` (bf16 by default): each
  layer casts its input and its parameters to ``cfg.dtype``, as Flax's
  ``dtype=`` does; LayerNorm computes in f32 and rounds once;
* every module builds its parameters on ``device``, by default the card
  (``torch.device("cuda")``); without a card it raises rather than land on
  the CPU, so a CPU caller passes ``device="cpu"``;
* initial weights come from ``generator``, a CPU ``torch.Generator``
  (seed 0 when none is given), so one seed gives the same weights on every
  device. ``utils/convert.py`` carries a Flax tree's weights across;
* ``implementation`` ('auto' | 'torch' | 'cuda', ``ops/rnnt.py``) of every
  loss function and train step picks the kernels or their plain versions
  for the loss; the layers are library calls either way.

The prediction network's LSTM is a loop over U of the cell's math
(``LSTMCell``), not ``torch.nn.LSTM``: Flax's ``OptimizedLSTMCell`` rounds
each gate's products to ``cfg.dtype`` but keeps the carry (c, h) in f32
(a bf16 gate times an f32 carry promotes), which ``nn.LSTM`` (its state in
the input's type, cuDNN's own rounding in bf16) does not reproduce. The
input products of all U steps are one matmul before the loop; the loop
runs U = L + 1 steps of one (B, 4H) product each.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_joint import rnnt_loss_fused_joint
from ..ops.multiblank import rnnt_loss_multiblank
from ..ops.multiblank_fused import rnnt_loss_multiblank_fused_joint
from ..ops.pruned import gather_banded, rnnt_loss_pruned
from ..ops.pruned_fused import rnnt_loss_pruned_fused
from ..ops.rnnt import rnnt_loss
from ..ops.simple import rnnt_loss_simple
from ..ops.tdt import rnnt_loss_tdt
from ..ops.tdt_fused import rnnt_loss_tdt_fused_joint

# Flax's LayerNorm epsilon (torch.nn.LayerNorm's default is 1e-5).
LAYER_NORM_EPS = 1e-6


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


def _device(device) -> torch.device:
    """``device``, or the card when it is None; raises without a card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: the model builds its parameters on the "
                           "card unless device= names another (device='cpu' for the CPU)")
    return torch.device("cuda")


def _generator(generator) -> torch.Generator:
    if generator is None:
        return torch.Generator().manual_seed(0)
    if generator.device.type != "cpu":
        raise ValueError(f"generator must be a CPU torch.Generator; got one on {generator.device}")
    return generator


def _fill_(param, std, generator):
    """``param`` ← normal(0, std) drawn on the CPU from ``generator``."""
    with torch.no_grad():
        param.copy_(torch.randn(param.shape, generator=generator) * std)


def _dense(n_in, n_out, device, generator, bias=True) -> nn.Linear:
    """An f32 ``nn.Linear`` with weight normal(0, 1/n_in) (LeCun, as Flax's
    default) from ``generator`` and a zero bias."""
    layer = nn.Linear(n_in, n_out, bias=bias, device=device, dtype=torch.float32)
    _fill_(layer.weight, n_in ** -0.5, generator)
    if bias:
        with torch.no_grad():
            layer.bias.zero_()
    return layer


def _layer_norm(dim, device) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LAYER_NORM_EPS, device=device, dtype=torch.float32)


def _linear(layer, x, dt):
    """``layer`` applied in ``dt`` (inputs and parameters cast, as Flax's
    ``Dense(dtype=...)``)."""
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def _norm(layer, x, dt):
    """Flax's ``LayerNorm(dtype=...)``: statistics, scale and bias in f32,
    one rounding to ``dt``."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight, layer.bias,
                        layer.eps).to(dt)


class FeedForward(nn.Module):
    """``Dense(4·dim)`` → swish → ``Dense(dim)``."""

    def __init__(self, dim, dtype, device=None, generator=None):
        super().__init__()
        device, generator = _device(device), _generator(generator)
        self.dtype = dtype
        self.fc1 = _dense(dim, 4 * dim, device, generator)
        self.fc2 = _dense(4 * dim, dim, device, generator)

    def forward(self, x):
        return _linear(self.fc2, F.silu(_linear(self.fc1, x, self.dtype)), self.dtype)


class ConvModule(nn.Module):
    """Pointwise GLU → depthwise conv → LayerNorm → swish → pointwise: the
    conformer recipe. The GLU is ``a * sigmoid(b)`` with ``a`` the first
    half; the depthwise conv pads as Flax's ``SAME``, (k − 1) // 2 frames on
    the left and the rest on the right (so an even kernel pads one more on
    the right)."""

    def __init__(self, dim, kernel, dtype, device=None, generator=None):
        super().__init__()
        device, generator = _device(device), _generator(generator)
        self.dtype = dtype
        self.pointwise_in = _dense(dim, 2 * dim, device, generator)
        self.depthwise = nn.Conv1d(dim, dim, kernel, groups=dim, device=device,
                                   dtype=torch.float32)
        _fill_(self.depthwise.weight, kernel ** -0.5, generator)
        with torch.no_grad():
            self.depthwise.bias.zero_()
        self.norm = _layer_norm(dim, device)
        self.pointwise_out = _dense(dim, dim, device, generator)

    def forward(self, x):
        dt = self.dtype
        a, b = _linear(self.pointwise_in, x, dt).chunk(2, dim=-1)
        h = (a * torch.sigmoid(b)).transpose(1, 2)  # (B, C, T)
        k = self.depthwise.kernel_size[0]
        h = F.pad(h, ((k - 1) // 2, k - 1 - (k - 1) // 2))
        h = F.conv1d(h, self.depthwise.weight.to(dt), self.depthwise.bias.to(dt),
                     groups=self.depthwise.groups).transpose(1, 2)
        return _linear(self.pointwise_out, F.silu(_norm(self.norm, h, dt)), dt)


class MultiHeadAttention(nn.Module):
    """Flax's ``MultiHeadDotProductAttention`` over one sequence: q, k, v
    projections to ``heads`` × ``dim // heads``, q scaled by 1/√head_dim,
    the mask on keys only (True keeps), softmax and products in ``dtype``,
    and the output projection."""

    def __init__(self, dim, heads, dtype, device=None, generator=None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"encoder_dim {dim} is not a multiple of encoder_heads {heads}")
        device, generator = _device(device), _generator(generator)
        self.dtype, self.heads = dtype, heads
        self.query = _dense(dim, dim, device, generator)
        self.key = _dense(dim, dim, device, generator)
        self.value = _dense(dim, dim, device, generator)
        self.out = _dense(dim, dim, device, generator)

    def forward(self, x, mask):
        dt = self.dtype
        B, T, D = x.shape
        split = (B, T, self.heads, D // self.heads)
        q = _linear(self.query, x, dt).view(split) / math.sqrt(D // self.heads)
        k = _linear(self.key, x, dt).view(split)
        v = _linear(self.value, x, dt).view(split)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = w.masked_fill(~mask[:, None, None, :], torch.finfo(w.dtype).min)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(w, dim=-1), v)
        return _linear(self.out, o.reshape(B, T, D), dt)


class ConformerBlock(nn.Module):
    """Half-step FFN, self-attention, conv module, half-step FFN, each
    residual behind its LayerNorm, then a closing LayerNorm."""

    def __init__(self, dim, heads, kernel, dtype, device=None, generator=None):
        super().__init__()
        device, generator = _device(device), _generator(generator)
        self.dtype = dtype
        self.norm_ff1 = _layer_norm(dim, device)
        self.ff1 = FeedForward(dim, dtype, device, generator)
        self.norm_attn = _layer_norm(dim, device)
        self.attn = MultiHeadAttention(dim, heads, dtype, device, generator)
        self.norm_conv = _layer_norm(dim, device)
        self.conv = ConvModule(dim, kernel, dtype, device, generator)
        self.norm_ff2 = _layer_norm(dim, device)
        self.ff2 = FeedForward(dim, dtype, device, generator)
        self.norm_out = _layer_norm(dim, device)

    def forward(self, x, mask):
        dt = self.dtype
        x = x + 0.5 * self.ff1(_norm(self.norm_ff1, x, dt))
        x = x + self.attn(_norm(self.norm_attn, x, dt), mask)
        x = x + self.conv(_norm(self.norm_conv, x, dt))
        x = x + 0.5 * self.ff2(_norm(self.norm_ff2, x, dt))
        return _norm(self.norm_out, x, dt)


class Encoder(nn.Module):
    """feats (B, T, input_dim), lengths (B,) -> (B, T, encoder_dim), zero
    at the padded frames."""

    def __init__(self, cfg: TransducerConfig, device=None, generator=None):
        super().__init__()
        device, generator = _device(device), _generator(generator)
        self.cfg = cfg
        self.input_proj = _dense(cfg.input_dim, cfg.encoder_dim, device, generator)
        self.blocks = nn.ModuleList(
            ConformerBlock(cfg.encoder_dim, cfg.encoder_heads, cfg.conv_kernel, cfg.dtype, device,
                           generator) for _ in range(cfg.encoder_layers))

    def forward(self, feats, lengths):
        T = feats.shape[1]
        mask = torch.arange(T, device=feats.device)[None, :] < lengths.to(feats.device)[:, None]
        x = _linear(self.input_proj, feats, self.cfg.dtype).masked_fill(~mask[..., None], 0)
        for block in self.blocks:
            x = block(x, mask)
        return x.masked_fill(~mask[..., None], 0)


class LSTMCell(nn.Module):
    """Flax's ``OptimizedLSTMCell``: gates i, f, g, o from ``ih`` (the input
    side, no bias) and ``hh`` (the state side, with the bias), each product
    in ``dtype``; c' = f·c + i·g, h' = o·tanh(c'). The state is ``(c, h)``
    in f32, as Flax keeps it."""

    def __init__(self, n_in, hidden, dtype, device=None, generator=None):
        super().__init__()
        device, generator = _device(device), _generator(generator)
        self.dtype, self.hidden = dtype, hidden
        self.ih = _dense(n_in, 4 * hidden, device, generator, bias=False)
        self.hh = _dense(hidden, 4 * hidden, device, generator)

    def project(self, x):
        """The input side of the gates: x (..., n_in) -> (..., 4·hidden)."""
        return _linear(self.ih, x, self.dtype)

    def step(self, state, x_proj):
        """One step from the input side already projected (``project``)."""
        c, h = state
        i, f, g, o = (_linear(self.hh, h, self.dtype) + x_proj).chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        return (c, h), h

    def forward(self, state, x):
        return self.step(state, self.project(x))


class Prediction(nn.Module):
    """Embedding + unidirectional LSTM over the blank-prefixed labels:
    labels (B, L) -> (B, U, prediction_dim), U = L + 1. ``initial_state`` and
    ``step`` drive it one token at a time, for decoders."""

    def __init__(self, cfg: TransducerConfig, device=None, generator=None):
        super().__init__()
        device, generator = _device(device), _generator(generator)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.prediction_dim, device=device,
                                  dtype=torch.float32)
        _fill_(self.embed.weight, 1.0, generator)
        self.cell = LSTMCell(cfg.prediction_dim, cfg.prediction_dim, cfg.dtype, device, generator)

    def _embed(self, tokens):
        return self.embed(tokens.long()).to(self.cfg.dtype)

    def forward(self, labels):
        B = labels.shape[0]
        start = torch.full((B, 1), self.cfg.blank, dtype=labels.dtype, device=labels.device)
        x_proj = self.cell.project(self._embed(torch.cat((start, labels), dim=1)))
        state, outs = self.initial_state(B), []
        for u in range(x_proj.shape[1]):
            state, h = self.cell.step(state, x_proj[:, u])
            outs.append(h)
        return torch.stack(outs, dim=1)

    def initial_state(self, *batch_dims: int):
        """LSTM carry ``(c, h)`` for a decode loop; ``batch_dims`` may be
        (B,) or (B, K)."""
        dev = self.embed.weight.device
        zeros = torch.zeros((*batch_dims, self.cfg.prediction_dim), device=dev)
        return zeros, zeros.clone()

    def step(self, state, tokens):
        """One decode step: tokens (...,) -> (new_state, out (..., H))."""
        return self.cell(state, self._embed(tokens))


class Joint(nn.Module):
    """The joint network: ``enc_proj``, ``pred_proj``, tanh, ``out_proj``
    (and ``dur_proj`` with ``cfg.tdt_durations``).

    Its fused losses (``fused_loss``, ``multiblank_fused_loss``,
    ``tdt_fused_loss``) run the fused joint kernels on a CUDA tensor, at any
    ``cfg.joint_dim``; ``pruned_fused_loss`` runs its sweeps, and the plain
    versions (CPU tensors, ``implementation="torch"``) run everywhere.
    """

    def __init__(self, cfg: TransducerConfig, device=None, generator=None):
        super().__init__()
        device, generator = _device(device), _generator(generator)
        self.cfg = cfg
        self.enc_proj = _dense(cfg.encoder_dim, cfg.joint_dim, device, generator)
        self.pred_proj = _dense(cfg.prediction_dim, cfg.joint_dim, device, generator)
        self.out_proj = _dense(cfg.joint_dim, cfg.vocab_size, device, generator)
        if cfg.tdt_durations:
            self.dur_proj = _dense(cfg.joint_dim, len(cfg.tdt_durations), device, generator)

    def _linear(self, layer, x):
        return _linear(layer, x, self.cfg.dtype)

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


class Transducer(nn.Module):
    """Encoder + prediction network + joint, and the factorised heads
    ``am_head`` / ``lm_head`` of the simple loss."""

    def __init__(self, cfg: TransducerConfig, device=None, generator=None):
        super().__init__()
        device, generator = _device(device), _generator(generator)
        self.cfg = cfg
        self.encoder = Encoder(cfg, device, generator)
        self.prediction = Prediction(cfg, device, generator)
        self.joint = Joint(cfg, device, generator)
        self.am_head = _dense(cfg.encoder_dim, cfg.vocab_size, device, generator)
        self.lm_head = _dense(cfg.prediction_dim, cfg.vocab_size, device, generator)

    def forward(self, feats, feat_lengths, labels):
        """The dense logits (B, T, U, V) in ``cfg.dtype``."""
        return self.joint(self.encoder(feats, feat_lengths), self.prediction(labels))

    def encode(self, feats, feat_lengths):
        return self.encoder(feats, feat_lengths)

    # --- decode-facing single-step methods ------------------------------
    def predict_init(self, *batch_dims: int):
        return self.prediction.initial_state(*batch_dims)

    def predict_step(self, state, tokens):
        return self.prediction.step(state, tokens)

    def joint_step(self, enc_frame, pred_out):
        return self.joint.step(enc_frame, pred_out)

    def tdt_logits(self, feats, feat_lengths, labels):
        """(token_logits, duration_logits) for ``rnnt_loss_tdt``; needs
        ``cfg.tdt_durations``."""
        return self.joint.tdt(self.encoder(feats, feat_lengths), self.prediction(labels))

    def tdt_joint_step(self, enc_frame, pred_out):
        return self.joint.tdt_step(enc_frame, pred_out)

    def _heads(self, enc, pred):
        dt = self.cfg.dtype
        return _linear(self.am_head, enc, dt), _linear(self.lm_head, pred, dt)

    def factorised(self, feats, feat_lengths, labels):
        """(am (B, T, V), lm (B, U, V)) for ``rnnt_loss_simple`` / pruning."""
        return self._heads(self.encoder(feats, feat_lengths), self.prediction(labels))

    def factorised_full(self, feats, feat_lengths, labels):
        """(am, lm, enc, pred): the trunk's activations too, so that a pruned
        training step runs the encoder and prediction network once."""
        enc = self.encoder(feats, feat_lengths)
        pred = self.prediction(labels)
        return (*self._heads(enc, pred), enc, pred)

    def banded_joint_from(self, enc, pred_banded):
        """Joint on the trunk's activations on a pruned band."""
        return self.joint.banded(enc, pred_banded)

    def banded_joint(self, feats, feat_lengths, labels, ranges, s_range: int):
        """(B, T, S, V) joint logits on the pruned band."""
        enc = self.encoder(feats, feat_lengths)
        pred_band = gather_banded(self.prediction(labels), ranges, s_range)  # (B, T, S, H)
        return self.joint.banded(enc, pred_band)

    def fused_loss(self, feats, feat_lengths, labels, label_lengths, reduction="mean",
                   implementation="auto"):
        """End-to-end loss with the joint projection fused into the loss
        kernels: the dense training path for large vocabularies."""
        return self.joint.fused_loss(
            self.encoder(feats, feat_lengths), self.prediction(labels), labels, feat_lengths,
            label_lengths, reduction=reduction, implementation=implementation)

    def tdt_fused_loss(self, feats, feat_lengths, labels, label_lengths, reduction="mean",
                       sigma=0.0, fastemit_lambda=0.0, delay_penalty=0.0,
                       implementation="auto"):
        """End-to-end TDT loss with the joint projection fused in (needs
        ``cfg.tdt_durations``)."""
        return self.joint.tdt_fused_loss(
            self.encoder(feats, feat_lengths), self.prediction(labels), labels, feat_lengths,
            label_lengths, reduction=reduction, sigma=sigma, fastemit_lambda=fastemit_lambda,
            delay_penalty=delay_penalty, implementation=implementation)

    def pruned_fused_loss(self, enc, pred, ranges, labels, input_lengths, label_lengths,
                          s_range: int, reduction="mean", implementation="auto"):
        """Banded loss on the trunk's activations, the joint fused in."""
        return self.joint.pruned_fused_loss(enc, pred, ranges, labels, input_lengths,
                                            label_lengths, s_range, reduction=reduction,
                                            implementation=implementation)

    def multiblank_fused_loss(self, feats, feat_lengths, labels, label_lengths,
                              big_blank_durations, reduction="mean", sigma=0.0,
                              fastemit_lambda=0.0, delay_penalty=0.0, implementation="auto"):
        """End-to-end multi-blank loss with the joint projection fused in;
        the big blanks live on the last K vocabulary columns."""
        return self.joint.multiblank_fused_loss(
            self.encoder(feats, feat_lengths), self.prediction(labels), labels, feat_lengths,
            label_lengths, big_blank_durations, reduction=reduction, sigma=sigma,
            fastemit_lambda=fastemit_lambda, delay_penalty=delay_penalty,
            implementation=implementation)


# --- loss functions: batch = {"feats", "feat_lengths", "labels", "label_lengths"}


def loss_fn(model, batch, blank=0, implementation="auto"):
    """The dense RNN-T objective on f32 logits, mean over the batch."""
    acts = model(batch["feats"], batch["feat_lengths"], batch["labels"])
    return rnnt_loss(acts.float(), batch["labels"], batch["feat_lengths"], batch["label_lengths"],
                     blank=blank, reduction="mean", implementation=implementation)


def tdt_loss_fn(model, batch, blank=0, sigma=0.0, fastemit_lambda=0.0, delay_penalty=0.0,
                implementation="auto"):
    """Token-and-Duration Transducer objective (arXiv:2304.06795); needs
    ``cfg.tdt_durations``."""
    tok, dur = model.tdt_logits(batch["feats"], batch["feat_lengths"], batch["labels"])
    return rnnt_loss_tdt(tok.float(), dur.float(), batch["labels"], batch["feat_lengths"],
                         batch["label_lengths"], durations=model.cfg.tdt_durations, blank=blank,
                         sigma=sigma, reduction="mean", fastemit_lambda=fastemit_lambda,
                         delay_penalty=delay_penalty, implementation=implementation)


def multiblank_loss_fn(model, batch, big_blank_durations, blank=0, sigma=0.0,
                       fastemit_lambda=0.0, delay_penalty=0.0, implementation="auto"):
    """Multi-blank transducer objective (arXiv:2211.03541) on the dense
    joint: the K big blanks use the last K vocabulary columns, so labels
    must stay below V − K."""
    acts = model(batch["feats"], batch["feat_lengths"], batch["labels"])
    return rnnt_loss_multiblank(acts.float(), batch["labels"], batch["feat_lengths"],
                                batch["label_lengths"], big_blank_durations, blank=blank,
                                sigma=sigma, reduction="mean", fastemit_lambda=fastemit_lambda,
                                delay_penalty=delay_penalty, implementation=implementation)


def _simple_stage(model, batch, s_range, blank, implementation):
    """The trunk once, the simple loss and the band starts from its own
    lattice: (simple, ranges, enc, pred)."""
    am, lm, enc, pred = model.factorised_full(batch["feats"], batch["feat_lengths"],
                                              batch["labels"])
    simple, ranges = rnnt_loss_simple(am.float(), lm.float(), batch["labels"],
                                      batch["feat_lengths"], batch["label_lengths"], blank=blank,
                                      reduction="mean", implementation=implementation,
                                      prune_range=s_range)
    return simple, ranges, enc, pred


def pruned_loss_fn(model, batch, s_range, blank=0, simple_scale=0.5, implementation="auto"):
    """Two-stage pruned-transducer objective (arXiv:2206.13236):
    ``simple_scale · simple(am, lm) + pruned(joint on the band)``. The trunk
    runs once (``factorised_full``) and the band comes out of the lattice the
    simple loss computes (``prune_range=``)."""
    simple, ranges, enc, pred = _simple_stage(model, batch, s_range, blank, implementation)
    acts_band = model.banded_joint_from(enc, gather_banded(pred, ranges, s_range))
    pruned = rnnt_loss_pruned(acts_band.float(), ranges, batch["labels"], batch["feat_lengths"],
                              batch["label_lengths"], blank=blank, reduction="mean",
                              implementation=implementation)
    return simple_scale * simple + pruned


def pruned_fused_loss_fn(model, batch, s_range, blank=0, simple_scale=0.5,
                         implementation="auto"):
    """The two-stage pruned objective with the stage-2 joint fused into the
    band loss: neither (B, T, U, V) nor, above the threshold, (B, T, S, V)
    is formed."""
    simple, ranges, enc, pred = _simple_stage(model, batch, s_range, blank, implementation)
    pruned = model.pruned_fused_loss(enc, pred, ranges, batch["labels"], batch["feat_lengths"],
                                     batch["label_lengths"], s_range,
                                     implementation=implementation)
    return simple_scale * simple + pruned


# --- train steps: step(batch) -> the loss before the update ------------------


def _train_step(optimizer, loss):
    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        value = loss(batch)
        value.backward()
        optimizer.step()
        return value.detach()

    return step


def make_train_step(model, optimizer, blank=0, implementation="auto"):
    """The dense train step (``loss_fn``)."""
    return _train_step(optimizer, lambda batch: loss_fn(model, batch, blank=blank,
                                                        implementation=implementation))


def make_fused_train_step(model, optimizer, implementation="auto"):
    """The train step over the fused joint+loss: the (B, T, U, V) logits and
    their gradient are never formed (``Transducer.fused_loss``)."""
    return _train_step(optimizer, lambda batch: model.fused_loss(
        batch["feats"], batch["feat_lengths"], batch["labels"], batch["label_lengths"],
        implementation=implementation))


def make_tdt_train_step(model, optimizer, blank=0, sigma=0.0, fastemit_lambda=0.0,
                        delay_penalty=0.0, implementation="auto"):
    """The TDT train step (``tdt_loss_fn``; both heads)."""
    return _train_step(optimizer, lambda batch: tdt_loss_fn(
        model, batch, blank=blank, sigma=sigma, fastemit_lambda=fastemit_lambda,
        delay_penalty=delay_penalty, implementation=implementation))


def make_tdt_fused_train_step(model, optimizer, sigma=0.0, implementation="auto"):
    """The TDT train step over the fused joint+loss: the (B, T, U, V) token
    logits and the (B, T, U, H) joint features are never formed."""
    return _train_step(optimizer, lambda batch: model.tdt_fused_loss(
        batch["feats"], batch["feat_lengths"], batch["labels"], batch["label_lengths"],
        sigma=sigma, implementation=implementation))


def make_multiblank_train_step(model, optimizer, big_blank_durations, blank=0, sigma=0.0,
                               fastemit_lambda=0.0, delay_penalty=0.0, implementation="auto"):
    """The multi-blank train step (``multiblank_loss_fn``, dense joint)."""
    return _train_step(optimizer, lambda batch: multiblank_loss_fn(
        model, batch, big_blank_durations, blank=blank, sigma=sigma,
        fastemit_lambda=fastemit_lambda, delay_penalty=delay_penalty,
        implementation=implementation))


def make_multiblank_fused_train_step(model, optimizer, big_blank_durations, sigma=0.0,
                                     implementation="auto"):
    """The multi-blank train step over the fused joint+loss: the (B, T, U, V)
    logits are never formed."""
    return _train_step(optimizer, lambda batch: model.multiblank_fused_loss(
        batch["feats"], batch["feat_lengths"], batch["labels"], batch["label_lengths"],
        big_blank_durations, sigma=sigma, implementation=implementation))


def make_pruned_fused_train_step(model, optimizer, s_range, blank=0, simple_scale=0.5,
                                 implementation="auto"):
    """The train step over the pruned fused objective
    (``pruned_fused_loss_fn``)."""
    return _train_step(optimizer, lambda batch: pruned_fused_loss_fn(
        model, batch, s_range, blank=blank, simple_scale=simple_scale,
        implementation=implementation))


def make_pruned_train_step(model, optimizer, s_range, blank=0, simple_scale=0.5,
                           implementation="auto"):
    """The pruned-transducer train step (``pruned_loss_fn``): the joint runs
    only on a (B, T, S, V) band."""
    return _train_step(optimizer, lambda batch: pruned_loss_fn(
        model, batch, s_range, blank=blank, simple_scale=simple_scale,
        implementation=implementation))
