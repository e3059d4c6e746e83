"""RNN-T loss fused into the joint network: the (B, T, U, V) tensor never exists.

``rnnt_loss_fused_joint(e, p, W, bias, labels, ...)`` computes the same
value as

    acts = tanh(e[:, :, None, :] + p[:, None, :, :]) @ W + bias
    rnnt_loss(acts, labels, ...)

but the joint logits live only tile-wise: the forward reduces them straight
to the (B, T, U) lattice inputs, the backward recomputes each tile and
contracts the dense gradient into (de, dp, dW, db) on the spot. The lattice
recursion runs on the (B, T, U) arrays exactly as in ``rnnt_loss``, and the
coefficient fields of the gradient are ``gradients.coefficients``.
Counterpart of ``warp_transducer_tpu/ops/fused_joint.py``.

The two stages here, ``fused_prep`` and ``fused_grad``, are the plain
PyTorch versions: a T-chunked loop of ``tanh`` / ``matmul`` / row
reductions that keeps O(B·Tc·U·(V + 2H)) alive at once. On a CUDA tensor the
same stages are the kernels ``csrc/joint_prep.cu`` and ``csrc/joint_grad.cu``
(``ops/cuda/joint.py``), which cover all of V in one launch: the port has no
V-chunked variants.

Both stages take the two hooks of the duration-arc losses
(``ops/multiblank_fused.py``, ``ops/tdt_fused.py``): K extra vocabulary
columns (the big blanks: their log-probs out of the prep, K more
coefficient fields into the gradient) and a duration head (Wd (H, D),
bias_d: a second, tiny projection of the same joint features). The duration
head always takes the unrounded f32 h and f32 Wd, also when ``W`` is bf16.
``dur_head_prep`` and ``dur_head_grad`` are the duration head alone, the
plain versions of ``csrc/dur_head.cu``.

Types, as the JAX package: the products take bf16 inputs when ``W`` is
bf16 (h, and g after its subtractions, are rounded to bf16) and f32 inputs
otherwise; e, p, bias and every reduction are f32, the products accumulate
in f32, and de, dp, dW, db come back in the types of e, p, W, bias. f32
products are full f32: PyTorch's default keeps TF32 off for ``matmul``
(``torch.backends.cuda.matmul.allow_tf32`` is False), and nothing here
turns it on.
"""
from __future__ import annotations

import torch

from . import gradients as _gradients
from . import prep as _prep
from .prep import NEG

# Working-set budget of one T chunk of the plain versions.
_T_CHUNK_MB = 256


def _t_chunk(B, T, U, H, V):
    per_t = B * U * (V + 2 * H) * 4
    return max(1, min(T, (_T_CHUNK_MB << 20) // max(per_t, 1)))


def lab_full(labels: torch.Tensor, U: int) -> torch.Tensor:
    """(B, U) int32: labels[u] for u < U-1, else -1 (no emit defined)."""
    lab = _prep._pad_labels(labels.to(torch.int32), U)
    return torch.nn.functional.pad(lab, (0, 1), value=-1).contiguous()


def _mm_dtype(W):
    return torch.bfloat16 if W.dtype == torch.bfloat16 else torch.float32


def _rounded(x, mm):
    """x rounded to the product's input type, held in f32. A product of two
    bf16 values is exact in f32, so an f32 matmul of rounded inputs is the
    bf16 product with f32 accumulation, up to the order of its sum."""
    return x if mm == torch.float32 else x.to(mm).float()


def _chunk_logits(e_c, p32, W32, bias32, mm):
    """One T chunk: h (B, Tc, U, H), h as the products take it, and the
    logits (B, Tc, U, V), all f32."""
    h = torch.tanh(e_c.float()[:, :, None, :] + p32[:, None, :, :])
    hm = _rounded(h, mm)
    return h, hm, torch.matmul(hm, W32) + bias32


def _label_index(lab, V):
    """(has, idx): whether each row has a label inside [0, V), and the label
    as a gather index along V (0 where there is none)."""
    lab = lab.long()
    has = (lab >= 0) & (lab < V)
    return has, torch.where(has, lab, 0)[..., None]


def _row_fields(logits, has, idx, blank):
    """denom, lpb, lpe of the rows of one chunk of logits (..., V): the
    two-pass logsumexp, the blank column, the label column by a gather (NEG
    where the row has no label). ``has`` and ``idx`` broadcast to the rows."""
    m = logits.amax(dim=-1)
    d = -(m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1)))
    le = torch.gather(logits, -1, idx.expand(logits.shape[:-1] + (1,)))[..., 0]
    return d, logits[..., blank] + d, torch.where(has, le + d, NEG)


def _row_grads(logits, denom, coef, cb, ce, has, idx, blank, cols=(), cX=None):
    """g = coef·exp(logits + denom) − cb·[v = blank] − ce·[v = label]
    − Σ_k cX[..., k]·[v = cols[k]] of one chunk, in f32 (every subtraction
    whose column matches applies: a label equal to the blank takes both)."""
    g = coef[..., None] * torch.exp(logits + denom[..., None])
    g[..., blank] -= cb
    g.scatter_add_(-1, idx.expand(g.shape[:-1] + (1,)), -torch.where(has, ce, 0.0)[..., None])
    for k, col in enumerate(cols):
        g[..., col] -= cX[..., k]
    return g


def _contract(g, h, hm, W32, mm, Wd32=None, g_dur=None):
    """One chunk's g against its h: d = (g·Wᵀ)·(1 − h²) per row, and the
    chunk's share of dW = hᵀ·g and db = Σ g. g is rounded to the products'
    input type after its subtractions; db sums it unrounded. With a duration
    head, g_dur·Wdᵀ joins g·Wᵀ before the (1 − h²), and the chunk's share of
    dWd = hᵀ·g_dur comes back too (else None), both with the unrounded h."""
    gm = _rounded(g, mm)
    dh = torch.matmul(gm, W32.t())
    H, V = W32.shape
    dWd = None
    if Wd32 is not None:
        dh = dh + torch.matmul(g_dur, Wd32.t())
        dWd = torch.matmul(h.reshape(-1, H).t(), g_dur.reshape(-1, Wd32.shape[1]))
    d = dh * (1.0 - h * h)
    return d, torch.matmul(hm.reshape(-1, H).t(), gm.reshape(-1, V)), g.sum(dim=(0, 1, 2)), dWd


def _check_dur_head(Wd, other, H, what):
    """(Wd, other) of a duration head as f32: Wd (H, D) with 1 <= D <=
    ``MAX_EXTRA_COLS``."""
    if Wd.dim() != 2 or Wd.shape[0] != H or not 1 <= Wd.shape[1] <= _prep.MAX_EXTRA_COLS:
        raise ValueError(f"Wd must be (H={H}, D) with 1 <= D <= {_prep.MAX_EXTRA_COLS}; got "
                         f"{tuple(Wd.shape)}")
    if other.shape[-1] != Wd.shape[1]:
        raise ValueError(f"{what} has {other.shape[-1]} columns for D = {Wd.shape[1]}")
    return Wd.float(), other.float()


def fused_prep(e, p, W, bias, labels, input_lengths, label_lengths, blank: int,
               extra_cols=(), dur_head=None) -> _prep.PreparedInputs:
    """Plain version of ``csrc/joint_prep.cu``: lpb, lpe and denom, (B, T, U)
    f32, of the joint logits tanh(e ⊕ p) @ W + bias, which live one T chunk
    at a time. Cells outside (t < T_b) & (u < U_b) hold NEG (lpb, lpe) and 0
    (denom); lpe is NEG where the row has no label (u = U-1, or a label
    outside [0, V)).

    ``extra_cols``: K static vocabulary columns; ``extras`` (B, T, U, K) then
    holds logits[col_k] + denom (NEG outside the lattice). ``dur_head``:
    (Wd (H, D), bias_d (D,)); ``dur`` (B, T, U, D) then holds the raw duration
    logits h·Wd + bias_d of the unrounded f32 h (0 outside the lattice)."""
    B, T, H = e.shape
    U, V = p.shape[1], W.shape[1]
    cols = list(_prep.check_extra_cols(extra_cols, V))
    mm = _mm_dtype(W)
    Tc = _t_chunk(B, T, U, H, V)
    p32, W32, bias32 = p.float(), W.float(), bias.float()
    has, idx = _label_index(lab_full(labels, U)[:, None, :], V)
    lpb = torch.empty((B, T, U), dtype=torch.float32, device=e.device)
    lpe, denom = torch.empty_like(lpb), torch.empty_like(lpb)
    lpX = lpb.new_empty((B, T, U, len(cols))) if cols else None
    dlog = None
    if dur_head is not None:
        Wd32, bias_d32 = _check_dur_head(dur_head[0], dur_head[1], H, "bias_d")
        dlog = lpb.new_empty((B, T, U, Wd32.shape[1]))
    for t0 in range(0, T, Tc):
        sl = slice(t0, t0 + Tc)
        h, _, logits = _chunk_logits(e[:, sl], p32, W32, bias32, mm)
        denom[:, sl], lpb[:, sl], lpe[:, sl] = _row_fields(logits, has, idx, blank)
        if cols:
            lpX[:, sl] = logits[..., cols] + denom[:, sl, :, None]
        if dlog is not None:
            dlog[:, sl] = torch.matmul(h, Wd32) + bias_d32
    valid = _gradients._valid_cells((B, T, U), input_lengths, label_lengths, e.device)
    return _prep.PreparedInputs(
        lpb=torch.where(valid, lpb, NEG), lpe=torch.where(valid, lpe, NEG),
        denom=torch.where(valid, denom, 0.0),
        extras=None if lpX is None else torch.where(valid[..., None], lpX, NEG),
        dur=None if dlog is None else torch.where(valid[..., None], dlog, 0.0))


def fused_grad(e, p, W, bias, labels, input_lengths, label_lengths, denom,
               fields: _gradients.Coefficients, blank: int, extra=None, dur_head=None):
    """Plain version of ``csrc/joint_grad.cu``: (de, dp, dW, db) in the
    types of (e, p, W, bias) from the (B, T, U) coefficient fields, which
    are zero outside each utterance's lattice. Each T chunk's logits are
    recomputed, g is formed in f32 (the subtractions before any rounding to
    bf16) and contracted at once. The lengths are not read: the zero fields
    mask (the kernel reads them to skip the rows).

    ``extra``: (cols, cX (B, T, U, K)) — K more fields subtracted at static
    columns. ``dur_head``: (Wd (H, D), g_dur (B, T, U, D)) — the duration
    head's cotangent, zero outside the lattice, joins dh before the
    (1 − h²); dWd = hᵀ·g_dur (f32, the unrounded h) is appended to the
    result."""
    B, T, H = e.shape
    U, V = p.shape[1], W.shape[1]
    mm = _mm_dtype(W)
    Tc = _t_chunk(B, T, U, H, V)
    p32, W32, bias32 = p.float(), W.float(), bias.float()
    has, idx = _label_index(lab_full(labels, U)[:, None, :], V)
    cols, cX = (), None
    if extra is not None:
        cols, cX = _prep.check_extra_cols(extra[0], V), extra[1].float()
        if cX.shape != (B, T, U, len(cols)):
            raise ValueError(f"the extra fields must be {(B, T, U, len(cols))}; got "
                             f"{tuple(cX.shape)}")
    Wd32 = g_dur = dWd = None
    if dur_head is not None:
        Wd32, g_dur = _check_dur_head(dur_head[0], dur_head[1], H, "g_dur")
        dWd = torch.zeros_like(Wd32)
    de = torch.empty((B, T, H), dtype=torch.float32, device=e.device)
    dp = torch.zeros((B, U, H), dtype=torch.float32, device=e.device)
    dW = torch.zeros((H, V), dtype=torch.float32, device=e.device)
    db = torch.zeros((V,), dtype=torch.float32, device=e.device)
    for t0 in range(0, T, Tc):
        sl = slice(t0, t0 + Tc)
        h, hm, logits = _chunk_logits(e[:, sl], p32, W32, bias32, mm)
        g = _row_grads(logits, denom[:, sl], fields.coef[:, sl], fields.cb[:, sl],
                       fields.ce[:, sl], has, idx, blank, cols,
                       None if cX is None else cX[:, sl])
        d, dW_c, db_c, dWd_c = _contract(g, h, hm, W32, mm, Wd32,
                                         None if g_dur is None else g_dur[:, sl])
        de[:, sl] = d.sum(dim=2)
        dp += d.sum(dim=1)
        dW += dW_c
        db += db_c
        if dWd is not None:
            dWd += dWd_c
    out = (de.to(e.dtype), dp.to(p.dtype), dW.to(W.dtype), db.to(bias.dtype))
    return out if dWd is None else out + (dWd.to(dur_head[0].dtype),)


def _dur_chunks(e, p):
    """(Tc, p32) of the duration head alone: a T chunk's working set is the
    (B, Tc, U, 2H) of h and dh."""
    B, T, H = e.shape
    return _t_chunk(B, T, p.shape[1], H, 0), p.float()


def dur_head_prep(e, p, Wd, bias_d, input_lengths=None, label_lengths=None):
    """Plain version of ``csrc/dur_head.cu``'s prep: the duration head alone,
    dlog (B, T, U, D) f32 = tanh(e ⊕ p)·Wd + bias_d with the unrounded f32 h.
    With the lengths, cells outside (t < T_b) & (u < U_b) hold 0."""
    B, T, H = e.shape
    U = p.shape[1]
    Wd32, bias_d32 = _check_dur_head(Wd, bias_d, H, "bias_d")
    Tc, p32 = _dur_chunks(e, p)
    dlog = torch.empty((B, T, U, Wd32.shape[1]), dtype=torch.float32, device=e.device)
    for t0 in range(0, T, Tc):
        sl = slice(t0, t0 + Tc)
        h = torch.tanh(e[:, sl].float()[:, :, None, :] + p32[:, None, :, :])
        dlog[:, sl] = torch.matmul(h, Wd32) + bias_d32
    if input_lengths is None:
        return dlog
    valid = _gradients._valid_cells((B, T, U), input_lengths, label_lengths, e.device)
    return torch.where(valid[..., None], dlog, 0.0)


def dur_head_grad(e, p, Wd, g_dur, input_lengths=None, label_lengths=None):
    """Plain version of ``csrc/dur_head.cu``'s gradient: the duration head's
    shares (de2, dp2, dWd) of the gradients to e, p and Wd from its cotangent
    g_dur (B, T, U, D), which is zero outside each utterance's lattice. They
    add to the token head's: dh enters the (1 − h²) linearly. The lengths
    are not read (the kernel reads them to skip the rows)."""
    B, T, H = e.shape
    U = p.shape[1]
    Wd32, g32 = _check_dur_head(Wd, g_dur, H, "g_dur")
    Tc, p32 = _dur_chunks(e, p)
    de = torch.empty((B, T, H), dtype=torch.float32, device=e.device)
    dp = torch.zeros((B, U, H), dtype=torch.float32, device=e.device)
    dWd = torch.zeros_like(Wd32)
    for t0 in range(0, T, Tc):
        sl = slice(t0, t0 + Tc)
        h = torch.tanh(e[:, sl].float()[:, :, None, :] + p32[:, None, :, :])
        d = torch.matmul(g32[:, sl], Wd32.t()) * (1.0 - h * h)
        de[:, sl] = d.sum(dim=2)
        dp += d.sum(dim=1)
        dWd += torch.matmul(h.reshape(-1, H).t(), g32[:, sl].reshape(-1, Wd32.shape[1]))
    return de.to(e.dtype), dp.to(p.dtype), dWd.to(Wd.dtype)


class _FusedCosts(torch.autograd.Function):
    """(B,) costs; the backward forms the coefficient fields with the
    upstream cotangent folded in and runs the fused gradient."""

    @staticmethod
    def forward(ctx, e, p, W, bias, labels, input_lengths, label_lengths, blank, eng,
                fastemit_lambda, delay_penalty):
        prepped = eng.fused_prep(e, p, W, bias, labels, input_lengths, label_lengths, blank)
        lpe = prepped.lpe
        if delay_penalty:
            lpe = _prep.delay_shift(lpe, input_lengths, delay_penalty)
        needs_grad = any(ctx.needs_input_grad[:4])
        res = eng.forward_backward(prepped.lpb, lpe, input_lengths, label_lengths,
                                   compute_betas=needs_grad)
        if needs_grad:
            ctx.save_for_backward(e, p, W, bias, labels, input_lengths, label_lengths,
                                  prepped.denom, prepped.lpb, lpe, res.alphas, res.betas,
                                  res.ll_forward)
            ctx.config = (eng, blank, fastemit_lambda)
        return (-res.ll_forward).to(e.dtype)

    @staticmethod
    def backward(ctx, g):
        (e, p, W, bias, labels, input_lengths, label_lengths, denom, lpb, lpe, alphas, betas,
         ll) = ctx.saved_tensors
        eng, blank, fastemit_lambda = ctx.config
        fields = _gradients.coefficients(lpb, lpe, alphas, betas, ll, input_lengths,
                                         label_lengths, g.float(), fastemit_lambda)
        grads = eng.fused_grad(e, p, W, bias, labels, input_lengths, label_lengths, denom,
                               fields, blank)
        return tuple(grads) + (None,) * 7


def _check_joint_inputs(e, p, W, bias, labels):
    """The shape checks shared with ``rnnt_loss_pruned_fused``."""
    if e.dim() != 3 or p.dim() != 3 or W.dim() != 2 or bias.dim() != 1:
        raise ValueError(
            f"expected e (B,T,H), p (B,U,H), W (H,V), bias (V,); got "
            f"{tuple(e.shape)}, {tuple(p.shape)}, {tuple(W.shape)}, {tuple(bias.shape)}")
    if e.shape[2] != p.shape[2] or e.shape[2] != W.shape[0] or W.shape[1] != bias.shape[0]:
        raise ValueError(
            f"hidden/vocab dims disagree: e {tuple(e.shape)}, p {tuple(p.shape)}, "
            f"W {tuple(W.shape)}, bias {tuple(bias.shape)}")
    if e.shape[0] != p.shape[0]:
        raise ValueError(f"batch dims disagree: e {tuple(e.shape)} vs p {tuple(p.shape)}")
    U = p.shape[1]
    if labels.dim() != 2 or labels.shape[0] != e.shape[0] or labels.shape[1] < U - 1:
        raise ValueError(f"labels must be (B, >={U - 1}) for U={U}; got {tuple(labels.shape)}")


def rnnt_loss_fused_joint(e, p, W, bias, labels, input_lengths, label_lengths,
                          blank: int = 0, reduction: str = "mean",
                          implementation: str = "auto", fastemit_lambda: float = 0.0,
                          delay_penalty: float = 0.0):
    """RNN-T loss with the joint projection fused in.

    Args:
      e: (B, T, H) projected encoder activations (after ``enc_proj``).
      p: (B, U, H) projected prediction activations (after ``pred_proj``).
      W: (H, V) output-projection weight (f32 or bf16); bias: (V,).
      labels, input_lengths, label_lengths, blank, reduction: as in
        ``rnnt_loss``.
      implementation: 'auto' | 'torch' | 'cuda' (``rnnt_loss``): the fused
        kernels and the lattice kernel, or their plain versions.
      fastemit_lambda: FastEmit λ (arXiv:2010.11148); changes the gradient
        only.
      delay_penalty: delay-penalized transducer λ (arXiv:2211.00490);
        changes the objective.

    Equals ``rnnt_loss(tanh(e ⊕ p) @ W + bias, ...)`` without ever holding
    the (B, T, U, V) logits or their gradient in device memory.
    Differentiable w.r.t. e, p, W and bias.
    """
    # ops/rnnt.py lists this module's stages in its engines and so imports
    # it; the engines are read here, when a loss is called.
    from . import rnnt as _rnnt

    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"reduction must be none|sum|mean, got {reduction!r}")
    _check_joint_inputs(e, p, W, bias, labels)
    if fastemit_lambda < 0:
        raise ValueError(f"fastemit_lambda must be >= 0, got {fastemit_lambda}")
    if delay_penalty < 0:
        raise ValueError(f"delay_penalty must be >= 0, got {delay_penalty}")
    eng = _rnnt._engine(implementation, e)
    labels, input_lengths, label_lengths = _rnnt._on_device(e, labels, input_lengths,
                                                            label_lengths)
    costs = _FusedCosts.apply(e, p, W, bias, labels, input_lengths, label_lengths, int(blank),
                              eng, float(fastemit_lambda), float(delay_penalty))
    return _rnnt._reduce(costs, reduction)
