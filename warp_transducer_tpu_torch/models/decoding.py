"""Greedy and beam-search RNN-T decoding for the ``Transducer`` model.

Counterpart of ``warp_transducer_tpu/models/decoding.py``. Each decoder
runs a fixed number of steps with masks (``T + max_symbols``, or ``T``
frames for ``beam_search_decode``), as the JAX package's ``lax.scan``s do:
no step reads a value back to the host, so a decode on the card runs with
no host sync. The model is reached only through its decode hooks
(``encode``, ``predict_init``, ``predict_step``, ``joint_step``,
``tdt_joint_step``), never through parameter names.

Every decoder runs under ``torch.no_grad()`` on the device of ``feats``.
Ties break as in the JAX package: ``torch.argmax`` returns the first
maximum, as ``jnp.argmax`` does, and every top-k is a stable sort, so among
equal scores the lower index comes first, as in ``jax.lax.top_k``. Beam
scores are f32 log-probabilities; a beam slot that holds no hypothesis
scores ``NEG``.

The reference library ships no decoding at all; this is beyond-reference
functionality.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.multiblank import _resolve_indices
from ..ops.prep import device_ints

NEG = -1.0e30


def _map(fn, *trees):
    """``fn`` over the leaves of equally shaped dicts / tuples of tensors
    (the LSTM carry is a tuple (c, h))."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple):
        return tuple(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _top_k(x, k):
    """(values, indices) of the k largest entries of the last axis, the
    lower index first among equal values (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _gather_k(tree, idx):
    """Select beams: ``idx`` (B, K') into axis 1 of every (B, K, ...) leaf."""
    def g(x):
        ix = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(*idx.shape, *x.shape[2:])
        return torch.gather(x, 1, ix)
    return _map(g, tree)


def _select(cond, a, b):
    """``torch.where`` with ``cond`` (B, ...) broadcast over every leaf's
    trailing axes."""
    return _map(lambda x, y: torch.where(cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim())),
                                         x, y), a, b)


def _frames(enc, t):
    """Encoder frames at ``t`` clamped into [0, T): t (B,) -> (B, H); t (B, K)
    -> (B, K, H)."""
    idx = t.clamp(0, enc.shape[1] - 1)
    flat = idx.reshape(idx.shape[0], -1, 1).expand(-1, -1, enc.shape[2])
    return torch.gather(enc, 1, flat).reshape(*idx.shape, enc.shape[2])


def _lengths(feats, feat_lengths):
    return feat_lengths.to(device=feats.device, dtype=torch.int32)


@torch.no_grad()
def greedy_decode(model, feats: torch.Tensor, feat_lengths: torch.Tensor, max_symbols: int,
                  blank: int = 0, big_blank_durations: Tuple[int, ...] = (),
                  big_blank_indices=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode a batch.

    At each step either emit the argmax label (advancing the prediction
    network) or consume the next encoder frame on blank; the loop runs a
    fixed ``T + max_symbols`` steps with masking.

    For a model trained with ``rnnt_loss_multiblank``, pass the same
    ``big_blank_durations`` (and ``big_blank_indices``, default: the last
    K vocabulary entries): a big-blank argmax consumes m_k frames in one
    step, the multi-blank decode speed-up (arXiv:2211.03541). Big blanks
    are never recorded as tokens.

    Returns (tokens, token_lengths): tokens is (B, max_symbols) int32
    padded with ``blank``, token_lengths (B,) int32.
    """
    B, T = feats.shape[0], feats.shape[1]
    dev = feats.device
    lengths = _lengths(feats, feat_lengths)
    enc = model.encode(feats, lengths)  # (B, T, H)
    state, pred = model.predict_step(model.predict_init(B),
                                     torch.full((B,), blank, dtype=torch.int32, device=dev))

    durs = tuple(int(m) for m in big_blank_durations)
    if durs:
        V = getattr(getattr(model, "cfg", None), "vocab_size", None)
        if V is None:  # the vocabulary from one joint evaluation
            V = model.joint_step(enc[:, 0, :], pred).shape[-1]
        durs, bb_idx = _resolve_indices(V, blank, durs, big_blank_indices)
    else:
        bb_idx = ()

    t = torch.zeros(B, dtype=torch.int32, device=dev)
    n_sym = torch.zeros(B, dtype=torch.int32, device=dev)
    tokens = torch.full((B, max_symbols), blank, dtype=torch.int32, device=dev)
    slots = torch.arange(max_symbols, device=dev)[None]
    for _ in range(T + max_symbols):
        logits = model.joint_step(_frames(enc, t), pred)
        best = torch.argmax(logits, dim=-1).to(torch.int32)
        active = (t < lengths) & (n_sym < max_symbols)
        adv = torch.ones_like(t)
        is_big = torch.zeros_like(active)
        for m, idx in zip(durs, bb_idx):
            hit = best == idx
            is_big = is_big | hit
            adv = torch.where(hit, m, adv)
        is_blank = (best == blank) | is_big | ~active
        # on emit: record the token, step the prediction network
        new_state, new_pred = model.predict_step(state, best)
        state = _select(is_blank, state, new_state)
        pred = torch.where(is_blank[:, None], pred, new_pred)
        tokens = torch.where(~is_blank[:, None] & (slots == n_sym[:, None]), best[:, None], tokens)
        n_sym = torch.where(is_blank, n_sym, n_sym + 1)
        t = torch.where(is_blank & active, t + adv, t)
    return tokens, n_sym


@torch.no_grad()
def greedy_decode_tdt(model, feats: torch.Tensor, feat_lengths: torch.Tensor, max_symbols: int,
                      blank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode for a Token-and-Duration Transducer model
    (``cfg.tdt_durations`` non-empty, trained with ``rnnt_loss_tdt``).

    At each step the duration head's argmax d decides how many frames the
    emission consumes: a token advances the prediction network and t by d
    (possibly 0), a blank advances t by max(d, 1), the frame-skipping
    decode speed-up of arXiv:2304.06795.

    Returns (tokens (B, max_symbols) int32 blank-padded, token_lengths).
    """
    B, T = feats.shape[0], feats.shape[1]
    dev = feats.device
    durs = device_ints(model.cfg.tdt_durations, dev, torch.int32)
    lengths = _lengths(feats, feat_lengths)
    enc = model.encode(feats, lengths)
    state, pred = model.predict_step(model.predict_init(B),
                                     torch.full((B,), blank, dtype=torch.int32, device=dev))
    t = torch.zeros(B, dtype=torch.int32, device=dev)
    n_sym = torch.zeros(B, dtype=torch.int32, device=dev)
    tokens = torch.full((B, max_symbols), blank, dtype=torch.int32, device=dev)
    slots = torch.arange(max_symbols, device=dev)[None]
    for _ in range(T + max_symbols):
        logits, dur_logits = model.tdt_joint_step(_frames(enc, t), pred)
        best = torch.argmax(logits, dim=-1).to(torch.int32)
        d = durs[torch.argmax(dur_logits, dim=-1)]
        active = (t < lengths) & (n_sym < max_symbols)
        is_blank = (best == blank) | ~active
        adv = torch.where(is_blank, d.clamp_min(1), d)
        new_state, new_pred = model.predict_step(state, best)
        state = _select(is_blank, state, new_state)
        pred = torch.where(is_blank[:, None], pred, new_pred)
        tokens = torch.where(~is_blank[:, None] & (slots == n_sym[:, None]), best[:, None], tokens)
        n_sym = torch.where(is_blank, n_sym, n_sym + 1)
        t = torch.where(active, t + adv, t)
    return tokens, n_sym


def _merge_duplicate_hyps(scores, tokens, n, extra_keys=()):
    """Pool the probability of duplicate hypotheses (equal token strings).

    Hypotheses with the same emitted token sequence are the same hypothesis
    reached along different lattice paths; their probabilities add. The
    prediction network's state is a function of the token string, so
    keeping the lowest-index (canonical) member's state is exact.

    scores (B, M), tokens (B, M, L) blank-padded, n (B, M) emission counts.
    ``extra_keys``: further (B, M) tensors that must also match for two
    hypotheses to be the same search state (the duration-arc searches pass
    the time pointer: the same tokens at another t are another lattice
    node and must not pool). Returns scores with each duplicate class's
    log-prob pooled onto its canonical member and every other member at
    NEG.
    """
    M = scores.shape[1]
    same = (n[:, :, None] == n[:, None, :]) & \
        (tokens[:, :, None, :] == tokens[:, None, :, :]).all(dim=-1)  # (B, M, M), diagonal true
    for k in extra_keys:
        same = same & (k[:, :, None] == k[:, None, :])
    first = torch.argmax(same.to(torch.int32), dim=-1)  # the lowest j equal to i
    is_canon = first == torch.arange(M, device=scores.device)[None, :]
    # log-sum-exp over each class (the finite NEG keeps it NaN-free)
    m = torch.where(same, scores[:, None, :], NEG).amax(dim=-1)
    pooled = m + torch.log(torch.where(same, torch.exp(scores[:, None, :] - m[..., None]),
                                       0.0).sum(dim=-1))
    return torch.where(is_canon, pooled, NEG)


def _init_beams(model, B, K, max_symbols, blank, dev):
    state, pred = model.predict_step(model.predict_init(B, K),
                                     torch.full((B, K), blank, dtype=torch.int32, device=dev))
    score = torch.full((B, K), NEG, device=dev)
    score[:, 0] = 0.0
    return {"score": score,
            "tokens": torch.full((B, K, max_symbols), blank, dtype=torch.int32, device=dev),
            "n": torch.zeros((B, K), dtype=torch.int32, device=dev),
            "state": state, "pred": pred}


def _fields(beams):
    return {k: v for k, v in beams.items() if k != "score"}


def _append_token(fields, token, max_symbols):
    """The tokens of ``fields`` with ``token`` (B, K) written at slot n."""
    slots = torch.arange(max_symbols, device=token.device)[None, None, :]
    return torch.where(slots == fields["n"][:, :, None], token[:, :, None], fields["tokens"])


def _sorted_best_first(scores, fields):
    """The beams in order of score, best first (a stable sort of -score,
    as ``jnp.argsort(-score)``)."""
    order = torch.argsort(-scores, dim=1, stable=True)
    final = _gather_k(fields, order)
    return final["tokens"], final["n"], torch.gather(scores, 1, order)


@torch.no_grad()
def beam_search_decode(model, feats: torch.Tensor, feat_lengths: torch.Tensor,
                       max_symbols: int, beam: int = 4, expansions: int = 3, blank: int = 0,
                       merge: bool = True) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Time-synchronous beam search with static shapes.

    Per frame, each of ``beam`` hypotheses may emit up to ``expansions``
    labels before consuming the frame with a blank; the K best blank-closed
    hypotheses survive to the next frame. With ``merge`` (default), closed
    hypotheses with identical token strings pool their probability
    (log-sum-exp) instead of taking duplicate beam slots.

    Returns (tokens (B, K, max_symbols), token_lengths (B, K),
    scores (B, K)), beams sorted best-first. ``beam=1`` with many
    ``expansions`` reduces to greedy decoding.
    """
    B, T = feats.shape[0], feats.shape[1]
    K, dev = beam, feats.device
    lengths = _lengths(feats, feat_lengths)
    enc = model.encode(feats, lengths)

    def joint_logp(e_frame, pred):
        """e_frame (B, H), pred (B, K, H) -> log-probs (B, K, V) in f32."""
        return torch.log_softmax(model.joint_step(e_frame, pred).float(), dim=-1)

    def close_pool(closed, open_b, blank_sc):
        """Merge blank-closed open hypotheses into the closed pool (2K -> K)."""
        pool_scores = torch.cat((closed["score"], blank_sc), dim=1)
        pool = _map(lambda c, o: torch.cat((c, o), dim=1), _fields(closed), _fields(open_b))
        if merge:
            pool_scores = _merge_duplicate_hyps(pool_scores, pool["tokens"], pool["n"])
        top_sc, top_ix = _top_k(pool_scores, K)
        return {"score": top_sc, **_gather_k(pool, top_ix)}

    beams = _init_beams(model, B, K, max_symbols, blank, dev)
    for t in range(T):
        e_frame = enc[:, t]
        # the closed pool: hypotheses that consumed this frame with a blank
        closed = {**beams, "score": torch.full((B, K), NEG, device=dev)}
        open_b = beams
        for _ in range(expansions):
            lp = joint_logp(e_frame, open_b["pred"])  # (B, K, V)
            closed = close_pool(closed, open_b, open_b["score"] + lp[:, :, blank])
            # expand with labels: top-K over the K·V non-blank continuations,
            # within the symbol budget
            lab_sc = open_b["score"][:, :, None] + lp
            lab_sc[:, :, blank] = NEG
            lab_sc = torch.where((open_b["n"] < max_symbols)[:, :, None], lab_sc, NEG)
            V = lab_sc.shape[-1]
            sc, ix = _top_k(lab_sc.reshape(B, K * V), K)
            parent, token = ix // V, (ix % V).to(torch.int32)
            sel = _gather_k(_fields(open_b), parent)
            new_state, new_pred = model.predict_step(sel["state"], token)
            open_b = {"score": sc, "tokens": _append_token(sel, token, max_symbols),
                      "n": sel["n"] + 1, "state": new_state, "pred": new_pred}
        # force-close the surviving open hypotheses with a final blank
        lp = joint_logp(e_frame, open_b["pred"])
        closed = close_pool(closed, open_b, open_b["score"] + lp[:, :, blank])
        # frames past an utterance's length pass its beams through untouched
        beams = _select(t < lengths, closed, beams)
    return _sorted_best_first(beams["score"], _fields(beams))


# ---------------------------------------------------------------------------
# Alignment-length-synchronous beam search (the duration-arc topologies)
# ---------------------------------------------------------------------------
#
# The frame-synchronous search above assumes every blank consumes exactly one
# frame, so all hypotheses in the beam share t. Multi-blank and TDT arcs
# advance t by variable amounts, so hypotheses fall out of step; the
# fixed-shape generalisation is alignment-length-synchronous decoding (ALSD,
# Saon et al. 2020): every live hypothesis takes exactly one arc a step and
# carries its own time pointer. A hypothesis finishes when a blank-family arc
# lands exactly on its utterance length. T + max_symbols steps bound the
# search (every arc advances t by >= 1 or emits a symbol).


def _alsd_search(model, enc, lengths, max_symbols, K, blank, merge, score_arcs):
    """The ALSD search both duration-arc decoders share.

    ``score_arcs(beams, e_frames, live) -> (blank_classes, tok_sc, token_of,
    dt_of)``:
      * blank_classes: [(scores (B, K), advance m)], the blank-family arcs
        advancing t by m, already NEG where invalid;
      * tok_sc (B, K, C): the token arcs' scores (masked); candidate c
        emits ``token_of[c]`` (C,) and advances t by ``dt_of[c]`` (C,).

    Two pools: the live beam of K unfinished hypotheses (each takes one
    arc a step) and a finished pool of the K best complete ones. They stay
    apart: a finished hypothesis carries its final score while partial ones
    still have log-prob factors to pay, so one pool would let soon-worse
    partial hypotheses evict complete results.
    """
    B, T = enc.shape[0], enc.shape[1]
    dev = enc.device
    len_b = lengths[:, None]
    beams = _init_beams(model, B, K, max_symbols, blank, dev)
    beams["t"] = torch.zeros((B, K), dtype=torch.int32, device=dev)
    fin = {"score": torch.full((B, K), NEG, device=dev),
           "tokens": torch.full((B, K, max_symbols), blank, dtype=torch.int32, device=dev),
           "n": torch.zeros((B, K), dtype=torch.int32, device=dev)}
    for _ in range(T + max_symbols):
        e_frames = _frames(enc, beams["t"])  # (B, K, H)
        live = (beams["score"] > NEG / 2) & (beams["t"] < len_b)
        blank_classes, tok_sc, token_of, dt_of = score_arcs(beams, e_frames, live)

        carried = _fields(beams)
        live_parts = []  # (score, fields) of the continuing hypotheses
        fin_scores, fin_tokens, fin_n = [fin["score"]], [fin["tokens"]], [fin["n"]]
        for sc, adv in blank_classes:
            t_new = beams["t"] + adv
            finished = t_new >= len_b  # valid arcs land at exactly the length
            live_parts.append((torch.where(finished, NEG, sc), {**carried, "t": t_new}))
            fin_scores.append(torch.where(finished, sc, NEG))
            fin_tokens.append(beams["tokens"])
            fin_n.append(beams["n"])

        # token expansions: top-K over all (beam, candidate) pairs
        C = tok_sc.shape[-1]
        tok_sc = torch.where((beams["n"] < max_symbols)[:, :, None], tok_sc, NEG)
        sc, ix = _top_k(tok_sc.reshape(B, K * C), K)
        parent, c = ix // C, ix % C
        token, dt = token_of[c], dt_of[c]
        sel = _gather_k(carried, parent)
        new_state, new_pred = model.predict_step(sel["state"], token)
        # token arcs land on a frame (t + dt < length), never finishing a path
        live_parts.append((sc, {"tokens": _append_token(sel, token, max_symbols),
                                "n": sel["n"] + 1, "t": sel["t"] + dt,
                                "state": new_state, "pred": new_pred}))

        pool_scores = torch.cat([p[0] for p in live_parts], dim=1)
        pool = _map(lambda *xs: torch.cat(xs, dim=1), *[p[1] for p in live_parts])
        if merge:
            pool_scores = _merge_duplicate_hyps(pool_scores, pool["tokens"], pool["n"],
                                                extra_keys=(pool["t"],))
        top_sc, top_ix = _top_k(pool_scores, K)
        beams = {"score": top_sc, **_gather_k(pool, top_ix)}

        # fold the newly finished hypotheses into the finished pool (complete
        # paths with the same token string are the same hypothesis: pool)
        f_sc = torch.cat(fin_scores, dim=1)
        f_tok, f_n = torch.cat(fin_tokens, dim=1), torch.cat(fin_n, dim=1)
        if merge:
            f_sc = _merge_duplicate_hyps(f_sc, f_tok, f_n)
        f_top, f_ix = _top_k(f_sc, K)
        fin = {"score": f_top, **_gather_k({"tokens": f_tok, "n": f_n}, f_ix)}
    return _sorted_best_first(fin["score"], _fields(fin))


@torch.no_grad()
def beam_search_decode_multiblank(model, feats: torch.Tensor, feat_lengths: torch.Tensor,
                                  max_symbols: int, beam: int = 4, blank: int = 0,
                                  big_blank_durations: Tuple[int, ...] = (),
                                  big_blank_indices=None, sigma: float = 0.0,
                                  merge: bool = True
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ALSD beam search for a multi-blank model (arXiv:2211.03541).

    The arcs are ``rnnt_loss_multiblank``'s: a token keeps t, the standard
    blank advances one frame, big blank k advances m_k, and a path finishes
    when a blank-family arc lands exactly on the utterance length.
    ``sigma`` applies the training's logit under-normalization (each arc's
    log-prob shifted by -sigma; with paths of several lengths this changes
    the ranking, unlike in greedy).

    Returns (tokens (B, K, max_symbols), token_lengths (B, K),
    scores (B, K)), beams sorted best-first; unfinished beams score NEG.
    """
    B = feats.shape[0]
    dev = feats.device
    lengths = _lengths(feats, feat_lengths)
    enc = model.encode(feats, lengths)
    V = getattr(getattr(model, "cfg", None), "vocab_size", None)
    if V is None:  # the vocabulary from one joint evaluation
        probe = model.predict_step(model.predict_init(B, 1),
                                   torch.full((B, 1), blank, dtype=torch.int32, device=dev))[1]
        V = model.joint_step(enc[:, 0], probe).shape[-1]
    durs, bb_idx = _resolve_indices(V, blank, tuple(big_blank_durations), big_blank_indices)
    len_b = lengths[:, None]
    token_of = torch.arange(V, dtype=torch.int32, device=dev)
    dt_of = torch.zeros(V, dtype=torch.int32, device=dev)

    def score_arcs(beams, e_frames, live):
        logits = model.joint_step(e_frames, beams["pred"])
        lp = torch.log_softmax(logits.float(), dim=-1) - sigma
        blank_classes = []
        for m, idx in ((1, blank),) + tuple(zip(durs, bb_idx)):
            ok = live & (beams["t"] + m <= len_b)
            blank_classes.append((torch.where(ok, beams["score"] + lp[:, :, idx], NEG), m))
        tok_sc = beams["score"][:, :, None] + lp
        for idx in (blank,) + tuple(bb_idx):
            tok_sc[:, :, idx] = NEG
        return blank_classes, torch.where(live[:, :, None], tok_sc, NEG), token_of, dt_of

    return _alsd_search(model, enc, lengths, max_symbols, beam, blank, merge, score_arcs)


@torch.no_grad()
def beam_search_decode_tdt(model, feats: torch.Tensor, feat_lengths: torch.Tensor,
                           max_symbols: int, beam: int = 4, blank: int = 0, sigma: float = 0.0,
                           merge: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ALSD beam search for a Token-and-Duration Transducer model
    (``cfg.tdt_durations`` non-empty; arXiv:2304.06795).

    The arcs are ``rnnt_loss_tdt``'s: every arc scores the token head's
    plus the duration head's log-probs; a token with duration d lands on
    frame t+d (so needs t+d < length; d may be 0), a blank needs d >= 1 and
    finishes the path when t+d == length. ``sigma`` under-normalizes the
    token head exactly as in training.

    Returns (tokens (B, K, max_symbols), token_lengths (B, K),
    scores (B, K)), beams sorted best-first; unfinished beams score NEG.
    """
    durs = tuple(int(d) for d in model.cfg.tdt_durations)
    D, dev = len(durs), feats.device
    dur_arr = device_ints(durs, dev, torch.int32)
    lengths = _lengths(feats, feat_lengths)
    enc = model.encode(feats, lengths)
    len_b = lengths[:, None]

    def score_arcs(beams, e_frames, live):
        logits, dur_logits = model.tdt_joint_step(e_frames, beams["pred"])
        lp = torch.log_softmax(logits.float(), dim=-1) - sigma
        lpd = torch.log_softmax(dur_logits.float(), dim=-1)
        blank_classes = []
        for j, d in enumerate(durs):
            if d < 1:
                continue  # blank arcs need d >= 1 (no self-loop)
            ok = live & (beams["t"] + d <= len_b)
            sc = beams["score"] + lp[:, :, blank] + lpd[:, :, j]
            blank_classes.append((torch.where(ok, sc, NEG), d))
        # token candidates: (v, d) pairs, flattened C = V·D
        V = lp.shape[-1]
        pair = lp[:, :, :, None] + lpd[:, :, None, :]  # (B, K, V, D)
        pair[:, :, blank, :] = NEG
        # token arcs must land on a frame: t + d < length
        ok_d = beams["t"][:, :, None] + dur_arr[None, None, :] < len_b[..., None]
        pair = torch.where(ok_d[:, :, None, :], pair, NEG)
        tok_sc = torch.where(live[:, :, None],
                             (beams["score"][:, :, None, None] + pair)
                             .reshape(*beams["score"].shape, V * D), NEG)
        token_of = torch.arange(V, dtype=torch.int32, device=dev).repeat_interleave(D)
        dt_of = dur_arr.repeat(V)
        return blank_classes, tok_sc, token_of, dt_of

    return _alsd_search(model, enc, lengths, max_symbols, beam, blank, merge, score_arcs)
