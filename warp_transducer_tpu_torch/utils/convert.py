"""Carry weights of the JAX package's Flax modules into the port's modules.

``joint_state_dict_from_flax`` turns the parameter tree of the Flax
``Joint``, with or without its duration head, into a ``state_dict`` of
``models.transducer.Joint``; ``transducer_state_dict_from_flax`` does the
same for a whole Flax ``Transducer`` (encoder, prediction network, joint and
the factorised heads) into ``models.transducer.Transducer``. A tree arrives
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` on the
other side); this module imports numpy and torch only. The maps are linear
(transposes and reshapes), so a tree of gradients converts the same way.
"""
from __future__ import annotations

import numpy as np
import torch

# Flax's names for the joint's three Dense layers, in the order its setup()
# declares them, and the port's; and the duration head, which a tree has
# only when the model was built with ``tdt_durations``.
_JOINT_LAYERS = {"Dense_0": "enc_proj", "Dense_1": "pred_proj", "Dense_2": "out_proj"}
_DUR_HEAD = {"DurHead_0": "dur_proj"}
# A whole Transducer's submodules (Joint_0 through joint_state_dict_from_flax).
_TRANSDUCER = ("Encoder_0", "Prediction_0", "Joint_0", "AmHead_0", "LmHead_0")
# A conformer block's LayerNorms, in the order its __call__ makes them, and
# its other parts.
_BLOCK_NORMS = {"LayerNorm_0": "norm_ff1", "LayerNorm_1": "norm_attn", "LayerNorm_2": "norm_conv",
                "LayerNorm_3": "norm_ff2", "LayerNorm_4": "norm_out"}
_BLOCK = _BLOCK_NORMS | {"FeedForward_0": "ff1", "FeedForward_1": "ff2", "ConvModule_0": "conv",
                         "MultiHeadDotProductAttention_0": "attn"}
_CONV = {"Dense_0": "pointwise_in", "Conv_0": "depthwise", "LayerNorm_0": "norm",
         "Dense_1": "pointwise_out"}
_FEED_FORWARD = {"Dense_0": "fc1", "Dense_1": "fc2"}
_ATTENTION = ("query", "key", "value", "out")
_GATES = "ifgo"  # OptimizedLSTMCell's gate order, as the port's LSTMCell splits them
_LSTM = {f"i{g}": ("kernel",) for g in _GATES} | {f"h{g}": ("kernel", "bias") for g in _GATES}


def _exactly(tree, names, where):
    """``tree``, after checking that its entries are ``names``: KeyError on
    one it does not know and on one it lacks."""
    unknown = sorted(set(tree) - set(names))
    if unknown:
        raise KeyError(f"unknown entries in {where}: {unknown}; known: {sorted(names)}")
    missing = sorted(set(names) - set(tree))
    if missing:
        raise KeyError(f"{where} lacks {missing}; it must hold {sorted(names)}")
    return tree


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _tensor(x):
    return torch.tensor(np.ascontiguousarray(x), dtype=torch.float32)


def _dense(leaves, where):
    """A Dense layer: (in, out) kernel → (out, in) weight, and its bias."""
    _exactly(leaves, ("kernel", "bias"), where)
    kernel, bias = _f32(leaves["kernel"]), _f32(leaves["bias"])
    if kernel.ndim != 2 or bias.shape != (kernel.shape[1],):
        raise ValueError(f"{where}: kernel {kernel.shape} and bias {bias.shape} "
                         "are not a Dense layer's (in, out) and (out,)")
    return {"weight": _tensor(kernel.T), "bias": _tensor(bias)}


def _norm(leaves, where):
    _exactly(leaves, ("scale", "bias"), where)
    return {"weight": _tensor(_f32(leaves["scale"])), "bias": _tensor(_f32(leaves["bias"]))}


def _attention(tree, where):
    """query/key/value kernels (in, heads, head_dim) → weight (heads·head_dim,
    in); out's (heads, head_dim, out) → (out, heads·head_dim)."""
    _exactly(tree, _ATTENTION, where)
    out = {}
    for name in _ATTENTION:
        leaves = _exactly(tree[name], ("kernel", "bias"), f"{where}/{name}")
        kernel, bias = _f32(leaves["kernel"]), _f32(leaves["bias"])
        if name == "out":
            out[name] = {"weight": _tensor(kernel.reshape(-1, kernel.shape[-1]).T),
                         "bias": _tensor(bias)}
        else:
            out[name] = {"weight": _tensor(kernel.reshape(kernel.shape[0], -1).T),
                         "bias": _tensor(bias.reshape(-1))}
    return out


def _depthwise(leaves, where):
    """A depthwise Conv: kernel (k, 1, C) → Conv1d weight (C, 1, k)."""
    _exactly(leaves, ("kernel", "bias"), where)
    kernel = _f32(leaves["kernel"])
    if kernel.ndim != 3 or kernel.shape[1] != 1:
        raise ValueError(f"{where}: kernel {kernel.shape} is not a depthwise conv's (k, 1, C)")
    return {"weight": _tensor(kernel.transpose(2, 1, 0)), "bias": _tensor(_f32(leaves["bias"]))}


def _encoder(tree, where):
    n_blocks = sum(k.startswith("ConformerBlock_") for k in tree)
    _exactly(tree, ["Dense_0"] + [f"ConformerBlock_{i}" for i in range(n_blocks)], where)
    out = {"input_proj": _dense(tree["Dense_0"], f"{where}/Dense_0")}
    for i in range(n_blocks):
        at = f"{where}/ConformerBlock_{i}"
        block = _exactly(tree[f"ConformerBlock_{i}"], _BLOCK, at)
        parts = {name: _norm(block[flax], f"{at}/{flax}") for flax, name in _BLOCK_NORMS.items()}
        for flax, name in (("FeedForward_0", "ff1"), ("FeedForward_1", "ff2")):
            ff = _exactly(block[flax], _FEED_FORWARD, f"{at}/{flax}")
            parts[name] = {n: _dense(ff[f], f"{at}/{flax}/{f}") for f, n in _FEED_FORWARD.items()}
        conv = _exactly(block["ConvModule_0"], _CONV, f"{at}/ConvModule_0")
        parts["conv"] = {
            "pointwise_in": _dense(conv["Dense_0"], f"{at}/ConvModule_0/Dense_0"),
            "depthwise": _depthwise(conv["Conv_0"], f"{at}/ConvModule_0/Conv_0"),
            "norm": _norm(conv["LayerNorm_0"], f"{at}/ConvModule_0/LayerNorm_0"),
            "pointwise_out": _dense(conv["Dense_1"], f"{at}/ConvModule_0/Dense_1")}
        parts["attn"] = _attention(block["MultiHeadDotProductAttention_0"],
                                   f"{at}/MultiHeadDotProductAttention_0")
        out[f"blocks.{i}"] = parts
    return out


def _prediction(tree, where):
    """The embedding, and OptimizedLSTMCell's eight gate layers as the
    port's ``cell.ih`` ([ii|if|ig|io], no bias) and ``cell.hh`` ([hi|hf|hg|ho]
    with its bias), kernels transposed."""
    _exactly(tree, ("Embed_0", "ScanOptimizedLSTMCell_0"), where)
    embed = _exactly(tree["Embed_0"], ("embedding",), f"{where}/Embed_0")
    cell_at = f"{where}/ScanOptimizedLSTMCell_0"
    cell = _exactly(tree["ScanOptimizedLSTMCell_0"], _LSTM, cell_at)
    for name, leaves in _LSTM.items():
        _exactly(cell[name], leaves, f"{cell_at}/{name}")

    def kernels(side):
        return np.concatenate([_f32(cell[f"{side}{g}"]["kernel"]) for g in _GATES], axis=1).T

    bias = np.concatenate([_f32(cell[f"h{g}"]["bias"]) for g in _GATES])
    return {"embed": {"weight": _tensor(_f32(embed["embedding"]))},
            "cell": {"ih": {"weight": _tensor(kernels("i"))},
                     "hh": {"weight": _tensor(kernels("h")), "bias": _tensor(bias)}}}


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def joint_state_dict_from_flax(params) -> dict:
    """The ``state_dict`` of the port's ``Joint`` from the Flax ``Joint``'s
    parameters: ``{"Dense_0": {"kernel": (in, out), "bias": (out,)}, ...}``,
    bare, under ``"params"``, or as ``params["Joint_0"]`` of a whole
    ``Transducer``. A Dense ``kernel`` is (in, out) and an ``nn.Linear``
    ``weight`` (out, in), so ``weight = kernel.T``. The duration head
    ``DurHead_0`` becomes ``dur_proj`` when the tree has it. Raises
    ``KeyError`` on a layer or leaf it does not know, so that no weight is
    dropped in silence."""
    tree = params.get("params", params)
    tree = tree.get("Joint_0", tree)
    known = _JOINT_LAYERS | _DUR_HEAD
    unknown = sorted(set(tree) - set(known))
    if unknown:
        raise KeyError(f"unknown entries in the Joint's parameters: {unknown}; "
                       f"known: {sorted(known)}")
    missing = sorted(set(_JOINT_LAYERS) - set(tree))
    if missing:
        raise KeyError(f"the Joint's parameters lack {missing}")
    state = {}
    for flax_name, name in known.items():
        if flax_name in tree:
            for leaf, value in _dense(tree[flax_name], flax_name).items():
                state[f"{name}.{leaf}"] = value
    return state


def transducer_state_dict_from_flax(params) -> dict:
    """The ``state_dict`` of the port's ``Transducer`` from a whole Flax
    ``Transducer``'s parameters (``init_params``' tree, bare or under
    ``"params"``): ``Encoder_0`` (``Dense_0`` and ``ConformerBlock_i``),
    ``Prediction_0``, ``Joint_0`` (``joint_state_dict_from_flax``),
    ``AmHead_0`` and ``LmHead_0``. Raises ``KeyError`` on any entry it does
    not know and on any it lacks, at every level; the number of blocks is
    the tree's, and ``load_state_dict`` holds it against the model's."""
    tree = _exactly(params.get("params", params), _TRANSDUCER, "the Transducer's parameters")
    nested = {"encoder": _encoder(tree["Encoder_0"], "Encoder_0"),
              "prediction": _prediction(tree["Prediction_0"], "Prediction_0"),
              "am_head": _dense(tree["AmHead_0"], "AmHead_0"),
              "lm_head": _dense(tree["LmHead_0"], "LmHead_0")}
    state = dict(_flatten(nested))
    state.update({f"joint.{k}": v for k, v in joint_state_dict_from_flax(tree["Joint_0"]).items()})
    return state
