"""Carry weights of the JAX package's Flax modules into the port's modules.

So far the joint network only: ``joint_state_dict_from_flax`` turns the
parameter tree of the Flax ``Joint``, with or without its duration head,
into a ``state_dict`` of ``models.transducer.Joint``. The tree arrives as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)`` on the other side); this module
imports numpy and torch only.
"""
from __future__ import annotations

import numpy as np
import torch

# Flax's names for the joint's three Dense layers, in the order its setup()
# declares them, and the port's; and the duration head, which a tree has
# only when the model was built with ``tdt_durations``.
_JOINT_LAYERS = {"Dense_0": "enc_proj", "Dense_1": "pred_proj", "Dense_2": "out_proj"}
_DUR_HEAD = {"DurHead_0": "dur_proj"}


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
        if flax_name not in tree:
            continue
        leaves = tree[flax_name]
        if set(leaves) != {"kernel", "bias"}:
            raise KeyError(f"{flax_name} must hold 'kernel' and 'bias'; got {sorted(leaves)}")
        kernel = np.asarray(leaves["kernel"], dtype=np.float32)
        bias = np.asarray(leaves["bias"], dtype=np.float32)
        if kernel.ndim != 2 or bias.shape != (kernel.shape[1],):
            raise ValueError(f"{flax_name}: kernel {kernel.shape} and bias {bias.shape} "
                             "are not a Dense layer's (in, out) and (out,)")
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T))
        state[f"{name}.bias"] = torch.from_numpy(bias.copy())
    return state
