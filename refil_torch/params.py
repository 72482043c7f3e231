"""Carries weights between the JAX package's parameter trees and the port's
modules.

A flax tree, as nested dicts of numpy arrays
(``flax.serialization.to_state_dict`` then ``np.asarray``), names each
submodule as the port's modules name their attributes (``fc1``, ``attn``,
``hyper_w_1``, ...). Layouts:

  * a flax ``TorchLinear`` kernel is (fan_in, fan_out); the port's
    ``TorchLinear.weight`` is (out, in), as in ``nn.Linear``: transposed;
  * the attention and pooling layers keep the JAX layout (``in_trans``
    (D, 3E), ``out_kernel`` (E, O), ``out_bias`` (O,)): copied as they are;
  * so do the GRU's six projection children (``gru.ir`` ... ``gru.hn``:
    ``kernel`` (fan_in, H), ``bias`` (H,) where the flax cell has one);
  * ``QMixer``'s layers are attributes under the flax names (``hyper_w_1``
    or ``hyper_w_1_0``/``hyper_w_1_1``, ``hyper_b_1``, ``V_0``, ``V_1``, ...);
    its ``state_masks`` is a buffer, not a parameter, as it is a module
    attribute in flax.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .modules.layers import TorchLinear


def _unwrap(tree: Dict[str, Any]) -> Dict[str, Any]:
    return tree["params"] if set(tree) == {"params"} else tree


def load_flax_params(module: nn.Module, tree: Dict[str, Any]) -> None:
    """Copies a flax parameter tree into ``module`` in place. Every leaf of
    the tree must land on a parameter and every parameter must be set."""
    tree = _unwrap(tree)
    seen = set()

    def visit(mod: nn.Module, node: Dict[str, Any], prefix: str) -> None:
        for name, value in node.items():
            path = f"{prefix}{name}"
            if isinstance(value, dict):
                child = getattr(mod, name, None)
                if not isinstance(child, nn.Module):
                    raise KeyError(f"flax subtree {path} has no module in {type(mod).__name__}")
                visit(child, value, path + ".")
                continue
            arr = torch.as_tensor(np.asarray(value))
            if isinstance(mod, TorchLinear):
                pname = {"kernel": "weight", "bias": "bias"}[name]
                if pname == "weight":
                    arr = arr.T
            else:
                pname = name
            param = getattr(mod, pname, None)
            if not isinstance(param, nn.Parameter):
                raise KeyError(f"flax leaf {path} has no parameter in {type(mod).__name__}")
            if tuple(param.shape) != tuple(arr.shape):
                raise ValueError(f"{path}: shape {tuple(arr.shape)} != {tuple(param.shape)}")
            with torch.no_grad():
                param.copy_(arr.to(param.dtype))
            seen.add(id(param))

    visit(module, tree, "")
    missing = [n for n, p in module.named_parameters() if id(p) not in seen]
    if missing:
        raise KeyError(f"parameters not set from the flax tree: {missing}")


def to_flax_params(module: nn.Module, grads: bool = False) -> Dict[str, Any]:
    """The module's parameters (or, with ``grads``, their gradients) as a
    flax-layout tree of numpy arrays: the inverse of ``load_flax_params``,
    without the ``params`` wrapper."""
    tree: Dict[str, Any] = {}
    for name, param in module.named_parameters():
        *path, leaf = name.split(".")
        owner = module.get_submodule(".".join(path)) if path else module
        arr = (param.grad if grads else param).detach().float().cpu().numpy()
        if isinstance(owner, TorchLinear):
            leaf = {"weight": "kernel", "bias": "bias"}[leaf]
            if leaf == "kernel":
                arr = arr.T
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree
