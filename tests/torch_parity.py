"""Helpers shared by the ``test_torch_*`` parity tests: moving parameter trees
and batches between the JAX package and the PyTorch port."""
from __future__ import annotations

import flax
import jax
import numpy as np
import torch


def flax_tree_to_numpy(tree):
    """A flax parameter tree as nested dicts of numpy arrays."""
    state = flax.serialization.to_state_dict(tree)
    return jax.tree.map(lambda x: np.array(x), state)


def unwrap(tree):
    return tree["params"] if set(tree) == {"params"} else tree


def assert_trees_close(got, ref, atol, rtol=0.0, path=""):
    assert set(got) == set(ref), (path, sorted(got), sorted(ref))
    for k in ref:
        if isinstance(ref[k], dict):
            assert_trees_close(got[k], ref[k], atol, rtol, f"{path}/{k}")
        else:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]), atol=atol,
                                       rtol=rtol, err_msg=f"{path}/{k}")


def batch_to_torch(batch, device="cpu"):
    """A JAX episode batch as torch tensors: actions become int64 for gather."""
    out = {}
    for k, v in batch.items():
        arr = np.array(v)
        t = torch.as_tensor(arr, device=device)
        if k == "actions":
            t = t.long()
        out[k] = t
    return out
