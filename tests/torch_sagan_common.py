"""The SAGAN parity tests' configuration and helpers
(tests/test_torch_sagan.py, tests/test_torch_sagan_step.py).
"""

import numpy as np
import torch

import jax


GAMMA = {"attn1": 0.5, "attn2": -0.3}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _set_gammas(variables):
    for name, g in GAMMA.items():
        variables["params"][name]["gamma"] = np.float32(g)
    return variables
