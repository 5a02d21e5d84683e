"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages run on the CPU from one set of parameters: the flax module is
initialised for its shapes, every leaf is then moved by numpy-seeded noise
(so norm scales and biases are not their trivial defaults), and the same
numbers reach the torch module through ``kokoro_tpu_torch.convert``.
Inputs are made with numpy and handed to both as arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from kokoro_tpu_torch.convert import kokoro_state_dict_from_flax

# the parity tests run small tensors; one intra-op thread per test worker
# keeps parallel workers from oversubscribing the cores
torch.set_num_threads(1)


def perturbed_params(variables, seed: int, scale: float = 0.05):
    """``(flax variables, flat numpy params)`` with every leaf moved by
    ``scale * N(0, 1)`` noise drawn from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    flat = flatten_dict(variables["params"], sep="/")
    out = {}
    for k in sorted(flat):
        v = np.asarray(flat[k], np.float32)
        out[k] = (v + scale * rng.standard_normal(v.shape)).astype(np.float32)
    return variables_from_flat(out), out


def variables_from_flat(flat):
    """flax variables from flat ``/``-joined numpy params."""
    return {"params": unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}


def load_torch(module: torch.nn.Module, flat, prefix: str = "") -> torch.nn.Module:
    """Load flat flax params (optionally only those under ``prefix/``) into a
    torch module, strictly, and put it in eval mode."""
    if prefix:
        flat = {k[len(prefix) + 1:]: v for k, v in flat.items() if k.startswith(prefix + "/")}
    module.load_state_dict(kokoro_state_dict_from_flax(flat), strict=True)
    return module.eval()


def t(x, dtype=None):
    """numpy -> torch CPU tensor."""
    out = torch.from_numpy(np.array(x, copy=True))
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """torch or jax -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _jit_call(fn, first, args, kwargs):
    """``fn(first, *args, **kwargs)`` under ``jax.jit``: array leaves of
    ``args``/``kwargs`` (dicts and lists of arrays too) are traced, the rest
    (ints, bools, None) stay static."""
    def is_array(x):
        return isinstance(x, (np.ndarray, jax.Array))

    def traced(x):
        leaves = jax.tree_util.tree_leaves(x)
        return bool(leaves) and all(is_array(leaf) for leaf in leaves)

    pos = [a for a in args if traced(a)]
    kw = {k: v for k, v in kwargs.items() if traced(v)}

    def call(first, pos_arrays, kw_arrays):
        it = iter(pos_arrays)
        full = [next(it) if traced(a) else a for a in args]
        return fn(first, *full, **{**kwargs, **kw_arrays})

    return jax.jit(call)(first, pos, kw)


def init_flax(module, *args, seed: int = 0, **kwargs):
    """``module.init`` under ``jax.jit``."""
    return _jit_call(module.init, jax.random.PRNGKey(seed), args, kwargs)


def apply_flax(module, variables, *args, **kwargs):
    """``module.apply`` under ``jax.jit`` (one compiled program instead of
    one dispatch per operation); ``method=`` stays static."""
    return _jit_call(module.apply, variables, args, kwargs)
