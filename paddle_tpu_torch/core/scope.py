"""Scope: name -> tensor store (counterpart of
`paddle_tpu/core/scope.py`: `Scope` with its `get` / `set` /
`__contains__` / `keys` surface at :38-55, `global_scope` and
`scope_guard`).

The reference's Scope holds jax arrays; this one holds
`torch.Tensor`s, on the card or the CPU. The Executor reads the
persistable vars from the scope before a run and writes the ones the
run produced back after it. `scope_from_numpy` loads parameters kept as
numpy arrays (for example the reference's initialized scope, read with
``np.asarray(ref_scope.get(n))``) keeping each array's dtype;
`scope_to_numpy` is its inverse, which reads a scope (the port's or the
reference's) out as numpy arrays, so a test can start both packages
from one state and compare every persistable after training.

Left out: parent scopes (`new_scope`, `drop_kids`), `var` / `find_var`
handles, `delete`, `memory_stats` and `live_array_stats`.
"""
import contextlib

import numpy as np
import torch

from .dtypes import tensor_from_numpy, tensor_to_numpy

__all__ = ["Scope", "global_scope", "scope_guard", "scope_from_numpy",
           "scope_to_numpy"]


class Scope:
    def __init__(self):
        self._vars = {}

    def get(self, name, default=None):
        return self._vars.get(name, default)

    def set(self, name, value):
        self._vars[name] = value

    def __contains__(self, name):
        return name in self._vars

    def keys(self):
        return set(self._vars)


_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    prev, _global_scope = _global_scope, scope
    try:
        yield
    finally:
        _global_scope = prev


def scope_from_numpy(arrays, device, scope=None):
    """{name: numpy array} -> a Scope (a new one unless `scope` is
    given) holding each as a tensor on `device` in the array's own
    dtype (bfloat16 arrays included). Returns the scope."""
    scope = Scope() if scope is None else scope
    for name, a in arrays.items():
        scope.set(name, tensor_from_numpy(a, device))
    return scope


def scope_to_numpy(scope, names=None):
    """A scope (anything with `get` and `keys`) -> {name: numpy array}
    for `names` (default: every name it holds), each a copy on the
    host; a bf16 tensor becomes a float32 array (numpy has no
    bfloat16), every other dtype is kept."""
    out = {}
    for n in (sorted(scope.keys()) if names is None else names):
        v = scope.get(n)
        # a copy: the arrays never alias the scope's CPU tensors
        out[n] = np.array(tensor_to_numpy(v) if isinstance(v, torch.Tensor)
                          else v)
    return out
