"""Numerical debugging (port of utils/debugging.py).

``debug_mode`` is the counterpart of ``jax_debug_nans``: inside it, the
first operator whose output holds a NaN raises ``FloatingPointError``, in
the forward as in the backward (autograd mode alone checks only the
backward). It checks every operator's floating outputs under a
``TorchDispatchMode``, one device sync an operator: a debugging tool, not
a training mode. The port's hand-written kernels are not operators; a NaN
they write is caught at the first operator that reads it.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode


# operators whose output is memory not yet written, which may hold anything
_UNINITIALIZED = {torch.ops.aten.empty, torch.ops.aten.empty_like,
                  torch.ops.aten.empty_strided, torch.ops.aten.empty_permuted,
                  torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided,
                  torch.ops.aten.resize_}


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _UNINITIALIZED:
            return out
        for t in _pytree.tree_leaves(out):
            if (torch.is_tensor(t) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Scoped numerical debugging: raises at the operator that produced a
    NaN. The mode is popped on exit, whatever happened inside."""
    if not nans:
        yield
        return
    with _NanCheck():
        yield
