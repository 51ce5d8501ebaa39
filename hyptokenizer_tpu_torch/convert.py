"""Carry training states between the JAX package and the port.

The JAX side is handed over as plain arrays: ``jax.tree.map(np.asarray,
st)`` turns its ``EnhancedState`` into the same structure with numpy
leaves, and :func:`enhanced_state_from_arrays` reads that structure (or a
nested dict of the same names) by attribute or key. The JAX state's PRNG
key has no field here; the loop's draws come from a sampler (see
``tokenizer/enhanced_state.py``).

:func:`enhanced_state_to_arrays` is the reverse, a nested dict of numpy
arrays with the JAX package's field names and dtypes (minus ``key``).
:func:`merge_state_from_arrays` and :func:`merge_state_to_arrays` do the
same for a bare ``MergeState``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hyptokenizer_tpu_torch import _device
from hyptokenizer_tpu_torch.tokenizer.enhanced_state import EnhancedState
from hyptokenizer_tpu_torch.tokenizer.state import MergeState


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def merge_state_from_arrays(src, device=None) -> MergeState:
    """A ``MergeState`` on ``device`` from the JAX package's as numpy
    arrays."""
    dev = _device.resolve(device)
    return MergeState(**{f.name: _tensor(_get(src, f.name), dev)
                         for f in dataclasses.fields(MergeState)})


def merge_state_to_arrays(st: MergeState) -> dict:
    """{field: array} of numpy arrays."""
    return {f.name: getattr(st, f.name).cpu().numpy()
            for f in dataclasses.fields(MergeState)}


def enhanced_state_from_arrays(src, device=None) -> EnhancedState:
    """An ``EnhancedState`` on ``device`` from the JAX package's state as
    numpy arrays."""
    dev = _device.resolve(device)
    return EnhancedState(
        base=merge_state_from_arrays(_get(src, "base"), dev),
        **{f.name: _tensor(_get(src, f.name), dev)
           for f in dataclasses.fields(EnhancedState) if f.name != "base"})


def enhanced_state_to_arrays(st: EnhancedState) -> dict:
    """{"base": {...}, field: array, ...} of numpy arrays."""
    out = {f.name: getattr(st, f.name).cpu().numpy()
           for f in dataclasses.fields(EnhancedState) if f.name != "base"}
    out["base"] = merge_state_to_arrays(st.base)
    return out
