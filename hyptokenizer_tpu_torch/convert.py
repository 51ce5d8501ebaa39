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

:func:`bert_params_from_flax` and :func:`multimodal_params_from_flax` carry
the downstream models' Flax parameter trees (nested dicts with numpy
leaves) over as ``state_dict``s of the port's modules (``models/nlp.py``,
``models/multimodal.py``): a Flax ``Dense`` kernel is ``(in, out)`` and a
torch ``Linear`` weight ``(out, in)``, a Flax ``Conv`` kernel HWIO and a
torch one OIHW.
"""

from __future__ import annotations

import dataclasses
import re

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


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def bert_params_from_flax(params) -> dict:
    """The state_dict of ``models.nlp.BertForMaskedLM`` or
    ``BertForSequenceClassification`` from transformers' Flax BERT
    parameters (``model.params``; same module names). The MLM decoder is
    tied to the word embeddings, so it has no entry."""
    out = {}
    for path, v in _flatten(params):
        *mods, leaf = path
        if leaf == "kernel":
            leaf, v = "weight", v.T
        elif leaf in ("embedding", "scale"):
            leaf = "weight"
        out[".".join(mods + [leaf])] = torch.from_numpy(
            np.array(v, np.float32, order="C"))
    return out


_MULTIMODAL_NAMES = [
    (r"Embed_0\.embedding$", "embed.weight"),
    (r"Conv_0\.", "patch."),
    (r"TransformerBlock_(\d+)\.LayerNorm_0\.", r"blocks.\1.ln1."),
    (r"TransformerBlock_(\d+)\.LayerNorm_1\.", r"blocks.\1.ln2."),
    (r"TransformerBlock_(\d+)\.Dense_0\.", r"blocks.\1.fc1."),
    (r"TransformerBlock_(\d+)\.Dense_1\.", r"blocks.\1.fc2."),
    (r"TransformerBlock_(\d+)\.MultiHeadDotProductAttention_0\.",
     r"blocks.\1.attn."),
    (r"(_encoder)\.LayerNorm_0\.", r"\1.ln."),
    (r"(_projector)\.Dense_0\.", r"\1.fc1."),
    (r"(_projector)\.Dense_1\.", r"\1.fc2."),
    (r"\.scale$", ".weight"),
]


def multimodal_params_from_flax(params) -> dict:
    """The state_dict of a ``models.multimodal.MultimodalHyperbolicModel``
    with the built-in towers (``TransformerTower``, ``ViTTower``) from the
    JAX model's parameters (``variables["params"]``): the towers, the
    projectors, ``pos_emb`` and ``cls``. Attention kernels ``(in, heads,
    head_dim)`` and ``(heads, head_dim, out)`` become ``Linear`` weights."""
    out = {}
    for path, v in _flatten(params):
        name = ".".join(path)
        for pat, rep in _MULTIMODAL_NAMES:
            name = re.sub(pat, rep, name)
        if name.endswith(".kernel"):
            name = name[:-len("kernel")] + "weight"
            if v.ndim == 4:                       # conv HWIO -> OIHW
                v = v.transpose(3, 2, 0, 1)
            elif name.endswith("attn.out.weight"):
                v = v.reshape(-1, v.shape[-1]).T
            else:
                v = v.reshape(v.shape[0], -1).T
        elif name.endswith(".bias"):
            v = v.reshape(-1)
        out[name] = torch.from_numpy(np.array(v, np.float32, order="C"))
    return out
