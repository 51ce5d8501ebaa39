"""Resumable mid-training checkpoints, in PyTorch.

Port of ``hyptokenizer_tpu/utils/checkpoint.py`` with ``torch.save`` and
``torch.load(weights_only=True)`` in place of orbax. A checkpoint
directory holds:

- ``device_state.pt``: every tensor of the merge state (``MergeState``, or
  ``EnhancedState`` with its ``base``), moved to the CPU, and the state of
  each sampler the tokenizer draws from: the enhanced loop's
  ``tokenizer.sampler`` (coherence and curvature draws; the port's
  ``EnhancedState`` has no PRNG key) and ``tokenizer.stats_sampler`` (the
  distance statistics, which the distance-only startup controller reads);
- ``host_state.json``: the JAX package's keys (vocabulary, merge history,
  training stats, curvature, threshold, ``corpus_len`` so that a corpus
  shrunk by ``corpus_shrink`` restores, ...) and the host-side state of the
  startup threshold controller (``threshold_adjusted``, ``startup_stats``),
  which lives outside the device state.

So a resumed run draws the same numbers and makes the same merges,
embeddings, curvature and threshold as one never interrupted.

A sampler takes part through ``get_state()`` / ``set_state(tensor)``
(``state.StatsSampler`` gives its generator's state).

Compatibility: a JAX orbax checkpoint does not restore into the port, and
the port's does not restore into the JAX package (different containers,
and the port keeps sampler states where JAX keeps a key). The artifacts
that ``save`` writes stay compatible both ways.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

STATE_FILE = "device_state.pt"
HOST_FILE = "host_state.json"


def _flatten(state, prefix: str = "") -> dict:
    out = {}
    for f in dataclasses.fields(state):
        val = getattr(state, f.name)
        if dataclasses.is_dataclass(val):
            out.update(_flatten(val, prefix + f.name + "."))
        else:
            out[prefix + f.name] = val.detach().cpu()
    return out


def _unflatten(template, tensors: dict, device, prefix: str = ""):
    kw = {}
    for f in dataclasses.fields(template):
        val = getattr(template, f.name)
        if dataclasses.is_dataclass(val):
            kw[f.name] = _unflatten(val, tensors, device,
                                    prefix + f.name + ".")
            continue
        name = prefix + f.name
        if name not in tensors:
            raise ValueError(f"checkpoint lacks state field {name}")
        saved = tensors[name]
        if saved.dtype != val.dtype or (name != "corpus"
                                        and saved.shape != val.shape):
            raise ValueError(
                f"checkpoint field {name} is {saved.dtype}{tuple(saved.shape)}"
                f", this tokenizer's is {val.dtype}{tuple(val.shape)}: "
                "construct it with the configuration it was saved with")
        kw[f.name] = saved.to(device)
    return dataclasses.replace(template, **kw)


def _samplers(tokenizer) -> dict:
    found = {"stats": tokenizer.stats_sampler}
    if hasattr(tokenizer, "enh_state"):
        found["loop"] = tokenizer.sampler
    return found


def save_checkpoint(path: str, tokenizer) -> None:
    """Checkpoint a (base or enhanced) tokenizer mid-training."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    enhanced = hasattr(tokenizer, "enh_state")
    state = tokenizer.enh_state if enhanced else tokenizer.state
    torch.save({"state": _flatten(state),
                "samplers": {k: s.get_state()
                             for k, s in _samplers(tokenizer).items()}},
               os.path.join(path, STATE_FILE))
    host = {
        "kind": type(tokenizer).__name__,
        "vocab": tokenizer.vocab,
        "merge_history": [list(m) for m in tokenizer.merge_history],
        "training_stats": tokenizer.training_stats,
        "curvature": float(tokenizer.state.curvature),
        "merge_threshold": float(tokenizer.state.threshold),
        "max_vocab_size": tokenizer.max_vocab_size,
        "step": int(tokenizer.state.step),
        "enhanced": enhanced,
        "current_phase": getattr(tokenizer, "current_phase", None),
        "corpus_len": (int(tokenizer.enh_state.corpus.shape[0])
                       if enhanced else None),
        "threshold_adjusted": bool(getattr(tokenizer, "_threshold_adjusted",
                                           False)),
        "startup_stats": tokenizer.startup_stats,
    }
    with open(os.path.join(path, HOST_FILE), "w") as f:
        json.dump(host, f)


def restore_checkpoint(path: str, tokenizer) -> None:
    """Restore device+host state into a compatibly-constructed tokenizer.

    The tokenizer must be constructed with the same static configuration
    (max_vocab_size, dims, feature flags, table and queue sizes) as at save
    time; tensors, sampler states and host strings are then replaced
    wholesale, on the tokenizer's device.
    """
    path = os.path.abspath(path)
    with open(os.path.join(path, HOST_FILE)) as f:
        host = json.load(f)
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    enhanced = hasattr(tokenizer, "enh_state")
    if host["enhanced"] and not enhanced:
        raise ValueError("checkpoint is enhanced; construct an "
                         "EnhancedHyperbolicTokenizer to restore it")
    template = tokenizer.enh_state if host["enhanced"] else tokenizer.state
    saved_len = host.get("corpus_len")
    if saved_len is not None and saved_len > template.corpus.shape[0]:
        raise ValueError(
            f"checkpoint corpus ({saved_len}) larger than this tokenizer's "
            f"buffer ({template.corpus.shape[0]}); construct with a larger "
            "corpus_max_tokens")
    restored = _unflatten(template, saved["state"], tokenizer.device)
    if host["enhanced"]:
        tokenizer.enh_state = restored
        tokenizer.state = restored.base
        tokenizer.current_phase = host.get("current_phase") or 1
    else:
        tokenizer.state = restored
    for name, sampler in _samplers(tokenizer).items():
        if name in saved["samplers"]:
            sampler.set_state(saved["samplers"][name])
    tokenizer.vocab = list(host["vocab"])
    tokenizer.merge_history = [tuple(m) for m in host["merge_history"]]
    tokenizer.training_stats = list(host["training_stats"])
    tokenizer.curvature = float(host["curvature"])
    tokenizer.merge_threshold = float(host["merge_threshold"])
    tokenizer._threshold_adjusted = bool(host.get("threshold_adjusted"))
    tokenizer.startup_stats = host.get("startup_stats")
    tokenizer._encoder = None
