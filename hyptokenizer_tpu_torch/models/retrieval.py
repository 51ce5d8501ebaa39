"""Image-text retrieval training with the hyperbolic two-tower model, in
PyTorch.

Port of ``hyptokenizer_tpu/models/retrieval.py``: AdamW epochs over
caption/image pairs with the hyperbolic contrastive loss, best-state
tracking on R@1 and a Recall@{1,5,10} evaluation (one distance matmul).
Data is any iterable of (image_array, caption_ids, caption_mask) as numpy;
``synthetic_batches`` (the JAX package's numpy generator, verbatim) gives a
correlated toy task.

Optimizer ``torch.optim.AdamW(lr, weight_decay=1e-4, eps=1e-8)``, which is
``optax.adamw(lr)``; the weights are initialized by
``multimodal.init_params`` from a ``torch.Generator`` seeded with ``seed``.
The best state is a detached copy of the ``state_dict`` taken when R@1
improves (the JAX package keeps an immutable parameter tree; a torch
``state_dict`` would alias the live weights).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hyptokenizer_tpu_torch import _device
from hyptokenizer_tpu_torch.models import multimodal
from hyptokenizer_tpu_torch.models.losses import (
    hyperbolic_contrastive_loss, recall_at_k,
)
from hyptokenizer_tpu_torch.models.nlp import ADAM_EPS, WEIGHT_DECAY


def synthetic_batches(n_batches: int, batch_size: int, image_size: int,
                      seq_len: int, vocab_size: int, seed: int = 0):
    """Correlated image/caption pairs: caption ids drive image patterns, so a
    working model can actually learn alignment."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        ids = rng.integers(4, vocab_size, (batch_size, seq_len)).astype(np.int32)
        mask = np.ones((batch_size, seq_len), np.int32)
        # Images: low-frequency pattern keyed on the first two caption ids.
        xx, yy = np.meshgrid(np.linspace(0, 1, image_size),
                             np.linspace(0, 1, image_size))
        images = np.zeros((batch_size, image_size, image_size, 3), np.float32)
        for b in range(batch_size):
            f1 = 1 + (ids[b, 0] % 5)
            f2 = 1 + (ids[b, 1] % 5)
            images[b, :, :, 0] = np.sin(2 * np.pi * f1 * xx)
            images[b, :, :, 1] = np.cos(2 * np.pi * f2 * yy)
            images[b, :, :, 2] = 0.1 * rng.standard_normal((image_size,
                                                            image_size))
        yield images, ids, mask


def snapshot(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A detached copy of the model's ``state_dict``."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _batch(dev, images, ids, mask):
    return (torch.as_tensor(np.asarray(ids), dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray(images), dtype=torch.float32,
                            device=dev),
            torch.as_tensor(np.asarray(mask), dtype=torch.int64, device=dev))


def train_retrieval(model, batches_fn, *, epochs: int = 1, lr: float = 1e-4,
                    temperature: float = 0.07, seed: int = 0,
                    eval_batch: Optional[Tuple] = None, log=print,
                    device=None) -> Dict:
    """AdamW training on ``device`` with best-R@1 tracking. Returns
    ``{"params": live state_dict, "best": {"r1", "params"}, "history"}``;
    the model is trained in place."""
    dev = _device.resolve(device)
    model.to(dev)
    multimodal.init_params(model, torch.Generator().manual_seed(int(seed)))
    opt = torch.optim.AdamW(model.parameters(), lr=lr,
                            weight_decay=WEIGHT_DECAY, eps=ADAM_EPS)
    best = {"r1": -1.0, "params": snapshot(model)}
    history = []
    for epoch in range(epochs):
        losses = []
        for images, ids, mask in batches_fn():
            zt, zi = model(*_batch(dev, images, ids, mask))
            loss = hyperbolic_contrastive_loss(zt, zi, temperature)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        mean_loss = float(torch.stack(losses).double().mean()) if losses \
            else float("nan")
        metrics = {}
        if eval_batch is not None:
            with torch.no_grad():
                zt, zi = model(*_batch(dev, *eval_batch))
            metrics = {k: float(v) for k, v in recall_at_k(zt, zi).items()}
            r1 = metrics["text_to_image_r@1"]
            if r1 > best["r1"]:
                best = {"r1": r1, "params": snapshot(model)}
        history.append({"epoch": epoch, "loss": mean_loss, **metrics})
        log(f"epoch {epoch}: loss {mean_loss:.4f} "
            + " ".join(f"{k}={v:.3f}" for k, v in metrics.items()))
    return {"params": model.state_dict(), "best": best, "history": history}
