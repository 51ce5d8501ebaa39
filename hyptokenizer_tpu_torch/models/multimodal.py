"""Two-tower multimodal model with hyperbolic projection heads, in PyTorch.

Port of ``hyptokenizer_tpu/models/multimodal.py``: text and image encoders
feed two-layer MLP projectors into ``projection_dim + 1`` coordinates,
re-projected onto the hyperboloid by recomputing the time coordinate. The
linen modules become ``torch.nn`` modules with Flax's numerics:

- ``nn.LayerNorm`` eps ``1e-6``; ``nn.gelu``'s default tanh approximation;
- ``nn.MultiHeadDotProductAttention``: query, key, value and output
  projections with bias, the query scaled by ``1/sqrt(head_dim)``, a
  masked key's weight replaced by ``finfo(float32).min``;
- :class:`ViTTower` takes NHWC images as the JAX tower does (permuted to
  NCHW for ``nn.Conv2d``), with the convolution's ``SAME`` padding;
- :class:`TransformerTower` mean-pools over the mask when one is given,
  else takes the first token.

The torch modules need their input widths at construction, which Flax
infers at ``init``: each tower has ``out_dim``, and the adapters take it
(or read ``config.hidden_size``). :func:`init_params` draws Flax's default
initializers from a ``torch.Generator``; ``convert.multimodal_params_from_flax``
carries a Flax tree over.

The HF adapters wrap any torch module that returns ``pooler_output`` or
``last_hidden_state`` (e.g. transformers' ``BertModel``/``ViTModel``); the
wrapped module runs in eval mode always (Flax's ``deterministic=True``), and
:func:`graft_pretrained_params` loads a ``state_dict`` into it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hyptokenizer_tpu_torch.ops import lorentz as L

LN_EPS = 1e-6   # flax nn.LayerNorm


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class MLPProjector(nn.Module):
    """in -> hidden -> projection_dim+1."""

    def __init__(self, in_dim: int, hidden_dim: int, projection_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, projection_dim + 1)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class MultiHeadAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention`` with ``inputs_k = inputs_v``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        if dim % heads:
            raise ValueError("dim must be a multiple of heads")
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        b, n, dim = x.shape
        hd = dim // self.heads

        def split(t):
            return t.view(b, n, self.heads, hd).transpose(1, 2)

        q = split(self.query(x)) / math.sqrt(hd)
        w = torch.matmul(q, split(self.key(x)).transpose(-1, -2))
        if mask is not None:
            w = torch.where(mask, w, torch.finfo(w.dtype).min)
        ctx = torch.matmul(torch.softmax(w, dim=-1), split(self.value(x)))
        return self.out(ctx.transpose(1, 2).reshape(b, n, dim))


class TransformerBlock(nn.Module):
    """Pre-LN block: attention and an MLP of ``mlp_ratio * dim``."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadAttention(dim, heads)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.fc2 = nn.Linear(dim * mlp_ratio, dim)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln1(x), mask)
        return x + self.fc2(_gelu(self.fc1(self.ln2(x))))


class TransformerTower(nn.Module):
    """From-scratch text encoder: embeddings + blocks + pooling."""

    def __init__(self, vocab_size: int, dim: int = 256, depth: int = 4,
                 heads: int = 4, max_len: int = 128):
        super().__init__()
        self.out_dim = dim
        self.embed = nn.Embedding(vocab_size, dim)
        self.pos_emb = nn.Parameter(torch.zeros(max_len, dim))
        self.blocks = nn.ModuleList(
            [TransformerBlock(dim, heads) for _ in range(depth)])
        self.ln = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, ids, attention_mask=None):
        x = self.embed(ids) + self.pos_emb[None, :ids.shape[1]]
        attn_mask = None
        if attention_mask is not None:
            attn_mask = attention_mask[:, None, None, :].to(torch.bool)
        for block in self.blocks:
            x = block(x, attn_mask)
        x = self.ln(x)
        if attention_mask is not None:
            m = attention_mask[..., None].to(x.dtype)
            return torch.sum(x * m, dim=1) / torch.clamp_min(
                torch.sum(m, dim=1), 1)
        return x[:, 0]


class ViTTower(nn.Module):
    """From-scratch image encoder on NHWC images: patch embedding + CLS
    token + blocks."""

    def __init__(self, image_size: int = 64, patch_size: int = 8,
                 dim: int = 256, depth: int = 4, heads: int = 4):
        super().__init__()
        self.out_dim = dim
        self.patch_size = patch_size
        self.patch = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        side = -(-image_size // patch_size)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_emb = nn.Parameter(torch.zeros(side * side + 1, dim))
        self.blocks = nn.ModuleList(
            [TransformerBlock(dim, heads) for _ in range(depth)])
        self.ln = nn.LayerNorm(dim, eps=LN_EPS)

    def _same_pad(self, x):
        """Flax's ``SAME`` padding for stride = kernel (none when the side
        divides)."""
        p = self.patch_size
        pads = []
        for side in (x.shape[3], x.shape[2]):
            total = max((-(-side // p) - 1) * p + p - side, 0)
            pads += [total // 2, total - total // 2]
        return F.pad(x, pads) if any(pads) else x

    def forward(self, images):
        b = images.shape[0]
        x = self.patch(self._same_pad(images.permute(0, 3, 1, 2)))
        x = x.permute(0, 2, 3, 1).reshape(b, -1, x.shape[1])
        x = torch.cat([self.cls.expand(b, 1, x.shape[2]), x], dim=1)
        x = x + self.pos_emb[None]
        for block in self.blocks:
            x = block(x)
        return self.ln(x)[:, 0]


def _pooled(out):
    pooled = getattr(out, "pooler_output", None)
    if pooled is None:
        pooled = out.last_hidden_state[:, 0]
    return pooled


class _HFTower(nn.Module):
    def __init__(self, hf_module: nn.Module, out_dim: Optional[int] = None):
        super().__init__()
        self.hf_module = hf_module.eval()
        self.out_dim = (out_dim if out_dim is not None
                        else hf_module.config.hidden_size)

    def train(self, mode: bool = True):
        super().train(mode)
        self.hf_module.eval()   # deterministic, as the Flax adapters call it
        return self


class HFTextTower(_HFTower):
    """Adapter: a HuggingFace torch text model (e.g. ``BertModel(cfg)``) as
    the text tower; its ``pooler_output``, else its first token."""

    def forward(self, ids, attention_mask=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(ids)
        return _pooled(self.hf_module(input_ids=ids,
                                      attention_mask=attention_mask))


class HFImageTower(_HFTower):
    """Adapter: a HuggingFace torch vision model (e.g. ``ViTModel``) as the
    image tower. Torch HF vision models take NCHW pixel values; NHWC input,
    the layout of :class:`ViTTower`, is permuted."""

    def forward(self, images):
        if images.ndim == 4 and images.shape[-1] in (1, 3) \
                and images.shape[1] not in (1, 3):
            images = images.permute(0, 3, 1, 2)
        return _pooled(self.hf_module(pixel_values=images))


def graft_pretrained_params(model, text_params=None, image_params=None):
    """Load HF ``state_dict``s into the adapters' wrapped modules of
    ``model``, in place; returns ``model``. Raises KeyError when the model
    was not built with the HF tower adapters."""
    for tower, params in ((model.text_encoder, text_params),
                          (model.image_encoder, image_params)):
        if params is None:
            continue
        if not isinstance(tower, _HFTower):
            raise KeyError("hf_module")
        tower.hf_module.load_state_dict(params)
    return model


class MultimodalHyperbolicModel(nn.Module):
    """Two towers -> MLP projectors -> hyperboloid."""

    def __init__(self, text_encoder: nn.Module, image_encoder: nn.Module,
                 projection_dim: int = 128, hidden_dim: int = 512,
                 curvature: float = 1.0):
        super().__init__()
        self.text_encoder = text_encoder
        self.image_encoder = image_encoder
        self.curvature = curvature
        self.text_projector = MLPProjector(text_encoder.out_dim, hidden_dim,
                                           projection_dim)
        self.image_projector = MLPProjector(image_encoder.out_dim,
                                            hidden_dim, projection_dim)

    def _to_hyperboloid(self, x):
        return L.project_to_hyperboloid(x, self.curvature)

    def encode_text(self, ids, attention_mask=None):
        pooled = self.text_encoder(ids, attention_mask)
        return self._to_hyperboloid(self.text_projector(pooled))

    def encode_image(self, images):
        return self._to_hyperboloid(
            self.image_projector(self.image_encoder(images)))

    def forward(self, ids, images, attention_mask=None):
        return (self.encode_text(ids, attention_mask),
                self.encode_image(images))


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's default initializers, drawn from ``generator`` (a CPU
    generator, so the weights do not depend on the device): dense and
    convolution kernels LeCun normal, biases zero, embeddings normal with
    variance ``1/dim``, LayerNorm scale one, ``pos_emb`` and ``cls``
    normal(0.02). The modules wrapped by the HF adapters keep their own
    weights."""
    skip = set()
    for m in model.modules():
        if isinstance(m, _HFTower):
            skip.update(id(p) for p in m.hf_module.parameters())

    def normal(w, std):
        w.copy_(std * torch.randn(w.shape, generator=generator))

    def lecun(w, fan_in):
        std = math.sqrt(1.0 / fan_in) / .87962566103423978
        t = torch.empty(w.shape)
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        w.copy_(t)

    with torch.no_grad():
        for name, m in model.named_modules():
            if any(id(p) in skip for p in m.parameters(recurse=False)):
                continue
            if isinstance(m, nn.Linear):
                lecun(m.weight, m.in_features)
                m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                lecun(m.weight, m.weight[0].numel())
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                normal(m.weight, 1.0 / math.sqrt(m.embedding_dim))
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            for pname in ("pos_emb", "cls"):
                p = m._parameters.get(pname)
                if p is not None:
                    normal(p, 0.02)
