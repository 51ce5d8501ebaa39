"""Downstream NLP evaluation: BERT MLM and sequence classification, in
PyTorch.

Port of ``hyptokenizer_tpu/models/nlp.py``: a tokenizer adapter over the
port's and the baseline tokenizers, the export of hyperbolic embeddings into
the transformer's input table, and small-BERT MLM / classification
training.

BERT is the port's own ``torch.nn`` module (:class:`BertForMaskedLM`,
:class:`BertForSequenceClassification`), written to the architecture of
transformers' ``FlaxBertForMaskedLM`` / ``FlaxBertForSequenceClassification``
that the JAX package trains from a fresh ``BertConfig``; the parameter names
are transformers' (``convert.bert_params_from_flax`` carries a Flax tree
over). Its numerics are Flax BERT's:

- word + position + token-type embeddings, then LayerNorm; post-LN encoder
  layers; LayerNorm eps ``1e-12``;
- the activation is the exact GELU (transformers' ``ACT2FN["gelu"]``);
- a masked key gets ``finfo(float32).min`` as an additive bias;
- the MLM head is dense, GELU, LayerNorm, then the decoder tied to the word
  embeddings plus its own bias; the classifier is a tanh pooler on the
  first token, then a dense layer;
- no dropout, in training too: the JAX steps call the model with
  ``train=False``;
- initialization as Flax BERT's (normal 0.02, the head transform and the
  classifier LeCun normal), drawn from a ``torch.Generator`` seeded with
  ``seed`` on the CPU, so the weights do not depend on the device.

Training is ``torch.optim.AdamW(lr, weight_decay=1e-4, eps=1e-8)``, which is
``optax.adamw(lr)`` (decay on every parameter). The MLM masks are drawn
through a sampler with ``uniform(shape)``, one call per batch in the JAX
step's order; the default is ``embed_train.GeneratorSampler(seed)`` on the
model's device. float32 throughout, TF32 off (``_device.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hyptokenizer_tpu_torch import _device
from hyptokenizer_tpu_torch.ops import lorentz as L
from hyptokenizer_tpu_torch.tokenizer.embed_train import GeneratorSampler

WEIGHT_DECAY = 1e-4   # optax.adamw's default
ADAM_EPS = 1e-8


class TokenizerAdapter:
    """One surface over the port's and the baseline tokenizers:
    ``tokenize``, ``encode`` (truncation + attention mask),
    ``batch_encode``, ``get_vocab_size``, ``get_embeddings``. A hyperbolic
    tokenizer loads onto ``device`` (its load re-scan runs there)."""

    def __init__(self, method: str, model_path: str, vocab_size: int = 0,
                 device=None):
        self.method = method
        self.device = _device.resolve(device)
        if method == "hyperbolic":
            from hyptokenizer_tpu_torch.tokenizer import HyperbolicTokenizer
            self.tokenizer = HyperbolicTokenizer.load(model_path,
                                                      device=self.device)
        elif method == "sentencepiece":
            from hyptokenizer_tpu_torch.evals.baselines import (
                SentencePieceWrapper)
            self.sp = SentencePieceWrapper(model_path)
        elif method in ("bpe", "bytelevel", "wordpiece", "unigram", "char"):
            from tokenizers import Tokenizer
            self.hf = Tokenizer.from_file(model_path)
        else:
            raise ValueError(f"unknown method {method}")

    def tokenize(self, text: str) -> List[str]:
        if self.method == "hyperbolic":
            return self.tokenizer.tokenize(text)
        if self.method == "sentencepiece":
            return self.sp.tokenize(text)
        return self.hf.encode(text).tokens

    def encode(self, text: str, max_length: int = 128) -> Dict:
        if self.method == "hyperbolic":
            ids = self.tokenizer.encode(text)
        elif self.method == "sentencepiece":
            ids = self.sp.encode(text)
        else:
            ids = self.hf.encode(text).ids
        ids = ids[:max_length]
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}

    def batch_encode(self, texts: List[str], max_length: int = 128) -> Dict:
        if self.method == "hyperbolic":
            all_ids = self.tokenizer.encode_batch(texts)
        elif self.method == "sentencepiece":
            all_ids = [self.sp.encode(t) for t in texts]
        else:
            all_ids = [e.ids for e in self.hf.encode_batch(texts)]
        out = {"input_ids": [], "attention_mask": []}
        for ids in all_ids:
            ids = ids[:max_length]
            out["input_ids"].append(ids)
            out["attention_mask"].append([1] * len(ids))
        return out

    def get_vocab_size(self) -> int:
        if self.method == "hyperbolic":
            return len(self.tokenizer.vocab)
        if self.method == "sentencepiece":
            return self.sp.get_vocab_size()
        return self.hf.get_vocab_size()

    def get_embeddings(self) -> Optional[np.ndarray]:
        if self.method == "hyperbolic":
            return export_euclidean_embeddings(self.tokenizer.embeddings,
                                               device=self.device)
        return None


def export_euclidean_embeddings(lorentz_emb, device=None) -> np.ndarray:
    """Lorentz points -> tangent space at the origin, spatial part (V, d),
    computed on ``device``."""
    dev = _device.resolve(device)
    emb = torch.as_tensor(np.array(lorentz_emb, np.float32), device=dev)
    o = L.origin(emb.shape[1] - 1, dev).expand(emb.shape)
    return L.log_map(o, emb)[:, 1:].cpu().numpy()


def _fit_embedding_table(table: np.ndarray, vocab_size: int,
                         hidden: int, inject_scale: str = "raw") -> np.ndarray:
    """Fit an exported (V, d) table into a (vocab_size, hidden) BERT table:
    zero-pad / truncate dims over a ``default_rng(0)`` 0.02-std table.

    ``inject_scale``: "raw" copies values unscaled; "matched" rescales the
    table to the 0.02 init std, preserving directions (the JAX package's
    rule, ``hyptokenizer_tpu/models/nlp.py``)."""
    out = 0.02 * np.random.default_rng(0).standard_normal(
        (vocab_size, hidden)).astype(np.float32)
    v = min(vocab_size, table.shape[0])
    d = min(hidden, table.shape[1])
    src = table[:v, :d]
    if inject_scale == "matched":
        src = src * (0.02 / max(float(src.std()), 1e-8))
    out[:v, :d] = src
    return out


# ------------------------------------------------------------------- BERT

@dataclasses.dataclass
class BertConfig:
    """The fields of transformers' ``BertConfig`` that the JAX package sets
    or reads; the defaults are the CLI's."""

    vocab_size: int
    hidden_size: int = 256
    num_hidden_layers: int = 4
    num_attention_heads: int = 4
    intermediate_size: int = 1024
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    num_labels: int = 2


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)
        h = (self.word_embeddings(ids)
             + self.token_type_embeddings(torch.zeros_like(ids))
             + self.position_embeddings(pos)[None])
        return self.LayerNorm(h)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        if cfg.hidden_size % cfg.num_attention_heads:
            raise ValueError("hidden_size must be a multiple of "
                             "num_attention_heads")
        self.heads = cfg.num_attention_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, n, width = h.shape
        hd = width // self.heads

        def split(x):
            return x.view(b, n, self.heads, hd).transpose(1, 2)

        q = split(self.query(h)) / math.sqrt(hd)
        scores = torch.matmul(q, split(self.key(h)).transpose(-1, -2)) + bias
        ctx = torch.matmul(torch.softmax(scores, dim=-1), split(self.value(h)))
        return ctx.transpose(1, 2).reshape(b, n, width)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h, residual):
        return self.LayerNorm(self.dense(h) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, h, bias):
        return self.output(self.self(h, bias), h)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, h):
        return F.gelu(self.dense(h))


class BertOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h, residual):
        return self.LayerNorm(self.dense(h) + residual)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, h, bias):
        a = self.attention(h, bias)
        return self.output(self.intermediate(a), a)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(
            [BertLayer(cfg) for _ in range(cfg.num_hidden_layers)])

    def forward(self, h, bias):
        for layer in self.layer:
            h = layer(h, bias)
        return h


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, h):
        return torch.tanh(self.dense(h[:, 0]))


class BertModel(nn.Module):
    """Embeddings and encoder, and the pooler when ``pooling``; returns
    (sequence output, pooled output or None)."""

    def __init__(self, cfg: BertConfig, pooling: bool = True):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)
        self.pooler = BertPooler(cfg) if pooling else None

    def forward(self, ids: torch.Tensor, attention_mask: torch.Tensor):
        bias = torch.where(
            attention_mask[:, None, None, :] > 0, 0.0,
            torch.finfo(torch.float32).min).to(torch.float32)
        h = self.encoder(self.embeddings(ids), bias)
        return h, (self.pooler(h) if self.pooler is not None else None)


class BertPredictionHeadTransform(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h):
        return self.LayerNorm(F.gelu(self.dense(h)))


class BertLMPredictionHead(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.transform = BertPredictionHeadTransform(cfg)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, h, word_embeddings):
        return torch.matmul(self.transform(h), word_embeddings.T) + self.bias


class BertOnlyMLMHead(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.predictions = BertLMPredictionHead(cfg)


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator):
    """Flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance ``1/fan_in``."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    t = torch.empty(w.shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)
    with torch.no_grad():
        w.copy_(t)


def _normal_(w: torch.Tensor, std: float, g: torch.Generator):
    with torch.no_grad():
        w.copy_(std * torch.randn(w.shape, generator=g))


class _BertBase(nn.Module):
    def _init_weights(self, seed: int) -> None:
        """Flax BERT's initializers, drawn on the CPU from ``seed``: every
        embedding and dense kernel normal(``initializer_range``), except the
        MLM head's transform and the classifier (LeCun normal); biases zero,
        LayerNorm scale one."""
        g = torch.Generator().manual_seed(int(seed))
        lecun = {id(m) for m in self._lecun_modules()}
        std = self.config.initializer_range
        for m in self.modules():
            if isinstance(m, nn.Embedding):
                _normal_(m.weight, std, g)
            elif isinstance(m, nn.Linear):
                if id(m) in lecun:
                    _lecun_normal_(m.weight, m.in_features, g)
                else:
                    _normal_(m.weight, std, g)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def _lecun_modules(self):
        return []

    def set_word_embeddings(self, table: np.ndarray) -> None:
        with torch.no_grad():
            w = self.bert.embeddings.word_embeddings.weight
            w.copy_(torch.as_tensor(table, dtype=w.dtype))


class BertForMaskedLM(_BertBase):
    """``forward(ids, attention_mask) -> logits (B, L, vocab_size)``."""

    def __init__(self, cfg: BertConfig, seed: int = 0):
        super().__init__()
        self.config = cfg
        self.bert = BertModel(cfg, pooling=False)
        self.cls = BertOnlyMLMHead(cfg)
        self._init_weights(seed)

    def _lecun_modules(self):
        return [self.cls.predictions.transform.dense]

    def forward(self, ids, attention_mask):
        h, _ = self.bert(ids, attention_mask)
        return self.cls.predictions(
            h, self.bert.embeddings.word_embeddings.weight)


class BertForSequenceClassification(_BertBase):
    """``forward(ids, attention_mask) -> logits (B, num_labels)``."""

    def __init__(self, cfg: BertConfig, seed: int = 0):
        super().__init__()
        self.config = cfg
        self.bert = BertModel(cfg, pooling=True)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels)
        self._init_weights(seed)

    def _lecun_modules(self):
        return [self.classifier]

    def forward(self, ids, attention_mask):
        _, pooled = self.bert(ids, attention_mask)
        return self.classifier(pooled)


def _config(vocab_size, hidden, layers, heads, max_pos, **kw) -> BertConfig:
    return BertConfig(vocab_size=vocab_size, hidden_size=hidden,
                      num_hidden_layers=layers, num_attention_heads=heads,
                      intermediate_size=hidden * 4,
                      max_position_embeddings=max_pos, **kw)


def build_bert_mlm(vocab_size: int, hidden: int = 256, layers: int = 4,
                   heads: int = 4, max_pos: int = 512, seed: int = 0,
                   embeddings: Optional[np.ndarray] = None,
                   inject_scale: str = "raw", device=None) -> BertForMaskedLM:
    """A fresh BERT MLM on ``device`` (+ optional hyperbolic embedding
    injection)."""
    model = BertForMaskedLM(
        _config(vocab_size, hidden, layers, heads, max_pos), seed=seed)
    if embeddings is not None:
        model.set_word_embeddings(_fit_embedding_table(
            embeddings, vocab_size, hidden, inject_scale))
    return model.to(_device.resolve(device))


def build_bert_classifier(vocab_size: int, num_labels: int, hidden: int = 256,
                          layers: int = 4, heads: int = 4, max_pos: int = 512,
                          seed: int = 0,
                          embeddings: Optional[np.ndarray] = None,
                          inject_scale: str = "raw",
                          device=None) -> BertForSequenceClassification:
    model = BertForSequenceClassification(
        _config(vocab_size, hidden, layers, heads, max_pos,
                num_labels=num_labels), seed=seed)
    if embeddings is not None:
        model.set_word_embeddings(_fit_embedding_table(
            embeddings, vocab_size, hidden, inject_scale))
    return model.to(_device.resolve(device))


def make_batches(encoded: Dict, batch_size: int, max_length: int,
                 pad_id: int = 0, seed: int = 0):
    """Static-shape (B, L) numpy batches from ragged encodings, in a
    ``default_rng(seed)`` permutation; a partial last batch is dropped."""
    rng = np.random.default_rng(seed)
    n = len(encoded["input_ids"])
    order = rng.permutation(n)
    for start in range(0, n - batch_size + 1, batch_size):
        yield _padded(encoded, order[start:start + batch_size], batch_size,
                      max_length, pad_id)


def _padded(encoded: Dict, idx, batch_size: int, max_length: int,
            pad_id: int = 0):
    """(ids, mask) of the sequences ``idx``, truncated and padded to
    (batch_size, max_length); rows past ``len(idx)`` are all padding."""
    ids = np.full((batch_size, max_length), pad_id, np.int32)
    mask = np.zeros((batch_size, max_length), np.int32)
    for r, k in enumerate(idx):
        seq = encoded["input_ids"][k][:max_length]
        ids[r, :len(seq)] = seq
        mask[r, :len(seq)] = 1
    return ids, mask


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _to(dev, *arrays):
    return [torch.from_numpy(np.asarray(a)).to(dev, torch.int64)
            for a in arrays]


def _adamw(model: nn.Module, lr: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), lr=lr,
                             weight_decay=WEIGHT_DECAY, eps=ADAM_EPS)


def _masked_ll(model, ids, mask, sampler, mask_id, mlm_prob):
    """(sum of masked tokens' log-likelihood, number masked) of a batch
    whose masks are drawn as the JAX step draws them."""
    rand = sampler.uniform(ids.shape).to(ids.device)
    is_masked = (rand < mlm_prob) & (mask == 1)
    inputs = torch.where(is_masked, mask_id, ids)
    logp = F.log_softmax(model(inputs, mask), dim=-1)
    tok_ll = torch.gather(logp, -1, ids[..., None])[..., 0]
    w = is_masked.to(torch.float32)
    return torch.sum(tok_ll * w), torch.sum(w)


def mlm_eval(model: nn.Module, encoded: Dict, *, batch_size: int = 16,
             max_length: int = 128, mask_id: int = 3, mlm_prob: float = 0.15,
             seed: int = 1234, sampler=None) -> float:
    """Held-out masked-LM perplexity on the model's device."""
    dev = _device_of(model)
    sampler = GeneratorSampler(seed, dev) if sampler is None else sampler
    total_ll = torch.zeros((), dtype=torch.float64, device=dev)
    total_w = torch.zeros((), dtype=torch.float64, device=dev)
    with torch.no_grad():
        for ids, mask in make_batches(encoded, batch_size, max_length,
                                      seed=seed):
            ll, w = _masked_ll(model, *_to(dev, ids, mask), sampler,
                               mask_id, mlm_prob)
            total_ll += ll
            total_w += w
    total_w = float(total_w)
    if total_w == 0:
        return float("inf")
    return math.exp(min(20.0, -float(total_ll) / total_w))


def mlm_train(model: nn.Module, encoded: Dict, *, epochs: int = 1,
              batch_size: int = 16, max_length: int = 128, lr: float = 5e-4,
              mask_id: int = 3, mlm_prob: float = 0.15, seed: int = 0,
              log=print, eval_encoded: Optional[Dict] = None, sampler=None,
              eval_sampler=None):
    """MLM training on the model's device (mlm_probability 0.15), the
    model trained in place.

    Returns (model, perplexity): held-out perplexity when ``eval_encoded``
    is given (masks from ``eval_sampler``, default ``mlm_eval``'s), else a
    train-loss estimate."""
    dev = _device_of(model)
    sampler = GeneratorSampler(seed, dev) if sampler is None else sampler
    opt = _adamw(model, lr)
    losses = []
    for epoch in range(epochs):
        for ids, mask in make_batches(encoded, batch_size, max_length,
                                      seed=seed + epoch):
            ll, w = _masked_ll(model, *_to(dev, ids, mask), sampler,
                               mask_id, mlm_prob)
            loss = -ll / torch.clamp_min(w, 1.0)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        recent = torch.stack(losses[-50:]).cpu().numpy() if losses else []
        log(f"epoch {epoch}: mlm loss {np.mean(recent):.4f}")
    if eval_encoded is not None:
        ppl = mlm_eval(model, eval_encoded, batch_size=batch_size,
                       max_length=max_length, mask_id=mask_id,
                       mlm_prob=mlm_prob, sampler=eval_sampler)
    elif losses:
        recent = torch.stack(losses[-50:]).cpu().numpy()
        ppl = math.exp(min(20.0, float(np.mean(recent))))
    else:
        ppl = float("inf")
    return model, ppl


def classification_train(model: nn.Module, encoded: Dict, labels: List[int],
                         *, epochs: int = 1, batch_size: int = 16,
                         max_length: int = 128, lr: float = 5e-4,
                         seed: int = 0, log=print,
                         eval_encoded: Optional[Dict] = None,
                         eval_labels: Optional[List[int]] = None):
    """Sequence classification on the model's device, trained in place;
    returns (model, accuracy): held-out accuracy when ``eval_encoded`` and
    ``eval_labels`` are given, else the running train accuracy."""
    dev = _device_of(model)
    opt = _adamw(model, lr)
    labels_arr = np.asarray(labels, np.int32)
    accs = []
    loss = torch.zeros(())
    n = len(encoded["input_ids"])
    for epoch in range(epochs):
        rng = np.random.default_rng(seed + epoch)
        order = rng.permutation(n)
        for start in range(0, n - batch_size + 1, batch_size):
            idx = order[start:start + batch_size]
            ids, mask, y = _to(dev, *_padded(encoded, idx, batch_size,
                                             max_length), labels_arr[idx])
            logits = model(ids, mask)
            loss = F.cross_entropy(logits, y)
            acc = (torch.argmax(logits, -1) == y).to(torch.float32).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            accs.append(acc.detach())
        recent = torch.stack(accs[-20:]).cpu().numpy() if accs else []
        log(f"epoch {epoch}: cls loss {float(loss.detach()):.4f} "
            f"acc {np.mean(recent):.3f}")
    train_acc = (float(np.mean(torch.stack(accs[-20:]).cpu().numpy()))
                 if accs else 0.0)
    if eval_encoded is None or eval_labels is None:
        return model, train_acc
    m = len(eval_encoded["input_ids"])
    correct = 0
    with torch.no_grad():
        for start in range(0, m, batch_size):
            idx = list(range(start, min(start + batch_size, m)))
            ids, mask = _to(dev, *_padded(eval_encoded, idx, batch_size,
                                          max_length))
            pred = torch.argmax(model(ids, mask), -1).cpu().numpy()
            for r, k in enumerate(idx):
                correct += int(pred[r] == eval_labels[k])
    val_acc = correct / max(m, 1)
    log(f"val accuracy: {val_acc:.3f} (train {train_acc:.3f})")
    return model, val_acc
