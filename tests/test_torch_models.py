"""The port's downstream models (hyptokenizer_tpu_torch/models/) against the
JAX package's, on the CPU at small sizes: the losses and Recall@K, BERT MLM
and classification against transformers' Flax BERT with the weights carried
across (``convert.bert_params_from_flax``), their training loops with the
same MLM masks (the JAX key chain replayed), the two towers and the
multimodal model against the flax modules (``convert.multimodal_params_from_flax``),
retrieval training, and the HF tower adapters over transformers' torch
modules. Inputs are made from a seed with numpy and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyptokenizer_tpu.models import losses as JLoss
from hyptokenizer_tpu.models import multimodal as JMM
from hyptokenizer_tpu.models import nlp as JNLP
from hyptokenizer_tpu.models import retrieval as JRet
from hyptokenizer_tpu.ops import lorentz as JL
from hyptokenizer_tpu_torch import convert
from hyptokenizer_tpu_torch.models import losses as TLoss
from hyptokenizer_tpu_torch.models import multimodal as TMM
from hyptokenizer_tpu_torch.models import nlp as TNLP
from hyptokenizer_tpu_torch.models import retrieval as TRet
from tests.torch_port_common import one_torch_thread, ReplayDraws  # noqa: F401

LOSS_TOL = 1e-5
BERT_TOL = 1e-4
TOWER_TOL = 1e-5


def points(seed, n, d, sigma=0.5):
    return np.asarray(JL.random_points(jax.random.PRNGKey(seed), n, d,
                                       sigma=sigma))


def t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ losses

def test_contrastive_and_infonce_match_jax():
    z1, z2 = points(1, 12, 8), points(2, 12, 8)
    for temp in (0.07, 0.5):
        want = float(JLoss.hyperbolic_contrastive_loss(z1, z2, temp, 1.3))
        got = float(TLoss.hyperbolic_contrastive_loss(t(z1), t(z2), temp, 1.3))
        assert got == pytest.approx(want, rel=LOSS_TOL, abs=LOSS_TOL)
    want = float(JLoss.HyperbolicInfoNCE(0.1)(z1, z1))
    got = float(TLoss.HyperbolicInfoNCE(0.1)(t(z1), t(z1)))
    assert got == pytest.approx(want, rel=LOSS_TOL, abs=LOSS_TOL)


def test_contrastive_grad_matches_jax():
    z1, z2 = points(3, 8, 6), points(4, 8, 6)
    want = np.asarray(jax.grad(
        lambda a: JLoss.hyperbolic_contrastive_loss(a, z2))(z1))
    a = t(z1).requires_grad_(True)
    TLoss.hyperbolic_contrastive_loss(a, t(z2)).backward()
    assert np.isfinite(a.grad.numpy()).all()
    np.testing.assert_allclose(a.grad.numpy(), want, rtol=1e-4,
                               atol=LOSS_TOL)


def test_triplet_matches_jax():
    a, p, n = points(5, 10, 8), points(6, 10, 8), points(7, 10, 8, 2.0)
    for margin in (0.1, 3.0):
        want = float(JLoss.hyperbolic_triplet_loss(a, p, n, margin, 0.7))
        got = float(TLoss.hyperbolic_triplet_loss(t(a), t(p), t(n), margin,
                                                  0.7))
        assert got == pytest.approx(want, rel=LOSS_TOL, abs=LOSS_TOL)


@pytest.mark.parametrize("tied", [False, True])
def test_recall_at_k_matches_jax(tied):
    q = points(8, 20, 16, 0.8)
    g = points(9, 20, 16, 0.8) if not tied else q.copy()
    if tied:
        # Gallery rows 3 and 4 equal to 2, and 11 to 10: every query sees
        # exactly tied distances there; a stable sort ranks them by index.
        g[3] = g[4] = g[2]
        g[11] = g[10]
    want = JLoss.recall_at_k(q, g, ks=(1, 2, 5, 10))
    got = TLoss.recall_at_k(t(q), t(g), ks=(1, 2, 5, 10))
    assert set(got) == set(want)
    n = q.shape[0]
    for k in want:
        # The hits are exact; the means may round apart by an ulp (XLA
        # multiplies by 1/n).
        assert round(float(got[k]) * n) == round(float(want[k]) * n), k
        assert float(got[k]) == pytest.approx(float(want[k]), abs=1e-6)
    if tied:
        assert float(got["text_to_image_r@1"]) < 1.0


# -------------------------------------------------------------------- BERT

def bert_cfgs(layers, num_labels=3):
    from transformers import BertConfig
    kw = dict(vocab_size=61, hidden_size=32, num_hidden_layers=layers,
              num_attention_heads=2, intermediate_size=128,
              max_position_embeddings=64)
    return (BertConfig(num_labels=num_labels, **kw),
            TNLP.BertConfig(num_labels=num_labels, **kw))


def padded_batch(seed=0, b=4, n=12, vocab=61):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, n)).astype(np.int32)
    mask = np.ones((b, n), np.int32)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    ids[mask == 0] = 0
    return ids, mask


def torch_twin(jax_model, cls, cfg):
    model = cls(cfg, seed=5)
    model.load_state_dict(convert.bert_params_from_flax(
        jax.tree.map(np.asarray, jax_model.params)), strict=True)
    return model


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("task", ["mlm", "classification"])
def test_bert_logits_match_flax(task, layers):
    pytest.importorskip("transformers")
    from transformers import (FlaxBertForMaskedLM,
                              FlaxBertForSequenceClassification)
    jcfg, tcfg = bert_cfgs(layers)
    jcls, tcls = {"mlm": (FlaxBertForMaskedLM, TNLP.BertForMaskedLM),
                  "classification": (FlaxBertForSequenceClassification,
                                     TNLP.BertForSequenceClassification)}[task]
    jm = jcls(jcfg, seed=layers)
    tm = torch_twin(jm, tcls, tcfg)
    ids, mask = padded_batch(layers)
    want = np.asarray(jm(input_ids=ids, attention_mask=mask,
                         params=jm.params, train=False).logits)
    with torch.no_grad():
        got = tm(t(ids).long(), t(mask).long()).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=BERT_TOL, atol=BERT_TOL)


def test_bert_init_and_builders():
    """Flax BERT's initializers: normal(0.02) except the head transform and
    the classifier (LeCun normal), zero biases, unit LayerNorm; the
    injected table is the JAX package's ``_fit_embedding_table``."""
    emb = np.random.default_rng(3).standard_normal((40, 8)).astype(np.float32)
    m = TNLP.build_bert_mlm(50, hidden=64, layers=1, heads=2, seed=0,
                            embeddings=emb, inject_scale="matched",
                            device="cpu")
    np.testing.assert_array_equal(
        m.bert.embeddings.word_embeddings.weight.detach().numpy(),
        JNLP._fit_embedding_table(emb, 50, 64, "matched"))
    q = m.bert.encoder.layer[0].attention.self.query.weight.detach()
    assert float(q.std()) == pytest.approx(0.02, rel=0.1)
    tr = m.cls.predictions.transform.dense.weight.detach()
    assert float(tr.std()) == pytest.approx(64 ** -0.5, rel=0.1)
    assert float(tr.abs().max()) <= 2 * 64 ** -0.5 / .87962566103423978
    assert not m.cls.predictions.bias.detach().any()
    same = TNLP.build_bert_mlm(50, hidden=64, layers=1, heads=2, seed=0,
                               device="cpu")
    other = TNLP.build_bert_mlm(50, hidden=64, layers=1, heads=2, seed=1,
                                device="cpu")
    a, b, c = (x.bert.encoder.layer[0].output.dense.weight
               for x in (m, same, other))
    assert torch.equal(a, b) and not torch.equal(a, c)
    cls = TNLP.build_bert_classifier(50, 4, hidden=64, layers=1, heads=2,
                                     device="cpu")
    assert cls.classifier.weight.shape == (4, 64)


def test_export_and_batches_match_jax():
    emb = points(11, 30, 9, 0.8)
    np.testing.assert_allclose(
        TNLP.export_euclidean_embeddings(emb, device="cpu"),
        JNLP.export_euclidean_embeddings(emb), rtol=1e-5, atol=1e-6)
    enc = {"input_ids": [list(range(1, 3 + i % 7)) for i in range(21)]}
    for a, b in zip(TNLP.make_batches(enc, 4, 6, seed=3),
                    JNLP.make_batches(enc, 4, 6, seed=3)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def encoded_set(n, seed, vocab=61, max_len=14):
    rng = np.random.default_rng(seed)
    ids = [rng.integers(4, vocab, rng.integers(3, max_len)).tolist()
           for _ in range(n)]
    return {"input_ids": ids, "attention_mask": [[1] * len(s) for s in ids]}


def assert_state_close(got, want, rtol, atol, lr, steps):
    """Every parameter within ``rtol``/``atol``, but an attention key bias:
    it shifts a query's scores by one constant, so its gradient is zero in
    exact arithmetic and each side's is its own rounding noise, which Adam
    scales up to at most ``lr`` a step. It is held to that bound."""
    assert set(want) == set(got)
    for k in want:
        if k.endswith("key.bias"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=2 * lr * steps,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=rtol, atol=atol, err_msg=k)


def assert_params_close(jax_params, model, tol, lr, steps=3):
    want = convert.bert_params_from_flax(jax.tree.map(np.asarray, jax_params))
    assert_state_close(model.state_dict(), want, tol, tol, lr, steps)


def test_mlm_train_matches_jax():
    """Three MLM steps (24 sequences, batch 8) with the JAX key chain's
    masks replayed, then the held-out perplexity with mlm_eval's chain."""
    emb = np.random.default_rng(4).standard_normal((61, 8)).astype(
        np.float32)
    jm = JNLP.build_bert_mlm(61, hidden=32, layers=2, heads=2, max_pos=64,
                             seed=0, embeddings=emb, inject_scale="matched")
    _, tcfg = bert_cfgs(2)
    tm = torch_twin(jm, TNLP.BertForMaskedLM, tcfg)
    enc, ev = encoded_set(24, 0), encoded_set(16, 1)
    kw = dict(epochs=1, batch_size=8, max_length=14, lr=5e-3, seed=7,
              log=lambda s: None, eval_encoded=ev)
    jparams, jppl = JNLP.mlm_train(jm, enc, **kw)
    model, ppl = TNLP.mlm_train(
        tm, enc, sampler=ReplayDraws(jax.random.PRNGKey(7), n_split=2),
        eval_sampler=ReplayDraws(jax.random.PRNGKey(1234), n_split=2), **kw)
    assert model is tm
    assert_params_close(jparams, tm, BERT_TOL, kw["lr"])
    assert ppl == pytest.approx(jppl, rel=BERT_TOL)


def test_classification_train_matches_jax():
    """Three classification steps and the held-out accuracy."""
    jcfg, tcfg = bert_cfgs(1, num_labels=3)
    jm = JNLP.build_bert_classifier(61, 3, hidden=32, layers=1, heads=2,
                                    max_pos=64, seed=1)
    tm = torch_twin(jm, TNLP.BertForSequenceClassification, tcfg)
    enc, ev = encoded_set(24, 2), encoded_set(11, 3)
    labels = [i % 3 for i in range(24)]
    ev_labels = [(i * 2) % 3 for i in range(11)]
    kw = dict(epochs=1, batch_size=8, max_length=14, lr=5e-3, seed=3,
              log=lambda s: None, eval_encoded=ev, eval_labels=ev_labels)
    jparams, jacc = JNLP.classification_train(jm, enc, labels, **kw)
    _, acc = TNLP.classification_train(tm, enc, labels, **kw)
    assert_params_close(jparams, tm, BERT_TOL, kw["lr"])
    assert acc == jacc


# ------------------------------------------------------------ multimodal

def towers(vocab=50, dim=32, depth=2, heads=2, seq=16, image=16):
    j = JMM.MultimodalHyperbolicModel(
        text_encoder=JMM.TransformerTower(vocab_size=vocab, dim=dim,
                                          depth=depth, heads=heads,
                                          max_len=seq),
        image_encoder=JMM.ViTTower(image_size=image, patch_size=8, dim=dim,
                                   depth=depth, heads=heads),
        projection_dim=8, hidden_dim=24)
    tm = TMM.MultimodalHyperbolicModel(
        text_encoder=TMM.TransformerTower(vocab_size=vocab, dim=dim,
                                          depth=depth, heads=heads,
                                          max_len=seq),
        image_encoder=TMM.ViTTower(image_size=image, patch_size=8, dim=dim,
                                   depth=depth, heads=heads),
        projection_dim=8, hidden_dim=24)
    return j, tm


def mm_inputs(seed=0, b=4, seq=16, image=16, vocab=50):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, seq)).astype(np.int32)
    mask = np.ones((b, seq), np.int32)
    mask[1, 10:] = 0
    mask[3, 4:] = 0
    images = rng.standard_normal((b, image, image, 3)).astype(np.float32)
    return ids, images, mask


@pytest.mark.parametrize("image", [16, 20])
def test_multimodal_matches_flax(image):
    """Both towers and the projections, with a padded mask (mean pooling)
    and without (first token); at 20 pixels the patch convolution pads
    (``SAME``)."""
    jm, tm = towers(image=image)
    ids, images, mask = mm_inputs(image=image)
    variables = jm.init(jax.random.PRNGKey(0), ids, images, mask)
    tm.load_state_dict(convert.multimodal_params_from_flax(
        jax.tree.map(np.asarray, variables["params"])), strict=True)
    for m in (mask, None):
        want = jm.apply(variables, ids, images, m)
        with torch.no_grad():
            got = tm(t(ids).long(), t(images),
                     None if m is None else t(m).long())
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=TOWER_TOL, atol=TOWER_TOL)
            mink = g[:, 0] ** 2 - (g[:, 1:] ** 2).sum(-1)
            np.testing.assert_allclose(mink.numpy(), 1.0, atol=1e-4)


def test_init_params_follows_flax_initializers():
    _, tm = towers(dim=64, depth=1)
    TMM.init_params(tm, torch.Generator().manual_seed(0))
    sd = tm.state_dict()   # detached
    assert float(sd["text_encoder.embed.weight"].std()) == pytest.approx(
        64 ** -0.5, rel=0.1)
    assert float(sd["text_encoder.pos_emb"].std()) == pytest.approx(
        0.02, rel=0.1)
    assert float(sd["image_encoder.patch.weight"].std()) == pytest.approx(
        192 ** -0.5, rel=0.1)
    fc = sd["text_encoder.blocks.0.fc1.weight"]
    assert float(fc.std()) == pytest.approx(64 ** -0.5, rel=0.1)
    assert float(fc.abs().max()) <= 2 * 64 ** -0.5 / .87962566103423978
    assert torch.equal(sd["text_encoder.blocks.0.ln1.weight"], torch.ones(64))
    assert not sd["text_encoder.blocks.0.attn.query.bias"].any()
    _, again = towers(dim=64, depth=1)
    TMM.init_params(again, torch.Generator().manual_seed(0))
    for a, b in zip(tm.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def retrieval_setup(seed=3):
    jm, tm = towers(vocab=40, dim=16, depth=1, seq=8)
    batches = lambda: JRet.synthetic_batches(2, 8, 16, 8, 40, seed=seed)  # noqa: E731
    ev = next(iter(JRet.synthetic_batches(1, 8, 16, 8, 40, seed=seed + 9)))
    return jm, tm, batches, ev


def test_synthetic_batches_are_the_jax_ones():
    for a, b in zip(TRet.synthetic_batches(3, 4, 16, 8, 40, seed=5),
                    JRet.synthetic_batches(3, 4, 16, 8, 40, seed=5)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_train_retrieval_matches_jax(monkeypatch):
    """Two AdamW steps from the JAX model's initial weights (the port's
    initializer is replaced by a load of them, for this comparison only):
    the losses, the recalls and the weights agree."""
    jm, tm, batches, ev = retrieval_setup()
    images0, ids0, mask0 = next(iter(batches()))
    init = jm.init(jax.random.PRNGKey(11), jnp.asarray(ids0),
                   jnp.asarray(images0), jnp.asarray(mask0))
    sd = convert.multimodal_params_from_flax(
        jax.tree.map(np.asarray, init["params"]))
    monkeypatch.setattr(TMM, "init_params",
                        lambda model, g: model.load_state_dict(sd))
    kw = dict(epochs=1, lr=1e-3, temperature=0.1, seed=11, eval_batch=ev,
              log=lambda s: None)
    want = JRet.train_retrieval(jm, batches, **kw)
    got = TRet.train_retrieval(tm, batches, device="cpu", **kw)
    (wh,), (gh,) = want["history"], got["history"]
    assert gh["loss"] == pytest.approx(wh["loss"], rel=1e-5)
    for k, v in wh.items():
        if k.startswith(("text_to_image", "image_to_text")):
            assert gh[k] == v, k
    final = convert.multimodal_params_from_flax(
        jax.tree.map(np.asarray, want["params"]["params"]))
    assert_state_close(got["params"], final, 1e-4, 1e-5, kw["lr"], 2)
    assert got["best"]["r1"] == want["best"]["r1"]


def test_best_snapshot_does_not_alias_the_model():
    _, tm, batches, ev = retrieval_setup()
    out = TRet.train_retrieval(tm, batches, epochs=2, seed=0, eval_batch=ev,
                               log=lambda s: None, device="cpu")
    best = out["best"]
    assert best["r1"] >= 0
    kept = {k: v.clone() for k, v in best["params"].items()}
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(1.0)
    for k, v in best["params"].items():
        assert torch.equal(v, kept[k]), k
    live = tm.state_dict()
    assert not torch.equal(live["text_projector.fc1.weight"],
                           best["params"]["text_projector.fc1.weight"])
    fresh = towers(vocab=40, dim=16, depth=1, seq=8)[1]
    fresh.load_state_dict(best["params"])


def test_losses_fall_in_retrieval_training():
    _, tm, batches, ev = retrieval_setup()
    out = TRet.train_retrieval(tm, batches, epochs=4, lr=1e-3, seed=0,
                               eval_batch=ev, log=lambda s: None,
                               device="cpu")
    losses = [h["loss"] for h in out["history"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_hf_torch_tower_adapter():
    """transformers' torch BERT and ViT (tiny local configs, no weights
    fetched) as the towers: outputs on the sheet, the wrapped modules kept
    in eval mode, and a grafted state_dict changes the outputs."""
    pytest.importorskip("transformers")
    from transformers import BertConfig, BertModel, ViTConfig, ViTModel
    torch.manual_seed(0)
    bert = BertModel(BertConfig(vocab_size=64, hidden_size=32,
                                num_hidden_layers=1, num_attention_heads=2,
                                intermediate_size=64,
                                max_position_embeddings=32))
    vit = ViTModel(ViTConfig(hidden_size=32, num_hidden_layers=1,
                             num_attention_heads=2, intermediate_size=64,
                             image_size=16, patch_size=8, num_channels=3))
    model = TMM.MultimodalHyperbolicModel(
        text_encoder=TMM.HFTextTower(bert),
        image_encoder=TMM.HFImageTower(vit), projection_dim=8,
        hidden_dim=16)
    TMM.init_params(model, torch.Generator().manual_seed(0))
    model.train()
    assert not bert.training and not vit.training
    ids = torch.ones((2, 8), dtype=torch.int64)
    images = torch.ones((2, 16, 16, 3))
    with torch.no_grad():
        zt, zi = model(ids, images)
        pooled = bert(input_ids=ids,
                      attention_mask=torch.ones_like(ids)).pooler_output
        want_t = model._to_hyperboloid(model.text_projector(pooled))
        zi_nchw = model.encode_image(images.permute(0, 3, 1, 2))
    assert zt.shape == (2, 9) and zi.shape == (2, 9)
    torch.testing.assert_close(zt, want_t)
    torch.testing.assert_close(zi, zi_nchw)
    for z in (zt, zi):
        mink = z[:, 0] ** 2 - (z[:, 1:] ** 2).sum(-1)
        np.testing.assert_allclose(mink.numpy(), 1.0, atol=1e-4)
    torch.manual_seed(1)
    other = BertModel(bert.config)
    TMM.graft_pretrained_params(model, text_params=other.state_dict())
    with torch.no_grad():
        zt2, _ = model(ids, images)
    assert not torch.allclose(zt, zt2)
    plain = TMM.MultimodalHyperbolicModel(
        TMM.TransformerTower(64, dim=32, depth=1, heads=2),
        TMM.ViTTower(16, 8, dim=32, depth=1, heads=2))
    with pytest.raises(KeyError):
        TMM.graft_pretrained_params(plain, text_params=other.state_dict())
