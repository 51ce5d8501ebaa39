"""Kernel checks: a kernel's merge sequence against its plain version's.

Port of the comparison protocol of ``hyptokenizer_tpu/evals/selfcheck.py``
(``GRAM_ATOL`` :45, ``_compare_chunks`` :48, ``_lockstep_enhanced`` :115),
with the port's plain PyTorch version as the oracle in place of XLA.

Lockstep with oracle resync. Exact merge-sequence equality over a long run
is not a property two float32 execution paths can promise: the kernel and
its plain version sum the grams and the coherence terms in other orders,
and one flipped near-tie changes every merge after it. So the check runs
both CHUNK by chunk from the SAME state, with the same draws, compares the
chunk's merges, and always continues from the plain version's state, so
noise cannot cascade:

  * identical chunk          -> clean
  * same merges, new order   -> "reorder" (a float near-tie among the
                                chunk's picks; counted, allowed)
  * different merge sets     -> allowed only if every differing pick's
                                recorded merge distance is within
                                ``GRAM_ATOL`` of the other's in gram space,
                                a verified near-tie; otherwise FAIL.

:func:`_lockstep_enhanced` is that protocol chunk by chunk, as the JAX
package runs it. :func:`_lockstep_steps` runs it step by step: each kernel
launch makes ONE step from the plain version's state, so a near-tie can
never cascade, and the step's candidate fold (``best_dist``/``best_j``) is
compared too. It is the check for states whose points lie far from the
origin, where the chunk protocol cannot hold: there a float32 Minkowski
gram of two nearby points carries an absolute rounding error of about
ulp(x0 * y0) (x0 ~ 74 at the flagship's d=100, sigma=0.5), far above
``GRAM_ATOL``, and the loop's structural near-ties (a self-pair merge
copies its token) then pick differently on the two paths within a chunk.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

U32 = 2.0 ** -24      # float32 unit roundoff

# Float tie tolerance, in GRAM space: the selection key is the Minkowski
# gram (distance = acosh(gram)/sqrt(c) is monotone in it), and the noise
# between the two paths is about 1 ulp of the gram. Comparing distances
# directly would mis-scale near the acosh clamp floor, where a 1-ulp gram
# difference moves the distance by about 1e-3.
GRAM_ATOL = 1e-5


def _compare_chunks(mk, dk, mx, dx, stats) -> bool:
    """Classify one chunk's merges (kernel ``mk``/``dk`` against the oracle
    ``mx``/``dx``); update ``stats``; return whether they agree."""
    if mk.shape == mx.shape and np.array_equal(mk, mx):
        return True
    sk = {tuple(r) for r in mk.tolist()}
    sx = {tuple(r) for r in mx.tolist()}
    if sk == sx:
        stats["reorders"] = stats.get("reorders", 0) + 1
        return True
    n = min(len(mk), len(mx))
    for t in range(n):
        if tuple(mk[t]) == tuple(mx[t]):
            continue
        gk, gx = float(np.cosh(dk[t])), float(np.cosh(dx[t]))
        if abs(gk - gx) > GRAM_ATOL * max(1.0, abs(gx)):
            stats["first_bad"] = {
                "pos": t, "kernel": mk[t].tolist(), "plain": mx[t].tolist(),
                "d_kernel": float(dk[t]), "d_plain": float(dx[t]),
                "gram_gap": abs(gk - gx)}
            return False
    if len(mk) != len(mx):
        stats["first_bad"] = {"len_kernel": len(mk), "len_plain": len(mx)}
        return False
    stats["dist_ties"] = stats.get("dist_ties", 0) + 1
    return True


def _lockstep_enhanced(tok, n_chunks: int, chunk: int, out: Dict,
                       name: str, seed: int = 0) -> None:
    """Hold the segment kernel of ``tok``'s configuration (K1 or K2) to its
    plain version on ``tok``'s device, ``n_chunks`` chunks of ``chunk``
    merges, each one sync plus segments (``enhanced_loop.run_chunk``).

    Both runs of a chunk draw from samplers with the same seed. Writes the
    verdict ("pass" or "FAIL ...") to ``out[name]``, the merges checked to
    ``out[name + "_merges"]`` and the counts of reordered and near-tied
    chunks to ``out[name + "_reorders"]`` and ``out[name + "_dist_ties"]``.
    """
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    st = E.clone_state(tok.enh_state)
    dev = st.base.emb.device
    stats: Dict = {}
    total = 0
    ok = True
    for k in range(n_chunks):
        n0 = int(st.base.num_merges)
        st_k = enhanced_loop.run_chunk(
            E.clone_state(st), tok.enh_config, chunk,
            E.TorchSampler(seed + k, dev))
        st_x = enhanced_loop.run_chunk(
            E.clone_state(st), tok.enh_config, chunk,
            E.TorchSampler(seed + k, dev), plain=True)
        nk, nx = int(st_k.base.num_merges), int(st_x.base.num_merges)
        ok = _compare_chunks(
            st_k.base.merges[n0:nk].cpu().numpy(),
            st_k.base.merge_dists[n0:nk].cpu().numpy(),
            st_x.base.merges[n0:nx].cpu().numpy(),
            st_x.base.merge_dists[n0:nx].cpu().numpy(), stats)
        total = nx - int(tok.enh_state.base.num_merges)
        st = st_x  # oracle resync: noise never cascades across chunks
        if not ok or bool(st.base.stopped):
            break
    out[name] = "pass" if ok else f"FAIL {stats.get('first_bad')}"
    out[f"{name}_merges"] = total
    out[f"{name}_reorders"] = stats.get("reorders", 0)
    out[f"{name}_dist_ties"] = stats.get("dist_ties", 0)


def gram_error_bound(emb, rows, cols, d1: int):
    """Bound on the difference of two float32 evaluations of the Minkowski
    grams <x_r, x_c>: each is within gamma_n * sum_e |x_r,e x_c,e| of the
    exact value (gamma_n = n u / (1 - n u), n = d1 products, u = 2^-24),
    so two of them differ by at most twice that."""
    gamma = d1 * U32 / (1 - d1 * U32)
    mag = (emb[rows].abs() * emb[cols].abs()).sum(-1)
    return 2 * gamma * mag


def _geodesic64(x, y, w, d, c):
    """``lorentz.geodesic_point`` at a given distance ``d``, re-projected
    onto the sheet of curvature ``c``, in float64."""
    import torch

    from hyptokenizer_tpu_torch.ops import lorentz as L

    a = (1.0 - w) * d
    b = w * d
    num_x = torch.exp(-b) * (1.0 - torch.exp(-2.0 * a))
    num_y = torch.exp(-a) * (1.0 - torch.exp(-2.0 * b))
    den = torch.clamp_min(1.0 - torch.exp(-2.0 * d), L.EPS_NORM)
    out = (num_x[:, None] * x + num_y[:, None] * y) / den[:, None]
    out = torch.where((d < L.EXP_ZERO_TOL)[:, None], x, out)
    return L.project_to_hyperboloid(out, c)


def _compare_rows(emb_k, emb_p, lengths, pairs, v0: int, c,
                  row_atol: float):
    """The rows ``v0 + t`` that the merges ``pairs[t]`` made on both paths.

    A new row is the geodesic point of its pair at a distance computed from
    the pair's float32 gram, which each path rounds in its own order: the
    gram's :func:`gram_error_bound` ``B`` leaves that distance anywhere in
    [acosh(g - B), acosh(g + B)]. Each coordinate may differ by ``row_atol``
    plus the float64 geodesic point's change over that range. A pair far
    from the origin at a near-zero distance (a self-pair, whose gram is 1 up
    to rounding) is ill-conditioned and gets a wide tolerance; a resolved
    pair a tight one. Returns (max abs error, max error / tolerance)."""
    import torch

    if len(pairs) == 0:
        return 0.0, 0.0
    ci, cj = pairs[:, 0].long(), pairs[:, 1].long()
    slots = v0 + torch.arange(len(pairs), device=emb_p.device)
    d1 = emb_p.shape[1]
    x, y = emb_p[ci].double(), emb_p[cj].double()
    sig = torch.ones(d1, dtype=torch.float64, device=emb_p.device)
    sig[1:] = -1.0
    g = (x * sig * y).sum(-1)
    bound = gram_error_bound(emb_p, ci, cj, d1).double()
    li, lj = lengths[ci].double(), lengths[cj].double()
    w = lj / torch.clamp_min(li + lj, 1.0)
    c64 = c.double()
    lo = _geodesic64(x, y, w, torch.acosh(torch.clamp_min(g - bound, 1.0)),
                     c64)
    hi = _geodesic64(x, y, w, torch.acosh(torch.clamp_min(g + bound, 1.0)),
                     c64)
    tol = row_atol + (hi - lo).abs().max(-1).values
    err = (emb_k[slots] - emb_p[slots]).abs().max(-1).values.double()
    return float(err.max()), float((err / tol).max())


def _compare_candidates(base_k, base_p, stats) -> bool:
    """The candidate arrays of two merge states with the same rows: every
    row keeps a candidate on both or on neither, and the two candidates'
    grams agree within :func:`gram_error_bound` (a different partner is
    allowed only as such a tie). Updates ``stats``; returns agreement."""
    import torch

    bk, jk = base_k.best_dist, base_k.best_j
    bp, jp = base_p.best_dist, base_p.best_j
    fin = torch.isfinite(bp)
    if not torch.equal(torch.isfinite(bk), fin):
        stats["first_bad"] = {"candidates": "rows without a candidate differ"}
        return False
    rows = torch.nonzero(fin).flatten()
    emb = base_p.emb
    sc = torch.sqrt(base_p.curvature.double())
    gap = (torch.cosh(bk[rows].double() * sc)
           - torch.cosh(bp[rows].double() * sc)).abs()
    bound = torch.maximum(
        gram_error_bound(emb, rows, jk[rows].long(), emb.shape[1]),
        gram_error_bound(emb, rows, jp[rows].long(), emb.shape[1])).double()
    ratio = float((gap / bound).max()) if rows.numel() else 0.0
    stats["gram_gap_over_bound"] = max(stats.get("gram_gap_over_bound", 0.0),
                                       ratio)
    stats["partner_ties"] = stats.get("partner_ties", 0) + int(
        (jk[rows] != jp[rows]).sum())
    if ratio > 1.0:
        worst = int(rows[torch.argmax(gap / bound)])
        stats["first_bad"] = {
            "candidate_row": worst,
            "kernel": [float(bk[worst]), int(jk[worst])],
            "plain": [float(bp[worst]), int(jp[worst])]}
        return False
    return True


def _refold(pre, post, pairs, max_token_len: int):
    """The plain version's invalidation and column fold for the merges
    ``pairs``, applied to the candidates of the pre-step state ``pre`` over
    the rows of ``post`` (the kernel's): the fold the kernel should have
    made on its own rows."""
    import dataclasses

    import torch

    from hyptokenizer_tpu_torch.tokenizer import state as state_lib

    ref = dataclasses.replace(pre, emb=post.emb, lengths=post.lengths,
                              best_dist=pre.best_dist.clone(),
                              best_j=pre.best_j.clone())
    if len(pairs):
        slots = int(pre.vocab_size) + torch.arange(len(pairs),
                                                   device=pre.emb.device)
        state_lib._fold_columns(ref, pairs[:, 0].long(), pairs[:, 1].long(),
                                slots, max_token_len)
    return ref


def _lockstep_steps(tok, n_segments: int, out: Dict, name: str,
                    seed: int = 0, row_atol: float = 1e-5) -> None:
    """Hold the segment kernel of ``tok``'s configuration to its plain
    version step by step over ``n_segments`` segments (each up to the next
    curvature event), on ``tok``'s device, from one sync of ``tok``'s
    state. Each step: one kernel launch of one step and one plain step from
    the plain version's state; the loop scalars must be equal and the
    merges must agree as in :func:`_compare_chunks`; when the merges are
    the same, the new rows as in :func:`_compare_rows`, the token features
    exactly, and the candidate arrays as in :func:`_compare_candidates`
    against the plain fold over the kernel's own rows (:func:`_refold`).
    The run continues from the plain state. Writes ``out[name]`` ("pass" or
    "FAIL ..."), ``_merges``, ``_steps``, ``_reorders``, ``_dist_ties``,
    ``_partner_ties``, ``_row_err``, ``_row_err_over_tol`` and
    ``_gram_gap_over_bound``."""
    import torch

    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    cfg = tok.enh_config
    st = E.clone_state(tok.enh_state)
    dev = st.base.emb.device
    sampler = E.TorchSampler(seed, dev)
    st = E.sync_corpus(st, cfg, sampler)
    n0 = int(st.base.num_merges)
    freq = cfg.curvature_freq if cfg.use_adaptive_curvature else 0
    stats: Dict = {}
    steps = 0
    row_err = 0.0
    ok = True
    for _ in range(n_segments):
        if not ok:
            break
        if cfg.use_adaptive_curvature:
            st = E._maybe_update_curvature(st, cfg, sampler)
        sc = E.state_scalars(st)
        if sc["stopped"]:
            break
        curv_stop = ((sc["curv_last"] // freq + 1) * freq if freq > 0
                     else K.NO_CURVATURE_STOP)
        budgets = (K.NO_CURVATURE_STOP, K.NO_CURVATURE_STOP, curv_stop)
        while ok and not K._halted(sc, *budgets):
            sk = K.run_segment(E.clone_state(st), cfg, *budgets, None,
                               n_steps=1)
            sp = K.run_segment(E.clone_state(st), cfg, *budgets, None,
                               n_steps=1, plain=True)
            a, b = E.state_scalars(sk), E.state_scalars(sp)
            if a != b:
                stats["first_bad"] = {"step": sc["step"], "kernel": a,
                                      "plain": b}
                ok = False
                break
            lo, hi = sc["num_merges"], b["num_merges"]
            mk, mp = sk.base.merges[lo:hi], sp.base.merges[lo:hi]
            ok = _compare_chunks(
                mk.cpu().numpy(), sk.base.merge_dists[lo:hi].cpu().numpy(),
                mp.cpu().numpy(), sp.base.merge_dists[lo:hi].cpu().numpy(),
                stats)
            if ok and torch.equal(mk, mp):
                v0, v1 = sc["vocab_size"], b["vocab_size"]
                err, ratio = _compare_rows(sk.base.emb, sp.base.emb,
                                           st.base.lengths, mp, v0,
                                           st.base.curvature, row_atol)
                row_err = max(row_err, err)
                stats["row_err_over_tol"] = max(
                    stats.get("row_err_over_tol", 0.0), ratio)
                same = all(torch.equal(getattr(sk, f)[v0:v1],
                                       getattr(sp, f)[v0:v1])
                           for f in ("token_hash", "byte_lengths",
                                     "has_vowel"))
                same &= torch.equal(sk.base.lengths, sp.base.lengths)
                same &= torch.equal(sk.base.merge_dists[lo:hi],
                                    sp.base.merge_dists[lo:hi])
                if not same or ratio > 1.0:
                    stats["first_bad"] = {"step": sc["step"],
                                          "row_err": err,
                                          "row_err_over_tol": ratio,
                                          "features_equal": same}
                    ok = False
                elif K.uses_dense(cfg):
                    # The fold, on the kernel's own new rows (which may
                    # differ from the plain version's within their
                    # conditioning, above).
                    ok = _compare_candidates(
                        sk.base, _refold(st.base, sk.base, mp,
                                         cfg.base.max_token_len), stats)
            steps += 1
            st = sp   # oracle resync: noise never cascades across steps
            sc = b
        if sc["needs_resync"]:
            st = E.sync_corpus(st, cfg, sampler)
    out[name] = "pass" if ok else f"FAIL {stats.get('first_bad')}"
    out[f"{name}_merges"] = int(st.base.num_merges) - n0
    out[f"{name}_steps"] = steps
    for key in ("reorders", "dist_ties", "partner_ties"):
        out[f"{name}_{key}"] = stats.get(key, 0)
    out[f"{name}_row_err"] = row_err
    out[f"{name}_row_err_over_tol"] = stats.get("row_err_over_tol", 0.0)
    out[f"{name}_gram_gap_over_bound"] = stats.get("gram_gap_over_bound",
                                                   0.0)
