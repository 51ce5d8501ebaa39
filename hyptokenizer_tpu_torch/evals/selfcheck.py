"""Kernel checks: a kernel's merge sequence against its plain version's.

Port of ``hyptokenizer_tpu/evals/selfcheck.py`` (``GRAM_ATOL`` :45,
``_compare_chunks`` :48, ``_check_base_kernel`` :76, ``_lockstep_enhanced``
:115, ``_check_enhanced_kernel`` :147, ``_check_enhanced_full_features``
:172, ``kernel_selfcheck`` :195), with the port's plain PyTorch version as
the oracle in place of XLA. :func:`kernel_selfcheck` is the on-card report
that the port's bench, ``cli.test_torch --kernel-check`` and
``chip_smoke.py`` print.

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

:func:`_check_base_kernel` (kernel K4, the distance-only loop) and
:func:`_lockstep_enhanced` (K1, K2) are that protocol chunk by chunk, as
the JAX package runs it. :func:`_lockstep_steps` (K1, K2) and
:func:`_lockstep_base_steps` (K4) run it step by step: each kernel
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


def _geodesic_eval_error(x, y, w, d, c):
    """Bound on the error of ONE float32 evaluation of the re-projected
    geodesic point at distance ``d`` (float64 inputs, (n, d1) rows): the
    coefficients' exponentials carry 2 ulp each, and ``1 - exp(-2t)``
    turns that into a relative error of 2u e^{-2t} / (1 - e^{-2t}), large
    for a short geodesic; the time coordinate inherits the spatial errors
    through the projection (sqrt(c)-Lipschitz in the spatial norm) plus
    its sum's rounding."""
    import torch

    from hyptokenizer_tpu_torch.ops import lorentz as L

    u = U32

    def rel(t):
        e = torch.exp(-2.0 * t)
        return 2 * u * e / torch.clamp_min(1.0 - e, 1e-30)

    a = (1.0 - w) * d
    b = w * d
    num_x = torch.exp(-b) * (1.0 - torch.exp(-2.0 * a))
    num_y = torch.exp(-a) * (1.0 - torch.exp(-2.0 * b))
    den = torch.clamp_min(1.0 - torch.exp(-2.0 * d), L.EPS_NORM)
    r = torch.maximum(rel(a), rel(b)) + rel(d) + 7 * u
    terms = (num_x[:, None] * x.abs() + num_y[:, None] * y.abs()) \
        / den[:, None]
    sp = (terms * r[:, None])[:, 1:]
    v = (num_x[:, None] * x + num_y[:, None] * y)[:, 1:] / den[:, None]
    sq = (v * v).sum(-1)
    x0 = torch.sqrt(1.0 + c * sq)
    err0 = torch.sqrt(c) * sp.norm(dim=-1) + x.shape[1] * u * c * sq / x0
    err = torch.cat([err0[:, None], sp], dim=-1)
    return torch.where((d < L.EXP_ZERO_TOL)[:, None], 0.0, err)


def _compare_rows(emb_k, emb_p, lengths, pairs, v0: int, c,
                  row_atol: float, fp32_eval: bool = False):
    """The rows ``v0 + t`` that the merges ``pairs[t]`` made on both paths.

    A new row is the geodesic point of its pair at a distance computed from
    the pair's float32 gram, which each path rounds in its own order: the
    gram's :func:`gram_error_bound` ``B`` leaves that distance anywhere in
    [acosh(g - B), acosh(g + B)]. Each coordinate may differ by ``row_atol``
    plus the float64 geodesic point's change over that range. A pair far
    from the origin at a near-zero distance (a self-pair, whose gram is 1 up
    to rounding) is ill-conditioned and gets a wide tolerance; a resolved
    pair a tight one. With ``fp32_eval`` (the K4 check, whose states include
    short geodesics far from the origin), each coordinate may also differ
    by twice one float32 evaluation's error of the point at the pair's
    float64 distance (:func:`_geodesic_eval_error`). Returns (max abs
    error, max error / tolerance)."""
    import torch

    from hyptokenizer_tpu_torch.ops import lorentz as L

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
    spread = (hi - lo).abs()
    if fp32_eval:
        d = torch.acosh(torch.clamp_min(g, 1.0 + L.ACOSH_EPS))
        spread = spread + 2 * _geodesic_eval_error(x, y, w, d, c64)
    tol = row_atol + spread.max(-1).values
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
                    seed: int = 0, row_atol: float = 1e-5,
                    sync=None) -> None:
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
    ``_gram_gap_over_bound``. ``sync`` replaces
    ``enhanced_state.sync_corpus`` (same arguments), e.g. to lay the pair
    table out as the v3 sharded sync does."""
    import torch

    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    cfg = tok.enh_config
    sync = sync or E.sync_corpus
    st = E.clone_state(tok.enh_state)
    dev = st.base.emb.device
    sampler = E.TorchSampler(seed, dev)
    st = sync(st, cfg, sampler)
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
            st = sync(st, cfg, sampler)
    out[name] = "pass" if ok else f"FAIL {stats.get('first_bad')}"
    out[f"{name}_merges"] = int(st.base.num_merges) - n0
    out[f"{name}_steps"] = steps
    for key in ("reorders", "dist_ties", "partner_ties"):
        out[f"{name}_{key}"] = stats.get(key, 0)
    out[f"{name}_row_err"] = row_err
    out[f"{name}_row_err_over_tol"] = stats.get("row_err_over_tol", 0.0)
    out[f"{name}_gram_gap_over_bound"] = stats.get("gram_gap_over_bound",
                                                   0.0)


def clone_merge_state(st):
    """A ``MergeState`` whose tensors are copies (the loop updates its
    buffers in place)."""
    import dataclasses

    return dataclasses.replace(st, **{
        f.name: getattr(st, f.name).clone()
        for f in dataclasses.fields(st)})


def base_state(device, n0: int = 512, d: int = 100, max_v: int = 1024,
               threshold: float = 5.0, seed: int = 7, lengths=None,
               sigma: float = 0.5, **config):
    """The distance-only loop's state and configuration of
    :func:`_check_base_kernel`: ``n0`` points at ``sigma`` from a seeded
    generator (length-1 tokens unless ``lengths`` is given) in ``max_v``
    slots, candidates from the constructor's pass."""
    import torch

    from hyptokenizer_tpu_torch.ops import lorentz as L
    from hyptokenizer_tpu_torch.tokenizer import state as S

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    emb0 = L.random_points(gen, n0, d, sigma=sigma, device=device)
    if lengths is None:
        lengths = torch.ones((n0,), dtype=torch.int32)
    cfg = S.MergeConfig(max_vocab_size=max_v, search_block=256, **config)
    st = S.init_state(emb0, lengths, curvature=1.0, threshold=threshold,
                      config=cfg, device=device)
    return st, cfg


def _check_base_kernel(out: Dict, st=None, cfg=None, n_chunks: int = 10,
                       chunk: int = 25, name: str = "kernel_selfcheck",
                       device="cuda") -> None:
    """Kernel K4 (``state.run_merges`` on a card state) against its plain
    version ``run_merges_plain``, chunk by chunk from the same state with
    oracle resync, merges classified by :func:`_compare_chunks`. By default
    the JAX package's sizes: 512 points at d=100, 1024 slots, threshold 5,
    10 chunks of 25 steps. Writes ``out[name]`` ("pass" or "FAIL ..."),
    ``out[name + "_merges"]`` and, when any, ``out[name + "_ties"]``."""
    from hyptokenizer_tpu_torch.tokenizer import state as S

    if st is None:
        st, cfg = base_state(device)
    stats: Dict = {}
    total = 0
    ok = True
    n_start = int(st.num_merges)
    for _ in range(n_chunks):
        n0 = int(st.num_merges)
        st_k = S.run_merges(clone_merge_state(st), cfg, chunk)
        st_x = S.run_merges_plain(clone_merge_state(st), cfg, chunk)
        nk, nx = int(st_k.num_merges), int(st_x.num_merges)
        ok = _compare_chunks(
            st_k.merges[n0:nk].cpu().numpy(),
            st_k.merge_dists[n0:nk].cpu().numpy(),
            st_x.merges[n0:nx].cpu().numpy(),
            st_x.merge_dists[n0:nx].cpu().numpy(), stats)
        total = nx - n_start
        st = st_x  # oracle resync: noise never cascades across chunks
        if not ok or bool(st.stopped):
            break
    out[name] = "pass" if ok else f"FAIL {stats.get('first_bad')}"
    out[f"{name}_merges"] = total
    if stats.get("reorders") or stats.get("dist_ties"):
        out[f"{name}_ties"] = (f"reorders={stats.get('reorders', 0)} "
                               f"dist_ties={stats.get('dist_ties', 0)}")


BASE_SCALARS = ("vocab_size", "num_merges", "step", "threshold",
                "empty_rounds", "stopped")


def _lockstep_base_steps(st, cfg, n_steps: int, out: Dict, name: str,
                         row_atol: float = 1e-5, kernel=None) -> None:
    """Kernel K4 against ``run_merges_plain`` step by step from ``st``
    (left untouched): each step, one launch of ONE step and one plain step
    from the plain version's state. The loop scalars must be equal; the
    merged pair equal, or a tie within the two pairs' gram rounding bounds
    (:func:`gram_error_bound`); when equal, the merge distance exactly, the
    new row as in :func:`_compare_rows`, and the candidates as in
    :func:`_compare_candidates` against the plain fold re-run on the
    kernel's own rows (:func:`_refold`). The run continues from the plain
    state. Writes ``out[name]`` ("pass" or "FAIL ..."), ``_merges``,
    ``_steps``, ``_pair_ties``, ``_partner_ties``, ``_row_err``,
    ``_row_err_over_tol`` and ``_gram_gap_over_bound``. ``kernel`` (a
    ``(state, config, n_steps)`` function) defaults to K4's wrapper."""
    import torch

    from hyptokenizer_tpu_torch.ops.cuda import merge_loop
    from hyptokenizer_tpu_torch.tokenizer import state as S

    if kernel is None:
        kernel = merge_loop.run_merges_chunk

    stats: Dict = {}
    steps = 0
    row_err = 0.0
    ok = True
    n_start = int(st.num_merges)
    d1 = st.emb.shape[1]
    while ok and steps < n_steps and not bool(st.stopped):
        sk = kernel(clone_merge_state(st), cfg, 1)
        sp = S.run_merges_plain(clone_merge_state(st), cfg, 1)
        a = [getattr(sk, f).item() for f in BASE_SCALARS]
        b = [getattr(sp, f).item() for f in BASE_SCALARS]
        steps += 1
        if a != b:
            stats["first_bad"] = {"step": int(st.step), "kernel": a,
                                  "plain": b}
            ok = False
            break
        nm = int(st.num_merges)
        if int(sp.num_merges) > nm:
            pk, pp = sk.merges[nm], sp.merges[nm]
            v0 = int(st.vocab_size)
            if not torch.equal(pk, pp):
                rows = torch.stack([pk[0], pp[0]]).long()
                cols = torch.stack([pk[1], pp[1]]).long()
                e64 = st.emb.double()
                sig = torch.ones(d1, dtype=torch.float64, device=e64.device)
                sig[1:] = -1.0
                g = (e64[rows] * sig * e64[cols]).sum(-1)
                bound = gram_error_bound(st.emb, rows, cols, d1).sum()
                if float((g[0] - g[1]).abs()) > float(bound):
                    stats["first_bad"] = {"step": int(st.step),
                                          "kernel": pk.tolist(),
                                          "plain": pp.tolist()}
                    ok = False
                stats["pair_ties"] = stats.get("pair_ties", 0) + 1
            else:
                err, ratio = _compare_rows(sk.emb, sp.emb, st.lengths,
                                           pp[None], v0, st.curvature,
                                           row_atol, fp32_eval=True)
                row_err = max(row_err, err)
                stats["row_err_over_tol"] = max(
                    stats.get("row_err_over_tol", 0.0), ratio)
                same = torch.equal(sk.lengths, sp.lengths) and \
                    torch.equal(sk.merge_dists[nm], sp.merge_dists[nm])
                if not same or ratio > 1.0:
                    stats["first_bad"] = {"step": int(st.step),
                                          "row_err": err,
                                          "row_err_over_tol": ratio,
                                          "bookkeeping_equal": same}
                    ok = False
                else:
                    ok = _compare_candidates(
                        sk, _refold(st, sk, pp[None], cfg.max_token_len),
                        stats)
        st = sp   # oracle resync: noise never cascades across steps
    out[name] = "pass" if ok else f"FAIL {stats.get('first_bad')}"
    out[f"{name}_merges"] = int(st.num_merges) - n_start
    out[f"{name}_steps"] = steps
    for key in ("pair_ties", "partner_ties"):
        out[f"{name}_{key}"] = stats.get(key, 0)
    out[f"{name}_row_err"] = row_err
    out[f"{name}_row_err_over_tol"] = stats.get("row_err_over_tol", 0.0)
    out[f"{name}_gram_gap_over_bound"] = stats.get("gram_gap_over_bound",
                                                   0.0)


def pad_dense_state(st, n_rows: int, seed: int = 11, sigma: float = 0.5):
    """A copy of the enhanced state ``st`` with its active prefix padded to
    ``n_rows`` rows, for holding the dense kernel K2 at a deep vocabulary:
    the new points drawn at ``sigma`` from a generator seeded with
    ``seed``, on the state's sheet; length and byte length 1, no vowel,
    token hashes distinct from each other and from the state's, drawn from
    the same generator; ``best_dist``/``best_j`` over the whole prefix
    recomputed by kernel K3 (its plain version for a CPU state)."""
    import torch

    from hyptokenizer_tpu_torch.ops import lorentz as L
    from hyptokenizer_tpu_torch.ops.cuda import pairwise
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E
    from hyptokenizer_tpu_torch.tokenizer import scoring

    st = E.clone_state(st)
    base = st.base
    v0 = int(base.vocab_size)
    max_v, d1 = base.emb.shape
    if not v0 <= n_rows <= max_v:
        raise ValueError(f"cannot pad {v0} active rows to {n_rows} in "
                         f"{max_v} slots")
    n = n_rows - v0
    dev = base.emb.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    c = base.curvature
    base.emb[v0:n_rows] = L.random_points(gen, n, d1 - 1, c=c, sigma=sigma,
                                          device=dev)
    base.lengths[v0:n_rows] = 1
    st.byte_lengths[v0:n_rows] = 1
    st.has_vowel[v0:n_rows] = False
    p2 = scoring.HASH_P2
    have = (st.token_hash[:v0, 0].long() * p2 + st.token_hash[:v0, 1].long())
    keys = torch.randint(0, scoring.HASH_P1 * p2, (2 * n + 64,),
                         generator=gen, device=dev)
    keys = torch.unique(keys)
    keys = keys[torch.randperm(keys.numel(), generator=gen, device=dev)]
    keys = keys[~torch.isin(keys, have)][:n]
    if keys.numel() < n:
        raise RuntimeError("too few distinct token hashes were drawn")
    st.token_hash[v0:n_rows, 0] = (keys // p2).int()
    st.token_hash[v0:n_rows, 1] = (keys % p2).int()
    base.best_dist, base.best_j = pairwise.pairwise_min_best(base.emb,
                                                             n_rows, c)
    base.vocab_size = torch.tensor(n_rows, dtype=torch.int32, device=dev)
    return st


def _enhanced_selfcheck_tokenizer(corpus, seed: int, device, **features):
    """The JAX package's selfcheck tokenizer (selfcheck.py:161-172 and
    :186-194): the characters of ``corpus`` behind the four specials, points
    at d=16 and sigma 0.6 from a generator seeded with ``seed``, and the
    JAX constructor's arguments, with ``features`` (flags and weights)."""
    import torch

    from hyptokenizer_tpu_torch import _device
    from hyptokenizer_tpu_torch.ops import lorentz as L
    from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer

    dev = _device.resolve(device)
    chars = sorted({c for ln in corpus for c in ln})
    vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + chars
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    emb = L.random_points(gen, len(vocab), 16, sigma=0.6, device=dev)
    return EnhancedHyperbolicTokenizer(
        vocab, emb, merge_threshold=5.0, max_vocab_size=256,
        corpus_sample=corpus, corpus_max_tokens=1024, merge_batch=4,
        search_block=64, freq_table_size=1024, queue_size=128, seed=0,
        device=dev, **features)


def _check_enhanced_kernel(out: Dict, device="cuda") -> None:
    """Kernel K1 (the corpus-only segment) against its plain version, chunk
    by chunk (:func:`_lockstep_enhanced`, 4 chunks of 8 merges), on the JAX
    package's small corpus and configuration."""
    corpus = ["the cat sat on the mat", "the dog sat on the log",
              "a cat and a dog and a rat"] * 10
    tok = _enhanced_selfcheck_tokenizer(
        corpus, 1, device,
        use_dense_channel=False, use_hierarchical=False,
        use_adaptive_curvature=False, use_compression_aware=False,
        alpha=0.1, beta=0.85, gamma=0.05)
    _lockstep_enhanced(tok, 4, 8, out, "enhanced_kernel_selfcheck")


def _check_enhanced_full_features(out: Dict, device="cuda") -> None:
    """Kernel K2 (every feature on: frequency, hierarchical morphology,
    compression and the dense channel) against its plain version, chunk by
    chunk, on the JAX package's corpus and configuration; the constructor
    runs kernel K3."""
    corpus = ["walking dogs walk and walk the walking walk",
              "the walking dog was walking quickly"] * 8
    tok = _enhanced_selfcheck_tokenizer(
        corpus, 3, device,
        use_dense_channel=True, use_hierarchical=True,
        use_adaptive_curvature=False, use_compression_aware=True,
        alpha=0.3, beta=0.5, gamma=0.2)
    _lockstep_enhanced(tok, 4, 8, out, "enhanced_full_selfcheck")


# ------------------------------------------- the sync's scoring (kernel S1)

# The flagship's table (freq_table_size, d = 100, 50 coherence samples, the
# 50,176-slot vocabulary), and a small one for a check on the CPU, where
# both sides are the plain version.
SCORE_TABLE = dict(n_vocab=50_176, d=100, table_size=1 << 17,
                   n_pairs=100_000, n_samples=50)
SCORE_TABLE_SMALL = dict(n_vocab=512, d=16, table_size=2048, n_pairs=1500,
                         n_samples=50)
ACOSH_1ULP = float(np.arccosh(1.0 + 2.0 ** -23))  # least float32 distance > 0


def score_table_inputs(device, n_vocab: int, d: int, table_size: int,
                       n_pairs: int, n_samples: int, seed: int = 5,
                       sigma: float = 0.5, curvature: float = 1.3,
                       threshold: float = 0.1) -> Dict:
    """The keyword arguments of ``enhanced_state.score_candidates`` for a
    synthetic sync: ``n_vocab`` points at ``sigma`` (d + 1 coordinates, on
    the sheet of ``curvature``), lengths 1-8, and a lexicographically
    sorted table of ``n_pairs`` distinct pairs in ``table_size`` rows
    (sentinel padded; one pair in a hundred a self pair (a, a)), with
    heavy-tailed counts; morphology and word tables that hold the composed
    hashes of some of the pairs (``HKEY_SENT`` padded past their sizes);
    ``n_samples`` coherence samples, half of them ids of the table's pairs.
    Drawn on the CPU from a generator seeded with ``seed``, then moved to
    ``device``, so that every device gets the same inputs."""
    import torch

    from hyptokenizer_tpu_torch.ops import lorentz as L
    from hyptokenizer_tpu_torch.tokenizer import scoring

    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)

    def ints(low, high, shape):
        return torch.randint(low, high, shape, generator=gen,
                             dtype=torch.int32)

    emb = L.random_points(gen, n_vocab, d, c=curvature, sigma=sigma,
                          device="cpu")
    lengths = ints(1, 9, (n_vocab,))
    byte_lengths = lengths + ints(0, 2, (n_vocab,))
    has_vowel = torch.rand((n_vocab,), generator=gen) < 0.5
    token_hash = torch.stack([ints(0, scoring.HASH_P1, (n_vocab,)),
                              ints(0, scoring.HASH_P2, (n_vocab,))], dim=-1)
    hi = ints(0, n_vocab, (2 * n_pairs,)).long()
    lo = ints(0, n_vocab, (2 * n_pairs,)).long()
    lo = torch.where(torch.rand((2 * n_pairs,), generator=gen) < 0.01, hi,
                     lo)
    pk = torch.unique(hi * n_vocab + lo)
    pk = pk[torch.randperm(pk.numel(), generator=gen)[:n_pairs]]
    pk = torch.sort(pk).values
    n_real = pk.numel()
    keys = torch.full((table_size, 2), scoring.PKEY_SENT, dtype=torch.int32)
    keys[:n_real, 0] = (pk // n_vocab).int()
    keys[:n_real, 1] = (pk % n_vocab).int()
    counts = torch.zeros((table_size,), dtype=torch.int32)
    heavy = torch.rand((n_real,), generator=gen).clamp_min(1e-6) ** -1.5
    counts[:n_real] = heavy.clamp_max(1e6).int()
    powers = scoring.hash_powers()
    rows, cols = keys[:n_real, 0].long(), keys[:n_real, 1].long()
    merged = scoring.compose_hash(token_hash[rows], token_hash[cols],
                                  byte_lengths[cols], powers)
    composed = scoring.pack_hash(merged[:, 0], merged[:, 1])

    def table(share):
        hits = composed[torch.rand((n_real,), generator=gen) < share]
        other = ints(0, 2**31 - 1, (max(n_real // 10, 1),))
        keys_ = torch.unique(torch.cat([hits, other]))
        pad = torch.full((keys_.numel() // 4 + 1,), scoring.HKEY_SENT,
                         dtype=torch.int32)
        return torch.cat([keys_, pad]), keys_.numel()

    morph_table, morph_size = table(0.2)
    word_table, word_size = table(0.3)
    n_hit = n_samples // 2
    samples = torch.cat([
        keys[ints(0, max(n_real, 1), (n_hit,)).long(),
             ints(0, 2, (n_hit,)).long()],
        ints(0, n_vocab, (n_samples - n_hit,))])

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype)

    out = dict(
        emb=emb, lengths=lengths, threshold=scalar(threshold, torch.float32),
        curvature=scalar(curvature, torch.float32), coh_samples=samples,
        max_pair_count=counts.max(),
        corpus_tokens=scalar(2_900_000, torch.int32), token_hash=token_hash,
        byte_lengths=byte_lengths, has_vowel=has_vowel, hash_powers=powers,
        morph_table=morph_table, morph_size=scalar(morph_size, torch.int32),
        word_table=word_table, word_size=scalar(word_size, torch.int32),
        keys=keys, counts=counts)
    return {k: v.to(device) for k, v in out.items()}


def state_score_inputs(st) -> Dict:
    """The keyword arguments of ``enhanced_state.score_candidates`` that
    score the pair table of the synced enhanced state ``st``."""
    base = st.base
    return dict(
        emb=base.emb, lengths=base.lengths, threshold=base.threshold,
        curvature=base.curvature, coh_samples=st.coh_samples,
        max_pair_count=st.max_pair_count, corpus_tokens=st.corpus_tokens,
        token_hash=st.token_hash, byte_lengths=st.byte_lengths,
        has_vowel=st.has_vowel, hash_powers=st.hash_powers,
        morph_table=st.morph_table, morph_size=st.morph_size,
        word_table=st.word_table, word_size=st.word_size,
        keys=st.pair_keys, counts=st.pair_counts)


def score_tolerance(config, inputs: Dict):
    """How far two float32 evaluations of ``score_candidates`` on
    ``inputs`` may lie apart, per table row, in float64: (gram_tol (T,),
    score_tol (T,)).

    ``gram_tol`` bounds the gap of the two distances mapped back to the
    gram, |cosh(sqrt(c) d1) - cosh(sqrt(c) d2)|: the pair's Minkowski dot
    summed in two orders (:func:`gram_error_bound`) plus the log-form
    acosh's and the division's rounding (16 ulp of the distance, carried
    to the gram by its slope). Distances themselves cannot be held to a
    fixed tolerance: near the acosh's floor one ulp of the gram moves a
    distance by about 5e-4, and a self pair (a, a) far from the origin
    reads anywhere in [0, acosh(1 + gram_tol)].

    ``score_tol`` adds up the terms' own spreads, each weighted as the
    configuration weights it: the distance score over the distance's
    interval (``1 / (1 + d)`` is 1-Lipschitz); 8 ulp of the frequency term
    (``log1p`` on two libraries); and the coherence's sigmoid (slope at
    most 1/4) over the spread of the average distance to the samples. A
    sample's distance spreads by the acosh of its gram's interval: the
    midpoint's gram against the sample at the ends and the middle of the
    pair's distance interval, plus the gram's summation bound and the
    midpoint's coordinate rounding, which the float32 coefficients
    ``1 - exp(-2t)`` make large for a short geodesic (as
    :func:`_geodesic_eval_error`; a path's distance is 0 or at least
    ``ACOSH_1ULP``). The weighted sum's own rounding adds 24 ulp. A real
    fault (a wrong term, sample or weight) moves a score by far more."""
    import torch

    from hyptokenizer_tpu_torch.tokenizer import scoring

    u = U32
    keys, emb = inputs["keys"], inputs["emb"]
    valid = keys[:, 0] != scoring.PKEY_SENT
    rows = torch.where(valid, keys[:, 0], 0).long()
    cols = torch.where(valid, keys[:, 1], 0).long()
    d1 = emb.shape[1]
    x, y = emb[rows].double(), emb[cols].double()
    sig = torch.ones(d1, dtype=torch.float64, device=emb.device)
    sig[1:] = -1.0
    g = (x * sig * y).sum(-1)
    sc = torch.sqrt(inputs["curvature"].double())
    t_p = torch.acosh(torch.clamp_min(g, 1.0))
    gram_tol = (gram_error_bound(emb, rows, cols, d1).double()
                + 16 * u * (1 + t_p) * torch.clamp_min(g, 1.0))
    t_lo = torch.acosh(torch.clamp_min(g - gram_tol, 1.0))
    t_hi = torch.acosh(torch.clamp_min(g + gram_tol, 1.0))
    alpha, beta, gamma, _, _ = config.weights()
    tol = alpha * ((t_hi - t_lo) / sc + 4 * u) + 24 * u
    if config.use_frequency:
        counts = inputs["counts"].double()
        denom = torch.log1p(torch.clamp_min(
            inputs["max_pair_count"].double(), 1.0)).clamp_min(1e-9)
        tol = tol + beta * 8 * u * (torch.log1p(counts) / denom + 1)
        tol = tol + gamma * (0.25 * _coherence_spread(
            inputs, rows, cols, x, y, sig, sc, t_lo, t_p, t_hi) + 4 * u)
    return gram_tol, tol


def _coherence_spread(inputs, rows, cols, x, y, sig, sc, t_lo, t_p, t_hi):
    """:func:`score_tolerance`'s bound on the spread of the average
    distance from each row's midpoint to the samples, float64 (T,)."""
    import torch

    from hyptokenizer_tpu_torch.ops import lorentz as L
    from hyptokenizer_tpu_torch.tokenizer.enhanced_state import GRAD_EPS

    u = U32
    lengths = inputs["lengths"]
    s = inputs["coh_samples"].long()
    if s.numel() == 0:
        return torch.zeros_like(t_p)
    ys = inputs["emb"][s].double()
    d1 = x.shape[1]
    gamma_n = d1 * u / (1 - d1 * u)
    w = (lengths[cols].double()
         / torch.clamp_min(lengths[rows] + lengths[cols], 1).double())

    def mid(t):
        a, b = (1.0 - w) * t, w * t
        nx = torch.exp(-b) * (1.0 - torch.exp(-2.0 * a))
        ny = torch.exp(-a) * (1.0 - torch.exp(-2.0 * b))
        den = torch.clamp_min(1.0 - torch.exp(-2.0 * t), L.EPS_NORM)
        m = (nx[:, None] * x + ny[:, None] * y) / den[:, None]
        return torch.where((t < L.EXP_ZERO_TOL)[:, None], x, m)

    def rel(t):
        e = torch.exp(-2.0 * t)
        return 2 * u * e / torch.clamp_min(1.0 - e, 1e-30)

    grams = [(mid(t) * sig) @ ys.T for t in (t_lo, t_p, t_hi)]
    g_min = torch.minimum(torch.minimum(grams[0], grams[1]), grams[2])
    g_max = torch.maximum(torch.maximum(grams[0], grams[1]), grams[2])
    # A coordinate of the midpoint is at most |x_k| + |y_k| (both
    # coefficients over the denominator are at most 1); its float32
    # evaluation errs by (r + 2u) times that.
    t_f = torch.clamp_min(t_lo, ACOSH_1ULP)
    r = torch.maximum(rel((1.0 - w) * t_f), rel(w * t_f)) + rel(t_f) + 9 * u
    size = (x.abs() + y.abs()) @ ys.abs().T
    err = gamma_n * size + r[:, None] * size
    floor = float(np.float32(1.0 + GRAD_EPS))
    lo = torch.acosh(torch.clamp_min(g_min - err, floor))
    hi = torch.acosh(torch.clamp_min(g_max + err, floor))
    width = (hi - lo + 16 * u * (1 + hi)) / sc
    not_self = (s[None, :] != rows[:, None]) & (s[None, :] != cols[:, None])
    cnt = torch.clamp_min(not_self.sum(1), 1).double()
    spread = torch.where(not_self, width, 0.0).sum(1) / cnt
    mean_hi = torch.where(not_self, hi / sc, 0.0).sum(1) / cnt
    return spread + 2 * s.numel() * u * mean_hi


def compare_scores(got, want, tol, curvature) -> Dict:
    """Two ``score_candidates`` results ``(scores (P, T), dists (T,))``
    against :func:`score_tolerance`'s ``tol``: the candidate masks (-inf
    scores) and the sentinel rows (inf distances) must be equal; returns
    them with the largest gaps and the largest gaps over their
    tolerances (each at most 1 for a pass) of the distances (in gram
    space) and the scores."""
    import torch

    gs, gd = got
    ws, wd = want
    gram_tol, score_tol = tol
    masks = (gs.shape == ws.shape and torch.equal(gs == -np.inf, ws == -np.inf)
             and torch.equal(torch.isfinite(gd), torch.isfinite(wd))
             and not bool(torch.isnan(gs).any() or torch.isnan(gd).any()))
    out = {"masks_equal": bool(masks)}
    if not masks:
        return out
    fin = torch.isfinite(wd)
    sc = torch.sqrt(curvature.double())
    gap = (torch.cosh(gd[fin].double() * sc)
           - torch.cosh(wd[fin].double() * sc)).abs()
    live = ws > -np.inf
    sgap = torch.where(live, (gs.double() - ws.double()).abs(), 0.0)
    out.update(
        dist_max_gap=float((gd[fin] - wd[fin]).abs().max())
        if fin.any() else 0.0,
        dist_gap_over_tol=float((gap / gram_tol[fin]).max())
        if fin.any() else 0.0,
        score_max_gap=float(sgap.max()) if live.any() else 0.0,
        score_gap_over_tol=float((sgap / score_tol[None, :]).max())
        if live.any() else 0.0,
        candidates=int(live[0].sum()))
    return out


def compare_queues(got, want, keys, score_tol) -> Dict:
    """Two syncs' queues ``(q_i, q_j, q_score)`` (each (3, K)) of one
    lexicographically sorted pair table ``keys``: the same number of
    stored entries in each phase, and entry for entry the same pair with
    scores within the pair's tolerance, or, where the pairs differ (a
    near-tie ordered otherwise), scores within the two pairs' tolerances
    added. Returns ``ok``, the entries that differ and the largest gap
    over its tolerance."""
    import torch

    from hyptokenizer_tpu_torch.tokenizer import scoring

    table = scoring._key64(keys[:, 0], keys[:, 1])

    def row(qi, qj):
        at = torch.searchsorted(table, scoring._key64(qi, qj))
        return torch.clamp_max(at, table.numel() - 1)

    gi, gj, gs = got
    wi, wj, ws = want
    stored = ws > -np.inf
    ok = torch.equal(gs > -np.inf, stored)
    same = (gi == wi) & (gj == wj)
    rg, rw = row(gi, gj), row(wi, wj)
    allow = torch.where(same, score_tol[rw],
                        score_tol[rg] + score_tol[rw])
    gap = torch.where(stored, (gs.double() - ws.double()).abs(), 0.0)
    ratio = float((gap / allow).max()) if bool(stored.any()) else 0.0
    return {"ok": bool(ok) and ratio <= 1.0,
            "differ": int((~same & stored).sum()), "gap_over_tol": ratio}


def _check_sync_score(out: Dict, device="cuda") -> None:
    """Kernel S1 (``enhanced_state.score_candidates`` on the card) against
    its plain version on the same device, on a synthetic flagship-sized
    table (:data:`SCORE_TABLE`; :data:`SCORE_TABLE_SMALL` on the CPU,
    where both sides are the plain version), in the flagship's
    configuration (frequency and coherence) and in the Quick start's
    (every feature, the curriculum's three phases) with
    ``min_pair_freq`` 2 and ``max_token_len`` 6: masks exact, distances
    and scores within :func:`score_tolerance`, and the queues
    (``top_k_desc``, ``queue_size`` 4096) within :func:`compare_queues`."""
    import torch

    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E
    from hyptokenizer_tpu_torch.tokenizer import scoring
    from hyptokenizer_tpu_torch.tokenizer.state import MergeConfig

    name = "sync_score_selfcheck"
    dev = torch.device(device)
    sizes = SCORE_TABLE if dev.type == "cuda" else SCORE_TABLE_SMALL
    inputs = score_table_inputs(dev, **sizes)
    configs = {
        "flagship": E.EnhancedConfig(use_frequency=True, alpha=0.05,
                                     beta=0.9, gamma=0.05),
        "quickstart": E.EnhancedConfig(
            base=MergeConfig(max_token_len=6), use_frequency=True,
            use_compression=True, compression_weight=0.7,
            use_hierarchical=True, min_pair_freq=2)}
    verdict = "pass"
    worst = {"score_gap": 0.0, "score_gap_over_tol": 0.0,
             "dist_gap_over_tol": 0.0, "queue_differ": 0}
    for cname, cfg in configs.items():
        got = E.score_candidates(cfg, **inputs)
        want = E.score_candidates_plain(cfg, **inputs)
        tol = score_tolerance(cfg, inputs)
        cmp = compare_scores(got, want, tol, inputs["curvature"])
        k = 4096
        queues = [scoring.top_k_desc(s, k) for s in (got[0], want[0])]
        q = [(inputs["keys"][p, 0], inputs["keys"][p, 1], v)
             for v, p in queues]
        qcmp = compare_queues(q[0], q[1], inputs["keys"], tol[1])
        if not cmp["masks_equal"]:
            verdict = f"FAIL {cname}: candidate masks differ"
        elif max(cmp["score_gap_over_tol"], cmp["dist_gap_over_tol"]) > 1.0 \
                or not qcmp["ok"]:
            verdict = f"FAIL {cname}: {cmp} queues {qcmp}"
        if verdict != "pass":
            break
        worst["score_gap"] = max(worst["score_gap"], cmp["score_max_gap"])
        worst["score_gap_over_tol"] = max(worst["score_gap_over_tol"],
                                          cmp["score_gap_over_tol"])
        worst["dist_gap_over_tol"] = max(worst["dist_gap_over_tol"],
                                         cmp["dist_gap_over_tol"])
        worst["queue_differ"] += qcmp["differ"]
    out[name] = verdict
    out[f"{name}_rows"] = int(inputs["keys"].shape[0])
    for key, val in worst.items():
        out[f"{name}_{key}"] = val


# Each verdict's name and the check that writes it.
SELFCHECKS = (("kernel_selfcheck", "_check_base_kernel"),
              ("enhanced_kernel_selfcheck", "_check_enhanced_kernel"),
              ("enhanced_full_selfcheck", "_check_enhanced_full_features"),
              ("sync_score_selfcheck", "_check_sync_score"))


def kernel_selfcheck(device="cuda") -> Dict:
    """Every kernel against its plain version on the card: K4
    (:func:`_check_base_kernel`), K1 (:func:`_check_enhanced_kernel`), K2
    and K3 (:func:`_check_enhanced_full_features`), S1
    (:func:`_check_sync_score`).

    A report: each check records "pass", "FAIL ..." or "error: ..." under
    its name, and a check that raises never discards another's verdict.
    Without a CUDA device it returns ``{"kernel_selfcheck": "skipped (no
    CUDA device)"}`` (the kernels run only there); the callers decide what a
    verdict other than "pass" means. ``device="cpu"`` runs the same checks
    with the plain version on both sides."""
    import torch

    if torch.device(device).type == "cuda" and \
            not torch.cuda.is_available():
        return {"kernel_selfcheck": "skipped (no CUDA device)"}
    out: Dict = {}
    for name, check in SELFCHECKS:
        try:
            globals()[check](out, device=device)
        except Exception as e:  # record, keep going
            msg = str(e).splitlines()[0][:200] if str(e) else repr(e)[:200]
            out[name] = f"error: {msg}"
    return out


def selfcheck_failures(report: Dict) -> Dict:
    """The verdicts of a :func:`kernel_selfcheck` report that are not
    "pass" (the skip verdict included)."""
    return {name: report.get(name, "missing") for name, _ in SELFCHECKS
            if report.get(name) != "pass"}
