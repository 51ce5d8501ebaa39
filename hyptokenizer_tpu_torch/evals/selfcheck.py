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


# Each verdict's name and the check that writes it.
SELFCHECKS = (("kernel_selfcheck", "_check_base_kernel"),
              ("enhanced_kernel_selfcheck", "_check_enhanced_kernel"),
              ("enhanced_full_selfcheck", "_check_enhanced_full_features"))


def kernel_selfcheck(device="cuda") -> Dict:
    """Every kernel against its plain version on the card: K4
    (:func:`_check_base_kernel`), K1 (:func:`_check_enhanced_kernel`), K2
    and K3 (:func:`_check_enhanced_full_features`).

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
