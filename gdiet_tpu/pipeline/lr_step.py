"""Device stages of the long-read pipeline.

Reuses the shared hit-collection front (device_step.collect_hits) and adds
the long-read voting scans as lax.scans over the concatenated fwd/rev hit
stream:

  * ``_vote_scan_lr`` — round-1 vote (GDiet-LongReads/map.c:1052-1180):
    coverage-gated runs, raw-target span tracking via the inverse diagonal
    projection, score-sorted top-K insertion (no threshold, no recovery).
  * ``_vote2_scan`` — round-2 vote (map.c:1182-1271): best run constrained
    to a query window (lo, hi), counting only in-window hits.

The hit stream (keys/qpos/valid) is returned by ``lr_front`` as device
arrays so the round-2 scan reruns on device without re-uploading anything.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import jax.numpy as jnp

from gdiet_tpu.pipeline.device_step import StepConfig, collect_hits

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)  # np: a module-level jnp constant would initialize the backend at import (breaks jax.distributed)
U32 = 0xFFFFFFFF
I64 = jnp.int64


def _raw_target(t, q, sgn, extracted):
    """Inverse diagonal projection: the hit's raw genomic anchor
    (map.c:1064-1065). u64 wraparound semantics."""
    qq = q.astype(jnp.uint64)
    ex = extracted.astype(jnp.uint64)
    return jnp.where(sgn != 0, t - qq, t - (ex - qq))


@partial(jax.jit, static_argnames=("K",))
def _vote_scan_lr(
    keys: jnp.ndarray,  # [B, M] u64 projected targets (stream order)
    qpos: jnp.ndarray,  # [B, M] i32
    valid: jnp.ndarray,  # [B, M] bool
    strand: jnp.ndarray,  # [M] i32
    extracted: jnp.ndarray,  # [B] i64
    vt_distance: jnp.ndarray,  # [B] u64
    cov_thr: jnp.ndarray,  # [B] i32 coverage threshold
    K: int,
):
    B, M = keys.shape
    i32 = jnp.int32

    state = {
        "head_valid": jnp.zeros((B,), bool),
        "head_str": jnp.zeros((B,), i32),
        "ref_loc": jnp.zeros((B,), jnp.uint64),
        "first_t": jnp.zeros((B,), jnp.uint64),
        "last_t": jnp.zeros((B,), jnp.uint64),
        "fq": jnp.zeros((B,), i32),
        "lq": jnp.zeros((B,), i32),
        "cnt": jnp.zeros((B,), i32),
        "k_score": jnp.full((B, K), -1, i32),
        "k_first_t": jnp.zeros((B, K), jnp.uint64),
        "k_last_t": jnp.zeros((B, K), jnp.uint64),
        "k_fq": jnp.zeros((B, K), i32),
        "k_lq": jnp.zeros((B, K), i32),
        "k_str": jnp.zeros((B, K), i32),
        "out_len": jnp.zeros((B,), i32),
    }

    def emit(st, do_emit):
        # lq >= fq by construction, so plain i32 subtraction implements the
        # uint32 coverage gate (map.c:1095)
        cov = (st["lq"] - st["fq"]) > cov_thr
        passes = do_emit & cov
        full = st["out_len"] == K
        reject = passes & full & (st["k_score"][:, K - 1] >= st["cnt"])
        insert = passes & ~reject
        pos = jnp.where(full, K - 1, st["out_len"])
        slot = jnp.arange(K, dtype=i32)[None, :] == pos[:, None]
        upd = insert[:, None] & slot

        def put(arr, val):
            return jnp.where(upd, val[:, None], arr)

        ks = put(st["k_score"], st["cnt"])
        kft = put(st["k_first_t"], st["first_t"])
        klt = put(st["k_last_t"], st["last_t"])
        kf = put(st["k_fq"], st["fq"])
        kl = put(st["k_lq"], st["lq"])
        kr = put(st["k_str"], st["head_str"])
        for kk in range(K - 1, 0, -1):
            swap = insert & (ks[:, kk] > ks[:, kk - 1])

            def sw(arr):
                a, b = arr[:, kk - 1], arr[:, kk]
                arr = arr.at[:, kk].set(jnp.where(swap, a, arr[:, kk]))
                arr = arr.at[:, kk - 1].set(jnp.where(swap, b, arr[:, kk - 1]))
                return arr

            ks, kft, klt, kf, kl, kr = (
                sw(ks), sw(kft), sw(klt), sw(kf), sw(kl), sw(kr)
            )
        st = dict(st)
        st.update(
            k_score=ks, k_first_t=kft, k_last_t=klt, k_fq=kf, k_lq=kl,
            k_str=kr,
            out_len=jnp.where(insert & ~full, st["out_len"] + 1, st["out_len"]),
        )
        return st

    def step(st, inp):
        t, q, ok, sgn = inp
        raw = _raw_target(t, q, sgn, extracted)
        in_run = (
            st["head_valid"]
            & ok
            & (sgn == st["head_str"])
            & ((t - st["ref_loc"]) <= vt_distance)
        )
        q_lt = q < st["fq"]
        new_fq = jnp.where(q_lt, q, st["fq"])
        new_ref = jnp.where(q_lt, t, st["ref_loc"])
        new_lq = jnp.maximum(st["lq"], q)
        new_ft = jnp.minimum(st["first_t"], raw)
        new_lt = jnp.maximum(st["last_t"], raw)
        brk = st["head_valid"] & ~in_run
        st2 = emit(st, brk)
        st2["ref_loc"] = jnp.where(in_run, new_ref, t)
        st2["first_t"] = jnp.where(in_run, new_ft, raw)
        st2["last_t"] = jnp.where(in_run, new_lt, raw)
        st2["fq"] = jnp.where(in_run, new_fq, q)
        st2["lq"] = jnp.where(in_run, new_lq, q)
        st2["cnt"] = jnp.where(in_run, st["cnt"] + 1, 1)
        st2["head_valid"] = jnp.where(in_run, True, ok)
        st2["head_str"] = jnp.where(in_run, st["head_str"], sgn)
        return st2, None

    final, _ = jax.lax.scan(step, state, (keys.T, qpos.T, valid.T, strand))
    final = emit(final, final["head_valid"])
    return {k: v for k, v in final.items() if k.startswith(("k_", "out_len"))}


@jax.jit
def _vote2_scan(
    keys: jnp.ndarray,  # [B, M] u64
    qpos: jnp.ndarray,  # [B, M] i32
    valid: jnp.ndarray,  # [B, M] bool
    strand: jnp.ndarray,  # [M] i32
    extracted: jnp.ndarray,  # [B] i64
    vt_distance: jnp.ndarray,  # [B] u64
    lo: jnp.ndarray,  # [B] i32 window (exclusive)
    hi: jnp.ndarray,  # [B] i32 window (exclusive)
):
    """vote_2 (map.c:1182-1271): best window-constrained run per read."""
    B, M = keys.shape
    i32 = jnp.int32

    state = {
        "head_valid": jnp.zeros((B,), bool),
        "head_str": jnp.zeros((B,), i32),
        "ref_loc": jnp.zeros((B,), jnp.uint64),
        "first_t": jnp.zeros((B,), jnp.uint64),
        "last_t": jnp.zeros((B,), jnp.uint64),
        "fq": jnp.zeros((B,), i32),
        "lq": jnp.zeros((B,), i32),
        "cnt": jnp.zeros((B,), i32),
        "b_score": jnp.zeros((B,), i32),
        "b_first_t": jnp.zeros((B,), jnp.uint64),
        "b_last_t": jnp.zeros((B,), jnp.uint64),
        "b_fq": jnp.zeros((B,), i32),
        "b_lq": jnp.zeros((B,), i32),
        "b_str": jnp.zeros((B,), i32),
    }

    def consider(st, do_emit):
        better = (
            do_emit & (st["cnt"] > st["b_score"]) & (st["lq"] < hi)
            & (st["fq"] > lo)
        )
        st = dict(st)
        for dst, src in (("b_score", "cnt"), ("b_first_t", "first_t"),
                         ("b_last_t", "last_t"), ("b_fq", "fq"),
                         ("b_lq", "lq"), ("b_str", "head_str")):
            st[dst] = jnp.where(better, st[src], st[dst])
        return st

    def step(st, inp):
        t, q, ok, sgn = inp
        raw = _raw_target(t, q, sgn, extracted)
        in_run = (
            st["head_valid"]
            & ok
            & (sgn == st["head_str"])
            & ((t - st["ref_loc"]) <= vt_distance)
        )
        in_win = in_run & (q < hi) & (q > lo)
        q_lt = in_win & (q < st["fq"])
        brk = st["head_valid"] & ~in_run
        st2 = consider(st, brk)
        st2["ref_loc"] = jnp.where(in_run, jnp.where(q_lt, t, st["ref_loc"]), t)
        st2["first_t"] = jnp.where(
            in_run, jnp.where(in_win, jnp.minimum(st["first_t"], raw), st["first_t"]), raw
        )
        st2["last_t"] = jnp.where(
            in_run, jnp.where(in_win, jnp.maximum(st["last_t"], raw), st["last_t"]), raw
        )
        st2["fq"] = jnp.where(in_run, jnp.where(q_lt, q, st["fq"]), q)
        st2["lq"] = jnp.where(
            in_run, jnp.where(in_win, jnp.maximum(st["lq"], q), st["lq"]), q
        )
        st2["cnt"] = jnp.where(in_run, st["cnt"] + jnp.where(in_win, 1, 0), 1)
        st2["head_valid"] = jnp.where(in_run, True, ok)
        st2["head_str"] = jnp.where(in_run, st["head_str"], sgn)
        return st2, None

    final, _ = jax.lax.scan(step, state, (keys.T, qpos.T, valid.T, strand))
    final = consider(final, final["head_valid"])
    return {k: v for k, v in final.items() if k.startswith("b_")}


def _lr_filters_device(vt, lens, cov_thr, k, vt_df1, vt_f, bw, K):
    """Density filter 1 + relative filter + boundary adjustment + round-2
    window computation on device (map.c:1355-1445, the oracle's
    apply_filters). Bit-compatible with the host version: f32 products,
    u32 wraparound, i32 sign casts.

    Returns (kept_len [B], score, fq (u32 bits), lq, str, chrom,
    ft (i32), lt (i32 bits), lt_unsigned flag, lo1, hi1, lo2, hi2)."""
    i32, i64, f32 = jnp.int32, jnp.int64, jnp.float32
    U32j = jnp.int64(0xFFFFFFFF)
    score = vt["k_score"].astype(i64)
    fq = vt["k_fq"].astype(i64)
    lq = vt["k_lq"].astype(i64)
    ft_u = (vt["k_first_t"] & jnp.uint64(0xFFFFFFFF)).astype(i64)
    lt_u = (vt["k_last_t"] & jnp.uint64(0xFFFFFFFF)).astype(i64)
    chrom = (vt["k_first_t"] >> jnp.uint64(32)).astype(i64)
    out_len = vt["out_len"].astype(i64)

    def sext(v):  # _i32: sign-extend the low 32 bits
        return jnp.where(v >= (1 << 31), v - (1 << 32), v)

    cidx = jnp.arange(K, dtype=i64)[None, :]
    valid0 = cidx < out_len[:, None]
    span0 = sext(lt_u) - sext(ft_u)
    df1_pass = score.astype(f32) > f32(vt_df1) * span0.astype(f32)
    nb_df = (df1_pass & valid0).sum(axis=1)
    valid1 = cidx < nb_df[:, None]
    thr = (score[:, 0].astype(f32) * f32(vt_f)).astype(i32).astype(i64)
    ge = score >= thr[:, None]
    kept = valid1 & jnp.cumprod(ge.astype(i32), axis=1).astype(bool)

    fq2 = (fq - (k - 1)) & U32j
    ft2 = sext((ft_u - (k - 1)) & U32j)
    dq = (lq - fq2) & U32j
    span = sext(lt_u) - ft2
    cond = dq.astype(jnp.float64) + 0.5 * bw < span.astype(jnp.float64)
    lt_adj = (ft2.astype(jnp.float64) + dq.astype(jnp.float64)
              + 0.5 * bw).astype(i64)  # int() truncation of f64
    lt2 = jnp.where(cond, sext(lt_adj & U32j), lt_u)

    any_kept = kept.any(axis=1)
    # qrstart starts at qlen and only moves down (map.c:1387-1391), so a
    # u32-wrapped first_query_loc above qlen never updates it
    qrstart = jnp.minimum(
        lens, jnp.where(kept, fq2, jnp.int64(1) << 62).min(axis=1)
    )
    qrend = jnp.where(kept, lq, 0).max(axis=1)
    cov = cov_thr.astype(i64)
    win1 = any_kept & (qrstart > cov)
    win2 = any_kept & ((lens - qrend) > cov)
    z = jnp.zeros_like(lens)
    lo1 = z
    hi1 = jnp.where(win1, qrstart, 0).astype(i32)
    lo2 = jnp.where(win2, qrend, 0).astype(i32)
    hi2 = jnp.where(win2, lens, 0).astype(i32)
    kept_len = jnp.where(kept, 1, 0).sum(axis=1)
    return (kept_len, score, fq2, lq, vt["k_str"].astype(i64), chrom,
            ft2, lt2, cond, lo1.astype(i32), hi1, lo2, hi2)


def lr_front(
    codes, lens,
    idx_keys, idx_vals, idx_positions, idx_buckets,
    maps, pref,
    cov_thr,  # [B] i32
    vt_dis,  # [B] u64 (opt.vt_dis)
    cfg: StepConfig,
    k: int = 0,
    vt_df1: float = 0.0,
    vt_f: float = 0.0,
    bw: int = 0,
    ref_axis: str | None = None,
    n_ref: int = 1,
):
    """Device front of the LR mm_map_frag: shared hit collection, round-1
    vote, density/relative filters and BOTH round-2 window scans — one
    dispatch, one packed tensor back to the host.

    Under ``ref_axis`` the index arrays are one key-range shard per device
    and collect_hits merges the per-shard hit streams with psum/all_gather
    (the LR analog of the reference's split-index merge, map.c:1094-1163);
    the vote scans then run on the full merged stream per data-shard read.
    """
    B = codes.shape[0]
    (fallback, shift, extracted, mv_n, capped,
     fk, fq, fok, rk, rq, rok, A_stream) = collect_hits(
        codes, lens, idx_keys, idx_vals, idx_positions, idx_buckets,
        maps, pref, cfg, ref_axis, n_ref,
    )
    # compact the voted stream: the strand-sorted hit arrays put valid hits
    # first, and typical reads fill a small fraction of the A budget, so the
    # three O(stream) vote scans (round 1 + both round-2 windows) run over
    # vote_budget slots instead of A; overflowing reads fall back
    C = cfg.vote_budget
    if C and C < A_stream:
        fallback = fallback | (
            fok.sum(axis=1, dtype=jnp.int32) > C
        ) | (rok.sum(axis=1, dtype=jnp.int32) > C)
        fk, fq, fok = fk[:, :C], fq[:, :C], fok[:, :C]
        rk, rq, rok = rk[:, :C], rq[:, :C], rok[:, :C]
        A_stream = C
    barrier = jnp.full((B, 1), U64_MAX, jnp.uint64)
    bq = jnp.zeros((B, 1), jnp.int32)
    bok = jnp.zeros((B, 1), bool)
    keys = jnp.concatenate([fk, barrier, rk, barrier], axis=1)
    qv = jnp.concatenate([fq, bq, rq, bq], axis=1)
    okv = jnp.concatenate([fok, bok, rok, bok], axis=1)
    strand_stream = jnp.concatenate(
        [jnp.zeros(A_stream + 1, jnp.int32), jnp.ones(A_stream + 1, jnp.int32)]
    )
    vt = _vote_scan_lr(
        keys, qv, okv, strand_stream, extracted, vt_dis, cov_thr, cfg.K
    )
    (kept_len, score, fq2, lq, strv, chrom, ft2, lt2, ltadj,
     lo1, hi1, lo2, hi2) = _lr_filters_device(
        vt, lens.astype(jnp.int64), cov_thr, k, vt_df1, vt_f, bw, cfg.K
    )
    vt2p = vote2_packed_pair(
        keys, qv, okv, strand_stream, extracted, vt_dis, lo1, hi1, lo2, hi2
    )
    # single packed [B, 4 + 8K + 4 + 16] i32 tensor for the host: one
    # device-to-host transfer per batch
    i32 = jnp.int32
    cols = [
        fallback.astype(i32)[:, None],
        shift.astype(i32)[:, None],
        extracted.astype(i32)[:, None],
        kept_len.astype(i32)[:, None],
        score.astype(i32),
        fq2.astype(i32),  # u32 bit pattern
        lq.astype(i32),
        strv.astype(i32),
        chrom.astype(i32),
        ft2.astype(i32),  # signed
        lt2.astype(i32),  # signed if lt_adj flag else u32 bit pattern
        ltadj.astype(i32),
        lo1[:, None], hi1[:, None], lo2[:, None], hi2[:, None],
        vt2p,
    ]
    return {"meta": jnp.concatenate(cols, axis=1)}


LR_META_B = 4  # fallback, shift, extracted, kept_len
LR_META_BK = 8  # score, fq, lq, str, chrom, ft, lt, lt_adj


def unpack_lr_meta(meta, K: int) -> dict:
    """Host inverse of lr_front's packed meta."""
    import numpy as np

    out = {
        "fallback": meta[:, 0].astype(bool),
        "shift": meta[:, 1],
        "extracted": meta[:, 2],
        "kept_len": meta[:, 3],
    }
    base = LR_META_B
    names = ("k_score", "k_fq", "k_lq", "k_str", "k_chrom", "k_ft", "k_lt",
             "k_lt_adj")
    for f, name in enumerate(names):
        out[name] = meta[:, base + f * K : base + (f + 1) * K]
    base += len(names) * K
    for j, name in enumerate(("lo1", "hi1", "lo2", "hi2")):
        out[name] = meta[:, base + j]
    out["vt2"] = meta[:, base + 4 : base + 20]
    return out


def vote2_packed_pair(keys, qv, okv, strand_stream, extracted, vt_dis,
                      lo1, hi1, lo2, hi2):
    """Both round-2 windows (head gap + tail gap, map.c:1680-1712) in ONE
    dispatch; returns [B, 16] i32 (two packed vote2 blocks) so the host
    pays a single transfer round-trip."""
    a = vote2_packed(keys, qv, okv, strand_stream, extracted, vt_dis, lo1, hi1)
    b = vote2_packed(keys, qv, okv, strand_stream, extracted, vt_dis, lo2, hi2)
    return jnp.concatenate([a, b], axis=1)


def vote2_packed(keys, qv, okv, strand_stream, extracted, vt_dis, lo, hi):
    """Round-2 scan with a single packed [B, 8] i32 result."""
    vt2 = _vote2_scan(keys, qv, okv, strand_stream, extracted, vt_dis, lo, hi)
    i32 = jnp.int32
    return jnp.stack(
        [
            vt2["b_score"],
            vt2["b_fq"],
            vt2["b_lq"],
            vt2["b_str"],
            (vt2["b_first_t"] >> jnp.uint64(32)).astype(i32),
            (vt2["b_first_t"] & jnp.uint64(0xFFFFFFFF)).astype(i32),
            (vt2["b_last_t"] >> jnp.uint64(32)).astype(i32),
            (vt2["b_last_t"] & jnp.uint64(0xFFFFFFFF)).astype(i32),
        ],
        axis=1,
    )
