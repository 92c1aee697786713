#!/usr/bin/env python
"""Cumulative per-stage device profile of the fused SR step.

Every stage here is timed by fetching a TINY checksum reduced inside the
jit, so the fetch floor cancels in the stage DIFFS.

Stages are cumulative prefixes of fused_map_step; the printed diff is the
marginal cost of each phase. Run AFTER bench.py generated /tmp/gdiet_bench.
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
BENCH = pathlib.Path("/tmp/gdiet_bench")


def timed_fetch(fn, *args, n=5):
    """Median wall of n calls, synced by fetching the (tiny) result."""
    np.asarray(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        np.asarray(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    import jax
    import jax.numpy as jnp

    import gdiet_tpu  # noqa: F401
    from gdiet_tpu import native
    from gdiet_tpu.config import options_for
    from gdiet_tpu.index.build import DietIndex
    from gdiet_tpu.io.fastx import read_fastx
    from gdiet_tpu.pipeline import device_step as ds
    from gdiet_tpu.pipeline.shortread import ShortReadMapper

    print(f"platform: {jax.devices()[0].platform}", flush=True)
    mi = DietIndex.load(str(BENCH / "ours.gdi.npz"))
    _, mo = options_for(
        "sr", pattern="10", max_seeds=2.0, best_n=1, bw_frac=0.05,
        bw_min=150, bw_max=200, min_cnt=0.95, rec_threshold_frac=0.3,
        min_dp_max=100, AF_max_loc=2,
    )
    reads = list(read_fastx(str(BENCH / "reads.fq")))
    B = 8192
    mapper = ShortReadMapper(
        mi, mo, max_read_len=160, seed_budget=32, shift_seed_budget=16,
        hit_budget=64, dp_frac=0.3125,
    )
    fused = mapper.fused
    cfg = fused.cfg
    codes, lens_np = native.encode_batch([r.seq for r in reads[:B]], 160)
    codes_d, lens_d = jnp.asarray(codes), jnp.asarray(lens_np)
    a = fused.arrays

    def ck(*arrs):
        """Tiny checksum of arbitrary arrays (forces full compute)."""
        s = jnp.int32(0)
        for x in arrs:
            if x.dtype == jnp.uint64:
                s += (x & jnp.uint64(0xFFFF)).astype(jnp.int32).sum()
            elif x.dtype == bool:
                s += x.sum().astype(jnp.int32)
            else:
                s += x.astype(jnp.int32).sum()
        return s

    # fetch floor (tiny constant round trip)
    floor = timed_fetch(jax.jit(lambda c: c[0, 0].astype(jnp.int32)), codes_d)
    print(f"fetch floor: {floor * 1e3:.1f} ms", flush=True)

    stages = []

    def sketch_only(c, l):
        W = len(cfg.pattern)
        Dmax = a["maps"].shape[1]
        rid0 = jnp.zeros((c.shape[0],), jnp.int64)
        from gdiet_tpu.ops.sketch import sketch_emit
        outs = []
        for s in range(W):
            dlen = ds._diet_len(l, s, a["pref"], W)
            rp = jnp.broadcast_to(a["maps"][s], (c.shape[0], Dmax))
            dc = ds._diet_slices(c, s, cfg.pattern, Dmax)
            xs, ys, v, n = sketch_emit(dc, dlen, rp, rid0, cfg.k, cfg.w,
                                       cfg.S, final_flush_ge=True)
            outs += [xs, ys, n]
        return ck(*outs)

    stages.append(("sketch (both shifts)", jax.jit(sketch_only)))

    def hits_only(c, l):
        out = ds.collect_hits(c, l, a["idx_keys"], a["idx_vals"],
                              a["idx_positions"], a["idx_buckets"],
                              a["maps"], a["pref"], cfg)
        return ck(*[x for x in out if hasattr(x, "dtype")])

    stages.append(("collect_hits (sketch+lookup+expand+sort)",
                   jax.jit(hits_only)))

    def full_ck(c, l, backtrack):
        d = ds.fused_map_step(
            c, l, a["idx_keys"], a["idx_vals"], a["idx_positions"],
            a["idx_buckets"], a["ref_codes"], a["ref_offsets"],
            a["ref_lengths"], a["maps"], a["pref"], cfg=cfg,
            backtrack=backtrack, ref_nmask=a.get("ref_nmask"))
        return ck(d["meta"], d["ops"])

    stages.append(("full step w/o backtrack",
                   jax.jit(lambda c, l: full_ck(c, l, False))))
    stages.append(("full step + backtrack",
                   jax.jit(lambda c, l: full_ck(c, l, True))))

    prev = 0.0
    for name, fn in stages:
        dt = timed_fetch(fn, codes_d, lens_d) - floor
        print(f"{name}: {dt * 1e3:.1f} ms  (marginal {((dt - prev)) * 1e3:+.1f} ms)",
              flush=True)
        prev = dt

    # vote scan in isolation (its inputs regenerated by collect_hits)
    ch = jax.jit(lambda c, l: ds.collect_hits(
        c, l, a["idx_keys"], a["idx_vals"], a["idx_positions"],
        a["idx_buckets"], a["maps"], a["pref"], cfg))
    out = ch(codes_d, lens_d)
    (fallback, shift, extracted, mv_n, capped,
     fk, fq, fok, rk, rq, rok, A_stream) = out
    bw = jnp.clip((lens_d.astype(jnp.float64) * cfg.bw_frac).astype(jnp.int64),
                  cfg.bw_min, cfg.bw_max)
    vt_thr = jnp.maximum(
        (mv_n.astype(jnp.float64) * cfg.min_cnt).astype(jnp.int64), 1)
    vt_rec = (mv_n.astype(jnp.float64) * cfg.rec_frac).astype(jnp.int64)
    barrier = jnp.full((B, 1), np.uint64(0xFFFFFFFFFFFFFFFF), jnp.uint64)
    bq = jnp.zeros((B, 1), jnp.int32)
    bok = jnp.zeros((B, 1), bool)
    keys = jnp.concatenate([fk, barrier, rk, barrier], axis=1)
    qv = jnp.concatenate([fq, bq, rq, bq], axis=1)
    okv = jnp.concatenate([fok, bok, rok, bok], axis=1)
    strand_stream = jnp.concatenate(
        [jnp.zeros(A_stream + 1, jnp.int32), jnp.ones(A_stream + 1, jnp.int32)])

    def vote_only(keys, qv, okv, vt_thr, vt_rec):
        vt = ds._vote_scan(keys, qv, okv, strand_stream,
                           bw.astype(jnp.uint64), vt_thr.astype(jnp.int32),
                           vt_rec.astype(jnp.int32), cfg.K, A_stream)
        return ck(*vt.values())

    dt = timed_fetch(jax.jit(vote_only), keys, qv, okv, vt_thr, vt_rec) - floor
    print(f"vote scan isolated: {dt * 1e3:.1f} ms", flush=True)


if __name__ == "__main__":
    main()
