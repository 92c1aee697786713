#!/usr/bin/env python
"""SR device-stage microprofile on the bench workload.

Times the fused step end-to-end and its sub-stages in isolation (separate
jits over the same inputs): sketch+shift, index lookup, hit expand+sort,
vote scan, window gathers, DP+backtrack. Host-clock timings that end in a
device fetch; they include the per-dispatch floor.

Run AFTER bench.py has generated /tmp/gdiet_bench (reuses its data/index);
never concurrently with another job on the same device.
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
BENCH = pathlib.Path("/tmp/gdiet_bench")


def t(fn, *args, n=5, **kw):
    """Median wall of n timed calls (after one warmup), blocking on result."""
    import jax

    r = fn(*args, **kw)
    jax.block_until_ready(r)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        r = fn(*args, **kw)
        jax.block_until_ready(r)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), r


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
    codes, _ = native.encode_batch([r.seq for r in reads[:B]], 160)
    lens = np.array([r.l_seq for r in reads[:B]], np.int64)
    codes_d, lens_d = jnp.asarray(codes), jnp.asarray(lens)
    a = fused.arrays

    # end-to-end fused step
    dt, out = t(lambda: jax.block_until_ready(fused(codes_d, lens_d)))
    print(f"fused step e2e: {dt * 1e3:.1f} ms", flush=True)

    # collect_hits (phases 1-3)
    ch = jax.jit(lambda c, l: ds.collect_hits(
        c, l, a["idx_keys"], a["idx_vals"], a["idx_positions"],
        a["idx_buckets"], a["maps"], a["pref"], cfg))
    dt, ch_out = t(ch, codes_d, lens_d)
    print(f"collect_hits (sketch+lookup+expand+sort): {dt * 1e3:.1f} ms",
          flush=True)

    # sketch-only: the W per-shift sketches without lookups
    maps_, pref_ = a["maps"], a["pref"]

    def sketch_only(c, l):
        outs = []
        W = len(cfg.pattern)
        Dmax = maps_.shape[1]
        rid0 = jnp.zeros((c.shape[0],), jnp.int64)
        from gdiet_tpu.ops.sketch import sketch_emit
        for s in range(W):
            dlen = ds._diet_len(l, s, pref_, W)
            rp = jnp.broadcast_to(maps_[s], (c.shape[0], Dmax))
            dc = ds._diet_slices(c, s, cfg.pattern, Dmax)
            outs.append(sketch_emit(dc, dlen, rp, rid0, cfg.k, cfg.w, cfg.S,
                                    final_flush_ge=True))
        return outs

    dt, sk = t(jax.jit(sketch_only), codes_d, lens_d)
    print(f"sketch only (both shifts): {dt * 1e3:.1f} ms", flush=True)

    # lookup-only over the sketched keys
    xs = sk[0][0]

    def lookup_only(q):
        NB = jnp.uint64(cfg.cuckoo_nb)
        kb = a["idx_keys"].reshape(-1, 4)
        vb = a["idx_vals"].reshape(-1, 4)
        t1 = (q * jnp.uint64(cfg.cuckoo_c1)) >> jnp.uint64(32)
        b1 = ((t1 * NB) >> jnp.uint64(32)).astype(jnp.int64)
        t2 = (q * jnp.uint64(cfg.cuckoo_c2)) >> jnp.uint64(32)
        b2 = ((t2 * NB) >> jnp.uint64(32)).astype(jnp.int64) + cfg.cuckoo_nb
        k1, v1 = jnp.take(kb, b1, axis=0), jnp.take(vb, b1, axis=0)
        k2, v2 = jnp.take(kb, b2, axis=0), jnp.take(vb, b2, axis=0)
        return (jnp.where(k1 == q[..., None], v1, jnp.uint64(0)).sum(-1)
                + jnp.where(k2 == q[..., None], v2, jnp.uint64(0)).sum(-1))

    q = xs >> jnp.uint64(8)
    dt, _ = t(jax.jit(lookup_only), q)
    print(f"cuckoo lookup only ([B,S] probes): {dt * 1e3:.1f} ms", flush=True)

    # full step WITHOUT backtrack (isolates backtrack+ops packing)
    nb = jax.jit(lambda c, l: ds.fused_map_step(
        c, l, a["idx_keys"], a["idx_vals"], a["idx_positions"],
        a["idx_buckets"], a["ref_codes"], a["ref_offsets"], a["ref_lengths"],
        a["maps"], a["pref"], cfg=cfg, backtrack=False,
        ref_nmask=a.get("ref_nmask")))
    dt, _ = t(nb, codes_d, lens_d)
    print(f"fused step w/o backtrack: {dt * 1e3:.1f} ms", flush=True)

    # host finish timing (native C) on the real outputs
    meta_np, ops_np = fused.fetch(out, B)
    di = np.arange(B)
    t0 = time.perf_counter()
    native.sr_finish_batch(
        meta_np, ops_np, cfg.K, cfg.Lmax, codes, lens,
        [r.name for r in reads[:B]], [r.seq for r in reads[:B]],
        [r.qual or "" for r in reads[:B]],
        mi.codes, mi.seq_offsets,
        mapper._ref_names_blob, mapper._ref_name_offs,
        mo.a, mo.b, mo.q, mo.e, mo.min_dp_max,
        0, True, False, 0,
    )
    print(f"native sr_finish_batch: {(time.perf_counter() - t0) * 1e3:.1f} ms",
          flush=True)

    # D2H fetch cost of the output tensor(s)
    o = fused(codes_d, lens_d)
    jax.block_until_ready(o)
    t0 = time.perf_counter()
    for v in o.values():
        np.asarray(v)
    nb_ = sum(v.nbytes for v in o.values())
    print(f"D2H outputs ({len(o)} tensor(s)): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms ({nb_} bytes)",
          flush=True)


if __name__ == "__main__":
    main()
