#!/usr/bin/env python
"""The CUDA DP kernel against the XLA scan on a GPU: alone and end to end.

Run from the root of a checkout, on a machine with a GPU:

    python eval/dp_ab.py

Part 1 times ops/dp.py::extd2 (the CUDA kernel on the GPU) and
ops/dp.py::extd2_xla, each alone and each followed by the device backtrack,
at the short-read DP shape and at every long-read bucket the HiFi and ONT
reads of chip_smoke.py reach, with their bandwidths. It first checks that
both give the same scores, direction bytes and op streams
(chip_smoke.compare_dp, exact). Medians of five calls.

Part 2 maps chip_smoke.py's scale-phase workload (short-read batches of
10,016, HiFi 5-15 kb, ONT 30 kb split reads) on the scale genome's index,
built once, four times in one process: kernel, XLA, kernel, XLA. An XLA pass
builds its mappers while ops.dp.extd2 points at extd2_xla. Every pass maps a
warm-up batch (compilation) before the timed ones, and its SAM must equal
the first pass's byte for byte.

Times are host wall clock and end in a device fetch.
"""

from __future__ import annotations

import contextlib
import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def median_ms(fn, args, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def dp_shapes(sizes: cs.Sizes, rng):
    """(name, Q, T, qlens, tlens, band, params, Lmax, Lt, band budget)."""
    from gdiet_tpu.pipeline.device_step import dp_rows

    N2 = dp_rows(2 * sizes.sr_batch, 0.3125)
    Q, T, ql, _ = cs.dp_pairs(rng, N2, 160, 160, min_len=100)
    band = rng.integers(150, 201, N2).astype(np.int32)
    yield "sr", Q, T, ql, ql, band, (2, 8, 12, 2, 24, 1), 160, 160, 200
    N = sizes.lr_dp_rows
    for tag, mo, lmax in (("hifi", cs.hifi_options(), sizes.hifi_lmax),
                          ("ont", cs.ont_options(), sizes.ont_lmax)):
        for lq, lt in cs.reached_buckets(lmax):
            Q, T, ql, tl = cs.dp_pairs(rng, N, lq, lt)
            yield (f"{tag} ({lq},{lt})", Q, T, ql, tl,
                   np.full(N, mo.bw, np.int32), cs.dp_params(mo), lq, lt,
                   mo.bw)


def part_dp(sizes: cs.Sizes, seed: int, card: str) -> None:
    import jax
    import jax.numpy as jnp

    from gdiet_tpu.ops import dp as dpk
    from gdiet_tpu.pipeline.device_step import _backtrack_antidiag

    rng = np.random.default_rng(seed)
    for name, Q, T, ql, tl, band, prm, Lmax, Lt, bb in dp_shapes(sizes, rng):
        args = [jnp.asarray(x) for x in (Q, T, ql, tl, band)]
        cs.compare_dp(cs.dp_fns(prm, Lmax, Lt, bb), args, name)
        kw = dict(params=prm, Lmax=Lmax, Lt=Lt, band_budget=bb)
        impls = {
            "kernel": lambda q, t, a, b, c: dpk.extd2(q, t, a, b, c, prm, Lmax,
                                                      Lt, bb),
            "xla": lambda q, t, a, b, c: dpk.extd2_xla(q, t, a, b, c, **kw),
        }
        row = []
        for impl, dp in impls.items():
            def with_bt(q, t, a, b, c, dp=dp):
                s, d = dp(q, t, a, b, c)
                return (s,) + _backtrack_antidiag(d, a, c, Lmax, tlens=b,
                                                  Lt=Lt, band_budget=bb)

            row.append(f"{impl} {median_ms(jax.jit(dp), args):.3f} ms"
                       f" (+backtrack {median_ms(jax.jit(with_bt), args):.3f}"
                       f" ms)")
        print(f"[dp] {name} N={len(ql)} band {bb}: exact; " + ", ".join(row)
              + f" [{card}]", flush=True)


@contextlib.contextmanager
def dp_impl(name: str):
    """Mappers built inside trace ops.dp.extd2 as `name`: the kernel (the
    module's own choice) or the XLA scan."""
    from gdiet_tpu.ops import dp as dpk

    orig = dpk.extd2
    if name == "xla":
        dpk.extd2 = lambda q, t, ql, tl, b, params, Lmax, Lt, band_budget=None: \
            dpk.extd2_xla(q, t, ql, tl, b, params=tuple(params), Lmax=Lmax,
                          Lt=Lt, band_budget=band_budget)
    try:
        yield
    finally:
        dpk.extd2 = orig


def part_e2e(sizes: cs.Sizes, seed: int, card: str) -> None:
    from gdiet_tpu.io.fastx import split_ultralong

    mi, chroms, _ = cs.build_scale_index(sizes, seed)
    rng = np.random.default_rng(seed + 1)
    B = sizes.sr_batch
    reads = cs.make_sr_reads(rng, chroms, B * (sizes.sr_batches + 1))
    batches = [reads[i:i + B] for i in range(0, len(reads), B)]
    hifi = cs.make_long_reads(rng, chroms, sizes.hifi_reads, *sizes.hifi_len,
                              sub=0.002, indel=0.002, tag="h")
    ont = cs.make_long_reads(rng, chroms, sizes.ont_reads, sizes.ont_len,
                             sizes.ont_len + 500, sub=0.03, indel=0.02,
                             tag="o")
    ont = list(split_ultralong(ont, 30000))
    first = None
    for n, impl in enumerate(("kernel", "xla", "kernel", "xla")):
        out = {}
        with dp_impl(impl):
            sr = cs.sr_mapper(mi)
            cs.run_sr(sr, batches[:1])
            blob, dt = cs.run_sr(sr, batches[1:])
            out["sr"] = (blob, len(reads) - B, dt, sr.stats["fallback_reads"])
            for tag, mk, recs, bsz in (
                    ("hifi", cs.hifi_mapper, hifi, sizes.hifi_batch),
                    ("ont", cs.ont_mapper, ont, sizes.ont_batch)):
                lr = mk(mi, sizes)
                cs.run_lr(lr, recs[:bsz], bsz)
                lines, dt, fb = cs.run_lr(lr, recs, bsz)
                out[tag] = ("\n".join(lines).encode(), len(recs), dt, len(fb))
        if first is None:
            first = out
        for tag, (blob, _, _, _) in out.items():
            if blob != first[tag][0]:
                raise AssertionError(f"pass {n + 1} ({impl}): {tag} SAM "
                                     f"differs from pass 1")
        print(f"[e2e] pass {n + 1} {impl}: " + "; ".join(
            f"{tag} {k} reads in {dt:.3f} s = {k / dt:.2f} reads/s "
            f"({f} fallback)" for tag, (_, k, dt, f) in out.items())
            + f"; SAM equal to pass 1 [{card}]", flush=True)


def main() -> int:
    cs.phase_device()
    card = cs.card_line()
    sizes = cs.Sizes()
    part_dp(sizes, cs.SEED, card)
    part_e2e(sizes, cs.SEED, card)
    print(f"[done] {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
