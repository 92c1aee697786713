"""Batched device sketching: k-mer hashing + windowed-min minimizers.

Device re-design of the reference's ring-buffer scan
(GDiet-ShortReads/sketch.c:1577-2225): instead of a sequential loop with a
w-slot buffer, we compute all k-mer hashes for the pattern-sparsified
sequence as fixed-shape tensors, take trailing windowed minima with a
doubling (sparse-table) trick, and mark every position that achieves the
minimum of at least one full window — that set provably equals the scalar
scan's emitted multiset (each seed is pushed exactly once).

For mm_sketch2/3 cap semantics the *emission order* also matters; it is
recovered from analytically derived emission times:

  For an emitted seed at diet position p (k-mer end, hash x_p):
    E(p)  = max(p, q* + w) where q* is the newest earlier position within
            the window with a strictly smaller hash ("exposure": the step
            at which the last smaller predecessor leaves the window and the
            scalar rescan makes p's value the running minimum).
    ff(p) = run_start(p) + w + k - 2, the step at which p's run first
            completes a full window (the scalar's l == w+k-1 special case,
            where deferred duplicate pushes are flushed).
    If an equal hash arrives at r <= E(p):        t = max(E(p), ff(p))
      (p is emitted in the duplicate batch at its exposure/flush event;
       the newest equal value keeps reigning and is emitted later.)
    Else p reigns from E(p) and t = min of:
      - max(p + d, ff(p)) for the first d in [1,w) with x_{p+d} <= x_p
        (displacement push; deferred to the full-window flush if early),
      - p + w                      (window-exit push),
      - the first invalid position after p (ambiguous-base flush),
      - diet_len                   (final flush).
  Ties are ordered by position (the scalar's ring-order batch loops).

mm_sketch's final flush uses l > w+k-1 (sketch.c:1760) while the query
variants use >= — ``final_flush_ge=False`` drops seeds whose only event is
the final flush of a run of exactly one full window.

Validated by fuzzing against the scalar oracle (tests/test_device_sketch).
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import jax.numpy as jnp

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)  # np: a module-level jnp constant would initialize the backend at import (breaks jax.distributed)


def hash64(key: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Invertible mix hash (sketch.c:25-34) on uint64 lanes."""
    key = (~key + (key << jnp.uint64(21))) & mask
    key = key ^ (key >> jnp.uint64(24))
    key = (key + (key << jnp.uint64(3)) + (key << jnp.uint64(8))) & mask
    key = key ^ (key >> jnp.uint64(14))
    key = (key + (key << jnp.uint64(2)) + (key << jnp.uint64(4))) & mask
    key = key ^ (key >> jnp.uint64(28))
    key = (key + (key << jnp.uint64(31))) & mask
    return key


def _shift_right(x: jnp.ndarray, d: int, fill) -> jnp.ndarray:
    """x[..., i] -> x[..., i-d] with `fill` in the first d slots."""
    if d == 0:
        return x
    pad = jnp.full(x.shape[:-1] + (d,), fill, dtype=x.dtype)
    return jnp.concatenate([pad, x[..., :-d]], axis=-1)


def _shift_left(x: jnp.ndarray, d: int, fill) -> jnp.ndarray:
    if d == 0:
        return x
    pad = jnp.full(x.shape[:-1] + (d,), fill, dtype=x.dtype)
    return jnp.concatenate([x[..., d:], pad], axis=-1)


def trailing_window_min(x: jnp.ndarray, w: int, fill) -> jnp.ndarray:
    """min over x[..., i-w+1 : i+1] via log2(w) doubling steps."""
    if w == 1:
        return x
    f = x
    span = 1
    while span * 2 <= w:
        f = jnp.minimum(f, _shift_right(f, span, fill))
        span *= 2
    if span < w:
        f = jnp.minimum(f, _shift_right(f, w - span, fill))
    return f


def leading_window_min(x: jnp.ndarray, w: int, fill) -> jnp.ndarray:
    """min over x[..., i : i+w]."""
    if w == 1:
        return x
    f = x
    span = 1
    while span * 2 <= w:
        f = jnp.minimum(f, _shift_left(f, span, fill))
        span *= 2
    if span < w:
        f = jnp.minimum(f, _shift_left(f, w - span, fill))
    return f


@partial(jax.jit, static_argnames=("k", "w"))
def kmer_scan(
    diet_codes: jnp.ndarray,  # [B, D] uint8 codes of the sparsified sequence
    diet_valid: jnp.ndarray,  # [B, D] bool: position < diet_len
    real_pos: jnp.ndarray,  # [B, D] int64 real coordinates (gather map)
    rid: jnp.ndarray,  # [B] int64 sequence ids
    k: int,
    w: int,
):
    """Per-position canonical k-mer hash keys x, packed positions y, run
    lengths l and the emitted-minimizer mask, all [B, D].

    x/y match the reference's info fields (sketch.c:1659-1684); invalid
    positions (short run, symmetric k-mer, ambiguous base, padding) hold
    U64_MAX.
    """
    B, D = diet_codes.shape
    codes = diet_codes.astype(jnp.uint64)
    is_base = (diet_codes < 4) & diet_valid

    mask = jnp.uint64((1 << (2 * k)) - 1)

    # k-mer construction by binary doubling: kmer_{l+m}[i] =
    # kmer_l[i-m] << 2m | kmer_m[i] (and the mirrored identity for the
    # reverse complement), so a k-mer needs ~2*log2(k) u64 shift-ors instead
    # of k. Equivalent to the reference's rolling update (sketch.c:1651-1656)
    # wherever a full valid window exists — elsewhere masked by l < k.
    segs = {1: codes & jnp.uint64(3)}
    segs_r = {1: (jnp.uint64(3) ^ codes) & jnp.uint64(3)}
    l_ = 1
    while l_ * 2 <= k:
        segs[l_ * 2] = (
            _shift_right(segs[l_], l_, jnp.uint64(0)) << jnp.uint64(2 * l_)
        ) | segs[l_]
        segs_r[l_ * 2] = (segs_r[l_] << jnp.uint64(2 * l_)) | _shift_right(
            segs_r[l_], l_, jnp.uint64(0)
        )
        l_ *= 2

    def build(target: int):
        done = 0
        kf_ = None
        kr_ = None
        bit = 1
        while bit <= target:
            if target & bit:
                if kf_ is None:
                    kf_, kr_ = segs[bit], segs_r[bit]
                    done = bit
                else:
                    kf_ = (
                        _shift_right(kf_, bit, jnp.uint64(0)) << jnp.uint64(2 * bit)
                    ) | segs[bit]
                    kr_ = (segs_r[bit] << jnp.uint64(2 * done)) | _shift_right(
                        kr_, bit, jnp.uint64(0)
                    )
                    done += bit
            bit <<= 1
        return kf_, kr_

    kf, kr = build(k)
    kf = kf & mask
    kr = kr & mask

    # l[i]: consecutive valid bases ending at i (the reference's l counter)
    idx = jnp.arange(D, dtype=jnp.int64)[None, :]
    last_bad = jnp.where(is_base, jnp.int64(-1), idx)
    last_bad = jax.lax.associative_scan(jnp.maximum, last_bad, axis=-1)
    run_start = last_bad + 1
    l = jnp.where(is_base, idx - run_start + 1, 0)

    strand = (kf >= kr).astype(jnp.uint64)  # z = 0 iff kmer_f < kmer_r
    symmetric = kf == kr
    kmin = jnp.where(strand == jnp.uint64(0), kf, kr)
    x = (hash64(kmin, mask) << jnp.uint64(8)) | jnp.uint64(k)
    pos_u32 = (real_pos.astype(jnp.uint64) << jnp.uint64(1)) & jnp.uint64(0xFFFFFFFF)
    y = (rid.astype(jnp.uint64)[:, None] << jnp.uint64(32)) | pos_u32 | strand

    kmer_ok = is_base & (l >= k) & ~symmetric
    x = jnp.where(kmer_ok, x, U64_MAX)
    y = jnp.where(kmer_ok, y, U64_MAX)

    full_window = is_base & (l >= w + k - 1)
    m = trailing_window_min(x, w, U64_MAX)
    # p achieves the min of some full window ending in [p, p+w-1] iff the
    # MAX over those windows' minima equals x_p (every window containing p
    # has min <= x_p). Non-full windows get sentinel 0 (< any valid x).
    m_masked = jnp.where(full_window, m, jnp.uint64(0))
    neg = ~m_masked  # max via min on complements keeps one helper
    Mc = leading_window_min(neg, w, U64_MAX)
    M = ~Mc
    emitted = (x != U64_MAX) & (x == M)

    return {
        "x": x,
        "y": y,
        "l": l,
        "run_start": run_start,
        "is_base": is_base,
        "emitted": emitted,
    }


@partial(jax.jit, static_argnames=("k", "w", "max_out", "final_flush_ge"))
def sketch_emit(
    diet_codes: jnp.ndarray,
    diet_len: jnp.ndarray,  # [B] int64 actual diet lengths
    real_pos: jnp.ndarray,
    rid: jnp.ndarray,
    k: int,
    w: int,
    max_out: int,
    final_flush_ge: bool = True,
):
    """Emit minimizers in scalar emission order, packed [B, max_out].

    Returns (xs, ys, valid_mask, counts) with counts = total emitted seeds
    (uncapped); entries beyond counts (or max_out) are invalid.
    """
    return _emit_core(
        diet_codes, diet_len, real_pos, rid, k, w, max_out, final_flush_ge
    )


@partial(
    jax.jit,
    static_argnames=("k", "w", "max_out", "ones_loc", "plen",
                     "final_flush_ge", "packed"),
)
def sketch_emit_build(
    diet_codes: jnp.ndarray,  # [B, D] uint8
    diet_len: jnp.ndarray,  # [B] int64
    lo: jnp.ndarray,  # [B] int64 diet offset of column 0 in the sequence
    rid: jnp.ndarray,  # [B] int64
    k: int,
    w: int,
    max_out: int,
    ones_loc: tuple[int, ...],  # pattern '1' offsets (pattern.ones_locations)
    plen: int,  # pattern period
    final_flush_ge: bool = True,
    packed: bool = False,  # one u64 per emission instead of (x, y):
    # (hash << 18) | (row-relative pos << 1) | strand — HALF the D2H bytes
    # (the build bottleneck at GRCh38 scale). Valid while 2k + 18 <= 64
    # (k <= 23) and D * plen < 2^17; the caller reconstructs (key, y).
):
    """Index-build variant of sketch_emit, tuned for host-device traffic:

    - real coordinates are derived ON DEVICE from the diet pattern
      (real = (j // ones) * plen + ones_loc[j % ones], sketch.c:20-23)
      instead of shipping a [B, D] int64 gather map — that array was 8x the
      bytes of the codes themselves and dominated build H2D time. NOTE the
      derivation assumes pattern shift == 0 (the reference formula adds
      '+ shift'): index builds always sketch at shift 0 (index.c:370); a
      caller with a nonzero shift must add it to the returned positions;
    - xs and ys come back fused in ONE [B, 2*max_out] u64 tensor so the
      host pays a single D2H fetch per group.

    Returns (xy, counts): xy[:, :max_out] = xs, xy[:, max_out:] = ys.
    """
    B, D = diet_codes.shape
    j = lo.astype(jnp.int64)[:, None] + jnp.arange(D, dtype=jnp.int64)[None, :]
    loc = jnp.asarray(ones_loc, dtype=jnp.int64)
    ones = len(ones_loc)
    real_pos = (j // ones) * jnp.int64(plen) + loc[j % ones]
    xs, ys, _, nvalid = _emit_core(
        diet_codes, diet_len, real_pos, rid, k, w, max_out, final_flush_ge
    )
    if packed:
        assert 2 * k + 18 <= 64 and D * plen < (1 << 17), (k, D, plen)
        # row base in (pos << 1) units: real position of diet column 0
        base2 = (((lo.astype(jnp.int64) // ones) * jnp.int64(plen)
                  + loc[lo.astype(jnp.int64) % ones]) << 1)[:, None]
        u64 = jnp.uint64
        rel2 = (ys & u64(0xFFFFFFFF)) - base2.astype(u64)
        return ((xs >> u64(8)) << u64(18)) | rel2, nvalid
    return jnp.concatenate([xs, ys], axis=1), nvalid


def _emit_core(diet_codes, diet_len, real_pos, rid, k, w, max_out,
               final_flush_ge):
    B, D = diet_codes.shape
    idx = jnp.arange(D, dtype=jnp.int64)[None, :]
    dlen = diet_len.astype(jnp.int64)[:, None]
    diet_valid = idx < dlen

    res = kmer_scan(diet_codes, diet_valid, real_pos, rid, k, w)
    x, l, emitted = res["x"], res["l"], res["emitted"]
    INF_T = jnp.int64(2 * D + 4)

    # exposure E(p): exit time of the newest (smallest-d) smaller
    # predecessor within the window; E = p when there is none.
    # w is static and small, so unroll the offset loops at trace time.
    E = idx
    for d in range(1, w):
        smaller = _shift_right(x, d, U64_MAX) < x
        E = jnp.where(smaller & (E == idx), idx + jnp.int64(w - d), E)

    # first equal / first <= successor within (p, p+w)
    d_eq = jnp.full((B, D), INF_T)
    d_le = jnp.full((B, D), INF_T)
    for d in range(1, w):
        xs = _shift_left(x, d, U64_MAX)
        eq = (xs == x) & (x != U64_MAX)
        le = (xs <= x) & (x != U64_MAX)
        d_eq = jnp.where(eq & (d_eq == INF_T), jnp.int64(d), d_eq)
        d_le = jnp.where(le & (d_le == INF_T), jnp.int64(d), d_le)

    # first-full-window flush step of p's run
    ff = res["run_start"] + jnp.int64(w + k - 2)

    # first invalid position strictly after p (ambiguous-base flush)
    invalid = ~res["is_base"] & diet_valid
    inv_idx = jnp.where(invalid, idx, INF_T)
    rev_min = jnp.flip(
        jax.lax.associative_scan(jnp.minimum, jnp.flip(inv_idx, -1), axis=-1), -1
    )
    t_nf = _shift_left(rev_min, 1, INF_T)

    t_disp = jnp.where(d_le != INF_T, jnp.maximum(idx + d_le, ff), INF_T)
    t_exit = jnp.where(idx + jnp.int64(w) < dlen, idx + jnp.int64(w), INF_T)
    t_final = jnp.broadcast_to(dlen, (B, D))
    t_caseB = jnp.minimum(jnp.minimum(t_disp, t_exit), jnp.minimum(t_nf, t_final))
    caseA = (d_eq != INF_T) & (idx + d_eq <= E)
    t = jnp.where(caseA, jnp.maximum(E, ff), t_caseB)

    if not final_flush_ge:
        # mm_sketch: final flush requires l > w+k-1; drop seeds whose only
        # event is the final flush of a single-full-window run
        last = jnp.clip(dlen - 1, 0, D - 1)
        l_last = jnp.take_along_axis(l, last, axis=-1)
        drop = (t == dlen) & (l_last == jnp.int64(w + k - 1))
        emitted = emitted & ~drop

    # stable order by (emission time, position), packed into ONE i32 key
    # (t <= 2D+4 and i < D, so t*(D+1)+i fits easily): a 1-key 3-operand
    # sort is ~25% cheaper than the 2-key 4-operand one
    INF32 = jnp.int32(0x7FFFFFFF)
    key = jnp.where(
        emitted, t * jnp.int64(D + 1) + idx, INF32
    ).astype(jnp.int32)
    _, xs, ys = jax.lax.sort([key, x, res["y"]], dimension=1, num_keys=1)
    xs = xs[:, :max_out]
    ys = ys[:, :max_out]
    nvalid = emitted.sum(axis=-1)
    valid = jnp.arange(max_out, dtype=jnp.int64)[None, :] < nvalid[:, None]
    return xs, ys, valid, nvalid
