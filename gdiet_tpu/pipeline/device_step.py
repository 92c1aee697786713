"""Fused single-dispatch device mapping step for the short-read pipeline.

One jitted function runs every device stage of mm_map_frag
(GDiet-ShortReads/map.c:586-1010) back to back with no host round-trips:

  1. shift inference   — W per-shift sketches + CSR lookups, argmax
                         (mm_sketch2 + mm_get_shift, sketch.c:2143 /
                         seed.c:166).
  2. query sketch      — device sketch at the inferred shift with frag-mode
                         cap semantics (mm_sketch3, sketch.c:1908).
  3. seed lookup       — batched binary search in the CSR index
                         (mm_idx_get, index.c:84).
  4. hit expansion     — ragged occurrence lists -> [B, A] hit budget,
                         per-strand diagonal projection + device sort
                         (collect_seed_hits, map.c:261-355).
  5. voting            — lax.scan run-vote with top-K + recovery candidate
                         (vote, map.c:447-584).
  6. window build      — candidate window geometry (map.c:764-840) and
                         query/target gathers, on device.
  7. extension         — exact-match short-circuit (exact_match_sse.c:23)
                         plus batched banded dual-affine DP (ops/dp.py).

The function also emits per-read *fallback masks* for every condition under
which the fixed-shape envelope cannot reproduce the reference exactly
(budget overflows, occurrence-streak selection, query-occ filter); the host
routes those reads through the scalar oracle. Everything else is finished on
host (backtrack, CIGAR fix-ups, mm_set_sam_params) from the returned arrays.

This is also the flagship "forward step" used by __graft_entry__ and the
multi-chip sharded path (parallel/dist.py).
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dataclass_replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gdiet_tpu import pattern as pat
from gdiet_tpu.config import MM_F_FRAG_MODE, MapOptions
from gdiet_tpu.index.build import DietIndex
from gdiet_tpu.ops import dp as dpk
from gdiet_tpu.ops.sketch import sketch_emit

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)  # np: a module-level jnp constant would initialize the backend at import (breaks jax.distributed)
U32 = 0xFFFFFFFF
I64 = jnp.int64


@partial(jax.jit, static_argnames=("K", "A"))
def _vote_scan(
    keys: jnp.ndarray,  # [B, M] u64 projected targets (stream order)
    qpos: jnp.ndarray,  # [B, M] i32
    valid: jnp.ndarray,  # [B, M] bool
    strand: jnp.ndarray,  # [M] i32 (0 fwd pass, 1 rev pass)
    vt_distance: jnp.ndarray,  # [B] u64
    vt_threshold: jnp.ndarray,  # [B] i32
    vt_rec_threshold: jnp.ndarray,  # [B] i32
    K: int,
    A: int,
):
    """vote (map.c:447-584) over the concatenated fwd/rev hit stream.

    Returns top-K candidate fields (sorted by score as maintained by the
    reference's insertion) plus the recovery candidate.
    """
    B, M = keys.shape
    i32 = jnp.int32

    state = {
        "head_t": jnp.zeros((B,), jnp.uint64),
        "head_valid": jnp.zeros((B,), bool),
        "head_str": jnp.zeros((B,), i32),
        "fq": jnp.zeros((B,), i32),
        "lq": jnp.zeros((B,), i32),
        "cnt": jnp.zeros((B,), i32),
        "k_score": jnp.full((B, K), -1, i32),
        "k_target": jnp.zeros((B, K), jnp.uint64),
        "k_fq": jnp.zeros((B, K), i32),
        "k_lq": jnp.zeros((B, K), i32),
        "k_str": jnp.zeros((B, K), i32),
        "out_len": jnp.zeros((B,), i32),
        "r_score": jnp.zeros((B,), i32),
        "r_target": jnp.zeros((B,), jnp.uint64),
        "r_fq": jnp.zeros((B,), i32),
        "r_lq": jnp.zeros((B,), i32),
        "r_str": jnp.zeros((B,), i32),
    }

    def emit(st, do_emit):
        """Process a finished run (head fields) where do_emit."""
        cnt, fq, lq = st["cnt"], st["fq"], st["lq"]
        target, hstr = st["head_t"], st["head_str"]
        passes = do_emit & (cnt > vt_threshold)
        full = st["out_len"] == K
        reject = passes & full & (st["k_score"][:, K - 1] >= cnt)
        insert = passes & ~reject
        # position of insertion: out_len (or K-1 when full)
        pos = jnp.where(full, K - 1, st["out_len"])
        slot = jnp.arange(K, dtype=i32)[None, :] == pos[:, None]
        upd = insert[:, None] & slot
        ks = jnp.where(upd, cnt[:, None], st["k_score"])
        kt = jnp.where(upd, target[:, None], st["k_target"])
        kf = jnp.where(upd, fq[:, None], st["k_fq"])
        kl = jnp.where(upd, lq[:, None], st["k_lq"])
        kr = jnp.where(upd, hstr[:, None], st["k_str"])
        # single backward bubble pass == the reference's insertion loop
        for kk in range(K - 1, 0, -1):
            swap = insert & (ks[:, kk] > ks[:, kk - 1])

            def sw(arr):
                a, b = arr[:, kk - 1], arr[:, kk]
                arr = arr.at[:, kk].set(jnp.where(swap, a, arr[:, kk]))
                arr = arr.at[:, kk - 1].set(jnp.where(swap, b, arr[:, kk - 1]))
                return arr

            ks, kt, kf, kl, kr = sw(ks), sw(kt), sw(kf), sw(kl), sw(kr)
        out_len = jnp.where(insert & ~full, st["out_len"] + 1, st["out_len"])
        # recovery (map.c:519-531): only while no potentials exist
        rec = (
            do_emit
            & ~passes
            & (st["out_len"] == 0)
            & (cnt > vt_rec_threshold)
            & (cnt > st["r_score"])
        )
        st = dict(st)
        st.update(
            k_score=ks, k_target=kt, k_fq=kf, k_lq=kl, k_str=kr, out_len=out_len,
            r_score=jnp.where(rec, cnt, st["r_score"]),
            r_target=jnp.where(rec, target, st["r_target"]),
            r_fq=jnp.where(rec, fq, st["r_fq"]),
            r_lq=jnp.where(rec, lq, st["r_lq"]),
            r_str=jnp.where(rec, hstr, st["r_str"]),
        )
        return st

    def step(st, inp):
        t, q, ok, sgn = inp
        in_run = (
            st["head_valid"]
            & ok
            & (sgn == st["head_str"])
            & ((t - st["head_t"]) <= vt_distance)
        )
        # extend run
        new_fq = jnp.where(in_run & (q < st["fq"]), q, st["fq"])
        new_head = jnp.where(in_run & (q < st["fq"]), t, st["head_t"])
        new_lq = jnp.where(in_run & (q > st["lq"]), q, st["lq"])
        new_cnt = jnp.where(in_run, st["cnt"] + 1, st["cnt"])
        # a break: head was valid and (invalid element | out of range)
        brk = st["head_valid"] & ~in_run
        st2 = emit(st, brk)
        # start new run at cur (if valid)
        st2["head_t"] = jnp.where(in_run, new_head, t)
        st2["fq"] = jnp.where(in_run, new_fq, q)
        st2["lq"] = jnp.where(in_run, new_lq, q)
        st2["cnt"] = jnp.where(in_run, new_cnt, 1)
        st2["head_valid"] = jnp.where(in_run, True, ok)
        st2["head_str"] = jnp.where(in_run, st["head_str"], sgn)
        return st2, None

    xs = (keys.T, qpos.T, valid.T, strand)
    final, _ = jax.lax.scan(step, state, xs)
    # final flush
    final = emit(final, final["head_valid"])
    return {k: v for k, v in final.items() if k.startswith(("k_", "out_len", "r_"))}


def _select_rows(tbl, sid):
    """[B, S] table, [B, A] seed ids -> tbl[b, sid[b, a]]: an exact integer
    gather for any table dtype (CSR starts reach 2^48 at genome scale)."""
    return jnp.take_along_axis(tbl, sid, axis=1)


@partial(jax.jit, static_argnames=("A",))
def _expand_hits(
    starts: jnp.ndarray,  # [B, S] i64 CSR starts per kept seed
    counts: jnp.ndarray,  # [B, S] i64 (0 for dropped seeds)
    qpos: jnp.ndarray,  # [B, S] i32 (real query position)
    qstrand: jnp.ndarray,  # [B, S] i32
    positions: jnp.ndarray,  # [P] u64 index position array
    extracted_len: jnp.ndarray,  # [B] i32
    A: int,
):
    """Flatten ragged per-seed hit lists to [B, A]; project to diagonal keys
    (map.c:294-311) and sort each strand."""
    B, S = starts.shape
    cum = jnp.cumsum(counts, axis=1)  # [B, S]
    total = cum[:, -1]
    a_idx = jnp.arange(A, dtype=jnp.int64)[None, :]
    # owning seed per hit slot: #\{s : cum[s] <= a\} — S is small, so a fused
    # compare+reduce stands in for a per-slot binary search
    sid = (cum.astype(jnp.int32)[:, None, :] <= a_idx.astype(jnp.int32)[:, :, None]).sum(
        axis=2, dtype=jnp.int32
    )
    sid_c = jnp.clip(sid, 0, S - 1)
    sel = partial(_select_rows, sid=sid_c)
    prev_tbl = jnp.concatenate(
        [jnp.zeros((B, 1), cum.dtype), cum[:, :-1]], axis=1
    )
    prev = sel(prev_tbl)
    off_in = a_idx - prev
    pidx = sel(starts) + off_in
    hit = jnp.take(positions, jnp.clip(pidx, 0, len(positions) - 1))
    ok = a_idx < total[:, None]

    qp = sel(qpos)
    qs = sel(qstrand)
    strand = (hit & jnp.uint64(1)).astype(jnp.int32) ^ qs
    loc = ((hit & jnp.uint64(U32)) >> jnp.uint64(1)).astype(jnp.int64)
    chrom = (hit >> jnp.uint64(32)).astype(jnp.int64)
    proj_f = (loc + extracted_len[:, None].astype(jnp.int64) - qp.astype(jnp.int64)) & U32
    proj_r = (loc + qp.astype(jnp.int64)) & U32
    key_f = (chrom.astype(jnp.uint64) << jnp.uint64(32)) | proj_f.astype(jnp.uint64)
    key_r = (chrom.astype(jnp.uint64) << jnp.uint64(32)) | proj_r.astype(jnp.uint64)
    fkey = jnp.where(ok & (strand == 0), key_f, U64_MAX)
    rkey = jnp.where(ok & (strand == 1), key_r, U64_MAX)
    fval = ok & (strand == 0)
    rval = ok & (strand == 1)
    fkey_s, fq_s, fok_s = jax.lax.sort([fkey, qp, fval], dimension=1, num_keys=1)
    rkey_s, rq_s, rok_s = jax.lax.sort([rkey, qp, rval], dimension=1, num_keys=1)
    return fkey_s, fq_s, fok_s, rkey_s, rq_s, rok_s, total


@dataclass(frozen=True)
class StepConfig:
    """Static (trace-time) configuration of the fused step."""

    k: int
    w: int
    pattern: str
    Lmax: int  # read-length budget
    S: int  # seed budget (sketch3)
    S2: int  # per-shift seed budget (sketch2)
    A: int  # hit budget per strand
    K: int  # AF_max_loc
    max_nb_seeds: int  # frag-mode seed cap (or U32)
    frac_mode: bool  # -i < 1
    max_seeds: float
    min_cnt: float
    rec_frac: float
    bw_min: int
    bw_max: int
    bw_frac: float
    occ_dist: int  # mm_seed_select dist (0 = plain high-occ filter)
    max_max_occ: int  # mm_seed_select hard occurrence cap
    q_occ_on: bool
    q_occ_frac: float
    mid_occ: int
    match_a: int
    params: tuple  # (a, b, q, e, q2, e2)
    frag_mode: bool
    bucket_shift: int = 0  # top-bits bucket of the key hash (index/build.py)
    bucket_iters: int = 30  # binary-search depth within a bucket
    # probe = "cuckoo": idx_keys/idx_vals are the bucketed cuckoo table
    # (index/cuckoo.py, 2 sides x NB buckets x 4 slots) — 4 row gathers in
    # 2 independent rounds instead of the bisect's 4-6 dependent ones;
    # "bisect": bucketed binary search
    probe: str = "bisect"
    cuckoo_c1: int = 0
    cuckoo_c2: int = 0
    cuckoo_nb: int = 0  # buckets per side
    dp_frac: float = 1.0  # DP/backtrack row budget as a fraction of B*K
    vote_budget: int = 0  # >0: compact the vote stream to this many hits

    @classmethod
    def from_options(
        cls, mi: DietIndex, mo: MapOptions, mid_occ: int,
        Lmax: int, S: int, S2: int, A: int,
    ) -> "StepConfig":
        frag = bool(mo.flag & MM_F_FRAG_MODE)
        max_nb = (800 if mo.max_frag_len == 0 else mo.max_frag_len) if frag else U32
        return cls(
            k=mi.k, w=mi.w, pattern=mo.pattern, Lmax=Lmax, S=S, S2=S2, A=A,
            K=mo.AF_max_loc, max_nb_seeds=max_nb, frac_mode=mo.max_seeds < 1,
            max_seeds=mo.max_seeds, min_cnt=mo.min_cnt,
            rec_frac=mo.rec_threshold_frac, bw_min=mo.bw_min, bw_max=mo.bw_max,
            bw_frac=mo.bw_frac,
            q_occ_on=mo.q_occ_frac > 0, q_occ_frac=mo.q_occ_frac,
            occ_dist=mo.occ_dist, max_max_occ=mo.max_max_occ,
            mid_occ=mid_occ, match_a=mo.a,
            params=(mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2), frag_mode=frag,
        )


def dp_rows(N: int, dp_frac: float) -> int:
    """Static DP/backtrack row budget for an N-slot candidate set."""
    return min(N, max(128, -(-int(N * dp_frac) // 128) * 128))


def _max_safe_subs(params) -> int:
    """Largest diagonal-mismatch count m for which NO gapped path can match
    the straight-diagonal alignment of two equal-length windows.

    A gap excursion of length g that avoids m' <= min(m, g) mismatches
    changes the score by  a*(m'-g) + b*m' - 2*min(q+e*g, q2+e2*g); this is
    strictly negative for every g <= m iff b*g < 2*min(q+e*g, q2+e2*g).
    Since Suzuki-Kasahara H telescopes path-independently to the corner,
    such windows have ksw_extd2 score a*(L-m) - b*m and a unique all-M
    backtrack — bit-identical to running the kernel (ksw2_extd2_sse.c:34).
    """
    a, b, q, e, q2, e2 = params
    g = 1
    while g < 64 and b * g < 2 * min(q + e * g, q2 + e2 * g):
        g += 1
    return g - 1


def _pattern_tables(cfg: StepConfig):
    """Per-shift gather maps [W, Dmax] + prefix-ones table [W+1]."""
    maps = [pat.gather_map(cfg.Lmax, cfg.pattern, s) for s in range(len(cfg.pattern))]
    Dmax = max(len(m) for m in maps)
    W = len(cfg.pattern)
    arr = np.full((W, Dmax), cfg.Lmax - 1, np.int64)
    for s, m in enumerate(maps):
        arr[s, : len(m)] = m
    pref = np.zeros(W + 1, np.int64)
    for i, c in enumerate(cfg.pattern):
        pref[i + 1] = pref[i] + (c == "1")
    return arr, pref, Dmax


def _diet_slices(codes, shift: int, pattern: str, Dmax: int):
    """Static diet projection codes[:, gather_map(pattern, shift)] expressed
    as strided SLICES instead of a gather: the diet stream of
    pattern Z interleaves codes[:, shift+o::W] for each one-offset o
    (get_real_location, sketch.c:20-23). Values past the per-read diet
    length are garbage; callers mask by diet_len."""
    B, L = codes.shape
    W = len(pattern)
    ones = [i for i, c in enumerate(pattern) if c == "1"]
    m = len(ones)
    T = (Dmax + m - 1) // m
    pad = shift + W * T + W - L
    padded = (
        jnp.concatenate(
            [codes, jnp.full((B, pad), 255, codes.dtype)], axis=1
        ) if pad > 0 else codes
    )
    cols = [padded[:, shift + o : shift + o + W * T : W] for o in ones]
    return jnp.stack(cols, axis=2).reshape(B, T * m)[:, :Dmax]


def _diet_len(lens, shift, pref, W: int):
    """diet_length (sketch.c:1942-1948) on device: [B] int64."""
    ones = pref[W]
    eff = jnp.maximum(lens - shift, 0)
    return (eff // W) * ones + jnp.take(pref, eff % W)


def _to_i32_dev(v):
    v = v & jnp.int64(U32)
    return jnp.where(v >= jnp.int64(1 << 31), v - jnp.int64(1 << 32), v)


def _backtrack_antidiag(dirs, dp_lens, band, Lmax, tlens=None, Lt=None,
                        band_budget=None):
    """Antidiagonal-synchronous device backtrack (ksw_backtrack,
    ksw2.h:131-163) from the terminal corner.

    Iterates r = R-1 .. 0; each row's walker acts exactly when it sits on
    antidiagonal r (every step decreases i+j), so the whole batch walks in
    lock-step over dirs SLICES delivered by the scan — no per-step gathers
    into the [N, R, Wd] tensor, only a per-row column pick within the slice
    (measured on an H100 against a one-hot reduce: 1.40 vs 2.05 ms at the
    short-read shape). With ``band_budget`` set the DP ran with the banded lane window,
    dirs columns are window-relative, and the base is recomputed in closed
    form (ops/dp.py::window_base); band geometry likewise.

    Ops stream out in back-to-front order with 255 holes on idle iterations;
    the RLE consumers skip holes (ops/dp.py cigars_from_ops, srf_rle).
    Returns (ops [N, R] u8, fin_i [N], fin_j [N]).
    """
    i32 = jnp.int32
    N, R, Wd = dirs.shape
    Lt = Lt if Lt is not None else Lmax
    T = dpk._round_up(Lt, 16)
    WB = (dpk.window_geometry(band_budget, Lt)
          if band_budget is not None else None)
    lens = dp_lens.astype(i32)
    tl = lens if tlens is None else tlens.astype(i32)
    w = band.astype(i32)

    BT_U = 8  # antidiagonals per scan iteration (amortizes step overhead)

    def substep(carry, dslice, r):
        i, j, state, active = carry
        act = active & (i + j == r)
        st0 = jnp.maximum(jnp.maximum(0, r - lens + 1), (r - w + 1) >> 1)
        en0 = jnp.minimum(jnp.minimum(tl - 1, r), (r + w) >> 1)
        live = (st0 <= en0) & (r < lens + tl - 1) & (lens > 0)
        off_r = jnp.where(live, st0 // 16 * 16, T)
        off_end_r = jnp.where(
            live, jnp.minimum((en0 + 16) // 16 * 16 - 1, T - 1), -1
        )
        force = jnp.full((N,), -1, i32)
        force = jnp.where(i < off_r, i32(2), force)
        force = jnp.where(i > off_end_r, i32(1), force)
        lo = dpk.window_base(r, band_budget, Lt, WB) if WB else 0
        col = jnp.clip(i - lo, 0, Wd - 1)
        tmp = jnp.take_along_axis(dslice, col[:, None], 1)[:, 0].astype(i32)
        tmp = jnp.where(force >= 0, i32(0), tmp)
        nstate = jnp.where(
            state == 0, tmp & 7,
            jnp.where(((tmp >> (state + 2)) & 1) != 0, state, 0),
        )
        nstate = jnp.where(nstate == 0, tmp & 7, nstate)
        nstate = jnp.where(force >= 0, force, nstate)
        op = jnp.where(
            nstate == 0, i32(dpk.CIGAR_MATCH),
            jnp.where((nstate == 1) | (nstate == 3), i32(dpk.CIGAR_DEL),
                      i32(dpk.CIGAR_INS)),
        )
        di = jnp.where((nstate == 0) | (nstate == 1) | (nstate == 3),
                       i32(1), i32(0))
        dj = jnp.where((nstate == 0) | (nstate == 2) | (nstate == 4),
                       i32(1), i32(0))
        out_op = jnp.where(act, op, 255).astype(jnp.uint8)
        i2 = jnp.where(act, i - di, i)
        j2 = jnp.where(act, j - dj, j)
        state = jnp.where(act, nstate, state)
        active = active & (i2 >= 0) & (j2 >= 0)
        return (i2, j2, state, active), out_op

    def step(carry, xs_t):
        dblk, rblk = xs_t  # [BT_U, N, Wd] u8, [BT_U] i32
        outs = []
        for u in range(BT_U):
            carry, op_u = substep(carry, dblk[u], rblk[u])
            outs.append(op_u)
        return carry, jnp.stack(outs)

    Rpad = -(-R // BT_U) * BT_U
    pad = Rpad - R
    dirs_rev = jnp.swapaxes(dirs, 0, 1)[::-1]
    if pad:  # prepend dead antidiagonals (r >= R never matches any row)
        dirs_rev = jnp.concatenate(
            [jnp.zeros((pad,) + dirs_rev.shape[1:], dirs_rev.dtype), dirs_rev]
        )
    rvals = jnp.arange(Rpad - 1, -1, -1, dtype=i32)
    init = (tl - 1, lens - 1, jnp.zeros((N,), i32), (lens > 0) & (tl > 0))
    xs = (dirs_rev.reshape(Rpad // BT_U, BT_U, N, Wd),
          rvals.reshape(Rpad // BT_U, BT_U))
    (fin_i, fin_j, _, _), ops = jax.lax.scan(step, init, xs)
    return ops.reshape(Rpad, N).T, fin_i, fin_j


# packed-output field order (all cast to int32 in one [B, F] tensor).
# eo/te are NOT transferred: the window geometry guarantees
# te - ts == eo - so == length - 1 on every live candidate (phase 6,
# map.c:764-840), so the host reconstructs them — 2 columns less D2H.
PACK_B = ("shift", "extracted", "fallback")
PACK_BK = ("c_valid", "c_score", "c_strand", "chrom", "so", "ts",
           "length", "exact", "dp_score", "fin_i", "fin_j", "opsrow")


def pack_outputs(fields: dict, K: int) -> jnp.ndarray:
    """[B]-fields + [B,K]-fields -> one [B, 3+14K] i32 tensor (every
    transfer has a fixed latency, so everything small goes device->host in
    a single copy; every field fits 32 bits)."""
    cols = [fields[n].astype(jnp.int32)[:, None] for n in PACK_B]
    cols += [fields[n].astype(jnp.int32) for n in PACK_BK]
    return jnp.concatenate(cols, axis=1)


def pack_ops(ops: jnp.ndarray) -> jnp.ndarray:
    """[N, S] op codes (0/1/2, 255 pad) -> [N, S/4] uint8, 2 bits per op
    (pad becomes 3)."""
    N, S = ops.shape
    v = jnp.minimum(ops, 3).astype(jnp.uint8).reshape(N, S // 4, 4)
    w = jnp.asarray([1, 4, 16, 64], jnp.uint8)
    return (v * w[None, None, :]).sum(axis=2, dtype=jnp.uint8)


def unpack_ops(packed: np.ndarray) -> np.ndarray:
    """Host inverse of pack_ops: [N, S/4] u8 -> [N, S] u8 with 3 = padding."""
    N, SB = packed.shape
    out = np.empty((N, SB, 4), np.uint8)
    for j in range(4):
        out[:, :, j] = (packed >> (2 * j)) & 3
    return out.reshape(N, SB * 4)


# meta fields that provably fit int16 under the SR envelope (qlen <= 300,
# scores <= a*Lmax, seed counts <= S): everything except the reference
# coordinate (ts), contig id (chrom) and the compacted DP row id
# (opsrow), which stay int32
FUSE_I16 = (0, 1, 2, 4, 6, 7, 8, 9, 10)  # PACK_BK indices
FUSE_I32 = (3, 5, 11)


def fuse_out_device(meta: jnp.ndarray, ops: jnp.ndarray, K: int) -> jnp.ndarray:
    """[B, 3+12K] i32 meta + [N2, OB] u8 packed ops -> ONE [R, W] u8
    tensor. Every transfer has a fixed latency, so the whole batch result
    goes device->host in a single copy: the int16-safe meta fields are
    halved on the way and the
    meta byte-block is reflowed DENSELY to the ops width (no per-row pad)."""
    B = meta.shape[0]

    def blk(f):
        b = meta[:, 3 + f * K: 3 + (f + 1) * K]
        if f == 8:  # dp_score: clamp the NEG_INF zdrop sentinel (-2^30)
            # into i16 range — its only use is the min_dp_max comparison,
            # which a guard on the config keeps above -30000
            b = jnp.maximum(b, -32768)
        return b

    m16 = jnp.concatenate(
        [meta[:, :3]] + [blk(f) for f in FUSE_I16], axis=1
    ).astype(jnp.int16)
    m32 = jnp.concatenate([blk(f) for f in FUSE_I32], axis=1)
    b16 = jax.lax.bitcast_convert_type(m16, jnp.uint8).reshape(B, -1)
    b32 = jax.lax.bitcast_convert_type(m32, jnp.uint8).reshape(B, -1)
    row = jnp.concatenate([b16, b32], axis=1)
    W = ops.shape[1]
    flat = row.reshape(-1)
    pad = (-flat.shape[0]) % W
    if pad:
        flat = jnp.concatenate([flat, jnp.zeros((pad,), jnp.uint8)])
    return jnp.concatenate([flat.reshape(-1, W), ops], axis=0)


def fuse_rows(B: int, K: int, OB: int) -> int:
    """Rows the reflowed meta block occupies in the fused tensor."""
    per_row = 2 * (3 + len(FUSE_I16) * K) + 4 * len(FUSE_I32) * K
    return -(-B * per_row // OB)


def unfuse_out(out_np: np.ndarray, B: int, K: int, OB: int):
    """Host inverse of fuse_out_device: -> (meta [B, 3+len(PACK_BK)*K] i32,
    ops [N2, OB] u8)."""
    F16 = 3 + len(FUSE_I16) * K
    F32 = len(FUSE_I32) * K
    MR = fuse_rows(B, K, OB)
    b = out_np[:MR].reshape(-1)[: B * (2 * F16 + 4 * F32)].reshape(B, -1)
    m16 = np.ascontiguousarray(b[:, : 2 * F16]).view("<i2")
    m32 = np.ascontiguousarray(b[:, 2 * F16: 2 * F16 + 4 * F32]).view("<i4")
    meta = np.empty((B, 3 + len(PACK_BK) * K), np.int32)
    meta[:, :3] = m16[:, :3]
    for j, f in enumerate(FUSE_I16):
        meta[:, 3 + f * K: 3 + (f + 1) * K] = m16[:, 3 + j * K: 3 + (j + 1) * K]
    for j, f in enumerate(FUSE_I32):
        meta[:, 3 + f * K: 3 + (f + 1) * K] = m32[:, j * K: (j + 1) * K]
    ops = out_np[MR:, :OB]
    return meta, ops


def unpack_outputs(meta: np.ndarray, K: int) -> dict:
    out = {}
    for c, name in enumerate(PACK_B):
        out[name] = meta[:, c]
    for f, name in enumerate(PACK_BK):
        out[name] = meta[:, 3 + f * K : 3 + (f + 1) * K]
    out["fallback"] = out["fallback"].astype(bool)
    out["c_valid"] = out["c_valid"].astype(bool)
    out["exact"] = out["exact"].astype(bool)
    # reconstructed (not transferred): spans are equal on live candidates
    out["eo"] = out["so"] + out["length"] - 1
    out["te"] = out["ts"] + out["length"] - 1
    return out


def _seed_select_device(cnts, qpos, seed_ok, lens, cfg: StepConfig):
    """mm_seed_select (seed.c:66-106), exactly, as sorts + scans (no
    gathers): for each streak of consecutive high-occurrence collected
    seeds (bounded by seeds with n <= mid_occ), keep the
    (span/dist + .499) least-frequent ones — the heap's survivors equal
    the H smallest (n, index) pairs since indices arrive in increasing
    order — and always drop n > max_max_occ; a read with <= 1 collected
    seed is left untouched (the reference's early return).

    Returns the kept mask [B, S] over collected seeds (the !flt set of
    mm_collect_matches2, seed.c:149-154).
    """
    B, S = cnts.shape
    i64 = I64
    present = seed_ok & (cnts > 0)
    low = present & (cnts <= cfg.mid_occ)
    high = present & ~low
    n_present = present.sum(axis=1)
    idx = jnp.arange(S, dtype=i64)[None, :]
    q64 = qpos.astype(i64)

    # ps: qpos of the last low seed before each lane (0 if none);
    # pe: qpos of the next low seed after it (qlen if none). High lanes are
    # not low, so at-or-before / at-or-after scans give strictly-adjacent
    # bounds for them (seed.c:79-80).
    BIGP = jnp.int64(1) << 62
    packed = jnp.where(low, (idx << 32) | q64, jnp.int64(-1))
    ps_pack = jax.lax.associative_scan(jnp.maximum, packed, axis=1)
    ps = jnp.where(ps_pack >= 0, ps_pack & 0xFFFFFFFF, 0)
    packed2 = jnp.where(low, (idx << 32) | q64, BIGP)
    pe_pack = jnp.flip(
        jax.lax.associative_scan(jnp.minimum, jnp.flip(packed2, 1), axis=1), 1
    )
    pe = jnp.where(pe_pack < BIGP, pe_pack & 0xFFFFFFFF, lens[:, None])

    # max_high_occ per lane (double arithmetic, int truncation; seed.c:83-85)
    H = ((pe - ps).astype(jnp.float64) / cfg.occ_dist + 0.499).astype(i64)
    H = jnp.minimum(H, 128)  # MAX_MAX_HIGH_OCC

    # rank the high seeds of each streak by (n, index): one composite-key
    # sort groups streaks and orders within them; rank = offset from the
    # group start. sid (streak id) = #lows at-or-before the lane.
    sid = jnp.cumsum(low.astype(i64), axis=1)
    BIG = jnp.int64(1) << 62
    nq = jnp.minimum(cnts.astype(i64), 0xFFFFFF)
    key = jnp.where(high, (sid << 40) | (nq << 16) | idx, BIG)
    idx_b = jnp.broadcast_to(idx, (B, S))
    key_s, orig_s, H_s = jax.lax.sort(
        [key, idx_b, H], dimension=1, num_keys=1
    )
    grp = key_s >> 40
    is_start = jnp.concatenate(
        [jnp.ones((B, 1), bool), grp[:, 1:] != grp[:, :-1]], axis=1
    )
    start_idx = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_start, idx, -1), axis=1
    )
    rank = idx - start_idx
    sel_sorted = (key_s < BIG) & (rank < H_s)
    _, sel = jax.lax.sort(
        [orig_s, sel_sorted.astype(jnp.int32)], dimension=1, num_keys=1
    )
    selected = sel.astype(bool)

    kept = present & (low | (selected & (cnts <= cfg.max_max_occ)))
    return jnp.where((n_present <= 1)[:, None], present, kept)


def collect_hits(
    codes,  # [B, Lmax] uint8 (255 pad)
    lens,  # [B] int64
    idx_keys,
    idx_vals,
    idx_positions,
    idx_buckets,
    maps,
    pref,
    cfg: StepConfig,
    ref_axis: str | None = None,
    n_ref: int = 1,
    upto: str | None = None,
):
    """Shared device front of mm_map_frag (phases 1-3: shift inference,
    query sketch, CSR lookup, hit expansion + per-strand sort). Used by both
    the short-read fused step and the long-read pipeline.

    Returns (fallback, shift, extracted, mv_n, capped,
             fk, fq, fok, rk, rq, rok, A_stream).

    ``upto`` cuts the computation early for the five-stage profiler
    (utils/profile.py; the reference's -DPROFILE split, profile.h:6-28):
    "pattern" stops after shift inference, returning (fallback, shift).
    """
    B = codes.shape[0]
    W = len(cfg.pattern)
    k, w = cfg.k, cfg.w
    rid0 = jnp.zeros((B,), I64)

    def lookup(q):
        """mm_idx_get (index.c:84-100) as a batched device probe.

        cuckoo: two independent (key, val) slot fetches — 4 gathers, serial
        depth 2. bisect: bucket-table lower bound — ~4-6 dependent gathers.
        """
        if cfg.probe == "cuckoo":
            # bucketed table: 2 sides x NB buckets x 4 contiguous slots,
            # keys and values MERGED per bucket (k0..3, v0..3) — ONE row
            # gather per side, the two sides
            # independent — serial HBM depth 2. The table ships as
            # [rows, 128] u64 = 16 buckets per tile row (a [buckets, 8]
            # layout lane-pads 8 -> 128 and burns 16x HBM, device_cuckoo_kv)
            # and the probe picks its bucket's 8 lanes in-register.
            NB = jnp.uint64(cfg.cuckoo_nb)
            t1 = (q * jnp.uint64(cfg.cuckoo_c1)) >> jnp.uint64(32)
            b1 = ((t1 * NB) >> jnp.uint64(32)).astype(I64)
            t2 = (q * jnp.uint64(cfg.cuckoo_c2)) >> jnp.uint64(32)
            b2 = ((t2 * NB) >> jnp.uint64(32)).astype(I64) + cfg.cuckoo_nb
            lanes = jnp.arange(128, dtype=I64)
            is_key = (lanes & 7) < 4  # [128]

            def side(b):
                row = jnp.take(idx_keys, b >> 4, axis=0)  # [..., 128]
                in_bkt = (lanes >> 3) == (b & 15)[..., None]
                m = in_bkt & is_key & (row == q[..., None])
                # the value of slot j sits 4 lanes above its key lane;
                # rolled-in wrap lanes have is_key False, so never match
                vrow = jnp.roll(row, -4, axis=-1)
                return (jnp.where(m, vrow, jnp.uint64(0)).sum(axis=-1),
                        m.any(axis=-1))

            v1, f1 = side(b1)
            v2, f2 = side(b2)
            # keys unique -> at most one slot matches across both sides
            v = v1 + v2
            found = f1 | f2
            s = (v >> jnp.uint64(24)).astype(I64)
            c = (v & jnp.uint64(0xFFFFFF)).astype(I64)
            return jnp.where(found, s, 0), jnp.where(found, c, 0)
        nk = idx_keys.shape[0]
        nb = idx_buckets.shape[0] - 1
        j = jnp.clip(
            (q >> jnp.uint64(cfg.bucket_shift)).astype(I64), 0, max(nb - 1, 0)
        )
        lo = jnp.take(idx_buckets, j)
        hi = jnp.take(idx_buckets, j + 1)
        for _ in range(cfg.bucket_iters):
            mid = (lo + hi) >> 1
            km = jnp.take(idx_keys, jnp.clip(mid, 0, max(nk - 1, 0)))
            open_ = lo < hi
            go_r = open_ & (km < q)
            lo = jnp.where(go_r, mid + 1, lo)
            hi = jnp.where(open_ & ~go_r, mid, hi)
        found = (nk > 0) & (lo < nk) & (
            jnp.take(idx_keys, jnp.clip(lo, 0, max(nk - 1, 0))) == q
        )
        v = jnp.take(idx_vals, jnp.clip(lo, 0, max(nk - 1, 0)))
        s = (v >> jnp.uint64(24)).astype(I64)
        c = (v & jnp.uint64(0xFFFFFF)).astype(I64)
        return jnp.where(found, s, 0), jnp.where(found, c, 0)

    def sketch(diet_codes, diet_len, rp, cap_out):
        return sketch_emit(
            diet_codes, diet_len, rp, rid0, k, w, cap_out, final_flush_ge=True
        )

    fallback = jnp.zeros((B,), bool)
    Dmax = maps.shape[1]

    if not cfg.frac_mode:
        # ---- phases 1+2 merged (absolute -i): mm_sketch2 per shift IS the
        # full-read sketch, so the chosen shift's mm_sketch3 seed stream
        # equals the phase-1 one — sketch each shift ONCE at the full seed
        # budget, then select by argmax shift (mm_sketch2/mm_sketch3
        # sketch.c:2143/1908, mm_get_shift seed.c:166). Only the first
        # `-i` seeds' occurrence counts feed the shift argmax, so the
        # inference lookups probe just those columns; the selected shift's
        # full stream is looked up once in phase 3 — ~3x fewer probe-row
        # gathers than full-budget lookups of every shift ----
        nb_hits = []
        per_shift = []
        cap = jnp.full((B,), cfg.max_seeds, I64)
        unlimited = cap == 0  # cap==0 means "no cap" (see sketch.c push loop)
        cap_int = int(cfg.max_seeds)
        cap_cols = cfg.S if cap_int <= 0 else min(cfg.S, cap_int)
        effs = []
        for s in range(W):
            dlen = _diet_len(lens, s, pref, W)
            rp = jnp.broadcast_to(maps[s], (B, Dmax))
            dc = _diet_slices(codes, s, cfg.pattern, Dmax)
            xs_s, ys_s, _, n_s = sketch(dc, dlen, rp, cfg.S)
            eff = jnp.where(unlimited, n_s, jnp.minimum(n_s, cap))
            fallback = fallback | ((n_s >= cfg.S) & (unlimited | (cap > cfg.S)))
            effs.append(eff)
            per_shift.append((xs_s, ys_s, n_s))
        # ONE probe call for all shifts' capped columns (gathers have a
        # fixed launch cost on top of the per-row cost)
        qcat = jnp.concatenate(
            [t[0][:, :cap_cols] for t in per_shift], axis=1
        ) >> jnp.uint64(8)
        _, cnt_cat = lookup(qcat)
        if ref_axis is not None:
            cnt_cat = jax.lax.psum(cnt_cat, ref_axis)
        for s in range(W):
            cnt_g = cnt_cat[:, s * cap_cols : (s + 1) * cap_cols]
            mask = jnp.arange(cap_cols, dtype=I64)[None, :] < effs[s][:, None]
            nb_hits.append((cnt_g * mask).sum(axis=1))
        shift = jnp.argmax(jnp.stack(nb_hits), axis=0).astype(I64)

        def _sel(field):
            out = per_shift[0][field]
            for s in range(1, W):
                cond = shift == s
                c = cond[:, None] if per_shift[s][field].ndim == 2 else cond
                out = jnp.where(c, per_shift[s][field], out)
            return out

        xs, ys, n3 = _sel(0), _sel(1), _sel(2)
        starts = cnts_local = cnts_global = None  # phase 3 looks up once
        if cfg.S < cfg.max_nb_seeds:
            fallback = fallback | (n3 > cfg.S)
    else:
        # ---- phase 1: shift inference (mm_sketch2 + mm_get_shift) ----
        len_crop0 = (lens.astype(jnp.float64) * cfg.max_seeds).astype(I64)
        nb_hits = []
        cap_vec = None
        for s in range(W):
            lc = len_crop0 if s == 0 else lens
            dlen = _diet_len(lc, s, pref, W)
            rp = jnp.broadcast_to(maps[s], (B, Dmax))
            dc = _diet_slices(codes, s, cfg.pattern, Dmax)
            xs_s, ys_s, _, n = sketch(dc, dlen, rp, cfg.S2)
            if s == 0:
                cap_vec = n  # sketch.c:2219-2222
                eff = n
                over = n >= cfg.S2
            else:
                # the reference stops a shift's scan only when the push count
                # EQUALS the cap (checked after each push), so a cap of 0 —
                # e.g. the cropped shift-0 scan emitted nothing — never
                # fires and means "no cap"
                unlimited = cap_vec == 0
                eff = jnp.where(unlimited, n, jnp.minimum(n, cap_vec))
                over = (n >= cfg.S2) & (unlimited | (cap_vec > cfg.S2))
            fallback = fallback | over
            _, cnts = lookup(xs_s >> jnp.uint64(8))
            if ref_axis is not None:
                cnts = jax.lax.psum(cnts, ref_axis)
            mask = jnp.arange(cfg.S2, dtype=I64)[None, :] < eff[:, None]
            nb_hits.append((cnts * mask).sum(axis=1))
        shift = jnp.argmax(jnp.stack(nb_hits), axis=0).astype(I64)

        # ---- phase 2: query sketch (mm_sketch3) ----
        dlen3 = _diet_len(lens, shift, pref, W)
        rp3 = jnp.take(maps, shift, axis=0)
        dc3 = jnp.take_along_axis(codes, rp3, axis=1)
        xs, ys, _, n3 = sketch(dc3, dlen3, rp3, cfg.S)
        if cfg.S < cfg.max_nb_seeds:
            fallback = fallback | (n3 > cfg.S)
        starts = cnts_local = cnts_global = None

    if upto == "pattern":  # five-stage profiler cut (pf_pattern_alignment)
        return fallback, shift

    cap_col = min(cfg.max_nb_seeds, cfg.S) - 1
    capped = n3 >= cfg.max_nb_seeds
    extracted = jnp.where(
        capped,
        ((ys[:, cap_col] & jnp.uint64(U32)) >> jnp.uint64(1)).astype(I64),
        lens,
    )
    mv_n = jnp.minimum(n3, cfg.max_nb_seeds)
    if cfg.q_occ_on:
        # mm_seed_mz_flt (seed.c:5-29) drops minimizers only when their
        # within-query occurrence exceeds BOTH mid_occ and n*q_occ_frac.
        # Compute the maximal duplicate-run length on device: the filter is
        # a no-op (the overwhelmingly common case) unless that maximum
        # violates both bounds — only then fall back to the exact oracle.
        valid_seed = jnp.arange(cfg.S, dtype=I64)[None, :] < jnp.minimum(mv_n, cfg.S)[:, None]
        xs_sorted = jnp.sort(jnp.where(valid_seed, xs, U64_MAX), axis=1)
        pos = jnp.arange(cfg.S, dtype=I64)[None, :]
        is_start = jnp.concatenate(
            [jnp.ones((B, 1), bool), xs_sorted[:, 1:] != xs_sorted[:, :-1]],
            axis=1,
        )
        run_start = jax.lax.associative_scan(
            jnp.maximum, jnp.where(is_start, pos, -1), axis=1
        )
        runlen = pos - run_start + 1
        dup_ok = jnp.where(xs_sorted != U64_MAX, runlen, 0)
        maxdup = dup_ok.max(axis=1)
        noop = (maxdup <= cfg.mid_occ) | (
            maxdup.astype(jnp.float64)
            <= mv_n.astype(jnp.float64) * cfg.q_occ_frac
        )
        fallback = fallback | ((mv_n > cfg.mid_occ) & ~noop)

    # ---- phase 3: seed lookup + hit expansion ----
    seed_ok = jnp.arange(cfg.S, dtype=I64)[None, :] < jnp.minimum(mv_n, cfg.S)[:, None]
    if starts is None:
        starts, cnts_local = lookup(
            jnp.where(seed_ok, xs >> jnp.uint64(8), U64_MAX)
        )
        cnts = (
            jax.lax.psum(cnts_local, ref_axis) if ref_axis is not None
            else cnts_local
        )
    else:  # merged path: per-shift lookups already selected above
        cnts = cnts_global
    qpos = ((ys & jnp.uint64(U32)) >> jnp.uint64(1)).astype(jnp.int32)
    if cfg.occ_dist > 0 and cfg.max_max_occ > cfg.mid_occ:
        # exact mm_seed_select on device (mm_collect_matches2 gate,
        # seed.c:149): high-occurrence streaks keep their least-frequent
        # members instead of forcing the whole read to the oracle
        kept = _seed_select_device(cnts, qpos, seed_ok, lens, cfg)
    else:
        kept = seed_ok & (cnts > 0) & (cnts <= cfg.mid_occ)
    fallback = fallback | (jnp.where(kept, cnts, 0).sum(axis=1) > cfg.A)
    # key-range sharding keeps all occurrences of a key on one shard, so the
    # local expansion counts are the owning shard's counts (0 elsewhere)
    kcounts = jnp.where(kept, cnts_local, 0)
    qstrand = (ys & jnp.uint64(1)).astype(jnp.int32)
    fk, fq, fok, rk, rq, rok, _ = _expand_hits(
        starts.astype(I64), kcounts.astype(I64), qpos, qstrand,
        idx_positions, extracted.astype(jnp.int32), cfg.A,
    )
    A_stream = cfg.A
    if ref_axis is not None:
        A_stream = cfg.A * n_ref

        def merge(key, q, okm):
            keyg = jax.lax.all_gather(key, ref_axis, axis=1, tiled=True)
            qg_ = jax.lax.all_gather(q, ref_axis, axis=1, tiled=True)
            okg = jax.lax.all_gather(okm, ref_axis, axis=1, tiled=True)
            return jax.lax.sort([keyg, qg_, okg], dimension=1, num_keys=1)

        fk, fq, fok = merge(fk, fq, fok)
        rk, rq, rok = merge(rk, rq, rok)

    return (fallback, shift, extracted, mv_n, capped,
            fk, fq, fok, rk, rq, rok, A_stream)


def _window_rows(flat, fstart, L):
    """Contiguous-window gather: out[n, j] = flat[fstart[n] + j] (garbage —
    zeros or neighbours — where fstart+j is out of range; callers mask).

    Gathers 128-byte chunk ROWS (fast) and aligns each row with a 128-way
    masked shift select instead of gathering L elements per row (slow)."""
    N = fstart.shape[0]
    Cn = (L + 127) // 128 + 2  # chunks covering rem + L
    pad_front = 256
    total = flat.shape[0] + pad_front
    total_pad = (total + Cn * 128 + 127) // 128 * 128 + Cn * 128
    flat_p = jnp.zeros((total_pad,), flat.dtype)
    flat_p = jax.lax.dynamic_update_slice(flat_p, flat, (pad_front,))
    fp = jnp.clip(fstart + pad_front, 0, total_pad - Cn * 128)
    crow = fp // 128
    rows = crow[:, None] + jnp.arange(Cn, dtype=fp.dtype)[None, :]
    buf = jnp.take(flat_p.reshape(-1, 128), rows.reshape(-1), axis=0)
    buf = buf.reshape(N, Cn * 128)
    rem = (fp - crow * 128).astype(jnp.int32)
    # two-level masked shift (rem = 16*hi + lo): 8 + 16 selects instead of
    # a 128-way select — 5x less traffic for the same alignment
    hi = rem // 16
    lo = rem % 16
    mid = jnp.zeros((N, L + 16), flat.dtype)
    for s in range(8):
        sl = jax.lax.dynamic_slice_in_dim(buf, 16 * s, L + 16, 1)
        mid = jnp.where((hi == s)[:, None], sl, mid)
    out = jnp.zeros((N, L), flat.dtype)
    for s in range(16):
        sl = jax.lax.dynamic_slice_in_dim(mid, s, L, 1)
        out = jnp.where((lo == s)[:, None], sl, out)
    return out


def pack_ref_codes(codes: np.ndarray):
    """2-bit pack of reference nt4 codes for device residency — the analog
    of the reference's 4-bit ``mi->S`` pack (index.c:350-357) at twice the
    density: 4 bases/byte = a 4x HBM cut vs uint8 (GRCh38: 3 GB -> 0.78 GB).

    N/ambiguous bases (code > 3) pack as 0 and are restored from a separate
    1-bit/base mask; ``nmask`` is None when the genome has none (the common
    case for synthetic/bacterial refs), costing nothing then.
    """
    codes = np.asarray(codes, np.uint8)
    L = len(codes)
    pad = (-L) % 4
    c = (codes & 3).astype(np.uint8)
    if pad:
        c = np.concatenate([c, np.zeros(pad, np.uint8)])
    packed = (c[0::4] | (c[1::4] << 2) | (c[2::4] << 4) | (c[3::4] << 6))
    nmask = None
    if bool((codes > 3).any()):
        n = (codes > 3).astype(np.uint8)
        padn = (-L) % 8
        if padn:
            n = np.concatenate([n, np.zeros(padn, np.uint8)])
        nmask = np.packbits(n.reshape(-1, 8), axis=1, bitorder="little").ravel()
    return packed.astype(np.uint8), nmask


def _window_rows_packed(packed, fstart, L, nmask=None):
    """Contiguous-window gather from the 2-bit packed reference:
    out[n, j] = code at base fstart[n]+j. Gathers packed BYTES (4 bases
    each) through _window_rows — 4x less gather traffic than the uint8
    path — unpacks in registers and aligns with a 4-way sub-byte select.
    N positions (code 4) are restored from the 1-bit nmask when present."""
    N = fstart.shape[0]
    bstart = jnp.right_shift(fstart, 2)
    sub = (fstart - 4 * bstart).astype(jnp.int32)  # 0..3 (also for fstart<0)
    Lb = L // 4 + 2
    braw = _window_rows(packed, bstart, Lb).astype(jnp.int32)  # [N, Lb]
    codes4 = (
        braw[:, :, None] >> (2 * jnp.arange(4, dtype=jnp.int32))[None, None, :]
    ) & 3
    codes4 = codes4.reshape(N, Lb * 4)
    out = jnp.zeros((N, L), jnp.int32)
    for s in range(4):
        sl = jax.lax.dynamic_slice_in_dim(codes4, s, L, 1)
        out = jnp.where((sub == s)[:, None], sl, out)
    if nmask is not None:
        b8 = jnp.right_shift(fstart, 3)
        sub8 = (fstart - 8 * b8).astype(jnp.int32)
        Ln = L // 8 + 2
        nraw = _window_rows(nmask, b8, Ln).astype(jnp.int32)
        bits = (
            nraw[:, :, None] >> jnp.arange(8, dtype=jnp.int32)[None, None, :]
        ) & 1
        bits = bits.reshape(N, Ln * 8)
        nb = jnp.zeros((N, L), jnp.int32)
        for s in range(8):
            sl = jax.lax.dynamic_slice_in_dim(bits, s, L, 1)
            nb = jnp.where((sub8 == s)[:, None], sl, nb)
        out = jnp.where(nb != 0, 4, out)
    return out.astype(jnp.uint8)


def fused_map_step(
    codes,  # [B, Lmax] uint8 (255 pad)
    lens,  # [B] int64
    idx_keys,  # [Kidx] uint64
    idx_vals,  # [Kidx] uint64 (start << 24 | count)
    idx_positions,  # [P] uint64
    idx_buckets,  # [2^b+1] int64 bucket table over idx_keys
    ref_codes,  # [ceil(total_ref_len/4)] uint8 2-bit pack (pack_ref_codes)
    ref_offsets,  # [n_seq] int64
    ref_lengths,  # [n_seq] int64
    maps,  # [W, Dmax] int64 per-shift gather maps
    pref,  # [W+1] int64 pattern prefix-ones
    cfg: StepConfig,
    ref_axis: str | None = None,
    n_ref: int = 1,
    backtrack: bool = True,
    ref_nmask=None,  # [ceil(total_ref_len/8)] uint8 N bitmask, or None
    upto: str | None = None,  # five-stage profiler cut: "pattern" | "seed"
    # | "vote" | None (full step) — see utils/profile.py
):
    """The fused forward step. All args are arrays except static ``cfg``.

    When ``ref_axis`` is set the index arrays are one key-range shard of the
    CSR index per device along that mesh axis: per-seed occurrence counts are
    combined with ``psum`` and per-shard expanded hit streams are merged with
    ``all_gather`` + re-sort — the device analog of the reference's
    split-index merge (map.c:1094-1163, splitidx.c).
    """
    B = codes.shape[0]
    k = cfg.k
    if upto == "pattern":
        return collect_hits(
            codes, lens, idx_keys, idx_vals, idx_positions, idx_buckets,
            maps, pref, cfg, ref_axis, n_ref, upto="pattern",
        )
    fallback, shift, extracted, mv_n, capped, fk, fq, fok, rk, rq, rok, A_stream = (
        collect_hits(
            codes, lens, idx_keys, idx_vals, idx_positions, idx_buckets,
            maps, pref, cfg, ref_axis, n_ref,
        )
    )
    if upto == "seed":
        return fk, fq, fok, rk, rq, rok

    # ---- phase 4: voting ----
    bw = (lens.astype(jnp.float64) * cfg.bw_frac).astype(I64)
    bw = jnp.clip(bw, cfg.bw_min, cfg.bw_max)
    capped_mask = capped & jnp.bool_(cfg.frag_mode) & (extracted < lens)
    vt_thr = jnp.where(
        capped_mask,
        jnp.int64(int(cfg.max_nb_seeds * cfg.min_cnt)),
        (mv_n.astype(jnp.float64) * cfg.min_cnt).astype(I64),
    )
    vt_thr = jnp.maximum(vt_thr, 1)
    vt_rec = jnp.where(
        capped_mask,
        jnp.int64(int(cfg.max_nb_seeds * cfg.rec_frac)),
        (mv_n.astype(jnp.float64) * cfg.rec_frac).astype(I64),
    )
    barrier = jnp.full((B, 1), U64_MAX, jnp.uint64)
    bq = jnp.zeros((B, 1), jnp.int32)
    bok = jnp.zeros((B, 1), bool)
    keys = jnp.concatenate([fk, barrier, rk, barrier], axis=1)
    qv = jnp.concatenate([fq, bq, rq, bq], axis=1)
    okv = jnp.concatenate([fok, bok, rok, bok], axis=1)
    strand_stream = jnp.concatenate(
        [jnp.zeros(A_stream + 1, jnp.int32), jnp.ones(A_stream + 1, jnp.int32)]
    )
    vt = _vote_scan(
        keys, qv, okv, strand_stream,
        bw.astype(jnp.uint64), vt_thr.astype(jnp.int32), vt_rec.astype(jnp.int32),
        cfg.K, A_stream,
    )
    if upto == "vote":
        return vt

    # ---- phase 5: candidate construction (top-K + recovery substitution) ----
    K = cfg.K
    use_rec = (vt["out_len"] == 0) & (vt["r_score"] > 0)
    slot = jnp.arange(K, dtype=jnp.int32)[None, :]
    c_valid = jnp.where(use_rec[:, None], slot == 0, slot < vt["out_len"][:, None])
    c_tgt = jnp.where(use_rec[:, None], vt["r_target"][:, None], vt["k_target"])
    c_str = jnp.where(use_rec[:, None], vt["r_str"][:, None], vt["k_str"])
    c_score = jnp.where(use_rec[:, None], vt["r_score"][:, None], vt["k_score"])

    off = jnp.where(c_str != 0, jnp.int64(0), -extracted[:, None])
    loc = _to_i32_dev((c_tgt & jnp.uint64(U32)).astype(I64) + off)
    loc = jnp.where(c_str != 0, loc - (k - 1), loc)

    # ---- phase 6: window geometry (map.c:764-840) ----
    chrom = (c_tgt >> jnp.uint64(32)).astype(I64)
    chrom_c = jnp.clip(chrom, 0, max(ref_lengths.shape[0] - 1, 0))
    tlen = jnp.take(ref_lengths, chrom_c)
    qlen = lens[:, None]
    # reverse strand
    te_r0 = loc
    so_r = jnp.maximum(te_r0 - (tlen - 1), 0)
    te_r1 = jnp.minimum(te_r0, tlen - 1)
    cond_r = te_r1 < qlen - so_r - 1
    eo_r = jnp.where(cond_r, so_r + te_r1, qlen - 1)
    ts_r = jnp.where(cond_r, jnp.int64(0), te_r1 - (eo_r - so_r))
    te_r = te_r1
    # forward strand
    ts_f0 = loc
    so_f = jnp.maximum(-ts_f0, 0)
    ts_f1 = jnp.maximum(ts_f0, 0)
    cond_f = (tlen - ts_f1) < (qlen - so_f)
    eo_f = jnp.where(cond_f, tlen - 1 - ts_f1 + so_f, qlen - 1)
    te_f = jnp.where(cond_f, tlen - 1, ts_f1 + (eo_f - so_f))
    ts_f = ts_f1

    rev = c_str != 0
    so = jnp.where(rev, so_r, so_f)
    eo = jnp.where(rev, eo_r, eo_f)
    ts = jnp.where(rev, ts_r, ts_f)
    te = jnp.where(rev, te_r, te_f)
    length = eo - so + 1
    bad = (length <= 0) | (length > cfg.Lmax) | (ts < 0)
    fallback = fallback | (c_valid & bad).any(axis=1)
    live = c_valid & ~bad

    # ---- phase 7: window gathers. The windows are CONTIGUOUS ranges, so
    # instead of per-element gathers gather whole 128-byte chunk rows and
    # align with a shift select (ROADMAP Design 3-4 revisits this) ----
    j = jnp.arange(cfg.Lmax, dtype=I64)[None, None, :]  # [1, 1, L]
    in_win = j < length[:, :, None]
    s0 = jnp.where(rev, eo - (cfg.Lmax - 1), so)
    bidx = jnp.arange(B, dtype=I64)[:, None]
    fstart_q = bidx * cfg.Lmax + s0  # may dip below 0 for reverse windows
    qraw = _window_rows(codes.reshape(-1), fstart_q.reshape(-1), cfg.Lmax)
    qraw = qraw.reshape(B, K, cfg.Lmax).astype(jnp.int32)
    qg = jnp.where(rev[:, :, None], jnp.flip(qraw, axis=2) ^ 3, qraw)
    qbuf = jnp.where(in_win & live[:, :, None], qg, 0).astype(jnp.uint8)
    fstart_t = jnp.take(ref_offsets, chrom_c) + ts
    tg = _window_rows_packed(
        ref_codes, fstart_t.reshape(-1), cfg.Lmax, nmask=ref_nmask
    )
    tg = tg.reshape(B, K, cfg.Lmax)
    tbuf = jnp.where(in_win & live[:, :, None], tg, 0).astype(jnp.uint8)

    # ---- phase 8: exact-match, then banded DP + backtrack on the COMPACTED
    # set of candidates that actually need a DP (live, not exact-matched):
    # typically ~1/3 of the B*K slots, so the DP tiles, the dirs tensor and
    # the per-step backtrack gathers all shrink accordingly ----
    exact = (qlen < 300) & live & (qbuf == tbuf).all(axis=2)
    # substitution-only shortcut: windows whose diagonal has <= m_safe
    # mismatches (and no ambiguous bases) provably align all-M with score
    # a*(L-m) - b*m — no DP row needed (see _max_safe_subs)
    m_safe = _max_safe_subs(cfg.params)
    diff = (qbuf != tbuf) & in_win
    nfree = ~(((qbuf > 3) | (tbuf > 3)) & in_win).any(axis=2)
    mism = diff.sum(axis=2, dtype=jnp.int32)
    sub_only = (
        live & ~exact & nfree & (mism <= m_safe)
        & ((eo - so) == (te - ts))
    )
    N = B * K
    need = (live & ~exact & ~sub_only).reshape(N)
    N2 = dp_rows(N, cfg.dp_frac)
    bandN = jnp.broadcast_to(bw[:, None], (B, K)).reshape(N).astype(jnp.int32)
    dp_lens = jnp.where(exact | ~live, 0, length).astype(jnp.int32).reshape(N)
    perm = jnp.argsort(jnp.where(need, 0, 1).astype(jnp.int32),
                       stable=True).astype(jnp.int32)
    # slot -> compacted row: the inverse permutation as one scatter (an
    # argsort of the permutation trips XLA's GPU permutation_sort_simplifier
    # under x64, "accumulator shape s32[] vs s64[]")
    rank = jnp.zeros((N,), jnp.int32).at[perm].set(
        jnp.arange(N, dtype=jnp.int32))
    overflow = need & (rank >= N2)
    fallback = fallback | overflow.reshape(B, K).any(axis=1)
    sel = perm[:N2]
    qb2 = jnp.take(qbuf.reshape(N, cfg.Lmax), sel, axis=0)
    tb2 = jnp.take(tbuf.reshape(N, cfg.Lmax), sel, axis=0)
    len2 = jnp.take(dp_lens, sel)
    band2 = jnp.take(bandN, sel)
    score2, dirs = dpk.extd2(
        qb2, tb2, len2, len2, band2, cfg.params, cfg.Lmax, cfg.Lmax,
        band_budget=cfg.bw_max,
    )
    rank_c = jnp.clip(rank, 0, N2 - 1)
    score = jnp.where(need, jnp.take(score2, rank_c), 0).reshape(B, K)
    a_, b_ = cfg.params[0], cfg.params[1]
    score = jnp.where(
        sub_only,
        (a_ * (length - mism) - b_ * mism).astype(jnp.int32), score,
    )
    score = jnp.where(exact, (qlen * cfg.match_a).astype(jnp.int32), score)

    if backtrack:
        # walk the direction bytes on device: the ops tensor going to the
        # host is ~100x smaller than dirs (which never leaves HBM)
        ops2, fin_i2, fin_j2 = _backtrack_antidiag(
            dirs, len2, band2, cfg.Lmax, band_budget=cfg.bw_max,
        )
        fin_i = jnp.where(need, jnp.take(fin_i2, rank_c), 0)
        fin_j = jnp.where(need, jnp.take(fin_j2, rank_c), 0)
        pad = (-ops2.shape[1]) % 4
        if pad:
            ops2 = jnp.concatenate(
                [ops2, jnp.full((N2, pad), 255, jnp.uint8)], axis=1
            )
        ops_packed = pack_ops(ops2)
    else:
        ops_packed = jnp.full((N2, 2 * cfg.Lmax // 4), 255, jnp.uint8)
        fin_i = fin_j = jnp.zeros((N,), jnp.int32)

    # opsrow: >=0 -> compacted op-stream row; -2 -> all-M (sub_only);
    # -1 -> no CIGAR available (dead slot / overflow -> read falls back)
    opsrow = jnp.where(need & ~overflow, rank, -1).reshape(B, K)
    opsrow = jnp.where(sub_only, -2, opsrow)
    fields = {
        "shift": shift,
        "extracted": extracted,
        "fallback": fallback,
        "c_valid": live,
        "c_score": c_score,
        "c_strand": c_str,
        "chrom": chrom,
        "so": so,
        "eo": eo,
        "ts": ts,
        "te": te,
        "length": length,
        "exact": exact,
        "dp_score": score,
        "fin_i": fin_i.reshape(B, K),
        "fin_j": fin_j.reshape(B, K),
        "opsrow": opsrow,
    }
    # two device->host copies per batch: the i32 meta tensor and the 2-bit
    # op streams of the compacted DP rows
    return {"meta": pack_outputs(fields, K), "ops": ops_packed}


class FusedMapper:
    """Holds device index arrays + the jitted fused step for one config."""

    def __init__(self, index: DietIndex, mo: MapOptions,
                 Lmax: int = 256, S: int = 160, S2: int = 64, A: int = 2048,
                 dp_frac: float = 1.0):
        mid_occ = index.derive_mid_occ(mo)
        # seeds can never exceed the diet length of the longest read
        dmax = pat.diet_length(Lmax, mo.pattern, 0)
        self.cfg = StepConfig.from_options(
            index, mo, mid_occ, Lmax, min(S, dmax), min(S2, dmax), A
        )
        self.cfg = dataclass_replace(self.cfg, dp_frac=dp_frac)
        tkv, c1, c2, nb = index.device_cuckoo_kv()
        self.cfg = dataclass_replace(
            self.cfg, probe="cuckoo", cuckoo_c1=c1, cuckoo_c2=c2,
            cuckoo_nb=nb,
        )
        maps, pref, _ = _pattern_tables(self.cfg)
        packed, nmask = index.device_packed()
        self.arrays = dict(
            idx_keys=tkv,  # merged (k0..3, v0..3) rows; vals unused
            idx_vals=jnp.zeros((1,), jnp.uint64),
            idx_positions=jnp.asarray(index.positions),
            idx_buckets=jnp.zeros((1,), jnp.int64),  # unused under cuckoo
            ref_codes=packed,
            ref_offsets=jnp.asarray(index.seq_offsets),
            ref_lengths=jnp.asarray(index.lengths),
            maps=jnp.asarray(maps),
            pref=jnp.asarray(pref),
        )
        if nmask is not None:
            self.arrays["ref_nmask"] = nmask
        # single fused u8 D2H tensor when every i16-packed field provably
        # fits (SR envelope); wide configs keep the two-tensor layout
        cfg_ = self.cfg
        a = max(abs(p) for p in cfg_.params)
        self.fuse = (cfg_.Lmax <= 4096 and cfg_.S <= 16384
                     and a * cfg_.Lmax < 32768 and 2 * cfg_.Lmax < 32768
                     and 2 * cfg_.A + 2 < 32768 and mo.min_dp_max > -30000)
        if self.fuse:
            def _step(codes, lens, **arrays):
                d = fused_map_step(codes, lens, **arrays, cfg=cfg_)
                return {"out": fuse_out_device(d["meta"], d["ops"], cfg_.K)}

            # combined input: [B, Lmax+8] u8 with the read length bitcast
            # into the last 8 bytes per row — ONE H2D transfer per batch
            # (every transfer has a fixed latency)
            def _step_combined(comb, **arrays):
                codes = comb[:, : cfg_.Lmax]
                lens = jax.lax.bitcast_convert_type(
                    comb[:, cfg_.Lmax:], jnp.int64
                ).reshape(comb.shape[0])
                return _step(codes, lens, **arrays)

            # 2-bit packed combined input: [B, Lmax/4 | Lmax/8 | 8] u8 =
            # packed bases | N bitmask | lens — a further ~2.6x H2D cut
            # codes are rebuilt on device: pad from lens, N from the mask
            L_ = cfg_.Lmax
            PB, NB8 = L_ // 4, L_ // 8

            def _step_packed(comb, **arrays):
                B = comb.shape[0]
                packed = comb[:, :PB].astype(jnp.int32)
                nmask = comb[:, PB:PB + NB8].astype(jnp.int32)
                lens = jax.lax.bitcast_convert_type(
                    comb[:, PB + NB8:], jnp.int64
                ).reshape(B)
                sh2 = (2 * jnp.arange(4, dtype=jnp.int32))[None, None, :]
                codes4 = ((packed[:, :, None] >> sh2) & 3).reshape(B, L_)
                sh1 = jnp.arange(8, dtype=jnp.int32)[None, None, :]
                nbits = ((nmask[:, :, None] >> sh1) & 1).reshape(B, L_)
                j = jnp.arange(L_, dtype=jnp.int64)[None, :]
                codes = jnp.where(nbits != 0, 4, codes4)
                codes = jnp.where(
                    j >= lens[:, None], 255, codes
                ).astype(jnp.uint8)
                return _step(codes, lens, **arrays)

            self._jit = jax.jit(_step)
            self._jit_combined = jax.jit(_step_combined)
            self._jit_packed = (
                jax.jit(_step_packed) if L_ % 8 == 0 else None
            )
        else:
            self._jit = jax.jit(partial(fused_map_step, cfg=cfg_))
            self._jit_combined = None
            self._jit_packed = None

    def __call__(self, codes, lens) -> dict:
        from gdiet_tpu import native as _native

        if (self._jit_packed is not None and isinstance(codes, np.ndarray)
                and _native.lib is not None):
            B = codes.shape[0]
            L_ = self.cfg.Lmax
            PB, NB8 = L_ // 4, L_ // 8
            comb = np.empty((B, PB + NB8 + 8), np.uint8)
            packed, nmask = _native.pack_codes_batch(codes)
            comb[:, :PB] = packed
            comb[:, PB:PB + NB8] = nmask
            comb[:, PB + NB8:] = np.ascontiguousarray(
                lens, "<i8").view(np.uint8).reshape(B, 8)
            return self._jit_packed(jnp.asarray(comb), **self.arrays)
        if self._jit_combined is not None and isinstance(codes, np.ndarray):
            B = codes.shape[0]
            comb = np.empty((B, self.cfg.Lmax + 8), np.uint8)
            comb[:, : self.cfg.Lmax] = codes
            comb[:, self.cfg.Lmax:] = np.ascontiguousarray(
                lens, "<i8").view(np.uint8).reshape(B, 8)
            return self._jit_combined(jnp.asarray(comb), **self.arrays)
        return self._jit(jnp.asarray(codes), jnp.asarray(lens), **self.arrays)

    def fetch(self, dev: dict, B: int):
        """Device outputs -> (meta [B, 3+12K] i32, ops u8) on host."""
        if "out" in dev:
            return unfuse_out(np.asarray(dev["out"]), B, self.cfg.K,
                              2 * self.cfg.Lmax // 4)
        return np.asarray(dev["meta"])[:B], np.asarray(dev["ops"])

    # ------------------------------------------------------------------
    def staged_times(self, codes, lens) -> dict:
        """Five-stage device profile (the reference's -DPROFILE split,
        profile.h:6-28 / print_profile main.c:671): re-runs the fused step
        cut at each phase boundary (upto=pattern/seed/vote/full) and
        returns the MARGINAL seconds of the four mapping stages. Synced by
        tiny checksum fetches with the fetch floor subtracted. Opt-in (verbose
        >= 4): it re-executes the step 4x, like a profiling build."""
        import time as _time

        if not hasattr(self, "_staged_jits"):
            cfg_ = self.cfg

            def ck(out):
                leaves = jax.tree_util.tree_leaves(out)
                s = jnp.int32(0)
                for x in leaves:
                    if x.dtype == jnp.uint64:
                        s += (x & jnp.uint64(0xFFFF)).astype(jnp.int32).sum()
                    elif x.dtype == jnp.bool_:
                        s += x.sum().astype(jnp.int32)
                    else:
                        s += x.astype(jnp.int32).sum()
                return s

            def mk(upto):
                def f(codes, lens, **arrays):
                    return ck(fused_map_step(
                        codes, lens, **arrays, cfg=cfg_, upto=upto))
                return jax.jit(f)

            self._staged_jits = [
                ("pattern", mk("pattern")), ("seed", mk("seed")),
                ("vote", mk("vote")), ("align", mk(None)),
            ]
            self._floor_jit = jax.jit(lambda c: c[0, 0].astype(jnp.int32))

        codes_d = jnp.asarray(np.asarray(codes, np.uint8))
        lens_d = jnp.asarray(np.asarray(lens, np.int64))
        np.asarray(self._floor_jit(codes_d))
        t0 = _time.perf_counter()
        np.asarray(self._floor_jit(codes_d))
        floor = _time.perf_counter() - t0
        out = {}
        prev = 0.0
        for name, f in self._staged_jits:
            np.asarray(f(codes_d, lens_d, **self.arrays))  # compile/warm
            t0 = _time.perf_counter()
            np.asarray(f(codes_d, lens_d, **self.arrays))
            dt = max(_time.perf_counter() - t0 - floor, 0.0)
            out[name] = max(dt - prev, 0.0)
            prev = dt
        return out
