"""Batched banded dual affine-gap alignment (device scoring + host backtrack).

Device re-design of ksw_extd2 (GDiet-ShortReads/ksw2_extd2_sse.c:34-402):
the Suzuki-Kasahara difference recurrence is evaluated as a lax.scan over
anti-diagonals with [N, T] int32 lanes (N = batch of candidate pairs, T =
padded target length). To stay bit-identical to the reference we replicate
its block behavior: per diagonal only lanes in the 16-aligned band
[st_al, en_al] are updated (others keep stale values, exactly like the SSE
lanes the C code never touches), substitution scores are refreshed 16 lanes
at a time from st0, and the boundary difference values x1/x21/v1 fall back
to constants when the previous diagonal did not cover st_al-1.

GDiet calls this kernel with KSW_EZ_APPROX_MAX on equal-length windows
(map.c:867-929): no Z-drop, score = greedy approximate terminal H (H0
tracking, ksw2_extd2_sse.c:367-383), CIGAR backtracked from the terminal
corner with left-aligned gaps. Direction bytes are returned for the host
backtrack (ksw_backtrack, ksw2.h:131-163), which is vectorized over the
batch.

Long-read windows (up to 32768 x 34048) cannot hold full-width direction
bytes, so ``band_budget`` confines each wavefront's work and its dirs row to
a sliding lane window (window_geometry / window_base) that provably covers
every row's band; lanes outside it keep their values, exactly as in the
full-width recurrence.

``extd2`` is the single device entry point: the CUDA kernel (ops/dp_cuda.py)
when lowered for the GPU, ``extd2_batch`` everywhere else.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = -0x40000000

CIGAR_MATCH, CIGAR_INS, CIGAR_DEL = 0, 1, 2


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def window_geometry(band_budget: int, Lt: int) -> int | None:
    """Banded lane-window width for a largest bandwidth ``band_budget``, or
    None when it would not be narrower than the 128-aligned target budget.

    Coverage: at wavefront r a row with band w <= band_budget touches lanes
    from st_al - 1 >= ((r - w + 1) >> 1) - 16 up to at most
    ((r + w) >> 1) + 15 (the 16-lane substitution refresh); window_base sits
    at most 16 + 127 lanes below the first bound, so a width of
    band_budget + 161 suffices (+176 keeps the historical slack)."""
    WB = _round_up(band_budget + 176, 128)
    return WB if WB < _round_up(Lt, 128) else None


def window_base(r, band_budget: int, Lt: int, WB: int):
    """First lane (a multiple of 128) of the window at wavefront r; the base
    never decreases with r. Works on python ints and traced int32 alike."""
    lo = ((r - band_budget + 1) >> 1) - 16
    return jnp.clip(lo, 0, _round_up(Lt, 128) - WB) // 128 * 128


def dp_scoring(params: tuple) -> tuple:
    """(a, b, q, e, q2, e2, long_thres, long_diff) with the gap pairs ordered
    so that q+e <= q2+e2 (ksw2_extd2_sse.c:78)."""
    a, b, q, e, q2, e2 = (int(p) for p in params)
    if q2 + e2 < q + e:
        q, q2, e, e2 = q2, q, e2, e
    long_thres = (q2 - q) // (e - e2) - 1 if e != e2 else 0
    if q2 + e2 + long_thres * e2 > q + e + long_thres * e:
        long_thres += 1
    long_diff = long_thres * (e - e2) - (q2 - q) - e2
    return a, b, q, e, q2, e2, long_thres, long_diff


def extd2(query, target, qlens, tlens, band, params: tuple, Lmax: int,
          Lt: int, band_budget: int | None = None):
    """Device DP: (score [N] int32, dirs [N, R, Wd] uint8), the layout of
    extd2_batch. Lowered for the GPU it runs the CUDA kernel
    (ops/dp_cuda.py); on every other platform the XLA scan (extd2_xla)."""
    from gdiet_tpu.ops import dp_cuda

    kw = dict(params=tuple(params), Lmax=Lmax, Lt=Lt, band_budget=band_budget)
    return jax.lax.platform_dependent(
        query, target, qlens.astype(jnp.int32), tlens.astype(jnp.int32),
        band.astype(jnp.int32), cuda=partial(dp_cuda.extd2_cuda, **kw),
        default=partial(extd2_xla, **kw),
    )


def extd2_xla(query, target, qlens, tlens, band, *, params: tuple,
              Lmax: int, Lt: int, band_budget: int | None = None):
    """extd2 through the XLA scan on any platform (the reference the kernel
    is measured against)."""
    score, dirs, _, _ = extd2_batch(
        query, target, qlens, band, np.array(params, np.int32), Lmax,
        tlens=tlens, Lt=Lt, band_budget=band_budget,
    )
    return score, dirs


@partial(jax.jit, static_argnames=("Lmax", "Lt", "band_budget"))
def extd2_batch(
    query: jnp.ndarray,  # [N, Lmax] uint8 codes, zero-padded beyond qlen
    target: jnp.ndarray,  # [N, Lt|Lmax] uint8 codes, zero-padded beyond tlen
    lens: jnp.ndarray,  # [N] int32 qlens (also tlens when tlens is None)
    band: jnp.ndarray,  # [N] int32 bandwidth w
    params: jnp.ndarray,  # [6] int32: a, b, q, e, q2, e2 (b positive)
    Lmax: int,
    tlens: jnp.ndarray | None = None,  # [N] int32 target lengths
    Lt: int | None = None,  # static target budget (defaults to Lmax)
    band_budget: int | None = None,  # static bound on band: banded window
):
    """Returns (score [N] int32, dirs [N, R, Wd] uint8, offs [N, R] int32,
    off_ends [N, R] int32) with R = Lmax+Lt-1, T = Lt rounded up to 16, and
    Wd = T, or the window width when ``band_budget`` engages the banded
    window; then dirs column c of wavefront r is lane
    window_base(r, band_budget, Lt, Wd) + c.

    Candidates with lens[i] == 0 produce score NEG_INF.
    """
    N = query.shape[0]
    if Lt is None:
        Lt = Lmax
    T = _round_up(Lt, 16)
    TQ = _round_up(Lmax, 16)
    R = Lmax + Lt - 1
    WB = window_geometry(band_budget, Lt) if band_budget is not None else None
    TS = _round_up(Lt, 128) if WB else T  # state width
    Wd = WB or T

    params = jnp.asarray(params, jnp.int32)
    a = params[0]
    b = params[1]
    q = params[2]
    e = params[3]
    q2 = params[4]
    e2 = params[5]
    # ensure q+e <= q2+e2 (ksw2_extd2_sse.c:78)
    swap = q2 + e2 < q + e
    q, q2 = jnp.where(swap, q2, q), jnp.where(swap, q, q2)
    e, e2 = jnp.where(swap, e2, e), jnp.where(swap, e, e2)
    sc_mch = a
    sc_mis = -b
    sc_N = -e2

    long_thres = jnp.where(e != e2, (q2 - q) // (e - e2) - 1, 0)
    long_thres = jnp.where(
        q2 + e2 + long_thres * e2 > q + e + long_thres * e, long_thres + 1, long_thres
    )
    long_diff = long_thres * (e - e2) - (q2 - q) - e2

    qlen = lens.astype(jnp.int32)
    tlen = qlen if tlens is None else tlens.astype(jnp.int32)
    w = band.astype(jnp.int32)

    wlanes = jnp.arange(Wd, dtype=jnp.int32)[None, :]  # [1, Wd]

    qe_init = -(q + e)
    qe2_init = -(q2 + e2)
    u0 = jnp.full((N, TS), qe_init, jnp.int32)
    v0 = jnp.full((N, TS), qe_init, jnp.int32)
    x0 = jnp.full((N, TS), qe_init, jnp.int32)
    y0 = jnp.full((N, TS), qe_init, jnp.int32)
    x20 = jnp.full((N, TS), qe2_init, jnp.int32)
    y20 = jnp.full((N, TS), qe2_init, jnp.int32)
    s0 = jnp.zeros((N, TS), jnp.int32)

    sf = jnp.zeros((N, TS), jnp.int32).at[:, : target.shape[1]].set(
        target.astype(jnp.int32)
    )
    qpad = jnp.zeros((N, TQ), jnp.int32).at[:, :Lmax].set(query.astype(jnp.int32))

    def boundary_u(r):
        # u/v initial diffs along the edges (ksw2_extd2_sse.c:158,162)
        return jnp.where(
            r == 0,
            -(q + e),
            jnp.where(r < long_thres, -e, jnp.where(r == long_thres, long_diff, -e2)),
        )

    def lane_at(arr, idx):  # arr[n, clip(idx[n])] over the full state width
        return jnp.take_along_axis(arr, jnp.clip(idx, 0, T - 1)[:, None], 1)[:, 0]

    def step(carry, r):
        state, H0, last_H0_t, last_st, last_en, score = carry
        r32 = r.astype(jnp.int32)
        st0 = jnp.maximum(jnp.maximum(0, r32 - qlen + 1), (r32 - w + 1) >> 1)
        en0 = jnp.minimum(jnp.minimum(tlen - 1, r32), (r32 + w) >> 1)
        live = (st0 <= en0) & (r32 < qlen + tlen - 1) & (qlen > 0)
        st = st0 // 16 * 16
        en = (en0 + 16) // 16 * 16 - 1
        en = jnp.minimum(en, T - 1)

        # boundary values (ksw2_extd2_sse.c:149-163)
        u_f, v_f, x_f, y_f, x2_f, y2_f, s_f = state
        prev_ok = (st > 0) & (st - 1 >= last_st) & (st - 1 <= last_en)
        x1 = jnp.where(prev_ok, lane_at(x_f, st - 1), -(q + e))
        x21 = jnp.where(prev_ok, lane_at(x2_f, st - 1), -(q2 + e2))
        bu = boundary_u(r32)
        v1 = jnp.where(st > 0, jnp.where(prev_ok, lane_at(v_f, st - 1),
                                         -(q + e)), bu)

        # the lanes this wavefront touches: the whole state, or the window
        if WB:
            lo = window_base(r32, band_budget, Lt, WB)
            win = lambda arr: jax.lax.dynamic_slice_in_dim(arr, lo, Wd, 1)
        else:
            lo = jnp.int32(0)
            win = lambda arr: arr
        lanes = lo + wlanes
        u, v, x, y, x2, y2, s = (win(arr) for arr in state)

        # edge-lane init at t == r (ksw2_extd2_sse.c:160-163)
        at_edge = (lanes == r32) & (en[:, None] >= r32) & live[:, None]
        y = jnp.where(at_edge, -(q + e), y)
        y2 = jnp.where(at_edge, -(q2 + e2), y2)
        u = jnp.where(at_edge, bu, u)

        # substitution scores for lanes [st0, st0+16*ceil(span/16)-1]
        span16 = (en0 - st0) // 16 * 16 + 16
        in_s = (lanes >= st0[:, None]) & (lanes < (st0 + span16)[:, None]) & live[:, None]
        # qrr[t] = qr[qlen-1-r+t] = query[r-t] when in range, 0 otherwise
        qi = jnp.broadcast_to(r32 - lanes, (N, Wd))  # query index per lane
        qv = jnp.where(
            (qi >= 0) & (qi < qlen[:, None]),
            jnp.take_along_axis(qpad, jnp.clip(qi, 0, TQ - 1), axis=1),
            0,
        )
        sq = win(sf)
        nmask = (sq == 4) | (qv == 4)
        sval = jnp.where(sq == qv, sc_mch, sc_mis)
        sval = jnp.where(nmask, sc_N, sval)
        s = jnp.where(in_s, sval, s)

        in_al = (lanes >= st[:, None]) & (lanes <= en[:, None]) & live[:, None]

        x_prev = jnp.concatenate([jnp.zeros((N, 1), jnp.int32), x[:, :-1]], axis=1)
        v_prev = jnp.concatenate([jnp.zeros((N, 1), jnp.int32), v[:, :-1]], axis=1)
        x2_prev = jnp.concatenate([jnp.zeros((N, 1), jnp.int32), x2[:, :-1]], axis=1)
        at_st = lanes == st[:, None]
        x_prev = jnp.where(at_st, x1[:, None], x_prev)
        v_prev = jnp.where(at_st, v1[:, None], v_prev)
        x2_prev = jnp.where(at_st, x21[:, None], x2_prev)

        zv = s
        a_ = x_prev + v_prev
        b_ = y + u
        a2_ = x2_prev + v_prev
        b2_ = y2 + u
        d = jnp.where(a_ > zv, jnp.uint8(1), jnp.uint8(0))
        zv = jnp.maximum(zv, a_)
        d = jnp.where(b_ > zv, jnp.uint8(2), d)
        zv = jnp.maximum(zv, b_)
        d = jnp.where(a2_ > zv, jnp.uint8(3), d)
        zv = jnp.maximum(zv, a2_)
        d = jnp.where(b2_ > zv, jnp.uint8(4), d)
        zv = jnp.maximum(zv, b2_)
        zv = jnp.minimum(zv, sc_mch)

        u_new = zv - v_prev
        v_new = zv - u
        a_p = a_ - (zv - q)
        b_p = b_ - (zv - q)
        a2_p = a2_ - (zv - q2)
        b2_p = b2_ - (zv - q2)
        x_new = jnp.maximum(a_p, 0) - (q + e)
        y_new = jnp.maximum(b_p, 0) - (q + e)
        x2_new = jnp.maximum(a2_p, 0) - (q2 + e2)
        y2_new = jnp.maximum(b2_p, 0) - (q2 + e2)
        d = d | jnp.where(a_p > 0, jnp.uint8(0x08), jnp.uint8(0))
        d = d | jnp.where(b_p > 0, jnp.uint8(0x10), jnp.uint8(0))
        d = d | jnp.where(a2_p > 0, jnp.uint8(0x20), jnp.uint8(0))
        d = d | jnp.where(b2_p > 0, jnp.uint8(0x40), jnp.uint8(0))

        u = jnp.where(in_al, u_new, u)
        v = jnp.where(in_al, v_new, v)
        x = jnp.where(in_al, x_new, x)
        y = jnp.where(in_al, y_new, y)
        x2 = jnp.where(in_al, x2_new, x2)
        y2 = jnp.where(in_al, y2_new, y2)
        d_out = jnp.where(in_al, d, jnp.uint8(0))
        if WB:
            state = tuple(
                jax.lax.dynamic_update_slice_in_dim(full, part, lo, 1)
                for full, part in zip(state, (u, v, x, y, x2, y2, s))
            )
        else:
            state = (u, v, x, y, x2, y2, s)
        u_f, v_f = state[0], state[1]

        # approximate H0 tracking (ksw2_extd2_sse.c:367-383)
        lt = last_H0_t
        lt_in = (lt >= st0) & (lt <= en0)
        lt1_in = (lt + 1 >= st0) & (lt + 1 <= en0)
        v_lt = lane_at(v_f, lt)
        u_lt1 = lane_at(u_f, lt + 1)
        both = lt_in & lt1_in
        d0gt = v_lt > u_lt1
        H0_new = jnp.where(
            both,
            jnp.where(d0gt, H0 + v_lt, H0 + u_lt1),
            jnp.where(lt_in, H0 + v_lt, H0 + u_lt1),
        )
        lt_new = jnp.where(both, jnp.where(d0gt, lt, lt + 1), jnp.where(lt_in, lt, lt + 1))
        first = r32 == 0
        v_0 = v_f[:, 0]
        H0 = jnp.where(live, jnp.where(first, v_0 - (q + e), H0_new), H0)
        last_H0_t = jnp.where(live, jnp.where(first, 0, lt_new), last_H0_t)

        hit_end = live & (r32 == qlen + tlen - 2) & (en0 == tlen - 1)
        score = jnp.where(hit_end, H0, score)

        last_st = jnp.where(live, st, last_st)
        last_en = jnp.where(live, en, last_en)
        st_out = jnp.where(live, st, jnp.int32(T))
        en_out = jnp.where(live, en, jnp.int32(-1))
        return (
            (state, H0, last_H0_t, last_st, last_en, score),
            (d_out, st_out, en_out),
        )

    init = (
        (u0, v0, x0, y0, x20, y20, s0),
        jnp.zeros((N,), jnp.int32),
        jnp.zeros((N,), jnp.int32),
        jnp.full((N,), -1, jnp.int32),
        jnp.full((N,), -1, jnp.int32),
        jnp.full((N,), NEG_INF, jnp.int32),
    )
    carry, (dirs, offs, off_ends) = jax.lax.scan(
        step, init, jnp.arange(R, dtype=jnp.int32)
    )
    score = carry[-1]
    # candidate-major layout (what the device backtrack consumes)
    return score, dirs.transpose(1, 0, 2), offs.T, off_ends.T


def cigars_from_ops(
    ops: np.ndarray,  # [N, SMAX] uint8 op codes back-to-front, >=3 padding
    fin_i: np.ndarray,  # [N] leftover target index after the walk
    fin_j: np.ndarray,  # [N] leftover query index
    lens: np.ndarray,  # [N]
) -> list[list[tuple[int, int]]]:
    """Run-length encode device-backtracked op streams into CIGARs,
    including the leading-gap leftovers (ksw2.h:157-158)."""
    cigars: list[list[tuple[int, int]]] = []
    for n in range(len(lens)):
        if lens[n] <= 0:
            cigars.append([])
            continue
        row = ops[n]
        row = row[row < 3]
        run: list[tuple[int, int]] = []
        for opv in row:
            opv = int(opv)  # plain int: np.uint8 ops overflow (l << 4) later
            if run and run[-1][1] == opv:
                run[-1] = (run[-1][0] + 1, opv)
            else:
                run.append((1, opv))
        if fin_i[n] >= 0:
            if run and run[-1][1] == CIGAR_DEL:
                run[-1] = (run[-1][0] + int(fin_i[n]) + 1, CIGAR_DEL)
            else:
                run.append((int(fin_i[n]) + 1, CIGAR_DEL))
        if fin_j[n] >= 0:
            if run and run[-1][1] == CIGAR_INS:
                run[-1] = (run[-1][0] + int(fin_j[n]) + 1, CIGAR_INS)
            else:
                run.append((int(fin_j[n]) + 1, CIGAR_INS))
        run.reverse()
        cigars.append(run)
    return cigars


def backtrack_batch(
    dirs: np.ndarray,  # [N, R, T] uint8
    offs: np.ndarray,  # [N, R]
    off_ends: np.ndarray,  # [N, R]
    lens: np.ndarray,  # [N] qlens
    tlens: np.ndarray | None = None,  # [N] (defaults to lens)
) -> list[list[tuple[int, int]]]:
    """Vectorized ksw_backtrack (ksw2.h:131-163) from the terminal corner.

    Returns per-candidate CIGARs as (len, op) lists (MM_CIGAR codes).
    """
    N = len(lens)
    if tlens is None:
        tlens = lens
    i = tlens.astype(np.int64) - 1
    j = lens.astype(np.int64) - 1
    state = np.zeros(N, np.int64)
    active = (lens > 0) & (tlens > 0)
    max_steps = int((lens + tlens).max()) if N else 0
    ops = np.full((N, max_steps + 2), -1, np.int8)
    ncol = dirs.shape[2]
    step_idx = np.zeros(N, np.int64)
    while active.any():
        r = i + j
        rc = np.clip(r, 0, dirs.shape[1] - 1)
        off_r = offs[np.arange(N), rc]
        off_end_r = off_ends[np.arange(N), rc]
        force_state = np.full(N, -1, np.int64)
        force_state = np.where(i < off_r, 2, force_state)
        force_state = np.where(i > off_end_r, 1, force_state)
        tmp = dirs[np.arange(N), rc, np.clip(i, 0, ncol - 1)].astype(np.int64)
        tmp = np.where(force_state >= 0, 0, tmp)
        state = np.where(state == 0, tmp & 7, np.where((tmp >> (state + 2)) & 1, state, 0))
        state = np.where(state == 0, tmp & 7, state)
        state = np.where(force_state >= 0, force_state, state)
        op = np.where(state == 0, CIGAR_MATCH, np.where((state == 1) | (state == 3), CIGAR_DEL, CIGAR_INS))
        di = np.where((state == 0) | (state == 1) | (state == 3), 1, 0)
        dj = np.where((state == 0) | (state == 2) | (state == 4), 1, 0)
        write = active & (i >= 0) & (j >= 0)
        ops[np.arange(N)[write], step_idx[write]] = op[write]
        step_idx = np.where(write, step_idx + 1, step_idx)
        i = np.where(write, i - di, i)
        j = np.where(write, j - dj, j)
        active = active & (i >= 0) & (j >= 0)
    # leading gap for whichever axis is left (ksw2.h:157-158)
    cigars: list[list[tuple[int, int]]] = []
    i_np, j_np = np.asarray(i), np.asarray(j)
    for n in range(N):
        if lens[n] <= 0 or tlens[n] <= 0:
            cigars.append([])
            continue
        run: list[tuple[int, int]] = []
        row = ops[n, : step_idx[n]]
        # ops are emitted back-to-front; build runs then reverse
        for opv in row:
            if run and run[-1][1] == opv:
                run[-1] = (run[-1][0] + 1, opv)
            else:
                run.append((1, int(opv)))
        if i_np[n] >= 0:
            if run and run[-1][1] == CIGAR_DEL:
                run[-1] = (run[-1][0] + int(i_np[n]) + 1, CIGAR_DEL)
            else:
                run.append((int(i_np[n]) + 1, CIGAR_DEL))
        if j_np[n] >= 0:
            if run and run[-1][1] == CIGAR_INS:
                run[-1] = (run[-1][0] + int(j_np[n]) + 1, CIGAR_INS)
            else:
                run.append((int(j_np[n]) + 1, CIGAR_INS))
        run.reverse()
        cigars.append(run)
    return cigars
