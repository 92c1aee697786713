"""Device DP (ops/dp.py::extd2 and its CUDA kernel) and the code around it.

The CUDA kernel has no interpret mode: its source is checked here through
the host emulation in ops/cuda/extd2_emu.cc (every GPU thread a host thread,
the barriers real barriers), and on the card by the ``gpu`` test below and
chip_smoke.py. Everything is integer arithmetic: equality is exact.
"""

import ctypes
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gdiet_tpu import compile_cache_dir, native
from gdiet_tpu.ops import dp as dpk
from gdiet_tpu.ops.dp_cuda import SRC_DIR, kernel_config
from gdiet_tpu.pipeline import longread as lrp
from gdiet_tpu.pipeline.device_step import (
    _backtrack_antidiag, _expand_hits, _select_rows,
)

SR_PRM = (2, 8, 12, 2, 24, 1)
LR_PRM = (1, 2, 2, 1, 32, 0)


def _pairs(rng, N, Lq, Lt, unequal=True):
    """Related windows (subs, indels, N bases), one random pair, one empty."""
    Q = np.zeros((N, Lq), np.uint8)
    T = np.zeros((N, Lt), np.uint8)
    ql = rng.integers(max(1, Lq // 3), Lq + 1, N).astype(np.int32)
    tl = np.zeros(N, np.int32)
    for i in range(N):
        q = rng.integers(0, 5 if i % 4 == 0 else 4, ql[i]).astype(np.uint8)
        t = q.copy()
        for _ in range(int(rng.integers(0, 12))):
            j = int(rng.integers(0, len(t)))
            op = rng.random()
            if op < 0.5:
                t[j] = rng.integers(0, 4)
            elif op < 0.75:
                t = np.insert(t, j, rng.integers(0, 4))
            elif len(t) > 1:
                t = np.delete(t, j)
        if unequal:
            t = np.concatenate([t, rng.integers(0, 4, int(rng.integers(0, 30)))])
        if i == 1:
            t = rng.integers(0, 4, len(t)).astype(np.uint8)
        t = t[:Lt].astype(np.uint8)
        Q[i, :ql[i]] = q
        T[i, :len(t)] = t
        tl[i] = len(t)
    ql[0] = 0
    return Q, T, ql, tl


def _xla(Q, T, ql, tl, band, prm, Lq, Lt, bb):
    out = dpk.extd2_batch(
        jnp.asarray(Q), jnp.asarray(T), jnp.asarray(ql), jnp.asarray(band),
        np.array(prm, np.int32), Lq, tlens=jnp.asarray(tl), Lt=Lt,
        band_budget=bb)
    return [np.asarray(x) for x in out]


# (Lmax, Lt, band budget, bands): the SR shape, where the window never
# engages, and LR-shaped buckets where it does
SHAPES = [
    (160, 160, 200, (150, 200)),
    (300, 700, 200, (60, 200)),
    (200, 600, 60, (7, 33, 60)),
]


@pytest.mark.parametrize("Lq,Lt,bb,bands", SHAPES)
def test_banded_window_matches_full_width(Lq, Lt, bb, bands):
    rng = np.random.default_rng(Lq + Lt)
    N = 11
    Q, T, ql, tl = _pairs(rng, N, Lq, Lt)
    band = rng.choice(bands, N).astype(np.int32)
    s_w, d_w, o_w, e_w = _xla(Q, T, ql, tl, band, SR_PRM, Lq, Lt, bb)
    s_f, d_f, o_f, e_f = _xla(Q, T, ql, tl, band, SR_PRM, Lq, Lt, None)
    np.testing.assert_array_equal(s_w, s_f)
    np.testing.assert_array_equal(o_w, o_f)
    np.testing.assert_array_equal(e_w, e_f)
    WB = dpk.window_geometry(bb, Lt)
    if WB is None:
        np.testing.assert_array_equal(d_w, d_f)
        return
    assert d_w.shape == (N, Lq + Lt - 1, WB)
    full = np.zeros((N, d_f.shape[1], dpk._round_up(Lt, 128)), np.uint8)
    full[:, :, : d_f.shape[2]] = d_f
    for r in range(d_f.shape[1]):
        lo = int(dpk.window_base(r, bb, Lt, WB))
        np.testing.assert_array_equal(d_w[:, r], full[:, r, lo:lo + WB])


@pytest.mark.parametrize("prm", [SR_PRM, LR_PRM])
def test_banded_dp_backtrack_matches_c_oracle(prm):
    assert native.lib is not None, "native library failed to build"
    rng = np.random.default_rng(sum(prm))
    N, Lq, Lt, bb = 12, 240, 560, 64
    Q, T, ql, tl = _pairs(rng, N, Lq, Lt)
    band = rng.choice([9, 40, 64], N).astype(np.int32)
    assert dpk.window_geometry(bb, Lt) is not None  # the window engages
    score, dirs = dpk.extd2(
        jnp.asarray(Q), jnp.asarray(T), jnp.asarray(ql), jnp.asarray(tl),
        jnp.asarray(band), prm, Lq, Lt, band_budget=bb)
    ops, fin_i, fin_j = _backtrack_antidiag(
        dirs, jnp.asarray(ql), jnp.asarray(band), Lq, tlens=jnp.asarray(tl),
        Lt=Lt, band_budget=bb)
    cigars = dpk.cigars_from_ops(np.asarray(ops), np.asarray(fin_i),
                                 np.asarray(fin_j), ql)
    for i in range(1, N):
        sc, cig = native.extd2_approx(Q[i, :ql[i]], T[i, :tl[i]], *prm,
                                      int(band[i]))
        assert int(score[i]) == sc, i
        # no CIGAR when the band never reaches the corner (pipeline rule)
        assert (cigars[i] if sc != dpk.NEG_INF else []) == cig, i
    assert int(score[0]) == dpk.NEG_INF  # the empty row
    assert (score[1:] != dpk.NEG_INF).sum() >= N // 2


def test_kernel_config_geometry():
    cfg, R, W = kernel_config(SR_PRM, 160, 160, 200)
    assert (R, W) == (319, 160) and cfg[6] == -1  # no window at the SR shape
    assert list(cfg[:6]) == [160, 160, 319, 160, 160, 160]
    cfg, R, W = kernel_config(LR_PRM, 2048, 3072, 1000)
    assert W == dpk.window_geometry(1000, 3072) == 1280
    assert list(cfg[:7]) == [2048, 3072, 5119, 3072, 3072, 1280, 1000]
    # the gap pairs are ordered so that q+e <= q2+e2 (ksw2_extd2_sse.c:78)
    a, b, q, e, q2, e2, lthr, ldiff = dpk.dp_scoring((2, 4, 24, 1, 4, 2))
    assert (q, e, q2, e2) == (4, 2, 24, 1) and q + e <= q2 + e2


def test_lr_bucket_choice_chunking_and_padding():
    assert lrp.dp_bucket(512, 1024) == 0
    assert lrp.dp_bucket(513, 600) == 1
    assert lrp.dp_bucket(100, 3073) == 2
    assert lrp.dp_bucket(32768, 34048) == len(lrp.DP_BUCKETS) - 1
    assert lrp.dp_bucket(32769, 100) is None
    for lq, lt in lrp.DP_BUCKETS:
        for bw in (200, 1000, 1300):
            rows = lrp.dp_chunk_rows(lq, lt, bw)
            Wd = dpk.window_geometry(bw, lt) or dpk._round_up(lt, 16)
            assert rows >= 32 and rows & (rows - 1) == 0
            # the chunk is the first power of two past the ~1 GB dirs budget
            assert rows == 32 or (rows // 2) * 2 * (lq + lt) * Wd <= 1 << 30
    assert [lrp.dp_pad_rows(n) for n in (1, 32, 33, 100)] == [32, 32, 64, 128]


def test_lr_dispatch_pads_rows_and_counts_host_segments(data_dir):
    from gdiet_tpu.config import options_for
    from gdiet_tpu.index import build_index
    from gdiet_tpu.io.fastx import read_fastx
    from gdiet_tpu.oracle import align as oal

    io_, mo = options_for("map-hifi", variant="lr", pattern="10", k=19, w=19,
                          bw=40)
    refs = [(r.name, r.seq) for r in read_fastx(str(data_dir / "ref_lr.fa"))]
    mapper = lrp.LongReadMapper(build_index(refs, io_), mo,
                                max_read_len=1024, seed_budget=128,
                                shift_seed_budget=64, hit_budget=256)
    rng = np.random.default_rng(5)
    Q, T, ql, tl = _pairs(rng, 3, 500, 1000)
    wins = [(Q[i, :ql[i]], T[i, :tl[i]]) for i in (1, 2)]
    big = rng.integers(0, 4, 32800).astype(np.uint8)  # beyond every bucket
    wins.append((big, big.copy()))
    jobs = [(0, (None, q, t, False, len(q))) for q, t in wins]
    ezs, pending = mapper._align_jobs_dispatch(jobs, np.array([0]),
                                               np.array([False]))
    assert mapper.stats["host_dp_segments"] == 1
    assert [len(sub) for sub, _, _ in pending] == [2]  # one padded DP call
    assert np.asarray(pending[0][2]).shape[0] == 32
    mapper._align_jobs_fetch(ezs, pending)
    for (q, t), (score, cigar) in zip(wins, ezs):
        ez = oal.extd2(q, t, mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2, mo.bw,
                       mo.zdrop, mo.end_bonus, oal.KSW_EZ_APPROX_MAX)
        assert (score, cigar) == (ez.score, list(ez.cigar))


def test_select_rows_exact_to_2_48():
    rng = np.random.default_rng(48)
    tbl = rng.integers(0, 1 << 48, (17, 32), dtype=np.int64)
    sid = rng.integers(0, 32, (17, 300), dtype=np.int32)
    got = np.asarray(_select_rows(jnp.asarray(tbl), jnp.asarray(sid)))
    np.testing.assert_array_equal(got, np.take_along_axis(tbl, sid, 1))


def _expand_ref(starts, counts, qpos, qstrand, positions, extracted, A):
    """numpy evaluation of _expand_hits (map.c:294-311 projection)."""
    U32 = np.uint64(0xFFFFFFFF)
    cum = np.cumsum(counts, axis=1)
    a = np.arange(A)[None, :]
    sid = np.minimum((cum[:, None, :] <= a[:, :, None]).sum(2),
                     starts.shape[1] - 1)
    prev = np.take_along_axis(np.concatenate(
        [np.zeros_like(cum[:, :1]), cum[:, :-1]], 1), sid, 1)
    pidx = np.take_along_axis(starts, sid, 1) + a - prev
    hit = positions[np.clip(pidx, 0, len(positions) - 1)]
    ok = a < cum[:, -1:]
    qp = np.take_along_axis(qpos, sid, 1).astype(np.int64)
    strand = (hit & np.uint64(1)).astype(np.int64) ^ np.take_along_axis(
        qstrand, sid, 1)
    loc = ((hit & U32) >> np.uint64(1)).astype(np.int64)
    chrom = (hit >> np.uint64(32)).astype(np.uint64) << np.uint64(32)
    out = []
    for want, proj in ((0, (loc + extracted[:, None] - qp) & 0xFFFFFFFF),
                       (1, (loc + qp) & 0xFFFFFFFF)):
        sel = ok & (strand == want)
        key = np.where(sel, chrom | proj.astype(np.uint64),
                       np.uint64(0xFFFFFFFFFFFFFFFF))
        order = np.argsort(key, axis=1, kind="stable")
        out += [np.take_along_axis(key, order, 1),
                np.take_along_axis(qp, order, 1),
                np.take_along_axis(sel, order, 1)]
    return out + [cum[:, -1]]


def test_expand_hits_matches_numpy():
    rng = np.random.default_rng(3)
    B, S, A, P = 9, 12, 64, 5000
    counts = rng.integers(0, 9, (B, S)).astype(np.int64)
    counts[0] = 0
    starts = rng.integers(0, P - 10, (B, S)).astype(np.int64)
    qpos = rng.integers(0, (1 << 31) - 1, (B, S)).astype(np.int32)
    qstrand = rng.integers(0, 2, (B, S)).astype(np.int32)
    chrom = rng.integers(0, 3, P).astype(np.uint64) << np.uint64(32)
    positions = chrom | rng.integers(0, 1 << 31, P).astype(np.uint64)
    extracted = rng.integers(100, 300, B).astype(np.int32)
    got = _expand_hits(jnp.asarray(starts), jnp.asarray(counts),
                       jnp.asarray(qpos), jnp.asarray(qstrand),
                       jnp.asarray(positions), jnp.asarray(extracted), A)
    want = _expand_ref(starts, counts, qpos, qstrand, positions,
                       extracted.astype(np.int64), A)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).astype(w.dtype), w)


def test_compile_cache_dir_env_set_and_unset(tmp_path):
    root = pathlib.Path(__file__).resolve().parent.parent
    assert compile_cache_dir({}) == str(root / ".jax_cache")
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == str(
        root / ".jax_cache")
    assert compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == compile_cache_dir()


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    """The kernel source compiled for the host emulation."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the kernel emulation")
    out = tmp_path_factory.mktemp("emu") / "libextd2_emu.so"
    subprocess.run([cxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
                    str(SRC_DIR / "extd2_emu.cc"), "-o", str(out)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    i32, ptr = ctypes.c_int32, ctypes.c_void_p
    lib.gdiet_extd2_emu.restype = ctypes.c_int
    lib.gdiet_extd2_emu.argtypes = [ptr] * 5 + [i32, ptr, i32, i32] \
        + [ptr] * 3
    lib.gdiet_extd2_geometry.restype = None
    lib.gdiet_extd2_geometry.argtypes = [i32, i32, i32, ptr]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _geometry(lib, W, reg_max, mem_max):
    g = np.zeros(3, np.int32)
    lib.gdiet_extd2_geometry(W, reg_max, mem_max, _ptr(g))
    return int(g[0]), int(g[1]), bool(g[2])


def _emulate(lib, Q, T, ql, tl, band, prm, Lq, Lt, bb, reg_max=1024,
             mem_max=1024):
    """(score, dirs, (tpc, lpt, in_memory)) from the emulated kernel, with
    reg_max / mem_max standing for the card's launch limits."""
    cfg, R, W = kernel_config(prm, Lq, Lt, bb)
    N = len(ql)
    score = np.zeros(N, np.int32)
    dirs = np.zeros((N, R, W), np.uint8)
    geom = np.zeros(3, np.int32)
    arrs = [np.ascontiguousarray(x) for x in (
        Q, T, ql.astype(np.int32), tl.astype(np.int32), band.astype(np.int32))]
    rc = lib.gdiet_extd2_emu(
        *map(_ptr, arrs), N, _ptr(cfg), reg_max, mem_max, _ptr(score),
        _ptr(dirs), _ptr(geom))
    assert rc == 0
    return score, dirs, (int(geom[0]), int(geom[1]), bool(geom[2]))


# one warp per candidate (SR), several warps with the window on, several
# warps without it
@pytest.mark.parametrize("N,Lq,Lt,bb,bands,prm", [
    (9, 160, 160, 200, (150, 200), SR_PRM),
    (5, 300, 700, 200, (60, 200), LR_PRM),
    (3, 400, 500, None, (50, 120), SR_PRM),
])
def test_cuda_kernel_source_matches_xla(emu_lib, N, Lq, Lt, bb, bands, prm):
    rng = np.random.default_rng(N * Lt)
    Q, T, ql, tl = _pairs(rng, N, Lq, Lt)
    band = rng.choice(bands, N).astype(np.int32)
    score, dirs, (_, _, in_mem) = _emulate(emu_lib, Q, T, ql, tl, band,
                                           prm, Lq, Lt, bb)
    assert not in_mem
    s_ref, d_ref, _, _ = _xla(Q, T, ql, tl, band, prm, Lq, Lt, bb)
    np.testing.assert_array_equal(score, s_ref)
    np.testing.assert_array_equal(dirs, d_ref)


# -r values whose rows are wider than a register-resident group reaches
WIDE_BW = (4000, 10000)


def _wide_rows():
    """(Lq, Lt, band budget, buckets) per distinct kernel row for -r in
    WIDE_BW over every long-read bucket. A windowed row is emulated at the
    smallest target budget with the same window (Lt = W + 128), an
    unwindowed one at the bucket's own width (W = Lt). Queries are short
    except at Lt 4352, where query-long rows carry live lanes across the
    window's wrap (lane W held by slot 0) once the base has moved."""
    rows: dict = {}
    for bw in WIDE_BW:
        for lq, lt in lrp.DP_BUCKETS:
            WB = dpk.window_geometry(bw, lt)
            Lt = min(lt, WB + 128) if WB else lt
            rows.setdefault((Lt if WB and Lt <= 4352 else 48, Lt, bw),
                            []).append(f"{lq}x{lt}")
    return [pytest.param(*k, id=f"r{k[2]}-" + "-".join(b))
            for k, b in rows.items()]


@pytest.mark.parametrize("W", sorted({
    kernel_config(LR_PRM, lq, lt, bw)[2]
    for lq, lt in lrp.DP_BUCKETS
    for bw in (150, 200, 500, 1000, 1300, *WIDE_BW, 40000)} | {16, 160, 256}))
def test_launch_geometry_tiles_every_row(emu_lib, W):
    """Every row width a bucket or the SR shape can produce gets a group
    whose slots cover it, within the launch limits a card may report."""
    for reg_max, mem_max in ((1024, 1024), (640, 1024), (256, 512)):
        tpc, lpt, in_mem = _geometry(emu_lib, W, reg_max, mem_max)
        assert tpc % 32 == 0 and tpc * lpt >= W > tpc * (lpt - 1)
        if in_mem:
            assert tpc == mem_max and W > 256
        else:
            assert tpc <= reg_max and lpt <= (8 if tpc == 32 else 4)
            assert (tpc == 32) == (W <= 256)


@pytest.mark.parametrize("Lq,Lt,bw", _wide_rows())
def test_cuda_kernel_source_wide_rows(emu_lib, Lq, Lt, bw):
    """-r 4000 and 10000 in every bucket: rows that leave the register
    kernel keep their state in scratch, with idle slots past W (a 224-thread
    group stands for the card's 1024 to keep the emulation small)."""
    rng = np.random.default_rng(Lt + bw)
    Q, T, ql, tl = _pairs(rng, 3, Lq, Lt)
    ql[2] = Lq
    T[2, :Lt] = rng.integers(0, 4, Lt)  # a row that reaches the last lane
    tl[2] = Lt
    band = np.full(3, bw, np.int32)
    score, dirs, (tpc, lpt, in_mem) = _emulate(
        emu_lib, Q, T, ql, tl, band, LR_PRM, Lq, Lt, bw, reg_max=256,
        mem_max=224)
    W = dirs.shape[2]
    if W <= 1024:
        assert (tpc, lpt, in_mem) == (256, 4, False)
    else:
        assert (tpc, in_mem) == (224, True) and tpc * lpt > W  # idle slots
    s_ref, d_ref, _, _ = _xla(Q, T, ql, tl, band, LR_PRM, Lq, Lt, bw)
    np.testing.assert_array_equal(score, s_ref)
    np.testing.assert_array_equal(dirs, d_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("Lq,Lt,bb,bands", SHAPES)
def test_cuda_kernel_matches_xla_on_gpu(gpu_device, Lq, Lt, bb, bands):
    rng = np.random.default_rng(Lq)
    N = 64
    Q, T, ql, tl = _pairs(rng, N, Lq, Lt)
    band = rng.choice(bands, N).astype(np.int32)
    with jax.default_device(gpu_device):
        score, dirs = dpk.extd2(
            jnp.asarray(Q), jnp.asarray(T), jnp.asarray(ql), jnp.asarray(tl),
            jnp.asarray(band), SR_PRM, Lq, Lt, band_budget=bb)
        s_ref, d_ref, _, _ = _xla(Q, T, ql, tl, band, SR_PRM, Lq, Lt, bb)
    np.testing.assert_array_equal(np.asarray(score), s_ref)
    np.testing.assert_array_equal(np.asarray(dirs), d_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("bw", WIDE_BW)
@pytest.mark.parametrize("lq,lt", lrp.DP_BUCKETS)
def test_cuda_kernel_wide_rows_on_gpu(gpu_device, lq, lt, bw):
    """-r 4000 and 10000 at every bucket's full size on the card, with
    query-long rows so the window slides and wraps."""
    rng = np.random.default_rng(lt + bw)
    Q, T, ql, tl = _pairs(rng, 3, lq, lt)
    band = np.full(3, bw, np.int32)
    with jax.default_device(gpu_device):
        score, dirs = dpk.extd2(
            jnp.asarray(Q), jnp.asarray(T), jnp.asarray(ql), jnp.asarray(tl),
            jnp.asarray(band), LR_PRM, lq, lt, band_budget=bw)
        s_ref, d_ref, _, _ = _xla(Q, T, ql, tl, band, LR_PRM, lq, lt, bw)
    np.testing.assert_array_equal(np.asarray(score), s_ref)
    np.testing.assert_array_equal(np.asarray(dirs), d_ref)
