// Banded dual affine-gap DP (ksw_extd2 with KSW_EZ_APPROX_MAX) for the GPU.
//
// Same recurrence, lane semantics and output layout as ops/dp.py::extd2_batch
// (the Suzuki-Kasahara difference form of GDiet-ShortReads/
// ksw2_extd2_sse.c:34-402), which is the reference it is checked against.
//
// One group of `tpc` threads owns one candidate for the whole wavefront loop.
// Each thread owns `lpt` consecutive slots of the W-lane window (slots past
// W idle), and the lane state of its slots (u, v, x, y, x2, y2, s) stays in
// registers across all R = qlen+tlen-1 wavefronts; the XLA scan instead moves
// it through device memory once per wavefront. A row too wide for a
// register-resident group keeps the same per-slot state in a global scratch
// area instead (Slots<0>), laid out so a group's accesses coalesce. The only
// cross-thread data per wavefront (the left neighbour's x/v/x2, the boundary
// values at lane st-1 and the two lanes the approximate-H0 walk reads) go
// through a double-buffered exchange area in shared memory behind ONE
// barrier per wavefront; the H0 step of wavefront r runs after the barrier
// of wavefront r+1.
//
// With the banded window on (wmax >= 0) slot s holds lane
// lo + ((s - lo) mod W) for the window base lo = window_base(r) of
// ops/dp.py; when the base moves, the slots whose lane changed restart from
// the initial values, which is what those never-touched lanes hold in the
// full-width recurrence.
//
// The including file defines GD_DEVICE, GD_KERNEL, GD_TID, GD_BID, GD_BDIM,
// GD_SHARED, GD_BARRIER(tpc) and the three DPX max operations GD_MAX3,
// GD_ADDMAX (max(a + b, c)) and GD_MAX: extd2_ffi.cu maps them to CUDA,
// extd2_emu.cc to host threads for the CPU tests.
#pragma once
#include <cstddef>
#include <cstdint>

namespace gdiet {

struct Extd2Args {
  const uint8_t* query;   // [N, Lmax] nt codes
  const uint8_t* target;  // [N, Lt] nt codes
  const int32_t* qlens;   // [N]
  const int32_t* tlens;   // [N]
  const int32_t* bands;   // [N]
  int32_t* score;         // [N]
  uint8_t* dirs;          // [N, R, W]
  int32_t* scratch;       // [N, kFields, lpt, tpc] for Slots<0>, else unused
  int32_t N, Lmax, Lt, R;
  int32_t T;     // Lt rounded up to 16: the clip bound of the lane gathers
  int32_t TS;    // state lanes: T, or Lt rounded up to 128 when windowed
  int32_t W;     // lanes per wavefront = dirs row width
  int32_t wmax;  // band budget of the window; -1 when the window is off
  int32_t tpc;   // threads per candidate
  int32_t lpt;   // slots per thread
  int32_t a, b, q, e, q2, e2, long_thres, long_diff;  // q+e <= q2+e2
};

struct Geometry {
  int tpc, lpt;
  bool in_memory;  // lane state in Args::scratch (the Slots<0> kernel)
};

// Threads per candidate and slots per thread for a W-lane row: one warp for
// rows of up to 256 lanes, else a group of about W/4 threads. `reg_max` and
// `mem_max` are the largest groups (multiples of 32) the register-resident
// and the scratch kernel can be launched with; a row whose group would pass
// reg_max takes the scratch kernel with mem_max threads.
inline Geometry launch_geometry(int W, int reg_max, int mem_max) {
  if (W <= 256) return {32, (W + 31) / 32, false};
  int tpc = ((W + 3) / 4 + 31) / 32 * 32;
  if (tpc <= reg_max) return {tpc, (W + tpc - 1) / tpc, false};
  return {mem_max, (W + mem_max - 1) / mem_max, true};
}

// candidates per block: four one-warp groups share a block
inline int candidates_per_block(int tpc) { return tpc == 32 ? 4 : 1; }

// shared int32 words per candidate: two parities of the exchange area
inline int exchange_words(int tpc) { return 2 * (8 + 3 * tpc); }

enum { kVLt = 0, kULt1 = 1, kV0 = 2, kX1 = 3, kX21 = 4, kV1 = 5, kEdge = 8 };

// per-slot fields: lane state, target code, lane held (-1: slot past W)
enum { kU, kV, kX, kY, kX2, kY2, kS, kTc, kLn, kFields };

// One thread's slots: LPT > 0 in registers (every loop over k unrolls);
// LPT == 0 in the global scratch, field f of slot k at ((f * lpt + k) * tpc
// + tid) from the candidate's base, so a group's accesses are contiguous.
template <int LPT>
struct Slots {
  int32_t f[kFields][LPT];
  GD_DEVICE Slots(const Extd2Args&, int, int) {}
  GD_DEVICE int count() const { return LPT; }
  GD_DEVICE int32_t& at(int field, int k) { return f[field][k]; }
};

template <>
struct Slots<0> {
  int32_t* base;
  int lpt, tpc;
  GD_DEVICE Slots(const Extd2Args& p, int n, int tid)
      : base(p.scratch + (size_t)n * kFields * p.lpt * p.tpc + tid),
        lpt(p.lpt), tpc(p.tpc) {}
  GD_DEVICE int count() const { return lpt; }
  GD_DEVICE int32_t& at(int field, int k) {
    return base[(size_t)(field * lpt + k) * tpc];
  }
};

GD_DEVICE int window_lo(int r, const Extd2Args& p) {
  if (p.wmax < 0) return 0;
  int lo = ((r - p.wmax + 1) >> 1) - 16;
  if (lo > p.TS - p.W) lo = p.TS - p.W;
  if (lo < 0) lo = 0;
  return lo / 128 * 128;
}

GD_DEVICE int slot_lane(int slot, int lo, const Extd2Args& p) {
  return lo + ((slot - lo % p.W) + p.W) % p.W;
}

template <int LPT>
GD_KERNEL void extd2_kernel(Extd2Args p) {
  const int tpc = p.tpc;
  const int sub = GD_TID / tpc;
  const int tid = GD_TID % tpc;
  const int n = GD_BID * (GD_BDIM / tpc) + sub;
  if (n >= p.N) return;  // whole candidate groups only: barriers stay matched
  const int XS = kEdge + 3 * tpc;
  int32_t* xch = GD_SHARED + sub * 2 * XS;

  const int qlen = p.qlens[n], tlen = p.tlens[n], w = p.bands[n];
  const int qmax = qlen < p.Lmax ? qlen : p.Lmax;
  const uint8_t* qs = p.query + (size_t)n * p.Lmax;
  const uint8_t* ts = p.target + (size_t)n * p.Lt;
  uint8_t* drow = p.dirs + (size_t)n * p.R * p.W;
  const int qe = -(p.q + p.e), qe2 = -(p.q2 + p.e2);

  Slots<LPT> S(p, n, tid);
  const int lpt = S.count();
  // restart a slot at lane L: the initial values of a never-touched lane
  auto reset = [&](int k, int L) {
    S.at(kLn, k) = L;
    S.at(kU, k) = S.at(kV, k) = S.at(kX, k) = S.at(kY, k) = qe;
    S.at(kX2, k) = S.at(kY2, k) = qe2;
    S.at(kS, k) = 0;
    S.at(kTc, k) = (L >= 0 && L < p.Lt) ? ts[L] : 0;
  };
#pragma unroll
  for (int k = 0; k < lpt; ++k) {
    const int slot = tid * lpt + k;
    reset(k, slot < p.W ? slot : -1);
  }
  // the slot below my first one is the last slot of the thread before me;
  // below slot 0 (in window order) is slot W-1
  const int left = tid == 0 ? (p.W - 1) / lpt : tid - 1;
  const int last = p.W - 1 - tid * lpt < lpt - 1 ? p.W - 1 - tid * lpt
                                                 : lpt - 1;  // < 0: idle

  int H0 = 0, lt = 0, last_st = -1, last_en = -1, score = -0x40000000;
  int pst0 = 0, pen0 = -1;
  bool plive = false;
  int lo = 0;
  for (int r = 0; r <= p.R; ++r) {
    int32_t* X = xch + (r & 1) * XS;
    int st0 = 0, en0 = -1, st = 0, en = -1;
    bool live = false;
    if (r < p.R) {
      st0 = r - qlen + 1 > 0 ? r - qlen + 1 : 0;
      if (((r - w + 1) >> 1) > st0) st0 = (r - w + 1) >> 1;
      en0 = tlen - 1 < r ? tlen - 1 : r;
      if (((r + w) >> 1) < en0) en0 = (r + w) >> 1;
      live = st0 <= en0 && r < qlen + tlen - 1 && qlen > 0;
      st = (st0 >> 4) << 4;
      en = (((en0 + 16) >> 4) << 4) - 1;
      if (en > p.T - 1) en = p.T - 1;
      // slide the window: slots whose lane changed hold never-touched lanes
      const int nlo = window_lo(r, p);
      if (nlo != lo) {
#pragma unroll
        for (int k = 0; k < lpt; ++k) {
          if (S.at(kLn, k) < 0) continue;
          const int nl = slot_lane(tid * lpt + k, nlo, p);
          if (nl != S.at(kLn, k)) reset(k, nl);
        }
        lo = nlo;
      }
    }

    // publish what other threads read from the state after wavefront r-1
    const int llt = lt < 0 ? 0 : (lt > p.T - 1 ? p.T - 1 : lt);
    const int llt1 = lt + 1 < 0 ? 0 : (lt + 1 > p.T - 1 ? p.T - 1 : lt + 1);
#pragma unroll
    for (int k = 0; k < lpt; ++k) {
      const int L = S.at(kLn, k);
      if (L == llt) X[kVLt] = S.at(kV, k);
      if (L == llt1) X[kULt1] = S.at(kU, k);
      if (L == 0) X[kV0] = S.at(kV, k);
      if (L == st - 1) {
        X[kX1] = S.at(kX, k);
        X[kX21] = S.at(kX2, k);
        X[kV1] = S.at(kV, k);
      }
      if (k == last) {
        X[kEdge + tid] = S.at(kX, k);
        X[kEdge + tpc + tid] = S.at(kV, k);
        X[kEdge + 2 * tpc + tid] = S.at(kX2, k);
      }
    }
    GD_BARRIER(tpc);

    // approximate H0 walk of wavefront r-1 (ksw2_extd2_sse.c:367-383)
    if (plive) {
      if (r == 1) {
        H0 = X[kV0] + qe;
        lt = 0;
      } else {
        const bool lt_in = lt >= pst0 && lt <= pen0;
        const bool lt1_in = lt + 1 >= pst0 && lt + 1 <= pen0;
        const int vlt = X[kVLt], ult1 = X[kULt1];
        if (lt_in && (!lt1_in || vlt > ult1)) {
          H0 += vlt;
        } else {
          H0 += ult1;
          ++lt;
        }
      }
      if (r - 1 == qlen + tlen - 2 && pen0 == tlen - 1) score = H0;
    }
    if (r == p.R) break;

    // boundary values (ksw2_extd2_sse.c:149-163)
    const bool prev_ok = st > 0 && st - 1 >= last_st && st - 1 <= last_en;
    const int x1 = prev_ok ? X[kX1] : qe;
    const int x21 = prev_ok ? X[kX21] : qe2;
    const int bu = r == 0 ? qe
                 : (r < p.long_thres ? -p.e
                    : (r == p.long_thres ? p.long_diff : -p.e2));
    const int v1 = st > 0 ? (prev_ok ? X[kV1] : qe) : bu;
    int px = X[kEdge + left], pv = X[kEdge + tpc + left];
    int px2 = X[kEdge + 2 * tpc + left];

    const int span16 = (((en0 - st0) >> 4) << 4) + 16;
    uint8_t* dr = drow + (size_t)r * p.W;
#pragma unroll
    for (int k = 0; k < lpt; ++k) {
      const int L = S.at(kLn, k);
      if (L < 0) continue;
      int32_t &u = S.at(kU, k), &v = S.at(kV, k), &x = S.at(kX, k);
      int32_t &y = S.at(kY, k), &x2 = S.at(kX2, k), &y2 = S.at(kY2, k);
      int32_t& s = S.at(kS, k);
      const int xl = L == lo ? 0 : px, vl = L == lo ? 0 : pv;
      const int x2l = L == lo ? 0 : px2;
      px = x;
      pv = v;
      px2 = x2;
      uint8_t d = 0;
      if (live) {
        if (L == r && en >= r) {  // edge-lane init (ksw2_extd2_sse.c:160-163)
          y = qe;
          y2 = qe2;
          u = bu;
        }
        if (L >= st0 && L < st0 + span16) {  // substitution refresh
          const int qi = r - L;
          const int qv = (qi >= 0 && qi < qmax) ? qs[qi] : 0;
          const int sq = S.at(kTc, k);
          s = (sq == 4 || qv == 4) ? -p.e2 : (sq == qv ? p.a : -p.b);
        }
        if (L >= st && L <= en) {
          const bool at_st = L == st;
          const int xp = at_st ? x1 : xl, vp = at_st ? v1 : vl;
          const int x2p = at_st ? x21 : x2l;
          const int a_ = xp + vp, b_ = y + u;
          const int a2_ = x2p + vp, b2_ = y2 + u;
          // d = first of (s, a, b, a2, b2) that attains the maximum
          const int m = GD_MAX(GD_MAX3(s, a_, b_), GD_MAX(a2_, b2_));
          d = s == m ? 0 : (a_ == m ? 1 : (b_ == m ? 2 : (a2_ == m ? 3 : 4)));
          const int zv = m < p.a ? m : p.a;
          const int uo = u;
          u = zv - vp;
          v = zv - uo;
          // x = max(a_ - (zv - q), 0) - (q + e) = max(a_ - zv, -q) - e
          x = GD_ADDMAX(a_, -zv, -p.q) - p.e;
          y = GD_ADDMAX(b_, -zv, -p.q) - p.e;
          x2 = GD_ADDMAX(a2_, -zv, -p.q2) - p.e2;
          y2 = GD_ADDMAX(b2_, -zv, -p.q2) - p.e2;
          d |= (a_ - zv + p.q > 0 ? 0x08 : 0) | (b_ - zv + p.q > 0 ? 0x10 : 0)
             | (a2_ - zv + p.q2 > 0 ? 0x20 : 0)
             | (b2_ - zv + p.q2 > 0 ? 0x40 : 0);
        }
      }
      dr[L - lo] = d;
    }
    if (live) {
      last_st = st;
      last_en = en;
    }
    pst0 = st0;
    pen0 = en0;
    plive = live;
  }
  if (tid == 0) p.score[n] = score;
}

}  // namespace gdiet
