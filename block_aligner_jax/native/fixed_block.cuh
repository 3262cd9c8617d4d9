// Fixed-block (min == max block size) aligner walk for one pair.
//
// The walk is written once against a lane-group policy ``LP`` and compiled
// twice: by nvcc with one warp (or half warp for block 16) per pair, each
// lane holding ``RPT`` consecutive rows of the block's anti-diagonal-free DP
// column in registers (fixed_block.cu), and by g++ with the lane group
// emulated as a G-wide array (fixed_block_host.cpp), so the CPU tests check
// the same source against the scalar oracle (core/oracle.py).
//
// Semantics are the reference state machine specialised to a fixed block
// (reference: src/scan_block.rs:94-595): no grow/shrink/checkpoint, one
// leading S x S rect, then STEP=8 column shifts right or down.  Arithmetic
// is i16-saturating in int32 lanes relative to ZERO = 2^14 with MIN = 0
// borders, exactly as ops/engine.py; the in-column prefix scan is the
// engine's closed form
//     R[k] = max(clamp16(e*k + max_{m<=k}(v[m] - e*m)), e*((k mod 8) + 1))
// done as a per-lane sequential max followed by a shuffle scan over lanes.
//
// Modes: global score-only and x-drop, over a 32x32 int8 code table
// (AAMatrix / NucMatrix, codes remapped on the host) or byte equality
// (ByteMatrix).

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define BA_HD __host__ __device__ __forceinline__
#else
#define BA_HD inline
#endif

namespace ba_fixed {

constexpr int STEP = 8;
constexpr int L16 = 16;  // tracker residues (reference AVX2 lane count)
constexpr int ZERO = 1 << 14;
constexpr int I16_MIN = -(1 << 15);
constexpr int I16_MAX = (1 << 15) - 1;
constexpr int X_DROP_ITER = 2;
constexpr int DIR_R = 0, DIR_D = 1, DIR_G = 2;

BA_HD int clamp16(int x) { return x < I16_MIN ? I16_MIN : (x > I16_MAX ? I16_MAX : x); }

struct Params {
  int gap_open;    // includes the first extension (Gaps.open)
  int gap_extend;  // Gaps.extend
  int x_drop;
  int byte_mode;   // 1: score by byte equality
  int match;       // byte mode scores
  int mismatch;
};

struct Pair {
  const uint8_t* q;  // DP-indexed query codes: q[0] = NULL, q[1..qlen]
  const uint8_t* r;  // DP-indexed reference codes
  int qlen;
  int rlen;
};

struct Result {
  int score;
  int qi;
  int rj;
};

// One pair's walk.  ``LP`` provides the lane-group primitives:
//   V                per-lane int32 value type (int on the device)
//   lane()           this lane's index in 0..G-1
//   shfl_up(v, d)    value of lane - d (lanes < d keep their own)
//   shfl_down(v, d)  value of lane + d (lanes >= G - d keep their own)
//   bcast(v, src)    lane ``src``'s value, as a scalar
//   max_all(v)       group max, as a scalar
//   load(p, idx)     per-lane byte load p[idx]
//   score(tab, c, code) per-lane table lookup tab[c * 32 + code]
template <class LP, int S, bool XDROP>
struct Walk {
  static constexpr int G = LP::G;
  static constexpr int RPT = S / G;  // rows per lane
  static_assert(RPT * G == S, "block must be a multiple of the lane group");
  using V = typename LP::V;

  LP& lp;
  const int8_t* tab;
  Params prm;
  V lane;
  V Dc[RPT], Cc[RPT];  // column borders D_col / C_col
  V Dr[RPT], Rr[RPT];  // row borders D_row / R_row
  V tmax;              // running rect max (global) per lane
  V rmax[RPT];         // x-drop: per-row running max
  V rarg[RPT];         // x-drop: last column reaching it (-1 = none)

  BA_HD Walk(LP& lp_, const int8_t* tab_, const Params& p)
      : lp(lp_), tab(tab_), prm(p) {
    lane = lp.lane();
  }

  BA_HD V row(int r) const { return lane * RPT + r; }

  BA_HD static V sat(V x) { return LP::vclamp(x, I16_MIN, I16_MAX); }

  BA_HD void reset_tracker() {
    tmax = LP::splat(0);
    if (XDROP) {
      for (int r = 0; r < RPT; ++r) {
        rmax[r] = LP::splat(0);
        rarg[r] = LP::splat(-1);
      }
    }
  }

  BA_HD V score(int c, V code) const {
    if (prm.byte_mode) {
      return LP::vsel(code == c, LP::splat(prm.match), LP::splat(prm.mismatch));
    }
    return lp.score(tab, c, code);
  }

  // One DP column of the current rect.  ``Dx``/``Cx`` is the rect's column
  // border (updated in place), ``code`` the lane codes of its rows, ``c`` the
  // column char; ``corner`` enters row 0's diagonal; ``ins0`` places the
  // relative zero at row 0 (DP cell (0, 0)).  Returns the bottom row's D and
  // R through ``dbot``/``rbot`` and folds the column into the tracker.
  BA_HD void column(V* Dx, V* Cx, const V* code, int c, int corner, bool ins0,
                    int rz, int j, int& dbot, int& rbot) {
    const int e = prm.gap_extend;
    const int go = prm.gap_open;
    V up = lp.shfl_up(Dx[RPT - 1], 1);
    V D00_0 = LP::vsel(lane == 0, LP::splat(corner), up);
    V D11[RPT], C11[RPT], R11[RPT], pm[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      V D00 = r == 0 ? D00_0 : Dx[r - 1];
      V d = sat(D00 + score(c, code[r]));
      if (r == 0 && ins0) d = LP::vsel(lane == 0, LP::splat(rz), d);
      V cc = LP::vmax(sat(Cx[r] + e), sat(Dx[r] + go));
      d = LP::vmax(d, cc);
      C11[r] = cc;
      D11[r] = d;
      V w = sat(d + (go - e)) - row(r) * e;
      pm[r] = r == 0 ? w : LP::vmax(pm[r - 1], w);
    }
    // inclusive max-scan of the lanes' row maxima, then shift to exclusive
    V tot = pm[RPT - 1];
#pragma unroll
    for (int d = 1; d < G; d *= 2) {
      V t = lp.shfl_up(tot, d);
      tot = LP::vsel(lane >= d, LP::vmax(tot, t), tot);
    }
    V excl = lp.shfl_up(tot, 1);
    excl = LP::vsel(lane == 0, LP::splat(INT32_MIN / 2), excl);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      V k = row(r);
      V run = LP::vmax(excl, pm[r]);
      V rr = LP::vmax(LP::vclamp(run + k * e, I16_MIN, I16_MAX),
                      ((k & (STEP - 1)) + 1) * e);
      R11[r] = rr;
      V d = LP::vmax(D11[r], rr);
      Dx[r] = d;
      Cx[r] = C11[r];
      tmax = LP::vmax(tmax, d);
      if (XDROP) {
        V nm = LP::vmax(rmax[r], d);
        rarg[r] = LP::vsel(d == nm, LP::splat(j), rarg[r]);
        rmax[r] = nm;
      }
    }
    dbot = lp.bcast(Dx[RPT - 1], G - 1);
    rbot = lp.bcast(R11[RPT - 1], G - 1);
  }

  // max of rows 0..7 of a border
  BA_HD int head_max(const V* X) {
    V m = LP::splat(INT32_MIN);
#pragma unroll
    for (int r = 0; r < RPT; ++r) m = LP::vmax(m, LP::vsel(row(r) < STEP, X[r], LP::splat(INT32_MIN)));
    return lp.max_all(m);
  }

  BA_HD int row_value(const V* X, int k) {
    V m = LP::splat(INT32_MIN);
#pragma unroll
    for (int r = 0; r < RPT; ++r) m = LP::vsel(row(r) == k, X[r], m);
    return lp.max_all(m);
  }

  // X[k] = sat(X[k + 8] + add) for k < S - 8; the tail rows k >= S - 8 take
  // T[k] (staged bottoms of the step's 8 columns)
  BA_HD void shift8(V* X, const V* T, int add) {
    V nx[RPT];
    if (RPT < STEP) {
      constexpr int dl = RPT < STEP ? STEP / RPT : 1;
#pragma unroll
      for (int r = 0; r < RPT; ++r) nx[r] = lp.shfl_down(X[r], dl);
    } else {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        if (r + STEP < RPT) {
          nx[r] = X[r + STEP];
        } else {
          nx[r] = lp.shfl_down(X[r + STEP - RPT < 0 ? 0 : r + STEP - RPT], 1);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      X[r] = LP::vsel(row(r) >= S - STEP, T[r], sat(nx[r] + add));
    }
  }

  // One STEP-column shift rect.  (DX, CX) is the rect's own border, (DY, CY)
  // the passive one that shifts by STEP and takes the rect's bottoms; lanes
  // run along ``lanes_seq`` from ``starti``, columns along ``col_seq`` from
  // ``cp0``.  Right shifts pass (D_col, C_col, D_row, R_row), down shifts
  // the transpose (reference: src/scan_block.rs:140-240).
  BA_HD void shift_step(V (&DX)[RPT], V (&CX)[RPT], V (&DY)[RPT], V (&CY)[RPT],
                        const uint8_t* lanes_seq, const uint8_t* col_seq,
                        int starti, int cp0, int lane_len, int col_len, int off,
                        int off_add, int corner, int& corner_scalar, int& x_max,
                        int& y_max) {
    V code[RPT], T1[RPT], T2[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      DX[r] = sat(DX[r] + off_add);
      CX[r] = sat(CX[r] + off_add);
      code[r] = lp.load(lanes_seq, starti + row(r));
      T1[r] = T2[r] = LP::splat(0);
    }
    const int rz = clamp16(ZERO - off);
#pragma unroll 1
    for (int j = 0; j < STEP; ++j) {
      const int cp = cp0 + j;
      int db, rb;
      column(DX, CX, code, col_seq[cp], j == 0 ? corner : 0,
             starti == 0 && cp == 0, rz, j, db, rb);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        T1[r] = LP::vsel(row(r) == S - STEP + j, LP::splat(db), T1[r]);
        T2[r] = LP::vsel(row(r) == S - STEP + j, LP::splat(rb), T2[r]);
      }
      if (!XDROP && starti + S > lane_len && cp >= col_len) break;
    }
    x_max = head_max(DX);
    corner_scalar = clamp16(row_value(DY, STEP - 1) + off_add);
    shift8(DY, T1, off_add);
    shift8(CY, T2, off_add);
    y_max = head_max(DY);
  }

  BA_HD Result run(const Pair& p) {
    const int qlen = p.qlen, rlen = p.rlen;
    for (int r = 0; r < RPT; ++r) {
      Dc[r] = Cc[r] = Dr[r] = Rr[r] = LP::splat(0);
    }
    int off = 0, off_max = 0;
    int dir = DIR_G, prev_dir = DIR_G;
    int si = 0, sj = 0;
    int corner_scalar = 0;
    int best_max = 0, best_i = 0, best_j = 0, x_iter = 0;
    int right_max = 0, down_max = 0;
    V code[RPT];

    while (true) {
      const int prev_off = off;
      reset_tracker();
      if (dir == DIR_G) {
        // leading S x S rect: right-placed, rows = query 0..S-1, columns =
        // reference 0..S-1; bottoms land in the row border
        corner_scalar = 0;
        for (int r = 0; r < RPT; ++r) code[r] = lp.load(p.q, row(r));
        const int rz = clamp16(ZERO - off);
        for (int j = 0; j < S; ++j) {
          int db, rb;
          column(Dc, Cc, code, p.r[j], 0, j == 0, rz, j, db, rb);
          for (int r = 0; r < RPT; ++r) {
            Dr[r] = LP::vsel(row(r) == j, LP::splat(db), Dr[r]);
            Rr[r] = LP::vsel(row(r) == j, LP::splat(rb), Rr[r]);
          }
          if (!XDROP && S > qlen && j >= rlen) break;
        }
        right_max = head_max(Dc);
        down_max = head_max(Dr);
      } else {
        off = off_max;
        const int off_add = clamp16(prev_off - off);
        const int corner = prev_dir == (dir == DIR_R ? DIR_D : DIR_R)
                               ? clamp16(corner_scalar + off_add) : 0;
        // the two branches bind the border arrays statically so they stay
        // in registers
        if (dir == DIR_R) {
          shift_step(Dc, Cc, Dr, Rr, p.q, p.r, si, sj + S - STEP, qlen, rlen,
                     off, off_add, corner, corner_scalar, right_max, down_max);
        } else {
          shift_step(Dr, Rr, Dc, Cc, p.r, p.q, sj, si + S - STEP, rlen, qlen,
                     off, off_add, corner, corner_scalar, down_max, right_max);
        }
      }
      prev_dir = dir;

      const int cur_max = lp.max_all(tmax);  // tracker starts at MIN = 0
      off_max = off + cur_max - ZERO;
      if (off_max > best_max) {
        if (XDROP) {
          // lowest residue lane reaching the max, then its last (column,
          // chunk) update: one keyed group max (core/oracle._MaxTracker)
          V key = LP::splat(-1);
          for (int r = 0; r < RPT; ++r) {
            V k = row(r);
            V kk = ((15 - (k & (L16 - 1))) << 24) | ((rarg[r] + 1) << 8) | (k >> 4);
            key = LP::vmax(key, LP::vsel(rmax[r] == cur_max, kk, LP::splat(-1)));
          }
          const int best = lp.max_all(key);
          const int lane_idx = 15 - (best >> 24);
          const int argp1 = (best >> 8) & 0xFFFF;
          const int idx_i = argp1 ? (best & 0xFF) * L16 : 0;
          const int idx_j = argp1 ? argp1 - 1 : 0;
          const int r_pos = idx_i + lane_idx;
          if (dir == DIR_R) {
            best_i = si + r_pos;
            best_j = sj + (S - STEP) + idx_j;
          } else if (dir == DIR_D) {
            best_i = si + (S - STEP) + idx_j;
            best_j = sj + r_pos;
          } else {
            best_i = si + r_pos;
            best_j = sj + idx_j;
          }
        }
        best_max = off_max;
      }
      if (XDROP) {
        if (off_max < best_max - prm.x_drop) {
          if (x_iter < X_DROP_ITER - 1) {
            ++x_iter;
          } else {
            break;
          }
        } else {
          x_iter = 0;
        }
      }
      if (si + S > qlen && sj + S > rlen) break;
      if (sj + S > rlen) {
        si += STEP;
        dir = DIR_D;
      } else if (si + S > qlen) {
        sj += STEP;
        dir = DIR_R;
      } else if (down_max > right_max) {
        si += STEP;
        dir = DIR_D;
      } else {
        sj += STEP;
        dir = DIR_R;
      }
    }

    Result res;
    if (XDROP) {
      res.score = best_max;
      res.qi = best_i;
      res.rj = best_j;
    } else {
      const bool use_col = dir != DIR_D;
      const int v = use_col ? row_value(Dc, qlen - si) : row_value(Dr, rlen - sj);
      res.score = off + v - ZERO;
      res.qi = qlen;
      res.rj = rlen;
    }
    return res;
  }
};

}  // namespace ba_fixed
