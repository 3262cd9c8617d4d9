"""Batched lockstep JAX engine for the adaptive block aligner.

Batched re-derivation of the reference state machine (reference:
src/scan_block.rs:94-595), compiled by XLA for the GPU or the CPU.  Instead
of one sequential CPU-SIMD aligner, this engine runs a *batch* of B
independent aligner state machines in lockstep.
The per-pair data-dependent control flow (shift right/down, grow, shrink,
checkpoint restore, x-drop) is flattened to **column granularity**: every
iteration of one ``lax.while_loop`` computes one DP column (a vector of up to
``max_size`` cells) for every pair, so per-pair divergence in rect widths
(STEP=8 shifts vs. power-of-two grow rects) never stalls the batch.

Hot-loop math is exact i16-saturating arithmetic carried in int32 lanes.  The
reference's chunked AVX2 prefix scan (reference: src/avx2.rs:312-338) is
replaced by the mathematically identical closed form

    R[k] = max( clip(e*k + cummax_m<=k(v[m] - e*m)),  e*((k mod 8) + 1) )

where the second term reproduces the MIN=0 zeros the AVX2 kernel shifts into
each 8-lane half -- one ``lax.cummax`` instead of a sequential carry chain.

Phases (per pair): START -> RECT columns -> (MIDGROW ->RECT) -> END -> ...
DONE.  All phase logic is masked vector arithmetic; iteration order is
arranged so a pair never idles more than the boundary bookkeeping itself.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.oracle import I16_MAX, I16_MIN, L, MIN_VAL, STEP, X_DROP_ITER, ZERO

__all__ = ["EngineConfig", "build_engine", "pack_pairs", "pack_profiles"]

# phases
P_START = 0
P_RECT = 1
P_MIDGROW = 2
P_END = 3
P_DONE = 4

# directions
DIR_R = 0
DIR_D = 1
DIR_G = 2


def _sat(x):
    return jnp.clip(x, I16_MIN, I16_MAX)


def _clamp16(x):
    return jnp.clip(x, I16_MIN, I16_MAX)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static (trace-time) engine configuration; one jit specialization per
    distinct config (the analogue of the reference's const generics,
    reference: src/scan_block.rs:89)."""

    batch: int
    min_size: int
    max_size: int
    seq_cap: int  # padded per-side sequence capacity (Lmax)
    n_rows: int  # score-table rows (27->32 for AA, 8 for Nuc)
    is_byte: bool = False
    profile: bool = False  # sequence-to-PSSM mode (reference align_profile)
    x_drop: bool = False
    trace: bool = False
    local_start: bool = False
    free_query_start_gaps: bool = False
    free_query_end_gaps: bool = False
    max_iters: Optional[int] = None
    trace_cols: Optional[int] = None

    def __post_init__(self):
        assert self.min_size % L == 0 and self.max_size % L == 0
        assert self.min_size & (self.min_size - 1) == 0
        assert self.max_size & (self.max_size - 1) == 0

    @property
    def iter_cap(self) -> int:
        if self.max_iters is not None:
            return self.max_iters
        # each 8-column shift advances i+j by 8; grows/boundaries add slack
        return 16 * self.seq_cap + 1024

    @property
    def trace_cap(self) -> int:
        """Column (= iteration) capacity of the trace stream: one column per
        iteration; shifts cost qlen+rlen columns, grows/restores are bounded
        by the doubling ladder (reference trace sizing analogue:
        src/scan_block.rs:1363-1374)."""
        if self.trace_cols is not None:
            return self.trace_cols
        return 2 * self.seq_cap + 16 * self.max_size + 64


@functools.lru_cache(maxsize=32)
def build_engine(cfg: EngineConfig):
    """Build the jitted batched aligner (one per distinct config, so
    aligners with equal configs share compiled executables).

    Returns ``fn(Sprof, CRow, qlen, rlen, gap_open, gap_extend, x_drop)``
    with shapes::

        Sprof: (B, 2, n_rows, seq_cap) int8   per-pair score profiles
               [b, 0] = scores vs query lanes (right rects),
               [b, 1] = scores vs reference lanes (down rects)
        CRow:  (B, 2, seq_cap) int32          column-char table rows
               [b, 0, p] = row index of reference char p (right rects),
               [b, 1, p] = row index of query char p (down rects)
        qlen, rlen: (B,) int32

    and returns ``(score, query_idx, reference_idx, iters)`` each (B,).
    For ``is_byte`` configs, Sprof/CRow instead carry raw byte codes:
    Sprof is (B, 2, 1, seq_cap) lane codes and scoring compares equality.
    """
    B = cfg.batch
    H = cfg.max_size
    lanes = jnp.arange(H, dtype=jnp.int32)
    lane_mod8_cost = None  # built once gap_extend is known (traced)

    def engine(Sprof, CRow, qlen, rlen, gap_open, gap_extend, x_drop_amt,
               byte_match=jnp.int32(0), byte_mismatch=jnp.int32(0),
               GOC=None, GCC=None, GOR=None):
        gap_open = jnp.int32(gap_open)
        e = jnp.int32(gap_extend)
        x_drop_amt = jnp.int32(x_drop_amt)
        qlen = qlen.astype(jnp.int32)
        rlen = rlen.astype(jnp.int32)

        zeros_b = jnp.zeros((B,), jnp.int32)
        min_border = jnp.full((B, H), MIN_VAL, jnp.int32)

        state = dict(
            iters=jnp.int32(0),
            phase=jnp.full((B,), P_START, jnp.int32),
            dirn=jnp.full((B,), DIR_G, jnp.int32),
            prev_dir=jnp.full((B,), DIR_G, jnp.int32),
            sub=zeros_b,  # 0 = first rect of a grow step, 1 = second
            i=zeros_b,
            j=zeros_b,
            blk=jnp.full((B,), cfg.min_size, jnp.int32),
            prev_size=zeros_b,
            off=zeros_b,
            off_max=zeros_b,
            off_add=zeros_b,
            best_max=zeros_b,
            best_i=zeros_b,
            best_j=zeros_b,
            y_drop=zeros_b,
            x_iter=zeros_b,
            ickpt=zeros_b,
            jckpt=zeros_b,
            offckpt=zeros_b,
            corner=jnp.full((B,), MIN_VAL, jnp.int32),
            D_col=min_border,
            C_col=min_border,
            D_row=min_border,
            R_row=min_border,
            Dc_ck=min_border,
            Cc_ck=min_border,
            Dr_ck=min_border,
            Rr_ck=min_border,
            tempD=jnp.full((B, H), MIN_VAL, jnp.int32),
            tempR=jnp.full((B, H), MIN_VAL, jnp.int32),
            # current rect
            r_right=jnp.zeros((B,), jnp.bool_),
            r_starti=zeros_b,
            r_startj=zeros_b,
            r_width=zeros_b,
            r_height=zeros_b,
            r_col=zeros_b,
            corner_col=jnp.full((B,), MIN_VAL, jnp.int32),
            rz=jnp.full((B,), ZERO, jnp.int32),
            # D_max tracker (16 row-residue lanes) and saved grow tracker
            tk_max=jnp.full((B, L), MIN_VAL, jnp.int32),
            tk_ai=jnp.zeros((B, L), jnp.int32),
            tk_aj=jnp.zeros((B, L), jnp.int32),
            gtk_max=jnp.full((B, L), MIN_VAL, jnp.int32),
            gtk_ai=jnp.zeros((B, L), jnp.int32),
            gtk_aj=jnp.zeros((B, L), jnp.int32),
            right_max=zeros_b,
            down_max=zeros_b,
            out_score=zeros_b,
            out_qi=zeros_b,
            out_rj=zeros_b,
        )
        if cfg.trace:
            state.update(
                trace=jnp.zeros((cfg.trace_cap, B, H), jnp.int8),
                meta=jnp.zeros((cfg.trace_cap, B, 2), jnp.int32),
                ev_save=zeros_b,
                ev_restore=zeros_b,
            )

        def bwhere(m, new, old):
            m = m.reshape((B,) + (1,) * (old.ndim - 1))
            return jnp.where(m, new, old)

        def body(s):
            s = dict(s)
            # ---------------- (a) rect-complete transition ----------------
            m_done_rect = (s["phase"] == P_RECT) & (s["r_col"] >= s["r_width"])
            to_mid = m_done_rect & (s["dirn"] == DIR_G) & (s["sub"] == 0)
            s["phase"] = jnp.where(to_mid, P_MIDGROW, jnp.where(m_done_rect, P_END, s["phase"]))

            # ---------------- (d) END bookkeeping ----------------
            s = end_phase(s)

            # ---------------- (b) MIDGROW: set up grow-right rect ---------
            s = midgrow_phase(s)

            # ---------------- (c) START: set up the step's first rect -----
            s = start_phase(s)

            # ---------------- (e) one DP column ---------------------------
            s = column_phase(s)

            s["iters"] = s["iters"] + 1
            return s

        def midgrow_phase(s):
            s = dict(s)
            m_mid = s["phase"] == P_MIDGROW
            if True:
                grow_step = s["blk"] - s["prev_size"]
                s["gtk_max"] = bwhere(m_mid, s["tk_max"], s["gtk_max"])
                s["gtk_ai"] = bwhere(m_mid, s["tk_ai"], s["gtk_ai"])
                s["gtk_aj"] = bwhere(m_mid, s["tk_aj"], s["gtk_aj"])
                s["tk_max"] = bwhere(m_mid, jnp.full((B, L), MIN_VAL, jnp.int32), s["tk_max"])
                s["r_right"] = jnp.where(m_mid, True, s["r_right"])
                s["r_starti"] = jnp.where(m_mid, s["i"], s["r_starti"])
                s["r_startj"] = jnp.where(m_mid, s["j"] + s["prev_size"], s["r_startj"])
                s["r_width"] = jnp.where(m_mid, grow_step, s["r_width"])
                s["r_height"] = jnp.where(m_mid, s["blk"], s["r_height"])
                s["r_col"] = jnp.where(m_mid, 0, s["r_col"])
                s["corner_col"] = jnp.where(m_mid, MIN_VAL, s["corner_col"])
                s["sub"] = jnp.where(m_mid, 1, s["sub"])
                s["phase"] = jnp.where(m_mid, P_RECT, s["phase"])
            return s

        def start_phase(s):
            s = dict(s)
            m = s["phase"] == P_START
            is_r = m & (s["dirn"] == DIR_R)
            is_d = m & (s["dirn"] == DIR_D)
            is_g = m & (s["dirn"] == DIR_G)
            blk = s["blk"]
            lane_ok = lanes[None, :] < blk[:, None]

            # off rebasing for shifts (reference: src/scan_block.rs:148-151)
            off_new = jnp.where(is_r | is_d, s["off_max"], s["off"])
            off_add = _clamp16(s["off"] - off_new)
            s["off"] = off_new
            s["off_add"] = jnp.where(is_r | is_d, off_add, s["off_add"])
            s["rz"] = jnp.where(m, _clamp16(-off_new + ZERO), s["rz"])

            # just_offset on the borders that persist through the shift
            def offset2(a, b, mm):
                mm2 = mm[:, None] & lane_ok
                return (
                    jnp.where(mm2, _sat(a + off_add[:, None]), a),
                    jnp.where(mm2, _sat(b + off_add[:, None]), b),
                )

            s["D_col"], s["C_col"] = offset2(s["D_col"], s["C_col"], is_r)
            s["D_row"], s["R_row"] = offset2(s["D_row"], s["R_row"], is_d)

            corner_use = jnp.where(
                (is_r & (s["prev_dir"] == DIR_D)) | (is_d & (s["prev_dir"] == DIR_R)),
                _sat(s["corner"] + off_add),
                MIN_VAL,
            )
            s["corner"] = jnp.where(is_g, MIN_VAL, s["corner"])

            grow_step = blk - s["prev_size"]
            # rect parameters
            s["r_right"] = jnp.where(m, is_r, s["r_right"])  # grow starts down
            s["r_starti"] = jnp.where(
                is_r, s["i"], jnp.where(is_d | is_g, s["j"], s["r_starti"])
            )
            s["r_startj"] = jnp.where(
                is_r,
                s["j"] + blk - STEP,
                jnp.where(
                    is_d,
                    s["i"] + blk - STEP,
                    jnp.where(is_g, s["i"] + s["prev_size"], s["r_startj"]),
                ),
            )
            s["r_width"] = jnp.where(is_r | is_d, STEP, jnp.where(is_g, grow_step, s["r_width"]))
            s["r_height"] = jnp.where(
                is_r | is_d, blk, jnp.where(is_g, s["prev_size"], s["r_height"])
            )
            # height==0 grow-down rects (first iteration) are skipped outright
            s["r_col"] = jnp.where(
                m, jnp.where(is_g & (s["prev_size"] == 0), s["r_width"], 0), s["r_col"]
            )
            s["corner_col"] = jnp.where(m, jnp.where(is_g, MIN_VAL, corner_use), s["corner_col"])
            s["sub"] = jnp.where(m, 0, s["sub"])
            s["tk_max"] = bwhere(m, jnp.full((B, L), MIN_VAL, jnp.int32), s["tk_max"])
            s["tk_ai"] = bwhere(m, jnp.zeros((B, L), jnp.int32), s["tk_ai"])
            s["tk_aj"] = bwhere(m, jnp.zeros((B, L), jnp.int32), s["tk_aj"])
            s["gtk_max"] = bwhere(m, jnp.full((B, L), MIN_VAL, jnp.int32), s["gtk_max"])
            s["phase"] = jnp.where(m, P_RECT, s["phase"])
            return s

        def column_phase(s):
            s = dict(s)
            m = (s["phase"] == P_RECT) & (s["r_col"] < s["r_width"])
            right = s["r_right"]
            blkH = s["r_height"]
            lane_ok = lanes[None, :] < blkH[:, None]
            cp = s["r_startj"] + s["r_col"]
            d_idx = jnp.where(right, 0, 1).astype(jnp.int32)
            cp_c = jnp.clip(cp, 0, cfg.seq_cap - 1)
            starti = jnp.clip(s["r_starti"], 0, cfg.seq_cap - H)

            c_row = jax.vmap(lambda cr, d, p: cr[d, p])(CRow, d_idx, cp_c)
            nr = 1 if cfg.is_byte else cfg.n_rows
            # rect origins are multiples of STEP and the window stays inside
            # seq_cap, so each lane gathers its row's value directly
            win = starti[:, None] + lanes[None, :]  # (B, H) positions

            def gather_rows(tab, row_idx):
                # tab (B, R, seq_cap): tab[b, row_idx[b], win[b]]
                flat = tab.reshape(B, -1)
                idx = row_idx[:, None] * cfg.seq_cap + win
                return jnp.take_along_axis(flat, idx, axis=1).astype(jnp.int32)

            Srows = Sprof.reshape(B, 2 * nr, cfg.seq_cap)
            if cfg.is_byte:
                lane_codes = gather_rows(Srows, d_idx * nr)
                scores = jnp.where(lane_codes == c_row[:, None], byte_match, byte_mismatch)
            elif cfg.profile:
                # seq-to-PSSM is asymmetric (reference: src/scan_block.rs:597-783):
                # right rects score the profile row at position cp against
                # the query lane window; down rects score one amino acid
                # along positions.
                prof = Srows[:, nr:]  # (B, nr, seq_cap)
                row32 = jnp.take_along_axis(
                    prof, cp_c[:, None, None], axis=2)[:, :, 0].astype(jnp.int32)
                qwin = jnp.take_along_axis(CRow[:, 0, :], win, axis=1)
                scores_r = jnp.take_along_axis(row32, qwin, axis=1)
                scores_d = gather_rows(prof, c_row)
                scores = jnp.where(right[:, None], scores_r, scores_d)
            else:
                scores = gather_rows(Srows, d_idx * nr + c_row)

            if cfg.profile:
                # per-position gap costs (reference: src/scores.rs:341-447;
                # down rects swap C<->R roles, src/scan_block.rs:651-705)
                def gword(v):
                    # per-pair scalar at position cp
                    return jnp.take_along_axis(v, cp_c[:, None], axis=1)[:, 0]

                def gwin(v):
                    return jnp.take_along_axis(v, win, axis=1)

                goc = jnp.where(
                    right[:, None], (gword(GOC) + e)[:, None], gwin(GOR) + e
                )
                gor_v = jnp.where(right[:, None], gword(GOR)[:, None], gwin(GOC))
                gcc_b = gword(GCC)  # right-rect C-close, broadcast
                gcr_v = gwin(GCC)  # down-rect R-close, per lane

            D10 = jnp.where(right[:, None], s["D_col"], s["D_row"])
            C10 = jnp.where(right[:, None], s["C_col"], s["R_row"])
            D00 = jnp.concatenate([s["corner_col"][:, None], D10[:, :-1]], axis=1)

            D11 = _sat(D00 + scores)
            # boundary-origin insert (reference: src/scan_block.rs:1130-1132)
            if cfg.free_query_start_gaps:
                ins0 = right & (s["r_starti"] == 0)
            elif cfg.local_start:
                ins0 = jnp.zeros((B,), jnp.bool_)
            else:
                ins0 = (s["r_starti"] == 0) & (cp == 0)
            D11 = D11.at[:, 0].set(jnp.where(ins0, s["rz"], D11[:, 0]))
            if cfg.local_start:
                D11 = jnp.maximum(D11, s["rz"][:, None])

            if cfg.profile:
                C11_open = _sat(D10 + goc)
                C11 = jnp.maximum(_sat(C10 + e), C11_open)
                # gap close costs when leaving C (right rects only;
                # reference: src/scan_block.rs:692-705)
                C11_end = jnp.where(
                    right[:, None], _sat(C11 + gcc_b[:, None]), C11
                )
            else:
                C11_open = _sat(D10 + gap_open)
                C11 = jnp.maximum(_sat(C10 + e), C11_open)
                C11_end = C11
            D11 = jnp.maximum(D11, C11_end)

            if cfg.profile:
                D11_open = _sat(D11 + gor_v)
            else:
                D11_open = _sat(D11 + (gap_open - e))
            # exact chunked-AVX2 prefix scan, closed form
            ek = e * lanes[None, :]
            run = lax.cummax(D11_open - ek, axis=1)
            R11 = _clamp16(run + ek)
            zero_cand = e * ((lanes % STEP) + 1)
            R11 = jnp.maximum(R11, zero_cand[None, :])
            if cfg.profile:
                # gap close costs when leaving R (down rects only)
                R11_end = jnp.where(right[:, None], R11, _sat(R11 + gcr_v))
            else:
                R11_end = R11
            D11 = jnp.maximum(D11, R11_end)

            if cfg.trace:
                # packed 2+2(+zero)-bit trace emission per cell (reference:
                # src/scan_block.rs:1166-1190); stream format in
                # core/traceback.py
                t_bits = (D11 == C11_end).astype(jnp.int32) | (
                    (D11 == R11_end).astype(jnp.int32) << 1
                )
                temp_tr = (R11 == D11_open).astype(jnp.int32)
                tr_R = jnp.concatenate(
                    [jnp.zeros((B, 1), jnp.int32), temp_tr[:, :-1]], axis=1
                )
                t2_bits = (C11 == C11_open).astype(jnp.int32) | (tr_R << 1)
                packed = t_bits | (t2_bits << 2)
                if cfg.local_start:
                    packed = packed | (
                        (D11 == s["rz"][:, None]).astype(jnp.int32) << 4
                    )
                it = jnp.minimum(s["iters"], cfg.trace_cap - 1)
                s["trace"] = lax.dynamic_update_slice(
                    s["trace"], packed.astype(jnp.int8)[None], (it, 0, 0)
                )
                mi = m.astype(jnp.int32)
                meta1 = (
                    s["r_starti"]
                    | (s["r_right"].astype(jnp.int32) << 25)
                    | (mi << 26)
                    | (s["ev_save"] << 27)
                    | (s["ev_restore"] << 28)
                    | ((mi & (s["r_col"] == 0).astype(jnp.int32)) << 29)
                )
                meta2 = cp | (s["r_height"] << 17)
                s["meta"] = lax.dynamic_update_slice(
                    s["meta"], jnp.stack([meta1, meta2], axis=-1)[None], (it, 0, 0)
                )
                s["ev_save"] = jnp.zeros((B,), jnp.int32)
                s["ev_restore"] = jnp.zeros((B,), jnp.int32)

            # tracker update over 16-row residues
            D11_m = jnp.where(lane_ok, D11, I16_MIN)
            chunks = D11_m.reshape(B, H // L, L)
            col_max = chunks.max(axis=1)
            new_max = jnp.maximum(s["tk_max"], col_max)
            if cfg.x_drop or cfg.free_query_end_gaps:
                eq = chunks == new_max[:, None, :]
                if cfg.free_query_end_gaps:
                    chunk_base = (jnp.arange(H // L, dtype=jnp.int32) * L)[None, :, None]
                    eq = eq & (s["r_starti"][:, None, None] + chunk_base + L > qlen[:, None, None])
                any_eq = eq.any(axis=1)
                # last chunk achieving the (new) max
                nchunk = H // L
                last_idx = (nchunk - 1) - jnp.argmax(eq[:, ::-1, :], axis=1)
                upd = m[:, None] & any_eq
                s["tk_ai"] = jnp.where(upd, last_idx.astype(jnp.int32) * L, s["tk_ai"])
                s["tk_aj"] = jnp.where(upd, s["r_col"][:, None], s["tk_aj"])
            s["tk_max"] = jnp.where(m[:, None], new_max, s["tk_max"])

            # write back borders
            wmask = m[:, None] & lane_ok
            s["D_col"] = jnp.where(wmask & right[:, None], D11, s["D_col"])
            s["C_col"] = jnp.where(wmask & right[:, None], C11, s["C_col"])
            s["D_row"] = jnp.where(wmask & ~right[:, None], D11, s["D_row"])
            s["R_row"] = jnp.where(wmask & ~right[:, None], C11, s["R_row"])

            # bottom-border outputs: masked selects at one lane per pair
            hm1 = jnp.clip(blkH - 1, 0, H - 1)
            bot_mask = lanes[None, :] == hm1[:, None]
            d_bot = jnp.max(jnp.where(bot_mask, D11, I16_MIN), axis=1)
            r_bot = jnp.max(jnp.where(bot_mask, R11, I16_MIN), axis=1)
            is_shift = s["dirn"] != DIR_G
            # shift rects stage bottoms directly at their final spliced
            # position blk-STEP+col in a full-width buffer
            tpos = jnp.clip(s["blk"] - STEP + s["r_col"], 0, H - 1)
            tmask = (m & is_shift)[:, None] & (lanes[None, :] == tpos[:, None])
            s["tempD"] = jnp.where(tmask, d_bot[:, None], s["tempD"])
            s["tempR"] = jnp.where(tmask, r_bot[:, None], s["tempR"])
            # grow rects write bottoms straight into the other border's
            # extension (reference: src/scan_block.rs:262-305)
            gcol = jnp.clip(s["prev_size"] + s["r_col"], 0, H - 1)
            gc_mask = lanes[None, :] == gcol[:, None]
            m_gd = (m & ~is_shift & (s["sub"] == 0))[:, None] & gc_mask  # grow-down
            m_gr = (m & ~is_shift & (s["sub"] == 1))[:, None] & gc_mask  # grow-right
            s["D_col"] = jnp.where(m_gd, d_bot[:, None], s["D_col"])
            s["C_col"] = jnp.where(m_gd, r_bot[:, None], s["C_col"])
            s["D_row"] = jnp.where(m_gr, d_bot[:, None], s["D_row"])
            s["R_row"] = jnp.where(m_gr, r_bot[:, None], s["R_row"])

            s["corner_col"] = jnp.where(m, MIN_VAL, s["corner_col"])
            new_col = s["r_col"] + 1
            # global-mode early exit freezes the rect once both seq ends are
            # passed (reference: src/scan_block.rs:1216-1224)
            if not (cfg.x_drop or cfg.free_query_end_gaps):
                lane_len = jnp.where(right, qlen, rlen)
                col_len = jnp.where(right, rlen, qlen)
                frozen = (s["r_starti"] + s["r_height"] > lane_len) & (cp >= col_len)
                new_col = jnp.where(frozen, s["r_width"], new_col)
            s["r_col"] = jnp.where(m, new_col, s["r_col"])
            return s

        def end_phase(s):
            s = dict(s)
            m = s["phase"] == P_END
            is_r = m & (s["dirn"] == DIR_R)
            is_d = m & (s["dirn"] == DIR_D)
            is_g = m & (s["dirn"] == DIR_G)
            blk = s["blk"]
            off_add = s["off_add"]
            bidx = jnp.arange(B)

            s["prev_dir"] = jnp.where(m, s["dirn"], s["prev_dir"])

            # shift_and_offset of the passive border pair; the column phase
            # already staged the new tail at its final position in temp*
            def shift_splice(a, b, mm):
                corner_new = _sat(a[:, STEP - 1] + off_add)
                sh_a = _sat(jnp.roll(a, -STEP, axis=1) + off_add[:, None])
                sh_b = _sat(jnp.roll(b, -STEP, axis=1) + off_add[:, None])
                pos = lanes[None, :]
                in_main = pos < (blk - STEP)[:, None]
                in_tail = (pos >= (blk - STEP)[:, None]) & (pos < blk[:, None])
                na = jnp.where(in_main, sh_a, jnp.where(in_tail, s["tempD"], a))
                nb = jnp.where(in_main, sh_b, jnp.where(in_tail, s["tempR"], b))
                mm2 = mm[:, None]
                return jnp.where(mm2, na, a), jnp.where(mm2, nb, b), corner_new

            nDr, nRr, cr = shift_splice(s["D_row"], s["R_row"], is_r)
            s["D_row"], s["R_row"] = nDr, nRr
            nDc, nCc, cd = shift_splice(s["D_col"], s["C_col"], is_d)
            s["D_col"], s["C_col"] = nDc, nCc
            s["corner"] = jnp.where(is_r, cr, jnp.where(is_d, cd, s["corner"]))

            right_max = s["D_col"][:, :STEP].max(axis=1)
            down_max = s["D_row"][:, :STEP].max(axis=1)

            # grow steps re-save the checkpoint (reference: src/scan_block.rs:313-327)
            def save_ck(s, mm):
                lane_ok = lanes[None, :] < blk[:, None]
                mm2 = mm[:, None] & lane_ok
                s["Dc_ck"] = jnp.where(mm2, s["D_col"], s["Dc_ck"])
                s["Cc_ck"] = jnp.where(mm2, s["C_col"], s["Cc_ck"])
                s["Dr_ck"] = jnp.where(mm2, s["D_row"], s["Dr_ck"])
                s["Rr_ck"] = jnp.where(mm2, s["R_row"], s["Rr_ck"])
                return s

            s = save_ck(s, is_g)

            lane16 = jnp.arange(L, dtype=jnp.int32)[None, :]

            def pick16(arr, idx):
                return jnp.max(
                    jnp.where(lane16 == idx[:, None], arr, jnp.iinfo(jnp.int32).min), axis=1
                )

            if cfg.free_query_end_gaps:
                qmod = (qlen % L).astype(jnp.int32)
                D_max_max = pick16(s["tk_max"], qmod)
            else:
                D_max_max = s["tk_max"].max(axis=1)
            grow_max = s["gtk_max"].max(axis=1)
            cur_max = jnp.maximum(D_max_max, grow_max)
            off_max = s["off"] + cur_max - ZERO
            s["off_max"] = jnp.where(m, off_max, s["off_max"])

            y_drop = s["y_drop"] + 1
            grow_no_max = is_g

            improved = m & (off_max > s["best_max"])

            if cfg.free_query_end_gaps:
                idx_j = pick16(s["tk_aj"], qmod)
                bi_f = qlen
                bj_f = jnp.where(
                    s["dirn"] == DIR_R,
                    s["j"] + (blk - STEP) + idx_j,
                    s["j"] + s["prev_size"] + idx_j,
                )
                s["best_i"] = jnp.where(improved, bi_f, s["best_i"])
                s["best_j"] = jnp.where(improved, bj_f, s["best_j"])

            if cfg.x_drop:
                lane_idx = jnp.argmax(s["tk_max"] == D_max_max[:, None], axis=1).astype(
                    jnp.int32
                )
                idx_i = pick16(s["tk_ai"], lane_idx)
                idx_j = pick16(s["tk_aj"], lane_idx)
                r_pos = idx_i + lane_idx
                c_pos = (blk - STEP) + idx_j
                g_lane = jnp.argmax(s["gtk_max"] == grow_max[:, None], axis=1).astype(jnp.int32)
                g_ii = pick16(s["gtk_ai"], g_lane)
                g_jj = pick16(s["gtk_aj"], g_lane)
                use_right_grow = D_max_max >= grow_max
                bi = jnp.where(
                    s["dirn"] == DIR_R,
                    s["i"] + r_pos,
                    jnp.where(
                        s["dirn"] == DIR_D,
                        s["i"] + c_pos,
                        jnp.where(
                            use_right_grow,
                            s["i"] + idx_i + lane_idx,
                            s["i"] + s["prev_size"] + g_jj,
                        ),
                    ),
                )
                bj = jnp.where(
                    s["dirn"] == DIR_R,
                    s["j"] + c_pos,
                    jnp.where(
                        s["dirn"] == DIR_D,
                        s["j"] + r_pos,
                        jnp.where(
                            use_right_grow,
                            s["j"] + s["prev_size"] + idx_j,
                            s["j"] + g_ii + g_lane,
                        ),
                    ),
                )
                s["best_i"] = jnp.where(improved, bi, s["best_i"])
                s["best_j"] = jnp.where(improved, bj, s["best_j"])

            can_ck = improved & (blk < cfg.max_size)
            s["ickpt"] = jnp.where(can_ck, s["i"], s["ickpt"])
            s["jckpt"] = jnp.where(can_ck, s["j"], s["jckpt"])
            s["offckpt"] = jnp.where(can_ck, s["off"], s["offckpt"])
            s = save_ck(s, can_ck)
            grow_no_max = grow_no_max & ~can_ck
            s["best_max"] = jnp.where(improved, off_max, s["best_max"])
            y_drop = jnp.where(improved, 0, y_drop)

            done_now = jnp.zeros((B,), jnp.bool_)
            if cfg.x_drop:
                xfail = m & (off_max < s["best_max"] - x_drop_amt)
                terminate = xfail & (s["x_iter"] >= X_DROP_ITER - 1)
                s["x_iter"] = jnp.where(
                    xfail, s["x_iter"] + 1, jnp.where(m, 0, s["x_iter"])
                )
                done_now = done_now | terminate

            reached_end = m & (s["i"] + blk > qlen) & (s["j"] + blk > rlen)
            done_now = done_now | reached_end

            # final score extraction (reference: src/scan_block.rs:567-592)
            if cfg.x_drop or cfg.free_query_end_gaps:
                fscore = s["best_max"]
                fqi = s["best_i"]
                frj = s["best_j"]
            else:
                use_col = s["dirn"] != DIR_D
                idx = jnp.where(use_col, qlen - s["i"], rlen - s["j"])
                idx = jnp.clip(idx, 0, H - 1)
                border = jnp.where(use_col[:, None], s["D_col"], s["D_row"])
                val = jnp.max(
                    jnp.where(lanes[None, :] == idx[:, None], border, jnp.iinfo(jnp.int32).min),
                    axis=1,
                )
                fscore = s["off"] + val - ZERO
                fqi = qlen
                frj = rlen
            s["out_score"] = jnp.where(done_now, fscore, s["out_score"])
            s["out_qi"] = jnp.where(done_now, fqi, s["out_qi"])
            s["out_rj"] = jnp.where(done_now, frj, s["out_rj"])

            cont = m & ~done_now
            # forced directions at sequence ends
            forced_down = cont & (s["j"] + blk > rlen)
            forced_right = cont & ~forced_down & (s["i"] + blk > qlen)
            free = cont & ~forced_down & ~forced_right

            # grow heuristic + checkpoint restore
            next_size = blk * 2
            do_grow = free & (next_size <= cfg.max_size) & (
                (y_drop > (blk // STEP) - 1) | grow_no_max
            )
            lane_ok_prev = lanes[None, :] < blk[:, None]  # prev_size = old blk
            gm = do_grow[:, None] & lane_ok_prev
            s["D_col"] = jnp.where(gm, s["Dc_ck"], s["D_col"])
            s["C_col"] = jnp.where(gm, s["Cc_ck"], s["C_col"])
            s["D_row"] = jnp.where(gm, s["Dr_ck"], s["D_row"])
            s["R_row"] = jnp.where(gm, s["Rr_ck"], s["R_row"])
            s["prev_size"] = jnp.where(do_grow, blk, s["prev_size"])
            s["i"] = jnp.where(do_grow, s["ickpt"], s["i"])
            s["j"] = jnp.where(do_grow, s["jckpt"], s["j"])
            s["off"] = jnp.where(do_grow, s["offckpt"], s["off"])
            s["blk"] = jnp.where(do_grow, next_size, s["blk"])
            s["dirn"] = jnp.where(do_grow, DIR_G, s["dirn"])
            y_drop = jnp.where(do_grow, 0, y_drop)
            blk = s["blk"]

            # shrink heuristic
            maybe_shrink = free & ~do_grow & (blk > cfg.min_size) & (y_drop == 0)
            sfx_mask = (lanes[None, :] >= (blk - SHRINK_SUFFIX)[:, None]) & (
                lanes[None, :] < blk[:, None]
            )
            neg = jnp.iinfo(jnp.int32).min
            shrink_max = jnp.maximum(
                jnp.max(jnp.where(sfx_mask, s["D_row"], neg), axis=1),
                jnp.max(jnp.where(sfx_mask, s["D_col"], neg), axis=1),
            )
            do_shrink = maybe_shrink & (shrink_max >= cur_max)
            blk2 = blk // 2
            # per-pair variable left-shift by blk2, composed from static rolls
            # over the possible power-of-two sizes (no gathers)
            sm = do_shrink[:, None] & (lanes[None, :] < blk2[:, None])
            for nm in ("D_col", "C_col", "D_row", "R_row"):
                a = s[nm]
                moved = a
                p = cfg.min_size
                while p <= cfg.max_size // 2:
                    moved = jnp.where((blk2 == p)[:, None], jnp.roll(a, -p, axis=1), moved)
                    p *= 2
                s[nm] = jnp.where(sm, moved, a)
            s["blk"] = jnp.where(do_shrink, blk2, s["blk"])
            s["i"] = jnp.where(do_shrink, s["i"] + blk2, s["i"])
            s["j"] = jnp.where(do_shrink, s["j"] + blk2, s["j"])
            s["ickpt"] = jnp.where(do_shrink, s["i"], s["ickpt"])
            s["jckpt"] = jnp.where(do_shrink, s["j"], s["jckpt"])
            s["offckpt"] = jnp.where(do_shrink, s["off"], s["offckpt"])
            s = save_ck_shrink(s, do_shrink)
            right_max = jnp.where(do_shrink, s["D_col"][:, :STEP].max(axis=1), right_max)
            down_max = jnp.where(do_shrink, s["D_row"][:, :STEP].max(axis=1), down_max)
            s["prev_dir"] = jnp.where(do_shrink, DIR_G, s["prev_dir"])
            y_drop = jnp.where(do_shrink, 0, y_drop)

            if cfg.trace:
                # trace-stack checkpoint events, consumed by the next column's
                # meta record (reference: src/scan_block.rs:1451-1462); save
                # marks happen on grow completion, new-best, and shrink;
                # restore pops on grow (oracle: _align_core)
                s["ev_save"] = (is_g | can_ck | do_shrink).astype(jnp.int32)
                s["ev_restore"] = do_grow.astype(jnp.int32)

            # direction choice (reference: src/scan_block.rs:551-558)
            choose = (free & ~do_grow) | forced_down | forced_right
            godown = forced_down | (free & ~do_grow & (down_max > right_max) & ~forced_right)
            s["i"] = jnp.where(choose & godown, s["i"] + STEP, s["i"])
            s["j"] = jnp.where(choose & ~godown, s["j"] + STEP, s["j"])
            s["dirn"] = jnp.where(
                choose, jnp.where(godown, DIR_D, DIR_R), s["dirn"]
            )

            s["y_drop"] = jnp.where(m, y_drop, s["y_drop"])
            s["phase"] = jnp.where(
                m, jnp.where(done_now, P_DONE, P_START), s["phase"]
            )
            return s

        def save_ck_shrink(s, mm):
            lane_ok = lanes[None, :] < s["blk"][:, None]
            mm2 = mm[:, None] & lane_ok
            s["Dc_ck"] = jnp.where(mm2, s["D_col"], s["Dc_ck"])
            s["Cc_ck"] = jnp.where(mm2, s["C_col"], s["Cc_ck"])
            s["Dr_ck"] = jnp.where(mm2, s["D_row"], s["Dr_ck"])
            s["Rr_ck"] = jnp.where(mm2, s["R_row"], s["Rr_ck"])
            return s

        SHRINK_SUFFIX = STEP // 4

        def cond(s):
            return jnp.any(s["phase"] != P_DONE) & (s["iters"] < cfg.iter_cap)

        final = lax.while_loop(cond, body, state)
        if cfg.trace:
            return (
                final["out_score"], final["out_qi"], final["out_rj"],
                final["iters"], final["trace"], final["meta"],
            )
        return final["out_score"], final["out_qi"], final["out_rj"], final["iters"]

    return jax.jit(engine)


def pack_pairs(pairs, matrix, cfg: EngineConfig):
    """Host-side packer: build (Sprof, CRow, qlen, rlen) numpy arrays for a
    list of (query_bytes, reference_bytes) pairs.

    Implements the per-pair query-profile precompute that replaces the
    reference's pshufb score lookup (reference TODO at src/scores.rs:115).
    """
    from ..core.scores import ByteMatrix

    B, Lmax = cfg.batch, cfg.seq_cap
    assert len(pairs) <= B
    is_byte = isinstance(matrix, ByteMatrix)
    nr = 1 if is_byte else cfg.n_rows
    Sprof = np.full((B, 2, nr, Lmax), -128, dtype=np.int8)
    CRow = np.zeros((B, 2, Lmax), dtype=np.int32)
    qlen = np.zeros(B, dtype=np.int32)
    rlen = np.zeros(B, dtype=np.int32)

    null_code = int(matrix.convert(bytes([matrix.NULL]))[0])

    # batch-wide code matrices: one conversion pass over the concatenation
    # plus per-pair memcpy slices, then single whole-batch gathers (the
    # per-pair fancy-indexing loop this replaces dominated short-sequence
    # end-to-end time)
    def as_bytes(s):
        return s.encode("ascii") if isinstance(s, str) else bytes(s)

    qs = [as_bytes(q) for q, _ in pairs]
    rs = [as_bytes(r) for _, r in pairs]
    qlen[: len(pairs)] = np.fromiter((len(x) for x in qs), np.int32, len(qs))
    rlen[: len(pairs)] = np.fromiter((len(x) for x in rs), np.int32, len(rs))
    QP = np.full((B, Lmax), null_code, dtype=np.uint8)
    RP = np.full((B, Lmax), null_code, dtype=np.uint8)
    qcat = matrix.convert(b"".join(qs)) if qlen.sum() else None
    rcat = matrix.convert(b"".join(rs)) if rlen.sum() else None
    qoff = np.concatenate([[0], np.cumsum(qlen[: len(pairs)])])
    roff = np.concatenate([[0], np.cumsum(rlen[: len(pairs)])])
    for b in range(len(pairs)):
        if qlen[b]:
            QP[b, 1 : 1 + qlen[b]] = qcat[qoff[b] : qoff[b + 1]]
        if rlen[b]:
            RP[b, 1 : 1 + rlen[b]] = rcat[roff[b] : roff[b + 1]]

    if is_byte:
        # bytes >= 128 wrap to negative i8, consistently on both sides
        Sprof[:, 0, 0] = QP.astype(np.int8)
        Sprof[:, 1, 0] = RP.astype(np.int8)
        CRow[:, 0] = RP.astype(np.int8)
        CRow[:, 1] = QP.astype(np.int8)
    else:
        tab = matrix.dense().astype(np.int8)
        cols_q = matrix.col_index(QP).astype(np.int64)
        cols_r = matrix.col_index(RP).astype(np.int64)
        Sprof[:, 0] = tab[:nr, cols_q].transpose(1, 0, 2)
        Sprof[:, 1] = tab[:nr, cols_r].transpose(1, 0, 2)
        CRow[:, 0] = matrix.row_index(RP).astype(np.int64)
        CRow[:, 1] = matrix.row_index(QP).astype(np.int64)
    return Sprof, CRow, qlen, rlen


def pack_profiles(pairs, cfg: EngineConfig):
    """Host-side packer for sequence-to-PSSM batches.

    ``pairs`` is a list of ``(query_bytes, AAProfile)``; the profile plays
    the reference role (reference: src/scan_block.rs:942-995).  Returns
    ``(Sprof, CRow, qlen, rlen, GOC, GCC, GOR, gap_extend)``:

      Sprof[b, 1, a, p] = profile score of amino acid ``a`` at position p
      (the reference's transposed ``aa_pos`` layout, src/scores.rs:454-468);
      Sprof[b, 0] is unused.  CRow[b, :, p] = query code at p.  GOC/GCC/GOR
      are the per-position gap open/close cost vectors.
    """
    assert cfg.profile
    B, Lmax, nr = cfg.batch, cfg.seq_cap, cfg.n_rows
    Sprof = np.full((B, 2, nr, Lmax), -128, dtype=np.int8)
    CRow = np.full((B, 2, Lmax), nr - 1, dtype=np.int32)
    GOC = np.full((B, Lmax), -128, dtype=np.int32)
    GCC = np.full((B, Lmax), -128, dtype=np.int32)
    GOR = np.full((B, Lmax), -128, dtype=np.int32)
    qlen = np.zeros(B, dtype=np.int32)
    rlen = np.zeros(B, dtype=np.int32)
    gap_extend = None

    for b, (q, prof) in enumerate(pairs):
        if prof is None:  # batch padding entry
            continue
        if gap_extend is None:
            gap_extend = prof.get_gap_extend()
        assert gap_extend == prof.get_gap_extend(), (
            "all profiles in a batch must share gap_extend"
        )
        qc = prof.convert(q).astype(np.int64)
        qlen[b] = len(qc)
        rlen[b] = prof.str_len
        # the engine only reads positions < seq_cap; profiles padded with a
        # larger block_size than max_size just truncate harmlessly
        cl = min(prof.curr_len, prof.str_len + cfg.max_size + 1, Lmax)
        assert prof.str_len + cfg.max_size + 1 <= Lmax, "profile too long"
        assert 1 + len(qc) + cfg.max_size + 16 <= Lmax, "query too long"
        qp = np.full(Lmax, 26, dtype=np.int64)  # NULL code
        qp[1 : 1 + len(qc)] = qc
        CRow[b, 0] = qp
        CRow[b, 1] = qp
        ps = np.asarray(prof.pos_scores[:cl], dtype=np.int64)
        assert ps.min() >= -128 and ps.max() <= 127
        Sprof[b, 1, :, :cl] = ps.T[:nr].astype(np.int8)
        GOC[b, :cl] = prof.gap_open_C[:cl]
        GCC[b, :cl] = prof.gap_close_C[:cl]
        GOR[b, :cl] = prof.gap_open_R[:cl]
    return Sprof, CRow, qlen, rlen, GOC, GCC, GOR, (gap_extend or -1)
