// Native traceback runtime for block_aligner_jax.
//
// Decodes the batched engine's per-iteration trace stream (format:
// block_aligner_jax/core/traceback.py) and walks the reference's OP_LUT
// traceback (reference: src/scan_block.rs:1469-1672) to a run-length-encoded
// CIGAR.  This is the host-side hot path when tracing large batches; the
// Python decoder is kept as a fallback.
//
// Build: g++ -O3 -shared -fPIC -o libbawalker.so walker.cpp

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

// operations, same encoding as core/cigar.py (reference: src/cigar.rs:10-31)
enum Op : int32_t { OP_SENTINEL = 0, OP_M = 1, OP_EQ = 2, OP_X = 3, OP_I = 4, OP_D = 5 };

struct LutEntry {
  int8_t op, di, dj, table;
};

// 2x64-entry LUT keyed by (t << 4 | t2 << 2 | table)
// (reference: src/scan_block.rs:1506-1572)
struct Lut {
  LutEntry e[2][64];
  Lut() {
    const int D = 0, C = 1, R = 2;
    for (int right = 0; right < 2; right++) {
      for (int t = 0; t < 4; t++) {
        for (int t2 = 0; t2 < 4; t2++) {
          for (int table = 0; table < 3; table++) {
            LutEntry r{};
            if (right == 1) {
              if (table == C) {
                r = (t2 == 0b00 || t2 == 0b10) ? LutEntry{OP_D, 0, 1, (int8_t)C}
                                               : LutEntry{OP_D, 0, 1, (int8_t)D};
              } else if (table == R) {
                r = (t2 == 0b00 || t2 == 0b01) ? LutEntry{OP_I, 1, 0, (int8_t)R}
                                               : LutEntry{OP_I, 1, 0, (int8_t)D};
              } else {
                if (t == 0b00) {
                  r = LutEntry{OP_M, 1, 1, (int8_t)D};
                } else if (t == 0b01 || t == 0b11) {
                  r = (t2 == 0b00 || t2 == 0b10) ? LutEntry{OP_D, 0, 1, (int8_t)C}
                                                 : LutEntry{OP_D, 0, 1, (int8_t)D};
                } else {
                  r = (t2 == 0b00 || t2 == 0b01) ? LutEntry{OP_I, 1, 0, (int8_t)R}
                                                 : LutEntry{OP_I, 1, 0, (int8_t)D};
                }
              }
            } else {
              if (table == R) {
                r = (t2 == 0b00 || t2 == 0b10) ? LutEntry{OP_I, 1, 0, (int8_t)R}
                                               : LutEntry{OP_I, 1, 0, (int8_t)D};
              } else if (table == C) {
                r = (t2 == 0b00 || t2 == 0b01) ? LutEntry{OP_D, 0, 1, (int8_t)C}
                                               : LutEntry{OP_D, 0, 1, (int8_t)D};
              } else {
                if (t == 0b00) {
                  r = LutEntry{OP_M, 1, 1, (int8_t)D};
                } else if (t == 0b01 || t == 0b11) {
                  r = (t2 == 0b00 || t2 == 0b10) ? LutEntry{OP_I, 1, 0, (int8_t)R}
                                                 : LutEntry{OP_I, 1, 0, (int8_t)D};
                } else {
                  r = (t2 == 0b00 || t2 == 0b01) ? LutEntry{OP_D, 0, 1, (int8_t)C}
                                                 : LutEntry{OP_D, 0, 1, (int8_t)D};
                }
              }
            }
            e[right][(t << 4) | (t2 << 2) | table] = r;
          }
        }
      }
    }
  }
};

const Lut kLut;

struct Rect {
  int32_t row, col;  // DP origin
  bool right;
  int32_t first;      // index into the shared rows vector
  int32_t n;          // number of place columns recorded
};

}  // namespace

extern "C" {

// Decode the event stream for pair `b` and walk the traceback from (i, j).
// trace_t: (B, T, H) int8 and meta_t: (B, T, 2) int32 -- both pair-major so
// the replay and the walk read local memory; iters <= T.
// qcodes/rcodes (nullable): padded code arrays (1-based positions) for =/X
// resolution. out_ops receives (op, len) pairs in forward order; returns the
// number of pairs written, or -1 if out_cap is too small, -2 on bad input.
int64_t ba_trace_cigar(const int8_t* trace_t, const int32_t* meta_t,
                       int64_t T, int64_t B, int64_t H, int64_t iters,
                       int64_t b, int64_t i, int64_t j, int32_t local_start,
                       int32_t free_query_start_gaps, int32_t eq,
                       const uint8_t* qcodes, const uint8_t* rcodes,
                       int32_t* out_ops, int64_t out_cap) {
  if (iters > T || b >= B) return -2;
  const int32_t* mrow = meta_t + (size_t)b * (size_t)T * 2;
  const int8_t* trow = trace_t + (size_t)b * (size_t)T * (size_t)H;

  // ---- replay the event stream into the final rect list ----
  std::vector<Rect> rects;
  std::vector<int32_t> rows;  // shared row-index storage
  rects.reserve((size_t)(iters / 8 + 4));
  rows.reserve((size_t)iters);
  size_t saved_len = 0, saved_rows = 0;
  for (int64_t it = 0; it < iters; it++) {
    const int32_t m1 = mrow[it * 2];
    const int32_t m2 = mrow[it * 2 + 1];
    const bool valid = (m1 >> 26) & 1;
    if ((m1 >> 27) & 1) {  // save mark (before restore; see traceback.py)
      saved_len = rects.size();
      saved_rows = rows.size();
    }
    if ((m1 >> 28) & 1) {  // restore: pop rects after the mark
      rects.resize(saved_len);
      rows.resize(saved_rows);
    }
    if (!valid) continue;
    if ((m1 >> 29) & 1) {  // rect start
      const int32_t starti = m1 & ((1 << 25) - 1);
      const bool right = (m1 >> 25) & 1;
      const int32_t colpos = m2 & ((1 << 17) - 1);
      Rect r;
      r.right = right;
      r.row = right ? starti : colpos;
      r.col = right ? colpos : starti;
      r.first = (int32_t)rows.size();
      r.n = 0;
      rects.push_back(r);
    }
    if (rects.empty()) return -2;
    rects.back().n++;
    rows.push_back((int32_t)it);
  }

  // ---- OP_LUT walk (reference: src/scan_block.rs:1576-1632) ----
  // ops are emitted in reverse; coalesced, then reversed at the end
  std::vector<int64_t> rev;  // packed (op << 32 | len)? keep two arrays
  std::vector<int32_t> rop, rlen;
  int32_t table = 0;
  int64_t rect_idx = (int64_t)rects.size();
  bool outer_done = false;
  while ((i > 0 || j > 0) && !outer_done) {
    const Rect* rect;
    while (true) {
      rect_idx--;
      if (rect_idx < 0) return -2;
      rect = &rects[(size_t)rect_idx];
      if (i >= rect->row && j >= rect->col) break;
    }
    const int64_t bi = rect->row, bj = rect->col;
    while (i >= bi && j >= bj && (i > 0 || j > 0)) {
      int64_t pc, lane;
      if (rect->right) {
        if (free_query_start_gaps && i == 0) {
          outer_done = true;
          break;
        }
        pc = j - bj;
        lane = i - bi;
      } else {
        pc = i - bi;
        lane = j - bj;
      }
      if (pc >= rect->n || lane >= H) return -2;
      const int64_t it = rows[(size_t)(rect->first + pc)];
      const int8_t cell = trow[it * H + lane];
      const int t = cell & 3;
      const int t2 = (cell >> 2) & 3;
      if (local_start && table == 0 && ((cell >> 4) & 1)) {
        outer_done = true;
        break;
      }
      const LutEntry& le = kLut.e[rect->right ? 1 : 0][(t << 4) | (t2 << 2) | table];
      int32_t op = le.op;
      if (eq && op == OP_M) {
        op = (qcodes[i] == rcodes[j]) ? OP_EQ : OP_X;
      }
      i -= le.di;
      j -= le.dj;
      table = le.table;
      if (!rop.empty() && rop.back() == op) {
        rlen.back()++;
      } else {
        rop.push_back(op);
        rlen.push_back(1);
      }
    }
  }

  const int64_t n = (int64_t)rop.size();
  if (n * 2 > out_cap) return -1;
  for (int64_t k = 0; k < n; k++) {  // reverse to forward order
    out_ops[2 * k] = rop[(size_t)(n - 1 - k)];
    out_ops[2 * k + 1] = rlen[(size_t)(n - 1 - k)];
  }
  return n;
}

}  // extern "C"
