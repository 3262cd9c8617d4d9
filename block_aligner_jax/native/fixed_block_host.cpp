// Host build of the CUDA fixed-block walk (fixed_block.cuh): the lane group
// is emulated as a G-wide array, so the exact source the GPU kernel runs is
// checked against the scalar oracle by the CPU tests.  Not a fast path.
//
// Build (done at first use by block_aligner_jax/native/__init__.py):
//   g++ -O2 -std=c++17 -shared -fPIC -o libbafixedhost.so fixed_block_host.cpp

#include <algorithm>

#include "fixed_block.cuh"

using namespace ba_fixed;

namespace {

template <int G>
struct HV {
  int v[G];
};

#define BA_BINOP(op)                                                        \
  template <int G>                                                          \
  HV<G> operator op(const HV<G>& a, const HV<G>& b) {                       \
    HV<G> o;                                                                \
    for (int k = 0; k < G; ++k) o.v[k] = a.v[k] op b.v[k];                  \
    return o;                                                               \
  }                                                                         \
  template <int G>                                                          \
  HV<G> operator op(const HV<G>& a, int b) {                                \
    HV<G> o;                                                                \
    for (int k = 0; k < G; ++k) o.v[k] = a.v[k] op b;                       \
    return o;                                                               \
  }                                                                         \
  template <int G>                                                          \
  HV<G> operator op(int a, const HV<G>& b) {                                \
    HV<G> o;                                                                \
    for (int k = 0; k < G; ++k) o.v[k] = a op b.v[k];                       \
    return o;                                                               \
  }

BA_BINOP(+)
BA_BINOP(-)
BA_BINOP(*)
BA_BINOP(&)
BA_BINOP(|)
BA_BINOP(<<)
BA_BINOP(>>)
BA_BINOP(==)
BA_BINOP(<)
BA_BINOP(>)
BA_BINOP(>=)
#undef BA_BINOP

template <int G_>
struct HostLanes {
  static constexpr int G = G_;
  using V = HV<G>;

  static V splat(int x) {
    V o;
    for (int k = 0; k < G; ++k) o.v[k] = x;
    return o;
  }
  V lane() const {
    V o;
    for (int k = 0; k < G; ++k) o.v[k] = k;
    return o;
  }
  static V vmax(const V& a, const V& b) {
    V o;
    for (int k = 0; k < G; ++k) o.v[k] = std::max(a.v[k], b.v[k]);
    return o;
  }
  static V vsel(const V& c, const V& a, const V& b) {
    V o;
    for (int k = 0; k < G; ++k) o.v[k] = c.v[k] ? a.v[k] : b.v[k];
    return o;
  }
  static V vclamp(const V& x, int lo, int hi) {
    V o;
    for (int k = 0; k < G; ++k) o.v[k] = std::min(std::max(x.v[k], lo), hi);
    return o;
  }
  V shfl_up(const V& x, int d) const {
    V o;
    for (int k = 0; k < G; ++k) o.v[k] = k >= d ? x.v[k - d] : x.v[k];
    return o;
  }
  V shfl_down(const V& x, int d) const {
    V o;
    for (int k = 0; k < G; ++k) o.v[k] = k + d < G ? x.v[k + d] : x.v[k];
    return o;
  }
  int bcast(const V& x, int src) const { return x.v[src]; }
  int max_all(const V& x) const {
    int m = x.v[0];
    for (int k = 1; k < G; ++k) m = std::max(m, x.v[k]);
    return m;
  }
  V load(const uint8_t* p, const V& idx) const {
    V o;
    for (int k = 0; k < G; ++k) o.v[k] = p[idx.v[k]];
    return o;
  }
  V score(const int8_t* tab, int c, const V& code) const {
    V o;
    for (int k = 0; k < G; ++k) o.v[k] = tab[c * 32 + code.v[k]];
    return o;
  }
};

template <int S, bool XDROP>
void run_all(const uint8_t* codes, const int32_t* meta, const int8_t* table,
             int32_t* out, int n, const Params& prm) {
  constexpr int G = S < 32 ? S : 32;
  HostLanes<G> lp;
  for (int b = 0; b < n; ++b) {
    const int32_t* m = meta + 4 * b;
    Pair p{codes + m[0], codes + m[1], m[2], m[3]};
    Walk<HostLanes<G>, S, XDROP> w(lp, table, prm);
    Result res = w.run(p);
    out[3 * b] = res.score;
    out[3 * b + 1] = res.qi;
    out[3 * b + 2] = res.rj;
  }
}

template <bool XDROP>
int dispatch(int block, const uint8_t* c, const int32_t* m, const int8_t* t,
             int32_t* o, int n, const Params& prm) {
  switch (block) {
    case 16: run_all<16, XDROP>(c, m, t, o, n, prm); return 0;
    case 32: run_all<32, XDROP>(c, m, t, o, n, prm); return 0;
    case 64: run_all<64, XDROP>(c, m, t, o, n, prm); return 0;
    case 128: run_all<128, XDROP>(c, m, t, o, n, prm); return 0;
    case 256: run_all<256, XDROP>(c, m, t, o, n, prm); return 0;
    case 512: run_all<512, XDROP>(c, m, t, o, n, prm); return 0;
    default: return -1;
  }
}

}  // namespace

extern "C" int ba_fixed_block_host(const uint8_t* codes, const int32_t* meta,
                                   const int8_t* table, int32_t* out,
                                   int32_t n_pairs, int32_t block,
                                   int32_t x_drop_mode, int32_t gap_open,
                                   int32_t gap_extend, int32_t x_drop,
                                   int32_t byte_mode, int32_t match,
                                   int32_t mismatch) {
  Params prm{gap_open, gap_extend, x_drop, byte_mode, match, mismatch};
  return x_drop_mode ? dispatch<true>(block, codes, meta, table, out, n_pairs, prm)
                     : dispatch<false>(block, codes, meta, table, out, n_pairs, prm);
}
