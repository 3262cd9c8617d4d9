// C API implementation: embeds the Python runtime and dispatches into the
// block_aligner_jax framework (see block_aligner_jax.h for the contract;
// reference FFI: src/ffi.rs).
//
// Handles are PyObject* (oracle aligners, PaddedBytes, matrices, profiles,
// Cigar).  Single-pair aligner calls run the exact scalar engine on the
// host; block_align_batch_aa builds a BatchAligner and runs on JAX's
// default device.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include "block_aligner_jax.h"

namespace {

PyObject* g_mod = nullptr;  // block_aligner_jax module

struct Gil {
  PyGILState_STATE st;
  Gil() : st(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(st); }
};

void die(const char* where) {
  fprintf(stderr, "block_aligner_jax C API error in %s:\n", where);
  PyErr_Print();
  abort();
}

PyObject* mod() {
  if (!g_mod) die("runtime not initialized");
  return g_mod;
}

PyObject* call(PyObject* target, const char* method, PyObject* args) {
  PyObject* f = PyObject_GetAttrString(target, method);
  if (!f) die(method);
  PyObject* r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  if (!r) die(method);
  return r;
}

long getint(PyObject* o, const char* attr) {
  PyObject* a = PyObject_GetAttrString(o, attr);
  if (!a) die(attr);
  long v = PyLong_AsLong(a);
  Py_DECREF(a);
  return v;
}

// oracle construction with mode flags
BlockHandle new_block(int trace, int xdrop) {
  Gil g;
  PyObject* kw = Py_BuildValue("{s:i,s:i}", "trace", trace, "x_drop", xdrop);
  PyObject* cls = PyObject_GetAttrString(mod(), "BlockOracle");
  if (!cls) die("BlockOracle");
  PyObject* empty = PyTuple_New(0);
  PyObject* r = PyObject_Call(cls, empty, kw);
  Py_DECREF(cls);
  Py_DECREF(empty);
  Py_DECREF(kw);
  if (!r) die("BlockOracle()");
  return (BlockHandle)r;
}

void align_aa(BlockHandle b, PaddedBytesHandle q, PaddedBytesHandle r,
              AAMatrixHandle m, Gaps gaps, SizeRange s, int32_t x_drop) {
  Gil g;
  PyObject* gapsmod = PyObject_GetAttrString(mod(), "Gaps");
  PyObject* gp = PyObject_CallFunction(gapsmod, "ii", (int)gaps.open,
                                       (int)gaps.extend);
  Py_DECREF(gapsmod);
  if (!gp) die("Gaps");
  PyObject* res = PyObject_CallMethod(
      (PyObject*)b, "align", "OOOO(nn)i", (PyObject*)q, (PyObject*)r,
      (PyObject*)m, gp, (Py_ssize_t)s.min, (Py_ssize_t)s.max, (int)x_drop);
  Py_DECREF(gp);
  if (!res) die("align");
  Py_DECREF(res);
}

AlignResult res_aa(BlockHandle b) {
  Gil g;
  PyObject* r = PyObject_CallMethod((PyObject*)b, "res", nullptr);
  if (!r) die("res");
  AlignResult out;
  out.score = (int32_t)getint(r, "score");
  out.query_idx = (size_t)getint(r, "query_idx");
  out.reference_idx = (size_t)getint(r, "reference_idx");
  Py_DECREF(r);
  return out;
}

void free_obj(void* h) {
  if (!h) return;
  Gil g;
  Py_DECREF((PyObject*)h);
}

}  // namespace

extern "C" {

int block_jax_init(void) {
  if (g_mod) return 0;
  if (!Py_IsInitialized()) {
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    // resolve the environment (venv site-packages, JAX plugins) of the
    // interpreter this library was built against; overridable at runtime
    const char* exe = getenv("BLOCK_ALIGNER_JAX_PYTHON");
#ifdef BA_JAX_PYTHON_EXECUTABLE
    if (!exe) exe = BA_JAX_PYTHON_EXECUTABLE;
#endif
    if (exe) {
      PyConfig_SetBytesString(&config, &config.program_name, exe);
      PyConfig_SetBytesString(&config, &config.executable, exe);
    }
    PyStatus st = Py_InitializeFromConfig(&config);
    PyConfig_Clear(&config);
    if (PyStatus_Exception(st)) return -1;
    // release the GIL acquired by initialization so Gil{} works everywhere
    PyEval_SaveThread();
  }
  Gil g;
  g_mod = PyImport_ImportModule("block_aligner_jax");
  if (!g_mod) {
    PyErr_Print();
    return -1;
  }
  return 0;
}

static void ensure_init() {
  if (!g_mod && block_jax_init() != 0) die("block_jax_init");
}

/* ---- matrices ---- */
AAMatrixHandle block_new_simple_aamatrix(int8_t match_score, int8_t mm) {
  ensure_init();
  Gil g;
  PyObject* cls = PyObject_GetAttrString(mod(), "AAMatrix");
  PyObject* r = call(cls, "new_simple", Py_BuildValue("(ii)", (int)match_score, (int)mm));
  Py_DECREF(cls);
  return (AAMatrixHandle)r;
}

AAMatrixHandle block_new_named_aamatrix(const char* name) {
  ensure_init();
  Gil g;
  PyObject* r = PyObject_GetAttrString(mod(), name);
  if (!r) die(name);
  return (AAMatrixHandle)r;
}

void block_set_aamatrix(AAMatrixHandle m, uint8_t a, uint8_t b, int8_t score) {
  Gil g;
  Py_XDECREF(PyObject_CallMethod((PyObject*)m, "set", "iii", (int)a, (int)b,
                                 (int)score));
}

void block_free_aamatrix(AAMatrixHandle m) { free_obj(m); }

/* ---- padded bytes ---- */
PaddedBytesHandle block_new_padded_aa(size_t len, size_t max_size) {
  ensure_init();
  Gil g;
  PyObject* cls = PyObject_GetAttrString(mod(), "PaddedBytes");
  PyObject* mat = PyObject_GetAttrString(mod(), "BLOSUM62");
  PyObject* r = call(cls, "new", Py_BuildValue("(nnO)", (Py_ssize_t)len,
                                               (Py_ssize_t)max_size, mat));
  Py_DECREF(cls);
  Py_DECREF(mat);
  return (PaddedBytesHandle)r;
}

void block_set_bytes_padded_aa(PaddedBytesHandle pb, const uint8_t* s,
                               size_t len, size_t max_size) {
  Gil g;
  PyObject* mat = PyObject_GetAttrString(mod(), "BLOSUM62");
  PyObject* r = PyObject_CallMethod((PyObject*)pb, "set_bytes", "y#nO",
                                    (const char*)s, (Py_ssize_t)len,
                                    (Py_ssize_t)max_size, mat);
  Py_DECREF(mat);
  if (!r) die("set_bytes");
  Py_DECREF(r);
}

void block_set_bytes_rev_padded_aa(PaddedBytesHandle pb, const uint8_t* s,
                                   size_t len, size_t max_size) {
  Gil g;
  PyObject* mat = PyObject_GetAttrString(mod(), "BLOSUM62");
  PyObject* r = PyObject_CallMethod((PyObject*)pb, "set_bytes_rev", "y#nO",
                                    (const char*)s, (Py_ssize_t)len,
                                    (Py_ssize_t)max_size, mat);
  Py_DECREF(mat);
  if (!r) die("set_bytes_rev");
  Py_DECREF(r);
}

void block_free_padded_aa(PaddedBytesHandle pb) { free_obj(pb); }

/* ---- aligners ---- */
BlockHandle block_new_aa(size_t, size_t, size_t) { ensure_init(); return new_block(0, 0); }
BlockHandle block_new_aa_trace(size_t, size_t, size_t) { ensure_init(); return new_block(1, 0); }
BlockHandle block_new_aa_xdrop(size_t, size_t, size_t) { ensure_init(); return new_block(0, 1); }
BlockHandle block_new_aa_trace_xdrop(size_t, size_t, size_t) { ensure_init(); return new_block(1, 1); }

void block_align_aa(BlockHandle b, PaddedBytesHandle q, PaddedBytesHandle r,
                    AAMatrixHandle m, Gaps gaps, SizeRange s, int32_t x) {
  align_aa(b, q, r, m, gaps, s, x);
}
void block_align_aa_trace(BlockHandle b, PaddedBytesHandle q, PaddedBytesHandle r,
                          AAMatrixHandle m, Gaps gaps, SizeRange s, int32_t x) {
  align_aa(b, q, r, m, gaps, s, x);
}
void block_align_aa_xdrop(BlockHandle b, PaddedBytesHandle q, PaddedBytesHandle r,
                          AAMatrixHandle m, Gaps gaps, SizeRange s, int32_t x) {
  align_aa(b, q, r, m, gaps, s, x);
}
void block_align_aa_trace_xdrop(BlockHandle b, PaddedBytesHandle q,
                                PaddedBytesHandle r, AAMatrixHandle m, Gaps gaps,
                                SizeRange s, int32_t x) {
  align_aa(b, q, r, m, gaps, s, x);
}

AlignResult block_res_aa(BlockHandle b) { return res_aa(b); }
AlignResult block_res_aa_trace(BlockHandle b) { return res_aa(b); }
AlignResult block_res_aa_xdrop(BlockHandle b) { return res_aa(b); }
AlignResult block_res_aa_trace_xdrop(BlockHandle b) { return res_aa(b); }

void block_free_aa(BlockHandle b) { free_obj(b); }
void block_free_aa_trace(BlockHandle b) { free_obj(b); }
void block_free_aa_xdrop(BlockHandle b) { free_obj(b); }
void block_free_aa_trace_xdrop(BlockHandle b) { free_obj(b); }

/* ---- profiles ---- */
AAProfileHandle block_new_aaprofile(size_t str_len, size_t block_size,
                                    int8_t gap_extend) {
  ensure_init();
  Gil g;
  PyObject* cls = PyObject_GetAttrString(mod(), "AAProfile");
  PyObject* r = PyObject_CallFunction(cls, "nni", (Py_ssize_t)str_len,
                                      (Py_ssize_t)block_size, (int)gap_extend);
  Py_DECREF(cls);
  if (!r) die("AAProfile");
  return (AAProfileHandle)r;
}

size_t block_len_aaprofile(AAProfileHandle p) {
  Gil g;
  PyObject* r = PyObject_CallMethod((PyObject*)p, "len", nullptr);
  size_t v = (size_t)PyLong_AsLong(r);
  Py_DECREF(r);
  return v;
}

void block_clear_aaprofile(AAProfileHandle p, size_t str_len, size_t block_size) {
  Gil g;
  Py_XDECREF(PyObject_CallMethod((PyObject*)p, "clear", "nn",
                                 (Py_ssize_t)str_len, (Py_ssize_t)block_size));
}

void block_set_aaprofile(AAProfileHandle p, size_t i, uint8_t b, int8_t score) {
  Gil g;
  Py_XDECREF(PyObject_CallMethod((PyObject*)p, "set", "nii", (Py_ssize_t)i,
                                 (int)b, (int)score));
}

#define GAP_SETTER(NAME, METHOD)                                       \
  void NAME(AAProfileHandle p, size_t i, int8_t gap) {                 \
    Gil g;                                                             \
    Py_XDECREF(PyObject_CallMethod((PyObject*)p, METHOD, "ni",         \
                                   (Py_ssize_t)i, (int)gap));          \
  }
GAP_SETTER(block_set_gap_open_C_aaprofile, "set_gap_open_C")
GAP_SETTER(block_set_gap_close_C_aaprofile, "set_gap_close_C")
GAP_SETTER(block_set_gap_open_R_aaprofile, "set_gap_open_R")
#undef GAP_SETTER

#define GAP_ALL_SETTER(NAME, METHOD)                                   \
  void NAME(AAProfileHandle p, int8_t gap) {                           \
    Gil g;                                                             \
    Py_XDECREF(PyObject_CallMethod((PyObject*)p, METHOD, "i", (int)gap)); \
  }
GAP_ALL_SETTER(block_set_all_gap_open_C_aaprofile, "set_all_gap_open_C")
GAP_ALL_SETTER(block_set_all_gap_close_C_aaprofile, "set_all_gap_close_C")
GAP_ALL_SETTER(block_set_all_gap_open_R_aaprofile, "set_all_gap_open_R")
#undef GAP_ALL_SETTER

static void set_all_profile(AAProfileHandle p, const uint8_t* order,
                            size_t order_len, const int8_t* scores,
                            size_t scores_len, size_t left_shift,
                            size_t right_shift, const char* method) {
  Gil g;
  PyObject* score_list = PyList_New((Py_ssize_t)scores_len);
  if (!score_list) die(method);
  for (size_t k = 0; k < scores_len; k++) {
    PyList_SET_ITEM(score_list, (Py_ssize_t)k, PyLong_FromLong(scores[k]));
  }
  PyObject* r = PyObject_CallMethod((PyObject*)p, method, "y#Onn",
                                    (const char*)order, (Py_ssize_t)order_len,
                                    score_list, (Py_ssize_t)left_shift,
                                    (Py_ssize_t)right_shift);
  Py_DECREF(score_list);
  if (!r) die(method);
  Py_DECREF(r);
}

void block_set_all_aaprofile(AAProfileHandle p, const uint8_t* order,
                             size_t order_len, const int8_t* scores,
                             size_t scores_len, size_t left_shift,
                             size_t right_shift) {
  set_all_profile(p, order, order_len, scores, scores_len, left_shift,
                  right_shift, "set_all");
}

void block_set_all_rev_aaprofile(AAProfileHandle p, const uint8_t* order,
                                 size_t order_len, const int8_t* scores,
                                 size_t scores_len, size_t left_shift,
                                 size_t right_shift) {
  set_all_profile(p, order, order_len, scores, scores_len, left_shift,
                  right_shift, "set_all_rev");
}

int8_t block_get_aaprofile(AAProfileHandle p, size_t i, uint8_t b) {
  Gil g;
  PyObject* r = PyObject_CallMethod((PyObject*)p, "get", "ni", (Py_ssize_t)i,
                                    (int)b);
  if (!r) die("profile.get");
  long v = PyLong_AsLong(r);
  Py_DECREF(r);
  return (int8_t)v;
}

int8_t block_get_gap_extend_aaprofile(AAProfileHandle p) {
  Gil g;
  PyObject* r = PyObject_CallMethod((PyObject*)p, "get_gap_extend", nullptr);
  if (!r) die("get_gap_extend");
  long v = PyLong_AsLong(r);
  Py_DECREF(r);
  return (int8_t)v;
}

void block_free_aaprofile(AAProfileHandle p) { free_obj(p); }

static void align_profile(BlockHandle b, PaddedBytesHandle q, AAProfileHandle p,
                          SizeRange s, int32_t x) {
  Gil g;
  PyObject* res = PyObject_CallMethod((PyObject*)b, "align_profile", "OO(nn)i",
                                      (PyObject*)q, (PyObject*)p,
                                      (Py_ssize_t)s.min, (Py_ssize_t)s.max,
                                      (int)x);
  if (!res) die("align_profile");
  Py_DECREF(res);
}

void block_align_profile_aa(BlockHandle b, PaddedBytesHandle q,
                            AAProfileHandle p, SizeRange s, int32_t x) {
  align_profile(b, q, p, s, x);
}
void block_align_profile_aa_trace(BlockHandle b, PaddedBytesHandle q,
                                  AAProfileHandle p, SizeRange s, int32_t x) {
  align_profile(b, q, p, s, x);
}
void block_align_profile_aa_xdrop(BlockHandle b, PaddedBytesHandle q,
                                  AAProfileHandle p, SizeRange s, int32_t x) {
  align_profile(b, q, p, s, x);
}
void block_align_profile_aa_trace_xdrop(BlockHandle b, PaddedBytesHandle q,
                                        AAProfileHandle p, SizeRange s,
                                        int32_t x) {
  align_profile(b, q, p, s, x);
}

/* ---- cigar ---- */
CigarHandle block_new_cigar(size_t qlen, size_t rlen) {
  ensure_init();
  Gil g;
  PyObject* cls = PyObject_GetAttrString(mod(), "Cigar");
  PyObject* r = PyObject_CallFunction(cls, "nn", (Py_ssize_t)qlen,
                                      (Py_ssize_t)rlen);
  Py_DECREF(cls);
  if (!r) die("Cigar");
  return (CigarHandle)r;
}

void block_cigar_aa_trace(BlockHandle b, size_t qi, size_t ri, CigarHandle c) {
  Gil g;
  PyObject* r = PyObject_CallMethod((PyObject*)b, "cigar", "nnO",
                                    (Py_ssize_t)qi, (Py_ssize_t)ri,
                                    (PyObject*)c);
  if (!r) die("cigar");
  Py_DECREF(r);
}

void block_cigar_aa_trace_xdrop(BlockHandle b, size_t qi, size_t ri,
                                CigarHandle c) {
  block_cigar_aa_trace(b, qi, ri, c);
}

static void cigar_eq(BlockHandle b, PaddedBytesHandle q, PaddedBytesHandle r,
                     size_t qi, size_t ri, CigarHandle c) {
  Gil g;
  PyObject* res = PyObject_CallMethod((PyObject*)b, "cigar_eq", "OOnnO",
                                      (PyObject*)q, (PyObject*)r,
                                      (Py_ssize_t)qi, (Py_ssize_t)ri,
                                      (PyObject*)c);
  if (!res) die("cigar_eq");
  Py_DECREF(res);
}

void block_cigar_eq_aa_trace(BlockHandle b, PaddedBytesHandle q,
                             PaddedBytesHandle r, size_t qi, size_t ri,
                             CigarHandle c) {
  cigar_eq(b, q, r, qi, ri, c);
}

void block_cigar_eq_aa_trace_xdrop(BlockHandle b, PaddedBytesHandle q,
                                   PaddedBytesHandle r, size_t qi, size_t ri,
                                   CigarHandle c) {
  cigar_eq(b, q, r, qi, ri, c);
}

size_t block_len_cigar(CigarHandle c) {
  Gil g;
  Py_ssize_t n = PyObject_Length((PyObject*)c);
  if (n < 0) die("len(cigar)");
  return (size_t)n;
}

OpLen block_get_cigar(CigarHandle c, size_t i) {
  Gil g;
  PyObject* ol = PyObject_CallMethod((PyObject*)c, "get", "n", (Py_ssize_t)i);
  if (!ol) die("cigar.get");
  long op = getint(ol, "op");
  long len = getint(ol, "len");
  Py_DECREF(ol);
  OpLen out;
  // internal ops match the reference Operation enum exactly
  // (Sentinel=0 M=1 Eq=2 X=3 I=4 D=5): pass through
  out.op = (uint32_t)op;
  out.len = (size_t)len;
  return out;
}

void block_free_cigar(CigarHandle c) { free_obj(c); }

/* ---- batched device dispatch ---- */
int block_align_batch_aa(const char* const* queries,
                         const char* const* references, size_t n,
                         AAMatrixHandle m, Gaps gaps, SizeRange s,
                         int32_t* scores_out) {
  ensure_init();
  Gil g;
  size_t max_len = 1;
  PyObject* pairs = PyList_New((Py_ssize_t)n);
  for (size_t k = 0; k < n; k++) {
    size_t ql = strlen(queries[k]), rl = strlen(references[k]);
    if (ql > max_len) max_len = ql;
    if (rl > max_len) max_len = rl;
    PyObject* t = Py_BuildValue("(y#y#)", queries[k], (Py_ssize_t)ql,
                                references[k], (Py_ssize_t)rl);
    PyList_SET_ITEM(pairs, (Py_ssize_t)k, t);
  }
  PyObject* cls = PyObject_GetAttrString(mod(), "BatchAligner");
  PyObject* gapsmod = PyObject_GetAttrString(mod(), "Gaps");
  PyObject* gp = PyObject_CallFunction(gapsmod, "ii", (int)gaps.open,
                                       (int)gaps.extend);
  Py_DECREF(gapsmod);
  PyObject* args = Py_BuildValue("(OO(nn))", (PyObject*)m, gp,
                                 (Py_ssize_t)s.min, (Py_ssize_t)s.max);
  PyObject* kw = Py_BuildValue("{s:n,s:n}", "batch", (Py_ssize_t)(n < 128 ? n : 128),
                               "seq_cap", (Py_ssize_t)max_len);
  PyObject* al = PyObject_Call(cls, args, kw);
  Py_DECREF(cls);
  Py_DECREF(gp);
  Py_DECREF(args);
  Py_DECREF(kw);
  if (!al) {
    PyErr_Print();
    Py_DECREF(pairs);
    return -1;
  }
  PyObject* res = PyObject_CallMethod(al, "align_all", "O", pairs);
  Py_DECREF(pairs);
  Py_DECREF(al);
  if (!res) {
    PyErr_Print();
    return -1;
  }
  for (size_t k = 0; k < n; k++) {
    PyObject* item = PyList_GetItem(res, (Py_ssize_t)k);
    scores_out[k] = (int32_t)getint(item, "score");
  }
  Py_DECREF(res);
  return 0;
}

}  // extern "C"
