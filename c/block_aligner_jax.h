/* C API for block_aligner_jax.
 *
 * Mirrors the reference C FFI surface (reference: src/ffi.rs:31-403,
 * c/block_aligner.h) so existing consumers (e.g. MMseqs2-style pipelines)
 * can switch over: opaque handles, padded byte strings, simple matrices,
 * PSSM profiles, and trace/x-drop aligner variants.
 *
 * Implementation: the library embeds the Python runtime and dispatches to
 * the block_aligner_jax framework.  Single-pair block_align_* calls run the
 * exact scalar engine on the host CPU; block_align_batch_aa dispatches a
 * whole batch to JAX's default device (the intended high-throughput entry
 * point -- single-pair device dispatch would waste the accelerator).
 *
 * Thread safety: calls serialize on the embedded interpreter's GIL.
 */

#ifndef BLOCK_ALIGNER_JAX_H
#define BLOCK_ALIGNER_JAX_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void* BlockHandle;
typedef void* PaddedBytesHandle;
typedef void* AAMatrixHandle;
typedef void* AAProfileHandle;
typedef void* CigarHandle;

typedef struct Gaps {
  int8_t open;  /* includes the first extend */
  int8_t extend;
} Gaps;

typedef struct SizeRange {
  size_t min;
  size_t max;
} SizeRange;

typedef struct AlignResult {
  int32_t score;
  size_t query_idx;
  size_t reference_idx;
} AlignResult;

/* cigar op encoding, identical to the reference Operation enum
 * (reference: src/cigar.rs:10-31) */
typedef struct OpLen {
  uint32_t op; /* 0 sentinel, 1 M, 2 =, 3 X, 4 I, 5 D */
  size_t len;
} OpLen;

/* ---- runtime ---- */
/* Optional: initialize the embedded runtime eagerly (otherwise lazy). */
int block_jax_init(void);

/* ---- matrices ---- */
AAMatrixHandle block_new_simple_aamatrix(int8_t match_score, int8_t mismatch_score);
/* named matrix: "BLOSUM62", "BLOSUM45", ..., "PAM250" */
AAMatrixHandle block_new_named_aamatrix(const char* name);
void block_set_aamatrix(AAMatrixHandle m, uint8_t a, uint8_t b, int8_t score);
void block_free_aamatrix(AAMatrixHandle m);

/* ---- padded byte strings ---- */
PaddedBytesHandle block_new_padded_aa(size_t len, size_t max_size);
void block_set_bytes_padded_aa(PaddedBytesHandle pb, const uint8_t* s,
                               size_t len, size_t max_size);
/* set reversed bytes (reference: src/ffi.rs block_set_bytes_rev_padded_aa) */
void block_set_bytes_rev_padded_aa(PaddedBytesHandle pb, const uint8_t* s,
                                   size_t len, size_t max_size);
void block_free_padded_aa(PaddedBytesHandle pb);

/* ---- aligner (seq-seq, amino acids) ---- */
BlockHandle block_new_aa(size_t query_len, size_t reference_len, size_t max_size);
BlockHandle block_new_aa_trace(size_t query_len, size_t reference_len, size_t max_size);
BlockHandle block_new_aa_xdrop(size_t query_len, size_t reference_len, size_t max_size);
BlockHandle block_new_aa_trace_xdrop(size_t query_len, size_t reference_len, size_t max_size);

void block_align_aa(BlockHandle b, PaddedBytesHandle q, PaddedBytesHandle r,
                    AAMatrixHandle m, Gaps gaps, SizeRange s, int32_t x_drop);
void block_align_aa_trace(BlockHandle b, PaddedBytesHandle q, PaddedBytesHandle r,
                          AAMatrixHandle m, Gaps gaps, SizeRange s, int32_t x_drop);
void block_align_aa_xdrop(BlockHandle b, PaddedBytesHandle q, PaddedBytesHandle r,
                          AAMatrixHandle m, Gaps gaps, SizeRange s, int32_t x_drop);
void block_align_aa_trace_xdrop(BlockHandle b, PaddedBytesHandle q,
                                PaddedBytesHandle r, AAMatrixHandle m, Gaps gaps,
                                SizeRange s, int32_t x_drop);

AlignResult block_res_aa(BlockHandle b);
AlignResult block_res_aa_trace(BlockHandle b);
AlignResult block_res_aa_xdrop(BlockHandle b);
AlignResult block_res_aa_trace_xdrop(BlockHandle b);

void block_free_aa(BlockHandle b);
void block_free_aa_trace(BlockHandle b);
void block_free_aa_xdrop(BlockHandle b);
void block_free_aa_trace_xdrop(BlockHandle b);

/* ---- profiles (PSSM) ---- */
AAProfileHandle block_new_aaprofile(size_t str_len, size_t block_size,
                                    int8_t gap_extend);
size_t block_len_aaprofile(AAProfileHandle p);
void block_clear_aaprofile(AAProfileHandle p, size_t str_len, size_t block_size);
void block_set_aaprofile(AAProfileHandle p, size_t i, uint8_t b, int8_t score);
void block_set_gap_open_C_aaprofile(AAProfileHandle p, size_t i, int8_t gap);
void block_set_gap_close_C_aaprofile(AAProfileHandle p, size_t i, int8_t gap);
void block_set_gap_open_R_aaprofile(AAProfileHandle p, size_t i, int8_t gap);
void block_set_all_gap_open_C_aaprofile(AAProfileHandle p, int8_t gap);
void block_set_all_gap_close_C_aaprofile(AAProfileHandle p, int8_t gap);
void block_set_all_gap_open_R_aaprofile(AAProfileHandle p, int8_t gap);
/* bulk position-major score fill with i8 shift-scaling; row r of
 * scores (str_len x order_len, row-major) sets position r+1's entries
 * for the amino acids in `order` (reference: src/ffi.rs:101-127) */
void block_set_all_aaprofile(AAProfileHandle p, const uint8_t* order,
                             size_t order_len, const int8_t* scores,
                             size_t scores_len, size_t left_shift,
                             size_t right_shift);
/* like block_set_all_aaprofile but rows fill positions str_len..1 */
void block_set_all_rev_aaprofile(AAProfileHandle p, const uint8_t* order,
                                 size_t order_len, const int8_t* scores,
                                 size_t scores_len, size_t left_shift,
                                 size_t right_shift);
int8_t block_get_aaprofile(AAProfileHandle p, size_t i, uint8_t b);
int8_t block_get_gap_extend_aaprofile(AAProfileHandle p);
void block_free_aaprofile(AAProfileHandle p);

void block_align_profile_aa(BlockHandle b, PaddedBytesHandle q,
                            AAProfileHandle p, SizeRange s, int32_t x_drop);
void block_align_profile_aa_trace(BlockHandle b, PaddedBytesHandle q,
                                  AAProfileHandle p, SizeRange s, int32_t x_drop);
void block_align_profile_aa_xdrop(BlockHandle b, PaddedBytesHandle q,
                                  AAProfileHandle p, SizeRange s, int32_t x_drop);
void block_align_profile_aa_trace_xdrop(BlockHandle b, PaddedBytesHandle q,
                                        AAProfileHandle p, SizeRange s,
                                        int32_t x_drop);

/* ---- cigar ---- */
CigarHandle block_new_cigar(size_t query_len, size_t reference_len);
void block_cigar_aa_trace(BlockHandle b, size_t query_idx, size_t reference_idx,
                          CigarHandle c);
void block_cigar_aa_trace_xdrop(BlockHandle b, size_t query_idx,
                                size_t reference_idx, CigarHandle c);
/* CIGARs with =/X resolved against the sequences (reference:
 * src/ffi.rs block_cigar_eq_aa_trace[_xdrop]) */
void block_cigar_eq_aa_trace(BlockHandle b, PaddedBytesHandle q,
                             PaddedBytesHandle r, size_t query_idx,
                             size_t reference_idx, CigarHandle c);
void block_cigar_eq_aa_trace_xdrop(BlockHandle b, PaddedBytesHandle q,
                                   PaddedBytesHandle r, size_t query_idx,
                                   size_t reference_idx, CigarHandle c);
size_t block_len_cigar(CigarHandle c);
OpLen block_get_cigar(CigarHandle c, size_t i);
void block_free_cigar(CigarHandle c);

/* ---- batched device dispatch ----
 * Aligns n pairs on JAX's default device (global, fixed or adaptive block
 * range).
 * queries/references: arrays of n NUL-terminated amino-acid strings.
 * scores_out: n int32 results. Returns 0 on success. */
int block_align_batch_aa(const char* const* queries,
                         const char* const* references, size_t n,
                         AAMatrixHandle m, Gaps gaps, SizeRange s,
                         int32_t* scores_out);

#ifdef __cplusplus
}
#endif

#endif /* BLOCK_ALIGNER_JAX_H */
