/* C consumer example (reference: c/example.c).
 *
 * Build: make && ./example (see Makefile)
 */

#include <stdio.h>
#include <string.h>

#include "block_aligner_jax.h"

void example1(void) {
  /* global seq-seq alignment */
  const char* a_str = "AAAAAAAA";
  const char* b_str = "AARAAAA";
  size_t a_len = strlen(a_str);
  size_t b_len = strlen(b_str);
  SizeRange range = {.min = 32, .max = 32};
  Gaps gaps = {.open = -11, .extend = -1};

  PaddedBytesHandle a = block_new_padded_aa(a_len, range.max);
  PaddedBytesHandle b = block_new_padded_aa(b_len, range.max);
  block_set_bytes_padded_aa(a, (const uint8_t*)a_str, a_len, range.max);
  block_set_bytes_padded_aa(b, (const uint8_t*)b_str, b_len, range.max);
  AAMatrixHandle blosum62 = block_new_named_aamatrix("BLOSUM62");

  BlockHandle block = block_new_aa(a_len, b_len, range.max);
  block_align_aa(block, a, b, blosum62, gaps, range, 0);
  AlignResult res = block_res_aa(block);

  printf("a: %s\nb: %s\nscore: %d\nidx: (%zu, %zu)\n", a_str, b_str,
         res.score, res.query_idx, res.reference_idx);

  block_free_aa(block);
  block_free_padded_aa(a);
  block_free_padded_aa(b);
  block_free_aamatrix(blosum62);
}

void example2(void) {
  /* global seq-seq alignment with traceback */
  const char* a_str = "AAAAAAAA";
  const char* b_str = "AARAAAA";
  size_t a_len = strlen(a_str);
  size_t b_len = strlen(b_str);
  SizeRange range = {.min = 32, .max = 32};
  Gaps gaps = {.open = -11, .extend = -1};

  PaddedBytesHandle a = block_new_padded_aa(a_len, range.max);
  PaddedBytesHandle b = block_new_padded_aa(b_len, range.max);
  block_set_bytes_padded_aa(a, (const uint8_t*)a_str, a_len, range.max);
  block_set_bytes_padded_aa(b, (const uint8_t*)b_str, b_len, range.max);
  AAMatrixHandle blosum62 = block_new_named_aamatrix("BLOSUM62");

  BlockHandle block = block_new_aa_trace(a_len, b_len, range.max);
  block_align_aa_trace(block, a, b, blosum62, gaps, range, 0);
  AlignResult res = block_res_aa_trace(block);

  printf("a: %s\nb: %s\nscore: %d\nidx: (%zu, %zu)\n", a_str, b_str,
         res.score, res.query_idx, res.reference_idx);

  CigarHandle cigar = block_new_cigar(res.query_idx, res.reference_idx);
  block_cigar_aa_trace(block, res.query_idx, res.reference_idx, cigar);
  size_t cigar_len = block_len_cigar(cigar);
  char ops_char[] = {' ', 'M', '=', 'X', 'I', 'D'};
  for (size_t i = 0; i < cigar_len; i++) {
    OpLen o = block_get_cigar(cigar, i);
    printf("%zu%c", o.len, ops_char[o.op]);
  }
  printf("\n");

  /* =/X-resolved CIGAR (reference: block_cigar_eq_aa_trace) */
  block_cigar_eq_aa_trace(block, a, b, res.query_idx, res.reference_idx,
                          cigar);
  cigar_len = block_len_cigar(cigar);
  for (size_t i = 0; i < cigar_len; i++) {
    OpLen o = block_get_cigar(cigar, i);
    printf("%zu%c", o.len, ops_char[o.op]);
  }
  printf("\n");

  block_free_cigar(cigar);
  block_free_aa_trace(block);
  block_free_padded_aa(a);
  block_free_padded_aa(b);
  block_free_aamatrix(blosum62);
}

void example3(void) {
  /* batched device dispatch */
  const char* qs[3] = {"CAGGATTAGCGGATCACG", "MKVLAT", "AAAA"};
  const char* rs[3] = {"CTGGAGTCTTTTAGCGGATCACGC", "MKVIAT", "RRRR"};
  int32_t scores[3];
  Gaps gaps = {.open = -11, .extend = -1};
  SizeRange range = {.min = 32, .max = 32};
  AAMatrixHandle blosum62 = block_new_named_aamatrix("BLOSUM62");
  if (block_align_batch_aa(qs, rs, 3, blosum62, gaps, range, scores) == 0) {
    printf("batch scores: %d %d %d\n", scores[0], scores[1], scores[2]);
  }
  block_free_aamatrix(blosum62);
}

void example4(void) {
  /* sequence-to-profile alignment with bulk set_all + x-drop
   * (reference: c/example.c profile usage + src/ffi.rs:101-127) */
  const char* q_str = "MKVLATAAAA";
  size_t q_len = strlen(q_str);
  size_t p_len = 10;
  SizeRange range = {.min = 32, .max = 32};

  AAProfileHandle prof = block_new_aaprofile(p_len, range.max, -1);
  /* position-major rows: favor the consensus "MKVIATAAAA" */
  const char* cons = "MKVIATAAAA";
  const uint8_t order[] = "ACDEFGHIKLMNPQRSTVWY";
  int8_t scores[10 * 20];
  for (size_t i = 0; i < p_len; i++) {
    for (size_t k = 0; k < 20; k++) {
      scores[i * 20 + k] = (order[k] == (uint8_t)cons[i]) ? 8 : -2;
    }
  }
  block_set_all_aaprofile(prof, order, 20, scores, sizeof(scores), 0, 0);
  block_set_all_gap_open_C_aaprofile(prof, -11);
  block_set_all_gap_close_C_aaprofile(prof, 0);
  block_set_all_gap_open_R_aaprofile(prof, -11);

  printf("profile len %zu, gap extend %d, P[1]['M']=%d\n",
         block_len_aaprofile(prof), (int)block_get_gap_extend_aaprofile(prof),
         (int)block_get_aaprofile(prof, 1, 'M'));

  PaddedBytesHandle q = block_new_padded_aa(q_len, range.max);
  block_set_bytes_padded_aa(q, (const uint8_t*)q_str, q_len, range.max);
  BlockHandle block = block_new_aa_xdrop(q_len, p_len, range.max);
  block_align_profile_aa_xdrop(block, q, prof, range, 50);
  AlignResult res = block_res_aa_xdrop(block);
  printf("profile x-drop score: %d idx: (%zu, %zu)\n", res.score,
         res.query_idx, res.reference_idx);

  block_free_aa_xdrop(block);
  block_free_padded_aa(q);
  block_free_aaprofile(prof);
}

void example5(void) {
  /* reversed sequences (free end gaps workflows use these; reference:
   * block_set_bytes_rev_padded_aa) */
  const char* a_str = "RAAAAAAA";
  size_t a_len = strlen(a_str);
  SizeRange range = {.min = 32, .max = 32};
  Gaps gaps = {.open = -11, .extend = -1};

  PaddedBytesHandle a = block_new_padded_aa(a_len, range.max);
  PaddedBytesHandle ar = block_new_padded_aa(a_len, range.max);
  block_set_bytes_padded_aa(a, (const uint8_t*)a_str, a_len, range.max);
  block_set_bytes_rev_padded_aa(ar, (const uint8_t*)a_str, a_len, range.max);
  AAMatrixHandle blosum62 = block_new_named_aamatrix("BLOSUM62");
  /* aligning s against reverse(s) is symmetric: same score both ways */
  BlockHandle block = block_new_aa(a_len, a_len, range.max);
  block_align_aa(block, a, ar, blosum62, gaps, range, 0);
  AlignResult r1 = block_res_aa(block);
  block_align_aa(block, ar, a, blosum62, gaps, range, 0);
  AlignResult r2 = block_res_aa(block);
  printf("rev scores: %d %d\n", r1.score, r2.score);

  block_free_aa(block);
  block_free_padded_aa(a);
  block_free_padded_aa(ar);
  block_free_aamatrix(blosum62);
}

int main(void) {
  if (block_jax_init() != 0) {
    fprintf(stderr, "init failed\n");
    return 1;
  }
  example1();
  example2();
  example3();
  example4();
  example5();
  return 0;
}
