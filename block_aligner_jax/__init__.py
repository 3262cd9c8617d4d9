"""block_aligner_jax: a batched adaptive block aligner in JAX.

A re-design with the capabilities of the block-aligner reference library
(global and X-drop affine-gap pairwise alignment of sequences and PSSM
profiles via an adaptive block DP algorithm), batched for one GPU or a mesh
of them: a CUDA kernel for fixed blocks and an XLA engine for every mode.
"""

from .core.cigar import Cigar, Operation, OpLen
from .core.oracle import AlignResult, BlockOracle, Rectangle
from .core.scores import (
    AAMatrix,
    AAProfile,
    BLOSUM45,
    BLOSUM50,
    BLOSUM62,
    BLOSUM80,
    BLOSUM90,
    BYTES1,
    ByteMatrix,
    Gaps,
    NW1,
    NucMatrix,
    PAM100,
    PAM120,
    PAM160,
    PAM200,
    PAM250,
    percent_len,
)
from .core.seqs import PaddedBytes
from .api import (BatchAligner, LongAdaptiveAligner, LongBatchAligner,
                  ProfileAligner, align_exp_all, align_profile_exp_all)

__version__ = "0.1.0"

__all__ = [
    "AlignResult",
    "BatchAligner",
    "LongBatchAligner",
    "LongAdaptiveAligner",
    "ProfileAligner",
    "align_exp_all",
    "align_profile_exp_all",
    "BlockOracle",
    "Cigar",
    "Operation",
    "OpLen",
    "Rectangle",
    "PaddedBytes",
    "AAMatrix",
    "NucMatrix",
    "ByteMatrix",
    "AAProfile",
    "Gaps",
    "NW1",
    "BYTES1",
    "BLOSUM45",
    "BLOSUM50",
    "BLOSUM62",
    "BLOSUM80",
    "BLOSUM90",
    "PAM100",
    "PAM120",
    "PAM160",
    "PAM200",
    "PAM250",
    "percent_len",
]
