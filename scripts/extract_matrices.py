"""Extract standard NCBI substitution-matrix data into block_aligner_jax/data/matrices.npz.

The numeric values are the standard NCBI BLOSUM/PAM substitution matrices
(public scientific data, originally from ftp.ncbi.nih.gov/blast/matrices/),
stored by the reference implementation as flat i8 arrays
(reference: matrices/* generated by scripts/create_matrix_aa.py).

Layout matches the reference lookup convention (reference: src/scores.rs:40-135):
AA matrices are (27, 32) int8 with rows/cols indexed by `char - 'A'`
(index 26 = NULL padding, score -128 everywhere).
"""
import re
import sys
from pathlib import Path

import numpy as np

REF = Path("/root/reference/matrices")
OUT = Path(__file__).resolve().parent.parent / "block_aligner_jax" / "data" / "matrices.npz"

AA_NAMES = [
    "BLOSUM45", "BLOSUM50", "BLOSUM62", "BLOSUM80", "BLOSUM90",
    "PAM100", "PAM120", "PAM160", "PAM200", "PAM250",
]


def parse_flat(path: Path) -> np.ndarray:
    text = path.read_text()
    nums = [int(x) for x in re.findall(r"-?\d+", text)]
    return np.array(nums, dtype=np.int32)


def main() -> None:
    out = {}
    for name in AA_NAMES:
        flat = parse_flat(REF / name)
        assert flat.size == 27 * 32, (name, flat.size)
        out[name] = flat.astype(np.int8).reshape(27, 32)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} with {list(out)}", file=sys.stderr)


if __name__ == "__main__":
    main()
