"""The CUDA fixed-block kernel on the card (skipped without a GPU).

Run on the card with ``python -m pytest tests -m gpu``.  The kernel must
bit-match its own walk compiled for the host (tests/test_fixed_block.py
checks that walk against the oracle) and the engine route.
"""

import numpy as np
import pytest

from block_aligner_jax import BLOSUM62, BYTES1, BatchAligner, Gaps
from block_aligner_jax.ops.fixed_block import (BLOCKS, FixedBlockConfig,
                                               build_fixed_block, code_table,
                                               pack_fixed, run_host)

pytestmark = pytest.mark.gpu

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)


def pairs_of(rng, n, hi):
    out = [(b"", b""), (b"AC", b"")]
    for _ in range(n):
        q = rng.choice(AA, int(rng.integers(1, hi)))
        r = q.copy()
        pos = rng.integers(0, len(q), size=len(q) // 8 + 1)
        r[pos] = rng.choice(AA, len(pos))
        r = np.delete(r, rng.integers(0, len(r), size=len(r) // 40))
        out.append((q.tobytes(), r.tobytes()))
    return out


@pytest.mark.parametrize("block", BLOCKS)
def test_kernel_matches_host_walk(gpu, block):
    rng = np.random.default_rng(block)
    pairs = pairs_of(rng, 200, 700)
    for matrix, gaps, x_drop in ((BLOSUM62, Gaps(-11, -1), None),
                                 (BLOSUM62, Gaps(-11, -1), 40),
                                 (BYTES1, Gaps(-2, -1), None)):
        cfg = FixedBlockConfig.for_matrix(matrix, gaps, block, x_drop)
        codes, meta = pack_fixed(pairs, matrix, block, len(pairs))
        tab = code_table(matrix)
        dev = np.asarray(build_fixed_block(cfg)(codes, meta, tab))
        np.testing.assert_array_equal(dev, run_host(codes, meta, tab, cfg))


def test_cuda_route_matches_engine(gpu):
    rng = np.random.default_rng(3)
    pairs = pairs_of(rng, 500, 1000)
    kw = dict(batch=256, seq_cap=1100)
    for x_drop in (None, 50):
        al = BatchAligner(BLOSUM62, Gaps(-11, -1), (32, 32), x_drop=x_drop,
                          **kw)
        eng = BatchAligner(BLOSUM62, Gaps(-11, -1), (32, 32), x_drop=x_drop,
                           use_lane_kernel=False, **kw)
        assert al.route == "cuda" and eng.route == "engine"
        assert al.align_all(pairs) == eng.align_all(pairs)


def test_cuda_route_on_mesh(gpu):
    import jax

    from block_aligner_jax.parallel.mesh import make_mesh

    mesh = make_mesh(len(jax.devices()))
    rng = np.random.default_rng(4)
    pairs = pairs_of(rng, 300, 800)
    al = BatchAligner(BLOSUM62, Gaps(-11, -1), (64, 64), batch=128, mesh=mesh)
    one = BatchAligner(BLOSUM62, Gaps(-11, -1), (64, 64), batch=128)
    assert al.route == "cuda"
    assert al.align_all(pairs) == one.align_all(pairs)
