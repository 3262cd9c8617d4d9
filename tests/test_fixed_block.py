"""The CUDA fixed-block kernel's source and its host-side wrapper, on the CPU.

The kernel's per-pair walk (native/fixed_block.cuh) is compiled here by g++
with an emulated lane group and checked against the scalar oracle at every
instantiated block size and mode; the pair-major packing, the code table
and the output decode are checked directly.  The kernel itself runs in
tests/test_fixed_block_gpu.py on the card.
"""

import numpy as np
import pytest

from block_aligner_jax import (BLOSUM62, BYTES1, AlignResult, BlockOracle,
                               Gaps, NucMatrix, PaddedBytes)
from block_aligner_jax.ops.fixed_block import (BLOCKS, FixedBlockConfig,
                                               code_table, decode,
                                               pack_fixed, run_host)

AA = b"ACDEFGHIKLMNPQRSTVWY"
DNA = b"ACGT"
NUC = NucMatrix.new_simple(2, -4)
MATRICES = {
    "aa": (BLOSUM62, Gaps(-11, -1), AA),
    "nuc": (NUC, Gaps(-6, -2), DNA),
    "byte": (BYTES1, Gaps(-2, -1), b"ACGTacgt"),
}


def mutate(rng, s, k, alpha):
    s = bytearray(s)
    for _ in range(k):
        op = int(rng.integers(0, 3))
        pos = int(rng.integers(0, max(len(s), 1)))
        if op == 0 and s:
            s[pos % len(s)] = int(rng.choice(list(alpha)))
        elif op == 1 and len(s) > 1:
            del s[pos % len(s)]
        else:
            s.insert(pos, int(rng.choice(list(alpha))))
    return bytes(s)


def host_vs_oracle(pairs, matrix, gaps, block, x_drop):
    cfg = FixedBlockConfig.for_matrix(matrix, gaps, block, x_drop)
    codes, meta = pack_fixed(pairs, matrix, block, len(pairs) + 3)
    got = decode(run_host(codes, meta, code_table(matrix), cfg), len(pairs))
    orc = BlockOracle(x_drop=x_drop is not None)
    for k, (q, r) in enumerate(pairs):
        orc.align(PaddedBytes.from_bytes(q, block, matrix),
                  PaddedBytes.from_bytes(r, block, matrix),
                  matrix, gaps, (block, block), x_drop or 0)
        assert got[k] == orc.res(), (k, len(q), len(r), got[k], orc.res())


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("mode", ["aa", "aa-xdrop", "nuc", "nuc-xdrop",
                                  "byte"])
def test_host_walk_vs_oracle(block, mode):
    """Random related pairs (edits and indels, some longer than the
    block, some shorter) through the kernel's walk: scores and end
    positions bit-match the oracle."""
    name, _, xd = mode.partition("-")
    matrix, gaps, alpha = MATRICES[name]
    x_drop = 30 if xd else None
    rng = np.random.default_rng(block * 7 + len(mode))
    pairs = []
    for _ in range(4):
        n = int(rng.integers(1, 260))
        q = bytes(rng.choice(list(alpha), size=n).tolist())
        pairs.append((q, mutate(rng, q, n // 6 + 1, alpha)))
    host_vs_oracle(pairs, matrix, gaps, block, x_drop)


@pytest.mark.parametrize("shape", [
    (0, 0), (0, 5), (5, 0), (31, 32), (32, 31), (33, 33), (1, 90)])
def test_host_walk_edge_shapes(shape):
    """Empty sides and lengths around the block edge, global and x-drop."""
    rng = np.random.default_rng(sum(shape))
    q = bytes(rng.choice(list(AA), size=shape[0]).tolist())
    r = bytes(rng.choice(list(AA), size=shape[1]).tolist())
    for x_drop in (None, 20):
        host_vs_oracle([(q, r), (r, q)], BLOSUM62, Gaps(-11, -1), 32, x_drop)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_code_table_scores_like_the_matrix(name):
    """T[code(a), code(b)] == matrix.get(a, b) for every pair of letters
    (byte mode scores by equality and leaves the table unused)."""
    matrix, _, _ = MATRICES[name]
    tab = code_table(matrix)
    assert tab.shape == (32, 32) and tab.dtype == np.int8
    if name == "byte":
        return
    letters = bytes(range(ord("A"), ord("Z") + 1))
    codes = matrix.col_index(matrix.convert(letters))
    for a, ca in zip(letters, codes):
        for b, cb in zip(letters, codes):
            assert tab[ca, cb] == matrix.get(a, b), (chr(a), chr(b))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_pack_fixed_layout(n_shards):
    """Pair-major layout: each sequence sits at its offset as
    [NULL] + codes + NULL pad, within its shard's row; padding pairs are
    empty; the row width is a power of two."""
    rng = np.random.default_rng(n_shards)
    pairs = [(bytes(rng.choice(list(AA), size=int(n)).tolist()),
              bytes(rng.choice(list(AA), size=int(m)).tolist()))
             for n, m in rng.integers(0, 300, size=(5, 2))]
    block, batch = 64, 8
    codes, meta = pack_fixed(pairs, BLOSUM62, block, batch, n_shards)
    assert codes.shape[0] == n_shards and meta.shape == (batch, 4)
    width = codes.shape[1]
    assert width & (width - 1) == 0
    null = BLOSUM62.convert(bytes([BLOSUM62.NULL]))[0]
    per = batch // n_shards
    for b in range(batch):
        q, r = pairs[b] if b < len(pairs) else (b"", b"")
        row = codes[b // per]
        for off, s, ln in ((meta[b, 0], q, meta[b, 2]), (meta[b, 1], r, meta[b, 3])):
            assert ln == len(s)
            assert row[off] == null
            if ln:
                assert bytes(row[off + 1 : off + 1 + ln]) == bytes(
                    BLOSUM62.convert(s))
            pad = row[off + 1 + ln : off + 1 + max(ln + 8, block)]
            assert (pad == null).all()


def test_pack_fixed_regions_do_not_overlap():
    """Every read the walk can make (index up to max(len + 7, block - 1))
    stays inside the sequence's own region."""
    rng = np.random.default_rng(5)
    lens = rng.integers(0, 200, size=(12, 2))
    pairs = [(b"A" * int(n), b"C" * int(m)) for n, m in lens]
    for block in (16, 512):
        codes, meta = pack_fixed(pairs, BLOSUM62, block, 12)
        spans = []
        for b in range(12):
            for side in (0, 1):
                lo = meta[b, side]
                hi = lo + max(meta[b, 2 + side] + 8, block)
                spans.append((lo, hi))
        spans.sort()
        assert all(a[1] < b[0] for a, b in zip(spans, spans[1:]))
        assert spans[-1][1] < codes.shape[1]


def test_decode_rows():
    out = np.array([[5, 1, 2], [-3, 0, 0], [9, 9, 9]], np.int32)
    assert decode(out, 2) == [AlignResult(5, 1, 2), AlignResult(-3, 0, 0)]


def test_fixed_block_config_attrs():
    """The FFI attributes carry the mode and scoring scalars as int32."""
    cfg = FixedBlockConfig.for_matrix(BLOSUM62, Gaps(-11, -1), 32, 50)
    a = cfg.attrs()
    assert a["block"] == 32 and a["x_drop_mode"] == 1 and a["x_drop"] == 50
    assert a["gap_open"] == -11 and a["gap_extend"] == -1
    assert a["byte_mode"] == 0
    assert all(v.dtype == np.int32 for v in a.values())
    b = FixedBlockConfig.for_matrix(BYTES1, Gaps(-2, -1), 16, None).attrs()
    assert b["byte_mode"] == 1 and b["match"] == 1 and b["mismatch"] == -1
    with pytest.raises(AssertionError):
        FixedBlockConfig(48, -11, -1)
