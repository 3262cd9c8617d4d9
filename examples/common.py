"""Shared helpers for the example/benchmark harness programs.

Mirrors the reference harness utilities: fixed-seed random sequence
generation and simulate-seqs-style mutation (reference:
examples/accuracy.rs:17-34), plus dataset loaders that read the reference's
data files when present under ``data/`` (see data/README.md in the
reference) and fall back to simulated datasets with the same shape when the
files are absent (this environment has no network egress).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

DATA_DIR = Path(__file__).resolve().parent.parent / "data"

AA = b"ACDEFGHIKLMNPQRSTVWY"
DNA = b"ACGT"


def rand_seq(rng, alpha, n):
    return bytes(rng.choice(list(alpha), size=n).tolist())


def rand_mutate(rng, s, k, alpha, insert_only=False):
    """k point edits (sub/del/ins), reference rand_mutate semantics."""
    s = bytearray(s)
    for _ in range(k):
        op = 2 if insert_only else int(rng.integers(0, 3))
        pos = int(rng.integers(0, max(len(s), 1)))
        if op == 0 and len(s) > 0:
            s[pos % len(s)] = int(rng.choice(list(alpha)))
        elif op == 1 and len(s) > 1:
            del s[pos % len(s)]
        else:
            s.insert(pos, int(rng.choice(list(alpha))))
    return bytes(s)


def load_uc_pairs(name="uc30", per_bucket=1000, seed=1234, max_len=256):
    """Uniclust30-style homolog pairs bucketed by sequence identity.

    Reads ``data/{name}.m8`` tab-separated (qseq, tseq, ..., pident) pairs if
    present; otherwise simulates ``per_bucket`` protein pairs per identity
    decile 0.3..0.9 (7 buckets, the reference's layout; reference:
    examples/uc_accuracy.rs + data/uc30_pairwise_aln.sh).

    Returns list of (query, reference, seq_id_bucket).
    """
    path = DATA_DIR / f"{name}.m8"
    out = []
    if path.exists():
        # mmseqs convertalis --format-output query,target,fident,...,
        # qseq,tseq (data/uc30_pairwise_aln.sh): the reference parser takes
        # the LAST TWO whitespace fields as (qseq, tseq)
        # (examples/uc_accuracy.rs:21-25) and column 2 is fident
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 4:
                    continue
                q, t = parts[-2].upper().encode(), parts[-1].upper().encode()
                ident = float(parts[2])
                out.append((q, t, round(ident, 1)))
        return out
    rng = np.random.default_rng(seed)
    if "0.95" in name:
        # the reference's uc30_0.95 is uc30 re-clustered at 95% identity:
        # high-identity homolog pairs, no large structural indels
        for bucket in (0.9, 0.92, 0.95, 0.9, 0.92, 0.95, 0.95):
            for _ in range(per_bucket):
                n = int(rng.integers(50, max_len))
                q = rand_seq(rng, AA, n)
                k = max(1, int(n * (1.0 - bucket)))
                out.append((q, rand_mutate(rng, q, k, AA), bucket))
        return out
    for bucket in (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9):
        for _ in range(per_bucket):
            n = int(rng.integers(50, max_len))
            q = rand_seq(rng, AA, n)
            k = max(1, int(n * (1.0 - bucket)))
            r = rand_mutate(rng, q, k, AA)
            # low-identity homologs carry structural (block) indels that
            # push the optimal path off-diagonal -- the case block
            # adaptivity exists for
            if bucket < 0.8:
                for _ in range(int(rng.integers(1, 4))):
                    ln = int(rng.integers(8, max(9, n // 6)))
                    pos = int(rng.integers(0, max(len(r) - ln, 1)))
                    if rng.integers(0, 2) and len(r) > ln + 8:
                        r = r[:pos] + r[pos + ln :]
                    else:
                        r = r[:pos] + rand_seq(rng, AA, ln) + r[pos:]
            out.append((q, r, bucket))
    return out


def load_nanopore_pairs(name="seq_pairs.10kbps.5000", n_pairs=5000,
                        max_len=10000, seed=1234):
    """Long-read pairs: reads ``data/{name}.txt`` ('>'-prefixed alternating
    lines, BiWFA set format) when present, else simulates ONT-like pairs
    (~10% edit distance)."""
    path = DATA_DIR / f"{name}.txt"
    out = []
    if path.exists():
        # plain alternating lines; the reference reads chunks of 2 with
        # r = line 0, q = line 1, uppercased
        # (examples/nanopore_accuracy.rs:31-33)
        with open(path) as f:
            lines = [ln.strip().upper() for ln in f if ln.strip()]
        for k in range(0, len(lines) - 1, 2):
            out.append((lines[k + 1].encode(), lines[k].encode()))
        return out[:n_pairs]
    rng = np.random.default_rng(seed)
    for _ in range(n_pairs):
        n = int(rng.integers(max_len // 2, max_len))
        q = rand_seq(rng, DNA, n)
        r = rand_mutate(rng, q, n // 10, DNA)
        out.append((q, r))
    return out


def load_scop_profiles(n_pairs=1000, seed=1234, max_len=200,
                       name="pairs.pssm"):
    """SCOP-style (sequence, PSSM) pairs: reads ``data/scop/pairs.pssm``
    when present (reference: scripts/scop_seq_profile_pairs.py format),
    else simulates profiles from mutated consensus sequences."""
    from block_aligner_jax import AAProfile

    path = DATA_DIR / "scop" / name
    out = []
    if path.exists():
        # real format (scripts/scop_seq_profile_pairs.py output, parsed as
        # in examples/pssm_accuracy.rs:38-69): per record
        #   "#<seq>"         query sequence
        #   "#<cns>"         profile consensus (len(cns) = profile length)
        #   <header line>    PSSM column header (skipped)
        #   <len rows>       "pos aa s1 .. s20", scores in MAP order
        # with gap_open -10 / gap_close 0 per position.
        MAP = b"ACDEFGHIKLMNPQRSTVWY"
        with open(path) as f:
            lines = f.read().splitlines()
        k = 0
        while k + 1 < len(lines):
            seq = lines[k][1:].encode()
            plen = len(lines[k + 1]) - 1
            prof = AAProfile(plen, 2048, -1)
            for i in range(1, plen + 1):
                row = lines[k + 2 + i].split()[2:]
                for j, s in enumerate(row[:20]):
                    prof.set(i, MAP[j], int(s))
                prof.set_gap_open_C(i, -10)
                prof.set_gap_close_C(i, 0)
                prof.set_gap_open_R(i, -10)
            k += plen + 3
            out.append((seq, prof))
        return out[:n_pairs]
    rng = np.random.default_rng(seed)
    for _ in range(n_pairs):
        n = int(rng.integers(30, max_len))
        cons = rand_seq(rng, AA, n)
        prof = AAProfile(n, 2048, -1)
        # vectorized writes into the profile's position-major table (same
        # values the per-cell prof.set() loop would produce)
        base = rng.integers(-4, 3, size=(n, 26))
        base[np.arange(n), np.frombuffer(cons, np.uint8) - 65] = (
            rng.integers(4, 12, size=n)
        )
        prof.pos_scores[1 : n + 1, :26] = base
        prof.gap_open_C[: n + 1] = rng.integers(-13, -8, size=n + 1)
        prof.gap_close_C[: n + 1] = 0
        prof.gap_open_R[: n + 1] = rng.integers(-13, -8, size=n + 1)
        q = rand_mutate(rng, cons, n // 5, AA)
        out.append((q, prof))
    return out
