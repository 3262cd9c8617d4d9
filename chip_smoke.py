"""Smoke run of block_aligner_jax on NVIDIA GPUs.

Drives the public API through each main path at real sizes, from seeded
synthetic data, and checks every result: the CUDA fixed-block route against
the XLA engine route on the same card, and seeded samples against the scalar
oracle (core/oracle.py).  A failed check raises, so the script exits
non-zero and prints no result line; it refuses to run without a GPU.

    python chip_smoke.py               # phases (a)-(d) on one card
    python chip_smoke.py --four-cards  # (a) and (b) on a 4-card mesh,
                                       # every pair vs the 1-card result

Phases: (a) headline -- 16384 random 1k-protein pairs, BLOSUM62, gaps
-11/-1, block 32, ``align_all``; (b) uc30-shaped pairs at (32, 256) with
x-drop, then traced with CIGARs; (c) sequence-to-PSSM; (d) 10 kbp
nanopore-like pairs at (128, 1024).  The last stdout line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))

import numpy as np  # noqa: E402

from block_aligner_jax import (BLOSUM62, BatchAligner, BlockOracle,  # noqa: E402
                               Gaps, LongAdaptiveAligner, NucMatrix,
                               PaddedBytes, ProfileAligner, compile_cache)

SEED = 1234
GAPS = Gaps(open=-11, extend=-1)
NUC = NucMatrix.new_simple(2, -4)
NUC_GAPS = Gaps(open=-6, extend=-2)
X_DROP = 50
# sizes: the headline batch (pairs, length, edits), uc30 pairs per
# identity bucket, PSSM pairs, and long pairs with their maximum length
HEADLINE = (16384, 1000, 100)
UC_PER_BUCKET = 1000
N_PROFILES = 1000
LONG = (4, 10000)


def log(*args):
    print(*args, flush=True)


def timed(fn, *args):
    """(seconds, result) of a warm call; the first call compiles."""
    fn(*args)
    t0 = time.perf_counter()
    out = fn(*args)
    return time.perf_counter() - t0, out


def check_equal(what, got, want):
    bad = [k for k, (g, w) in enumerate(zip(got, want)) if g != w]
    assert len(got) == len(want) and not bad, (
        f"{what}: {len(bad)} of {len(want)} differ; first {bad[:5]}: "
        f"{[(got[k], want[k]) for k in bad[:3]]}")


def sample(n, k, seed):
    return np.random.default_rng(seed).choice(n, size=min(k, n), replace=False)


def oracle_check(what, pairs, got, matrix, gaps, size, x_drop=None,
                 cigars=None, n=64, seed=SEED):
    """Seeded sample of ``got`` (and ``cigars``) against the scalar
    oracle."""
    orc = BlockOracle(x_drop=x_drop is not None, trace=cigars is not None)
    idx = sample(len(pairs), n, seed)
    for k in idx:
        q, r = pairs[k]
        pq = PaddedBytes.from_bytes(q, size[1], matrix)
        pr = PaddedBytes.from_bytes(r, size[1], matrix)
        orc.align(pq, pr, matrix, gaps, size, x_drop or 0)
        w = orc.res()
        assert got[k] == w, f"{what}: pair {k} {got[k]} != oracle {w}"
        if cigars is not None:
            want = str(orc.cigar(w.query_idx, w.reference_idx))
            assert str(cigars[k]) == want, (
                f"{what}: pair {k} CIGAR {cigars[k]} != oracle {want}")
    return len(idx)


def headline_pairs():
    from bench import rand_protein_pairs

    return rand_protein_pairs(np.random.default_rng(SEED), *HEADLINE)


def phase_a(pairs, mesh=None):
    al = BatchAligner(BLOSUM62, GAPS, (32, 32), batch=len(pairs),
                      seq_cap=HEADLINE[1] + HEADLINE[2], mesh=mesh)
    assert al.route == "cuda", al.route
    dt, got = timed(al.align_all, pairs)
    return al.route, dt, got


def uc30_pairs():
    from common import load_uc_pairs

    return [(q, r) for q, r, _ in load_uc_pairs(
        "uc30", per_bucket=UC_PER_BUCKET, seed=SEED)]


def phase_b(pairs, mesh=None):
    """uc30 at (32, 256) with x-drop, all pairs; then traced with CIGARs
    over the first 2048 pairs."""
    cap = max(max(len(q), len(r)) for q, r in pairs) + 32
    al = BatchAligner(BLOSUM62, GAPS, (32, 256), batch=1024, seq_cap=cap,
                      x_drop=X_DROP, mesh=mesh)
    dt, got = timed(al.align_all, pairs)
    alt = BatchAligner(BLOSUM62, GAPS, (32, 256), batch=256, seq_cap=cap,
                       x_drop=X_DROP, trace=True, mesh=mesh)
    traced = pairs[:2048]
    dtt, (tres, cigars) = timed(alt.align_all_trace, traced)
    return al.route, dt, got, dtt, tres, cigars


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run phases (a) and (b) on a 4-card mesh and "
                         "compare every pair with the 1-card result")
    args = ap.parse_args()

    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (backend "
                 f"{jax.default_backend()!r})")
    log("compile cache:", compile_cache.enable())
    dev = jax.devices()[0]
    log(f"devices: {len(jax.devices())} x {dev.device_kind}")

    hp = headline_pairs()
    up = uc30_pairs()
    if args.four_cards:
        from block_aligner_jax.parallel.mesh import make_mesh

        assert len(jax.devices()) >= 4, "--four-cards needs 4 GPUs"
        mesh = make_mesh(4)
        r1, dt1, got1 = phase_a(hp)
        r4, dt4, got4 = phase_a(hp, mesh)
        check_equal("(a) 4 cards vs 1", got4, got1)
        log(f"(a) headline route={r4}: 1 card {dt1 / len(hp) * 1e6:.4f} "
            f"us/pair, 4 cards {dt4 / len(hp) * 1e6:.4f} us/pair; "
            f"{len(hp)} pairs equal")
        b1 = phase_b(up)
        b4 = phase_b(up, mesh)
        check_equal("(b) x-drop 4 cards vs 1", b4[2], b1[2])
        check_equal("(b) trace 4 cards vs 1", b4[4], b1[4])
        check_equal("(b) CIGARs 4 cards vs 1", [str(c) for c in b4[5]],
                    [str(c) for c in b1[5]])
        log(f"(b) uc30 (32,256) x-drop route={b4[0]}: 1 card "
            f"{b1[1] / len(up) * 1e6:.3f} us/pair, 4 cards "
            f"{b4[1] / len(up) * 1e6:.3f} us/pair; {len(up)} pairs and "
            f"{len(b4[5])} CIGARs equal")
    else:
        # (a) headline: CUDA route vs the engine route, every pair
        route, dt, got = phase_a(hp)
        eng = BatchAligner(BLOSUM62, GAPS, (32, 32), batch=len(hp),
                           seq_cap=HEADLINE[1] + HEADLINE[2],
                           use_lane_kernel=False)
        dte, want = timed(eng.align_all, hp)
        check_equal("(a) cuda vs engine", got, want)
        n = oracle_check("(a)", hp, got, BLOSUM62, GAPS, (32, 32))
        log(f"(a) headline {len(hp)} x {HEADLINE[1]} aa, block 32: "
            f"route={route} "
            f"{dt / len(hp) * 1e6:.4f} us/pair, route=engine "
            f"{dte / len(hp) * 1e6:.4f} us/pair; all pairs equal, "
            f"{n} oracle-equal")

        # (b) uc30 adaptive x-drop, then trace
        route, dt, got, dtt, tres, cigars = phase_b(up)
        n = oracle_check("(b) x-drop", up, got, BLOSUM62, GAPS, (32, 256),
                         X_DROP)
        m = oracle_check("(b) trace", up[: len(tres)], tres, BLOSUM62, GAPS,
                         (32, 256), X_DROP, cigars=cigars, n=32)
        log(f"(b) uc30 {len(up)} pairs (32,256) x-drop: route={route} "
            f"{dt / len(up) * 1e6:.3f} us/pair, {n} oracle-equal; traced "
            f"{len(tres)} pairs {dtt / len(tres) * 1e6:.3f} us/pair with "
            f"CIGARs, {m} oracle-equal")

        # (c) sequence-to-PSSM
        from common import load_scop_profiles

        pp = load_scop_profiles(n_pairs=N_PROFILES, seed=SEED)
        cap = max(max(len(q), p.str_len) for q, p in pp) + 32
        pa = ProfileAligner((32, 64), batch=256, seq_cap=cap)
        dt, got = timed(pa.align_all, pp)
        orc = BlockOracle()
        idx = sample(len(pp), 64, SEED)
        for k in idx:
            q, prof = pp[k]
            orc.align_profile(PaddedBytes.from_bytes(q, 64, prof), prof,
                              (32, 64), 0)
            assert got[k] == orc.res(), f"(c) pair {k} {got[k]} {orc.res()}"
        log(f"(c) {len(pp)} seq-to-PSSM pairs (32,64): route={pa.route} "
            f"{dt / len(pp) * 1e6:.3f} us/pair, {len(idx)} oracle-equal")

        # (d) long reads
        from common import load_nanopore_pairs

        lp = load_nanopore_pairs(n_pairs=LONG[0], max_len=LONG[1], seed=SEED)
        la = LongAdaptiveAligner(NUC, NUC_GAPS, (128, 1024), batch=LONG[0])
        dt, got = timed(la.align_batch, lp)
        n = oracle_check("(d)", lp, got, NUC, NUC_GAPS, (128, 1024), n=2)
        log(f"(d) {len(lp)} nanopore pairs <= {LONG[1]} bp (128,1024): "
            f"{dt / len(lp) * 1e3:.1f} ms/pair, {n} oracle-equal")

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
