"""Engine while-loop cost per iteration on the default JAX device."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    from block_aligner_jax import BLOSUM62, Gaps
    from block_aligner_jax.ops.engine import EngineConfig, build_engine, pack_pairs

    B = int(os.environ.get("PB", "512"))
    LEN = int(os.environ.get("PL", "1000"))
    MAXB = int(os.environ.get("PMAX", "256"))

    rng = np.random.default_rng(0)
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    pairs = []
    for _ in range(B):
        q = rng.choice(aa, size=LEN).tobytes()
        r = rng.choice(aa, size=LEN).tobytes()  # unrelated → max adaptivity stress
        pairs.append((q, r))

    cap = -(-(1 + LEN + MAXB + 16) // 128) * 128
    cfg = EngineConfig(batch=B, min_size=32, max_size=MAXB, seq_cap=cap, n_rows=27)
    fn = build_engine(cfg)
    t_pack0 = time.perf_counter()
    Sprof, CRow, qlen, rlen = pack_pairs(pairs, BLOSUM62, cfg)
    t_pack = time.perf_counter() - t_pack0
    gaps = Gaps(open=-11, extend=-1)

    args = [jax.device_put(x) for x in (Sprof, CRow, qlen, rlen)]
    out = fn(*args, gaps.open, gaps.extend, 0)
    out[0].block_until_ready()
    t0 = time.perf_counter()
    out = fn(*args, gaps.open, gaps.extend, 0)
    out[0].block_until_ready()
    t1 = time.perf_counter()
    iters = int(out[3])
    total = t1 - t0
    print(f"pack: {t_pack*1e3:.1f} ms")
    print(f"iters: {iters}, total: {total*1e3:.1f} ms, per-iter: {total/iters*1e6:.1f} us")
    print(f"us/pair: {total/B*1e6:.1f}")
    cells = iters * B * MAXB
    print(f"lockstep cell rate: {cells/total/1e9:.2f} Gcells/s (upper bound incl. masked)")


if __name__ == "__main__":
    main()
