"""Build and drive the C FFI layer end-to-end (c/ directory)."""

import os
import shutil
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CDIR = ROOT / "c"


@pytest.mark.skipif(shutil.which("g++") is None, reason="no toolchain")
def test_c_example_builds_and_runs():
    r = subprocess.run(["make"], cwd=CDIR, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{ROOT}:{env.get('PYTHONPATH', '')}"
    # keep the C example on the CPU: the embedded runtime must work
    # anywhere, and the batch call then runs the engine route
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(["./example"], cwd=CDIR, capture_output=True,
                       text=True, timeout=560, env=env)
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert "score: 12" in out  # reference c/example.c expected score
    assert "7M1I" in out
    assert "2=1X4=1I" in out  # block_cigar_eq_aa_trace
    assert "batch scores: 77 25 -4" in out
    # block_set_all / get / get_gap_extend + profile x-drop:
    # MKVLATAAAA vs consensus MKVIATAAAA = 9 matches * 8 - 2
    assert "profile len 10, gap extend -1, P[1]['M']=8" in out
    assert "profile x-drop score: 70 idx: (10, 10)" in out
    # block_set_bytes_rev_padded_aa: s vs reverse(s) is symmetric
    assert "rev scores: 22 22" in out
