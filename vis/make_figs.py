"""Render the accuracy figure set.

Mirrors the reference's two executed notebooks (reference:
vis/block_aligner_accuracy_vis.ipynb, vis/block_aligner_bench_vis.ipynb
and their saved PDFs: uniclust30_{scores,accuracy,percent_error,
overall_accuracy,length_accuracy,seq_id_accuracy}, nanopore_10kbp_
{scores,largest_gap}, pssm_{scores,accuracy}, random_dna_accuracy),
rendered with matplotlib from:

* ``vis/data/*.csv`` -- per-pair records from
  ``examples/accuracy_perpair.py`` (run it first);
* ``vis/data/random_accuracy.txt`` -- captured stdout of
  ``examples/accuracy.py`` (optional).

Usage: python vis/make_figs.py
"""

import csv
import re
import sys
from collections import defaultdict
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
DATA = HERE / "data"
SIZES = ["32-32", "32-256", "256-256"]


def read_csv(name):
    path = DATA / name
    if not path.exists():
        return None
    with open(path) as f:
        return list(csv.DictReader(f))


def save(fig, name):
    fig.savefig(HERE / name, dpi=130, bbox_inches="tight")
    plt.close(fig)
    print("wrote", name)


def binned_scatter(ax, x, y, bins=50):
    if len(x) == 0:
        return
    h, xe, ye = np.histogram2d(x, y, bins=bins)
    h = np.ma.masked_where(h == 0, h)
    ax.pcolormesh(xe, ye, h.T, cmap="viridis",
                  norm=matplotlib.colors.LogNorm())


# ---------------------------------------------------------------- uc30
def uc_figs(rows):
    datasets = sorted({r["dataset"] for r in rows})

    # scores scatter: rows = dataset, cols = size
    fig, axes = plt.subplots(len(datasets), len(SIZES),
                             figsize=(11, 3.6 * len(datasets)),
                             squeeze=False)
    for i, ds in enumerate(datasets):
        for j, sz in enumerate(SIZES):
            sel = [r for r in rows if r["dataset"] == ds
                   and r["size"] == sz]
            t = np.array([int(r["true score"]) for r in sel])
            p = np.array([int(r["pred score"]) for r in sel])
            ax = axes[i][j]
            binned_scatter(ax, t, p)
            ax.set_title(f"{ds}  {sz}", fontsize=10)
            ax.set_xlabel("true score")
            ax.set_ylabel("pred score")
    fig.suptitle("Uniclust30-style: our score vs true score")
    fig.tight_layout()
    save(fig, "uniclust30_scores.png")

    # error rate + % error by identity bucket
    for metric, fname, title in (
        ("rate", "uniclust30_accuracy.png",
         "Uniclust30-style error rate by sequence identity"),
        ("err", "uniclust30_percent_error.png",
         "Uniclust30-style % score error (wrong pairs) by identity"),
    ):
        fig, axes = plt.subplots(len(datasets), len(SIZES),
                                 figsize=(11, 3.0 * len(datasets)),
                                 sharey="row", squeeze=False)
        for i, ds in enumerate(datasets):
            for j, sz in enumerate(SIZES):
                agg = defaultdict(lambda: [0, 0, 0.0])
                for r in rows:
                    if r["dataset"] != ds or r["size"] != sz:
                        continue
                    t, p = int(r["true score"]), int(r["pred score"])
                    a = agg[float(r["seq id"])]
                    a[0] += 1
                    if p != t:
                        a[1] += 1
                        a[2] += (t - p) / max(abs(t), 1)
                ks = sorted(agg)
                if metric == "rate":
                    vals = [agg[k][1] / agg[k][0] for k in ks]
                else:
                    vals = [agg[k][2] / max(agg[k][1], 1) for k in ks]
                ax = axes[i][j]
                ax.bar(range(len(ks)), vals, color=f"C{j}")
                ax.set_xticks(range(len(ks)),
                              [f"{k:.0%}" for k in ks], fontsize=8)
                ax.set_title(f"{ds}  {sz}", fontsize=10)
                ax.yaxis.set_major_formatter(
                    matplotlib.ticker.PercentFormatter(1.0))
        fig.suptitle(title)
        fig.tight_layout()
        save(fig, fname)

    # overall error rate
    fig, ax = plt.subplots(figsize=(6, 3.2))
    xs, vals, labels = [], [], []
    x = 0
    for ds in datasets:
        for sz in SIZES:
            sel = [r for r in rows if r["dataset"] == ds
                   and r["size"] == sz]
            if not sel:
                continue
            w = sum(1 for r in sel
                    if r["true score"] != r["pred score"])
            xs.append(x)
            vals.append(w / len(sel))
            labels.append(f"{ds}\n{sz}")
            x += 1
        x += 0.6
    bars = ax.bar(xs, vals,
                  color=[f"C{i % 3}" for i in range(len(xs))])
    for b, v in zip(bars, vals):
        ax.text(b.get_x() + b.get_width() / 2, v, f"{v:.1%}",
                ha="center", va="bottom", fontsize=7)
    ax.set_xticks(xs, labels, fontsize=7)
    ax.yaxis.set_major_formatter(matplotlib.ticker.PercentFormatter(1.0))
    ax.set_title("Overall Uniclust30-style error rate")
    save(fig, "uniclust30_overall_accuracy.png")

    # length vs % error and seq id vs % error (uc30_0.95, non-256 sizes)
    for col, fname, title, fmt in (
        ("len", "uniclust30_length_accuracy.png",
         "Sequence length vs % error (uc30_0.95)", False),
        ("id", "uniclust30_seq_id_accuracy.png",
         "Sequence identity vs % error (uc30_0.95)", True),
    ):
        fig, axes = plt.subplots(1, 2, figsize=(9, 3.6))
        for j, sz in enumerate(("32-32", "32-256")):
            sel = [r for r in rows if r["dataset"] == "uc30_0.95"
                   and r["size"] == sz]
            if col == "len":
                xv = np.array([max(int(r["query len"]),
                                   int(r["reference len"]))
                               for r in sel], float)
            else:
                xv = np.array([float(r["seq id"]) for r in sel])
            yv = np.array([1.0 - int(r["pred score"]) /
                           max(int(r["true score"]), 1) for r in sel])
            ax = axes[j]
            binned_scatter(ax, xv, yv, bins=30)
            ax.set_title(sz, fontsize=10)
            ax.set_xlabel("sequence length" if col == "len"
                          else "sequence identity")
            ax.set_ylabel("% error")
            ax.yaxis.set_major_formatter(
                matplotlib.ticker.PercentFormatter(1.0))
            if fmt:
                ax.xaxis.set_major_formatter(
                    matplotlib.ticker.PercentFormatter(1.0))
        fig.suptitle(title)
        fig.tight_layout()
        save(fig, fname)


# ------------------------------------------------------------ nanopore
def nanopore_figs(rows):
    t = np.array([int(r["true score"]) for r in rows])
    p = np.array([int(r["pred score"]) for r in rows])
    g = np.array([int(r["largest gap"]) for r in rows], float)
    err = (t - p) / np.maximum(np.abs(t), 1)
    sz = rows[0]["size"] if rows else "?"

    fig, ax = plt.subplots(figsize=(4.6, 4.2))
    binned_scatter(ax, t, p, bins=40)
    ax.set_xlabel("true score")
    ax.set_ylabel("pred score")
    ax.set_title(f"Nanopore-style global: our vs true score ({sz})")
    save(fig, "nanopore_10kbp_scores.png")

    fig, ax = plt.subplots(figsize=(4.6, 4.2))
    ax.scatter(g, err, s=14, alpha=0.7)
    ax.set_xlabel("largest structural gap (simulated)")
    ax.set_ylabel("% score error")
    ax.yaxis.set_major_formatter(matplotlib.ticker.PercentFormatter(1.0))
    ax.set_title(f"Nanopore-style: largest gap vs % error ({sz})")
    save(fig, "nanopore_10kbp_largest_gap.png")


# ---------------------------------------------------------------- pssm
def pssm_figs(rows):
    sizes = sorted({r["size"] for r in rows})
    fig, axes = plt.subplots(1, len(sizes), figsize=(4.6 * len(sizes), 4.2),
                             squeeze=False)
    for j, sz in enumerate(sizes):
        sel = [r for r in rows if r["size"] == sz]
        t = np.array([int(r["true score"]) for r in sel])
        p = np.array([int(r["pred score"]) for r in sel])
        ax = axes[0][j]
        binned_scatter(ax, t, p, bins=40)
        ax.set_xlabel("true score")
        ax.set_ylabel("pred score")
        ax.set_title(f"seq-PSSM {sz}")
    fig.suptitle("SCOP-style sequence-to-PSSM: our vs true score")
    fig.tight_layout()
    save(fig, "pssm_scores.png")

    fig, ax = plt.subplots(figsize=(4.2, 3.2))
    vals = []
    for sz in sizes:
        sel = [r for r in rows if r["size"] == sz]
        w = sum(1 for r in sel if r["true score"] != r["pred score"])
        vals.append(w / max(len(sel), 1))
    bars = ax.bar(range(len(sizes)), vals, color="C2")
    for b, v in zip(bars, vals):
        ax.text(b.get_x() + b.get_width() / 2, v, f"{v:.1%}",
                ha="center", va="bottom", fontsize=8)
    ax.set_xticks(range(len(sizes)), sizes)
    ax.yaxis.set_major_formatter(matplotlib.ticker.PercentFormatter(1.0))
    ax.set_title("seq-PSSM error rate by block size")
    save(fig, "pssm_accuracy.png")


# --------------------------------------------------- random DNA/protein
def random_accuracy_fig():
    """Parse captured accuracy.py output: 'len L, k K, size MN-MX: wrong
    W / N' lines under '# protein'/'# DNA' headers."""
    path = DATA / "random_accuracy.txt"
    if not path.exists():
        print("skip random_dna_accuracy (no data/random_accuracy.txt)")
        return
    section = ""
    recs = []
    for line in path.read_text().splitlines():
        if line.startswith("#"):
            section = "DNA" if "DNA" in line else "protein"
            continue
        m = re.match(r"len (\d+), k (\d+), size (\S+): wrong (\d+) / (\d+)",
                     line.strip())
        if m:
            ln, k, sz, w, n = (m.group(1), m.group(2), m.group(3),
                               int(m.group(4)), int(m.group(5)))
            recs.append((section, int(ln), int(k), sz, w / max(n, 1)))
    if not recs:
        return
    lens = sorted({r[1] for r in recs})
    secs = sorted({r[0] for r in recs})
    fig, axes = plt.subplots(len(secs), len(lens),
                             figsize=(3.4 * len(lens), 3.0 * len(secs)),
                             squeeze=False)
    for i, sec in enumerate(secs):
        for j, ln in enumerate(lens):
            sel = [r for r in recs if r[0] == sec and r[1] == ln]
            sizes = sorted({r[3] for r in sel})
            ks = sorted({r[2] for r in sel})
            ax = axes[i][j]
            w = 0.8 / max(len(sizes), 1)
            for si, sz in enumerate(sizes):
                ys = [next((r[4] for r in sel
                            if r[2] == k and r[3] == sz), 0) for k in ks]
                ax.bar(np.arange(len(ks)) + si * w, ys, width=w, label=sz)
            ax.set_xticks(np.arange(len(ks)) + 0.4,
                          [f"k={k}" for k in ks], fontsize=8)
            ax.yaxis.set_major_formatter(
                matplotlib.ticker.PercentFormatter(1.0))
            ax.set_title(f"{sec}, len {ln}", fontsize=9)
            if i == 0 and j == 0:
                ax.legend(fontsize=7, title="size")
    fig.suptitle("Random-sequence error rate by mutations / length / size")
    fig.tight_layout()
    save(fig, "random_dna_accuracy.png")


def main():
    uc = read_csv("uc_accuracy.csv")
    if uc:
        uc_figs(uc)
    nano = read_csv("nanopore_accuracy.csv")
    if nano:
        nanopore_figs(nano)
    pssm = read_csv("pssm_accuracy.csv")
    if pssm:
        pssm_figs(pssm)
    random_accuracy_fig()
    print("done", file=sys.stderr)


if __name__ == "__main__":
    main()
