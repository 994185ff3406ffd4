"""Synthetic pangenome GFA generator for chromosome-scale testing.

Produces a valid GFA v1 whose structure mimics a real pangenome after
construction: ``--paths`` haplotype paths walk the node space roughly
monotonically with local jitter, occasional reversals, and private
indel-like skips; every adjacent step pair is backed by an L line.
Used by the chromosome-scale end-to-end run (scripts/e2e_chromosome.py)
and the CI-sized regression test (tests/test_e2e_scale.py).

Usage: python -m gfasort_tpu_torch.tools.make_synthetic_gfa \
           --nodes 1000000 --paths 16 --steps 250000 -o big.gfa
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def synthetic_gfa_lines(
    n_nodes: int,
    n_paths: int,
    steps_per_path: int,
    seed: int = 0,
    max_node_len: int = 16,
    rev_frac: float = 0.05,
):
    """Yield GFA lines (without trailing newlines)."""
    rng = np.random.default_rng(seed)
    node_len = rng.integers(1, max_node_len + 1, size=n_nodes)

    yield "H\tVN:Z:1.0"

    # S lines: id 1..N, sequence = repeats of ACGT cycle per node
    # (content is irrelevant to sorting; lengths drive bp distances)
    base = np.frombuffer(b"ACGT", dtype=np.uint8)
    for i in range(n_nodes):
        ln = int(node_len[i])
        seq = base[(np.arange(ln) + i) % 4].tobytes().decode()
        yield f"S\t{i + 1}\t{seq}"

    # paths: noisy monotone walks (same structure as the bench
    # workload, bench_util.synthetic_path_index)
    paths = []
    for p in range(n_paths):
        ids = np.sort(rng.integers(0, n_nodes, size=steps_per_path))
        jitter = rng.integers(-50, 51, size=steps_per_path)
        ids = np.clip(ids + jitter, 0, n_nodes - 1) + 1
        rev = rng.random(steps_per_path) < rev_frac
        paths.append((ids, rev))

    # L lines from path adjacencies, deduplicated on the canonical
    # (smaller-handle-first) form — vectorized: handle = id*2 + rev
    fh = np.concatenate([(ids[:-1] * 2 + rev[:-1]) for ids, rev in paths])
    th = np.concatenate([(ids[1:] * 2 + rev[1:]) for ids, rev in paths])
    cf, ct = th ^ 1, fh ^ 1  # complement form
    use_c = (cf < fh) | ((cf == fh) & (ct < th))
    canon = np.stack([np.where(use_c, cf, fh), np.where(use_c, ct, th)], 1)
    canon = np.unique(canon, axis=0)
    for a_h, b_h in canon.tolist():
        yield (
            f"L\t{a_h >> 1}\t{'-' if a_h & 1 else '+'}"
            f"\t{b_h >> 1}\t{'-' if b_h & 1 else '+'}\t0M"
        )

    for p, (ids, rev) in enumerate(paths):
        steps = ",".join(
            f"{i}{'-' if r else '+'}" for i, r in zip(ids.tolist(), rev.tolist())
        )
        yield f"P\tpath{p}\t{steps}\t*"


def write_synthetic_gfa(path: str, **kw) -> None:
    with open(path, "w") as f:
        for line in synthetic_gfa_lines(**kw):
            f.write(line)
            f.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--paths", type=int, default=16)
    ap.add_argument("--steps", type=int, default=250_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-o", "--output", required=True)
    args = ap.parse_args(argv)
    write_synthetic_gfa(
        args.output, n_nodes=args.nodes, n_paths=args.paths,
        steps_per_path=args.steps, seed=args.seed,
    )
    print(f"wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
