"""Entry points of the port (counterpart of ``__graft_entry__.py``).

* :func:`entry` — one batched SGD round on the toy graph (sample B
  Zipfian term pairs over the path index, compute distance-residual
  deltas, scatter-mean them into the position vector), as a function
  and its example arguments.
* :func:`dryrun_multichip` — builds a mesh of ``n_devices`` shards and
  runs the three multi-device engines (sharded batched rounds, sharded
  1D sweep, sharded 2D layout) on tiny shapes; every output must be
  finite.

Both run on the card unless the caller asks for the CPU (``device=``).

    python -m gfasort_tpu_torch.entry [dryrun N] [--device cuda|cpu]
"""

from __future__ import annotations

import sys
from dataclasses import replace

import numpy as np


def _toy_graph(n_nodes=64, n_paths=4):
    """Small synthetic pangenome-like graph (no file dependencies); the
    same graph as the JAX package's from the same numpy seed."""
    from . import handle as H
    from .graph import BidirectedGraph

    rng = np.random.default_rng(0)
    g = BidirectedGraph()
    for i in range(1, n_nodes + 1):
        g.add_node(i, bytes(rng.choice(list(b"ACGT"), size=rng.integers(1, 8))))
    for i in range(1, n_nodes):
        g.add_edge(H.forward(i), H.forward(i + 1))
    for p in range(n_paths):
        ids = sorted(rng.choice(np.arange(1, n_nodes + 1), size=16, replace=False).tolist())
        g.build_path(f"p{p}", [(int(i), bool(rng.integers(0, 2))) for i in ids])
    return g


def entry(device="cuda"):
    """Returns (fn, example_args): ``fn(x, key, eta)`` is one batched SGD
    round of B = 1024 terms at f32 and ``pow_mode="fast"``; ``x`` holds
    the node positions [N] on ``device``, ``key`` the u32 [2] key data
    (``ops.keys.key_data``), ``eta`` an f32 scalar tensor.  The sampler
    is the batched engine's (its Bernoulli coins are f64 draws, as JAX
    draws them under ``jax_enable_x64``), and each node's terms are
    added in the order of the JAX scatter-add (first nodes, then second
    ones, each in draw order, from +0), so the round is deterministic
    on every device."""
    import torch

    from .device import resolve_device
    from .index import PathIndex
    from .ops.fastpow import zeta_table
    from .ops.keys import key_data, split
    from .ops.sgd import (DeviceIndex, _fold_tables, _make_sampler,
                          _row_sums, effective_batch)
    from .params import YgsParams

    dev = resolve_device(device)
    g = _toy_graph()
    pidx = PathIndex.from_graph(g)
    params = replace(
        YgsParams.from_graph(g).path_sgd,
        dtype="float32", pow_mode="fast", batch=1024,
    )
    di = DeviceIndex.from_path_index(pidx, np.float32, dev)
    zetas = zeta_table(
        params.space, params.space_max, params.space_quantization_step,
        params.theta,
    )
    B = effective_batch(params)
    sample_pairs = _make_sampler(di, params, zetas, np.float32, B)
    S, N = di.total_steps, di.num_nodes

    def sgd_round(x, key, eta):
        """One forward step of the flagship model: B term updates."""
        keys = torch.from_numpy(split(key, 5).astype(np.int64)[None]).to(dev)
        sa, sb, valid = (t[0] for t in sample_pairs(keys, False, 0, S))
        term_dist = torch.abs(di.step_pos[sa] - di.step_pos[sb])
        valid = valid & (term_dist != 0)
        safe = torch.where(valid, term_dist, 1.0)
        mu = torch.clamp_max(eta / safe, 1.0)
        i = di.step_node[sa]
        j = di.step_node[sb]
        dx = x[i] - x[j]
        dx = torch.where(dx == 0, 1e-9, dx)
        mag = torch.abs(dx)
        delta = mu * (mag - safe) / 2.0
        r_x = torch.where(valid, (delta / mag) * dx, 0.0)
        table, tgt, cnt = _fold_tables(torch.cat([i, j])[None],
                                       torch.cat([valid, valid])[None], N)
        dsum = _row_sums(torch.cat([-r_x, r_x, r_x.new_zeros(1)])[table[0]])
        xe = torch.cat([x, x.new_zeros(1)])
        xe[tgt[0]] = xe[tgt[0]] + dsum / cnt[0]
        return xe[:N]

    x0 = torch.from_numpy(pidx.initial_positions().astype(np.float32)).to(dev)
    eta = torch.tensor(10.0, dtype=torch.float32, device=dev)
    return sgd_round, (x0, key_data(9399220), eta)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the three multi-device engines over a mesh of ``n_devices``
    shards of ``device`` (``parallel.default_mesh``) on tiny shapes;
    every output must be finite.  Returns a summary."""
    from .bench_util import synthetic_path_index
    from .ops.exact import layout_initial_coords
    from .ops.keys import key_data
    from .params import LayoutSGDParams, PathSGDParams, YgsParams
    from .parallel import default_mesh, path_linear_sgd_sharded
    from .parallel.sweep_nd_shard import build_sharded_sweep_nd
    from .parallel.sweep_shard import build_sharded_sweep

    mesh = default_mesh(n_devices, device)
    g = _toy_graph(n_nodes=32, n_paths=max(4, n_devices))
    params = replace(
        YgsParams.from_graph(g).path_sgd,
        dtype="float32", pow_mode="fast",
        iter_max=2, batch=64,
    )

    # 1. sharded batched engine (rounds per shard + all-reduced deltas)
    x = path_linear_sgd_sharded(g, params, mesh)
    _check(x is not None and np.isfinite(x).all(),
           "sharded batched SGD produced non-finite positions")

    # The sweep engines run on a workload with pangenome band locality
    # (monotone path walks, one path per shard), as the JAX dry run.
    pidx = synthetic_path_index(
        n_nodes=4096, n_paths=n_devices, steps_per_path=4096, seed=3
    )
    sp = replace(
        PathSGDParams().derive_from_graph(pidx),
        dtype="float32", pow_mode="fast", iter_max=2,
    )

    # 2. sharded sweep engine (offset sweeps + all-reduced consensus).
    # The JAX dry run asserts its grid consensus, an MXU workaround the
    # port drops: the port's sharded engines run the gather consensus
    # only, and their info (held equal to the JAX engines') says so.
    run, arrays, make_state, info = build_sharded_sweep(pidx, sp, mesh)
    _check(info["grid_consensus"] is False,
           "the sharded sweep reports a grid consensus")
    xs0, xn0 = make_state()
    xs = run(xs0, xn0, key_data(sp.seed), *arrays).cpu().numpy()
    _check(np.isfinite(xs).all(),
           "sharded sweep SGD produced non-finite positions")

    # 3. sharded nD layout engine (2D, one [2D, N] all-reduce per period)
    lp = replace(
        LayoutSGDParams().derive_from_graph(pidx, 2),
        dtype="float32", pow_mode="fast", iter_max=2,
    )
    run2, arrays2, make_state2, info2 = build_sharded_sweep_nd(pidx, lp, mesh)
    _check(info2["grid_consensus"] is False,
           "the sharded layout reports a grid consensus")
    cs0, csn0 = make_state2(layout_initial_coords(pidx, 2, lp.seed))
    x_node = run2(cs0, csn0, key_data(lp.seed), *arrays2).cpu().numpy()
    _check(np.isfinite(x_node).all(),
           "sharded layout produced non-finite coordinates")
    summary = {"shards": mesh.size, "device": str(mesh.devices[0]),
               "batched_positions": len(x), "sweep_positions": xs.shape[-1],
               "layout_coords": list(x_node.shape),
               "grid_consensus": info["grid_consensus"]}
    print(f"[dryrun_multichip] ok: {summary} all finite")
    return summary


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="gfasort_tpu_torch.entry",
        description="Run one entry() round, or the multi-device dry run")
    p.add_argument("mode", nargs="?", choices=["entry", "dryrun"],
                   default="entry")
    p.add_argument("n_devices", nargs="?", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.mode == "dryrun":
        dryrun_multichip(args.n_devices, args.device)
        return 0
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    print("entry() ran:", tuple(out.shape), out.dtype, out.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
