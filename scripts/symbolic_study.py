#!/usr/bin/env python
"""Host-only study: level counts / fill / padded work per (ordering, panel).

The v2 engine's wall time per sweep is ~ n_levels * per_level_cost, where
per_level_cost is driven by the PADDED widths (max_ud/max_uo/max_off across
levels).  This picks the config before spending device compile time.
"""
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import slampp_tpu  # noqa
from slampp_tpu.io.datasets import make_manhattan
from slampp_tpu.io.parser import parse_file, build_system
from slampp_tpu.linear.native import NativeBlockSolver


def main():
    import tempfile

    text, gt = make_manhattan(n_poses=3500, loop_prob=0.1, seed=0)
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write(text)
        path = f.name
    try:
        system = build_system(parse_file(path))
    finally:
        os.unlink(path)

    for ordering in ["min_degree", "nested_dissection", "rcm"]:
        for panel in [4, 8, 16, 32]:
            ns = NativeBlockSolver(system, ordering=ordering, panel=panel, engine="v2")
            t0 = time.perf_counter()
            try:
                ns.symbolic()
            except Exception as e:
                print(f"{ordering:18s} p={panel:3d}: FAILED {e}")
                continue
            dt = time.perf_counter() - t0
            p2 = ns.plan2
            P = ns.block_plan.P
            # padded per-sweep work proxies
            fac_work = p2.n_levels * (p2.max_ud + p2.max_uo) * P * P * P * 2
            print(
                f"{ordering:18s} p={panel:3d}: P={P:3d} n={p2.n:4d} n_off={p2.n_off:5d} "
                f"levels={p2.n_levels:3d} max_cols={p2.max_cols:3d} max_off={p2.max_off:4d} "
                f"max_ud={p2.max_ud:4d} max_uo={p2.max_uo:5d} max_fw={p2.max_fw:4d} "
                f"facGF={fac_work/1e9:6.2f} sym_s={dt:5.1f}"
            )


if __name__ == "__main__":
    main()
