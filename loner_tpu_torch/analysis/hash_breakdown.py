"""The hash-grid backward's time by level-group budget, on the card.

    python3 -m loner_tpu_torch.analysis.hash_breakdown [--points 2097152 262144]
        [--budgets-mb 0 32 24 16 8]

Times the backward through its wrapper (``hash_encode_bwd_cuda``, bf16, the
reference's grid) at each level-group budget (its ``group_bytes``; the package's
is ``ops/hash_grid.py::BWD_GROUP_BYTES``; 0: all levels in one launch), with dpos
and without, at points in ray order and at random (``ab_compare.hash_points``).
Every budget computes the same function: the table gradient's int64 sums and
dpos are compared with the first budget's bits. Prints the card's name and power
limit, then one JSON line a budget, order and size (ms, ``ab_compare.kernel_ms``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from loner_tpu_torch.analysis.ab_compare import hash_points, kernel_ms
from loner_tpu_torch.models.hash_encoding import HashEncodingConfig
from loner_tpu_torch.ops import hash_grid as hg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, nargs="+", default=[2097152, 262144])
    ap.add_argument("--budgets-mb", type=int, nargs="+", default=[0, 32, 24, 16, 8])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hash_breakdown: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cfg, bf = HashEncodingConfig(), torch.bfloat16
    rng = np.random.default_rng(5)
    table = torch.tensor(rng.uniform(-1e-2, 1e-2, (cfg.total_table_size, 2)).astype(np.float32),
                         device=dev)
    for order in ("ray", "random"):
        for n in args.points:
            pos = torch.tensor(hash_points(n, order), device=dev)
            dout = torch.tensor((rng.normal(size=(n, cfg.output_dim)) / n ** 0.5)
                                .astype(np.float32), device=dev)
            want = None
            for mb in args.budgets_mb:
                budget = (mb << 20) if mb else 1 << 62
                sums = hg.table_sum(table)
                _, dpos = hg.hash_encode_bwd_cuda(table, pos, dout, cfg, bf, sink=sums,
                                                  group_bytes=budget)
                if want is None:
                    want = (sums.acc, dpos)
                print(json.dumps({
                    "budget_mb": mb, "order": order, "points": n,
                    "groups": hg.level_groups(cfg, budget),
                    "bwd_ms": kernel_ms(lambda: hg.hash_encode_bwd_cuda(
                        table, pos, dout, cfg, bf, group_bytes=budget)),
                    "bwd_no_dpos_ms": kernel_ms(lambda: hg.hash_encode_bwd_cuda(
                        table, pos, dout, cfg, bf, need_dpos=False, group_bytes=budget)),
                    "equal_bits": bool(torch.equal(sums.acc, want[0])
                                       and torch.equal(dpos, want[1]))}), flush=True)
            del pos, dout, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
