"""
Synthetic phasing workload builders shared by the dry run
(parallel/dryrun.py) and the sharding tests: batches of independent
single-sample or pedigree (trio) wMEC instances, packed and padded for the
batched solvers, with the PackedProblems kept for per-block parity checks.
Copies of whatshap_tpu/parallel/workloads.py's builders.
"""

from typing import List, Tuple

import numpy as np

from ..core import NumericSampleIds, Pedigree, Read, ReadSet
from ..ops import wmec
from ..testhelpers import canonic_index_to_biallelic_gt
from . import blocks as blk


def build_single_sample_batch(
    n_blocks: int, n_cols: int = 32, coverage: int = 6, read_len: int = 8, seed: int = 0,
    c_pad: int = None, k_pad: int = None,
) -> Tuple[int, int, int, List[wmec.PackedProblem], tuple]:
    """(K, T, P, packed problems, stacked padded arrays) for a batch of
    random diploid single-sample instances."""
    packed_list = []
    for b in range(n_blocks):
        rs, positions, _ = blk.make_synthetic_readset(
            n_cols, coverage, read_len=read_len, seed=seed + b
        )
        ped = Pedigree(NumericSampleIds())
        ped.add_individual(
            "sample",
            [canonic_index_to_biallelic_gt(1) for _ in positions],
            [None] * len(positions),
        )
        packed_list.append(wmec.pack_problem(rs, [1] * len(positions), ped, False))
    K = max(p.K for p in packed_list)
    if k_pad is not None:
        K = max(K, k_pad)
    c_pad = c_pad or n_cols
    padded = [blk.pad_block(p, c_pad, k_pad=K) for p in packed_list]
    arrays = blk.stack_blocks(padded)
    return K, packed_list[0].T, packed_list[0].P, packed_list, arrays


def build_trio_batch(
    n_blocks: int, n_pos: int = 12, n_reads: int = 10, seed: int = 31,
    n_ind: int = 3, trios=((0, 1, 2),), c_pad: int = 16, k_pad: int = None,
    read_len: int = None,
) -> Tuple[int, int, int, List[wmec.PackedProblem], tuple]:
    """(K, T, P, packed problems, stacked padded arrays) for a batch of
    pedigree instances (one trio -> T=4; two trios -> T=16).

    read_len caps the read span in columns; without it reads run from
    their start to a uniform point anywhere right of it (fine for the
    default n_pos=12, but at hundreds of columns that stacks coverage —
    and K — far beyond any kernel limit)."""
    rng = np.random.RandomState(seed)
    packed_list = []
    for _ in range(n_blocks):
        positions = [(i + 1) * 10 for i in range(n_pos)]
        rs = ReadSet()
        for i in range(n_reads):
            sample = int(rng.randint(0, n_ind))
            start = int(rng.randint(0, n_pos - 1))
            hi = n_pos if read_len is None else min(start + read_len, n_pos)
            end = int(rng.randint(start + 1, hi))
            read = Read(f"R{i}", 50, 0, sample)
            for c in range(start, end + 1):
                if rng.rand() < 0.2 and c not in (start, end):
                    continue
                read.add_variant(positions[c], int(rng.randint(0, 2)), int(rng.randint(1, 300)))
            rs.add(read)
        rs.sort()
        ped = Pedigree(NumericSampleIds())
        for ind in range(n_ind):
            ped.add_individual(
                f"ind{ind}", [canonic_index_to_biallelic_gt(1) for _ in positions], None
            )
        for f, m, c in trios:
            ped.add_relationship(f"ind{f}", f"ind{m}", f"ind{c}")
        packed_list.append(
            wmec.pack_problem(
                rs, [int(rng.randint(1, 10)) for _ in positions], ped, False, positions
            )
        )
    K = max(p.K for p in packed_list)
    if k_pad is not None:
        K = max(K, k_pad)
    padded = [blk.pad_block(p, c_pad, k_pad=K) for p in packed_list]
    arrays = blk.stack_blocks(padded)
    return K, packed_list[0].T, packed_list[0].P, packed_list, arrays


def assert_batched_matches_serial(packed_list, costs, index_paths, trans_paths):
    """Bit-parity of a batched/sharded solve against per-block serial
    ``run_dp`` on the CPU (the plain torch route): optimal cost, read
    partitioning and transmission path must all agree."""
    for b, packed in enumerate(packed_list):
        serial = wmec.run_dp(packed, device="cpu")
        C = packed.n_cols
        assert int(costs[b]) == serial.optimal_cost, (b, int(costs[b]), serial.optimal_cost)
        batched = wmec.DPResult(
            int(costs[b]),
            np.asarray(index_paths[b][:C], dtype=np.int64),
            np.asarray(trans_paths[b][:C], dtype=np.int64),
        )
        assert list(batched.trans_path) == list(serial.trans_path)
        assert wmec.extract_partitioning(packed, batched) == wmec.extract_partitioning(
            packed, serial
        )
