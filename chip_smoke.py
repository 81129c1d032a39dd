#!/usr/bin/env python3
"""
Drive the PyTorch/CUDA port (whatshap_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, every one of which must pass:

1. build    nvcc builds every kernel from whatshap_torch/csrc, one process per
            source, all started together.
2. kernels  on the card, each kernel is held bit-equal against its plain
            torch version on the same CUDA tensors: the T=1 kernels at K = 7,
            10, 14, 15, 16 (B = 4 blocks of C = 256 columns); the general-T
            kernels (tables mode unseeded and seeded, m-only mode, backtrace
            at M = 1 and M = T + 1) at T = 4, K = 7, 10, 12, 15, 16 and T =
            16, K = 7, 10, 13 (B = 4 blocks of C = 128 columns); half the
            blocks with weights above 256.
3. slice    the single-sample main path: a chromosome of 256 blocks x 512
            heterozygous variants at coverage 15 (K = 15) phased by
            PedigreeDPTable(device="cuda"), with the kernels' launch counters
            set to 0 just before and read just after; cost, partitioning and
            index paths must equal the plain torch route's on the card, and
            the superreads must recover the simulated haplotypes.  A second
            run, with its solves timed between synchronisations, splits the
            wall time into pack / prep+H2D / kernels / D2H / extract.
4. single   one read-connected block of 4096 columns at coverage 15 through
            the single-block route (B = 1), checked the same way.
5. trio     the pedigree path: a simulated trio chromosome of 64 blocks x 256
            variants, heterozygous in at least one individual, reads at
            coverage 5 per individual (K = 15), recombination cost 10 per
            column and one recombination per parent in a few blocks, phased
            by PedigreeDPTable(device="cuda") through the seam route (pass 1
            m-only scans, host chain, pass 2 seeded scans with tables and
            multi-walk backtrace); checked as the slice, transmission paths
            included, for every individual's superreads.
6. trio-single  one read-connected trio range of 2048 columns (K = 15)
            through the single-block route, checked the same way.
7. quartet  two trios with shared parents (T = 16, four symmetry cosets),
            16 blocks x 128 columns at coverage 3 per individual, checked
            against the plain route.
8. timing   the main paths' largest buckets copied to the card, and each
            kernel at its shape (CUDA events), beside its plain version and
            its bound.

It prints the card's name and power limit, a {"kernels": [...]} line, and as
its last line {"ok": true, "device": {...}}.  Where there is no CUDA device,
or when a phase fails, it exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

import whatshap_torch.core as core
from whatshap_torch.ops import _build, wmec, wmec_cuda
from whatshap_torch.parallel import blocks

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and int32
# adds/s.  The float32 peak of 67e12 operations/s counts a multiply-add on each
# of an SM's 128 f32 lanes as two; Hopper has 64 int32 lanes per SM, so one add
# per int32 lane per clock is a quarter of it.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_ADDS_PER_S = 67e12 / 4

REPLACES = {
    "wmec_forward_t1": "whatshap_tpu/ops/wmec_pallas.py:73",
    "wmec_backtrace_t1": "whatshap_tpu/ops/wmec_pallas.py:626",
    "wmec_forward_t": "whatshap_tpu/ops/wmec_pallas.py:73",
    "wmec_forward_m_t": "whatshap_tpu/ops/wmec_pallas.py:73",
    "wmec_backtrace_t": "whatshap_tpu/ops/wmec_pallas.py:660",
}
SOURCES = {
    "wmec_forward_t1": "wmec_forward_t1",
    "wmec_backtrace_t1": "wmec_backtrace_t1",
    "wmec_forward_t": "wmec_forward_t",
    "wmec_forward_m_t": "wmec_forward_t",
    "wmec_backtrace_t": "wmec_backtrace_t",
}
WRAPPERS = {
    "wmec_forward_t1": wmec_cuda.forward_t1,
    "wmec_backtrace_t1": wmec_cuda.backtrace_t1,
    "wmec_forward_t": wmec_cuda.forward_t,
    "wmec_forward_m_t": wmec_cuda.forward_m_t,
    "wmec_backtrace_t": wmec_cuda.backtrace_t,
}
TRIO = (3, ((0, 1, 2),))
QUARTET = (4, ((0, 1, 2), (0, 1, 3)))


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def _het_pedigree(n_cols: int):
    ped = core.Pedigree(core.NumericSampleIds())
    het = core.Genotype([0, 1])
    ped.add_individual("sample", [het] * n_cols, None)
    return ped


def chromosome(n_blocks: int, n_cols: int, coverage: int, seed: int):
    """A ReadSet of `n_blocks` synthetic blocks (make_synthetic_readset with
    seeds seed, seed+1, ...), shifted so that they do not overlap.  Returns
    (readset, positions, truth): truth (2, len(positions)) holds, per
    position, the block it lies in and the simulated haplotype's allele."""
    rs = core.ReadSet()
    haps = []
    stride = (n_cols + 100) * 10
    for b in range(n_blocks):
        sub, _positions, hap = blocks.make_synthetic_readset(
            n_cols, coverage, read_len=12, seed=seed + b
        )
        haps.append(hap)
        for read in sub:
            r = core.Read(f"b{b}_{read.name}", 50, 0, 0)
            for v in read:
                r.add_variant(v.position + b * stride, v.allele, v.quality)
            rs.add(r)
    rs.sort()
    positions = rs.get_positions()
    pos = np.asarray(positions)
    block = pos // stride
    col = (pos % stride) // 10 - 1
    truth = np.stack([block, np.asarray(haps)[block, col]])
    return rs, positions, truth


def packed_bucket(n_blocks, n_cols, K, seed, device):
    """Stacked device arrays of `n_blocks` synthetic single-range blocks of
    n_cols columns padded to K slots; blocks with index >= n_blocks // 2 get
    their weights scaled by 37 (entries up to 1443, above bf16's exact 256)."""
    padded = []
    for b in range(n_blocks):
        rs, positions, _hap = blocks.make_synthetic_readset(n_cols, K, read_len=12, seed=seed + b)
        p = wmec.pack_problem(rs, [1] * len(positions), _het_pedigree(len(positions)), False)
        _require(p.K <= K, f"block K {p.K} <= {K}")
        padded.append(blocks.pad_block(p, n_cols, k_pad=K))
    arrays = list(blocks.stack_blocks(padded))
    # pack_problem is linear in the read weights: scaling wdiff and wbase is
    # the same instance with every quality times 37
    arrays[0][n_blocks // 2 :] *= 37
    arrays[1][n_blocks // 2 :] *= 37
    return blocks.to_device(arrays, device)


def _max_err(pairs) -> int:
    """Largest absolute difference between paired int32 tensors, 0 when they
    are bit-equal (differences are taken in slices: the tables are large)."""
    worst = 0
    for a, b in pairs:
        if torch.equal(a, b):
            continue
        for x, y in zip(a.reshape(-1).split(1 << 26), b.reshape(-1).split(1 << 26)):
            worst = max(worst, int((x.long() - y.long()).abs().max()))
    return worst


def compare_kernels(device, ks=(7, 10, 14, 15, 16), n_blocks=4, n_cols=256):
    """Phase 2: both kernels against their plain versions, bit for bit.
    Returns {kernel name: max abs error}."""
    err = {"wmec_forward_t1": 0, "wmec_backtrace_t1": 0}
    for K in ks:
        arrays = packed_bucket(n_blocks, n_cols, K, 1000 + 10 * K, device)
        kern = wmec_cuda.forward_t1(K, 2, *arrays)
        plain = wmec_cuda.forward_t1_plain(K, 2, *arrays)
        torch.cuda.synchronize()
        e_fwd = _max_err(zip(kern, plain))
        _m, _t, opt = wmec_cuda._select_optimum(K, 1, kern[1], kern[2])
        path, final = wmec_cuda.backtrace_t1(opt.contiguous(), kern[0])
        path_p, final_p = wmec_cuda.backtrace_t1_plain(opt, kern[0])
        torch.cuda.synchronize()
        e_bt = _max_err([(path, path_p), (final, final_p)])
        print(f"kernels K={K:2d} B={n_blocks} C={n_cols}: forward max|err|={e_fwd} "
              f"backtrace max|err|={e_bt}", flush=True)
        _require(e_fwd == 0 and e_bt == 0, f"kernels bit-equal to plain at K={K}")
        err["wmec_forward_t1"] = max(err["wmec_forward_t1"], e_fwd)
        err["wmec_backtrace_t1"] = max(err["wmec_backtrace_t1"], e_bt)
    return err


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def haplotype_agreement(superreads, block, haps) -> float:
    """Share of each individual's heterozygous calls where its first
    superread agrees with its simulated haplotypes, up to one swap of the
    two per block (ties excluded); the lowest share over the individuals.
    block (C,) is each column's block (or window), haps (n_ind, 2, C) the
    simulated alleles."""
    worst = 1.0
    for ind, (h0, h1) in enumerate(haps):
        alleles = np.asarray([v.allele for v in superreads[ind][0]])
        hits = total = 0
        for b in np.unique(block):
            at = (block == b) & (h0 != h1) & (alleles < 2)
            same = int(np.sum(alleles[at] == h0[at]))
            hits += max(same, int(at.sum()) - same)
            total += int(at.sum())
        worst = min(worst, hits / max(total, 1))
    return worst


def plain_solve(K, T, P, *arrays):
    """The route's solve with the torch mirror in the kernels' place,
    chunked as the route chunks."""
    per_block = arrays[0].shape[1] * T * 4 << K
    return wmec._launch_batched(wmec.solve_batched, K, T, P, arrays, per_block)


def plain_solve_seeded(K, T, P, *arrays):
    """Pass 2 of the pedigree route with the torch mirror, chunked as the
    route chunks."""
    per_block = arrays[0].shape[1] * T * 8 << K
    return wmec._launch_batched(wmec.solve_seeded_batched, K, T, P, arrays, per_block)


def phase_instance(rs, positions, ped, rc, truth, device, label, expect):
    """Phase one instance through the entry point (counted), then again
    through the route's pieces with a time split, and through the plain torch
    route; check all three agree and that the kernels named in `expect`
    launched.  truth = (block (C,), haps (n_ind, C)).  Returns the
    entry-point run's launch counts."""
    C = len(positions)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    table = core.PedigreeDPTable(rs, rc, ped, False, positions, device=device)
    cost = table.get_optimal_cost()
    partition = table.get_optimal_partitioning()
    superreads, transmission = table.get_super_reads()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    packed = table._packed
    print(f"{label}: {C} variants, {len(rs)} reads, K={packed.K}, T={packed.T}, "
          f"{len(wmec.connected_column_ranges(packed))} read-connected ranges; "
          f"cost {cost}; wall {wall:.3f} s = {C / wall:.1f} variants/s; "
          f"peak device memory {peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    _require(all(launches[n] > 0 for n in expect), f"{label}: every kernel of its path launched")
    _require(len(superreads[0][0]) == C and len(transmission) == C, f"{label}: output shapes")
    _require(packed.T > 1 or transmission == [0] * C, f"{label}: no transmission for one sample")

    # the same instance again, timed around the route's calls: each solve
    # (kernels and the glue between them) between two synchronisations; the
    # rest of run_dp is host prep and the copies to the card before the
    # solves, the host chain between the pedigree passes, and the fetch and
    # stitching after them
    laps = []

    def timed(fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            laps.append((t, time.perf_counter()))
            return out
        return run

    t0 = time.perf_counter()
    packed = wmec.pack_problem(rs, rc, ped, False, positions)
    t1 = time.perf_counter()
    result = wmec.run_dp(
        packed, device, solve=timed(wmec.solve_batched_auto),
        forward_m=timed(wmec.forward_m_auto), solve_seeded=timed(wmec.solve_seeded_auto),
    )
    t2 = time.perf_counter()
    part_split = wmec.extract_partitioning(packed, result)
    wmec.extract_alleles(packed, result, ped)
    t3 = time.perf_counter()
    kernels = sum(b - a for a, b in laps)
    split = {
        "pack": t1 - t0,
        "prep+h2d": laps[-1][1] - t1 - kernels,
        "kernels": kernels,
        "d2h": t2 - laps[-1][1],
        "extract": t3 - t2,
    }
    text = " ".join(f"{k} {v:.3f}" for k, v in split.items())
    print(f"{label}: split (s): {text}; total {t3 - t0:.3f}", flush=True)
    _require(result.optimal_cost == cost and part_split == partition, f"{label}: split run agrees")

    # the plain torch route on the card
    t0 = time.perf_counter()
    plain = wmec.run_dp(
        packed, device, solve=plain_solve, forward_m=wmec.forward_m_batched,
        solve_seeded=plain_solve_seeded,
    )
    plain_s = time.perf_counter() - t0
    same = (
        plain.optimal_cost == cost
        and wmec.extract_partitioning(packed, plain) == partition
        and np.array_equal(plain.index_path, table._result.index_path)
        and np.array_equal(plain.trans_path, table._result.trans_path)
    )
    print(f"{label}: plain torch route {plain_s:.3f} s, cost {plain.optimal_cost}; "
          f"cost, partitioning, index and transmission paths equal: {same}", flush=True)
    _require(same, f"{label}: kernel route equals plain route")

    if truth is not None:
        agree = haplotype_agreement(superreads, *truth)
        print(f"{label}: superreads agree with the simulated haplotypes at {agree:.4f} of "
              f"calls (lowest over {len(truth[1])} individual(s))", flush=True)
        _require(agree > 0.9, f"{label}: haplotypes recovered")
    if packed.T > 1:
        switches = int(np.count_nonzero(np.diff(table._result.trans_path)))
        print(f"{label}: {switches} transmission changes on the optimal path", flush=True)
    return launches


def simulate_pedigree(n_blocks, n_cols, coverage, pedigree, seed, recomb_every=16):
    """A simulated pedigree chromosome: founders (individuals 0 and 1) get
    random haplotypes, made to differ somewhere at every column so that each
    column is heterozygous in someone; each child (the trios' third members)
    inherits one haplotype of each parent, switching parental haplotype once
    per parent in every `recomb_every`-th block (at different blocks for
    the two parents); genotypes follow the haplotypes.  Reads of every
    individual tile each block in `coverage` lanes (read length ~12
    variants, 5 % allele errors, qualities 10-39).  Returns (readset,
    positions, pedigree, (block (C,), first haplotype of each individual
    (n_ind, C)))."""
    n_ind, trios = pedigree
    rng = np.random.RandomState(seed)
    total = n_blocks * n_cols
    haps = np.zeros((n_ind, 2, total), dtype=np.int64)
    haps[:2] = rng.randint(0, 2, size=(2, 2, total))
    same = (haps[:2] == haps[0, 0]).all(axis=(0, 1))
    haps[0, 1, same] ^= 1
    block = np.repeat(np.arange(n_blocks), n_cols)
    for ci, (fa, mo, ch) in enumerate(trios):
        for side, parent in enumerate((fa, mo)):
            pick = np.full(total, rng.randint(0, 2))
            for b in range(n_blocks):
                if (b + 5 * side + 3 * ci) % recomb_every == 0:  # one recombination in this block
                    at = b * n_cols + rng.randint(n_cols // 4, 3 * n_cols // 4)
                    pick[at:] ^= 1
            haps[ch, side] = haps[parent, pick, np.arange(total)]
    positions = ((block * (n_cols + 100) + np.tile(np.arange(n_cols), n_blocks) + 1) * 10).tolist()
    ped = core.Pedigree(core.NumericSampleIds())
    for ind in range(n_ind):
        gts = [core.Genotype(sorted((int(a), int(b)))) for a, b in zip(haps[ind, 0], haps[ind, 1])]
        ped.add_individual(f"ind{ind}", gts, None)
    for fa, mo, ch in trios:
        ped.add_relationship(f"ind{fa}", f"ind{mo}", f"ind{ch}")
    rs = core.ReadSet()
    for ind in range(n_ind):
        for b in range(n_blocks):
            off = b * n_cols
            for lane in range(coverage):
                start = int(rng.randint(0, 6))
                while start < n_cols - 1:
                    length = int(np.clip(rng.poisson(12), 2, n_cols - start))
                    side = int(rng.randint(0, 2))
                    cols = np.arange(off + start, off + start + length)
                    alleles = haps[ind, side, cols] ^ (rng.rand(length) < 0.05)
                    quals = rng.randint(10, 40, size=length)
                    read = core.Read(f"i{ind}_b{b}_l{lane}_{start}", 50, 0, ind)
                    for c, a, q in zip(cols.tolist(), alleles.tolist(), quals.tolist()):
                        read.add_variant(positions[c], int(a), int(q))
                    rs.add(read)
                    start += length
    rs.sort()
    return rs, positions, ped, (block, haps)


def pedigree_bucket(n_blocks, n_cols, K, T, seed, device):
    """Stacked device arrays of `n_blocks` single-range simulated pedigree
    blocks (a trio for T = 4, a quartet for T = 16) of n_cols columns padded
    to K slots, recombination cost 10; blocks with index >= n_blocks // 2
    get their weights scaled by 37."""
    pedigree = TRIO if T == 4 else QUARTET
    padded = []
    for b in range(n_blocks):
        rs, positions, ped, _truth = simulate_pedigree(1, n_cols - 8, max(1, K // pedigree[0]), pedigree, seed + b)
        p = wmec.pack_problem(rs, [10] * len(positions), ped, False, positions)
        _require(p.K <= K and p.T == T, f"pedigree block K {p.K} <= {K}, T {p.T} == {T}")
        padded.append(blocks.pad_block(p, n_cols, k_pad=K))
    arrays = list(blocks.stack_blocks(padded))
    arrays[0][n_blocks // 2 :] *= 37
    arrays[1][n_blocks // 2 :] *= 37
    return blocks.to_device(arrays, device)


def _seeds(B, T, seed, device):
    rng = np.random.RandomState(seed)
    dp0 = rng.randint(0, 500, size=(B, T)).astype(np.int32)
    dp0[rng.rand(B, T) < 0.3] = wmec.INF
    dp0[:, 0] = np.minimum(dp0[:, 0], 100)
    return torch.from_numpy(dp0).to(device)


def _walk_inits(K, T, tables_out, die_next):
    """The M = T + 1 walk starts of pass 2: the head optimum and the seam
    fold's winners, as solve_seeded_batched_cuda builds them."""
    _pidx, _pjmin, dp_last, jmin_last, key_last = tables_out
    _cost, head = wmec_cuda._head_init(K, T, dp_last, jmin_last, key_last)
    _m, s_star, jmin_star = wmec._seam_fold(
        K, T, dp_last.transpose(1, 2), key_last, jmin_last.transpose(1, 2), die_next
    )
    B = dp_last.shape[0]
    t_ids = torch.arange(T, dtype=torch.int32, device=dp_last.device).expand(B, T)
    return torch.cat([head[:, None], torch.stack([s_star, t_ids, jmin_star], dim=2)], dim=1).contiguous()


def compare_pedigree_kernels(device, shapes=((4, 7), (4, 10), (4, 12), (4, 15), (4, 16),
                                            (16, 7), (16, 10), (16, 13)), n_blocks=4, n_cols=128):
    """Phase 2, general T: each mode of the forward kernel and the backtrace
    at M = 1 and M = T + 1 against their plain versions, bit for bit.
    Returns {kernel name: max abs error}."""
    err = {"wmec_forward_t": 0, "wmec_forward_m_t": 0, "wmec_backtrace_t": 0}
    P = 4
    for T, K in shapes:
        arrays = pedigree_bucket(n_blocks, n_cols, K, T, 2000 + 10 * K + T, device)
        dp0 = _seeds(n_blocks, T, K + T, device)
        e_fwd = 0
        for seed in (None, dp0):
            kern = wmec_cuda.forward_t(K, T, P, *arrays, seed)
            plain = wmec_cuda.forward_t_plain(K, T, P, *arrays, seed)
            torch.cuda.synchronize()
            e_fwd = max(e_fwd, _max_err(zip(kern, plain)))
            del plain
        m = wmec_cuda.forward_m_t(K, T, P, *arrays, dp0)
        m_plain = wmec_cuda.forward_m_t_plain(K, T, P, *arrays, dp0)
        torch.cuda.synchronize()
        e_m = _max_err([(m, m_plain)])
        die_next = torch.rand((n_blocks, K), generator=torch.Generator().manual_seed(K)) < 0.7
        inits = _walk_inits(K, T, kern, die_next.to(device))
        e_bt = 0
        for init in (inits[:, :1].contiguous(), inits):
            out = wmec_cuda.backtrace_t(init, kern[0], kern[1])
            ref = wmec_cuda.backtrace_t_plain(init, kern[0], kern[1])
            torch.cuda.synchronize()
            e_bt = max(e_bt, _max_err(zip(out, ref)))
        del kern
        print(f"kernels T={T:2d} K={K:2d} B={n_blocks} C={n_cols}: forward (tables, unseeded and "
              f"seeded) max|err|={e_fwd} m-only max|err|={e_m} backtrace (M=1, M={T + 1}) "
              f"max|err|={e_bt}", flush=True)
        _require(e_fwd == 0 and e_m == 0 and e_bt == 0, f"general-T kernels bit-equal to plain at T={T}, K={K}")
        err["wmec_forward_t"] = max(err["wmec_forward_t"], e_fwd)
        err["wmec_forward_m_t"] = max(err["wmec_forward_m_t"], e_m)
        err["wmec_backtrace_t"] = max(err["wmec_backtrace_t"], e_bt)
    return err


def _time(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs, by CUDA events, after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_kernels(packed):
    """Phase 8, T = 1: each kernel at the slice's largest bucket."""
    (c_pad, K), members, _ri = main_bucket(packed)
    stacked = blocks.stack_blocks(members)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrays = blocks.to_device(stacked, "cuda")
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    B, C, S = len(members), c_pad, 1 << K
    print(f"timing at the main bucket: B={B} C={C} K={K}; its copy to the card "
          f"{h2d_ms:.3f} ms", flush=True)

    fwd_ms = _time(lambda: wmec_cuda.forward_t1(K, 2, *arrays), reps=3)
    pidx, dp_last, key_last = wmec_cuda.forward_t1(K, 2, *arrays)
    t0 = time.perf_counter()
    plain = wmec_cuda.forward_t1_plain(K, 2, *arrays)
    torch.cuda.synchronize()
    fwd_plain_ms = (time.perf_counter() - t0) * 1e3
    fwd_err = _max_err(zip((pidx, dp_last, key_last), plain))
    del plain
    _m, _t, opt = wmec_cuda._select_optimum(K, 1, dp_last, key_last)
    opt = opt.contiguous()
    bt_ms = _time(lambda: wmec_cuda.backtrace_t1(opt, pidx), reps=10)
    path, final = wmec_cuda.backtrace_t1(opt, pidx)
    t0 = time.perf_counter()
    path_p, final_p = wmec_cuda.backtrace_t1_plain(opt, pidx)
    torch.cuda.synchronize()
    bt_plain_ms = (time.perf_counter() - t0) * 1e3
    bt_err = _max_err([(path, path_p), (final, final_p)])
    _require(fwd_err == 0 and bt_err == 0, "kernels bit-equal to plain at the main bucket")

    # bounds: each input read once and each output written once, against
    # the adds the function needs: its four cost sums and its key sum change
    # by one slot's weight from a state to its Gray-order neighbour, so they
    # cost one int32 add each per state and column
    fwd_in = sum(a.numel() * a.element_size() for a in arrays[:5])  # rc is not read
    fwd_out = (pidx.numel() + dp_last.numel() + key_last.numel()) * 4
    fwd_ops = 5.0 * B * C * S
    fwd_bytes_ms = (fwd_in + fwd_out) / PEAK_BYTES_PER_S * 1e3
    fwd_ops_ms = fwd_ops / PEAK_INT32_ADDS_PER_S * 1e3
    bt_bytes = 4 * (B + B * C + B * C + B)  # opt, gathered entries, path, final
    out = {
        "wmec_forward_t1": {
            "ms": fwd_ms, "plain_ms": fwd_plain_ms, "max_abs_err": fwd_err,
            "bound_ms": max(fwd_bytes_ms, fwd_ops_ms),
            "bound_by": "operations" if fwd_ops_ms >= fwd_bytes_ms else "bytes",
        },
        "wmec_backtrace_t1": {
            "ms": bt_ms, "plain_ms": bt_plain_ms, "max_abs_err": bt_err,
            "bound_ms": bt_bytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
        },
    }
    for name, r in out.items():
        print(f"{name}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms), bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}", flush=True)
    return out


def main_bucket(packed):
    """The bucket of the most blocks on the route: ((c_pad, K), its
    PaddedArrays, their range indices)."""
    ranges = wmec.connected_column_ranges(packed)
    buckets = {}
    for ri, (c_pad, k_b, arrs) in enumerate(wmec._slice_ranges(packed, ranges)):
        buckets.setdefault((c_pad, k_b), []).append((ri, arrs))
    key, members = max(buckets.items(), key=lambda kv: len(kv[1]))
    return key, [a for _ri, a in members], [ri for ri, _a in members]


def _plain_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(in_bytes, out_bytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the int32 adds over the add rate."""
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_INT32_ADDS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def time_pedigree_kernels(packed, device="cuda"):
    """Phase 8, general T: each kernel at the trio path's main bucket, at
    the shapes the route gives it: the m-only scan as pass 1 (unit seeds,
    R = 1), the seeded scan with tables as pass 2, the backtrace with the
    head and T seam walks per block."""
    (c_pad, K), members, _ri = main_bucket(packed)
    T, P = packed.T, packed.P
    arrays = blocks.to_device(blocks.stack_blocks(members), device)
    B, C, S = len(members), c_pad, 1 << K
    print(f"timing at the trio's main bucket: B={B} C={C} K={K} T={T} P={P}", flush=True)
    rep_of, reps = wmec.coset_representatives(T, packed.t_sym_masks)
    unit = np.full((len(reps), T), wmec.INF, dtype=np.int32)
    unit[np.arange(len(reps)), reps] = 0
    seeds = torch.from_numpy(unit).to(device).repeat(B, 1)
    rep = tuple(a.repeat_interleave(len(reps), dim=0) for a in arrays)
    out = {}

    # pass 1: m-only
    m_ms = _time(lambda: wmec_cuda.forward_m_t(K, T, P, *rep, seeds), reps=3)
    m = wmec_cuda.forward_m_t(K, T, P, *rep, seeds)
    m_plain, m_plain_ms = _plain_ms(lambda: wmec_cuda.forward_m_t_plain(K, T, P, *rep, seeds))
    wdiff, wbase, rankw, acost, die, rc = rep
    out["wmec_forward_m_t"] = dict(
        ms=m_ms, plain_ms=m_plain_ms, max_abs_err=_max_err([(m, m_plain)]),
        **dict(zip(("bound_ms", "bound_by"), _bound(
            _nbytes(wdiff, wbase, acost, die, rc, seeds), _nbytes(m),
            (2 * T * P + T * T) * rep[0].shape[0] * C * S))),
    )

    # pass 2: seeded, with tables (the seeds: each block's folded minima)
    dp0 = m.reshape(B, len(reps), T)[:, 0].contiguous()
    del rep, m_plain
    fwd_ms = _time(lambda: wmec_cuda.forward_t(K, T, P, *arrays, dp0), reps=2)
    kern = wmec_cuda.forward_t(K, T, P, *arrays, dp0)
    plain, fwd_plain_ms = _plain_ms(lambda: wmec_cuda.forward_t_plain(K, T, P, *arrays, dp0))
    fwd_err = _max_err(zip(kern, plain))
    del plain
    out["wmec_forward_t"] = dict(
        ms=fwd_ms, plain_ms=fwd_plain_ms, max_abs_err=fwd_err,
        **dict(zip(("bound_ms", "bound_by"), _bound(
            _nbytes(*arrays, dp0), _nbytes(*kern), (2 * T * P + 1 + T * T) * B * C * S))),
    )

    # the head and T seam walks per block over the pass-2 tables
    die_next = torch.ones((B, K), dtype=torch.bool, device=device)
    inits = _walk_inits(K, T, kern, die_next)
    pidx, pjmin = kern[0], kern[1]
    bt_ms = _time(lambda: wmec_cuda.backtrace_t(inits, pidx, pjmin), reps=10)
    walks = wmec_cuda.backtrace_t(inits, pidx, pjmin)
    ref, bt_plain_ms = _plain_ms(lambda: wmec_cuda.backtrace_t_plain(inits, pidx, pjmin))
    W = B * (T + 1)
    out["wmec_backtrace_t"] = dict(
        ms=bt_ms, plain_ms=bt_plain_ms, max_abs_err=_max_err(zip(walks, ref)),
        # start and final triples, two gathered entries and two path
        # entries per column and walk
        bound_ms=4 * W * (3 + 4 * C + 3) / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
    )
    del kern, pidx, pjmin
    _require(all(r["max_abs_err"] == 0 for r in out.values()), "general-T kernels bit-equal at the trio's bucket")
    for name, r in out.items():
        print(f"{name}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms), bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)

    # 1. build
    secs, logs = _build.build_all()
    print(f"build: {secs:.2f} s for {sorted(logs) or 'nothing (already built)'}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    for name in _build.sources():
        _build.load(name)

    # 2. kernels against their plain versions
    errs = compare_kernels("cuda")
    errs.update(compare_pedigree_kernels("cuda"))
    print(f"phases 1-2 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    def both(hap):  # the two haplotypes of one heterozygous sample
        return np.stack([hap, 1 - hap])[None]

    # 3. the single-sample main path: a 256-block chromosome at coverage 15
    t0 = time.perf_counter()
    rs, positions, truth = chromosome(256, 512, 15, seed=7)
    print(f"chromosome built in {time.perf_counter() - t0:.1f} s", flush=True)
    het = _het_pedigree(len(positions))
    launches = phase_instance(
        rs, positions, het, [1] * len(positions), (truth[0], both(truth[1])), "cuda", "slice",
        ("wmec_forward_t1", "wmec_backtrace_t1"),
    )

    # 4. one read-connected block of 4096 columns (single-block route, B = 1)
    rs1, pos1, truth1 = chromosome(1, 4096, 15, seed=3)
    het1 = _het_pedigree(len(pos1))
    packed1 = wmec.pack_problem(rs1, [1] * len(pos1), het1, False)
    _require(len(wmec.connected_column_ranges(packed1)) == 1, "single block is one range")
    phase_instance(
        rs1, pos1, het1, [1] * len(pos1), (truth1[0], both(truth1[1])), "cuda", "single",
        ("wmec_forward_t1", "wmec_backtrace_t1"),
    )
    del rs1, packed1
    print(f"phases 3-4 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # 5. the pedigree path: a 64-block trio chromosome at coverage 5 each
    t0 = time.perf_counter()
    rs_t, pos_t, ped_t, truth_t = simulate_pedigree(64, 256, 5, TRIO, seed=11)
    print(f"trio chromosome built in {time.perf_counter() - t0:.1f} s", flush=True)
    pedigree_kernels = ("wmec_forward_t", "wmec_forward_m_t", "wmec_backtrace_t")
    trio_launches = phase_instance(
        rs_t, pos_t, ped_t, [10] * len(pos_t), truth_t, "cuda", "trio", pedigree_kernels
    )

    # 6. one read-connected trio range of 2048 columns (single-block route)
    rs_s, pos_s, ped_s, truth_s = simulate_pedigree(1, 2048, 5, TRIO, seed=5)
    packed_s = wmec.pack_problem(rs_s, [10] * len(pos_s), ped_s, False, pos_s)
    _require(len(wmec.connected_column_ranges(packed_s)) == 1, "trio-single is one range")
    # one range of 2048 columns may hold a switch error: agreement is
    # counted up to one flip per 256-column window
    windows = (np.arange(len(pos_s)) // 256, truth_s[1])
    phase_instance(
        rs_s, pos_s, ped_s, [10] * len(pos_s), windows, "cuda", "trio-single",
        ("wmec_forward_t", "wmec_backtrace_t"),
    )
    del rs_s, packed_s

    # 7. a quartet (two trios with shared parents: T = 16, four cosets)
    rs_q, pos_q, ped_q, _truth_q = simulate_pedigree(16, 128, 3, QUARTET, seed=13)
    phase_instance(
        rs_q, pos_q, ped_q, [10] * len(pos_q), None, "cuda", "quartet", pedigree_kernels
    )
    del rs_q
    print(f"phases 5-7 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # 8. kernel times at the main paths' shapes
    packed = wmec.pack_problem(rs, [1] * len(positions), het, False)
    times = time_kernels(packed)
    del packed
    torch.cuda.empty_cache()
    packed_t = wmec.pack_problem(rs_t, [10] * len(pos_t), ped_t, False, pos_t)
    times.update(time_pedigree_kernels(packed_t))
    launches.update({k: trio_launches[k] for k in pedigree_kernels})

    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kernels = []
    for name in WRAPPERS:
        t = times[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"whatshap_torch/csrc/{SOURCES[name]}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(errs[name], t["max_abs_err"]),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
        })
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(power)
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
