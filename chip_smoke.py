#!/usr/bin/env python3
"""
Drive the PyTorch/CUDA port (whatshap_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, every one of which must pass:

1. build    nvcc builds every kernel from whatshap_torch/csrc, one process per
            source, all started together.
2. kernels  on the card, each kernel is held bit-equal against its plain
            torch version on the same CUDA tensors, at K = 7, 10, 14, 15, 16
            (B = 4 synthetic blocks of C = 256 columns, half of them with
            weights above 256).
3. slice    the main path: a chromosome of 256 blocks x 512 heterozygous
            variants at coverage 15 (K = 15) phased by
            PedigreeDPTable(device="cuda"), with the kernels' launch counters
            set to 0 just before and read just after; cost, partitioning and
            index paths must equal the plain torch route's on the card, and
            the superreads must recover the simulated haplotypes.  A second
            run, with its solves timed between synchronisations, splits the
            wall time into pack / prep+H2D / kernels / D2H / extract.
4. single   one read-connected block of 4096 columns at coverage 15 through
            the single-block route (B = 1), checked the same way.
5. timing   the main path's bucket copied to the card, and each kernel at
            its shape (CUDA events), beside its plain version and its bound.

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
}


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
    wmec_cuda.forward_t1.launches = 0
    wmec_cuda.backtrace_t1.launches = 0


def read_launches() -> dict:
    return {
        "wmec_forward_t1": wmec_cuda.forward_t1.launches,
        "wmec_backtrace_t1": wmec_cuda.backtrace_t1.launches,
    }


def haplotype_agreement(superreads, truth) -> float:
    """Share of the calls of the first superread that agree with the
    simulated haplotype, up to one flip per block (ties excluded)."""
    alleles = np.asarray([v.allele for v in superreads[0][0]])
    hits = total = 0
    for b in np.unique(truth[0]):
        at = truth[0] == b
        got, want = alleles[at], truth[1][at]
        called = got < 2
        same = int(np.sum(got[called] == want[called]))
        hits += max(same, int(called.sum()) - same)
        total += int(called.sum())
    return hits / max(total, 1)


def plain_solve(K, T, P, *arrays):
    """The route's solve with the torch mirror in the kernels' place,
    chunked as the route chunks."""
    per_block = arrays[0].shape[1] * T * 4 << K
    return wmec._launch_batched(wmec.solve_batched, K, T, P, arrays, per_block)


def phase_instance(rs, positions, truth, device, label):
    """Phase one instance through the entry point (counted), then again
    through the route's pieces with a time split, and through the plain torch
    route; check all three agree.  Returns the entry-point run's launch
    counts."""
    C = len(positions)
    rc = [1] * C
    ped = _het_pedigree(C)

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
    print(f"{label}: {C} variants, {len(rs)} reads, K={table._packed.K}, "
          f"{len(wmec.connected_column_ranges(table._packed))} read-connected ranges; "
          f"cost {cost}; wall {wall:.3f} s = {C / wall:.1f} variants/s; "
          f"peak device memory {peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    _require(all(n > 0 for n in launches.values()), f"{label}: every kernel launched")
    _require(len(superreads[0][0]) == C and transmission == [0] * C, f"{label}: output shapes")

    # the same instance again, timed around the route's calls: each solve
    # (kernels and the optimum selection) between two synchronisations; the
    # rest of run_dp is host prep and the copies to the card before the
    # solves, and the fetch and stitching after them
    laps = []

    def timed_solve(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = wmec.solve_batched_auto(*args)
        torch.cuda.synchronize()
        laps.append((t, time.perf_counter()))
        return out

    t0 = time.perf_counter()
    packed = wmec.pack_problem(rs, rc, ped, False, positions)
    t1 = time.perf_counter()
    result = wmec.run_dp(packed, device, solve=timed_solve)
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
    plain = wmec.run_dp(packed, device, solve=plain_solve)
    plain_s = time.perf_counter() - t0
    same = (
        plain.optimal_cost == cost
        and wmec.extract_partitioning(packed, plain) == partition
        and np.array_equal(plain.index_path, table._result.index_path)
    )
    print(f"{label}: plain torch route {plain_s:.3f} s, cost {plain.optimal_cost}; "
          f"cost, partitioning and index paths equal: {same}", flush=True)
    _require(same, f"{label}: kernel route equals plain route")

    agree = haplotype_agreement(superreads, truth)
    print(f"{label}: superreads agree with the simulated haplotypes at {agree:.4f} of calls", flush=True)
    _require(agree > 0.9, f"{label}: haplotypes recovered")
    return launches


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
    """Phase 5: each kernel at the main path's largest bucket."""
    ranges = wmec.connected_column_ranges(packed)
    buckets = {}
    for c_pad, k_b, arrs in wmec._slice_ranges(packed, ranges):
        buckets.setdefault((c_pad, k_b), []).append(arrs)
    (c_pad, K), members = max(buckets.items(), key=lambda kv: len(kv[1]))
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

    # 3. the main path: a 256-block chromosome at coverage 15
    t0 = time.perf_counter()
    rs, positions, truth = chromosome(256, 512, 15, seed=7)
    print(f"chromosome built in {time.perf_counter() - t0:.1f} s", flush=True)
    launches = phase_instance(rs, positions, truth, "cuda", "slice")

    # 4. one read-connected block of 4096 columns (single-block route, B = 1)
    rs1, pos1, truth1 = chromosome(1, 4096, 15, seed=3)
    packed1 = wmec.pack_problem(rs1, [1] * len(pos1), _het_pedigree(len(pos1)), False)
    _require(len(wmec.connected_column_ranges(packed1)) == 1, "single block is one range")
    phase_instance(rs1, pos1, truth1, "cuda", "single")
    del rs1, packed1

    # 5. kernel times at the main path's shapes
    packed = wmec.pack_problem(rs, [1] * len(positions), _het_pedigree(len(positions)), False)
    times = time_kernels(packed)

    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kernels = []
    for name in ("wmec_forward_t1", "wmec_backtrace_t1"):
        t = times[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"whatshap_torch/csrc/{name}.cu",
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
