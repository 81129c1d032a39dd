"""
The port's CUDA kernels and its CUDA route, on the card.  Every test here
needs a CUDA device and skips where there is none.  The file imports
nothing of jax or of the reference package, so that it also runs where only
the port's dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The kernels are held bit-equal against their plain torch versions (which
tests/test_torch_wmec.py holds against the JAX reference on the CPU).
"""

import numpy as np
import pytest
import torch

import whatshap_torch.core as core
from whatshap_torch.ops import wmec, wmec_cuda
from whatshap_torch.parallel import blocks


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _pedigree(n_cols, n_ind=1, trios=()):
    ped = core.Pedigree(core.NumericSampleIds())
    for i in range(n_ind):
        ped.add_individual(f"ind{i}", [core.Genotype([0, 1])] * n_cols, None)
    for f, m, c in trios:
        ped.add_relationship(f"ind{f}", f"ind{m}", f"ind{c}")
    return ped


def _bucket(K, n_blocks=3, n_cols=64, seed=0):
    padded = []
    for b in range(n_blocks):
        rs, positions, _ = blocks.make_synthetic_readset(n_cols, K, read_len=6, seed=seed + b)
        p = wmec.pack_problem(rs, [1] * len(positions), _pedigree(len(positions)), False)
        padded.append(blocks.pad_block(p, n_cols, k_pad=max(K, p.K)))
    arrays = list(blocks.stack_blocks(padded))
    arrays[0][-1] *= 41  # one block with weights above 256
    arrays[1][-1] *= 41
    return arrays


def _chromosome(n_blocks, n_cols, coverage, seed):
    rs = core.ReadSet()
    for b in range(n_blocks):
        sub, _pos, _hap = blocks.make_synthetic_readset(n_cols, coverage, read_len=6, seed=seed + b)
        for read in sub:
            r = core.Read(f"b{b}_{read.name}", 50, 0, 0)
            for v in read:
                r.add_variant(v.position + b * 10 * (n_cols + 10), v.allele, v.quality)
            rs.add(r)
    rs.sort()
    return rs, rs.get_positions()


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3, 5, 7, 9, 10, 13, 14, 15, 16, 17])
def test_kernels_match_plain(cuda_device, K):
    arrays = blocks.to_device(_bucket(K, seed=10 * K), cuda_device)
    kern = wmec_cuda.forward_t1(K, 2, *arrays)
    plain = wmec_cuda.forward_t1_plain(K, 2, *arrays)
    torch.cuda.synchronize()
    for x, y in zip(kern, plain):
        assert torch.equal(x, y)
    _m, _t, opt = wmec_cuda._select_optimum(K, 1, kern[1], kern[2])
    die = wmec_cuda.pack_die(arrays[4])
    path, final = wmec_cuda.backtrace_t1(opt.contiguous(), kern[0], die)
    path_p, final_p = wmec_cuda.backtrace_t1_plain(opt, kern[0], die)
    torch.cuda.synchronize()
    assert torch.equal(path, path_p) and torch.equal(final, final_p)


def _walks_equal(T, tables, start, die):
    if T == 1:
        out = wmec_cuda.backtrace_t1(start, tables[0], die)
        ref = wmec_cuda.backtrace_t1_plain(start, tables[0], die)
    else:
        out = wmec_cuda.backtrace_t(start, *tables, die)
        ref = wmec_cuda.backtrace_t_plain(start, *tables, die)
    torch.cuda.synchronize()
    return all(torch.equal(x, y) for x, y in zip(out, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("T,K,B,M", [
    (1, 5, 2, 1), (1, 12, 9, 1), (1, 17, 1, 1), (4, 9, 3, 1), (4, 9, 2, 5), (16, 7, 1, 17), (16, 13, 1, 1),
])
def test_backtraces_match_plain_on_random_tables(cuda_device, T, K, B, M):
    """Both backtrace kernels against their plain versions on tables that
    break the shape their guesses rest on: random entries, whole or in 5 %
    of a table shaped like the forward's, under random masks (half of them
    empty), from random starts; in narrow launches (up to 8 walks) and
    wide ones."""
    rng = np.random.RandomState(100 * T + K)
    S, C = 1 << K, 150
    die = (rng.randint(0, S, (B, C)) * (rng.rand(B, C) < 0.5)).astype(np.int32)
    shaped = np.arange(S, dtype=np.int32) ^ (rng.randint(0, S, (B, C, T, S), dtype=np.int32) & die[:, :, None, None])
    broken = np.where(rng.rand(B, C, T, S) < 0.05, rng.randint(0, S, (B, C, T, S), dtype=np.int32), shaped)
    whole = rng.randint(0, S, (B, C, T, S), dtype=np.int32)
    dev = cuda_device
    if T == 1:
        start = torch.from_numpy(rng.randint(0, S, B).astype(np.int32)).to(dev)
    else:
        start = torch.from_numpy(np.stack([rng.randint(0, S, (B, M)), rng.randint(0, T, (B, M)),
                                           rng.randint(0, T, (B, M))], axis=2).astype(np.int32)).to(dev)
    pjmin = torch.from_numpy(rng.randint(0, T, (B, C, T, S), dtype=np.int32)).to(dev)
    for pidx in (broken, whole):
        pidx = torch.from_numpy(pidx).to(dev)
        tables = (pidx[:, :, 0].contiguous(),) if T == 1 else (pidx, pjmin)
        assert _walks_equal(T, tables, start, torch.from_numpy(die).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("T,K,B,M", [(1, 12, 3, 1), (1, 15, 10, 1), (4, 10, 2, 1), (4, 10, 2, 5)])
def test_backtraces_match_plain_where_few_slots_die(cuda_device, T, K, B, M):
    """Both backtrace kernels against their plain versions on forward tables
    of a bucket where 2 % of the slots die before each column (most columns
    free: at T = 1 the walk assumes the index carries over there)."""
    rng = np.random.RandomState(K + B)
    C, P = 160, 2 if T == 1 else 4
    arrays = blocks.to_device([
        rng.randint(0, 3, (B, C, K, T * P * 2)).astype(np.float32),
        rng.randint(0, 3, (B, C, T, P, 2)).astype(np.int32),
        rng.randint(0, 2, (B, C, K)).astype(np.float32),
        rng.randint(0, 2, (B, C, T, 1 << P)).astype(np.int32),
        rng.rand(B, C, K) < 0.02,
        rng.randint(0, 3, (B, C)).astype(np.int32),
    ], cuda_device)
    die = wmec_cuda.pack_die(arrays[4])
    assert float((die == 0).float().mean()) > 0.5
    if T == 1:
        pidx, dp, key = wmec_cuda.forward_t1(K, P, *arrays)
        assert _walks_equal(T, (pidx,), wmec_cuda._select_optimum(K, 1, dp, key)[2].contiguous(), die)
    else:
        pidx, pjmin, dp, jm, key = wmec_cuda.forward_t(K, T, P, *arrays)
        head = wmec_cuda._head_init(K, T, dp, jm, key)[1]
        assert _walks_equal(T, (pidx, pjmin), head[:, None].expand(B, M, 3).contiguous(), die)


@pytest.mark.cuda
def test_backtrace_t1_walks_4096_columns(cuda_device):
    """A single block's walk of 4096 columns (B = 1: one warp) against the
    plain walk, from the optimum."""
    arrays = blocks.to_device(_bucket(12, n_blocks=1, n_cols=4096, seed=5), cuda_device)
    pidx, dp, key = wmec_cuda.forward_t1(12, 2, *arrays)
    opt = wmec_cuda._select_optimum(12, 1, dp, key)[2].contiguous()
    assert _walks_equal(1, (pidx,), opt, wmec_cuda.pack_die(arrays[4]))


@pytest.mark.cuda
def test_route_on_cuda_matches_cpu(cuda_device):
    """PedigreeDPTable on the card, through both kernels, equals the CPU
    (plain torch) run: batched route and single-block route."""
    for n_blocks in (4, 1):
        rs, positions = _chromosome(n_blocks, 48, 8, seed=n_blocks)
        ped = _pedigree(len(positions))
        fwd, bt = wmec_cuda.forward_t1.launches, wmec_cuda.backtrace_t1.launches
        gpu = core.PedigreeDPTable(rs, [1] * len(positions), ped, False, positions)
        assert gpu.device.type == "cuda"
        assert wmec_cuda.forward_t1.launches > fwd and wmec_cuda.backtrace_t1.launches > bt
        cpu = core.PedigreeDPTable(rs, [1] * len(positions), ped, False, positions, device="cpu")
        assert gpu.get_optimal_cost() == cpu.get_optimal_cost()
        assert gpu.get_optimal_partitioning() == cpu.get_optimal_partitioning()
        assert np.array_equal(gpu._result.index_path, cpu._result.index_path)


@pytest.mark.cuda
def test_route_on_cuda_refuses_what_it_cannot_solve(cuda_device):
    """A pedigree beyond the kernels' envelope (six trios, T = 4096; six
    founders, P = 12), or K above it (24, past the wide T=1 kernel's 23),
    raises on CUDA instead of leaving the card, naming ROADMAP Queue 1 item
    5.  (Three trios, T = 64, and five, T = 1024, now run in the wide
    general-T kernel.)"""
    rs, positions = _chromosome(1, 12, 3, seed=1)
    for n_ind, trios in ((8, tuple((0, 1, c) for c in range(2, 8))), (8, ((0, 1, 6), (2, 3, 7)))):
        ped = _pedigree(len(positions), n_ind=n_ind, trios=trios)
        with pytest.raises(NotImplementedError, match="wider envelope, ROADMAP Queue 1 item 5"):
            core.PedigreeDPTable(rs, [1] * len(positions), ped, False, positions)
    k = wmec_cuda.MAX_K_WIDE + 1
    rs, positions = _chromosome(1, 40, k, seed=2)
    with pytest.raises(NotImplementedError, match="wider envelope"):
        core.PedigreeDPTable(rs, [1] * len(positions), _pedigree(len(positions)), False, positions)


TRIO = (3, ((0, 1, 2),))
QUARTET = (4, ((0, 1, 2), (0, 1, 3)))


def _pedigree_chromosome(n_blocks, n_cols, coverage, pedigree, seed):
    """A chromosome of `n_blocks` read-connected blocks whose reads come
    from every individual of `pedigree` at `coverage` each (synthetic
    haplotypes per individual: enough for parity, not for phasing quality).
    Returns (readset, positions, Pedigree)."""
    n_ind, trios = pedigree
    rs = core.ReadSet()
    for b in range(n_blocks):
        for ind in range(n_ind):
            sub, _pos, _hap = blocks.make_synthetic_readset(
                n_cols, coverage, read_len=6, seed=seed + 97 * b + ind
            )
            for read in sub:
                r = core.Read(f"b{b}_i{ind}_{read.name}", 50, 0, ind)
                for v in read:
                    r.add_variant(v.position + b * 10 * (n_cols + 10), v.allele, v.quality)
                rs.add(r)
    rs.sort()
    positions = rs.get_positions()
    return rs, positions, _pedigree(len(positions), n_ind, trios)


def _pedigree_bucket(K, T, n_blocks=3, n_cols=64, seed=0):
    """Stacked arrays of `n_blocks` single-range pedigree instances padded
    to K slots; block 0 has weights times 41."""
    pedigree = TRIO if T == 4 else QUARTET
    padded = []
    for b in range(n_blocks):
        rs, positions, ped = _pedigree_chromosome(1, n_cols - 8, max(1, K // pedigree[0]), pedigree, seed + b)
        p = wmec.pack_problem(rs, [3] * len(positions), ped, False, positions)
        padded.append(blocks.pad_block(p, n_cols, k_pad=max(K, p.K)))
    arrays = list(blocks.stack_blocks(padded))
    arrays[0][0] *= 41
    arrays[1][0] *= 41
    return arrays


@pytest.mark.cuda
@pytest.mark.parametrize("T,K", [
    (4, 1), (4, 4), (4, 7), (4, 9), (4, 12), (4, 13), (4, 15), (4, 16),
    (16, 1), (16, 7), (16, 9), (16, 10), (16, 11), (16, 13),
])
def test_pedigree_kernels_match_plain(cuda_device, T, K):
    """The general-T forward kernel (tables unseeded and seeded, m-only) and
    backtrace kernel (M = 1 and M = T + 1) against their plain versions, at
    the boundaries of the forward kernel's cluster layout (fewer than 32
    states, one CTA, the first cluster, the top of the envelope)."""
    P = 4
    arrays = _pedigree_bucket(K, T, seed=7 * K + T)
    K = arrays[0].shape[2]
    ta = blocks.to_device(arrays, cuda_device)
    B = arrays[0].shape[0]
    rng = np.random.RandomState(K)
    dp0_np = rng.randint(0, 300, size=(B, T)).astype(np.int32)
    dp0_np[rng.rand(B, T) < 0.3] = wmec.INF
    dp0 = torch.from_numpy(dp0_np).to(cuda_device)
    for seed in (None, dp0):
        kern = wmec_cuda.forward_t(K, T, P, *ta, seed)
        plain = wmec_cuda.forward_t_plain(K, T, P, *ta, seed)
        torch.cuda.synchronize()
        for x, y in zip(kern, plain):
            assert torch.equal(x, y)
    m = wmec_cuda.forward_m_t(K, T, P, *ta, dp0)
    assert torch.equal(m, wmec_cuda.forward_m_t_plain(K, T, P, *ta, dp0))
    pidx, pjmin, dp_last, jmin_last, key_last = kern
    _m, head = wmec_cuda._head_init(K, T, dp_last, jmin_last, key_last)
    S = 1 << K
    rand = torch.from_numpy(np.stack(
        [rng.randint(0, S, (B, T + 1)), rng.randint(0, T, (B, T + 1)), rng.randint(0, T, (B, T + 1))], axis=2
    ).astype(np.int32)).to(cuda_device)
    die = wmec_cuda.pack_die(ta[4])
    for init in (head[:, None].contiguous(), rand):
        out = wmec_cuda.backtrace_t(init, pidx, pjmin, die)
        ref = wmec_cuda.backtrace_t_plain(init, pidx, pjmin, die)
        torch.cuda.synchronize()
        for x, y in zip(out, ref):
            assert torch.equal(x, y)


def _tie_bucket(K, T, P, device, n_blocks=3, n_cols=48, seed=0):
    """Stacked block arrays at exactly K slots, drawn so that ties abound:
    weights, base costs, rankw and assignment costs in {0, 1},
    recombination costs in {0, 1, 2}, a quarter of the slots dying before
    each column (folds at every level of the cluster layout)."""
    rng = np.random.RandomState(seed)
    B, C = n_blocks, n_cols
    arrays = [
        rng.randint(0, 2, (B, C, K, T * P * 2)).astype(np.float32),
        rng.randint(0, 2, (B, C, T, P, 2)).astype(np.int32),
        rng.randint(0, 2, (B, C, K)).astype(np.float32),
        rng.randint(0, 2, (B, C, T, 1 << P)).astype(np.int32),
        rng.rand(B, C, K) < 0.25,
        rng.randint(0, 3, (B, C)).astype(np.int32),
    ]
    return blocks.to_device(arrays, device)


@pytest.mark.cuda
@pytest.mark.parametrize("T,K,P", [
    (4, 1, 4), (4, 4, 4), (4, 5, 4), (4, 9, 2), (4, 10, 4), (4, 13, 4), (4, 15, 4), (4, 16, 4),
    (16, 1, 4), (16, 9, 4), (16, 13, 2), (16, 13, 4),
])
def test_pedigree_kernels_break_ties_as_plain(cuda_device, T, K, P):
    """Every mode of the general-T forward kernel on a tie-heavy bucket:
    tables unseeded and seeded, m-only, carry and tables from that carry,
    bit-equal to the plain versions in pidx, pjmin, dp_last, jmin_last,
    key_last and m, so every fold, across lanes, warps, CTAs and loop bits,
    breaks its ties as the reference does."""
    ta = _tie_bucket(K, T, P, cuda_device, seed=100 * T + 10 * K + P)
    B = ta[0].shape[0]
    dp0 = torch.from_numpy(np.random.RandomState(K).randint(0, 2, (B, T)).astype(np.int32)).to(cuda_device)
    for seed in (None, dp0):
        kern = wmec_cuda.forward_t(K, T, P, *ta, seed)
        plain = wmec_cuda.forward_t_plain(K, T, P, *ta, seed)
        torch.cuda.synchronize()
        for x, y in zip(kern, plain):
            assert torch.equal(x, y)
    assert torch.equal(wmec_cuda.forward_m_t(K, T, P, *ta, dp0), wmec_cuda.forward_m_t_plain(K, T, P, *ta, dp0))
    head = [a[:, :16].contiguous() for a in ta]
    tail = [a[:, 16:].contiguous() for a in ta]
    carry = tuple(wmec_cuda.forward_t(K, T, P, *head)[2:])
    pairs = [
        (wmec_cuda.forward_carry_t(K, T, P, *tail, carry), wmec_cuda.forward_carry_t_plain(K, T, P, *tail, carry)),
        (wmec_cuda.forward_t(K, T, P, *tail, carry=carry), wmec_cuda.forward_t_plain(K, T, P, *tail, carry=carry)),
    ]
    torch.cuda.synchronize()
    for kern, plain in pairs:
        for x, y in zip(kern, plain):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("K,B", [(K, 3) for K in (1, 4, 5, 9, 10, 13, 14, 15, 16, 17)] + [
    (K, wmec_cuda.T1_WIDE_B + 1) for K in (11, 12, 13, 14, 15, 16, 17)
])
def test_t1_kernels_break_ties_as_plain(cuda_device, K, B):
    """Both modes of the T=1 forward kernel on a tie-heavy bucket, in its
    narrow layout (B = 3) and its wide one (B above T1_WIDE_B): tables from a
    zero state, carry, and tables from that nonzero carry, bit-equal to the
    plain versions in pidx, dp_last and key_last, so every fold, across
    lanes, warps, CTAs and loop bits, breaks its ties as the reference
    does."""
    ta = _tie_bucket(K, 1, 2, cuda_device, n_blocks=B, n_cols=48 if B < 8 else 24, seed=10 * K + B)
    kern = wmec_cuda.forward_t1(K, 2, *ta)
    plain = wmec_cuda.forward_t1_plain(K, 2, *ta)
    head = [a[:, :12].contiguous() for a in ta]
    tail = [a[:, 12:].contiguous() for a in ta]
    carry = wmec_cuda.forward_t1(K, 2, *head)[1:]
    pairs = [
        (kern, plain),
        (wmec_cuda.forward_carry_t1(K, 2, *tail, carry), wmec_cuda.forward_carry_t1_plain(K, 2, *tail, carry)),
        (wmec_cuda.forward_t1(K, 2, *tail, carry=carry), wmec_cuda.forward_t1_plain(K, 2, *tail, carry)),
    ]
    torch.cuda.synchronize()
    assert bool((carry[0] != 0).any())
    for kern, plain in pairs:
        for x, y in zip(kern, plain):
            assert torch.equal(x, y)


WIDE = (wmec_cuda.forward_t1_wide, wmec_cuda.forward_carry_t1_wide)
CLUSTER_T1 = (wmec_cuda.forward_t1, wmec_cuda.forward_carry_t1)


def _wide_pairs(K, ta, head_cols):
    """(kernel outputs, plain outputs) of the T=1 forward wrappers over a
    bucket: tables from a zero state, carry mode and tables from that
    nonzero carry (the state after the first head_cols columns)."""
    head = [a[:, :head_cols].contiguous() for a in ta]
    tail = [a[:, head_cols:].contiguous() for a in ta]
    carry = wmec_cuda.forward_t1(K, 2, *head)[1:]
    assert bool((carry[0] != 0).any())
    return [
        (wmec_cuda.forward_t1(K, 2, *ta), wmec_cuda.forward_t1_plain(K, 2, *ta)),
        (wmec_cuda.forward_carry_t1(K, 2, *tail, carry), wmec_cuda.forward_carry_t1_plain(K, 2, *tail, carry)),
        (wmec_cuda.forward_t1(K, 2, *tail, carry=carry), wmec_cuda.forward_t1_plain(K, 2, *tail, carry)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [18, 19, 20, 21])
def test_wide_kernel_matches_plain(cuda_device, K):
    """Past the cluster kernel's ceiling forward_t1 and forward_carry_t1
    hand the block to the wide kernel (csrc/wmec_forward_t1_wide.cu, the
    state in device memory): tables from zero, carry and tables from a
    nonzero carry, bit-equal to the plain versions, the backtrace over its
    tables equal to the plain walk; only the wide kernel's counters count."""
    ta = blocks.to_device(_bucket(K, n_blocks=2, n_cols=40, seed=30 * K), cuda_device)
    K = ta[0].shape[2]
    before = [f.launches for f in WIDE + CLUSTER_T1]
    pairs = _wide_pairs(K, ta, 12)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(WIDE + CLUSTER_T1, before)] == [3, 1, 0, 0]
    for kern, plain in pairs:
        for x, y in zip(kern, plain):
            assert torch.equal(x, y)
    pidx, dp, key = pairs[0][0]
    opt = wmec_cuda._select_optimum(K, 1, dp, key)[2].contiguous()
    assert _walks_equal(1, (pidx,), opt, wmec_cuda.pack_die(ta[4]))


def _wide_edge_bucket(case, device):
    """(K, arrays, head columns) of a T = 1 bucket at an edge of the wide
    kernel's layout: its L2 sweep's last group cut short (B one past a
    multiple of the group at K = 20), one block at K = 22 and 23, windows
    of several columns on a tie-heavy bucket (one slot in 20 dying a
    column), blocks whose dying masks differ in one column only, and a
    column where 13 or more slots die (more than a tile's 12 bits: a
    pre-pass) at K = 20 and 23."""
    K = int(case[-2:])
    if case in ("group-boundary-k20", "one-block-k22", "one-block-k23"):
        B = wmec_cuda.forward_t1_wide_group(K, 1 << 10) + 1 if case.startswith("group") else 1
        ta = blocks.to_device(_bucket(K, n_blocks=B, n_cols=16, seed=60 + K), device)
        assert ta[0].shape[2] == K
        return K, ta, 6
    if case.startswith("windows"):
        ta = _tie_bucket(K, 1, 2, device, n_blocks=2, n_cols=24, seed=80 + K)
        die = torch.from_numpy(np.random.RandomState(K).rand(2, 24, K) < 0.05).to(device)
        return K, [*ta[:4], die, ta[5]], 8
    B = 3 if case.startswith("masks") else 2
    ta = _tie_bucket(K, 1, 2, device, n_blocks=B, n_cols=12, seed=70 + K + B)
    die = ta[4].clone()
    if case.startswith("masks"):
        die[:] = die[0].clone()
        die[1, 7] = ~die[1, 7]
        die[2, 7, :3] = True
    else:
        die[0, 2, : K - 4] = True
        die[1, 2, 4:17] = True
        die[:, 8, :13] = True
    assert int(die.sum(dim=2).max()) >= 13 or case.startswith("masks")
    return K, [*ta[:4], die.contiguous(), ta[5]], 4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["group-boundary-k20", "one-block-k22", "one-block-k23", "windows-k20",
                                  "windows-k23", "masks-differ-k20", "pre-pass-k20", "pre-pass-k23"])
def test_wide_kernel_edges_match_plain(cuda_device, case):
    """The wide kernel at the edges of its layout (_wide_edge_bucket):
    tables from zero, carry, and tables from a nonzero carry, bit-equal to
    the plain versions, and only the wide kernel's counters count."""
    K, ta, head_cols = _wide_edge_bucket(case, cuda_device)
    before = [f.launches for f in WIDE + CLUSTER_T1]
    pairs = _wide_pairs(K, ta, head_cols)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(WIDE + CLUSTER_T1, before)] == [3, 1, 0, 0]
    for kern, plain in pairs:
        for x, y in zip(kern, plain):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_wide_kernel_group_rule_matches_its_mirror(cuda_device):
    """wmec_cuda.forward_t1_wide_group is the kernel's own rule for the
    blocks of a group of its L2 sweep, at every K it takes."""
    from whatshap_torch.ops import _build

    fn = _build.load("wmec_forward_t1_wide").wmec_forward_t1_wide_group
    for K in range(1, wmec_cuda.MAX_K_WIDE + 1):
        for B in (1, 2, 5, 7, 19, 64, 1 << 20):
            assert fn(K, B) == wmec_cuda.forward_t1_wide_group(K, B)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [18, 19, 20, 21])
def test_wide_kernel_breaks_ties_as_plain(cuda_device, K):
    """The wide kernel's folds on a tie-heavy bucket (a quarter of the slots
    dying a column: several passes a column where more than four die, pairs
    across thread blocks of the grid) break their ties as the plain
    versions do, in both modes, from zero and from a carry."""
    ta = _tie_bucket(K, 1, 2, cuda_device, n_blocks=3, n_cols=24, seed=40 * K)
    pairs = _wide_pairs(K, ta, 8)
    torch.cuda.synchronize()
    for kern, plain in pairs:
        for x, y in zip(kern, plain):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4, 5, 9, 12, 13, 16, 17])
def test_wide_kernel_matches_cluster_kernel(cuda_device, K):
    """Inside the cluster kernel's envelope the wide kernel computes the
    same function: both modes, from zero and from a carry, on a tie-heavy
    bucket, bit-equal to csrc/wmec_forward_t1.cu."""
    ta = _tie_bucket(K, 1, 2, cuda_device, n_blocks=3, n_cols=32, seed=50 * K)
    head = [a[:, :10].contiguous() for a in ta]
    tail = [a[:, 10:].contiguous() for a in ta]
    carry = wmec_cuda.forward_t1(K, 2, *head)[1:]
    pairs = [
        (wmec_cuda.forward_t1_wide(K, 2, *ta), wmec_cuda.forward_t1(K, 2, *ta)),
        (wmec_cuda.forward_carry_t1_wide(K, 2, *tail, carry), wmec_cuda.forward_carry_t1(K, 2, *tail, carry)),
        (wmec_cuda.forward_t1_wide(K, 2, *tail, carry), wmec_cuda.forward_t1(K, 2, *tail, carry=carry)),
    ]
    torch.cuda.synchronize()
    for wide, cluster in pairs:
        for x, y in zip(wide, cluster):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_wide_route_on_cuda_matches_cpu(cuda_device):
    """PedigreeDPTable at K = 20 on the card (the batched route over several
    ranges, and one range) runs the wide kernel and the backtrace, never the
    cluster kernel, and equals the CPU run."""
    for n_blocks in (3, 1):
        rs, positions = _chromosome(n_blocks, 40, 20, seed=n_blocks)
        ped = _pedigree(len(positions))
        before = [f.launches for f in WIDE + CLUSTER_T1 + (wmec_cuda.backtrace_t1,)]
        gpu = core.PedigreeDPTable(rs, [1] * len(positions), ped, False, positions)
        launched = [f.launches - b for f, b in zip(WIDE + CLUSTER_T1 + (wmec_cuda.backtrace_t1,), before)]
        assert gpu._packed.K == 20 and launched[0] > 0 and launched[4] > 0 and launched[1:4] == [0, 0, 0]
        cpu = core.PedigreeDPTable(rs, [1] * len(positions), ped, False, positions, device="cpu")
        assert gpu.get_optimal_cost() == cpu.get_optimal_cost()
        assert gpu.get_optimal_partitioning() == cpu.get_optimal_partitioning()
        assert np.array_equal(gpu._result.index_path, cpu._result.index_path)


@pytest.mark.cuda
def test_wide_route_on_cuda_never_runs_the_plain_versions(cuda_device, monkeypatch):
    """With every plain version made to raise, K = 20 still phases on the
    card, batched and as one range, and a range past the (patched) table
    budget takes the segmented solve in the wide kernel's two modes (XLA
    route segments of 64 columns) and equals the unsegmented run."""

    def refuse(*_args, **_kw):
        raise AssertionError("a plain version ran on the CUDA route")

    rs, positions = _chromosome(1, 100, 20, seed=4)
    ped = _pedigree(len(positions))
    whole = core.PedigreeDPTable(rs, [1] * len(positions), ped, False, positions)
    for mod, name in [
        (wmec, "forward_scan"), (wmec, "solve_batched"), (wmec, "_backtrace_from"),
        (wmec, "forward_carry"), (wmec, "forward_tables"), (wmec, "walk_segment"),
        (wmec_cuda, "forward_t1_plain"), (wmec_cuda, "forward_carry_t1_plain"),
        (wmec_cuda, "backtrace_t1_plain"),
    ]:
        monkeypatch.setattr(mod, name, refuse)
    for n_blocks in (3, 1):
        rs_b, pos_b = _chromosome(n_blocks, 40, 20, seed=5 + n_blocks)
        table = core.PedigreeDPTable(rs_b, [1] * len(pos_b), _pedigree(len(pos_b)), False, pos_b)
        assert len(table.get_super_reads()[1]) == len(pos_b)
    packed = whole._packed
    tables = wmec._next_pow2(packed.n_cols) * wmec._table_bytes_per_col(packed.K, 1)
    monkeypatch.setattr(wmec, "_table_budget", lambda device: tables * 3 // 4)
    assert wmec._single_range_segment(packed.n_cols, packed.K, 1, cuda_device) == 64
    before = [f.launches for f in WIDE + (wmec_cuda.backtrace_t1,)]
    seg = core.PedigreeDPTable(rs, [1] * len(positions), ped, False, positions)
    assert [f.launches - b for f, b in zip(WIDE + (wmec_cuda.backtrace_t1,), before)] == [2, 2, 2]
    assert seg.get_optimal_cost() == whole.get_optimal_cost()
    assert seg.get_optimal_partitioning() == whole.get_optimal_partitioning()
    assert np.array_equal(seg._result.index_path, whole._result.index_path)


@pytest.mark.cuda
@pytest.mark.parametrize("pedigree", [TRIO, QUARTET])
def test_pedigree_route_on_cuda_matches_cpu(cuda_device, pedigree):
    """A trio and a quartet through PedigreeDPTable on the card, through the
    three general-T kernels, equal the CPU run: multi-range and one range."""
    for n_blocks in (4, 1):
        rs, positions, ped = _pedigree_chromosome(n_blocks, 40, 3, pedigree, seed=n_blocks)
        rc = [5] * len(positions)
        counters = [wmec_cuda.forward_t, wmec_cuda.forward_m_t, wmec_cuda.backtrace_t]
        before = [f.launches for f in counters]
        gpu = core.PedigreeDPTable(rs, rc, ped, False, positions)
        after = [f.launches for f in counters]
        assert gpu.device.type == "cuda"
        assert after[0] > before[0] and after[2] > before[2]
        assert (after[1] > before[1]) == (n_blocks > 1)
        cpu = core.PedigreeDPTable(rs, rc, ped, False, positions, device="cpu")
        assert gpu.get_optimal_cost() == cpu.get_optimal_cost()
        assert gpu.get_optimal_partitioning() == cpu.get_optimal_partitioning()
        assert np.array_equal(gpu._result.index_path, cpu._result.index_path)
        assert np.array_equal(gpu._result.trans_path, cpu._result.trans_path)


@pytest.mark.cuda
def test_pedigree_route_on_cuda_never_runs_the_plain_versions(cuda_device, monkeypatch):
    """With every plain version made to raise, a trio still phases on the
    card: nothing on the CUDA route falls back to them."""

    def refuse(*_args, **_kw):
        raise AssertionError("a plain version ran on the CUDA route")

    for mod, name in [
        (wmec, "forward_scan"), (wmec, "solve_batched"), (wmec, "forward_m_batched"),
        (wmec, "solve_seeded_batched"), (wmec, "_backtrace_from"),
        (wmec_cuda, "forward_t_plain"), (wmec_cuda, "forward_m_t_plain"),
        (wmec_cuda, "backtrace_t_plain"), (wmec_cuda, "forward_t1_plain"),
        (wmec_cuda, "backtrace_t1_plain"),
    ]:
        monkeypatch.setattr(mod, name, refuse)
    for n_blocks in (3, 1):
        rs, positions, ped = _pedigree_chromosome(n_blocks, 40, 3, TRIO, seed=11)
        table = core.PedigreeDPTable(rs, [5] * len(positions), ped, False, positions)
        assert len(table.get_super_reads()[1]) == len(positions)


WIDE_T = (wmec_cuda.forward_t_wide, wmec_cuda.forward_m_t_wide, wmec_cuda.forward_carry_t_wide)
CLUSTER_T = (wmec_cuda.forward_t, wmec_cuda.forward_m_t, wmec_cuda.forward_carry_t)
DOUBLE_TRIO = (5, ((0, 1, 2), (2, 3, 4)))  # three founders: P = 6, T = 16
FAMILY5 = (5, ((0, 1, 2), (0, 1, 3), (0, 1, 4)))  # three children: T = 64
FAMILY7 = (7, tuple((0, 1, c) for c in range(2, 7)))  # five children: T = 1024, P = 4
# two grandparent couples, their two children, an in-law and two
# grandchildren: four trios of five founders, T = 256, P = 10
FIVE_FOUNDERS = (9, ((0, 1, 4), (2, 3, 5), (4, 5, 7), (4, 6, 8)))


def _t_pairs(first, second, K, T, P, ta, dp0, head_cols):
    """Pairs of outputs of two sets of general-T forward wrappers over a
    bucket, each set (tables, m-only, carry): tables from zero and from the
    seed dp0, m-only from dp0, carry and tables from that nonzero carry (the
    state after the first head_cols columns, from the first set)."""
    head = [a[:, :head_cols].contiguous() for a in ta]
    tail = [a[:, head_cols:].contiguous() for a in ta]
    carry = first[0](K, T, P, *head)[2:]
    assert bool((carry[0] != 0).any())
    return [
        tuple(t(K, T, P, *ta) for t, _m, _c in (first, second)),
        tuple(t(K, T, P, *ta, dp0) for t, _m, _c in (first, second)),
        tuple([m(K, T, P, *ta, dp0)] for _t, m, _c in (first, second)),
        tuple(c(K, T, P, *tail, carry) for _t, _m, c in (first, second)),
        tuple(t(K, T, P, *tail, carry=carry) for t, _m, _c in (first, second)),
    ]


PLAIN_T = (wmec_cuda.forward_t_plain, wmec_cuda.forward_m_t_plain, wmec_cuda.forward_carry_t_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("T,K,P", [
    (4, 1, 2), (4, 17, 4), (4, 20, 4), (16, 9, 6), (16, 14, 4), (16, 12, 8),
    (64, 5, 4), (64, 12, 4), (64, 15, 4), (256, 3, 8), (256, 9, 4),
    (1024, 1, 4), (1024, 6, 4), (1024, 5, 10), (256, 7, 10), (16, 9, 10), (4, 10, 10),
])
def test_wide_t_kernel_breaks_ties_as_plain(cuda_device, T, K, P):
    """Row 14, the general-T kernel with its T planes in device memory
    (csrc/wmec_forward_t_wide.cu), on a tie-heavy bucket (a quarter of the
    slots dying a column) from seeds with INF entries: tables from zero and
    seeded, m-only, carry and tables from a carry, bit-equal to the plain
    versions; the head walk and T + 1 random walks over its tables (T up to
    1024: 1,025 walks a block) equal the plain walk; only the wide kernel's
    counters count.  Five trios (T = 1024) and five founders (P = 10) at
    each T included."""
    ta = _tie_bucket(K, T, P, cuda_device, n_blocks=2, n_cols=20, seed=60 * T + K + P)
    rng = np.random.RandomState(K + T)
    dp0_np = rng.randint(0, 3, (2, T)).astype(np.int32)
    dp0_np[rng.rand(2, T) < 0.3] = wmec.INF
    dp0 = torch.from_numpy(dp0_np).to(cuda_device)
    before = [f.launches for f in WIDE_T + CLUSTER_T]
    pairs = _t_pairs(WIDE_T, PLAIN_T, K, T, P, ta, dp0, 6)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(WIDE_T + CLUSTER_T, before)] == [4, 1, 1, 0, 0, 0]
    for kern, plain in pairs:
        for x, y in zip(kern, plain):
            assert torch.equal(x, y)
    pidx, pjmin, dp_last, jmin_last, key_last = pairs[0][0]
    _m, head = wmec_cuda._head_init(K, T, dp_last, jmin_last, key_last)
    rand = torch.from_numpy(np.stack(
        [rng.randint(0, 1 << K, (2, T + 1)), rng.randint(0, T, (2, T + 1)), rng.randint(0, T, (2, T + 1))], axis=2
    ).astype(np.int32)).to(cuda_device)
    die = wmec_cuda.pack_die(ta[4])
    for init in (head[:, None].contiguous(), rand):
        assert _walks_equal(T, (pidx, pjmin), init, die)


@pytest.mark.cuda
@pytest.mark.parametrize("T,K,P", [(4, 18, 2), (16, 14, 6), (64, 12, 4), (64, 9, 8), (256, 12, 2), (256, 6, 8),
                                   (1024, 6, 4), (1024, 5, 10)])
def test_wide_t_kernel_pre_passes_match_plain(cuda_device, T, K, P):
    """Row 14 where more slots die in a column than its tile holds (4096 / T
    states: 10 tile bits at T = 4, 8 at 16, 6 at 64, 4 at 256, 2 at 1024): two thirds
    of the slots die before each column, so the kernel folds the lowest in
    pre-passes (two at T = 256, K = 12) before the column's tile pass;
    every mode on a tie-heavy bucket equals the plain versions."""
    ta = _tie_bucket(K, T, P, cuda_device, n_blocks=2, n_cols=12, seed=90 * T + K + P)
    die = torch.from_numpy(np.random.RandomState(K * T).rand(2, 12, K) < 0.67).to(cuda_device)
    lb = (4096 // T).bit_length() - 1
    assert int(die.sum(dim=2).max()) > lb  # a pre-pass in some column
    ta = [*ta[:4], die, ta[5]]
    rng = np.random.RandomState(K + T)
    dp0_np = rng.randint(0, 3, (2, T)).astype(np.int32)
    dp0_np[rng.rand(2, T) < 0.3] = wmec.INF
    dp0 = torch.from_numpy(dp0_np).to(cuda_device)
    pairs = _t_pairs(WIDE_T, PLAIN_T, K, T, P, ta, dp0, 4)
    torch.cuda.synchronize()
    for kern, plain in pairs:
        for x, y in zip(kern, plain):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 2, 16])
@pytest.mark.parametrize("T,K,P", [(4, 17, 4), (16, 9, 6), (64, 8, 4), (64, 6, 8), (256, 5, 2), (1024, 5, 4),
                                   (64, 4, 10)])
def test_wide_t_grouped_m_matches_plain(cuda_device, T, K, P, R):
    """Row 14's m-only mode with R seeds a block (B, R, T), one launch over
    the blocks' inputs, against the plain version (each seed a copy of its
    block) on a tie-heavy bucket whose columns reach the pre-passes, from
    seeds with INF entries; one launch counted, of the wide kernel."""
    B = 2
    ta = _tie_bucket(K, T, P, cuda_device, n_blocks=B, n_cols=10, seed=80 * T + K + P + R)
    die = torch.from_numpy(np.random.RandomState(K + R).rand(B, 10, K) < 0.5).to(cuda_device)
    ta = [*ta[:4], die, ta[5]]
    rng = np.random.RandomState(T + R)
    seeds = rng.randint(0, 5, (B, R, T)).astype(np.int32)
    seeds[rng.rand(B, R, T) < 0.4] = wmec.INF
    seeds[:, 0] = wmec.INF
    seeds[:, 0, T // 2] = 0
    dp0 = torch.from_numpy(seeds).to(cuda_device)
    before = [f.launches for f in WIDE_T + CLUSTER_T]
    m = wmec_cuda.forward_m_t(K, T, P, *ta, dp0)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(WIDE_T + CLUSTER_T, before)] == [0, 1, 0, 0, 0, 0]
    assert m.shape == (B, R, T) and torch.equal(m, wmec_cuda.forward_m_t_plain(K, T, P, *ta, dp0))
    assert torch.equal(m[:, :1], wmec_cuda.forward_m_t_wide(K, T, P, *ta, dp0[:, :1].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("T,K", [(4, 1), (4, 9), (4, 12), (4, 16), (16, 5), (16, 13)])
def test_wide_t_kernel_matches_cluster_kernel(cuda_device, T, K):
    """Inside the cluster kernel's envelope (kernel rows 3, 4, 6, 7, 9, 10)
    the wide general-T kernel computes the same function: every mode on a
    tie-heavy bucket, bit-equal to csrc/wmec_forward_t.cu."""
    P = 4
    ta = _tie_bucket(K, T, P, cuda_device, n_blocks=3, n_cols=24, seed=70 * T + K)
    dp0 = torch.from_numpy(np.random.RandomState(K).randint(0, 3, (3, T)).astype(np.int32)).to(cuda_device)
    pairs = _t_pairs(WIDE_T, CLUSTER_T, K, T, P, ta, dp0, 8)
    torch.cuda.synchronize()
    for wide, cluster in pairs:
        for x, y in zip(wide, cluster):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("pedigree", [DOUBLE_TRIO, FAMILY5], ids=["doubletrio", "family5"])
def test_wide_t_route_on_cuda_matches_cpu(cuda_device, pedigree, monkeypatch):
    """A three-generation pedigree with three founders (P = 6, T = 16) and a
    family of three children (T = 64) through PedigreeDPTable on the card,
    several ranges (the seam route) and one range, with every plain version
    made to raise: the wide general-T kernel and the backtrace launch,
    nothing falls back, and the result equals the CPU run."""

    def refuse(*_args, **_kw):
        raise AssertionError("a plain version ran on the CUDA route")

    for n_blocks in (3, 1):
        rs, positions, ped = _pedigree_chromosome(n_blocks, 30, 1, pedigree, seed=20 + n_blocks)
        rc = [5] * len(positions)
        before = [f.launches for f in WIDE_T + (wmec_cuda.backtrace_t,)]
        with monkeypatch.context() as m:
            for mod, name in [
                (wmec, "forward_scan"), (wmec, "solve_batched"), (wmec, "forward_m_batched"),
                (wmec, "solve_seeded_batched"), (wmec, "_backtrace_from"),
                (wmec_cuda, "forward_t_plain"), (wmec_cuda, "forward_m_t_plain"),
                (wmec_cuda, "backtrace_t_plain"),
            ]:
                m.setattr(mod, name, refuse)
            gpu = core.PedigreeDPTable(rs, rc, ped, False, positions)
        launched = [f.launches - b for f, b in zip(WIDE_T + (wmec_cuda.backtrace_t,), before)]
        assert not wmec_cuda.cluster_supported(gpu._packed.K, gpu._packed.T, gpu._packed.P)
        assert launched[0] > 0 and launched[3] > 0 and (launched[1] > 0) == (n_blocks > 1)
        cpu = core.PedigreeDPTable(rs, rc, ped, False, positions, device="cpu")
        assert gpu.get_optimal_cost() == cpu.get_optimal_cost()
        assert gpu.get_optimal_partitioning() == cpu.get_optimal_partitioning()
        assert np.array_equal(gpu._result.index_path, cpu._result.index_path)
        assert np.array_equal(gpu._result.trans_path, cpu._result.trans_path)


@pytest.mark.cuda
@pytest.mark.parametrize("pedigree", [FAMILY7, FIVE_FOUNDERS], ids=["family7", "five-founders"])
def test_five_trios_or_founders_route_on_cuda(cuda_device, pedigree, monkeypatch):
    """A family of five children (T = 1024) and a pedigree of five founders
    (P = 10) through PedigreeDPTable on the card, with every plain version
    made to raise: several ranges (the seam route: pass 1 over the coset
    seeds, 256 and 8 a block, pass 2's T + 1 walks a block) equal the same
    route with the plain versions handed in, run on the card; one range
    equals the CPU."""

    def refuse(*_args, **_kw):
        raise AssertionError("a plain version ran on the CUDA route")

    for n_blocks in (2, 1):
        rs, positions, ped = _pedigree_chromosome(n_blocks, 14, 1, pedigree, seed=30 + n_blocks)
        rc = [5] * len(positions)
        before = [f.launches for f in WIDE_T + (wmec_cuda.backtrace_t,)]
        with monkeypatch.context() as m:
            for mod, name in [
                (wmec, "forward_scan"), (wmec, "solve_batched"), (wmec, "forward_m_batched"),
                (wmec, "solve_seeded_batched"), (wmec, "_backtrace_from"),
                (wmec_cuda, "forward_t_plain"), (wmec_cuda, "forward_m_t_plain"),
                (wmec_cuda, "backtrace_t_plain"),
            ]:
                m.setattr(mod, name, refuse)
            gpu = core.PedigreeDPTable(rs, rc, ped, False, positions)
        launched = [f.launches - b for f, b in zip(WIDE_T + (wmec_cuda.backtrace_t,), before)]
        packed = gpu._packed
        assert (packed.T, packed.P) == {7: (1024, 4), 9: (256, 10)}[pedigree[0]]
        assert launched[0] > 0 and launched[3] > 0 and (launched[1] > 0) == (n_blocks > 1)
        if n_blocks > 1:
            assert len(wmec.connected_column_ranges(packed)) > 1
            want = wmec.run_dp(packed, cuda_device, wmec.solve_batched, wmec.forward_m_batched,
                               wmec.solve_seeded_batched, wmec.solve_segmented)
        else:
            want = wmec.run_dp(packed, "cpu")
        assert gpu._result.optimal_cost == want.optimal_cost
        assert np.array_equal(gpu._result.index_path, want.index_path)
        assert np.array_equal(gpu._result.trans_path, want.trans_path)


@pytest.mark.cuda
def test_pass_1_seed_split_on_cuda_matches_one_launch(cuda_device, monkeypatch):
    """Pass 1 (forward_m_auto) at five children (T = 1024) with the table
    budget pinned below one block's seed planes: the seeds go in launches of
    three (the wide m-only kernel counted once a launch), and m equals the
    unsplit launch's at the card's budget."""
    K, T, P, B, R = 5, 1024, 4, 2, 8
    ta = _tie_bucket(K, T, P, cuda_device, n_blocks=B, n_cols=12, seed=77)
    rng = np.random.RandomState(78)
    seeds = np.full((B, R, T), wmec.INF, dtype=np.int32)
    seeds[:, np.arange(R), rng.choice(T, R, replace=False)] = 0
    dp0 = torch.from_numpy(seeds).to(cuda_device)
    whole = wmec.forward_m_auto(K, T, P, *ta, dp0)
    per_seed = wmec_cuda.state_bytes(K, T, P, seeds=1)
    monkeypatch.setattr(wmec, "_table_budget", lambda device: 3 * B * per_seed)
    before = wmec_cuda.forward_m_t_wide.launches
    split = wmec.forward_m_auto(K, T, P, *ta, dp0)
    torch.cuda.synchronize()
    assert wmec_cuda.forward_m_t_wide.launches - before == 3
    assert torch.equal(split, whole) and split.shape == (B, R, T)


@pytest.mark.cuda
def test_geno_wide_kernels_match_plain_at_five_trios_and_founders(cuda_device):
    """Both wide genotyping kernels at five trios of five founders (T =
    1024, P = 10: a tile of 4 states in each of 1,024 planes, 1,024
    assignments a state and plane), K = 6, against their float32 plain
    versions (chip_smoke.geno_bucket: a zero-sum prior column in instance
    0, a new range with all its slots born in instance 1); the forward's
    partial rows of red (4 MiB a CTA) hold the launch to
    genotyping_cuda.wide_red_rows."""
    import chip_smoke
    from whatshap_torch.ops import genotyping, genotyping_cuda

    P, stacked = chip_smoke.geno_bucket(1024, 6, 2, 20, 910, pedigree=chip_smoke.FIVE_BY_FIVE,
                                        coverage=chip_smoke._lanes(6, 10), break_block=1)
    assert P == 10 and genotyping_cuda.wide_max_ctas(cuda_device, 2, 6, 1024, P) < genotyping_cuda.wide_red_rows(1024, P)
    diff, base, passign, trans, birth, die_next, dup = genotyping.to_device(stacked, cuda_device)
    beta, scaling = genotyping_cuda.backward(6, 1024, P, diff, base, passign, trans, birth, dup)
    red = genotyping_cuda.forward(6, 1024, P, diff, base, passign, trans, die_next, scaling, beta)
    beta_p, scaling_p = genotyping_cuda.backward_plain(6, 1024, P, diff, base, passign, trans, birth, dup)
    red_p = genotyping_cuda.forward_plain(6, 1024, P, diff, base, passign, trans, die_next, scaling_p, beta_p)
    torch.cuda.synchronize()
    _geno_close((beta, scaling, red), (beta_p, scaling_p, red_p))


def _geno_instance(n_cols, coverage, n_ind, trios, seed, zero_prior=None, break_at=None, error=None):
    """A genotyping instance whose reads tile the columns in `coverage`
    lanes per individual (so K = coverage * n_ind), random priors; with
    zero_prior = c the first individual's prior at column c is all 0; with
    break_at = c no read spans columns c - 1 and c (a new range starts at c
    with all its slots born).  The alleles are random, or with `error` each
    read's haplotype (one of its individual's two random ones) with that
    rate of allele errors.  Returns (readset, positions, pedigree, numeric
    sample ids)."""
    rng = np.random.RandomState(seed)
    haps = rng.randint(0, 2, size=(n_ind, 2, n_cols)) if error is not None else None
    positions = ((np.arange(n_cols) + 1) * 10).tolist()
    rs = core.ReadSet()
    for ind in range(n_ind):
        for lane in range(coverage):
            start = 0
            while start < n_cols - 1:
                end = break_at if break_at is not None and start < break_at else n_cols
                if end - start < 2:
                    start = end
                    continue
                length = int(np.clip(rng.poisson(6), 2, end - start))
                read = core.Read(f"i{ind}_l{lane}_{start}", 50, 0, ind)
                side = int(rng.randint(0, 2)) if haps is not None else 0
                for c in range(start, start + length):
                    allele = int(rng.randint(0, 2)) if haps is None else int(haps[ind, side, c] ^ (rng.rand() < error))
                    read.add_variant(positions[c], allele, int(rng.randint(5, 40)))
                rs.add(read)
                start += length
    rs.sort()
    nsi = core.NumericSampleIds()
    ped = core.Pedigree(nsi)
    for ind in range(n_ind):
        gls = rng.rand(n_cols, 3) + 0.01
        gls /= gls.sum(axis=1, keepdims=True)
        if ind == 0 and zero_prior is not None:
            gls[zero_prior] = 0.0
        ped.add_individual(
            f"ind{ind}", [core.Genotype([])] * n_cols,
            [core.PhredGenotypeLikelihoods(list(g)) for g in gls],
        )
    for f, m, c in trios:
        ped.add_relationship(f"ind{f}", f"ind{m}", f"ind{c}")
    return rs, positions, ped, nsi


def _rel_close(x, y, rtol):
    """x and y have the same NaN pattern and agree within rtol elsewhere."""
    x, y = x.double().cpu(), y.double().cpu()
    nan = torch.isnan(y)
    assert torch.equal(nan, torch.isnan(x))
    assert bool(((x - y).abs() <= rtol * y.abs() + 1e-30)[~nan].all())


GENO_PEDIGREES = {1: (1, ()), 4: TRIO, 16: QUARTET}


ALL_LEVELS = {"register", "lane", "warp", "cta", "top"}


@pytest.mark.cuda
@pytest.mark.parametrize("T,coverage", [
    (1, 3), (1, 7), (1, 10), (1, 12), (1, 13), (1, 14), (1, 15), (1, 16), (1, 17),
    (4, 2), (4, 4), (4, 5), (16, 2), (16, 3),
])
def test_geno_kernels_match_plain(cuda_device, T, coverage):
    """Both genotyping kernels against their float32 plain versions on the
    same CUDA tensors, over the cluster layouts: one CTA with idle lanes
    (K = 3), one CTA (K = 7), two CTAs (K = 10), eight (K = 12), 16 with no
    register bits (K = 13) and with 1 to 4 (K = 14 to 17: folds at every
    level of the state index, the top CTA-rank bit included from K = 15);
    instance 0 has a zero-sum prior column, whose NaN fills its instance and
    no other."""
    from whatshap_torch.ops import genotyping, genotyping_cuda

    n_ind, trios = GENO_PEDIGREES[T]
    parts = []
    for b in range(3):
        rs, positions, ped, _nsi = _geno_instance(48, coverage, n_ind, trios, 100 * T + 10 * coverage + b,
                                                  zero_prior=20 if b == 0 else None)
        packed = wmec.pack_problem(rs, [7] * 48, ped, False, positions,
                                   check_conflicts=False, emission_tables=False)
        (K, T_, P, _n), stacked = genotyping.prepare_genotyping_batch([packed], ped)
        assert T_ == T and K == coverage * n_ind
        parts.append(stacked)
    stacked = [np.concatenate(xs) for xs in zip(*parts)]
    diff, base, passign, trans, birth, die_next, dup = genotyping.to_device(stacked, cuda_device)
    if K >= 15:
        assert genotyping_cuda.fold_levels(K, birth) == ALL_LEVELS
        assert genotyping_cuda.fold_levels(K, die_next) == ALL_LEVELS
    before = (genotyping_cuda.backward.launches, genotyping_cuda.forward.launches)
    beta, scaling = genotyping_cuda.backward(K, T, P, diff, base, passign, trans, birth, dup)
    red = genotyping_cuda.forward(K, T, P, diff, base, passign, trans, die_next, scaling, beta)
    assert (genotyping_cuda.backward.launches, genotyping_cuda.forward.launches) == (before[0] + 1, before[1] + 1)
    beta_p, scaling_p = genotyping_cuda.backward_plain(K, T, P, diff, base, passign, trans, birth, dup)
    red_p = genotyping_cuda.forward_plain(K, T, P, diff, base, passign, trans, die_next, scaling_p, beta_p)
    torch.cuda.synchronize()
    for x, y in ((scaling, scaling_p), (red, red_p)):
        _rel_close(x, y, 1e-4)
    # beta entries far below their column's largest carry the rounding of
    # their large negative log-emissions; they are held to 1e-4 of that
    assert torch.equal(beta.isnan(), beta_p.isnan())
    col_max = beta_p.flatten(2).amax(dim=2)
    ok = ~col_max.isnan()
    err = (beta - beta_p).abs().flatten(2).amax(dim=2)
    assert bool((err[ok] <= 1e-4 * col_max[ok]).all())
    nan_rows = torch.isnan(red).flatten(1).any(dim=1).tolist()
    assert nan_rows == [True, False, False]


@pytest.mark.cuda
@pytest.mark.parametrize("pedigree,atol", [((1, ()), 2e-4), (TRIO, 3e-4)])
def test_genotype_route_on_cuda_matches_cpu(cuda_device, pedigree, atol):
    """GenotypeDPTable on the card (float32 kernels, one launch each) is
    within the reference's f32 bar of the float64 CPU route."""
    from whatshap_torch.ops import genotyping_cuda

    n_ind, trios = pedigree
    rs, positions, ped, nsi = _geno_instance(60, 5, n_ind, trios, seed=5)
    before = (genotyping_cuda.backward.launches, genotyping_cuda.forward.launches)
    gpu = core.GenotypeDPTable(nsi, rs, [10] * 60, ped, positions)
    assert gpu.device.type == "cuda"
    assert (genotyping_cuda.backward.launches, genotyping_cuda.forward.launches) == (before[0] + 1, before[1] + 1)
    cpu = core.GenotypeDPTable(nsi, rs, [10] * 60, ped, positions, device="cpu")
    np.testing.assert_allclose(gpu._likelihoods, cpu._likelihoods, atol=atol)


@pytest.mark.cuda
def test_genotype_route_on_cuda_at_k17(cuda_device):
    """One sample at K = 17, the kernels' ceiling at T = 1 (a cluster of 16
    CTAs), through GenotypeDPTable on the card: one launch of each kernel,
    within the reference's f32 bar of the float64 CPU route."""
    from whatshap_torch.ops import genotyping_cuda

    rs, positions, ped, nsi = _geno_instance(40, 17, 1, (), seed=17)
    before = (genotyping_cuda.backward.launches, genotyping_cuda.forward.launches)
    gpu = core.GenotypeDPTable(nsi, rs, [10] * 40, ped, positions)
    assert gpu._packed.K == 17
    assert (genotyping_cuda.backward.launches, genotyping_cuda.forward.launches) == (before[0] + 1, before[1] + 1)
    cpu = core.GenotypeDPTable(nsi, rs, [10] * 40, ped, positions, device="cpu")
    np.testing.assert_allclose(gpu._likelihoods, cpu._likelihoods, atol=2e-4)


@pytest.mark.cuda
def test_genotype_route_on_cuda_refuses_what_it_cannot_solve(cuda_device):
    """One sample above K = 23, past both kernels' envelopes, raises on CUDA
    instead of leaving the card, naming ROADMAP Queue 1 item 5."""
    rs, positions, ped, nsi = _geno_instance(12, 24, 1, (), seed=2)
    with pytest.raises(NotImplementedError, match="wider envelope, ROADMAP Queue 1 item 5"):
        core.GenotypeDPTable(nsi, rs, [10] * 12, ped, positions)


FAMILY5 = (5, ((0, 1, 2), (0, 1, 3), (0, 1, 4)))  # three children: T = 64, P = 4
GENO_DOUBLE_TRIO = (5, ((0, 1, 2), (2, 3, 4)))  # three founders: T = 16, P = 6


def _wide_geno_inputs(pedigree, coverage, device, n_cols=40):
    """Prepared inputs of two instances of `pedigree` on `device`: instance
    0 with a zero-sum prior column, instance 1 with a new range at column 16
    whose slots are all born (more than a wide tile's bits: further fold
    passes)."""
    from whatshap_torch.ops import genotyping

    n_ind, trios = pedigree
    parts = []
    for b in range(2):
        rs, positions, ped, _nsi = _geno_instance(n_cols, coverage, n_ind, trios, 700 + 10 * coverage + b,
                                                  zero_prior=20 if b == 0 else None,
                                                  break_at=16 if b == 1 else None)
        packed = wmec.pack_problem(rs, [7] * n_cols, ped, False, positions,
                                   check_conflicts=False, emission_tables=False)
        static, stacked = genotyping.prepare_genotyping_batch([packed], ped)
        assert static[0] == coverage * n_ind
        parts.append(stacked)
    stacked = [np.concatenate(xs) for xs in zip(*parts)]
    return static, stacked, genotyping.to_device(stacked, device)


def _geno_close(got, want, nan_rows=(True, False)):
    """compare_geno_kernels' bars: scaling and red within rtol 1e-4,
    beta_store within 1e-4 of its column's largest, identical NaN patterns;
    the zero-sum prior's NaN in the instances nan_rows names."""
    (beta, scaling, red), (beta_p, scaling_p, red_p) = got, want
    for x, y in ((scaling, scaling_p), (red, red_p)):
        _rel_close(x, y, 1e-4)
    assert torch.equal(beta.isnan(), beta_p.isnan())
    col_max = beta_p.flatten(2).amax(dim=2)
    ok = ~col_max.isnan()
    err = (beta - beta_p).abs().flatten(2).amax(dim=2)
    assert bool((err[ok] <= 1e-4 * col_max[ok]).all())
    assert torch.isnan(red).flatten(1).any(dim=1).tolist() == list(nan_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("pedigree,coverage,shape", [
    (FAMILY5, 2, (10, 64, 4)), (GENO_DOUBLE_TRIO, 2, (10, 16, 6)), ((1, ()), 20, (20, 1, 2)),
    (FAMILY7, 1, (7, 1024, 4)), (FIVE_FOUNDERS, 1, (9, 256, 10)),
], ids=["t64", "p6", "k20", "t1024", "p10"])
def test_geno_wide_kernels_match_plain(cuda_device, pedigree, coverage, shape):
    """Both wide genotyping kernels (the state in device memory) against
    their float32 plain versions on the same CUDA tensors, past the cluster
    kernels: three children (T = 64), three founders (P = 6), one sample at
    K = 20, five children (T = 1024), five founders (P = 10); backward and
    forward take them by shape, one launch each."""
    from whatshap_torch.ops import genotyping_cuda

    (K, T, P, _n), _stacked, x = _wide_geno_inputs(pedigree, coverage, cuda_device)
    assert (K, T, P) == shape and not genotyping_cuda.kernel_supported(K, T, P)
    diff, base, passign, trans, birth, die_next, dup = x
    counters = (genotyping_cuda.backward, genotyping_cuda.forward, genotyping_cuda.backward_wide,
                genotyping_cuda.forward_wide)
    before = [fn.launches for fn in counters]
    beta, scaling = genotyping_cuda.backward(K, T, P, diff, base, passign, trans, birth, dup)
    red = genotyping_cuda.forward(K, T, P, diff, base, passign, trans, die_next, scaling, beta)
    assert [fn.launches - b for fn, b in zip(counters, before)] == [0, 0, 1, 1]
    beta_p, scaling_p = genotyping_cuda.backward_plain(K, T, P, diff, base, passign, trans, birth, dup)
    red_p = genotyping_cuda.forward_plain(K, T, P, diff, base, passign, trans, die_next, scaling_p, beta_p)
    torch.cuda.synchronize()
    _geno_close((beta, scaling, red), (beta_p, scaling_p, red_p))


@pytest.mark.cuda
@pytest.mark.parametrize("pedigree,coverage", [((1, ()), 3), (TRIO, 1), (GENO_DOUBLE_TRIO, 1), (FAMILY5, 1)],
                         ids=["t1-k3", "t4-k3", "p6-k5", "t64-k5"])
def test_geno_wide_kernels_match_plain_below_a_tile(cuda_device, pedigree, coverage):
    """The wide kernels, called directly, at K below a tile's bits: tiles of
    the whole instance (8 or 32 states in each plane), fewer than 16 states
    a thread, one or two threads a plane."""
    from whatshap_torch.ops import genotyping_cuda

    (K, T, P, _n), _stacked, x = _wide_geno_inputs(pedigree, coverage, cuda_device)
    assert genotyping_cuda.wide_tiles(K, T) == 1
    diff, base, passign, trans, birth, die_next, dup = x
    beta, scaling = genotyping_cuda.backward_wide(K, T, P, diff, base, passign, trans, birth, dup)
    red = genotyping_cuda.forward_wide(K, T, P, diff, base, passign, trans, die_next, scaling, beta)
    beta_p, scaling_p = genotyping_cuda.backward_plain(K, T, P, diff, base, passign, trans, birth, dup)
    red_p = genotyping_cuda.forward_plain(K, T, P, diff, base, passign, trans, die_next, scaling_p, beta_p)
    torch.cuda.synchronize()
    _geno_close((beta, scaling, red), (beta_p, scaling_p, red_p))


@pytest.mark.cuda
def test_geno_wide_kernels_match_cluster_kernels(cuda_device):
    """Inside the cluster kernels' envelope (a trio at K = 12) the wide
    kernels, called directly, agree with the cluster kernels."""
    from whatshap_torch.ops import genotyping_cuda

    (K, T, P, _n), _stacked, x = _wide_geno_inputs(TRIO, 4, cuda_device)
    assert genotyping_cuda.kernel_supported(K, T, P)
    diff, base, passign, trans, birth, die_next, dup = x
    beta, scaling = genotyping_cuda.backward_wide(K, T, P, diff, base, passign, trans, birth, dup)
    red = genotyping_cuda.forward_wide(K, T, P, diff, base, passign, trans, die_next, scaling, beta)
    beta_c, scaling_c = genotyping_cuda.backward(K, T, P, diff, base, passign, trans, birth, dup)
    red_c = genotyping_cuda.forward(K, T, P, diff, base, passign, trans, die_next, scaling_c, beta_c)
    torch.cuda.synchronize()
    _geno_close((beta, scaling, red), (beta_c, scaling_c, red_c))


@pytest.mark.cuda
def test_geno_wide_kernels_match_plain_over_many_instances(cuda_device):
    """300 instances of one tile each (T = 1, K = 10): the wide kernels'
    CTAs take more than one instance and every instance spans CTAs, so the
    sums run over the partial rows of several CTAs; the zero-sum prior's
    NaN stays in the instances that have it."""
    from whatshap_torch.ops import genotyping, genotyping_cuda

    parts = []
    for b in range(4):
        rs, positions, ped, _nsi = _geno_instance(12, 10, 1, (), 900 + b, zero_prior=5 if b == 0 else None)
        packed = wmec.pack_problem(rs, [7] * 12, ped, False, positions, check_conflicts=False, emission_tables=False)
        (K, T, P, _n), stacked = genotyping.prepare_genotyping_batch([packed], ped)
        parts.append(stacked)
    order = np.arange(300) % 4
    stacked = [np.concatenate([parts[i][j] for i in order]) for j in range(len(parts[0]))]
    assert (K, T, P) == (10, 1, 2) and genotyping_cuda.wide_tiles(K, T) == 1
    diff, base, passign, trans, birth, die_next, dup = genotyping.to_device(stacked, cuda_device)
    beta, scaling = genotyping_cuda.backward_wide(K, T, P, diff, base, passign, trans, birth, dup)
    red = genotyping_cuda.forward_wide(K, T, P, diff, base, passign, trans, die_next, scaling, beta)
    beta_p, scaling_p = genotyping_cuda.backward_plain(K, T, P, diff, base, passign, trans, birth, dup)
    red_p = genotyping_cuda.forward_plain(K, T, P, diff, base, passign, trans, die_next, scaling_p, beta_p)
    torch.cuda.synchronize()
    _geno_close((beta, scaling, red), (beta_p, scaling_p, red_p), nan_rows=(order == 0).tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("pedigree,coverage,atol", [
    (FAMILY5, 2, 3e-4), ((1, ()), 18, 2e-4), (FAMILY7, 1, 3e-4), (FIVE_FOUNDERS, 1, 3e-4),
], ids=["t64", "k18", "t1024", "p10"])
def test_genotype_route_on_cuda_past_the_cluster_kernels(cuda_device, pedigree, coverage, atol):
    """GenotypeDPTable on the card past the cluster kernels (three children,
    T = 64; one sample at K = 18; five children, T = 1024; five founders, P
    = 10): one launch of each wide kernel, within the reference's f32 bar of
    the float64 CPU route."""
    from whatshap_torch.ops import genotyping_cuda

    n_ind, trios = pedigree
    n_cols = 8 if n_ind == 9 else 36  # the float64 CPU route takes 2^P = 1,024 assignments a state at P = 10
    rs, positions, ped, nsi = _geno_instance(n_cols, coverage, n_ind, trios, seed=8)
    before = (genotyping_cuda.backward_wide.launches, genotyping_cuda.forward_wide.launches)
    gpu = core.GenotypeDPTable(nsi, rs, [10] * n_cols, ped, positions)
    assert gpu._packed.K == coverage * n_ind
    assert (genotyping_cuda.backward_wide.launches, genotyping_cuda.forward_wide.launches) == (
        before[0] + 1, before[1] + 1)
    cpu = core.GenotypeDPTable(nsi, rs, [10] * n_cols, ped, positions, device="cpu")
    np.testing.assert_allclose(gpu._likelihoods, cpu._likelihoods, atol=atol)


@pytest.mark.cuda
def test_genotype_route_past_the_cluster_never_runs_the_plain_versions(cuda_device, monkeypatch):
    """With every plain version made to raise, a family of three children
    (T = 64) still genotypes on the card, through the wide kernels."""
    from whatshap_torch.ops import genotyping, genotyping_cuda

    def refuse(*_args, **_kw):
        raise AssertionError("a plain version ran on the CUDA route")

    for mod, name in [(genotyping, "forward_backward_plain"), (genotyping_cuda, "backward_plain"),
                      (genotyping_cuda, "forward_plain")]:
        monkeypatch.setattr(mod, name, refuse)
    rs, positions, ped, nsi = _geno_instance(30, 2, 5, FAMILY5[1], seed=4)
    before = genotyping_cuda.forward_wide.launches
    table = core.GenotypeDPTable(nsi, rs, [10] * 30, ped, positions)
    assert genotyping_cuda.forward_wide.launches == before + 1
    assert np.isfinite(table._likelihoods).all() and table._likelihoods.shape == (30, 5, 3)


@pytest.mark.cuda
def test_genotype_route_on_cuda_never_runs_the_plain_versions(cuda_device, monkeypatch):
    """With every plain version made to raise, a trio still genotypes on the
    card."""
    from whatshap_torch.ops import genotyping, genotyping_cuda

    def refuse(*_args, **_kw):
        raise AssertionError("a plain version ran on the CUDA route")

    for mod, name in [(genotyping, "forward_backward_plain"), (genotyping_cuda, "backward_plain"),
                      (genotyping_cuda, "forward_plain")]:
        monkeypatch.setattr(mod, name, refuse)
    rs, positions, ped, nsi = _geno_instance(40, 3, 3, TRIO[1], seed=3)
    table = core.GenotypeDPTable(nsi, rs, [10] * 40, ped, positions)
    assert np.isfinite(table._likelihoods).all() and table._likelihoods.shape == (40, 3, 3)


FOUR_TRIOS = (8, ((0, 1, 4), (2, 3, 5), (0, 1, 6), (2, 3, 7)))  # four founders, four trios: T = 256, P = 8


def _geno_stack(specs, device, cols=None):
    """Prepared inputs of one instance per spec (n_cols, coverage, pedigree,
    seed, zero_prior, break_at[, error]), all of one K, on `device`; with
    `cols` only the first `cols` columns.  Returns ((K, T, P), the
    tensors)."""
    from whatshap_torch.ops import genotyping

    parts = []
    for n_cols, coverage, (n_ind, trios), seed, zero_prior, break_at, *error in specs:
        rs, positions, ped, _nsi = _geno_instance(n_cols, coverage, n_ind, trios, seed, zero_prior=zero_prior,
                                                  break_at=break_at, error=error[0] if error else None)
        packed = wmec.pack_problem(rs, [7] * n_cols, ped, False, positions,
                                   check_conflicts=False, emission_tables=False)
        (K, T, P, _n), stacked = genotyping.prepare_genotyping_batch([packed], ped)
        assert K == coverage * n_ind
        parts.append(stacked)
    stacked = [np.concatenate(xs) for xs in zip(*parts)]
    x = genotyping.to_device(stacked, device)
    if cols is not None:
        x = tuple(a[:, :cols].contiguous() for a in x)
    return (K, T, P), x


def _windows(K, T, P, flags, backward):
    """The wide kernels' windows of one pass (their rule's mirror)."""
    from whatshap_torch.ops import genotyping_cuda

    uq = genotyping_cuda.wide_unions(flags, backward)
    return genotyping_cuda.wide_windows(uq, genotyping_cuda.wide_lb(K, T), genotyping_cuda.wide_window_cap(T, P, backward))


def _pass_col(q, C, backward):
    return C - 1 - q if backward else q


#: (instances, cols, the instances with a zero-sum prior) of the window cases
GENO_WINDOW_CASES = {
    "break": ([(60, 14, (1, ()), 31, None, None)], None, (False,)),
    "range-start": ([(60, 14, (1, ()), 32, None, 30)], None, (False,)),
    "three-instances": ([(48, 14, (1, ()), 33, 20, None), (48, 14, (1, ()), 34, None, 24),
                         (48, 14, (1, ()), 35, None, None)], None, (True, False, False)),
    "nan-in-window": ([(60, 14, (1, ()), 36, 29, None)], None, (True,)),
    "c1": ([(20, 2, FAMILY5, 37, None, None)], 1, (False,)),
    "c2": ([(20, 2, FAMILY5, 38, None, None), (20, 2, FAMILY5, 39, None, None)], 2, (False, False)),
    "c1-k18": ([(12, 18, (1, ()), 40, None, None)], 1, (False,)),
    "t256-p8": ([(16, 1, FOUR_TRIOS, 41, 8, None), (16, 1, FOUR_TRIOS, 42, None, 6)], None, (True, False)),
    "t1-k23": ([(10, 23, (1, ()), 43, None, None, 0.05)], None, (False,)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GENO_WINDOW_CASES))
def test_geno_wide_windows_match_plain(cuda_device, case):
    """The wide kernels' windows of columns against the float32 plain
    versions (compare_geno_kernels' bars, one launch of each wide kernel):
    windows that end where their folds would leave the tile bits (one
    sample at K = 14: 12 tile bits), a range start (every slot born: further
    fold passes) between runs of windows, three instances with different
    fold masks, a zero-sum prior's NaN column inside a window of both
    passes, C = 1 and 2 (a family of three children, and one sample at K =
    18), four trios of four founders (T = 256, P = 8) at K = 8, one sample
    at K = 23 (reads of its haplotypes with 5 % allele errors: with random
    alleles at coverage 23 a column's likelihood falls to ~1e-18 and the
    float32 plain version itself strays from float64, see
    test_geno_wide_windows_scalings_against_float64)."""
    from whatshap_torch.ops import genotyping_cuda

    specs, cols, nan_rows = GENO_WINDOW_CASES[case]
    (K, T, P), x = _geno_stack(specs, cuda_device, cols)
    diff, base, passign, trans, birth, die_next, dup = x
    C = diff.shape[1]
    assert genotyping_cuda.wide_supported(K, T, P)
    win = (_windows(K, T, P, birth, True), _windows(K, T, P, die_next, False))
    lb = genotyping_cuda.wide_lb(K, T)
    if case == "break":
        for w, backward in zip(win, (True, False)):
            cap = genotyping_cuda.wide_window_cap(T, P, backward)
            assert any(n > 1 and q + n < C and (q + n) % cap for q, n in enumerate(w))
    if case == "range-start":
        assert int(birth[0, 30].sum()) > lb and int(die_next[0, 29].sum()) > lb
        for w, backward in zip(win, (True, False)):
            q = C - 1 - 30 if backward else 29
            assert w[q] == 1 and max(w[:q]) > 1 and max(w[q + 1:]) > 1
    if case == "nan-in-window":
        for w, backward in zip(win, (True, False)):
            start = max(q for q in range(C) if w[q] and q <= (C - 1 - 29 if backward else 29))
            assert w[start] > 1 and start + w[start] > (C - 1 - 29 if backward else 29)
    if case == "t256-p8":
        assert (T, P) == (256, 8) and K == 8
    counters = (genotyping_cuda.backward_wide, genotyping_cuda.forward_wide)
    before = [fn.launches for fn in counters]
    beta, scaling = genotyping_cuda.backward_wide(K, T, P, diff, base, passign, trans, birth, dup)
    red = genotyping_cuda.forward_wide(K, T, P, diff, base, passign, trans, die_next, scaling, beta)
    assert [fn.launches - b for fn, b in zip(counters, before)] == [1, 1]
    beta_p, scaling_p = genotyping_cuda.backward_plain(K, T, P, diff, base, passign, trans, birth, dup)
    red_p = genotyping_cuda.forward_plain(K, T, P, diff, base, passign, trans, die_next, scaling_p, beta_p)
    torch.cuda.synchronize()
    _geno_close((beta, scaling, red), (beta_p, scaling_p, red_p), nan_rows=nan_rows)


@pytest.mark.cuda
def test_geno_wide_windows_scalings_against_float64(cuda_device):
    """One sample at K = 23 with random alleles (a column's likelihood near
    1e-18, most of the state far below float32's normal range): the float32
    plain version's scalings stray from the float64 plain version's (by up
    to 0.93 of them on this instance), and the backward's two-phase windows
    (their first phase sums in float64 from states kept near 1) come no
    farther from float64 than the float32 plain version does, within rtol
    1e-4."""
    from whatshap_torch.ops import genotyping_cuda

    (K, T, P), x = _geno_stack([(10, 23, (1, ()), 44, None, None)], cuda_device)
    diff, base, passign, trans, birth, die_next, dup = x
    assert max(_windows(K, T, P, birth, True)) > 1
    _beta, scaling = genotyping_cuda.backward_wide(K, T, P, diff, base, passign, trans, birth, dup)
    _beta_p, scaling_p = genotyping_cuda.backward_plain(K, T, P, diff, base, passign, trans, birth, dup)
    _b64, s64 = genotyping_cuda.backward_plain(K, T, P, diff.double(), base.double(), passign.double(),
                                               trans.double(), birth, dup.double())
    torch.cuda.synchronize()
    del _beta, _beta_p, _b64
    err, err_p = (scaling.double() - s64).abs(), (scaling_p.double() - s64).abs()
    assert float((err_p / s64.abs()).max()) > 0.1
    assert bool((err <= err_p + 1e-4 * s64.abs()).all())


@pytest.mark.cuda
def test_geno_wide_window_rule_matches_its_mirror(cuda_device):
    """genotyping_cuda.wide_windows is the kernels' own window rule (the C
    entry geno_wide_windows runs the code the kernels run), over random
    unions of fold slots at every tile width and window cap."""
    import ctypes

    from whatshap_torch.ops import _build, genotyping_cuda

    fn = _build.load("geno_backward_wide").geno_wide_windows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rng = np.random.RandomState(17)
    for lb in (2, 4, 6, 8, 10, 12):
        for cap in (1, 4, 13, 16):
            for density in (0.05, 0.2, 0.6):
                C = int(rng.randint(1, 200))
                uq = np.zeros(C, dtype=np.uint32)
                for k in range(23):
                    uq |= (rng.rand(C) < density).astype(np.uint32) << np.uint32(k)
                win = np.zeros(C, dtype=np.int32)
                assert fn(uq.ctypes.data, C, lb, cap, win.ctypes.data) == 0
                assert win.tolist() == genotyping_cuda.wide_windows(uq, lb, cap)


def _force_segments(monkeypatch, packed):
    """Make the single range `packed` segment on the card: a table budget of
    three quarters of its unsegmented tables (C padded to a power of two
    above 256 columns), and segments of the reference's shortest length,
    256 columns.  Returns the number of segments."""
    C, K, T = packed.n_cols, packed.K, packed.T
    tables = wmec._next_pow2(C) * wmec._table_bytes_per_col(K, T)
    monkeypatch.setattr(wmec, "_table_budget", lambda device: tables * 3 // 4 if device.type == "cuda" else None)
    monkeypatch.setattr(wmec, "SEGMENT_TABLE_BUDGET", 1 << 10)
    seg = wmec._single_range_segment(C, K, T, torch.device("cuda"))
    assert seg == 256
    return -(-C // seg)


def _carry_bucket(T, K, device, n_blocks=3, n_cols=96, head_cols=32):
    """(P, the columns after head_cols, the state after the first head_cols)
    of a bucket at T and K: the carry rows 9 and 10 start from."""
    if T == 1:
        P, arrays = 2, _bucket(K, n_blocks, n_cols, seed=20 * K)
    else:
        P, arrays = 4, _pedigree_bucket(K, T, n_blocks, n_cols, seed=20 * K + T)
    K = arrays[0].shape[2]
    ta = blocks.to_device(arrays, device)
    head = [a[:, :head_cols].contiguous() for a in ta]
    tail = [a[:, head_cols:].contiguous() for a in ta]
    if T == 1:
        carry = wmec_cuda.forward_t1(K, P, *head)[1:]
    else:
        carry = tuple(wmec_cuda.forward_t(K, T, P, *head)[2:])
    return K, P, tail, carry


@pytest.mark.cuda
@pytest.mark.parametrize("T,K", [
    (1, 7), (1, 13), (1, 14), (1, 15), (1, 16), (1, 17), (4, 7), (4, 12), (4, 13), (4, 16), (16, 7), (16, 10), (16, 13),
])
def test_carry_kernels_match_plain(cuda_device, T, K):
    """Rows 9 and 10, the carry kernel and the tables kernel from a carry,
    against their plain versions from a nonzero carry, at the first cluster
    of 16 CTAs and at every count of loop bits of both kernels; the carry
    they read is left as it was."""
    K, P, tail, carry = _carry_bucket(T, K, cuda_device)
    saved = [c.clone() for c in carry]
    if T == 1:
        pairs = [
            (wmec_cuda.forward_carry_t1(K, P, *tail, carry), wmec_cuda.forward_carry_t1_plain(K, P, *tail, carry)),
            (wmec_cuda.forward_t1(K, P, *tail, carry=carry), wmec_cuda.forward_t1_plain(K, P, *tail, carry)),
        ]
    else:
        pairs = [
            (wmec_cuda.forward_carry_t(K, T, P, *tail, carry),
             wmec_cuda.forward_carry_t_plain(K, T, P, *tail, carry)),
            (wmec_cuda.forward_t(K, T, P, *tail, carry=carry),
             wmec_cuda.forward_t_plain(K, T, P, *tail, carry=carry)),
        ]
    torch.cuda.synchronize()
    assert bool((carry[0] != 0).any())
    for kern, plain in pairs:
        for x, y in zip(kern, plain):
            assert (x is None and y is None) or torch.equal(x, y)
    assert all(torch.equal(c, s) for c, s in zip(carry, saved))


@pytest.mark.cuda
@pytest.mark.parametrize("pedigree", [(1, ()), TRIO])
def test_segmented_route_on_cuda(cuda_device, pedigree, monkeypatch):
    """A single range whose tables exceed the (patched) table budget takes
    the segmented route on the card: the carry kernel, the tables kernel
    and the backtrace launch once per segment, and the result equals the
    unsegmented route on the card and the CPU run."""
    rs, positions, ped = _pedigree_chromosome(1, 700, 3 if pedigree == TRIO else 8, pedigree, seed=3)
    rc = [5] * len(positions)
    whole = core.PedigreeDPTable(rs, rc, ped, False, positions)
    assert len(wmec.connected_column_ranges(whole._packed)) == 1
    n_seg = _force_segments(monkeypatch, whole._packed)
    assert n_seg == 3
    T = whole._packed.T
    if T == 1:
        counters = [wmec_cuda.forward_carry_t1, wmec_cuda.forward_t1, wmec_cuda.backtrace_t1]
    else:
        counters = [wmec_cuda.forward_carry_t, wmec_cuda.forward_t, wmec_cuda.backtrace_t]
    before = [f.launches for f in counters]
    gpu = core.PedigreeDPTable(rs, rc, ped, False, positions)
    assert [f.launches - b for f, b in zip(counters, before)] == [n_seg] * 3
    cpu = core.PedigreeDPTable(rs, rc, ped, False, positions, device="cpu")
    for other in (whole, cpu):
        assert gpu.get_optimal_cost() == other.get_optimal_cost()
        assert gpu.get_optimal_partitioning() == other.get_optimal_partitioning()
        assert np.array_equal(gpu._result.index_path, other._result.index_path)
        assert np.array_equal(gpu._result.trans_path, other._result.trans_path)


@pytest.mark.cuda
def test_segmented_route_on_cuda_never_runs_the_plain_versions(cuda_device, monkeypatch):
    """With every plain version made to raise, a segmented single sample and
    trio still phase on the card."""

    def refuse(*_args, **_kw):
        raise AssertionError("a plain version ran on the CUDA route")

    for mod, name in [
        (wmec, "forward_scan"), (wmec, "solve_batched"), (wmec, "_backtrace_from"),
        (wmec, "forward_carry"), (wmec, "forward_tables"), (wmec, "walk_segment"),
        (wmec_cuda, "forward_t_plain"), (wmec_cuda, "forward_carry_t_plain"),
        (wmec_cuda, "backtrace_t_plain"), (wmec_cuda, "forward_t1_plain"),
        (wmec_cuda, "forward_carry_t1_plain"), (wmec_cuda, "backtrace_t1_plain"),
    ]:
        monkeypatch.setattr(mod, name, refuse)
    for pedigree, cov in (((1, ()), 6), (TRIO, 2)):
        rs, positions, ped = _pedigree_chromosome(1, 400, cov, pedigree, seed=7)
        rc = [5] * len(positions)
        packed = wmec.pack_problem(rs, rc, ped, False, positions)
        with monkeypatch.context() as m:
            assert _force_segments(m, packed) == 2
            launches = wmec_cuda.forward_carry_t1.launches + wmec_cuda.forward_carry_t.launches
            table = core.PedigreeDPTable(rs, rc, ped, False, positions)
            assert wmec_cuda.forward_carry_t1.launches + wmec_cuda.forward_carry_t.launches == launches + 2
        assert len(table.get_super_reads()[1]) == len(positions)


@pytest.mark.cuda
@pytest.mark.parametrize("trio", [False, True], ids=["chromosome", "trio"])
def test_phase_cli_on_cuda_matches_cpu(cuda_device, trio, tmp_path):
    """The phase CLI on files (chip_smoke.py's generator: FASTA, BAM and VCF
    written with the port's own writers), with realignment: the VCF of the
    run on the card equals the CPU run's, byte for byte, and the card run
    launched the kernels of its route."""
    import chip_smoke
    from whatshap_torch.cli.phase import run_whatshap

    data = chip_smoke.write_synth(tmp_path, 512 if trio else 1024, 3 if trio else 10, seed=41, trio=trio)
    args = dict(phase_input_files=[data["bam"]], variant_file=data["vcf"], reference=data["fasta"],
                write_command_line_header=False, ped=data["ped"])
    names = ("wmec_forward_m_t", "wmec_forward_t", "wmec_backtrace_t") if trio else (
        "wmec_forward_t1", "wmec_backtrace_t1")
    for name in names:
        chip_smoke.WRAPPERS[name].launches = 0
    run_whatshap(**args, output=str(tmp_path / "cuda.vcf"), device="cuda")
    assert all(chip_smoke.WRAPPERS[name].launches > 0 for name in names)
    run_whatshap(**args, output=str(tmp_path / "cpu.vcf"), device="cpu")
    cuda_vcf = (tmp_path / "cuda.vcf").read_bytes()
    assert cuda_vcf == (tmp_path / "cpu.vcf").read_bytes()
    assert cuda_vcf.count(b"|") > 100


def _genotype_cli_inputs(case, tmp_path):
    """The inputs of tests/test_geno_backends_cli.py's two legs: the pacbio
    sample with realignment, and the trio with its PED file.  Each BAM is
    written and indexed under tmp_path (a checkout has no index of the
    pacbio BAM: tests/data/pacbio/.gitignore lists *.bai)."""
    import shutil

    from whatshap_torch.io.sam import build_minimal_index, sam_to_bam

    bam = str(tmp_path / f"{case}.bam")
    if case == "pacbio":
        shutil.copy("tests/data/pacbio/pacbio.bam", bam)
        build_minimal_index(bam)
        return dict(phase_input_files=[bam], variant_file="tests/data/pacbio/variants.vcf",
                    reference="tests/data/pacbio/reference.fasta")
    sam_to_bam("tests/data/trio.pacbio.sam", bam)
    build_minimal_index(bam)
    return dict(phase_input_files=[bam], variant_file="tests/data/trio.vcf", ped="tests/data/trio.ped")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pacbio", "trio"])
def test_genotype_cli_on_cuda_matches_cpu(cuda_device, case, tmp_path):
    """The genotype CLI on the card (float32 kernels, one launch of each per
    GenotypeDPTable call) meets the reference's own CLI bar against the
    port's CPU run (the float64 plain route): GT and GQ exact, GL within
    5e-3, both <= -30 equal; the priors VCFs are byte-identical."""
    import chip_smoke
    from whatshap_torch.cli.genotype import run_genotype
    from whatshap_torch.ops import genotyping_cuda

    args = dict(_genotype_cli_inputs(case, tmp_path), write_command_line_header=False)
    launches = (genotyping_cuda.backward.launches, genotyping_cuda.forward.launches)
    run_genotype(**args, output=str(tmp_path / "cuda.vcf"), prioroutput=str(tmp_path / "cuda.priors"),
                 device="cuda")
    assert genotyping_cuda.backward.launches > launches[0]
    assert genotyping_cuda.forward.launches - launches[1] == genotyping_cuda.backward.launches - launches[0]
    run_genotype(**args, output=str(tmp_path / "cpu.vcf"), prioroutput=str(tmp_path / "cpu.priors"),
                 device="cpu")
    cpu = chip_smoke.vcf_calls((tmp_path / "cpu.vcf").read_text())
    assert any(call[3] for call in cpu)
    diff = chip_smoke.cli_bar(cpu, chip_smoke.vcf_calls((tmp_path / "cuda.vcf").read_text()))
    assert diff["sites"] == 0 and not diff["GT"] and not diff["GQ"] and not diff["GL"], diff
    assert (tmp_path / "cuda.priors").read_bytes() == (tmp_path / "cpu.priors").read_bytes()


@pytest.mark.cuda
def test_genotype_cli_on_cuda_never_runs_the_plain_versions(cuda_device, tmp_path, monkeypatch):
    """With every plain genotyping version made to raise, the genotype CLI
    still genotypes the trio on the card, and launches no wMEC kernel."""
    import chip_smoke
    from whatshap_torch.cli.genotype import run_genotype
    from whatshap_torch.ops import genotyping, genotyping_cuda

    def refuse(*_args, **_kw):
        raise AssertionError("a plain version ran on the CUDA route")

    for mod, name in [(genotyping, "forward_backward_plain"), (genotyping_cuda, "backward_plain"),
                      (genotyping_cuda, "forward_plain")]:
        monkeypatch.setattr(mod, name, refuse)
    wmec_kernels = [getattr(wmec_cuda, name) for name in ("forward_t1", "forward_carry_t1", "backtrace_t1",
                                                           "forward_t", "forward_carry_t", "forward_m_t",
                                                           "backtrace_t")]
    before = [k.launches for k in wmec_kernels]
    out = tmp_path / "out.vcf"
    run_genotype(**_genotype_cli_inputs("trio", tmp_path), output=str(out), write_command_line_header=False)
    assert [k.launches for k in wmec_kernels] == before
    calls = chip_smoke.vcf_calls(out.read_text())
    assert len(calls) == 15 and all(len(call[3]) == 3 for call in calls)


FORWARD_COST_KERNELS = ("forward_carry_t1", "forward_carry_t1_wide", "forward_carry_t", "forward_carry_t_wide")
ALL_WMEC_KERNELS = FORWARD_COST_KERNELS + ("forward_t1", "forward_t1_wide", "backtrace_t1", "forward_t",
                                           "forward_t_wide", "forward_m_t", "forward_m_t_wide", "backtrace_t")


@pytest.mark.cuda
@pytest.mark.parametrize("T,K", [(1, 7), (1, 15), (1, 17), (1, 20), (4, 12), (4, 16), (4, 18), (16, 13)])
def test_forward_cost_batched_matches_plain(cuda_device, monkeypatch, T, K):
    """forward_cost_batched on the card (the carry kernels from a zero carry)
    equals its plain version bit for bit on all three outputs (cost, jmin and
    key), launching its carry kernel once and no other kernel, with every
    plain version made to raise."""
    if T == 1:
        arrays = _bucket(K, n_blocks=3, n_cols=48, seed=K)
    else:
        arrays = _pedigree_bucket(K, T, n_blocks=3, n_cols=48, seed=K + T)
    K = arrays[0].shape[2]
    ta = blocks.to_device(arrays, cuda_device)
    P = 2 if T == 1 else 4
    if T == 1:
        kernel = "forward_carry_t1" if K <= wmec_cuda.MAX_K else "forward_carry_t1_wide"
    else:
        kernel = "forward_carry_t" if wmec_cuda.cluster_supported(K, T, P) else "forward_carry_t_wide"
    plain = wmec.forward_cost_batched_plain(K, T, P, *ta)

    def refuse(*_args, **_kw):
        raise AssertionError("a plain version ran on the CUDA route")

    for name in ("forward_scan", "forward_carry"):
        monkeypatch.setattr(wmec, name, refuse)
    for name in ("forward_carry_t1_plain", "forward_carry_t_plain"):
        monkeypatch.setattr(wmec_cuda, name, refuse)
    before = {name: getattr(wmec_cuda, name).launches for name in ALL_WMEC_KERNELS}
    got = wmec.forward_cost_batched(K, T, P, *ta)
    torch.cuda.synchronize()
    rose = {name for name in ALL_WMEC_KERNELS if getattr(wmec_cuda, name).launches != before[name]}
    assert rose == {kernel} and getattr(wmec_cuda, kernel).launches == before[kernel] + 1
    assert [tuple(x.shape) for x in got] == [(3, T, 1 << K), (3, T, 1 << K), (3, 1 << K)]
    for x, y in zip(got, plain):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["single", "trio"])
def test_sharded_solve_over_one_card_three_times(cuda_device, kind):
    """solve_blocks_sharded over cuda:0 x 3 (uneven shards of 7 single-sample
    or 4 trio blocks) equals the unsharded solve on the card and the CPU's,
    and per-block serial solves; LAUNCH_STATS records three devices."""
    from whatshap_torch.parallel import mesh as mesh_mod
    from whatshap_torch.parallel import workloads

    if kind == "single":
        K, T, P, packed_list, arrays = workloads.build_single_sample_batch(7, n_cols=16, coverage=4, seed=3)
    else:
        K, T, P, packed_list, arrays = workloads.build_trio_batch(4, n_pos=10, seed=7)
    card = torch.device("cuda", torch.cuda.current_device())
    sharded = mesh_mod.solve_blocks_sharded([card] * 3, K, T, P, arrays)
    assert wmec.LAUNCH_STATS[-1][-1] == 3
    whole = mesh_mod.solve_blocks_sharded([card], K, T, P, arrays)
    cpu = mesh_mod.solve_blocks_sharded([torch.device("cpu")], K, T, P, arrays)
    for s, w, c in zip(sharded, whole, cpu):
        np.testing.assert_array_equal(s, w)
        np.testing.assert_array_equal(s, c)
    workloads.assert_batched_matches_serial(packed_list, *sharded)
    dp_last, _j, _k = mesh_mod.run_blocks_sharded([card] * 3, K, T, P, arrays)
    np.testing.assert_array_equal(mesh_mod.optimal_costs_from_batched(dp_last), sharded[0])


def _assert_equals_run_dp(packed_list, results, device):
    """Each result equals its instance's own run_dp on `device`: cost,
    transmission path and partitioning, the index path on the bits of the
    active slots, and the whole index path for an instance of one
    read-connected range (run_dp slices several at each range's K, where the
    bits of inactive slots are don't-cares)."""
    for packed, r in zip(packed_list, results):
        serial = wmec.run_dp(packed, device=device)
        assert r.optimal_cost == serial.optimal_cost
        np.testing.assert_array_equal(r.trans_path, serial.trans_path)
        mask = (packed.active.astype(np.int64) << np.arange(packed.K, dtype=np.int64)).sum(axis=1)
        np.testing.assert_array_equal(r.index_path & mask, serial.index_path & mask)
        assert wmec.extract_partitioning(packed, r) == wmec.extract_partitioning(packed, serial)
        if len(wmec.connected_column_ranges(packed)) == 1:
            np.testing.assert_array_equal(r.index_path, serial.index_path)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["trio", "single"])
def test_solve_packed_list_on_cuda_matches_run_dp(cuda_device, kind):
    """solve_packed_list on the card: a trio list with one member at K = 17
    (past the cluster kernel: row 14) or a single-sample list with one at K =
    18 (row 13) equals each instance's run_dp on the card, the CPU's
    solve_packed_list bit for bit, and launches the kernels of its path."""
    from whatshap_torch.parallel import workloads

    if kind == "trio":
        packed_list = workloads.build_trio_batch(4, n_pos=24, n_reads=12, seed=3, c_pad=24, read_len=5)[3]
        packed_list += workloads.build_trio_batch(1, n_pos=24, n_reads=40, seed=7, c_pad=24, read_len=10)[3]
        expect = ("forward_t", "forward_t_wide", "backtrace_t")
    else:
        packed_list = workloads.build_single_sample_batch(4, n_cols=32, coverage=5, seed=11)[3]
        packed_list += workloads.build_single_sample_batch(1, n_cols=32, coverage=18, read_len=12, seed=19)[3]
        expect = ("forward_t1", "forward_t1_wide", "backtrace_t1")
    assert max(p.K for p in packed_list) == (17 if kind == "trio" else 18)
    for name in expect:
        getattr(wmec_cuda, name).launches = 0
    got = wmec.solve_packed_list(packed_list, device=cuda_device)
    assert all(getattr(wmec_cuda, name).launches > 0 for name in expect)
    cpu = wmec.solve_packed_list(packed_list, device="cpu")
    for g, c in zip(got, cpu):
        assert g.optimal_cost == c.optimal_cost
        np.testing.assert_array_equal(g.index_path, c.index_path)
        np.testing.assert_array_equal(g.trans_path, c.trans_path)
    _assert_equals_run_dp(packed_list, got, cuda_device)


def _same_shaped_genotyping(n, n_cols, n_ind, trios, seed, lanes=3):
    """n genotyping instances of one shape: one read layout (`lanes` lanes
    of reads an individual, so one K) over one pedigree with random
    genotype likelihoods, each instance with its own alleles and
    qualities."""
    rng = np.random.RandomState(seed)
    positions = [(i + 1) * 10 for i in range(n_cols)]
    ped = core.Pedigree(core.NumericSampleIds())
    for i in range(n_ind):
        gls = [core.PhredGenotypeLikelihoods(list(rng.dirichlet([1, 1, 1]))) for _ in positions]
        ped.add_individual(f"ind{i}", [core.Genotype([])] * n_cols, gls)
    for f, m, c in trios:
        ped.add_relationship(f"ind{f}", f"ind{m}", f"ind{c}")
    layout = []
    for ind in range(n_ind):
        for _lane in range(lanes):
            start = int(rng.randint(0, 3))
            while start < n_cols - 1:
                end = min(n_cols, start + int(rng.randint(2, 8)))
                layout.append((ind, start, end))
                start = end
    packed_list = []
    for _j in range(n):
        rs = core.ReadSet()
        for i, (ind, a, b) in enumerate(layout):
            read = core.Read(f"r{i}", 50, 0, ind)
            for c in range(a, b):
                read.add_variant(positions[c], int(rng.randint(0, 2)), int(rng.randint(10, 40)))
            rs.add(read)
        rs.sort()
        packed_list.append(wmec.pack_problem(rs, [10] * n_cols, ped, False, positions, check_conflicts=False,
                                             emission_tables=False))
    return packed_list, ped


@pytest.mark.cuda
@pytest.mark.parametrize("n_ind,trios,lanes", [
    (1, (), 8), (3, ((0, 1, 2),), 3), (5, ((0, 1, 2), (0, 1, 3), (0, 1, 4)), 3),
], ids=["single", "trio", "fam5"])
def test_run_genotyping_batched_on_cuda_matches_per_instance(cuda_device, n_ind, trios, lanes):
    """run_genotyping_batched on the card equals each instance's own
    run_genotyping on the card (the same kernels at B = 1): bit for bit
    inside the cluster kernels' envelope (one sample, a trio); past it
    (three children, T = 64: rows 15-16) within the likelihood bar of the
    kernel checks (atol 1e-5), since the wide kernels sum an instance's
    tiles in the rows of the CTAs that hold them, and how many tiles a CTA
    holds depends on the grid, so on B."""
    from whatshap_torch.ops import genotyping, genotyping_cuda

    packed_list, ped = _same_shaped_genotyping(6, 40, n_ind, trios, seed=5 + n_ind, lanes=lanes)
    shapes = {(p.n_cols, p.K, p.T, p.P) for p in packed_list}
    assert len(shapes) == 1
    _C, K, T, P = shapes.pop()
    got = genotyping.run_genotyping_batched(packed_list, ped, device=cuda_device)
    assert got.shape == (6, 40, n_ind, 3) and np.isfinite(got).all()
    for b, packed in enumerate(packed_list):
        one = genotyping.run_genotyping(packed, ped, device=cuda_device)
        if genotyping_cuda.kernel_supported(K, T, P):
            np.testing.assert_array_equal(got[b], one)
        else:
            np.testing.assert_allclose(got[b], one, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="one shape"):
        genotyping.run_genotyping_batched(
            packed_list + _same_shaped_genotyping(1, 39, n_ind, trios, 1, lanes)[0], ped, device=cuda_device)
