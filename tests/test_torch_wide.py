"""
Parity of the port's single-sample route past the T=1 cluster kernel's
ceiling (K 18 to 23, where the reference runs its XLA scan) with the JAX
reference on the CPU.  The route there goes to wmec_cuda.forward_t1_wide and
forward_carry_t1_wide (csrc/wmec_forward_t1_wide.cu on the card, their plain
versions on CPU tensors) and to backtrace_t1; the same numpy-seeded inputs go
through the reference's solve_batched, _solve_scan and solve_scan_segmented
and through both PedigreeDPTables, and every output must be bit-equal (int32
DP: the tolerance is exact equality).  The reference's XLA scan takes
seconds a column on a CPU at these K, so its instances here have two or
three columns, and its K = 19 bucket and the
segmented solve are cases of tests/test_torch_wmec.py and
tests/test_torch_segmented.py, which run in other test workers; the wide
kernel itself is held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import whatshap_tpu.core as ref_core
from whatshap_tpu.ops import wmec as ref_wmec
from whatshap_tpu.parallel import blocks as ref_blocks

import whatshap_torch.core as core
from whatshap_torch.ops import wmec, wmec_cuda
from whatshap_torch.parallel import blocks


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The torch mirror's column loops are many small ops, which run faster
    on one thread than on threads that the test workers of a run share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


INF = 1 << 29


def _wide_bucket(K, B, C, seed, ties=False):
    """Stacked T = 1 block arrays at exactly K slots, from a numpy seed.
    Tie-heavy: weights, base costs, rank weights and assignment costs in
    {0, 1}.  Otherwise integer weights, block 0's times 37 (above bf16's
    exact 256), the rank weights a power of two per slot, and INF for some
    assignments.  A quarter of the slots die before each column, and every
    slot before the first."""
    rng = np.random.RandomState(seed)
    if ties:
        arrays = [
            rng.randint(0, 2, (B, C, K, 4)).astype(np.float32),
            rng.randint(0, 2, (B, C, 1, 2, 2)).astype(np.int32),
            rng.randint(0, 2, (B, C, K)).astype(np.float32),
            rng.randint(0, 2, (B, C, 1, 4)).astype(np.int32),
        ]
    else:
        wdiff = rng.randint(-40, 41, (B, C, K, 4)).astype(np.float32)
        wbase = rng.randint(0, 60, (B, C, 1, 2, 2)).astype(np.int32)
        wdiff[0] *= 37
        wbase[0] *= 37
        rank = np.stack([[rng.permutation(K) for _ in range(C)] for _ in range(B)])
        rankw = np.where(rng.rand(B, C, K) < 0.9, 2.0 ** rank, 0).astype(np.float32)
        acost = np.where(rng.rand(B, C, 1, 4) < 0.3, INF, rng.randint(0, 3, (B, C, 1, 4))).astype(np.int32)
        arrays = [wdiff, wbase, rankw, acost]
    die = rng.rand(B, C, K) < 0.25
    die[:, 0] = True
    return arrays + [die, rng.randint(0, 3, (B, C)).astype(np.int32)]


def _t(arrays):
    return blocks.to_device(arrays, "cpu")


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _eq(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    return port.shape == np.shape(ref) and np.array_equal(port, np.asarray(ref))


def test_wide_solve_batched_matches_reference():
    """A tie-heavy bucket of two blocks at K = 18 through the port's batched
    solve (the kernel route's wrappers, plain on the CPU, and
    solve_batched_auto as run_dp_batched calls it) against the reference's
    solve_batched, the XLA route it takes for T = 1 past its Pallas
    envelope.  K = 19 is a workload of tests/test_torch_wmec.py."""
    K = 18
    arrays = _wide_bucket(K, 2, 2, seed=K, ties=True)
    ref = ref_wmec.solve_batched(K, 1, 2, *_j(arrays))
    assert wmec_cuda.kernel_supported(K, 1, 2) and K > wmec_cuda.MAX_K
    for solve in (wmec_cuda.solve_batched_cuda, wmec.solve_batched_auto):
        out = solve(K, 1, 2, *_t(arrays))
        for x, r in zip(out, ref):
            assert x.dtype == torch.int32 and _eq(x, r), solve.__name__


def test_wide_single_range_matches_solve_scan():
    """One range at K = 18 (B = 1, as run_dp solves a single range) against
    the reference's _solve_scan."""
    K = 18
    arrays = _wide_bucket(K, 1, 2, seed=3)
    cost, index_path, trans_path = ref_wmec._solve_scan(K, 1, 2, *_j([a[0] for a in arrays]))
    out = wmec.solve_batched_auto(K, 1, 2, *_t(arrays))
    assert _eq(out[0], [cost]) and _eq(out[1], [index_path]) and _eq(out[2], [trans_path])


def _table_pair(K, n_cols, seed):
    """The same reads (make_synthetic_readset at coverage K) in both
    packages: (port ReadSet, reference ReadSet, positions)."""
    rs_p, positions, _ = blocks.make_synthetic_readset(n_cols, K, read_len=6, seed=seed)
    rs_r, positions_r, _ = ref_blocks.make_synthetic_readset(n_cols, K, read_len=6, seed=seed)
    assert list(positions) == list(positions_r)
    return rs_p, rs_r, positions


@pytest.mark.parametrize("K", [18, 19, 20])
def test_wide_pedigree_dptable_matches_reference(K):
    """Both PedigreeDPTables end to end on the same reads at K = 18 to 20:
    cost, partitioning, index path and superreads; the port's run on the
    CPU takes the kernel route's wrappers (wmec_cuda.solve_batched_cuda)
    with no launch counted."""
    rs_p, rs_r, positions = _table_pair(K, 14, seed=40 + K)
    tables = []
    for pkg, rs in ((core, rs_p), (ref_core, rs_r)):
        ped = pkg.Pedigree(pkg.NumericSampleIds())
        ped.add_individual("s", [pkg.Genotype([0, 1])] * len(positions), None)
        kw = {"device": "cpu"} if pkg is core else {}
        tables.append(pkg.PedigreeDPTable(rs, [1] * len(positions), ped, False, positions, **kw))
    port, ref = tables
    assert port._packed.K == K
    assert port.get_optimal_cost() == ref.get_optimal_cost()
    assert port.get_optimal_partitioning() == ref.get_optimal_partitioning()
    ref_result = ref_wmec.run_dp(ref_wmec.pack_problem(rs_r, [1] * len(positions), ped, False, positions))
    assert np.array_equal(port._result.index_path, ref_result.index_path)
    (p_super, _pt), (r_super, _rt) = port.get_super_reads(), ref.get_super_reads()
    for ps, rs_ in zip(p_super, r_super):
        for p_read, r_read in zip(ps, rs_):
            assert [(v.position, v.allele, v.quality) for v in p_read] == [
                (v.position, v.allele, v.quality) for v in r_read
            ]


def test_wide_segment_rule_follows_the_xla_route(monkeypatch):
    """Past the cluster kernel's ceiling the single range segments by the
    reference's XLA-route rule (whatshap_tpu/ops/wmec.py:1893-1905): on the
    CPU once its tables pass SEGMENT_TABLE_BUDGET, into segments of
    max(64, min(2048, next_pow2(sqrt(C)))) columns; on a card where the
    tables and the wide kernel's state pass the budget, by the same length.
    Up to the ceiling the table rule stays."""
    dev = torch.device("cpu")
    for C in (64, 100, 4095, 4096, 100_000, 10_000_000):
        ref = max(64, min(2048, ref_wmec._next_pow2(int(np.sqrt(C)), lo=64)))
        assert wmec._xla_segment_length(C) == ref
    assert (wmec._xla_segment_length(2048), wmec._xla_segment_length(100_000)) == (64, 512)
    K = 23
    per_col = 4 << K
    # C = 32 pads to 32: 1 GiB of tables, the XLA route's threshold
    assert wmec._single_range_segment(32, K, 1, dev) is None
    assert wmec._single_range_segment(33, K, 1, dev) == 64
    assert wmec._single_range_segment(100_000, K, 1, dev) == 512
    assert wmec._single_range_segment(4096, 17, 1, dev) is None  # the table rule: 2 GiB at K = 17
    assert wmec._single_range_segment(4097, 17, 1, dev) == wmec._segment_length(17, 1) == 1024
    need = 2048 * per_col + wmec_cuda.state_bytes(K, 1)
    monkeypatch.setattr(wmec, "_table_budget", lambda device: need)
    assert wmec._single_range_segment(2048, K, 1, dev) is None
    monkeypatch.setattr(wmec, "_table_budget", lambda device: need - 1)
    assert wmec._single_range_segment(2048, K, 1, dev) == 64


def test_wide_segment_budget_counts_two_planes_a_checkpoint(monkeypatch):
    """At T = 1 a checkpoint of the segmented solve holds the cost and the
    key (the jmin plane is the one zeros tensor every checkpoint shares):
    the budget admits exactly one segment's tables, the kernel's state and
    nseg + 1 checkpoints of two planes."""
    K, seg = 18, 1
    arrays = _t(_wide_bucket(K, 1, 3, seed=7))
    S = 1 << K
    need = seg * 4 * S + wmec_cuda.state_bytes(K, 1) + (3 // seg + 1) * 2 * 4 * S
    monkeypatch.setattr(wmec, "_table_budget", lambda device: need - 1)
    with pytest.raises(NotImplementedError, match="budget"):
        wmec.solve_segmented_auto(K, 1, 2, *arrays, seg)
    monkeypatch.setattr(wmec, "_table_budget", lambda device: need)
    out = wmec.solve_segmented_auto(K, 1, 2, *arrays, seg)
    for x, y in zip(out, wmec.solve_batched(K, 1, 2, *arrays)):
        assert torch.equal(x, y)


def test_wide_route_segments_without_changing_paths(monkeypatch):
    """run_dp(device="cpu") on one range at K = 18 past the (shrunk) table
    budget: the XLA-route rule picks the segment length (shrunk here to 8),
    the segmented solve runs on the kernel route's wrappers, and cost,
    index path and partitioning equal the unsegmented route's and the
    reference's host route's."""
    K = 18
    rs_p, rs_r, positions = _table_pair(K, 14, seed=9)
    packs = []
    for pkg, mod, rs in ((core, wmec, rs_p), (ref_core, ref_wmec, rs_r)):
        ped = pkg.Pedigree(pkg.NumericSampleIds())
        ped.add_individual("s", [pkg.Genotype([0, 1])] * len(positions), None)
        packs.append(mod.pack_problem(rs, [1] * len(positions), ped, False, positions))
    packed, ref_packed = packs
    assert packed.K == K and len(wmec.connected_column_ranges(packed)) == 1
    whole = wmec.run_dp(packed, "cpu")
    monkeypatch.setattr(wmec, "SEGMENT_TABLE_BUDGET", 1 << 10)
    monkeypatch.setattr(wmec, "_xla_segment_length", lambda C: 8)
    segs = []
    orig = wmec_cuda.solve_segmented_cuda
    monkeypatch.setattr(wmec_cuda, "solve_segmented_cuda", lambda *a: segs.append(a[-1]) or orig(*a))
    port = wmec.run_dp(packed, "cpu")
    assert segs == [8] and packed.n_cols > 8
    ref = ref_wmec.run_dp(ref_packed, backend="numpy")
    for result in (whole, ref):
        assert port.optimal_cost == result.optimal_cost
        assert np.array_equal(port.index_path, result.index_path)
    assert wmec.extract_partitioning(packed, port) == ref_wmec.extract_partitioning(ref_packed, ref)


def test_wide_wrappers_check_inputs_and_count_no_launch():
    """The wide kernel's wrappers take 1 <= K <= MAX_K_WIDE and run their
    plain versions on CPU tensors (no launch counted), as do forward_t1 and
    forward_carry_t1 above MAX_K; the T=1 backtrace takes K up to
    MAX_K_WIDE."""
    K = 18
    arrays = _t(_wide_bucket(K, 2, 3, seed=11, ties=True))
    counters = (wmec_cuda.forward_t1, wmec_cuda.forward_carry_t1, wmec_cuda.forward_t1_wide,
                wmec_cuda.forward_carry_t1_wide, wmec_cuda.backtrace_t1)
    before = [f.launches for f in counters]
    head = [a[:, :1].contiguous() for a in arrays]
    tail = [a[:, 1:].contiguous() for a in arrays]
    carry = wmec_cuda.forward_t1_wide(K, 2, *head)[1:]
    for x, y in zip(wmec_cuda.forward_t1_wide(K, 2, *tail, carry), wmec_cuda.forward_t1(K, 2, *tail, carry=carry)):
        assert torch.equal(x, y)
    for x, y in zip(wmec_cuda.forward_carry_t1_wide(K, 2, *tail, carry), wmec_cuda.forward_carry_t1(K, 2, *tail, carry)):
        assert torch.equal(x, y)
    pidx, dp, key = wmec_cuda.forward_t1_wide(K, 2, *arrays)
    opt = wmec_cuda._select_optimum(K, 1, dp, key)[2]
    path, _final = wmec_cuda.backtrace_t1(opt, pidx, wmec_cuda.pack_die(arrays[4]))
    assert path.shape == (2, 3)
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="carry"):
        wmec_cuda.forward_carry_t1_wide(K, 2, *tail, None)
    with pytest.raises(ValueError):
        wmec_cuda.forward_t1_wide(K + 1, 2, *arrays)
    big = list(_t(_wide_bucket(1, 1, 1, seed=1)))
    big[0] = torch.zeros((1, 1, wmec_cuda.MAX_K_WIDE + 1, 4))
    with pytest.raises(ValueError, match="unsupported"):
        wmec_cuda.forward_t1_wide(wmec_cuda.MAX_K_WIDE + 1, 2, *big)
    empty = torch.zeros((1, 0, 1 << (wmec_cuda.MAX_K_WIDE + 1)), dtype=torch.int32)
    with pytest.raises(ValueError, match="K <= 23"):
        wmec_cuda.backtrace_t1(torch.zeros(1, dtype=torch.int32), empty, torch.zeros((1, 0), dtype=torch.int32))


def test_wide_group_rule_fills_the_l2_share():
    """The wide kernel's L2 sweep takes as many blocks a group as their cost
    planes (4 * 2^K bytes each) fit the share, at least one and at most the
    launch's: one at K = 23, whose plane alone is 32 MiB."""
    share = wmec_cuda.T1_WIDE_L2_SHARE
    for K in range(1, wmec_cuda.MAX_K_WIDE + 1):
        for B in (1, 2, 3, 7, 16, 19, 1 << 20):
            g = wmec_cuda.forward_t1_wide_group(K, B)
            plane = 4 << K
            assert 1 <= g <= B
            assert g == 1 or g * plane <= share
            assert g == B or (g + 1) * plane > share
    assert wmec_cuda.forward_t1_wide_group(23, 19) == 1


def test_wide_trio_forward_m_matches_reference():
    """A trio (T = 4, P = 4) at K = 18, past the general-T cluster kernel's
    K = 16: the port's pass 1 of the pedigree route (forward_m_auto, row
    14's m-only mode on the card, its plain version here) against the
    reference's XLA forward_m_batched, from seeds with INF entries, on a
    tie-heavy bucket with saturating recombination costs.  The other
    pedigree shapes past the cluster kernel are cases of
    tests/test_torch_pedigree_wide.py."""
    K, T, P = 18, 4, 4
    rng = np.random.RandomState(K)
    arrays = [
        rng.randint(0, 2, (1, 2, K, T * P * 2)).astype(np.float32),
        rng.randint(0, 2, (1, 2, T, P, 2)).astype(np.int32),
        rng.randint(0, 2, (1, 2, K)).astype(np.float32),
        rng.randint(0, 2, (1, 2, T, 1 << P)).astype(np.int32),
        rng.rand(1, 2, K) < 0.25,
        np.array([[INF, 1]], dtype=np.int32),
    ]
    dp0 = np.array([[0, INF, 3, INF]], dtype=np.int32)
    assert wmec_cuda.kernel_supported(K, T, P) and not wmec_cuda.cluster_supported(K, T, P)
    ref = ref_wmec.forward_m_batched(K, T, P, *_j(arrays), jnp.asarray(dp0))
    assert _eq(wmec.forward_m_auto(K, T, P, *_t(arrays), torch.from_numpy(dp0)), ref)
