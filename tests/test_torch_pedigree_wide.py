"""
Parity of the port's pedigree (T > 1) route past the general-T cluster
kernel's envelope (three or more trios, T = 64 and 256; a third or fourth
founder, P = 6 and 8; a trio at K = 17), where the reference runs its
XLA scan, with the JAX reference on the CPU.  The route there goes to
wmec_cuda.forward_t_wide, forward_m_t_wide and forward_carry_t_wide
(csrc/wmec_forward_t_wide.cu on the card, their plain versions on CPU
tensors) and to backtrace_t; the same numpy-seeded inputs go through the
reference's solve_batched, forward_m_batched, solve_seeded_batched and
solve_scan_segmented and through both PedigreeDPTables, and every output
must be bit-equal (int32 DP: the tolerance is exact equality).  The buckets
hold saturating recombination costs (INF, and above INF / log2 T) and INF
seeds, where the transmission min-plus ties.  The reference's XLA scan is
slow on a CPU at high K, so its instances have two or three columns; the
wide kernel itself is held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import whatshap_tpu.core as ref_core
from whatshap_tpu.ops import wmec as ref_wmec

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


INF = wmec.INF
DOUBLE_TRIO = (5, ((0, 1, 2), (2, 3, 4)))  # three founders: P = 6, T = 16
FAMILY5 = (5, ((0, 1, 2), (0, 1, 3), (0, 1, 4)))  # two parents, three children: P = 4, T = 64
FAMILY7 = (7, tuple((0, 1, c) for c in range(2, 7)))  # two parents, five children: P = 4, T = 1024
# two grandparent couples, their two children, an in-law and two
# grandchildren: four trios of five founders, P = 10, T = 256
FIVE_FOUNDERS = (9, ((0, 1, 4), (2, 3, 5), (4, 5, 7), (4, 6, 8)))


def _bucket(K, T, P, B, C, seed, ties=False):
    """Stacked block arrays (wdiff, wbase, rankw, acost, die_prev, rc) at
    exactly K slots, T transmissions and P partitions, from a numpy seed.
    Tie-heavy: weights, base costs, rank weights and assignment costs in
    {0, 1}, recombination costs in {0, 1, 2}.  Otherwise integer weights,
    block 0's times 37 (above bf16's exact 256), the rank weights powers of
    two, INF for some assignments.  Either way a quarter of the slots die
    before each column and every slot before the first, and a third of the
    recombination costs saturate: INF, or above INF / log2 T, where the
    reference clamps them."""
    rng = np.random.RandomState(seed)
    tp2, na = T * P * 2, 1 << P
    if ties:
        arrays = [
            rng.randint(0, 2, (B, C, K, tp2)).astype(np.float32),
            rng.randint(0, 2, (B, C, T, P, 2)).astype(np.int32),
            rng.randint(0, 2, (B, C, K)).astype(np.float32),
            rng.randint(0, 2, (B, C, T, na)).astype(np.int32),
        ]
        rc = rng.randint(0, 3, (B, C))
    else:
        wdiff = rng.randint(-40, 41, (B, C, K, tp2)).astype(np.float32)
        wbase = rng.randint(0, 60, (B, C, T, P, 2)).astype(np.int32)
        wdiff[0] *= 37
        wbase[0] *= 37
        rankw = (2.0 ** rng.randint(0, K, (B, C, K))).astype(np.float32)
        acost = np.where(rng.rand(B, C, T, na) < 0.3, INF, rng.randint(0, 3, (B, C, T, na))).astype(np.int32)
        arrays = [wdiff, wbase, rankw, acost]
        rc = rng.randint(0, 400, (B, C))
    sat = rng.rand(B, C)
    rc = np.where(sat < 0.15, INF, np.where(sat < 0.3, INF // 2 + rng.randint(0, 1000, (B, C)), rc))
    die = rng.rand(B, C, K) < 0.25
    die[:, 0] = True
    return arrays + [die, rc.astype(np.int32)]


def _seeds(B, T, seed):
    """Seeds (B, T): small costs, a third of them INF, one row all INF but
    one entry, as the seam pass's unit seeds are."""
    rng = np.random.RandomState(seed)
    dp0 = rng.randint(0, 300, (B, T)).astype(np.int32)
    dp0[rng.rand(B, T) < 0.35] = INF
    dp0[0] = INF
    dp0[0, rng.randint(T)] = 0
    return dp0


def _t(arrays):
    return blocks.to_device(arrays, "cpu")


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _eq(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    return port.shape == np.shape(ref) and np.array_equal(port, np.asarray(ref))


def _past_cluster(K, T, P):
    return wmec_cuda.kernel_supported(K, T, P) and not wmec_cuda.cluster_supported(K, T, P)


# (K, T, P, B, C, ties): three trios, four trios, three founders, four
# founders, and a trio past the cluster kernel's K = 16
SOLVE_SHAPES = [
    (5, 64, 4, 2, 3, True),
    (3, 256, 4, 2, 2, True),
    (4, 16, 6, 2, 3, False),
    (2, 16, 8, 2, 3, True),
    (17, 4, 2, 1, 2, True),
    # five founders at one and two trios, five trios
    (4, 4, 10, 2, 3, False),
    (3, 16, 10, 2, 2, True),
    (3, 1024, 4, 1, 2, False),
]


@pytest.mark.parametrize("K,T,P,B,C,ties", SOLVE_SHAPES)
def test_wide_solve_batched_matches_reference(K, T, P, B, C, ties):
    """The batched solve (the kernel route's wrappers, plain on the CPU, and
    solve_batched_auto as the route calls it) against the reference's
    solve_batched, the XLA route it takes past its Pallas envelope: cost,
    index paths and transmission paths."""
    assert _past_cluster(K, T, P)
    arrays = _bucket(K, T, P, B, C, seed=100 * K + T + P, ties=ties)
    ref = ref_wmec.solve_batched(K, T, P, *_j(arrays))
    for solve in (wmec_cuda.solve_batched_cuda, wmec.solve_batched_auto):
        out = solve(K, T, P, *_t(arrays))
        for x, r in zip(out, ref):
            assert x.dtype == torch.int32 and _eq(x, r), solve.__name__


# (K, T, P, B, C, ties)
SEEDED_SHAPES = [
    (4, 64, 4, 2, 3, True),
    (2, 256, 8, 2, 2, False),
    (2, 1024, 2, 1, 2, True),
    (3, 16, 10, 2, 2, False),
]


@pytest.mark.parametrize("K,T,P,B,C,ties", SEEDED_SHAPES + [(3, 16, 6, 2, 3, True)])
def test_wide_forward_m_matches_reference(K, T, P, B, C, ties):
    """Pass 1 of the pedigree route (forward_m_auto, the m-only mode) against
    the reference's forward_m_batched, from seeds with INF entries."""
    assert _past_cluster(K, T, P)
    arrays = _bucket(K, T, P, B, C, seed=200 * K + T + P, ties=ties)
    dp0 = _seeds(B, T, seed=K + T)
    ref = ref_wmec.forward_m_batched(K, T, P, *_j(arrays), jnp.asarray(dp0))
    for fwd in (wmec_cuda.forward_m_t, wmec.forward_m_auto):
        assert _eq(fwd(K, T, P, *_t(arrays), torch.from_numpy(dp0)), ref), fwd.__name__


# (K, T, P, B, C) of the grouped m-only mode: a trio and a quartet past the
# cluster kernel by their founders (P = 6), three trios
GROUPED_SHAPES = {4: (4, 4, 6, 2, 3), 16: (3, 16, 6, 2, 2), 64: (3, 64, 4, 2, 2)}
GROUPED_R = 16


@functools.lru_cache(maxsize=None)
def _grouped_case(T):
    """A bucket, GROUPED_R seeds a block (INF entries, unit rows) and the
    reference's forward_m_batched over the bucket repeated once per seed,
    m (B, GROUPED_R, T)."""
    K, T, P, B, C = GROUPED_SHAPES[T]
    arrays = _bucket(K, T, P, B, C, seed=500 + T, ties=T != 16)
    seeds = _seeds(B * GROUPED_R, T, seed=T).reshape(B, GROUPED_R, T)
    seeds[:, 1] = INF
    seeds[:, 1, T - 1] = 0
    rep = [np.repeat(a, GROUPED_R, axis=0) for a in arrays]
    ref = np.asarray(ref_wmec.forward_m_batched(K, T, P, *_j(rep), jnp.asarray(seeds.reshape(-1, T))))
    return (K, T, P), arrays, seeds, ref.reshape(B, GROUPED_R, T)


@pytest.mark.parametrize("R", [1, 2, GROUPED_R])
@pytest.mark.parametrize("T", sorted(GROUPED_SHAPES))
def test_grouped_forward_m_matches_reference(T, R):
    """Pass 1's grouped m-only mode, R seeds a block over the block's inputs
    (seeds (B, R, T), m (B, R, T)): the wrappers' plain versions and
    forward_m_auto against the reference's forward_m_batched on the inputs
    repeated once per seed and the same seeds, bit for bit."""
    (K, T, P), arrays, seeds, ref = _grouped_case(T)
    assert _past_cluster(K, T, P)
    dp0 = torch.from_numpy(np.ascontiguousarray(seeds[:, :R]))
    for fwd in (wmec_cuda.forward_m_t_plain, wmec_cuda.forward_m_t, wmec_cuda.forward_m_t_wide, wmec.forward_m_auto):
        assert _eq(fwd(K, T, P, *_t(arrays), dp0), ref[:, :R]), fwd.__name__


def test_pedigree_route_runs_pass_1_grouped(monkeypatch):
    """run_dp_batched_pedigree hands pass 1 each bucket's blocks once with
    their R coset seeds (B, R, T), not the blocks repeated R times, and its
    m (B, R, T) equals the reference's forward_m_batched on the repeated
    blocks; the route's result equals the one with the mirror's
    forward_m_batched in pass 1."""
    seen = []

    def spy(K, T, P, *arrays):
        m = wmec.forward_m_auto(K, T, P, *arrays)
        seen.append((K, T, P, [a.numpy() for a in arrays], m.numpy()))
        return m

    rs, recomb, positions, ped = _family_instance(core, FAMILY5, 6, 1, seed=5)
    packed = core.PedigreeDPTable(rs, recomb, ped, False, positions, device="cpu")._packed
    assert len(wmec.connected_column_ranges(packed)) > 1
    res = wmec.run_dp_batched_pedigree(packed, torch.device("cpu"), forward_m=spy)
    mirror = wmec.run_dp_batched_pedigree(packed, torch.device("cpu"), forward_m=wmec.forward_m_batched)
    assert res.optimal_cost == mirror.optimal_cost
    assert np.array_equal(res.index_path, mirror.index_path) and np.array_equal(res.trans_path, mirror.trans_path)
    _rep_of, reps = wmec.coset_representatives(packed.T, packed.t_sym_masks)
    R = len(reps)
    assert R == 16 and seen
    for K, T, P, arrays, m in seen:
        *inputs, seeds = arrays
        B = inputs[0].shape[0]
        assert seeds.shape == (B, R, T) and m.shape == (B, R, T)
        rep = [np.repeat(a, R, axis=0) for a in inputs]
        ref = ref_wmec.forward_m_batched(K, T, P, *_j(rep), jnp.asarray(seeds.reshape(B * R, T)))
        assert _eq(m.reshape(B * R, T), ref)


@pytest.mark.parametrize("K,T,P,B,C,ties", SEEDED_SHAPES)
def test_wide_solve_seeded_matches_reference(K, T, P, B, C, ties):
    """Pass 2 of the pedigree route (solve_seeded_auto: the seeded tables
    mode, the head walk and the T seam walks) against the reference's
    solve_seeded_batched: all eight outputs."""
    assert _past_cluster(K, T, P)
    arrays = _bucket(K, T, P, B, C, seed=300 * K + T + P, ties=ties)
    dp0 = _seeds(B, T, seed=K * T)
    die_next = np.random.RandomState(K).rand(B, K) < 0.6
    ref = ref_wmec.solve_seeded_batched(K, T, P, *_j(arrays), jnp.asarray(dp0), jnp.asarray(die_next))
    out = wmec.solve_seeded_auto(K, T, P, *_t(arrays), torch.from_numpy(dp0), torch.from_numpy(die_next))
    assert len(out) == len(ref) == 8
    for i, (x, r) in enumerate(zip(out, ref)):
        assert x.dtype == torch.int32 and _eq(x, r), i


@pytest.mark.parametrize("K,T,P,C,seg", [(4, 64, 4, 4, 2)])
def test_wide_segmented_matches_scan_segmented(K, T, P, C, seg):
    """The segmented solve of one range (solve_segmented_auto: the carry
    mode, then the tables mode from each checkpoint and the walks) against
    the reference's solve_scan_segmented, its XLA route's checkpoint and
    recompute solve: cost, index path and transmission path."""
    assert _past_cluster(K, T, P)
    arrays = _bucket(K, T, P, 1, C, seed=400 * K + T + P, ties=True)
    ref = ref_wmec.solve_scan_segmented(K, T, P, *_j([a[0] for a in arrays]), seg=seg)
    cost, index_path, trans_path = wmec.solve_segmented_auto(K, T, P, *_t(arrays), seg)
    assert int(cost[0]) == ref.optimal_cost
    assert np.array_equal(index_path[0].numpy(), ref.index_path)
    assert np.array_equal(trans_path[0].numpy(), ref.trans_path)


def _family_instance(pkg, pedigree, n_cols, coverage, seed):
    """The same reads, genotypes and recombination costs in `pkg` (either
    core module): the founders' haplotypes drawn at random, each child
    taking one haplotype of each parent (switching once), the genotypes
    following them; every individual gets `coverage` reads of 2-6 variants
    a window of 6 columns, in windows with no read across them, their
    alleles drawn at random.  Returns (readset, recombination costs,
    positions, Pedigree)."""
    n_ind, trios = pedigree
    rng = np.random.RandomState(seed)
    positions = [100 + 10 * i + 1000 * (i // 6) for i in range(n_cols)]
    haps = rng.randint(0, 2, (n_ind, 2, n_cols))
    for f, m, c in trios:  # a trio's parents come before it
        for side, parent in enumerate((f, m)):
            pick = (np.arange(n_cols) >= rng.randint(n_cols)) ^ rng.randint(2)
            haps[c, side] = haps[parent, pick.astype(int), np.arange(n_cols)]
    gts = haps.sum(axis=1)
    rs = pkg.ReadSet()
    for ind in range(n_ind):
        for w in range(0, n_cols, 6):
            for r in range(coverage):
                start = w + rng.randint(0, 4)
                length = rng.randint(2, min(6, w + 6 - start) + 1)
                read = pkg.Read(f"i{ind}w{w}r{r}", 50, 0, ind)
                for c in range(start, min(start + length, n_cols)):
                    read.add_variant(positions[c], int(rng.randint(0, 2)), int(rng.randint(5, 40)))
                rs.add(read)
    rs.sort()
    ped = pkg.Pedigree(pkg.NumericSampleIds())
    for ind in range(n_ind):
        ped.add_individual(f"ind{ind}", [pkg.Genotype([0, 1] if g == 1 else [g // 2] * 2) for g in gts[ind]], None)
    for f, m, c in trios:
        ped.add_relationship(f"ind{f}", f"ind{m}", f"ind{c}")
    recomb = rng.randint(1, 12, n_cols).tolist()
    return rs, recomb, positions, ped


def _assert_tables_equal(port, ref):
    assert port.get_optimal_cost() == ref.get_optimal_cost()
    assert port.get_optimal_partitioning() == ref.get_optimal_partitioning()
    (p_super, p_trans), (r_super, r_trans) = port.get_super_reads(), ref.get_super_reads()
    assert list(p_trans) == list(r_trans)
    for ps, rs_ in zip(p_super, r_super):
        for p_read, r_read in zip(ps, rs_):
            assert [(v.position, v.allele, v.quality) for v in p_read] == [
                (v.position, v.allele, v.quality) for v in r_read
            ]


@pytest.mark.parametrize("pedigree,coverage", [(DOUBLE_TRIO, 1), (FAMILY5, 1)], ids=["doubletrio", "family5"])
def test_wide_pedigree_dptable_matches_reference(pedigree, coverage):
    """Both PedigreeDPTables end to end on the same reads: a three-generation
    pedigree with three founders (P = 6, T = 16) and a family of two parents
    and three children (P = 4, T = 64), through the seam route of three
    read-connected ranges; cost, partitioning, superreads and the
    transmission vector.  The port runs on the CPU through the kernel
    route's wrappers, which launch nothing there."""
    tables = []
    for pkg in (core, ref_core):
        rs, recomb, positions, ped = _family_instance(pkg, pedigree, 12, coverage, seed=5)
        kw = {"device": "cpu"} if pkg is core else {}
        tables.append(pkg.PedigreeDPTable(rs, recomb, ped, False, positions, **kw))
    port, ref = tables
    K, T, P = port._packed.K, port._packed.T, port._packed.P
    assert _past_cluster(K, T, P) and len(wmec.connected_column_ranges(port._packed)) > 1
    _assert_tables_equal(port, ref)


def test_wide_doubletrio_pure_genetic_matches_reference():
    """The reference's test_phase_doubletrio_pure_genetic
    (tests/test_pedigreephasing.py): no reads, three founders (P = 6, T =
    16), phased from the genotypes alone; cost 0 and one transmission value
    throughout in both packages, and the same superreads."""
    gts = ([1, 2, 1, 0], [1, 0, 1, 1], [2, 1, 1, 0], [1, 2, 2, 1], [1, 1, 1, 0])
    tables = []
    for pkg in (core, ref_core):
        ped = pkg.Pedigree(pkg.NumericSampleIds())
        for name, g in zip("ABCDE", gts):
            ped.add_individual(f"individual{name}", [pkg.Genotype([0, 1] if x == 1 else [x // 2] * 2) for x in g])
        ped.add_relationship("individualA", "individualB", "individualC")
        ped.add_relationship("individualC", "individualD", "individualE")
        kw = {"device": "cpu"} if pkg is core else {}
        tables.append(pkg.PedigreeDPTable(pkg.ReadSet(), [2, 2, 2], ped, False, [10, 20, 30, 40], **kw))
    port, ref = tables
    assert (port._packed.T, port._packed.P) == (16, 6)
    assert port.get_optimal_cost() == 0 and len(set(port.get_super_reads()[1])) == 1
    _assert_tables_equal(port, ref)


def test_wide_t_wrappers_check_inputs_and_count_no_launch():
    """The general-T wide wrappers run their plain versions on CPU tensors (no
    launch counted), as forward_t, forward_m_t and forward_carry_t do for
    shapes past the cluster kernel; they refuse shapes past the envelope
    (six trios, T = 4096; six founders, P = 12), and backtrace_t takes
    tables of T in WIDE_T, up to T = 1024."""
    K, T, P = 3, 64, 6
    arrays = _t(_bucket(K, T, P, 2, 3, seed=9, ties=True))
    counters = (wmec_cuda.forward_t, wmec_cuda.forward_m_t, wmec_cuda.forward_carry_t, wmec_cuda.forward_t_wide,
                wmec_cuda.forward_m_t_wide, wmec_cuda.forward_carry_t_wide, wmec_cuda.backtrace_t)
    before = [f.launches for f in counters]
    head = [a[:, :1].contiguous() for a in arrays]
    tail = [a[:, 1:].contiguous() for a in arrays]
    carry = wmec_cuda.forward_t_wide(K, T, P, *head)[2:]
    for x, y in zip(wmec_cuda.forward_t_wide(K, T, P, *tail, carry=carry), wmec_cuda.forward_t(K, T, P, *tail, carry=carry)):
        assert torch.equal(x, y)
    for x, y in zip(wmec_cuda.forward_carry_t_wide(K, T, P, *tail, carry), wmec_cuda.forward_carry_t(K, T, P, *tail, carry)):
        assert torch.equal(x, y)
    dp0 = torch.from_numpy(_seeds(2, T, seed=1))
    assert torch.equal(wmec_cuda.forward_m_t_wide(K, T, P, *arrays, dp0), wmec_cuda.forward_m_t(K, T, P, *arrays, dp0))
    tables = wmec_cuda.forward_t_wide(K, T, P, *arrays)
    _m, init = wmec_cuda._head_init(K, T, *tables[2:])
    path, tpath, _final = wmec_cuda.backtrace_t(init[:, None].contiguous(), tables[0], tables[1],
                                                wmec_cuda.pack_die(arrays[4]))
    assert path.shape == tpath.shape == (2, 1, 3)
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="carry"):
        wmec_cuda.forward_carry_t_wide(K, T, P, *tail, None)
    with pytest.raises(ValueError, match="seeded"):
        wmec_cuda.forward_m_t_wide(K, T, P, *arrays, None)
    for bad in ((K, 4096, 4), (K, 64, 12), (wmec_cuda.MAX_K_WIDE + 1, 4, 4)):
        big = _t(_bucket(*bad, 1, 1, seed=2))
        with pytest.raises(ValueError, match="unsupported"):
            wmec_cuda.forward_t_wide(*bad, *big)
    with pytest.raises(ValueError, match="unsupported"):
        wmec_cuda.backtrace_t(torch.zeros((1, 1, 3), dtype=torch.int32), torch.zeros((1, 1, 512, 2), dtype=torch.int32),
                              torch.zeros((1, 1, 512, 2), dtype=torch.int32), torch.zeros((1, 1), dtype=torch.int32))


def test_wide_t_envelope_and_state():
    """The envelope: up to five trios (T = 1024) and five founders (P = 10)
    at any K up to the CLI's 23; past the cluster kernel's shapes the wide
    kernel keeps 2T + 1 planes of 4 * 2^K bytes a block (cost, jmin, key)."""
    assert wmec_cuda.WIDE_T == (4, 16, 64, 256, 1024) and wmec_cuda.WIDE_P == (2, 4, 6, 8, 10)
    for T in wmec_cuda.WIDE_T:
        for P in wmec_cuda.WIDE_P:
            assert wmec_cuda.kernel_supported(1, T, P) and wmec_cuda.kernel_supported(23, T, P)
            assert not wmec_cuda.kernel_supported(24, T, P)
            for K in (1, 13, 16, 17, 23):
                cluster = wmec_cuda.cluster_supported(K, T, P)
                assert cluster == (P <= 4 and ((T == 4 and K <= 16) or (T == 16 and K <= 13)))
                assert wmec_cuda.state_bytes(K, T, P) == (0 if cluster else (2 * T + 1) * 4 << K)
    for T, P in ((4096, 4), (64, 12), (8, 4), (64, 5)):
        assert not wmec_cuda.kernel_supported(5, T, P)
    assert wmec_cuda.state_bytes(15, 64, 4) == 129 * 4 << 15


def test_wide_t_budgets_count_the_state_planes(monkeypatch):
    """The route's three pedigree solvers chunk their launches under the
    table budget counting the wide kernel's planes beside the tables: the
    batched and seeded solves' index and transmission tables plus 2T + 1
    planes a block, pass 1's T cost planes for each of a block's seeds."""
    K, T, P, B, C = 3, 64, 4, 2, 3
    arrays = _t(_bucket(K, T, P, B, C, seed=13, ties=True))
    seen = []
    real = wmec._launch_batched
    monkeypatch.setattr(wmec, "_launch_batched", lambda *a: seen.append(a[-1]) or real(*a))
    wmec.solve_batched_auto(K, T, P, *arrays)
    dp0 = torch.from_numpy(_seeds(B, T, seed=3))
    wmec.forward_m_auto(K, T, P, *arrays, dp0)
    wmec.forward_m_auto(K, T, P, *arrays, dp0[:, None].expand(B, 3, T).contiguous())
    wmec.solve_seeded_auto(K, T, P, *arrays, dp0, torch.ones((B, K), dtype=torch.bool))
    state = (2 * T + 1) * 4 << K
    tables = C * T * 8 << K
    assert seen == [tables + state, T * 4 << K, 3 * T * 4 << K, tables + state]


def test_wide_t_segment_rule_follows_the_xla_route(monkeypatch):
    """Past the cluster kernels a pedigree's single range segments by the
    reference's XLA-route rule (whatshap_tpu/ops/wmec.py:1893-1905): on the
    CPU once its tables pass SEGMENT_TABLE_BUDGET, into segments of about
    sqrt(C) columns; on a card where the tables and the wide kernel's planes
    pass the budget, by the same length.  Inside the cluster kernel's
    envelope the table rule stays."""
    dev = torch.device("cpu")
    per_col = wmec._table_bytes_per_col(15, 64)  # 16 MiB a column at T = 64, K = 15
    assert per_col == 16 << 20
    assert wmec._single_range_segment(64, 15, 64, dev, 4) is None  # 1 GiB: the XLA threshold
    assert wmec._single_range_segment(65, 15, 64, dev, 4) == 64
    assert wmec._single_range_segment(100_000, 15, 64, dev, 4) == 512
    assert wmec._single_range_segment(10_000, 12, 16, dev, 6) == 128  # P = 6 is past the cluster kernel
    assert wmec._single_range_segment(1024, 15, 4, dev, 4) is None  # the cluster kernel's table rule
    assert wmec._single_range_segment(2049, 15, 4, dev, 4) == 512
    need = 2048 * per_col + wmec_cuda.state_bytes(15, 64, 4)
    monkeypatch.setattr(wmec, "_table_budget", lambda device: need)
    assert wmec._single_range_segment(2048, 15, 64, dev, 4) is None
    monkeypatch.setattr(wmec, "_table_budget", lambda device: need - 1)
    assert wmec._single_range_segment(2048, 15, 64, dev, 4) == 64


# ---------------------------------------------------------------------------
# five trios (T = 1024) and five founders (P = 10)
# ---------------------------------------------------------------------------


def _t1024_case(mode):
    """A five-trio bucket (T = 1024, P = 4, K = 3) and the reference's
    output for `mode`: "tables" solve_batched's costs and paths and the
    tables of _forward_tables_scan from zero; "carry" _forward_carry_scan of
    the last two columns from the nonzero state after the first; "m"
    forward_m_batched with 3 explicit seeds a block, on the blocks repeated
    once per seed."""
    K, T, P = 3, 1024, 4
    if mode == "tables":
        arrays = _bucket(K, T, P, 1, 2, seed=61, ties=True)
        ref = [np.asarray(x) for x in ref_wmec.solve_batched(K, T, P, *_j(arrays))]
        zero = (jnp.zeros((1 << K, T), jnp.int32), jnp.zeros((1 << K, T), jnp.int32), jnp.zeros((1 << K,), jnp.int32))
        tables = ref_wmec._forward_tables_scan(K, T, P, *_j([a[0] for a in arrays]), zero)
        ref += [np.asarray(tables[3]).transpose(0, 2, 1)[None], np.asarray(tables[4]).transpose(0, 2, 1)[None]]
        return (K, T, P), arrays, None, ref
    if mode == "carry":
        arrays = _bucket(K, T, P, 1, 3, seed=62, ties=False)
        zero = (jnp.zeros((1 << K, T), jnp.int32), jnp.zeros((1 << K, T), jnp.int32), jnp.zeros((1 << K,), jnp.int32))
        carry0 = ref_wmec._forward_carry_scan(K, T, P, *_j([a[0, :1] for a in arrays]), zero)
        out = ref_wmec._forward_carry_scan(K, T, P, *_j([a[0, 1:] for a in arrays]), carry0)
        carry0 = [np.asarray(x)[None] for x in carry0]
        assert (carry0[0] != 0).any() and (carry0[2] != 0).any()
        return (K, T, P), [a[:, 1:] for a in arrays], carry0, [np.asarray(x)[None] for x in out]
    R = 3
    arrays = _bucket(K, T, P, 2, 2, seed=63, ties=True)
    seeds = _seeds(2 * R, T, seed=64).reshape(2, R, T)
    rep = [np.repeat(a, R, axis=0) for a in arrays]
    ref = np.asarray(ref_wmec.forward_m_batched(K, T, P, *_j(rep), jnp.asarray(seeds.reshape(-1, T))))
    return (K, T, P), arrays, seeds, [ref.reshape(2, R, T)]


@pytest.mark.parametrize("chunk", [wmec.MINPLUS_CHUNK, 1 << 21], ids=["chunk-default", "chunk-states"])
@pytest.mark.parametrize("mode", ["tables", "carry", "m"])
def test_t1024_mirror_modes_match_reference(mode, chunk, monkeypatch):
    """Five trios (T = 1024: a state's T x T min-plus term is 4 MiB): the
    wide wrappers' plain versions in the tables, carry and m-only modes
    against the reference's XLA scan, bit for bit: solve_batched and its
    tables, _forward_carry_scan from a nonzero carry, forward_m_batched with
    three explicit seeds a block (the grouped mode).  The mirror takes the
    min-plus of the tables and carry modes in chunks of MINPLUS_CHUNK
    entries: at its default whole scans a chunk, pinned at 2M entries two
    states a chunk; the results do not move.  (The m-only mode takes it as
    a distance transform over the bits of t, whatever the chunk.)"""
    monkeypatch.setattr(wmec, "MINPLUS_CHUNK", chunk)
    (K, T, P), arrays, extra, ref = _t1024_case(mode)
    assert _past_cluster(K, T, P)
    ta = _t(arrays)
    if mode == "tables":
        out = list(wmec_cuda.solve_batched_cuda(K, T, P, *ta)) + list(wmec_cuda.forward_t_wide(K, T, P, *ta)[:2])
    elif mode == "carry":
        carry = tuple(torch.from_numpy(np.array(np.swapaxes(x, 1, 2) if x.ndim == 3 else x, order="C")) for x in extra)
        out = [x.transpose(1, 2) if x.dim() == 3 else x for x in wmec_cuda.forward_carry_t_wide(K, T, P, *ta, carry)]
    else:
        out = [wmec_cuda.forward_m_t_wide(K, T, P, *ta, torch.from_numpy(extra))]
    assert len(out) == len(ref)
    for i, (x, r) in enumerate(zip(out, ref)):
        assert _eq(x, r), (mode, i)


@pytest.mark.parametrize("pedigree", [FAMILY7, FIVE_FOUNDERS], ids=["family7", "five-founders"])
def test_five_trios_or_founders_dptable_matches_reference(pedigree):
    """Both PedigreeDPTables end to end on one read-connected range (one
    block, the single-range solve) of a family of two parents and five
    children (T = 1024, P = 4) and of a pedigree of five founders and four
    trios (T = 256, P = 10): cost, partitioning, superreads and the
    transmission vector, bit for bit."""
    tables = []
    for pkg in (core, ref_core):
        rs, recomb, positions, ped = _family_instance(pkg, pedigree, 6, 1, seed=5)
        kw = {"device": "cpu"} if pkg is core else {}
        tables.append(pkg.PedigreeDPTable(rs, recomb, ped, False, positions, **kw))
    port, ref = tables
    K, T, P = port._packed.K, port._packed.T, port._packed.P
    assert (T, P) == {7: (1024, 4), 9: (256, 10)}[pedigree[0]] and _past_cluster(K, T, P)
    assert len(wmec.connected_column_ranges(port._packed)) == 1
    _assert_tables_equal(port, ref)


def test_pass_1_splits_a_blocks_seeds_over_the_budget(monkeypatch):
    """Pass 1 (forward_m_auto) splits a block's coset seeds over launches
    where their cost planes (T * 4 * 2^K bytes a seed) pass the table
    budget, each launch chunked along the blocks in turn, and m equals the
    unsplit launch's; a budget below one seed's planes raises, naming the
    over-budget item."""
    K, T, P, B, R = 3, 64, 4, 3, 5
    arrays = _t(_bucket(K, T, P, B, 2, seed=71, ties=True))
    seeds = torch.from_numpy(_seeds(B * R, T, seed=72).reshape(B, R, T))
    whole = wmec.forward_m_auto(K, T, P, *arrays, seeds)
    per_seed = wmec_cuda.state_bytes(K, T, P, seeds=1)
    assert per_seed == T * 4 << K
    seen = []
    real = wmec._launch_batched
    monkeypatch.setattr(wmec, "_launch_batched", lambda *a: seen.append((a[-2][-1].shape, a[-1])) or real(*a))
    monkeypatch.setattr(wmec, "_table_budget", lambda device: 2 * per_seed + 1)
    split = wmec.forward_m_auto(K, T, P, *arrays, seeds)
    assert torch.equal(split, whole)
    assert seen == [((B, 2, T), 2 * per_seed), ((B, 2, T), 2 * per_seed), ((B, 1, T), per_seed)]
    monkeypatch.setattr(wmec, "_table_budget", lambda device: R * per_seed)
    seen.clear()
    assert torch.equal(wmec.forward_m_auto(K, T, P, *arrays, seeds), whole)
    assert seen == [((B, R, T), R * per_seed)]
    monkeypatch.setattr(wmec, "_table_budget", lambda device: per_seed - 1)
    with pytest.raises(NotImplementedError, match="item 6"):
        wmec.forward_m_auto(K, T, P, *arrays, seeds)
