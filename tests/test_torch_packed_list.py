"""
Parity of the port's entries for lists of independent instances with the JAX
reference on the CPU: wmec.bucket_packed_list and wmec.solve_packed_list
(bit for bit against the reference's, which on the CPU buckets at exact K and
solves on its XLA scan), genotyping.run_genotyping_batched (within rtol=1e-9
of the reference's run_genotyping_jax_batched in float64), and the port's
testhelpers against the reference's on the same strings and matrices.

Every instance is made from a seed, with each package's own workload builders
or data model, and packed by each package's own pack_problem.
"""

import random
from pathlib import Path

import numpy as np
import pytest
import torch

import whatshap_tpu.core as ref_core
import whatshap_tpu.testhelpers as ref_testhelpers
from whatshap_tpu.ops import genotyping_jax as ref_genotyping_jax
from whatshap_tpu.ops import wmec as ref_wmec
from whatshap_tpu.parallel import workloads as ref_workloads

import whatshap_torch.core as core
import whatshap_torch.testhelpers as testhelpers
from whatshap_torch.ops import genotyping, wmec
from whatshap_torch.parallel import workloads

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TRIO = ((0, 1, 2),)


@pytest.fixture(autouse=True)
def _one_torch_thread_no_mesh():
    """One torch thread (the mirror's column loop is many small ops), and the
    route's mesh and launch records as a fresh process has them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = wmec.MESH_DEVICES
    wmec.MESH_DEVICES = None
    wmec.LAUNCH_STATS.clear()
    yield
    wmec.MESH_DEVICES = saved
    wmec.LAUNCH_STATS.clear()
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# solve_packed_list, bucket_packed_list
# ---------------------------------------------------------------------------


def _lists(kind):
    """(reference list, port list) of the same instances, K spanning three
    buckets at K <= 12: trios as tests/test_batched_blocks.py:114 builds them
    (many read-connected ranges each), or single samples at coverage 3, 6
    and 9."""
    ref, port = [], []
    if kind == "trio":
        for nb, (n_reads, rl) in enumerate([(12, 3), (24, 4), (40, 5)]):
            kw = dict(n_pos=48, n_reads=n_reads, seed=100 + nb, c_pad=48, read_len=rl)
            ref += ref_workloads.build_trio_batch(2, **kw)[3]
            port += workloads.build_trio_batch(2, **kw)[3]
    else:
        for nb, cov in enumerate([3, 6, 9]):
            kw = dict(n_cols=40, coverage=cov, seed=10 * nb)
            ref += ref_workloads.build_single_sample_batch(2, **kw)[3]
            port += workloads.build_single_sample_batch(2, **kw)[3]
    ks = {p.K for p in port}
    assert max(ks) <= 12 and 1 < len(ks) <= 3, sorted(ks)
    return ref, port


def _active_mask(packed):
    """Per column, the index-path bits of the slots active there."""
    weights = 1 << np.arange(packed.K, dtype=np.int64)
    return (packed.active.astype(np.int64) * weights).sum(axis=1)


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.optimal_cost == w.optimal_cost
        np.testing.assert_array_equal(g.index_path, w.index_path)
        np.testing.assert_array_equal(g.trans_path, w.trans_path)
        assert g.index_path.dtype == g.trans_path.dtype == np.int64


@pytest.mark.parametrize("kind", ["trio", "single"])
def test_bucket_packed_list_matches_reference(kind):
    ref_list, port_list = _lists(kind)
    ref = ref_wmec.bucket_packed_list(ref_list)
    port = wmec.bucket_packed_list(port_list)
    assert [(k, cp, idxs) for k, cp, idxs, _s in port] == [(k, cp, idxs) for k, cp, idxs, _s in ref]
    for (_k, _cp, _i, ps), (_k2, _cp2, _i2, rs) in zip(port, ref):
        for a, b in zip(ps, rs):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("kind", ["trio", "single"])
def test_solve_packed_list_matches_reference(kind):
    """Costs, index paths and transmission paths equal the reference's bit
    for bit.  Each instance's own run_dp gives the same cost, transmission
    path and partitioning; its index path equals on the bits of the active
    slots: a trio instance of several read-connected ranges takes run_dp's
    seam route, which slices each range at its own K, and the bits of
    inactive slots are don't-cares (as tests/test_batched_blocks.py:137
    compares them)."""
    ref_list, port_list = _lists(kind)
    ref = ref_wmec.solve_packed_list(ref_list)
    got = wmec.solve_packed_list(port_list, device="cpu")
    _assert_results_equal(got, ref)
    for packed, r in zip(port_list, got):
        serial = wmec.run_dp(packed, device="cpu")
        assert r.optimal_cost == serial.optimal_cost
        np.testing.assert_array_equal(r.trans_path, serial.trans_path)
        mask = _active_mask(packed)
        np.testing.assert_array_equal(r.index_path & mask, serial.index_path & mask)
        assert wmec.extract_partitioning(packed, r) == wmec.extract_partitioning(packed, serial)
        if kind == "single":  # single ranges at the instance's K: the whole path
            np.testing.assert_array_equal(r.index_path, serial.index_path)


def test_solve_packed_list_c_pad_and_empty():
    """c_pad given or left out gives the same results, in the buckets it
    names; an empty list gives []; c_pad below an instance's columns is
    raised to them."""
    _ref, port_list = _lists("single")
    default = wmec.solve_packed_list(port_list, device="cpu")
    for c_pad in (40, 128, 8):
        _assert_results_equal(wmec.solve_packed_list(port_list, c_pad=c_pad, device="cpu"), default)
        assert {cp for _k, cp, _i, _s in wmec.bucket_packed_list(port_list, c_pad)} == {max(c_pad, 40)}
    assert wmec.solve_packed_list([], device="cpu") == []
    assert wmec.bucket_packed_list([]) == []


def test_solve_packed_list_mixed_tp_rejected():
    """A list of instances that do not share (T, P) raises ValueError, as the
    reference's does (tests/test_batched_blocks.py:146)."""
    single = workloads.build_trio_batch(1, n_pos=8, n_reads=6, seed=7, n_ind=1, trios=(), c_pad=8)[3]
    trio = workloads.build_trio_batch(1, n_pos=8, n_reads=9, seed=8, c_pad=8)[3]
    with pytest.raises(ValueError, match=r"share \(T, P\)"):
        wmec.solve_packed_list(single + trio, device="cpu")
    with pytest.raises(ValueError):
        wmec.bucket_packed_list(trio + single)
    ref_single = ref_workloads.build_trio_batch(1, n_pos=8, n_reads=6, seed=7, n_ind=1, trios=(), c_pad=8)[3]
    ref_trio = ref_workloads.build_trio_batch(1, n_pos=8, n_reads=9, seed=8, c_pad=8)[3]
    with pytest.raises(ValueError):
        ref_wmec.solve_packed_list(ref_single + ref_trio)


@pytest.mark.parametrize("kind", ["trio", "single"])
def test_solve_packed_list_sharded_over_four_devices(kind):
    """With wmec.MESH_DEVICES = [cpu] * 4 every bucket's launch shards over
    four devices (LAUNCH_STATS records n_dev = 4 where a bucket has four or
    more blocks), and the results equal the unsharded ones."""
    _ref, port_list = _lists(kind)
    whole = wmec.solve_packed_list(port_list, device="cpu")
    assert all(stat[-1] == 1 for stat in wmec.LAUNCH_STATS)
    wmec.LAUNCH_STATS.clear()
    wmec.MESH_DEVICES = [CPU] * 4
    sharded = wmec.solve_packed_list(port_list, device="cpu")
    _assert_results_equal(sharded, whole)
    buckets = wmec.bucket_packed_list(port_list)
    assert len(wmec.LAUNCH_STATS) == len(buckets)
    for (k_b, cp, idxs, _s), (K, T, C, B, _Bp, n_dev) in zip(buckets, wmec.LAUNCH_STATS):
        assert (K, C, B, n_dev) == (k_b, cp, len(idxs), min(4, len(idxs)))
    # one bucket of four or more blocks: the launch over all four devices
    wmec.LAUNCH_STATS.clear()
    big = port_list * 2
    _assert_results_equal(wmec.solve_packed_list(big, device="cpu"), whole * 2)
    assert max(stat[-1] for stat in wmec.LAUNCH_STATS) == 4


def test_solve_packed_list_needs_a_device():
    """The default device is CUDA: without a card the entry raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _ref, port_list = _lists("single")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wmec.solve_packed_list(port_list)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        genotyping.run_genotyping_batched([], None)


# ---------------------------------------------------------------------------
# run_genotyping_batched
# ---------------------------------------------------------------------------


def _geno_specs(seed, n_ind, trios, n_pos, n_reads, n):
    """n genotyping instances of one shape as plain data: one read layout
    (spans and samples), one pedigree (genotypes, likelihoods, recombination
    costs) and, per instance, its own alleles and qualities.  The layout
    fixes K, so every instance packs to the same (C, K, T, P)."""
    rng = random.Random(seed)
    positions = sorted(rng.sample(range(10, 10 * n_pos + 400), n_pos))
    layout = []
    for i in range(n_reads):
        start = rng.randint(0, n_pos - 2)
        layout.append((f"r{i}", rng.randint(0, n_ind - 1), start, min(start + rng.randint(2, 8), n_pos)))
    gts = [[rng.randint(0, 2) for _ in range(n_pos)] for _ in range(n_ind)]
    gls = [[[10.0 ** (-rng.choice((0.0, 5.0, 20.0)) / 10.0) for _ in range(3)] for _ in range(n_pos)]
           for _ in range(n_ind)]
    recomb = [rng.choice([1, 2, 5]) for _ in range(n_pos)]
    reads = []
    for j in range(n):
        r = random.Random(seed * 1000 + j)
        reads.append([
            (name, sample, [(positions[p], r.randint(0, 1), r.choice([5, 10, 30])) for p in range(a, b)])
            for name, sample, a, b in layout
        ])
    return dict(positions=positions, reads=reads, gts=gts, gls=gls, trios=trios, recomb=recomb)


def _geno_packed(mod, pack, spec):
    """(packed list, pedigree) of `spec` in the data model of `mod`."""
    ped = mod.Pedigree(mod.NumericSampleIds())
    for i, (gts, gls) in enumerate(zip(spec["gts"], spec["gls"])):
        ped.add_individual(
            f"ind{i}",
            [mod.Genotype.from_index(g, 2) for g in gts],
            [mod.PhredGenotypeLikelihoods(t) for t in gls],
        )
    for f, m, c in spec["trios"]:
        ped.add_relationship(f"ind{f}", f"ind{m}", f"ind{c}")
    packed = []
    for reads in spec["reads"]:
        rs = mod.ReadSet()
        for name, sample, variants in reads:
            read = mod.Read(name, 50, 0, sample)
            for pos, allele, qual in variants:
                read.add_variant(pos, allele, qual)
            rs.add(read)
        rs.sort()
        packed.append(pack(rs, spec["recomb"], ped, False, spec["positions"],
                           check_conflicts=False, emission_tables=False))
    return packed, ped


GENO_LISTS = {
    "single": dict(seed=31, n_ind=1, trios=(), n_pos=9, n_reads=8, n=5),
    "trio": dict(seed=37, n_ind=3, trios=TRIO, n_pos=8, n_reads=9, n=4),
}


@pytest.mark.parametrize("kind", list(GENO_LISTS))
def test_run_genotyping_batched_matches_reference(kind):
    """Within rtol 1e-9 of the reference's run_genotyping_jax_batched in
    float64, identical NaN patterns (tests/test_genotyping_jax.py:68's bar),
    and equal to each instance's own run_genotyping."""
    spec = _geno_specs(**GENO_LISTS[kind])
    ref_list, ref_ped = _geno_packed(ref_core, ref_wmec.pack_problem, spec)
    port_list, ped = _geno_packed(core, wmec.pack_problem, spec)
    assert len({(p.n_cols, p.K, p.T, p.P) for p in port_list}) == 1
    ref = ref_genotyping_jax.run_genotyping_jax_batched(ref_list, ref_ped, dtype="f64")
    got = genotyping.run_genotyping_batched(port_list, ped, device="cpu")
    assert got.shape == ref.shape == (len(port_list), port_list[0].n_cols, len(ped), 3)
    assert got.dtype == np.float64
    nan = np.isnan(ref)
    np.testing.assert_array_equal(nan, np.isnan(got))
    np.testing.assert_allclose(got[~nan], ref[~nan], rtol=1e-9, atol=1e-300)
    for b, packed in enumerate(port_list):
        np.testing.assert_array_equal(got[b], genotyping.run_genotyping(packed, ped, device="cpu"))


def test_run_genotyping_batched_rejects_mixed_shapes():
    """Instances of different shapes raise ValueError naming the shapes; an
    empty list gives None, as the reference's."""
    spec = _geno_specs(**GENO_LISTS["single"])
    port_list, ped = _geno_packed(core, wmec.pack_problem, spec)
    other = dict(spec, positions=spec["positions"][:-1], recomb=spec["recomb"][:-1],
                 reads=[[(n, s, v[:-1] if v[-1][0] == spec["positions"][-1] else v) for n, s, v in r]
                        for r in spec["reads"][:1]])
    short, _ = _geno_packed(core, wmec.pack_problem, other)
    assert short[0].n_cols != port_list[0].n_cols
    with pytest.raises(ValueError, match="one shape"):
        genotyping.run_genotyping_batched(port_list + short, ped, device="cpu")
    assert genotyping.run_genotyping_batched([], ped, device="cpu") is None
    assert ref_genotyping_jax.run_genotyping_jax_batched([], None) is None


# ---------------------------------------------------------------------------
# testhelpers
# ---------------------------------------------------------------------------


def _reads(rs):
    """A ReadSet as plain data: each read's name, mapping qualities, source
    and sample ids and variants (position, allele, quality)."""
    return [
        (r.name, tuple(r.mapqs), r.source_id, r.sample_id, [(v.position, v.allele, v.quality) for v in r])
        for r in rs
    ]


def _to_module(mod, rs):
    """A ReadSet rebuilt in the data model of `mod`."""
    out = mod.ReadSet()
    for name, mapqs, source, sample, variants in _reads(rs):
        read = mod.Read(name, mapqs[0], source, sample)
        for pos, allele, qual in variants:
            read.add_variant(pos, allele, qual)
        out.add(read)
    return out


MATRICES = [
    ("""
     0 1 1 0
     10011 0
     1 0011
     """, None),
    ("""
     1  11010
     00 00101
     001 0101
     """, """
     2  13112
     11 23359
     223 5923
     """),
    ("""
     01 1
     1 0101
      1100 1
     """, None),
]
PEDIGREE_MATRICES = [
    """
    A111
    A0101
    B00111
    C 1 1
    """,
    """
    A0 1
    B11
    C 0011
    C1010
    """,
]


@pytest.mark.parametrize("case", range(len(MATRICES)))
@pytest.mark.parametrize("scale", [None, 3])
def test_string_to_readset_matches_reference(case, scale):
    s, w = MATRICES[case]
    sample_ids = [2, 0, 1] if case == 2 else None
    kw = dict(w=w, sample_ids=sample_ids, source_id=case, scale_quality=scale)
    assert _reads(testhelpers.string_to_readset(s, **kw)) == _reads(ref_testhelpers.string_to_readset(s, **kw))


@pytest.mark.parametrize("s", PEDIGREE_MATRICES)
def test_string_to_readset_pedigree_matches_reference(s):
    for scale in (None, 5):
        got = testhelpers.string_to_readset_pedigree(s, scaling_quality=scale)
        want = ref_testhelpers.string_to_readset_pedigree(s, scaling_quality=scale)
        assert _reads(got) == _reads(want)


def test_matrix_to_readset_matches_reference():
    lines = (REPO / "tests" / "test.matrix").read_text().splitlines(keepends=True)
    got = testhelpers.matrix_to_readset(lines)
    assert len(got) > 1
    assert _reads(got) == _reads(ref_testhelpers.matrix_to_readset(lines))
    with pytest.raises(AssertionError):
        testhelpers.matrix_to_readset(["2 1 01\n"])


def _random_readset(seed, n_reads, n_pos):
    """A port ReadSet of n_reads random reads over n_pos positions (several
    alleles a site, weights 1-9, some reads with allele 2)."""
    rng = random.Random(seed)
    rs = core.ReadSet()
    for i in range(n_reads):
        start = rng.randint(0, n_pos - 2)
        read = core.Read(f"Read {i + 1}", 50, 0, 0)
        for p in range(start, min(n_pos, start + rng.randint(2, 5))):
            read.add_variant((p + 1) * 10, rng.choice([0, 1, 1, 0, 2]), rng.randint(1, 9))
        rs.add(read)
    return rs


@pytest.mark.parametrize("all_heterozygous", [False, True])
@pytest.mark.parametrize("case", [f"matrix{i}" for i in range(len(MATRICES))] + [f"random{s}" for s in range(4)])
def test_brute_force_phase_matches_reference(case, all_heterozygous):
    """The same cost, partition, solution count and haplotypes (ties marked
    3) as the reference's oracle on the same reads."""
    if case.startswith("matrix"):
        s, w = MATRICES[int(case[6:])]
        rs = testhelpers.string_to_readset(s, w)
    else:
        seed = int(case[6:])
        rs = _random_readset(seed, 5 + seed, 6)
    got = testhelpers.brute_force_phase(rs, all_heterozygous)
    want = ref_testhelpers.brute_force_phase(_to_module(ref_core, rs), all_heterozygous)
    assert got == want


def test_genotype_helpers_match_reference():
    gts = [0, 1, 2, 3, -1]
    for ploidy in (1, 2, 3):
        got = testhelpers.canonic_index_list_to_biallelic_gt_list(gts, ploidy)
        want = ref_testhelpers.canonic_index_list_to_biallelic_gt_list(gts, ploidy)
        assert [g.as_vector() for g in got] == [g.as_vector() for g in want]
        for i in gts:
            assert (testhelpers.canonic_index_to_biallelic_gt(i, ploidy).as_vector()
                    == ref_testhelpers.canonic_index_to_biallelic_gt(i, ploidy).as_vector())


@pytest.mark.parametrize("a,b", [
    ([0.1, 0.2, 0.7], [0.1, 0.2, 0.7]),
    ([0.1, 0.2, 0.7], [0.1, 0.2, 0.7 + 1e-12]),
    ([0.1, 0.2, 0.7], [0.1, 0.25, 0.65]),
    ([1.0, 0.0, 0.0], [1.0, 0.0, 1e-8]),
])
def test_likelihoods_equal_matches_reference(a, b):
    got = testhelpers.likelihoods_equal(core.PhredGenotypeLikelihoods(a), core.PhredGenotypeLikelihoods(b))
    want = ref_testhelpers.likelihoods_equal(
        ref_core.PhredGenotypeLikelihoods(a), ref_core.PhredGenotypeLikelihoods(b))
    assert got == want
