"""
The port's main-path slice as a whole: whatshap_torch's PedigreeDPTable on
the CPU against whatshap_tpu's, on identical read lists built in each
package from the same numpy-seeded data.  Costs, partitionings, superreads
(alleles and qualities) and transmission vectors must be equal; so must the
packed problems and the index paths of the DP.
"""

import numpy as np
import pytest
import torch

import whatshap_tpu.core as ref_core
from whatshap_tpu.ops import wmec as ref_wmec

import whatshap_torch.core as core
from whatshap_torch.ops import wmec
from whatshap_torch.parallel import blocks


def _read_specs(seed, n_blocks=3, n_cols=20, coverage=5, gap=1000, max_q=40):
    """Reads of a chromosome made of `n_blocks` read-connected blocks:
    [(name, [(position, allele, quality), ...])], from a numpy seed."""
    rng = np.random.RandomState(seed)
    specs = []
    for blk in range(n_blocks):
        hap = rng.randint(0, 2, size=n_cols)
        offset = blk * (n_cols * 10 + gap)
        for lane in range(coverage):
            start = int(rng.randint(0, 3))
            while start < n_cols - 1:
                length = int(np.clip(rng.poisson(6), 2, n_cols - start))
                side = int(rng.randint(0, 2))
                variants = []
                for c in range(start, start + length):
                    allele = int(hap[c] if side == 0 else 1 - hap[c])
                    if rng.rand() < 0.1:
                        allele = 1 - allele
                    variants.append((offset + (c + 1) * 10, allele, int(rng.randint(1, max_q))))
                specs.append((f"b{blk}_l{lane}_{start}", variants))
                start += length
    return specs


def _build(pkg, specs, n_ind=1, trios=(), het=True):
    """ReadSet, positions and Pedigree of `pkg` (either core module)."""
    rs = pkg.ReadSet()
    for i, (name, variants) in enumerate(specs):
        read = pkg.Read(name, 50, 0, i % n_ind)
        for pos, allele, q in variants:
            read.add_variant(pos, allele, q)
        rs.add(read)
    rs.sort()
    positions = sorted({p for _n, v in specs for p, _a, _q in v})
    ped = pkg.Pedigree(pkg.NumericSampleIds())
    gt = pkg.Genotype([0, 1] if het else [0, 0])
    for ind in range(n_ind):
        ped.add_individual(f"ind{ind}", [gt for _ in positions], None)
    for f, m, c in trios:
        ped.add_relationship(f"ind{f}", f"ind{m}", f"ind{c}")
    return rs, positions, ped


def _tables(specs, recomb=1, **kw):
    out = []
    for pkg, extra in ((core, {"device": "cpu"}), (ref_core, {})):
        rs, positions, ped = _build(pkg, specs, **kw)
        out.append(pkg.PedigreeDPTable(rs, [recomb] * len(positions), ped, False, positions, **extra))
    return out


def _assert_same(port, ref):
    assert port.get_optimal_cost() == ref.get_optimal_cost()
    assert port.get_optimal_partitioning() == ref.get_optimal_partitioning()
    sr_p, tv_p = port.get_super_reads()
    sr_r, tv_r = ref.get_super_reads()
    assert tv_p == tv_r
    assert len(sr_p) == len(sr_r)
    for rs_p, rs_r in zip(sr_p, sr_r):
        for a, b in zip(rs_p, rs_r):
            assert a.name == b.name and a.sample_id == b.sample_id
            assert [(v.position, v.allele, v.quality) for v in a] == [
                (v.position, v.allele, v.quality) for v in b
            ]


@pytest.mark.parametrize("ref_backend", ["auto", "batched"])
def test_multi_range_chromosome_matches_reference(monkeypatch, ref_backend):
    """(d) A chromosome of several read-connected blocks: the port's batched
    route against the reference under its host route (auto) and under its
    own batched route."""
    if ref_backend == "batched":
        monkeypatch.setenv("WHATSHAP_TPU_BACKEND", "batched")
    specs = _read_specs(seed=3)
    port, ref = _tables(specs)
    assert len(wmec.connected_column_ranges(port._packed)) == 3
    _assert_same(port, ref)
    if ref_backend == "batched":
        # both batched routes slice each range to its exact K, so even the
        # inactive-slot bits of the index paths (don't-cares for every
        # output, and free to differ from the host route's) agree
        assert np.array_equal(port._result.index_path, ref._result.index_path)


def test_single_range_matches_reference():
    """(d) One read-connected block: the port's single-block route (B = 1)."""
    specs = _read_specs(seed=4, n_blocks=1, n_cols=24, coverage=6, max_q=3000)
    port, ref = _tables(specs, recomb=3)
    assert len(wmec.connected_column_ranges(port._packed)) == 1
    _assert_same(port, ref)
    jax_route = ref_wmec.run_dp(ref._packed, backend="jax")
    assert np.array_equal(port._result.index_path, jax_route.index_path)


@pytest.mark.parametrize("n_blocks", [1, 3])
def test_route_with_the_mirror_as_its_solve(n_blocks):
    """run_dp's `solve` seam: the same route with the torch mirror in place
    of the kernels' wrappers gives the same cost and index paths, on the
    batched route (3 ranges) and the single-block route (1 range)."""
    specs = _read_specs(seed=8, n_blocks=n_blocks)
    rs, positions, ped = _build(core, specs)
    packed = wmec.pack_problem(rs, [1] * len(positions), ped, False, positions)
    assert len(wmec.connected_column_ranges(packed)) == n_blocks
    route = wmec.run_dp(packed, "cpu")
    mirror = wmec.run_dp(packed, "cpu", solve=wmec.solve_batched)
    assert mirror.optimal_cost == route.optimal_cost
    assert np.array_equal(mirror.index_path, route.index_path)


def test_trio_on_cpu_matches_reference():
    """A trio (T = 4) through the torch mirror on the CPU, index and
    transmission paths included.  (On CUDA this raises until the pedigree
    slice is ported.)"""
    specs = _read_specs(seed=5, n_blocks=1, n_cols=10, coverage=4)
    port, ref = _tables(specs, n_ind=3, trios=((0, 1, 2),), recomb=2)
    assert port._packed.T == 4
    _assert_same(port, ref)
    jax_route = ref_wmec.run_dp(ref._packed, backend="jax")
    assert np.array_equal(port._result.index_path, jax_route.index_path)
    assert np.array_equal(port._result.trans_path, jax_route.trans_path)


def test_homozygous_and_empty_instances():
    specs = _read_specs(seed=6, n_blocks=2, n_cols=8, coverage=3)
    port, ref = _tables(specs, het=False)
    _assert_same(port, ref)
    for pkg, extra in ((core, {"device": "cpu"}), (ref_core, {})):
        ped = pkg.Pedigree(pkg.NumericSampleIds())
        ped.add_individual("s", [], None)
        table = pkg.PedigreeDPTable(pkg.ReadSet(), [], ped, False, [], **extra)
        assert table.get_optimal_cost() == 0 and table.get_optimal_partitioning() == []


def test_pack_problem_matches_reference():
    specs = _read_specs(seed=7)
    packed = []
    for pkg, mod in ((core, wmec), (ref_core, ref_wmec)):
        rs, positions, ped = _build(pkg, specs)
        packed.append(mod.pack_problem(rs, [1] * len(positions), ped, False, positions))
    port, ref = packed
    for field in ref.__dataclass_fields__:
        a, b = getattr(port, field), getattr(ref, field)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), field
        else:
            assert a == b, field


def test_synthetic_readset_matches_reference():
    from whatshap_tpu.parallel import blocks as ref_blocks

    rs_p, pos_p, hap_p = blocks.make_synthetic_readset(40, 4, read_len=6, seed=9)
    rs_r, pos_r, hap_r = ref_blocks.make_synthetic_readset(40, 4, read_len=6, seed=9)
    assert pos_p == pos_r and np.array_equal(hap_p, hap_r)
    assert [(r.name, list(r._positions), list(r._alleles), list(r._qualities)) for r in rs_p] == [
        (r.name, list(r._positions), list(r._alleles), list(r._qualities)) for r in rs_r
    ]


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    """(e) Without `device` the entry point asks for CUDA; where there is
    none it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rs, positions, ped = _build(core, _read_specs(seed=8, n_blocks=1, n_cols=6, coverage=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        core.PedigreeDPTable(rs, [1] * len(positions), ped, False, positions)
    with pytest.raises(RuntimeError, match="CUDA"):
        core.PedigreeDPTable(rs, [1] * len(positions), ped, False, positions, device="cuda")
    assert wmec.resolve_device("cpu").type == "cpu"
