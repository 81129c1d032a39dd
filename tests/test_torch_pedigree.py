"""
Parity of the port's pedigree (T > 1) route with the JAX reference on the
CPU: the general-T forward scan in its tables and m-only modes, unseeded and
seeded, the general-T backtrace at M = 1 and M = T + 1 walks per block, the
seeded solve, the host seam chain, run_dp_batched_pedigree and
PedigreeDPTable.  The same numpy-seeded inputs go through both packages and
every output must be bit-equal (int32 DP: the tolerance is exact equality).
The reference's Pallas kernels run in interpret mode (K >= 7, their lane
minimum).  The CUDA kernels are held against these plain versions on the
card in tests/test_torch_cuda.py and chip_smoke.py.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import whatshap_tpu.core as ref_core
from whatshap_tpu.ops import wmec as ref_wmec
from whatshap_tpu.ops import wmec_pallas as ref_pallas
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


INF = wmec.INF
TRIO = (3, ((0, 1, 2),))
QUARTET = (4, ((0, 1, 2), (0, 1, 3)))  # two children of shared parents
THREE_GENERATIONS = (5, ((0, 1, 2), (2, 3, 4)))  # the middle one is child and parent


def _specs(seed, n_blocks, cols, reads, n_ind, max_q=30):
    """Reads of a chromosome of `n_blocks` read-connected blocks:
    [(name, sample, [(position, allele, quality), ...])], from a seed."""
    rng = random.Random(seed)
    specs, base = [], 100
    for _b in range(n_blocks):
        block_positions = [base + 10 * i for i in range(cols)]
        for _ in range(reads):
            start = rng.randrange(0, cols - 1)
            length = rng.randint(2, cols - start)
            variants = [
                (block_positions[c], rng.randint(0, 1), rng.randint(1, max_q))
                for c in range(start, start + length)
            ]
            specs.append((f"r{len(specs)}", len(specs) % n_ind, variants))
        base += 10 * cols + 5000  # no read spans two blocks
    return specs


def _build(pkg, specs, seed, n_ind, trios):
    """ReadSet, recombination costs, positions and Pedigree in `pkg` (either
    core module) from the same specs."""
    rs = pkg.ReadSet()
    for name, sample, variants in specs:
        read = pkg.Read(name, 50, 0, sample)
        for pos, allele, q in variants:
            read.add_variant(pos, allele, q)
        rs.add(read)
    rs.sort()
    positions = sorted(rs.get_positions())
    ped = pkg.Pedigree(pkg.NumericSampleIds())
    for ind in range(n_ind):
        ped.add_individual(f"ind{ind}", [pkg.Genotype([0, 1])] * len(positions), None)
    for f, m, c in trios:
        ped.add_relationship(f"ind{f}", f"ind{m}", f"ind{c}")
    rng = random.Random(seed + 1)
    recomb = [rng.randint(1, 10) for _ in positions]
    return rs, recomb, positions, ped


def _packed_pair(specs, seed, pedigree):
    """The same instance packed by the port and by the reference."""
    n_ind, trios = pedigree
    out = []
    for pkg, mod in ((core, wmec), (ref_core, ref_wmec)):
        rs, recomb, positions, ped = _build(pkg, specs, seed, n_ind, trios)
        out.append((mod.pack_problem(rs, recomb, ped, False, positions), ped))
    return out


def _bucket(seed, pedigree=TRIO, n_blocks=2, c_pad=32, k_min=ref_pallas.LANE_BITS):
    """Stacked numpy block arrays of independent single-range instances,
    padded to one (c_pad, K >= k_min); block 0 gets weights times 37.
    Returns (K, T, P, arrays)."""
    packed = []
    for b in range(n_blocks):
        specs = _specs(seed + b, 1, min(20, c_pad), 12, pedigree[0], max_q=60)
        packed.append(_packed_pair(specs, seed + b, pedigree)[1][0])
    K = max(max(p.K for p in packed), k_min)
    arrays = list(ref_blocks.stack_blocks([ref_blocks.pad_block(p, c_pad, k_pad=K) for p in packed]))
    arrays[0][0] *= 37
    arrays[1][0] *= 37
    return K, packed[0].T, packed[0].P, arrays


def _seeds(rng, B, T):
    dp0 = rng.randint(0, 200, size=(B, T)).astype(np.int32)
    dp0[rng.rand(B, T) < 0.3] = INF
    dp0[:, 0] = np.minimum(dp0[:, 0], 50)  # at least one finite entry
    return dp0


def _t(arrays):
    return blocks.to_device(arrays, "cpu")


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _eq(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    return port.shape == np.shape(ref) and np.array_equal(port, np.asarray(ref))


@pytest.mark.parametrize("seeded", [False, True])
def test_forward_tables_mode_matches_reference(seeded):
    """(a) The T = 4 forward scan with tables, unseeded against
    forward_scan_pallas and the XLA scan, seeded against
    forward_tables_seeded_pallas: the wrapper's plain version and the
    mirror."""
    K, T, P, arrays = _bucket(seed=3 if seeded else 4, c_pad=16)
    B, C, S = arrays[0].shape[0], arrays[0].shape[1], 1 << K
    assert T == 4 and wmec_cuda.kernel_supported(K, T, P)
    dp0 = _seeds(np.random.RandomState(5), B, T) if seeded else None
    extra = (torch.from_numpy(dp0),) if seeded else ()
    port = wmec_cuda.forward_t(K, T, P, *_t(arrays), *extra)
    if seeded:
        ref = ref_pallas.forward_tables_seeded_pallas(
            K, T, P, *_j(arrays), jnp.asarray(dp0), interpret=True
        )
        ref = [np.asarray(x).reshape(s) for x, s in zip(ref, [(B, C, T, S)] * 2 + [(B, T, S)] * 2 + [(B, S)])]
    else:
        dp_r, jmin_r, key_r, pidx_r, pjmin_r = (
            np.asarray(x) for x in ref_pallas.forward_scan_pallas(K, T, P, *_j(arrays), interpret=True)
        )
        ref = [pidx_r.transpose(0, 1, 3, 2), pjmin_r.transpose(0, 1, 3, 2),
               dp_r.transpose(0, 2, 1), jmin_r.transpose(0, 2, 1), key_r]
        for b in range(B):  # the XLA scan, one block at a time
            xla = [np.asarray(x) for x in ref_wmec._forward_scan(K, T, P, *_j([a[b] for a in arrays]))]
            assert np.array_equal(xla[3].transpose(0, 2, 1), ref[0][b])
            assert np.array_equal(xla[0], dp_r[b])
    for x, r in zip(port, ref):
        assert x.dtype == torch.int32 and _eq(x, r)
    mirror = wmec.forward_scan(K, T, P, *_t(arrays), dp0=extra[0] if seeded else None)
    assert _eq(mirror[3], ref[0]) and _eq(mirror[4], ref[1])
    assert _eq(mirror[0].transpose(1, 2), ref[2]) and _eq(mirror[2], ref[4])


@pytest.mark.parametrize("pedigree", [TRIO, QUARTET])
def test_forward_m_mode_matches_reference(pedigree):
    """(b) The seeded m-only scan: forward_m_batched (mirror) and forward_m_t
    (plain on the CPU) against the reference's forward_m_batched and, for
    the trio, forward_m_seeded_pallas (its T = 16 body takes ~20 s to trace
    in interpret mode), seeds with INF entries."""
    K, T, P, arrays = _bucket(seed=11, pedigree=pedigree, c_pad=16 if pedigree == TRIO else 8)
    dp0 = _seeds(np.random.RandomState(6), arrays[0].shape[0], T)
    ref_x = np.asarray(ref_wmec.forward_m_batched(K, T, P, *_j(arrays), jnp.asarray(dp0)))
    if T == 4:
        ref_p = ref_pallas.forward_m_seeded_pallas(K, T, P, *_j(arrays), jnp.asarray(dp0), interpret=True)
        assert np.array_equal(np.asarray(ref_p), ref_x)
    for fn in (wmec.forward_m_batched, wmec_cuda.forward_m_t, wmec.forward_m_auto):
        m = fn(K, T, P, *_t(arrays), torch.from_numpy(dp0))
        assert m.dtype == torch.int32 and _eq(m, ref_x), fn.__name__


def test_solve_seeded_matches_reference():
    """(c) The seeded solve of pass 2, all 8 outputs: the mirror and the
    kernel route (plain on the CPU) against solve_seeded_batched_pallas
    (interpret) and the reference's solve_seeded_batched."""
    K, T, P, arrays = _bucket(seed=21, c_pad=16)
    rng = np.random.RandomState(7)
    B = arrays[0].shape[0]
    dp0 = _seeds(rng, B, T)
    die_next = rng.rand(B, K) < 0.6
    ref_p = ref_wmec.solve_seeded_batched_pallas(
        K, T, P, *_j(arrays), jnp.asarray(dp0), jnp.asarray(die_next), interpret=True
    )
    ref_x = ref_wmec.solve_seeded_batched(K, T, P, *_j(arrays), jnp.asarray(dp0), jnp.asarray(die_next))
    for a, b in zip(ref_p, ref_x):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for fn in (wmec.solve_seeded_batched, wmec_cuda.solve_seeded_batched_cuda):
        out = fn(K, T, P, *_t(arrays), torch.from_numpy(dp0), torch.from_numpy(die_next))
        assert len(out) == 8
        for i, (x, r) in enumerate(zip(out, ref_x)):
            assert x.dtype == torch.int32 and _eq(x, r), (fn.__name__, i)


@pytest.mark.parametrize("multi", [False, True])
def test_backtrace_matches_reference(multi):
    """(d) The general-T walk's plain version at M = 1 (backtrace_pallas_t)
    and M = T + 1 (backtrace_pallas_t_multi), from the optimum and from
    arbitrary starts."""
    K, T, P, arrays = _bucket(seed=31, c_pad=16)
    ta = _t(arrays)
    die = wmec_cuda.pack_die(ta[4])
    pidx, pjmin, dp_last, jmin_last, key_last = wmec_cuda.forward_t(K, T, P, *ta)
    B, C, S = pidx.shape[0], pidx.shape[1], 1 << K
    _m, head = wmec_cuda._head_init(K, T, dp_last, jmin_last, key_last)
    rng = np.random.RandomState(8)
    M = T + 1 if multi else 1
    rand = np.stack(
        [rng.randint(0, S, (B, M)), rng.randint(0, T, (B, M)), rng.randint(0, T, (B, M))], axis=2
    ).astype(np.int32)
    pidx_r = jnp.asarray(pidx.numpy()).reshape(B, C, T, S >> 7, 128)
    pjmin_r = jnp.asarray(pjmin.numpy()).reshape(B, C, T, S >> 7, 128)
    for init in (torch.from_numpy(rand), head[:, None].expand(B, M, 3).contiguous()):
        path, tpath, final = wmec_cuda.backtrace_t(init.contiguous(), pidx, pjmin, die)
        if multi:
            ref = ref_pallas.backtrace_pallas_t_multi(K, T, M, jnp.asarray(init.numpy()), pidx_r, pjmin_r, interpret=True)
        else:
            ref = ref_pallas.backtrace_pallas_t(K, T, jnp.asarray(init[:, 0].numpy()), pidx_r, pjmin_r, interpret=True)
            ref = [np.asarray(x)[:, None] for x in ref]
        for x, r in zip((path, tpath, final), ref):
            assert _eq(x, r)


def _reference_host_chain(m_rows, rep_of, reps):
    """The reference's host expansion and chain (run_dp_batched_pedigree),
    over m_rows (nb, R, T) in block order."""
    nb, _R, T = m_rows.shape
    a_idx, b_idx = np.arange(T)[:, None], np.arange(T)[None, :]
    row_sel = rep_of[a_idx]
    col_sel = b_idx ^ a_idx ^ reps[rep_of[a_idx]]
    G = np.stack([m_rows[j][row_sel, col_sel] for j in range(nb)])
    m_in = np.zeros((nb, T), dtype=np.int64)
    m_cur = np.minimum(G[0].min(axis=0), INF)
    for j in range(1, nb):
        m_in[j] = m_cur
        m_cur = np.minimum((m_cur[:, None] + G[j]).min(axis=0), INF)
    return m_in


@pytest.mark.parametrize("pedigree", [TRIO, QUARTET])
def test_seam_chain_matches_reference(pedigree):
    """(e) chain_seams against the reference's host chain and, for a
    single-coset pedigree, its device chain (_seam_chain_device): INF
    saturation, and per-bucket parts in interleaved block order."""
    n_ind, trios = pedigree
    specs = _specs(2, 3, 5, 8, n_ind)
    (packed, _ped), (ref_packed, _rp) = _packed_pair(specs, 2, pedigree)
    assert packed.t_sym_masks == ref_packed.t_sym_masks
    T = packed.T
    rep_of, reps = wmec.coset_representatives(T, packed.t_sym_masks)
    R = len(reps)
    assert R == {3: 1, 4: 4}[n_ind]
    rng = np.random.RandomState(0)
    for _trial in range(6):
        nb = int(rng.randint(2, 30))
        m_rows = rng.randint(0, INF, size=(nb, R, T)).astype(np.int64)
        m_rows[rng.rand(nb, R, T) < 0.2] = INF
        order = list(range(0, nb, 2)) + list(range(1, nb, 2))
        split = nb // 2
        parts = [
            (order[:split], m_rows[order[:split]].reshape(-1, T).astype(np.int32)),
            (order[split:], m_rows[order[split:]].reshape(-1, T).astype(np.int32)),
        ]
        m_in = wmec.chain_seams(parts, nb, rep_of, reps)
        assert np.array_equal(m_in, _reference_host_chain(m_rows, rep_of, reps))
        if R == 1:
            row_of = np.empty(nb, np.int32)
            row_of[order] = np.arange(nb)
            nbp = ref_wmec._b_tier(nb)
            perm = np.full(nbp, nb, np.int32)
            perm[:nb] = row_of
            dev = ref_wmec._seam_chain_device(
                nbp, tuple(jnp.asarray(m) for _i, m in parts), jnp.asarray(perm)
            )
            assert np.array_equal(np.asarray(dev)[:nb].astype(np.int64), m_in)


FIXTURES = {
    "trio_s0": (0, TRIO, 4, 6, 9),
    "trio_s1": (1, TRIO, 4, 6, 9),
    "trio_s2": (2, TRIO, 5, 7, 10),
    "quartet": (3, QUARTET, 3, 5, 8),
    "three_generations": (23, THREE_GENERATIONS, 3, 5, 8),
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_batched_pedigree_route_matches_reference(name):
    """(f) The port's run_dp_batched_pedigree (kernel route, plain on the
    CPU, and the mirror as its solvers) against the reference's batched
    route and its host solve: cost, transmission path, partitioning, alleles
    and qualities; the index path against the reference's batched route."""
    seed, pedigree, n_blocks, cols, reads = FIXTURES[name]
    specs = _specs(seed, n_blocks, cols, reads, pedigree[0])
    (packed, ped), (ref_packed, ref_ped) = _packed_pair(specs, seed, pedigree)
    assert len(wmec.connected_column_ranges(packed)) > 1
    ref_batched = ref_wmec.run_dp_batched_pedigree(ref_packed)
    ref_host = ref_wmec.run_dp(ref_packed, backend="numpy")
    assert ref_batched.optimal_cost == ref_host.optimal_cost
    port = wmec.run_dp_batched_pedigree(packed, torch.device("cpu"))
    mirror = wmec.run_dp_batched_pedigree(
        packed, torch.device("cpu"), wmec.forward_m_batched, wmec.solve_seeded_batched
    )
    via_run_dp = wmec.run_dp(packed, "cpu")
    for res in (port, mirror, via_run_dp):
        assert res.optimal_cost == ref_host.optimal_cost
        assert np.array_equal(res.trans_path, ref_host.trans_path)
        assert np.array_equal(res.trans_path, ref_batched.trans_path)
        assert np.array_equal(res.index_path, ref_batched.index_path)
        assert wmec.extract_partitioning(packed, res) == ref_wmec.extract_partitioning(ref_packed, ref_host)
        for x, r in zip(wmec.extract_alleles(packed, res, ped), ref_wmec.extract_alleles(ref_packed, ref_host, ref_ped)):
            assert np.array_equal(x, r)


def test_pedigree_dptable_matches_reference():
    """(g) PedigreeDPTable(device="cpu") on a multi-range trio against the
    reference's PedigreeDPTable: cost, partitioning, superreads and the
    transmission vector."""
    specs = _specs(9, 4, 6, 10, 3)
    tables = []
    for pkg, extra in ((core, {"device": "cpu"}), (ref_core, {})):
        rs, recomb, positions, ped = _build(pkg, specs, 9, *TRIO)
        tables.append(pkg.PedigreeDPTable(rs, recomb, ped, False, positions, **extra))
    port, ref = tables
    assert len(wmec.connected_column_ranges(port._packed)) == 4
    assert port.get_optimal_cost() == ref.get_optimal_cost()
    assert port.get_optimal_partitioning() == ref.get_optimal_partitioning()
    sr_p, tv_p = port.get_super_reads()
    sr_r, tv_r = ref.get_super_reads()
    assert tv_p == tv_r and len(sr_p) == len(sr_r) == 3
    for rs_p, rs_r in zip(sr_p, sr_r):
        for a, b in zip(rs_p, rs_r):
            assert a.name == b.name and a.sample_id == b.sample_id
            assert [(v.position, v.allele, v.quality) for v in a] == [
                (v.position, v.allele, v.quality) for v in b
            ]


def test_single_range_trio_takes_the_single_block_route():
    """A pedigree that forms one range is solved as one block through
    solve_batched (T > 1): the same result as the reference's jax route."""
    specs = _specs(4, 1, 12, 14, 3)
    (packed, _ped), (ref_packed, _rp) = _packed_pair(specs, 4, TRIO)
    assert len(wmec.connected_column_ranges(packed)) == 1
    assert wmec.run_dp_batched_pedigree(packed, torch.device("cpu")) is None
    port = wmec.run_dp(packed, "cpu")
    ref = ref_wmec.run_dp(ref_packed, backend="jax")
    assert port.optimal_cost == ref.optimal_cost
    assert np.array_equal(port.index_path, ref.index_path)
    assert np.array_equal(port.trans_path, ref.trans_path)


def test_pedigree_wrappers_check_inputs():
    K, T, P, arrays = _bucket(seed=41, c_pad=16)
    ta = list(_t(arrays))
    B = ta[0].shape[0]
    with pytest.raises(ValueError):
        wmec_cuda.forward_t(K, T, 2, *ta)  # wdiff is (.., T*4*2), not T*2*2
    with pytest.raises(ValueError):
        wmec_cuda.forward_t(17, T, P, *ta)
    with pytest.raises(ValueError):
        wmec_cuda.forward_m_t(K, T, P, *ta, None)
    with pytest.raises(ValueError):
        wmec_cuda.forward_m_t(K, T, P, *ta, torch.zeros((B, T), dtype=torch.int64))
    pidx, pjmin, *_ = wmec_cuda.forward_t(K, T, P, *ta)
    die = wmec_cuda.pack_die(ta[4])
    init = torch.zeros((B, 1, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        wmec_cuda.backtrace_t(torch.zeros((B, 2), dtype=torch.int32), pidx, pjmin, die)
    with pytest.raises(ValueError):
        wmec_cuda.backtrace_t(init, pidx, pjmin[..., :-1], die)
    # the dying masks: (B, C) int32, contiguous, beside the tables
    with pytest.raises(ValueError):
        wmec_cuda.backtrace_t(init, pidx, pjmin, ta[4])
    with pytest.raises(ValueError):
        wmec_cuda.backtrace_t(init, pidx, pjmin, die.long())
    with pytest.raises(ValueError):
        wmec_cuda.backtrace_t(init, pidx, pjmin, die[:1])
    with pytest.raises(ValueError):
        wmec_cuda.backtrace_t(init, pidx, pjmin, die.t().contiguous().t())


def test_pedigree_wrappers_count_kernel_launches_only():
    """On CPU tensors the general-T wrappers run their plain versions: no
    launch is counted."""
    K, T, P, arrays = _bucket(seed=43, c_pad=16)
    counters = (wmec_cuda.forward_t, wmec_cuda.forward_m_t, wmec_cuda.backtrace_t)
    before = [f.launches for f in counters]
    ta = _t(arrays)
    wmec_cuda.solve_batched_cuda(K, T, P, *ta)
    dp0 = torch.zeros((ta[0].shape[0], T), dtype=torch.int32)
    wmec.forward_m_auto(K, T, P, *ta, dp0)
    assert [f.launches for f in counters] == before


def test_route_refuses_beyond_the_envelope_only_on_cuda():
    """Six trios (T = 4096), six founders (P = 12) or K = 24 at a trio run
    the mirror on the CPU; the auto solvers would raise NotImplementedError
    for such a shape on a CUDA device.  Three trios (T = 64), five trios (T
    = 1024) and five founders (P = 10), shapes this test refused before the
    wide general-T kernel took them, now take the kernels."""
    dev = torch.device("cuda")
    for shape in ((5, 4096, 4), (5, 16, 12), (24, 4, 4)):
        with pytest.raises(NotImplementedError, match="wider envelope"):
            wmec._pick(*shape, dev, wmec_cuda.solve_batched_cuda, wmec.solve_batched)
        assert wmec._pick(*shape, torch.device("cpu"), None, wmec.solve_batched) is wmec.solve_batched
    for shape in ((5, 64, 4), (14, 16, 4), (5, 1024, 4), (5, 16, 10), (23, 1024, 10)):
        assert wmec._pick(*shape, dev, wmec_cuda.solve_batched_cuda, wmec.solve_batched) is wmec_cuda.solve_batched_cuda
