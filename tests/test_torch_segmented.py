"""
Parity of the port's segmented (checkpoint and recompute) solve with the JAX
reference on the CPU: the carry mode and the carry-in tables mode of the
forward scan, the wrappers of kernel rows 9 and 10 (their plain versions on
CPU tensors), the walk that chains the segments, the segmented solve itself,
and the single-range route of run_dp and PedigreeDPTable when it segments.
The same numpy-seeded inputs go through both packages and every output must
be bit-equal (int32 DP: the tolerance is exact equality).  The reference's
Pallas kernels run in interpret mode (K >= 7, their lane minimum).  The CUDA
kernels are held against these plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import whatshap_tpu.core as ref_core
from whatshap_tpu.ops import wmec as ref_wmec
from whatshap_tpu.ops import wmec_pallas as ref_pallas
from whatshap_tpu.parallel import blocks as ref_blocks
from whatshap_tpu.parallel import workloads as ref_workloads
from whatshap_tpu.testhelpers import canonic_index_to_biallelic_gt

import whatshap_torch.core as core
from whatshap_torch.ops import wmec, wmec_cuda
from whatshap_torch.parallel import blocks

LANES = 128
TRIO = (3, ((0, 1, 2),))
QUARTET = (4, ((0, 1, 2), (0, 1, 3)))
PEDIGREES = {1: (1, ()), 4: TRIO, 16: QUARTET}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The mirror's column loop is many small torch ops, which run faster on
    one thread than on threads that the test workers of a run share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_packed(rng, n_pos, n_reads, pedigree, max_q=300, pkg=ref_core, mod=ref_wmec):
    """A random single-range instance (reads as tests/test_pallas_kernel.py
    builds them), packed by `mod` from `pkg`'s classes."""
    n_ind, trios = pedigree
    positions = [(i + 1) * 10 for i in range(n_pos)]
    rs = pkg.ReadSet()
    for i in range(n_reads):
        sample = int(rng.randint(0, n_ind))
        start = int(rng.randint(0, n_pos - 1))
        end = int(rng.randint(start + 1, n_pos))
        read = pkg.Read(f"R{i}", 50, 0, sample)
        for c in range(start, end + 1):
            if rng.rand() < 0.2 and c not in (start, end):
                continue
            read.add_variant(positions[c], int(rng.randint(0, 2)), int(rng.randint(1, max_q)))
        rs.add(read)
    rs.sort()
    ped = pkg.Pedigree(pkg.NumericSampleIds())
    for ind in range(n_ind):
        ped.add_individual(f"ind{ind}", [pkg.Genotype([0, 1])] * n_pos, None)
    for f, m, c in trios:
        ped.add_relationship(f"ind{f}", f"ind{m}", f"ind{c}")
    rc = [int(rng.randint(1, 10)) for _ in positions]
    return mod.pack_problem(rs, rc, ped, False, positions)


def _bucket(T, seed, n_blocks=2, c_pad=24, n_pos=20, n_reads=None, k_min=1):
    """Stacked numpy block arrays of random single-range instances of the
    pedigree with T transmission values, padded to one (c_pad, K >= k_min);
    block 0 gets weights times 23 (above bf16's exact 256).  Returns (K, P,
    arrays)."""
    rng = np.random.RandomState(seed)
    n_reads = n_reads or {1: 9, 4: 10, 16: 8}[T]
    packed = [_random_packed(rng, n_pos, n_reads, PEDIGREES[T]) for _ in range(n_blocks)]
    assert packed[0].T == T
    K = max(max(p.K for p in packed), k_min)
    arrays = list(ref_blocks.stack_blocks([ref_blocks.pad_block(p, c_pad, k_pad=K) for p in packed]))
    arrays[0][0] *= 23
    arrays[1][0] *= 23
    return K, packed[0].P, arrays


def _t(arrays):
    return blocks.to_device(arrays, "cpu")


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _split(arrays, at):
    return [a[:, :at] for a in arrays], [a[:, at:] for a in arrays]


def _eq(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    return port.shape == np.shape(ref) and np.array_equal(port, np.asarray(ref))


@pytest.mark.parametrize("T", [1, 4, 16])
def test_forward_scan_carry_modes_match_xla(T):
    """The mirror's carry mode and its tables mode from a carry, at exact K,
    against the reference's _forward_carry_scan and _forward_tables_scan; the
    carry is nonzero: the state after a scan over the preceding columns."""
    K, P, arrays = _bucket(T, seed=10 + T, c_pad=16 if T == 16 else 24, n_pos=14 if T == 16 else 20)
    head, tail = _split(arrays, 10)
    B = arrays[0].shape[0]
    refs = []
    for b in range(B):
        zero = (jnp.zeros((1 << K, T), jnp.int32), jnp.zeros((1 << K, T), jnp.int32), jnp.zeros((1 << K,), jnp.int32))
        carry_b = ref_wmec._forward_carry_scan(K, T, P, *_j([a[b] for a in head]), zero)
        carry_out = ref_wmec._forward_carry_scan(K, T, P, *_j([a[b] for a in tail]), carry_b)
        tables = ref_wmec._forward_tables_scan(K, T, P, *_j([a[b] for a in tail]), carry_b)
        refs.append(([np.asarray(x) for x in carry_b], [np.asarray(x) for x in carry_out], tables))
    carry0 = tuple(torch.from_numpy(np.stack([r[0][i] for r in refs])) for i in range(3))
    assert bool((carry0[0] != 0).any()) and bool((carry0[2] != 0).any())
    if T == 1:
        carry0 = (carry0[0], None, carry0[2])
    carry = wmec.forward_scan(K, T, P, *_t(tail), carry0=carry0, mode="carry")
    tabled = wmec.forward_scan(K, T, P, *_t(tail), carry0=carry0)
    assert carry[3] is None and carry[4] is None
    for b, (_c0, carry_r, tables_r) in enumerate(refs):
        for x, y, r in zip(carry[:3], tabled[:3], carry_r):
            assert _eq(x[b], r) and _eq(y[b], r)
        assert _eq(tabled[3][b], np.asarray(tables_r[3]).transpose(0, 2, 1))
        if T > 1:
            assert _eq(tabled[4][b], np.asarray(tables_r[4]).transpose(0, 2, 1))


def _lanes(x, T):
    """A port state (B, T, S) or (B, S) in the reference kernels' (R, 128)
    layout."""
    x = jnp.asarray(x.numpy())
    if x.ndim == 2:
        return x.reshape(x.shape[0], -1, LANES)
    return x.reshape(x.shape[0], T, -1, LANES)


def _t1_tie_bucket(K, C=32, B=3):
    """Stacked T=1 block arrays at exactly K slots, drawn so that ties
    abound: weights, base costs, rankw and assignment costs in {0, 1}, a
    quarter of the slots dying before each column."""
    rng = np.random.RandomState(70 + K)
    return [
        rng.randint(0, 2, (B, C, K, 4)).astype(np.float32),
        rng.randint(0, 2, (B, C, 1, 2, 2)).astype(np.int32),
        rng.randint(0, 2, (B, C, K)).astype(np.float32),
        rng.randint(0, 2, (B, C, 1, 4)).astype(np.int32),
        rng.rand(B, C, K) < 0.25,
        rng.randint(0, 3, (B, C)).astype(np.int32),
    ]


def _check_carry_wrappers(K, T, P, arrays, at):
    """Rows 9 and 10 through their wrappers over the columns from `at`, from
    the state after the columns before it, against the Pallas kernels."""
    head, tail = _split(arrays, at)
    tail = _t([np.ascontiguousarray(a) for a in tail])
    B, C, S = arrays[0].shape[0], arrays[0].shape[1] - at, 1 << K
    if T == 1:
        _pidx, dp, key = wmec_cuda.forward_t1(K, P, *_t([np.ascontiguousarray(a) for a in head]))
        carry = (dp, key)
        cost0, jmin0, key0 = _lanes(dp[:, None], T), jnp.zeros((B, 1, S // LANES, LANES), jnp.int32), _lanes(key, T)
        port_carry = wmec_cuda.forward_carry_t1(K, P, *tail, carry)
        port_pidx = wmec_cuda.forward_t1(K, P, *tail, carry=carry)[0][:, :, None]
        port_pjmin = None
    else:
        out = wmec_cuda.forward_t(K, T, P, *_t([np.ascontiguousarray(a) for a in head]))
        carry = tuple(out[2:])
        cost0, jmin0, key0 = _lanes(carry[0], T), _lanes(carry[1], T), _lanes(carry[2], T)
        port_carry = wmec_cuda.forward_carry_t(K, T, P, *tail, carry)
        port_pidx, port_pjmin = wmec_cuda.forward_t(K, T, P, *tail, carry=carry)[:2]
    assert bool((carry[0] != 0).any()) and bool((carry[-1] != 0).any())
    jt = [jnp.asarray(a.numpy()) for a in tail]
    ref_carry = ref_pallas.forward_carry_pallas(K, T, P, *jt, cost0, jmin0, key0, interpret=True)
    ref_pidx, ref_pjmin = ref_pallas.forward_tables_pallas(K, T, P, *jt, cost0, jmin0, key0, interpret=True)
    ref_cost, ref_jmin, ref_key = (np.asarray(x) for x in ref_carry)
    if T == 1:
        assert _eq(port_carry[0], ref_cost.reshape(B, S)) and _eq(port_carry[1], ref_key.reshape(B, S))
        assert ref_pjmin is None
    else:
        for x, r in zip(port_carry, (ref_cost, ref_jmin, ref_key)):
            assert _eq(x, r.reshape(x.shape))
        assert _eq(port_pjmin, np.asarray(ref_pjmin).reshape(B, C, T, S))
    assert _eq(port_pidx, np.asarray(ref_pidx).reshape(B, C, T, S))
    # what the backtrace kernels' guesses rest on, in the reference's tables
    # from a carry: an index changes only in the slots dying before its
    # column, and pjmin is constant along those bits
    die = wmec_cuda.pack_die(tail[4]).numpy()[:, :, None, None].astype(np.int64)
    v = np.arange(S)
    assert not np.any((np.asarray(ref_pidx).reshape(B, C, T, S) ^ v) & ~die)
    if T > 1:
        pj = np.asarray(ref_pjmin).reshape(B, C, T, S)
        assert np.array_equal(pj, np.take_along_axis(pj, np.broadcast_to(v & ~die, pj.shape), axis=-1))


@pytest.mark.parametrize("T", [1, 4])
def test_carry_wrappers_match_pallas(T):
    """Rows 9 and 10 through their wrappers (the plain versions, on CPU
    tensors) against forward_carry_pallas and forward_tables_pallas in
    interpret mode, from a nonzero carry, at the kernels' padded K; at T = 1
    also on tie-heavy buckets at K = 7 and 9.  The reference's tables from
    the carry must also have the shape the backtrace kernels' guesses rest
    on (an index changes only in its column's dying bits)."""
    K, P, arrays = _bucket(T, seed=20 + T, c_pad=12, n_pos=12, k_min=ref_pallas.LANE_BITS)
    _check_carry_wrappers(K, T, P, arrays, 7)
    if T == 1:
        for K in (7, 9):
            _check_carry_wrappers(K, T, P, _t1_tie_bucket(K), 16)


@pytest.mark.parametrize("T", [1, 4])
def test_segment_walk_final_matches_pallas(T):
    """A segment's walk from a carry-in tables pass, on the mirror
    (walk_segment) and on the kernel route's walk (plain backtrace
    versions), against backtrace_pallas / backtrace_pallas_t in interpret
    mode: the paths and `final`, the state the preceding segment's walk
    starts from."""
    K, P, arrays = _bucket(T, seed=30 + T, c_pad=16, n_pos=14, k_min=ref_pallas.LANE_BITS)
    head, tail = _split(arrays, 6)
    B, C, S = arrays[0].shape[0], 10, 1 << K
    carry = wmec.forward_carry(
        K, T, P, *_t([np.ascontiguousarray(a) for a in head]),
        (torch.zeros((B, T, S), dtype=torch.int32),) * 2 + (torch.zeros((B, S), dtype=torch.int32),),
    )
    pidx, pjmin = wmec.forward_tables(K, T, P, *_t([np.ascontiguousarray(a) for a in tail]), carry)
    rng = np.random.RandomState(T)
    state = np.stack([rng.randint(0, S, B), rng.randint(0, T, B), rng.randint(0, T, B)], axis=1)
    state = torch.from_numpy(state.astype(np.int32))
    if T == 1:
        state[:, 1:] = 0
        ref_ip, ref_final = ref_pallas.backtrace_pallas(
            K, jnp.asarray(state[:, 0].numpy()), jnp.asarray(pidx.numpy()).reshape(B, C, -1, LANES),
            interpret=True,
        )
        ref_tp = np.zeros((B, C), np.int32)
        ref_final = np.stack([np.asarray(ref_final), np.zeros(B, np.int32), np.zeros(B, np.int32)], axis=1)
    else:
        ref_ip, ref_tp, ref_final = ref_pallas.backtrace_pallas_t(
            K, T, jnp.asarray(state.numpy()), jnp.asarray(pidx.numpy()).reshape(B, C, T, -1, LANES),
            jnp.asarray(pjmin.numpy()).reshape(B, C, T, -1, LANES), interpret=True,
        )
    die_prev = _t([np.ascontiguousarray(a) for a in tail])[4]
    for walk in (wmec.walk_segment, wmec_cuda._walk):
        ip, tp, final = walk(state, pidx, pjmin, die_prev)
        assert _eq(ip, ref_ip) and _eq(tp, ref_tp) and _eq(final, ref_final), walk.__name__


def _pallas_single_workload():
    """The inputs of tests/test_pallas_kernel.py:143 (two blocks of 48
    columns at coverage 8, K padded to >= 7)."""
    packed = []
    for b in range(2):
        rs, positions, _ = ref_blocks.make_synthetic_readset(48, 8, read_len=8, seed=43 + b)
        ped = ref_core.Pedigree(ref_core.NumericSampleIds())
        ped.add_individual("s", [canonic_index_to_biallelic_gt(1) for _ in positions], [None] * len(positions))
        packed.append(ref_wmec.pack_problem(rs, [1] * len(positions), ped, False))
    K = max(max(p.K for p in packed), ref_pallas.LANE_BITS)
    return K, 1, 2, ref_blocks.stack_blocks([ref_blocks.pad_block(p, 48, k_pad=K) for p in packed])


def _pallas_trio_workload():
    """The inputs of tests/test_pallas_kernel.py:152 (two trio blocks padded
    to 16 columns)."""
    K, T, P, _packed, arrays = ref_workloads.build_trio_batch(
        2, n_pos=12, n_reads=10, seed=51, c_pad=16, k_pad=None
    )
    K = max(K, ref_pallas.LANE_BITS)
    _K, _T, _P, packed, _a = ref_workloads.build_trio_batch(2, n_pos=12, n_reads=10, seed=51, c_pad=16)
    return K, T, P, ref_blocks.stack_blocks([ref_blocks.pad_block(p, 16, k_pad=K) for p in packed])


@functools.lru_cache(maxsize=None)
def _pallas_segmented(name):
    """The workload `name` and the reference's wmec_pallas.solve_segmented
    of it in interpret mode, at tests/test_pallas_kernel.py's segment length
    (16 for the single sample, 4 for the trio), once per test process."""
    if name == "single":
        K, T, P, arrays = _pallas_single_workload()
        seg = 16
    else:
        K, T, P, arrays = _pallas_trio_workload()
        seg = 4
    ref = ref_pallas.solve_segmented(K, T, P, *_j(arrays), seg=seg, interpret=True)
    return K, T, P, arrays, [np.asarray(x) for x in ref]


@pytest.mark.parametrize("name,seg", [("single", 16), ("single", 48), ("single", 8), ("trio", 4), ("trio", 16)])
def test_segmented_solve_matches_pallas(name, seg):
    """The port's segmented solve, on the kernel route's passes (plain
    versions) and on the mirror, at several segment lengths (seg = C is one
    segment) against wmec_pallas.solve_segmented in interpret mode on the
    inputs of tests/test_pallas_kernel.py:140-158 (which it holds equal to
    the unsegmented solve)."""
    K, T, P, arrays, ref = _pallas_segmented(name)
    for solve in (wmec_cuda.solve_segmented_cuda, wmec.solve_segmented):
        out = solve(K, T, P, *_t(arrays), seg)
        for x, r in zip(out, ref):
            assert x.dtype == torch.int32 and _eq(x, r), solve.__name__


def _exact_single(n_cols, c_pad):
    """tests/test_highcov_segmented.py:49's instance at exact K, padded to
    c_pad columns."""
    rs, positions, _ = ref_blocks.make_synthetic_readset(n_cols, 8, read_len=8, seed=4)
    ped = ref_core.Pedigree(ref_core.NumericSampleIds())
    ped.add_individual("s", [canonic_index_to_biallelic_gt(1) for _ in positions], [None] * len(positions))
    packed = ref_wmec.pack_problem(rs, [1] * len(positions), ped, False)
    return packed.K, 1, 2, ref_blocks.stack_blocks([ref_blocks.pad_block(packed, c_pad)])


def _exact_trio():
    """tests/test_highcov_segmented.py:59's trio instance at exact K."""
    K, T, P, _packed, arrays = ref_workloads.build_trio_batch(1, n_pos=32, n_reads=20, seed=9, c_pad=32)
    return K, T, P, arrays


@pytest.mark.parametrize(
    "name,seg",
    # (single, 24): 64 columns padded to 72, a multiple of the segment
    [("single", 16), ("single", 64), ("single", 24), ("trio", 8)],
)
def test_segmented_solve_matches_scan_segmented(name, seg):
    """The port's segmented solve at exact K against the reference's
    solve_scan_segmented (the XLA scan route) on the inputs of
    tests/test_highcov_segmented.py:48-68."""
    if name == "single":
        K, T, P, arrays = _exact_single(64, 72 if seg == 24 else 64)
    else:
        K, T, P, arrays = _exact_trio()
    ref = ref_wmec.solve_scan_segmented(K, T, P, *_j([a[0] for a in arrays]), seg=seg)
    for solve in (wmec_cuda.solve_segmented_cuda, wmec.solve_segmented):
        cost, ip, tp = solve(K, T, P, *_t(arrays), seg)
        assert int(cost[0]) == ref.optimal_cost, solve.__name__
        assert np.array_equal(ip[0].numpy(), ref.index_path)
        assert np.array_equal(tp[0].numpy(), ref.trans_path)


def test_segmented_solve_wide_matches_scan_segmented():
    """Past the T=1 cluster kernel's ceiling, where the reference runs its
    XLA scan: the segmented solve at K = 18 in three segments of one column
    (the reference's XLA scan takes seconds a column here) against
    solve_scan_segmented, on the kernel route's wrappers (plain on the CPU)
    and through solve_segmented_auto."""
    K, seg = 18, 1
    rng = np.random.RandomState(18)
    arrays = [
        rng.randint(-40, 41, (1, 3, K, 4)).astype(np.float32) * 37,
        rng.randint(0, 60, (1, 3, 1, 2, 2)).astype(np.int32),
        (2.0 ** np.stack([[rng.permutation(K) for _ in range(3)]])).astype(np.float32),
        rng.randint(0, 3, (1, 3, 1, 4)).astype(np.int32),
        rng.rand(1, 3, K) < 0.3,
        np.zeros((1, 3), np.int32),
    ]
    arrays[4][:, 0] = True
    ref = ref_wmec.solve_scan_segmented(K, 1, 2, *_j([a[0] for a in arrays]), seg=seg)
    for solve in (wmec_cuda.solve_segmented_cuda, wmec.solve_segmented_auto):
        cost, ip, tp = solve(K, 1, 2, *_t(arrays), seg)
        assert int(cost[0]) == ref.optimal_cost, solve.__name__
        assert np.array_equal(ip[0].numpy(), ref.index_path)
        assert np.array_equal(tp[0].numpy(), ref.trans_path)


def test_segmented_solve_needs_whole_segments():
    K, T, P, arrays = _exact_single(40, 40)
    with pytest.raises(ValueError, match="multiple"):
        wmec.solve_segmented(K, T, P, *_t(arrays), 16)


def test_segment_length_follows_the_reference():
    """The reference's rule (whatshap_tpu/ops/wmec.py:1889-1890)."""
    assert wmec.SEGMENT_TABLE_BUDGET == ref_wmec.SEGMENT_TABLE_BUDGET
    for K, T in [(15, 1), (15, 4), (17, 1), (13, 16), (8, 1), (20, 1), (16, 4)]:
        per_col = (1 << K) * T * 4 * (2 if T > 1 else 1)
        ref = max(256, min(2048, ref_wmec._next_pow2(ref_wmec.SEGMENT_TABLE_BUDGET // per_col, lo=256) >> 1))
        assert wmec._segment_length(K, T) == ref
    assert (wmec._segment_length(15, 1), wmec._segment_length(15, 4), wmec._segment_length(17, 1)) == (2048, 512, 1024)


def test_when_to_segment(monkeypatch):
    """On a device with a table budget the single range segments exactly
    where the unsegmented launch would not fit (tables plus the kernel's
    state); on the CPU above twice SEGMENT_TABLE_BUDGET."""
    dev = torch.device("cpu")
    K, T = 15, 1
    assert wmec._single_range_segment(16384, K, T, dev) is None  # 2 GiB of tables
    assert wmec._single_range_segment(16385, K, T, dev) == 2048  # 4 GiB
    assert wmec._single_range_segment(2048, K, 4, dev) is None  # 2048 columns of 1 MiB
    assert wmec._single_range_segment(2049, K, 4, dev) == 512  # padded to 4096: 4 GiB
    C = 8192
    tables = C * (4 << K)
    monkeypatch.setattr(wmec, "SEGMENT_TABLE_BUDGET", tables // 2 - 1)
    assert wmec._single_range_segment(C, K, T, dev) == wmec._segment_length(K, T)
    need = tables + wmec_cuda.state_bytes(K, T)
    monkeypatch.setattr(wmec, "_table_budget", lambda device: need)
    assert wmec._single_range_segment(C, K, T, dev) is None
    monkeypatch.setattr(wmec, "_table_budget", lambda device: need - 1)
    assert wmec._single_range_segment(C, K, T, dev) == wmec._segment_length(K, T)


def test_segment_beyond_the_budget_raises(monkeypatch):
    """A segment whose tables, kernel state and checkpoints exceed the table
    budget raises instead of launching."""
    K, T, P, arrays = _exact_single(64, 64)
    ta = _t(arrays)
    monkeypatch.setattr(wmec, "_table_budget", lambda device: 16 * (4 << K))
    with pytest.raises(NotImplementedError, match="budget"):
        wmec.solve_segmented_auto(K, T, P, *ta, 32)
    monkeypatch.setattr(wmec, "_table_budget", lambda device: 1 << 30)
    out = wmec.solve_segmented_auto(K, T, P, *ta, 32)
    for x, y in zip(out, wmec.solve_batched(K, T, P, *ta)):
        assert torch.equal(x, y)


def _tiled_specs(seed, n_pos, n_ind, lanes):
    """Reads of one read-connected range: each individual's reads tile the
    columns in `lanes` lanes, 3-10 columns long, each read starting at the
    previous one's last column (so K <= 2 * lanes * n_ind).  Returns
    (positions, [(name, sample, [(position, allele, quality), ...])],
    recombination costs), from a seed."""
    rng = np.random.RandomState(seed)
    positions = [(i + 1) * 10 for i in range(n_pos)]
    specs = []
    for ind in range(n_ind):
        for lane in range(lanes):
            start = int(rng.randint(0, 3))
            while start < n_pos - 1:
                end = min(start + int(rng.randint(3, 11)), n_pos) - 1
                specs.append((f"i{ind}_l{lane}_{start}", ind, [
                    (positions[c], int(rng.randint(0, 2)), int(rng.randint(1, 60)))
                    for c in range(start, end + 1)
                ]))
                start = end
    return positions, specs, [int(x) for x in rng.randint(1, 10, size=n_pos)]


def _build(pkg, positions, specs, n_ind, trios):
    """ReadSet and Pedigree in `pkg` (either core module) from specs."""
    rs = pkg.ReadSet()
    for name, sample, variants in specs:
        read = pkg.Read(name, 50, 0, sample)
        for pos, allele, q in variants:
            read.add_variant(pos, allele, q)
        rs.add(read)
    rs.sort()
    ped = pkg.Pedigree(pkg.NumericSampleIds())
    for ind in range(n_ind):
        ped.add_individual(f"ind{ind}", [pkg.Genotype([0, 1])] * len(positions), None)
    for f, m, c in trios:
        ped.add_relationship(f"ind{f}", f"ind{m}", f"ind{c}")
    return rs, ped


def _single_range_pair(kind, seed):
    """(port packed, reference packed) of one single-range instance: a
    single sample of 300 columns in three lanes, a trio of 280 in one lane
    each, or a coverage-17 sample of 32 columns (K = 17)."""
    if kind == "k17":
        rs_r, positions, _ = ref_blocks.make_synthetic_readset(32, 17, read_len=8, seed=seed)
        rs_p, _pos, _h = blocks.make_synthetic_readset(32, 17, read_len=8, seed=seed)
        out = []
        for pkg, mod, rs in ((core, wmec, rs_p), (ref_core, ref_wmec, rs_r)):
            ped = pkg.Pedigree(pkg.NumericSampleIds())
            ped.add_individual("s", [pkg.Genotype([0, 1])] * len(positions), [None] * len(positions))
            out.append(mod.pack_problem(rs, [1] * len(positions), ped, False))
        return out
    n_ind, trios = PEDIGREES[1 if kind == "single" else 4]
    positions, specs, rc = _tiled_specs(seed, 300 if kind == "single" else 280, n_ind, 3 if n_ind == 1 else 1)
    out = []
    for pkg, mod in ((core, wmec), (ref_core, ref_wmec)):
        rs, ped = _build(pkg, positions, specs, n_ind, trios)
        out.append(mod.pack_problem(rs, rc, ped, False, positions))
    return out


@pytest.mark.parametrize("kind", ["single", "trio", "k17"])
def test_run_dp_segments_a_single_range(kind, monkeypatch):
    """run_dp(device="cpu") takes the segmented route once the tables would
    pass twice SEGMENT_TABLE_BUDGET (shrunk here), and equals the
    reference's numpy route: cost, index and transmission paths and
    partitioning.  The K = 17 instance has 32 columns, cut into segments of
    12."""
    packed, ref_packed = _single_range_pair(kind, seed=5)
    assert len(wmec.connected_column_ranges(packed)) == 1
    assert packed.K == (17 if kind == "k17" else packed.K) and packed.T == (4 if kind == "trio" else 1)
    monkeypatch.setattr(wmec, "SEGMENT_TABLE_BUDGET", 1 << 10)
    if kind == "k17":
        monkeypatch.setattr(wmec, "_segment_length", lambda K, T: 12)
    segs = []
    orig = wmec_cuda.solve_segmented_cuda

    def spy(K, T, P, *arrays):
        segs.append((arrays[0].shape[1], arrays[-1]))
        return orig(K, T, P, *arrays)

    monkeypatch.setattr(wmec_cuda, "solve_segmented_cuda", spy)
    port = wmec.run_dp(packed, "cpu")
    c_pad, seg = segs[0]
    assert len(segs) == 1 and c_pad % seg == 0 and c_pad // seg >= 2 and packed.n_cols % seg
    ref = ref_wmec.run_dp(ref_packed, backend="numpy")
    assert port.optimal_cost == ref.optimal_cost
    assert np.array_equal(port.index_path, ref.index_path)
    assert np.array_equal(port.trans_path, ref.trans_path)
    assert wmec.extract_partitioning(packed, port) == ref_wmec.extract_partitioning(ref_packed, ref)


def test_pedigree_dptable_segmented_route(monkeypatch):
    """PedigreeDPTable(device="cpu") with the segmented route forced equals
    the reference's PedigreeDPTable on the same reads: a trio of 280
    columns in two segments of 256."""
    positions, specs, rc = _tiled_specs(8, 280, 3, 1)
    monkeypatch.setattr(wmec, "SEGMENT_TABLE_BUDGET", 1 << 10)
    calls = []
    orig = wmec_cuda.solve_segmented_cuda
    monkeypatch.setattr(wmec_cuda, "solve_segmented_cuda", lambda *a: calls.append(a[-1]) or orig(*a))
    tables = []
    for pkg in (core, ref_core):
        rs, ped = _build(pkg, positions, specs, *TRIO)
        kw = {"device": "cpu"} if pkg is core else {}
        tables.append(pkg.PedigreeDPTable(rs, rc, ped, False, positions, **kw))
    assert calls == [256]
    port, ref = tables
    assert port.get_optimal_cost() == ref.get_optimal_cost()
    assert port.get_optimal_partitioning() == ref.get_optimal_partitioning()
    (p_super, p_trans), (r_super, r_trans) = port.get_super_reads(), ref.get_super_reads()
    assert list(p_trans) == list(r_trans)
    for ps, rs_ in zip(p_super, r_super):
        for p_read, r_read in zip(ps, rs_):
            assert [(v.position, v.allele, v.quality) for v in p_read] == [
                (v.position, v.allele, v.quality) for v in r_read
            ]


def test_carry_wrappers_check_inputs():
    K, P, arrays = _bucket(1, seed=50, c_pad=16, n_pos=14)
    ta = list(_t(arrays))
    B, S = ta[0].shape[0], 1 << K
    good = (torch.zeros((B, S), dtype=torch.int32), torch.zeros((B, S), dtype=torch.int32))
    with pytest.raises(ValueError):
        wmec_cuda.forward_carry_t1(K, P, *ta, None)
    with pytest.raises(ValueError):
        wmec_cuda.forward_carry_t1(K, P, *ta, (good[0][:, :-1].contiguous(), good[1]))
    with pytest.raises(ValueError):
        wmec_cuda.forward_t1(K, P, *ta, carry=(good[0].long(), good[1]))
    K, P, arrays = _bucket(4, seed=51, c_pad=16, n_pos=14)
    ta = list(_t(arrays))
    B, S, T = ta[0].shape[0], 1 << K, 4
    carry = (torch.zeros((B, T, S), dtype=torch.int32),) * 2 + (torch.zeros((B, S), dtype=torch.int32),)
    with pytest.raises(ValueError, match="exclusive"):
        wmec_cuda.forward_t(K, T, P, *ta, torch.zeros((B, T), dtype=torch.int32), carry)
    with pytest.raises(ValueError):
        wmec_cuda.forward_carry_t(K, T, P, *ta, None)
    with pytest.raises(ValueError):
        wmec_cuda.forward_carry_t(K, T, P, *ta, carry[:2] + (carry[2][:, :-1].contiguous(),))
    with pytest.raises(ValueError, match="exclusive"):
        wmec.forward_scan(K, T, P, *ta, dp0=torch.zeros((B, T), dtype=torch.int32),
                          carry0=(carry[0].transpose(1, 2), carry[1].transpose(1, 2), carry[2]))


def test_segmented_wrappers_count_kernel_launches_only():
    """On CPU tensors the segmented route's wrappers run their plain
    versions: no launch is counted."""
    counters = (wmec_cuda.forward_carry_t1, wmec_cuda.forward_t1, wmec_cuda.backtrace_t1,
                wmec_cuda.forward_carry_t, wmec_cuda.forward_t, wmec_cuda.backtrace_t)
    before = [f.launches for f in counters]
    for T in (1, 4):
        K, P, arrays = _bucket(T, seed=60 + T, c_pad=16, n_pos=14)
        wmec_cuda.solve_segmented_cuda(K, T, P, *_t(arrays), 8)
    assert [f.launches for f in counters] == before
