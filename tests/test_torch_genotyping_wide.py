"""
Parity of the PyTorch port's genotyping past the cluster kernels' envelope
(families of three or more children, a third or fourth founder, K above
17) with the JAX reference on the CPU, where the reference runs its XLA
forward-backward (whatshap_tpu/ops/genotyping_jax.py _forward_backward).
Each instance is made from a seed with numpy, built once with each
package's own data model, and packed by each package's own pack_problem.

- the float64 plain route (run_genotyping on the CPU): likelihoods within
  rtol=1e-9 of the reference's f64 scan, identical NaN patterns;
- the float32 plain versions (the wide kernels' yardstick on the card):
  likelihoods within atol=3e-4 (2e-4 for one sample) of the reference's
  own f32 scan (its jax32 route), identical NaN patterns;
- GenotypeDPTable(device="cpu") within rtol=1e-9 of the reference's
  GenotypeDPTable on its jax route;
- the dispatch rule: which kernel each shape takes on the card, and which
  shapes raise (the launch stubbed: there is no card here).

The wide kernels are held against the plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import whatshap_tpu.core as ref_core
from whatshap_tpu.ops import genotyping_jax as ref_jax
from whatshap_tpu.ops import wmec as ref_wmec
from whatshap_tpu.solver import genotyping as ref_solver

import whatshap_torch.core as core
from whatshap_torch.ops import genotyping, genotyping_cuda, wmec

CPU = torch.device("cpu")
TRIO = ((0, 1, 2),)
FAMILY5 = ((0, 1, 2), (0, 1, 3), (0, 1, 4))  # three children: T = 64, P = 4
FAMILY6 = FAMILY5 + ((0, 1, 5),)  # four children: T = 256, P = 4
DOUBLE_TRIO = ((0, 1, 2), (2, 3, 4))  # three founders: T = 16, P = 6
FOUR_FOUNDERS = ((0, 1, 4), (2, 3, 5))  # T = 16, P = 8
FAMILY7 = tuple((0, 1, c) for c in range(2, 7))  # five children: T = 1024, P = 4
# two grandparent couples, their two children, an in-law and two
# grandchildren: four trios of five founders, T = 256, P = 10
FIVE_FOUNDERS = ((0, 1, 4), (2, 3, 5), (4, 5, 7), (4, 6, 8))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run many small ops: one thread each under the
    test runner's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(seed, trios, lanes, n_pos, zero_prior=None):
    """A genotyping instance as plain data: reads of individual i tile the
    columns in lanes[i] lanes (so K = sum(lanes)), seeded alleles, qualities
    and likelihood triples; with zero_prior = c the first individual's
    likelihoods at column c are all 0 (NaN spreads through the HMM as in
    the reference)."""
    rng = np.random.RandomState(seed)
    positions = ((np.arange(n_pos) + 1) * 10).tolist()
    reads = []
    for ind, n_lanes in enumerate(lanes):
        for lane in range(n_lanes):
            start = int(rng.randint(0, 2)) if n_pos > 3 else 0
            while start < n_pos - 1:
                length = int(np.clip(rng.poisson(4), 2, n_pos - start))
                reads.append((f"r{ind}_{lane}_{start}", ind, [
                    (positions[c], int(rng.randint(0, 2)), int(rng.choice([5, 10, 30])))
                    for c in range(start, start + length)
                ]))
                start += length
    gls = rng.rand(len(lanes), n_pos, 3) + 0.01
    if zero_prior is not None:
        gls[0, zero_prior] = 0.0
    recomb = rng.choice([1, 2, 5], size=n_pos).tolist()
    return dict(positions=positions, reads=reads, gls=gls.tolist(), trios=trios, recomb=recomb)


def _build(mod, spec):
    """(readset, pedigree, numeric sample ids) of `spec` in the data model
    of `mod` (the reference's or the port's core package)."""
    rs = mod.ReadSet()
    for name, sample, variants in spec["reads"]:
        read = mod.Read(name, 50, 0, sample)
        for pos, allele, qual in variants:
            read.add_variant(pos, allele, qual)
        rs.add(read)
    rs.sort()
    nsi = mod.NumericSampleIds()
    ped = mod.Pedigree(nsi)
    for i, gls in enumerate(spec["gls"]):
        ped.add_individual(f"ind{i}", [mod.Genotype([])] * len(gls), [mod.PhredGenotypeLikelihoods(t) for t in gls])
    for f, m, c in spec["trios"]:
        ped.add_relationship(f"ind{f}", f"ind{m}", f"ind{c}")
    return rs, ped, nsi


def _packed(spec):
    """The instance packed by both packages: ((ref packed, ref pedigree),
    (port packed, port pedigree))."""
    out = []
    for mod, pack in ((ref_core, ref_wmec.pack_problem), (core, wmec.pack_problem)):
        rs, ped, _nsi = _build(mod, spec)
        packed = pack(rs, spec["recomb"], ped, False, spec["positions"], check_conflicts=False, emission_tables=False)
        out.append((packed, ped))
    return out


def _assert_close(ref, port, rtol=0.0, atol=0.0):
    ref = np.asarray(ref, dtype=np.float64)
    port = np.asarray(port, dtype=np.float64)
    assert ref.shape == port.shape
    nan = np.isnan(ref)
    np.testing.assert_array_equal(nan, np.isnan(port))
    np.testing.assert_allclose(port[~nan], ref[~nan], rtol=rtol, atol=atol or 1e-300)


# (name, trios, lanes an individual, columns, zero-prior column, (K, T, P))
CASES = [
    ("family5-k9", FAMILY5, (2, 2, 2, 2, 1), 7, None, (9, 64, 4)),
    ("family5-k6-nan", FAMILY5, (2, 1, 1, 1, 1), 6, 2, (6, 64, 4)),
    ("double-trio-p6", DOUBLE_TRIO, (2, 2, 2, 1, 1), 7, None, (8, 16, 6)),
    ("four-founders-p8", FOUR_FOUNDERS, (1, 1, 1, 1, 1, 1), 6, None, (6, 16, 8)),
    ("family6-k6", FAMILY6, (1, 1, 1, 1, 1, 1), 5, None, (6, 256, 4)),
    ("trio-k17", TRIO, (6, 6, 5), 3, None, (17, 4, 4)),
    ("single-k18", (), (18,), 2, None, (18, 1, 2)),
    # five children (T = 1024), five founders (P = 10) at four trios, at one
    # trio and at two (three and two individuals outside any trio)
    ("family7-k7", FAMILY7, (1,) * 7, 4, None, (7, 1024, 4)),
    ("five-founders-p10", FIVE_FOUNDERS, (1, 1, 1, 1, 1, 1, 0, 0, 0), 4, None, (6, 256, 10)),
    ("trio-p10", TRIO, (2, 1, 1, 1, 1, 1), 4, None, (7, 4, 10)),
    ("four-founders-p10-nan", FOUR_FOUNDERS, (1,) * 7, 5, 1, (7, 16, 10)),
]
IDS = [c[0] for c in CASES]


def _case_spec(case, seed):
    name, trios, lanes, n_pos, zero_prior, shape = case
    spec = _spec(seed, trios, lanes, n_pos, zero_prior)
    (ref_p, ref_ped), (port_p, port_ped) = _packed(spec)
    assert (port_p.K, port_p.T, port_p.P) == shape == (ref_p.K, ref_p.T, ref_p.P), name
    K, T, P = shape
    assert not genotyping_cuda.kernel_supported(K, T, P) and genotyping_cuda.wide_supported(K, T, P)
    return spec, (ref_p, ref_ped), (port_p, port_ped)


@pytest.fixture(scope="module")
def results():
    """Per case: the reference's f64 and f32 scans, the port's float64 CPU
    route and its float32 plain versions' likelihoods."""
    out = {}
    for i, case in enumerate(CASES):
        _spec_, (ref_p, ref_ped), (port_p, port_ped) = _case_spec(case, 1600 + i)
        static, stacked = genotyping.prepare_genotyping_batch([port_p], port_ped)
        K, T, P, _n = static
        trans, passign, base, diff, birth, die_next, dup, gmask = stacked
        f32 = [torch.from_numpy(np.asarray(a, np.float32)) for a in (diff, base, passign, trans)]
        red, _scaling = genotyping.forward_backward_plain(
            K, T, P, f32[0], f32[1].reshape(1, -1, T * P * 2), f32[2].reshape(1, -1, T << P),
            f32[3].reshape(1, -1, T * T), torch.from_numpy(birth), torch.from_numpy(die_next),
            torch.from_numpy(dup.astype(np.float32)),
        )
        assert red.dtype == torch.float32
        out[case[0]] = dict(
            ref64=ref_jax.run_genotyping_jax(ref_p, ref_ped, dtype="f64"),
            ref32=ref_jax.run_genotyping_jax(ref_p, ref_ped, dtype="f32"),
            port64=genotyping.run_genotyping(port_p, port_ped, CPU),
            port32=genotyping.likelihoods_from_red(red.numpy(), gmask[0])[0],
        )
    return out


# ---------------------------------------------------------------------------
# (a) the float64 plain route against the reference's f64 scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", IDS)
def test_plain_f64_matches_reference_scan(results, name):
    r = results[name]
    _assert_close(r["ref64"], r["port64"], rtol=1e-9)
    assert np.isnan(r["port64"]).any() == name.endswith("nan")


# ---------------------------------------------------------------------------
# (b) the float32 plain versions against the reference's f32 scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", IDS)
def test_plain_f32_matches_reference_f32_scan(results, name):
    r = results[name]
    _assert_close(r["ref32"], r["port32"], atol=2e-4 if name.startswith("single") else 3e-4)
    assert np.isnan(r["port32"]).any() == name.endswith("nan")


# ---------------------------------------------------------------------------
# (c) GenotypeDPTable on the CPU against the reference's jax route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [CASES[i] for i in (0, 2, 7, 8)], ids=[IDS[i] for i in (0, 2, 7, 8)])
def test_genotype_dptable_cpu_matches_reference_jax_route(case, monkeypatch):
    spec, _ref, _port = _case_spec(case, 1700)
    monkeypatch.setenv("WHATSHAP_TPU_GENO_BACKEND", "jax")
    rs, ped, nsi = _build(ref_core, spec)
    ref = ref_solver.GenotypeDPTable(nsi, rs, spec["recomb"], ped, spec["positions"])
    rs_p, ped_p, nsi_p = _build(core, spec)
    port = core.GenotypeDPTable(nsi_p, rs_p, spec["recomb"], ped_p, spec["positions"], device="cpu")
    assert (port._packed.T, port._packed.P) == (case[5][1], case[5][2])
    for i in range(len(spec["gls"])):
        for pos in range(len(spec["positions"])):
            a = ref.get_genotype_likelihoods(f"ind{i}", pos).as_vector()
            b = port.get_genotype_likelihoods(f"ind{i}", pos).as_vector()
            _assert_close(a, b, rtol=1e-9)


# ---------------------------------------------------------------------------
# (d) the dispatch rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,T,P,supported", [
    (1, 1, 2, True), (18, 1, 2, True), (23, 1, 2, True), (24, 1, 2, False), (20, 1, 4, False),
    (17, 4, 4, True), (23, 4, 2, True), (15, 64, 4, True), (6, 256, 8, True), (12, 16, 6, True),
    (10, 16, 8, True), (24, 64, 4, False), (5, 1024, 4, True), (8, 64, 10, True), (23, 1024, 10, True),
    (5, 4096, 4, False), (8, 64, 12, False), (8, 64, 3, False),
    (0, 16, 4, False), (7, 8, 4, False),
])
def test_wide_envelope(K, T, P, supported):
    assert genotyping_cuda.wide_supported(K, T, P) == supported


def _stub_card(monkeypatch, launched):
    """Meta tensors treated as lying on a card of 132 SMs, each launch
    recorded by name instead of run."""
    monkeypatch.setattr(genotyping_cuda, "_check_device", lambda *ts: torch.device("cuda"))
    monkeypatch.setattr(genotyping_cuda, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(genotyping_cuda, "_run", lambda dev, name, *args: launched.append((name, args[-7:])))


def _meta_inputs(K, T, P, B=2, C=3):
    nA = 1 << P
    f = dict(dtype=torch.float32, device="meta")
    return (
        torch.empty((B, C, K, T * P * 2), **f), torch.empty((B, C, T * P * 2), **f),
        torch.empty((B, C, T * nA), **f), torch.empty((B, C, T * T), **f),
        torch.empty((B, C, K), dtype=torch.bool, device="meta"), torch.empty((B, C), **f),
    )


@pytest.mark.parametrize("K,T,P,kernel", [
    (17, 1, 2, "cluster"), (18, 1, 2, "wide"), (23, 1, 2, "wide"), (16, 4, 4, "cluster"), (17, 4, 4, "wide"),
    (13, 16, 4, "cluster"), (14, 16, 4, "wide"), (7, 16, 6, "wide"), (15, 64, 4, "wide"), (6, 256, 8, "wide"),
    (9, 1024, 4, "wide"), (8, 64, 10, "wide"), (24, 1, 2, None), (9, 4096, 4, None), (8, 64, 12, None),
])
def test_wrappers_dispatch_by_shape(monkeypatch, K, T, P, kernel):
    """On the card backward and forward launch the cluster kernel where
    kernel_supported, the wide kernel past it, and raise ValueError beyond
    both; the wide wrappers take their own envelope, inside the cluster
    kernel's too.  Each counts only its own kernel's launches."""
    launched = []
    counters = (genotyping_cuda.backward, genotyping_cuda.forward, genotyping_cuda.backward_wide,
                genotyping_cuda.forward_wide)
    before = [fn.launches for fn in counters]
    diff, base, passign, trans, flags, per_col = _meta_inputs(K, T, P)
    _stub_card(monkeypatch, launched)
    if kernel is None:
        with pytest.raises(ValueError, match="unsupported shape"):
            genotyping_cuda.backward(K, T, P, diff, base, passign, trans, flags, per_col)
        with pytest.raises(ValueError, match="unsupported shape"):
            genotyping_cuda.backward_wide(K, T, P, diff, base, passign, trans, flags, per_col)
        assert launched == []
        return
    beta, scaling = genotyping_cuda.backward(K, T, P, diff, base, passign, trans, flags, per_col)
    red = genotyping_cuda.forward(K, T, P, diff, base, passign, trans, flags, scaling, beta)
    assert beta.shape == (2, 3, T, 1 << K) and red.shape == (2, 3, T << P)
    genotyping_cuda.backward_wide(K, T, P, diff, base, passign, trans, flags, per_col)
    genotyping_cuda.forward_wide(K, T, P, diff, base, passign, trans, flags, scaling, beta)
    names = [name for name, _args in launched]
    suffix = "" if kernel == "cluster" else "_wide"
    assert names == [f"geno_backward{suffix}", f"geno_forward{suffix}", "geno_backward_wide", "geno_forward_wide"]
    max_ctas = min(2 * genotyping_cuda.wide_tiles(K, T), 8 * 132)
    assert launched[-1][1] == (2, 3, K, T, P, genotyping_cuda.wide_window_cap(T, P, backward=False), max_ctas)
    assert launched[-2][1] == (2, 3, K, T, P, genotyping_cuda.wide_window_cap(T, P, backward=True), max_ctas)
    wide = kernel == "wide"
    assert [fn.launches - b for fn, b in zip(counters, before)] == [1 - wide, 1 - wide, 1 + wide, 1 + wide]


def test_route_refuses_only_beyond_both_envelopes(monkeypatch):
    """The route's message names both envelopes and Queue 1 item 5, and the
    bytes an instance takes count its inputs' copy on the card and red (a
    column's diff, base, passign, trans and red in float32, the two flags,
    dup and scaling) and, past the cluster envelope only, the wide
    forward's alpha plane, its rows of partial sums of red (two a column of
    a window: 16 columns at T * 2^P = 1024 floats, one at 65,536), the
    backward's rows of partial sums and four words a column, with the rows
    of each CTA counted once a chunk."""
    err = genotyping._unsupported(24, 1, 2)
    assert "item 5" in str(err) and genotyping_cuda.WIDE_ENVELOPE in str(err) and "wider envelope" in str(err)

    def inputs(C, K, T, P):
        return C * (4 * (K * T * 2 * P + T * 2 * P + 2 * (T << P) + T * T) + 2 * K + 8)

    assert genotyping.instance_bytes(10, 15, 1, 2) == (10 * 4 << 15) + inputs(10, 15, 1, 2)
    rows_t64 = 2 * 16 * (64 * 4 << 4) + 8 * (1 + 1)
    rows_t256 = 2 * 1 * (256 * 4 << 8) + 8 * (1 + 1)
    rows_t1 = 2 * 16 * (1 * 4 << 2) + 8 * (1 + 16)
    assert genotyping.instance_bytes(10, 15, 64, 4) == (11 * 64 * 4 << 15) + rows_t64 + 16 * 10 + inputs(10, 15, 64, 4)
    assert genotyping.instance_bytes(10, 6, 256, 8) == (11 * 256 * 4 << 6) + rows_t256 + 16 * 10 + inputs(10, 6, 256, 8)
    assert genotyping.instance_bytes(10, 20, 1, 2) == (11 * 4 << 20) + rows_t1 + 16 * 10 + inputs(10, 20, 1, 2)
    # trans is 4 MiB a column at T = 1024
    assert inputs(1, 14, 1024, 4) > 4 << 20
    monkeypatch.setattr(genotyping_cuda, "_sm_count", lambda dev: 132)
    cuda = torch.device("cuda")
    assert genotyping.chunk_bytes(cuda, 15, 1, 2) == 0 and genotyping.chunk_bytes(torch.device("cpu"), 15, 64, 4) == 0
    assert genotyping.chunk_bytes(cuda, 15, 64, 4) == 8 * 132 * rows_t64
    assert genotyping.chunk_bytes(cuda, 3, 256, 8) == 8 * 132 * rows_t256
    assert genotyping.chunk_bytes(cuda, 20, 1, 2) == 8 * 132 * rows_t1
    assert genotyping_cuda.wide_tiles(15, 64) == 512 and genotyping_cuda.wide_tiles(20, 1) == 256
    assert genotyping_cuda.wide_tiles(6, 256) == 4 and genotyping_cuda.wide_tiles(3, 256) == 1


def _fold_flags(rng, B, C, K, kind):
    """Fold flags (B, C, K) of a kind: "sparse" (a slot folds with
    probability 1/10), "dense" (1/2), "starts" (sparse, with every slot
    folding at a few columns: range starts) or "mixed" (the instances
    differ: one sparse, one with range starts, one dense)."""
    if kind == "mixed":
        parts = [_fold_flags(rng, 1, C, K, k) for k in ("sparse", "starts", "dense")]
        return np.concatenate([parts[b % 3] for b in range(B)])
    f = rng.rand(B, C, K) < (0.5 if kind == "dense" else 0.1)
    if kind == "starts":
        f[:, rng.randint(0, C, size=3)] = True
    return f


@pytest.mark.parametrize("K,T,P,backward,kind", [
    (20, 1, 2, True, "sparse"), (20, 1, 2, False, "starts"), (23, 1, 2, True, "mixed"),
    (15, 64, 4, False, "sparse"), (15, 64, 4, True, "starts"), (10, 16, 6, False, "dense"),
    (6, 256, 8, False, "mixed"), (3, 4, 2, True, "dense"), (12, 4, 4, False, "mixed"),
])
def test_wide_windows_cover_every_column_once(K, T, P, backward, kind):
    """The wide kernels' window rule (its mirror, wide_windows): the windows
    cover every column once and in the pass's order, never cross a
    multiple of the window cap, and each holds every instance's fold slots
    of its columns within the tile bits, or is a single column whose slots
    pass them (further fold passes); a window ends only at the cap, at C or
    where the next column's slots would pass the tile bits."""
    rng = np.random.RandomState(K * 1000 + T * 10 + P)
    B, C = 3, 150
    flags = _fold_flags(rng, B, C, K, kind)
    lb = genotyping_cuda.wide_lb(K, T)
    assert 1 << lb == min(1 << K, genotyping_cuda.WIDE_TILE // T)
    wcap = genotyping_cuda.wide_window_cap(T, P, backward)
    uq = genotyping_cuda.wide_unions(torch.from_numpy(flags), backward)
    win = genotyping_cuda.wide_windows(uq, lb, wcap)
    masks = (flags.astype(np.int64) << np.arange(K)).sum(axis=2)  # (B, C)
    if backward:
        masks[:, 0] = 0
        masks = masks[:, ::-1]  # by pass order
    assert len(win) == C
    q, n_windows = 0, 0
    while q < C:
        n = win[q]
        assert 1 <= n <= wcap and q // wcap == (q + n - 1) // wcap
        assert all(w == 0 for w in win[q + 1 : q + n])
        per_instance = np.bitwise_or.reduce(masks[:, q : q + n], axis=1)
        if n > 1:
            assert all(bin(int(m)).count("1") <= lb for m in per_instance)
        union = int(np.bitwise_or.reduce(per_instance))
        assert union == int(np.bitwise_or.reduce(uq[q : q + n]))
        end = q + n
        if end < C and end % wcap:
            assert bin(union | int(uq[end])).count("1") > lb or bin(union).count("1") > lb
        q, n_windows = end, n_windows + 1
    assert q == C and n_windows >= -(-C // wcap)


def test_wide_window_caps():
    """Window caps: the forward 16 columns where red's partial rows of a
    window stay within 16,384 floats a CTA and instance, fewer past that;
    the backward 16 at T = 1 and one column past it."""
    cap = genotyping_cuda.wide_window_cap
    assert [cap(1, 2, False), cap(64, 4, False), cap(64, 6, False), cap(256, 4, False), cap(256, 8, False)] == [
        16, 16, 4, 4, 1]
    assert [cap(1, 2, True), cap(4, 2, True), cap(64, 4, True), cap(256, 8, True)] == [16, 1, 1, 1]
    assert genotyping_cuda.wide_windows([0b1, 0b10, 0b100, 0b1, 0b111], 2, 16) == [2, 0, 2, 0, 1]
    assert genotyping_cuda.wide_windows([0b1] * 5, 1, 2) == [2, 0, 2, 0, 1]
