"""
Parity of the PyTorch port's genotyping forward-backward (whatshap_torch.ops.
genotyping, solver.genotyping) with the JAX reference on the CPU.  Each
instance is made from a seed with `random`, built once with each package's
own data model, and packed by each package's own pack_problem.

- host preparation: every array equal to the reference's, exactly;
- the float64 plain route: likelihoods within rtol=1e-9 of the reference's
  f64 XLA scan, identical NaN patterns (tests/test_genotyping_jax.py's bar);
- the float32 plain versions (the kernels' yardstick): red and scaling
  within rtol=1e-4 of the reference's Pallas kernels in interpret mode, and
  likelihoods within atol=2e-4 (one sample) and 3e-4 (trio) of the host
  long-double engine (tests/test_genotyping_pallas.py's bars);
- GenotypeDPTable(device="cpu") within rtol=1e-9 of the reference's
  GenotypeDPTable on its host route, and compute_genotypes equal.

The CUDA kernels are held against the plain versions on the card in
tests/test_torch_cuda.py.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import whatshap_tpu.core as ref_core
from whatshap_tpu.ops import genotyping as ref_host
from whatshap_tpu.ops import genotyping_jax as ref_jax
from whatshap_tpu.ops import genotyping_pallas as ref_pallas
from whatshap_tpu.ops import wmec as ref_wmec
from whatshap_tpu.solver import genotyping as ref_solver

import whatshap_torch.core as core
from whatshap_torch.ops import genotyping, genotyping_cuda, wmec

TRIO = ((0, 1, 2),)
QUARTET = ((0, 1, 2), (0, 1, 3))
CPU = torch.device("cpu")
KEYS = ("trans", "passign", "base", "diff", "birth", "die_next", "dup", "gmask")


def _spec(seed, n_ind, trios, n_pos, n_reads, span=(2, 8), gl_phreds=(0.0, 5.0, 20.0),
          zero_prior=None):
    """A random genotyping instance as plain data: positions, reads (name,
    sample, [(position, allele, quality)]), per-individual genotype indices
    and likelihood triples, recombination costs.  With zero_prior = c, the
    first individual's likelihoods at column c are all 0: that column's
    allele-assignment prior is 0/0, and NaN spreads through the HMM as in the
    reference."""
    rng = random.Random(seed)
    positions = sorted(rng.sample(range(10, 10 * n_pos + 400), n_pos))
    reads = []
    for i in range(n_reads):
        start = rng.randint(0, n_pos - 2)
        end = min(start + rng.randint(*span), n_pos)
        sample = rng.randint(0, n_ind - 1)
        reads.append((f"r{i}", sample, [
            (positions[p], rng.randint(0, 1), rng.choice([5, 10, 30])) for p in range(start, end)
        ]))
    gts = [[rng.randint(0, 2) for _ in range(n_pos)] for _ in range(n_ind)]
    gls = [[[10.0 ** (-rng.choice(gl_phreds) / 10.0) for _ in range(3)] for _ in range(n_pos)]
           for _ in range(n_ind)]
    if zero_prior is not None:
        gls[0][zero_prior] = [0.0, 0.0, 0.0]
    recomb = [rng.choice([1, 2, 5]) for _ in range(n_pos)]
    return dict(positions=positions, reads=reads, gts=gts, gls=gls, trios=trios, recomb=recomb)


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
    for i, (gts, gls) in enumerate(zip(spec["gts"], spec["gls"])):
        ped.add_individual(
            f"ind{i}",
            [mod.Genotype.from_index(g, 2) for g in gts],
            [mod.PhredGenotypeLikelihoods(t) for t in gls],
        )
    for f, m, c in spec["trios"]:
        ped.add_relationship(f"ind{f}", f"ind{m}", f"ind{c}")
    return rs, ped, nsi


def _packed(spec):
    """The instance packed by both packages: ((ref packed, ref pedigree),
    (port packed, port pedigree))."""
    out = []
    for mod, pack in ((ref_core, ref_wmec.pack_problem), (core, wmec.pack_problem)):
        rs, ped, _nsi = _build(mod, spec)
        packed = pack(rs, spec["recomb"], ped, False, spec["positions"],
                      check_conflicts=False, emission_tables=False)
        out.append((packed, ped))
    return out


def _assert_close(ref, port, rtol):
    ref = np.asarray(ref, dtype=np.float64)
    port = np.asarray(port, dtype=np.float64)
    assert ref.shape == port.shape
    nan = np.isnan(ref)
    np.testing.assert_array_equal(nan, np.isnan(port))
    np.testing.assert_allclose(port[~nan], ref[~nan], rtol=rtol, atol=1e-300)


SINGLE = [dict(seed=9000 + s, n_ind=1, trios=(), n_pos=random.Random(s).randint(3, 9),
               n_reads=random.Random(s).randint(2, 8)) for s in range(8)]
TRIOS = [dict(seed=9100 + s, n_ind=3, trios=TRIO, n_pos=random.Random(50 + s).randint(3, 9),
              n_reads=random.Random(50 + s).randint(3, 9)) for s in range(8)]
QUARTETS = [dict(seed=9200, n_ind=4, trios=QUARTET, n_pos=6, n_reads=6)]
for case in (SINGLE[2], SINGLE[6], TRIOS[1], TRIOS[4]):
    case["zero_prior"] = 1


# ---------------------------------------------------------------------------
# (a) host preparation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [SINGLE[0], SINGLE[2], TRIOS[0], TRIOS[4], QUARTETS[0]])
def test_prepare_inputs_equal_reference(case):
    (ref_p, ref_ped), (port_p, port_ped) = _packed(_spec(**case))
    ref = ref_jax._prepare_inputs(ref_p, ref_ped)
    port = genotyping._prepare_inputs(port_p, port_ped)
    assert list(port) == list(KEYS)
    for key in KEYS:
        a, b = np.asarray(ref[key]), np.asarray(port[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    static_ref, _ = ref_jax.prepare_genotyping_batch([ref_p], ref_ped)
    static_port, stacked = genotyping.prepare_genotyping_batch([port_p], port_ped)
    assert static_ref == static_port
    assert [a.shape[0] for a in stacked] == [1] * len(KEYS)


# ---------------------------------------------------------------------------
# (b) the float64 plain route against the reference's f64 scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "case", SINGLE + TRIOS + QUARTETS,
    ids=[f"single{i}" for i in range(8)] + [f"trio{i}" for i in range(8)] + ["quartet"],
)
def test_plain_f64_matches_reference_scan(case):
    (ref_p, ref_ped), (port_p, port_ped) = _packed(_spec(**case))
    ref = ref_jax.run_genotyping_jax(ref_p, ref_ped, dtype="f64")
    port = genotyping.run_genotyping(port_p, port_ped, CPU)
    _assert_close(ref, port, rtol=1e-9)
    assert np.isnan(port).any() == ("zero_prior" in case)


# ---------------------------------------------------------------------------
# (c) the float32 plain versions against the Pallas kernels (interpret mode)
# and the long-double host engine
# ---------------------------------------------------------------------------

F32_CASES = {
    "single": dict(seed=3, n_ind=1, trios=(), n_pos=24, n_reads=20, span=(3, 9)),
    "trio": dict(seed=11, n_ind=3, trios=TRIO, n_pos=14, n_reads=16, span=(3, 9)),
    "single-nan": dict(seed=5, n_ind=1, trios=(), n_pos=20, n_reads=18, span=(3, 9), zero_prior=9),
}


@pytest.fixture(scope="module")
def f32_results():
    """Per case: the reference's Pallas (red, scaling), the host engine's
    likelihoods, and the port's f32 plain (red, scaling) and likelihoods,
    on the same stacked inputs."""
    out = {}
    for name, case in F32_CASES.items():
        spec = _spec(**case, gl_phreds=(0.0, 5.0, 20.0, 40.0))
        (ref_p, ref_ped), (port_p, port_ped) = _packed(spec)
        static, stacked = ref_jax.prepare_genotyping_batch([ref_p], ref_ped)
        K, T, P, _n = static
        trans, passign, base, diff, birth, die_next, dup, gmask = (np.asarray(a) for a in stacked)
        red_ref, scaling_ref = ref_pallas.forward_backward_pallas(
            K, T, P, jnp.asarray(diff, jnp.float32), jnp.asarray(base, jnp.float32),
            jnp.asarray(passign, jnp.float32), jnp.asarray(trans, jnp.float32),
            jnp.asarray(birth), jnp.asarray(die_next), jnp.asarray(dup, jnp.float32),
            interpret=True,
        )
        f32 = [torch.from_numpy(np.asarray(a, np.float32)) for a in (diff, base, passign, trans)]
        red, scaling = genotyping.forward_backward_plain(
            K, T, P, *f32, torch.from_numpy(birth), torch.from_numpy(die_next),
            torch.from_numpy(dup.astype(np.float32)),
        )
        out[name] = dict(
            static=static, red_ref=np.asarray(red_ref), scaling_ref=np.asarray(scaling_ref),
            red=red.numpy(), scaling=scaling.numpy(),
            lik=genotyping.likelihoods_from_red(red.numpy(), gmask[0])[0],
            host=np.asarray(ref_host.run_genotyping(ref_p, ref_ped), dtype=np.float64),
        )
    return out


@pytest.mark.parametrize("name", list(F32_CASES))
def test_plain_f32_matches_pallas_kernels(f32_results, name):
    r = f32_results[name]
    assert r["static"][0] >= 7
    assert r["red"].dtype == np.float32 and r["red"].shape == r["red_ref"].shape
    _assert_close(r["scaling_ref"], r["scaling"], rtol=1e-4)
    _assert_close(r["red_ref"], r["red"], rtol=1e-4)
    assert np.isnan(r["red"]).any() == name.endswith("nan")


@pytest.mark.parametrize("name,atol", [("single", 2e-4), ("trio", 3e-4)])
def test_plain_f32_likelihoods_match_host_engine(f32_results, name, atol):
    r = f32_results[name]
    host = r["host"]
    assert not np.isnan(host).any()
    np.testing.assert_allclose(r["lik"], host, atol=atol)


def test_plain_f32_matches_pallas_kernels_at_k17():
    """K = 17 at T = 1, the reference kernel's ceiling (T * 2^P * 2^K = 2^19)
    and the kernels' since the cluster layout: 17 reads of one sample that
    all overlap columns 2-4 of 8, starting and ending at seeded columns;
    the float32 plain versions within rtol=1e-4 of the reference's Pallas
    kernels in interpret mode."""
    rng = np.random.RandomState(17)
    spec = _spec(seed=170, n_ind=1, trios=(), n_pos=8, n_reads=2, gl_phreds=(0.0, 5.0, 20.0, 40.0))
    pos = spec["positions"]
    spec["reads"] = [
        (f"k{i}", 0, [(pos[c], int(rng.randint(0, 2)), int(rng.choice([5, 10, 30])))
                      for c in range(rng.randint(0, 3), rng.randint(5, 9))])
        for i in range(17)
    ]
    (ref_p, ref_ped), (port_p, port_ped) = _packed(spec)
    static, stacked = ref_jax.prepare_genotyping_batch([ref_p], ref_ped)
    K, T, P, _n = static
    assert (K, T, P) == (17, 1, 2) and ref_pallas.kernel_supported(K, T, P)
    assert genotyping_cuda.kernel_supported(K, T, P)
    trans, passign, base, diff, birth, die_next, dup, _gmask = (np.asarray(a) for a in stacked)
    red_ref, scaling_ref = ref_pallas.forward_backward_pallas(
        K, T, P, jnp.asarray(diff, jnp.float32), jnp.asarray(base, jnp.float32),
        jnp.asarray(passign, jnp.float32), jnp.asarray(trans, jnp.float32),
        jnp.asarray(birth), jnp.asarray(die_next), jnp.asarray(dup, jnp.float32),
        interpret=True,
    )
    f32 = [torch.from_numpy(np.asarray(a, np.float32)) for a in (diff, base, passign, trans)]
    red, scaling = genotyping.forward_backward_plain(
        K, T, P, *f32, torch.from_numpy(birth), torch.from_numpy(die_next),
        torch.from_numpy(dup.astype(np.float32)),
    )
    _assert_close(np.asarray(scaling_ref), scaling.numpy(), rtol=1e-4)
    _assert_close(np.asarray(red_ref), red.numpy(), rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_wrappers_on_cpu_run_the_plain_versions(dtype):
    """backward and forward on CPU tensors in the kernels' layout equal the
    plain versions in the inputs' dtype, count no launch, and refuse mixed
    dtypes, other float types and misshaped tables."""
    spec = _spec(**F32_CASES["trio"])
    (_ref, _rped), (port_p, port_ped) = _packed(spec)
    static, stacked = genotyping.prepare_genotyping_batch([port_p], port_ped)
    K, T, P, _n = static
    diff, base, passign, trans, birth, die_next, dup = (
        t.to(dtype) if t.is_floating_point() else t for t in genotyping.to_device(stacked, CPU)
    )
    launches = (genotyping_cuda.backward.launches, genotyping_cuda.forward.launches)
    beta_store, scaling = genotyping_cuda.backward(K, T, P, diff, base, passign, trans, birth, dup)
    red = genotyping_cuda.forward(K, T, P, diff, base, passign, trans, die_next, scaling, beta_store)
    assert (genotyping_cuda.backward.launches, genotyping_cuda.forward.launches) == launches
    ref_red, ref_scaling = genotyping.forward_backward_plain(
        K, T, P, diff, base, passign, trans, birth, die_next, dup
    )
    assert beta_store.shape == (1, port_p.n_cols, T, 1 << K)
    assert red.dtype == scaling.dtype == beta_store.dtype == dtype
    assert torch.equal(scaling, ref_scaling) and torch.equal(red.reshape(ref_red.shape), ref_red)
    other = torch.float64 if dtype == torch.float32 else torch.float32
    with pytest.raises(ValueError, match="base"):
        genotyping_cuda.backward(K, T, P, diff, base.to(other), passign, trans, birth, dup)
    with pytest.raises(ValueError, match="float32"):
        genotyping_cuda.backward(K, T, P, diff.half(), base, passign, trans, birth, dup)
    with pytest.raises(ValueError, match="diff"):
        genotyping_cuda.backward(K, 64, P, diff, base, passign, trans, birth, dup)
    with pytest.raises(ValueError, match="beta_store"):
        genotyping_cuda.forward(K, T, P, diff, base, passign, trans, die_next, scaling, beta_store[..., 1:])


@pytest.mark.parametrize("K,T,P,supported", [
    (16, 1, 2, True), (17, 1, 2, True), (18, 1, 2, False), (16, 4, 4, True), (16, 4, 2, True),
    (17, 4, 4, False), (13, 16, 4, True), (14, 16, 4, False), (7, 64, 4, False), (7, 4, 6, False),
    (0, 1, 2, False),
])
def test_kernel_envelope(K, T, P, supported):
    assert genotyping_cuda.kernel_supported(K, T, P) == supported


def test_state_bytes_split_shared_and_global():
    """Every supported shape keeps its state on chip: split over a cluster of
    at most 16 CTAs, at most 64 KB of it per CTA, in registers (T * 2^reg_bits
    <= 32 floats a thread, at most 512 threads); no device-memory scratch.
    The cluster leaves each CTA 2^9 states or more."""
    for T, k_max in genotyping_cuda.MAX_K_T.items():
        for K in range(1, k_max + 1):
            cta_bits, reg_bits, threads = genotyping_cuda.cluster_layout(K)
            assert cta_bits == min(4, max(0, K - 9))
            assert threads <= 512 and T << reg_bits <= 32
            assert threads << reg_bits << cta_bits == max(1 << K, 32 << reg_bits << cta_bits)
            assert (T * 4 << K) >> cta_bits <= 64 << 10
    assert genotyping_cuda.cluster_layout(17) == (4, 4, 512)
    assert genotyping_cuda.cluster_layout(15) == (4, 2, 512)
    assert genotyping_cuda.cluster_layout(13) == (4, 0, 512)
    assert genotyping_cuda.cluster_layout(12) == (3, 0, 512)
    assert genotyping_cuda.cluster_layout(10) == (1, 0, 512)
    assert genotyping_cuda.cluster_layout(7) == (0, 0, 128)
    assert genotyping_cuda.cluster_layout(3) == (0, 0, 32)
    # K = 15 over 16 CTAs: lanes 0-4, warps 5-8, CTA ranks 9-12, registers 13-14
    flags = torch.zeros((1, 2, 15), dtype=torch.bool)
    assert genotyping_cuda.fold_levels(15, flags) == set()
    flags[0, 1, [4, 5, 12]] = True
    assert genotyping_cuda.fold_levels(15, flags) == {"lane", "warp", "cta", "top"}
    flags[0, 0, 13] = True
    assert genotyping_cuda.fold_levels(15, flags) == {"lane", "warp", "cta", "top", "register"}
    # K = 12 over 8 CTAs: CTA ranks 9-11, no register bits
    assert genotyping_cuda.fold_levels(12, flags[..., :12]) == {"lane", "warp"}
    flags[0, 0, 11] = True
    assert genotyping_cuda.fold_levels(12, flags[..., :12]) == {"lane", "warp", "cta", "top"}


def test_route_chunks_under_the_table_budget(monkeypatch):
    """Instances beyond the table budget are split into sequential chunks
    with the same result; an instance that alone exceeds it raises.  An
    instance's bytes are genotyping.instance_bytes: its beta table and its
    inputs' copy on the card."""
    packs = []
    for s in range(3):
        spec = _spec(seed=700, n_ind=1, trios=(), n_pos=8, n_reads=6)
        spec["gls"] = _spec(seed=800 + s, n_ind=1, trios=(), n_pos=8, n_reads=6)["gls"]
        packs.append(_packed(spec)[1])
    static, stacked = genotyping.prepare_genotyping_batch([p for p, _ in packs], packs[0][1])
    K, T, P, _n = static
    whole = genotyping.launch_genotyping(static, stacked, CPU)
    C = stacked[3].shape[1]
    per = genotyping.instance_bytes(C, K, T, P)
    assert per == (C * T * 4 << K) + genotyping.input_bytes(C, K, T, P)
    calls = []
    plain = genotyping_cuda.backward_plain
    monkeypatch.setattr(genotyping_cuda, "backward_plain", lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setattr(wmec, "_table_budget", lambda device: 2 * per)
    chunked = genotyping.launch_genotyping(static, stacked, CPU)
    assert len(calls) == 2
    np.testing.assert_array_equal(whole, chunked)
    monkeypatch.setattr(wmec, "_table_budget", lambda device: per - 1)
    with pytest.raises(NotImplementedError, match="table budget"):
        genotyping.launch_genotyping(static, stacked, CPU)


# ---------------------------------------------------------------------------
# (d)-(f) the entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [SINGLE[1], SINGLE[6], TRIOS[2], TRIOS[7]], ids=["single1", "single6", "trio2", "trio7"])
def test_genotype_dptable_cpu_matches_reference_host_route(case, monkeypatch):
    spec = _spec(**case)
    monkeypatch.setenv("WHATSHAP_TPU_GENO_BACKEND", "host")
    rs, ped, nsi = _build(ref_core, spec)
    ref = ref_solver.GenotypeDPTable(nsi, rs, spec["recomb"], ped, spec["positions"])
    rs_p, ped_p, nsi_p = _build(core, spec)
    port = core.GenotypeDPTable(nsi_p, rs_p, spec["recomb"], ped_p, spec["positions"], device="cpu")
    assert port.device == CPU
    for i in range(len(spec["gls"])):
        for pos in range(len(spec["positions"])):
            a = ref.get_genotype_likelihoods(f"ind{i}", pos)
            b = port.get_genotype_likelihoods(f"ind{i}", pos)
            assert isinstance(b, core.PhredGenotypeLikelihoods)
            _assert_close(a.as_vector(), b.as_vector(), rtol=1e-9)


@pytest.mark.parametrize("seed", [21, 22])
def test_compute_genotypes_equals_reference(seed):
    spec = _spec(seed=seed, n_ind=1, trios=(), n_pos=30, n_reads=40, span=(2, 12))
    ref_rs, _p, _n = _build(ref_core, spec)
    rs, _p, _n = _build(core, spec)
    ref_gts, ref_gls = ref_solver.compute_genotypes(ref_rs, spec["positions"])
    gts, gls = core.compute_genotypes(rs, spec["positions"])
    assert [g.as_vector() for g in gts] == [g.as_vector() for g in ref_gts]
    assert gls == ref_gls
    d = core.GenotypeDistribution(0.2, 0.3, 0.5) * core.GenotypeDistribution(0.5, 0.25, 0.25)
    r = ref_solver.GenotypeDistribution(0.2, 0.3, 0.5) * ref_solver.GenotypeDistribution(0.5, 0.25, 0.25)
    assert d.distribution == r.distribution and d.error_probability() == r.error_probability()


def test_genotype_dptable_needs_a_card_by_default(monkeypatch):
    """With no device named and no CUDA device, GenotypeDPTable raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _spec(**SINGLE[0])
    rs, ped, nsi = _build(core, spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        core.GenotypeDPTable(nsi, rs, spec["recomb"], ped, spec["positions"])


def test_empty_instance_has_no_likelihoods():
    spec = _spec(**SINGLE[0])
    (_r, _rp), (port_p, port_ped) = _packed(spec)
    port_p.n_cols = 0
    assert genotyping.run_genotyping(port_p, port_ped, CPU) is None
