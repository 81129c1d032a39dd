"""
Parity of the port's `polyphasegenetic` (cli/polyphasegenetic.py over
polyphase/{variantselection,offspringscoring,clusterarrangement}.py) with the
JAX package's on the CPU: the reference's module tests
(tests/test_polyphasegenetic.py) run on the port, the command on the
committed fixtures with a PED of the progeny VCF's samples (written under
tmp_path) across its options, byte-identical VCFs or the same exception
with the same message, the three modules on seeded random inputs through
both packages (exact equality: the same float arithmetic in the same
order), and a spawned `python -m whatshap_torch polyphasegenetic` that
imports neither jax nor the reference.
"""

import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from whatshap_tpu.cli import polyphasegenetic as ref_cli
from whatshap_tpu.polyphase import clusterarrangement as ref_arrangement
from whatshap_tpu.polyphase import offspringscoring as ref_scoring
from whatshap_tpu.polyphase import variantselection as ref_selection
from whatshap_tpu.polyphase.solver import ProgenyGenotypeLikelihoods as RefProgenyGL
from whatshap_tpu.vcf import VcfReader as RefVcfReader

from whatshap_torch.cli import polyphasegenetic as cli
from whatshap_torch.cli.polyphasegenetic import determine_pedigree
from whatshap_torch.polyphase import clusterarrangement, offspringscoring, variantselection
from whatshap_torch.polyphase.solver import ProgenyGenotypeLikelihoods
from whatshap_torch.vcf import VcfReader

REPO = Path(__file__).resolve().parent.parent
PARENTS = "tests/data/polyphasegenetic.test.parents.vcf"
PROGENY = "tests/data/polyphasegenetic.test.progeny.vcf.gz"


# ---------------------------------------------------------------------------
# tests/test_polyphasegenetic.py on the port
# ---------------------------------------------------------------------------


def test_read_parent_vcf():
    tables = list(VcfReader(PARENTS, only_snvs=False, genotype_likelihoods=False, ploidy=4, mav=True))
    assert len(tables) == 1
    table = tables[0]

    assert table.chromosome == "StSOLv1.1ch03"
    assert len(table.variants) == 135
    assert table.samples == ["Parent_A", "Parent_B"]

    assert table.variants[0].reference_allele == "C"
    assert table.variants[0].alternative_allele == "T"
    assert table.variants[33].reference_allele == "ACC"
    assert table.variants[33].alternative_alleles == ("A", "AC")
    assert table.variants[34].reference_allele == "C"
    assert table.variants[34].alternative_alleles == ("*", "T")


def test_read_progeny_vcf():
    tables = list(VcfReader(PROGENY, only_snvs=False, genotype_likelihoods=False, ploidy=4, mav=True,
                            allele_depth=True))
    assert len(tables) == 1
    table = tables[0]

    assert table.chromosome == "StSOLv1.1ch03"
    assert len(table.variants) == 198
    assert len(table.samples) == 64
    assert table.samples == ["Progeny_{}".format(i) for i in range(1, 65)]

    assert table.variants[0].reference_allele == "C"
    assert table.variants[0].alternative_allele == "T"
    assert table.variants[19].reference_allele == "T"
    assert table.variants[19].alternative_alleles == ("C", "A")
    assert table.variants[71].reference_allele == "AGT"
    assert table.variants[71].alternative_alleles == ("AGGT", "*")

    ad1 = table.allele_depths_of("Progeny_1")
    ad2 = table.allele_depths_of("Progeny_2")
    ad3 = table.allele_depths_of("Progeny_3")
    ad4 = table.allele_depths_of("Progeny_4")

    assert ad1[0] == (1, 4)
    assert ad2[0] == (9,)
    assert ad3[0] == (7,)
    assert ad4[0] == (4, 3)
    assert ad1[19] == (7,)
    assert table.allele_depths_of("Progeny_62")[44] == (3, 1, 1)


def test_pedigree_1():
    file = "tests/data/polyphasegenetic.ped1.txt"
    samples = ["Parent_A"]
    parents = ["Parent_A", "Parent_B", "p1", "p2", "p3", "p4"]
    samples, sam_to_cop, sam_to_prog = determine_pedigree(file, samples, parents)
    assert sam_to_cop["Parent_A"] == "Parent_B"
    assert sam_to_prog["Parent_A"] == ["p1", "p2", "p3", "p4"]
    assert "Parent_B" not in sam_to_cop
    assert "Parent_B" not in sam_to_prog


def test_pedigree_2():
    file = "tests/data/polyphasegenetic.ped1.txt"
    samples = ["Parent_A", "Parent_B"]
    parents = ["Parent_A", "Parent_B", "p1", "p2", "p3", "p4"]
    samples, sam_to_cop, sam_to_prog = determine_pedigree(file, samples, parents)
    assert sam_to_cop["Parent_B"] == "Parent_A"
    assert sam_to_prog["Parent_B"] == sam_to_prog["Parent_A"] == ["p1", "p2", "p3", "p4"]


def test_pedigree_3():
    file = "tests/data/polyphasegenetic.ped2.txt"
    samples = ["Parent_A"]
    parents = ["Parent_A", "Parent_B", "Parent_C", "Parent_D", "p1", "p2", "p3", "p4", "p5"]
    samples, sam_to_cop, sam_to_prog = determine_pedigree(file, samples, parents)
    assert sam_to_cop["Parent_A"] == "Parent_B"
    assert sam_to_prog["Parent_A"] == ["p1", "p2", "p3"]
    assert "Parent_B" not in sam_to_cop
    assert "Parent_B" not in sam_to_prog
    assert "Parent_C" not in sam_to_cop
    assert "Parent_C" not in sam_to_prog


def test_pedigree_4():
    file = "tests/data/polyphasegenetic.ped2.txt"
    samples = ["Parent_C"]
    parents = ["Parent_A", "Parent_B", "Parent_C", "Parent_D", "p1", "p2", "p3", "p4", "p5"]
    samples, sam_to_cop, sam_to_prog = determine_pedigree(file, samples, parents)
    assert sam_to_cop["Parent_C"] == "Parent_D"
    assert sam_to_prog["Parent_C"] == ["p4", "p5"]


def test_pedigree_5():
    file = "tests/data/polyphasegenetic.ped1.txt"
    samples = ["Parent_A"]
    parents = ["Parent_A", "Parent_B", "p1", "p2"]
    samples, sam_to_cop, sam_to_prog = determine_pedigree(file, samples, parents)
    assert sam_to_cop["Parent_A"] == "Parent_B"
    assert sam_to_prog["Parent_A"] == ["p1", "p2"]
    assert "Parent_B" not in sam_to_cop
    assert "Parent_B" not in sam_to_prog


def test_pedigree_6():
    file = "tests/data/polyphasegenetic.ped1.txt"
    samples = ["Parent_A"]
    parents = ["Parent_A", "Parent_B", "p1", "p2"]
    progeny = ["p3", "p4"]
    samples, sam_to_cop, sam_to_prog = determine_pedigree(file, samples, parents, progeny)
    assert sam_to_cop["Parent_A"] == "Parent_B"
    assert sam_to_prog["Parent_A"] == ["p3", "p4"]
    assert "Parent_B" not in sam_to_cop
    assert "Parent_B" not in sam_to_prog


@pytest.mark.parametrize("ped,samples,parents,progeny", [
    ("ped1", ["Parent_A"], ["Parent_A", "Parent_B", "p1", "p2", "p3", "p4"], None),
    ("ped2", ["Parent_C", "Parent_A"], ["Parent_A", "Parent_B", "Parent_C", "Parent_D", "p1", "p2", "p3"],
     ["p4", "p5"]),
    ("ped2", ["Parent_D"], ["Parent_A", "Parent_B", "Parent_C", "Parent_D"], ["p1", "p2", "p3", "p4", "p5"]),
    ("ped2", ["Parent_X"], ["Parent_A", "Parent_B", "Parent_X"], None),
])
def test_determine_pedigree_matches_reference(ped, samples, parents, progeny):
    """determine_pedigree gives the reference's result, or raises its
    exception with its message."""
    file = f"tests/data/polyphasegenetic.{ped}.txt"
    outcomes = []
    for fn in (ref_cli.determine_pedigree, determine_pedigree):
        try:
            outcomes.append(("ok", fn(file, list(samples), list(parents), progeny)))
        except Exception as e:  # noqa: BLE001 - the outcome compared is the exception itself
            outcomes.append((type(e).__name__, str(e)))
    assert outcomes[0] == outcomes[1]


# ---------------------------------------------------------------------------
# the command on the fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def progeny_ped(tmp_path_factory):
    """Parent_A x Parent_B with Progeny_1 to Progeny_24 of the progeny VCF,
    as chip_smoke.py's host-commands phase writes it."""
    from chip_smoke import write_polyphasegenetic_ped

    return write_polyphasegenetic_ped(tmp_path_factory.mktemp("ped") / "progeny.ped")


def _outcome(run, out, **kwargs):
    """The bytes written (decoded for a .gz output: its gzip header holds
    the time), or the exception raised."""
    try:
        run(output=str(out), **kwargs)
    except Exception as e:  # noqa: BLE001 - the outcome compared is the exception itself
        return type(e).__name__, str(e)
    if out.suffix == ".gz":
        return "gz", gzip.decompress(out.read_bytes())
    return "vcf", out.read_bytes()


CLI_CASES = {
    "C0": dict(write_command_line_header=False),
    "C1": dict(complexity_support=1),
    "C2": dict(complexity_support=2),
    "distrust": dict(distrust_genotypes=True),
    "window-50": dict(scoring_window=50),
    "only-snvs": dict(only_snvs=True),
    "tag-HP": dict(tag="HP"),
    "gz": {},
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_polyphasegenetic_matches_reference(case, progeny_ped, tmp_path):
    """--sample Parent_A at ploidy 4 with the case's options: the port's VCF
    is the reference's, byte for byte (a .gz output decoded), and phases
    variants.  With the default options (C0, no command line header) the
    records hash to chip_smoke.py's POLYPHASEGENETIC_RECORDS_SHA256, 91 of
    the 135 variants phased."""
    kwargs = dict(variant_file=PARENTS, pedigree_file=progeny_ped, ploidy=4, progeny_file=PROGENY,
                  samples=["Parent_A"], **CLI_CASES[case])
    suffix = ".vcf.gz" if case == "gz" else ".vcf"
    ref = _outcome(ref_cli.run_polyphasegenetic, tmp_path / f"ref{suffix}", **kwargs)
    got = _outcome(cli.run_polyphasegenetic, tmp_path / f"port{suffix}", **kwargs)
    assert got == ref
    assert ref[0] in ("vcf", "gz")
    records = [line for line in ref[1].splitlines() if not line.startswith(b"#")]
    assert len(records) == (135 if case != "only-snvs" else len(records))
    assert sum((b"HP" if case == "tag-HP" else b"|") in r for r in records) > 30
    if case == "C0":
        import chip_smoke

        assert chip_smoke.records_sha256(tmp_path / "port.vcf") == chip_smoke.POLYPHASEGENETIC_RECORDS_SHA256
        assert sum(b"|" in r for r in records) == 91


@pytest.mark.parametrize("case", ["Parent_B", "ped1"])
def test_polyphasegenetic_stops_as_the_reference(case, progeny_ped, tmp_path):
    """The reference's own stops, kept: Parent_B has no simplex-nulliplex
    marker (an empty clustering, `assert clustering`), and ped1.txt names
    progeny p1-p4 that the progeny VCF lacks (no cluster of two,
    `assert any(len(c) > 1 ...)`); both raise the same AssertionError."""
    ped = "tests/data/polyphasegenetic.ped1.txt" if case == "ped1" else progeny_ped
    sample = "Parent_B" if case == "Parent_B" else "Parent_A"
    kwargs = dict(variant_file=PARENTS, pedigree_file=ped, ploidy=4, progeny_file=PROGENY, samples=[sample])
    ref = _outcome(ref_cli.run_polyphasegenetic, tmp_path / "ref.vcf", **kwargs)
    got = _outcome(cli.run_polyphasegenetic, tmp_path / "port.vcf", **kwargs)
    assert ref[0] == "AssertionError"
    assert got == ref


def test_subcommands_are_the_references():
    """`python -m whatshap_torch` discovers the reference's 13 subcommands."""
    import whatshap_torch.__main__ as port_main
    import whatshap_tpu.__main__ as ref_main

    port = sorted(name for name, _doc in port_main._available_commands())
    assert port == sorted(name for name, _doc in ref_main._available_commands())
    assert len(port) == 13 and {"polyphasegenetic", "find_snv_candidates", "learn"} <= set(port)


def test_spawned_command_imports_no_jax_and_no_reference(progeny_ped, tmp_path):
    """`python -m whatshap_torch polyphasegenetic` in a process of its own
    writes the reference's records with neither jax nor whatshap_tpu in its
    sys.modules."""
    code = (
        "import runpy, sys\n"
        "runpy.run_module('whatshap_torch', run_name='__main__', alter_sys=True)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'whatshap_tpu'))\n"
        "print('BANNED', bad)\n"
    )
    out = tmp_path / "spawned.vcf"
    args = [sys.executable, "-c", code, "polyphasegenetic", "--ploidy", "4", "--sample", "Parent_A", "-P",
            str(REPO / PROGENY), "-o", str(out), str(REPO / PARENTS), progeny_ped]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    run = subprocess.run(args, cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert run.returncode == 0, run.stderr
    assert "BANNED []" in run.stdout
    import chip_smoke

    assert chip_smoke.records_sha256(out) == chip_smoke.POLYPHASEGENETIC_RECORDS_SHA256


# ---------------------------------------------------------------------------
# the modules on seeded random inputs
# ---------------------------------------------------------------------------


def _random_clustering(rng, n_nodes, n_clusters):
    """A partition of n_nodes nodes into clusters of runs of nearby nodes
    (some singletons), in random order."""
    labels = np.minimum(np.sort(rng.integers(0, n_clusters, n_nodes)) + rng.integers(0, 3, n_nodes),
                        n_clusters + 2)
    clusters = [sorted(np.nonzero(labels == c)[0].tolist()) for c in np.unique(labels)]
    order = rng.permutation(len(clusters))
    return [clusters[i] for i in order]


@pytest.mark.parametrize("seed,ploidy,padding", [(1, 2, 0), (2, 4, 3), (3, 4, 10), (4, 6, 5), (5, 4, 40),
                                                 (6, 6, 0), (7, 2, 20), (8, 8, 7)])
def test_arrange_clusters_matches_reference(seed, ploidy, padding):
    """arrange_clusters (its no-PuLP flow) assigns the reference's clusters
    to each haplotype."""
    rng = np.random.default_rng(seed)
    clustering = _random_clustering(rng, int(rng.integers(40, 120)), int(rng.integers(5, 30)))
    got = clusterarrangement.arrange_clusters(clustering, padding, ploidy)
    assert got == ref_arrangement.arrange_clusters(clustering, padding, ploidy)
    assert len(got) == ploidy
    chosen = [c for hap in got for c in hap]
    assert len(chosen) == len(set(chosen)) and all(len(clustering[c]) > 1 for c in chosen)


class _Variant:
    def __init__(self, position):
        self.position = position


class _ProgenyTable:
    """The two attributes of a progeny VariantTable that the scoring reads:
    variants (with positions) and each sample's allele depths."""

    def __init__(self, positions, depths):
        self.variants = [_Variant(p) for p in positions]
        self._depths = depths

    def allele_depths_of(self, sample):
        return self._depths[sample]


def _fixture_table(reader):
    return next(iter(reader(PARENTS, only_snvs=False, genotype_likelihoods=False, ploidy=4, mav=True,
                            allele_depth=True)))


def _param(mod, support, window=40):
    return mod.PolyphaseGeneticParameter(ploidy=4, scoring_window=window, allele_error_rate=0.06,
                                         complexity_support=support, ratio_cutoff=0.0, distrust_genotypes=False,
                                         allow_deletions=True, plot=False, output=None)


def _varinfo_state(varinfo):
    return ([(v.ref, v.alt, v.alt_count, v.co_alt_count) for v in varinfo.variants], varinfo.get_phasable(),
            varinfo.get_node_positions())


@pytest.mark.parametrize("support", [0, 1, 2])
@pytest.mark.parametrize("sample", ["Parent_A", "Parent_B"])
def test_phasable_variants_match_reference(support, sample):
    """compute_phasable_variants on the parents' fixture gives the
    reference's VariantInfo (variants, phasable set, node positions)."""
    coparent = "Parent_B" if sample == "Parent_A" else "Parent_A"
    ref = ref_selection.compute_phasable_variants(_fixture_table(RefVcfReader), sample, coparent,
                                                  _param(ref_cli, support))
    got = variantselection.compute_phasable_variants(_fixture_table(VcfReader), sample, coparent,
                                                     _param(cli, support))
    assert _varinfo_state(got) == _varinfo_state(ref)


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_variant_info_and_filter_match_reference(seed):
    """VariantInfo under random appends, type corrections and removals, and
    filter_variants on random coverages, as the reference's."""
    rng = np.random.default_rng(seed)
    allowed = [(1, 0), (2, 0), (1, 1)]
    infos = [ref_selection.VariantInfo(allowed), variantselection.VariantInfo(allowed)]
    appends = []
    for _ in range(60):
        alt_count, co_alt = [(1, 0), (2, 0), (1, 1), (2, 2), (3, 0)][int(rng.integers(0, 5))]
        appends.append((0, int(rng.integers(0, 2)), alt_count, co_alt, bool(rng.random() < 0.1)))
    for info in infos:
        for args in appends:
            info.append(*args)
    # corrections of distinct phasable variants (the pipeline corrects only
    # those), compatible or not, then one more removal
    phasable = infos[0].get_phasable()
    targets = rng.choice(phasable, size=min(10, len(phasable) - 1), replace=False).tolist()
    types = [[(1, 0), (2, 0), (1, 1)][int(rng.integers(0, 3))] for _ in targets]
    for info in infos:
        for index, new_type in zip(targets, types):
            info.correct_type(index, *new_type)
        info.remove_phasable(info.get_phasable()[0])
        info.get_node_positions()
    assert _varinfo_state(infos[0]) == _varinfo_state(infos[1])
    assert [infos[0].node_to_variant(n) for n in range(len(infos[0].get_node_positions()))] == [
        infos[1].node_to_variant(n) for n in range(len(infos[1].get_node_positions()))
    ]
    covs = [rng.integers(1, 60, 60).tolist() for _ in range(3)]
    ref_selection.filter_variants(infos[0], *covs, 1.5)
    variantselection.filter_variants(infos[1], *covs, 1.5)
    assert _varinfo_state(infos[0]) == _varinfo_state(infos[1])
    assert [ref_selection.diff_ratio(x) for x in (0.0, 0.25, 1.0, 3.0, None)] == [
        variantselection.diff_ratio(x) for x in (0.0, 0.25, 1.0, 3.0, None)
    ]


@pytest.mark.parametrize("support,window,distrust", [(0, 40, False), (1, 40, False), (2, 20, False),
                                                     (2, 40, True), (0, 250, True)])
def test_offspring_scoring_matches_reference(support, window, distrust):
    """The scoring stage on the parents' fixture with seeded random progeny
    allele depths (24 progeny): get_offspring_gl's likelihoods (after
    correct_variant_types with `distrust`), the corrected VariantInfo and
    get_variant_scoring's sparse scores equal the reference's bit for bit;
    the priors and pmfs too."""
    rng = np.random.default_rng(100 + 10 * support + window)
    table = _fixture_table(VcfReader)
    positions = [v.position for v in table.variants]
    offspring = [f"Progeny_{i}" for i in range(1, 25)]
    depths = {s: [tuple(int(x) for x in rng.integers(0, 12, int(rng.integers(1, 4)))) for _ in positions]
              for s in offspring}
    progeny = _ProgenyTable(positions, depths)
    out = []
    for mod_cli, mod_sel, mod_score, reader in ((ref_cli, ref_selection, ref_scoring, RefVcfReader),
                                                (cli, variantselection, offspringscoring, VcfReader)):
        param = _param(mod_cli, support, window)
        parents = _fixture_table(reader)
        varinfo = mod_sel.compute_phasable_variants(parents, "Parent_A", "Parent_B", param)
        if distrust:
            mod_score.correct_variant_types(parents, progeny, offspring, varinfo, param)
        off_gl = mod_score.get_offspring_gl(parents, progeny, offspring, varinfo, param)
        gls = [[off_gl.getGlv(p, i) for i in range(off_gl.getNumSamples())] for p in range(off_gl.getNumPositions())]
        scoring = mod_score.get_variant_scoring(varinfo, off_gl, param)
        out.append((_varinfo_state(varinfo), gls, sorted((i, j, scoring.get(i, j)) for i, j in scoring.getEntries()),
                    mod_score.compute_gt_likelihood_priors(4), mod_score.compute_gt_likelihood_priors(6),
                    [mod_score.get_binom_pmf(n, k, g, 4, 0.06) for n, k, g in ((10, 3, 1), (4, 0, 0), (20, 20, 4))]))
    assert out[0] == out[1]
    assert len(out[1][2]) > 0


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_most_likely_variant_type_matches_reference(seed):
    """get_most_likely_variant_type on random progeny likelihoods (some
    progeny without depth) picks the reference's (alt, co-alt) pair."""
    rng = np.random.default_rng(seed)
    n_pos, n_samples = 6, 10
    gls = []
    for cls in (RefProgenyGL, ProgenyGenotypeLikelihoods):
        gl = cls(4, n_samples, n_pos)
        gls.append(gl)
    for pos in range(n_pos):
        for s in range(n_samples):
            if rng.random() < 0.2:
                continue
            v = rng.random(5)
            for gl in gls:
                gl.setGlv(pos, s, (v / v.sum()).tolist())
    for pos in range(n_pos):
        want = ref_scoring.get_most_likely_variant_type(ref_scoring.compute_gt_likelihood_priors(4), 0, gls[0], pos)
        got = offspringscoring.get_most_likely_variant_type(offspringscoring.compute_gt_likelihood_priors(4), 0,
                                                            gls[1], pos)
        assert got == want
