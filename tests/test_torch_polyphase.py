"""
The port's polyphase against the reference's, on the CPU.

- The CLI: whatshap_torch.cli.polyphase.run_polyphase and
  whatshap_tpu.cli.polyphase.run_polyphase on every case of
  tests/test_run_polyphase.py (chr22 12k at ploidy 4, the two multi-BAM
  orders, the wrong ploidy, block-cut sensitivities 0-5 on chr22 and on the
  cuts fixture with and without --use-prephasing, threads 1 and 4, the
  indels fixture with and without --only-snvs, a VCF with no variants to
  phase) and on more options (--include-haploid-sets, --distrust-genotypes,
  --use-prephasing, --no-mav, --ce-bundle-edges, --tag HP, --min-overlap,
  --sample, --chromosome, both plot options) write the same bytes (every
  file a run writes), or raise the same exception class with the same
  message.  `python -m whatshap_torch polyphase --threads 2` and
  `python -m whatshap_tpu polyphase --threads 2` likewise.
- chip_smoke.py's synthetic tetraploid chromosome (write_synth_poly) at a
  small size: the port on its libraries, the port on its Python paths
  (the entry of chip_smoke.py's child process) and the reference write the
  same VCF.
- The plots: PdfPages stamps a CreationDate, so the plot cases run with
  SOURCE_DATE_EPOCH set (matplotlib honours it) and compare the PDFs byte
  for byte.
- The modules: the same seeded random instances (numpy) through both
  packages' AlleleMatrix, read scoring, cluster editing, threading,
  reordering, block splitting, the whole solve with and without a
  prephasing, cut positions, mathutils, the sparse triangle matrix, the
  progeny likelihoods and the plots' helpers; and the fixtures of
  tests/test_{reorder,threading,clusterediting,readscoring,allelematrix}.py
  built in both packages and run through each stage.  The port's host
  libraries (clusterlib, threadlib, scorelib) run on the port's side, the
  reference's on its own; their Python paths are held against them in
  test_torch_hostlib.py.
- The reference tests of those modules, run on the port: each test of
  tests/test_{allelematrix,clusterediting,threading,readscoring,reorder,
  plots}.py, with whatshap_tpu read as whatshap_torch, passes.
- PuLP is not installed here (nor on the card's host), so the reordering
  with a prephasing takes the exact chain DP in both packages; the ILP
  branch is not run.
- A spawned pool worker of the port's polyphase imports neither jax nor
  whatshap_tpu.

Outputs go under pytest's temporary directories; nothing under tests/data
is written.
"""

import ast
import dataclasses
import json
import multiprocessing
import os
import pickle
import random
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import whatshap_tpu.cli.polyphase as ref_cli
import whatshap_tpu.core as ref_core
import whatshap_tpu.polyphase as ref_poly
import whatshap_tpu.polyphase.algorithm as ref_algorithm
import whatshap_tpu.polyphase.mathutils as ref_mathutils
import whatshap_tpu.polyphase.plots as ref_plots
import whatshap_tpu.polyphase.progenygl as ref_progenygl
import whatshap_tpu.polyphase.reorder as ref_reorder
import whatshap_tpu.polyphase.solver as ref_solver
import whatshap_tpu.polyphase.threading as ref_threading
import whatshap_tpu.testhelpers as ref_testhelpers
import whatshap_tpu.vcf as ref_vcf
from whatshap_tpu.timer import StageTimer as RefStageTimer

import whatshap_torch.cli.polyphase as cli
import whatshap_torch.core as core
import whatshap_torch.polyphase as poly
import whatshap_torch.polyphase.algorithm as algorithm
import whatshap_torch.polyphase.mathutils as mathutils
import whatshap_torch.polyphase.plots as plots
import whatshap_torch.polyphase.progenygl as progenygl
import whatshap_torch.polyphase.reorder as reorder
import whatshap_torch.polyphase.solver as solver
import whatshap_torch.polyphase.threading as threading_
import whatshap_torch.vcf as vcf
from whatshap_torch.timer import StageTimer

REPO = Path(__file__).parent.parent
DATA = "tests/data"

# the two packages' modules of each name, reference first
SIDES = {
    "ref": types.SimpleNamespace(
        cli=ref_cli, core=ref_core, poly=ref_poly, algorithm=ref_algorithm,
        mathutils=ref_mathutils, plots=ref_plots, progenygl=ref_progenygl,
        reorder=ref_reorder, solver=ref_solver, threading=ref_threading, vcf=ref_vcf,
        StageTimer=RefStageTimer,
    ),
    "port": types.SimpleNamespace(
        cli=cli, core=core, poly=poly, algorithm=algorithm, mathutils=mathutils,
        plots=plots, progenygl=progenygl, reorder=reorder, solver=solver,
        threading=threading_, vcf=vcf, StageTimer=StageTimer,
    ),
}


def both(fn):
    """fn(side namespace) for the reference and for the port."""
    return fn(SIDES["ref"]), fn(SIDES["port"])


def plain(value):
    """A value of either package as plain Python data (dataclasses as
    dicts, tuples as lists but in dict keys, numpy scalars and arrays as
    Python ones), so that the two packages' results compare with ==."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: plain(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if isinstance(value, np.ndarray):
        return plain(value.tolist())
    if isinstance(value, np.generic):
        return value.item()
    return value


def assert_same(ref, port):
    assert plain(port) == plain(ref)


# ---------------------------------------------------------------------------
# the CLI on every case of tests/test_run_polyphase.py and more options

CHR22 = dict(
    phase_input_files=[f"{DATA}/polyploid.chr22.42M.12k.bam"],
    variant_file=f"{DATA}/polyploid.chr22.42M.12k.vcf",
    ploidy=4,
    ignore_read_groups=True,
)
CUTS = dict(
    phase_input_files=[f"{DATA}/polyploid.cuts.bam"],
    variant_file=f"{DATA}/polyploid.cuts.vcf",
    ploidy=4,
    ignore_read_groups=True,
)
HUMAN = [f"{DATA}/polyploid.human1.chr22.42M.5k.bam", f"{DATA}/polyploid.human2.chr22.42M.5k.bam"]
MULTI = dict(variant_file=f"{DATA}/polyploid.multisample.chr22.42M.5k.vcf", ploidy=2)
INDELS = dict(
    phase_input_files=[f"{DATA}/polyploid.indels.bam"],
    variant_file=f"{DATA}/polyploid.indels.vcf",
    ploidy=4,
    ignore_read_groups=True,
)

CLI_CASES = [
    ("chr22", CHR22),
    ("multiple_bam", dict(MULTI, phase_input_files=HUMAN)),
    ("multiple_bam2", dict(MULTI, phase_input_files=HUMAN[::-1])),
    ("wrong_ploidy", dict(CHR22, ploidy=3)),
    *[(f"blockcut_chr22_s{s}", dict(CHR22, block_cut_sensitivity=s)) for s in range(6)],
    *[(f"blockcut_cuts_s{s}", dict(CUTS, block_cut_sensitivity=s)) for s in range(6)],
    *[(f"blockcut_cuts_prephasing_s{s}", dict(CUTS, block_cut_sensitivity=s, use_prephasing=True))
      for s in range(6)],
    ("threads4", dict(CHR22, threads=4)),
    ("indels_only_snvs", dict(INDELS, only_snvs=True)),
    ("indels", dict(INDELS, only_snvs=False)),
    ("no_variants", dict(variant_file=f"{DATA}/onevariant.vcf",
                         phase_input_files=[f"{DATA}/oneread.bam"], ploidy=2)),
    ("include_haploid_sets", dict(CHR22, include_haploid_sets=True)),
    ("include_haploid_sets_cuts", dict(CUTS, include_haploid_sets=True, block_cut_sensitivity=5)),
    ("distrust_genotypes", dict(CHR22, distrust_genotypes=True)),
    ("distrust_genotypes_indels", dict(INDELS, distrust_genotypes=True)),
    ("use_prephasing_chr22", dict(CHR22, use_prephasing=True, block_cut_sensitivity=0)),
    ("no_mav", dict(CHR22, mav=False)),
    ("no_mav_indels", dict(INDELS, mav=False)),
    ("ce_bundle_edges", dict(CHR22, ce_bundle_edges=True)),
    ("ce_bundle_edges_cuts", dict(CUTS, ce_bundle_edges=True)),
    ("tag_hp", dict(CHR22, tag="HP")),
    ("min_overlap3", dict(CHR22, min_overlap=3)),
    ("sample", dict(MULTI, phase_input_files=HUMAN, samples=["NA19240"])),
    ("unknown_sample", dict(MULTI, phase_input_files=HUMAN, samples=["nobody"])),
    ("ignore_read_groups_multisample", dict(MULTI, phase_input_files=HUMAN, ignore_read_groups=True)),
    ("excluded_chromosome", dict(CHR22, excluded_chromosomes=["chr22"])),
    ("chromosome", dict(CHR22, chromosomes=["chr22"])),
    ("read_list", dict(CHR22, read_list_filename="reads.txt")),
    ("plots", dict(CHR22, plot_clusters=True, plot_threading=True)),
    ("plot_clusters_cuts", dict(CUTS, plot_clusters=True)),
    ("plot_threading_indels", dict(INDELS, plot_threading=True)),
]
RAISING = {"wrong_ploidy", "unknown_sample", "ignore_read_groups_multisample", "read_list"}


def run_both_cli(tmp_path, kwargs):
    """run_polyphase of each package with `kwargs`, its output (and its
    plots beside it) under a directory of its own; [(files, error)] of the
    reference and of the port, with a side's directory read "<out>" in its
    messages."""
    results = []
    for side in ("ref", "port"):
        out_dir = tmp_path / side
        out_dir.mkdir()
        error = None
        try:
            SIDES[side].cli.run_polyphase(output=str(out_dir / "out.vcf"), **kwargs)
        except Exception as e:  # noqa: BLE001 - compared below
            error = (type(e).__name__, str(e).replace(str(out_dir), "<out>"))
        files = {p.name: p.read_bytes() for p in sorted(out_dir.iterdir())}
        results.append((files, error))
    return results


@pytest.mark.parametrize("name,kwargs", CLI_CASES, ids=[c[0] for c in CLI_CASES])
def test_run_polyphase_matches_reference(name, kwargs, tmp_path, monkeypatch):
    """Every file of the run (the VCF, and the PDFs of the plot cases) has
    the reference's bytes, or both raise the same exception class with the
    same message."""
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")  # the PDFs' CreationDate
    (ref_files, ref_error), (files, error) = run_both_cli(tmp_path, kwargs)
    assert error == ref_error
    assert (ref_error is not None) == (name in RAISING), ref_error
    assert files.keys() == ref_files.keys()
    for fname in ref_files:
        assert files[fname] == ref_files[fname], f"{fname} differs from the reference's"
    if name.startswith("plot"):
        assert any(f.endswith(".pdf") for f in files)
    if name == "threads4":
        # the spawn pool writes the single-threaded run's VCF
        single = tmp_path / "single.vcf"
        cli.run_polyphase(output=str(single), **CHR22)
        assert single.read_bytes() == files["out.vcf"]


def test_polyphase_command_matches_reference(tmp_path):
    """`python -m whatshap_torch polyphase` (found by the subcommand
    discovery, with a spawn pool of two workers) writes the VCF that
    `python -m whatshap_tpu polyphase` writes with the same arguments."""
    outs = {}
    for package in ("whatshap_tpu", "whatshap_torch"):
        out_dir = tmp_path / package
        out_dir.mkdir()
        args = [sys.executable, "-m", package, "polyphase", "--ploidy", "4",
                "--ignore-read-groups", "--threads", "2", "-B", "5", "-o", "out.vcf",
                str(REPO / CHR22["variant_file"]), str(REPO / CHR22["phase_input_files"][0])]
        env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
        run = subprocess.run(args, cwd=out_dir, capture_output=True, text=True, timeout=300, env=env)
        assert run.returncode == 0, run.stderr
        outs[package] = (out_dir / "out.vcf").read_bytes()
    assert outs["whatshap_torch"] == outs["whatshap_tpu"]
    assert b'##commandline="(whatshap 0.1.0) polyphase --ploidy 4' in outs["whatshap_torch"]


@pytest.mark.parametrize("seed", [61, 62])
def test_synthetic_chromosome_matches_reference_and_python_paths(seed, tmp_path, capsys):
    """chip_smoke.py's polyphase-chrom at a small size (write_synth_poly: 150
    SNVs at coverage 24, ploidy 4): the port's run through the libraries
    (_polyphase_chrom), its run on the Python paths through the child's
    entry (polyphase_python_paths) and the reference's run write the same
    VCF, with every record phased or left as the reference leaves it."""
    import chip_smoke as cs

    data = cs.write_synth_poly(tmp_path / "chrom", 150, 24, seed)
    _wall, stages = cs._polyphase_chrom(data, str(tmp_path / "library.vcf"))
    assert any(s.startswith("solving cluster editing:") for s in stages), stages
    assert cs.polyphase_python_paths(data["vcf"], data["bam"], str(tmp_path / "python.vcf")) == 0
    child = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert child["wall"] > 0 and len(child["stages"]) == len(stages)
    ref_cli.run_polyphase(phase_input_files=[data["bam"]], variant_file=data["vcf"], ploidy=4,
                          ignore_read_groups=True, output=str(tmp_path / "ref.vcf"), threads=1,
                          write_command_line_header=False)
    library = (tmp_path / "library.vcf").read_bytes()
    assert library == (tmp_path / "python.vcf").read_bytes()
    assert library == (tmp_path / "ref.vcf").read_bytes()
    records = [line.split(b"\t") for line in library.splitlines() if not line.startswith(b"#")]
    assert len(records) == 150 and sum(b"|" in r[9] for r in records) > 100
    gts = [r[9].split(b":")[0].replace(b"|", b"/") for r in records]
    assert all(gt.count(b"/") == 3 and b"0" in gt and b"1" in gt for gt in gts)  # tetraploid, heterozygous


# ---------------------------------------------------------------------------
# the spawned worker


def test_spawned_worker_imports_no_jax_and_no_reference():
    """A worker of the spawn pool that --threads > 1 starts phases a block
    of the port (importing whatshap_torch.polyphase.algorithm) without jax
    or whatshap_tpu in its sys.modules, and gives the in-process result."""
    rs = _readset(core, _random_reads(5, 4))
    am = solver.AlleleMatrix(rs)
    genotypes = _genotypes(5, 4, am)
    param = _param(poly, 4)
    ctx = poly.BlockContext(0, 1, 1, 0)
    args = (am, genotypes, None, param, StageTimer(), ctx)
    local = algorithm.phase_single_block(*args)
    with multiprocessing.get_context("spawn").Pool(processes=1) as pool:
        remote = pool.apply(algorithm.phase_single_block, args)
        modules = pool.apply(eval, ("sorted(__import__('sys').modules)",))
    assert "whatshap_torch.polyphase.algorithm" in modules
    banned = [m for m in modules if m.split(".")[0] in ("jax", "jaxlib", "whatshap_tpu")]
    assert banned == []
    assert_same(local, remote)


# ---------------------------------------------------------------------------
# seeded random instances through both packages' modules


def _haplotypes(seed, ploidy, n_pos, n_alleles=2):
    """Ploidy haplotypes over n_pos positions, each position heterozygous."""
    rng = np.random.default_rng(seed)
    haps = rng.integers(0, n_alleles, size=(ploidy, n_pos))
    for p in range(n_pos):
        if len(set(haps[:, p].tolist())) == 1:
            haps[int(rng.integers(0, ploidy)), p] = (haps[0, p] + 1) % n_alleles
    return haps


N_POS = 36


def _random_reads(seed, ploidy, n_pos=N_POS, n_reads=56, err=0.06, n_alleles=2, gap=None):
    """(name, mapq, [(position, allele, quality)]) of reads drawn from
    _haplotypes (variant p at position 10 * (p + 1)), with allele errors at
    rate err; with `gap`, no read spans the variants gap - 1 and gap (two
    blocks)."""
    rng = np.random.default_rng(seed + 1000)
    haps = _haplotypes(seed, ploidy, n_pos, n_alleles)
    reads = []
    for i in range(n_reads):
        h = haps[i % ploidy]
        start = int(rng.integers(0, n_pos - 6))
        end = min(start + int(rng.integers(4, 14)), n_pos)
        if gap is not None and start < gap < end:
            end = gap
        variants = []
        for p in range(start, end):
            allele = int(h[p])
            if rng.random() < err:
                allele = (allele + 1 + int(rng.integers(0, n_alleles - 1))) % n_alleles
            variants.append((10 * (p + 1), allele, int(rng.integers(10, 40))))
        if len(variants) >= 2:
            reads.append((f"read{i}", int(rng.integers(20, 60)), variants))
    return reads


def _readset(core_mod, reads):
    rs = core_mod.ReadSet()
    for name, mapq, variants in reads:
        read = core_mod.Read(name, mapq, 0, 0)
        for pos, allele, qual in variants:
            read.add_variant(pos, allele, qual)
        rs.add(read)
    rs.sort()
    return rs


def _genotypes(seed, ploidy, am, n_alleles=2):
    """The genotype of each position of `am`, from _haplotypes."""
    haps = _haplotypes(seed, ploidy, N_POS, n_alleles)
    out = []
    for gpos in am.getPositions():
        column = haps[:, gpos // 10 - 1].tolist()
        out.append({a: column.count(a) for a in sorted(set(column))})
    return out


def _param(poly_mod, ploidy, **kw):
    fields = dict(
        ploidy=ploidy, ce_bundle_edges=False, distrust_genotypes=False, min_overlap=2,
        block_cut_sensitivity=4, plot_clusters=False, plot_threading=False,
        plot_path="unused", threads=1, use_prephasing=False,
    )
    fields.update(kw)
    return poly_mod.PolyphaseParameter(**fields)


def _am_view(am):
    """Everything an AlleleMatrix shows."""
    n = len(am)
    return dict(
        size=am.size(), positions=am.getPositions(), num_positions=am.getNumPositions(),
        max_allele=am.getMaxNumAllele(), reads=[am.getRead(i) for i in range(n)],
        first=[am.getFirstPos(i) for i in range(n)], last=[am.getLastPos(i) for i in range(n)],
        ids=[am.getGlobalId(i) for i in range(n)],
        depths=[am.getAlleleDepths(p) for p in range(am.getNumPositions())],
        state=am.__getstate__(),
    )


# (seed, ploidy, alleles a position)
INSTANCES = [(0, 2, 2), (1, 3, 2), (2, 4, 2), (3, 4, 3), (4, 5, 2), (5, 6, 2), (6, 4, 2), (7, 3, 3)]


def _instance(side, seed, ploidy, n_alleles, **kw):
    reads = _random_reads(seed, ploidy, n_alleles=n_alleles, **kw)
    am = side.solver.AlleleMatrix(_readset(side.core, reads))
    return am, _genotypes(seed, ploidy, am, n_alleles)


@pytest.mark.parametrize("seed,ploidy,n_alleles", INSTANCES)
def test_allelematrix_matches_reference(seed, ploidy, n_alleles):
    """The matrix, its intervals and sub-matrices, and its pickle."""
    def run(side):
        am, _ = _instance(side, seed, ploidy, n_alleles)
        n_pos, n = am.getNumPositions(), len(am)
        rng = random.Random(seed)
        a, b = sorted(rng.sample(range(n_pos + 1), 2))
        positions = sorted(rng.sample(range(n_pos), n_pos // 2)) + [n_pos + 3]
        read_ids = sorted(rng.sample(range(n), n // 2)) + [n + 1]
        views = [_am_view(am)]
        views += [_am_view(am.extractInterval(a, b, e)) for e in (True, False)]
        views += [_am_view(am.extractSubMatrix(positions, read_ids, e)) for e in (True, False)]
        views.append(_am_view(pickle.loads(pickle.dumps(am))))
        views.append([am.getAlleleGlobal(i, g) for i in range(n) for g in am.getPositions()[:5]])
        views.append([am.globalToLocal(g) for g in am.getPositions()])
        return views

    assert_same(*both(run))


@pytest.mark.parametrize("seed,ploidy,n_alleles", INSTANCES)
def test_scoring_and_cluster_editing_match_reference(seed, ploidy, n_alleles):
    """Read-pair scores (both packages' scorelib) and the clusterings of
    both bundling modes (both packages' clusterlib)."""
    def run(side):
        am, _ = _instance(side, seed, ploidy, n_alleles)
        out = []
        for min_overlap, err in ((2, 0.07), (3, 0.05)):
            sim = side.solver.scoreReadset(am, min_overlap, ploidy, err)
            out.append(sorted(sim.m.items()))
            out.append(sim.getMaxDim())
            out += [side.solver.ClusterEditingSolver(sim, bundle).run() for bundle in (False, True)]
        return out

    assert_same(*both(run))


@pytest.mark.parametrize("seed,ploidy,n_alleles", INSTANCES)
@pytest.mark.parametrize("distrust", [False, True])
def test_threading_matches_reference(seed, ploidy, n_alleles, distrust):
    """Allele depths, cluster selection, the read-length ratio and the
    threading (both packages' threadlib), with and without distrusting
    the genotypes."""
    def run(side):
        am, genotypes = _instance(side, seed, ploidy, n_alleles)
        clustering = side.solver.ClusterEditingSolver(
            side.solver.scoreReadset(am, 2, ploidy, 0.07), False).run()
        depths, cov = side.threading.get_allele_depths(am, clustering, ploidy)
        return [
            depths, cov,
            side.threading.select_clusters(depths, ploidy, 10),
            side.threading.compute_readlength_snp_distance_ratio(am),
            side.poly.get_coverage(am, clustering),
            side.threading.run_threading(am, clustering, ploidy, [dict(g) for g in genotypes],
                                         distrust_genotypes=distrust),
        ]

    assert_same(*both(run))


def _prephasing(side, seed, ploidy, am, n_alleles):
    """A prephasing in the shape extract_partial_phasing gives: ploidy rows
    a block, each over all of the block's positions, the haplotypes
    permuted a block."""
    haps = _haplotypes(seed, ploidy, N_POS, n_alleles)
    rng = np.random.default_rng(seed + 7)
    positions = am.getPositions()
    cut = len(positions) // 2
    rs = side.core.ReadSet()
    for b, block in enumerate((positions[:cut], positions[cut:])):
        perm = rng.permutation(ploidy).tolist()
        for h in range(ploidy):
            read = side.core.Read(f"block{b}_hap{h}", 0, 0, 0)
            for gpos in block:
                read.add_variant(gpos, int(haps[perm[h], gpos // 10 - 1]), 0)
            rs.add(read)
    return side.solver.AlleleMatrix(rs)


# the chain DP of the prephasing at ploidy 6 (720 permutations a
# breakpoint, squared) takes ~25 s on a CPU: it runs up to ploidy 5
SOLVE_CASES = [(mode, *inst) for mode in ("plain", "bundle", "prephasing", "gap")
               for inst in INSTANCES if not (mode == "prephasing" and inst[1] > 5)]


@pytest.mark.parametrize("mode,seed,ploidy,n_alleles", SOLVE_CASES)
def test_solve_matches_reference(mode, seed, ploidy, n_alleles):
    """The whole solve of an instance (blocks, cluster editing, threading,
    sub-instances, reordering: greedy, or the chain DP under a
    prephasing), each reordering stage on the first block, the block
    bounds, and the cut positions of every sensitivity."""
    def run(side):
        kw = dict(gap=18) if mode == "gap" else {}
        am, genotypes = _instance(side, seed, ploidy, n_alleles, **kw)
        prephasing = _prephasing(side, seed, ploidy, am, n_alleles) if mode == "prephasing" else None
        out = []
        # the sensitivity reaches the solve only through single linkage
        # (<= 1) and the prephasing's borders (0)
        for sens in (0, 1, 4):
            param = _param(side.poly, ploidy, ce_bundle_edges=(mode == "bundle"),
                           block_cut_sensitivity=sens, use_prephasing=prephasing is not None)
            result = side.algorithm.solve_polyphase_instance(
                am, [dict(g) for g in genotypes], param, side.StageTimer(), prephasing)
            out.append(result)
            out += [side.algorithm.compute_cut_positions(result.breakpoints, ploidy, cut)
                    for cut in range(6)]
            out.append([(i.start, i.end) for i in side.poly.compute_block_bounds(am, ploidy, sens <= 1)])
        # the reordering stages one by one
        clustering = side.solver.ClusterEditingSolver(
            side.solver.scoreReadset(am, 2, ploidy, 0.07), False).run()
        threads, haplotypes = side.threading.run_threading(am, clustering, ploidy, genotypes)
        subs = side.reorder.find_subinstances(am, clustering, threads, haplotypes)
        out.append([(cid, ts, _am_view(sub)) for cid, ts, sub in subs])
        breakpoints = side.reorder.find_breakpoints(threads)
        out.append(breakpoints)
        lllh = side.reorder.compute_link_likelihoods(threads, haplotypes, breakpoints, clustering, am, 0.07)
        out.append(lllh)
        if prephasing is not None:
            aff = side.reorder.compute_phase_affiliation(am, haplotypes, breakpoints, prephasing, 0.07)
            out.append(aff)
            out.append(side.reorder.get_optimal_assignments(breakpoints, lllh, ploidy, aff))
        out.append(side.reorder.get_optimal_assignments(breakpoints, lllh, ploidy, None))
        return out

    assert_same(*both(run))


def test_no_ilp_solver_here():
    """Without PuLP both packages raise the same SolverError (and the
    prephasing cases above take the chain DP)."""
    def run(side):
        with pytest.raises(side.poly.SolverError) as e:
            side.poly.get_ilp_solver()
        return str(e.value)

    assert_same(*both(run))


@pytest.mark.parametrize("name", ["cuts", "chr22", "indels"])
def test_genotypes_and_partial_phasing_match_reference(name):
    """create_genotype_list and extract_partial_phasing over the fixtures'
    variant tables."""
    path = {"cuts": CUTS, "chr22": CHR22, "indels": INDELS}[name]["variant_file"]

    def run(side):
        out = []
        for table in side.vcf.VcfReader(path, phases=True, ploidy=4):
            for sample in table.samples:
                out.append(side.poly.create_genotype_list(table, sample))
                pre = side.poly.extract_partial_phasing(table, sample, 4)
                out.append(None if pre is None else _am_view(pre))
        return out

    assert_same(*both(run))


@pytest.mark.parametrize("seed", range(4))
def test_mathutils_matches_reference(seed):
    rng = np.random.default_rng(seed)

    def run(side):
        m = side.mathutils
        out = []
        for _ in range(60):
            n = int(rng.integers(0, 70))
            k = int(rng.integers(0, n + 2))
            p = float(rng.random())
            out += [m.binomial_coefficient(n, k), m.binomial_coefficient_log(n, k),
                    m.binom_pmf(n, k, p), m.log_binom_pmf(n, k, p)]
            counts = rng.integers(0, 12, size=int(rng.integers(1, 5))).tolist()
            probs = rng.dirichlet(np.ones(len(counts))).tolist()
            out += [m.log_multinomial_coefficient(counts), m.check_multinom_input(counts, probs),
                    m.multinom_pmf(counts, probs), m.log_multinom_pmf(counts, probs)]
        return [repr(x) for x in out]  # nan == nan

    state = rng.bit_generator.state
    ref = run(SIDES["ref"])
    rng.bit_generator.state = state
    assert run(SIDES["port"]) == ref


@pytest.mark.parametrize("seed", range(4))
def test_triangle_matrix_and_progeny_likelihoods_match_reference(seed):
    def run(side):
        rng = np.random.default_rng(seed)
        m = side.solver.TriangleSparseMatrix()
        for _ in range(80):
            i, j = (int(x) for x in rng.integers(0, 30, 2))
            if i != j:
                m.set(i, j, float(rng.normal()))
        for _ in range(10):
            i, j = (int(x) for x in rng.integers(0, 30, 2))
            if i != j:
                m.setDoubleInt(i, j, int(rng.integers(0, 1000)), int(rng.integers(0, 1000)))
        entries = m.getEntries()
        out = [m.size(), m.getMaxDim(), m.getIndices(), entries,
               [m.get(i, j) for i, j in entries], [m.getDoubleInt(i, j) for i, j in entries[:10]]]
        ploidy, samples, n_pos = 4, 3, 6
        gl = side.solver.ProgenyGenotypeLikelihoods(ploidy, samples, n_pos)
        for pos in range(n_pos):
            for s in range(samples):
                gl.setGlv(pos, s, rng.dirichlet(np.ones(ploidy + 1)).tolist())
        out.append([gl.getGlv(p, s) for p in range(n_pos) for s in range(samples)])
        out.append([(gl.getSimplexNulliplexScore(a, b), gl.getSimplexSimplexScore(a, b),
                     gl.getDuplexNulliplexScore(a, b)) for a in range(n_pos) for b in range(n_pos)])
        return [repr(x) for x in out]

    assert_same(*both(run))


@pytest.mark.parametrize("seed", range(3))
def test_plot_helpers_and_pdfs_match_reference(seed, tmp_path, monkeypatch):
    """The plots' helpers on random input, and the PDFs of each drawing
    function (SOURCE_DATE_EPOCH set) byte for byte."""
    pytest.importorskip("matplotlib")
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")

    def run(side_name):
        side = SIDES[side_name]
        p = side.plots
        rng = np.random.default_rng(seed)
        out_dir = tmp_path / side_name
        out_dir.mkdir()
        out = [p.parse_haplotype(n) for n in
               ("read17_HG00514_HAP1", "x_NA19240_HAP2", "a_b_HG00733_HAP1", "plain", "x_OTHER_HAP1")]
        h1, h2 = rng.integers(0, 2, 20).tolist(), rng.integers(0, 2, 20).tolist()
        out += [p.relative_hamming_dist(h1, h2), p.relative_hamming_dist(h1, h2[:5])]
        intervals = [tuple(sorted(rng.integers(0, 20, 2).tolist())) for _ in range(6)]
        out += [p.haplodist(h1, h2, intervals), p.diff_ratio(float(rng.random())), p.diff_ratio(None)]
        reads = _random_reads(seed, 4, n_pos=16, n_reads=20)
        rs = _readset(side.core, reads)
        out.append(p.avg_readlength(rs))
        clustering = [list(range(i, len(rs), 4)) for i in range(4)]
        p.draw_clustering(rs, clustering, None, str(out_dir / "clusters.pdf"))
        p.create_histogram(str(out_dir / "hist.pdf"), rng.integers(0, 9, 30).tolist(),
                           rng.integers(0, 9, 30).tolist(), 10, [0, 10], "x", "t")
        p.draw_genetic_clustering([[0, 1, 2], [3, 4], [5]], 6, str(out_dir / "genetic.pdf"))
        p.draw_genetic_clustering_arrangement([[0, 1, 2], [3, 4], [5]], [[0], [1, 2], []], 6,
                                              str(out_dir / "arrangement.pdf"))
        out.append({f.name: f.read_bytes() for f in sorted(out_dir.iterdir())})
        return out

    ref, port = run("ref"), run("port")
    assert port == ref


# ---------------------------------------------------------------------------
# the fixtures of the reference's module tests, through both packages


def _fixture_module(name, side):
    """tests/<name>.py loaded as a module of its own: for "ref" as it is,
    for "port" with whatshap_tpu read as whatshap_torch and the readsets of
    whatshap_tpu.testhelpers.string_to_readset converted to the port's."""
    source = (REPO / "tests" / f"{name}.py").read_text()
    mod = types.ModuleType(f"_{side}_{name}")
    mod.__file__ = str(REPO / "tests" / f"{name}.py")
    if side == "port":
        source = re.sub(r"from whatshap_tpu\.testhelpers import [^\n]*\n", "", source)
        source = source.replace("whatshap_tpu", "whatshap_torch")
        mod.string_to_readset = lambda *a, **k: _convert(ref_testhelpers.string_to_readset(*a, **k))
    exec(compile(source, mod.__file__, "exec"), mod.__dict__)
    return mod


def _convert(ref_readset):
    rs = core.ReadSet()
    for r in ref_readset:
        read = core.Read(r.name, r.mapqs[0], r.source_id, r.sample_id)
        for v in r:
            read.add_variant(v.position, v.allele, v.quality)
        rs.add(read)
    return rs


FIXTURES = {
    "test_reorder": ["get_instance1", "get_instance2", "get_instance3"],
    "test_threading": ["create_testinstance1", "create_testinstance2", "create_testinstance3"],
}


@pytest.mark.parametrize("module,builder", [(m, b) for m, bs in FIXTURES.items() for b in bs])
def test_reference_fixtures_through_both(module, builder):
    """Each fixture of tests/test_reorder.py and tests/test_threading.py,
    built in both packages, through scoring, cluster editing, threading,
    sub-instances, breakpoints, link likelihoods, reordering and the
    whole solve."""
    def run(side_name):
        side = SIDES[side_name]
        fixture = getattr(_fixture_module(module, side_name), builder)()
        if module == "test_reorder":
            am, clustering, threads, haplotypes = fixture
            ploidy = len(haplotypes)
            genotypes = [{a: col.count(a) for a in sorted(set(col))}
                         for col in (list(c) for c in zip(*haplotypes))]
        else:
            readset, _var_pos, clustering, genotypes = fixture
            am = side.solver.AlleleMatrix(readset)
            ploidy = sum(genotypes[0].values())
            threads, haplotypes = side.threading.run_threading(
                am, clustering, ploidy, [dict(g) for g in genotypes])
        out = [_am_view(am), threads, haplotypes]
        subs = side.reorder.find_subinstances(am, clustering, threads, haplotypes)
        out.append([(cid, ts, _am_view(sub)) for cid, ts, sub in subs])
        breakpoints = side.reorder.find_breakpoints(threads)
        lllh = side.reorder.compute_link_likelihoods(threads, haplotypes, breakpoints, clustering, am, 0.07)
        out += [breakpoints, lllh, side.reorder.get_optimal_assignments(breakpoints, lllh, ploidy, None)]
        threads2, haps2 = [list(t) for t in threads], [list(h) for h in haplotypes]
        side.reorder.run_reordering(am, clustering, threads2, haps2, breakpoints, None)
        out += [threads2, haps2, breakpoints]
        sim = side.solver.scoreReadset(am, 2, ploidy, 0.07)
        out += [sorted(sim.m.items()), side.solver.ClusterEditingSolver(sim, False).run()]
        if len(genotypes) == am.getNumPositions():
            out.append(side.algorithm.solve_polyphase_instance(
                am, [dict(g) for g in genotypes], _param(side.poly, ploidy), side.StageTimer()))
        return out

    assert_same(run("ref"), run("port"))


# ---------------------------------------------------------------------------
# the reference's module tests, run on the port

REF_MODULE_TESTS = ["test_allelematrix", "test_clusterediting", "test_threading",
                    "test_readscoring", "test_reorder", "test_plots"]


def _test_names(name):
    tree = ast.parse((REPO / "tests" / f"{name}.py").read_text())
    return [n.name for n in tree.body if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]


@pytest.mark.parametrize("module,test", [(m, t) for m in REF_MODULE_TESTS for t in _test_names(m)])
def test_reference_module_test_on_the_port(module, test, tmp_path, monkeypatch):
    """The reference's test, with whatshap_tpu read as whatshap_torch,
    passes on the port."""
    if module == "test_plots":
        pytest.importorskip("matplotlib")
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    fn = getattr(_fixture_module(module, "port"), test)
    args = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**{a: args[a] for a in fn.__code__.co_varnames[: fn.__code__.co_argcount]})
