"""
The port's host tools against the reference's, on the CPU: compare, stats,
split, unphase, hapcut2vcf and haplotagphase of whatshap_torch.cli, and
whatshap_tpu.cli's, run on the same committed fixtures must write the same
bytes (every file each run writes, and what it prints), and raise the same
exception class with the same message where the reference raises.  The
cases are those of tests/test_run_{compare,stats,split,unphase,hapcut2vcf,
haplotagphase}.py, with a few more options of each tool.

One difference is stated where it applies: a gzip-compressed output (split
to .fastq.gz) carries the time of the run in its gzip header, so .gz
outputs are compared decompressed.

Also here: compare's switch/flip distance (SwitchFlipCalculator, through
csrc/host/switchfliplib.cpp) and block errors against the reference's on the
reference's cases (its random phasings against the Python paths are in
test_torch_hostlib.py), and verification.verify_mec_score_and_partitioning
over the port's PedigreeDPTable(device="cpu").

Outputs go under pytest's temporary directories; nothing under tests/data
is written.
"""

import contextlib
import gzip
import io
from pathlib import Path

import numpy as np
import pytest

import whatshap_tpu.cli.compare as ref_compare
import whatshap_tpu.cli.hapcut2vcf as ref_hapcut2vcf
import whatshap_tpu.cli.haplotagphase as ref_haplotagphase
import whatshap_tpu.cli.split as ref_split
import whatshap_tpu.cli.stats as ref_stats
import whatshap_tpu.cli.unphase as ref_unphase
import whatshap_tpu.core as ref_core
from whatshap_tpu.testhelpers import matrix_to_readset, string_to_readset

import whatshap_torch.cli.compare as compare
import whatshap_torch.cli.hapcut2vcf as hapcut2vcf
import whatshap_torch.cli.haplotag as haplotag
import whatshap_torch.cli.haplotagphase as haplotagphase
import whatshap_torch.cli.split as split
import whatshap_torch.cli.stats as stats
import whatshap_torch.cli.unphase as unphase
import whatshap_torch.core as core
from whatshap_torch.verification import verify_mec_score_and_partitioning

REPO = Path(__file__).parent.parent
DATA = "tests/data"


class Out(str):
    """An output file name in a case: run_both puts it under the run's own
    directory."""


def _place(value, out_dir):
    if isinstance(value, Out):
        return str(out_dir / value)
    if isinstance(value, list):
        return [_place(v, out_dir) for v in value]
    return value


def _written(out_dir):
    files = {}
    for path in sorted(out_dir.iterdir()):
        data = path.read_bytes()
        files[path.name] = gzip.decompress(data) if path.suffix == ".gz" else data
    return files


def run_both(tmp_path, ref_fn, port_fn, **kwargs):
    """Call ref_fn and port_fn with `kwargs` (each Out placed under a
    directory of its side); return [(files written, stdout, exception)] of
    the reference and of the port.  Paths of a side read "<out>" in its
    stdout and messages, so that the two compare."""
    results = []
    for side, fn in (("ref", ref_fn), ("port", port_fn)):
        out_dir = tmp_path / side
        out_dir.mkdir()
        stdout, error = io.StringIO(), None
        with contextlib.redirect_stdout(stdout):
            try:
                fn(**{k: _place(v, out_dir) for k, v in kwargs.items()})
            except Exception as e:  # noqa: BLE001 - compared below
                error = (type(e).__name__, str(e).replace(str(out_dir), "<out>"))
        results.append((_written(out_dir), stdout.getvalue().replace(str(out_dir), "<out>"), error))
    return results


def assert_same(results, raises=False):
    (ref_files, ref_out, ref_error), (files, out, error) = results
    assert error == ref_error
    assert (ref_error is not None) == raises, ref_error
    assert files.keys() == ref_files.keys()
    for name in ref_files:
        assert files[name] == ref_files[name], f"{name} differs from the reference's"
    assert out == ref_out
    return ref_files


# ---------------------------------------------------------------------------
# compare

COMPARE_CASES = [
    ("compare1", dict(vcf=[f"{DATA}/phased1.vcf", f"{DATA}/phased2.vcf"], ploidy=2,
                      names="p1,p2", tsv_pairwise=Out("pairwise.tsv"), sample="sample1")),
    ("compare2", dict(vcf=[f"{DATA}/phased1.vcf", f"{DATA}/phased2.vcf"], ploidy=2,
                      names="p1,p2", tsv_pairwise=Out("pairwise.tsv"), sample="sample2")),
    *[
        (f"polyploid_{a}_{b}_{sample}", dict(
            vcf=[f"{DATA}/phased.poly{a}.vcf", f"{DATA}/phased.poly{b}.vcf"], ploidy=4,
            names="p1,p2", tsv_pairwise=Out("pairwise.tsv"), sample=sample))
        for a, b, sample in ((1, 2, "sample1"), (1, 2, "sample2"), (1, 3, "sample1"))
    ],
    ("only_snvs", dict(vcf=[f"{DATA}/phased1.vcf", f"{DATA}/phased2.vcf"], ploidy=2,
                       names="p1,p2", tsv_pairwise=Out("pairwise.tsv"), sample="sample2",
                       only_snvs=True)),
    ("unphased", dict(vcf=[f"{DATA}/unphased.vcf"] * 3, ploidy=2, sample="sample1")),
    ("ignore_sample_name", dict(
        vcf=[f"{DATA}/phased_single_sample1.vcf", f"{DATA}/phased_single_sample2.vcf"],
        ploidy=2, names="p1,p2", tsv_pairwise=Out("pairwise.tsv"), ignore_sample_name=True)),
    ("mav", dict(vcf=[f"{DATA}/mav_1.vcf", f"{DATA}/mav_2.vcf"], ploidy=2,
                 tsv_pairwise=Out("pairwise.tsv"), ignore_sample_name=True)),
    # every report but the plots, on three files (the multiway table)
    *[
        (f"all_reports_{sample}", dict(
            vcf=[f"{DATA}/phased1.vcf", f"{DATA}/phased2.vcf", f"{DATA}/phased3.vcf"], ploidy=2,
            sample=sample, tsv_pairwise=Out("pairwise.tsv"), tsv_multiway=Out("multiway.tsv"),
            switch_error_bed=Out("switches.bed"), longest_block_tsv=Out("longest.tsv")))
        for sample in ("sample1", "sample2")
    ],
]


@pytest.mark.parametrize("kwargs", [c[1] for c in COMPARE_CASES], ids=[c[0] for c in COMPARE_CASES])
def test_compare_byte_identical(kwargs, tmp_path):
    assert_same(run_both(tmp_path, ref_compare.run_compare, compare.run_compare, **kwargs))


COMPARE_ERRORS = [
    ("names_count", dict(vcf=[f"{DATA}/phased1.vcf", f"{DATA}/phased2.vcf"], ploidy=2,
                         names="p1,p2,p3")),
    ("missing_sample", dict(vcf=[f"{DATA}/phased1.vcf", f"{DATA}/phased2.vcf"], ploidy=2,
                            sample="nobody")),
    # the switch-error BED, the longest-block table and three files at once
    # are for diploids only
    ("polyploid_multiway", dict(
        vcf=[f"{DATA}/phased.poly1.vcf", f"{DATA}/phased.poly2.vcf", f"{DATA}/phased.poly3.vcf"],
        ploidy=4, sample="sample1", tsv_multiway=Out("multiway.tsv"))),
    *[
        (f"polyploid_{report}", dict(vcf=[f"{DATA}/phased.poly1.vcf", f"{DATA}/phased.poly3.vcf"],
                                     ploidy=4, sample="sample1", **{report: Out("report")}))
        for report in ("switch_error_bed", "longest_block_tsv")
    ],
]


@pytest.mark.parametrize("kwargs", [c[1] for c in COMPARE_ERRORS], ids=[c[0] for c in COMPARE_ERRORS])
def test_compare_raises_as_the_reference(kwargs, tmp_path):
    assert_same(run_both(tmp_path, ref_compare.run_compare, compare.run_compare, **kwargs), raises=True)


SWITCH_FLIP_CASES = [
    (["0100", "1011"], ["0000", "1111"], dict(flip_cost=3)),
    (["00000000", "11111111"], ["00000000", "11111111"], {}),
    ([[0] * 8, [0] * 4 + [1] * 4], [[0] * 4 + [1] * 4, [0] * 8], {}),
    ([[0] * 8, [0] * 4 + [1] * 4], [[0] * 8, [0] * 8], {}),
    ([[1] * 4 + [0] * 4, [0] * 4 + [1] * 4], [[0] * 8, [1] * 8], {}),
    ([[1, 1, 1, 1, 0, 0, 1, 0], [0] * 4 + [1] * 4], [[0] * 8, [1] * 8], {}),
    ([[1, 1, 1, 1, 0, 0, 1, 0], [0] * 4 + [1] * 4], [[0] * 8, [1] * 8], dict(flip_cost=5, switch_cost=1)),
    ([[1, 1, 1, 1, 0, 0, 1, 0], [0] * 4 + [1] * 4], [[0] * 8, [1] * 8], dict(flip_cost=1, switch_cost=10)),
    ([[0, 0, 0, 1, 0, 0, 0, 0], [1, 1, 1, 0, 1, 1, 1, 1]], [[0] * 8, [1] * 8], {}),
    ([[0, 0, 0, 1, 0, 0, 0, 0], [1, 1, 1, 0, 1, 1, 1, 1]], [[0] * 8, [1] * 8], dict(flip_cost=5, switch_cost=1)),
    ([[0, 0, 0, 1, 0, 0, 0, 0], [1] * 8], [[0] * 8, [1] * 8], dict(flip_cost=float("inf"), switch_cost=1)),
]


@pytest.mark.parametrize("phasing, truth, costs", SWITCH_FLIP_CASES)
def test_compute_switch_flips_poly_matches_reference(phasing, truth, costs):
    got = compare.compute_switch_flips_poly(phasing, truth, **costs)
    want = ref_compare.compute_switch_flips_poly(phasing, truth, **costs)
    assert (got.switches, got.flips) == (want.switches, want.flips)


BLOCKS = [
    (["1111111111", "0000000000"], ["1111100000", "0000011111"]),
    (["000000", "101111", "111010"], ["000000", "101010", "111111"]),
    (["1110001", "1011101", "0000010"], ["1110001", "1010010", "0001101"]),
    (["1111101", "1010001", "0000010"], ["1110001", "1010010", "0001101"]),
    (["111111", "111111", "111111"], ["111111", "000000", "111111"]),
]


@pytest.mark.parametrize("phasing, truth", BLOCKS)
def test_compare_block_matches_reference(phasing, truth):
    got, want = compare.compare_block(phasing, truth), ref_compare.compare_block(phasing, truth)
    assert repr(got) == repr(want)
    assert compare.compute_switch_errors_poly(phasing, truth) == ref_compare.compute_switch_errors_poly(
        phasing, truth)


# ---------------------------------------------------------------------------
# stats

STATS_CASES = [
    ("stats1", dict(vcf=f"{DATA}/phased1.vcf", tsv=Out("stats.tsv"), sample="sample1",
                    chr_lengths=f"{DATA}/chr-lengths.txt")),
    ("stats2", dict(vcf=f"{DATA}/phased3.vcf", tsv=Out("stats.tsv"), sample="sample1",
                    chr_lengths=f"{DATA}/chr-lengths.txt")),
    ("overlapping", dict(vcf=f"{DATA}/phased_overlapping.vcf", tsv=Out("stats.tsv"), sample="sample1")),
    ("unphased", dict(vcf=f"{DATA}/unphased.vcf", tsv=Out("stats.tsv"), sample="sample1",
                      chromosomes=["chrA"])),
    # the GTF and the block list too, every sample, SNVs only
    *[
        (f"all_outputs_{sample}", dict(
            vcf=f"{DATA}/phased1.vcf", tsv=Out("stats.tsv"), sample=sample, gtf=Out("blocks.gtf"),
            block_list=Out("blocks.tsv"), chr_lengths=f"{DATA}/chr-lengths.txt"))
        for sample in ("sample1", "sample2")
    ],
    ("only_snvs_chromosomes", dict(vcf=f"{DATA}/phased3.vcf", tsv=Out("stats.tsv"), only_snvs=True,
                                   chromosomes=["chrA,chrB"], gtf=Out("blocks.gtf"))),
    ("pacbio_hapchat", dict(vcf=f"{DATA}/pacbio/phased_hapchat.vcf", tsv=Out("stats.tsv"),
                            block_list=Out("blocks.tsv"))),
]


@pytest.mark.parametrize("kwargs", [c[1] for c in STATS_CASES], ids=[c[0] for c in STATS_CASES])
def test_stats_byte_identical(kwargs, tmp_path):
    files = assert_same(run_both(tmp_path, ref_stats.run_stats, stats.run_stats, **kwargs))
    assert files["stats.tsv"].count(b"\n") >= 2


@pytest.mark.parametrize("chromosomes", [["chrA,chrB,chrC"], ["chrA,chrB,", "chrC"], [",", "chrA"]])
def test_unpack_chromosomes_matches_reference(chromosomes):
    assert stats.unpack_chromosomes(chromosomes) == ref_stats.unpack_chromosomes(chromosomes)


# ---------------------------------------------------------------------------
# split


def _bam_to_fastq(bam_path, fastq_path):
    from whatshap_torch.io import sam
    from whatshap_torch.utils import xopen

    with sam.AlignmentFile(bam_path) as af, xopen(fastq_path, "w") as fastq:
        for record in af:
            fastq.write(f"@{record.query_name}\n{record.query_sequence}\n+\n{record.qual}\n")


SPLIT_CASES = [
    ("bam_h1_h2", dict(reads_file=f"{DATA}/pacbio/pacbio.bam", list_file=f"{DATA}/pacbio/haplotags.txt",
                       output_h1=Out("h1.bam"), output_h2=Out("h2.bam"))),
    ("bam_untagged_histogram", dict(
        reads_file=f"{DATA}/pacbio/pacbio.bam", list_file=f"{DATA}/pacbio/haplotags.txt",
        output_h1=Out("h1.bam"), output_h2=Out("h2.bam"), output_untagged=Out("untagged.bam"),
        read_lengths_histogram=Out("lengths.tsv"))),
    ("bam_add_untagged", dict(reads_file=f"{DATA}/pacbio/pacbio.bam",
                              list_file=f"{DATA}/pacbio/haplotags.txt",
                              outputs=[Out("a.bam"), Out("b.bam")], add_untagged=True)),
    ("bam_largest_block_discard", dict(
        reads_file=f"{DATA}/pacbio/pacbio.bam", list_file=f"{DATA}/pacbio/haplotags.txt",
        output_h1=Out("h1.bam"), output_h2=Out("h2.bam"), only_largest_block=True,
        discard_unknown_reads=True)),
    ("no_sequence", dict(reads_file=f"{DATA}/reads-no-sequence.bam",
                         list_file=f"{DATA}/reads-no-sequence.haplotags.tsv",
                         output_h1=Out("h1.bam"), output_h2=Out("h2.bam"),
                         output_untagged=Out("untagged.bam"), read_lengths_histogram=Out("lengths.tsv"))),
]


@pytest.mark.parametrize("kwargs", [c[1] for c in SPLIT_CASES], ids=[c[0] for c in SPLIT_CASES])
def test_split_byte_identical(kwargs, tmp_path):
    files = assert_same(run_both(tmp_path, ref_split.run_split, split.run_split, **kwargs))
    assert any(len(v) > 0 for v in files.values())


def test_split_fastq_byte_identical(tmp_path):
    from whatshap_torch.utils import xopen

    fastq, listing = tmp_path / "reads.fastq.gz", tmp_path / "readlist.txt"
    with xopen(fastq, "w") as f:
        f.write("@r\nACGT\n+\n####\n@s\nGGTA\n+\n####\n")
    listing.write_text("r\tH1\ns\tH2\n")
    files = assert_same(run_both(tmp_path, ref_split.run_split, split.run_split, reads_file=str(fastq),
                                 list_file=str(listing), output_h1=Out("h1.fastq.gz"),
                                 output_h2=Out("h2.fastq")))
    assert files["h1.fastq.gz"] == b"@r\nACGT\n+\n####\n"


@pytest.mark.parametrize("fmt", ("bam", "fastq", "fastq.gz"))
@pytest.mark.parametrize("add_untagged", (False, True))
def test_split_tetraploid_byte_identical(tmp_path, add_untagged, fmt):
    """The reference's tetraploid case: the port's haplotag writes the list
    and the tagged BAM, and both splits read them."""
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    haplotag.run_haplotag(variant_file=f"{DATA}/haplotag_poly.vcf.gz",
                          alignment_file=f"{DATA}/haplotag_poly.bam", ploidy=4,
                          output=str(inputs / "reads.bam"), haplotag_list=str(inputs / "list.txt"))
    reads = inputs / f"reads.{fmt}"
    if fmt.startswith("fastq"):
        _bam_to_fastq(f"{DATA}/haplotag_poly.bam", reads)
    files = assert_same(run_both(
        tmp_path, ref_split.run_split, split.run_split, reads_file=str(reads),
        list_file=str(inputs / "list.txt"), outputs=[Out(f"split.{i}.{fmt}") for i in (1, 2, 3, 4)],
        add_untagged=add_untagged))
    assert len(files) == 4


# ---------------------------------------------------------------------------
# unphase, hapcut2vcf, haplotagphase

UNPHASE_CASES = ["phased-via-mixed-HP-PS.vcf", "string_typed_ps_tag.vcf", "phased1.vcf",
                 "pacbio/phased_hapchat.vcf"]


@pytest.mark.parametrize("name", UNPHASE_CASES)
def test_unphase_byte_identical(name, tmp_path):
    files = assert_same(run_both(tmp_path, ref_unphase.run_unphase, unphase.run_unphase,
                                 vcf_path=f"{DATA}/{name}", outfile=Out("out.vcf")))
    if name == "phased-via-mixed-HP-PS.vcf":
        assert files["out.vcf"] == (REPO / DATA / "unphased.vcf").read_bytes()


def test_hapcut2vcf_byte_identical(tmp_path):
    files = assert_same(run_both(tmp_path, ref_hapcut2vcf.run_hapcut2vcf, hapcut2vcf.run_hapcut2vcf,
                                 hapcut=f"{DATA}/pacbio/hapcut.txt", vcf=f"{DATA}/pacbio/variants.vcf",
                                 output=Out("hapcut.vcf")))
    assert b"|" in files["hapcut.vcf"]


HAPLOTAGPHASE = dict(variant_file=f"{DATA}/pacbio/variants_haplotagphase.vcf",
                     alignment_file=f"{DATA}/pacbio/haplotagged.bam",
                     reference=f"{DATA}/pacbio/reference.fasta", output=Out("out.vcf"))
HAPLOTAGPHASE_CASES = [
    ("default", {}),
    ("no_mav", dict(mav=False)),
    ("only_indels", dict(only_indels=True)),
    ("gap_cut", dict(gap_threshold=90, cut_poly=3)),
    ("no_header", dict(write_command_line_header=False)),
]


@pytest.mark.parametrize("extra", [c[1] for c in HAPLOTAGPHASE_CASES], ids=[c[0] for c in HAPLOTAGPHASE_CASES])
def test_haplotagphase_byte_identical(extra, tmp_path):
    files = assert_same(run_both(tmp_path, ref_haplotagphase.run_haplotagphase,
                                 haplotagphase.run_haplotagphase, **HAPLOTAGPHASE, **extra))
    assert files["out.vcf"].count(b"\n") > 10


def test_compute_votes_matches_reference():
    def reads(mod):
        out = []
        for name, source, hp, ps, variants in (
            ("a", 1, 1, 1, [(1, 0, 30), (2, 0, 10), (3, 0, 50)]),
            ("b", 2, 1, 1, [(1, 1, 20), (2, 0, 30), (3, 0, 90)]),
            ("c", 1, 2, 1, [(1, 1, 20), (3, 0, 10)]),
            ("d", 0, 2, 1, [(1, 0, 30), (2, 0, 10), (3, 0, 50)]),
            ("d", 1, 0, 1, [(1, 0, 30), (2, 0, 10), (3, 0, 50)]),
        ):
            read = mod.Read(name, 60, 0, 0, 0, "", source, hp)
            for position, allele, quality in variants:
                read.add_variant(position, allele, quality)
            out.append(read)
        return out

    args = ({1: False, 2: False, 3: True},)
    ids = {1: {0: 0, 1: 1}, 2: {0: 0, 1: 1}, 3: {0: 0, 1: 1}}
    got = haplotagphase.compute_votes(*args, reads(core), allele_to_id=ids)
    want = ref_haplotagphase.compute_votes(*args, reads(ref_core), allele_to_id=ids)
    assert got == want
    assert got == {1: {(0, 0): 50, (0, 1): 0, (1, 1): 20, (1, 0): 0}, 2: {(0, 0): 10, (0, 1): 30}}


# ---------------------------------------------------------------------------
# verification over the port's PedigreeDPTable


def _port_readset(ref_readset):
    rs = core.ReadSet()
    for ref_read in ref_readset:
        read = core.Read(ref_read.name, ref_read.mapqs[0], ref_read.source_id, ref_read.sample_id)
        for v in ref_read:
            read.add_variant(v.position, v.allele, v.quality)
        rs.add(read)
    return rs


def _random_readset(seed):
    rng = np.random.default_rng(seed)
    n_pos = int(rng.integers(3, 14))
    positions = np.sort(rng.choice(np.arange(10, 2000, 10), n_pos, replace=False))
    rs = core.ReadSet()
    for i in range(int(rng.integers(2, 12))):
        start = int(rng.integers(0, n_pos - 1))
        stop = int(rng.integers(start + 2, n_pos + 1))
        read = core.Read(f"r{i}", 50, 0, 0)
        for p in range(start, stop):
            read.add_variant(int(positions[p]), int(rng.integers(0, 2)), int(rng.choice([1, 5, 10, 30])))
        rs.add(read)
    rs.sort()
    return rs


def _verify(rs, all_heterozygous):
    positions = rs.get_positions()
    pedigree = core.Pedigree(core.NumericSampleIds())
    likelihoods = [None if all_heterozygous else core.PhredGenotypeLikelihoods([0, 0, 0])] * len(positions)
    pedigree.add_individual("individual0", [core.Genotype([0, 1]) for _ in positions], likelihoods)
    table = core.PedigreeDPTable(rs, [1] * len(positions), pedigree,
                                 distrust_genotypes=not all_heterozygous, device="cpu")
    verify_mec_score_and_partitioning(table, rs)


FIXTURE = """
  0             0
  110111111111
  00100
       0001000000
       000
        10100
              101
"""


@pytest.mark.parametrize("all_heterozygous", [True, False], ids=["heterozygous", "distrust"])
@pytest.mark.parametrize("source", ["string", "matrix", *[f"random{s}" for s in range(6)]])
def test_verification_on_port_dptable(source, all_heterozygous, capsys):
    if source == "string":
        rs = _port_readset(string_to_readset(FIXTURE))
    elif source == "matrix":
        with open(REPO / "tests" / "test.matrix") as f:
            rs = _port_readset(matrix_to_readset(f))
    else:
        rs = _random_readset(int(source[6:]))
    _verify(rs, all_heterozygous)
    assert "Expected MEC score" in capsys.readouterr().out
