"""
The port's `haplotag` against the reference's, on the CPU:
whatshap_torch.cli.haplotag.run_haplotag and whatshap_tpu.cli.haplotag's,
run on the same committed fixtures, must write the same bytes (the tagged
BAM with its @PG line, and the haplotag list), and raise the same exception
class with the same message where the reference raises.  The cases are
those of tests/test_run_haplotag.py, with its argument-parser cases held
against the reference's parser.

One difference is stated where it applies: a CRAM output carries the
writer's name in its file definition and the time of the run in the gzip
header of each block, so the CRAM case compares the header and the records
decoded, not the bytes.

Outputs go under pytest's temporary directories; nothing under tests/data
is written.
"""

import argparse
import shutil
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

import whatshap_tpu.cli.haplotag as ref_haplotag  # noqa: E402
from whatshap_tpu.io import sam as ref_sam  # noqa: E402

import whatshap_torch.cli.haplotag as haplotag  # noqa: E402
from whatshap_torch.io import sam  # noqa: E402
from test_torch_tools import Out, assert_same, run_both  # noqa: E402

DATA = "tests/data"
H1, H2 = f"{DATA}/haplotag_1.vcf.gz", f"{DATA}/haplotag_2.vcf.gz"
BAM = f"{DATA}/haplotag.bam"
SUPP = dict(variant_file=f"{DATA}/supplementary_strategy_test.grch38.vcf.gz",
            alignment_file=f"{DATA}/supplementary_strategy_test.grch38.bam", ignore_read_groups=True)
OUT = dict(output=Out("out.bam"))


def _both(tmp_path, strategy=None, **kwargs):
    """run_both over the two run_haplotag; `strategy` names a
    SupplementaryHaplotaggingStrategy member, given to each side as its own
    module's enum."""
    def side(module):
        def run(**kw):
            if strategy is not None:
                kw["supplementary_strategy"] = module.SupplementaryHaplotaggingStrategy[strategy]
            return module.run_haplotag(**kw)
        return run

    return run_both(tmp_path, side(ref_haplotag), side(haplotag), **kwargs)


# (id, arguments); the supplementary strategy by its member's name
CASES = [
    *[(f"list_{i}", dict(variant_file=vcf, alignment_file=BAM, haplotag_list=Out("list.tsv"), **OUT))
      for i, vcf in ((1, H1), (2, H2))],
    *[(f"vcf_{name}", dict(variant_file=f"{DATA}/{name}", alignment_file=BAM, **OUT))
      for name in ("haplotag_with_csi_index.vcf.gz", "haplotag_2.bcf")],
    ("supplementary_default", dict(**SUPP, **OUT)),
    ("supplementary_skip", dict(**SUPP, **OUT, strategy="SKIP")),
    *[
        (f"supplementary_copy_primary_{'strand' if match else 'any'}_{distance}", dict(
            **SUPP, **OUT, strategy="COPY_PRIMARY", supplementary_strand_match=match,
            supplementary_distance_threshold=distance))
        for match in (False, True) for distance in (100, 1_000_000)
    ],
    *[(f"supplementary_{s.lower()}", dict(**SUPP, **OUT, strategy=s))
      for s in ("INDEPENDENT_OR_SKIP", "INDEPENDENT_OR_COPY_PRIMARY")],
    *[(f"ignore_read_groups_{name}", dict(
        variant_file=H1, alignment_file=f"{DATA}/{name}.bam", haplotag_list=Out("list.tsv"),
        ignore_read_groups=True, **OUT))
      for name in ("haplotag", "haplotag_noSM", "haplotag_noRG")],
    ("missing_chromosome", dict(variant_file=f"{DATA}/haplotag.missing_chr.vcf.gz",
                                alignment_file=f"{DATA}/haplotag.large.bam", **OUT)),
    ("skip_missing_contigs", dict(variant_file=f"{DATA}/haplotag.without_chr2.vcf.gz",
                                  alignment_file=f"{DATA}/haplotag.large.bam", skip_missing_contigs=True,
                                  **OUT)),
    ("sample_given", dict(variant_file=f"{DATA}/haplotag_sample.vcf.gz",
                          alignment_file=f"{DATA}/haplotag_sample.bam", given_samples=["mother"], **OUT)),
    *[(f"sorting_{i}", dict(variant_file=f"{DATA}/{name}", alignment_file=f"{DATA}/haplotag.large.bam",
                            haplotag_list=Out("list.tsv"), **OUT))
      for i, name in ((1, "haplotag.large.vcf.gz"), (2, "haplotag.large.2.vcf.gz"))],
    ("10X", dict(variant_file=f"{DATA}/haplotag.10X.vcf.gz", alignment_file=f"{DATA}/haplotag.10X.bam",
                 haplotag_list=Out("list.tsv"), **OUT)),
    ("10X_2", dict(variant_file=f"{DATA}/haplotag.10X_2.vcf.gz", alignment_file=f"{DATA}/haplotag.10X.bam",
                   **OUT)),
    *[(f"10X_3_links_{not ignore}", dict(
        variant_file=f"{DATA}/haplotag.10X.vcf.gz", alignment_file=f"{DATA}/haplotag.10X_3.bam",
        ignore_linked_read=ignore, haplotag_list=Out("list.tsv"), **OUT))
      for ignore in (False, True)],
    ("10X_3_cutoff", dict(variant_file=f"{DATA}/haplotag.10X.vcf.gz",
                          alignment_file=f"{DATA}/haplotag.10X_3.bam", linked_read_distance_cutoff=10,
                          **OUT)),
    ("supplementary_untagged", dict(variant_file=f"{DATA}/haplotag.supplementary.vcf.gz",
                                    alignment_file=f"{DATA}/haplotag.supplementary.bam",
                                    ignore_read_groups=True, **OUT)),
    ("supplementary_tagged", dict(
        variant_file=f"{DATA}/haplotag.supplementary.vcf.gz",
        alignment_file=f"{DATA}/haplotag.supplementary.bam", ignore_read_groups=True,
        strategy="COPY_PRIMARY", supplementary_strand_match=False,
        supplementary_distance_threshold=1_000_000_000, haplotag_list=Out("list.tsv"), **OUT)),
    ("regions_chr1", dict(variant_file=H1, alignment_file=BAM, haplotag_list=Out("list.tsv"),
                          regions=["chr1"], **OUT)),
    ("selected_regions", dict(variant_file=H1, alignment_file=BAM, haplotag_list=Out("list.tsv"),
                              regions=["chr1:1054025-1069500", "chr1:1075700"], **OUT)),
    ("unmapped_reads", dict(variant_file=f"{DATA}/haplotag.10X.vcf.gz", alignment_file=f"{DATA}/unmapped.bam",
                            **OUT)),
    ("triploid", dict(variant_file=f"{DATA}/haplotag_triploid.vcf.gz",
                      alignment_file=f"{DATA}/haplotag_triploid.bam", ploidy=3,
                      haplotag_list=Out("list.tsv"), **OUT)),
    ("tetraploid", dict(variant_file=f"{DATA}/haplotag_poly.vcf.gz", alignment_file=f"{DATA}/haplotag_poly.bam",
                        ploidy=4, haplotag_list=Out("list.tsv"), **OUT)),
    ("pacbio_reference", dict(variant_file=f"{DATA}/pacbio/phased.vcf.gz",
                              alignment_file=f"{DATA}/pacbio/pacbio.bam",
                              reference=f"{DATA}/pacbio/reference.fasta", haplotag_list=Out("list.tsv"),
                              **OUT)),
]


@pytest.mark.parametrize("kwargs", [c[1] for c in CASES], ids=[c[0] for c in CASES])
def test_haplotag_byte_identical(kwargs, tmp_path):
    files = assert_same(_both(tmp_path, **kwargs))
    assert len(files["out.bam"]) > 28  # more than the BGZF end-of-file block


ERRORS = [
    ("contig_not_in_vcf_header", dict(variant_file=f"{DATA}/haplotag.without_chr2.vcf.gz",
                                      alignment_file=f"{DATA}/haplotag.large.bam", **OUT)),
    ("several_samples_without_read_groups", dict(
        variant_file=f"{DATA}/haplotag_noRG.vcf.gz", alignment_file=f"{DATA}/haplotag_noRG.bam",
        ignore_read_groups=True, **OUT)),
    ("nonexisting_region", dict(variant_file=H1, alignment_file=BAM, regions=["chr2"], **OUT)),
    ("sample_not_in_vcf", dict(variant_file=H1, alignment_file=BAM, given_samples=["nobody"], **OUT)),
]


@pytest.mark.parametrize("kwargs", [c[1] for c in ERRORS], ids=[c[0] for c in ERRORS])
def test_haplotag_raises_as_the_reference(kwargs, tmp_path):
    assert_same(_both(tmp_path, **kwargs), raises=True)


def test_haplotag_fails_if_index_missing(tmp_path):
    vcf = tmp_path / "vcf_without_index.vcf.gz"
    shutil.copy(H1, vcf)
    results = _both(tmp_path, variant_file=str(vcf), alignment_file=BAM, **OUT)
    assert results[0][2][0] == "CommandLineError"
    assert_same(results, raises=True)


def test_haplotag_duplicates_byte_identical(tmp_path):
    """Every record of haplotag.bam marked a duplicate (written once by the
    port's writer, under tmp_path) is tagged as it was."""
    dup = tmp_path / "haplotag-duplicates.bam"
    with sam.AlignmentFile(BAM) as infile, sam.AlignmentFile(str(dup), mode="wb", template=infile) as outfile:
        for record in infile:
            record.is_duplicate = True
            outfile.write(record)
    sam.index(str(dup))
    files = assert_same(_both(tmp_path, variant_file=H1, alignment_file=str(dup), **OUT))
    assert len(files["out.bam"]) > 28


def test_haplotag_run_twice_byte_identical(tmp_path):
    """haplotag of its own output: each side indexes its first BAM with its
    own writer's index and tags it again (a second, renamed whatshap @PG
    entry)."""
    outputs = []
    for side, module, samlib in (("ref", ref_haplotag, ref_sam), ("port", haplotag, sam)):
        first, second = tmp_path / f"{side}1.bam", tmp_path / f"{side}2.bam"
        args = dict(variant_file=f"{DATA}/haplotag_sample.vcf.gz", given_samples=["mother"])
        module.run_haplotag(alignment_file=f"{DATA}/haplotag_sample.bam", output=str(first), **args)
        samlib.index(str(first))
        module.run_haplotag(alignment_file=str(first), output=str(second), **args)
        outputs.append((first.read_bytes(), Path(f"{first}.bai").read_bytes(), second.read_bytes()))
    assert outputs[1] == outputs[0]
    with sam.AlignmentFile(str(tmp_path / "port2.bam")) as f:
        ids = [pg["ID"] for pg in f.header.get("PG") if pg["ID"].startswith("whatshap")]
    assert ids == ["whatshap", "whatshap.1"]


def _records(path, reference):
    with sam.AlignmentFile(str(path), reference_filename=reference) as f:
        assert f.is_cram
        return f.header.to_dict(), [sam.encode_bam_record(r) for r in f]


def test_haplotag_cram_output_same_records(tmp_path):
    """CRAM output: the same header and the same records.  The bytes differ
    in the file definition's writer name ("whatshap_tpu" / "whatshap_torch")
    and in the gzip time stamp of each block."""
    reference = f"{DATA}/pacbio/reference.fasta"
    paths = {}
    for side, module in (("ref", ref_haplotag), ("port", haplotag)):
        paths[side] = tmp_path / f"{side}.cram"
        module.run_haplotag(variant_file=f"{DATA}/pacbio/phased.vcf.gz",
                            alignment_file=f"{DATA}/pacbio/pacbio.bam", reference=reference,
                            output=str(paths[side]))
    header, records = _records(paths["port"], reference)
    assert (header, records) == _records(paths["ref"], reference)
    assert len(records) > 10 and sum(b"HPi" in r for r in records) > 0


PARSER_CASES = [
    [],
    ["--tag-supplementary"],
    ["--tag-supplementary", "skip"],
    ["--tag-supplementary", "copy-primary"],
    ["--tag-supplementary", "independent-or-skip"],
    ["--tag-supplementary", "independent-or-copy-primary"],
    ["--supplementary-distance", "100"],
    ["--tag-supplementary", "skip", "--supplementary-distance", "100"],
    ["--no-supplementary-strand-match"],
    ["--tag-supplementary", "skip", "--supplementary-distance", "100", "--no-supplementary-strand-match"],
    ["--ignore-linked-read", "--linked-read-distance-cutoff", "5", "--ploidy", "3", "--regions", "chr1"],
    ["--sample", "a", "--sample", "b", "--ignore-read-groups", "--skip-missing-contigs"],
]


def _parsed(module, argv):
    parser = argparse.ArgumentParser(prog="whatshap")
    module.add_arguments(parser)
    args = vars(parser.parse_args(argv + ["--no-reference", "--output", "out.bam", H2, BAM]))
    return {k: v.value if hasattr(v, "value") else v for k, v in args.items()}


@pytest.mark.parametrize("argv", PARSER_CASES, ids=[" ".join(a) or "defaults" for a in PARSER_CASES])
def test_haplotag_parser_matches_reference(argv):
    assert _parsed(haplotag, argv) == _parsed(ref_haplotag, argv)


def test_haplotag_from_parsed_arguments_byte_identical(tmp_path):
    """The reference's parser case: run_haplotag(**vars(args)) with
    --no-reference and the default --regions (None: every contig)."""
    def side(module):
        def run(output):
            parser = argparse.ArgumentParser(prog="whatshap")
            module.add_arguments(parser)
            args = parser.parse_args(["--no-reference", "--output", output, H2, BAM])
            args.reference = False
            del args.no_reference
            module.run_haplotag(**vars(args))
        return run

    files = assert_same(run_both(tmp_path, side(ref_haplotag), side(haplotag), output=Out("out.bam")))
    assert len(files["out.bam"]) > 28
