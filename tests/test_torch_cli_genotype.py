"""
The port's `genotype` entry point against the reference's, end to end on the
CPU: whatshap_tpu.cli.genotype.run_genotype (its default CPU route, the host
engine) and whatshap_torch.cli.genotype.run_genotype(device="cpu") (the
float64 plain route) on the same BAM, VCF, FASTA, PED and map files.

The main VCF is held to the reference's own CLI bar
(tests/test_geno_backends_cli.py:61-83, chip_smoke.cli_bar): GT and GQ exact,
GL within rel/abs 5e-3, two values both <= -30 counting as equal.  The priors
VCF (--priors-out) is byte-identical: both sides compute the priors with the
same host arithmetic.  The cases are the options of tests/test_run_genotype.py;
BAMs are regenerated from the committed SAMs into a temporary directory, and
nothing under tests/data is written.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from whatshap_tpu.cli import CommandLineError as RefCommandLineError
from whatshap_tpu.cli.genotype import run_genotype as ref_run_genotype

from chip_smoke import cli_bar, vcf_calls
from whatshap_torch.cli import CommandLineError
from whatshap_torch.cli.genotype import run_genotype
from whatshap_torch.io.sam import build_minimal_index, sam_to_bam

REPO = Path(__file__).parent.parent
DATA = "tests/data"
PED = f"{DATA}/trio.ped"
GENMAP = f"{DATA}/trio.map"
PACBIO = dict(
    phase_input_files=[f"{DATA}/pacbio/pacbio.bam"],
    variant_file=f"{DATA}/pacbio/variants.vcf",
    reference=f"{DATA}/pacbio/reference.fasta",
)
TRIO = dict(phase_input_files=["@trio.pacbio"], variant_file=f"{DATA}/trio.vcf")
# BAMs that tests/test_run_genotype.py regenerates from SAMs under tests/data:
# here they are made under a temporary directory instead ("@name" in
# phase_input_files stands for the BAM made from tests/data/<name>.sam)
SAM_BAMS = ("trio.pacbio", "paired_end.sorted", "quartet2", "recombination_breaks.sorted",
            "short-genome/short")


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    out = tmp_path_factory.mktemp("bams")
    paths = {}
    for name in SAM_BAMS:
        bam = str(out / f"{name.replace('/', '_')}.bam")
        sam_to_bam(f"{DATA}/{name}.sam", bam)
        build_minimal_index(bam)
        paths[name] = bam
    return paths


def _inputs(kwargs, bams):
    paths = [bams[p[1:]] if p.startswith("@") else p for p in kwargs["phase_input_files"]]
    return dict(kwargs, phase_input_files=paths)


# (id, arguments); every case but --no-priors also writes the priors VCF
CASES = [
    ("pacbio_reference", dict(PACBIO)),
    ("trio_ped_genmap", dict(TRIO, ped=PED, genmap=GENMAP)),
    ("no_priors", dict(TRIO, nopriors=True)),
    ("constant", dict(TRIO, constant=5.0)),
    ("gt_qual_threshold", dict(TRIO, gt_qual_threshold=13, only_snvs=True)),
    ("chromosome", dict(
        TRIO, variant_file=f"{DATA}/trio-two-chromosomes.vcf", ped=PED, genmap=GENMAP,
        chromosomes=["2"],
    )),
    ("only_snvs", dict(PACBIO, only_snvs=True)),
    ("use_ped_samples", dict(
        phase_input_files=[f"{DATA}/ped_samples.bam"], variant_file=f"{DATA}/ped_samples.vcf",
        ped=PED, genmap=GENMAP, use_ped_samples=True,
    )),
    ("stdout", dict(TRIO)),
    *[
        (f"chromosome_{key}_{chrom}", dict(
            TRIO, variant_file=f"{DATA}/trio-two-chromosomes.vcf", ped=PED, **{key: [chrom]},
        ))
        for key, chrom in (("chromosomes", "1"), ("excluded_chromosomes", "1"),
                           ("excluded_chromosomes", "2"))
    ],
    ("one_of_three_individuals", dict(TRIO, samples=["HG003"])),
    *[
        (f"ped_sample_{'_'.join(samples)}", dict(
            phase_input_files=[f"{DATA}/ped_samples.bam"], variant_file=f"{DATA}/ped_samples.vcf",
            ped=PED, samples=samples,
        ))
        for samples in (["HG002"], ["HG003", "HG004"])
    ],
    ("likelihoods_given", dict(
        TRIO, variant_file=f"{DATA}/trio_genotype_likelihoods.vcf", ped=PED, genmap=GENMAP,
    )),
    ("log_likelihoods_given", dict(
        TRIO, variant_file=f"{DATA}/trio_genotype_log_likelihoods.vcf", ped=PED, genmap=GENMAP,
    )),
    ("empty_format", dict(TRIO, variant_file=f"{DATA}/empty_format.vcf")),
    ("paired_end_trio", dict(
        phase_input_files=["@paired_end.sorted"], variant_file=f"{DATA}/paired_end.sorted.vcf",
        ped=f"{DATA}/trio_paired_end.ped", genmap=GENMAP,
    )),
    ("quartet", dict(
        phase_input_files=["@quartet2"], variant_file=f"{DATA}/quartet2.vcf",
        ped=f"{DATA}/quartet2.ped",
    )),
    ("quartet_recombination_breaks", dict(
        phase_input_files=["@recombination_breaks.sorted"], variant_file=f"{DATA}/quartet.vcf.gz",
        ped=f"{DATA}/recombination_breaks.ped",
    )),
    ("multiallelic", dict(PACBIO, variant_file=f"{DATA}/multiallelic.vcf", only_snvs=True)),
    ("one_variant", dict(
        phase_input_files=[f"{DATA}/oneread.bam"], variant_file=f"{DATA}/onevariant.vcf",
    )),
    ("no_read_group", dict(
        phase_input_files=[f"{DATA}/no-readgroup.bam"], variant_file=f"{DATA}/onevariant.vcf",
        ignore_read_groups=True,
    )),
]


@pytest.mark.parametrize("name,kwargs", CASES, ids=[c[0] for c in CASES])
def test_genotype_cases_meet_the_cli_bar(name, kwargs, bams, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("WHATSHAP_TPU_GENO_BACKEND", raising=False)
    kwargs = _inputs(kwargs, bams)
    main, priors = {}, {}
    for side, run, extra in (
        ("ref", ref_run_genotype, {}),
        ("port", run_genotype, {"device": "cpu"}),
    ):
        out = tmp_path / side
        out.mkdir()
        if not kwargs.get("nopriors"):
            extra["prioroutput"] = str(out / "priors.vcf")
        capsys.readouterr()
        if name == "stdout":
            # the writer on a text stream (the CLI's default output)
            run(**kwargs, **extra, output=sys.stdout, write_command_line_header=False)
            main[side] = capsys.readouterr().out
        else:
            run(**kwargs, **extra, output=str(out / "out.vcf"), write_command_line_header=False)
            main[side] = (out / "out.vcf").read_text()
        if "prioroutput" in extra:
            priors[side] = (out / "priors.vcf").read_bytes()
    calls = vcf_calls(main["ref"])
    assert any(call[3] for call in calls), "the reference genotyped nothing"
    diff = cli_bar(calls, vcf_calls(main["port"]))
    assert diff["sites"] == 0 and not diff["GT"] and not diff["GQ"] and not diff["GL"], diff
    assert priors.get("port") == priors.get("ref")


ERRORS = [
    ("sample_not_in_vcf", dict(
        phase_input_files=[f"{DATA}/oneread.bam"], variant_file=f"{DATA}/onevariant.vcf",
        samples=["DOES_NOT_EXIST"],
    )),
    ("ignore_read_groups_without_sample", dict(TRIO, ignore_read_groups=True)),
    ("wrong_chromosome", dict(
        phase_input_files=["@short-genome/short"], ignore_read_groups=True,
        variant_file=f"{DATA}/short-genome/wrongchromosome.vcf",
    )),
]


@pytest.mark.parametrize("kwargs", [c[1] for c in ERRORS], ids=[c[0] for c in ERRORS])
def test_genotype_command_line_errors(kwargs, bams, tmp_path, monkeypatch):
    """Both entry points refuse the same command lines with their
    CommandLineError."""
    monkeypatch.delenv("WHATSHAP_TPU_GENO_BACKEND", raising=False)
    kwargs = _inputs(kwargs, bams)
    with pytest.raises(RefCommandLineError):
        ref_run_genotype(**kwargs, output=str(tmp_path / "ref.vcf"))
    with pytest.raises(CommandLineError):
        run_genotype(**kwargs, output=str(tmp_path / "port.vcf"), device="cpu")


def test_genotype_without_cuda_writes_nothing(tmp_path):
    """run_genotype runs on a CUDA device by default: with none it raises
    before it creates the output or the priors file."""
    import torch

    assert not torch.cuda.is_available()
    out, priors = tmp_path / "out.vcf", tmp_path / "priors.vcf"
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_genotype(**PACBIO, output=str(out), prioroutput=str(priors))
    assert not out.exists() and not priors.exists()


def test_genotype_cli_without_cuda_writes_nothing(tmp_path):
    """`python -m whatshap_torch genotype` with no CUDA device visible exits
    non-zero before it opens its outputs."""
    out, priors = tmp_path / "out.vcf", tmp_path / "priors.vcf"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "whatshap_torch", "genotype", "-o", str(out), "--priors-out",
         str(priors), "-r", PACBIO["reference"], PACBIO["variant_file"], *PACBIO["phase_input_files"]],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA device" in proc.stderr
    assert not out.exists() and not priors.exists()


def test_genotype_family_of_three_children_meets_the_cli_bar(tmp_path, monkeypatch):
    """A family of two parents and three children (T = 64 transmission
    values, past the card's cluster genotyping kernels; one read a sample
    and variant, K = 10), written under tmp_path by chip_smoke.write_synth:
    the port's float64 CPU route meets the reference CLI's bar against the
    reference's default route."""
    from chip_smoke import write_synth

    monkeypatch.delenv("WHATSHAP_TPU_GENO_BACKEND", raising=False)
    data = write_synth(tmp_path / "fam5", 96, 1, seed=5, trio=True, children=3)
    args = dict(phase_input_files=[data["bam"]], variant_file=data["vcf"], reference=data["fasta"],
                ped=data["ped"], write_command_line_header=False)
    ref_run_genotype(**args, output=str(tmp_path / "ref.vcf"))
    run_genotype(**args, output=str(tmp_path / "port.vcf"), device="cpu")
    calls = vcf_calls((tmp_path / "ref.vcf").read_text())
    assert len({call[0][2] for call in calls}) == 5 and sum(bool(call[3]) for call in calls) > 400
    diff = cli_bar(calls, vcf_calls((tmp_path / "port.vcf").read_text()))
    assert diff["sites"] == 0 and not diff["GT"] and not diff["GQ"] and not diff["GL"], diff


def test_genotype_family_of_five_children_meets_the_cli_bar(tmp_path, monkeypatch):
    """A family of two parents and five children (T = 1024, P = 4; one read
    a sample at --max-coverage 7, K = 7), written under tmp_path by
    chip_smoke.write_synth: the port's float64 CPU route meets the reference
    CLI's bar against the reference's default route."""
    from chip_smoke import write_synth

    monkeypatch.delenv("WHATSHAP_TPU_GENO_BACKEND", raising=False)
    data = write_synth(tmp_path / "fam7", 8, 1, seed=5, trio=True, children=5, vars_per_read=8)
    args = dict(phase_input_files=[data["bam"]], variant_file=data["vcf"], reference=data["fasta"],
                ped=data["ped"], max_coverage=7, write_command_line_header=False)
    ref_run_genotype(**args, output=str(tmp_path / "ref.vcf"))
    run_genotype(**args, output=str(tmp_path / "port.vcf"), device="cpu")
    calls = vcf_calls((tmp_path / "ref.vcf").read_text())
    assert len({call[0][2] for call in calls}) == 7 and sum(bool(call[3]) for call in calls) >= 7 * 8
    diff = cli_bar(calls, vcf_calls((tmp_path / "port.vcf").read_text()))
    assert diff["sites"] == 0 and not diff["GT"] and not diff["GQ"] and not diff["GL"], diff


def test_genotype_family_past_the_envelope_refused_before_output(tmp_path, monkeypatch):
    """On a CUDA device `genotype` refuses a family of six children (T =
    4096) before it opens its output or its priors file, naming ROADMAP
    Queue 1 item 5 (the device taken as CUDA: the refusal comes before
    anything runs on it)."""
    import torch

    import whatshap_torch.cli.genotype as cli
    from chip_smoke import write_synth

    data = write_synth(tmp_path / "fam8", 8, 1, seed=5, trio=True, children=6, vars_per_read=8)
    monkeypatch.setattr(cli, "resolve_device", lambda device: torch.device("cuda"))
    out, priors = tmp_path / "out.vcf", tmp_path / "priors.vcf"
    for use_ped_samples in (False, True):
        with pytest.raises(NotImplementedError, match="T = 4096.*ROADMAP Queue 1 item 5"):
            run_genotype(phase_input_files=[data["bam"]], variant_file=data["vcf"], reference=data["fasta"],
                         ped=data["ped"], output=str(out), prioroutput=str(priors), use_ped_samples=use_ped_samples)
        assert not out.exists() and not priors.exists()
