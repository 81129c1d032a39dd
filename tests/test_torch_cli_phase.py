"""
The port's `phase` entry point against the reference's, end to end on the
CPU: whatshap_tpu.cli.phase.run_whatshap and
whatshap_torch.cli.phase.run_whatshap(device="cpu") on the same BAM/CRAM,
VCF, PED and map files must write byte-identical VCFs (and read lists,
recombination lists and changed-genotype lists where a case asks for one).

The cases are the exact-solver cases of tests/test_run_phase.py, with the
reference on its default routing, plus two generated chromosomes
(tools/make_synth_chrom.py, as tests/test_cli_mesh.py builds them), with the
reference on its default route too: on both its batched route (the route
the port mirrors) writes the same bytes, but takes minutes on a CPU shared
with other test workers.  The host solvers' cases (`--algorithm hapchat`
and `heuristic`) are the reference's `algorithm` fixture cases and its
golden phased_hapchat.vcf.  BAMs are regenerated from the committed SAMs
into a temporary directory; nothing under tests/data is written.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent.parent / "tools"))

from whatshap_tpu.cli.phase import run_whatshap as ref_run_whatshap  # noqa: E402

from whatshap_torch.cli import CommandLineError  # noqa: E402
from whatshap_torch.cli.phase import run_whatshap  # noqa: E402
from whatshap_torch.io.sam import build_minimal_index, sam_to_bam  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The torch mirror's column loops are many small ops, which run faster
    on one thread than on threads that the test workers of a run share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = Path(__file__).parent.parent
DATA = "tests/data"
# BAMs that tests/test_run_phase.py regenerates from SAMs under tests/data:
# here they are made under a temporary directory instead
SAM_BAMS = ("trio.pacbio", "trio-merged-blocks", "recombination_breaks.sorted")
# report files a case may ask for, compared like the VCF
REPORTS = ("read_list_filename", "recombination_list_filename", "gtchange_list_filename")


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    out = tmp_path_factory.mktemp("bams")
    paths = {}
    for name in SAM_BAMS:
        bam = str(out / f"{name}.bam")
        sam_to_bam(f"{DATA}/{name}.sam", bam)
        build_minimal_index(bam)
        paths[name] = bam
    return paths


def _phase_both(tmp_path, **kwargs):
    """Run the reference and the port on the same arguments; return the
    bytes of (reference, port) for the VCF and each report asked for."""
    written = []
    for side, run, extra in (
        ("ref", ref_run_whatshap, {}),
        ("port", run_whatshap, {"device": "cpu"}),
    ):
        out = tmp_path / side
        out.mkdir()
        kw = dict(kwargs, output=str(out / "out.vcf"), write_command_line_header=False)
        for key in REPORTS:
            if kwargs.get(key):
                kw[key] = str(out / key)
        run(**kw, **extra)
        names = ["out.vcf"] + [key for key in REPORTS if kwargs.get(key)]
        written.append({name: (out / name).read_bytes() for name in names})
    return written


TRIO = f"{DATA}/trio.vcf"
PED = f"{DATA}/trio.ped"
GENMAP = f"{DATA}/trio.map"
PACBIO = dict(
    phase_input_files=[f"{DATA}/pacbio/pacbio.bam"],
    variant_file=f"{DATA}/pacbio/variants.vcf",
    reference=f"{DATA}/pacbio/reference.fasta",
)

# (id, arguments); "@name" in phase_input_files stands for a BAM made from
# tests/data/<name>.sam
CASES = [
    ("with_reference", dict(PACBIO)),
    ("with_reference_and_indels", dict(PACBIO, only_snvs=False)),
    ("with_read_merging", dict(PACBIO, read_merging=True)),
    ("cram", dict(
        phase_input_files=[f"{DATA}/oneread.cram"],
        reference=f"{DATA}/oneread-ref.fasta",
        variant_file=f"{DATA}/onevariant.vcf",
    )),
    ("ps_tag", dict(phase_input_files=["@trio.pacbio"], variant_file=TRIO, tag="PS")),
    ("three_individuals", dict(
        phase_input_files=["@trio.pacbio"], variant_file=TRIO, read_list_filename=True,
    )),
    ("trio", dict(
        phase_input_files=["@trio.pacbio"], variant_file=TRIO, ped=PED, genmap=GENMAP,
        read_list_filename=True,
    )),
    *[
        (f"trio_use_ped_samples_{flag}", dict(
            phase_input_files=[f"{DATA}/ped_samples.bam"],
            variant_file=f"{DATA}/ped_samples.vcf", ped=PED, genmap=GENMAP,
            use_ped_samples=flag, read_list_filename=True,
        ))
        for flag in (True, False)
    ],
    *[
        (f"ped_sample_{'_'.join(samples)}", dict(
            phase_input_files=[f"{DATA}/ped_samples.bam"],
            variant_file=f"{DATA}/ped_samples.vcf", ped=PED, samples=samples,
        ))
        for samples in (["HG002"], ["HG003"], ["HG004"], ["HG002", "HG003"],
                        ["HG002", "HG004"], ["HG003", "HG004"])
    ],
    ("trio_distrust_genotypes", dict(
        phase_input_files=["@trio.pacbio"],
        variant_file=f"{DATA}/trio_genotype_likelihoods.vcf", ped=PED, genmap=GENMAP,
        distrust_genotypes=True, read_list_filename=True, gtchange_list_filename=True,
    )),
    ("trio_merged_blocks", dict(
        phase_input_files=["@trio-merged-blocks"],
        variant_file=f"{DATA}/trio-merged-blocks.vcf", ped=PED, genmap=GENMAP,
    )),
    ("trio_dont_merge_blocks", dict(
        phase_input_files=["@trio-merged-blocks"],
        variant_file=f"{DATA}/trio-merged-blocks.vcf", ped=PED, genmap=GENMAP,
        genetic_haplotyping=False,
    )),
    *[
        (f"{key}_chromosome_{chrom}", dict(
            phase_input_files=["@trio.pacbio"],
            variant_file=f"{DATA}/trio-two-chromosomes.vcf", ped=PED, genmap=GENMAP,
            **{key: [chrom]},
        ))
        for key in ("chromosomes", "excluded_chromosomes")
        for chrom in ("1", "2")
    ],
    *[
        (f"quartet_recombination_{name}", dict(
            phase_input_files=["@recombination_breaks.sorted"],
            variant_file=f"{DATA}/quartet.vcf.gz", ped=f"{DATA}/recombination_breaks.ped",
            recombination_list_filename=True, **params,
        ))
        for name, params in (
            ("genmap", {"genmap": f"{DATA}/recombination_breaks.map"}),
            ("high_rate", {"recombrate": 1000000}),
            ("low_rate", {"recombrate": 0.0000001}),
        )
    ],
    ("genetic_haplotyping", dict(
        variant_file=f"{DATA}/genetic-haplotyping.vcf", phase_input_files=[],
        ped=f"{DATA}/genetic-haplotyping.ped", recombination_list_filename=True,
    )),
]


@pytest.mark.parametrize("kwargs", [c[1] for c in CASES], ids=[c[0] for c in CASES])
def test_phase_cases_byte_identical(kwargs, bams, tmp_path, monkeypatch):
    monkeypatch.delenv("WHATSHAP_TPU_BACKEND", raising=False)
    inputs = [bams[p[1:]] if p.startswith("@") else p for p in kwargs["phase_input_files"]]
    ref, port = _phase_both(tmp_path, **dict(kwargs, phase_input_files=inputs))
    assert ref.keys() == port.keys()
    for name in ref:
        assert port[name] == ref[name], f"{name} differs from the reference's"
    assert b"\n" in ref["out.vcf"]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The generated chromosome and trio, and the reference's VCF of each,
    both on the reference's default route (its batched route writes the same
    bytes for both, and was the slow part of this file), one run per
    module."""
    import make_synth_chrom

    out = tmp_path_factory.mktemp("synth")
    chrom = make_synth_chrom.generate(
        out / "chrom", n_vars=400, coverage=6, vars_per_read=8, spacing=60, break_every=40, seed=5
    )
    trio = make_synth_chrom.generate_trio(
        out / "trio", n_vars=240, coverage=4, vars_per_read=8, spacing=60, break_every=30, seed=9
    )
    cases = {
        "synth_chrom": dict(
            phase_input_files=[chrom["bam"]], variant_file=chrom["vcf"], reference=False
        ),
        "synth_trio": dict(
            phase_input_files=[trio["bam"]], variant_file=trio["vcf"],
            reference=trio["fasta"], ped=trio["ped"],
        ),
    }
    expected = {}
    for name in ("synth_chrom", "synth_trio"):
        path = out / f"{name}.ref.vcf"
        with pytest.MonkeyPatch.context() as mp:
            mp.delenv("WHATSHAP_TPU_BACKEND", raising=False)
            ref_run_whatshap(**cases[name], output=str(path), write_command_line_header=False)
        expected[name] = path.read_bytes()
    return cases, expected


@pytest.mark.parametrize("name", ["synth_chrom", "synth_trio"])
def test_phase_synth_byte_identical(name, synth, tmp_path):
    cases, expected = synth
    out = tmp_path / "port.vcf"
    run_whatshap(**cases[name], output=str(out), write_command_line_header=False, device="cpu")
    assert out.read_bytes() == expected[name]
    assert out.read_bytes().count(b"|") > 100  # most of the chromosome is phased


# (id, arguments) of the host solvers' cases: tests/test_run_phase.py's
# `algorithm` fixture cases on the pacbio, CRAM and one-read fixtures, a
# sample without read groups, three samples and the pedigree cases
HOST_CASES = [
    ("with_reference", dict(PACBIO)),
    ("with_reference_and_indels", dict(PACBIO, only_snvs=False)),
    ("with_read_merging", dict(PACBIO, read_merging=True)),
    ("one_variant", dict(phase_input_files=[f"{DATA}/oneread.bam"], variant_file=f"{DATA}/onevariant.vcf")),
    ("one_variant_cram", dict(
        phase_input_files=[f"{DATA}/oneread.cram"], reference=f"{DATA}/oneread-ref.fasta",
        variant_file=f"{DATA}/onevariant.vcf",
    )),
    ("bam_without_readgroup", dict(
        phase_input_files=[f"{DATA}/no-readgroup.bam"], variant_file=f"{DATA}/onevariant.vcf",
        ignore_read_groups=True,
    )),
    ("three_individuals", dict(
        phase_input_files=["@trio.pacbio"], variant_file=TRIO, read_list_filename=True,
    )),
]


@pytest.mark.parametrize("algorithm", ["hapchat", "heuristic"])
@pytest.mark.parametrize("kwargs", [c[1] for c in HOST_CASES], ids=[c[0] for c in HOST_CASES])
def test_host_algorithms_byte_identical(algorithm, kwargs, bams, tmp_path):
    """`--algorithm hapchat` and `heuristic` (the host solvers,
    csrc/host/hapchatlib.cpp and heurlib.cpp) write the reference's bytes."""
    inputs = [bams[p[1:]] if p.startswith("@") else p for p in kwargs["phase_input_files"]]
    ref, port = _phase_both(tmp_path, **dict(kwargs, phase_input_files=inputs, algorithm=algorithm))
    assert ref.keys() == port.keys()
    for name in ref:
        assert port[name] == ref[name], f"{name} differs from the reference's"
    if kwargs is HOST_CASES[0][1] and algorithm == "hapchat":
        assert ref["out.vcf"] == (REPO / DATA / "pacbio" / "phased_hapchat.vcf").read_bytes()


def test_heuristic_with_ped_byte_identical(tmp_path):
    """heuristic with --ped on ped_samples.vcf: pedigree.ped names none of
    its samples (its relationships are set aside, as in the reference), so
    each sample is phased on its own, and the VCF is the reference's."""
    ref, port = _phase_both(
        tmp_path, phase_input_files=[f"{DATA}/ped_samples.bam"], variant_file=f"{DATA}/ped_samples.vcf",
        ped=f"{DATA}/pedigree.ped", algorithm="heuristic", read_list_filename=True,
    )
    assert port == ref
    assert ref["out.vcf"].count(b"|") > 0


def test_heuristic_on_a_trio_fails_as_the_reference(tmp_path):
    """heuristic on a real trio (ped_samples with trio.ped) stops with the
    reference's own AssertionError: PedMecHeuristic returns the superreads
    in its samples' numeric order, which the pipeline pairs with the family
    order (whatshap_tpu/cli/phase.py process_chromosome).  The port is a
    copy and stops the same way."""
    args = dict(phase_input_files=[f"{DATA}/ped_samples.bam"], variant_file=f"{DATA}/ped_samples.vcf",
                ped=PED, algorithm="heuristic", write_command_line_header=False)
    errors = []
    for run, extra in ((ref_run_whatshap, {}), (run_whatshap, {"device": "cpu"})):
        with pytest.raises(AssertionError) as e:
            run(**args, **extra, output=str(tmp_path / "out.vcf"))
        errors.append(str(e.value))
    assert errors[1] == errors[0]


def test_hapchat_refuses_ped(tmp_path):
    """hapchat has no pedigree support: both refuse --ped with the same
    message before they open the output."""
    messages = []
    for side, run, extra in (("ref", ref_run_whatshap, {}), ("port", run_whatshap, {"device": "cpu"})):
        out = tmp_path / f"{side}.vcf"
        with pytest.raises(Exception) as e:
            run(phase_input_files=[f"{DATA}/ped_samples.bam"], variant_file=f"{DATA}/ped_samples.vcf",
                ped=PED, output=str(out), algorithm="hapchat", **extra)
        messages.append((type(e.value).__name__, str(e.value)))
        assert not out.exists()
    assert messages[1] == messages[0] == ("CommandLineError", "The hapchat algorithm cannot do pedigree phasing")


def test_cli_without_cuda_writes_nothing(tmp_path):
    """`python -m whatshap_torch phase` runs on a CUDA device or raises: with
    none visible it exits non-zero before it opens its output."""
    out = tmp_path / "out.vcf"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "whatshap_torch", "phase", "--no-reference", "-o", str(out),
         f"{DATA}/phased-blocks.variants.vcf", f"{DATA}/phased-blocks.reads.bam"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA device" in proc.stderr
    assert not out.exists()


@pytest.mark.parametrize("seed", range(4))
def test_bam_record_encoding_matches_reference(seed):
    """The port's BAM record encoder (sequence packed through a translation
    table) writes the reference encoder's bytes: odd and even lengths,
    lowercase and ambiguous bases, characters outside the BAM alphabet."""
    import random

    from whatshap_tpu.io import sam as ref_sam

    from whatshap_torch.io import sam

    rng = random.Random(seed)
    for _ in range(50):
        length = rng.randint(0, 41)
        seq = "".join(rng.choice("ACGTNacgtn=MRX*é") for _ in range(length))
        records = []
        for mod in (ref_sam, sam):
            header = mod.AlignmentHeader.from_dict({"HD": {"VN": "1.6"}, "SQ": [{"SN": "c", "LN": 1000}]})
            seg = mod.AlignedSegment(header)
            seg.query_name = f"r{seed}"
            seg.reference_id = 0
            seg.reference_start = 5
            seg.cigartuples = [(0, max(length, 1))]
            seg.query_sequence = seq or None
            seg.query_qualities = [30] * length or None
            seg.tags = {"RG": "x"}
            records.append(mod.encode_bam_record(seg))
        assert records[1] == records[0], seq


def _synth_family(tmp_path, children, seed=3):
    """A family of two parents and `children` children (T = 4^children),
    written under tmp_path by chip_smoke.write_synth: 8 variants, every read
    over all of them (one read-connected range), one read a sample and
    window."""
    from chip_smoke import write_synth

    return write_synth(tmp_path / f"fam{children + 2}", 8, 1, seed=seed, trio=True, children=children,
                       vars_per_read=8)


def test_phase_family_of_five_children_byte_identical(tmp_path, monkeypatch):
    """A family of two parents and five children (T = 1024, P = 4; one read
    a sample at --max-coverage 7, K = 7): the port's VCF on the CPU is the
    reference's on its default route, byte for byte."""
    monkeypatch.delenv("WHATSHAP_TPU_BACKEND", raising=False)
    data = _synth_family(tmp_path, 5)
    args = dict(phase_input_files=[data["bam"]], variant_file=data["vcf"], reference=data["fasta"],
                ped=data["ped"], max_coverage=7, write_command_line_header=False)
    ref_run_whatshap(**args, output=str(tmp_path / "ref.vcf"))
    run_whatshap(**args, output=str(tmp_path / "port.vcf"), device="cpu")
    ref = (tmp_path / "ref.vcf").read_bytes()
    assert (tmp_path / "port.vcf").read_bytes() == ref
    assert ref.count(b"|") >= 7 * 4  # the family is phased


def test_families_past_the_envelope_refused_before_output(tmp_path, monkeypatch):
    """On a CUDA device `phase` refuses a family past the kernels' pedigree
    envelope before it opens its output, naming ROADMAP Queue 1 item 5: six
    children (T = 4096) through the CLI (the device taken as CUDA: the
    refusal comes before anything runs on it), six founders (P = 12) through
    the check itself.  Five children and five founders pass it, and on the
    CPU nothing is refused."""
    import whatshap_torch.cli.phase as cli

    data = _synth_family(tmp_path, 6)
    monkeypatch.setattr(cli, "resolve_device", lambda device: torch.device("cuda"))
    out = tmp_path / "out.vcf"
    with pytest.raises(NotImplementedError, match="T = 4096.*ROADMAP Queue 1 item 5"):
        run_whatshap(phase_input_files=[data["bam"]], variant_file=data["vcf"], reference=data["fasta"],
                     ped=data["ped"], output=str(out))
    assert not out.exists()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    kids = [f"child{i + 1}" for i in range(6)]
    cli.refuse_families_past_envelope(["father", "mother", *kids], data["ped"], cpu)
    cli.refuse_families_past_envelope(["father", "mother", *kids[:5]], data["ped"], cuda)  # T = 1024
    # six founders a-f and five trios (T = 1024, P = 12); without f's trio,
    # five founders (T = 256, P = 10)
    ped = tmp_path / "six-founders.ped"
    ped.write_text("".join(f"F {c} {p} {m} 0 0\n" for c, p, m in (
        ("x", "a", "b"), ("y", "c", "d"), ("z", "x", "y"), ("w", "e", "z"), ("v", "f", "w"))))
    with pytest.raises(NotImplementedError, match="P = 12.*ROADMAP Queue 1 item 5"):
        cli.refuse_families_past_envelope(list("abcdefxyzwv"), str(ped), cuda)
    cli.refuse_families_past_envelope(list("abcdexyzw"), str(ped), cuda)
    cli.refuse_families_past_envelope(list("abcdefxyzwv"), str(ped), cpu)
