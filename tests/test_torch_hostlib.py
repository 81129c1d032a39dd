"""
The port's host helpers (whatshap_torch/csrc/host/*.cpp, built with g++ by
ops/_build.build_host and loaded by whatshap_torch.hostlib) against the
Python paths they replace, on the CPU:

- each helper three ways: the port's C++ route, the port's Python path (the
  hostlib attributes set to None: the code the port ran before it had the
  helpers) and the reference's Python path (whatshap_tpu with its native
  handles set to None, so that the oracle does not depend on the
  reference's own build);
- the BAM pool decode of every BAM under tests/data against the Python
  record loop, the realignment pool at one thread and at more;
- the build: nothing at import, one whole library per source after six
  processes build at once, and a failing compiler raises with its output.

Generated files go under pytest's temporary directories only.
"""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent.parent / "tools"))

import whatshap_tpu.align as ref_align  # noqa: E402
import whatshap_tpu.native as ref_native  # noqa: E402
import whatshap_tpu.priorityqueue as ref_pq  # noqa: E402
import whatshap_tpu.readselect as ref_readselect  # noqa: E402
from whatshap_tpu import _variants as ref_variants_py  # noqa: E402
from whatshap_tpu.cli import PhasedInputReader as RefPhasedInputReader  # noqa: E402
from whatshap_tpu.cli.phase import run_whatshap as ref_run_whatshap  # noqa: E402
from whatshap_tpu.core import NumericSampleIds as RefNumericSampleIds  # noqa: E402
from whatshap_tpu.core import Read as RefRead  # noqa: E402
from whatshap_tpu.core import ReadSet as RefReadSet  # noqa: E402
from whatshap_tpu.io.sam import AlignmentFile as RefAlignmentFile  # noqa: E402
from whatshap_tpu.vcf import BiallelicVcfVariant as RefBiallelic  # noqa: E402
from whatshap_tpu.vcf import VcfReader as RefVcfReader  # noqa: E402

from whatshap_torch import _variants as variants_py  # noqa: E402
from whatshap_torch import align, hostlib, priorityqueue, readselect, variants  # noqa: E402
from whatshap_torch.cli import PhasedInputReader  # noqa: E402
from whatshap_torch.cli.phase import run_whatshap  # noqa: E402
from whatshap_torch.core import NumericSampleIds, Read, ReadSet  # noqa: E402
from whatshap_torch.io.sam import AlignmentFile  # noqa: E402
from whatshap_torch.ops import _build  # noqa: E402
from whatshap_torch.vcf import BiallelicVcfVariant, VcfReader  # noqa: E402

REPO = Path(__file__).parent.parent
DATA = REPO / "tests" / "data"
# every BAM committed under tests/data (a fixed list: a glob could differ
# between test workers where another test writes a BAM there)
BAMS = (
    "alleledetection.biallelic.01.bam", "alleledetection.biallelic.02.bam",
    "alleledetection.biallelic.03.bam", "alleledetection.biallelic.04.bam",
    "alleledetection.biallelic.05.bam", "alleledetection.multiallelic.01.bam",
    "haplotag.10X.bam", "haplotag.10X_3.bam", "haplotag.bam", "haplotag.large.bam",
    "haplotag.supplementary.bam", "haplotag_noRG.bam", "haplotag_noSM.bam",
    "haplotag_poly.bam", "haplotag_sample.bam", "haplotag_triploid.bam",
    "issue-586/MUT011_S351.bam", "no-readgroup.bam", "not-indexed.bam",
    "oneread-readgroup-without-sample.bam", "oneread.bam", "pacbio/haplotagged.bam",
    "pacbio/pacbio.bam", "ped_samples.bam", "phased-blocks.reads.bam",
    "polyploid.chr22.42M.12k.bam", "polyploid.cuts.bam",
    "polyploid.human1.chr22.42M.5k.bam", "polyploid.human2.chr22.42M.5k.bam",
    "polyploid.indels.bam", "reads-no-sequence.bam",
    "short-genome/learn-data/short-reads.bam", "supplementary_strategy_test.grch38.bam",
    "unmapped.bam",
)
BASES = np.array(list("ACGT"))


def _python_routes(monkeypatch, fn):
    """fn("port") with every hostlib attribute None (the port's Python
    paths) and fn("ref") with the reference's native handles None (and the
    two it binds at import, the edit distances' and the heap's)."""
    with monkeypatch.context() as m:
        for name in hostlib.__all__:
            m.setattr(hostlib, name, None, raising=False)
        port = fn("port")
    with monkeypatch.context() as m:
        for name in ("lib", "bamlib", "cigarlib", "readselectlib", "pqext"):
            m.setattr(ref_native, name, None)
        m.setattr(ref_align, "_native", None)
        m.setattr(ref_readselect, "PriorityQueue", ref_pq._PriorityQueuePython)
        ref = fn("ref")
    return port, ref


# ---------------------------------------------------------------------------
# the CIGAR engine on seeded random reads


class FakeRead:
    def __init__(self, reference_start, cigartuples, query_sequence, query_qualities):
        self.reference_start = reference_start
        self.cigartuples = cigartuples
        self.query_sequence = query_sequence
        self.query_qualities = query_qualities


def _random_read(rng, ref_start):
    """A read of 1-6 random CIGAR operations (M, I, D, N, =, X), sometimes
    soft-clipped, with base qualities four times in five."""
    cigar, query_len = [], 0
    if rng.random() < 0.5:
        clip = int(rng.integers(1, 6))
        cigar.append((4, clip))
        query_len += clip
    for _ in range(int(rng.integers(1, 7))):
        op = int(rng.choice([0, 1, 2, 3, 7, 8], p=np.array([10, 2, 2, 1, 2, 2]) / 19))
        length = int(rng.integers(1, 13))
        cigar.append((op, length))
        if op in (0, 1, 7, 8):
            query_len += length
    seq = "".join(rng.choice(BASES, query_len + 5))
    quals = rng.integers(3, 61, len(seq)).tolist() if rng.random() < 0.8 else None
    return FakeRead(ref_start, cigar, seq, quals)


def _random_variants(rng, lo, hi, cls):
    """Variants every 1-6 bases in [lo, hi): REF of 1-3 bases, ALT of 0-2."""
    out, pos = [], lo
    while pos < hi:
        ref = "".join(rng.choice(BASES, int(rng.choice([1, 2, 3], p=[0.8, 0.1, 0.1]))))
        alt = "".join(rng.choice(BASES, int(rng.choice([0, 1, 2], p=[0.1, 0.8, 0.1]))))
        if alt != ref:
            out.append(cls(pos, ref, alt))
        pos += int(rng.integers(1, 7))
    return out


def _case(seed):
    rng = np.random.default_rng(seed)
    ref_start = int(rng.integers(0, 31))
    read = _random_read(rng, ref_start)
    state = rng.bit_generator.state
    port_vars = _random_variants(rng, 0, ref_start + 80, BiallelicVcfVariant)
    rng.bit_generator.state = state
    ref_vars = _random_variants(rng, 0, ref_start + 80, RefBiallelic)
    assert port_vars
    return read, port_vars, ref_vars


@pytest.mark.parametrize("seed", range(12))
def test_iterate_cigar_matches_python(seed):
    """The realignment-mode CIGAR walk: the same split points as the port's
    and the reference's Python walks."""
    read, port_vars, ref_vars = _case(7100 + seed)
    cig = hostlib.cigarlib
    native = cig.iterate_cigar(
        cig._i64([v.position for v in port_vars]), 0, read.reference_start,
        cig._i32([op for op, _ in read.cigartuples]), cig._i32([n for _, n in read.cigartuples]),
    )
    python = list(variants_py._iterate_cigar(port_vars, 0, read, read.cigartuples))
    ref = list(ref_variants_py._iterate_cigar(ref_vars, 0, read, read.cigartuples))
    assert native == python == ref


def _progress(reader_cls, normalized):
    reader = reader_cls.__new__(reader_cls)  # only its static helpers are used
    usable = reader.detect_non_overlapping_variants(normalized)
    return sorted((reader.build_var_progress(normalized, j) for j in usable), key=lambda p: p.variant_id)


@pytest.mark.parametrize("seed", range(12))
def test_detect_alleles_matches_python(seed):
    """Reference-free allele detection: the same (variant, allele, quality)
    calls as the port's and the reference's Python detectors."""
    from whatshap_tpu.variants import ReadSetReader as RefReadSetReader

    read, port_vars, ref_vars = _case(7500 + seed)
    normalized = [v.normalized() for v in port_vars]
    ref_normalized = [v.normalized() for v in ref_vars]
    python = list(variants_py._detect_alleles(normalized, _progress(variants.ReadSetReader, normalized), 0, read))
    ref = list(ref_variants_py._detect_alleles(
        ref_normalized, _progress(RefReadSetReader, ref_normalized), 0, read))
    # the Python walk moves its trackers on: the C++ one gets fresh ones
    progress = _progress(variants.ReadSetReader, normalized)
    assert progress, "no usable variant"
    state = variants._pack_detect_state(hostlib.cigarlib, normalized, progress)
    native = variants._detect_alleles_native(hostlib.cigarlib, state, 0, read)
    assert [tuple(x) for x in native] == [tuple(x) for x in python] == [tuple(x) for x in ref]


@pytest.mark.parametrize("seed", range(4))
def test_edit_distances_match_python(seed):
    """edit_distance (unbanded and banded) and edit_distance_affine_gap
    through alignlib equal the port's and the reference's Python versions
    on 60 random pairs of related strings."""
    rng = np.random.default_rng(900 + seed)
    for _ in range(60):
        s = "".join(rng.choice(BASES, int(rng.integers(0, 40))))
        t = list(s)
        for _e in range(int(rng.integers(0, 6))):
            i = int(rng.integers(0, len(t) + 1))
            kind = rng.integers(0, 3)
            if kind == 0 or not t:
                t.insert(i, str(rng.choice(BASES)))
            elif kind == 1:
                del t[min(i, len(t) - 1)]
            else:
                t[min(i, len(t) - 1)] = str(rng.choice(BASES))
        t = "".join(t)
        for maxdiff in (-1, 0, 2, 5):
            got = align.edit_distance(s, t, maxdiff)
            assert got == align._edit_distance_py(s.encode(), t.encode(), maxdiff)
            assert got == ref_align._edit_distance_py(s.encode(), t.encode(), maxdiff)
        costs = rng.integers(1, 30, len(s)).tolist()
        gs, ge = int(rng.integers(1, 12)), int(rng.integers(1, 8))
        got = align.edit_distance_affine_gap(s, t, costs, gs, ge)
        assert got == align._edit_distance_affine_gap_py(s.encode(), t.encode(), costs, gs, ge)
        assert got == ref_align._edit_distance_affine_gap_py(s.encode(), t.encode(), costs, gs, ge)


# ---------------------------------------------------------------------------
# the BAM pool


SEGMENT_FIELDS = ("query_name", "flag", "reference_id", "reference_start", "mapping_quality", "cigartuples",
                  "next_reference_id", "next_reference_start", "template_length", "query_sequence",
                  "query_qualities")


def _segment_row(seg):
    """Every field of a decoded record (its tags as repr'd items)."""
    return tuple(repr(getattr(seg, k)) for k in SEGMENT_FIELDS) + (repr(sorted(seg.tags.items())),)


@pytest.mark.parametrize("name", BAMS)
def test_pool_decode_matches_record_loop(name, monkeypatch):
    """Every record of the BAM decoded from bamlib's pool equals the Python
    record loop's (the port's and the reference's)."""
    path = str(DATA / name)
    f = AlignmentFile(path)
    assert f._native_pool() is not None, "the pool decoded the file"
    native = [_segment_row(s) for s in f]
    port, ref = _python_routes(monkeypatch, lambda side: [
        _segment_row(s) for s in (AlignmentFile if side == "port" else RefAlignmentFile)(path)])
    assert native == port == ref


def test_pool_cache_is_cleared(tmp_path):
    """clear_bam_pool_cache() drops the decoded pools: the next open decodes
    the file again (chip_smoke.py charges each timed run its full decode)."""
    from whatshap_torch.io import sam

    sam.clear_bam_pool_cache()
    first = AlignmentFile(str(DATA / "pacbio/pacbio.bam"))._native_pool()
    assert len(sam._BAM_POOL_CACHE) == 1
    again = AlignmentFile(str(DATA / "pacbio/pacbio.bam"))._native_pool()
    assert again is first
    sam.clear_bam_pool_cache()
    assert not sam._BAM_POOL_CACHE
    fresh = AlignmentFile(str(DATA / "pacbio/pacbio.bam"))._native_pool()
    assert fresh is not first and fresh == first


# ---------------------------------------------------------------------------
# realignment through the read path


def _rows(readset):
    return [(r.name, r.source_id, r.sample_id, r.reference_start, r.reference_end, r.BX_tag, r.HP_tag,
             r.PS_tag, bool(r.is_reverse), bool(r.is_supplementary), tuple(r._mapqs), tuple(r._positions),
             tuple(r._alleles), tuple(r._qualities)) for r in readset]


def _read_all(side, bam, vcf, fasta, regions=None, **kwargs):
    """{sample: rows of the ReadSet} for every sample of the VCF's first
    chromosome, through PhasedInputReader as the phase CLI reads."""
    port = side == "port"
    reader_cls = PhasedInputReader if port else RefPhasedInputReader
    vcf_reader = (VcfReader if port else RefVcfReader)(str(vcf), phases=False, only_snvs=False)
    table = next(iter(vcf_reader))
    ids = (NumericSampleIds if port else RefNumericSampleIds)()
    out = {}
    with reader_cls([str(bam)], str(fasta), ids, ignore_read_groups=False, only_snvs=False,
                    mapq_threshold=20, **kwargs) as reader:
        for sample in vcf_reader.samples:
            readset, _ = reader.read(table.chromosome, table.variants, sample, read_vcf=False,
                                     regions=regions)
            out[sample] = _rows(readset)
    return out


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A synthetic chromosome (300 SNVs at coverage 8); one of 120 SNVs with
    an insertion at every seventh site and one symbolic ALT (the records
    over it take the per-record Python path, status -2); a trio (three
    read groups)."""
    from make_synth_chrom import generate, generate_trio

    root = tmp_path_factory.mktemp("synth")
    chrom = generate(root / "chrom", n_vars=300, coverage=8, seed=11)
    indel = generate(root / "indel", n_vars=120, coverage=8, seed=13)
    vcf = Path(indel["vcf"])
    lines = []
    for k, line in enumerate(x for x in vcf.read_text().splitlines() if not x.startswith("#")):
        f = line.split("\t")
        if k % 7 == 3:
            f[4] = f[3] + "ACG"
        if k == 60:
            f[4] = "<DEL>"
        lines.append("\t".join(f))
    header = [x for x in vcf.read_text().splitlines() if x.startswith("#")]
    vcf.write_text("\n".join(header + lines) + "\n")
    trio = generate_trio(root / "trio", n_vars=150, coverage=4, seed=17)
    return {
        "pacbio": (DATA / "pacbio/pacbio.bam", DATA / "pacbio/variants.vcf", DATA / "pacbio/reference.fasta"),
        "synthetic": (chrom["bam"], chrom["vcf"], chrom["fasta"]),
        "indels": (indel["bam"], indel["vcf"], indel["fasta"]),
        "trio": (trio["bam"], trio["vcf"], trio["fasta"]),
    }


@pytest.mark.parametrize("affine", [False, True], ids=["unit", "affine"])
@pytest.mark.parametrize("case", ["pacbio", "synthetic", "indels", "trio", "indels-regions"])
def test_realignment_matches_python(case, affine, synth, monkeypatch):
    """ReadSetReader.read through the BAM pool and the realignment pool
    (records it cannot reproduce, status -2, one by one through
    realign_read) equals the port's and the reference's Python read paths,
    read for read; with regions the pool is not used and every record goes
    through realign_read and the CIGAR walk of cigarlib."""
    bam, vcf, fasta = synth[case.split("-")[0]]
    regions = [(0, None)] if case.endswith("regions") else None
    calls, statuses = [], []
    real = variants.ReadSetReader._read_pool_fast
    real_pool = type(hostlib.cigarlib).realign_pool

    def spy(self, *args):
        got = real(self, *args)
        calls.append(got is not None)
        return got

    def pool(self, *args, **kwargs):
        out = real_pool(self, *args, **kwargs)
        statuses.extend(out["status"].tolist())
        return out

    monkeypatch.setattr(variants.ReadSetReader, "_read_pool_fast", spy)
    monkeypatch.setattr(type(hostlib.cigarlib), "realign_pool", pool)
    native = _read_all("port", bam, vcf, fasta, regions=regions, affine=affine)
    assert calls and all(calls) == (regions is None), "the realignment pool read every sample"
    assert (-2 in statuses) == (case == "indels")
    port, ref = _python_routes(
        monkeypatch, lambda side: _read_all(side, bam, vcf, fasta, regions=regions, affine=affine))
    assert sum(len(rows) for rows in native.values()) > 0
    assert native == port == ref


def test_realign_pool_threads_do_not_change_the_result(synth, monkeypatch):
    """The realignment pool at one thread, at its default (4) and at 16
    gives the same arrays."""
    cig = hostlib.cigarlib
    seen = []
    real = type(cig).realign_pool

    def keep(self, *args, **kwargs):
        seen.append((args, kwargs))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(type(cig), "realign_pool", keep)
    bam, vcf, fasta = synth["synthetic"]
    _read_all("port", bam, vcf, fasta)
    assert len(seen) == 1
    args, kwargs = seen[0]
    outs = [real(cig, *args, **kwargs, n_threads=n) for n in (1, 16)] + [real(cig, *args, **kwargs)]
    assert (outs[0]["status"] > 0).sum() > 50
    for other in outs[1:]:
        assert outs[0].keys() == other.keys()
        for key in outs[0]:
            assert np.array_equal(outs[0][key], other[key]), key


def test_phase_cli_matches_python_paths(tmp_path, monkeypatch):
    """The phase CLI on pacbio through the helpers writes the bytes of the
    port's and the reference's Python paths."""
    args = dict(phase_input_files=[str(DATA / "pacbio/pacbio.bam")], variant_file=str(DATA / "pacbio/variants.vcf"),
                reference=str(DATA / "pacbio/reference.fasta"), write_command_line_header=False)

    def phase(side):
        out = tmp_path / f"{side}.vcf"
        if side == "ref":
            ref_run_whatshap(**args, output=str(out))
        else:
            run_whatshap(**args, output=str(out), device="cpu")
        return out.read_bytes()

    native = phase("native")
    port, ref = _python_routes(monkeypatch, phase)
    assert native == port == ref


# ---------------------------------------------------------------------------
# read selection


def _random_readsets(seed, n_reads=120, n_pos=80, preferred=False):
    """The same random reads (2-12 variants each, gaps between blocks so
    that bridging has work) as a port ReadSet and a reference ReadSet."""
    rng = np.random.default_rng(seed)
    sets = (ReadSet(), RefReadSet())
    for i in range(n_reads):
        start = int(rng.integers(0, n_pos - 2))
        length = int(rng.integers(2, 13))
        cols = sorted(set(rng.integers(start, min(start + 2 * length, n_pos), length).tolist()) | {start})
        if len(cols) < 2:
            cols.append(cols[0] + 1)
        alleles = rng.integers(0, 2, len(cols)).tolist()
        quals = rng.integers(1, 60, len(cols)).tolist()
        source = 1 if preferred and rng.random() < 0.15 else 0
        mapq = int(rng.integers(20, 61))
        for rs, cls in zip(sets, (Read, RefRead)):
            read = cls(f"r{i}", mapq, source, 0)
            for c, a, q in zip(cols, alleles, quals):
                read.add_variant(100 * (c + 1) + 50 * (c // 20), a, q)
            rs.add(read)
    for rs in sets:
        rs.sort()
    return sets


@pytest.mark.parametrize("bridging", [True, False], ids=["bridging", "slices"])
@pytest.mark.parametrize("seed", range(4))
def test_readselection_matches_python(seed, bridging, monkeypatch):
    """readselection in one call (readselectlib) selects the reads that the
    port's and the reference's Python selections select."""
    port_rs, ref_rs = _random_readsets(300 + seed)
    max_cov = 3 + seed
    native = readselect.readselection(port_rs, max_cov, None, bridging)
    port, ref = _python_routes(monkeypatch, lambda side: (
        readselect.readselection(port_rs, max_cov, None, bridging) if side == "port"
        else ref_readselect.readselection(ref_rs, max_cov, None, bridging)))
    assert 0 < len(native) < len(port_rs)
    assert native == port == ref


@pytest.mark.parametrize("seed", range(2))
def test_preferred_selection_uses_the_extension_heap(seed, monkeypatch):
    """With preferred reads the selection stays in Python, as in the
    reference, on the extension heap (pqext): the same reads as on the
    Python heap and as the reference's."""
    port_rs, ref_rs = _random_readsets(400 + seed, preferred=True)
    made = []
    real = priorityqueue._PriorityQueueNative.__init__

    def counted(self):
        made.append(1)
        real(self)

    monkeypatch.setattr(priorityqueue._PriorityQueueNative, "__init__", counted)
    native = readselect.readselection(port_rs, 4, {1})
    assert made, "the extension heap was used"
    port, ref = _python_routes(monkeypatch, lambda side: (
        readselect.readselection(port_rs, 4, {1}) if side == "port"
        else ref_readselect.readselection(ref_rs, 4, {1})))
    assert native == port == ref


@pytest.mark.parametrize("seed", range(3))
def test_extension_heap_matches_python_heap(seed):
    """pqext's heap and the Python heap (the port's and the reference's)
    pop the same items in the same order under random pushes, score
    changes and pops, ties included."""
    rng = np.random.default_rng(500 + seed)
    heaps = [priorityqueue._PriorityQueueNative(), priorityqueue._PriorityQueuePython(),
             ref_pq._PriorityQueuePython()]
    live, popped = set(), [[] for _ in heaps]
    for item in range(400):
        op = rng.integers(0, 4)
        if op < 2 or not live:
            score = tuple(int(x) for x in rng.integers(0, 4, 3))
            for h in heaps:
                h.push(score, item)
            live.add(item)
        elif op == 2:
            target = int(rng.choice(sorted(live)))
            score = tuple(int(x) for x in rng.integers(0, 4, 3))
            for h in heaps:
                h.change_score(target, score)
        else:
            for h, out in zip(heaps, popped):
                out.append(h.pop())
            live.discard(popped[0][-1][1])
    while live:
        for h, out in zip(heaps, popped):
            out.append(h.pop())
        live.discard(popped[0][-1][1])
    assert popped[0] == popped[1] == popped[2]
    assert all(h.is_empty() for h in heaps)


# ---------------------------------------------------------------------------
# the build


def test_nothing_is_built_at_import(tmp_path):
    """Importing the port, its CLIs included, builds no host helper and
    loads none."""
    code = (
        "import sys, pathlib\n"
        "import whatshap_torch.ops._build as b\n"
        "b.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "import whatshap_torch.cli.phase, whatshap_torch.cli.genotype, whatshap_torch.hostlib as h\n"
        "import whatshap_torch.io.sam, whatshap_torch.variants, whatshap_torch.readselect\n"
        "print(sorted(n for n in h.__all__ if n in vars(h)), b.BUILD_DIR.exists())\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "build")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False"


RACE = """
import importlib.util, sys, time
from pathlib import Path
spec = importlib.util.spec_from_file_location("_build", sys.argv[1])
b = importlib.util.module_from_spec(spec)
spec.loader.exec_module(b)
b.BUILD_DIR = Path(sys.argv[2])
time.sleep(max(0.0, float(sys.argv[3]) - time.time()))
secs, logs = b.build_host()
print(sorted(logs))
"""


def test_six_processes_build_one_whole_library_each(tmp_path, monkeypatch):
    """Six processes that build every host helper at the same moment (as six
    test workers may at first use) leave one whole, loadable library per
    source and no temporary file."""
    build = tmp_path / "build"
    start = time.time() + 1.5
    procs = [subprocess.Popen([sys.executable, "-c", RACE, _build.__file__, str(build), str(start)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _o, e in outs]
    assert any(o.strip() != "[]" for o, _e in outs)  # some process built
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    files = sorted(p.name for p in build.iterdir())
    assert files == sorted(_build.host_library_path(n).name for n in _build.HOST_SOURCES)
    for name in _build.HOST_SOURCES:
        lib = hostlib.load(name)
        assert lib is not None
    assert hostlib.load("alignlib").edit_distance(b"ACGT", b"AGT") == 1


@pytest.mark.parametrize("compiler", ["failing", "missing"])
def test_a_failed_build_raises(compiler, tmp_path, monkeypatch):
    """A compiler that fails (its output in the error) or is missing raises
    RuntimeError at first use, and the edit distance raises with it: there
    is no Python fallback."""
    gxx = tmp_path / "g++"
    if compiler == "failing":
        gxx.write_text("#!/bin/sh\necho 'error: this compiler builds nothing' >&2\nexit 1\n")
        gxx.chmod(0o755)
    monkeypatch.setattr(_build, "GXX", str(gxx))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delattr(hostlib, "alignlib", raising=False)
    match = "this compiler builds nothing" if compiler == "failing" else "cannot run"
    with pytest.raises(RuntimeError, match=match):
        hostlib.alignlib
    with pytest.raises(RuntimeError, match=match):
        align.edit_distance("ACGT", "AGT")
    assert not any((tmp_path / "build").glob("*"))
    assert "alignlib" not in vars(hostlib)
