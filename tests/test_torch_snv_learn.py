"""
Parity of the port's `find_snv_candidates` and `learn` (cli/*.py over
solver/caller.py, `core.Caller`) with the JAX package's on the CPU: the
reference's tests (tests/test_run_find_snv_candidates.py,
tests/test_run_learn.py) run on the port, both commands across their other
options with byte-identical outputs (find_snv_candidates' ##fileDate line
pinned to one date for both), and the k-mer enumerations and the Caller on
seeded random references and reads through both packages, outputs equal.
"""

import datetime as real_datetime
import filecmp
import types

import numpy as np
import pytest

from whatshap_tpu.cli import find_snv_candidates as ref_snv
from whatshap_tpu.cli import learn as ref_learn
from whatshap_tpu.solver import caller as ref_caller

import whatshap_torch.core as core
from whatshap_torch.cli import find_snv_candidates as snv
from whatshap_torch.cli import learn
from whatshap_torch.cli.find_snv_candidates import run_find_snv_candidates
from whatshap_torch.cli.learn import run_learn
from whatshap_torch.solver import caller

LEARN = "tests/data/short-genome/learn-data"


# ---------------------------------------------------------------------------
# the reference's tests on the port
# ---------------------------------------------------------------------------


def test_call(tmpdir):
    output = str(tmpdir.join("output.vcf"))
    run_find_snv_candidates(
        "tests/data/pacbio/reference.fasta",
        "tests/data/pacbio/pacbio.bam",
        datatype="pacbio",
        output=output,
    )
    computed_lines = []
    expected_lines = []
    for line in open(output, "r"):
        if line.startswith("#"):
            continue
        computed_lines.append(line)
    for line in open("tests/data/expected-calls.vcf"):
        if line.startswith("#"):
            continue
        expected_lines.append(line)
    assert computed_lines == expected_lines


def test_run_learn(tmp_path):
    expected = f"{LEARN}/expected.txt"
    observed = tmp_path / "observed.txt"
    run_learn(
        reference=f"{LEARN}/short_ref.fasta",
        bam=f"{LEARN}/short-reads.bam",
        vcf=f"{LEARN}/variant.vcf",
        k=7,
        window=25,
        output=observed,
    )
    assert filecmp.cmp(expected, observed, shallow=False)


# ---------------------------------------------------------------------------
# the commands against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture
def pinned_date(monkeypatch):
    """Both find_snv_candidates modules see 2026-01-02 as today (the
    ##fileDate line), so that a run across midnight cannot differ."""

    class Pinned(real_datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2026, 1, 2)

    pinned = types.SimpleNamespace(datetime=Pinned)
    for mod in (ref_snv, snv):
        monkeypatch.setattr(mod, "datetime", pinned)


SNV_CASES = {
    "pacbio": dict(datatype="pacbio"),
    "nanopore": dict(datatype="nanopore"),
    "illumina": dict(datatype="illumina"),
    "defaults": {},
    "multi-allelics": dict(datatype="pacbio", multi_allelics=True),
    "sites-only": dict(datatype="pacbio", sample=None),
    "minabs-2-minrel-0.1": dict(minabs=2, minrel=0.1, sample="NA12878"),
    "chromosome": dict(datatype="nanopore", chromosome="ref"),
    "no-such-chromosome": dict(datatype="pacbio", chromosome="chrZ"),
}


@pytest.mark.parametrize("case", list(SNV_CASES))
def test_find_snv_candidates_matches_reference(case, tmp_path, pinned_date, capsys):
    """find_snv_candidates on the pacbio fixture writes the reference's
    bytes, and prints what it prints."""
    outs = []
    for mod, name in ((ref_snv, "ref.vcf"), (snv, "port.vcf")):
        mod.run_find_snv_candidates("tests/data/pacbio/reference.fasta", "tests/data/pacbio/pacbio.bam",
                                    output=str(tmp_path / name), **SNV_CASES[case])
        outs.append(((tmp_path / name).read_bytes(), capsys.readouterr().out))
    assert outs[1] == outs[0]
    assert b"##fileDate=20260102\n" in outs[0][0]
    if case in ("pacbio", "multi-allelics", "chromosome"):
        assert outs[0][0].count(b"\tPASS\t") > 20


@pytest.mark.parametrize("k,window", [(7, 25), (5, 25), (9, 25), (7, 10), (7, 50), (11, 20), (3, 5)])
def test_learn_matches_reference(k, window, tmp_path):
    """learn on the short-genome fixture writes the reference's k-mer pair
    counts at each k and window (none at a window of 50: every column of the
    short genome lies within 50 bases of a variant)."""
    args = dict(reference=f"{LEARN}/short_ref.fasta", bam=f"{LEARN}/short-reads.bam", vcf=f"{LEARN}/variant.vcf",
                k=k, window=window)
    ref_learn.run_learn(**args, output=tmp_path / "ref.txt")
    learn.run_learn(**args, output=tmp_path / "port.txt")
    ref = (tmp_path / "ref.txt").read_bytes()
    assert (tmp_path / "port.txt").read_bytes() == ref
    assert (len(ref) > 0) == (window < 50)


def test_core_reexports_caller():
    """whatshap_torch.core re-exports Caller after the host solvers, as the
    reference's core does."""
    import whatshap_tpu.core as ref_core

    assert core.Caller is caller.Caller
    assert "Caller" in core.__all__
    assert [n for n in ref_core.__all__] == [n for n in core.__all__]


# ---------------------------------------------------------------------------
# the k-mer enumerations and the Caller on seeded random inputs
# ---------------------------------------------------------------------------


def _reference(rng, n):
    """A random reference of n bases, a few of them N or lower case."""
    seq = rng.choice(list(b"ACGT"), n).astype(np.uint8)
    seq[rng.random(n) < 0.01] = ord("N")
    seq[rng.random(n) < 0.01] = ord("a")
    return seq.tobytes()


def _read(rng, ref, start):
    """A read aligned at `start` with a random CIGAR (soft clips, matches,
    insertions, deletions) and 2 % substitutions; (cigartuples, query)."""
    ops = []
    if rng.random() < 0.3:
        ops.append((4, int(rng.integers(1, 6))))
    for _ in range(int(rng.integers(1, 5))):
        ops.append((0, int(rng.integers(5, 30))))
        r = rng.random()
        if r < 0.3:
            ops.append((1, int(rng.integers(1, 4))))
        elif r < 0.6:
            ops.append((2, int(rng.integers(1, 4))))
    ops.append((0, int(rng.integers(3, 20))))
    if rng.random() < 0.3:
        ops.append((4, int(rng.integers(1, 6))))
    query, pos = bytearray(), start
    for op, n in ops:
        if op == 0:
            seg = bytearray(ref[pos : pos + n].ljust(n, b"A"))
            for i in np.nonzero(rng.random(n) < 0.02)[0]:
                seg[i] = b"ACGT"[int(rng.integers(0, 4))]
            query += seg
            pos += n
        elif op == 2:
            pos += n
        else:
            query += bytes(rng.choice(list(b"ACGT"), n).astype(np.uint8))
    return ops, bytes(query)


@pytest.mark.parametrize("seed,k", [(1, 3), (2, 5), (3, 7), (4, 9), (5, 11), (6, 15)])
def test_kmer_enumerations_match_reference(seed, k):
    """enumerate_reference_kmers and enumerate_kmers (the CIGAR walk) give
    the reference's (hash, end position) lists."""
    rng = np.random.default_rng(seed)
    ref = _reference(rng, 400)
    assert caller.enumerate_reference_kmers(ref, k) == ref_caller.enumerate_reference_kmers(ref, k)
    for _ in range(20):
        start = int(rng.integers(0, 300))
        ops, query = _read(rng, ref, start)
        assert caller.enumerate_kmers(start, query, k, ops) == ref_caller.enumerate_kmers(start, query, k, ops)


@pytest.mark.parametrize("seed,k,window", [(11, 5, 10), (12, 7, 25), (13, 7, 3), (14, 9, 40), (15, 4, 15)])
def test_caller_matches_reference(seed, k, window, tmp_path):
    """A Caller of each package over a random reference, variant list and
    sorted reads with random CIGARs appends the same rows to its file."""
    rng = np.random.default_rng(seed)
    ref = _reference(rng, 1200)
    variants = sorted((int(p), int(rng.integers(1, 4))) for p in rng.choice(1100, 12, replace=False))
    reads = sorted((int(s), *_read(rng, ref, int(s))) for s in rng.integers(0, 1050, 60))
    for cls, name in ((ref_caller.Caller, "ref.txt"), (core.Caller, "port.txt")):
        out = str(tmp_path / name)
        open(out, "w").close()
        c = cls(ref, k, window)
        c.all_variants(variants)
        for start, ops, query in reads:
            c.add_read(start, ops, query, out)
        c.final_pop(out)
    ref_rows = (tmp_path / "ref.txt").read_bytes()
    assert (tmp_path / "port.txt").read_bytes() == ref_rows
    assert ref_rows.count(b"\n") > 100
