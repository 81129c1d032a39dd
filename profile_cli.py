#!/usr/bin/env python3
"""
What the first `python -m whatshap_torch phase` costs, and what one
PedigreeDPTable call costs on the card against the CPU at the sizes of the
repository's test fixtures, on one CUDA card:

    python3 profile_cli.py

1. build at CLI use.  The package is copied into a fresh temporary
   directory (so its build/whatshap_torch/ is empty) and
   `python -m whatshap_torch phase` runs there in a new process, twice on
   the same files: the first run builds, with nvcc, each kernel source its
   route loads (one at a time, at first use), the second loads the built
   libraries.  Once for a single-sample chromosome of 1,000 SNVs at
   coverage 10 (T = 1 kernels) and once, in another fresh copy, for a trio
   of 512 SNVs at coverage 3 a sample (T = 4 kernels); both written by
   chip_smoke.write_synth, realigned against their FASTA.  A third fresh
   copy times a prebuild: _build.build_all(), every source at once.
2. per-call wall.  The PedigreeDPTable instances the phase CLI makes on
   tests/data fixtures (pacbio, the trio and its PED, the quartet with
   recombination breaks, phased blocks, ped_samples; captured from
   run_whatshap(device="cpu")) are solved again, each with device="cuda"
   and device="cpu": the median wall of 20 calls after one warm-up call,
   construction (packing, the solve, the copies back) included.

It prints the card's name and power limit beside the numbers.
"""

import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke as cs
from whatshap_torch.cli import phase as phase_cli
from whatshap_torch.io.sam import build_minimal_index, sam_to_bam
from whatshap_torch.solver.dptable import PedigreeDPTable

REPO = Path(__file__).resolve().parent


def _cli(root: Path, data: dict, out: str) -> float:
    """Wall seconds of one `python -m whatshap_torch phase` in a new process
    with `root` first on its path."""
    cmd = [sys.executable, "-m", "whatshap_torch", "phase", "-r", data["fasta"], "-o", out,
           data["vcf"], data["bam"]]
    if data["ped"]:
        cmd += ["--ped", data["ped"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, PYTHONPATH=str(root)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"phase CLI failed:\n{proc.stderr[-4000:]}")
    return wall


def _body(vcf: Path) -> list:
    return [line for line in vcf.read_text().splitlines() if not line.startswith("##commandline")]


def _fresh_copy(tmp: Path, name: str) -> Path:
    root = tmp / name
    shutil.copytree(REPO / "whatshap_torch", root / "whatshap_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def build_at_cli_use(tmp: Path) -> None:
    for label, name, data in (
        ("single sample, 1,000 SNVs", "chrom", cs.write_synth(tmp / "chrom", 1000, 10, seed=5)),
        ("trio, 512 SNVs", "trio", cs.write_synth(tmp / "trio", 512, 3, seed=9, trio=True)),
    ):
        root = _fresh_copy(tmp, f"copy-{name}")
        cold = _cli(root, data, str(root / "cold.vcf"))
        built = sorted(p.name.split("-")[0] for p in (root / "build" / "whatshap_torch").glob("*.so"))
        warm = _cli(root, data, str(root / "warm.vcf"))
        # the two VCFs differ only in their ##commandline header (the -o path)
        same = _body(root / "cold.vcf") == _body(root / "warm.vcf")
        print(f"build at CLI use, {label}: first run (cold build cache) {cold:.3f} s, built {built}; "
              f"second run (warm) {warm:.3f} s; same VCF records: {same}", flush=True)
    root = _fresh_copy(tmp, "prebuild")
    code = "from whatshap_torch.ops import _build; s, logs = _build.build_all(); print(f'{s:.3f}', sorted(logs))"
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=900,
                         env=dict(os.environ, PYTHONPATH=str(root)), check=True).stdout.strip()
    print(f"prebuild of every source at once: build_all {out.split()[0]} s, process {time.perf_counter() - t0:.3f} s",
          flush=True)


def fixture_instances(tmp: Path) -> list:
    """(fixture, arguments of each PedigreeDPTable the CLI makes on it)."""
    bams = {}
    for name in ("trio.pacbio", "recombination_breaks.sorted"):
        bams[name] = str(tmp / f"{name}.bam")
        sam_to_bam(f"tests/data/{name}.sam", bams[name])
        build_minimal_index(bams[name])
    fixtures = {
        "pacbio": dict(phase_input_files=["tests/data/pacbio/pacbio.bam"],
                       variant_file="tests/data/pacbio/variants.vcf",
                       reference="tests/data/pacbio/reference.fasta"),
        "trio": dict(phase_input_files=[bams["trio.pacbio"]], variant_file="tests/data/trio.vcf",
                     ped="tests/data/trio.ped", genmap="tests/data/trio.map"),
        "quartet": dict(phase_input_files=[bams["recombination_breaks.sorted"]],
                        variant_file="tests/data/quartet.vcf.gz", ped="tests/data/recombination_breaks.ped"),
        "phased-blocks": dict(phase_input_files=["tests/data/phased-blocks.reads.bam"],
                              variant_file="tests/data/phased-blocks.variants.vcf"),
        "ped_samples": dict(phase_input_files=["tests/data/ped_samples.bam"],
                            variant_file="tests/data/ped_samples.vcf", ped="tests/data/trio.ped"),
    }
    captured = []
    real = phase_cli.PedigreeDPTable

    class Capture(real):
        def __init__(self, *args, **kwargs):
            captured.append((fixture, args))
            super().__init__(*args, **kwargs)

    phase_cli.PedigreeDPTable = Capture
    try:
        for fixture, kwargs in fixtures.items():
            phase_cli.run_whatshap(**kwargs, output=str(tmp / f"{fixture}.vcf"), device="cpu")
    finally:
        phase_cli.PedigreeDPTable = real
    return captured


def _median_ms(args, device, reps=20) -> float:
    PedigreeDPTable(*args, device=device)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        PedigreeDPTable(*args, device=device)
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def per_call_wall(tmp: Path) -> None:
    for fixture, args in fixture_instances(tmp):
        table = PedigreeDPTable(*args, device="cpu")
        p = table._packed
        cuda_ms, cpu_ms = _median_ms(args, "cuda"), _median_ms(args, "cpu")
        print(f"PedigreeDPTable per call, {fixture} (C={p.n_cols} K={p.K} T={p.T}, {len(args[0])} reads): "
              f"cuda {cuda_ms:.3f} ms, cpu {cpu_ms:.3f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_cli: no CUDA device available", file=sys.stderr)
        return 1
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(power, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        build_at_cli_use(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        per_call_wall(Path(tmp))
    print(power, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
