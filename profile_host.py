#!/usr/bin/env python3
"""
Where the CLI cells' host time goes, before and after the host helpers of
the read path (whatshap_torch/csrc/host, whatshap_torch.hostlib), on one
CUDA card:

    python3 profile_host.py [--parent DIR] [--phase-variants N] [--geno-variants N]

It writes the files of three chip_smoke.py cells with chip_smoke.write_synth
(phase-cli: CLI_VARIANTS SNVs at coverage 14, or --phase-variants;
genotype-cli: GENO_CLI_VARIANTS of mixed genotypes, or --geno-variants;
phase-cli-ds23: DS23_VARIANTS at coverage 30, phased at
--internal-downsampling 23) under
build/profile_host/, builds this checkout's kernels and host helpers, and
runs the three CLIs on the card (device="cuda") in a new process per
checkout and turn, after one warm-up run in that process on a 512-variant
file of the generator: wall, variants/s and every stage of LAST_TIMERS.  With --parent (a
checkout of another commit, e.g. `git archive` of the parent unpacked under
build/), it times that checkout's CLIs on the same files in turns: parent,
this, this, parent (its kernels are copied from this
checkout's build where their sources are the same).  Each line carries the
card's name and power limit and the host's CPU count; the results go to
build/profile_host/profile_host.json as well.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DATA = REPO / "build" / "profile_host"
CELLS = ("phase-cli", "genotype-cli", "phase-cli-ds23")
STAGES = {"phase": ("parse_vcf", "read_bam", "select", "phase", "components", "write_vcf"),
          "genotype": ("parse_vcf", "read_bam", "select", "genotyping", "write_vcf")}

RUN = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from whatshap_torch.cli import phase as phase_cli
from whatshap_torch.cli import genotype as geno_cli
cells = json.loads(sys.argv[2])
out = {"checkout": sys.argv[1]}
warm = cells.pop("warm")
phase_cli.run_whatshap(phase_input_files=[warm["bam"]], variant_file=warm["vcf"], reference=warm["fasta"],
                       write_command_line_header=False, device="cuda", output=sys.argv[3] + "/warm.vcf")
for label, cell in cells.items():
    cli = phase_cli if cell["cli"] == "phase" else geno_cli
    run = cli.run_whatshap if cell["cli"] == "phase" else cli.run_genotype
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(phase_input_files=[cell["bam"]], variant_file=cell["vcf"], reference=cell["fasta"],
        write_command_line_header=False, device="cuda", output=sys.argv[3] + f"/{label}.vcf", **cell["kwargs"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timers = cli.LAST_TIMERS
    stages = {k: timers.elapsed(k) for k in cell["stages"]}
    stages["rest"] = timers.total() - timers.sum()
    out[label] = {"wall": wall, "variants_per_s": cell["n_vars"] / wall, "stages": stages}
print("RESULT " + json.dumps(out))
"""


def write_cells(phase_variants, geno_variants):
    """The three cells' files and the warm-up's, written once under
    build/profile_host/."""
    import chip_smoke as cs

    specs = {
        "warm": (512, 14, 3, False, "phase", {}),
        "phase-cli": (phase_variants or cs.CLI_VARIANTS, 14, 7, False, "phase", {}),
        "genotype-cli": (geno_variants or cs.GENO_CLI_VARIANTS, 14, 13, True, "genotype", {}),
        "phase-cli-ds23": (cs.DS23_VARIANTS, cs.DS23_COVERAGE, 7, False, "phase", {"max_coverage": 23}),
    }
    cells = {}
    for label, (n, cov, seed, mixed, cli, kwargs) in specs.items():
        t0 = time.perf_counter()
        data = cs.write_synth(str(DATA / label), n, cov, seed=seed, mixed=mixed)
        print(f"{label}: {n} variants, {data['n_reads']} reads written in {time.perf_counter() - t0:.1f} s",
              flush=True)
        cells[label] = {"bam": data["bam"], "vcf": data["vcf"], "fasta": data["fasta"], "n_vars": n, "cli": cli,
                        "stages": STAGES[cli], "kwargs": kwargs}
    return cells


def run_checkout(root: Path, cells: dict) -> dict:
    out_dir = DATA / f"out-{root.name}"
    out_dir.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([sys.executable, "-c", RUN, str(root), json.dumps(cells), str(out_dir)], cwd=REPO,
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"CLI runs of {root} failed:\n{proc.stderr[-4000:]}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout to time in turns with this one")
    ap.add_argument("--phase-variants", type=int, help="phase-cli's size (default chip_smoke.CLI_VARIANTS)")
    ap.add_argument("--geno-variants", type=int, help="genotype-cli's size (default chip_smoke.GENO_CLI_VARIANTS)")
    args = ap.parse_args()

    import torch

    from whatshap_torch.ops import _build

    if not torch.cuda.is_available():
        print("profile_host: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    context = f"{card}; {os.cpu_count()} host CPUs"
    secs, _ = _build.build_all()
    host_secs, _ = _build.build_host()
    print(f"build: kernels {secs:.1f} s, host helpers {host_secs:.1f} s", flush=True)
    checkouts = [REPO]
    if args.parent:
        parent = Path(args.parent).resolve()
        built = parent / "build" / "whatshap_torch"
        built.mkdir(parents=True, exist_ok=True)
        for lib in _build.BUILD_DIR.glob("*.so"):
            if (parent / "whatshap_torch" / "csrc" / lib.name.rsplit("-", 1)[0]).with_suffix(".cu").exists():
                shutil.copy2(lib, built / lib.name)
        checkouts = [parent, REPO, REPO, parent]
    cells = write_cells(args.phase_variants, args.geno_variants)
    results = []
    for root in checkouts:
        res = run_checkout(root, cells)
        results.append(res)
        name = "parent" if root != REPO else "this"
        for label in CELLS:
            r = res[label]
            print(f"{name} {label}: wall {r['wall']:.3f} s = {r['variants_per_s']:.1f} variants/s; stages (s): "
                  + " ".join(f"{k} {v:.3f}" for k, v in r["stages"].items()) + f" ({context})", flush=True)
    (DATA / "profile_host.json").write_text(json.dumps({"context": context, "runs": results}, indent=1))
    print(context)
    return 0


if __name__ == "__main__":
    sys.exit(main())
