#!/usr/bin/env python3
"""
Where a column's time goes in the general-T forward kernel
(whatshap_torch/csrc/wmec_forward_t.cu), on one CUDA card:

    python3 profile_forward_t.py

The card's profilers are not at hand, so this builds variants of the kernel
source, each with one part switched off (their results are wrong and are
not used), and times them against the unchanged kernel with CUDA events at
the trio-single shape (one read-connected trio range of 2048 columns, K =
15, T = 4, P = 4: kernel rows 3-4), in the tables mode and the carry mode,
in two rounds.  A part's cost is the difference to the unchanged kernel.
The variants are built under build/whatshap_torch/parts/.
"""

import ctypes
import subprocess
import sys

import torch

import chip_smoke as cs
from whatshap_torch.ops import _build, wmec, wmec_cuda
from whatshap_torch.parallel import blocks

#: variant -> (text in the source, its replacement)
VARIANTS = {
    "kernel": [],
    "no CTA-bit folds": [("|| p >= ctab) continue;", "|| p >= q.tb) continue;")],
    "no warp-bit folds": [("|| p >= ctab) continue;", "|| p < q.tb || p >= ctab) continue;")],
    "no lane-bit folds": [("for (int p = 0; p < q.lb; ++p) {", "for (int p = 0; p < 0; ++p) {")],
    "no loop-bit folds": [("if (!((mask >> (ctab + r)) & 1)) continue;", "continue;")],
    "no folds": [("mask |= (uint32_t)(rec[Rc::die(K) + k] != 0) << k;", "(void)0;")],
    "no table writes": [("a.pidx[at] = iv[m];", ""), ("a.pjmin[at] = jv[m];", "")],
}


def build_variants(source="wmec_forward_t", variants=VARIANTS, fns=("wmec_forward_t", "wmec_forward_carry_t"),
                   parts="parts"):
    """Build each variant of csrc/<source>.cu (its text substitutions applied)
    under build/whatshap_torch/<parts>/, one nvcc each, all started together;
    returns {variant: the loaded library, with the C entries `fns` bound}."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    out = _build.BUILD_DIR / parts
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for i, (name, subs) in enumerate(variants.items()):
        text = src
        for a, b in subs:
            if a not in text:
                raise RuntimeError(f"variant {name!r}: {a!r} is not in the source")
            text = text.replace(a, b)
        cu = out / f"part{i}.cu"
        cu.write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out / f"part{i}.so"), str(cu)]
        procs[name] = (out / f"part{i}.so", subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in fns:
            getattr(lib, fn).argtypes = wmec_cuda._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_forward_t: no CUDA device available", file=sys.stderr)
        return 1
    libs = build_variants()
    rs, pos, ped, _truth = cs.simulate_pedigree(1, 2048, 5, cs.TRIO, seed=5)
    packed = wmec.pack_problem(rs, [10] * len(pos), ped, False, pos)
    (C, K), members, _ri = cs.main_bucket(packed)
    T, P = packed.T, packed.P
    arrays = blocks.to_device(blocks.stack_blocks(members), "cuda")
    B, S = len(members), 1 << K
    pidx = torch.empty((B, C, T, S), dtype=torch.int32, device="cuda")
    pjmin = torch.empty_like(pidx)
    dp = torch.empty((B, T, S), dtype=torch.int32, device="cuda")
    jm = torch.empty_like(dp)
    key = torch.empty((B, S), dtype=torch.int32, device="cuda")
    carry = wmec_cuda.forward_t(K, T, P, *[a[:, :64].contiguous() for a in arrays])[2:]
    ins = [a.data_ptr() for a in arrays]
    stream = torch.cuda.current_stream().cuda_stream
    runs = {
        "tables": lambda lib: lib.wmec_forward_t(
            *ins, None, None, None, None, pidx.data_ptr(), pjmin.data_ptr(), dp.data_ptr(), jm.data_ptr(),
            key.data_ptr(), B, C, K, T, P, stream),
        "carry": lambda lib: lib.wmec_forward_carry_t(
            *ins, *(x.data_ptr() for x in carry), dp.data_ptr(), jm.data_ptr(), key.data_ptr(),
            B, C, K, T, P, stream),
    }
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{power}; B={B} C={C} K={K} T={T} P={P}", flush=True)
    for rnd in range(2):
        for name, lib in libs.items():
            for mode, run in runs.items():
                if run(lib) != 0:
                    raise RuntimeError(f"{name} {mode}: launch failed")
                ms = cs._time(lambda: run(lib), reps=3)
                print(f"round {rnd} {name:18s} {mode:6s} {ms:8.3f} ms {ms * 1e3 / C:7.2f} us per column", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
