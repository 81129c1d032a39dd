#!/usr/bin/env python3
"""
Where a column's time goes in the T=1 forward kernel
(whatshap_torch/csrc/wmec_forward_t1.cu), and how its cluster size plays,
on one CUDA card:

    python3 profile_forward_t1.py

The card's profilers are not at hand, so this builds variants of the kernel
source and times them against the unchanged kernel with CUDA events, in
the tables mode and the carry mode, in two rounds, at two shapes: one
segment of the segmented cell (B = 1, C = 2048, K = 15: kernel rows 9-10
at T = 1) and the slice's bucket (B = 256, C = 512, K = 15: row 1).  Three
variants fix the cluster at 16, 8 and 4 CTAs at K = 15 whatever the launch
width (their results must equal the kernel's), and a sweep times them in
the tables mode on the first B blocks of the slice's bucket, B = 1 to 256;
the others each switch one part off (their results are wrong and are not
used), so a part's cost is the difference to the unchanged kernel.  The
variants are built under build/whatshap_torch/parts_t1/.
"""

import subprocess
import sys

import torch

import chip_smoke as cs
import profile_forward_t
from whatshap_torch.ops import wmec, wmec_cuda
from whatshap_torch.parallel import blocks

CTA_BITS = "int cta_bits(int K, int B) {"
#: variant -> (text in the source, its replacement); the first four keep the
#: results and change only the layout at K = 15
VARIANTS = {
    "kernel": [],
    "16 CTAs": [("  if (B <= kWideB) return narrow;", "  return narrow;")],
    "8 CTAs": [(CTA_BITS, CTA_BITS + " if (K == 15) return 3;")],
    "4 CTAs": [(CTA_BITS, CTA_BITS + " if (K == 15) return 2;")],
    "no CTA-bit folds": [("for (int p = q.lb; p < ctab; ++p) {", "for (int p = q.lb; p < q.tb; ++p) {")],
    "no warp-bit folds": [("for (int p = q.lb; p < ctab; ++p) {", "for (int p = q.tb; p < ctab; ++p) {")],
    "no lane-bit folds": [("for (int p = 0; p < q.lb; ++p) {", "for (int p = 0; p < 0; ++p) {")],
    "no loop-bit folds": [("if (!((mask >> (ctab + r)) & 1)) continue;", "continue;")],
    "no cluster barriers": [
        ("          cluster_sync();\n        } else {\n          __syncthreads();\n        }\n        const unsigned pr",
         "          (void)0;\n        } else {\n          __syncthreads();\n        }\n        const unsigned pr"),
        ("          clusters::cluster_arrive();\n          pending = true;", "          (void)0;"),
        # one barrier at the end, so that no CTA leaves while a partner reads
        ("  if (pending) clusters::cluster_wait();", "  cluster_sync();"),
    ],
    "no folds": [("if (mask) {", "if (false) {")],
    "no table writes": [("if (kTab) prow[(size_t)m << ctab] = iv[m];", "")],
}
EXACT = ("kernel", "16 CTAs", "8 CTAs", "4 CTAs")
#: launch widths of the sweep (the first B blocks of the slice's bucket)
SWEEP_B = (1, 8, 16, 17, 24, 32, 64, 128, 256)


def shapes():
    """(label, K, arrays, carry) of the two shapes: segment 1 of the
    segmented cell from the state after segment 0, and the slice's bucket
    from a zero state (the carry mode there from the state after its first
    half)."""
    rs, pos, _truth = cs.chromosome(1, 4096, 15, seed=23)
    packed = wmec.pack_problem(rs, [1] * len(pos), cs._het_pedigree(len(pos)), False)
    arrays = blocks.to_device(blocks.stack_blocks([blocks.pad_block(packed, 4096)]), "cuda")
    K = packed.K
    carry = wmec_cuda.forward_t1(K, 2, *[a[:, :2048].contiguous() for a in arrays])[1:]
    out = [("segment", K, [a[:, 2048:].contiguous() for a in arrays], carry)]
    rs, pos, _truth = cs.chromosome(256, 512, 15, seed=7)
    packed = wmec.pack_problem(rs, [1] * len(pos), cs._het_pedigree(len(pos)), False)
    (_c, K), members, _ri = cs.main_bucket(packed)
    arrays = blocks.to_device(blocks.stack_blocks(members), "cuda")
    carry = wmec_cuda.forward_t1(K, 2, *[a[:, :256].contiguous() for a in arrays])[1:]
    out.append(("slice bucket", K, arrays, carry))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_forward_t1: no CUDA device available", file=sys.stderr)
        return 1
    libs = profile_forward_t.build_variants(
        "wmec_forward_t1", VARIANTS, ("wmec_forward_t1", "wmec_forward_carry_t1"), "parts_t1")
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.strip()
    stream = torch.cuda.current_stream().cuda_stream
    cells = shapes()
    for label, K, arrays, carry in cells:
        B, C, S = arrays[0].shape[0], arrays[0].shape[1], 1 << K
        pidx = torch.empty((B, C, S), dtype=torch.int32, device="cuda")
        dp = torch.empty((B, S), dtype=torch.int32, device="cuda")
        key = torch.empty_like(dp)
        ins = [a.data_ptr() for a in arrays[:5]]
        runs = {
            "tables": lambda lib: lib.wmec_forward_t1(
                *ins, None, None, pidx.data_ptr(), dp.data_ptr(), key.data_ptr(), B, C, K, stream),
            "carry": lambda lib: lib.wmec_forward_carry_t1(
                *ins, *(x.data_ptr() for x in carry), dp.data_ptr(), key.data_ptr(), B, C, K, stream),
        }
        print(f"{power}; {label}: B={B} C={C} K={K}", flush=True)
        ref = {}
        for rnd in range(2):
            for name, lib in libs.items():
                for mode, run in runs.items():
                    if run(lib) != 0:
                        raise RuntimeError(f"{name} {mode}: launch failed")
                    if rnd == 0 and name in EXACT:
                        torch.cuda.synchronize()
                        got = [t.clone() for t in ((pidx, dp, key) if mode == "tables" else (dp, key))]
                        if name == "kernel":
                            ref[mode] = got
                        elif not all(torch.equal(x, y) for x, y in zip(got, ref[mode])):
                            raise RuntimeError(f"{name} {mode}: results differ from the kernel's")
                    ms = cs._time(lambda: run(lib), reps=3)
                    print(f"round {rnd} {label} {name:18s} {mode:6s} {ms:8.3f} ms {ms * 1e3 / C:8.2f} us per column",
                          flush=True)
        del pidx, ref
        torch.cuda.empty_cache()

    # the layouts against the launch width, tables mode
    _label, K, arrays, _carry = cells[1]
    C, S = arrays[0].shape[1], 1 << K
    print(f"{power}; sweep over B at C={C} K={K}, tables mode", flush=True)
    for rnd in range(2):
        for B in SWEEP_B:
            ins = [a[:B].data_ptr() for a in arrays[:5]]
            pidx = torch.empty((B, C, S), dtype=torch.int32, device="cuda")
            dp = torch.empty((B, S), dtype=torch.int32, device="cuda")
            key = torch.empty_like(dp)
            times = []
            for name in ("kernel", "16 CTAs", "4 CTAs"):
                run = lambda: libs[name].wmec_forward_t1(  # noqa: E731
                    *ins, None, None, pidx.data_ptr(), dp.data_ptr(), key.data_ptr(), B, C, K, stream)
                if run() != 0:
                    raise RuntimeError(f"{name} B={B}: launch failed")
                times.append(f"{name} {cs._time(run, reps=3):8.3f} ms")
            print(f"round {rnd} sweep B={B:3d}: " + ", ".join(times), flush=True)
            del pidx, dp, key
    return 0


if __name__ == "__main__":
    sys.exit(main())
