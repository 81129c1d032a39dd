#!/usr/bin/env python3
"""
Where a launch's time goes in the T=1 forward kernel with the state in
device memory (whatshap_torch/csrc/wmec_forward_t1_wide.cu, kernel row 13),
on one CUDA card:

    python3 profile_forward_t1_wide.py [--parent DIR]

The card's profilers are not at hand, so this builds variants of the kernel
source under build/whatshap_torch/parts_t1_wide/, each with parts switched
off (their results are wrong and are not used), its windows cut to one
column or all columns sent down its general path, its occupancy or its
L2 sweep's groups changed, or clock64 counters a CTA around its phases
("phase clocks", printed as microseconds a CTA), and times them with CUDA
events against the unchanged kernel at four shapes: wide-k20 (16 blocks of 64 columns at K = 20, tables
from zero), phase-cli-ds23's bucket (19 blocks of 64 columns at K = 23, one
launch as the route chunks it; chip_smoke.packed_bucket's synthetic blocks)
and a segment of segmented-k23 (one block of 64 columns at K = 23 from the
state after 64 columns) in the carry mode and the tables mode from that
carry; two rounds.  A part's cost is the difference to the unchanged
kernel.  Every launch writes into the same output buffers (phase-cli-ds23's
tables are 38 GiB).  With --parent DIR the same parts of the kernel of the
checkout in DIR are timed too, in turns with this one's: parent, kernel,
kernel, parent.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from whatshap_torch.ops import _build, wmec_cuda

SOURCE = "wmec_forward_t1_wide"
#: variant -> (text in this checkout's source, its replacement)
VARIANTS = {
    "kernel": [],
    "no fold": [("const uint32_t dm = sm.dmask[w];", "const uint32_t dm = 0;"),
                ("const int nf = sm.nfold;", "const int nf = 0;")],
    "no column cost": [("const int cc = min(min(min(a4.x + h.x, a4.y + h.y), min(a4.z + h.z, a4.w + h.w)), kInf);",
                        "const int cc = min(a4.x + h.x, kInf);")],
    "no table writes": [("if (kTab) __stcs(row + (base | (uint32_t)sm.hoff[i]), "
                         "(int)(base | (uint32_t)sm.hoff[nib(iv, i)]));", ""),
                        ("if (kTab) __stcs(row + s, iv[i]);", "")],
    "one column a window": [("for (int w = 1; w < kWin; ++w) {\n      if (c0 + w >= C",
                             "for (int w = 1; w < 1; ++w) {\n      if (c0 + w >= C")],
    "three CTAs an SM": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)")],
    "general path only": [("const bool windowed = __all_sync(0xffffffffu, nb <= 32 && __popc(m[0]) <= nh);",
                           "const bool windowed = false;")],
    "group sweep off": [("int group = (int)(kL2Share >> (K + 2));", "int group = B;")],
    "L2 share 24 MiB": [("constexpr size_t kL2Share = ", "constexpr size_t kL2Share = (size_t)24 << 20; //")],
    "L2 share 40 MiB": [("constexpr size_t kL2Share = ", "constexpr size_t kL2Share = (size_t)40 << 20; //")],
}
VARIANTS["loads and stores only"] = VARIANTS["no fold"] + VARIANTS["no column cost"]
# thread 0 of each CTA counts clock64 cycles in the kernel's phases and
# writes them over the first int64 words of key_last: the window choice, the
# builds, the tiles and the grid barriers, then the windows and the general
# path's columns it took
_W = "{ pt = clock64(); %s pc[%d] += clock64() - pt; }"
VARIANTS["phase clocks"] = [
    ("  grid.sync();\n\n  // the groups of the L2 sweep",
     "  grid.sync();\n  long long pc[6] = {0, 0, 0, 0, 0, 0}, pt = 0;\n\n  // the groups of the L2 sweep"),
    ("if (threadIdx.x < 32) next_window(a, sm, g0, nb, c0, lb - nl);\n      __syncthreads();",
     _W % ("if (threadIdx.x < 32) next_window(a, sm, g0, nb, c0, lb - nl); __syncthreads();", 0)),
    ("build_window<kTab>(a, sm, b, c0, win);", _W % ("build_window<kTab>(a, sm, b, c0, win);", 1) + " ++pc[4];"),
    ("build(a, sm, b, c, fold, kTab && c > 0 && fold != 0);",
     _W % ("build(a, sm, b, c, fold, kTab && c > 0 && fold != 0);", 1) + " ++pc[5];"),
    ("load_window(a, sm, (size_t)b << K, c0, base, 1 << (lb - nl), cv);\n"
     "          run_window<kTab>(a, sm, b, c0, win, u, base, 1 << (lb - nl), cv);",
     _W % ("load_window(a, sm, (size_t)b << K, c0, base, 1 << (lb - nl), cv); "
           "run_window<kTab>(a, sm, b, c0, win, u, base, 1 << (lb - nl), cv);", 2)),
    ("run_tile<kTab>(a, sm, b, c, t % per_block, first, final_pass, lane_bits);",
     _W % ("run_tile<kTab>(a, sm, b, c, t % per_block, first, final_pass, lane_bits);", 2)),
    ("        grid.sync();\n        c0 += win;", "        " + _W % ("grid.sync();", 3) + "\n        c0 += win;"),
    ("        grid.sync();\n      }\n    }\n  }\n}",
     "        " + _W % ("grid.sync();", 3) + "\n      }\n    }\n  }\n"
     "  if (threadIdx.x == 0) {\n"
     "    for (int q = 0; q < 6; ++q) reinterpret_cast<long long*>(a.key_last)[blockIdx.x * 6 + q] = pc[q];\n"
     "  }\n}"),
]
#: the same parts in the source of the kernel's first draft (a checkout before the redesign)
PARENT_VARIANTS = {
    "kernel": [],
    "no fold": [("if ((m >> j) & 1) continue;", "continue;"), ("if (kTab && G > 0) {", "if (false) {")],
    "one pass a column": [("const int np = __ldcg(a.npass + c);", "const int np = 1;"),
                          ("const int gi = p - (np - groups);", "const int gi = 0 * groups;")],
    "no column cost": [("const int4 x = sums_of(sm, s);", "const int4 x = make_int4(0, 0, 0, 0);"),
                       ("for (int e = tid; e < 3 * kRows; e += kThreads) {",
                        "for (int e = tid; e < 0; e += kThreads) {")],
    "no table writes": [("if (kTab) __stcs(row + s, iv[e]);", "")],
}
PARENT_VARIANTS["loads and stores only"] = PARENT_VARIANTS["no fold"] + PARENT_VARIANTS["no column cost"]
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"wmec_forward_t1_wide": [_P] * 11 + [_I] * 3 + [_P],
              "wmec_forward_carry_t1_wide": [_P] * 10 + [_I] * 3 + [_P]}


def build_variants(src: str, variants: dict, tag: str) -> dict:
    """Build each variant of the source text `src` (its substitutions
    applied) under build/whatshap_torch/parts_t1_wide/<tag>/, one nvcc each,
    all started together; returns {variant: the loaded library}."""
    out = _build.BUILD_DIR / "parts_t1_wide" / tag
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
        procs[name] = (out / f"part{i}.so", subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                             text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {name!r}:\n{log}")
        if name == "kernel":
            print(f"{tag}: " + "; ".join(x.strip() for x in log.splitlines() if "registers" in x or "spill" in x),
                  flush=True)
        lib = ctypes.CDLL(str(so))
        for fn, sig in SIGNATURES.items():
            getattr(lib, fn).argtypes = sig
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def print_clocks(key, K, B, label, mode):
    """The phase clocks variant's counts (thread 0 of each CTA): mean and
    largest over the launch's CTAs, in microseconds at the card's clock."""
    torch.cuda.synchronize()
    props = torch.cuda.get_device_properties(0)
    lb = min(K, 12)
    grid = min(2 * props.multi_processor_count, wmec_cuda.forward_t1_wide_group(K, B) << (K - lb))
    pc = key.view(-1)[: 2 * 6 * grid].view(torch.int64).view(grid, 6).double().cpu()
    mhz = props.clock_rate / 1e3 if hasattr(props, "clock_rate") else 1980.0
    names = ("window choice", "builds", "tiles", "grid barriers")
    print(f"  clocks {label} {mode} over {grid} CTAs at {mhz:.0f} MHz: "
          + "; ".join(f"{n} {pc[:, i].mean() / mhz:.1f} us (max {pc[:, i].max() / mhz:.1f})"
                      for i, n in enumerate(names))
          + f"; windows {pc[:, 4].mean():.1f}, general columns' builds {pc[:, 5].mean():.1f} a CTA", flush=True)


def shapes():
    """(label, mode, K, input arrays, carry or None) of the four timed
    launches, built one at a time (the caller frees each before the next)."""
    yield "wide-k20", "tables", 20, cs.packed_bucket(16, 64, 20, 9000, "cuda"), None
    yield "ds23-bucket", "tables", 23, cs.packed_bucket(19, 64, 23, 9100, "cuda"), None
    arrays = cs.packed_bucket(1, 128, 23, 9200, "cuda")
    head = [a[:, :64].contiguous() for a in arrays]
    tail = [a[:, 64:].contiguous() for a in arrays]
    del arrays
    carry = cs._carry_after(23, 1, 2, head)
    del head
    yield "segment", "carry", 23, tail, carry
    yield "segment", "tables from a carry", 23, tail, carry


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_forward_t1_wide: no CUDA device available", file=sys.stderr)
        return 1
    parent = Path(sys.argv[sys.argv.index("--parent") + 1]) if "--parent" in sys.argv else None
    libs = {"": build_variants((_build.CSRC / f"{SOURCE}.cu").read_text(), VARIANTS, "kernel")}
    if parent is not None:
        src = (parent / "whatshap_torch" / "csrc" / f"{SOURCE}.cu").read_text()
        libs["parent "] = build_variants(src, PARENT_VARIANTS, "parent")
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.strip()
    print(power, flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    order = list(libs) + list(reversed(libs))
    for label, mode, K, arrays, carry in shapes():
        B, C, S = arrays[0].shape[0], arrays[0].shape[1], 1 << K
        ins = [a.data_ptr() for a in arrays[:5]]
        pidx = torch.empty((B, C, S), dtype=torch.int32, device="cuda") if mode != "carry" else None
        dp = torch.empty((B, S), dtype=torch.int32, device="cuda")
        key = torch.empty_like(dp)
        scratch = torch.empty(B * C + C, dtype=torch.int32, device="cuda")
        c0, k0 = (carry[0].data_ptr(), carry[1].data_ptr()) if carry is not None else (None, None)
        if mode == "carry":
            run = lambda lib: lib.wmec_forward_carry_t1_wide(  # noqa: E731
                *ins, c0, k0, dp.data_ptr(), key.data_ptr(), scratch.data_ptr(), B, C, K, stream)
        else:
            run = lambda lib: lib.wmec_forward_t1_wide(  # noqa: E731
                *ins, c0, k0, pidx.data_ptr(), dp.data_ptr(), key.data_ptr(), scratch.data_ptr(), B, C, K, stream)
        print(f"{label} {mode}: B={B} C={C} K={K}", flush=True)
        for rnd, tag in enumerate(order):
            for name, lib in libs[tag].items():
                if run(lib) != 0:
                    raise RuntimeError(f"{tag}{name} {label} {mode}: launch failed")
                ms = cs._time(lambda: run(lib), reps=2)
                print(f"turn {rnd} {label:12s} {mode:20s} {tag}{name:24s} {ms:10.3f} ms "
                      f"{ms * 1e3 / C:9.2f} us per column", flush=True)
                if name == "phase clocks":
                    print_clocks(key, K, B, label, mode)
        del pidx, dp, key, scratch, arrays, carry, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
