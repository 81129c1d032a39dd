#!/usr/bin/env python3
"""
Where a launch's time goes in the wide genotyping kernels (the state in
device memory: whatshap_torch/csrc/geno_backward_wide.cu and
geno_forward_wide.cu over geno_wide.cuh, kernel rows 15-16), on one CUDA
card:

    python3 profile_geno_wide.py [--parent DIR]

The card's profilers are not at hand, so this builds variants of each
kernel's source under build/whatshap_torch/parts_geno_wide/, each with one
part switched off (their results are wrong and are not used): the exps,
the staging of a column's emission rows, the emission step, the transmission product, the
fold, the partial sums, the stores or loads of beta_store, the grid
barriers.  It times them with CUDA events against the unchanged kernel at
the instances of genotype-cli-fam5 (C = 4,009, K = 15, T = 64, P = 4) and
genotype-cli-cov20 (C = 8,120, K = 20, T = 1), built with
chip_smoke.write_synth and genotyped once through the CLI as
chip_smoke.geno_cli_wide builds them; a part's cost is the difference to
the unchanged kernel.  The backward is also timed at other window caps
(a launch argument: no build).  With --parent DIR the kernels of the
checkout in DIR (e.g. a `git archive` of the parent under build/) are
timed too, in turns with this one's: parent, kernel, kernel, parent.
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from whatshap_torch.ops import _build, genotyping, genotyping_cuda

HEADER = "geno_wide.cuh"
#: variant -> {file: [(text in this checkout's source, its replacement)]}
BWD = "geno_backward_wide.cu"
FWD = "geno_forward_wide.cu"
VARIANTS = {
    BWD: {
        "kernel": {},
        "no exps": {HEADER: [("expf(", "(")]},
        "no emission slice": {BWD: [("stage_slice<T, P>(s, a.K, diff_c, base_c);", "")]},
        "no emission step": {BWD: [("weigh<T, P>(s, g, X, Wt,", "if (false) weigh<T, P>(s, g, X, Wt,")]},
        "no product": {BWD: [("mat_product<T>(X, Wt, s, g, tr, true);", "")]},
        "no fold": {BWD: [("fold_tile(X, g, (uint32_t)s.meta[32 + w]);", "")]},
        "no beta_store stores": {BWD: [("__stcs(cur + (size_t)t * S + (cbase | s.off[l]), X[t * g.ps + l] * inv);",
                                        "")]},
        "no grid barriers": {BWD: [("grid.sync();", "")]},
    },
    FWD: {
        "kernel": {},
        "no exps": {HEADER: [("expf(", "(")]},
        "no emission slice": {FWD: [("stage_slice<T, P>(s, a.K, diff_c, base_c);", "")]},
        "no emission step": {FWD: [("emit<T, P>(s, g, A, SP, Bt,", "if (false) emit<T, P>(s, g, A, SP, Bt,")]},
        "no product": {FWD: [("mat_product<T>(SP, A, s, g, tr, false);", "")]},
        "no fold": {FWD: [("fold_tile(A, g, (uint32_t)s.meta[32 + w]);", "")]},
        "no beta_store loads": {FWD: [("cp_async4(Bt + t * g.ps + l,", "if (false) cp_async4(Bt + t * g.ps + l,")]},
        "no red sums": {FWD: [("if (j > 0) reduce_red(", "if (false) reduce_red(")]},
        "no grid barriers": {FWD: [("grid.sync();", "")]},
    },
}
PARENT_VARIANTS = {BWD: {"kernel": {}}, FWD: {"kernel": {}}}
#: applied to every variant of this checkout: only the instances the two
#: cells launch (T = 1 with P = 2, T = 64 with P = 2 and 4), for short builds
COMMON = [("    case 4: return launch_t<4>(a, P, max_ctas, stream);\n", ""),
          ("    case 16: return launch_t<16>(a, P, max_ctas, stream);\n", ""),
          ("    case 256: return launch_t<256>(a, P, max_ctas, stream);\n", ""),
          ("    case 6: return launch<T, 6>(a, max_ctas, stream);\n", ""),
          ("    case 8: return launch<T, 8>(a, max_ctas, stream);\n", "")]
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"geno_backward_wide": [_P] * 13 + [_I] * 7 + [_P], "geno_forward_wide": [_P] * 14 + [_I] * 7 + [_P]}
PARENT_SIGNATURES = {"geno_backward_wide": [_P] * 11 + [_I] * 6 + [_P],
                     "geno_forward_wide": [_P] * 12 + [_I] * 6 + [_P]}


def build_variants(csrc: Path, variants: dict, tag: str) -> dict:
    """Build each variant of csrc's two wide genotyping sources (the
    substitutions applied to copies of the source and the shared header)
    under build/whatshap_torch/parts_geno_wide/<tag>/, one nvcc each, all
    started together; returns {(source, variant): the loaded library}."""
    out = _build.BUILD_DIR / "parts_geno_wide" / tag
    nvcc = _build._nvcc()
    procs = {}
    for src, vs in variants.items():
        for i, (name, subs) in enumerate(vs.items()):
            d = out / f"{Path(src).stem}{i}"
            d.mkdir(parents=True, exist_ok=True)
            for fname in (src, HEADER):
                text = (csrc / fname).read_text()
                for a, b in subs.get(fname, []) + (COMMON if tag == "kernel" and fname == src else []):
                    if a not in text:
                        raise RuntimeError(f"variant {name!r}: {a!r} is not in {fname}")
                    text = text.replace(a, b)
                (d / fname).write_text(text)
            cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(d), "-I", str(csrc), "-o", str(d / "lib.so"), str(d / src)]
            procs[(src, name)] = (d / "lib.so", subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                                  stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (src, name), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {src} {name!r}:\n{log}")
        if name == "kernel":
            lines = [x.strip() for x in log.splitlines() if "registers" in x or "spill" in x or "Compiling" in x]
            print(f"{tag} {src}:\n  " + "\n  ".join(lines), flush=True)
        lib = ctypes.CDLL(str(so))
        fn = Path(src).stem
        getattr(lib, fn).argtypes = (SIGNATURES if tag == "kernel" else PARENT_SIGNATURES)[fn]
        getattr(lib, fn).restype = ctypes.c_int
        libs[(src, name)] = lib
    return libs


def instance(tmp, label, n_vars, coverage, seed, **kwargs):
    """The largest instance of a genotype CLI cell, on the card, as
    chip_smoke.geno_cli_wide builds it (the CLI runs once on the card)."""
    _l, (static, stacked) = cs.geno_cli_wide(tmp, label, n_vars, coverage, plain=False, seed=seed, **kwargs)
    return static, genotyping.to_device(stacked, torch.device("cuda"))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_geno_wide: no CUDA device available", file=sys.stderr)
        return 1
    parent = Path(sys.argv[sys.argv.index("--parent") + 1]) if "--parent" in sys.argv else None
    libs = {}
    if parent is not None:
        libs["parent "] = build_variants(parent / "whatshap_torch" / "csrc", PARENT_VARIANTS, "parent")
    libs[""] = build_variants(_build.CSRC, VARIANTS, "kernel")
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.strip()
    print(power, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cells = {
            "fam5": instance(tmp, "genotype-cli-fam5", cs.GENO_FAM5_VARIANTS, 5, 31, synth=dict(trio=True, children=3),
                             atol=3e-4, min_concordance=cs.GENO_FAM5_CONCORDANCE,
                             shape_ok=lambda K, T, P: (T, P) == (64, 4)),
            "cov20": instance(tmp, "genotype-cli-cov20", cs.GENO_COV20_VARIANTS, 22, 37, synth=dict(mixed=True),
                              atol=2e-4, min_concordance=0.9, max_coverage=20,
                              shape_ok=lambda K, T, P: T == 1 and K > 17),
        }
    stream = torch.cuda.current_stream().cuda_stream
    order = list(libs) + list(reversed(libs))
    for cell, ((K, T, P, _n), x) in cells.items():
        diff, base, passign, trans, birth, die_next, dup = x
        B, C, S = diff.shape[0], diff.shape[1], 1 << K
        dev = diff.device
        max_ctas = genotyping_cuda.wide_max_ctas(dev, B, K, T)
        beta, scaling = genotyping_cuda.backward_wide(K, T, P, diff, base, passign, trans, birth, dup)
        red = torch.empty((B, C, T << P), dtype=torch.float32, device=dev)
        alpha = torch.empty((B, T, S), dtype=torch.float32, device=dev)
        masks = torch.empty((B, C), dtype=torch.int32, device=dev)
        cols = torch.empty((3, C), dtype=torch.int32, device=dev)
        wf = genotyping_cuda.wide_window_cap(T, P, backward=False)
        wb = genotyping_cuda.wide_window_cap(T, P, backward=True)
        part = torch.empty(2 * genotyping_cuda.WIDE_WINDOW * (max_ctas + B) * (T << P) + 4, dtype=torch.float32,
                           device=dev)
        ins = [t.data_ptr() for t in (diff, base, passign, trans)]
        beta_out = torch.empty_like(beta)
        scal_out = torch.empty_like(scaling)
        pt = [masks.data_ptr(), cols[0].data_ptr(), cols[1].data_ptr(), cols[2].data_ptr(), part.data_ptr()]
        windows = (sum(1 for w in genotyping_cuda.wide_windows(genotyping_cuda.wide_unions(birth, True),
                                                               genotyping_cuda.wide_lb(K, T), wb) if w),
                   sum(1 for w in genotyping_cuda.wide_windows(genotyping_cuda.wide_unions(die_next, False),
                                                               genotyping_cuda.wide_lb(K, T), wf) if w))
        print(f"{cell}: B={B} C={C} K={K} T={T} P={P}; window caps {wb} / {wf}: {windows[0]} backward, "
              f"{windows[1]} forward windows", flush=True)

        def bwd(lib, tag, cap):
            if tag:
                return lib.geno_backward_wide(*ins, birth.data_ptr(), dup.data_ptr(), beta_out.data_ptr(),
                                              scal_out.data_ptr(), pt[0], pt[1], pt[4], B, C, K, T, P, max_ctas,
                                              stream)
            return lib.geno_backward_wide(*ins, birth.data_ptr(), dup.data_ptr(), beta_out.data_ptr(),
                                          scal_out.data_ptr(), *pt, B, C, K, T, P, cap, max_ctas, stream)

        def fwd(lib, tag, cap):
            if tag:
                return lib.geno_forward_wide(*ins, die_next.data_ptr(), scaling.data_ptr(), beta.data_ptr(),
                                             red.data_ptr(), alpha.data_ptr(), pt[0], pt[1], pt[4], B, C, K, T, P,
                                             max_ctas, stream)
            return lib.geno_forward_wide(*ins, die_next.data_ptr(), scaling.data_ptr(), beta.data_ptr(),
                                         red.data_ptr(), alpha.data_ptr(), *pt, B, C, K, T, P, cap, max_ctas, stream)

        for rnd, tag in enumerate(order):
            for (src, name), lib in libs[tag].items():
                run, caps = (bwd, (wb,)) if src == BWD else (fwd, (wf,))
                if src == BWD and name == "kernel" and not tag:
                    caps = tuple(sorted({wb, 1, 4, 16}))
                for cap in caps:
                    if run(lib, tag, cap) != 0:
                        raise RuntimeError(f"{tag}{src} {name} cap {cap}: launch failed")
                    ms = cs._time(lambda: run(lib, tag, cap), reps=2)
                    what = f"{tag}{Path(src).stem} {name}" + (f" (cap {cap})" if len(caps) > 1 else "")
                    print(f"turn {rnd} {cell:5s} {what:55s} {ms:10.3f} ms {ms * 1e3 / C:9.2f} us per column",
                          flush=True)
        del beta, beta_out, x, diff
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
