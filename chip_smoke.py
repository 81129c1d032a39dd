#!/usr/bin/env python3
"""
Drive the PyTorch/CUDA port (whatshap_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, every one of which must pass:

1. build    nvcc builds every kernel from whatshap_torch/csrc, one process per
            source, all started together; then g++ builds the host helpers
            from whatshap_torch/csrc/host (the BAM pool, the CIGAR and
            realignment engine, the edit distances, read selection and its
            heap, the HapCHAT and PedMEC-heuristic solvers, the switch/flip
            distance, polyphase's cluster editing, haplotype threading and
            read-pair scoring: whatshap_torch.hostlib), one process per
            source, and the build time is printed.
2. kernels  on the card, each kernel is held bit-equal against its plain
            torch version on the same CUDA tensors: the T=1 kernels at K = 7
            to 17 (B = 4 blocks of C = 256 columns: the forward kernel's
            narrow layout) and K = 12, 15, 17 (B = 12: its wide one); the carry
            kernels (kernel row 9) and the tables kernels from a carry (row
            10), from the nonzero state after the first 64 columns of B = 3
            blocks of C = 192, at T = 1, K = 7, 10, 14, 15, 16, 17; T = 4, K
            = 3, 4, 7, 9, 12, 15, 16; T = 16, K = 4, 7, 9, 13; the general-T
            kernels (tables mode unseeded and seeded, m-only mode, backtrace
            at M = 1 and M = T + 1) at T = 4, K = 3, 4, 7, 9, 10, 12, 15, 16
            and T = 16, K = 4, 7, 9, 10, 13 (B = 4 blocks of C = 128
            columns); half the blocks with weights above 256.  Every mode of
            the general-T forward kernel again on a tie-heavy bucket
            (weights, rankw and assignment costs in {0, 1}, a quarter of the
            slots dying each column) at K = 1 to 16 (T = 4) and 1 to 13
            (T = 16), P = 2 and 4: its cluster layout's boundaries, fewer
            than 32 states, one CTA, the first cluster, the top of the
            envelope; likewise both modes of the T=1 forward kernel (tables
            from zero, carry, tables from the carry) at K = 1, 4, 5, 9, 10,
            13 to 17 (B = 3, narrow layout) and 11, 12, 15, 16, 17 (B = 9,
            wide layout).  Row 13, the T=1 kernel with its state in device
            memory (csrc/wmec_forward_t1_wide.cu), which forward_t1 and
            forward_carry_t1 take past K = 17: bit-equal to its plain
            versions at K = 18 to 23 (B = 2) in both modes, from zero and
            from a nonzero carry, on packed and tie-heavy buckets, the
            backtrace over its tables too; and bit-equal to the cluster
            kernel (rows 1, 9, 10) at K = 7 to 17.  Row 14, the general-T
            kernel with its T planes in device memory
            (csrc/wmec_forward_t_wide.cu), which forward_t, forward_m_t and
            forward_carry_t take past the cluster kernel's envelope: every
            mode bit-equal to its plain version on simulated pedigree buckets
            (a trio at K = 17 and 21, a quartet at K = 14, three children at
            K = 9 and 15, four children at K = 8, three founders (P = 6) and
            four (P = 8)) with the backtrace at M = 1 and T + 1 over its
            tables, and on tie-heavy buckets at T = 4, 16, 64, 256 and P = 4,
            6, 8 (to pedigree-p6's K = 15 at P = 6); and bit-equal to the
            cluster kernel (rows 3, 4, 6, 7, 9, 10) at T = 4, K = 7, 12, 16
            and T = 16, K = 9, 13.  The genotyping kernels (backward
            and forward, one thread-block cluster per instance) against
            their float32 plain versions at T = 1, K = 3, 7, 10, 12, 15, 16,
            17 (K = 15 and 17 also in clusters of 8 CTAs); T = 4, K = 7, 12,
            15, 16; T = 16, K = 7, 10, 13 (B = 4 simulated instances of C =
            128 columns, one with a zero-sum prior column), folds at every
            level of the state index (register, lane, warp and CTA bits,
            the top CTA-rank bit included) at K = 15 and 17: red and
            scaling within rtol 1e-4, likelihoods within atol 1e-5,
            identical NaN patterns.  Rows 15-16, the genotyping kernels with
            the state in device memory (csrc/geno_backward_wide.cu,
            csrc/geno_forward_wide.cu), which backward and forward take past
            the cluster kernels: held to their float32 plain versions with
            the same bars at T = 1, K = 18, 20, 23; T = 4, K = 17, 20; T =
            16, K = 14; three founders (T = 16, P = 6, K = 12), four (P = 8,
            K = 10); three children (T = 64, K = 9 and 15), four (T = 256,
            K = 8); four trios of four founders (T = 256, P = 8, K = 6) (B =
            3 instances of 64-128 columns, one with a zero-sum prior column,
            one with a new range whose slots are all born: further fold
            passes), and to the cluster kernels at T = 1, K = 7 and 17; T =
            4, K = 12 and 16; T = 16, K = 13.  Both backtraces, bit for bit, also on
            random tables that break the forward's shape (whole, or in 5 %
            of the entries of shaped ones; random masks, half of them
            empty) at T = 1, 4, 16, 64, 256, K up to 20, M = 1 and T + 1, narrow and
            wide launches, and on forward tables of tie-heavy buckets where
            2 % of the slots die before each column.
3. slice    the single-sample main path: a chromosome of 256 blocks x 512
            heterozygous variants at coverage 15 (K = 15) phased by
            PedigreeDPTable(device="cuda"), with the kernels' launch counters
            set to 0 just before and read just after; cost, partitioning and
            index paths must equal the plain torch route's on the card, and
            the superreads must recover the simulated haplotypes.  A second
            run, with its solves timed between synchronisations, splits the
            wall time into pack / prep+H2D / kernels / D2H / extract.
4. single   one read-connected block of 4096 columns at coverage 15 through
            the single-block route (B = 1), checked the same way.
5. trio     the pedigree path: a simulated trio chromosome of 64 blocks x 256
            variants, heterozygous in at least one individual, reads at
            coverage 5 per individual (K = 15), recombination cost 10 per
            column and one recombination per parent in a few blocks, phased
            by PedigreeDPTable(device="cuda") through the seam route (pass 1
            m-only scans, host chain, pass 2 seeded scans with tables and
            multi-walk backtrace); checked as the slice, transmission paths
            included, for every individual's superreads.
6. trio-single  one read-connected trio range of 2048 columns (K = 15)
            through the single-block route, checked the same way.
7. quartet  two trios with shared parents (T = 16, four symmetry cosets),
            16 blocks x 128 columns at coverage 3 per individual, checked
            against the plain route.  pedigree-p6: a three-generation
            pedigree with three founders (P = 6, T = 16, two cosets), 16
            blocks x 128 columns at coverage 3 (K = 15), through row 14 and
            the backtrace, checked the same way.
8. genotype one simulated sample of 32,768 variants (hom and het) at
            coverage 15 (K = 15), priors from compute_genotypes over its
            reads, through GenotypeDPTable(device="cuda") as one instance
            (B = 1), one launch of each genotyping kernel expected; a time
            split pack / prepare / h2d / kernels / d2h+marginals, GT
            concordance with the simulation, and a 2,048-column instance of
            the same generator against the float64 plain route on the card
            (atol 2e-4).  genotype-trio: a trio of 8,192 variants at coverage
            5 each (K = 15, T = 4, P = 4), checked the same way on 1,024
            columns (atol 3e-4).
9. segmented  the segmented (checkpoint and recompute) solve of one
            read-connected range whose tables exceed the table budget,
            through PedigreeDPTable(device="cuda") with the budget pinned at
            768 MiB: segmented, one block of 32,768 heterozygous columns at
            coverage 15 (K = 15, 16 segments of 2,048); segmented-trio, a
            trio range of 8,192 columns at coverage 5 each (K = 15, T = 4,
            16 segments of 512); segmented-k17, 2,048 columns at coverage 17
            (K = 17, 2 segments of 1,024).  Each must launch the carry
            kernel, the tables kernel and the backtrace once per segment and
            nothing else, agree with the unsegmented single-block route on
            the card at the default budget (cost, partitioning, index and
            transmission paths) and recover the simulated haplotypes; a
            second run splits the time into pack / carry pass / tables +
            backtrace pass / d2h / extract; both routes' peak device memory
            is printed.  segmented-k23: 2,048 columns at coverage 23 (K =
            23) at the default budget, which its 64 GiB of unsegmented
            tables exceed: 32 segments of 64 (the reference's XLA-route
            rule), one launch of row 13's carry mode, its tables mode from a
            carry and the backtrace a segment, equal to the plain route on
            the card (cost, partitioning, index path); it prints the largest
            single range at K = 23 the budget admits.  segmented-trio-wide:
            a trio range of 1,024 columns at coverage 6 each (K = 18, T = 4,
            past the cluster kernel) with the budget pinned: 16 segments of
            64 (the XLA-route rule) in row 14's two modes, also equal to the
            plain route on the card.
10. host     the host helpers on an 8,192-variant file of phase-cli's
            generator (below), each held to the Python path it replaces (the
            hostlib attributes set to None, python_host_paths): every record
            of the BAM pool decode against the Python record loop, the reads
            of ReadSetReader.read through the realignment pool against the
            Python realignment, and readselection in one call against the
            Python selection, each with both times; then the phase CLI on
            that file through the helpers and through the Python paths:
            byte-identical VCFs, both runs' stages printed.
    phase-cli  the phase CLI on files, as a user runs it: a synthetic
            chromosome of 100,000 heterozygous SNVs (spacing 150, coverage
            14, ~30 variants a read, 2 % allele errors, a break every 64
            variants; reference FASTA, BAM and VCF written by this script
            with the port's BAM writer) phased by
            whatshap_torch.cli.phase.run_whatshap(device="cuda") with
            realignment against the FASTA.  It prints variants phased/s over
            the whole call, the stage times, the PedigreeDPTable calls and
            the kernel launches per call, and the switch-error rate against
            the simulated haplotypes (below 5 %); the VCF must be
            byte-identical to a second run with the plain torch route handed
            in through run_dp's seams (no kernel launched in it).  Every
            CLI cell's stage line carries the card's name and power limit and
            the host's CPU count; the BAM pool cache is cleared before each
            timed CLI run, so that read_bam is charged its whole decode.
11. phase-cli-trio  the same for a trio of 8,192 variants at coverage 5 a
            sample (one BAM with three read groups, a PED file; the child
            inherits with a crossover at a window boundary with probability
            0.2), through the seam route.  phase-cli-ds23: phase-cli's
            generator (32,768 variants) at coverage 30, phased with
            --internal-downsampling 23
            (the CLI's ceiling): wall, stages, the solve's device time,
            variants/s, the ranges by K (most past K = 17, in row 13) and
            the switch-error rate beside a run at the default 15 on the same
            files; the byte-identical comparison with the plain route runs
            on an 8,192-variant file of the same generator (the plain route
            at K = 23 over the whole file does not fit the time limit).
            phase-cli-fam5: a family of two parents and three children
            (T = 64, P = 4; five read groups, a PED file), 8,192 variants at
            coverage 5 a sample at the default --max-coverage 15: row 14 in
            both passes of the seam route; wall, stages, device time, the
            ranges by (K, T), switch-error rate below 5 %, and the VCF
            byte-identical to the plain route's on a 512-variant file of the
            generator.  phase-cli-trio-ds23: a trio of 2,048 variants at
            coverage 8 a sample with --internal-downsampling 23 (K up to 21
            at T = 4), byte-identical to the plain route.
11b. tools  the subcommands that follow phase, on an 8,192-variant file of
            phase-cli's generator: phase on the card (rows 1-2 launched),
            then compare against a truth VCF of the simulated haplotypes
            (switch-error rate under 5 %), stats (blocks, N50), haplotag
            (HP on at least 0.9 of the reads over two or more heterozygous
            sites, agreeing with each read's haplotype of origin in at least
            0.95 of the tagged reads within each phase set, up to a swap),
            split by haplotag's list (the counts add up), unphase (the
            input's genotypes back), and phase --algorithm heuristic (the 5 %
            gate) and --algorithm hapchat (on one read-connected block of
            1,024 variants: HapCHAT phases only a chromosome's first block;
            the 5 % gate); then the host solvers' libraries (hapchatlib,
            heurlib, switchfliplib) against their Python paths, equal
            outputs.  Each tool's wall time is printed with the card's name,
            power limit and the host's CPU count.
11c. polyphase  polyploid phasing, which runs on the host alone (no device
            work, as in the reference): `python -m whatshap_torch polyphase`
            on the committed fixtures tests/data/polyploid.chr22.42M.12k (42
            variants at ploidy 4; --threads 1, and --threads 4 through the
            spawn pool) and tests/data/polyploid.indels, each VCF equal, but
            for its ##commandline line, to an in-process run at one thread
            on the Python paths (python_host_paths), the three commands
            started at once; before them read-pair scoring (scorelib),
            cluster editing (clusterlib) and threading (threadlib) on a
            synthetic tetraploid block of 300 variants and 600 reads, each
            against its Python path (equal results); and polyphase-chrom, a
            synthetic tetraploid chromosome of 4,000 SNVs at coverage 48
            (6,400 reads of 30 variants), run_polyphase at one thread
            through the libraries, its VCF byte-equal to a run on the Python
            paths in a process of its own, started after the host build
            (it runs beside phase 2, which times nothing on the host).
            Each run's wall (polyphase-chrom's with its stages) and each
            library's time beside its Python path's are printed with the
            card's name, power limit and the host's CPU count.
12. genotype-cli  the genotype CLI on files, as a user runs it: the same
            generator's chromosome of 100,000 SNVs at coverage 14 with mixed
            genotypes (its two haplotypes drawn independently: hom ref, het
            and hom alt 1:2:1), re-genotyped with priors by
            whatshap_torch.cli.genotype.run_genotype(device="cuda") with
            realignment against the FASTA.  It prints variants genotyped/s
            over the whole call, the stage times, the device time of the
            forward-backward calls (CUDA events) and the card's idle share,
            the GenotypeDPTable calls with the launches (one of each
            genotyping kernel per call, no plain version, no wMEC kernel),
            the table budget at each call with the columns it admits, and
            the GT concordance with the simulation (above 0.9); the VCF must
            meet the reference's own CLI bar (tests/test_geno_backends_cli.py:
            GT exact, GL within 5e-3) against a second run with the float64
            plain route on the card handed in, and GQ exact except where a
            difference of 1 is f32 rounding at a half-integer, or where both
            GQs are 300 or more (the f32 flush-to-zero edge at which the
            reference's bar counts GLs as equal; each such site printed with
            both unrounded values).
13. genotype-cli-trio  the same on phase-cli-trio's files (8,192 variants,
            a trio at coverage 5 a sample, its PED file); its concordance
            gate is 0.85, since at that coverage the reference's own host
            engine recovers only 0.859-0.899 of these files' genotypes.
    genotype-cli-fam5  the genotype CLI past the cluster kernels: a family
            of two parents and three children (T = 64, P = 4), 4,096
            variants at coverage 5 a sample, at the default --max-coverage
            15 (K up to 15): one launch of each wide genotyping kernel
            (rows 15-16) per GenotypeDPTable call, no plain version, no
            cluster genotyping kernel and no wMEC kernel; wall, stages,
            device time, idle share, budget and concordance printed (gate
            0.85, from its cut's 0.887-0.934 on the float64 plain route).
            The float64 plain route cannot hold the whole file's beta table,
            so its CLI bar runs on a 512-variant file of the generator
            (genotype-cli-fam5-512).  genotype-cli-cov20: one sample of
            8,192 mixed-genotype variants at coverage 22 genotyped at
            --max-coverage 20 (K up to 20), checked the same way, its CLI
            bar on genotype-cli-cov20-512.  There GQs of 300 or more on both
            routes count as equal: the wrong genotypes' likelihoods are
            below 1e-30, where the float32 routes flush to zero and the
            reference's bar counts GLs as equal.
14. timing  the main paths' largest buckets copied to the card, and each
            kernel at its shape (CUDA events), beside its plain version and
            its bound: the T=1 kernels at the phase CLI's bucket (the
            kernels line's rows 1-2), the slice's bucket and the single block
            (B = 1, C = 4096), each with its cluster layout and microseconds
            per column; the general-T kernels at the phase-cli-trio's bucket
            (the kernels line's rows 6-8) and the trio's, the tables
            kernel and backtrace also at the trio-single shape, the
            genotyping kernels at the genotype and genotype-trio shapes (the
            kernels line's rows 11-12 at the genotype cell's)
            (with the CTAs per cluster, the SMs used and the share of the
            bound), rows 9 and 10 at the segments' shapes (B = 1; C = 2048,
            K = 15, T = 1 and C = 512, K = 15, T = 4); each forward mode
            with its cluster layout and microseconds per column.  Both
            backtraces at every shape the cells launch them at (the slice's
            and the trio's buckets, the single block, trio-single, the
            quartet's bucket, a segment of each segmented cell), warm and
            from a flushed L2, each beside its bytes bound, the card's
            gather latency (profile_backtrace.py's probe) and the round
            trips a column its walk takes (wmec_cuda.backtrace_rounds).
            Row 13 at a bucket of 16 blocks x 64 columns at K = 20 (the
            kernels line), at one launch of phase-cli-ds23's main bucket,
            and in both passes at a segment of segmented-k23.  Row 14 at one
            launch of phase-cli-fam5's main bucket as the route chunks it
            under the table budget (wide-t64, the kernels line): the m-only
            mode over each block's 16 coset seeds, the seeded tables mode,
            the carry mode and the tables mode from that carry; and in both
            passes at a segment of segmented-trio-wide.  Rows 15-16 at the
            instances of genotype-cli-fam5 (the kernels line) and
            genotype-cli-cov20, beside their float32 plain versions on the
            first 64 columns and their bounds.
15. last   15a: wmec.forward_cost_batched (the costs-only forward from the
            initial state, kernel row 17) on the card against its plain
            version, bit for bit on all three outputs (cost, jmin, key), at
            T = 1, K = 7, 15, 17 and 20 (row 13's carry mode); T = 4, K = 12
            and 16; T = 16, K = 13; T = 64, K = 15 (row 14's): one launch of
            the shape's carry kernel and no other, every plain version made
            to raise.  15b: parallel/dryrun.py's dryrun_multichip(4) over
            cuda:0 x 4 (one card: the shards run one after another through
            the split, copies and gather of the sharded launches): sharded
            solves and costs-only forwards of a single-sample and a trio
            batch against serial solves, then the phase CLI with every
            batched launch sharded, byte-identical to one device; its time
            and launches printed (the kernels line reads row 17's launches
            there).  15c: find_snv_candidates on tests/data/pacbio (the
            records of tests/data/expected-calls.vcf), learn on
            tests/data/short-genome/learn-data (expected.txt), and
            polyphasegenetic (--sample Parent_A, a PED of 24 progeny) whose
            records hash to the reference's (POLYPHASEGENETIC_RECORDS_SHA256);
            host only, each wall printed.  Row 17 is timed in phase 14 at
            the slice's bucket (the kernels line) and at entry()'s batch.

It prints the card's name and power limit, a {"kernels": [...]} line, and as
its last line {"ok": true, "device": {...}}.  Where there is no CUDA device,
or when a phase fails, it exits non-zero and prints no result.
"""

import contextlib
import functools
import json
import io
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import whatshap_torch.core as core
from whatshap_torch import hostlib
from whatshap_torch.io.sam import clear_bam_pool_cache
from whatshap_torch.ops import _build, genotyping, genotyping_cuda, wmec, wmec_cuda
from whatshap_torch.parallel import blocks

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and int32
# adds/s.  The float32 peak of 67e12 operations/s counts a multiply-add on each
# of an SM's 128 f32 lanes as two; Hopper has 64 int32 lanes per SM, so one add
# per int32 lane per clock is a quarter of it.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_ADDS_PER_S = 67e12 / 4
# f32 adds: one per f32 lane and clock, half the 67e12 FLOP/s of the data
# sheet (which counts a multiply-add as two).  exp: the special-function
# units return 16 results per clock per SM on compute capability 9.0 (CUDA C
# Programming Guide, arithmetic instruction throughput), times 132 SMs at
# the 1.98 GHz boost clock (data sheet).
PEAK_F32_ADDS_PER_S = 67e12 / 2
PEAK_EXP_PER_S = 16 * 132 * 1.98e9
# float32 multiply-adds on the tensor cores at float32's accuracy: the
# data sheet's 495e12 dense TF32 FLOP/s (two a multiply-add), a third of
# them in the 3xTF32 split (three TF32 products a float32 product)
PEAK_TF32X3_MACS_PER_S = 495e12 / 2 / 3

WRAPPERS = {
    "wmec_forward_t1": wmec_cuda.forward_t1,
    "wmec_forward_carry_t1": wmec_cuda.forward_carry_t1,
    "wmec_forward_t1_wide": wmec_cuda.forward_t1_wide,
    "wmec_forward_carry_t1_wide": wmec_cuda.forward_carry_t1_wide,
    "wmec_backtrace_t1": wmec_cuda.backtrace_t1,
    "wmec_forward_t": wmec_cuda.forward_t,
    "wmec_forward_carry_t": wmec_cuda.forward_carry_t,
    "wmec_forward_m_t": wmec_cuda.forward_m_t,
    "wmec_backtrace_t": wmec_cuda.backtrace_t,
    "wmec_forward_t_wide": wmec_cuda.forward_t_wide,
    "wmec_forward_m_t_wide": wmec_cuda.forward_m_t_wide,
    "wmec_forward_carry_t_wide": wmec_cuda.forward_carry_t_wide,
    "geno_backward": genotyping_cuda.backward,
    "geno_forward": genotyping_cuda.forward,
    "geno_backward_wide": genotyping_cuda.backward_wide,
    "geno_forward_wide": genotyping_cuda.forward_wide,
}
# The kernels line: (entry, source, the TPU kernel it replaces).  Rows 9
# and 10 at T = 1 and T > 1 are entries of their own; an entry's launches
# are read on the path that runs it (rows 9 and 10 on the segmented phases,
# where forward_t1 and forward_t launch only from a carry).  Row 13, the T=1
# kernel with its state in device memory, replaces the reference's XLA scan
# past its Pallas envelope: with tables from zero as solve_batched and
# _solve_scan run it (read on phase-cli-ds23), and in the segmented solve's
# two passes (read on segmented-k23).  Row 14, the general-T kernel with its
# T planes in device memory, replaces the same XLA scan past the Pallas
# envelope at T > 1: with tables as solve_batched and solve_seeded_batched
# run it and m-only as forward_m_batched does (read on phase-cli-fam5), and
# in the segmented solve's two passes (read on segmented-trio-wide).  Rows
# 15-16, the genotyping kernels with the state in device memory, replace the
# reference's XLA forward-backward past its Pallas envelope (read and timed
# on genotype-cli-fam5).
ENTRIES = [
    ("wmec_forward_t1", "wmec_forward_t1", "whatshap_tpu/ops/wmec_pallas.py:73"),
    ("wmec_backtrace_t1", "wmec_backtrace_t1", "whatshap_tpu/ops/wmec_pallas.py:626"),
    ("wmec_forward_t", "wmec_forward_t", "whatshap_tpu/ops/wmec_pallas.py:73"),
    ("wmec_forward_m_t", "wmec_forward_t", "whatshap_tpu/ops/wmec_pallas.py:73"),
    ("wmec_backtrace_t", "wmec_backtrace_t", "whatshap_tpu/ops/wmec_pallas.py:660"),
    ("wmec_forward_carry_t1", "wmec_forward_t1", "whatshap_tpu/ops/wmec_pallas.py:967"),
    ("wmec_forward_t1:carry_in", "wmec_forward_t1", "whatshap_tpu/ops/wmec_pallas.py:1024"),
    ("wmec_forward_carry_t", "wmec_forward_t", "whatshap_tpu/ops/wmec_pallas.py:967"),
    ("wmec_forward_t:carry_in", "wmec_forward_t", "whatshap_tpu/ops/wmec_pallas.py:1024"),
    ("geno_backward", "geno_backward", "whatshap_tpu/ops/genotyping_pallas.py:117"),
    ("geno_forward", "geno_forward", "whatshap_tpu/ops/genotyping_pallas.py:182"),
    ("wmec_forward_t1_wide", "wmec_forward_t1_wide", "whatshap_tpu/ops/wmec.py:514"),
    ("wmec_forward_carry_t1_wide", "wmec_forward_t1_wide", "whatshap_tpu/ops/wmec.py:679"),
    ("wmec_forward_t1_wide:carry_in", "wmec_forward_t1_wide", "whatshap_tpu/ops/wmec.py:687"),
    ("wmec_forward_t_wide", "wmec_forward_t_wide", "whatshap_tpu/ops/wmec.py:514"),
    ("wmec_forward_m_t_wide", "wmec_forward_t_wide", "whatshap_tpu/ops/wmec.py:796"),
    ("wmec_forward_carry_t_wide", "wmec_forward_t_wide", "whatshap_tpu/ops/wmec.py:679"),
    ("wmec_forward_t_wide:carry_in", "wmec_forward_t_wide", "whatshap_tpu/ops/wmec.py:687"),
    ("geno_backward_wide", "geno_backward_wide", "whatshap_tpu/ops/genotyping_jax.py:214"),
    ("geno_forward_wide", "geno_forward_wide", "whatshap_tpu/ops/genotyping_jax.py:237"),
    # row 17, forward_cost_batched: the carry kernels from a zero carry (at
    # the slice's bucket, T = 1 and K = 15, the T = 1 kernel's carry mode)
    ("forward_cost_batched", "wmec_forward_t1", "whatshap_tpu/ops/wmec.py:916"),
    # the same kernels at five trios (":t1024", T = 1024: phase-cli-fam7,
    # genotype-cli-fam7) and five founders (":p10", P = 10: pedigree-p10)
    *((f"{name}:{tag}", source, replaces)
      for tag in ("t1024", "p10")
      for name, source, replaces in (
          ("wmec_forward_t_wide", "wmec_forward_t_wide", "whatshap_tpu/ops/wmec.py:514"),
          ("wmec_forward_m_t_wide", "wmec_forward_t_wide", "whatshap_tpu/ops/wmec.py:796"),
          ("wmec_backtrace_t", "wmec_backtrace_t", "whatshap_tpu/ops/wmec_pallas.py:660"),
          ("geno_backward_wide", "geno_backward_wide", "whatshap_tpu/ops/genotyping_jax.py:214"),
          ("geno_forward_wide", "geno_forward_wide", "whatshap_tpu/ops/genotyping_jax.py:237"),
      )),
]
CARRY_KERNELS = ("wmec_forward_carry_t1", "wmec_forward_carry_t", "wmec_forward_carry_t1_wide",
                 "wmec_forward_carry_t_wide")
# T = 1 past the cluster kernel's ceiling (wmec_cuda.MAX_K): the shapes the
# wide kernel is held to its plain version at, (K, blocks)
WIDE_SHAPES = tuple((K, 2) for K in range(wmec_cuda.MAX_K + 1, wmec_cuda.MAX_K_WIDE + 1))
# T > 1 past the general-T cluster kernel's envelope (row 14): (T, K) of
# simulated pedigree buckets (a trio up to the trio CLI's K = 21 at
# --internal-downsampling 23, a quartet, three children to phase-cli-fam5's
# K = 15, four children), and (T, K, P) of tie-heavy buckets
WIDE_T_PEDIGREE_SHAPES = ((4, 17), (4, 21), (16, 14), (64, 9), (64, 15), (256, 8))
WIDE_T_TIE_SHAPES = ((4, 17, 4), (4, 21, 4), (16, 14, 4), (16, 9, 6), (16, 15, 6), (16, 8, 8), (64, 5, 4),
                     (64, 15, 4), (256, 3, 8), (256, 9, 4))
# five trios (T = 1024) and five founders (P = 10) on tie-heavy buckets,
# (T, K, P) at K 6 to 10
FIVE_TIE_SHAPES = ((1024, 6, 4), (1024, 7, 10), (256, 9, 10), (16, 8, 10))
# the phase CLI cells: the first half of the chr1-style chromosome of
# BASELINE.json (100,000 SNVs at coverage 14; the genotype CLI's the same
# with mixed genotypes) and a trio of 8,192 SNVs at coverage 5 a sample
CLI_VARIANTS = 100_000
GENO_CLI_VARIANTS = 100_000
CLI_TRIO_VARIANTS = 8192
# the host phase's CLI comparison through the helpers and the Python paths
HOST_CUT_VARIANTS = 8192
# the tools phase: phase-cli's generator at 8,192 variants, and one
# read-connected block of 1,024 variants (HapCHAT phases only the first block
# of a chromosome) for hapchat and for the host solvers' Python paths
TOOLS_VARIANTS = 8192
TOOLS_BLOCK_VARIANTS = 1024
# the polyphase phase: the committed fixtures (file stem, ploidy, --threads),
# and the synthetic block the libraries are timed on (variants, reads)
POLYPHASE_RUNS = (("polyploid.chr22.42M.12k", 4, 1), ("polyploid.chr22.42M.12k", 4, 4),
                  ("polyploid.indels", 4, 1))
POLYPHASE_BLOCK = (300, 600)
# polyphase-chrom: a synthetic tetraploid chromosome (variants, coverage,
# seed), phased in process on the libraries and, in a process of its own
# started after the host build, on the Python paths
POLYPHASE_CHROM = (4000, 48, 61)
# the child processes this script starts, stopped when it ends
CHILDREN = []
SINGLE = (1, ())
TRIO = (3, ((0, 1, 2),))
QUARTET = (4, ((0, 1, 2), (0, 1, 3)))
# past the general-T cluster kernel: a three-generation pedigree with three
# founders (P = 6, T = 16), two trios of four founders (P = 8, T = 16), and
# families of two parents with three and four children (T = 64 and 256)
DOUBLE_TRIO = (5, ((0, 1, 2), (2, 3, 4)))
FOUR_FOUNDERS = (6, ((0, 1, 4), (2, 3, 5)))
FAMILY5 = (5, ((0, 1, 2), (0, 1, 3), (0, 1, 4)))
FAMILY6 = (6, ((0, 1, 2), (0, 1, 3), (0, 1, 4), (0, 1, 5)))
# four trios of four founders (T = 256, P = 8)
FOUR_TRIOS = (8, ((0, 1, 4), (2, 3, 5), (0, 1, 6), (2, 3, 7)))
# five trios or five founders: two parents and five children (T = 1024,
# P = 4); two grandparent couples, their two children, an in-law and two
# grandchildren (four trios of five founders: T = 256, P = 10); five trios of
# five founders (T = 1024, P = 10)
FAMILY7 = (7, tuple((0, 1, c) for c in range(2, 7)))
FIVE_FOUNDERS = (9, ((0, 1, 4), (2, 3, 5), (4, 5, 7), (4, 6, 8)))
FIVE_BY_FIVE = (10, ((0, 1, 5), (2, 3, 6), (5, 6, 7), (4, 7, 8), (4, 7, 9)))


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def _het_pedigree(n_cols: int):
    ped = core.Pedigree(core.NumericSampleIds())
    het = core.Genotype([0, 1])
    ped.add_individual("sample", [het] * n_cols, None)
    return ped


def chromosome(n_blocks: int, n_cols: int, coverage: int, seed: int):
    """A ReadSet of `n_blocks` synthetic blocks (make_synthetic_readset with
    seeds seed, seed+1, ...), shifted so that they do not overlap.  Returns
    (readset, positions, truth): truth (2, len(positions)) holds, per
    position, the block it lies in and the simulated haplotype's allele."""
    rs = core.ReadSet()
    haps = []
    stride = (n_cols + 100) * 10
    for b in range(n_blocks):
        sub, _positions, hap = blocks.make_synthetic_readset(
            n_cols, coverage, read_len=12, seed=seed + b
        )
        haps.append(hap)
        for read in sub:
            r = core.Read(f"b{b}_{read.name}", 50, 0, 0)
            for v in read:
                r.add_variant(v.position + b * stride, v.allele, v.quality)
            rs.add(r)
    rs.sort()
    positions = rs.get_positions()
    pos = np.asarray(positions)
    block = pos // stride
    col = (pos % stride) // 10 - 1
    truth = np.stack([block, np.asarray(haps)[block, col]])
    return rs, positions, truth


def packed_bucket(n_blocks, n_cols, K, seed, device):
    """Stacked device arrays of `n_blocks` synthetic single-range blocks of
    n_cols columns padded to K slots; blocks with index >= n_blocks // 2 get
    their weights scaled by 37 (entries up to 1443, above bf16's exact 256)."""
    padded = []
    for b in range(n_blocks):
        rs, positions, _hap = blocks.make_synthetic_readset(n_cols, K, read_len=12, seed=seed + b)
        p = wmec.pack_problem(rs, [1] * len(positions), _het_pedigree(len(positions)), False)
        _require(p.K <= K, f"block K {p.K} <= {K}")
        padded.append(blocks.pad_block(p, n_cols, k_pad=K))
    arrays = list(blocks.stack_blocks(padded))
    # pack_problem is linear in the read weights: scaling wdiff and wbase is
    # the same instance with every quality times 37
    arrays[0][n_blocks // 2 :] *= 37
    arrays[1][n_blocks // 2 :] *= 37
    return blocks.to_device(arrays, device)


def _max_err(pairs) -> int:
    """Largest absolute difference between paired int32 tensors, 0 when they
    are bit-equal (differences are taken in slices: the tables are large)."""
    worst = 0
    for a, b in pairs:
        if torch.equal(a, b):
            continue
        for x, y in zip(a.reshape(-1).split(1 << 26), b.reshape(-1).split(1 << 26)):
            worst = max(worst, int((x.long() - y.long()).abs().max()))
    return worst


def _t_name(K, T, P, name):
    """The kernels-line entry that forward_t, forward_m_t and forward_carry_t
    launch at (K, T, P): the cluster kernel's inside its envelope, the wide
    kernel's (row 14) past it."""
    if wmec_cuda.cluster_supported(K, T, P):
        return name
    base, _, mode = name.partition(":")
    return f"{base}_wide" + (f":{mode}" if mode else "")


def _t1_name(K, name="wmec_forward_t1"):
    """The kernels-line entry that forward_t1 / forward_carry_t1 launch at
    K: the cluster kernel's up to wmec_cuda.MAX_K, the wide kernel's above."""
    if K <= wmec_cuda.MAX_K:
        return name
    base, _, mode = name.partition(":")
    return f"{base}_wide" + (f":{mode}" if mode else "")


def compare_kernels(device, shapes=tuple((K, 4) for K in range(7, 18)) + ((12, 12), (15, 12), (17, 12)),
                    n_cols=256):
    """Phase 2: both kernels against their plain versions, bit for bit, at
    (K, B): the forward kernel's narrow layout (B = 4) and its wide one (B =
    12); past K = 17 the wide T=1 kernel (state in device memory).  Returns
    {kernel name: max abs error}."""
    err = {"wmec_forward_t1": 0, "wmec_backtrace_t1": 0}
    for K, n_blocks in shapes:
        arrays = packed_bucket(n_blocks, n_cols, K, 1000 + 10 * K + n_blocks, device)
        kern = wmec_cuda.forward_t1(K, 2, *arrays)
        plain = wmec_cuda.forward_t1_plain(K, 2, *arrays)
        torch.cuda.synchronize()
        e_fwd = _max_err(zip(kern, plain))
        _m, _t, opt = wmec_cuda._select_optimum(K, 1, kern[1], kern[2])
        die = wmec_cuda.pack_die(arrays[4])
        path, final = wmec_cuda.backtrace_t1(opt.contiguous(), kern[0], die)
        path_p, final_p = wmec_cuda.backtrace_t1_plain(opt, kern[0], die)
        torch.cuda.synchronize()
        e_bt = _max_err([(path, path_p), (final, final_p)])
        print(f"kernels K={K:2d} B={n_blocks} C={n_cols}: forward max|err|={e_fwd} "
              f"backtrace max|err|={e_bt}", flush=True)
        _require(e_fwd == 0 and e_bt == 0, f"kernels bit-equal to plain at K={K}")
        err[_t1_name(K)] = max(err.get(_t1_name(K), 0), e_fwd)
        err["wmec_backtrace_t1"] = max(err["wmec_backtrace_t1"], e_bt)
        del kern, plain
    return err


def _carry_after(K, T, P, head):
    """The state after a scan over `head` (the kernel's; it is held to its
    plain version above): (cost, key) at T = 1, (cost, jmin, key) above."""
    if T == 1:
        return wmec_cuda.forward_t1(K, P, *head)[1:]
    return tuple(wmec_cuda.forward_t(K, T, P, *head)[2:])


def compare_carry_kernels(device, shapes=((1, 7), (1, 10), (1, 14), (1, 15), (1, 16), (1, 17),
                                         (4, 3), (4, 4), (4, 7), (4, 9), (4, 12), (4, 15), (4, 16),
                                         (16, 4), (16, 7), (16, 9), (16, 13)),
                          n_blocks=3, n_cols=192, head_cols=64):
    """Phase 2, rows 9 and 10: the carry kernel and the tables kernel from a
    carry against their plain versions, bit for bit, over the last
    n_cols - head_cols columns of n_blocks blocks, from the nonzero state
    after their first head_cols columns.  Returns {entry: max abs error}."""
    err = {}
    for T, K in shapes:
        if T == 1:
            P, arrays = 2, packed_bucket(n_blocks, n_cols, K, 4000 + 10 * K, device)
        else:
            P, arrays = 4, pedigree_bucket(n_blocks, n_cols, K, T, 5000 + 10 * K + T, device)
        head = [a[:, :head_cols].contiguous() for a in arrays]
        tail = [a[:, head_cols:].contiguous() for a in arrays]
        carry = _carry_after(K, T, P, head)
        _require(all(bool((x != 0).any()) for x in (carry[0], carry[-1])), f"nonzero carry at T={T}, K={K}")
        if T == 1:
            names = (_t1_name(K, "wmec_forward_carry_t1"), _t1_name(K, "wmec_forward_t1:carry_in"))
            kern = (wmec_cuda.forward_carry_t1(K, P, *tail, carry), wmec_cuda.forward_t1(K, P, *tail, carry=carry))
            plain = (wmec_cuda.forward_carry_t1_plain(K, P, *tail, carry),
                     wmec_cuda.forward_t1_plain(K, P, *tail, carry))
        else:
            names = ("wmec_forward_carry_t", "wmec_forward_t:carry_in")
            kern = (wmec_cuda.forward_carry_t(K, T, P, *tail, carry), wmec_cuda.forward_t(K, T, P, *tail, carry=carry))
            plain = (wmec_cuda.forward_carry_t_plain(K, T, P, *tail, carry),
                     wmec_cuda.forward_t_plain(K, T, P, *tail, carry=carry))
        torch.cuda.synchronize()
        e = [_max_err(zip(k, p)) for k, p in zip(kern, plain)]
        print(f"kernels rows 9-10 T={T:2d} K={K:2d} B={n_blocks} C={n_cols - head_cols} (carry from "
              f"{head_cols} columns): carry max|err|={e[0]} tables from the carry max|err|={e[1]}", flush=True)
        _require(e == [0, 0], f"rows 9 and 10 bit-equal to plain at T={T}, K={K}")
        for name, x in zip(names, e):
            err[name] = max(err.get(name, 0), x)
        del kern, plain
    return err


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def haplotype_agreement(superreads, block, haps) -> float:
    """Share of each individual's heterozygous calls where its first
    superread agrees with its simulated haplotypes, up to one swap of the
    two per block (ties excluded); the lowest share over the individuals.
    block (C,) is each column's block (or window), haps (n_ind, 2, C) the
    simulated alleles."""
    worst = 1.0
    for ind, (h0, h1) in enumerate(haps):
        alleles = np.asarray([v.allele for v in superreads[ind][0]])
        hits = total = 0
        for b in np.unique(block):
            at = (block == b) & (h0 != h1) & (alleles < 2)
            same = int(np.sum(alleles[at] == h0[at]))
            hits += max(same, int(at.sum()) - same)
            total += int(at.sum())
        worst = min(worst, hits / max(total, 1))
    return worst


def _mirror_bytes(K, T, P):
    """Device memory the torch mirror's column step takes per block past the
    cluster kernels' envelope, where its temporaries no longer fit beside
    half the card in tables: at T = 1 the float64 sums of every state (48
    bytes a state); at T > 1 per state and plane the float64 and int32 sums
    (2P of each), the column cost's running sums, the fold's and the
    argmin's copies (the T x T min-plus is taken in chunks of at most
    wmec.MINPLUS_CHUNK_CUDA terms, whatever the block)."""
    if wmec_cuda.cluster_supported(K, T, P):
        return 0
    if T == 1:
        return 48 << K
    return (T << K) * (P * 2 * 12 + 64)


def plain_solve(K, T, P, *arrays):
    """The route's solve with the torch mirror in the kernels' place,
    chunked as the route chunks, leaving room for the mirror's temporaries
    (_mirror_bytes)."""
    per_block = (arrays[0].shape[1] * T * 4 << K) + _mirror_bytes(K, T, P)
    return wmec._launch_batched(wmec.solve_batched, K, T, P, arrays, per_block)


def plain_solve_seeded(K, T, P, *arrays):
    """Pass 2 of the pedigree route with the torch mirror, chunked as the
    route chunks, with room for the mirror's temporaries."""
    per_block = (arrays[0].shape[1] * T * 8 << K) + _mirror_bytes(K, T, P)
    return wmec._launch_batched(wmec.solve_seeded_batched, K, T, P, arrays, per_block)


def plain_forward_m(K, T, P, *arrays):
    """Pass 1 of the pedigree route with the torch mirror, chunked so that
    its state and temporaries fit: for each of a block's R seeds its state
    and the fold's and the min-plus's copies of it (8 int32 a state and
    plane), and once a block the column cost's temporaries."""
    R = arrays[-1].shape[1] if arrays[-1].dim() == 3 else 1
    per_block = R * (T * 32 << K) + _mirror_bytes(K, T, P)
    return wmec._launch_batched(wmec.forward_m_batched, K, T, P, arrays, per_block)


def phase_instance(rs, positions, ped, rc, truth, device, label, expect):
    """Phase one instance through the entry point (counted), then again
    through the route's pieces with a time split, and through the plain torch
    route; check all three agree and that the kernels named in `expect`
    launched.  truth = (block (C,), haps (n_ind, C)).  Returns the
    entry-point run's launch counts."""
    C = len(positions)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    table = core.PedigreeDPTable(rs, rc, ped, False, positions, device=device)
    cost = table.get_optimal_cost()
    partition = table.get_optimal_partitioning()
    superreads, transmission = table.get_super_reads()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    packed = table._packed
    print(f"{label}: {C} variants, {len(rs)} reads, K={packed.K}, T={packed.T}, "
          f"{len(wmec.connected_column_ranges(packed))} read-connected ranges; "
          f"cost {cost}; wall {wall:.3f} s = {C / wall:.1f} variants/s; "
          f"peak device memory {peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    _require(all(launches[n] > 0 for n in expect), f"{label}: every kernel of its path launched")
    _require(all(launches[n] == 0 for n in CARRY_KERNELS), f"{label}: unsegmented, as before")
    _require(len(superreads[0][0]) == C and len(transmission) == C, f"{label}: output shapes")
    _require(packed.T > 1 or transmission == [0] * C, f"{label}: no transmission for one sample")

    # the same instance again, timed around the route's calls: each solve
    # (kernels and the glue between them) between two synchronisations; the
    # rest of run_dp is host prep and the copies to the card before the
    # solves, the host chain between the pedigree passes, and the fetch and
    # stitching after them
    laps = []

    def timed(fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            laps.append((t, time.perf_counter()))
            return out
        return run

    t0 = time.perf_counter()
    packed = wmec.pack_problem(rs, rc, ped, False, positions)
    t1 = time.perf_counter()
    result = wmec.run_dp(
        packed, device, solve=timed(wmec.solve_batched_auto),
        forward_m=timed(wmec.forward_m_auto), solve_seeded=timed(wmec.solve_seeded_auto),
    )
    t2 = time.perf_counter()
    part_split = wmec.extract_partitioning(packed, result)
    wmec.extract_alleles(packed, result, ped)
    t3 = time.perf_counter()
    kernels = sum(b - a for a, b in laps)
    split = {
        "pack": t1 - t0,
        "prep+h2d": laps[-1][1] - t1 - kernels,
        "kernels": kernels,
        "d2h": t2 - laps[-1][1],
        "extract": t3 - t2,
    }
    text = " ".join(f"{k} {v:.3f}" for k, v in split.items())
    print(f"{label}: split (s): {text}; total {t3 - t0:.3f}", flush=True)
    _require(result.optimal_cost == cost and part_split == partition, f"{label}: split run agrees")

    # the plain torch route on the card
    t0 = time.perf_counter()
    plain = wmec.run_dp(
        packed, device, solve=plain_solve, forward_m=plain_forward_m, solve_seeded=plain_solve_seeded,
    )
    plain_s = time.perf_counter() - t0
    same = (
        plain.optimal_cost == cost
        and wmec.extract_partitioning(packed, plain) == partition
        and np.array_equal(plain.index_path, table._result.index_path)
        and np.array_equal(plain.trans_path, table._result.trans_path)
    )
    print(f"{label}: plain torch route {plain_s:.3f} s, cost {plain.optimal_cost}; "
          f"cost, partitioning, index and transmission paths equal: {same}", flush=True)
    _require(same, f"{label}: kernel route equals plain route")

    if truth is not None:
        agree = haplotype_agreement(superreads, *truth)
        print(f"{label}: superreads agree with the simulated haplotypes at {agree:.4f} of "
              f"calls (lowest over {len(truth[1])} individual(s))", flush=True)
        _require(agree > 0.9, f"{label}: haplotypes recovered")
    if packed.T > 1:
        switches = int(np.count_nonzero(np.diff(table._result.trans_path)))
        print(f"{label}: {switches} transmission changes on the optimal path", flush=True)
    return launches


def simulate_pedigree(n_blocks, n_cols, coverage, pedigree, seed, recomb_every=16):
    """A simulated pedigree chromosome: the founders (the individuals that
    are no trio's child: 0 and 1, then any other) get random haplotypes,
    those of 0 and 1 made to differ somewhere at every column so that each
    column is heterozygous in someone; each child (the trios' third members,
    a trio's parents before it) inherits one haplotype of each parent,
    switching parental haplotype once per parent in every `recomb_every`-th
    block (at different blocks for the two parents); genotypes follow the
    haplotypes.  Reads of every
    individual tile each block in `coverage` lanes (an int, or one count an
    individual; read length ~12 variants, 5 % allele errors, qualities
    10-39).  Returns (readset, positions, pedigree, (block (C,), first
    haplotype of each individual (n_ind, C)))."""
    n_ind, trios = pedigree
    lanes = [coverage] * n_ind if isinstance(coverage, int) else list(coverage)
    rng = np.random.RandomState(seed)
    total = n_blocks * n_cols
    haps = np.zeros((n_ind, 2, total), dtype=np.int64)
    haps[:2] = rng.randint(0, 2, size=(2, 2, total))
    same = (haps[:2] == haps[0, 0]).all(axis=(0, 1))
    haps[0, 1, same] ^= 1
    children = {ch for _f, _m, ch in trios}
    for ind in range(2, n_ind):
        if ind not in children:
            haps[ind] = rng.randint(0, 2, size=(2, total))
    block = np.repeat(np.arange(n_blocks), n_cols)
    for ci, (fa, mo, ch) in enumerate(trios):
        for side, parent in enumerate((fa, mo)):
            pick = np.full(total, rng.randint(0, 2))
            for b in range(n_blocks):
                if (b + 5 * side + 3 * ci) % recomb_every == 0:  # one recombination in this block
                    at = b * n_cols + rng.randint(n_cols // 4, 3 * n_cols // 4)
                    pick[at:] ^= 1
            haps[ch, side] = haps[parent, pick, np.arange(total)]
    positions = ((block * (n_cols + 100) + np.tile(np.arange(n_cols), n_blocks) + 1) * 10).tolist()
    ped = core.Pedigree(core.NumericSampleIds())
    for ind in range(n_ind):
        gts = [core.Genotype(sorted((int(a), int(b)))) for a, b in zip(haps[ind, 0], haps[ind, 1])]
        ped.add_individual(f"ind{ind}", gts, None)
    for fa, mo, ch in trios:
        ped.add_relationship(f"ind{fa}", f"ind{mo}", f"ind{ch}")
    rs = core.ReadSet()
    for ind in range(n_ind):
        for b in range(n_blocks):
            off = b * n_cols
            for lane in range(lanes[ind]):
                start = int(rng.randint(0, 6))
                while start < n_cols - 1:
                    length = int(np.clip(rng.poisson(12), 2, n_cols - start))
                    side = int(rng.randint(0, 2))
                    cols = np.arange(off + start, off + start + length)
                    alleles = haps[ind, side, cols] ^ (rng.rand(length) < 0.05)
                    quals = rng.randint(10, 40, size=length)
                    read = core.Read(f"i{ind}_b{b}_l{lane}_{start}", 50, 0, ind)
                    for c, a, q in zip(cols.tolist(), alleles.tolist(), quals.tolist()):
                        read.add_variant(positions[c], int(a), int(q))
                    rs.add(read)
                    start += length
    rs.sort()
    return rs, positions, ped, (block, haps)


def pedigree_bucket(n_blocks, n_cols, K, T, seed, device, pedigree=None):
    """Stacked device arrays of `n_blocks` single-range simulated pedigree
    blocks of n_cols columns padded to K slots (by default a trio for T = 4,
    a quartet for T = 16, a family of three or four children for T = 64 or
    256), recombination cost 10; blocks with index >= n_blocks // 2 get their
    weights scaled by 37."""
    pedigree = pedigree or {4: TRIO, 16: QUARTET, 64: FAMILY5, 256: FAMILY6, 1024: FAMILY7}[T]
    padded = []
    for b in range(n_blocks):
        rs, positions, ped, _truth = simulate_pedigree(1, n_cols - 8, max(1, K // pedigree[0]), pedigree, seed + b)
        p = wmec.pack_problem(rs, [10] * len(positions), ped, False, positions)
        _require(p.K <= K and p.T == T, f"pedigree block K {p.K} <= {K}, T {p.T} == {T}")
        padded.append(blocks.pad_block(p, n_cols, k_pad=K))
    arrays = list(blocks.stack_blocks(padded))
    arrays[0][n_blocks // 2 :] *= 37
    arrays[1][n_blocks // 2 :] *= 37
    return blocks.to_device(arrays, device)


def _seeds(B, T, seed, device):
    rng = np.random.RandomState(seed)
    dp0 = rng.randint(0, 500, size=(B, T)).astype(np.int32)
    dp0[rng.rand(B, T) < 0.3] = wmec.INF
    dp0[:, 0] = np.minimum(dp0[:, 0], 100)
    return torch.from_numpy(dp0).to(device)


def _walk_inits(K, T, tables_out, die_next):
    """The M = T + 1 walk starts of pass 2: the head optimum and the seam
    fold's winners, as solve_seeded_batched_cuda builds them."""
    _pidx, _pjmin, dp_last, jmin_last, key_last = tables_out
    _cost, head = wmec_cuda._head_init(K, T, dp_last, jmin_last, key_last)
    _m, s_star, jmin_star = wmec._seam_fold(
        K, T, dp_last.transpose(1, 2), key_last, jmin_last.transpose(1, 2), die_next
    )
    B = dp_last.shape[0]
    t_ids = torch.arange(T, dtype=torch.int32, device=dp_last.device).expand(B, T)
    return torch.cat([head[:, None], torch.stack([s_star, t_ids, jmin_star], dim=2)], dim=1).contiguous()


def compare_pedigree_kernels(device, shapes=((4, 3), (4, 4), (4, 7), (4, 9), (4, 10), (4, 12), (4, 15),
                                            (4, 16), (16, 4), (16, 7), (16, 9), (16, 10), (16, 13)),
                             n_blocks=4, n_cols=128, pedigree=None):
    """Phase 2, general T: each mode of the forward kernel and the backtrace
    at M = 1 and M = T + 1 against their plain versions, bit for bit, at (T,
    K) of pedigree_bucket's pedigrees (or of `pedigree`), the cluster kernel
    inside its envelope and row 14 past it.  Returns {kernel name: max abs
    error}."""
    err = {"wmec_backtrace_t": 0}
    for T, K in shapes:
        arrays = pedigree_bucket(n_blocks, n_cols, K, T, 2000 + 10 * K + T, device, pedigree)
        P = arrays[3].shape[-1].bit_length() - 1
        dp0 = _seeds(n_blocks, T, K + T, device)
        e_fwd = 0
        for seed in (None, dp0):
            kern = wmec_cuda.forward_t(K, T, P, *arrays, seed)
            plain = wmec_cuda.forward_t_plain(K, T, P, *arrays, seed)
            torch.cuda.synchronize()
            e_fwd = max(e_fwd, _max_err(zip(kern, plain)))
            del plain
        # m-only from dp0, and on row 14 grouped: R = 2 seeds a block (B, R,
        # T), where the plain version's T x T min-plus of every state stays
        # small (the largest shapes hold the grouped mode at
        # phase-cli-fam5's bucket and on the tie-heavy buckets; the cluster
        # kernel takes each seed as a block, which the pedigree cells'
        # routes run)
        m = wmec_cuda.forward_m_t(K, T, P, *arrays, dp0)
        m_plain = wmec_cuda.forward_m_t_plain(K, T, P, *arrays, dp0)
        torch.cuda.synchronize()
        e_m = _max_err([(m, m_plain)])
        wide = not wmec_cuda.cluster_supported(K, T, P)
        seeds_r = (1, 2) if wide and T << K <= 1 << 20 else (1,)
        if len(seeds_r) > 1:
            grouped = torch.stack([dp0, dp0.roll(1, dims=0)], dim=1).contiguous()
            m = wmec_cuda.forward_m_t(K, T, P, *arrays, grouped)
            m_plain = wmec_cuda.forward_m_t_plain(K, T, P, *arrays, grouped)
            torch.cuda.synchronize()
            e_m = max(e_m, _max_err([(m, m_plain)]))
        del m_plain
        die_next = torch.rand((n_blocks, K), generator=torch.Generator().manual_seed(K)) < 0.7
        inits = _walk_inits(K, T, kern, die_next.to(device))
        die = wmec_cuda.pack_die(arrays[4])
        e_bt = 0
        for init in (inits[:, :1].contiguous(), inits):
            out = wmec_cuda.backtrace_t(init, kern[0], kern[1], die)
            ref = wmec_cuda.backtrace_t_plain(init, kern[0], kern[1], die)
            torch.cuda.synchronize()
            e_bt = max(e_bt, _max_err(zip(out, ref)))
        del kern
        fwd, m_name = _t_name(K, T, P, "wmec_forward_t"), _t_name(K, T, P, "wmec_forward_m_t")
        print(f"kernels T={T:2d} K={K:2d} P={P} B={n_blocks} C={n_cols}: {fwd} (tables, unseeded and "
              f"seeded) max|err|={e_fwd} {m_name} (R = {', '.join(map(str, seeds_r))}) max|err|={e_m} "
              f"backtrace (M=1, M={T + 1}) "
              f"max|err|={e_bt}", flush=True)
        _require(e_fwd == 0 and e_m == 0 and e_bt == 0, f"general-T kernels bit-equal to plain at T={T}, K={K}")
        for name, e in ((fwd, e_fwd), (m_name, e_m), ("wmec_backtrace_t", e_bt)):
            err[name] = max(err.get(name, 0), e)
    return err


def _walk_pair(T, tables, start, die):
    """The backtrace kernel and its plain version on the same inputs; returns
    the max abs error between them."""
    if T == 1:
        out = wmec_cuda.backtrace_t1(start, tables[0], die)
        ref = wmec_cuda.backtrace_t1_plain(start, tables[0], die)
    else:
        out = wmec_cuda.backtrace_t(start, tables[0], tables[1], die)
        ref = wmec_cuda.backtrace_t_plain(start, tables[0], tables[1], die)
    torch.cuda.synchronize()
    return _max_err(zip(out, ref))


def compare_walks(device, random_shapes=((1, 7, 3, 1), (1, 15, 12, 1), (1, 17, 2, 1), (4, 9, 3, 1), (4, 9, 3, 5),
                                         (4, 16, 1, 1), (16, 7, 2, 17), (16, 13, 1, 1), (64, 6, 2, 65),
                                         (256, 4, 1, 257), (4, 20, 1, 5)),
                  free_shapes=((1, 12, 3, 1), (1, 15, 12, 1), (4, 10, 3, 1), (4, 10, 3, 5)), n_cols=200):
    """Phase 2, the backtraces beyond the tables of the main paths, against
    their plain versions, bit for bit, in narrow launches (up to 8 walks)
    and wide ones, at (T, K, B, M): on random tables, which break the shape
    the walks' guesses rest on (an index that changes outside its column's
    dying bits, pjmin not constant along them), whole or in 5 % of the
    entries of tables that have that shape, with random masks, a half of
    them empty: the guesses miss, and at T > 1 the checks of the
    transmission fail and the walk goes back; and on forward tables of
    tie-heavy buckets where 2 % of the slots die before each column, so
    that most columns are free.  Returns {kernel: max abs error}."""
    err = {"wmec_backtrace_t1": 0, "wmec_backtrace_t": 0}
    rng = np.random.RandomState(91)
    # the tables (up to 2^30 entries at T = 4, K = 20) are drawn on the card
    gen = torch.Generator(device=device).manual_seed(91)
    for T, K, B, M in random_shapes:
        S, C = 1 << K, n_cols
        die = torch.from_numpy((rng.randint(0, S, (B, C)) * (rng.rand(B, C) < 0.5)).astype(np.int32)).to(device)

        def draw(high):
            return torch.randint(0, high, (B, C, T, S), generator=gen, device=device, dtype=torch.int32)

        shaped = torch.arange(S, dtype=torch.int32, device=device) ^ (draw(S) & die[:, :, None, None])
        broken = torch.where(torch.rand((B, C, T, S), generator=gen, device=device) < 0.05, draw(S), shaped)
        whole = draw(S)
        pjmin = draw(T) if T > 1 else None
        if T == 1:
            start = torch.from_numpy(rng.randint(0, S, B).astype(np.int32)).to(device)
        else:
            start = torch.from_numpy(np.stack([rng.randint(0, S, (B, M)), rng.randint(0, T, (B, M)),
                                               rng.randint(0, T, (B, M))], axis=2).astype(np.int32)).to(device)
        e = 0
        for pidx in (broken, whole):
            tables = (pidx[:, :, 0].contiguous(),) if T == 1 else (pidx, pjmin)
            e = max(e, _walk_pair(T, tables, start, die))
        del shaped, broken, whole, pjmin, tables
        name = "wmec_backtrace_t1" if T == 1 else "wmec_backtrace_t"
        print(f"kernels random tables T={T:2d} K={K:2d} B={B} M={M} C={C} "
              f"({B * M} walks): {name} max|err|={e}", flush=True)
        _require(e == 0, f"{name} bit-equal to plain on random tables at T={T}, K={K}, B={B}, M={M}")
        err[name] = max(err[name], e)
    for T, K, B, M in free_shapes:
        P = 2 if T == 1 else 4
        arrays = list(tie_bucket(B, n_cols, K, T, P, 8000 + 10 * K + B, device))
        arrays[4] = torch.from_numpy(np.random.RandomState(K + B).rand(B, n_cols, K) < 0.02).to(device)
        die = wmec_cuda.pack_die(arrays[4])
        if T == 1:
            pidx, dp, key = wmec_cuda.forward_t1(K, P, *arrays)
            e = _walk_pair(T, (pidx,), wmec_cuda._select_optimum(K, 1, dp, key)[2].contiguous(), die)
        else:
            kern = wmec_cuda.forward_t(K, T, P, *arrays)
            inits = _walk_inits(K, T, kern, torch.ones((B, K), dtype=torch.bool, device=device))
            e = _walk_pair(T, kern[:2], inits[:, :M].contiguous(), die)
        name = "wmec_backtrace_t1" if T == 1 else "wmec_backtrace_t"
        print(f"kernels few dying slots T={T:2d} K={K:2d} B={B} M={M} C={n_cols} "
              f"({float((die == 0).float().mean()):.2f} of the columns free): {name} max|err|={e}", flush=True)
        _require(e == 0, f"{name} bit-equal to plain where few slots die at T={T}, K={K}, B={B}, M={M}")
        err[name] = max(err[name], e)
    return err


def tie_bucket(n_blocks, n_cols, K, T, P, seed, device):
    """Stacked block arrays at exactly K slots, drawn so that ties abound:
    weights, base costs, rankw and assignment costs in {0, 1},
    recombination costs in {0, 1, 2}, a quarter of the slots dying before
    each column, so folds at every level of the forward kernel's cluster
    layout meet equal costs and equal keys."""
    rng = np.random.RandomState(seed)
    B, C = n_blocks, n_cols
    arrays = [
        rng.randint(0, 2, (B, C, K, T * P * 2)).astype(np.float32),
        rng.randint(0, 2, (B, C, T, P, 2)).astype(np.int32),
        rng.randint(0, 2, (B, C, K)).astype(np.float32),
        rng.randint(0, 2, (B, C, T, 1 << P)).astype(np.int32),
        rng.rand(B, C, K) < 0.25,
        rng.randint(0, 3, (B, C)).astype(np.int32),
    ]
    return blocks.to_device(arrays, device)


def compare_tie_kernels(device, shapes=((4, 1, 4), (4, 4, 4), (4, 5, 4), (4, 9, 2), (4, 10, 4), (4, 13, 4),
                                        (4, 15, 4), (4, 16, 4), (16, 1, 4), (16, 9, 4), (16, 13, 2), (16, 13, 4)),
                        n_blocks=3, n_cols=96, head_cols=32):
    """Phase 2, general T on the tie-heavy bucket: every mode of the forward
    kernel (tables unseeded and seeded, m-only, carry, tables from the
    carry) against its plain version, bit for bit, at (T, K, P) from fewer
    than 32 states to the top of the envelope (row 14 past the cluster
    kernel's).  Returns {entry: max abs error}."""
    err = {}
    for T, K, P in shapes:
        arrays = tie_bucket(n_blocks, n_cols, K, T, P, 6000 + 100 * T + 10 * K + P, device)
        dp0 = torch.from_numpy(np.random.RandomState(K).randint(0, 2, (n_blocks, T)).astype(np.int32)).to(device)
        # the m-only mode from dp0, and on row 14 also with R = 2 seeds a block
        seeds = [dp0]
        if not wmec_cuda.cluster_supported(K, T, P):
            seeds.append(torch.stack([dp0, 1 - dp0], dim=1).contiguous())
        head = [a[:, :head_cols].contiguous() for a in arrays]
        tail = [a[:, head_cols:].contiguous() for a in arrays]
        carry = _carry_after(K, T, P, head)
        runs = {
            "wmec_forward_t": [(lambda s=s: wmec_cuda.forward_t(K, T, P, *arrays, s),
                                lambda s=s: wmec_cuda.forward_t_plain(K, T, P, *arrays, s)) for s in (None, dp0)],
            "wmec_forward_m_t": [(lambda s=s: [wmec_cuda.forward_m_t(K, T, P, *arrays, s)],
                                  lambda s=s: [wmec_cuda.forward_m_t_plain(K, T, P, *arrays, s)])
                                 for s in seeds],
            "wmec_forward_carry_t": [(lambda: wmec_cuda.forward_carry_t(K, T, P, *tail, carry),
                                      lambda: wmec_cuda.forward_carry_t_plain(K, T, P, *tail, carry))],
            "wmec_forward_t:carry_in": [(lambda: wmec_cuda.forward_t(K, T, P, *tail, carry=carry),
                                         lambda: wmec_cuda.forward_t_plain(K, T, P, *tail, carry=carry))],
        }
        e = {}
        for name, pairs in runs.items():
            for kern_fn, plain_fn in pairs:
                kern, plain = kern_fn(), plain_fn()
                torch.cuda.synchronize()
                entry = _t_name(K, T, P, name)
                e[entry] = max(e.get(entry, 0), _max_err(zip(kern, plain)))
                del kern, plain
        print(f"kernels tie-heavy T={T:2d} K={K:2d} P={P} B={n_blocks} C={n_cols}: "
              + " ".join(f"{n} max|err|={v}" for n, v in e.items()), flush=True)
        _require(all(v == 0 for v in e.values()), f"general-T forward bit-equal on the tie-heavy bucket at T={T}, K={K}")
        for name, v in e.items():
            err[name] = max(err.get(name, 0), v)
    return err


def compare_tie_kernels_t1(device, shapes=tuple((K, 3) for K in (1, 4, 5, 9, 10, 13, 14, 15, 16, 17))
                           + tuple((K, 9) for K in (11, 12, 15, 16, 17)), n_cols=64, head_cols=24):
    """Phase 2, T = 1 on the tie-heavy bucket: both modes of the T=1 forward
    kernel (tables from a zero state, carry, tables from that carry) against
    their plain versions, bit for bit, at (K, B) from fewer than 32 states to
    K = 17, in the narrow layout (B = 3) and the wide one (B = 9).  Returns
    {entry: max abs error}."""
    err = {}
    for K, B in shapes:
        arrays = tie_bucket(B, n_cols, K, 1, 2, 7000 + 10 * K + B, device)
        head = [a[:, :head_cols].contiguous() for a in arrays]
        tail = [a[:, head_cols:].contiguous() for a in arrays]
        carry = _carry_after(K, 1, 2, head)
        runs = {
            "wmec_forward_t1": (lambda: wmec_cuda.forward_t1(K, 2, *arrays),
                                lambda: wmec_cuda.forward_t1_plain(K, 2, *arrays)),
            "wmec_forward_carry_t1": (lambda: wmec_cuda.forward_carry_t1(K, 2, *tail, carry),
                                      lambda: wmec_cuda.forward_carry_t1_plain(K, 2, *tail, carry)),
            "wmec_forward_t1:carry_in": (lambda: wmec_cuda.forward_t1(K, 2, *tail, carry=carry),
                                         lambda: wmec_cuda.forward_t1_plain(K, 2, *tail, carry)),
        }
        e = {}
        for name, (kern_fn, plain_fn) in runs.items():
            kern, plain = kern_fn(), plain_fn()
            torch.cuda.synchronize()
            e[_t1_name(K, name)] = _max_err(zip(kern, plain))
            del kern, plain
        if K <= wmec_cuda.MAX_K:
            lay = f"{1 << wmec_cuda.forward_t1_layout(K, B)['cta_bits']} CTAs a block"
        else:
            lay = "the wide kernel, state in device memory"
        print(f"kernels tie-heavy T= 1 K={K:2d} B={B} C={n_cols} ({lay}): "
              + " ".join(f"{n} max|err|={v}" for n, v in e.items()), flush=True)
        _require(all(v == 0 for v in e.values()), f"T=1 forward bit-equal on the tie-heavy bucket at K={K}, B={B}")
        for name, v in e.items():
            err[name] = max(err.get(name, 0), v)
    return err


def compare_wide_cluster(device, Ks=tuple(range(7, wmec_cuda.MAX_K + 1)), n_blocks=3, n_cols=64, head_cols=24):
    """Phase 2, row 13 against rows 1, 9 and 10: inside the cluster kernel's
    envelope the wide kernel computes the same function, so both modes of
    each (tables from zero, carry, tables from that carry) must agree bit
    for bit, on a tie-heavy bucket and on a packed one (half its blocks with
    weights above 256), at K = 7 to 17.  Returns {entry: max abs error}."""
    err = {}
    for K in Ks:
        for kind, arrays in (("tie-heavy", tie_bucket(n_blocks, n_cols, K, 1, 2, 8000 + K, device)),
                             ("packed", packed_bucket(n_blocks, n_cols, K, 8100 + K, device))):
            head = [a[:, :head_cols].contiguous() for a in arrays]
            tail = [a[:, head_cols:].contiguous() for a in arrays]
            carry = _carry_after(K, 1, 2, head)
            pairs = {
                "wmec_forward_t1_wide": (wmec_cuda.forward_t1_wide(K, 2, *arrays), wmec_cuda.forward_t1(K, 2, *arrays)),
                "wmec_forward_carry_t1_wide": (wmec_cuda.forward_carry_t1_wide(K, 2, *tail, carry),
                                               wmec_cuda.forward_carry_t1(K, 2, *tail, carry)),
                "wmec_forward_t1_wide:carry_in": (wmec_cuda.forward_t1_wide(K, 2, *tail, carry),
                                                  wmec_cuda.forward_t1(K, 2, *tail, carry=carry)),
            }
            torch.cuda.synchronize()
            e = {name: _max_err(zip(*pair)) for name, pair in pairs.items()}
            del pairs
            print(f"kernels row 13 against the cluster kernel, {kind} K={K:2d} B={n_blocks} C={n_cols}: "
                  + " ".join(f"{n} max|err|={v}" for n, v in e.items()), flush=True)
            _require(all(v == 0 for v in e.values()), f"wide kernel equals the cluster kernel at K={K} ({kind})")
            for name, v in e.items():
                err[name] = max(err.get(name, 0), v)
    return err


def compare_wide_edges(device, Ks=(20, 23), n_blocks=2, head_cols=8):
    """Phase 2, row 13 at the edges of its layout, on tie-heavy buckets at K
    = 20 and 23: windows of several columns (one slot in 20 dying before
    each of 24 columns), and columns where more slots die than its tile's 12
    bits hold (a pre-pass folds the lowest first: 13 to K - 4 slots before
    two columns of 12, one in the head and one in the tail); both modes
    (tables from zero, carry, tables from that carry) against their plain
    versions, bit for bit.  Returns {entry: max abs error}."""
    err = {}
    for K in Ks:
        for kind, n_cols in (("windows", 24), ("a pre-pass", 12)):
            arrays = tie_bucket(n_blocks, n_cols, K, 1, 2, 8200 + K + n_cols, device)
            if kind == "windows":
                die = torch.from_numpy(np.random.RandomState(K).rand(n_blocks, n_cols, K) < 0.05).to(device)
            else:
                die = arrays[4].clone()
                die[0, 2, : K - 4] = True
                die[1, 2, 4:17] = True
                die[:, 8, :13] = True
            arrays = [*arrays[:4], die.contiguous(), arrays[5]]
            h = head_cols if kind == "windows" else 4
            head = [a[:, :h].contiguous() for a in arrays]
            tail = [a[:, h:].contiguous() for a in arrays]
            carry = _carry_after(K, 1, 2, head)
            runs = {
                "wmec_forward_t1_wide": (lambda: wmec_cuda.forward_t1_wide(K, 2, *arrays),
                                         lambda: wmec_cuda.forward_t1_plain(K, 2, *arrays)),
                "wmec_forward_carry_t1_wide": (lambda: wmec_cuda.forward_carry_t1_wide(K, 2, *tail, carry),
                                               lambda: wmec_cuda.forward_carry_t1_plain(K, 2, *tail, carry)),
                "wmec_forward_t1_wide:carry_in": (lambda: wmec_cuda.forward_t1_wide(K, 2, *tail, carry),
                                                  lambda: wmec_cuda.forward_t1_plain(K, 2, *tail, carry)),
            }
            e = {}
            for name, (kern_fn, plain_fn) in runs.items():
                kern, plain = kern_fn(), plain_fn()
                torch.cuda.synchronize()
                e[name] = _max_err(zip(kern, plain))
                del kern, plain
            print(f"kernels row 13 with {kind} K={K:2d} B={n_blocks} C={n_cols} (up to "
                  f"{int(die.sum(dim=2).max())} slots dying a column): "
                  + " ".join(f"{n} max|err|={v}" for n, v in e.items()), flush=True)
            _require(all(v == 0 for v in e.values()), f"row 13 bit-equal with {kind} at K={K}")
            for name, v in e.items():
                err[name] = max(err.get(name, 0), v)
    return err


def compare_wide_t_cluster(device, shapes=((4, 7), (4, 12), (4, 16), (16, 9), (16, 13)), n_blocks=3, n_cols=64,
                           head_cols=24):
    """Phase 2, row 14 against rows 3, 4, 6, 7, 9 and 10: inside the general-T
    cluster kernel's envelope the wide kernel computes the same function, so
    every mode of each (tables from zero and seeded, m-only, carry, tables
    from that carry) must agree bit for bit, on a tie-heavy bucket and on a
    packed one (half its blocks with weights above 256), at (T, K), P = 4.
    Returns {entry: max abs error}."""
    err = {}
    P = 4
    for T, K in shapes:
        for kind, arrays in (("tie-heavy", tie_bucket(n_blocks, n_cols, K, T, P, 8200 + 10 * K + T, device)),
                             ("packed", pedigree_bucket(n_blocks, n_cols, K, T, 8300 + 10 * K + T, device))):
            dp0 = _seeds(n_blocks, T, K * T, device)
            head = [a[:, :head_cols].contiguous() for a in arrays]
            tail = [a[:, head_cols:].contiguous() for a in arrays]
            carry = wmec_cuda.forward_t(K, T, P, *head)[2:]
            pairs = {
                "wmec_forward_t_wide": [(wmec_cuda.forward_t_wide(K, T, P, *arrays, s), wmec_cuda.forward_t(K, T, P, *arrays, s))
                                        for s in (None, dp0)],
                "wmec_forward_m_t_wide": [([wmec_cuda.forward_m_t_wide(K, T, P, *arrays, s)],
                                           [wmec_cuda.forward_m_t(K, T, P, *arrays, s)])
                                          for s in (dp0, torch.stack([dp0, dp0.flip(0)], dim=1).contiguous())],
                "wmec_forward_carry_t_wide": [(wmec_cuda.forward_carry_t_wide(K, T, P, *tail, carry),
                                               wmec_cuda.forward_carry_t(K, T, P, *tail, carry))],
                "wmec_forward_t_wide:carry_in": [(wmec_cuda.forward_t_wide(K, T, P, *tail, carry=carry),
                                                  wmec_cuda.forward_t(K, T, P, *tail, carry=carry))],
            }
            torch.cuda.synchronize()
            e = {name: max(_max_err(zip(*pair)) for pair in pl) for name, pl in pairs.items()}
            del pairs
            print(f"kernels row 14 against the cluster kernel, {kind} T={T:2d} K={K:2d} B={n_blocks} C={n_cols}: "
                  + " ".join(f"{n} max|err|={v}" for n, v in e.items()), flush=True)
            _require(all(v == 0 for v in e.values()), f"row 14 equals the cluster kernel at T={T}, K={K} ({kind})")
            for name, v in e.items():
                err[name] = max(err.get(name, 0), v)
    return err


def _layout_t1(K, B, tables, ms, C):
    """The T=1 forward kernel's cluster layout in a launch of B blocks and
    its microseconds per column (of all B blocks), for the timing lines."""
    lay = wmec_cuda.forward_t1_layout(K, B, tables)
    return (f"[{B} clusters of {1 << lay['cta_bits']} CTAs x {lay['threads']} threads, "
            f"{1 << lay['loop_bits']} states a thread, {lay['smem_bytes']} B shared a CTA; "
            f"{ms * 1e3 / C:.2f} us per column]")


def _layout(K, T, P, tables, ms, C, B):
    """The forward kernel's cluster layout at a shape and its microseconds
    per column (of all B blocks of the launch), for the timing lines."""
    lay = wmec_cuda.forward_t_layout(K, T, P, tables)
    return (f"[{B} clusters of {1 << lay['cta_bits']} CTAs x {lay['threads']} threads, "
            f"{1 << lay['loop_bits']} states a thread, {lay['smem_bytes']} B shared a CTA; "
            f"{ms * 1e3 / C:.2f} us per column]")


def _time(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs, by CUDA events, after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


_LATENCY = {}


def gather_latency() -> dict:
    """The card's dependent-gather latency in ns, from L2 and from device
    memory (profile_backtrace's pointer-chase probe), measured once."""
    if not _LATENCY:
        import profile_backtrace

        _LATENCY.update(profile_backtrace.latencies())
        print(f"gather latency (pointer chase, one thread): {_LATENCY['L2']:.1f} ns from L2, "
              f"{_LATENCY['HBM']:.1f} ns from device memory", flush=True)
    return _LATENCY


def _time_cold(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs, by CUDA events around each
    run alone, with the L2 cache flushed before each (a 256 MiB write): the
    tables as a caller meets them that did not just read them."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.fill_(1)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def walk_rounds(T, out, die) -> float:
    """The mean over a launch's walks of the memory round trips the
    backtrace kernels take (wmec_cuda.backtrace_rounds), from its outputs:
    T = 1 (path (B, C), final (B,)), else (path, tpath (B, M, C), final (B,
    M, 3)); die (B, C)."""
    die = die.cpu().numpy()
    if T == 1:
        path, final = (x.cpu().numpy() for x in out)
        walks = [(path[b], None, final[b], die[b]) for b in range(len(path))]
    else:
        path, tpath, final = (x.cpu().numpy() for x in out)
        walks = [(path[b, m], tpath[b, m], final[b, m], die[b])
                 for b in range(path.shape[0]) for m in range(path.shape[1])]
    return sum(wmec_cuda.backtrace_rounds(p, t, f, d, T, len(walks)) for p, t, f, d in walks) / len(walks)


def walk_timing(label, name, T, K, tables, start, die, reps=10):
    """Time a backtrace kernel at its shape (CUDA events) beside its plain
    version, hold it bit-equal, and print its bytes bound (the start, one
    table entry and one path entry a column and walk, twice at T > 1, and
    the final state), the card's gather latency, the walk's layout and its
    round trips a column (wmec_cuda.backtrace_rounds over these walks):
    rounds times latency is what the walk should take a column, beside the
    time a column measured, warm (runs retracing the same walk, as the
    parent's numbers were taken) and from a flushed L2.  Returns the kernels
    line's numbers (warm)."""
    B, C = tables[0].shape[0], tables[0].shape[1]
    if T == 1:
        W = B
        fn = lambda: wmec_cuda.backtrace_t1(start, tables[0], die)  # noqa: E731
        plain_fn = lambda: wmec_cuda.backtrace_t1_plain(start, tables[0], die)  # noqa: E731
        bound_bytes = 4 * (B + B * C + B * C + B)
    else:
        W = start.shape[0] * start.shape[1]
        fn = lambda: wmec_cuda.backtrace_t(start, *tables, die)  # noqa: E731
        plain_fn = lambda: wmec_cuda.backtrace_t_plain(start, *tables, die)  # noqa: E731
        bound_bytes = 4 * W * (3 + 4 * C + 3)
    ms = _time(fn, reps=reps)
    cold_ms = _time_cold(fn, reps=reps)
    out = fn()
    ref, plain_ms = _plain_ms(plain_fn)
    err = _max_err(zip(out, ref))
    bound_ms = bound_bytes / PEAK_BYTES_PER_S * 1e3
    lat = gather_latency()
    rounds = walk_rounds(T, out, die) / C
    lay = wmec_cuda.backtrace_layout(W, T)
    print(f"{label} {name} (walks={W} C={C} K={K} T={T}): {ms:.4f} ms (plain {plain_ms:.3f} ms), "
          f"{cold_ms:.4f} ms from a flushed L2, bound {bound_ms:.6f} ms by bytes, max|err|={err} "
          f"[a warp a walk, row 0 of {lay['row0']} lanes, {lay['guessed_rows']} guessed rows; {rounds:.3f} round trips a "
          f"column, x {lat['L2']:.1f} ns L2 latency = {rounds * lat['L2']:.1f} ns, x {lat['HBM']:.1f} ns "
          f"device-memory latency = {rounds * lat['HBM']:.1f} ns; measured {ms * 1e6 / C:.1f} ns a column, "
          f"{cold_ms * 1e6 / C:.1f} from a flushed L2]", flush=True)
    _require(err == 0, f"{label}: {name} bit-equal to plain")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "bound_ms": bound_ms, "bound_by": "bytes"}


def time_kernels(packed, label="slice"):
    """Phase 12, T = 1: each kernel at the largest bucket of the path
    (slice: B = 256 blocks; single: the one 4096-column block; phase-cli:
    the chromosome's 64-variant windows at K = 15)."""
    (c_pad, K), members, _ri = main_bucket(packed)
    stacked = blocks.stack_blocks(members)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrays = blocks.to_device(stacked, "cuda")
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    B, C, S = len(members), c_pad, 1 << K
    print(f"timing at the {label}'s main bucket: B={B} C={C} K={K}; its copy to the card "
          f"{h2d_ms:.3f} ms", flush=True)

    fwd_ms = _time(lambda: wmec_cuda.forward_t1(K, 2, *arrays), reps=3)
    pidx, dp_last, key_last = wmec_cuda.forward_t1(K, 2, *arrays)
    t0 = time.perf_counter()
    plain = wmec_cuda.forward_t1_plain(K, 2, *arrays)
    torch.cuda.synchronize()
    fwd_plain_ms = (time.perf_counter() - t0) * 1e3
    fwd_err = _max_err(zip((pidx, dp_last, key_last), plain))
    del plain
    _require(fwd_err == 0, f"forward kernel bit-equal to plain at the {label}'s bucket")

    # bounds: each input read once and each output written once, against
    # the adds the function needs: its four cost sums and its key sum change
    # by one slot's weight from a state to its Gray-order neighbour, so they
    # cost one int32 add each per state and column
    fwd_in = sum(a.numel() * a.element_size() for a in arrays[:5])  # rc is not read
    fwd_out = (pidx.numel() + dp_last.numel() + key_last.numel()) * 4
    fwd_ops = 5.0 * B * C * S
    fwd_bytes_ms = (fwd_in + fwd_out) / PEAK_BYTES_PER_S * 1e3
    fwd_ops_ms = fwd_ops / PEAK_INT32_ADDS_PER_S * 1e3
    out = {
        "wmec_forward_t1": {
            "ms": fwd_ms, "plain_ms": fwd_plain_ms, "max_abs_err": fwd_err,
            "bound_ms": max(fwd_bytes_ms, fwd_ops_ms),
            "bound_by": "operations" if fwd_ops_ms >= fwd_bytes_ms else "bytes",
        },
    }
    r = out["wmec_forward_t1"]
    print(f"{label} wmec_forward_t1: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms), bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']} {_layout_t1(K, B, True, fwd_ms, C)}", flush=True)
    opt = wmec_cuda._select_optimum(K, 1, dp_last, key_last)[2].contiguous()
    out["wmec_backtrace_t1"] = walk_timing(
        label, "wmec_backtrace_t1", 1, K, (pidx,), opt, wmec_cuda.pack_die(arrays[4]))
    return out


def main_bucket(packed):
    """The bucket of the most work on the route (blocks x columns x 2^K; a
    pedigree CLI run also has many read-less ranges of the genetic
    haplotyping at K = 1): ((c_pad, K), its PaddedArrays, their range
    indices)."""
    ranges = wmec.connected_column_ranges(packed)
    buckets = {}
    for ri, (c_pad, k_b, arrs) in enumerate(wmec._slice_ranges(packed, ranges)):
        buckets.setdefault((c_pad, k_b), []).append((ri, arrs))
    key, members = max(buckets.items(), key=lambda kv: len(kv[1]) * kv[0][0] << kv[0][1])
    return key, [a for _ri, a in members], [ri for ri, _a in members]


def _plain_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(in_bytes, out_bytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the int32 adds over the add rate."""
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_INT32_ADDS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def _general_t_ops(K, T, P, die_prev, tables=True, seeds=1):
    """int32 operations a general-T forward function needs over a bucket
    (die_prev (B, C, K)), as the bounds count them.  Inside the cluster
    kernel's envelope (rows 3-10) per state and column 2TP (the cost sums,
    in Gray order one add each), T^2 (the min-plus) and with tables one for
    the key.  Past it (row 14) what this run's data needs: a compare per
    state and plane of each pair a dying slot folds and per state and
    column T log2 T compares of the min-plus's distance transform, for each
    of a block's `seeds` scans (the m-only mode's R), and once per block
    the column cost's T (2P + 2^P) (its sums and the assignments), which
    does not depend on the seed."""
    B, C = die_prev.shape[0], die_prev.shape[1]
    S = 1 << K
    if wmec_cuda.cluster_supported(K, T, P):
        return (2 * T * P + T * T + (1 if tables else 0)) * B * C * S * seeds
    folds = int(die_prev.sum()) * T * S // 2
    return seeds * (folds + B * C * S * T * (T.bit_length() - 1)) + B * C * S * T * (2 * P + (1 << P))


def time_pedigree_kernels(packed, device="cuda", label="trio", max_blocks=None, plain_blocks=None, plain_seeds=None,
                          plain_cols=None, carry=True):
    """Phase 12, general T: each kernel at a pedigree path's main bucket, at
    the shapes the route gives it: the m-only scan as pass 1 (unit seeds,
    R seeds a block), the seeded scan with tables as pass 2, the backtrace
    with the head and T seam walks per block.  max_blocks: the bucket's
    blocks one launch takes (the route's chunk under the table budget);
    plain_blocks: the plain versions run on that many blocks only and are
    held to the kernel's output there (the m-only one on the first
    plain_seeds of a block's seeds, and both on the first plain_cols
    columns, where given: at T = 1024 a seed's T x T min-plus takes the
    plain version seconds a column).  Past the cluster kernel's
    envelope (row 14), with `carry`, also its carry mode and its tables mode
    from that carry, over the bucket's second half from the state after its
    first half."""
    (c_pad, K), members, _ri = main_bucket(packed)
    T, P = packed.T, packed.P
    members = members[:max_blocks]
    arrays = blocks.to_device(blocks.stack_blocks(members), device)
    B, C = len(members), c_pad
    nb = B if plain_blocks is None else min(B, plain_blocks)
    print(f"timing at the {label}'s main bucket: B={B} C={C} K={K} T={T} P={P} (plain versions on {nb} "
          f"block(s))", flush=True)
    rep_of, reps = wmec.coset_representatives(T, packed.t_sym_masks)
    R = len(reps)
    unit = np.full((R, T), wmec.INF, dtype=np.int32)
    unit[np.arange(R), reps] = 0
    seeds = torch.from_numpy(unit).to(device).expand(B, R, T).contiguous()
    names = {n: _t_name(K, T, P, n) for n in ("wmec_forward_m_t", "wmec_forward_t", "wmec_forward_carry_t",
                                              "wmec_forward_t:carry_in")}
    out = {}

    # pass 1: m-only, the R coset seeds of each block; the cluster kernel
    # takes each seed as a block (timed on the repeated blocks), row 14 the
    # blocks once with their seeds
    if wmec_cuda.cluster_supported(K, T, P):
        ins, sd = tuple(a.repeat_interleave(R, dim=0) for a in arrays), seeds.reshape(B * R, T)
    else:
        ins, sd = arrays, seeds
    m_ms = _time(lambda: wmec_cuda.forward_m_t(K, T, P, *ins, sd), reps=1 if T >= 1024 else 3)
    m = wmec_cuda.forward_m_t(K, T, P, *arrays, seeds)
    rp = R if plain_seeds is None else min(R, plain_seeds)
    pc = C if plain_cols is None else min(C, plain_cols)
    sub = [a[:nb, :pc].contiguous() for a in arrays]
    m_sub = m[:nb, :rp] if pc == C else wmec_cuda.forward_m_t(K, T, P, *sub, seeds[:nb, :rp].contiguous())
    m_plain, m_plain_ms = _plain_ms(lambda: plain_forward_m(K, T, P, *sub, seeds[:nb, :rp].contiguous()))
    wdiff, wbase, rankw, acost, die, rc = ins
    out[names["wmec_forward_m_t"]] = dict(
        ms=m_ms, plain_ms=m_plain_ms, max_abs_err=_max_err([(m_sub, m_plain)]),
        **dict(zip(("bound_ms", "bound_by"), _bound(
            _nbytes(wdiff, wbase, acost, die, rc, sd), _nbytes(m),
            _general_t_ops(K, T, P, arrays[4], tables=False, seeds=R)))),
    )

    # pass 2: seeded, with tables (the seeds: each block's folded minima)
    dp0 = m[:, 0].contiguous()
    del ins, m_plain
    fwd_ms = _time(lambda: wmec_cuda.forward_t(K, T, P, *arrays, dp0), reps=2)
    kern = wmec_cuda.forward_t(K, T, P, *arrays, dp0)
    plain, fwd_plain_ms = _plain_ms(lambda: wmec_cuda.forward_t_plain(K, T, P, *sub, dp0[:nb]))
    kern_sub = (x[:nb] for x in kern) if pc == C else wmec_cuda.forward_t(K, T, P, *sub, dp0[:nb].contiguous())
    fwd_err = _max_err(zip(kern_sub, plain))
    del plain, kern_sub
    out[names["wmec_forward_t"]] = dict(
        ms=fwd_ms, plain_ms=fwd_plain_ms, max_abs_err=fwd_err,
        **dict(zip(("bound_ms", "bound_by"), _bound(
            _nbytes(*arrays, dp0), _nbytes(*kern), _general_t_ops(K, T, P, arrays[4])))),
    )
    _require(all(r["max_abs_err"] == 0 for r in out.values()), f"general-T kernels bit-equal at the {label}'s bucket")
    for name, r in out.items():
        if wmec_cuda.cluster_supported(K, T, P):
            note = _layout(K, T, P, name == "wmec_forward_t", r["ms"], C, B * (R if "_m_" in name else 1))
        else:
            note = (f"[row 14, the T planes in device memory; {r['ms'] * 1e3 / C:.2f} us per column of "
                    f"{B} blocks" + (f" x {R} seeds" if "_m_" in name else "")
                    + f"; {100 * r['bound_ms'] / r['ms']:.2f} % of the bound]")
        on = (f"{nb} block(s)" + (f" x {rp} seed(s)" if "_m_" in name and rp < R else "")
              + (f", {pc} columns" if pc < C else ""))
        print(f"{label} {name}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms on {on}), bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} {note}", flush=True)

    # the head and T seam walks per block over the pass-2 tables
    inits = _walk_inits(K, T, kern, torch.ones((B, K), dtype=torch.bool, device=device))
    out["wmec_backtrace_t"] = walk_timing(
        label, "wmec_backtrace_t", T, K, kern[:2], inits, wmec_cuda.pack_die(arrays[4]))
    state = kern[2:]
    del kern, inits
    if carry and not wmec_cuda.cluster_supported(K, T, P):
        # row 14's carry mode, and its tables mode from that carry
        half = C // 2
        head = [a[:, :half].contiguous() for a in arrays]
        tail = [a[:, half:].contiguous() for a in arrays]
        carry = tuple(wmec_cuda.forward_carry_t(K, T, P, *head, tuple(torch.zeros_like(x) for x in state)))
        sub_carry = tuple(x[:nb] for x in carry)
        sub_tail = [a[:nb] for a in tail]
        for name, fn, plain_fn in (
            ("wmec_forward_carry_t", lambda: wmec_cuda.forward_carry_t(K, T, P, *tail, carry),
             lambda: wmec_cuda.forward_carry_t_plain(K, T, P, *sub_tail, sub_carry)),
            ("wmec_forward_t:carry_in", lambda: wmec_cuda.forward_t(K, T, P, *tail, carry=carry),
             lambda: wmec_cuda.forward_t_plain(K, T, P, *sub_tail, carry=sub_carry)),
        ):
            ms = _time(fn, reps=2)
            k_out = fn()
            p_out, plain_ms = _plain_ms(plain_fn)
            err = _max_err(zip((x[:nb] for x in k_out), p_out))
            bound = _bound(_nbytes(*tail, *carry), _nbytes(*k_out),
                           _general_t_ops(K, T, P, tail[4], tables=name != "wmec_forward_carry_t"))
            out[names[name]] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound[0], bound_by=bound[1])
            del k_out, p_out
        for name in ("wmec_forward_carry_t", "wmec_forward_t:carry_in"):
            r = out[names[name]]
            print(f"{label} {names[name]}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms on {nb} block(s)), "
                  f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} [row 14, from the state after {half} columns; "
                  f"{r['ms'] * 1e3 / (C - half):.2f} us per column of {B} blocks; "
                  f"{100 * r['bound_ms'] / r['ms']:.2f} % of the bound]", flush=True)
        _require(all(r["max_abs_err"] == 0 for r in out.values()), f"row 14's carry modes bit-equal at the {label}'s bucket")
    return out


def time_quartet_walks(packed, device="cuda"):
    """The general-T backtrace at the quartet's main bucket as pass 2 of the
    pedigree route launches it (the head and T seam walks of each block),
    over tables of a seeded scan (zero seeds)."""
    (c_pad, K), members, _ri = main_bucket(packed)
    T, P = packed.T, packed.P
    arrays = blocks.to_device(blocks.stack_blocks(members), device)
    B = len(members)
    kern = wmec_cuda.forward_t(K, T, P, *arrays, torch.zeros((B, T), dtype=torch.int32, device=device))
    inits = _walk_inits(K, T, kern, torch.ones((B, K), dtype=torch.bool, device=device))
    walk_timing("quartet", "wmec_backtrace_t", T, K, kern[:2], inits, wmec_cuda.pack_die(arrays[4]))


def time_segment_walk(packed, seg, label, device="cuda"):
    """A backtrace at a segment's shape (B = 1, C = seg) as the segmented
    route launches it: over segment 1's tables from the checkpoint after
    segment 0, from that pass's optimum."""
    K, T, P = packed.K, packed.T, packed.P
    c_pad = -(-packed.n_cols // seg) * seg
    arrays = blocks.to_device(blocks.stack_blocks([blocks.pad_block(packed, c_pad)]), device)
    head = [a[:, :seg].contiguous() for a in arrays]
    tail = [a[:, seg : 2 * seg].contiguous() for a in arrays]
    carry = _carry_after(K, T, P, head)
    die = wmec_cuda.pack_die(tail[4])
    if T == 1:
        pidx, dp, key = wmec_cuda.forward_t1(K, P, *tail, carry=carry)
        opt = wmec_cuda._select_optimum(K, 1, dp, key)[2].contiguous()
        walk_timing(label, "wmec_backtrace_t1", 1, K, (pidx,), opt, die)
    else:
        kern = wmec_cuda.forward_t(K, T, P, *tail, carry=carry)
        init = wmec_cuda._head_init(K, T, *kern[2:])[1][:, None].contiguous()
        walk_timing(label, "wmec_backtrace_t", T, K, kern[:2], init, die)


def time_trio_single_kernels(packed, device="cuda"):
    """Kernel rows 3-5 at the shape the single-block route gives them at
    T = 4: one read-connected trio range (B = 1), the tables kernel unseeded
    (as forward_scan_pallas and solve_batched_pallas launch it) and the
    backtrace with one walk."""
    (c_pad, K), members, _ri = main_bucket(packed)
    T, P = packed.T, packed.P
    arrays = blocks.to_device(blocks.stack_blocks(members), device)
    B, C, S = len(members), c_pad, 1 << K
    fwd_ms = _time(lambda: wmec_cuda.forward_t(K, T, P, *arrays), reps=2)
    kern = wmec_cuda.forward_t(K, T, P, *arrays)
    plain, fwd_plain_ms = _plain_ms(lambda: wmec_cuda.forward_t_plain(K, T, P, *arrays))
    fwd_err = _max_err(zip(kern, plain))
    del plain
    fwd_bound = _bound(_nbytes(*arrays), _nbytes(*kern), (2 * T * P + 1 + T * T) * B * C * S)
    print(f"trio-single kernels (B={B} C={C} K={K} T={T} P={P}): wmec_forward_t unseeded "
          f"{fwd_ms:.3f} ms (plain {fwd_plain_ms:.3f} ms), bound {fwd_bound[0]:.4f} ms by "
          f"{fwd_bound[1]}, max|err|={fwd_err} {_layout(K, T, P, True, fwd_ms, C, B)}", flush=True)
    _require(fwd_err == 0, "general-T forward kernel bit-equal at the trio-single shape")
    init = wmec_cuda._head_init(K, T, *kern[2:])[1][:, None].contiguous()
    walk_timing("trio-single", "wmec_backtrace_t", T, K, kern[:2], init, wmec_cuda.pack_die(arrays[4]))


# ---------------------------------------------------------------------------
# the segmented solve
# ---------------------------------------------------------------------------

#: The table budget the segmented phases pin: below each instance's whole
#: tables (4, 8 and 1 GiB), above one segment's tables, state and
#: checkpoints (~0.26, ~0.53 and ~0.52 GiB).
SEGMENT_PHASE_BUDGET = 768 << 20


@contextlib.contextmanager
def pinned_budget():
    """Within the block, wmec's table budget on the card is
    SEGMENT_PHASE_BUDGET bytes; the budget function is restored on the way
    out."""
    saved = wmec._table_budget
    wmec._table_budget = lambda device: SEGMENT_PHASE_BUDGET if device.type == "cuda" else None
    try:
        yield
    finally:
        wmec._table_budget = saved


def _phase_table(rs, positions, ped, rc):
    """PedigreeDPTable on the card, from the ReadSet to the superreads, with
    its wall time, launch counts and peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    table = core.PedigreeDPTable(rs, rc, ped, False, positions, device="cuda")
    out = (table.get_optimal_cost(), table.get_optimal_partitioning(), table.get_super_reads())
    wall = time.perf_counter() - t0
    return table, out, wall, read_launches(), torch.cuda.max_memory_allocated()


def segmented_instance(rs, positions, ped, rc, truth, label, K, T, n_seg, plain=False, min_agree=0.9):
    """Phase segmented*: one read-connected range whose whole tables exceed
    the pinned budget, through PedigreeDPTable(device="cuda") with the
    counters set to 0 just before and read just after: the carry kernel,
    the tables kernel from a carry and the backtrace must each launch once
    per segment (n_seg) and no other wMEC kernel at all.  Then a second run
    through the route's pieces with each pass timed between
    synchronisations, and the unsegmented single-block route on the card at
    the default budget, which must give the same cost, partitioning, index
    and transmission paths; with `plain`, also the plain route on the card
    (the torch mirror's segmented solve in the same segments).  truth =
    (block or window (C,), haps (n_ind, C)): the superreads must agree with
    it above min_agree (None: the agreement is printed, not held).  Returns
    the first run's launch counts and the packed instance."""
    C = len(positions)
    packed = wmec.pack_problem(rs, rc, ped, False, positions)
    _require(len(wmec.connected_column_ranges(packed)) == 1 and packed.K == K and packed.T == T,
             f"{label}: one range, K={packed.K} == {K}, T={packed.T} == {T}")
    if T == 1:
        path = ("wmec_forward_carry_t1", "wmec_forward_t1", "wmec_backtrace_t1")
    else:
        path = tuple(_t_name(K, T, packed.P, n) for n in ("wmec_forward_carry_t", "wmec_forward_t")) + (
            "wmec_backtrace_t",)
    with pinned_budget():
        table, (cost, partition, (superreads, transmission)), wall, launches, peak = _phase_table(
            rs, positions, ped, rc)
        seg = wmec._single_range_segment(C, K, T, torch.device("cuda"), packed.P)
        print(f"{label}: {C} variants, {len(rs)} reads, K={K}, T={T}, one read-connected range; "
              f"table budget pinned at {SEGMENT_PHASE_BUDGET / 2**20:.0f} MiB; segments of {seg}; "
              f"cost {cost}; wall {wall:.3f} s = {C / wall:.1f} variants/s; peak device memory "
              f"{peak / 2**30:.3f} GiB; launches {launches}", flush=True)
        _require(all(launches[n] == n_seg for n in path), f"{label}: {n_seg} launches of each kernel of the path")
        _require(sum(launches[n] for n in WRAPPERS if n not in path) == 0, f"{label}: no other kernel launched")
        _require(len(superreads[0][0]) == C and len(transmission) == C, f"{label}: output shapes")

        # the same instance through the route's pieces, each pass timed
        # between two synchronisations: the checkpoint pass (carry kernels),
        # then per segment the tables kernel from its checkpoint and the
        # backtrace
        laps = {"carry": 0.0, "tables+backtrace": 0.0}
        ends = []

        def timed(fn, lap):
            def run(*args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                ends.append(time.perf_counter())
                laps[lap] += ends[-1] - t
                return out
            return run

        def solve(K_, T_, P_, *arrays):
            return wmec.solve_segmented(
                K_, T_, P_, *arrays, timed(wmec_cuda._carry_pass, "carry"),
                timed(wmec_cuda._tables_pass, "tables+backtrace"), timed(wmec_cuda._walk, "tables+backtrace"),
            )

        t0 = time.perf_counter()
        packed = wmec.pack_problem(rs, rc, ped, False, positions)
        t1_ = time.perf_counter()
        result = wmec.run_dp(packed, "cuda", solve_segmented=solve)
        t2 = time.perf_counter()
        part_split = wmec.extract_partitioning(packed, result)
        wmec.extract_alleles(packed, result, ped)
        t3 = time.perf_counter()
        if plain:
            t0_p = time.perf_counter()
            plain_result = wmec.run_dp(packed, "cuda", solve=plain_solve, solve_segmented=wmec.solve_segmented)
            plain_s = time.perf_counter() - t0_p
            same_plain = (
                plain_result.optimal_cost == cost and wmec.extract_partitioning(packed, plain_result) == partition
                and np.array_equal(plain_result.index_path, table._result.index_path)
                and np.array_equal(plain_result.trans_path, table._result.trans_path)
            )
            print(f"{label}: plain route on the card (the same segments) {plain_s:.3f} s; cost, partitioning, "
                  f"index and transmission paths equal: {same_plain}", flush=True)
            _require(same_plain, f"{label}: kernel route equals the plain route")
    split = {"pack": t1_ - t0, **laps, "prep+h2d+select": ends[-1] - t1_ - sum(laps.values()),
             "d2h": t2 - ends[-1], "extract": t3 - t2}
    text = " ".join(f"{k} {v:.3f}" for k, v in split.items())
    print(f"{label}: split (s): {text}; total {t3 - t0:.3f}", flush=True)
    _require(result.optimal_cost == cost and part_split == partition, f"{label}: split run agrees")

    # the unsegmented single-block route at the default budget
    whole, (cost_w, partition_w, _sr), wall_w, launches_w, peak_w = _phase_table(rs, positions, ped, rc)
    same = (
        cost_w == cost and partition_w == partition
        and np.array_equal(whole._result.index_path, table._result.index_path)
        and np.array_equal(whole._result.trans_path, table._result.trans_path)
    )
    print(f"{label}: unsegmented route at the default budget: wall {wall_w:.3f} s, peak device memory "
          f"{peak_w / 2**30:.3f} GiB (segmented {peak / 2**30:.3f}), launches {launches_w}; cost, "
          f"partitioning, index and transmission paths equal: {same}", flush=True)
    _require(all(launches_w[n] == 0 for n in CARRY_KERNELS), f"{label}: the default budget does not segment")
    _require(same, f"{label}: segmented route equals the unsegmented route")

    agree = haplotype_agreement(superreads, *truth)
    print(f"{label}: superreads agree with the simulated haplotypes at {agree:.4f} of calls "
          f"(lowest over {len(truth[1])} individual(s))", flush=True)
    _require(min_agree is None or agree > min_agree, f"{label}: haplotypes recovered")
    if T > 1:
        switches = int(np.count_nonzero(np.diff(table._result.trans_path)))
        print(f"{label}: {switches} transmission changes on the optimal path", flush=True)
    return launches, packed


def time_carry_kernels(packed, seg, label, device="cuda"):
    """Phase timing, rows 9 and 10 (row 13's two passes past K = 17) at a
    segment's shape (B = 1, C = seg) as the segmented route gives it them:
    segment 1 of the instance, from the checkpoint after segment 0.  Bounds: the bytes (each input read once,
    the carry in and out, the tables) against the int32 adds the function
    needs (5 per state and column at T = 1, 2TP + 1 + T^2 above)."""
    K, T, P = packed.K, packed.T, packed.P
    c_pad = -(-packed.n_cols // seg) * seg
    arrays = blocks.to_device(blocks.stack_blocks([blocks.pad_block(packed, c_pad)]), device)
    head = [a[:, :seg].contiguous() for a in arrays]
    tail = [a[:, seg : 2 * seg].contiguous() for a in arrays]
    carry = _carry_after(K, T, P, head)
    S = 1 << K
    ops = 5 * seg * S if T == 1 else _general_t_ops(K, T, P, tail[4])
    inputs = _nbytes(*(tail[:5] if T == 1 else tail), *carry)  # T = 1 does not read rc
    if T == 1:
        carry_fn = lambda: wmec_cuda.forward_carry_t1(K, P, *tail, carry)  # noqa: E731
        tables_fn = lambda: wmec_cuda.forward_t1(K, P, *tail, carry=carry)  # noqa: E731
        plains = (lambda: wmec_cuda.forward_carry_t1_plain(K, P, *tail, carry),
                  lambda: wmec_cuda.forward_t1_plain(K, P, *tail, carry))
        names = (_t1_name(K, "wmec_forward_carry_t1"), _t1_name(K, "wmec_forward_t1:carry_in"))
    else:
        carry_fn = lambda: wmec_cuda.forward_carry_t(K, T, P, *tail, carry)  # noqa: E731
        tables_fn = lambda: wmec_cuda.forward_t(K, T, P, *tail, carry=carry)  # noqa: E731
        plains = (lambda: wmec_cuda.forward_carry_t_plain(K, T, P, *tail, carry),
                  lambda: wmec_cuda.forward_t_plain(K, T, P, *tail, carry=carry))
        names = (_t_name(K, T, P, "wmec_forward_carry_t"), _t_name(K, T, P, "wmec_forward_t:carry_in"))
    out = {}
    for name, fn, plain_fn in zip(names, (carry_fn, tables_fn), plains):
        ms = _time(fn, reps=2)
        kern = fn()
        plain, plain_ms = _plain_ms(plain_fn)
        bound = _bound(inputs, _nbytes(*(x for x in kern if x is not None)), ops)
        out[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=_max_err(zip(kern, plain)),
                         bound_ms=bound[0], bound_by=bound[1])
        del kern, plain
        r = out[name]
        if not wmec_cuda.cluster_supported(K, T, P):
            note = f" [the wide kernel, state in device memory; {ms * 1e3 / seg:.2f} us per column]"
        elif T == 1:
            note = " " + _layout_t1(K, 1, name != "wmec_forward_carry_t1", ms, seg)
        else:
            note = " " + _layout(K, T, P, name != "wmec_forward_carry_t", ms, seg, 1)
        print(f"{label} {name} (B=1 C={seg} K={K} T={T} P={P}): {ms:.3f} ms (plain {plain_ms:.3f} ms), "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, max|err|={r['max_abs_err']}{note}", flush=True)
    _require(all(r["max_abs_err"] == 0 for r in out.values()), f"{label}: rows 9 and 10 bit-equal at the segment")
    return out


# ---------------------------------------------------------------------------
# genotyping
# ---------------------------------------------------------------------------


def simulate_genotyping(n_cols, coverage, pedigree, seed, zero_prior=None, break_at=None):
    """A simulated genotyping chromosome of n_cols variants: every
    individual's two haplotypes carry the alternative allele with probability
    1/2 at each variant (so hom ref, het and hom alt in the ratio 1:2:1);
    each child of a trio inherits one haplotype of each parent, switching
    once per parent at a random point.  Reads of every individual tile the
    chromosome in `coverage` lanes (an int, or one count an individual; read
    length ~12 variants, 5 % allele errors, qualities 10-39).  The priors
    are each individual's compute_genotypes over its own reads, normalised
    as the genotype CLI regularises them (constant 0); with zero_prior = c
    the first individual's prior at column c is all 0; with break_at = c no
    read spans columns c - 1 and c, so every slot dies after c - 1 and a new
    range starts at c with all its slots born.  Returns (readset, positions,
    pedigree, numeric sample ids, true genotypes (n_ind, C))."""
    n_ind, trios = pedigree
    rng = np.random.RandomState(seed)
    haps = rng.randint(0, 2, size=(n_ind, 2, n_cols))
    for fa, mo, ch in trios:
        for side, parent in enumerate((fa, mo)):
            pick = np.full(n_cols, rng.randint(0, 2))
            pick[rng.randint(n_cols // 4, 3 * n_cols // 4):] ^= 1
            haps[ch, side] = haps[parent, pick, np.arange(n_cols)]
    positions = ((np.arange(n_cols) + 1) * 10).tolist()
    nsi = core.NumericSampleIds()
    ped = core.Pedigree(nsi)
    rs = core.ReadSet()
    lanes = [coverage] * n_ind if isinstance(coverage, int) else list(coverage)
    for ind in range(n_ind):
        own = core.ReadSet()
        for lane in range(lanes[ind]):
            start = int(rng.randint(0, 6))
            while start < n_cols - 1:
                end = break_at if break_at is not None and start < break_at else n_cols
                if end - start < 2:
                    start = end
                    continue
                length = int(np.clip(rng.poisson(12), 2, end - start))
                side = int(rng.randint(0, 2))
                cols = np.arange(start, start + length)
                alleles = haps[ind, side, cols] ^ (rng.rand(length) < 0.05)
                quals = rng.randint(10, 40, size=length)
                read = core.Read(f"i{ind}_l{lane}_{start}", 50, 0, ind)
                for c, a, q in zip(cols.tolist(), alleles.tolist(), quals.tolist()):
                    read.add_variant(positions[c], int(a), int(q))
                own.add(read)
                rs.add(read)
                start += length
        own.sort()
        _gts, priors = core.compute_genotypes(own, positions)
        gls = [core.PhredGenotypeLikelihoods([g / sum(gl) for g in gl]) for gl in priors]
        if ind == 0 and zero_prior is not None:
            gls[zero_prior] = core.PhredGenotypeLikelihoods([0.0, 0.0, 0.0])
        ped.add_individual(f"ind{ind}", [core.Genotype([])] * n_cols, gls)
    for fa, mo, ch in trios:
        ped.add_relationship(f"ind{fa}", f"ind{mo}", f"ind{ch}")
    rs.sort()
    return rs, positions, ped, nsi, haps.sum(axis=1)


def _pad_k(stacked, k_pad):
    """Pad prepared inputs' slot axis to k_pad: the extra state bits carry
    zero diff and never fold, and dup takes the exact 2^pad duplicate
    factor, so every scaled quantity is unchanged (as the reference's
    pad_prepared_k)."""
    trans, passign, base, diff, birth, die_next, dup, gmask = stacked
    pad = k_pad - diff.shape[2]
    diff = np.pad(diff, ((0, 0), (0, 0), (0, pad), (0, 0)))
    birth = np.pad(birth, ((0, 0), (0, 0), (0, pad)))
    die_next = np.pad(die_next, ((0, 0), (0, 0), (0, pad)))
    return [trans, passign, base, diff, birth, die_next, dup * 2.0 ** pad, gmask]


def geno_bucket(T, K, n_blocks, n_cols, seed, pedigree=None, coverage=None, break_block=None):
    """Prepared inputs of n_blocks simulated genotyping instances of n_cols
    columns (one sample, a trio or a quartet by T, or `pedigree` with its
    read lanes `coverage`), padded to K slots; block 0 has a zero-sum prior
    at column n_cols // 2, and block `break_block` a new range at column
    n_cols // 3 with all its slots born.  Returns (P, stacked)."""
    pedigree = pedigree or {1: SINGLE, 4: TRIO, 16: QUARTET}[T]
    cov = coverage or max(1, K // pedigree[0])
    parts = []
    for b in range(n_blocks):
        rs, pos, ped, _nsi, _gt = simulate_genotyping(
            n_cols, cov, pedigree, seed + b, zero_prior=n_cols // 2 if b == 0 else None,
            break_at=n_cols // 3 if b == break_block else None,
        )
        packed = wmec.pack_problem(rs, [10] * n_cols, ped, False, pos,
                                   check_conflicts=False, emission_tables=False)
        _require(packed.K <= K and packed.T == T, f"genotyping block K {packed.K} <= {K}, T {packed.T}")
        (_k, _t, P, _n), stacked = genotyping.prepare_genotyping_batch([packed], ped)
        parts.append(_pad_k(stacked, K))
    return P, [np.concatenate(xs) for xs in zip(*parts)]


def _rel_err(a, b) -> float:
    """Largest |a - b| / (|b| + 1e-30) over the entries where b is a number
    (the 1e-30 keeps float32 subnormals out of it); inf where the NaN
    patterns differ.  Taken in slices: beta tables are large."""
    worst = 0.0
    for x, y in zip(a.reshape(-1).split(1 << 26), b.reshape(-1).split(1 << 26)):
        x, y = x.double(), y.double()
        nan = torch.isnan(y)
        if not torch.equal(nan, torch.isnan(x)):
            return float("inf")
        d = ((x - y).abs() / (y.abs() + 1e-30))[~nan]
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


def _col_err(beta, beta_p) -> float:
    """Largest |beta - beta_p| of a (B, C, T, S) table relative to the
    largest |beta_p| of its (instance, column), over the columns that are
    numbers in both (the NaN patterns are checked by _rel_err).  Entries far
    below their column's largest carry the rounding of their large negative
    log-emissions, so they are held to this scale, not to their own."""
    worst = 0.0
    rows = beta.reshape(-1, beta.shape[2] * beta.shape[3])
    rows_p = beta_p.reshape(rows.shape)
    step = max(1, (1 << 26) // rows.shape[1])
    for x, y in zip(rows.split(step), rows_p.split(step)):
        scale = y.abs().amax(dim=1)
        err = (x - y).abs().amax(dim=1) / (scale + 1e-30)
        err = err[~(scale.isnan() | err.isnan())]
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
    return worst


def _abs_err(a, b) -> float:
    """Largest |a - b| over the entries where both are numbers."""
    worst = 0.0
    for x, y in zip(a.reshape(-1).split(1 << 26), b.reshape(-1).split(1 << 26)):
        worst = max(worst, float((x.double() - y.double()).abs().nan_to_num(nan=0.0).max()))
    return worst


def _per_col(red):
    """red (B, C, T * nA) over its column sums in float64: the joint
    posterior of transmission and allele assignment, the scale-free form in
    which the likelihoods take it."""
    red = red.double()
    return red / red.sum(dim=-1, keepdim=True)


def _lik_err(lik, ref) -> float:
    """Largest absolute difference of two likelihood arrays; inf where the
    NaN patterns differ."""
    nan = np.isnan(ref)
    if not np.array_equal(nan, np.isnan(lik)):
        return float("inf")
    return float(np.max(np.abs(lik[~nan] - ref[~nan]), initial=0.0))


GENO_SHAPES = (
    (1, 3), (1, 7), (1, 10), (1, 12), (1, 13), (1, 14), (1, 15), (1, 16), (1, 17),
    (4, 7), (4, 12), (4, 15), (4, 16), (16, 7), (16, 10), (16, 13),
)


def compare_geno_kernels(device, shapes=GENO_SHAPES, n_blocks=4, n_cols=128):
    """Phase geno-kernels: both genotyping kernels against their float32
    plain versions on the same CUDA tensors, at (T, K); red and scaling
    within rtol=1e-4, likelihoods within atol=1e-5, identical NaN patterns.
    Where K is the instances' own (no padded slots) and the cluster has 8
    or 16 CTAs, both passes must fold bits at every level the layout has,
    the top CTA-rank bit included.  As a witness of where beta_store's per-entry
    differences come from, the kernel's and the float32 plain version's
    beta_store are both held against the float64 plain version on the same
    inputs (printed, not gated).  Returns {kernel name: max abs error} (red
    normalised per column)."""
    err = {"geno_backward": 0.0, "geno_forward": 0.0}
    for T, K in shapes:
        P, stacked = geno_bucket(T, K, n_blocks, n_cols, 3000 + 10 * K + T)
        x = genotyping.to_device(stacked, torch.device(device))
        diff, base, passign, trans, birth, die_next, dup = x
        layout = genotyping_cuda.cluster_layout(K)
        levels = (genotyping_cuda.fold_levels(K, birth), genotyping_cuda.fold_levels(K, die_next))
        print(f"geno kernels T={T:2d} K={K:2d}: a cluster of {1 << layout[0]} CTAs of {layout[2]} "
              f"threads, 2^{layout[1]} states a thread and plane; folds at {sorted(levels[0])} "
              f"(backward), {sorted(levels[1])} (forward)", flush=True)
        if layout[0] >= 3 and K % {1: SINGLE, 4: TRIO, 16: QUARTET}[T][0] == 0:
            has = {"register": layout[1] > 0, "lane": True, "warp": K - layout[0] - layout[1] > 5,
                   "cta": True, "top": True}
            full = {level for level, present in has.items() if present}
            _require(levels[0] == full and levels[1] == full, f"folds at every level at T={T}, K={K}")
        beta, scaling = genotyping_cuda.backward(K, T, P, diff, base, passign, trans, birth, dup)
        beta_p, scaling_p = genotyping_cuda.backward_plain(K, T, P, diff, base, passign, trans, birth, dup)
        red = genotyping_cuda.forward(K, T, P, diff, base, passign, trans, die_next, scaling, beta)
        red_p = genotyping_cuda.forward_plain(K, T, P, diff, base, passign, trans, die_next, scaling_p, beta_p)
        torch.cuda.synchronize()
        _witness_f64(f"geno kernels T={T:2d} K={K:2d}", K, T, P, x, beta, beta_p)
        e_bwd, e_fwd = _hold_geno(f"geno kernels T={T:2d} K={K:2d} P={P} B={n_blocks} C={n_cols}", K, T, P,
                                  stacked, (beta, scaling, red), (beta_p, scaling_p, red_p), n_blocks, n_cols)
        err["geno_backward"] = max(err["geno_backward"], e_bwd)
        err["geno_forward"] = max(err["geno_forward"], e_fwd)
        del beta, beta_p, x
    return err


def _lanes(K, n_ind):
    """Read lanes an individual such that K slots are active: K split as
    evenly as it goes, the first individuals taking the remainder."""
    return [K // n_ind + (1 if i < K % n_ind else 0) for i in range(n_ind)]


def wide_window_stats(K, T, P, flags, backward):
    """The wide kernels' windows (genotyping_cuda.wide_windows, the kernels'
    own rule) over the fold flags (B, C, K) of one pass: (windows, the
    longest, the windows that end where the next column's slots would pass
    the tile bits: the breaks)."""
    lb, cap = genotyping_cuda.wide_lb(K, T), genotyping_cuda.wide_window_cap(T, P, backward)
    uq = genotyping_cuda.wide_unions(flags, backward)
    win = genotyping_cuda.wide_windows(uq, lb, cap)
    starts = [q for q, n in enumerate(win) if n]
    breaks = sum(1 for q in starts if q + win[q] < len(win) and (q + win[q]) % cap)
    return len(starts), max(win), breaks


def wide_passes(K, T, flags) -> int:
    """The most passes a wide genotyping kernel takes at a column where the
    fold flags (B, C, K) fold: one, and one more for each further group of
    log2(min(2^K, 4096 / T)) slots (csrc/geno_wide.cuh)."""
    lb = int(math.log2(min(1 << K, genotyping_cuda.WIDE_TILE // T)))
    nf = int(flags.sum(dim=2).max())
    return -(-nf // lb) if nf > lb else 1


# genotyping past the cluster kernels (kernel rows 15-16): (T, K, pedigree)
# of the wide kernels' checks: one sample to K = 23 (at K = 14 windows of
# both passes that break where the slots born or dying pass the 12 tile
# bits, the backward's in two phases), a trio, a quartet,
# three founders (P = 6), four (P = 8), three children (T = 64) and four
# (T = 256), four trios of four founders (T = 256, P = 8)
GENO_WIDE_SHAPES = (
    (1, 14, SINGLE), (1, 18, SINGLE), (1, 20, SINGLE), (1, 23, SINGLE), (4, 17, TRIO), (4, 20, TRIO), (16, 14, QUARTET),
    (16, 12, DOUBLE_TRIO), (16, 10, FOUR_FOUNDERS), (64, 9, FAMILY5), (64, 15, FAMILY5), (256, 8, FAMILY6),
    (256, 6, FOUR_TRIOS),
)
# inside the cluster kernels' envelope, where the wide kernels are held to them
GENO_WIDE_CLUSTER_SHAPES = ((1, 7), (1, 17), (4, 12), (4, 16), (16, 13))
# five trios (T = 1024) and five founders (P = 10), at K 6 to 9 and 16
# columns (the float32 and float64 plain versions take 2^P assignments of
# every state and plane at P = 10)
GENO_FIVE_SHAPES = ((1024, 6, FAMILY7), (1024, 9, FAMILY7), (1024, 6, FIVE_BY_FIVE), (256, 8, FIVE_FOUNDERS))


def _witness_f64(label, K, T, P, x, beta, beta_p):
    """Print a kernel's and the float32 plain version's beta_store against
    the float64 plain version on the same inputs x (to_device's tensors),
    per entry and to its column's largest: a witness of where their
    differences come from, not gated."""
    diff, base, passign, trans, birth, _die_next, dup = x
    beta64, _s64 = genotyping_cuda.backward_plain(
        K, T, P, diff.double(), base.double(), passign.double(), trans.double(), birth, dup.double()
    )
    print(f"{label}: beta_store against the float64 plain version, per entry / to its column's largest: "
          f"kernel {_rel_err(beta, beta64):.3e} / {_col_err(beta, beta64):.3e}, float32 plain "
          f"{_rel_err(beta_p, beta64):.3e} / {_col_err(beta_p, beta64):.3e}", flush=True)


def _hold_geno(label, K, T, P, stacked, got, want, n_blocks, n_cols, nan_blocks=1):
    """Hold one forward-backward's outputs got = (beta_store, scaling, red)
    against want's on the same inputs: red and scaling within rtol 1e-4,
    beta_store within 1e-4 of its column's largest, likelihoods within atol
    1e-5, identical NaN patterns, and the zero-sum prior's NaN in
    `nan_blocks` blocks.  Returns the largest absolute errors (backward:
    beta_store and scaling; forward: red per column)."""
    beta, scaling, red = got
    beta_p, scaling_p, red_p = want
    rel = {"scaling": _rel_err(scaling, scaling_p), "beta_store": _col_err(beta, beta_p), "red": _rel_err(red, red_p)}
    _require(torch.equal(beta.isnan(), beta_p.isnan()), f"{label}: beta_store NaN patterns")
    shape4 = (n_blocks, n_cols, T, 1 << P)
    lik = genotyping.likelihoods_from_red(red.reshape(shape4).double().cpu().numpy(), stacked[7][0])
    lik_p = genotyping.likelihoods_from_red(red_p.reshape(shape4).double().cpu().numpy(), stacked[7][0])
    e_lik = _lik_err(lik, lik_p)
    blocks = int(np.isnan(lik).any(axis=(1, 2, 3)).sum())
    print(f"{label}: rel err scaling {rel['scaling']:.3e} red {rel['red']:.3e}, beta_store to its column's "
          f"largest {rel['beta_store']:.3e}; likelihoods max|err|={e_lik:.3e}; blocks with NaN {blocks}", flush=True)
    _require(rel["scaling"] <= 1e-4 and rel["red"] <= 1e-4 and rel["beta_store"] <= 1e-4 and e_lik <= 1e-5,
             f"{label}: agree")
    _require(blocks == nan_blocks, f"{label}: the zero-sum prior's NaN stays in its block")
    return max(_abs_err(beta, beta_p), _abs_err(scaling, scaling_p)), _abs_err(_per_col(red), _per_col(red_p))


def compare_geno_wide(device, shapes=GENO_WIDE_SHAPES, n_blocks=3, cols=None, check_windows=True):
    """Phase geno-kernels, rows 15-16: both wide genotyping kernels (the state
    in device memory) against their float32 plain versions on the same CUDA
    tensors at (T, K, pedigree), C = 128 columns below K = 18 and 64 from
    it: block 0 has a zero-sum prior column, block 1 a new range at column
    C // 3 with all its slots born (past a tile's bits: further fold passes,
    which each shape must take in the backward, and some in the forward).  The bars of
    compare_geno_kernels (_hold_geno); each kernel's and the float32 plain
    version's beta_store against the float64 plain version printed, not
    gated.  `cols` sets the columns of every shape; with check_windows the
    shapes must take, all told, further fold passes in the forward and
    windows that break at the tile bits in both passes.  Returns {kernel
    name: max abs error}."""
    err = {"geno_backward_wide": 0.0, "geno_forward_wide": 0.0}
    fwd_passes = 1
    breaks = [0, 0]
    for T, K, pedigree in shapes:
        n_cols = cols or (128 if K < 18 else 64)
        P, stacked = geno_bucket(T, K, n_blocks, n_cols, 5000 + 10 * K + T, pedigree=pedigree,
                                 coverage=_lanes(K, pedigree[0]), break_block=1)
        x = genotyping.to_device(stacked, torch.device(device))
        diff, base, passign, trans, birth, die_next, dup = x
        label = f"geno wide T={T:3d} P={P} K={K:2d} B={n_blocks} C={n_cols}"
        passes = (wide_passes(K, T, birth[:, 1:]), wide_passes(K, T, die_next))
        print(f"{label}: tiles of {min(1 << K, genotyping_cuda.WIDE_TILE // T)} states in {T} planes, "
              f"{genotyping_cuda.wide_tiles(K, T)} an instance; most passes a column {passes[0]} "
              f"(backward), {passes[1]} (forward)", flush=True)
        _require(passes[0] > 1, f"{label}: further fold passes in the backward")
        fwd_passes = max(fwd_passes, passes[1])
        stats = (wide_window_stats(K, T, P, birth, True), wide_window_stats(K, T, P, die_next, False))
        print(f"{label}: windows (count, longest, breaks) {stats[0]} (backward), {stats[1]} (forward)", flush=True)
        breaks = [x + st[2] * (st[1] > 1) for x, st in zip(breaks, stats)]
        before = (genotyping_cuda.backward_wide.launches, genotyping_cuda.forward_wide.launches)
        beta, scaling = genotyping_cuda.backward_wide(K, T, P, diff, base, passign, trans, birth, dup)
        red = genotyping_cuda.forward_wide(K, T, P, diff, base, passign, trans, die_next, scaling, beta)
        torch.cuda.synchronize()
        _require((genotyping_cuda.backward_wide.launches, genotyping_cuda.forward_wide.launches)
                 == (before[0] + 1, before[1] + 1), f"{label}: one launch of each wide kernel")
        beta_p, scaling_p = genotyping_cuda.backward_plain(K, T, P, diff, base, passign, trans, birth, dup)
        red_p = genotyping_cuda.forward_plain(K, T, P, diff, base, passign, trans, die_next, scaling_p, beta_p)
        e_bwd, e_fwd = _hold_geno(label, K, T, P, stacked, (beta, scaling, red), (beta_p, scaling_p, red_p),
                                  n_blocks, n_cols)
        _witness_f64(label, K, T, P, x, beta, beta_p)
        err["geno_backward_wide"] = max(err["geno_backward_wide"], e_bwd)
        err["geno_forward_wide"] = max(err["geno_forward_wide"], e_fwd)
        del beta, beta_p, x
    if check_windows:
        _require(fwd_passes > 1, "further fold passes in the forward")
        _require(all(breaks), "windows of several columns that break at the tile bits, in both passes")
    return err


def compare_geno_wide_cluster(device, shapes=GENO_WIDE_CLUSTER_SHAPES, n_blocks=3, n_cols=96):
    """Phase geno-kernels: the wide genotyping kernels against the cluster
    kernels (rows 11-12) inside the cluster kernels' envelope, at (T, K), on
    the same CUDA tensors, with compare_geno_kernels' bars."""
    for T, K in shapes:
        P, stacked = geno_bucket(T, K, n_blocks, n_cols, 6000 + 10 * K + T, break_block=1)
        diff, base, passign, trans, birth, die_next, dup = genotyping.to_device(stacked, torch.device(device))
        _require(genotyping_cuda.kernel_supported(K, T, P), f"T={T}, K={K} inside the cluster envelope")
        beta, scaling = genotyping_cuda.backward_wide(K, T, P, diff, base, passign, trans, birth, dup)
        red = genotyping_cuda.forward_wide(K, T, P, diff, base, passign, trans, die_next, scaling, beta)
        beta_c, scaling_c = genotyping_cuda.backward(K, T, P, diff, base, passign, trans, birth, dup)
        red_c = genotyping_cuda.forward(K, T, P, diff, base, passign, trans, die_next, scaling_c, beta_c)
        torch.cuda.synchronize()
        _hold_geno(f"geno wide against cluster T={T:2d} K={K:2d}", K, T, P, stacked, (beta, scaling, red),
                   (beta_c, scaling_c, red_c), n_blocks, n_cols)


def genotype_instance(spec, device, label, check_cols, atol):
    """Phase genotype / genotype-trio: a simulated chromosome through
    GenotypeDPTable(device="cuda") with the genotyping kernels' launch
    counters set to 0 just before and read just after (one launch of each
    expected), then the same instance through the route's pieces with a time
    split, GT concordance with the simulated genotypes, and a check of the
    likelihoods against the float64 plain route on the card on a
    `check_cols`-column instance of the same generator within `atol`.
    spec = (n_cols, coverage, pedigree, seed).  Returns the prepared static
    shape and stacked inputs."""
    n_cols, coverage, pedigree, seed = spec
    t0 = time.perf_counter()
    rs, pos, ped, nsi, truth = simulate_genotyping(n_cols, coverage, pedigree, seed)
    print(f"{label}: chromosome built in {time.perf_counter() - t0:.1f} s", flush=True)
    rc = [10] * n_cols
    n_ind = pedigree[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    table = core.GenotypeDPTable(nsi, rs, rc, ped, pos, device=device)
    likelihoods = [[table.get_genotype_likelihoods(f"ind{i}", c).as_vector() for c in range(n_cols)]
                   for i in range(n_ind)]
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    packed = table._packed
    print(f"{label}: {n_cols} variants, {len(rs)} reads, K={packed.K}, T={packed.T}, P={packed.P}; "
          f"wall {wall:.3f} s = {n_cols / wall:.1f} variants genotyped/s; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    _require(launches["geno_backward"] == 1 and launches["geno_forward"] == 1,
             f"{label}: one launch of each genotyping kernel")
    lik = np.asarray(likelihoods, dtype=np.float64)  # (n_ind, C, 3)
    _require(lik.shape == (n_ind, n_cols, 3) and np.isfinite(lik).all(), f"{label}: finite likelihoods")
    _require(np.allclose(lik.sum(axis=2), 1.0, atol=1e-5), f"{label}: likelihoods sum to 1")
    concordance = float(np.mean(lik.argmax(axis=2) == truth))
    print(f"{label}: GT concordance with the simulated genotypes {concordance:.4f}", flush=True)
    _require(concordance > 0.9, f"{label}: genotypes recovered")

    # the same instance again, timed between synchronisations
    dev = torch.device(device)
    t0 = time.perf_counter()
    packed = wmec.pack_problem(rs, rc, ped, False, pos, check_conflicts=False, emission_tables=False)
    t1 = time.perf_counter()
    static, stacked = genotyping.prepare_genotyping_batch([packed], ped)
    t2 = time.perf_counter()
    x = genotyping.to_device(stacked, dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    red = genotyping.forward_backward(*static[:3], *x)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    lik_split = genotyping.likelihoods_from_red(red.to("cpu", torch.float64).numpy(), stacked[7][0])[0]
    t5 = time.perf_counter()
    split = {"pack": t1 - t0, "prepare": t2 - t1, "h2d": t3 - t2, "kernels": t4 - t3,
             "d2h+marginals": t5 - t4}
    text = " ".join(f"{k} {v:.3f}" for k, v in split.items())
    print(f"{label}: split (s): {text}; total {t5 - t0:.3f}", flush=True)
    _require(np.array_equal(lik_split, table._likelihoods), f"{label}: split run agrees")
    del x, red

    # the float64 plain route on the card, on a shorter instance
    rs_c, pos_c, ped_c, nsi_c, _truth = simulate_genotyping(check_cols, coverage, pedigree, seed + 1)
    small = core.GenotypeDPTable(nsi_c, rs_c, [10] * check_cols, ped_c, pos_c, device=device)
    st_c, stk_c = genotyping.prepare_genotyping_batch([small._packed], ped_c)
    t0 = time.perf_counter()
    trans, passign, base, diff, birth, die_next, dup, _gmask = (torch.from_numpy(a).to(dev) for a in stk_c)
    red64, _scaling = genotyping.forward_backward_plain(
        *st_c[:3], diff, base, passign, trans, birth, die_next, dup
    )
    ref = genotyping.likelihoods_from_red(red64.cpu().numpy(), stk_c[7][0])[0]
    e = _lik_err(small._likelihoods, ref)
    print(f"{label}: {check_cols}-column instance (K={small._packed.K}) against the float64 plain "
          f"route on the card ({time.perf_counter() - t0:.1f} s): likelihoods max|err|={e:.3e} "
          f"(limit {atol})", flush=True)
    _require(e <= atol, f"{label}: kernels agree with the float64 plain route")
    return static, stacked


def time_geno_kernels(static, stacked, label, device="cuda"):
    """Phase timing, genotyping: each kernel at a genotyping cell's shape
    (CUDA events), beside its float32 plain version on the same inputs and
    its bound: the larger of the bytes (each input read once, each output
    written once), the exps and the f32 adds of the emission sums over
    their rates.  The work counted is the least the function needs: in Gray
    order a state's log-emission sums differ from its neighbour's by one
    diff row, T*P*2 adds per state and column; exp of a sum over the P
    partitions is the product of per-partition exps, T*P*2 exps per state
    and column, not one per allele assignment."""
    K, T, P, _n = static
    x = genotyping.to_device(stacked, torch.device(device))
    diff, base, passign, trans, birth, die_next, dup = x
    B, C, S = diff.shape[0], diff.shape[1], 1 << K
    bwd_ms = _time(lambda: genotyping_cuda.backward(K, T, P, diff, base, passign, trans, birth, dup), reps=1)
    beta, scaling = genotyping_cuda.backward(K, T, P, diff, base, passign, trans, birth, dup)
    fwd_ms = _time(lambda: genotyping_cuda.forward(K, T, P, diff, base, passign, trans, die_next, scaling, beta), reps=1)
    red = genotyping_cuda.forward(K, T, P, diff, base, passign, trans, die_next, scaling, beta)
    (beta_p, scaling_p), bwd_plain_ms = _plain_ms(
        lambda: genotyping_cuda.backward_plain(K, T, P, diff, base, passign, trans, birth, dup))
    rel_bwd = max(_rel_err(scaling, scaling_p), _col_err(beta, beta_p))
    _require(torch.equal(beta.isnan(), beta_p.isnan()), f"{label}: beta_store NaN patterns")
    abs_bwd = max(_abs_err(scaling, scaling_p), _abs_err(beta, beta_p))
    del beta_p
    red_p, fwd_plain_ms = _plain_ms(
        lambda: genotyping_cuda.forward_plain(K, T, P, diff, base, passign, trans, die_next, scaling, beta))
    rel_fwd = _rel_err(red, red_p)
    print(f"{label}: kernels against plain at the cell: rel err scaling and beta_store (to its "
          f"column's largest) {rel_bwd:.3e}, red {rel_fwd:.3e} (largest |red| "
          f"{float(red_p.abs().nan_to_num().max()):.3e}, |scaling| "
          f"{float(scaling_p.abs().nan_to_num().max()):.3e})", flush=True)
    _require(rel_bwd <= 1e-4 and rel_fwd <= 1e-4, f"{label}: genotyping kernels agree with plain at the cell")
    cta, _reg, threads = genotyping_cuda.cluster_layout(K)
    cells = B * C * S
    exps_ms = cells * T * P * 2 / PEAK_EXP_PER_S * 1e3
    adds_ms = cells * T * P * 2 / PEAK_F32_ADDS_PER_S * 1e3
    common = _nbytes(diff, base, passign, trans)
    out = {}
    for name, ms, plain_ms, nbytes, err in (
        ("geno_backward", bwd_ms, bwd_plain_ms, common + _nbytes(birth, dup, beta, scaling), abs_bwd),
        ("geno_forward", fwd_ms, fwd_plain_ms, common + _nbytes(die_next, scaling, beta, red),
         _abs_err(_per_col(red), _per_col(red_p))),
    ):
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        bound = max(bytes_ms, exps_ms, adds_ms)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, max_abs_err=err,
                         bound_by="bytes" if bound == bytes_ms else "operations")
        print(f"{label} {name} (B={B} C={C} K={K} T={T} P={P}): {ms:.3f} ms (plain "
              f"{plain_ms:.3f} ms), bound {bound:.4f} ms by {out[name]['bound_by']} (bytes "
              f"{bytes_ms:.4f}, exp {exps_ms:.4f}, f32 adds {adds_ms:.4f} ms); N = {1 << cta} "
              f"CTAs of {threads} threads per instance, {min(132, B << cta)} of 132 SMs; "
              f"{100 * bound / ms:.3f} % of the bound", flush=True)
    return out


# ---------------------------------------------------------------------------
# the phase CLI on files: a synthetic chromosome or trio on disk, phased by
# whatshap_torch.cli.phase.run_whatshap on the card


BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def write_synth(out_dir, n_vars, coverage, seed, trio=False, vars_per_read=30, spacing=150,
                err=0.02, break_every=64, recomb_per_block=0.2, mixed=False, children=1):
    """Write a synthetic chromosome (the generator of tools/make_synth_chrom.py,
    on numpy's seeded generator): ref.fasta and its .fai, variants.vcf of
    biallelic SNVs every `spacing` bases, reads.bam (with a minimal .bai) of
    all-match reads drawn from one haplotype each, `vars_per_read` variants
    long, confined to `break_every`-variant windows, at `coverage` reads over
    each variant of each sample, with `err` of the alleles flipped.  One
    sample, heterozygous at every site (with `mixed`, its two haplotypes
    drawn independently: hom ref, het and hom alt in the ratio 1:2:1, for the
    genotype CLI); or, with `trio`, a mother and a father
    with random haplotypes and a child that inherits one of each parent's,
    switching at a window boundary with probability `recomb_per_block`, one
    read group per sample and family.ped; with `children` above 1, that many
    children of the two (child1, child2, ...; three make the shape of
    tests/data/recombination_breaks.ped, T = 64).  Returns the paths, the sample
    names, each sample's simulated haplotypes, (2, n_vars), and each read's
    haplotype of origin (`origin`: 0 or 1 by read id, the N of its name
    readN)."""
    from pathlib import Path

    from whatshap_torch.io.sam import AlignedSegment, AlignmentFile, AlignmentHeader, build_minimal_index

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    contig, ref_len = "chr1", (n_vars + 2) * spacing
    ref_code = rng.integers(0, 4, ref_len)
    ref = BASES[ref_code]
    pos = (np.arange(n_vars) + 1) * spacing  # 0-based
    alt = BASES[(ref_code[pos] + rng.integers(1, 4, n_vars)) % 4]
    if trio:
        mother, father = rng.integers(0, 2, (2, n_vars)), rng.integers(0, 2, (2, n_vars))
        cols = np.arange(n_vars)

        def inherit(parent):
            cross = (cols % break_every == 0) & (cols > 0) & (rng.random(n_vars) < recomb_per_block)
            return parent[(rng.integers(0, 2) + np.cumsum(cross)) % 2, cols]

        kids = ["child"] if children == 1 else [f"child{i + 1}" for i in range(children)]
        haps = {"mother": mother, "father": father}
        for kid in kids:
            haps[kid] = np.stack([inherit(mother), inherit(father)])
    else:
        h0 = rng.integers(0, 2, n_vars)
        haps = {"sample": np.stack([h0, rng.integers(0, 2, n_vars) if mixed else 1 - h0])}
    names = list(haps)

    seq = ref.tobytes()
    fasta = out / "ref.fasta"
    with open(fasta, "wb") as f:
        f.write(f">{contig}\n".encode())
        f.write(b"".join(seq[i : i + 60] + b"\n" for i in range(0, ref_len, 60)))
    with open(f"{fasta}.fai", "w") as f:
        f.write(f"{contig}\t{ref_len}\t{len(contig) + 2}\t60\t61\n")

    gts = np.stack([np.char.add(np.char.add(np.minimum(*h).astype(str), "/"), np.maximum(*h).astype(str))
                    for h in haps.values()], axis=1)
    vcf = out / "variants.vcf"
    with open(vcf, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={contig},length={ref_len}>\n")
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + "\t".join(names) + "\n")
        refs, alts = ref[pos].tobytes().decode(), alt.tobytes().decode()
        f.writelines(f"{contig}\t{p + 1}\t.\t{refs[i]}\t{alts[i]}\t50\tPASS\t.\tGT\t" + "\t".join(gts[i]) + "\n"
                     for i, p in enumerate(pos.tolist()))
    ped = None
    if trio:
        ped = out / "family.ped"
        ped.write_text("".join(f"FAM {kid} father mother 0 0\n" for kid in kids)
                       + "FAM father 0 0 0 0\nFAM mother 0 0 0 0\n")

    reads = []  # (start, read id, sample, sequence)
    origin = []  # by read id: the haplotype the read was drawn from
    for name in names:
        h = haps[name]
        for v_lo in range(0, n_vars, break_every):
            v_hi = min(v_lo + break_every, n_vars)
            span = min(vars_per_read, v_hi - v_lo)
            n_reads = max(1, round(coverage * (v_hi - v_lo) / span))
            which = rng.integers(0, 2, n_reads)
            v_start = rng.integers(v_lo, v_hi - span + 1, n_reads)
            lead = rng.integers(10, spacing - 10, (n_reads, 2))
            for r in range(n_reads):
                a, b = int(v_start[r]), int(v_start[r]) + span
                g0, g1 = int(pos[a]) - int(lead[r, 0]), int(pos[b - 1]) + int(lead[r, 1])
                bases = ref[g0:g1].copy()
                allele = h[which[r], a:b] ^ (rng.random(span) < err)
                at = allele == 1
                bases[pos[a:b][at] - g0] = alt[a:b][at]
                reads.append((g0, len(reads), name, bases.tobytes().decode()))
                origin.append(int(which[r]))
    reads.sort()
    header = AlignmentHeader.from_dict({
        "HD": {"VN": "1.6", "SO": "coordinate"},
        "SQ": [{"SN": contig, "LN": ref_len}],
        "RG": [{"ID": name, "SM": name} for name in names],
    })
    bam = out / "reads.bam"
    bf = AlignmentFile(str(bam), "wb", header=header)
    for g0, rid, name, sq in reads:
        seg = AlignedSegment(header)
        seg.query_name = f"read{rid}"
        seg.flag = 0
        seg.reference_id = 0
        seg.reference_start = g0
        seg.mapping_quality = 50
        seg.cigartuples = [(0, len(sq))]
        seg.query_sequence = sq
        seg.query_qualities = bytes([30]) * len(sq)
        seg.tags = {"RG": name}
        bf.write(seg)
    bf.close()
    build_minimal_index(str(bam))
    return {"fasta": str(fasta), "bam": str(bam), "vcf": str(vcf), "ped": None if ped is None else str(ped),
            "n_vars": n_vars, "n_reads": len(reads), "spacing": spacing, "haps": haps,
            "origin": np.array(origin, dtype=np.int8)}


def write_synth_poly(out_dir, n_vars, coverage, seed, ploidy=4, vars_per_read=30, spacing=150, err=0.02):
    """Write a synthetic polyploid chromosome, as write_synth writes a
    diploid one: variants.vcf of biallelic SNVs every `spacing` bases, one
    sample whose `ploidy` haplotypes are drawn at random (no site
    homozygous), and reads.bam (with a minimal .bai) of all-match reads
    `vars_per_read` variants long, drawn from one haplotype each and placed
    at random over the whole chromosome, `coverage` reads over a variant on
    average, with `err` of the alleles flipped.  Returns the paths and the
    haplotypes, (ploidy, n_vars)."""
    from pathlib import Path

    from whatshap_torch.io.sam import AlignedSegment, AlignmentFile, AlignmentHeader, build_minimal_index

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    contig, ref_len = "chr1", (n_vars + 2) * spacing
    ref_code = rng.integers(0, 4, ref_len)
    ref = BASES[ref_code]
    pos = (np.arange(n_vars) + 1) * spacing  # 0-based
    alt = BASES[(ref_code[pos] + rng.integers(1, 4, n_vars)) % 4]
    haps = rng.integers(0, 2, (ploidy, n_vars))
    flat = haps.min(axis=0) == haps.max(axis=0)
    haps[rng.integers(0, ploidy, n_vars)[flat], np.flatnonzero(flat)] ^= 1
    gts = ["/".join("1" * int(d) + "0" * (ploidy - int(d)))[::-1] for d in haps.sum(axis=0)]
    vcf = out / "variants.vcf"
    with open(vcf, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={contig},length={ref_len}>\n")
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsample\n")
        refs, alts = ref[pos].tobytes().decode(), alt.tobytes().decode()
        f.writelines(f"{contig}\t{p + 1}\t.\t{refs[i]}\t{alts[i]}\t50\tPASS\t.\tGT\t{gts[i]}\n"
                     for i, p in enumerate(pos.tolist()))

    n_reads = round(coverage * n_vars / vars_per_read)
    which = rng.integers(0, ploidy, n_reads)
    v_start = np.sort(rng.integers(0, n_vars - vars_per_read + 1, n_reads))
    lead = rng.integers(10, spacing - 10, (n_reads, 2))
    header = AlignmentHeader.from_dict({
        "HD": {"VN": "1.6", "SO": "coordinate"},
        "SQ": [{"SN": contig, "LN": ref_len}],
        "RG": [{"ID": "sample", "SM": "sample"}],
    })
    bam = out / "reads.bam"
    bf = AlignmentFile(str(bam), "wb", header=header)
    for r in range(n_reads):
        a, b = int(v_start[r]), int(v_start[r]) + vars_per_read
        g0, g1 = int(pos[a]) - int(lead[r, 0]), int(pos[b - 1]) + int(lead[r, 1])
        bases = ref[g0:g1].copy()
        at = (haps[which[r], a:b] ^ (rng.random(vars_per_read) < err)) == 1
        bases[pos[a:b][at] - g0] = alt[a:b][at]
        seg = AlignedSegment(header)
        seg.query_name = f"read{r}"
        seg.flag = 0
        seg.reference_id = 0
        seg.reference_start = g0
        seg.mapping_quality = 50
        seg.cigartuples = [(0, g1 - g0)]
        seg.query_sequence = bases.tobytes().decode()
        seg.query_qualities = bytes([30]) * (g1 - g0)
        seg.tags = {"RG": "sample"}
        bf.write(seg)
    bf.close()
    build_minimal_index(str(bam))
    return {"bam": str(bam), "vcf": str(vcf), "n_vars": n_vars, "n_reads": n_reads, "haps": haps}


def switch_error_rates(vcf_text, data) -> dict:
    """Per sample, the switch-error rate of a phased VCF against the
    simulated haplotypes, counted as bench.py's CLI leg counts it: over
    consecutive phased calls of one phase set (PS), the share where the
    called haplotype's agreement with the first simulated one flips; only
    sites heterozygous in the simulation count."""
    samples = list(data["haps"])
    blocks = {s: {} for s in samples}
    for line in vcf_text.splitlines():
        if not line or line.startswith("#"):
            continue
        f = line.split("\t")
        vi = int(f[1]) // data["spacing"] - 1
        keys = f[8].split(":")
        for s, value in zip(samples, f[9:]):
            call = dict(zip(keys, value.split(":")))
            gt = call.get("GT", "")
            h = data["haps"][s]
            if "|" not in gt or h[0, vi] == h[1, vi]:
                continue
            blocks[s].setdefault(call.get("PS"), []).append((vi, int(gt.split("|")[0]) ^ int(h[0, vi])))
    rates = {}
    for s in samples:
        pairs = switches = 0
        for members in blocks[s].values():
            rel = [r for _vi, r in sorted(members)]
            pairs += len(rel) - 1
            switches += sum(x != y for x, y in zip(rel, rel[1:]))
        rates[s] = (switches / pairs if pairs else None, pairs)
    return rates


@contextlib.contextmanager
def counted_tables(calls: list):
    """Keep the packed problem of each PedigreeDPTable the phase CLI makes."""
    from whatshap_torch.cli import phase as phase_cli

    real = phase_cli.PedigreeDPTable

    class Counted(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            calls.append(self._packed)

    phase_cli.PedigreeDPTable = Counted
    try:
        yield
    finally:
        phase_cli.PedigreeDPTable = real


@contextlib.contextmanager
def plain_route():
    """Every run_dp of the block in the plain torch route on the card: the
    route's seams (solve, forward_m, solve_seeded, solve_segmented) get the
    torch mirror, chunked as the route chunks, in place of the kernels."""
    real = wmec.run_dp

    def run_dp(packed, device=None):
        return real(packed, device, solve=plain_solve, forward_m=plain_forward_m,
                    solve_seeded=plain_solve_seeded, solve_segmented=wmec.solve_segmented)

    wmec.run_dp = run_dp
    try:
        yield
    finally:
        wmec.run_dp = real


@contextlib.contextmanager
def solve_events(pairs: list):
    """Record a pair of CUDA events around each solve of the block's run_dp
    calls (the route's default seams, unchanged; no synchronisation added):
    the device time of the solves, an upper bound on the card's busy time."""
    real = wmec.run_dp

    def timed(fn):
        def run(*args):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            stop.record()
            pairs.append((start, stop))
            return out
        return run

    def run_dp(packed, device=None):
        return real(packed, device, solve=timed(wmec.solve_batched_auto), forward_m=timed(wmec.forward_m_auto),
                    solve_seeded=timed(wmec.solve_seeded_auto), solve_segmented=timed(wmec.solve_segmented_auto))

    wmec.run_dp = run_dp
    try:
        yield
    finally:
        wmec.run_dp = real


@functools.lru_cache(maxsize=None)
def card_name_and_power() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def host_context() -> str:
    """What a CLI cell's stage times depend on: the card and the host's CPUs."""
    return f"{card_name_and_power()}; {os.cpu_count()} host CPUs"


@contextlib.contextmanager
def python_host_paths():
    """The host work on the Python versions of the host helpers: every
    attribute of hostlib None (the Python record loop, realignment and edit
    distances, selection and heap, the HapCHAT and heuristic solvers, the
    switch/flip distance, polyphase's read-pair scoring, cluster editing and
    threading), restored after the block.  In this process only: a spawned
    worker (polyphase --threads > 1) loads the libraries."""
    saved = {name: getattr(hostlib, name) for name in hostlib.__all__}
    for name in saved:
        setattr(hostlib, name, None)
    try:
        yield
    finally:
        for name, lib in saved.items():
            setattr(hostlib, name, lib)


SEGMENT_FIELDS = ("query_name", "flag", "reference_id", "reference_start", "mapping_quality", "cigartuples",
                  "next_reference_id", "next_reference_start", "template_length", "query_sequence",
                  "query_qualities", "tags")


def _read_rows(data):
    """The rows of every Read of `data`'s sample(s), read as the phase CLI
    reads them (PhasedInputReader, realignment against the FASTA), and the
    ReadSets."""
    from whatshap_torch.cli import PhasedInputReader
    from whatshap_torch.core import NumericSampleIds
    from whatshap_torch.vcf import VcfReader

    vcf = VcfReader(data["vcf"], phases=False, only_snvs=False)
    table = next(iter(vcf))
    rows, sets = [], []
    with PhasedInputReader([data["bam"]], data["fasta"], NumericSampleIds(), ignore_read_groups=False,
                           only_snvs=False, mapq_threshold=20) as reader:
        for sample in vcf.samples:
            readset, _ = reader.read(table.chromosome, table.variants, sample, read_vcf=False)
            sets.append(readset)
            rows += [(r.name, r.source_id, r.sample_id, r.reference_start, r.reference_end, r.BX_tag, r.HP_tag,
                      r.PS_tag, r.is_reverse, tuple(r._mapqs), tuple(r._positions), tuple(r._alleles),
                      tuple(r._qualities)) for r in readset]
    return rows, sets


def host_phase(tmp) -> None:
    """Phase 10: the host helpers against their Python paths (the BAM pool
    decode, the reads through the realignment pool, readselection) on a
    HOST_CUT_VARIANTS-variant file of phase-cli's generator, then the phase
    CLI on that file through both, byte-identical."""
    from whatshap_torch.cli import phase as phase_cli
    from whatshap_torch.io.sam import AlignmentFile
    from whatshap_torch.readselect import readselection

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    def decode():
        return [tuple(repr(getattr(seg, k)) for k in SEGMENT_FIELDS) for seg in AlignmentFile(data["bam"])]

    def select():
        return [sorted(readselection(rs, 15)) for rs in sets]

    data = write_synth(f"{tmp}/host-cut", HOST_CUT_VARIANTS, 14, seed=7)
    clear_bam_pool_cache()
    native, t_native = timed(decode)
    with python_host_paths():
        python, t_python = timed(decode)
    _require(len(native) > 0 and native == python, "host: the BAM pool decode equals the Python record loop")
    print(f"host: BAM pool decode of {len(native)} records {t_native:.3f} s, the Python record loop "
          f"{t_python:.3f} s; records equal: True", flush=True)
    del native, python
    clear_bam_pool_cache()
    (rows, sets), t_native = timed(lambda: _read_rows(data))
    with python_host_paths():
        (rows_py, _sets), t_python = timed(lambda: _read_rows(data))
    _require(len(rows) > 0 and rows == rows_py, "host: the realignment pool's reads equal the Python realignment's")
    print(f"host: {len(rows)} reads through the BAM pool and the realignment pool {t_native:.3f} s, the Python "
          f"realignment {t_python:.3f} s; reads equal: True", flush=True)
    del rows, rows_py, _sets
    picked, t_native = timed(select)
    with python_host_paths():
        picked_py, t_python = timed(select)
    _require(picked == picked_py and 0 < sum(map(len, picked)), "host: readselection equals the Python selection")
    print(f"host: readselection of {sum(map(len, picked))} of {sum(map(len, sets))} reads (max coverage 15) "
          f"{t_native:.3f} s, the Python selection {t_python:.3f} s; equal: True", flush=True)
    del sets

    args = dict(phase_input_files=[data["bam"]], variant_file=data["vcf"], reference=data["fasta"],
                write_command_line_header=False, device="cuda")
    texts = {}
    for route, paths in (("helpers", contextlib.nullcontext()), ("python", python_host_paths())):
        clear_bam_pool_cache()
        out = f"{tmp}/host-cut/{route}.vcf"
        t0 = time.perf_counter()
        with paths:
            phase_cli.run_whatshap(**args, output=out)
        wall = time.perf_counter() - t0
        timers = phase_cli.LAST_TIMERS
        stages = " ".join(f"{k} {timers.elapsed(k):.3f}" for k in ("parse_vcf", "read_bam", "select", "phase",
                                                                    "components", "write_vcf"))
        print(f"host: phase-cli-{HOST_CUT_VARIANTS} through the {route} host path: wall {wall:.3f} s = "
              f"{HOST_CUT_VARIANTS / wall:.1f} variants phased/s; stages (s): {stages} ({host_context()})",
              flush=True)
        with open(out) as f:
            texts[route] = f.read()
    _require(texts["helpers"] == texts["python"], "host: the phase CLI's VCF is byte-identical on both host paths")
    print(f"host: phase-cli-{HOST_CUT_VARIANTS} VCF byte-identical through the helpers and the Python paths: True",
          flush=True)


def write_minimal_tbi(vcf_gz, contigs) -> None:
    """Write a structurally valid (empty) tabix index next to a bgzipped VCF,
    as write_synth's BAM gets a minimal .bai: the port's VCF reader scans and
    filters, and takes the index as the existence check that indexed access
    needs (haplotag fetches its VCF by region)."""
    import struct

    from whatshap_torch.io.bgzf import BGZFWriter

    names = b"".join(c.encode() + b"\0" for c in contigs)
    # VCF format (2), sequence column 1, begin column 2, no end column,
    # meta character '#', no lines skipped
    body = b"TBI\x01" + struct.pack("<8i", len(contigs), 2, 1, 2, 0, ord("#"), 0, len(names)) + names
    body += struct.pack("<2i", 0, 0) * len(contigs)  # n_bin, n_intv of each contig
    with open(f"{vcf_gz}.tbi", "wb") as raw:
        writer = BGZFWriter(raw)
        writer.write(body)
        writer.close()


def _text(path) -> str:
    """A VCF or TSV, bgzipped or not, as text."""
    import gzip

    with (gzip.open(path, "rt") if str(path).endswith(".gz") else open(path)) as f:
        return f.read()


def write_truth_vcf(data, path) -> None:
    """`data`'s variants.vcf with its one sample's simulated haplotypes as
    phased genotypes (h0|h1, one phase set): compare's truth."""
    (h,) = data["haps"].values()
    with open(data["vcf"]) as src, open(path, "w") as out:
        i = 0
        for line in src:
            if not line.startswith("#"):
                line = line[: line.rindex("\t") + 1] + f"{h[0, i]}|{h[1, i]}\n"
                i += 1
            out.write(line)


def _tsv_rows(path):
    """The rows of a TSV with a #-header line, as dicts."""
    with open(path) as f:
        header, *rows = [line.rstrip("\n").split("\t") for line in f]
    return [dict(zip([h.lstrip("#") for h in header], row)) for row in rows]


def _haplotype_strings(path):
    """The two haplotypes of a one-sample VCF's phased calls, every call
    read as one block, as strings, and the calls' positions."""
    calls = [(pos, gt.split("|")) for (_c, pos, _s), gt, _q, _l in vcf_calls(_text(path)) if "|" in gt]
    return [pos for pos, _gt in calls], ["".join(gt[h] for _pos, gt in calls) for h in (0, 1)]


def tools_phase(tmp) -> None:
    """Phase 11b, tools: the subcommands that follow phase, on files of
    phase-cli's generator (TOOLS_VARIANTS variants at coverage 14): phase on
    the card (rows 1-2, launches counted), compare against the simulated
    haplotypes (switch-error rate under phase-cli's 5 %), stats (blocks,
    N50), haplotag (HP on at least 0.9 of the reads over two or more
    heterozygous sites, and agreeing with each read's haplotype of origin in
    at least 0.95 of the tagged reads, within each phase set up to a swap),
    split by haplotag's list (the reads add up), unphase (the input's
    genotypes), phase --algorithm heuristic (the 5 % gate) and --algorithm
    hapchat on one read-connected block of TOOLS_BLOCK_VARIANTS (the gate
    too); then the host solvers against their Python paths
    (python_host_paths): hapchat's and heuristic's VCFs on the block's files,
    and compare's switch/flip distance (SwitchFlipCalculator) of phase's
    calls, read as one block, against the truth.  Each tool's wall time is
    printed."""
    from whatshap_torch.cli import phase as phase_cli
    from whatshap_torch.cli.compare import run_compare
    from whatshap_torch.cli.haplotag import run_haplotag
    from whatshap_torch.cli.split import run_split
    from whatshap_torch.cli.stats import run_stats
    from whatshap_torch.cli.unphase import run_unphase
    from whatshap_torch.io.sam import AlignmentFile
    from whatshap_torch.polyphase.solver import SwitchFlipCalculator

    t0 = time.perf_counter()
    out = f"{tmp}/tools"
    data = write_synth(out, TOOLS_VARIANTS, 14, seed=47)
    block = write_synth(f"{tmp}/tools-block", TOOLS_BLOCK_VARIANTS, 14, seed=53, break_every=TOOLS_BLOCK_VARIANTS)
    print(f"tools: files written in {time.perf_counter() - t0:.1f} s", flush=True)
    walls = {}

    def timed(name, fn):  # what a tool prints (compare's report) is not shown
        clear_bam_pool_cache()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            fn()
        walls[name] = time.perf_counter() - t0

    def phase(files, algorithm, output):
        phase_cli.run_whatshap(phase_input_files=[files["bam"]], variant_file=files["vcf"],
                               reference=files["fasta"], write_command_line_header=False, device="cuda",
                               algorithm=algorithm, output=output)

    def gate(label, path, files):
        rate, pairs = switch_error_rates(_text(path), files)["sample"]
        print(f"tools: {label}: switch-error rate against the simulated haplotypes {rate} over {pairs} pairs",
              flush=True)
        _require(rate is not None and rate < 0.05 and pairs > 0.9 * files["n_vars"], f"tools: {label} recovers "
                 "the haplotypes")

    phased = f"{out}/phased.vcf.gz"  # bgzipped, and indexed below: haplotag fetches by region
    torch.cuda.synchronize()
    reset_launches()
    timed("phase", lambda: phase(data, "whatshap", phased))
    torch.cuda.synchronize()
    launches = read_launches()
    write_minimal_tbi(phased, ["chr1"])
    print(f"tools: phase launches {launches}", flush=True)
    _require(launches["wmec_forward_t1"] > 0 and launches["wmec_backtrace_t1"] > 0,
             "tools: phase ran rows 1-2 on the card")
    gate("phase", phased, data)

    truth = f"{out}/truth.vcf"
    write_truth_vcf(data, truth)
    timed("compare", lambda: run_compare(vcf=[truth, phased], ploidy=2, names="truth,phased",
                                         tsv_pairwise=f"{out}/compare.tsv"))
    (row,) = _tsv_rows(f"{out}/compare.tsv")
    rate = float(row["all_switch_rate"])
    print(f"tools: compare against the truth: switch-error rate {rate} ({row['all_switches']} switches in "
          f"{row['all_assessed_pairs']} pairs), blockwise Hamming rate {row['blockwise_hamming_rate']}", flush=True)
    _require(rate < 0.05 and int(row["all_assessed_pairs"]) > 0, "tools: compare's switch-error rate under 5 %")

    timed("stats", lambda: run_stats(vcf=phased, tsv=f"{out}/stats.tsv"))
    (row,) = _tsv_rows(f"{out}/stats.tsv")
    print(f"tools: stats: {row['phased']} of {row['heterozygous_variants']} heterozygous variants phased in "
          f"{row['blocks']} blocks, block N50 {row['block_n50']} bp", flush=True)
    _require(int(row["blocks"]) > 0 and int(row["phased"]) > 0.9 * data["n_vars"], "tools: stats counts the blocks")

    tagged, listing = f"{out}/tagged.bam", f"{out}/haplotags.tsv"
    timed("haplotag", lambda: run_haplotag(variant_file=phased, alignment_file=data["bam"], output=tagged,
                                           haplotag_list=listing))
    positions = (np.arange(data["n_vars"]) + 1) * data["spacing"]  # 0-based, every one heterozygous
    over_two = tagged_over_two = 0
    by_block = {}
    for seg in AlignmentFile(tagged):
        n_sites = np.searchsorted(positions, seg.reference_end) - np.searchsorted(positions, seg.reference_start)
        has_hp = seg.has_tag("HP")
        over_two += n_sites >= 2
        tagged_over_two += n_sites >= 2 and has_hp
        if has_hp:
            agree = seg.get_tag("HP") - 1 == data["origin"][int(seg.query_name[4:])]
            counts = by_block.setdefault(seg.get_tag("PS"), [0, 0])
            counts[0] += int(agree)
            counts[1] += 1
    n_tagged = sum(n for _a, n in by_block.values())
    agreement = sum(max(a, n - a) for a, n in by_block.values()) / max(n_tagged, 1)
    share = tagged_over_two / max(over_two, 1)
    print(f"tools: haplotag: {tagged_over_two} of {over_two} reads over two or more heterozygous sites tagged "
          f"({share:.4f}); HP agrees with the read's haplotype of origin in {agreement:.4f} of {n_tagged} tagged "
          f"reads ({len(by_block)} phase sets, each up to a swap)", flush=True)
    _require(share >= 0.9 and agreement >= 0.95, "tools: haplotag tags the reads by their haplotype")

    parts = [f"{out}/{name}.bam" for name in ("h1", "h2", "untagged")]
    timed("split", lambda: run_split(reads_file=data["bam"], list_file=listing, output_h1=parts[0],
                                     output_h2=parts[1], output_untagged=parts[2]))
    split_counts = [sum(1 for _seg in AlignmentFile(p)) for p in parts]
    listed = [row["haplotype"] for row in _tsv_rows(listing)]
    print(f"tools: split: H1 {split_counts[0]}, H2 {split_counts[1]}, untagged {split_counts[2]} of "
          f"{data['n_reads']} reads", flush=True)
    _require(sum(split_counts) == data["n_reads"] and split_counts[:2] == [listed.count("H1"), listed.count("H2")],
             "tools: split's reads add up to the BAM's and to haplotag's list")

    timed("unphase", lambda: run_unphase(phased, f"{out}/unphased.vcf"))
    same = [gt for _k, gt, _q, _l in vcf_calls(_text(data["vcf"]))] == [
        gt.replace("|", "/") for _k, gt, _q, _l in vcf_calls(_text(f"{out}/unphased.vcf"))]
    print(f"tools: unphase: genotypes equal the input's: {same}", flush=True)
    _require(same, "tools: unphase gives back the input's genotypes")

    timed("heuristic", lambda: phase(data, "heuristic", f"{out}/heuristic.vcf"))
    gate("phase --algorithm heuristic", f"{out}/heuristic.vcf", data)
    block_out = f"{tmp}/tools-block"
    timed("hapchat", lambda: phase(block, "hapchat", f"{block_out}/hapchat.vcf"))
    gate(f"phase --algorithm hapchat (one block of {TOOLS_BLOCK_VARIANTS} variants)", f"{block_out}/hapchat.vcf",
         block)
    print("tools: wall (s): " + " ".join(f"{k} {v:.3f}" for k, v in walls.items()) + f" ({host_context()})",
          flush=True)

    # the host solvers against their Python paths: hapchat and heuristic on
    # the block's files; the switch/flip distance on phase's calls, read as
    # one block (a switch at most block boundaries), against the truth
    truth_positions, truth_haps = _haplotype_strings(truth)
    at, phased_haps = _haplotype_strings(phased)
    index = {p: i for i, p in enumerate(truth_positions)}
    truth_haps = ["".join(h[index[p]] for p in at) for h in truth_haps]
    for label, fn in (
        ("hapchat", lambda tag: phase(block, "hapchat", f"{block_out}/hapchat-{tag}.vcf")),
        ("heuristic", lambda tag: phase(block, "heuristic", f"{block_out}/heuristic-{tag}.vcf")),
        # compare's switch/flip distance (its per-column switches, flips and
        # permutations too)
        ("switchflip", lambda tag: SwitchFlipCalculator(2, 1, 1).compute_switch_flips_poly(phased_haps, truth_haps)),
    ):
        t0 = time.perf_counter()
        helpers = fn("helpers")
        t_helpers = time.perf_counter() - t0
        with python_host_paths():
            t0 = time.perf_counter()
            python = fn("python")
            t_python = time.perf_counter() - t0
        if label == "switchflip":
            what = f"{helpers[0]} switches and {helpers[1]} flips over phase's {len(at)} calls read as one block"
        else:
            helpers, python = _text(f"{block_out}/{label}-helpers.vcf"), _text(f"{block_out}/{label}-python.vcf")
            what = f"VCF of one block of {TOOLS_BLOCK_VARIANTS} variants"
        print(f"host: {label}: {what}, {t_helpers:.3f} s, the Python path {t_python:.3f} s; equal: "
              f"{helpers == python} ({host_context()})", flush=True)
        _require(helpers == python, f"host: {label} through its library equals its Python path")


def polyphase_block(n_vars, n_reads, ploidy=4, seed=59, err=0.03):
    """An AlleleMatrix of one read-connected polyploid block: n_reads reads
    of 6-30 variants drawn in turn from `ploidy` random haplotypes, with
    allele errors at rate err."""
    from whatshap_torch.polyphase.solver import AlleleMatrix

    rng = np.random.default_rng(seed)
    haps = rng.integers(0, 2, size=(ploidy, n_vars))
    rs = core.ReadSet()
    for i in range(n_reads):
        start = int(rng.integers(0, n_vars - 10))
        end = min(start + int(rng.integers(6, 30)), n_vars)
        alleles = haps[i % ploidy, start:end].copy()
        alleles[rng.random(end - start) < err] ^= 1
        read = core.Read(f"read{i}", 50, 0, 0)
        for c, a in zip(range(start, end), alleles.tolist()):
            read.add_variant(10 * (c + 1), a, 30)
        rs.add(read)
    rs.sort()
    return AlleleMatrix(rs)


def _polyphase_chrom(data, output):
    """run_polyphase on write_synth_poly's files at ploidy 4, one thread;
    returns its wall seconds and the stage lines of its summary."""
    import logging

    from whatshap_torch.cli.polyphase import logger, run_polyphase

    stages = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: stages.append(record.getMessage())
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        run_polyphase(phase_input_files=[data["bam"]], variant_file=data["vcf"], ploidy=4,
                      ignore_read_groups=True, output=output, threads=1, write_command_line_header=False)
        wall = time.perf_counter() - t0
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    spent = [" ".join(m.split()[2:]) for m in stages if m.startswith("Time spent")]
    return wall, spent


def start_polyphase_python(tmp):
    """Write polyphase-chrom's files under `tmp` and start this script in a
    process of its own (`--polyphase-python-paths`) that phases them on the
    Python paths; returns the files and the process."""
    n_vars, coverage, seed = POLYPHASE_CHROM
    data = write_synth_poly(f"{tmp}/polychrom", n_vars, coverage, seed)
    with open(f"{tmp}/polychrom/python.out", "w") as out, open(f"{tmp}/polychrom/python.err", "w") as err:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--polyphase-python-paths", data["vcf"],
                                 data["bam"], f"{tmp}/polychrom/python.vcf"], stdout=out, stderr=err)
    CHILDREN.append(proc)
    return data, proc


def polyphase_python_paths(vcf, bam, output) -> int:
    """The child of start_polyphase_python: phase on the Python paths and
    print the wall seconds and the stage lines as one JSON object."""
    with python_host_paths():
        wall, spent = _polyphase_chrom({"vcf": vcf, "bam": bam}, output)
    print(json.dumps({"wall": wall, "stages": spent}))
    return 0


def polyphase_phase(tmp, chrom) -> None:
    """Phase 11c, polyphase (host only): the three libraries against their
    Python paths on a synthetic block, timed alone; polyphase-chrom (`chrom`,
    start_polyphase_python's files and process) phased in process on the
    libraries, its VCF equal to the Python paths' run; then the subcommand as
    a user runs it on the committed fixtures of POLYPHASE_RUNS, the three
    processes started at once (each spends most of its wall importing
    torch and scipy), each VCF equal to an in-process run on the Python
    paths at one thread (all but the ##commandline line, which names the
    command).  Prints each library's time beside its Python path's and each
    run's wall."""
    import threading
    from math import ceil

    from whatshap_torch.cli.polyphase import run_polyphase
    from whatshap_torch.polyphase import haplothreader
    from whatshap_torch.polyphase import solver as poly_solver
    from whatshap_torch.polyphase import threading as poly_threading

    n_vars, n_reads = POLYPHASE_BLOCK
    am = polyphase_block(n_vars, n_reads)
    ploidy = 4
    results, secs = {}, {}
    for route, paths in (("library", contextlib.nullcontext()), ("python", python_host_paths())):
        with paths:
            t0 = time.perf_counter()
            sim = poly_solver.scoreReadset(am, 2, ploidy, 0.07)
            t1 = time.perf_counter()
            clustering = poly_solver.ClusterEditingSolver(sim, False).run()
            t2 = time.perf_counter()
            depths, _ = poly_threading.get_allele_depths(am, clustering, ploidy)
            cov_map = poly_threading.select_clusters(depths, ploidy, 10)
            affine = ceil(poly_threading.compute_readlength_snp_distance_ratio(am))
            threader = haplothreader.HaploThreader(ploidy, 4 * affine, affine, 10, 0)
            t3 = time.perf_counter()
            threads = threader.computePathsBlockwise([0], cov_map, depths)
            t4 = time.perf_counter()
        results[route] = (sorted(sim.m.items()), clustering, threads)
        secs[route] = {"scorelib": t1 - t0, "clusterlib": t2 - t1, "threadlib": t4 - t3}
    for i, name in enumerate(("scorelib", "clusterlib", "threadlib")):
        same = results["library"][i] == results["python"][i]
        print(f"host: {name}: a block of {n_vars} variants and {n_reads} reads at ploidy {ploidy}, "
              f"{secs['library'][name]:.4f} s, the Python path {secs['python'][name]:.4f} s; equal: {same} "
              f"({host_context()})", flush=True)
        _require(same, f"host: {name} equals its Python path")
    _require(len(results["library"][1]) >= ploidy, "polyphase: the block's reads fall in clusters")

    data, proc = chrom
    files = os.path.dirname(data["vcf"])
    library = f"{files}/library.vcf"
    wall, spent = _polyphase_chrom(data, library)
    proc.wait(timeout=600)
    err = _text(f"{files}/python.err")[-2000:]
    _require(proc.returncode == 0, f"polyphase-chrom on the Python paths exits 0 ({err})")
    python = json.loads(_text(f"{files}/python.out").strip().splitlines()[-1])
    records = [line.split("\t") for line in _text(library).splitlines() if not line.startswith("#")]
    phased = sum("|" in r[9] for r in records)
    same = _text(library) == _text(f"{files}/python.vcf")
    n_vars, coverage, _seed = POLYPHASE_CHROM
    print(f"polyphase: polyphase-chrom, {n_vars} variants, {data['n_reads']} reads at ploidy 4 and coverage "
          f"{coverage}: {phased} of {len(records)} records phased; the libraries {wall:.3f} s (stages: "
          f"{'; '.join(spent)}), the Python paths {python['wall']:.3f} s (stages: {'; '.join(python['stages'])}; "
          f"in a process of its own beside phase 2); equal VCFs: {same} ({host_context()})", flush=True)
    _require(same and phased > 0, "polyphase: polyphase-chrom through the libraries writes the Python paths' VCF")

    root = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(root, "tests", "data")
    out = f"{tmp}/polyphase"
    os.makedirs(out)
    runs, walls = {}, {}

    def wait(label, proc, t0):
        runs[label] = (proc.communicate(timeout=300), proc.returncode)
        walls[label] = time.perf_counter() - t0

    watchers = []
    for stem, ploidy, threads in POLYPHASE_RUNS:
        label = f"{stem} -t {threads}"
        args = [sys.executable, "-m", "whatshap_torch", "polyphase", "--ploidy", str(ploidy), "--ignore-read-groups",
                "--threads", str(threads), "-o", f"{out}/{stem}-t{threads}.vcf", f"{data}/{stem}.vcf",
                f"{data}/{stem}.bam"]
        proc = subprocess.Popen(args, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        watchers.append(threading.Thread(target=wait, args=(label, proc, time.perf_counter())))
        watchers[-1].start()
    for stem, ploidy, _threads in POLYPHASE_RUNS:
        python = f"{out}/{stem}-python.vcf"
        if not os.path.exists(python):
            with python_host_paths():
                t0 = time.perf_counter()
                run_polyphase(phase_input_files=[f"{data}/{stem}.bam"], variant_file=f"{data}/{stem}.vcf",
                              ploidy=ploidy, ignore_read_groups=True, output=python, threads=1)
                walls[f"{stem} in process on the Python paths"] = time.perf_counter() - t0
    for watcher in watchers:
        watcher.join()

    def body(path):
        return [line for line in _text(path).splitlines() if not line.startswith("##commandline=")]

    for stem, _ploidy, threads in POLYPHASE_RUNS:
        label = f"{stem} -t {threads}"
        (_stdout, stderr), rc = runs[label]
        _require(rc == 0, f"polyphase: {label} exits 0 ({stderr[-2000:]})")
        lines, python = body(f"{out}/{stem}-t{threads}.vcf"), body(f"{out}/{stem}-python.vcf")
        records = [line.split("\t") for line in lines if not line.startswith("#")]
        phased = sum("|" in r[9] for r in records)
        print(f"polyphase: {label}: {phased} of {len(records)} records phased; equal to the Python paths' VCF: "
              f"{lines == python}", flush=True)
        _require(lines == python and phased > 0, f"polyphase: {label} writes the Python paths' VCF")
    print("polyphase: wall (s): " + "; ".join(f"{k} {v:.3f}" for k, v in walls.items())
          + f" (the three commands at once, each wall from its interpreter's start; {host_context()})", flush=True)


def cli_instance(data, label, expect, plain=True, reads=None, **kwargs):
    """Phase the files of `data` through run_whatshap on the card (counted,
    with the launch counters set to 0 just before and read just after), then
    (unless `plain` is false) again with the plain torch route handed in;
    the two VCFs must be byte-identical and the first must recover the
    simulated haplotypes.  With `reads` (a list), the counted run records
    its reads there, or replays them where the list holds a run's
    (replayed_reads).  Returns the counted run's launches, the packed
    problem of its largest PedigreeDPTable call, and its wall seconds and
    switch-error rates."""
    from whatshap_torch.cli import phase as phase_cli

    args = dict(phase_input_files=[data["bam"]], variant_file=data["vcf"], reference=data["fasta"],
                write_command_line_header=False, device="cuda", **kwargs)
    out = data["vcf"][: -len("variants.vcf")]
    calls, events = [], []
    clear_bam_pool_cache()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    replay = replayed_reads(reads) if reads is not None else contextlib.nullcontext()
    with counted_tables(calls), solve_events(events), replay:
        phase_cli.run_whatshap(**args, output=out + "kernels.vcf")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    solves = sum(a.elapsed_time(b) for a, b in events) / 1e3
    timers = phase_cli.LAST_TIMERS
    stages = {k: timers.elapsed(k) for k in ("parse_vcf", "read_bam", "select", "phase", "components",
                                             "write_vcf")}
    stages["rest"] = timers.total() - timers.sum()
    n = data["n_vars"]
    print(f"{label}: {n} variants, {data['n_reads']} reads, {len(data['haps'])} sample(s): wall {wall:.3f} s "
          f"(files in, VCF out) = {n / wall:.1f} variants phased/s", flush=True)
    print(f"{label}: stages (s): " + " ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f" ({host_context()})",
          flush=True)
    print(f"{label}: device time of the {len(events)} solves (CUDA events) {solves:.4f} s = {solves / wall:.4f} of "
          f"the wall: the card idles at least {1 - solves / wall:.4f} of it", flush=True)
    per_call = {k: v / max(len(calls), 1) for k, v in launches.items() if v}
    print(f"{label}: {len(calls)} PedigreeDPTable call(s); launches {launches}; per call {per_call}", flush=True)
    _require(len(calls) > 0 and all(launches[k] > 0 for k in expect), f"{label}: every kernel of its path launched")
    _require(all(launches[k] == 0 for k in CARRY_KERNELS), f"{label}: no segmented solve")

    with open(out + "kernels.vcf") as f:
        text = f.read()
    rates = switch_error_rates(text, data)
    print(f"{label}: switch-error rate against the simulated haplotypes: "
          + ", ".join(f"{s} {r if r is None else round(r, 6)} over {p} pairs" for s, (r, p) in rates.items()),
          flush=True)
    _require(all(r is not None and r < 0.05 for r, _p in rates.values()), f"{label}: haplotypes recovered")
    largest = max(calls, key=lambda p: p.n_cols)
    if not plain:
        return launches, largest, wall, rates

    clear_bam_pool_cache()
    reset_launches()
    t0 = time.perf_counter()
    with plain_route():
        phase_cli.run_whatshap(**args, output=out + "plain.vcf")
    plain_s = time.perf_counter() - t0
    with open(out + "plain.vcf") as f:
        same = f.read() == text
    print(f"{label}: plain torch route {plain_s:.3f} s (phase stage {phase_cli.LAST_TIMERS.elapsed('phase'):.3f} s); "
          f"kernel launches in it {sum(read_launches().values())}; VCF byte-identical: {same}", flush=True)
    _require(same and sum(read_launches().values()) == 0, f"{label}: VCF byte-identical to the plain route's")
    return launches, largest, wall, rates


def range_k_histogram(packed) -> dict:
    """{K: read-connected ranges} of a packed single-sample problem, each
    range at its own K (its highest active slot + 1, as _slice_ranges cuts
    it)."""
    hist = {}
    for a, b in wmec.connected_column_ranges(packed):
        act = np.nonzero(packed.active[a:b].any(axis=0))[0]
        k = int(act[-1]) + 1 if act.size else 1
        hist[k] = hist.get(k, 0) + 1
    return dict(sorted(hist.items()))


#: phase-cli-ds23: phase-cli's generator at a long-read depth, phased with
#: --internal-downsampling 23, the CLI's ceiling (32,768 variants: the
#: chromosome's first third, to leave the script's time limit room for the
#: pedigree phases)
DS23_VARIANTS = 32_768
DS23_COVERAGE = 30
DS23_CUT_VARIANTS = 8192
#: phase-cli-fam5: phase-cli-trio's generator with three children (T = 64),
#: the plain route's comparison on a cut (its T x T min-plus over every
#: state makes it slow at T = 64); phase-cli-trio-ds23: a trio at coverage 8
#: phased with --internal-downsampling 23 (7 reads a sample, K up to 21)
FAM5_VARIANTS = 8192
FAM5_CUT_VARIANTS = 512
TRIO_DS23_VARIANTS = 2048


def cli_ds23(tmp):
    """Phase phase-cli-ds23: 32,768 variants of phase-cli's generator at
    coverage 30, phased on the card with --internal-downsampling 23 (counted:
    most ranges past the cluster kernel's ceiling, in the wide kernel), then
    the same files at the default 15 for the switch-error rate beside it
    (given the first run's reads, which do not depend on the downsampling:
    its read_bam stage is the replay); the plain route's time at K = 23 does
    not fit the script's limit there, so the byte-identical comparison with
    the plain route on the card runs on an 8,192-variant file of the same
    generator.  Returns the counted run's launches and its packed problem."""
    t0 = time.perf_counter()
    data = write_synth(f"{tmp}/ds23", DS23_VARIANTS, DS23_COVERAGE, seed=7)
    print(f"phase-cli-ds23: chromosome written in {time.perf_counter() - t0:.1f} s ({data['n_reads']} reads)",
          flush=True)
    expect = ("wmec_forward_t1_wide", "wmec_backtrace_t1")
    reads = []
    launches, packed, wall23, rates23 = cli_instance(data, "phase-cli-ds23", expect, plain=False, reads=reads,
                                                     max_coverage=23)
    hist = range_k_histogram(packed)
    wide = sum(n for k, n in hist.items() if k > wmec_cuda.MAX_K)
    print(f"phase-cli-ds23: {sum(hist.values())} read-connected ranges by K {hist}; {wide} past K = "
          f"{wmec_cuda.MAX_K} (the wide kernel), K = {packed.K} at most", flush=True)
    _require(packed.K > wmec_cuda.MAX_K and wide > 0, "phase-cli-ds23: ranges past the cluster kernel's ceiling")
    _l, _p, wall15, rates15 = cli_instance(
        data, "phase-cli-ds23 (the same files at --internal-downsampling 15, reads replayed)",
        ("wmec_forward_t1", "wmec_backtrace_t1"), plain=False, reads=reads)
    del reads
    print("phase-cli-ds23: switch-error rate at --internal-downsampling 23 / 15: "
          + ", ".join(f"{s} {rates23[s][0]:.6f} / {rates15[s][0]:.6f}" for s in rates23)
          + f"; wall {wall23:.3f} / {wall15:.3f} s (the second without the BAM decode)", flush=True)
    del data
    cut = write_synth(f"{tmp}/ds23-cut", DS23_CUT_VARIANTS, DS23_COVERAGE, seed=7)
    cut_packed = cli_instance(cut, f"phase-cli-ds23-{DS23_CUT_VARIANTS}", expect, max_coverage=23)[1]
    print(f"phase-cli-ds23-{DS23_CUT_VARIANTS}: ranges by K {range_k_histogram(cut_packed)}", flush=True)
    return launches, packed


def cli_fam5(tmp):
    """Phase phase-cli-fam5: a family of two parents and three children (the
    shape of tests/data/recombination_breaks.ped: T = 64, P = 4), 8,192
    variants at coverage 5 a sample in one BAM with five read groups and a
    PED file, phased on the card at the default --max-coverage 15 (3 reads a
    sample, ranges up to K = 15, all past the cluster kernel: row 14 in both
    passes of the seam route); wall, stages, the solve's device time,
    variants/s, launches, the ranges by (K, T) and the switch-error rate
    (below 5 %).  The byte-identical comparison with the plain route runs on
    a 512-variant file of the same generator.  Returns the counted run's
    launches and its packed problem."""
    t0 = time.perf_counter()
    data = write_synth(f"{tmp}/fam5", FAM5_VARIANTS, 5, seed=17, trio=True, children=3)
    print(f"phase-cli-fam5: family written in {time.perf_counter() - t0:.1f} s ({data['n_reads']} reads)", flush=True)
    expect = ("wmec_forward_t_wide", "wmec_forward_m_t_wide", "wmec_backtrace_t")
    launches, packed, _w, _r = cli_instance(data, "phase-cli-fam5", expect, plain=False, ped=data["ped"])
    _require((packed.T, packed.P) == (64, 4), "phase-cli-fam5: three trios of two founders")
    print(f"phase-cli-fam5: read-connected ranges by K at T = {packed.T}, P = {packed.P}: "
          f"{range_k_histogram(packed)}", flush=True)
    del data
    cut = write_synth(f"{tmp}/fam5-cut", FAM5_CUT_VARIANTS, 5, seed=17, trio=True, children=3)
    cut_packed = cli_instance(cut, f"phase-cli-fam5-{FAM5_CUT_VARIANTS}", expect, ped=cut["ped"])[1]
    print(f"phase-cli-fam5-{FAM5_CUT_VARIANTS}: ranges by K {range_k_histogram(cut_packed)}", flush=True)
    return launches, packed


def cli_trio_ds23(tmp):
    """Phase phase-cli-trio-ds23: a trio of 2,048 variants at coverage 8 a
    sample, phased on the card with --internal-downsampling 23 (7 reads a
    sample: ranges up to K = 21 at T = 4, past the cluster kernel's K = 16:
    row 14), byte-identical to the plain route.  Returns the launches."""
    data = write_synth(f"{tmp}/trio-ds23", TRIO_DS23_VARIANTS, 8, seed=19, trio=True)
    expect = ("wmec_forward_t_wide", "wmec_forward_m_t_wide", "wmec_backtrace_t")
    launches, packed, _w, _r = cli_instance(data, "phase-cli-trio-ds23", expect, ped=data["ped"], max_coverage=23)
    hist = range_k_histogram(packed)
    print(f"phase-cli-trio-ds23: read-connected ranges by K at T = {packed.T}: {hist}; "
          f"{sum(n for k, n in hist.items() if k > wmec_cuda.MAX_K_T[4])} past K = {wmec_cuda.MAX_K_T[4]} (row 14)",
          flush=True)
    _require(packed.T == 4 and packed.K > wmec_cuda.MAX_K_T[4], "phase-cli-trio-ds23: ranges past the cluster kernel")
    return launches


#: phase-cli-fam7: phase-cli-trio's generator with five children (T = 1024,
#: P = 4) at the default --max-coverage 15 (two reads a sample, K up to 14);
#: the plain route's comparison on a cut at --max-coverage 7 (one read a
#: sample, K up to 7), where the plain seam route's 256 coset seeds each
#: take a T x T min-plus a state and column
FAM7_VARIANTS = 256
FAM7_CUT_VARIANTS = 128
PEDIGREE_KERNELS_WIDE = ("wmec_forward_t_wide", "wmec_forward_m_t_wide", "wmec_backtrace_t")


def cli_fam7(tmp):
    """Phase phase-cli-fam7: a family of two parents and five children (T =
    1024, P = 4), FAM7_VARIANTS variants at coverage 5 a sample in one BAM
    with seven read groups and a PED file, phased on the card at the default
    --max-coverage 15 (row 14 in both passes of the seam route, pass 1 over
    256 coset seeds a block, and rows 5/8: 1,025 walks a block); wall,
    stages, the solves' device time, launches, the ranges by K and the
    switch-error rate against the simulation (below 5 %).  Then
    phase-cli-fam7-128: a FAM7_CUT_VARIANTS-variant file of the same
    generator at --max-coverage 7 (two ranges: both passes), byte-identical
    to the plain route on the card.  Returns the counted run's launches and
    its packed problem."""
    t0 = time.perf_counter()
    data = write_synth(f"{tmp}/fam7", FAM7_VARIANTS, 5, seed=41, trio=True, children=5)
    print(f"phase-cli-fam7: family written in {time.perf_counter() - t0:.1f} s ({data['n_reads']} reads)", flush=True)
    launches, packed, _w, _r = cli_instance(data, "phase-cli-fam7", PEDIGREE_KERNELS_WIDE, plain=False,
                                            ped=data["ped"])
    _require((packed.T, packed.P) == (1024, 4), "phase-cli-fam7: five trios of two founders")
    print(f"phase-cli-fam7: read-connected ranges by K at T = {packed.T}, P = {packed.P}: "
          f"{range_k_histogram(packed)}", flush=True)
    del data
    cut = write_synth(f"{tmp}/fam7-cut", FAM7_CUT_VARIANTS, 5, seed=41, trio=True, children=5)
    cut_packed = cli_instance(cut, f"phase-cli-fam7-{FAM7_CUT_VARIANTS}", PEDIGREE_KERNELS_WIDE, ped=cut["ped"],
                              max_coverage=7)[1]
    print(f"phase-cli-fam7-{FAM7_CUT_VARIANTS}: ranges by K {range_k_histogram(cut_packed)}", flush=True)
    _require(len(wmec.connected_column_ranges(cut_packed)) > 1, "phase-cli-fam7's cut runs the seam route")
    return launches, packed


#: pedigree-p10: two grandparent couples, their two children, an in-law and
#: two grandchildren (FIVE_FOUNDERS: T = 256, P = 10), the read lanes of
#: each individual (K = 12), and the sizes of its phasing and genotyping
#: instances
P10_LANES = (2, 2, 2, 1, 1, 1, 1, 1, 1)
P10_BLOCKS, P10_COLS = 2, 64
P10_GENO_COLS, P10_GENO_CHECK_COLS = 128, 16


def pedigree_p10(device="cuda"):
    """Phase pedigree-p10: a pedigree of five founders and four trios (T =
    256, P = 10) at K = 12, through PedigreeDPTable (phase_instance: the
    entry point counted, the route split, the plain route on the card equal;
    P10_BLOCKS read-connected blocks: both passes of the seam route, R = 8
    coset seeds a block) and GenotypeDPTable (one launch of each wide
    genotyping kernel, finite likelihoods that sum to 1, the concordance
    with the simulated genotypes printed; a P10_GENO_CHECK_COLS-column
    instance of one read lane an individual (K = 9) held to the float64
    plain route on the card at the trio bar, atol 3e-4).  Returns the
    phasing run's launches, its packed problem, the genotyping run's
    launches and its prepared (static, stacked) inputs."""
    rs, pos, ped, _truth = simulate_pedigree(P10_BLOCKS, P10_COLS, P10_LANES, FIVE_FOUNDERS, seed=47)
    rc = [10] * len(pos)
    launches = phase_instance(rs, pos, ped, rc, None, device, "pedigree-p10", PEDIGREE_KERNELS_WIDE)
    packed = wmec.pack_problem(rs, rc, ped, False, pos)
    _require((packed.K, packed.T, packed.P) == (12, 256, 10), "pedigree-p10: K = 12, T = 256, P = 10")

    rs_g, pos_g, ped_g, nsi_g, truth_g = simulate_genotyping(P10_GENO_COLS, P10_LANES, FIVE_FOUNDERS, seed=53)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    table = core.GenotypeDPTable(nsi_g, rs_g, [10] * P10_GENO_COLS, ped_g, pos_g, device=device)
    wall = time.perf_counter() - t0
    geno_launches = read_launches()
    lik = np.moveaxis(np.asarray(table._likelihoods, dtype=np.float64), 1, 0)  # (n_ind, C, 3)
    gp = table._packed
    print(f"pedigree-p10 genotyping: {P10_GENO_COLS} variants, K={gp.K}, T={gp.T}, P={gp.P}; wall {wall:.3f} s = "
          f"{P10_GENO_COLS / wall:.1f} variants genotyped/s; launches {geno_launches}", flush=True)
    _require((gp.K, gp.T, gp.P) == (12, 256, 10), "pedigree-p10 genotyping: K = 12, T = 256, P = 10")
    _require(all(geno_launches[k] == 1 for k in WIDE_GENO)
             and all(v == 0 for k, v in geno_launches.items() if k not in WIDE_GENO),
             "pedigree-p10: one launch of each wide genotyping kernel, no other")
    _require(np.isfinite(lik).all() and np.allclose(lik.sum(axis=2), 1.0, atol=1e-5),
             "pedigree-p10: finite likelihoods that sum to 1")
    print(f"pedigree-p10 genotyping: GT concordance with the simulated genotypes "
          f"{float(np.mean(lik.argmax(axis=2) == truth_g)):.4f}", flush=True)
    prepared = genotyping.prepare_genotyping_batch([gp], ped_g)

    rs_c, pos_c, ped_c, nsi_c, _t = simulate_genotyping(P10_GENO_CHECK_COLS, 1, FIVE_FOUNDERS, seed=59)
    small = core.GenotypeDPTable(nsi_c, rs_c, [10] * P10_GENO_CHECK_COLS, ped_c, pos_c, device=device)
    st_c, stk_c = genotyping.prepare_genotyping_batch([small._packed], ped_c)
    trans, passign, base, diff, birth, die_next, dup, _gmask = (torch.from_numpy(a).to(device) for a in stk_c)
    red64, _scaling = genotyping.forward_backward_plain(*st_c[:3], diff, base, passign, trans, birth, die_next, dup)
    e = _lik_err(small._likelihoods, genotyping.likelihoods_from_red(red64.cpu().numpy(), stk_c[7][0])[0])
    print(f"pedigree-p10 genotyping: {P10_GENO_CHECK_COLS}-column instance (K={small._packed.K}) against the "
          f"float64 plain route on the card: likelihoods max|err|={e:.3e} (limit 3e-4)", flush=True)
    _require(e <= 3e-4, "pedigree-p10: the wide kernels agree with the float64 plain route")
    return launches, packed, geno_launches, prepared


def time_wide_bucket(label, arrays, K, plain_blocks=None, reps=3):
    """Row 13 (tables from zero) at a bucket (CUDA events), beside its plain
    version and its bound: the bytes (inputs read once, the tables and the
    final state written once) over the memory rate against 5 int32 adds a
    state and column over the add rate.  plain_blocks: the plain version
    runs on that many of the blocks only (at K = 23 beside the kernel's own
    tables it would not fit the card) and is held to the kernel's output
    there.  Returns the kernels line's numbers."""
    B, C = arrays[0].shape[0], arrays[0].shape[1]
    ms = _time(lambda: wmec_cuda.forward_t1_wide(K, 2, *arrays), reps=reps)
    kern = wmec_cuda.forward_t1_wide(K, 2, *arrays)
    nb = B if plain_blocks is None else plain_blocks
    sub = [a[:nb].contiguous() for a in arrays]
    plain, plain_ms = _plain_ms(lambda: wmec_cuda.forward_t1_plain(K, 2, *sub))
    err = _max_err(zip((x[:nb] for x in kern), plain))
    del plain
    bound = _bound(_nbytes(*arrays[:5]), _nbytes(*kern), 5.0 * B * C * (1 << K))
    del kern
    torch.cuda.empty_cache()
    print(f"{label} wmec_forward_t1_wide (B={B} C={C} K={K}, L2 sweep in groups of "
          f"{wmec_cuda.forward_t1_wide_group(K, B)}): {ms:.3f} ms (plain {plain_ms:.3f} ms on {nb} "
          f"block(s)), bound {bound[0]:.4f} ms by {bound[1]} ({bound[0] / ms:.4f} of it), max|err|={err}; "
          f"{B * C * (4 << K) / ms / 1e6:.1f} GB/s of tables", flush=True)
    _require(err == 0, f"{label}: row 13 bit-equal to plain")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "bound_ms": bound[0], "bound_by": bound[1]}


def time_ds23_bucket(packed):
    """Row 13 at phase-cli-ds23's bucket of most work, one launch of it as
    the route chunks it under the table budget."""
    (c_pad, K), members, _ri = main_bucket(packed)
    per_block = c_pad * (4 << K) + wmec_cuda.state_bytes(K, 1)
    budget = wmec._table_budget(torch.device("cuda"))
    B = max(1, min(len(members), budget // per_block))
    arrays = blocks.to_device(blocks.stack_blocks(members[:B]), "cuda")
    print(f"timing at phase-cli-ds23's main bucket: {len(members)} blocks of C={c_pad} at K={K}, launched "
          f"{B} at a time under the table budget of {budget} bytes", flush=True)
    out = time_wide_bucket("phase-cli-ds23", arrays, K, plain_blocks=min(B, 2), reps=2)
    del arrays
    torch.cuda.empty_cache()
    return out


def largest_single_range(K, budget) -> int:
    """The most columns one read-connected single-sample range at K past the
    cluster kernel's ceiling (the XLA route's segment rule) may have on the
    card under `budget` bytes: unsegmented while its tables (columns
    padded to a power of two) and the kernel's state fit, then in the
    segmented solve with the XLA-route segment length, one segment's tables,
    the state and the checkpoints (two planes each) fitting, as
    wmec._single_range_segment and solve_segmented_auto reckon them."""
    C = np.arange(1, 1 << 23, dtype=np.int64)
    per_col, state, ckpt = 4 << K, wmec_cuda.state_bytes(K, 1), 8 << K
    pow2 = 1 << np.ceil(np.log2(np.maximum(C, 8))).astype(np.int64)
    root = np.floor(np.sqrt(C)).astype(np.int64)
    seg = np.clip(1 << np.ceil(np.log2(np.maximum(root, 1))).astype(np.int64), 64, 2048)
    n_seg = -(-C // seg)
    ok = (pow2 * per_col + state <= budget) | (seg * per_col + state + (n_seg + 1) * ckpt <= budget)
    best = int(C[ok].max()) if ok.any() else 0
    _require(best == 0 or wmec._xla_segment_length(best) == int(seg[best - 1]), "segment rule mirrored")
    return best


def wide_segmented_instance(n_cols=2048, K=23, seed=37):
    """Phase segmented-k23: one read-connected range of n_cols columns at
    coverage 23 through PedigreeDPTable(device="cuda") at the default table
    budget, which its unsegmented tables (n_cols x 32 MiB, 64 GiB) exceed:
    the segmented solve in the XLA route's segments (64 columns at 2,048),
    with the counters set to 0 just before and read just after: the wide
    kernel's carry mode, its tables mode from a carry and the backtrace once
    a segment each, no other kernel.  Then the plain route on the card (the
    torch mirror's segmented solve, the same segments): cost, partitioning
    and index path equal.  Prints the largest single range at K = 23 that
    the budget admits.  Returns the launches and the packed instance."""
    t0 = time.perf_counter()
    rs, positions, truth = chromosome(1, n_cols, K, seed=seed)
    het = _het_pedigree(len(positions))
    rc = [1] * len(positions)
    packed = wmec.pack_problem(rs, rc, het, False, positions)
    C = packed.n_cols
    _require(len(wmec.connected_column_ranges(packed)) == 1 and packed.K == K, f"segmented-k{K}: one range at K={K}")
    seg = wmec._single_range_segment(C, K, 1, torch.device("cuda"))
    _require(seg is not None, f"segmented-k{K}: its tables exceed the default budget")
    n_seg = -(-C // seg)
    print(f"segmented-k{K}: built in {time.perf_counter() - t0:.1f} s", flush=True)
    events = []
    with solve_events(events):
        table, (cost, partition, (superreads, _tr)), wall, launches, peak = _phase_table(rs, positions, het, rc)
    solves = sum(a.elapsed_time(b) for a, b in events) / 1e3
    path = ("wmec_forward_carry_t1_wide", "wmec_forward_t1_wide", "wmec_backtrace_t1")
    budget = wmec._table_budget(torch.device("cuda"))
    print(f"segmented-k{K}: {C} variants, {len(rs)} reads, K={K}, one read-connected range; default table "
          f"budget {budget} bytes; {n_seg} segments of {seg}; cost {cost}; wall {wall:.3f} s = {C / wall:.1f} "
          f"variants/s; peak device memory {peak / 2**30:.3f} GiB (unsegmented tables alone "
          f"{wmec._next_pow2(C) * (4 << K) / 2**30:.1f} GiB); launches {launches}", flush=True)
    print(f"segmented-k{K}: device time of the {len(events)} solve(s) (CUDA events) {solves:.4f} s = "
          f"{solves / wall:.4f} of the wall: the card idles at least {1 - solves / wall:.4f} of it", flush=True)
    _require(all(launches[n] == n_seg for n in path), f"segmented-k{K}: {n_seg} launches of each kernel of the path")
    _require(sum(launches[n] for n in WRAPPERS if n not in path) == 0, f"segmented-k{K}: no other kernel launched")
    _require(len(superreads[0][0]) == C, f"segmented-k{K}: output shapes")
    agree = haplotype_agreement(superreads, truth[0], np.stack([truth[1], 1 - truth[1]])[None])
    print(f"segmented-k{K}: superreads agree with the simulated haplotypes at {agree:.4f} of calls", flush=True)
    _require(agree > 0.9, f"segmented-k{K}: haplotypes recovered")

    t0 = time.perf_counter()
    plain = wmec.run_dp(packed, "cuda", solve=plain_solve, solve_segmented=wmec.solve_segmented)
    plain_s = time.perf_counter() - t0
    same = (plain.optimal_cost == cost and wmec.extract_partitioning(packed, plain) == partition
            and np.array_equal(plain.index_path, table._result.index_path))
    print(f"segmented-k{K}: plain route on the card {plain_s:.3f} s; cost, partitioning and index path "
          f"equal: {same}", flush=True)
    _require(same, f"segmented-k{K}: kernel route equals the plain route")
    ceiling = largest_single_range(K, budget)
    print(f"segmented-k{K}: the largest single range at K = {K} the budget admits: {ceiling} columns "
          f"(segments of {wmec._xla_segment_length(ceiling)})", flush=True)
    return launches, packed


# ---------------------------------------------------------------------------
# the genotype CLI on files: the same generator's files, re-genotyped by
# whatshap_torch.cli.genotype.run_genotype on the card


def vcf_calls(text):
    """Every sample's call of a genotyped VCF, read as
    tests/test_geno_backends_cli.py reads them: [((CHROM, POS, sample), GT,
    GQ, [GL, ...]), ...] (GQ as its text, None where absent)."""
    calls = []
    samples = []
    for line in text.splitlines():
        if line.startswith("##") or not line:
            continue
        fields = line.split("\t")
        if line.startswith("#"):
            samples = fields[9:]
            continue
        fmt = fields[8].split(":")
        for sample, column in zip(samples, fields[9:]):
            parts = dict(zip(fmt, column.split(":")))
            gl = [float(x) for x in parts["GL"].split(",")] if "GL" in parts else []
            calls.append(((fields[0], int(fields[1]), sample), parts.get("GT"), parts.get("GQ"), gl))
    return calls


def cli_bar(ref, got) -> dict:
    """The differences of `got` from `ref` (vcf_calls lists) under the
    reference's own CLI bar (tests/test_geno_backends_cli.py:61-83): GT and
    GQ exact, GL within rel/abs 5e-3, where two values both <= -30 count as
    equal (the f32 routes' flush-to-zero edge).  Returns {"sites": the calls
    whose site or sample differ, a difference in length included; "GT",
    "GQ", "GL": the (ref call, got call) pairs that differ in that field}."""
    out = {"sites": abs(len(ref) - len(got)), "GT": [], "GQ": [], "GL": []}
    for r, g in zip(ref, got):
        if r[0] != g[0]:
            out["sites"] += 1
            continue
        if r[1] != g[1]:
            out["GT"].append((r, g))
        if r[2] != g[2]:
            out["GQ"].append((r, g))
        if len(r[3]) != len(g[3]) or not all(
            (a <= -30 and b <= -30) or math.isclose(a, b, rel_tol=5e-3, abs_tol=5e-3)
            for a, b in zip(r[3], g[3])
        ):
            out["GL"].append((r, g))
    return out


GENO_PLAIN = ((genotyping, "forward_backward_plain"), (genotyping_cuda, "backward_plain"),
              (genotyping_cuda, "forward_plain"))


@contextlib.contextmanager
def genotype_probe(probe: dict):
    """Watch the genotype CLI's genotyping: keep each GenotypeDPTable it
    makes ("tables"), a pair of CUDA events around each forward-backward
    (the route's default, unchanged; no synchronisation added: the device
    time of the kernels, "events"), the table budget each one met
    ("budgets"), and the calls of every plain genotyping version
    ("plain")."""
    from whatshap_torch.cli import genotype as geno_cli

    probe.update(tables=[], events=[], budgets=[], plain=0)
    real_table, real_fb = geno_cli.GenotypeDPTable, genotyping.forward_backward
    real_plain = [getattr(mod, name) for mod, name in GENO_PLAIN]

    class Kept(real_table):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            probe["tables"].append(self)

    def forward_backward(*args):
        probe["budgets"].append(wmec._table_budget(args[3].device))
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_fb(*args)
        stop.record()
        probe["events"].append((start, stop))
        return out

    def counted(fn):
        def run(*args, **kwargs):
            probe["plain"] += 1
            return fn(*args, **kwargs)
        return run

    geno_cli.GenotypeDPTable, genotyping.forward_backward = Kept, forward_backward
    for (mod, name), fn in zip(GENO_PLAIN, real_plain):
        setattr(mod, name, counted(fn))
    try:
        yield
    finally:
        geno_cli.GenotypeDPTable, genotyping.forward_backward = real_table, real_fb
        for (mod, name), fn in zip(GENO_PLAIN, real_plain):
            setattr(mod, name, fn)


@contextlib.contextmanager
def plain_genotyping(dtype=torch.float64):
    """Every genotyping instance of the block on the plain route on the
    card: launch_genotyping's seam gets forward_backward_plain over `dtype`
    copies of the prepared tables in place of the kernels."""
    real = genotyping.launch_genotyping

    def launch(static, stacked, device):
        trans, passign, base, diff, birth, die_next, dup, _gmask = (
            torch.from_numpy(a).to(device, torch.bool if a.dtype == np.bool_ else dtype) for a in stacked)
        red, _scaling = genotyping.forward_backward_plain(*static[:3], diff, base, passign, trans, birth,
                                                          die_next, dup)
        return genotyping.likelihoods_from_red(red.cpu().numpy(), stacked[7][0])

    genotyping.launch_genotyping = launch
    try:
        yield
    finally:
        genotyping.launch_genotyping = real


@contextlib.contextmanager
def replayed_reads(store: list):
    """The reads of a CLI run, recorded or replayed: while `store` is empty,
    each PhasedInputReader.read result of the block is appended to it; once
    it holds a run's results, the next run of the same command gets them back
    in the same order (each checked against the chromosome, sample and
    read_vcf it was read for), so it skips the BAM decode and allele
    detection."""
    from whatshap_torch.cli import PhasedInputReader

    real = PhasedInputReader.read
    replay = iter(list(store)) if store else None

    def read(self, chromosome, variants, sample, **kwargs):
        key = (chromosome, sample, kwargs.get("read_vcf", True))
        if replay is None:
            out = real(self, chromosome, variants, sample, **kwargs)
            store.append((key, out))
            return out
        recorded, out = next(replay)
        _require(recorded == key, f"the replayed reads are those of {key}")
        return out

    PhasedInputReader.read = read
    try:
        yield
    finally:
        PhasedInputReader.read = real


def _site_likelihoods(tables, chrom_pos_sample):
    """The likelihood triple a VCF call of (CHROM, POS, sample) was written
    from: the column of the genotyping call that covered it."""
    _chrom, pos, sample = chrom_pos_sample
    for table in tables:
        positions = table._packed.positions
        col = int(np.searchsorted(positions, pos - 1))
        sample_id = table._numeric_sample_ids.mapping.get(sample)
        members = [table._pedigree.index_to_id(i) for i in range(len(table._pedigree))]
        if col < len(positions) and positions[col] == pos - 1 and sample_id in members:
            return table._likelihoods[col, table._pedigree.id_to_index(sample_id)]
    raise KeyError(chrom_pos_sample)


GT_INDEX = {"0/0": 0, "0/1": 1, "1/1": 2}


def _gq_unrounded(lik, gt) -> float:
    """GQ before rounding, as GenotypeVcfWriter computes it: -10 log10 of
    the likelihood of every genotype but the called one."""
    called = GT_INDEX[gt]
    wrong = sum(float(p) for i, p in enumerate(lik) if i != called)
    return -10.0 * math.log10(wrong) if wrong > 0 else math.inf


def geno_cli_instance(data, label, atol, min_concordance, kernels=("geno_backward", "geno_forward"), plain=True,
                      f32_range=False, **kwargs):
    """Genotype the files of `data` through run_genotype on the card (the
    launch counters set to 0 just before and read just after; one launch of
    each of `kernels` per GenotypeDPTable call, no plain version, no other
    kernel), then, with `plain`, again with the float64 plain route on the card handed
    in and the first run's reads replayed; the first VCF must meet the
    reference's CLI bar against the second (cli_bar: GT exact, GL within
    5e-3, GQ exact but where a difference of 1 is f32 rounding: the float64
    value within 4.4e-4 of a half-integer, and the kernels' likelihoods
    there within `atol` of the plain route's), and agree with the simulated
    genotypes above `min_concordance` in every sample.  With `f32_range` the
    float32 plain route runs too, on the same reads: the kernels' VCF must
    meet the CLI bar against it with GQ exact, and a GQ that differs from
    the float64 route's is also excused where the float32 plain route's GQ
    there is the kernels' (a wrong genotypes' likelihood past float32's
    range: the float32 route itself departs, not the kernels).  Returns the
    counted run's launches and (prepared static shape, stacked inputs) of its
    largest instance."""
    from whatshap_torch.cli import genotype as geno_cli

    args = dict(phase_input_files=[data["bam"]], variant_file=data["vcf"], reference=data["fasta"],
                write_command_line_header=False, device="cuda", **kwargs)
    out = data["vcf"][: -len("variants.vcf")]
    probe, reads = {}, []
    clear_bam_pool_cache()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with genotype_probe(probe), replayed_reads(reads):
        geno_cli.run_genotype(**args, output=out + "geno.vcf")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    tables = probe["tables"]
    device_s = sum(a.elapsed_time(b) for a, b in probe["events"]) / 1e3
    timers = geno_cli.LAST_TIMERS
    stages = {k: timers.elapsed(k) for k in ("parse_vcf", "read_bam", "select", "genotyping", "write_vcf")}
    stages["rest"] = timers.total() - timers.sum()
    n = data["n_vars"]
    print(f"{label}: {n} variants, {data['n_reads']} reads, {len(data['haps'])} sample(s): wall {wall:.3f} s "
          f"(files in, VCF out) = {n / wall:.1f} variants genotyped/s", flush=True)
    print(f"{label}: stages (s): " + " ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f" ({host_context()})",
          flush=True)
    print(f"{label}: device time of the {len(probe['events'])} forward-backward calls (CUDA events) "
          f"{device_s:.4f} s = {device_s / wall:.4f} of the wall: the card idles at least "
          f"{1 - device_s / wall:.4f} of it", flush=True)
    shapes = [(t._packed.n_cols, t._packed.K, t._packed.T, t._packed.P) for t in tables]
    print(f"{label}: {len(tables)} GenotypeDPTable call(s) (C, K, T, P) {shapes}; launches {launches}; "
          f"plain genotyping calls {probe['plain']}", flush=True)
    for (C, K, T, P), budget in zip(shapes, probe["budgets"]):
        per_col = T * 4 << K
        room = budget - genotyping.chunk_bytes(torch.device("cuda"), K, T, P)
        cols = (room - (genotyping.instance_bytes(1, K, T, P) - per_col)) // per_col
        print(f"{label}: table budget at the call {budget} bytes: at K={K}, T={T}, P={P} one instance takes at "
              f"most {cols} columns (this one {C}, {genotyping.instance_bytes(C, K, T, P)} bytes of beta "
              "table and state)", flush=True)
    _require(len(tables) > 0 and all(launches[k] == len(tables) for k in kernels),
             f"{label}: one launch of each of {kernels} per GenotypeDPTable call")
    _require(probe["plain"] == 0 and all(v == 0 for k, v in launches.items() if k not in kernels),
             f"{label}: no plain version and no other kernel")

    with open(out + "geno.vcf") as f:
        calls = vcf_calls(f.read())
    concordance = {}
    for sample, haps in data["haps"].items():
        truth = haps.sum(axis=0)
        mine = [GT_INDEX.get(gt, -1) == truth[pos // data["spacing"] - 1] for (_c, pos, s), gt, _q, _l in calls
                if s == sample]
        concordance[sample] = sum(mine) / len(mine)
    print(f"{label}: GT concordance with the simulated genotypes: "
          + ", ".join(f"{s} {c:.4f}" for s, c in concordance.items()), flush=True)
    _require(all(c > min_concordance for c in concordance.values()), f"{label}: genotypes recovered")
    biggest = max(tables, key=lambda t: t._packed.n_cols)
    prepared = genotyping.prepare_genotyping_batch([biggest._packed], biggest._pedigree)
    if not plain:
        return launches, prepared

    plain_probe, plain_calls = {}, {}
    for dtype in (torch.float64, torch.float32) if f32_range else (torch.float64,):
        reset_launches()
        t0 = time.perf_counter()
        with plain_genotyping(dtype), genotype_probe(plain_probe), replayed_reads(reads):
            geno_cli.run_genotype(**args, output=out + "plain.vcf")
        plain_s = time.perf_counter() - t0
        with open(out + "plain.vcf") as f:
            plain_calls[dtype] = vcf_calls(f.read())
        diff = cli_bar(plain_calls[dtype], calls)
        kernel_launches = sum(read_launches().values())
        print(f"{label}: {dtype} plain route on the card, the reads replayed, {plain_s:.3f} s (genotyping stage "
              f"{geno_cli.LAST_TIMERS.elapsed('genotyping'):.3f} s); kernel launches in it {kernel_launches}; "
              f"against it: {len(calls)} calls, sites differing {diff['sites']}, GT {len(diff['GT'])}, "
              f"GQ {len(diff['GQ'])}, GL {len(diff['GL'])}", flush=True)
        _require(kernel_launches == 0 and len(plain_probe["tables"]) == len(tables), f"{label}: the {dtype} plain run")
        _require(diff["sites"] == 0 and not diff["GT"] and not diff["GL"], f"{label}: GT and GL meet the CLI bar")
        if dtype == torch.float32:
            _require(not diff["GQ"], f"{label}: GQ meets the CLI bar against the float32 plain route")
        else:
            tables64, diff64 = plain_probe["tables"], diff
    del reads
    gq32 = {site: gq for site, _gt, gq, _gl in plain_calls.get(torch.float32, [])}
    rounding = range32 = 0
    for (site, gt, gq_plain, _gl), (_site, _gt, gq, _gl2) in diff64["GQ"]:
        lik64, lik32 = _site_likelihoods(tables64, site), _site_likelihoods(tables, site)
        exact64, exact32 = _gq_unrounded(lik64, gt), _gq_unrounded(lik32, gt)
        edge = abs(exact64 - math.floor(exact64) - 0.5)
        err = float(np.max(np.abs(lik32 - lik64)))
        ok = (gq is not None and gq_plain is not None and abs(int(gq) - int(gq_plain)) == 1
              and edge <= 4.4e-4 and err <= atol)
        past = not ok and f32_range and gq32[site] == gq
        rounding += ok
        range32 += past
        verdict = "f32 rounding" if ok else "the float32 plain route's GQ too" if past else "FAULT"
        print(f"{label}: GQ differs at {site}: kernels {gq} ({exact32!r} unrounded), float64 plain "
              f"{gq_plain} ({exact64!r}), {edge:.3e} from a half-integer, likelihoods max|err| {err:.3e}"
              + (f", float32 plain {gq32[site]}" if f32_range else "") + f": {verdict}", flush=True)
    print(f"{label}: GQ differences that are f32 rounding at a half-integer: {rounding} of {len(diff64['GQ'])}"
          + (f"; that the float32 plain route makes too: {range32}" if f32_range else ""), flush=True)
    _require(rounding + range32 == len(diff64["GQ"]), f"{label}: GQ meets the CLI bar")
    return launches, prepared


GENO_FAM5_VARIANTS = 4096
GENO_COV20_VARIANTS = 8192
GENO_WIDE_CUT_VARIANTS = 512
# genotype-cli-fam7: five children (T = 1024) at --max-coverage 15 (K up to
# 14: 64 MiB of beta table a column; 256 variants, of the ~600 columns one
# instance can hold, to leave the script's time limit room), fewer where
# the instance does not fit the table budget (geno_fam7_variants), and its
# cut, whose concordance gate is the share its 128 variants support (0.68
# for one child of the cut in a run where every sample of the whole file
# passed 0.9: a child's recombination in a short file)
GENO_FAM7_VARIANTS = 256
GENO_FAM7_CUT_VARIANTS = 128
GENO_FAM7_CUT_CONCORDANCE = 0.6
# genotype-cli-fam5's concordance gate, set from its 512-variant cut's
# concordance on the float64 plain route (PERF.md, the genotype CLI cells)
GENO_FAM5_CONCORDANCE = 0.85
WIDE_GENO = ("geno_backward_wide", "geno_forward_wide")


def geno_fam7_variants(K=14, T=1024, P=4) -> int:
    """genotype-cli-fam7's variants: GENO_FAM7_VARIANTS, or in steps of 64
    fewer, as many as leave one instance's bytes (genotyping.instance_bytes:
    the beta table, the inputs' copy with trans, the wide kernels' scratch)
    and the inputs' copy once more (they are on the card when the route
    reads its budget) within the table budget at K = 14."""
    dev = torch.device("cuda")
    budget = wmec._table_budget(dev) - genotyping.chunk_bytes(dev, K, T, P)
    n = GENO_FAM7_VARIANTS
    while n > 64 and genotyping.instance_bytes(n, K, T, P) + genotyping.input_bytes(n, K, T, P) > budget:
        n -= 64
    print(f"genotype-cli-fam7: {n} variants (the table budget {budget} bytes; an instance of {n} columns at K={K}, "
          f"T={T} takes {genotyping.instance_bytes(n, K, T, P)} bytes, its inputs "
          f"{genotyping.input_bytes(n, K, T, P)})", flush=True)
    return n


def geno_cli_wide(tmp, label, n_vars, coverage, seed, shape_ok, atol, min_concordance, plain, **kwargs):
    """Phases genotype-cli-fam5 and genotype-cli-cov20 and their cuts: the
    genotype CLI on n_vars variants past the cluster kernels, genotyped on
    the card (geno_cli_instance: one launch of each wide kernel per
    GenotypeDPTable call, no plain version, no cluster genotyping kernel, no
    wMEC kernel; wall, stages, device time, idle share, budget,
    concordance).  The float64 plain route cannot hold a whole file's beta
    table (twice the float32 one), so the reference's CLI bar against it
    (`plain`) runs on a GENO_WIDE_CUT_VARIANTS-variant file of the same
    generator.  shape_ok(K, T, P) must hold for the largest instance.
    Returns the counted run's launches and (static, stacked) of its largest
    instance."""
    t0 = time.perf_counter()
    data = write_synth(f"{tmp}/{label}", n_vars, coverage, seed=seed, **kwargs.pop("synth", {}))
    print(f"{label}: files written in {time.perf_counter() - t0:.1f} s ({data['n_reads']} reads)", flush=True)
    ped = {"ped": data["ped"]} if data["ped"] else {}
    launches, prepared = geno_cli_instance(data, label, atol, min_concordance, kernels=WIDE_GENO, plain=plain,
                                           **ped, **kwargs)
    K, T, P, _n = prepared[0]
    print(f"{label}: its largest instance C={prepared[1][3].shape[1]}, K={K}, T={T}, P={P}", flush=True)
    _require(shape_ok(K, T, P) and not genotyping_cuda.kernel_supported(K, T, P), f"{label}: the instance's shape")
    del data
    torch.cuda.empty_cache()
    return launches, prepared


def time_geno_wide(static, stacked, label, plain_cols=64, device="cuda"):
    """Phase timing, rows 15-16: each wide genotyping kernel at a CLI cell's
    instance (CUDA events), beside its float32 plain version on the first
    `plain_cols` columns (the kernels on the same cut are held to it: rtol
    1e-4) and its bound: the larger of the bytes (the inputs read once,
    beta_store written once by the backward and read once by the forward)
    and the operations a state, plane and column over their units' peak
    rates: the exps (2P: em[t, a] is the product over p of exp(ab[2p +
    bit_p(a)]), as rows 11-12 count them), the f32 operations on the CUDA
    cores (the emission sums' 2P adds, in Gray order, and the 2^P
    multiply-adds of em against passign) and the T multiply-adds of the
    transmission product on the fastest unit that keeps float32's
    accuracy, the tensor cores in the 3xTF32 split (its time on the CUDA
    cores printed beside it)."""
    K, T, P, _n = static
    x = genotyping.to_device(stacked, torch.device(device))
    diff, base, passign, trans, birth, die_next, dup = x
    B, C, S = diff.shape[0], diff.shape[1], 1 << K
    bwd_ms = _time(lambda: genotyping_cuda.backward_wide(K, T, P, diff, base, passign, trans, birth, dup), reps=1)
    beta, scaling = genotyping_cuda.backward_wide(K, T, P, diff, base, passign, trans, birth, dup)
    fwd_ms = _time(lambda: genotyping_cuda.forward_wide(K, T, P, diff, base, passign, trans, die_next, scaling, beta),
                   reps=1)
    red = genotyping_cuda.forward_wide(K, T, P, diff, base, passign, trans, die_next, scaling, beta)
    torch.cuda.synchronize()
    _require(bool(torch.isfinite(red).all()), f"{label}: red is finite")
    common = _nbytes(diff, base, passign, trans)
    nbytes = {"geno_backward_wide": common + _nbytes(birth, dup, beta, scaling),
              "geno_forward_wide": common + _nbytes(die_next, scaling, beta, red)}
    del beta, red
    torch.cuda.empty_cache()
    cut = [a[:, :plain_cols].contiguous() for a in x]
    beta, scaling = genotyping_cuda.backward_wide(K, T, P, *cut[:5], cut[6])
    red = genotyping_cuda.forward_wide(K, T, P, *cut[:4], cut[5], scaling, beta)
    (beta_p, scaling_p), bwd_plain_ms = _plain_ms(lambda: genotyping_cuda.backward_plain(K, T, P, *cut[:5], cut[6]))
    red_p, fwd_plain_ms = _plain_ms(
        lambda: genotyping_cuda.forward_plain(K, T, P, *cut[:4], cut[5], scaling_p, beta_p))
    rel = max(_rel_err(scaling, scaling_p), _col_err(beta, beta_p), _rel_err(red, red_p))
    print(f"{label}: wide kernels against plain on the first {plain_cols} columns: rel err {rel:.3e}", flush=True)
    _require(rel <= 1e-4, f"{label}: wide kernels agree with plain on the cut")
    errs = {"geno_backward_wide": max(_abs_err(beta, beta_p), _abs_err(scaling, scaling_p)),
            "geno_forward_wide": _abs_err(_per_col(red), _per_col(red_p))}
    cells = B * C * S
    exps_ms = cells * T * P * 2 / PEAK_EXP_PER_S * 1e3
    adds_ms = cells * T * (P * 2 + (1 << P)) / PEAK_F32_ADDS_PER_S * 1e3
    prod_ms = cells * T * T / PEAK_TF32X3_MACS_PER_S * 1e3
    prod_cores_ms = cells * T * T / PEAK_F32_ADDS_PER_S * 1e3
    tiles = genotyping_cuda.wide_tiles(K, T)
    windows = {"geno_backward_wide": wide_window_stats(K, T, P, birth, True),
               "geno_forward_wide": wide_window_stats(K, T, P, die_next, False)}
    out = {}
    for name, ms, plain_ms in (("geno_backward_wide", bwd_ms, bwd_plain_ms),
                               ("geno_forward_wide", fwd_ms, fwd_plain_ms)):
        bytes_ms = nbytes[name] / PEAK_BYTES_PER_S * 1e3
        bound = max(bytes_ms, exps_ms, adds_ms, prod_ms)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, max_abs_err=errs[name],
                         bound_by="bytes" if bound == bytes_ms else "operations")
        n_win, longest, breaks = windows[name]
        print(f"{label} {name} (B={B} C={C} K={K} T={T} P={P}): {ms:.3f} ms = {1e3 * ms / C:.2f} us a column "
              f"(plain {plain_ms:.3f} ms on {plain_cols} columns), bound {bound:.4f} ms by "
              f"{out[name]['bound_by']} (bytes {bytes_ms:.4f}, exp {exps_ms:.4f}, f32 adds and multiply-adds "
              f"{adds_ms:.4f}, the product {prod_ms:.4f} on the tensor cores in 3xTF32 and {prod_cores_ms:.4f} "
              f"on the CUDA cores, {adds_ms + prod_cores_ms:.4f} with the adds); {B * tiles} tiles a pass, "
              f"{n_win} windows (longest {longest}, {breaks} breaks at the tile bits); "
              f"{100 * bound / ms:.3f} % of the bound", flush=True)
    return out


# ---------------------------------------------------------------------------
# forward_cost_batched, the dry run over several devices, the last host
# commands
# ---------------------------------------------------------------------------

# (T, K) at which forward_cost_batched is held to its plain version: T = 1 in
# the cluster kernel (K 7 to 17) and the wide one (K = 20), T = 4 and 16 in
# the general-T cluster kernel, T = 64 in the wide general-T kernel
FORWARD_COST_SHAPES = ((1, 7), (1, 15), (1, 17), (1, 20), (4, 12), (4, 16), (16, 13), (64, 15))
# the plain versions that the CUDA route of forward_cost_batched must not reach
FORWARD_COST_PLAIN = ((wmec, "forward_scan"), (wmec, "forward_carry"), (wmec_cuda, "forward_carry_t1_plain"),
                      (wmec_cuda, "forward_carry_t_plain"))
# polyphasegenetic on the committed fixtures: the parents' VCF, the progeny's
# (64 samples), a PED naming Parent_A x Parent_B as the parents of
# Progeny_1 to Progeny_24, --sample Parent_A at ploidy 4; the SHA-256 of its
# record lines (those not starting with "#"), which
# tests/test_torch_polyphasegenetic.py holds equal to the reference's
POLYPHASEGENETIC_PROGENY = 24
POLYPHASEGENETIC_RECORDS_SHA256 = "36248ab2d16a27db51e1babbccd5833a84a378e0286f24913ab63efca20fa37e"


@contextlib.contextmanager
def refused(names):
    """Each (module, attribute) of `names` made to raise within the block."""

    def refuse(*_args, **_kwargs):
        raise AssertionError("a plain version ran on the CUDA route")

    saved = [(mod, name, getattr(mod, name)) for mod, name in names]
    for mod, name, _fn in saved:
        setattr(mod, name, refuse)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _carry_kernel(K, T, P) -> str:
    """The carry kernel that forward_cost_batched launches at (K, T, P)."""
    return _t1_name(K, "wmec_forward_carry_t1") if T == 1 else _t_name(K, T, P, "wmec_forward_carry_t")


def compare_forward_cost(device="cuda", shapes=FORWARD_COST_SHAPES):
    """Phase 15a: wmec.forward_cost_batched on the card (the carry kernels
    from a zero carry) against its plain version on the same CUDA tensors,
    bit for bit on all three outputs (cost, jmin, key), at each (T, K) of
    `shapes`: one launch of the shape's carry kernel and of no other kernel,
    with every plain version made to raise.  Returns the max abs error."""
    worst = 0
    for T, K in shapes:
        if T == 1:
            P = 2
            arrays = packed_bucket(4, 128, K, 6000 + K, device) if K <= 17 else packed_bucket(2, 32, K, 6000 + K,
                                                                                                device)
        else:
            P = 4
            n_blocks, n_cols = (3, 64) if T < 64 else (2, 40)
            arrays = pedigree_bucket(n_blocks, n_cols, K, T, 7000 + K + T, device)
        plain = wmec.forward_cost_batched_plain(K, T, P, *arrays)
        reset_launches()
        with refused(FORWARD_COST_PLAIN):
            got = wmec.forward_cost_batched(K, T, P, *arrays)
            torch.cuda.synchronize()
        launched = {name: n for name, n in read_launches().items() if n}
        e = _max_err(zip(got, plain))
        print(f"forward_cost_batched T={T:2d} K={K:2d} B={arrays[0].shape[0]} C={arrays[0].shape[1]}: "
              f"max|err|={e} (cost, jmin, key), launches {launched}", flush=True)
        _require(launched == {_carry_kernel(K, T, P): 1}, f"forward_cost_batched at T={T}, K={K} launches its "
                 "carry kernel once and nothing else")
        _require(e == 0, f"forward_cost_batched bit-equal to plain at T={T}, K={K}")
        worst = max(worst, e)
        del got, plain, arrays
    return worst


def time_forward_cost(arrays, K, T, P, label, reps=3):
    """Row 17, forward_cost_batched, at `arrays` (one launch of its carry
    kernel), beside its plain version and its bound: the bytes of the
    function's inputs (rc not read at T = 1) and outputs, against the int32
    adds of the carry mode (5 a state and column at T = 1; above as
    _general_t_ops counts them)."""
    B, C, S = arrays[0].shape[0], arrays[0].shape[1], 1 << K
    ms = _time(lambda: wmec.forward_cost_batched(K, T, P, *arrays), reps=reps)
    got = wmec.forward_cost_batched(K, T, P, *arrays)
    plain, plain_ms = _plain_ms(lambda: wmec.forward_cost_batched_plain(K, T, P, *arrays))
    err = _max_err(zip(got, plain))
    ops = 5 * B * C * S if T == 1 else _general_t_ops(K, T, P, arrays[4])
    bound = _bound(_nbytes(*(arrays[:5] if T == 1 else arrays)), _nbytes(*got), ops)
    print(f"{label} forward_cost_batched (B={B} C={C} K={K} T={T}; {_carry_kernel(K, T, P)}): {ms:.3f} ms "
          f"(plain {plain_ms:.3f} ms), bound {bound[0]:.4f} ms by {bound[1]}, max|err|={err}; "
          f"{card_name_and_power()}", flush=True)
    _require(err == 0, f"{label}: forward_cost_batched bit-equal to plain")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound[0], bound_by=bound[1])


def dryrun_phase(n_devices=4):
    """Phase 15b: parallel/dryrun.py's dry run over cuda:0 x n_devices (one
    card: the shards run one after another through the split, copies and
    gather of the sharded launches): the sharded solves and costs-only
    forwards against serial solves, then the phase CLI sharded against one
    device, byte-identical.  Returns the launches of the run."""
    from whatshap_torch.parallel import dryrun

    devices = dryrun.dryrun_devices(n_devices, "cuda")
    reset_launches()
    wmec.LAUNCH_STATS.clear()
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(n_devices, "cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    sharded = sum(1 for stats in wmec.LAUNCH_STATS if stats[-1] > 1)
    print(f"dryrun_multichip({n_devices}) over {[str(d) for d in devices]}: {secs:.2f} s; {sharded} sharded "
          f"launches in the CLI run; kernel launches {({k: v for k, v in launches.items() if v})}; "
          f"{card_name_and_power()}", flush=True)
    _require(sharded > 0, "the dry run's CLI sharded a launch")
    _require(launches["wmec_forward_carry_t1"] == n_devices and launches["wmec_forward_carry_t"] == n_devices,
             "the dry run's costs-only forwards launched the carry kernels once a shard")
    return launches


def records_sha256(path) -> str:
    """SHA-256 of a VCF's record lines (those not starting with '#')."""
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(b"".join(line for line in f if not line.startswith(b"#"))).hexdigest()


def write_polyphasegenetic_ped(path, n=POLYPHASEGENETIC_PROGENY) -> str:
    with open(path, "w") as f:
        f.writelines(f"Parent_A Parent_B Progeny_{i}\n" for i in range(1, n + 1))
    return str(path)


def host_commands_phase(tmp) -> None:
    """Phase 15c: the last host commands, on committed fixtures (no device
    work): find_snv_candidates on tests/data/pacbio (its records equal
    tests/data/expected-calls.vcf's), learn on
    tests/data/short-genome/learn-data (equal to expected.txt), and
    polyphasegenetic (--sample Parent_A, ploidy 4, the PED of
    write_polyphasegenetic_ped) whose record lines must hash to
    POLYPHASEGENETIC_RECORDS_SHA256.  Each wall is printed."""
    import filecmp

    from whatshap_torch.cli.find_snv_candidates import run_find_snv_candidates
    from whatshap_torch.cli.learn import run_learn
    from whatshap_torch.cli.polyphasegenetic import run_polyphasegenetic

    walls = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        run_find_snv_candidates("tests/data/pacbio/reference.fasta", "tests/data/pacbio/pacbio.bam",
                                datatype="pacbio", output=f"{tmp}/calls.vcf")
    walls["find_snv_candidates"] = time.perf_counter() - t0

    def records(path):
        return [line for line in open(path) if not line.startswith("#")]

    _require(records(f"{tmp}/calls.vcf") == records("tests/data/expected-calls.vcf"),
             "find_snv_candidates calls tests/data/expected-calls.vcf's sites")
    t0 = time.perf_counter()
    learn_dir = "tests/data/short-genome/learn-data"
    run_learn(reference=f"{learn_dir}/short_ref.fasta", bam=f"{learn_dir}/short-reads.bam",
              vcf=f"{learn_dir}/variant.vcf", k=7, window=25, output=f"{tmp}/learn.txt")
    walls["learn"] = time.perf_counter() - t0
    _require(filecmp.cmp(f"{learn_dir}/expected.txt", f"{tmp}/learn.txt", shallow=False),
             "learn writes expected.txt")
    t0 = time.perf_counter()
    run_polyphasegenetic("tests/data/polyphasegenetic.test.parents.vcf", write_polyphasegenetic_ped(f"{tmp}/pg.ped"),
                         4, progeny_file="tests/data/polyphasegenetic.test.progeny.vcf.gz", samples=["Parent_A"],
                         output=f"{tmp}/pg.vcf", write_command_line_header=False)
    walls["polyphasegenetic"] = time.perf_counter() - t0
    phased = sum(1 for line in records(f"{tmp}/pg.vcf") if "|" in line)
    _require(records_sha256(f"{tmp}/pg.vcf") == POLYPHASEGENETIC_RECORDS_SHA256,
             "polyphasegenetic writes the reference's records")
    print(f"host commands: find_snv_candidates {walls['find_snv_candidates']:.3f} s, learn {walls['learn']:.3f} s, "
          f"polyphasegenetic {walls['polyphasegenetic']:.3f} s ({phased} variants phased); {host_context()}",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)

    # 1. build
    secs, logs = _build.build_all()
    print(f"build: {secs:.2f} s for {sorted(logs) or 'nothing (already built)'}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    for name in _build.sources():
        _build.load(name)
    secs, logs = _build.build_host()
    print(f"host build: {secs:.2f} s for {sorted(logs) or 'nothing (already built)'} (g++, "
          f"{os.cpu_count()} host CPUs)", flush=True)
    for name in hostlib.__all__:
        getattr(hostlib, name)
    # polyphase-chrom on the Python paths takes about two minutes of one host
    # CPU: it runs beside phase 2, which times nothing on the host, and is
    # read in phase 11c
    poly_tmp = tempfile.TemporaryDirectory()
    poly_chrom = start_polyphase_python(poly_tmp.name)

    # 2. kernels against their plain versions (row 13, the wide T=1 kernel,
    # at K = 18 to 23 and against the cluster kernel at K = 7 to 17)
    errs = {}

    def merge(found):
        for name, e in found.items():
            errs[name] = max(errs.get(name, 0), e)
        print(f"  (phase 2 at {time.perf_counter() - t_start:.1f} s)", flush=True)

    merge(compare_kernels("cuda"))
    merge(compare_kernels("cuda", shapes=WIDE_SHAPES, n_cols=32))
    merge(compare_carry_kernels("cuda"))
    merge(compare_carry_kernels("cuda", shapes=tuple((1, K) for K, _b in WIDE_SHAPES), n_blocks=2, n_cols=48,
                                head_cols=16))
    merge(compare_pedigree_kernels("cuda"))
    # row 14, the general-T kernel with its T planes in device memory, past
    # the cluster kernel: three founders (P = 6), four founders (P = 8)
    merge(compare_pedigree_kernels("cuda", shapes=WIDE_T_PEDIGREE_SHAPES, n_blocks=2, n_cols=40))
    merge(compare_pedigree_kernels("cuda", shapes=((16, 12),), n_blocks=2, n_cols=40, pedigree=DOUBLE_TRIO))
    merge(compare_pedigree_kernels("cuda", shapes=((16, 9),), n_blocks=2, n_cols=40, pedigree=FOUR_FOUNDERS))
    # row 14 and rows 5/8 at five trios (T = 1024: the backtrace's 1,025
    # walks a block) and five founders (P = 10)
    merge(compare_pedigree_kernels("cuda", shapes=((1024, 8),), n_blocks=2, n_cols=40))
    merge(compare_pedigree_kernels("cuda", shapes=((256, 10),), n_blocks=2, n_cols=40, pedigree=FIVE_FOUNDERS))
    merge(compare_tie_kernels("cuda", shapes=FIVE_TIE_SHAPES, n_blocks=2, n_cols=16, head_cols=6))
    merge(compare_walks("cuda", random_shapes=((1024, 6, 1, 1025), (1024, 4, 2, 3)), free_shapes=()))
    merge(compare_walks("cuda"))
    merge(compare_tie_kernels("cuda"))
    merge(compare_tie_kernels("cuda", shapes=WIDE_T_TIE_SHAPES, n_blocks=2, n_cols=40, head_cols=12))
    merge(compare_tie_kernels_t1("cuda"))
    merge(compare_tie_kernels_t1("cuda", shapes=WIDE_SHAPES))
    merge(compare_wide_cluster("cuda"))
    merge(compare_wide_edges("cuda"))
    merge(compare_wide_t_cluster("cuda"))
    torch.cuda.empty_cache()
    merge(compare_geno_kernels("cuda"))
    # rows 15-16, the genotyping kernels with the state in device memory,
    # past the cluster kernels and against them inside their envelope
    torch.cuda.empty_cache()
    merge(compare_geno_wide("cuda"))
    merge(compare_geno_wide("cuda", shapes=GENO_FIVE_SHAPES, n_blocks=2, cols=16, check_windows=False))
    compare_geno_wide_cluster("cuda")
    print(f"phases 1-2 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    def both(hap):  # the two haplotypes of one heterozygous sample
        return np.stack([hap, 1 - hap])[None]

    # 3. the single-sample main path: a 256-block chromosome at coverage 15
    t0 = time.perf_counter()
    rs, positions, truth = chromosome(256, 512, 15, seed=7)
    print(f"chromosome built in {time.perf_counter() - t0:.1f} s", flush=True)
    het = _het_pedigree(len(positions))
    launches = phase_instance(
        rs, positions, het, [1] * len(positions), (truth[0], both(truth[1])), "cuda", "slice",
        ("wmec_forward_t1", "wmec_backtrace_t1"),
    )

    # 4. one read-connected block of 4096 columns (single-block route, B = 1)
    rs1, pos1, truth1 = chromosome(1, 4096, 15, seed=3)
    het1 = _het_pedigree(len(pos1))
    packed1 = wmec.pack_problem(rs1, [1] * len(pos1), het1, False)
    _require(len(wmec.connected_column_ranges(packed1)) == 1, "single block is one range")
    phase_instance(
        rs1, pos1, het1, [1] * len(pos1), (truth1[0], both(truth1[1])), "cuda", "single",
        ("wmec_forward_t1", "wmec_backtrace_t1"),
    )
    del rs1
    print(f"phases 3-4 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # 5. the pedigree path: a 64-block trio chromosome at coverage 5 each
    t0 = time.perf_counter()
    rs_t, pos_t, ped_t, truth_t = simulate_pedigree(64, 256, 5, TRIO, seed=11)
    print(f"trio chromosome built in {time.perf_counter() - t0:.1f} s", flush=True)
    pedigree_kernels = ("wmec_forward_t", "wmec_forward_m_t", "wmec_backtrace_t")
    trio_launches = phase_instance(
        rs_t, pos_t, ped_t, [10] * len(pos_t), truth_t, "cuda", "trio", pedigree_kernels
    )

    # 6. one read-connected trio range of 2048 columns (single-block route)
    rs_s, pos_s, ped_s, truth_s = simulate_pedigree(1, 2048, 5, TRIO, seed=5)
    packed_s = wmec.pack_problem(rs_s, [10] * len(pos_s), ped_s, False, pos_s)
    _require(len(wmec.connected_column_ranges(packed_s)) == 1, "trio-single is one range")
    # one range of 2048 columns may hold a switch error: agreement is
    # counted up to one flip per 256-column window
    windows = (np.arange(len(pos_s)) // 256, truth_s[1])
    phase_instance(
        rs_s, pos_s, ped_s, [10] * len(pos_s), windows, "cuda", "trio-single",
        ("wmec_forward_t", "wmec_backtrace_t"),
    )
    del rs_s

    # 7. a quartet (two trios with shared parents: T = 16, four cosets)
    rs_q, pos_q, ped_q, _truth_q = simulate_pedigree(16, 128, 3, QUARTET, seed=13)
    phase_instance(
        rs_q, pos_q, ped_q, [10] * len(pos_q), None, "cuda", "quartet", pedigree_kernels
    )
    packed_q = wmec.pack_problem(rs_q, [10] * len(pos_q), ped_q, False, pos_q)
    del rs_q
    # pedigree-p6: a three-generation pedigree with three founders (P = 6,
    # T = 16: row 14 in both passes of the seam route)
    rs_p6, pos_p6, ped_p6, _truth_p6 = simulate_pedigree(16, 128, 3, DOUBLE_TRIO, seed=17)
    phase_instance(
        rs_p6, pos_p6, ped_p6, [10] * len(pos_p6), None, "cuda", "pedigree-p6",
        ("wmec_forward_t_wide", "wmec_forward_m_t_wide", "wmec_backtrace_t"),
    )
    del rs_p6
    # pedigree-p10: five founders and four trios (T = 256, P = 10) at K = 12
    torch.cuda.empty_cache()
    p10_launches, p10_packed, p10_geno_launches, p10_geno_prepared = pedigree_p10()
    print(f"pedigree-p10 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"phases 5-7 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # 8. genotyping: one sample of 32,768 variants at coverage 15 (K = 15),
    # and a trio of 8,192 variants at coverage 5 each (K = 15, T = 4)
    torch.cuda.empty_cache()
    geno_static, geno_stacked = genotype_instance(
        (32768, 15, SINGLE, 17), "cuda", "genotype", check_cols=2048, atol=2e-4
    )
    trio_g_static, trio_g_stacked = genotype_instance(
        (8192, 5, TRIO, 19), "cuda", "genotype-trio", check_cols=1024, atol=3e-4
    )
    print(f"phase 8 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # 9. the segmented solve of single ranges beyond the (pinned) budget
    torch.cuda.empty_cache()
    rs_g, pos_g, truth_g = chromosome(1, 32768, 15, seed=23)
    seg_launches, packed_g = segmented_instance(
        rs_g, pos_g, _het_pedigree(len(pos_g)), [1] * len(pos_g), (truth_g[0], both(truth_g[1])),
        "segmented", K=15, T=1, n_seg=16,
    )
    del rs_g
    rs_gt, pos_gt, ped_gt, truth_gt = simulate_pedigree(1, 8192, 5, TRIO, seed=29)
    seg_trio_launches, packed_gt = segmented_instance(
        rs_gt, pos_gt, ped_gt, [10] * len(pos_gt), (np.arange(len(pos_gt)) // 256, truth_gt[1]),
        "segmented-trio", K=15, T=4, n_seg=16,
    )
    del rs_gt
    rs_k, pos_k, truth_k = chromosome(1, 2048, 17, seed=31)
    _l, packed_k = segmented_instance(
        rs_k, pos_k, _het_pedigree(len(pos_k)), [1] * len(pos_k), (truth_k[0], both(truth_k[1])),
        "segmented-k17", K=17, T=1, n_seg=2,
    )
    del rs_k
    # segmented-k23: 2,048 columns at K = 23 at the default budget (row 13)
    torch.cuda.empty_cache()
    seg23_launches, packed_23 = wide_segmented_instance()
    # segmented-trio-wide: one trio range at K = 18 (row 14) past the pinned
    # budget, in the reference's XLA-route segments (16 of 64), held to the
    # plain route; the exact optimum of this range mis-phases the mother in
    # two of its four 256-column windows (0.63 and 0.67 of her calls there,
    # on the CPU's plain route as on the card), so its agreement with the
    # simulation is printed, not held
    rs_w, pos_w, ped_w, truth_w = simulate_pedigree(1, 1024, 6, TRIO, seed=41)
    segw_launches, packed_w = segmented_instance(
        rs_w, pos_w, ped_w, [10] * len(pos_w), (np.arange(len(pos_w)) // 256, truth_w[1]),
        "segmented-trio-wide", K=18, T=4, n_seg=16, plain=True, min_agree=None,
    )
    del rs_w
    print(f"phase 9 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # 10-11. the phase CLI, files in and a phased VCF out: a chr1-sized
    # single-sample chromosome with realignment, and a trio with its PED file
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        chrom = write_synth(f"{tmp}/chrom", CLI_VARIANTS, 14, seed=7)
        print(f"phase-cli: chromosome written in {time.perf_counter() - t0:.1f} s", flush=True)
        host_phase(tmp)
        print(f"phase 10 (host) done at {time.perf_counter() - t_start:.1f} s", flush=True)
        cli_launches, cli_packed, _w, _r = cli_instance(chrom, "phase-cli", ("wmec_forward_t1", "wmec_backtrace_t1"))
        del chrom
        t0 = time.perf_counter()
        trio = write_synth(f"{tmp}/trio", CLI_TRIO_VARIANTS, 5, seed=11, trio=True)
        print(f"phase-cli-trio: trio written in {time.perf_counter() - t0:.1f} s", flush=True)
        cli_trio_launches, cli_trio_packed, _w, _r = cli_instance(trio, "phase-cli-trio", pedigree_kernels,
                                                                  ped=trio["ped"])
        # tools: phase on the card, then compare, stats, haplotag, split,
        # unphase and the host solvers (heuristic, hapchat) on its files
        t0 = time.perf_counter()
        tools_phase(tmp)
        print(f"phase 11b (tools) took {time.perf_counter() - t0:.1f} s, done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # polyphase: the host-only polyploid phaser and its libraries
        t0 = time.perf_counter()
        polyphase_phase(tmp, poly_chrom)
        poly_tmp.cleanup()
        print(f"phase 11c (polyphase) took {time.perf_counter() - t0:.1f} s, done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # phase-cli-ds23: --internal-downsampling 23 on a coverage-30
        # chromosome, the single-sample main path past the cluster kernel
        torch.cuda.empty_cache()
        ds23_launches, ds23_packed = cli_ds23(tmp)
        # phase-cli-fam5: three children (T = 64, row 14), and
        # phase-cli-trio-ds23: a trio at --internal-downsampling 23
        torch.cuda.empty_cache()
        fam5_launches, fam5_packed = cli_fam5(tmp)
        torch.cuda.empty_cache()
        cli_trio_ds23(tmp)
        # phase-cli-fam7: five children (T = 1024)
        torch.cuda.empty_cache()
        fam7_launches, fam7_packed = cli_fam7(tmp)
        print(f"phase-cli-fam7 done at {time.perf_counter() - t_start:.1f} s", flush=True)
        print(f"phases 10-11 done at {time.perf_counter() - t_start:.1f} s", flush=True)

        # 12-13. the genotype CLI, files in and a genotyped VCF out: a
        # single-sample chromosome of mixed genotypes, and phase-cli-trio's files
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        geno_chrom = write_synth(f"{tmp}/geno", GENO_CLI_VARIANTS, 14, seed=13, mixed=True)
        print(f"genotype-cli: chromosome written in {time.perf_counter() - t0:.1f} s", flush=True)
        geno_cli_launches, _prepared = geno_cli_instance(geno_chrom, "genotype-cli", atol=2e-4,
                                                         min_concordance=0.9)
        del _prepared
        del geno_chrom
        torch.cuda.empty_cache()
        # at 5 reads a sample (fewer at some sites) the reference's own host
        # engine recovers 0.859, 0.865 and 0.899 of these files' genotypes:
        # the trio is held to 0.85 (PERF.md, the genotype CLI findings)
        _l, geno_cli_trio_prepared = geno_cli_instance(trio, "genotype-cli-trio", atol=3e-4,
                                                       min_concordance=0.85, ped=trio["ped"])
        del trio
        # genotype-cli-fam5: a family of three children (T = 64) and
        # genotype-cli-cov20: one sample at --max-coverage 20 (K up to 20),
        # both past the cluster kernels (rows 15-16), each with its CLI bar
        # against the float64 plain route on a 512-variant cut
        torch.cuda.empty_cache()
        fam5 = dict(seed=31, synth=dict(trio=True, children=3), atol=3e-4, min_concordance=GENO_FAM5_CONCORDANCE,
                    shape_ok=lambda K, T, P: (T, P) == (64, 4))
        geno_fam5_launches, geno_fam5_prepared = geno_cli_wide(tmp, "genotype-cli-fam5", GENO_FAM5_VARIANTS, 5,
                                                               plain=False, **fam5)
        geno_cli_wide(tmp, f"genotype-cli-fam5-{GENO_WIDE_CUT_VARIANTS}", GENO_WIDE_CUT_VARIANTS, 5, plain=True,
                      **fam5)
        # at --max-coverage 20 some wrong genotypes' likelihoods fall past
        # float32's range (below 1.4e-45): the cut is also held to the
        # float32 plain route (geno_cli_instance, f32_range)
        cov20 = dict(seed=37, synth=dict(mixed=True), atol=2e-4, min_concordance=0.9, max_coverage=20,
                     shape_ok=lambda K, T, P: T == 1 and K > 17)
        _l, geno_cov20_prepared = geno_cli_wide(tmp, "genotype-cli-cov20", GENO_COV20_VARIANTS, 22, plain=False,
                                                **cov20)
        geno_cli_wide(tmp, f"genotype-cli-cov20-{GENO_WIDE_CUT_VARIANTS}", GENO_WIDE_CUT_VARIANTS, 22, plain=True,
                      f32_range=True, **cov20)
        # genotype-cli-fam7: five children (T = 1024, K up to 14), with its
        # CLI bar against the float64 plain route on a cut
        torch.cuda.empty_cache()
        fam7 = dict(seed=43, synth=dict(trio=True, children=5), atol=3e-4, min_concordance=GENO_FAM5_CONCORDANCE,
                    shape_ok=lambda K, T, P: (T, P) == (1024, 4))
        geno_fam7_launches, geno_fam7_prepared = geno_cli_wide(tmp, "genotype-cli-fam7", geno_fam7_variants(), 5,
                                                               plain=False, **fam7)
        torch.cuda.empty_cache()
        geno_cli_wide(tmp, f"genotype-cli-fam7-{GENO_FAM7_CUT_VARIANTS}", GENO_FAM7_CUT_VARIANTS, 5, plain=True,
                      **dict(fam7, min_concordance=GENO_FAM7_CUT_CONCORDANCE))
        print(f"genotype-cli-fam7 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"phases 12-13 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # 15. forward_cost_batched against its plain version, the dry run over
    # cuda:0 x 4, and the last host commands
    t0 = time.perf_counter()
    errs["forward_cost_batched"] = compare_forward_cost("cuda")
    t1 = time.perf_counter()
    dryrun_launches = dryrun_phase(4)
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        host_commands_phase(tmp)
    t3 = time.perf_counter()
    print(f"phase 15 took {t3 - t0:.1f} s (15a {t1 - t0:.1f}, 15b {t2 - t1:.1f}, 15c {t3 - t2:.1f}), done at "
          f"{t3 - t_start:.1f} s", flush=True)

    # 14. kernel times at the main paths' shapes
    # (rows 1-2 and 6-8 of the kernels line at the phase CLI's buckets and
    # rows 11-12 at the genotype CLI's instance, the paths users run; the
    # library cells' as before beside them)
    times = {}
    packed = wmec.pack_problem(rs, [1] * len(positions), het, False)
    time_kernels(packed)
    # row 17, forward_cost_batched, at the slice's bucket (the kernels line)
    # and at entry()'s example batch
    (_c, slice_k), slice_members, _ri = main_bucket(packed)
    times["forward_cost_batched"] = time_forward_cost(
        blocks.to_device(blocks.stack_blocks(slice_members), "cuda"), slice_k, 1, 2, "slice")
    del slice_members
    from whatshap_torch.parallel import dryrun
    entry_fn, entry_args = dryrun.entry("cuda")
    time_forward_cost(entry_args, entry_args[0].shape[2], 1, 2, "entry", reps=10)
    del packed
    torch.cuda.empty_cache()
    times.update(time_kernels(cli_packed, "phase-cli"))
    del cli_packed
    torch.cuda.empty_cache()
    time_kernels(packed1, "single")
    del packed1
    packed_t = wmec.pack_problem(rs_t, [10] * len(pos_t), ped_t, False, pos_t)
    time_pedigree_kernels(packed_t)
    torch.cuda.empty_cache()
    times.update(time_pedigree_kernels(cli_trio_packed, label="phase-cli-trio"))
    del cli_trio_packed
    time_trio_single_kernels(packed_s)
    time_quartet_walks(packed_q)
    del packed_t, packed_s
    torch.cuda.empty_cache()
    # rows 11-12: the genotype cell's instance (32,768 columns; the f32
    # plain versions at the genotype CLI's 97,247 columns are left out to
    # hold the script inside its time limit)
    times.update(time_geno_kernels(geno_static, geno_stacked, "genotype"))
    torch.cuda.empty_cache()
    time_geno_kernels(trio_g_static, trio_g_stacked, "genotype-trio")
    torch.cuda.empty_cache()
    time_geno_kernels(*geno_cli_trio_prepared, "genotype-cli-trio")
    del geno_cli_trio_prepared
    torch.cuda.empty_cache()
    # rows 15-16: the wide genotyping kernels at the instances of
    # genotype-cli-fam5 (the kernels line) and genotype-cli-cov20
    times.update(time_geno_wide(*geno_fam5_prepared, "genotype-cli-fam5"))
    del geno_fam5_prepared
    torch.cuda.empty_cache()
    time_geno_wide(*geno_cov20_prepared, "genotype-cli-cov20")
    del geno_cov20_prepared
    torch.cuda.empty_cache()
    times.update(time_carry_kernels(packed_g, 2048, "segmented"))
    times.update(time_carry_kernels(packed_gt, 512, "segmented-trio"))
    # row 13: a batched bucket at K = 20 (16 blocks of 64 columns, the
    # kernels line), one launch of phase-cli-ds23's main bucket, and the
    # segmented solve's two passes at a segment of segmented-k23
    torch.cuda.empty_cache()
    times["wmec_forward_t1_wide"] = time_wide_bucket("wide-k20", packed_bucket(16, 64, 20, 9000, "cuda"), 20)
    time_ds23_bucket(ds23_packed)
    del ds23_packed
    times.update(time_carry_kernels(packed_23, wmec._xla_segment_length(packed_23.n_cols), "segmented-k23"))
    del packed_23
    # row 14: one launch of phase-cli-fam5's main bucket in each mode (the
    # kernels line), as the route chunks it under the table budget, and both
    # passes at a segment of segmented-trio-wide
    torch.cuda.empty_cache()
    (c_pad, k_b), _m, _r = main_bucket(fam5_packed)
    T, P = fam5_packed.T, fam5_packed.P
    per_block = c_pad * (T * 8 << k_b) + wmec_cuda.state_bytes(k_b, T, P)
    fam5_times = time_pedigree_kernels(fam5_packed, label="phase-cli-fam5",
                                       max_blocks=max(1, wmec._table_budget(torch.device("cuda")) // per_block),
                                       plain_blocks=1)
    fam5_times.pop("wmec_backtrace_t")  # the kernels line reads rows 5 and 8 on phase-cli-trio
    times.update(fam5_times)
    del fam5_packed
    torch.cuda.empty_cache()
    time_carry_kernels(packed_w, 64, "segmented-trio-wide")
    # rows 14 and 5/8 at five trios (one launch of phase-cli-fam7's main
    # bucket in each mode, one block: its 256 coset seeds' cost planes are
    # 16 GiB at K = 14; the plain versions on its first 8 columns, the
    # m-only one from its first seed) and five founders (pedigree-p10's
    # main bucket); rows 15-16 at
    # genotype-cli-fam7's instance and pedigree-p10's
    torch.cuda.empty_cache()
    new_shapes = {}
    for tag, got in (("t1024", time_pedigree_kernels(fam7_packed, label="phase-cli-fam7", max_blocks=1,
                                                     plain_blocks=1, plain_seeds=1, plain_cols=8, carry=False)),
                     ("p10", time_pedigree_kernels(p10_packed, label="pedigree-p10", plain_blocks=1, carry=False))):
        for name, r in got.items():
            new_shapes[f"{name}:{tag}"] = r
        torch.cuda.empty_cache()
    del fam7_packed, p10_packed
    for tag, (prepared, label, cols) in (("t1024", (geno_fam7_prepared, "genotype-cli-fam7", 16)),
                                         ("p10", (p10_geno_prepared, "pedigree-p10", 8))):
        for name, r in time_geno_wide(*prepared, label, plain_cols=cols).items():
            new_shapes[f"{name}:{tag}"] = r
        torch.cuda.empty_cache()
    del geno_fam7_prepared, p10_geno_prepared
    times.update(new_shapes)
    for packed_x, seg, label in ((packed_g, 2048, "segmented"), (packed_k, 1024, "segmented-k17"),
                                 (packed_gt, 512, "segmented-trio"), (packed_w, 64, "segmented-trio-wide")):
        time_segment_walk(packed_x, seg, label)
    del packed_g, packed_gt, packed_k, packed_q, packed_w
    # rows 1-2 and 6-8 are read on the phase CLI, rows 11-12 on the genotype
    # CLI: the paths users run
    launches.update({k: cli_launches[k] for k in ("wmec_forward_t1", "wmec_backtrace_t1")})
    launches.update({k: cli_trio_launches[k] for k in pedigree_kernels})
    launches.update({k: geno_cli_launches[k] for k in ("geno_backward", "geno_forward")})
    launches.update({k: geno_fam5_launches[k] for k in WIDE_GENO})
    launches["wmec_forward_carry_t1"] = seg_launches["wmec_forward_carry_t1"]
    launches["wmec_forward_t1:carry_in"] = seg_launches["wmec_forward_t1"]
    launches["wmec_forward_carry_t"] = seg_trio_launches["wmec_forward_carry_t"]
    launches["wmec_forward_t:carry_in"] = seg_trio_launches["wmec_forward_t"]
    # row 13 on its paths: phase-cli-ds23 (tables from zero), segmented-k23
    # (the carry mode, and tables from a carry)
    launches["wmec_forward_t1_wide"] = ds23_launches["wmec_forward_t1_wide"]
    launches["wmec_forward_carry_t1_wide"] = seg23_launches["wmec_forward_carry_t1_wide"]
    launches["wmec_forward_t1_wide:carry_in"] = seg23_launches["wmec_forward_t1_wide"]
    # row 14 on its paths: phase-cli-fam5 (tables, m-only), segmented-trio-wide
    # (the carry mode, and tables from a carry)
    launches["wmec_forward_t_wide"] = fam5_launches["wmec_forward_t_wide"]
    launches["wmec_forward_m_t_wide"] = fam5_launches["wmec_forward_m_t_wide"]
    launches["wmec_forward_carry_t_wide"] = segw_launches["wmec_forward_carry_t_wide"]
    launches["wmec_forward_t_wide:carry_in"] = segw_launches["wmec_forward_t_wide"]
    # the new shapes on their paths: five trios on phase-cli-fam7 and
    # genotype-cli-fam7, five founders on pedigree-p10
    for name in PEDIGREE_KERNELS_WIDE:
        launches[f"{name}:t1024"] = fam7_launches[name]
        launches[f"{name}:p10"] = p10_launches[name]
    for name in WIDE_GENO:
        launches[f"{name}:t1024"] = geno_fam7_launches[name]
        launches[f"{name}:p10"] = p10_geno_launches[name]

    # row 17 on its path: the dry run's costs-only forwards over cuda:0 x 4
    launches["forward_cost_batched"] = dryrun_launches["wmec_forward_carry_t1"]

    power = card_name_and_power()
    kernels = []
    for name, source, replaces in ENTRIES:
        t = times[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"whatshap_torch/csrc/{source}.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(errs.get(name, 0), t["max_abs_err"]),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
        })
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(power)
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--polyphase-python-paths"]:
            sys.exit(polyphase_python_paths(*sys.argv[2:5]))
        sys.exit(main())
    finally:
        for child in CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
