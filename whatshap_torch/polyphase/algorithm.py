"""
Driver of the polyploid phaser (counterpart of
whatshap/polyphase/algorithm.py): split the input into weakly connected
blocks, run cluster editing -> threading -> reordering per block
(optionally in parallel worker processes), and stitch the block results.
"""

import logging
import multiprocessing
import os
from copy import copy
from itertools import chain
from math import log
from typing import List, Tuple

from . import (
    BlockContext, Genotype, PhaseBreakpoint, PolyphaseBlockResult,
    PolyphaseParameter, PolyphaseResult, compute_block_bounds,
)
from .reorder import find_subinstances, integrate_sub_results, run_reordering
from .solver import AlleleMatrix, ClusterEditingSolver, scoreReadset
from .threading import run_threading
from ..timer import StageTimer

logger = logging.getLogger(__name__)


def _block_inputs(allele_matrix, genotypes, partial_phasing, block):
    """Slice out one block's matrix, genotypes and optional prephasing."""
    sub_phasing = (
        partial_phasing.extractInterval(block.start, block.end) if partial_phasing else None
    )
    return (
        allele_matrix.extractInterval(block.start, block.end),
        genotypes[block.start : block.end],
        sub_phasing,
    )


def solve_polyphase_instance(
    allele_matrix: AlleleMatrix, genotypes: List[Genotype],
    param: PolyphaseParameter, timers: StageTimer,
    partial_phasing: AlleleMatrix = None, recursion_level: int = 0,
) -> PolyphaseResult:
    """Phase one polyploid instance end to end."""
    num_vars = len(allele_matrix.getPositions())
    assert num_vars > 0
    assert len(allele_matrix) > 0

    if recursion_level == 0:
        logger.info("Detecting connected components with weak interconnect ..")
    timers.start("detecting_blocks")
    single_linkage = param.block_cut_sensitivity <= 1
    blocks = list(compute_block_bounds(allele_matrix, param.ploidy, single_linkage))
    num_nontrivial = sum(1 for b in blocks if b.length > 1)
    if recursion_level == 0:
        logger.info(
            f"Split variants into {num_nontrivial} blocks (and "
            f"{len(blocks) - num_nontrivial} singleton blocks)."
        )
    timers.stop("detecting_blocks")

    if param.threads == 1:
        contexts = []
        job_counter = 0
        for block_id, block in enumerate(blocks):
            job_counter += block.length > 1
            contexts.append(
                BlockContext(block_id, job_counter, num_nontrivial, recursion_level)
            )
        # Host-thread parallelism over independent blocks: the hot stages
        # (read scoring, cluster editing, threading) run in the host
        # libraries (hostlib), whose ctypes calls release the GIL, so
        # threads overlap them across blocks —
        # the host-side analogue of batching blocks across device lanes.
        # Top level only (sub-instances recurse within a worker), and
        # results/merge order stay by block id, so output is unchanged.
        n_workers = min(num_nontrivial, os.cpu_count() or 1, 8)
        if recursion_level == 0 and num_nontrivial >= 2 and n_workers >= 2:
            from concurrent.futures import ThreadPoolExecutor

            def _run_block(i: int):
                sub_timer = StageTimer()
                inputs = _block_inputs(
                    allele_matrix, genotypes, partial_phasing, blocks[i]
                )
                res = phase_single_block(*inputs, param, sub_timer, contexts[i])
                return res, sub_timer

            # biggest blocks first: a 4/3-approximation for makespan
            order = sorted(range(len(blocks)), key=lambda i: -blocks[i].length)
            with ThreadPoolExecutor(max_workers=n_workers) as ex:
                outs = list(ex.map(_run_block, order))
            results = [None] * len(blocks)
            for i, (res, sub_timer) in zip(order, outs):
                results[i] = res
                for stage, seconds in sub_timer._acc.items():
                    timers._acc[stage] = timers._acc.get(stage, 0.0) + seconds
        else:
            results = []
            for i, block in enumerate(blocks):
                inputs = _block_inputs(allele_matrix, genotypes, partial_phasing, block)
                results.append(phase_single_block(*inputs, param, timers, contexts[i]))
    else:
        timers.start("phase_blocks")
        # Biggest blocks first: a 4/3-approximation for makespan scheduling.
        # Workers use the spawn start method — fork is unsafe once torch's
        # thread pools exist in this process; a worker loads the host
        # libraries already built into the build cache.  Job arguments are
        # pickled, which AlleleMatrix supports via __getstate__/__setstate__.
        queue = sorted(enumerate(blocks), key=lambda item: -item[1].length)
        spawn = multiprocessing.get_context("spawn")
        with spawn.Pool(processes=param.threads) as pool:
            pending = []
            for job_id, (block_id, block) in enumerate(queue):
                ctx = BlockContext(block_id, job_id, num_nontrivial, recursion_level)
                inputs = _block_inputs(allele_matrix, genotypes, partial_phasing, block)
                pending.append(
                    pool.apply_async(phase_single_block, (*inputs, param, timers, ctx))
                )
            results = [job.get() for job in pending]
        results.sort(key=lambda r: r.block_id)
        timers.stop("phase_blocks")

    if partial_phasing and param.block_cut_sensitivity == 0:
        # lowest sensitivity: block starts only become breakpoints where
        # the partial phasing is itself interrupted
        borders = {partial_phasing.getFirstPos(i) for i in range(len(partial_phasing))}
    else:
        borders = []
    return aggregate_results(results, param.ploidy, borders)


def _trivial_block_result(allele_matrix, genotypes, block_id) -> PolyphaseBlockResult:
    """Single-variant blocks phase to their genotype directly."""
    g = genotypes[0]
    clusters = [[i for i, r in enumerate(allele_matrix) if r and r[0][1] == a] for a in g]
    threads = [sorted(chain(*[[i] * g[a] for i, a in enumerate(g)]))]
    haplotypes = sorted(chain(*[[[a]] * g[a] for a in g]))
    return PolyphaseBlockResult(block_id, clusters, threads, haplotypes, [])


def phase_single_block(
    allele_matrix: AlleleMatrix, genotypes: List[Genotype],
    prephasing: AlleleMatrix, param: PolyphaseParameter,
    timers: StageTimer, context: BlockContext,
) -> PolyphaseBlockResult:
    """Cluster editing -> threading -> reordering on one block."""
    num_vars = len(genotypes)
    if num_vars < 2:
        return _trivial_block_result(allele_matrix, genotypes, context.block_id)

    if context.recursion_level == 0:
        logger.info(
            f"Processing block {context.job_id} of {context.total_blocks} with "
            f"{len(allele_matrix)} reads and {num_vars} variants."
        )

    # Phase I: pairwise read scoring + cluster editing
    assert len(allele_matrix) > 0
    assert num_vars == allele_matrix.getNumPositions()
    timers.start("read_scoring")
    logger.debug("Computing similarities for read pairs ..")
    similarities = scoreReadset(allele_matrix, param.min_overlap, param.ploidy, 0.07)
    timers.stop("read_scoring")

    timers.start("clustering")
    logger.debug(
        f"Solving cluster editing instance with {len(allele_matrix)} nodes and "
        f"{len(similarities)} edges .."
    )
    clustering = ClusterEditingSolver(similarities, param.ce_bundle_edges).run()
    del similarities
    # reads past the last clustered one become their own singleton clusters
    for i in range(sum(len(c) for c in clustering), len(allele_matrix)):
        clustering.append([i])
    timers.stop("clustering")

    # Phase II: threading
    logger.debug(f"Threading haplotypes through {len(clustering)} clusters ..\r")
    timers.start("threading")
    threads, haplotypes = run_threading(
        allele_matrix, clustering, param.ploidy, genotypes,
        distrust_genotypes=param.distrust_genotypes,
    )
    timers.stop("threading")

    # Phase III: recursive refinement of collapsed regions, then reordering
    logger.debug("Reordering ambiguous sites ..\r")
    timers.start("reordering")
    sub_instances = find_subinstances(allele_matrix, clustering, threads, haplotypes)
    sub_results = []
    sub_param = copy(param)
    sub_param.use_prephasing = False
    sub_param.threads = 1
    for cid, thread_set, submatrix in sub_instances:
        assert len(submatrix) > 0
        local_positions = [allele_matrix.globalToLocal(g) for g in submatrix.getPositions()]
        assert all(0 <= pos < allele_matrix.getNumPositions() for pos in local_positions)
        sub_haplotypes = [[haplotypes[i][pos] for i in thread_set] for pos in local_positions]
        sub_genotypes = [{a: column.count(a) for a in column} for column in sub_haplotypes]
        sub_param.ploidy = len(thread_set)
        timers.stop("reordering")
        sub_results.append(
            solve_polyphase_instance(
                submatrix, sub_genotypes, sub_param, timers,
                recursion_level=context.recursion_level + 1,
            )
        )
        timers.start("reordering")

    breakpoints = integrate_sub_results(
        allele_matrix, threads, haplotypes, sub_instances, sub_results
    )
    del sub_instances, sub_results
    run_reordering(allele_matrix, clustering, threads, haplotypes, breakpoints, prephasing)
    timers.stop("reordering")

    if context.recursion_level == 0 and param.threads > 1:
        logger.info(f"Finished block {context.job_id}.")

    return PolyphaseBlockResult(
        block_id=context.block_id,
        clustering=[[allele_matrix.getGlobalId(r) for r in c] for c in clustering],
        threads=threads,
        haplotypes=haplotypes,
        breakpoints=breakpoints,
    )


def aggregate_results(
    results: List[PolyphaseBlockResult], ploidy: int, borders: List[int]
) -> PolyphaseResult:
    """Concatenate block results, offsetting cluster ids and positions."""
    total = PolyphaseResult([], [], [[] for _ in range(ploidy)], [])
    cid_offset = pos_offset = 0
    for r in results:
        total.clustering.extend(r.clustering)
        total.threads.extend([cid_offset + cid for cid in thread] for thread in r.threads)
        for hap, extension in zip(total.haplotypes, r.haplotypes):
            hap += extension
        block_start_is_cut = not borders or pos_offset in borders or pos_offset == 0
        if block_start_is_cut:
            total.breakpoints.append(PhaseBreakpoint(pos_offset, list(range(ploidy)), 0.0))
        total.breakpoints.extend(
            PhaseBreakpoint(b.position + pos_offset, b.haplotypes, b.confidence)
            for b in r.breakpoints
        )
        cid_offset = len(total.clustering)
        pos_offset = len(total.haplotypes[0])
    return total


def compute_cut_positions(
    breakpoints: List[PhaseBreakpoint], ploidy: int, block_cut_sensitivity: int
) -> Tuple[List[int], List[List[int]]]:
    """Cut positions for output phase blocks, from breakpoint confidences.
    Sensitivity 0 keeps one block; 5 cuts at every breakpoint event."""
    conf_thresholds = [-float("inf"), -float("inf"), log(0.5), log(0.5), log(0.99), 0]
    count_thresholds = [ploidy, ploidy, min(ploidy, 3), 2, 2, 0]
    threshold = conf_thresholds[block_cut_sensitivity]
    needed = count_thresholds[block_cut_sensitivity]

    cuts: List[int] = []
    hap_cuts: List[List[int]] = [[] for _ in range(ploidy)]
    accumulated = [0.0] * ploidy

    def cut_here(position, on_haplotypes):
        cuts.append(position)
        for h in on_haplotypes:
            hap_cuts[h].append(position)
        accumulated[:] = [0.0] * ploidy

    for b in breakpoints:
        if cuts and cuts[-1] == b.position:
            continue
        if cuts and block_cut_sensitivity == 0:
            break
        if b.confidence == 0.0:
            # hard breakpoint: always cut, on every haplotype
            cut_here(b.position, range(ploidy))
            continue
        for h in b.haplotypes:
            accumulated[h] += log(b.confidence)
        n_uncertain = sum(acc <= threshold for acc in accumulated)
        if n_uncertain >= needed:
            cut_here(b.position, b.haplotypes)
    return cuts, hap_cuts
