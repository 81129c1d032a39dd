#!/usr/bin/env python3
"""
Phase variants in a VCF with the WhatsHap algorithm

Read a VCF and one or more files with phase information (BAM/CRAM or VCF phased
blocks) and phase the variants. The phased VCF is written to standard output.
"""
import logging
import platform
import sys
from argparse import SUPPRESS
from collections import Counter, defaultdict
from contextlib import ExitStack
from dataclasses import dataclass
from pathlib import Path
from typing import (
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
    Set,
    TextIO,
    Tuple,
    Union,
)

import torch

from .. import __version__
from ..core import (
    NumericSampleIds,
    Pedigree,
    PedigreeDPTable,
    PhredGenotypeLikelihoods,
    ReadSet,
)
from ..graph import ComponentFinder
from ..ops import wmec_cuda
from ..ops.wmec import resolve_device
from ..merge import DoNothingReadMerger, ReadMerger
from ..pedigree import (
    GeneticMapRecombinationCostComputer,
    ParseError,
    PedReader,
    RecombinationCostComputer,
    Trio,
    UniformRecombinationCostComputer,
    find_recombination,
    mendelian_conflict,
)
from ..readselect import readselection
from ..timer import StageTimer
from ..types import PhasingAlgorithm
from ..utils import ChromosomeFilter, plural_s, warn_once
from ..vcf import PhasedVcfWriter, VariantTable, VcfError, VcfReader
from . import (
    CommandLineError,
    PhasedInputReader,
    log_memory_usage,
    populate_arg_parser,
    raise_if_any_sample_not_in_vcf,
)

logger = logging.getLogger(__name__)

#: StageTimer of the most recent run_whatshap call: a caller (chip_smoke.py)
#: reads it to print a per-stage wall-clock breakdown beside the end-to-end
#: number.
LAST_TIMERS = None


# ---------------------------------------------------------------------------
# connected components of variants


def find_components(
    phased_positions: Sequence[int],
    reads: ReadSet,
    master_block: Optional[Sequence[int]] = None,
    heterozygous_positions: Optional[Mapping[int, Set[int]]] = None,
) -> Mapping[int, int]:
    """Map each phasable position to its phase block, where two positions
    share a block iff some read covers both (and, when
    ``heterozygous_positions`` is given, both are het in that read's
    sample).  Blocks are named by their leftmost position.  An optional
    ``master_block`` position list is forced into one block."""
    logger.debug("Finding connected components ...")
    assert phased_positions == sorted(phased_positions)
    position_set = set(phased_positions)
    pos_index = {p: i for i, p in enumerate(phased_positions)}

    def usable(read):
        if heterozygous_positions is None:
            return [p for p in read._positions if p in position_set]
        hets = heterozygous_positions[read.sample_id]
        return [p for p in read._positions if p in position_set and p in hets]

    # batch union-find: edge chains per read, one C connected-components
    # pass (components are canonical, so this equals the union-find loop)
    rows: List[int] = []
    cols: List[int] = []
    for read in reads:
        covered = usable(read)
        if len(covered) > 1:
            anchor = pos_index[covered[0]]
            rows.extend([anchor] * (len(covered) - 1))
            cols.extend(pos_index[p] for p in covered[1:])
    if master_block is not None:
        anchor = pos_index[master_block[0]]
        rows.extend([anchor] * (len(master_block) - 1))
        cols.extend(pos_index[p] for p in master_block[1:])
    labels = _connected_component_labels(len(phased_positions), rows, cols)
    # positions ascend, so a label's first occurrence is the block minimum
    rep_of_label: Dict[int, int] = {}
    out: Dict[int, int] = {}
    for i, lab in enumerate(labels):
        rep = rep_of_label.get(lab)
        if rep is None:
            rep = rep_of_label[lab] = phased_positions[i]
        out[phased_positions[i]] = rep
    return out


def _connected_component_labels(
    n: int, rows: Sequence[int], cols: Sequence[int]
) -> List[int]:
    """Component label per node index for an undirected edge list."""
    if n == 0:
        return []
    if not rows:
        return list(range(n))
    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    graph = coo_matrix(
        (np.ones(len(rows), np.int8), (np.asarray(rows), np.asarray(cols))),
        shape=(n, n),
    )
    _, labels = connected_components(graph, directed=False)
    return labels.tolist()


def find_largest_component(components: Mapping[int, int]) -> Sequence[int]:
    """Sorted positions of the biggest phase block."""
    by_block: Dict[int, List[int]] = defaultdict(list)
    for position, block_id in components.items():
        by_block[block_id].append(position)
    if not by_block:
        return []
    biggest = max(by_block.values(), key=len)
    biggest.sort()
    return biggest


def best_case_blocks(reads: ReadSet) -> Tuple[int, int]:
    """(number of components, number of non-singleton components) reachable
    if every covered variant could be phased."""
    positions: Set[int] = set()
    for read in reads:
        positions.update(read._positions)
    pos_index = {p: i for i, p in enumerate(sorted(positions))}
    rows: List[int] = []
    cols: List[int] = []
    for read in reads:
        covered = read._positions
        if len(covered) > 1:
            anchor = pos_index[covered[0]]
            rows.extend([anchor] * (len(covered) - 1))
            cols.extend(pos_index[p] for p in covered[1:])
    labels = _connected_component_labels(len(pos_index), rows, cols)
    sizes: Dict[int, int] = defaultdict(int)
    for lab in labels:
        sizes[lab] += 1
    return len(sizes), sum(1 for size in sizes.values() if size > 1)


# ---------------------------------------------------------------------------
# read selection


def select_reads(
    readset: ReadSet, max_coverage: int, preferred_source_ids: Optional[Set[int]]
) -> ReadSet:
    logger.debug(
        "Reducing coverage to at most %dX by selecting most informative reads ...", max_coverage
    )
    picked = readselection(readset, max_coverage, preferred_source_ids)
    selection = readset.subset(picked)
    logger.info(
        "Selected %d most phase-informative reads covering %d variants",
        len(selection),
        len(selection.get_positions()),
    )
    return selection


class ReadList:
    """Tab-separated dump of the reads that went into phasing."""

    _COLUMNS = (
        "#readname",
        "source_id",
        "sample",
        "phaseset",
        "haplotype",
        "covered_variants",
        "first_variant_pos",
        "last_variant_pos",
    )

    def __init__(self, path: str):
        self._path = path
        self._file = None

    def __enter__(self):
        self._file = open(self._path, "w")
        print(*self._COLUMNS, sep="\t", file=self._file)
        return self

    def __exit__(self, *args):
        self._file.close()
        self._file = None

    def write(
        self,
        readset: ReadSet,
        bipartition: Sequence[int],
        sample_components,
        numeric_sample_ids: NumericSampleIds,
    ) -> None:
        if self._file is None:
            raise ValueError("Needs to be used as context manager (e.g. in a with statement")
        assert len(readset) == len(bipartition)
        name_of = numeric_sample_ids.inverse_mapping()
        for read, haplotype in zip(readset, bipartition):
            sample = name_of[read.sample_id]
            phaseset = sample_components[sample][read[0].position] + 1
            row = (
                read.name,
                read.source_id,
                sample,
                phaseset,
                haplotype,
                len(read),
                read[0].position + 1,
                read[-1].position + 1,
            )
            print(*row, sep="\t", file=self._file)


# ---------------------------------------------------------------------------
# pedigree setup


def setup_pedigree(ped_path: str, samples: Sequence[str]) -> Tuple[Sequence[Trio], Set[str]]:
    """Read a PED file, keeping only trios fully contained in ``samples``."""
    trios: List[Trio] = []
    members: Set[str] = set()
    for trio in PedReader(ped_path):
        if trio.child is None or trio.mother is None or trio.father is None:
            warn_once(
                logger,
                "Relationship %s/%s/%s ignored because at least one of the individuals is unknown.",
                trio.child,
                trio.mother,
                trio.father,
            )
            continue
        if not {trio.mother, trio.father, trio.child}.issubset(samples):
            warn_once(
                logger,
                "Relationship %s/%s/%s ignored because at least one of the "
                "individuals was not among the samples to be phased "
                "(either not in the input VCF or restricted by --sample).",
                trio.child,
                trio.mother,
                trio.father,
            )
            continue
        trios.append(trio)
        members.update((trio.child, trio.father, trio.mother))
    return trios, members


def setup_families(
    samples: Sequence[str], ped_path: Optional[str], max_coverage: int
) -> Tuple[Mapping[str, Sequence[str]], Mapping[str, Sequence[Trio]]]:
    """Group samples into families (connected via trio relations); both
    returned maps are keyed by the family's representative sample."""
    finder = ComponentFinder(samples)
    if ped_path is None:
        all_trios: Sequence[Trio] = []
    else:
        all_trios, _ = setup_pedigree(ped_path, samples)
        for trio in all_trios:
            if trio.father is not None:
                finder.merge(trio.father, trio.child)
            if trio.mother is not None:
                finder.merge(trio.mother, trio.child)

    families: Dict[str, List[str]] = defaultdict(list)
    for sample in samples:
        families[finder.find(sample)].append(sample)
    family_trios: Dict[str, List[Trio]] = defaultdict(list)
    for trio in all_trios:
        family_trios[finder.find(trio.child)].append(trio)

    logger.info(
        "Working on %d sample%s from %d famil%s",
        len(samples),
        plural_s(len(samples)),
        len(families),
        "y" if len(families) == 1 else "ies",
    )
    deepest = max([0] + [len(trios) for trios in family_trios.values()])
    if max_coverage + 2 * deepest > 23:
        logger.warning(
            "The maximum coverage is too high! "
            "WhatsHap may take a long time to finish and require a huge amount of memory."
        )
    return families, family_trios


def vcf_samples(variant_file: str) -> List[str]:
    """The samples of a VCF's header, or none where it cannot be read (the
    run then reports that when it opens the file)."""
    try:
        with VcfReader(variant_file) as reader:
            return list(reader.samples)
    except (OSError, ValueError, VcfError):
        return []


def refuse_families_past_envelope(samples: Sequence[str], ped_path: str, device: torch.device) -> None:
    """On a CUDA device, raise NotImplementedError for a family of the PED
    file whose pedigree the card's kernels cannot take, before the caller
    opens any output: its T = 4^trios and P = 2 * (members - trios), as
    pack_problem counts them for the families of setup_families, past
    wmec_cuda.WIDE_T and WIDE_P (six or more trios, or six or more
    founders: ROADMAP Queue 1 item 5).  The solvers would raise the same
    once the family's turn came, after the output had been opened."""
    if device.type != "cuda":
        return
    trios, _members = setup_pedigree(ped_path, samples)
    finder = ComponentFinder(samples)
    for trio in trios:
        finder.merge(trio.father, trio.child)
        finder.merge(trio.mother, trio.child)
    members = Counter(finder.find(sample) for sample in samples)
    for representative, n_trios in Counter(finder.find(trio.child) for trio in trios).items():
        T, P = 4**n_trios, 2 * (members[representative] - n_trios)
        if not wmec_cuda.kernel_supported(1, T, P):
            raise NotImplementedError(
                f"the family of {representative} has {n_trios} trios and "
                f"{members[representative] - n_trios} founders (T = {T}, P = {P}): pedigrees past "
                f"the CUDA kernels' envelope (T in {wmec_cuda.WIDE_T}, P in {wmec_cuda.WIDE_P}) "
                "need kernels with a wider envelope, ROADMAP Queue 1 item 5"
            )


def make_recombination_cost_computer(
    ped: Optional[str], genmap: Optional[str], recombrate: float
) -> RecombinationCostComputer:
    if ped and genmap:
        logger.info("Using region-specific recombination rates from genetic map %s.", genmap)
        try:
            return GeneticMapRecombinationCostComputer(genmap)
        except ParseError as e:
            raise CommandLineError(e)
    if ped:
        logger.info("Using uniform recombination rate of %g cM/Mb.", recombrate)
    return UniformRecombinationCostComputer(recombrate)


def find_mendelian_conflicts(trios: Sequence[Trio], variant_table: VariantTable) -> Set[int]:
    conflicts: Set[int] = set()
    for trio in trios:
        if trio.mother is None or trio.father is None:
            continue
        columns = zip(
            variant_table.genotypes_of(trio.mother),
            variant_table.genotypes_of(trio.father),
            variant_table.genotypes_of(trio.child),
        )
        for index, (gt_mother, gt_father, gt_child) in enumerate(columns):
            if gt_mother.is_none() or gt_father.is_none() or gt_child.is_none():
                continue
            if mendelian_conflict(gt_mother, gt_father, gt_child):
                conflicts.add(index)
    return conflicts


def find_phaseable_variants(
    family: Sequence[str],
    include_homozygous: bool,
    trios: Sequence[Trio],
    variant_table: VariantTable,
) -> Tuple[Sequence[int], VariantTable]:
    """Classify variant rows and return (positions homozygous in some
    family member among retained rows, table restricted to phasable rows)."""
    missing: Set[int] = set()
    heterozygous: Set[int] = set()
    homozygous: Set[int] = set()
    for sample in family:
        for index, gt in enumerate(variant_table.genotypes_of(sample)):
            if gt.is_none():
                missing.add(index)
            elif gt.is_homozygous():
                assert gt.is_diploid_and_biallelic()
                homozygous.add(index)
            else:
                heterozygous.add(index)

    conflicts = find_mendelian_conflicts(trios, variant_table)
    all_rows = set(range(len(variant_table)))
    retained = (all_rows if include_homozygous else heterozygous) - missing - conflicts

    # Positions of retained variants homozygous in >= 1 individual feed the
    # genetic-haplotyping master block.
    homozygous_positions = [
        variant_table.variants[i].position for i in retained & homozygous
    ]
    phasable = variant_table.copy_with_rows(sorted(retained))

    if len(family) == 1:
        logger.info(
            "Found %d usable%s variants (%d skipped due to missing genotypes)",
            len(phasable),
            "" if include_homozygous else " heterozygous",
            len(missing),
        )
    else:
        logger.info(
            "Found %d usable variants (%d skipped due to Mendelian conflicts)",
            len(phasable),
            len(conflicts),
        )
    return homozygous_positions, phasable


def create_pedigree(
    default_gq,
    distrust_genotypes,
    family,
    gl_regularizer,
    numeric_sample_ids,
    phasable_variant_table,
    trios,
) -> Pedigree:
    pedigree = Pedigree(numeric_sample_ids)
    for sample in family:
        genotypes = phasable_variant_table.genotypes_of(sample)
        if not distrust_genotypes:
            likelihoods = None
        else:
            likelihoods = []
            raw = phasable_variant_table.genotype_likelihoods_of(sample)
            for gt, gl in zip(genotypes, raw):
                assert gt.is_diploid_and_biallelic()
                if gl is None:
                    # flat default_gq everywhere except the called genotype
                    phred = [default_gq] * 3
                    phred[gt.get_index()] = 0
                    likelihoods.append(PhredGenotypeLikelihoods(phred))
                else:
                    likelihoods.append(gl.as_phred(regularizer=gl_regularizer))
        pedigree.add_individual(sample, genotypes, likelihoods)
    for trio in trios:
        pedigree.add_relationship(
            father_id=trio.father, mother_id=trio.mother, child_id=trio.child
        )
    return pedigree


# ---------------------------------------------------------------------------
# report files


def write_changed_genotypes(gtchange_list_filename, changed_genotypes) -> None:
    with open(gtchange_list_filename, "w") as f:
        print(
            "#sample", "chromosome", "position", "REF", "ALT", "old_gt", "new_gt", sep="\t", file=f
        )
        for change in changed_genotypes:
            row = (
                change.sample,
                change.chromosome,
                change.variant.position,
                change.variant.reference_allele,
                change.variant.alternative_allele,
                repr(change.old_gt),
                repr(change.new_gt),
            )
            print(*row, sep="\t", file=f)


def write_recombination_list(
    path: Union[str, Path],
    chromosome: str,
    accessible_positions: Sequence[int],
    overall_components: Mapping[int, int],
    recombination_costs: Sequence[int],
    transmission_vector: Sequence[int],
    trios: Sequence[Trio],
) -> int:
    """Write putative recombination events; returns how many."""
    # decompose the packed transmission value: 2 bits per trio, child order
    per_child: Dict[str, List[int]] = defaultdict(list)
    for value in transmission_vector:
        for trio in trios:
            per_child[trio.child].append(value % 4)
            value //= 4
    header = (
        "#child_id",
        "chromosome",
        "position1",
        "position2",
        "transmitted_hap_father1",
        "transmitted_hap_father2",
        "transmitted_hap_mother1",
        "transmitted_hap_mother2",
        "recombination_cost",
    )
    count = 0
    with open(path, "w") as f:
        print(*header, file=f)
        for trio in trios:
            events = find_recombination(
                per_child[trio.child],
                overall_components,
                accessible_positions,
                recombination_costs,
            )
            for e in events:
                print(
                    trio.child,
                    chromosome,
                    e.position1 + 1,
                    e.position2 + 1,
                    e.transmitted_hap_father1,
                    e.transmitted_hap_father2,
                    e.transmitted_hap_mother1,
                    e.transmitted_hap_mother2,
                    e.recombination_cost,
                    file=f,
                )
            count += len(events)
    return count


# ---------------------------------------------------------------------------
# the pipeline


@dataclass
class _Config:
    """Everything run_whatshap was called with, minus the I/O resources."""

    max_coverage: int
    row_limit: int
    distrust_genotypes: bool
    include_homozygous: bool
    genetic_haplotyping: bool
    algorithm: str
    default_gq: int
    gl_regularizer: Optional[float]
    recombination_list_filename: Optional[str]
    gtchange_list_filename: Optional[str]
    device: torch.device


class _PhasingPipeline:
    """Per-run state and the chromosome/family/sample loops."""

    def __init__(
        self,
        config: _Config,
        phased_input_reader: PhasedInputReader,
        vcf_writer: PhasedVcfWriter,
        recombination_cost_computer: RecombinationCostComputer,
        read_merger,
        families,
        family_trios,
        numeric_sample_ids: NumericSampleIds,
        read_list: Optional[ReadList],
        timers: StageTimer,
    ):
        self.config = config
        self.phased_input_reader = phased_input_reader
        self.vcf_writer = vcf_writer
        self.recombination_cost_computer = recombination_cost_computer
        self.read_merger = read_merger
        self.families = families
        self.family_trios = family_trios
        self.numeric_sample_ids = numeric_sample_ids
        self.read_list = read_list
        self.timers = timers

    # -- per-sample input

    def _load_sample_reads(self, chromosome, variants, sample, max_cov, distrust):
        cfg = self.config
        with self.timers("read_bam"):
            readset, vcf_source_ids = self.phased_input_reader.read(
                chromosome, variants, sample
            )
        with self.timers("select"):
            readset = readset.subset([i for i, read in enumerate(readset) if len(read) >= 2])
            logger.info("Kept %d reads that cover at least two variants each", len(readset))
            merged = self.read_merger.merge(readset)
            if cfg.algorithm == "heuristic":
                selection = merged
            else:
                selection = select_reads(merged, max_cov, preferred_source_ids=vcf_source_ids)
        return readset, selection

    # -- solver dispatch

    def _solve(
        self, all_reads, recombination_costs, pedigree, accessible_positions
    ) -> PhasingAlgorithm:
        cfg = self.config
        solver: PhasingAlgorithm
        if cfg.algorithm == "hapchat":
            from ..solver.hapchat import HapChatCore

            solver = HapChatCore(all_reads)
        elif cfg.algorithm == "heuristic":
            from ..solver.heuristic import PedMecHeuristic

            all_reads.sort()
            solver = PedMecHeuristic(
                all_reads,
                recombination_costs,
                pedigree,
                cfg.row_limit,
                distrust_genotypes=cfg.distrust_genotypes,
                positions=accessible_positions,
                allow_mutations=True,
                verbosity=0,
            )
        else:
            # exact wMEC/PedMEC: the column DP in the CUDA kernels of
            # ops.wmec_cuda on a CUDA device, the plain torch mirror on the CPU
            solver = PedigreeDPTable(
                all_reads,
                recombination_costs,
                pedigree,
                cfg.distrust_genotypes,
                accessible_positions,
                device=cfg.device,
            )
        return solver

    # -- per-family phasing

    def _phase_family(self, chromosome, variant_table, representative, family):
        cfg = self.config
        logger.info("")
        if len(family) == 1:
            logger.info("# Working on contig %s in individual %s", chromosome, representative)
        else:
            logger.info(
                "# Working on contig %s in family individuals %s", chromosome, ",".join(family)
            )
        max_cov_per_sample = max(1, cfg.max_coverage // len(family))
        logger.debug("Using maximum coverage per sample of %dX", max_cov_per_sample)
        trios = self.family_trios[representative]
        assert len(family) == 1 or len(trios) > 0

        homozygous_positions, phasable_table = find_phaseable_variants(
            family, cfg.include_homozygous, trios, variant_table
        )

        readsets = {}
        for sample in family:
            raw_readset, selection = self._load_sample_reads(
                chromosome, phasable_table.variants, sample, max_cov_per_sample,
                cfg.distrust_genotypes,
            )
            readsets[sample] = selection
            if len(family) == 1 and not cfg.distrust_genotypes:
                self._log_best_case(raw_readset, selection)

        all_reads = ReadSet()
        for readset in readsets.values():
            for read in readset:
                assert read.is_sorted(), "Add a read.sort() here"
                all_reads.add(read)
        all_reads.sort()

        accessible_positions = sorted(all_reads.get_positions())
        logger.debug(
            "Variants covered by at least one phase-informative "
            "read in at least one individual after read selection: %d",
            len(accessible_positions),
        )
        if len(family) > 1 and cfg.genetic_haplotyping:
            accessible_positions = sorted(set(accessible_positions) | set(homozygous_positions))
            logger.info(
                "Variants either covered by phase-informative read or homozygous "
                "in at least one individual: %d",
                len(accessible_positions),
            )
        phasable_table.subset_rows_by_position(accessible_positions)
        assert len(phasable_table.variants) == len(accessible_positions)

        pedigree = create_pedigree(
            cfg.default_gq,
            cfg.distrust_genotypes,
            family,
            cfg.gl_regularizer,
            self.numeric_sample_ids,
            phasable_table,
            trios,
        )
        recombination_costs = self.recombination_cost_computer.compute(accessible_positions)

        with self.timers("phase"):
            problem_name = "MEC" if len(family) == 1 else "PedMEC"
            logger.info(
                "Phasing %d sample%s by solving the %s problem ...",
                len(family),
                plural_s(len(family)),
                problem_name,
            )
            solver = self._solve(all_reads, recombination_costs, pedigree, accessible_positions)
            superreads_list, transmission_vector = solver.get_super_reads()
            logger.debug("%s cost: %d", problem_name, solver.get_optimal_cost())

        with self.timers("components"):
            overall_components = self._components_for_family(
                accessible_positions,
                all_reads,
                family,
                homozygous_positions,
                superreads_list,
            )
            self._log_component_stats(overall_components, len(accessible_positions))

        if cfg.recombination_list_filename:
            assert transmission_vector is not None
            n_events = write_recombination_list(
                cfg.recombination_list_filename,
                chromosome,
                accessible_positions,
                overall_components,
                recombination_costs,
                transmission_vector,
                trios,
            )
            logger.info("Total no. of detected recombination events: %d", n_events)

        return family, superreads_list, overall_components, all_reads, solver

    def _components_for_family(
        self, accessible_positions, all_reads, family, homozygous_positions, superreads_list
    ):
        cfg = self.config
        accessible = set(accessible_positions)
        master_block = None
        het_by_sample: Optional[Dict[int, Set[int]]] = None
        if cfg.distrust_genotypes:
            # genotypes may have been changed by the solver: classify from
            # the superreads, not the input table
            hom_in_any = set()
            het_by_sample = {}
            hets = frozenset({(0, 1), (1, 0)})
            homs = frozenset({(0, 0), (1, 1)})
            for sample, superreads in zip(family, superreads_list):
                sample_hets = set()
                for v0, v1 in zip(*superreads):
                    assert v0.position == v1.position
                    if v0.position not in accessible:
                        continue
                    pair = (v0.allele, v1.allele)
                    if pair in hets:
                        sample_hets.add(v0.position)
                    elif pair in homs:
                        hom_in_any.add(v0.position)
                het_by_sample[self.numeric_sample_ids[sample]] = sample_hets
            if len(family) > 1 and cfg.genetic_haplotyping:
                master_block = sorted(hom_in_any)
        elif len(family) > 1 and cfg.genetic_haplotyping:
            master_block = sorted(set(homozygous_positions) & accessible)
        return find_components(accessible_positions, all_reads, master_block, het_by_sample)

    @staticmethod
    def _log_component_stats(components, n_accessible) -> None:
        n_blocks = len(set(components.values()))
        largest = find_largest_component(components)
        if largest:
            logger.info(
                "%s",
                f"Largest block contains {len(largest)} variants"
                f" ({len(largest) / n_accessible:.1%} of accessible variants)"
                f" between position {largest[0] + 1} and {largest[-1] + 1}",
            )
        else:
            logger.info(f"No. of phased blocks: {n_blocks}")

    @staticmethod
    def _log_best_case(readset, selection) -> None:
        n_all, n_nonsingleton_all = best_case_blocks(readset)
        n_cov, n_nonsingleton_cov = best_case_blocks(selection)
        logger.info(
            "Best-case phasing would result in %d non-singleton phased block%s (%d singletons). ",
            n_nonsingleton_cov,
            plural_s(n_nonsingleton_cov),
            n_cov - n_nonsingleton_cov,
        )
        logger.debug(
            "... would be %d non-singleton phased blocks without read selection",
            n_nonsingleton_all,
        )

    # -- per-chromosome driver

    def process_chromosome(self, variant_table) -> None:
        cfg = self.config
        chromosome = variant_table.chromosome
        superreads: Dict[str, ReadSet] = {}
        components: Dict = {}

        for representative, family in sorted(self.families.items()):
            (family_, superreads_list, overall_components, all_reads, solver) = (
                self._phase_family(chromosome, variant_table, representative, family)
            )
            # superreads arrive in pedigree (family) order
            for sample, sample_superreads in zip(family_, superreads_list):
                superreads[sample] = sample_superreads
                assert len(sample_superreads) == 2
                assert (
                    sample_superreads[0].sample_id
                    == sample_superreads[1].sample_id
                    == self.numeric_sample_ids[sample]
                )
                components[sample] = overall_components  # same for all samples

            if self.read_list:
                self.read_list.write(
                    all_reads,
                    solver.get_optimal_partitioning(),
                    components,
                    self.numeric_sample_ids,
                )

        with self.timers("write_vcf"):
            logger.debug("Writing phasing result to output VCF")
            changed_genotypes = self.vcf_writer.write(
                chromosome, superreads, components,
                records=variant_table.raw_records,
            )
            if changed_genotypes:
                assert cfg.distrust_genotypes
                logger.info("Changed %d genotypes while writing VCF", len(changed_genotypes))
        if cfg.gtchange_list_filename:
            logger.info("Writing list of changed genotypes to %r", cfg.gtchange_list_filename)
            write_changed_genotypes(cfg.gtchange_list_filename, changed_genotypes)

        logger.debug("Chromosome %r finished", chromosome)

    def skip_chromosome(self, chromosome, records=None) -> None:
        logger.info(
            "Leaving chromosome %r unchanged (present in VCF but not requested by --chromosome)",
            chromosome,
        )
        with self.timers("write_vcf"):
            self.vcf_writer.write(chromosome, {}, {}, records=records)


def _log_time_and_memory_usage(timers: StageTimer, show_phase_vcfs: bool) -> None:
    total_time = timers.total()
    logger.info("\n# Resource usage")
    log_memory_usage()
    # fmt: off
    logger.info("Time spent reading BAM/CRAM:                 %6.1f s", timers.elapsed("read_bam"))
    logger.info("Time spent parsing VCF:                      %6.1f s", timers.elapsed("parse_vcf"))
    if show_phase_vcfs:
        logger.info("Time spent parsing input phasings from VCFs: %6.1f s", timers.elapsed("parse_phasing_vcfs"))
    logger.info("Time spent selecting reads:                  %6.1f s", timers.elapsed("select"))
    logger.info("Time spent phasing:                          %6.1f s", timers.elapsed("phase"))
    logger.info("Time spent writing VCF:                      %6.1f s", timers.elapsed("write_vcf"))
    logger.info("Time spent finding components:               %6.1f s", timers.elapsed("components"))
    logger.info("Time spent on rest:                          %6.1f s", total_time - timers.sum())
    logger.info("Total elapsed time:                          %6.1f s", total_time)
    # fmt: on


def run_whatshap(
    phase_input_files: Sequence[str],
    variant_file: str,
    reference: Union[None, bool, str] = False,
    output: TextIO = sys.stdout,
    samples: Optional[Sequence[str]] = None,
    chromosomes: Optional[List[str]] = None,
    excluded_chromosomes: Optional[List[str]] = None,
    ignore_read_groups: bool = False,
    only_snvs: bool = False,
    mapping_quality: int = 20,
    read_merging: bool = False,
    read_merging_error_rate: float = 0.15,
    read_merging_max_error_rate: float = 0.25,
    read_merging_positive_threshold: int = 1000000,
    read_merging_negative_threshold: int = 1000,
    max_coverage: int = 15,
    row_limit: int = 256,
    distrust_genotypes: bool = False,
    include_homozygous: bool = False,
    ped: Optional[str] = None,
    recombrate: float = 1.26,
    genmap: Optional[str] = None,
    genetic_haplotyping: bool = True,
    recombination_list_filename: Optional[str] = None,
    tag: str = "PS",
    read_list_filename: Optional[str] = None,
    gl_regularizer: Optional[float] = None,
    gtchange_list_filename: Optional[str] = None,
    default_gq: int = 30,
    write_command_line_header: bool = True,
    use_ped_samples: bool = False,
    use_supplementary: bool = False,
    supplementary_distance_threshold: int = 100_000,
    algorithm: str = "whatshap",
    device="cuda",
) -> None:
    """Run the whole phasing pipeline.  Parameter semantics match the
    reference's run_whatshap (whatshap/cli/phase.py:289).  `algorithm`
    picks the solver: "whatshap" the exact wMEC/PedMEC DP, which runs on
    `device`, a CUDA device unless the caller passes "cpu"; "hapchat"
    (HapChatCore, single samples only) and "heuristic" (PedMecHeuristic,
    which takes every merged read and skips read selection) run on the host,
    in csrc/host/hapchatlib.cpp and heurlib.cpp.  The device is resolved
    first for every algorithm (ops.wmec.resolve_device raises before any
    output is opened when no CUDA device is available; so does a PED family
    past the card's kernels under "whatshap",
    refuse_families_past_envelope)."""
    if algorithm == "hapchat" and ped is not None:
        raise CommandLineError("The hapchat algorithm cannot do pedigree phasing")
    device = resolve_device(device)
    if ped is not None and algorithm == "whatshap":
        refuse_families_past_envelope(
            PedReader(ped).samples() if use_ped_samples else samples or vcf_samples(variant_file),
            ped,
            device,
        )

    global LAST_TIMERS
    timers = LAST_TIMERS = StageTimer()
    logger.info(
        f"This is whatshap-torch {__version__} running under Python {platform.python_version()}"
    )
    numeric_sample_ids = NumericSampleIds()
    command_line = (
        "(whatshap {}) {}".format(__version__, " ".join(sys.argv[1:]))
        if write_command_line_header
        else None
    )
    read_merger = (
        ReadMerger(
            read_merging_error_rate,
            read_merging_max_error_rate,
            read_merging_positive_threshold,
            read_merging_negative_threshold,
        )
        if read_merging
        else DoNothingReadMerger()
    )

    with ExitStack() as stack:
        logger.debug("Creating PhasedInputReader")
        phased_input_reader = stack.enter_context(
            PhasedInputReader(
                phase_input_files,
                None if reference is False else reference,
                numeric_sample_ids,
                ignore_read_groups,
                mapq_threshold=mapping_quality,
                only_snvs=only_snvs,
                use_supplementary=use_supplementary,
                supplementary_distance_threshold=supplementary_distance_threshold,
            )
        )
        show_phase_vcfs = phased_input_reader.has_vcfs
        if phased_input_reader.has_alignments and reference is None:
            raise CommandLineError(
                "A reference FASTA needs to be provided with -r/--reference; "
                "or use --no-reference at the expense of phasing quality."
            )

        logger.debug("Creating PhasedVcfWriter")
        try:
            vcf_writer = stack.enter_context(
                PhasedVcfWriter(
                    command_line=command_line,
                    in_path=variant_file,
                    out_file=output,
                    tag=tag,
                    only_snvs=only_snvs,
                )
            )
        except (OSError, VcfError) as e:
            raise CommandLineError(e)

        # genotype likelihoods are only needed when they may be overridden
        vcf_reader = stack.enter_context(
            VcfReader(
                variant_file,
                only_snvs=only_snvs,
                genotype_likelihoods=distrust_genotypes,
                remember_records=True,
            )
        )

        if ignore_read_groups and not samples and len(vcf_reader.samples) > 1:
            raise CommandLineError(
                "When using --ignore-read-groups on a VCF with "
                "multiple samples, --sample must also be used."
            )
        if not samples:
            samples = vcf_reader.samples
        if ped is not None and use_ped_samples:
            samples = PedReader(ped).samples()
        raise_if_any_sample_not_in_vcf(vcf_reader, samples)

        recombination_cost_computer = make_recombination_cost_computer(ped, genmap, recombrate)
        families, family_trios = setup_families(samples, ped, max_coverage)
        del samples
        for trios in family_trios.values():
            for trio in trios:
                if trio.child is not None:
                    numeric_sample_ids[trio.child]  # assign ids in child order

        read_list = (
            stack.enter_context(ReadList(read_list_filename)) if read_list_filename else None
        )

        with timers("parse_phasing_vcfs"):
            phased_input_reader.read_vcfs()

        pipeline = _PhasingPipeline(
            _Config(
                max_coverage=max_coverage,
                row_limit=row_limit,
                distrust_genotypes=distrust_genotypes,
                include_homozygous=include_homozygous,
                genetic_haplotyping=genetic_haplotyping,
                algorithm=algorithm,
                default_gq=default_gq,
                gl_regularizer=gl_regularizer,
                recombination_list_filename=recombination_list_filename,
                gtchange_list_filename=gtchange_list_filename,
                device=device,
            ),
            phased_input_reader,
            vcf_writer,
            recombination_cost_computer,
            read_merger,
            families,
            family_trios,
            numeric_sample_ids,
            read_list,
            timers,
        )

        wanted = ChromosomeFilter(chromosomes, excluded_chromosomes)
        for variant_table in timers.iterate("parse_vcf", vcf_reader):
            if variant_table.chromosome in wanted:
                pipeline.process_chromosome(variant_table)
            else:
                pipeline.skip_chromosome(
                    variant_table.chromosome, records=variant_table.raw_records
                )

    _log_time_and_memory_usage(timers, show_phase_vcfs=show_phase_vcfs)


# ---------------------------------------------------------------------------
# argument parsing


PHASE_ARGUMENTS = [
    (None, [
        ("variant_file", dict(metavar="VCF",
            help="VCF or BCF file with variants to be phased (can be gzip-compressed)")),
        ("phase_input_files", dict(nargs="*", metavar="PHASEINPUT",
            help="BAM, CRAM, VCF or BCF file(s) with phase information, either through sequencing reads (BAM, CRAM) or through phased blocks (VCF, BCF)")),
        (("-o", "--output"), dict(default=sys.stdout,
            help="Output VCF file. Add .gz to the file name to get compressed output. If omitted, use standard output.")),
        (("--reference", "-r"), dict(metavar="FASTA",
            help="Reference file. Must be accompanied by .fai index (create with samtools faidx)")),
        ("--no-reference", dict(action="store_true", default=False,
            help="Detect alleles without requiring a reference, at the expense of phasing quality (in particular for long reads)")),
        ("--tag", dict(choices=("PS", "HP"), default="PS",
            help="Store phasing information with PS tag (standardized) or HP tag (used by GATK ReadBackedPhasing) (default: %(default)s)")),
        ("--output-read-list", dict(metavar="FILE", default=None, dest="read_list_filename",
            help="Write reads that have been used for phasing to FILE.")),
        ("--algorithm", dict(choices=("whatshap", "hapchat", "heuristic"), default="whatshap",
            help="Phasing algorithm to use (default: %(default)s)")),
    ]),
    (("Input pre-processing, selection and filtering", None), [
        ("--merge-reads", dict(dest="read_merging", default=False, action="store_true",
            help="Merge reads which are likely to come from the same haplotype (default: do not merge reads)")),
        (("--max-coverage", "-H"), dict(metavar="MAXCOV", type=int,
            dest="max_coverage_was_used", help=SUPPRESS)),
        (("--row-limit", "-L"), dict(metavar="ROWLIMIT", type=int, default=None, dest="row_limit",
            help="For the heuristic: Maximum number of memorized intermediate solutions. Larger values increase runtime and memory consumption, but can improve phasing quality. (default: %(default)s)")),
        ("--internal-downsampling", dict(metavar="COVERAGE", dest="max_coverage", default=15, type=int,
            help="Coverage reduction parameter in the internal core phasing algorithm. Higher values increase runtime *exponentially* while possibly improving phasing quality marginally. Avoid using this in the normal case! (default: %(default)s)")),
        (("--mapping-quality", "--mapq"), dict(metavar="QUAL", default=20, type=int,
            help="Minimum mapping quality (default: %(default)s)")),
        ("--indels", dict(dest="indels_used", action="store_true", help=SUPPRESS)),
        ("--only-snvs", dict(default=False, action="store_true", help="Phase only SNVs")),
        ("--ignore-read-groups", dict(default=False, action="store_true",
            help="Ignore read groups in BAM/CRAM header and assume all reads come from the same sample.")),
        ("--sample", dict(dest="samples", metavar="SAMPLE", default=[], action="append",
            help="Name of a sample to phase. If not given, all samples in the input VCF are phased. Can be used multiple times.")),
        ("--chromosome", dict(dest="chromosomes", metavar="CHROMOSOME", default=[], action="append",
            help="Name of chromosome to phase. If not given, all chromosomes in the input VCF are phased. Can be used multiple times.")),
        ("--exclude-chromosome", dict(dest="excluded_chromosomes", default=[], action="append",
            help="Name of chromosome not to phase.")),
    ]),
    (("Read merging", "The options in this section are only active when --merge-reads is used"), [
        ("--error-rate", dict(dest="read_merging_error_rate", type=float, default=0.15,
            help="The probability that a nucleotide is wrong in read merging model (default: %(default)s).")),
        ("--maximum-error-rate", dict(dest="read_merging_max_error_rate", type=float, default=0.25,
            help="The maximum error rate of any edge of the read merging graph before discarding it (default: %(default)s).")),
        ("--threshold", dict(dest="read_merging_positive_threshold", type=int, default=1000000,
            help="The threshold of the ratio between the probabilities that a pair of reads come from the same haplotype and different haplotypes in the read merging model (default: %(default)s).")),
        ("--negative-threshold", dict(dest="read_merging_negative_threshold", type=int, default=1000,
            help="The threshold of the ratio between the probabilities that a pair of reads come from different haplotypes and the same haplotype in the read merging model (default: %(default)s).")),
    ]),
    (("Genotyping", "These options are only used when --distrust-genotypes is used"), [
        ("--full-genotyping", dict(action="store_true", default=False, help=SUPPRESS)),
        ("--distrust-genotypes", dict(dest="distrust_genotypes", action="store_true", default=False,
            help="Allow switching variants from hetero- to homozygous in an optimal solution (see documentation).")),
        ("--include-homozygous", dict(dest="include_homozygous", action="store_true", default=False,
            help="Also work on homozygous variants, which might be turned to heterozygous")),
        ("--default-gq", dict(type=int, default=30,
            help="Default genotype quality used as cost of changing a genotype when no genotype likelihoods are available (default %(default)s)")),
        ("--gl-regularizer", dict(type=float, default=None,
            help="Constant (float) to be used to regularize genotype likelihoods read from input VCF (default %(default)s).")),
        ("--changed-genotype-list", dict(metavar="FILE", dest="gtchange_list_filename", default=None,
            help="Write list of changed genotypes to FILE.")),
    ]),
    (("Pedigree phasing", None), [
        ("--ped", dict(metavar="PED/FAM",
            help="Use pedigree information in PED file to improve phasing (switches to PedMEC algorithm). Columns 2, 3, 4 must refer to child, father, and mother sample names as used in the VCF and BAM/CRAM. Other columns are ignored.")),
        ("--recombination-list", dict(metavar="FILE", dest="recombination_list_filename", default=None,
            help="Write putative recombination events to FILE.")),
        ("--recombrate", dict(metavar="RECOMBRATE", type=float, default=1.26,
            help="Recombination rate in cM/Mb (used with --ped). If given, a constant recombination rate is assumed (default: %(default)gcM/Mb).")),
        ("--genmap", dict(metavar="FILE",
            help="File with genetic map (used with --ped) to be used instead of constant recombination rate, i.e. overrides option --recombrate.")),
        ("--no-genetic-haplotyping", dict(dest="genetic_haplotyping", action="store_false", default=True,
            help="Do not merge blocks that are not connected by reads (i.e. solely based on genotype status). Default: when in --ped mode, merge all blocks that contain at least one homozygous genotype in at least one individual into one block.")),
        ("--use-ped-samples", dict(dest="use_ped_samples", action="store_true", default=False,
            help="Only work on samples mentioned in the provided PED file.")),
        ("--use-supplementary", dict(dest="use_supplementary", action="store_true", default=False,
            help="Use also supplementary alignments (default: ignore supplementary_ alignments)")),
        ("--supplementary-distance", dict(metavar="DIST", type=int, dest="supplementary_distance_threshold", default=100_000,
            help="Skip supplementary alignments further than DIST bp away from the primary alignment (default: %(default)s)")),
    ]),
]


def add_arguments(parser):
    populate_arg_parser(parser, PHASE_ARGUMENTS)


def validate(args, parser):
    if args.reference is not None and args.no_reference:
        parser.error("Options --reference and --no-reference cannot be used together")
    if args.ignore_read_groups and args.ped:
        parser.error("Option --ignore-read-groups cannot be used together with --ped")
    if args.genmap and not args.ped:
        parser.error("Option --genmap can only be used together with --ped")
    if args.genmap and (len(args.chromosomes) != 1):
        parser.error(
            "Option --genmap can only be used when working on exactly one "
            "chromosome (use --chromosome)"
        )
    if args.include_homozygous and not args.distrust_genotypes:
        parser.error("Option --include-homozygous can only be used with --distrust-genotypes.")
    if args.use_ped_samples and not args.ped:
        parser.error("Option --use-ped-samples can only be used when PED file is provided (--ped).")
    if args.use_ped_samples and args.samples:
        parser.error("Option --use-ped-samples cannot be used together with --samples")
    if len(args.phase_input_files) == 0 and not args.ped:
        parser.error("Not providing any PHASEINPUT files only allowed in --ped mode.")
    if args.max_coverage > 23:
        parser.error("Coverage downsampling parameter must not exceed 23.")
    if args.max_coverage_was_used is not None:
        logger.warning(
            "The --max-coverage and -H options are no longer supported. "
            "The coverage reduction parameter in the internal core phasing algorithm can now "
            "be adjusted with --internal-downsampling. Higher values increase runtime "
            "*exponentially* while possibly improving phasing quality marginally. "
            "Avoid using this in the normal case!"
        )
    if args.row_limit is None:
        args.row_limit = 256
    elif args.algorithm != "heuristic":
        logger.warning("Ignoring --row-limit as heuristic is not used as algorithm.")
    elif args.row_limit > 65535:
        parser.error("Row limit parameter must not exceed 65535.")
    if args.full_genotyping:
        parser.error(
            "The experimental --full-genotyping option has been removed. Instead, please run "
            "'whatshap genotype' prior to running 'whatshap phase'"
        )
    if args.indels_used:
        logger.warning("Ignoring --indels as indel phasing is default in WhatsHap 2.0+")


def main(args):
    if args.no_reference:
        args.reference = False
    del args.no_reference
    del args.max_coverage_was_used
    del args.full_genotyping
    del args.indels_used
    run_whatshap(**vars(args))
