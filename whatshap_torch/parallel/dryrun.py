"""
Entry points for a compile check and a dry run over several devices, the
port's counterpart of the reference's __graft_entry__.py.

- entry(device) -> (fn, example_args): the batched forward step of the main
  compute path (wmec.forward_cost_batched, the column DP from the initial
  state) with a stacked batch of 8 single-sample blocks.
- dryrun_multichip(n_devices, device): splits batches of phase blocks over
  n devices and runs, for a single-sample batch and a trio batch (T = 4),
  the costs-only forward (run_blocks_sharded) and the full solve
  (solve_blocks_sharded), held bit for bit against per-block serial solves;
  then the phase CLI on a synthetic chromosome with every batched launch
  sharded, byte-identical to the same run on one device.

Without n cards the dry run repeats one device n times (cuda:0 x n on a
host with one card, cpu x n on a host with none): the shards then run one
after another on that device, through the same split, copies and gather.
"""

import sys
import tempfile
from pathlib import Path

import torch

from ..ops import wmec
from . import mesh as mesh_mod
from . import workloads
from .blocks import to_device


def entry(device=None):
    """(fn, example_args) for the batched forward step on `device` (CUDA
    unless the caller names another)."""
    dev = wmec.resolve_device(device)
    K, T, P, _packed, arrays = workloads.build_single_sample_batch(8, n_cols=32, coverage=6)
    example_args = to_device(arrays, dev)

    def fn(wdiff, wbase, rankw, acost, die_prev, rc):
        return wmec.forward_cost_batched(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc)

    return fn, example_args


def dryrun_devices(n_devices: int, device=None):
    """The first n cards where that many exist, else `device` (CUDA unless
    the caller names another) n times."""
    dev = wmec.resolve_device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() >= n_devices:
            return [torch.device("cuda", i) for i in range(n_devices)]
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return [dev] * n_devices


def _check_sharded(mesh, K, T, P, packed_list, arrays):
    """The sharded full solve against per-block serial solves, and the
    sharded costs-only forward against the solve's costs."""
    costs, index_paths, trans_paths = mesh_mod.solve_blocks_sharded(mesh, K, T, P, arrays)
    assert costs.shape == (len(packed_list),)
    workloads.assert_batched_matches_serial(packed_list, costs, index_paths, trans_paths)
    dp_last, _jmin, _key = mesh_mod.run_blocks_sharded(mesh, K, T, P, arrays)
    assert (mesh_mod.optimal_costs_from_batched(dp_last) == costs).all(), "forward costs differ from the solve's"


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the sharded phasing step over n devices (dryrun_devices) on small
    shapes and check it against serial per-block solves, then the CLI."""
    mesh = mesh_mod.make_block_mesh(dryrun_devices(n_devices, device))

    # single-sample batch, two blocks a device
    K, T, P, packed_list, arrays = workloads.build_single_sample_batch(
        2 * n_devices, n_cols=16, coverage=4
    )
    _check_sharded(mesh, K, T, P, packed_list, arrays)

    # trio batch (T = 4): the transmission state takes the pedigree min-plus
    K, T, P, packed_list, arrays = workloads.build_trio_batch(n_devices, n_pos=10, seed=7)
    assert T == 4
    _check_sharded(mesh, K, T, P, packed_list, arrays)

    _dryrun_cli_mesh(mesh)


def _dryrun_cli_mesh(mesh) -> None:
    """The phase CLI (BAM and VCF in, phased VCF out) on a synthetic
    chromosome of 300 variants in windows of 30, on the mesh's device: with
    every batched launch sharded over the mesh, byte-identical to the run on
    that device alone, and LAUNCH_STATS must show a launch over more than
    one device."""
    repo = Path(__file__).resolve().parents[2]
    if str(repo) not in sys.path:
        sys.path.insert(0, str(repo))
    from chip_smoke import write_synth

    from ..cli.phase import run_whatshap

    saved = wmec.MESH_DEVICES
    try:
        with tempfile.TemporaryDirectory() as tmp:
            data = write_synth(Path(tmp) / "synth", 300, 6, seed=5, vars_per_read=8, spacing=60,
                               break_every=30)

            def phase(out_path):
                run_whatshap(
                    phase_input_files=[data["bam"]],
                    variant_file=data["vcf"],
                    reference=False,
                    output=str(out_path),
                    write_command_line_header=False,
                    device=mesh[0],
                )

            single = Path(tmp) / "single.vcf"
            wmec.MESH_DEVICES = [mesh[0]]
            phase(single)

            wmec.MESH_DEVICES = list(mesh)
            wmec.LAUNCH_STATS.clear()
            sharded = Path(tmp) / "sharded.vcf"
            phase(sharded)

            assert any(
                n_dev > 1 for (_k, _t, _c, _b, _bp, n_dev) in wmec.LAUNCH_STATS
            ), "CLI dry run never launched a sharded batch"
            assert sharded.read_bytes() == single.read_bytes(), (
                "CLI run over the mesh is not byte-identical to the single-device run"
            )
    finally:
        wmec.MESH_DEVICES = saved
