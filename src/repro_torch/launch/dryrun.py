"""Dry run: every (architecture x shape x mesh) cell's per-device memory,
FLOPs and (SVFusion) collectives, without a device (twin of
``repro.launch.dryrun``).

The reference lowers each cell through XLA for placeholder TPU devices
and reads the compiled program's analyses. torch has no such lowering,
so a record here holds what the port can give:

* ``memory``: ``argument_bytes``, ``output_bytes`` and ``alias_bytes``
  a device, from the specs of the arguments the step reads and of its
  outputs, each dim divided (rounded up) by the mesh axes it is split
  over. ``alias_bytes`` counts the arguments written in place (the
  decode step's cache).
* ``flops_counted``: ``torch.utils.flop_counter.FlopCounterMode`` over
  the step run on ``meta`` tensors (no storage, no device), for the
  whole step (global); ``flops_per_device`` is that over ``n_chips``.
  Where the step-by-step SSM scan would replay more than ``MAX_REPLAY``
  steps, the count is the step at ``steps.cut_depth`` plus each cost
  unit times its multiplier (``flops_method``). The search step syncs
  the host, so the SVFusion cells take ``flops_per_device`` from
  ``analytical_search_flops``.
* ``collectives`` (SVFusion cells): the step's all-gathers of the [B, k]
  ids and distances along each data axis of more than one device,
  counted from the shapes (bytes: the gathered output, as the
  reference counts an all-gather).
* ``unavailable``: the reference's fields the port cannot give. No XLA
  partitioner means no per-device program: no HLO ``flops``,
  ``bytes_accessed``, ``temp_bytes`` or ``generated_code_bytes``, and
  no ``collectives`` for the LM cells.

Usage: python -m repro_torch.launch.dryrun (--arch A --shape S | --all)
[--mesh pod256|pod512|h100x1|h100x4|all]. Records go to
``results/dryrun_torch/<mesh>/<arch>__<shape>.json``.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import pathlib
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ARCH_IDS, shape_cells
from repro_torch.launch import steps as Steps
from repro_torch.launch.mesh import MESHES
from repro_torch.models.model import dtype_of
from repro_torch.models.sharding import (rules_override, shard_shape,
                                         use_mesh)

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" \
    / "dryrun_torch"
MAX_REPLAY = 100_000        # SSM scan steps a counted step may replay
UNAVAILABLE_HLO = ("flops", "bytes_accessed", "temp_bytes",
                   "generated_code_bytes")


def device_bytes(tree, specs, mesh) -> int:
    """Bytes a device holds of ``tree`` (meta tensors) laid out by
    ``specs`` (the same structure, a spec a tensor) on ``mesh``."""
    if torch.is_tensor(tree):
        return math.prod(shard_shape(tree.shape, specs, mesh)) \
            * tree.dtype.itemsize
    if isinstance(tree, dict):
        return sum(device_bytes(tree[k], specs[k], mesh) for k in tree)
    return sum(device_bytes(t, s, mesh) for t, s in zip(tree, specs))


def abstract_outputs(bundle, shape):
    """The step's outputs as meta tensors, in ``out_shardings``' layout."""
    args = bundle.abstract_args
    if bundle.kind == "train":
        return args[0], args[1], Steps.meta((), torch.float32)
    if bundle.kind == "search":
        B, k = shape.batch, Steps.SVF_PARAMS.k
        return Steps.meta((B, k), torch.int32), Steps.meta((B, k),
                                                           torch.float32)
    cfg = bundle.cfg
    logits = Steps.meta((shape.global_batch, 1, cfg.padded_vocab),
                        dtype_of(cfg.dtype))
    cache = Steps.abstract_cache(cfg, shape)[0] if bundle.kind == "prefill" \
        else args[1]
    return logits, cache


def memory(bundle, shape, mesh) -> dict:
    args, in_sh = bundle.abstract_args, bundle.in_shardings
    if bundle.kind == "search":       # the index fields the step reads
        idx = {k: args[0][k] for k in bundle.reads}
        args = (idx,) + tuple(args[1:])
        in_sh = ({k: in_sh[0][k] for k in bundle.reads},) + tuple(in_sh[1:])
    out_sh = bundle.out_shardings
    outs = abstract_outputs(bundle, shape)
    if out_sh is None:                 # replicated
        out_sh = tuple(() for _ in outs)
    return {
        "argument_bytes": device_bytes(tuple(args), tuple(in_sh), mesh),
        "output_bytes": device_bytes(tuple(outs), tuple(out_sh), mesh),
        "alias_bytes": sum(device_bytes(bundle.abstract_args[i],
                                        bundle.in_shardings[i], mesh)
                           for i in bundle.donate_argnums),
    }


def count_flops(fn, args) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return int(fc.get_total_flops())


def scan_replay(cfg, shape) -> int:
    """SSM scan steps the whole step runs (forward, recompute and
    backward of a training step)."""
    if cfg.family not in ("ssm", "hybrid") or shape.kind == "decode":
        return 0
    per = 3 if shape.kind == "train" else 1
    return cfg.n_layers * shape.seq_len * per


@functools.lru_cache(maxsize=None)
def counted_flops(arch: str, shape, method: str = "auto") -> dict:
    """The global FLOPs of ``arch``'s step at ``shape`` (a
    ``ShapeConfig``): ``method`` "step" runs the whole step, "units" the
    step at ``cut_depth`` plus the cost units, "auto" picks "units" when
    the whole step would replay more than ``MAX_REPLAY`` scan steps.
    The count does not depend on the mesh."""
    bundle = Steps.build_bundle(arch, shape)
    if method == "auto":
        method = "units" if scan_replay(bundle.cfg, shape) > MAX_REPLAY \
            else "step"
    if method == "step":
        return {"flops_counted": count_flops(bundle.fn, bundle.abstract_args),
                "flops_method": "whole step"}
    cut = Steps.step_bundle(arch, shape, Steps.cut_depth(bundle.cfg))
    main = count_flops(cut.fn, cut.abstract_args)
    units = [{"name": u.name, "multiplier": u.multiplier,
              "flops_counted": count_flops(u.fn, u.abstract_args)}
             for u in bundle.cost_units]
    return {"flops_counted": main + sum(u["flops_counted"] * u["multiplier"]
                                        for u in units),
            "flops_method": "step at cut_depth + cost units",
            "flops_cut_step": main, "units": units}


def svf_collectives(bundle, shape, mesh) -> dict:
    """The search step's all-gathers of [B, k] ids (int32) and distances
    (fp32), one pair for each data axis of more than one device."""
    k = Steps.SVF_PARAMS.k
    n = sum(2 for s in mesh.axis_sizes if s > 1)
    per_axis = [2 * s * shape.batch * k * 4 for s in mesh.axis_sizes
                if s > 1]
    return {"bytes": {"all-gather": sum(per_axis)},
            "counts": {"all-gather": n}, "total_bytes": sum(per_axis),
            "method": "counted from the shapes"}


def _name(shape) -> str:
    return shape if isinstance(shape, str) else shape.name


def run_cell(arch: str, shape, mesh="pod256", *, write=True) -> dict:
    """The dry-run record of ``arch`` at ``shape`` (a name, or a
    ``ShapeConfig`` / ``SvfShape``) on ``mesh`` (a ``MESHES`` name or a
    ``MeshDesc``), written to ``RESULTS`` when ``write``."""
    mesh = MESHES[mesh] if isinstance(mesh, str) else mesh
    shp = Steps.shape_config(shape)
    t0 = time.time()
    record = {"arch": arch, "shape": _name(shape), "mesh": mesh.name,
              "n_chips": mesh.size, "ok": False}
    try:
        with use_mesh(mesh):
            rules = Steps.plan_rules(arch, shp)
            record["rules"] = {k: list(v) for k, v in rules.items()}
            with rules_override(**rules):
                svf = arch.startswith("svfusion")
                bundle = Steps.build_svfusion_bundle(shp, mesh) if svf \
                    else Steps.build_bundle(arch, shp)
                record["kind"] = bundle.kind
                record["notes"] = bundle.notes
                record["model_flops"] = bundle.model_flops
                record["memory"] = memory(bundle, shp, mesh)
                unavailable = list(UNAVAILABLE_HLO)
                if svf:
                    record["flops_per_device"] = bundle.model_flops \
                        / mesh.size
                    record["flops_source"] = "analytical_search_flops"
                    record["collectives"] = svf_collectives(bundle, shp, mesh)
                    unavailable.append("flops_counted")
                else:
                    record.update(counted_flops(arch, shp))
                    record["flops_per_device"] = record["flops_counted"] \
                        / mesh.size
                    unavailable.append("collectives")
                record["unavailable"] = unavailable
        record["ok"] = True
    except Exception as e:        # a failed cell is recorded, not raised
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["elapsed_s"] = round(time.time() - t0, 2)
    if write:
        out = RESULTS / mesh.name / f"{arch}__{_name(shape)}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1))
    status = "OK " if record["ok"] else "FAIL"
    print(f"[{status}] {mesh.name} {arch:20s} {_name(shape):12s} "
          f"{record['elapsed_s']:7.1f}s {record.get('error', '')[:90]}",
          flush=True)
    return record


def all_cells():
    cells = [(arch, shape) for arch in ARCH_IDS for shape in shape_cells(arch)]
    cells.append(("svfusion_deep1b", "search_10k"))
    cells.append(("svfusion_msturing", "search_1k"))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=[*MESHES, "all"], default="all")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    meshes = list(MESHES) if args.mesh == "all" else [args.mesh]
    if args.all:
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    n_ok = n_fail = 0
    for mesh in meshes:
        for arch, shape in cells:
            rec = run_cell(arch, shape, mesh)
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
    print(f"dry-run: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
