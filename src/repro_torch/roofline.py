"""Roofline over the port's dry-run records, on the H100's peaks (twin of
``repro.roofline``).

Three terms a step, in seconds a device:

    compute    = flops_per_device / 989 TFLOP/s (dense bf16)
    memory     = (argument + output - aliased bytes a device) / 3.35 TB/s
                 (HBM3): each input read once, each output written once,
                 an output written in place over its input (the decode
                 cache) counted once; a lower bound, since the port has
                 no temporaries' bytes
    collective = collective bytes a device / 450 GB/s (NVLink, each way)
                 on a mesh of more than one card; 0 on one card; "n/a"
                 where the record has no collectives (the LM cells)

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates. ``roofline_fraction`` is the ideal compute time of the useful
``model_flops`` over the bounding term: the share of the compute peak
the step could reach if it ran at its bound.
"""
from __future__ import annotations

import json
import pathlib

PEAK_FLOPS = 989e12        # H100 SXM dense bf16
HBM_BW = 3.35e12           # H100 SXM HBM3
NVLINK_BW = 450e9          # H100 SXM NVLink, each way

RESULTS = pathlib.Path(__file__).resolve().parents[2] / "results" \
    / "dryrun_torch"


def load_cells(mesh="h100x1", results=None):
    cells = {}
    d = (results or RESULTS) / mesh
    if not d.exists():
        return cells
    for p in sorted(d.glob("*.json")):
        r = json.loads(p.read_text())
        if r.get("ok"):
            cells[(r["arch"], r["shape"])] = r
    return cells


def terms(rec) -> dict:
    chips = rec["n_chips"]
    t_comp = rec["flops_per_device"] / PEAK_FLOPS
    mem = rec["memory"]
    t_mem = (mem["argument_bytes"] + mem["output_bytes"]
             - mem.get("alias_bytes", 0)) / HBM_BW
    if "collectives" not in rec:
        t_coll = "n/a"
    elif chips == 1:
        t_coll = 0.0
    else:
        t_coll = rec["collectives"]["total_bytes"] / NVLINK_BW
    named = {"compute": t_comp, "memory": t_mem}
    if t_coll != "n/a":
        named["collective"] = t_coll
    dominant = max(named, key=named.get)
    bound = named[dominant]
    model = rec.get("model_flops", 0.0)
    ideal = model / chips / PEAK_FLOPS
    counted = rec.get("flops_counted")
    return {
        "arch": rec["arch"], "shape": rec["shape"], "chips": chips,
        "t_compute_s": t_comp, "t_memory_lower_s": t_mem,
        "t_collective_s": t_coll, "bound_s": bound, "dominant": dominant,
        "model_flops": model,
        "useful_ratio": model / counted if counted else "n/a",
        "roofline_fraction": ideal / bound if bound else 0.0,
        "arg_gb": mem["argument_bytes"] / 1e9,
        "notes": rec.get("notes", ""),
    }


def what_would_help(t) -> str:
    if t["dominant"] == "collective":
        return ("cut collective bytes: reduce-scatter instead of all-gather, "
                "fewer axes in the merge, keep weights resident")
    if t["dominant"] == "memory":
        return ("raise arithmetic intensity: batch more requests a step, "
                "fuse attention (no fp32 score or KV copies), bf16 end to "
                "end")
    if t["useful_ratio"] != "n/a" and t["useful_ratio"] < 0.6:
        return ("recover counted-but-useless FLOPs: the full-square causal "
                "attention, the remat recompute, the MoE capacity padding")
    return "compute-bound: tensor-core utilisation of the products remains"


def table(mesh="h100x1", results=None) -> list[dict]:
    return [terms(r) for r in load_cells(mesh, results).values()]


def markdown_table(rows, cols, header=None) -> str:
    out = ["| " + " | ".join(header or cols) + " |",
           "|" + "---|" * len(cols)]
    for r in rows:
        cells = []
        for c in cols:
            v = r[c]
            if isinstance(v, float):
                if "ratio" in c or "fraction" in c:
                    cells.append(f"{v:.3f}")
                elif v and (abs(v) < 1e-3 or abs(v) > 1e5):
                    cells.append(f"{v:.2e}")
                else:
                    cells.append(f"{v:.3f}")
            else:
                cells.append(str(v))
        out.append("| " + " | ".join(cells) + " |")
    return "\n".join(out)


def main():
    for mesh in ("h100x1", "h100x4"):
        rows = sorted(table(mesh), key=lambda r: (r["arch"], r["shape"]))
        print(f"\n## {mesh}\n")
        print(markdown_table(rows, ["arch", "shape", "t_compute_s",
                                    "t_memory_lower_s", "t_collective_s",
                                    "dominant", "useful_ratio",
                                    "roofline_fraction"]))


if __name__ == "__main__":
    main()
