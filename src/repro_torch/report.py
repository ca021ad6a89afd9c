"""Write ``results/dryrun_torch/REPORT.md`` from the port's dry-run
records: per cell of ``dryrun.all_cells()``, on one H100 (``h100x1``)
and on four over NVLink (``h100x4``), the memory a card holds and the
roofline terms on the card's peaks (twin of ``repro.report``, which
writes the reference's ``EXPERIMENTS.md`` and is not touched here).

Usage: python -m repro_torch.report (after
``python -m repro_torch.launch.dryrun --all``).
"""
from __future__ import annotations

from repro_torch import roofline as R

OUT = R.RESULTS / "REPORT.md"
CARD_BYTES = 80e9          # H100 SXM HBM


def mesh_section(mesh, results=None) -> list[str]:
    rows = sorted(R.table(mesh, results), key=lambda r: (r["arch"],
                                                         r["shape"]))
    for r in rows:
        r["args_fit_80gb"] = "yes" if r["arg_gb"] * 1e9 < CARD_BYTES \
            else "NO"
        r["help"] = R.what_would_help(r)
    return [
        f"\n## {mesh}: {len(rows)} cells\n",
        R.markdown_table(rows, ["arch", "shape", "arg_gb", "args_fit_80gb",
                                "notes"]),
        "",
        R.markdown_table(rows, ["arch", "shape", "t_compute_s",
                                "t_memory_lower_s", "t_collective_s",
                                "bound_s", "dominant", "useful_ratio",
                                "roofline_fraction", "help"]),
        ""]


def render(results=None) -> str:
    out = [
        "# Dry run and roofline of the PyTorch port on the H100\n",
        "Written by `python -m repro_torch.report` from the records of "
        "`python -m repro_torch.launch.dryrun --all` "
        "(`results/dryrun_torch/<mesh>/`). No number here was measured: "
        "the dry run runs each step on `meta` tensors (no device) and "
        "counts FLOPs with `torch.utils.flop_counter.FlopCounterMode`; "
        "bytes come from the specs, a dim divided (rounded up) by the "
        "mesh axes it is split over. Terms in seconds a step a card: "
        "compute = counted FLOPs a card / 989 TFLOP/s (H100 SXM dense "
        "bf16); memory = (argument + output - aliased bytes a card) / "
        "3.35 TB/s, a lower bound (no temporaries; the decode cache, "
        "written in place, counted once); collective = the search's "
        "all-gather bytes / 450 GB/s (NVLink, each way), 0 on one card, "
        "n/a for the LM cells (no partitioner, so no collectives). "
        "`useful_ratio` = model FLOPs (6·N·D or the serving analogue) / "
        "counted FLOPs; `roofline_fraction` = the model FLOPs' ideal "
        "compute time / the bound. The LM cells are the reference's "
        "global shapes on one card or four: most do not fit 80 GB "
        "(`args_fit_80gb`), as the reference sizes them for a 256-chip "
        "pod.\n"]
    for mesh in ("h100x1", "h100x4"):
        out += mesh_section(mesh, results)
    return "\n".join(out)


def main():
    text = render()
    OUT.write_text(text)
    print(f"wrote {OUT} ({len(text)} chars)")


if __name__ == "__main__":
    main()
