#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): one
run of one cell.

    python3 svbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. It makes the data on the card from the seed, builds the index,
warms the cell's own shapes, runs the cell's traffic for ``--seconds``,
compares the answers with the plain reference, and prints the numbers
compared beside their limits (the last lines of standard error) and one
JSON result line (the last line of standard output). With ``--trace 0``
the result holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics. Without a card, or with fewer than the cell asks for,
it exits non-zero and prints no result; so it does if JAX or the JAX
package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "svbench_cache"


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _err(msg):
    print(f"svbench: {msg}", file=sys.stderr, flush=True)


def main(argv, under_test=None) -> int:
    """One run against ``under_test`` (a module as ``svbench/system.py``;
    by default that one, the program)."""
    args = _args(argv)
    # every cache a library could keep stays inside the checkout, at a
    # fixed path (the port's own kernels build into build/repro_torch_kernels)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from svbench import harness, spec, system
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        _err("no CUDA device: this benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        _err(f"{args.workload} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} found")
        return 2
    try:
        import repro_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        _err(f"the port is not importable: {e}")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START,
                              under_test=under_test or system, log=_err)
    bad = harness.forbidden_modules()
    if bad:
        _err(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['must']} "
              f"{c['limit']})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
