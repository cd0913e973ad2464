#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one run of one cell.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with as many CUDA cards as the
cell asks for.  The cell (an entry of ``BENCHMARK.json``'s ``workloads``)
names its configuration and traffic mix; ``bench/harness/cells.py`` finds
their files.  Set-up makes the weights and inputs from ``--seed`` on the
card and warms every shape the traffic uses; the window then measures for
``--seconds``.  ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, read from a profiled window after it.
Every run ends by holding what the timed path produced against the plain
reference (``bench/reference``): each number compared is printed beside its
limit, as the last lines of standard error and as the last key of the result.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` with
``--trace 1``), ``checks``.  With no card, fewer cards than the cell asks
for, or ``jax``, ``jaxlib``, ``flax`` or ``repro`` loaded by the time the
window has closed, the run prints no result and exits with 2.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import ast  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    """Modules in ``sys.modules`` whose top-level name (before the first dot)
    is one of ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def reference_imports(root: Path = ROOT) -> list:
    """(file, module) of every import under ``bench/reference`` whose top-level
    name is ``repro_torch`` or one of ``FORBIDDEN``."""
    bad = []
    for path in sorted((root / "bench" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [(path.name, n) for n in names
                    if n.split(".")[0] in FORBIDDEN + ("repro_torch",)]
    return bad


def fail(message: str) -> None:
    print(f"bench: {message}", file=sys.stderr)
    sys.exit(2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's kernel caches stay in the checkout; a library that would
    # load JAX by itself is told not to
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    bad = reference_imports()
    if bad:
        fail(f"the reference imports the program or JAX: {bad}")
    import torch
    from bench.harness import cells, session

    cell = cells.cell(args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        fail(f"the cell asks for {cell.chips} cards; {torch.cuda.device_count()} here")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    out = cells.mode_module(cell.mode).run(cell, args.seed, args.seconds,
                                            bool(args.trace), device, T0)
    found = loaded_forbidden()
    if found:
        fail(f"loaded in this process: {found}")
    correct, checks = session.judge(out["numbers"], cell.limits)
    correct &= out["failed"] == 0
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"], "device": out["device"]}
    for key in ("requests", "batches", "breakdown"):
        if key in out:
            result[key] = out[key]
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
