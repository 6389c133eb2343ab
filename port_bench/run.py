"""The benchmark of ddim_audio_tpu_torch: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json`` at the root of the checkout;
its configuration, traffic mix, driver, per-layer metrics and kernel
families are files of this folder, found by name (``harness/registry.py``).
The run sets up the program with seed-made weights, warms the cell's
shapes, measures for ``--seconds`` (``--trace 1``: then traces a short
window and reports the per-layer metrics instead of the end-to-end ones),
compares what the timed path produced with the float32 reference of
``reference/``, and prints the compared numbers with their limits as the
last lines of standard error and one JSON object as the last line of
standard output. It exits non-zero and prints no result without as many
CUDA devices as the cell asks for, without the program, or when JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from port_bench.harness.registry import Registry

    registry = Registry()
    cell = registry.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                          < int(cell["chips"])):
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import ddim_audio_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"port_bench: the program is not here: {err}", file=sys.stderr)
        return 4

    from port_bench.harness.cell import execute, forbidden_modules

    result, checks = execute(registry, args.workload, args.seed,
                             args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"port_bench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 5
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
