"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The program under test is
``dynamic_multiview_3d_torch`` from that checkout. The run needs as many
CUDA devices as the cell asks for and exits non-zero without them, as it
does where the program or anything of the JAX package was loaded. The
last line of standard output is the result as one JSON object; the last
lines of standard error name each compared number beside its limit. The
program builds its CUDA libraries into its own fixed folder inside the
checkout (``dynamic_multiview_3d_torch/_build/``), so only a checkout's
first run of a cell compiles.
"""

from __future__ import annotations

import os
import time
from pathlib import Path


def _process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock."""
    now = time.perf_counter()
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return now - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
CHECKOUT = Path(__file__).resolve().parent.parent

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "dynamic_multiview_3d_tpu")


def loaded_forbidden() -> list[str]:
    """Modules of JAX or of the JAX package in this process, by their
    whole top-level name."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    phases = {"interpreter": time.perf_counter() - T_START}
    import torch
    phases["import_torch"] = time.perf_counter() - T_START - sum(
        phases.values())
    from portbench import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import dynamic_multiview_3d_torch as program
    from dynamic_multiview_3d_torch import api, models  # noqa: F401
    where = Path(program.__file__).resolve()
    if CHECKOUT not in where.parents:
        print(f"portbench: the program was imported from {where}, not from "
              f"this checkout", file=sys.stderr)
        return 2
    phases["import_program"] = time.perf_counter() - T_START - sum(
        phases.values())
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START, phases)
    found = loaded_forbidden()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
