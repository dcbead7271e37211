"""The readings a cell's limits are set from, on the chip at the cell's size.

    python3 -m portbench.calibrate --workload <cell> --seconds <s> \\
        --seeds <n>... [--control-seeds <n>...] [--faults <kind>...] \\
        [--fault-seeds <n>...]

In one process: a short run of the cell for each of ``--seeds`` (the
program as it is: the lower readings), the control on each of
``--control-seeds`` (the reference one precision below the
configuration's, in the program's place, on the same requests or steps
as a run compares: the upper readings), and each of the traffic kind's
planted faults (``kinds/<kind>.py``'s ``FAULTS``) on each of
``--fault-seeds``. Prints one JSON line per reading. Not part of a
benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import check, harness, traffic as traffic_lib, weights
from portbench.reference import dmv3d
from portbench.reference import train as ref_train


def control(cell: dict, seed: int, device) -> dict:
    m = cell["config_file"]["config"]["model"]
    params = weights.draw(dmv3d.param_shapes(m), seed, device)
    pool = traffic_lib.pool(cell["traffic_file"], m["image_size"], seed,
                            device)
    return harness.kind(cell).control(cell, params, pool)


def look(cell: dict, seed: int, device, top: int = 6) -> dict:
    """A train cell's parameters with the largest gaps of set-up's steps,
    the program's and the control's, at ``seed``."""
    conf = cell["config_file"]["config"]
    params = weights.draw(dmv3d.param_shapes(conf["model"]), seed, device)
    driver = harness.kind(cell)
    work = driver.Work(cell, seed, device, params)
    prog, pool = work.first, work.pool
    work.free()
    batches = driver._batches(pool, device, 0)
    ref = ref_train.run_steps(conf["model"], conf["train"], params, batches)
    fp8 = ref_train.run_steps(conf["model"], conf["train"], params, batches,
                              check.fp8)
    out = {}
    for who, side in (("program", prog), ("control", {
            "grad_norms": {k: float(g.norm())
                           for k, g in fp8["first_grads"].items()},
            "change_norms": {k: float(c.norm())
                             for k, c in fp8["change"].items()}})):
        gaps = check.leaf_gaps(side, ref)
        out[who] = {k: sorted(v.items(), key=lambda kv: -kv[1])[:top]
                    for k, v in gaps.items()}
    out["grad_norms"] = sorted(
        ((k, float(g.norm())) for k, g in ref["first_grads"].items()),
        key=lambda kv: kv[1])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--look-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = torch.device(args.device)
    driver = harness.kind(cell)

    def show(what, seed, numbers, **extra):
        print(json.dumps({"workload": args.workload, "what": what,
                          "seed": seed, "numbers": numbers, **extra}),
              flush=True)

    for seed in args.seeds:
        out = harness.run_cell(cell, seed, args.seconds, False, device,
                               time.perf_counter())
        show("program", seed, out["readings"],
             metrics={k: v["value"] for k, v in out["metrics"].items()})
    for seed in args.look_seeds:
        show("look", seed, look(cell, seed, device))
    for seed in args.control_seeds:
        show("control", seed, control(cell, seed, device))
    for fault in args.faults:
        for seed in args.fault_seeds:
            with driver.FAULTS[fault]():
                out = harness.run_cell(cell, seed, args.seconds, False,
                                       device, time.perf_counter())
            show(f"fault:{fault}", seed, out["readings"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
