"""The readings that a cell's limits are set from (never run by the
benchmark's own runs):

    python3 perfbench/calibrate.py --workload cornell.fit \
        --seeds 1,2,3 --control-seeds 11,12,13 [--fault-seeds 21,22,23]

* the program: a run of the cell per seed (a short window for a fit,
  which runs on through the steps it compares; ``run_seconds`` for a
  session, so that as many passes are compared as a run compares);
* the control: the reference in the program's place, with its tables and
  wavefront state stored in bfloat16, at the cell's own size;
* the faults that the cell's loop plants (its ``FAULTS``) in the
  reference put in the program's place (a fit's: ``half``, the loss over
  half the pixels, their mean; ``altered``, each loss read 1% high; both
  from the first window step on). A state left unchanged reads 1 by the
  step gap's measure and needs no run.

Each reading is one JSON line on standard output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None, overrides=None):
    """``overrides`` replace traffic parameters (the tests' small
    sizes)."""
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--passes", type=int, default=0,
                   help="a session control's passes (default: the first "
                        "program seed's)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from perfbench.harness import cell, specs

    bench = specs.benchmark()
    w = specs.workload(args.workload, bench)
    mix = specs.traffic(w["traffic"], overrides=overrides)
    loop_name = mix["loop"]
    loop = specs.loop(loop_name)
    dev = torch.device(args.device)

    def emit(**row):
        print(json.dumps(row), flush=True)

    def context(seed):
        return cell.context(args.workload, seed, bench["run_seconds"], False,
                            dev, time.perf_counter(), overrides, bench)

    passes = args.passes
    for seed in _seeds(args.seeds):
        t0 = time.perf_counter()
        res, compared = cell.run(
            args.workload, seed,
            bench["run_seconds"] if loop_name == "session" else 0.01, 0,
            dev, t0, overrides=overrides, bench=bench,
            log=open(os.devnull, "w"))
        if not passes:
            passes = res["attempted"] + mix["warmup_calls"]
        emit(kind="program", seed=seed, attempted=res["attempted"],
             numbers={k: c["value"] for k, c in compared.items()},
             seconds=time.perf_counter() - t0)

    for seed in _seeds(args.control_seeds):
        t0 = time.perf_counter()
        emit(kind="control", seed=seed,
             numbers=loop.stand_in(context(seed), "bf16", None, passes),
             seconds=time.perf_counter() - t0)

    for seed in _seeds(args.fault_seeds):
        for fault in loop.FAULTS:
            t0 = time.perf_counter()
            emit(kind=f"fault:{fault}", seed=seed,
                 numbers=loop.stand_in(context(seed), "fp32", fault, passes),
                 seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
