"""Readings of a cell's control: the plain reference computed one
precision below the configuration's, put in the program's place, at the
cell's own size, judged by the cell's own comparison.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

Prints, for each seed, every number beside its limit and whether the
control came out not correct (it has to), then one JSON line. The
benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def readings(name: str, seed: int, device: str = "cuda", traffic=None,
             config=None) -> list:
    """The control's numbers (one dict an answer judged) for one seed."""
    from portbench import harness

    cell = harness.find_cell(harness.benchmark(), name)
    spec = cell["spec"]
    ctx = harness.Context(name, seed, 0.0, False, device,
                          {**cell["config_file"], **(config or {})},
                          {**spec["traffic"], **(traffic or {})},
                          spec["limits"])
    return harness.load("drivers", spec["driver"]).control(ctx)


def fails(nums: list, limits: dict) -> bool:
    """Whether the control came out not correct: a number over its limit."""
    return any(v > limits[k] for d in nums for k, v in d.items())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    from portbench import harness

    limits = harness.find_cell(harness.benchmark(),
                               args.workload)["spec"]["limits"]
    out = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = readings(args.workload, seed)
        # a run reports the worst of the answers it judged; so does this
        worst = {k: max(d[k] for d in nums) for k in nums[0]}
        out[seed] = {"worst": worst, "fails": fails(nums, limits)}
        print(f"seed {seed}: " + ", ".join(
            f"{k} {v!r} (limit {limits[k]!r})" for k, v in worst.items())
            + f"; not correct: {out[seed]['fails']}", flush=True)
    print(json.dumps({"workload": args.workload, "control": out}))
    return 0 if all(v["fails"] for v in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
