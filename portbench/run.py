"""Run one benchmark cell of the PyTorch port on the cards of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON object as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number that decides
``correct`` beside its limit), and the same numbers as the last lines of
standard error. Exits with another code than 0, and prints no result,
where the cards the cell needs are not there, where the process holds
JAX or the JAX package once the window has closed, or where a cell's
files or the program are missing.
"""

import time

T0 = time.perf_counter()    # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    torch.set_num_threads(1)     # one process, few threads: steadier runs
    try:
        out = harness.execute(args.workload, args.seed, args.seconds,
                              bool(args.trace), T0)
    except harness.HarnessError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        return 1
    held = harness.forbidden_modules()
    if held:
        print("portbench: the process holds " + ", ".join(held),
              file=sys.stderr)
        return 3
    print(f"correct {out['correct']}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
