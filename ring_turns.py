#!/usr/bin/env python3
"""Times the packed ring kernels' global path of two checkouts of the
port in turns on one card.

The calls are those of ``chip_smoke.py`` phase 6 on the global path
(``path="global"``): configs[0] (4 x 1M f32), the histogram payload (4 x
229,376 f32, both directions) and configs[1] (reduce-scatter of 8 x 256M
f64, allgather of 8 x 32M f64), and the reference's 16- and 64-member
meshes (configs[0] and the histogram payload over 16, reduce-scatter of
16 x 128M f64, allgather of 16 x 8M f64, allreduce of 64 x 1M f32). Each
run is a fresh interpreter that imports the package from one checkout
and builds its ``ring_kernel.cu``; the runs go other, this, this, other.
A call's time is the device time of its kernels (``torch.profiler``,
mean of 5 calls after one warm-up), as ``chip_smoke.py`` measures it.
Every run digests each call's output (the sum of its 64-bit words and
its NaN count, seeded inputs), and the two checkouts' digests must
agree: the global path's result is fixed bit for bit by the ring's fold
order.

    python3 ring_turns.py --other DIR

``DIR`` holds another checkout (say a ``git archive`` of the parent
commit unpacked under ``.chipwork/``, which git ignores). Prints a line
a call and run, the card's ``nvidia-smi`` line and each call's mean by
checkout, and writes ``chiprun_out/ring_turns.json``. Needs one card.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
REPS = 5
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
HIST_PAYLOAD = 2 * 16 * 28 * 256   # chip_smoke.py's histogram payload
# (name, mode, members, length a member, dtype, bidirectional)
CALLS = (
    ("configs[0] allreduce 4 x 1M f32", "allreduce", 4, 1 << 20,
     "float32", False),
    ("histogram payload 4 x 229376 f32 bidir", "allreduce", 4, HIST_PAYLOAD,
     "float32", True),
    ("configs[1] reduce-scatter 8 x 256M f64", "reduce_scatter", 8, 256 << 20,
     "float64", False),
    ("configs[1] allgather 8 x 32M f64", "allgather", 8, 32 << 20,
     "float64", False),
    ("configs[0] allreduce 16 x 1M f32", "allreduce", 16, 1 << 20,
     "float32", False),
    ("histogram payload 16 x 229376 f32 bidir", "allreduce", 16,
     HIST_PAYLOAD, "float32", True),
    ("reduce-scatter 16 x 128M f64", "reduce_scatter", 16, 128 << 20,
     "float64", False),
    ("allgather 16 x 8M f64", "allgather", 16, 8 << 20, "float64", False),
    ("allreduce 64 x 1M f32", "allreduce", 64, 1 << 20, "float32", False),
)


def bound_ms(mode, n, length, itemsize):
    """Every input read once and every output written once at the HBM
    rate (chip_smoke.py ``ring_bound_ms``; these calls are bytes-bound)."""
    moved = {"allreduce": 2 * n * length,
             "reduce_scatter": n * length + length,
             "allgather": n * length + n * n * length}[mode] * itemsize
    return moved / HBM_BYTES_PER_S * 1e3


def worker(checkout, out_path):
    """One run: the calls on this interpreter's card, from ``checkout``'s
    package."""
    sys.path.insert(0, checkout)
    import torch

    from ytk_mp4j_tpu_torch.ops import _build
    from ytk_mp4j_tpu_torch.ops import ring_kernel as rk

    _build.build(["ring_kernel"])
    dev = torch.device("cuda", 0)
    entry = {"allreduce": rk.ring_allreduce_kernel,
             "reduce_scatter": rk.ring_reduce_scatter_kernel,
             "allgather": lambda x, bidirectional, **kw:
             rk.ring_allgather_kernel(x, bidirectional, **kw)}

    def device_ms(fn):
        """Mean device ms of the call's one ``ring_`` kernel, as
        chip_smoke.py's ``device_ms``: marker kernels first (CUPTI loses
        a profile's first launches now and then), the mean over the
        kernels seen, a profile that saw fewer than REPS taken again."""
        fn()
        torch.cuda.synchronize()
        best = (0, 0.0)
        for _ in range(3):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
                for _ in range(256):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
                for _ in range(REPS):
                    fn()
                torch.cuda.synchronize()
            got = [(e.count, getattr(e, "self_device_time_total", 0))
                   for e in p.key_averages() if "ring_" in e.key]
            seen = (sum(c for c, _ in got), sum(us for _, us in got))
            best = max(best, seen)
            if seen[0] >= REPS:
                break
        if best[0] == 0:
            raise SystemExit("the profiler saw no device time")
        return best[1] / best[0] / 1e3

    rows = []
    for i, (name, mode, n, length, dt, bidir) in enumerate(CALLS):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        x = torch.randn((n, length), generator=gen, device=dev,
                        dtype=getattr(torch, dt))

        def call():
            return entry[mode](x, bidirectional=bidir, path="global")

        y = call()
        words = y.view(torch.int64) if y.element_size() == 8 else \
            y.view(torch.int32).to(torch.int64)
        digest = [int(words.sum()), int(y.isnan().sum())]
        del y, words
        ms = device_ms(call)
        rows.append(dict(call=name, mode=mode, n=n, length=length, dtype=dt,
                         bidirectional=bidir, ms=ms,
                         bound_ms=bound_ms(mode, n, length, x.element_size()),
                         digest=digest))
        print(f"{checkout}: {name}: {ms:.4f} ms (bound "
              f"{rows[-1]['bound_ms']:.4f})", flush=True)
        del x
        torch.cuda.empty_cache()
    with open(out_path, "w") as f:
        json.dump(rows, f)
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="another checkout of the repo, timed in turns")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ring_turns: no CUDA device", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    os.makedirs(OUT_DIR, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    runs = []
    for k, checkout in enumerate((other, HERE, HERE, other)):
        path = os.path.join(OUT_DIR, f"ring_turns_{k}.json")
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--worker", checkout, path],
                            timeout=1200).returncode
        if rc:
            print(f"ring_turns: run {k} ({checkout}) exited {rc}",
                  file=sys.stderr)
            return 1
        with open(path) as f:
            runs.append({"checkout": checkout, "rows": json.load(f)})
    ok = True
    summary = []
    for i, (name, *_rest) in enumerate(CALLS):
        digests = {json.dumps(r["rows"][i]["digest"]) for r in runs}
        same = len(digests) == 1
        ok &= same
        by = {c: [r["rows"][i]["ms"] for r in runs if r["checkout"] == c]
              for c in (other, HERE)}
        summary.append(dict(call=name, other_ms=by[other], this_ms=by[HERE],
                            bound_ms=runs[0]["rows"][i]["bound_ms"],
                            digests_agree=same))
        print(f"{name}: other {sum(by[other]) / 2:.4f} ms {by[other]}, this "
              f"{sum(by[HERE]) / 2:.4f} ms {by[HERE]}, bound "
              f"{summary[-1]['bound_ms']:.4f} ms, outputs "
              f"{'agree' if same else 'DIFFER'}", flush=True)
    with open(os.path.join(OUT_DIR, "ring_turns.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "other": other, "runs": runs,
                   "summary": summary}, f, indent=1)
    print(smi)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        sys.exit(worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
