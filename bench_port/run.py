"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port
(``raytracinginonesemester_tpu_torch``) and ``BENCHMARK.json``.  It needs
as many CUDA devices as the cell asks for and exits with code 2, printing
no result, without them.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiler trace of the
window.
"""

import time

T_START = time.perf_counter()  # set-up counts from here, before torch loads

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from bench_port import harness

    # the program's paths are the defaults: no knob from the caller's
    # environment may change them; its caches live in the checkout
    for key in [k for k in os.environ if k.startswith("RT_")]:
        del os.environ[key]
    os.environ.update(harness.cache_env(root))
    # a traffic mix may fix the threads of torch's CPU operators, which
    # torch reads when it loads (in harness.run)
    threads = harness.Cell(args.workload, root).traffic.get("host_threads")
    if threads:
        os.environ["OMP_NUM_THREADS"] = str(int(threads))
    return harness.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), T_START, root=root)


if __name__ == "__main__":
    sys.exit(main())
