"""The benchmark's command: one run of one cell on the card.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted` and `failed` (rays), `metrics` (the cell's end-to-end metrics;
with `--trace 1` its per-layer ones), `device`, with `--trace 1`
`breakdown`, and last `checks`, each compared number beside its limit,
which also end standard error. Exits non-zero and prints no result
without CUDA or with fewer cards than the cell asks for, or when a module
of JAX or of the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton_cache")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, spec

    chips = spec.Cell(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    result, err = harness.run(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    print("\n".join(err), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
