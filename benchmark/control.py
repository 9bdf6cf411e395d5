"""Readings of the check without a measured window, many seeds in one
process, to set a cell's limits (limits/<cell>.json):

    python3 benchmark/control.py --workload CELL --seeds 1,2,3 \
        [--control] [--out FILE]

For each seed: set-up as a run makes it, then the mix's check requests
rendered by the program (`Generator.raytrace_images`, the timed path at
the timed sizes) and compared as a run compares them (the lower
readings); with `--control` the reference computed in bfloat16 stands in
for the program's output, at the same pixels of the same requests (the
upper readings). One JSON line a seed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell_name: str, seed: int, control: bool, device: str = "cuda",
             overrides=None) -> dict:
    """One seed's check readings (see the module docstring)."""
    import torch

    from benchmark import check, harness, spec

    cell = spec.Cell(cell_name)
    s = harness.Setup(cell, seed, torch.device(device), overrides)
    n = int(s.check["requests"])
    outputs, cams, failed = [], [], 0
    for i in range(n):
        if control:
            cams.append(s.traffic.cameras(i))
            outputs.append(None)
        else:
            out, cam, ovf = s.request(i)
            outputs.append(out)
            cams.append(cam)
            failed += ovf
    model, weights, traffic = s.model_cfg, s.weights, s.traffic
    s.free()
    r = check.compare(model, weights, outputs, cams, traffic, s.check, seed,
                      torch.device(device),
                      control=torch.bfloat16 if control else None)
    r.update(seed=seed, control=control, failed=failed,
             fit_loss=weights["fit_loss"])
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    lines = []
    for seed in (int(x) for x in args.seeds.split(",")):
        t = time.time()
        r = readings(args.workload, seed, args.control)
        r["seconds"] = time.time() - t
        lines.append(json.dumps(r))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
