"""The IGR kernels' outputs on seeded inputs, saved from one build of the
kernels and held bit for bit against another's.

    python -m isopoints_torch.igr_reference save FILE
    python -m isopoints_torch.igr_reference check FILE

The bench's 4x256 IGR field (skip at the head) with its geometric init
from a seeded CPU generator (so every build sees the same weights, which a
fit on the CPU does not promise), then on the card,
for each mode: `fused_igr` value and value+grad on 2048 points in
[-1.2, 1.2]^3 (numpy seed 1); and bench.py's trace schedule on 4096 rays,
once with the fused MLP and the in-kernel sampler and once more with the
in-kernel march, its depths, hit and sampler masks (the f32 trace sweeps
in bf16 and evaluates fine in f32, as bench.py does; the bf16 trace does
both in bf16). So every IGR kernel (fused_igr, the coarse sampler, the
march) contributes in each mode. `check` prints each output's number of
differing elements and exits non-zero if any differs.
`tests/test_torch_kernels_cuda.py` holds the kernels to the outputs saved
in `tests/data/igr_reference.pt`.
"""

import sys
from typing import Dict

import numpy as np
import torch

from isopoints_torch import bench
from isopoints_torch.models.fields import SDFField
from isopoints_torch.ops import fused_mlp

N_POINTS = 2048
N_RAYS = 4096


def outputs(device) -> Dict[str, torch.Tensor]:
    """Every output, on the CPU, by name."""
    field = SDFField(hidden_size=256, n_layers=4, num_frequencies=0,
                     generator=torch.Generator().manual_seed(0), device="cpu").to(device)
    x = np.random.RandomState(1).uniform(-1.2, 1.2, (N_POINTS, 3))
    x = torch.from_numpy(x.astype(np.float32)).to(device)
    rays = bench.make_rays(N_RAYS, device)
    out = {}
    for precision in fused_mlp.PRECISIONS:
        fn = fused_mlp.make_fused_igr_sdf(field, precision)
        out[f"{precision} value"] = fn(x)
        out[f"{precision} value+grad: value"], out[f"{precision} value+grad: grad"] = (
            fn.sdf_and_grad(x))
        fine, coarse = bench.trace_fns(field)
        if precision == "bf16":
            fine = coarse
        for route, cfg in (("sampler", bench.bench_config()),
                           ("march", bench.bench_config(trace_in_kernel=True))):
            res = bench.trace(fine, coarse, rays, cfg)
            for name in ("dists", "network_object_mask", "sampler_mask"):
                out[f"{precision} trace ({route}): {name}"] = getattr(res, name)
    return {k: v.detach().cpu() for k, v in out.items()}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2 or argv[0] not in ("save", "check"):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("igr_reference runs the CUDA kernels: it needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    got = outputs(torch.device("cuda"))
    if argv[0] == "save":
        torch.save(got, argv[1])
        print(f"saved {len(got)} outputs to {argv[1]}")
        return
    ref = torch.load(argv[1], weights_only=True)
    bad = 0
    for name in sorted(set(ref) | set(got)):
        if name not in ref or name not in got:
            print(f"{name}: only in {'the reference' if name in ref else 'this build'}")
            bad += 1
        elif got[name].shape != ref[name].shape:
            print(f"{name}: shape {tuple(got[name].shape)}, the reference's "
                  f"{tuple(ref[name].shape)}")
            bad += 1
        else:
            n = int((got[name] != ref[name]).sum())
            print(f"{name} {tuple(got[name].shape)}: "
                  + (f"differs in {n} elements" if n else "equal"))
            bad += n > 0
    if bad:
        raise SystemExit(f"{bad} outputs differ from {argv[1]}")
    print(f"all {len(got)} outputs equal to {argv[1]} bit for bit")


if __name__ == "__main__":
    main()
