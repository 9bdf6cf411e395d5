"""Rank processes for tests/test_torch_parallel.py (the port only: this
module imports torch and isopoints_torch, never jax).

`run(rank, world, store, task, inp, out)` joins a gloo process group
through a `FileStore` at `store`, runs `task` on the inputs of the npz file
`inp` and writes the rank's results to `out` % rank. Tasks:
- "step": one `make_train_step` step of the tiny combined model of
  tests/test_parallel.py on the given parameters, buffer and full-width
  draws, with the views replicated or, for "step_views", sharded (each rank
  passes its half of the views);
- "newton": the sharded Newton projection on the sphere SDF;
- "checkpoint": `CheckpointIO(backend="orbax")` saved and loaded by both
  ranks: replicated parameters and an Adam state with non-zero moments,
  and a DTensor sharded by rows over the two ranks;
- "camera": `form_global_batch` on this rank's share of a camera batch
  with non-default clip planes; the planes come back as they were;
- "entry": `train_mvr.main` with `--n-devices 2`, as torchrun launches it
  (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT set; the entry makes the
  group).
"""

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

N_RAYS, N_EIK, SIZE = 64, 64, 32
HP = {"lambda_rgb": 1.0, "lambda_freespace": 1.0, "lambda_occupied": 1.0,
      "lambda_eikonal": 0.01, "sdf_alpha": 10.0}


def tiny_model():
    """The port of tests/test_parallel.py's `tiny_model`."""
    from isopoints_torch.models.combined import CombinedConfig, CombinedModel
    from isopoints_torch.models.fields import SirenField
    from isopoints_torch.models.implicit import ImplicitConfig
    from isopoints_torch.rendering.rasterizer import RasterizationSettings
    return CombinedModel(
        SirenField(hidden_size=32, n_layers=1, device="cpu"),
        ImplicitConfig(proj_max_iters=5),
        CombinedConfig(max_iso_per_batch=64, n_points_per_cloud=128,
                       visibility_image_size=SIZE),
        raster_settings=RasterizationSettings(image_size=SIZE, tile_size=8,
                                              max_points_per_tile=64))


def port_step(mesh, inp, views_sharded=False):
    """One step on the inputs of `inp` (a dict of numpy arrays) over
    `mesh`; returns the results as a dict of numpy arrays."""
    from isopoints_torch.core.camera import PerspectiveCamera
    from isopoints_torch.models.combined import ProjectedDraws
    from isopoints_torch.parallel.sharding import make_train_step
    from isopoints_torch.training.trainer import AdamState, StepDraws

    t = lambda k: torch.from_numpy(np.array(inp[k]))
    model = tiny_model()
    model.load_state_dict({k[3:]: t(k) for k in inp if k.startswith("sd:")})
    project = bool(inp["project"])
    img, mask = t("img"), t("mask")
    cam = PerspectiveCamera.create(R=t("R"), T=t("T"), focal_length=2.0)
    if views_sharded:   # this rank's contiguous share of the views
        per = img.shape[0] // mesh.size
        sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
        img, mask = img[sl], mask[sl]
        cam = PerspectiveCamera(R=cam.R[sl], T=cam.T[sl],
                                focal_length=cam.focal_length[sl],
                                principal_point=cam.principal_point[sl])
    draws = StepDraws(t("pixels"), t("eikonal"), t("u_minsdf"), ProjectedDraws(
        t("sel_scores"), t("iso_offset"), t("ray_uniform")) if project else None)
    zeros = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    step = make_train_step(model, mesh, project, N_RAYS, n_eikonal_points=N_EIK,
                           views_sharded=views_sharded)
    _, pts, pmask, metrics, _ = step(AdamState(0, zeros, dict(zeros)),
                                     t("points"), t("points_mask"), None, img,
                                     mask, cam, HP, draws)
    out = {f"metric:{k}": v.numpy() for k, v in metrics.items()}
    if views_sharded:   # tests/test_parallel.py's form_global_batch layout
        from isopoints_torch.parallel.data import form_global_batch
        x = np.arange(8 * 4 * 4, dtype=np.float32).reshape(8, 4, 4)
        per = 8 // mesh.size
        out["gathered"] = form_global_batch(
            {"img": x[mesh.rank * per:(mesh.rank + 1) * per]}, mesh)["img"].numpy()
    out.update({f"param:{k}": v.detach().numpy()
                for k, v in model.state_dict().items()})
    out.update(points=pts.numpy(), points_mask=pmask.numpy())
    return out


def sphere_sdf(x):
    return torch.linalg.norm(x, dim=-1) - 0.6


def newton(mesh, inp):
    from isopoints_torch.models.levelset import project_points_newton
    out = {}
    for p in (128, 100):
        res = project_points_newton(sphere_sdf, torch.from_numpy(inp[f"pts{p}"]),
                                    torch.from_numpy(inp[f"mask{p}"]),
                                    max_iters=10, tolerance=1e-5, mesh=mesh)
        out.update({f"{f}{p}": getattr(res, f).numpy()
                    for f in ("points", "normals", "mask")})
    return out


def checkpoint(mesh, inp):
    """Save the registry of `inp` with the orbax backend under the group,
    load it into zeroed templates, and return what came back (the DTensor
    as this rank's shard)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from isopoints_torch.misc.checkpoints import CheckpointIO
    from isopoints_torch.training.trainer import AdamState

    t = lambda k: torch.from_numpy(np.array(inp[k]))
    dmesh = init_device_mesh("cpu", (mesh.size,))
    names = [k[3:] for k in inp if k.startswith("mu:")]
    opt = AdamState(int(inp["count"]), {k: t("mu:" + k) for k in names},
                    {k: t("nu:" + k) for k in names})
    rows = distribute_tensor(t("rows"), dmesh, [Shard(0)])
    d = str(inp["dir"])
    path = CheckpointIO(d, backend="orbax", model={"w": t("w")}, opt=opt,
                        rows=rows).save("model.npz", it=int(inp["it"]))
    zero = lambda x: torch.zeros_like(x)
    ck = CheckpointIO(d, backend="orbax", model={"w": zero(t("w"))},
                      opt=AdamState(0, {k: zero(v) for k, v in opt.mu.items()},
                                    {k: zero(v) for k, v in opt.nu.items()}),
                      rows=distribute_tensor(zero(t("rows")), dmesh, [Shard(0)]))
    scalars = ck.load("model")
    r = ck.registry
    assert isinstance(r["rows"], DTensor) and r["rows"].placements == (Shard(0),)
    out = {"path": np.array(path), "it": np.int64(scalars["it"]),
           "count": np.int64(r["opt"].count), "w": r["model"]["w"].numpy(),
           "rows_local": r["rows"].to_local().numpy()}
    out.update({f"mu:{k}": v.numpy() for k, v in r["opt"].mu.items()})
    out.update({f"nu:{k}": v.numpy() for k, v in r["opt"].nu.items()})
    return out


def camera(mesh, inp):
    """This rank's half of the cameras of `inp` (znear 0.5, zfar 3.0)
    through `form_global_batch`; returns the gathered arrays and planes."""
    from isopoints_torch.core.camera import PerspectiveCamera
    from isopoints_torch.parallel.data import form_global_batch

    per = inp["R"].shape[0] // mesh.size
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    cam = PerspectiveCamera.create(R=inp["R"][sl], T=inp["T"][sl],
                                   focal_length=inp["focal"][sl],
                                   znear=0.5, zfar=3.0)
    g = form_global_batch((cam, inp["img"][sl]), mesh)
    assert isinstance(g[0], PerspectiveCamera)
    assert type(g[0].znear) is float and type(g[0].zfar) is float
    return {"R": g[0].R.numpy(), "T": g[0].T.numpy(),
            "focal": g[0].focal_length.numpy(),
            "principal_point": g[0].principal_point.numpy(),
            "planes": np.array([g[0].znear, g[0].zfar]), "img": g[1].numpy()}


def run(rank, world, store, task, inp, out):
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with np.load(inp, allow_pickle=False) as f:
        arrays = {k: f[k] for k in f.files}
    if task == "entry":
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                          WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(int(arrays["port"])))
        from isopoints_torch import train_mvr
        argv = [str(a) for a in arrays["argv"]]
        run_ = train_mvr.main(argv)
        res = {"mesh_size": np.int64(run_.trainer.mesh.size),
               "views_sharded": np.bool_(run_.trainer.views_sharded)}
        res.update({f"param:{k}": v.detach().numpy()
                    for k, v in run_.trainer.model.state_dict().items()})
        np.savez(out % rank, **res)
        dist.destroy_process_group()
        return
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    from isopoints_torch.parallel.sharding import make_mesh
    mesh = make_mesh(world, "cpu")
    assert (mesh.size, mesh.rank) == (world, rank)
    if task == "newton":
        res = newton(mesh, arrays)
    elif task == "checkpoint":
        res = checkpoint(mesh, arrays)
    elif task == "camera":
        res = camera(mesh, arrays)
    else:
        res = port_step(mesh, arrays, views_sharded=task == "step_views")
    np.savez(out % rank, **res)
    dist.destroy_process_group()
