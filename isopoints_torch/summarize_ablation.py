"""Summarise the three-arm sampling ablation (port of
scripts/summarize_ablation.py).

    python -m isopoints_torch.summarize_ablation out/ablation_implicit \
        out/ablation_uni out/ablation_lossS [--budget 5400] \
        [--data-dir out/torch_data_compound] [--final-mesh-resolution 192] \
        [--truncate-at SECONDS] [--no-finals] [--out PATH] [--device cuda|cpu]

Reads each arm's metrics.jsonl (train_mvr's rows; the `eval_` rows of the
validate cadence: eval_psnr_full, eval_iou_full, eval_chamfer) and writes
the same table as the JAX script: each arm's last and best scores, its
median ms a training step (the median gap between consecutive training
rows), and its curves against elapsed seconds. `--truncate-at T` takes
each arm's last evaluation at or before T seconds of its own wall clock.

Finals: each arm's model.npz (with its config.yaml) is meshed at
`--final-mesh-resolution`³ by `Generator.generate_mesh` (one stage, on the
fused SIREN kernel on the card), cut to its largest component and scored
by `evaluate_mesh` against the data's 20,000 GT samples; under
`--truncate-at` an arm whose run outlasted T is skipped. `--no-finals`
leaves the section out.

The table goes to `--out` (default: ABLATION.md in the first arm's parent
directory) and the raw metrics are copied beside it into
ablation_metrics/<arm>.jsonl. `main(argv)` returns the rows, the finals,
each final's times (mesh, largest component, evaluation) and the lines.
"""

import argparse
import os
import shutil
import time

import numpy as np
import torch


def arm_name(d: str) -> str:
    return os.path.basename(d.rstrip("/")).replace("ablation_", "")


def _load_metrics(path: str):
    """A missing arm (crashed, or not run yet) gives no rows."""
    from isopoints_torch.misc.metrics import load_metrics

    return load_metrics(path) if os.path.exists(path) else []


def arm_rows(d: str, truncate_at: float):
    """(table row or None, curve, restarts, logged wall seconds) of one arm
    (summarize_ablation.py:73-121)."""
    all_rows = _load_metrics(os.path.join(d, "metrics.jsonl"))
    t_first = min((m["ts"] for m in all_rows), default=0.0)
    its = [m["it"] for m in all_rows]
    restarts = sum(1 for a, b in zip(its, its[1:]) if b < a)
    wall_all = max(m["ts"] for m in all_rows) - t_first if all_rows else 0.0
    ms = [m for m in all_rows if "eval_iou_full" in m]
    if truncate_at > 0:
        ms = [m for m in ms if m["ts"] - t_first <= truncate_at]
    if not ms:
        return None, [], restarts, wall_all
    last = ms[-1]
    # per-step cost: the median gap between consecutive training rows (an
    # evaluation between two of them would skew a mean)
    train = [m for m in all_rows if "eval_iou_full" not in m]
    gaps = sorted((b["ts"] - a["ts"]) / max(b["it"] - a["it"], 1)
                  for a, b in zip(train, train[1:]) if 0 < b["it"] - a["it"] <= 2)
    row = dict(
        iters=last["it"], psnr=last["eval_psnr_full"], iou=last["eval_iou_full"],
        chamfer=last.get("eval_chamfer", float("nan")),
        best_psnr=max(m["eval_psnr_full"] for m in ms),
        best_iou=max(m["eval_iou_full"] for m in ms),
        best_chamfer=min(m.get("eval_chamfer", float("inf")) for m in ms),
        step_ms=1e3 * gaps[len(gaps) // 2] if gaps else float("nan"),
        wall=(train[-1]["ts"] - train[0]["ts"]) if len(train) > 1 else 0)
    # curves against elapsed seconds: the protocol is equal time
    curve = [(m["it"], int(m["ts"] - t_first), m["eval_psnr_full"],
              m.get("eval_chamfer", float("nan"))) for m in ms]
    return row, curve, restarts, wall_all


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def final_chamfer(d: str, gt: np.ndarray, resolution: int, device: torch.device):
    """(chamfer_p, {mesh, largest, evaluate: seconds}) of an arm's final
    checkpoint, or None without one; inf for an empty mesh."""
    from isopoints_torch.config import load_config
    from isopoints_torch.factories import create_model
    from isopoints_torch.misc.checkpoints import CheckpointIO
    from isopoints_torch.models.generator import Generator, GeneratorConfig
    from isopoints_torch.training.evaluation import evaluate_mesh
    from isopoints_torch.utils.meshing import largest_component

    cfgp = os.path.join(d, "config.yaml")
    if not (os.path.exists(os.path.join(d, "model.npz")) and os.path.exists(cfgp)):
        return None
    model = create_model(load_config(cfgp), device=device)
    ckpt = CheckpointIO(d, model=model.state_dict())
    ckpt.load("model.npz")
    model.load_state_dict(ckpt.registry["model"])
    times = {}
    t = time.perf_counter()
    gen = Generator(model, GeneratorConfig(mesh_resolution=resolution))
    verts, faces = gen.generate_mesh(two_stage=False)
    times["mesh"] = time.perf_counter() - t
    if len(verts) == 0:
        return float("inf"), times
    t = time.perf_counter()
    verts, faces = largest_component(verts, faces)
    times["largest"] = time.perf_counter() - t
    t = time.perf_counter()
    res = evaluate_mesh(verts, faces, gt, None, n_samples=20000, device=device)
    _sync(device)
    times["evaluate"] = time.perf_counter() - t
    times["faces"] = len(faces)
    return res["chamfer_p"], times


def _device_words(device: torch.device) -> str:
    if device.type == "cuda":
        return f"one {torch.cuda.get_device_name(device)}"
    return "the CPU"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--budget", type=int, default=0)
    ap.add_argument("--out", type=str, default=None,
                    help="default: ABLATION.md beside the first arm's directory")
    ap.add_argument("--final-mesh-resolution", type=int, default=192)
    ap.add_argument("--data-dir", type=str, default="out/torch_data_compound")
    ap.add_argument("--truncate-at", type=int, default=0,
                    help="equal-budget comparison point, in seconds of each "
                    "arm's wall clock from its first metrics row: each arm's "
                    "row uses its last evaluation at or before it")
    ap.add_argument("--no-finals", action="store_true",
                    help="leave out the final-checkpoint re-evaluation")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    out = args.out or os.path.join(
        os.path.dirname(os.path.abspath(args.dirs[0].rstrip("/"))), "ABLATION.md")
    rows, curves, restarts, run_wall = [], {}, {}, {}
    for d in args.dirs:
        name = arm_name(d)
        row, curves[name], restarts[name], run_wall[name] = arm_rows(
            d, args.truncate_at)
        rows.append((name, row))
        if row is None:
            del curves[name]

    # the consistent final evaluation: one fixed resolution and only the
    # largest component (the in-training chamfer meshes the raw field, whose
    # off-camera islands contaminate it)
    finals, final_times, skipped = {}, {}, []
    gtp = os.path.join(args.data_dir, "data_dict.npz")
    if not args.no_finals and os.path.exists(gtp):
        gt = np.load(gtp)["points"]
        for d in args.dirs:
            name = arm_name(d)
            # model.npz is the end-of-run checkpoint: under --truncate-at it
            # may hold training past T, so an arm whose logged run outlasts T
            # (+2% for the final write) is skipped
            if (args.truncate_at > 0
                    and run_wall.get(name, 0.0) > 1.02 * args.truncate_at):
                skipped.append(name)
                continue
            res = final_chamfer(d, gt, args.final_mesh_resolution, device)
            if res is not None:
                finals[name], final_times[name] = res

    lines = [
        "# ABLATION — sampling with iso-points (reference protocol)",
        "",
        "Three-way MVR ablation mirroring the reference's headline experiment "
        "(`README.md:60-67`, `train_mvr --exit-after`): baseline implicit (IDR "
        "ray tracing only) vs uniform iso-points vs loss-weighted iso-points "
        f"(hard-example mining), EQUAL wall-clock budget ({args.budget}s each, "
        f"{_device_words(device)}, sequential runs).",
        "",
        "Data: 512px x 24 views rendered from the compound CSG mesh "
        "(`python -m isopoints_torch.make_ablation_data`; a stand-in for the "
        "reference's compressor part with the same qualitative difficulty: "
        "through-hole, concavities, thin features). Configs: "
        "`isopoints_torch/configs/ablation_compound_*_dir.yml`. Chamfer is "
        "point-to-surface-samples (20k GT samples), the mesh extracted at the "
        "run's `--eval-mesh-resolution` per evaluation.",
        "",
        "Conditions: the arms ran one after another on the same revision. "
        + ("Arms that crashed and were resumed from their last checkpoint "
           "count the crash against their budget. Restart counts: "
           + ", ".join(f"{k} x{v}" for k, v in restarts.items() if v) + "."
           if any(restarts.values()) else
           "Each arm is one uninterrupted run."),
        "",
        ("" if not args.truncate_at else
         f"EQUAL-BUDGET TABLE at T = {args.truncate_at}s of per-arm wall clock "
         "(each arm's last eval at or before T; arms that ran longer are "
         "truncated; crash/restart overheads count against the arm that "
         "incurred them).\n"),
        "| arm | iters reached | med ms/step | final PSNR | final IoU "
        "| final chamfer | best PSNR | best IoU | best chamfer |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for name, r in rows:
        if r is None:
            lines.append(f"| {name} | (no eval rows) | | | | | | | |")
            continue
        lines.append(
            f"| {name} | {r['iters']} | {r['step_ms']:.0f} "
            f"| {r['psnr']:.2f} | {r['iou']:.4f} "
            f"| {r['chamfer']:.5f} | {r['best_psnr']:.2f} "
            f"| {r['best_iou']:.4f} | {r['best_chamfer']:.5f} |")
    lines.append("")
    if finals:
        lines += ["## Final-checkpoint chamfer (consistent protocol)", "",
                  f"Final mesh at {args.final_mesh_resolution}^3, LARGEST "
                  "component only, squared chamfer vs the 20k GT surface "
                  "samples (the in-training curve meshes the raw field, whose "
                  "off-camera f<0 islands contaminate it; this row is the "
                  "comparable number):", "", "| arm | final chamfer_p |",
                  "|---|---|"]
        lines += [f"| {name} | {v:.6f} |" for name, v in finals.items()]
        lines += [f"| {name} | (skipped: run extended past T={args.truncate_at}s "
                  "— end-of-run checkpoint would embody extra training) |"
                  for name in skipped]
        lines.append("")
    lines += ["## Curves (it, elapsed_s, PSNR_full, chamfer)", ""]
    for name, c in curves.items():
        pts = ", ".join(f"({it}, {t}s, {p:.2f}, {ch:.4f})" for it, t, p, ch in c)
        lines.append(f"- **{name}**: {pts}")
    lines.append("")

    copy_dir = os.path.join(os.path.dirname(os.path.abspath(out)), "ablation_metrics")
    os.makedirs(copy_dir, exist_ok=True)
    for d in args.dirs:
        src = os.path.join(d, "metrics.jsonl")
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(copy_dir, f"{arm_name(d)}.jsonl"))
    lines += [f"Raw per-arm metrics: `{copy_dir}/<arm>.jsonl` (copies of each "
              "run's metrics.jsonl).", ""]

    with open(out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out}")
    for line in lines[6:6 + len(rows) + 2]:
        print(line)
    return {"rows": rows, "finals": finals, "final_times": final_times,
            "skipped": skipped, "lines": lines, "out": out}


if __name__ == "__main__":
    main()
