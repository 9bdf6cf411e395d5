"""The harness finds a cell, a mix, a configuration and a per-layer metric
that were added as files and entries only, with no file edited."""

import hashlib
import json
import os
import shutil

from benchmark import spec

ROOT = spec.ROOT


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_added_files_are_found(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(root)
    b = os.path.join(root, "benchmark")

    # a configuration, a mix, limits and a metric reader, each a new file
    with open(os.path.join(b, "configs", "siren-3x256.json")) as f:
        cfg = json.load(f)
    cfg["model"]["decoder_kwargs"]["hidden_size"] = 128
    with open(os.path.join(b, "configs", "siren-3x128.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "render128x8.json"), "w") as f:
        json.dump({"views": 8, "image_size": 128, "elevation_deg": 30.0,
                   "azimuth_step_deg": 45.0, "rays_per_chunk": 16384,
                   "check": {"requests": 2, "rays": 4096}}, f)
    with open(os.path.join(b, "limits", "siren-3x128.render128x8.json"),
              "w") as f:
        json.dump({"limits": {"px_off": 0.05}}, f)
    with open(os.path.join(b, "metrics", "rays_k.render.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['rays'] / 1e3\n")

    # ... and entries in BENCHMARK.json
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "siren-3x128", "source": "x",
                             "file": "benchmark/configs/siren-3x128.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "siren-3x128.render128x8",
                               "config": "siren-3x128",
                               "traffic": "render128x8", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "rays_k.render", "unit": "k",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "render_rays_per_s",
                               "workloads": ["siren-3x128.render128x8"]})
    with open(path, "w") as f:
        json.dump(bench, f)

    cell = spec.Cell("siren-3x128.render128x8", root)
    assert cell.config["model"]["decoder_kwargs"]["hidden_size"] == 128
    assert cell.mix["views"] == 8
    assert cell.limits == {"px_off": 0.05}
    names = [m["name"] for m in cell.per_layer()]
    assert "rays_k.render" in names
    assert "rays_k.render" not in [
        m["name"] for m in spec.Cell("siren-3x256.render512x2", root).per_layer()]
    assert cell.reader("rays_k.render")({"rays": 2000}) == 2.0

    after = _digests(root)
    edited = [p for p, h in before.items() if after.get(p) != h]
    assert edited == []


def test_every_entry_has_its_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = spec.Cell(w["name"])
        assert cell.limits
        for m in cell.per_layer():
            assert os.path.exists(os.path.join(cell.metrics_dir,
                                               m["name"] + ".py"))
