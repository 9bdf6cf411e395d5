"""The port as a package: import hygiene, configs, checkpoint conversion,
the generator chain and the warm-up entry point, all on the CPU."""

import json
import os
import pkgutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import isopoints_torch
from isopoints_tpu.config import load_config as j_load_config
from isopoints_tpu.misc.checkpoints import CheckpointIO
from isopoints_tpu.models.fields import SirenField as JSiren
from isopoints_torch.config import load_config
from isopoints_torch.convert import load_jax_npz, params_from_jax
from isopoints_torch.rng import GeneratorChain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_CFG = os.path.join(ROOT, "isopoints_torch", "configs",
                         "mvr_warmup_siren.yml")


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        isopoints_torch.__path__, "isopoints_torch."))
    assert "isopoints_torch.ops.fused_mlp" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'isopoints_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_slice_config_inherits_default():
    cfg = load_config(SLICE_CFG)
    ref = j_load_config(os.path.join(ROOT, "configs", "default.yaml"))
    assert cfg.model.decoder_kwargs.to_dict() == {"hidden_size": 256,
                                                  "n_layers": 3}
    assert cfg.model.implicit_kwargs.use_fused_mlp is True
    assert cfg.model.implicit_kwargs.raytrace.to_dict() == {
        "sampler_in_kernel": True}
    # nothing else differs from configs/default.yaml
    got = cfg.to_dict()
    got.pop("inherit_from")
    del got["model"]["implicit_kwargs"]["use_fused_mlp"]
    del got["model"]["implicit_kwargs"]["raytrace"]
    assert got == ref.to_dict()


def test_load_jax_checkpoint(tmp_path):
    field = JSiren(hidden_size=32, n_layers=1)
    params = {"decoder": field.init(jax.random.key(3))}
    CheckpointIO(str(tmp_path), model=params).save("model.npz", it=5)
    sd = load_jax_npz(str(tmp_path / "model.npz"))
    ref = params_from_jax({"decoder": jax.tree.map(np.asarray,
                                                   params["decoder"])})
    assert sorted(sd) == sorted(ref) and len(sd) == 6
    for k in sd:
        assert torch.equal(sd[k], ref[k])


def test_generator_chain_is_seeded_and_fresh():
    a, b = GeneratorChain(7), GeneratorChain(7)
    xa = [torch.rand(3, generator=a.next()) for _ in range(2)]
    xb = [torch.rand(3, generator=b.next()) for _ in range(2)]
    assert torch.equal(xa[0], xb[0]) and torch.equal(xa[1], xb[1])
    assert not torch.equal(xa[0], xa[1])


def test_train_mvr_warmup_entry_on_cpu(tmp_path):
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(
        f"inherit_from: {SLICE_CFG}\n"
        "data: {n_views: 3, image_size: 12}\n"
        "model: {decoder_kwargs: {hidden_size: 32, n_layers: 1}}\n"
        "training: {n_rays: 32, scheduler_init_n_rays: 32, "
        "n_eikonal_points: 32}\n")
    out = tmp_path / "out"
    subprocess.run([sys.executable, "-m", "isopoints_torch.train_mvr",
                    str(cfg), "--max-iters", "2", "--device", "cpu",
                    "--out-dir", str(out)], cwd=ROOT, check=True, timeout=300)
    rows = [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["it"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in rows)
    with pytest.raises(subprocess.CalledProcessError):
        subprocess.run([sys.executable, "-m", "isopoints_torch.train_mvr",
                        str(cfg), "--max-iters", "501", "--device", "cpu",
                        "--out-dir", str(out)], cwd=ROOT, check=True,
                       timeout=300, capture_output=True)
