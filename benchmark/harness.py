"""One run of a cell: set-up, the measured window, the check, the result.

Set-up builds the configuration's model with the program's
`isopoints_torch.factories.create_model`, loads the weights that
`weights.make_weights` draws and fits from the seed, makes the program's
`Generator` with the mix's chunk and image size, and renders one request
(the warm-up, which on a checkout's first run also builds the kernels).
The window is one closed-loop client calling
`Generator.raytrace_images` with each request as soon as the previous
one returned, until `seconds` have passed; the rate is the rays of every
completed request over the time from the first request's start to the
last one's return. After the window the program's state is freed and the
check (check.py) compares a seeded sample of the completed requests'
pixels with the plain reference.
"""

import contextlib
import gc
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark import check, spec, trace
from benchmark.traffic import Traffic
from benchmark.weights import make_weights
from benchmark.yardstick import flops

FORBIDDEN = ("jax", "jaxlib", "flax", "isopoints_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    out.update(over or {})
    return out


def state_dicts(model: dict, w: dict) -> Tuple[dict, dict]:
    """The weights under the program's parameter names (decoder, texture)."""
    dec = {}
    for i, layer in enumerate(w["decoder"]):
        keys = (("weight", "bias") if model.get("decoder_type") == "siren"
                else ("v", "g", "b"))
        dec.update({f"layers.{i}.{k}": t for k, t in zip(keys, layer)})
    tex = {f"layers.{i}.{k}": t for i, layer in enumerate(w["texture"])
           for k, t in zip(("v", "g", "b"), layer)}
    return dec, tex


class Setup:
    """The program built for a cell and seed, ready to serve requests."""

    def __init__(self, cell: spec.Cell, seed: int, device,
                 overrides: Optional[dict] = None):
        from isopoints_torch.config import AttrDict
        from isopoints_torch.factories import create_model
        from isopoints_torch.models.generator import Generator, GeneratorConfig

        ov = overrides or {}
        self.config = dict(cell.config)
        self.config["fit"] = _merge(cell.config["fit"], ov.get("fit"))
        self.mix = _merge(cell.mix, ov.get("mix"))
        self.check = _merge(self.mix["check"], ov.get("check"))
        self.model_cfg = self.config["model"]
        self.device = torch.device(device)
        self.seed = seed
        self.traffic = Traffic(self.mix, self.config, seed)
        t0 = time.time()
        self.weights = make_weights(self.config, seed, self.device)
        self.phases = {"weights": time.time() - t0}
        cfg = AttrDict({"model": self.model_cfg, "data": self.config["data"]})
        self.model = create_model(
            cfg, generator=torch.Generator(device=self.device).manual_seed(0),
            device=self.device)
        dec, tex = state_dicts(self.model_cfg, self.weights)
        self.model.decoder.load_state_dict(dec, strict=True)
        self.model.texture.load_state_dict(tex, strict=True)
        self.gen = Generator(self.model, GeneratorConfig(
            image_size=self.traffic.size,
            rays_per_chunk=int(self.mix["rays_per_chunk"])))
        self.phases["model"] = time.time() - t0 - self.phases["weights"]

    def request(self, i: int) -> Tuple[np.ndarray, Tuple, int]:
        """(RGBA (views, S, S, 4), (R, T), rays overflowed) of request i."""
        from isopoints_torch.core.camera import PerspectiveCamera

        R, T = self.traffic.cameras(i)
        cam = PerspectiveCamera.create(R=R, T=T,
                                       focal_length=self.traffic.focal,
                                       device=self.device)
        out = self.gen.raytrace_images(cam)
        return out, (R, T), int(self.gen.overflow)

    def free(self) -> None:
        del self.gen, self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _power_limit() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run(cell_name: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        overrides: Optional[dict] = None, root: str = spec.ROOT
        ) -> Tuple[Dict, List[str]]:
    """One run; returns (the result object, the lines for standard error,
    the compared numbers last)."""
    t_start = time.time() if t_start is None else t_start
    cell = spec.Cell(cell_name, root)
    dev = torch.device(device)
    t_imports = time.time() - t_start
    s = Setup(cell, seed, dev, overrides)
    if dev.type == "cuda":
        # the program's peak, from its build on: not the fit's
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_w = time.time()
    s.request(-1)                                    # warm-up
    setup_s = time.time() - t_start
    phases = dict(imports=t_imports, **s.phases, warmup=time.time() - t_w)

    records: List[dict] = []
    outputs, cams, failed, req_s = [], [], 0, []
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    with (trace.launch_hook(records) if traced
          else contextlib.nullcontext()), \
            (record_function(trace.WINDOW) if traced
             else contextlib.nullcontext()):
        t0 = time.perf_counter()
        i = 0
        while True:
            r0 = time.perf_counter()
            out, cam, ovf = s.request(i)
            req_s.append(time.perf_counter() - r0)
            outputs.append(out)
            cams.append(cam)
            failed += ovf
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
    if prof is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
    window = t1 - t0
    attempted = len(outputs) * s.traffic.rays_per_request
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    model_cfg, weights, traffic, chk = s.model_cfg, s.weights, s.traffic, s.check
    chunk = int(s.mix["rays_per_chunk"])
    s.free()

    readings = check.compare(model_cfg, weights, outputs, cams, traffic, chk,
                             seed, dev)
    correct, checks = check.judge(readings, cell.limits)

    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
               "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct) and attempted > 0,
              "attempted": attempted, "failed": failed}
    if traced:
        summ = trace.summarise(prof)
        ctx = {"window_s": summ["window_s"], "busy_s": summ["busy_s"],
               "device_events": summ["device_events"], "launches": records,
               "model": model_cfg, "rays": attempted,
               "rays_per_view_chunk": chunk, "peaks": flops.peaks(),
               "csrc_kernels": trace.csrc_kernels()}
        result["metrics"] = spec.readings(cell, ctx)
        devinfo.update(busy_s=summ["busy_s"], window_s=summ["window_s"])
        result["device"] = devinfo
        result["breakdown"] = summ["breakdown"]
    else:
        values = {"render_rays_per_s": attempted / window, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end()}
        result["device"] = devinfo
    if dev.type == "cuda":
        devinfo["power_limit_w"] = _power_limit()
    result["checks"] = checks
    err = [f"requests {len(outputs)} window_s {window!r} setup_s {setup_s!r} "
           f"fit_loss {weights['fit_loss']!r}",
           "setup_phases " + " ".join(f"{k} {v:.3f}" for k, v in phases.items()),
           "request_s " + " ".join(f"{x:.4f}" for x in req_s),
           "readings " + " ".join(f"{k} {v!r}" for k, v in readings.items())]
    err += [f"check {k} {v['value']!r} limit {v['limit']!r}"
            for k, v in checks.items()]
    return result, err

