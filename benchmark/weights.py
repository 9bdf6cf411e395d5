"""The weights a run hands both the program and the reference: drawn from
the seed on the device, in a few large calls, then fitted to the
configuration's scene by a fixed number of Adam steps on seeded points.

Initialisation follows each paper (SIREN: first layer U(±1/in), the rest
U(±√(6/in)/ω0), zero biases; IGR's geometric init: N(0, 2/out) hidden,
head N(√π/√in, 1e-4) with bias −0.6, weight norm g = ‖w‖_row; the IDR
texture U(±1/√in)). The fit regresses the SDF's values (L1) at points
half uniform in the padded cube and half jittered about the surface.
The texture keeps its draw: a render only reads it.
"""

import math
from typing import Callable, Dict, List

import torch

from benchmark.reference import fields
from benchmark.yardstick.flops import decoder_products, texture_products


def stream(seed: int, k: int, device) -> torch.Generator:
    """The k-th independent generator of a run's seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + k) % (1 << 62))


def compound_sdf(x: torch.Tensor) -> torch.Tensor:
    """The ablation's solid: a torus in the xy plane and an axle box along
    x, joined by two end spheres, minus a vertical bore
    (isopoints_torch/make_ablation_data.py:27, copied)."""
    q = torch.stack([torch.linalg.norm(x[..., :2], dim=-1) - 0.55,
                     x[..., 2]], -1)
    torus = torch.linalg.norm(q, dim=-1) - 0.16
    qb = torch.abs(x) - torch.tensor([0.68, 0.12, 0.12], device=x.device)
    box = (torch.linalg.norm(torch.clamp(qb, min=0.0), dim=-1)
           + torch.clamp(torch.amax(qb, dim=-1), max=0.0))
    cap = torch.tensor([0.68, 0.0, 0.0], device=x.device)
    s1 = torch.linalg.norm(x - cap, dim=-1) - 0.2
    s2 = torch.linalg.norm(x + cap, dim=-1) - 0.2
    solid = torch.minimum(torch.minimum(torus, box), torch.minimum(s1, s2))
    cyl = torch.linalg.norm(x[..., :2], dim=-1) - 0.09
    return torch.maximum(solid, -cyl)


SCENES: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "compound": compound_sdf}


def _init_decoder(model: dict, g: torch.Generator, device) -> List:
    kind = model.get("decoder_type", "siren")
    kw = model.get("decoder_kwargs", {})
    prods = decoder_products(model)
    layers = []
    if kind == "siren":
        w0 = kw.get("hidden_omega_0", 30.0)
        for i, (a, b) in enumerate(prods):
            bound = 1.0 / a if i == 0 else math.sqrt(6.0 / a) / w0
            w = (torch.rand((b, a), generator=g, device=device) * 2 - 1) * bound
            layers.append([w, torch.zeros(b, device=device)])
        return layers
    for i, (a, b) in enumerate(prods):
        if i == len(prods) - 1:
            w = math.sqrt(math.pi) / math.sqrt(a) + 1e-4 * torch.randn(
                (b, a), generator=g, device=device)
            bias = torch.full((b,), -kw.get("bias", 0.6), device=device)
        else:
            w = torch.randn((b, a), generator=g, device=device) * (
                math.sqrt(2.0) / math.sqrt(b))
            bias = torch.zeros(b, device=device)
        layers.append([w, torch.linalg.norm(w, dim=1, keepdim=True), bias])
    return layers


def _init_texture(model: dict, g: torch.Generator, device) -> List:
    layers = []
    for a, b in texture_products(model):
        bound = 1.0 / math.sqrt(a)
        w = (torch.rand((b, a), generator=g, device=device) * 2 - 1) * bound
        bias = (torch.rand((b,), generator=g, device=device) * 2 - 1) * bound
        layers.append([w, torch.linalg.norm(w, dim=1, keepdim=True), bias])
    return layers


def _fit_points(sdf: Callable, n: int, g: torch.Generator, device,
                block: int = 1 << 20) -> torch.Tensor:
    """n points in a seeded order, made in blocks: each half uniform in
    [-1.1, 1.1]³, half two Newton steps onto the surface from uniform
    points, jittered by N(0, 0.02)."""
    out = []
    for s in range(0, n, block):
        m = min(block, n - s)
        u = torch.rand((m, 3), generator=g, device=device) * 2.2 - 1.1
        p = u[m // 2:]
        for _ in range(2):
            p = p.detach().requires_grad_(True)
            with torch.enable_grad():
                f = sdf(p)
                (gr,) = torch.autograd.grad(f.sum(), p)
            p = p - f[:, None] * gr / torch.clamp(
                (gr * gr).sum(-1, keepdim=True), min=1e-12)
        p = p.detach() + 0.02 * torch.randn(p.shape, generator=g,
                                            device=device)
        out.append(torch.cat([u[:m // 2], p]))
    pts = torch.cat(out)
    return pts[torch.randperm(n, generator=g, device=device)]


def make_weights(config: dict, seed: int, device) -> Dict[str, List]:
    """{"decoder": layers, "texture": layers, "fit_loss": float} for a
    configuration file's contents. The fit's points and targets are made
    in a few large calls before the steps; its products may run in TF32
    (the fit only has to reach a surface; both sides get its result)."""
    model, fit = config["model"], config["fit"]
    g = stream(seed, 1, device)
    decoder = _init_decoder(model, g, device)
    texture = _init_texture(model, g, device)
    scene = SCENES[fit["scene"]]
    steps, n = fit["steps"], fit["points"]
    pts = _fit_points(scene, steps * n, stream(seed, 2, device), device)
    target = torch.cat([scene(c) for c in pts.split(1 << 20)])
    leaves = [t.requires_grad_(True) for layer in decoder for t in layer]
    opt = torch.optim.Adam(leaves, lr=fit["lr"])
    f = fields.sdf_fn(model, decoder)
    loss = torch.zeros((), device=device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for i in range(steps):
            with torch.enable_grad():
                sl = slice(i * n, (i + 1) * n)
                loss = torch.mean(torch.abs(f(pts[sl]) - target[sl]))
                opt.zero_grad(set_to_none=True)
                loss.backward()
            opt.step()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    decoder = [[t.detach() for t in layer] for layer in decoder]
    return {"decoder": decoder, "texture": texture,
            "fit_loss": float(loss.detach())}
