"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`: each test skips without a CUDA device (decided inside the
fixture, never at import). This file imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -o addopts="" tests/test_torch_kernels_cuda.py

Tolerances: MLP values atol 2e-5 and input gradients atol 1e-4 + rtol 1e-4
(float32 FMA in the kernel against cuBLAS float32 in the twin; ω = 30
sine layers amplify the round-off of the gradient). Sampler: the picked
depths must be equal on all but 0.1% of rays (a pick flips only where two
proposal values tie within round-off), and on equal picks f_pick agrees to
1e-5 and the secant depth to 1e-4 on rays with a sign change.
"""

import pytest
import torch

from isopoints_torch.models.fields import SirenField
from isopoints_torch.models.raytracing import RayTracingConfig, ray_trace
from isopoints_torch.ops import fused_mlp, fused_sampler
from isopoints_torch.utils import linspace01

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sdf(dev, hidden, n_layers, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    field = SirenField(hidden_size=hidden, n_layers=n_layers, generator=g,
                       device=dev)
    return field, fused_mlp.make_fused_siren_sdf(field)


def _rays(dev, n, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    cam = torch.tensor([0.0, 0.0, -2.0], device=dev).expand(n, 3).contiguous()
    d = torch.randn(n, 3, generator=g, device=dev) * 0.3
    d[:, 2] = 1.0
    d = d / d.norm(dim=-1, keepdim=True)
    t_lo = 0.8 + 0.4 * torch.rand(n, generator=g, device=dev)
    t_hi = t_lo + 2.2 * torch.rand(n, generator=g, device=dev)
    return cam, d, t_lo, t_hi


@pytest.mark.parametrize("hidden,n_layers,n", [(64, 2, 1000), (256, 3, 5000),
                                               (96, 0, 77)])
def test_fused_mlp_matches_twin(dev, hidden, n_layers, n):
    field, sdf = _sdf(dev, hidden, n_layers)
    x = torch.rand(n, 3, device=dev) * 2 - 1
    before = fused_mlp.KERNEL.launches
    v = sdf(x)
    v2, g = sdf.sdf_and_grad(x)
    torch.cuda.synchronize()
    assert fused_mlp.KERNEL.launches == before + 2
    v_ref, g_ref = fused_mlp.siren_sdf_and_grad_plain(sdf.pack, x)
    torch.testing.assert_close(v, v_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(v2, v_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(g, g_ref, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        torch.testing.assert_close(v, field.sdf(x), atol=2e-5, rtol=0)


def test_fused_mlp_checks_inputs(dev):
    _, sdf = _sdf(dev, 64, 1)
    x = torch.rand(10, 3, device=dev)
    with pytest.raises(TypeError):
        sdf(x.double())
    with pytest.raises(ValueError):
        fused_mlp.siren_forward_cuda(sdf.pack, x[:, :2], False)
    with pytest.raises(ValueError):
        fused_mlp.siren_forward_cuda(sdf.pack, x.t(), False)
    _, odd = _sdf(dev, 48, 1)
    with pytest.raises(ValueError):
        odd(x)


@pytest.mark.parametrize("n_secant,random_steps", [(8, False), (0, True)])
def test_fused_sampler_matches_twin(dev, n_secant, random_steps):
    _, sdf = _sdf(dev, 256, 3)
    cam, d, t_lo, t_hi = _rays(dev, 4096)
    steps = (torch.rand(100, device=dev) if random_steps
             else linspace01(100, device=dev))
    before = fused_sampler.KERNEL.launches
    out = sdf.fused_ray_sampler(cam, d, t_lo, t_hi, steps, n_secant=n_secant)
    torch.cuda.synchronize()
    assert fused_sampler.KERNEL.launches == before + 1
    ref = fused_sampler.sweep_plain(
        lambda p: fused_mlp.siren_sdf_plain(sdf.pack, p), cam, d, t_lo, t_hi,
        steps, n_secant)
    same = (out[0] == ref[0]) & (out[2] == ref[2])
    assert float(same.float().mean()) >= 0.999
    torch.testing.assert_close(out[1][same], ref[1][same], atol=1e-5, rtol=0)
    hit = same & (ref[1] < 0)
    assert int(hit.sum()) > 100
    torch.testing.assert_close(out[3][hit], ref[3][hit], atol=1e-4, rtol=0)


def test_ray_trace_fused_matches_plain(dev):
    field, sdf = _sdf(dev, 256, 3)
    cam, d, _, _ = _rays(dev, 2048)
    cam, d = cam.reshape(2, 1024, 3), d.reshape(2, 1024, 3)
    obj = torch.rand(2, 1024, device=dev) > 0.4
    u = torch.rand(100, device=dev)
    with torch.no_grad():
        r_k = ray_trace(sdf, cam, d, obj, u,
                        RayTracingConfig(sampler_in_kernel=True))
        r_p = ray_trace(field.sdf, cam, d, obj, u, RayTracingConfig())
    agree = r_k.network_object_mask == r_p.network_object_mask
    assert float(agree.float().mean()) >= 0.998
    close = (r_k.dists - r_p.dists).abs() < 1e-4
    assert float(close.float().mean()) >= 0.99
