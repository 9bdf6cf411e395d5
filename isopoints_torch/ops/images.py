"""Image sampling and pixel enumeration (port of
isopoints_tpu/ops/images.py:35-102).

Images are (B, H, W, C) channels-last, as in the JAX package; NDC is +X
left, +Y up at pixel centers: x_ndc(col) = (W − 2·col − 1)/W.
"""

from typing import Optional, Tuple

import torch


def ndc_to_pix_coords(ndc_xy: torch.Tensor, image_size: Tuple[int, int]
                      ) -> torch.Tensor:
    h, w = image_size
    col = (w - 1.0) / 2.0 - ndc_xy[..., 0] * w / 2.0
    row = (h - 1.0) / 2.0 - ndc_xy[..., 1] * h / 2.0
    return torch.stack([col, row], dim=-1)


def pix_to_ndc_coords(pix_xy: torch.Tensor, image_size: Tuple[int, int]
                      ) -> torch.Tensor:
    h, w = image_size
    x = (w - 2.0 * pix_xy[..., 0] - 1.0) / w
    y = (h - 2.0 * pix_xy[..., 1] - 1.0) / h
    return torch.stack([x, y], dim=-1)


def sample_image_at_ndc(img: torch.Tensor, ndc_xy: torch.Tensor,
                        mode: str = "bilinear") -> torch.Tensor:
    """Image values at NDC points. img (B, H, W, C), ndc_xy (B, N, 2) ->
    (B, N, C); out-of-range coordinates clamp to the border."""
    b, h, w, _ = img.shape
    pix = ndc_to_pix_coords(ndc_xy, (h, w))
    col = torch.clamp(pix[..., 0], 0.0, w - 1.0)
    row = torch.clamp(pix[..., 1], 0.0, h - 1.0)
    bi = torch.arange(b, device=img.device)[:, None]
    if mode == "nearest":
        return img[bi, torch.round(row).long(), torch.round(col).long()]
    c0 = torch.floor(col).long()
    r0 = torch.floor(row).long()
    c1 = torch.clamp(c0 + 1, max=w - 1)
    r1 = torch.clamp(r0 + 1, max=h - 1)
    wc = (col - c0)[..., None]
    wr = (row - r0)[..., None]
    top = img[bi, r0, c0] * (1 - wc) + img[bi, r0, c1] * wc
    bot = img[bi, r1, c0] * (1 - wc) + img[bi, r1, c1] * wc
    return top * (1 - wr) + bot * wr


def arange_pixels(image_size: Tuple[int, int], batch_size: int = 1,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full pixel grid: (pix (B, H·W, 2) int (col, row), ndc (B, H·W, 2))."""
    h, w = image_size
    rr, cc = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    pix = torch.stack([cc.reshape(-1), rr.reshape(-1)], dim=-1)
    ndc = pix_to_ndc_coords(pix.float(), (h, w))
    return (pix[None].repeat(batch_size, 1, 1),
            ndc[None].repeat(batch_size, 1, 1))


def sample_random_pixels(generator: Optional[torch.Generator], n_points: int,
                         image_size: Tuple[int, int], batch_size: int = 1,
                         device=None) -> torch.Tensor:
    """Random continuous pixel positions in NDC, (B, n_points, 2)
    (sample_patch_points parity, the `continuous` case)."""
    h, w = image_size
    u = torch.rand((batch_size, n_points, 2), generator=generator,
                   device=device)
    pix = u * torch.tensor([w - 1.0, h - 1.0], device=device)
    return pix_to_ndc_coords(pix, (h, w))
