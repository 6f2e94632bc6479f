"""YUV 4:2:0 -> RGB on the device, bitwise equal to libjpeg.

Port of hand_integral_pose_estimation_tpu/ops/yuv.py. The native loader's
YUV mode (`data/native_loader.py`, native/hipe_io.cpp
`decode_jpeg_file_yuv420`) stops the host decode at the planar subsampled
form the JPEG file stores: 1.5 bytes a pixel to copy to the card instead of
3, and no chroma upsampling or colour conversion on the host. This module
finishes the decode with an exact integer emulation of libjpeg's default
path, so the pixels are bitwise those of the full host decode
(`decode_jpeg`):

* chroma upsampling: `h2v2_fancy_upsample` (jdsample.c), the 3/4 + 1/4
  triangle filter in each dimension with the library's alternating +8/+7
  rounding and edge replication;
* colour conversion: `ycc_rgb_convert` (jdcolor.c), the SCALEBITS = 16
  fixed-point constants (FIX(1.40200) = 91881, FIX(1.77200) = 116130,
  FIX(0.34414) = 22554, FIX(0.71414) = 46802) with ONE_HALF rounding and
  the 0..255 range limit.

Everything is int32 elementwise work with shapes fixed by the image size:
no host synchronisation and no data-dependent shape, so it runs inside a
captured CUDA graph (the Trainer's chunk decodes the packed planes there).
`>>` on an int32 tensor is an arithmetic shift in torch, as in libjpeg's
RIGHT_SHIFT and jnp: the G term is negative for many inputs.
"""

from __future__ import annotations

import torch


def planar_sizes(height: int, width: int) -> tuple[int, int, int]:
    """(y, cb, cr) plane lengths of a packed 4:2:0 image."""
    if height % 2 or width % 2:
        raise ValueError("4:2:0 needs even dims, got %dx%d" % (height, width))
    c = (height // 2) * (width // 2)
    return height * width, c, c


def upsample_h2v2_fancy(c: torch.Tensor) -> torch.Tensor:
    """libjpeg `h2v2_fancy_upsample`: (B, ch, cw) uint8 -> (B, 2ch, 2cw).

    Triangle filter (9/16, 3/16, 3/16, 1/16), edge-replicated, with the
    library's integer rounding: even output columns round with +8, odd
    with +7. Edge replication makes the first and last columns' special
    cases ((sum*4+8)>>4, (sum*4+7)>>4) fall out of the general formula."""
    c = c.to(torch.int32)
    B, ch, cw = c.shape
    # vertical pass: colsum = 3 * nearer + farther (rows 2i pull row i-1,
    # rows 2i+1 pull row i+1; clamped at the image edge)
    up = 3 * c + torch.cat([c[:, :1], c[:, :-1]], dim=1)
    down = 3 * c + torch.cat([c[:, 1:], c[:, -1:]], dim=1)
    cols = torch.stack([up, down], dim=2).reshape(B, 2 * ch, cw)
    # horizontal pass over the column sums
    left = torch.cat([cols[..., :1], cols[..., :-1]], dim=-1)
    right = torch.cat([cols[..., 1:], cols[..., -1:]], dim=-1)
    even = (3 * cols + left + 8) >> 4
    odd = (3 * cols + right + 7) >> 4
    out = torch.stack([even, odd], dim=-1).reshape(B, 2 * ch, 2 * cw)
    return out.to(torch.uint8)


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
               ) -> torch.Tensor:
    """libjpeg `ycc_rgb_convert` on full-resolution planes -> (..., 3)
    uint8 (jdcolor.c build_ycc_rgb_table: SCALEBITS 16, ONE_HALF 32768,
    arithmetic right shifts)."""
    yi = y.to(torch.int32)
    cbi = cb.to(torch.int32) - 128
    cri = cr.to(torch.int32) - 128
    r = yi + ((91881 * cri + 32768) >> 16)
    b = yi + ((116130 * cbi + 32768) >> 16)
    g = yi + ((-22554 * cbi + 32768 - 46802 * cri) >> 16)
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


def yuv420_to_rgb(packed: torch.Tensor, height: int, width: int
                  ) -> torch.Tensor:
    """Packed planar 4:2:0 batches -> RGB, bitwise equal to libjpeg.

    `packed` is (B, h*w*3//2) uint8 as the native loader's YUV mode makes
    it: the Y plane, then Cb (h/2, w/2), then Cr. Returns (B, h, w, 3)
    uint8 on `packed`'s device."""
    ny, ncb, _ = planar_sizes(height, width)
    ch, cw = height // 2, width // 2
    b = packed.shape[0]
    y = packed[:, :ny].reshape(b, height, width)
    cb = packed[:, ny:ny + ncb].reshape(b, ch, cw)
    cr = packed[:, ny + ncb:].reshape(b, ch, cw)
    return ycc_to_rgb(y, upsample_h2v2_fancy(cb), upsample_h2v2_fancy(cr))
