"""The bilinear gather of a deformable 3x3 convolution (torch).

Port of aod_meh_hua_tpu/models/deform.py:31-60 (`_BASE_YX`,
`bilinear_zero`), the arithmetic of mmcv's DeformConv2d im2col sampling:
a zero-padded four-corner gather at float positions, each corner read
only where it lies inside the map. It is not F.grid_sample, whose
align_corners and border rules differ. Cascade RPN's
DeformConv3x3Explicit (models/cascade_rpn.py) runs on it. The JAX
module's DCN backbone convs and GCNet block (Faster R-CNN's backbone_dcn
and backbone_gcb_ratio switches) are not ported (ROADMAP Queue 1 item
15.5).
"""

from __future__ import annotations

import numpy as np
import torch

# tap offsets of a 3x3 kernel relative to its centre, row-major (dy, dx)
_BASE_YX = np.array([(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dtype=np.float32)


def bilinear_zero(feat: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Samples of feat [..., H, W, C] at float positions ys, xs [..., N]
    (the same leading dims), zero outside the map: [..., N, C]. Each of
    the four corners floor(y) + {0, 1}, floor(x) + {0, 1} adds its value
    times its bilinear weight where it lies inside the map, and nothing
    where it does not."""
    h, w, c = feat.shape[-3:]
    lead = feat.shape[:-3]
    table = feat.reshape(*lead, h * w, c)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    out = None
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            yy = y0 + dy
            xx = x0 + dx
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            yi = yy.clamp(0, h - 1).long()
            xi = xx.clamp(0, w - 1).long()
            idx = (yi * w + xi)[..., None].expand(*yi.shape, c)
            v = torch.gather(table, -2, idx) * (wy * wx * ok)[..., None].to(feat.dtype)
            out = v if out is None else out + v
    return out
