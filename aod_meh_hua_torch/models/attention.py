"""GeneralizedAttention (torch): the four-term spatial attention of "An
Empirical Study of Spatial Attention Mechanisms in Deep Networks" (Zhu et
al., ICCV 2019), as the empirical-attention family plugs it into the
backbone (after conv2 of the c4 and c5 blocks; 8 heads, kv_stride 2) and
GRoIE fuses its RoI features with it ('0100', 6 heads, kv_stride 2).

Port of aod_meh_hua_tpu/models/attention.py:43-139 (`_sin_embed`, a
cited copy, and `GeneralizedAttention`), which re-derives mmcv's
cnn/bricks/generalized_attention.py from the paper's energy terms:

  E(q, k) = [1] <W_q x_q, W_k x_k> / sqrt(d)   (query and key content)
          + [2] <W_q x_q, W_g r_qk> / sqrt(d)  (query content and position)
          + [3] <u, W_k x_k>                   (bias and key content)
          + [4] <v, W_g r_qk>                  (bias and position)

attention_type a '0'/'1' mask over the four terms; r_qk a sinusoidal
embedding of the relative offset, projected per head in separable x and
y halves (geom_fc_x, geom_fc_y); the keys average-pooled by kv_stride; a
softmax over the keys, a 1x1 value and output projection, and a residual
scale `gamma` that starts at zero, so that the block is the identity at
init.

NCHW in and out. The energies are summed in the JAX module's order
([1], [3], [2], [4]) and each term keeps its broadcast shape: term [3]
is one row per head ([B, nh, 1, Nk]), term [4] one map for the batch, so
where no term varies along the queries (the empirical family's '0010')
the softmax runs on one row per head, whose values are the rows JAX's
[B, nh, Nq, Nk] energies repeat.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# the profiler range of the backbone's attention blocks (engine/two_stage.py STAGES)
ATTENTION_SPAN = "empirical_attention.gen_attention"


def _sin_embed(rel: np.ndarray, dim: int) -> np.ndarray:
    """Sinusoidal embedding of integer relative offsets -> [N, dim]
    (a copy of JAX models/attention.py:43-48)."""
    assert dim % 2 == 0
    freq = np.power(100.0, -np.arange(dim // 2) / max(dim // 2 - 1, 1))
    ang = rel[:, None] * freq[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


class GeneralizedAttention(nn.Module):
    """The block on [B, C, H, W] maps: num_heads heads of width
    d = max(C // num_heads, 4), so its projections have num_heads * d
    channels (GRoIE's 6 heads on 256 channels: 252), and proj_conv maps
    them back to C. The parameters the type needs only: query_conv with
    terms 1 or 2, key_conv with 1 or 3, key_bias [nh, d] with 3,
    geom_fc_x/y with 2 or 4, geom_bias [nh, d] with 4; value_conv,
    proj_conv and gamma always (the JAX module's tree)."""

    def __init__(self, in_channels: int, num_heads: int = 8, attention_type: str = "1111",
                 kv_stride: int = 2):
        super().__init__()
        if len(attention_type) != 4 or set(attention_type) - {"0", "1"}:
            raise ValueError(f"attention_type={attention_type!r}: four of '0' and '1'")
        c, nh = in_channels, num_heads
        self.num_heads, self.kv_stride = nh, kv_stride
        self.d = d = max(c // nh, 4)
        self.terms = [t == "1" for t in attention_type]
        t1, t2, t3, t4 = self.terms
        if t1 or t2:
            self.query_conv = nn.Conv2d(c, nh * d, 1, bias=False)
        if t1 or t3:
            self.key_conv = nn.Conv2d(c, nh * d, 1, bias=False)
        if t3:
            self.key_bias = nn.Parameter(torch.zeros(nh, d))
        if t2 or t4:
            self.geom_dim = min(d, 32) * 2
            self.geom_fc_x = nn.Linear(self.geom_dim, nh * d, bias=False)
            self.geom_fc_y = nn.Linear(self.geom_dim, nh * d, bias=False)
        if t4:
            self.geom_bias = nn.Parameter(torch.zeros(nh, d))
        self.value_conv = nn.Conv2d(c, nh * d, 1, bias=False)
        self.proj_conv = nn.Conv2d(nh * d, c, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX module's initialisers: LeCun-normal convs and geometry
        projections, a zero proj_conv bias, zero key_bias, geom_bias and
        gamma (the identity)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * fan_in ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
        for name in ("key_bias", "geom_bias", "gamma"):
            if hasattr(self, name):
                getattr(self, name).zero_()

    def _heads(self, v: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        """[B, C, H, W] -> [B, nh, H * W, d], positions row-major."""
        y = conv(v)
        b, _, h, w = y.shape
        return y.reshape(b, self.num_heads, self.d, h * w).transpose(2, 3)

    def _geometry(self, fc: nn.Linear, n: int, nk: int, device) -> torch.Tensor:
        """The projected embeddings of each (query, key) offset along one
        axis: [n, nk, nh, d], n queries, nk keys at kv_stride."""
        s = self.kv_stride
        rel = np.arange(-(n - 1), (nk - 1) * s + 1)
        emb = fc(torch.from_numpy(_sin_embed(rel, self.geom_dim)).to(device))
        idx = (np.arange(nk) * s)[None, :] - np.arange(n)[:, None] + (n - 1)
        return emb.reshape(-1, self.num_heads, self.d)[torch.from_numpy(idx).to(device)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        nh, d = self.num_heads, self.d
        t1, t2, t3, t4 = self.terms
        scale = 1.0 / np.sqrt(d)
        s = self.kv_stride
        xk = F.avg_pool2d(x, s, s) if s > 1 else x
        hk, wk = xk.shape[2:]
        nq, nk = h * w, hk * wk

        energy = None

        def add(term):
            nonlocal energy
            energy = term if energy is None else energy + term

        q = self._heads(x, self.query_conv) if (t1 or t2) else None
        if t1 or t3:
            k = self._heads(xk, self.key_conv)
            if t1:
                add(torch.matmul(q, k.transpose(2, 3)) * scale)
            if t3:
                add(torch.einsum("hd,bhkd->bhk", self.key_bias, k)[:, :, None, :])
        if t2 or t4:
            ex = self._geometry(self.geom_fc_x, w, wk, x.device)  # [w, wk, nh, d]
            ey = self._geometry(self.geom_fc_y, h, hk, x.device)  # [h, hk, nh, d]
            if t2:
                qm = q.reshape(b, nh, h, w, d)
                e_x = torch.einsum("bhywd,wkhd->bhywk", qm, ex) * scale
                e_y = torch.einsum("bhywd,ykhd->bhywk", qm, ey) * scale
                add((e_x[:, :, :, :, None, :] + e_y[:, :, :, :, :, None]).reshape(b, nh, nq, nk))
            if t4:
                bx = torch.einsum("hd,wkhd->hwk", self.geom_bias, ex)
                by = torch.einsum("hd,ykhd->hyk", self.geom_bias, ey)
                add((bx[:, None, :, None, :] + by[:, :, None, :, None]).reshape(1, nh, nq, nk))
        if energy is None:
            energy = torch.zeros((1, nh, 1, nk), dtype=x.dtype, device=x.device)
        attn = torch.softmax(energy.float(), dim=-1).to(x.dtype)
        out = torch.matmul(attn, self._heads(xk, self.value_conv))  # [B or 1, nh, 1 or Nq, d]
        out = out.expand(b, nh, nq, d).transpose(2, 3).reshape(b, nh * d, h, w)
        return x + self.gamma * self.proj_conv(out)
