"""Ordinal embedders: the additive (AOE) and the basic (BOE).

Counterpart of `psd_tpu/conditioning/ordinal.py`. AdditiveOrdinalEmbedder
(inference and training):
  * class table E[k] = base + cumsum(deltas)[:k];
  * continuous labels interpolate linearly between rows, clamped to [0, K−1];
  * projector MLP D → 2D → GELU → D·T, reshaped to T tokens;
  * `negative`: the smooth negative embedding at clamp(1−y, 0, 1);
  * `ordinal_delta`: proj(E[target]) − proj(E[source]), exactly zero when
    the labels are equal;
  * `embedding_stats`: the class table's and the deltas' statistics, which
    the training CLI logs;
  * in training, Gaussian regularization noise of std `NOISE_STD` = 0.005
    on the interpolated embedding before the projector
    (`psd_tpu/conditioning/ordinal.py:106-109`). The caller draws the N(0, 1)
    values from its torch.Generator and passes them in, so a test can hand
    the port the values JAX drew.
BasicOrdinalEmbedder: a learnable (K, D) class table, interpolated the same
way, (B,) → (B, D), with the same training noise. As in psd_tpu it has no
`negative` and no `ordinal_delta`, so classifier-free guidance and routing
gates need the AOE (`DADDCore.prepare_conditioning` raises for either).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.geglu import gelu_exact


def interp_table(table: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of rows of a (K, D) table at float labels (B,)."""
    K = table.shape[0]
    y = labels.to(table.dtype).clamp(0.0, float(K - 1))
    lower = torch.floor(y)
    upper = torch.clamp(lower + 1, max=K - 1).long()
    alpha = (y - lower)[:, None]
    return table[lower.long()] * (1.0 - alpha) + table[upper] * alpha


class AdditiveOrdinalEmbedder(nn.Module):
    NOISE_STD = 0.005

    def __init__(self, num_classes: int = 4, embedding_dim: int = 768,
                 init_std: float = 0.02, delta_scale: float = 0.1, num_tokens: int = 16):
        super().__init__()
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2 for ordinal modeling.")
        D, K = embedding_dim, num_classes
        self.num_classes, self.embedding_dim, self.num_tokens = K, D, num_tokens
        self.init_std, self.delta_scale = init_std, delta_scale
        self.base = nn.Parameter(torch.zeros(D))
        self.deltas = nn.Parameter(torch.zeros(K - 1, D))
        self.null_embedding = nn.Parameter(torch.zeros(1, D))
        self.projector_0 = nn.Linear(D, 2 * D)
        self.projector_2 = nn.Linear(2 * D, D * num_tokens)

    @torch.no_grad()
    def reset_flax_(self, generator: torch.Generator):
        """The flax init: base ~ N(0, init_std); deltas row i ~
        (delta_scale + N(0, init_std))·(1 + 0.1·i) (monotonic); null zero."""
        g = generator
        self.base.normal_(0.0, self.init_std, generator=g)
        noise = torch.empty_like(self.deltas).normal_(0.0, self.init_std, generator=g)
        i = torch.arange(self.num_classes - 1, dtype=self.deltas.dtype,
                         device=self.deltas.device)[:, None]
        self.deltas.copy_((self.delta_scale + noise) * (1.0 + 0.1 * i))
        self.null_embedding.zero_()

    def class_table(self) -> torch.Tensor:
        offsets = torch.cat([torch.zeros_like(self.deltas[:1]),
                             torch.cumsum(self.deltas, dim=0)])
        return self.base[None, :] + offsets

    def _project(self, emb):
        h = gelu_exact(self.projector_0(emb))
        return self.projector_2(h).reshape(-1, self.num_tokens, self.embedding_dim)

    def forward(self, labels: torch.Tensor, noise=None) -> torch.Tensor:
        """labels (B,) float in [0, K−1] → (B, T, D) fp32. `noise` (B, D)
        N(0, 1), given in training only, is added at std `NOISE_STD`."""
        out = interp_table(self.class_table(), labels)
        if noise is not None:
            out = out + self.NOISE_STD * noise
        return self._project(out)

    def negative(self, labels: torch.Tensor, noise=None) -> torch.Tensor:
        return self(torch.clamp(1.0 - labels, 0.0, 1.0), noise)

    def ordinal_delta(self, source_labels, target_labels):
        table = self.class_table()
        return (self._project(interp_table(table, target_labels))
                - self._project(interp_table(table, source_labels)))

    @torch.no_grad()
    def embedding_stats(self) -> dict:
        """The table's mean, std, min, max and mean row norm, the base's
        norm and the deltas' mean and std (population std, as jnp's), 0-d
        fp32 tensors keyed as psd_tpu logs them."""
        table = self.class_table()
        return {
            "embed/mean": table.mean(),
            "embed/std": table.std(unbiased=False),
            "embed/min": table.min(),
            "embed/max": table.max(),
            "embed/norm": torch.linalg.vector_norm(table, dim=-1).mean(),
            "embed/base_norm": torch.linalg.vector_norm(self.base),
            "embed/delta_mean": self.deltas.mean(),
            "embed/delta_std": self.deltas.std(unbiased=False),
        }


class BasicOrdinalEmbedder(nn.Module):
    """BOE (psd_tpu/conditioning/ordinal.py:143-178): table interpolation,
    (B,) → (B, D) fp32; `noise` (B, D) N(0, 1), in training only, is added
    at std `NOISE_STD`."""

    NOISE_STD = 0.005

    def __init__(self, num_classes: int = 4, embedding_dim: int = 768, init_std: float = 0.02):
        super().__init__()
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2 for ordinal modeling.")
        self.init_std = init_std
        self.table = nn.Parameter(torch.zeros(num_classes, embedding_dim))
        self.null_embedding = nn.Parameter(torch.zeros(1, embedding_dim))

    @torch.no_grad()
    def reset_flax_(self, generator: torch.Generator):
        """The flax init: table ~ N(0, init_std); null zero."""
        self.table.normal_(0.0, self.init_std, generator=generator)
        self.null_embedding.zero_()

    def forward(self, labels: torch.Tensor, noise=None) -> torch.Tensor:
        out = interp_table(self.table, labels)
        if noise is not None:
            out = out + self.NOISE_STD * noise
        return out
