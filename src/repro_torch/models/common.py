"""Shared model-building blocks: the generator splitter, the dense
initializer and the RMS norm (the GNN and recsys helpers wait for their
slice)."""
from __future__ import annotations

import torch

__all__ = ["Split", "dense_init", "rms_norm"]


class Split:
    """Deterministic generator splitter over an explicit
    :class:`torch.Generator`: ``Split(gen)()`` yields a fresh generator on
    ``gen``'s device, seeded from ``gen``'s stream, so each draw is
    independent of how many numbers the others take."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def __call__(self) -> torch.Generator:
        seed = int(torch.randint(0, 2**62, (1,), generator=self.gen,
                                 device=self.gen.device))
        return torch.Generator(device=self.gen.device).manual_seed(seed)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               scale: float | None = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[d_in, d_out]`` standard normals times ``scale`` (default
    ``1/sqrt(d_in)``), drawn in float32 on ``gen``'s device and cast to
    ``dtype``."""
    s = scale if scale is not None else 1.0 / d_in ** 0.5
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device)
    return (w * s).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMS norm over the last axis in float32; output in ``x.dtype``."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)
