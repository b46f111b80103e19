"""Standard-normal draws that stay the same when a batch is split over ranks.

A sampler draws its noise from a ``torch.Generator``. A rank that drew only
its own rows would draw other numbers than one process drawing the whole
batch. :class:`RowDraws` makes every draw at the whole batch (the rank's
rows times ``parts``) from the same generator, in the same order, on every
rank, and keeps this rank's block of rows, so rank r of n gets exactly rows
[r b, (r + 1) b) of what one process would draw. :func:`normal` is the
samplers' one call for a draw, from a plain generator or from a
:class:`RowDraws`.
"""

from __future__ import annotations

import torch


class RowDraws:
    """``generator``'s draws of the whole batch, cut to block ``index`` of
    ``parts`` equal blocks of rows."""

    def __init__(self, generator: torch.Generator, index: int, parts: int):
        self.generator = generator
        self.index = index
        self.parts = parts


def normal(shape, generator=None, device=None, dtype=None) -> torch.Tensor:
    """``torch.randn(shape)`` from ``generator`` (None, a generator or a
    :class:`RowDraws`, where ``shape[0]`` is this rank's rows)."""
    if isinstance(generator, RowDraws):
        b = shape[0]
        full = torch.randn((b * generator.parts, *shape[1:]), generator=generator.generator,
                           device=device, dtype=dtype)
        return full[generator.index * b:(generator.index + 1) * b]
    return torch.randn(shape, generator=generator, device=device, dtype=dtype)
