"""The plain reference (``pathtracer.py``) with a ``max_segments`` render
key: a wavefront cut after that many bounce segments, in place of the
default ``2 * max_depth + 2``. Specular and refraction bounces give their
depth back, so a glass scene's chains end by Russian roulette or at this
cap (the program's ``RenderConfig.max_segments``). Everything else is
``pathtracer.py``'s; like it, this file imports nothing of the program."""

from __future__ import annotations

import dataclasses

from . import pathtracer


@dataclasses.dataclass
class Config(pathtracer.Config):
    max_segments: int | None = None

    @property
    def n_segments(self):
        if self.max_segments is not None:
            return self.max_segments
        return 2 * self.max_depth + 2

    @classmethod
    def of(cls, render: dict, seed: int, prec: str = "fp32") -> "Config":
        """As ``pathtracer.Config.of``, which refuses a key that the
        reference does not implement; ``max_segments`` is implemented
        here."""
        rest = {k: v for k, v in render.items() if k != "max_segments"}
        base = pathtracer.Config.of(rest, seed, prec)
        return cls(**vars(base), max_segments=render.get("max_segments"))
