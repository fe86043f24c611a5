"""Render configuration — the single source of truth.

The reference keeps three uncoordinated copies of the workload constants
(width/height/samples in src/common.h:4-6, scripts/gen_data.py:6-10 and
scripts/data_visualization.py:5-7, kept in sync by hand).  Here one frozen
dataclass is consumed by the camera, renderers, oracle, codec and benchmarks
alike, and sizes are runtime arguments rather than recompile-time constants.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Workload + algorithm configuration.

    Defaults reproduce the reference's shipped configuration
    (src/common.h:4-11, src/render.cpp:141).
    """

    width: int = 16
    height: int = 16
    #: Samples per sub-pixel; each pixel has a 2x2 sub-pixel grid, so the
    #: total sample count per pixel is ``4 * samples`` (common.h:6).
    samples: int = 1
    #: Fixed bounce count ("while depth < 5", render.cpp:141).
    bounces: int = 5
    #: Intersection epsilon (common.h:9).
    eps: float = 1e-4
    #: ``"reference"`` replicates the reference kernel semantics exactly
    #: (pure specular bounce, light-mask on the last sphere, final
    #: throughput x emission finalize, render.cpp:141-196).
    #: ``"pt"`` is the full physically-based smallpt estimator (diffuse /
    #: specular / refractive materials, Russian roulette, emission
    #: accumulated every bounce) — the BASELINE north-star mode.
    mode: str = "reference"
    #: Depth at which Russian roulette starts in ``"pt"`` mode.
    rr_depth: int = 5
    #: RNG seed. The reference seeds NumPy with 0 (gen_data.py:438).
    seed: int = 0
    scene: str = "cornell8"

    # ------------------------------------------------------------------
    @property
    def rays_per_pixel(self) -> int:
        return 4 * self.samples

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    @property
    def n_rays(self) -> int:
        """Primary ray count = W*H*4*samples (render.cpp:8 TOTAL_NUM)."""
        return self.width * self.height * 4 * self.samples

    def validate(self) -> "RenderConfig":
        if self.width < 1 or self.height < 1:
            raise ValueError("width/height must be positive")
        if self.samples < 1:
            raise ValueError("samples must be >= 1")
        if self.bounces < 1:
            raise ValueError("bounces must be >= 1")
        if self.mode not in ("reference", "pt"):
            raise ValueError(f"unknown mode {self.mode!r}")
        return self

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


#: The reference's shipped default (src/common.h:4-6).
REFERENCE_CONFIG = RenderConfig()

#: BASELINE.json config 1: Cornell 256x256, 4 spp, 4 bounces.
BASELINE_CONFIG_1 = RenderConfig(width=256, height=256, samples=1, bounces=4)

#: BASELINE.json config 2: 1024x1024, 64 spp, 8-bounce Russian roulette.
BASELINE_CONFIG_2 = RenderConfig(
    width=1024, height=1024, samples=16, bounces=8, mode="pt", rr_depth=5
)
