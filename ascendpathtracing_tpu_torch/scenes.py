"""Scene tables.

The reference hard-codes one 8-sphere Cornell-box variant in
scripts/gen_data.py:92-110 (a trimmed smallpt scene: the glass sphere is
dropped and wall colors changed; the original 9-sphere smallpt table is
quoted at gen_data.py:77-89).  Spheres are stored SoA with 10 members —
r^2, center xyz, emission xyz, color xyz (gen_data.py:94 comment,
src/common.h:11 SPHERE_MEMBER_NUM=10) — note **r^2, not r**
(gen_data.py:109).

Here scenes are data, not code: a registry of named scenes, each an SoA
struct usable from NumPy (oracle / IO) and JAX (renderers / gradients)
alike.  Materials are a first-class per-sphere attribute (the reference
kernel is specular-only, rt_helper.h:689-703; the ``"pt"`` mode needs
DIFF/SPEC/REFR like real smallpt).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

# Material codes (used by the "pt" renderers; ignored in "reference" mode).
DIFF = 0  # Lambertian
SPEC = 1  # perfect mirror
REFR = 2  # glass (dielectric, IOR 1.5)


@dataclasses.dataclass
class SphereScene:
    """SoA sphere scene.

    Arrays may be NumPy or JAX; renderers treat ``center``, ``emission``,
    ``color`` and ``radius`` as differentiable leaves (the differentiable
    pass of BASELINE config 4).
    """

    radius: np.ndarray  # [S]
    center: np.ndarray  # [S, 3]
    emission: np.ndarray  # [S, 3]
    color: np.ndarray  # [S, 3] (albedo)
    material: np.ndarray  # [S] int32, static (not differentiated)
    #: Index of the sphere used as the terminating light in "reference"
    #: mode (the reference hard-codes sphere 7, rt_helper.h:772-776).
    light_index: int = -1

    @property
    def n_spheres(self) -> int:
        return int(self.radius.shape[0])

    @property
    def r2(self) -> np.ndarray:
        """Squared radius — the on-disk / on-device layout (gen_data.py:109)."""
        return self.radius * self.radius

    def soa10(self, dtype=np.float32) -> np.ndarray:
        """[10, S] plane layout: r^2, x, y, z, ex, ey, ez, cx, cy, cz.

        This is the exact plane order of the reference's spheres.bin
        (gen_data.py:94 comment and :106-113) and of SphereLocalSoA
        (rt_helper.h:85-104).
        """
        planes = np.stack(
            [
                np.asarray(self.r2, dtype),
                np.asarray(self.center[:, 0], dtype),
                np.asarray(self.center[:, 1], dtype),
                np.asarray(self.center[:, 2], dtype),
                np.asarray(self.emission[:, 0], dtype),
                np.asarray(self.emission[:, 1], dtype),
                np.asarray(self.emission[:, 2], dtype),
                np.asarray(self.color[:, 0], dtype),
                np.asarray(self.color[:, 1], dtype),
                np.asarray(self.color[:, 2], dtype),
            ],
            axis=0,
        )
        return planes

    @staticmethod
    def from_soa10(planes: np.ndarray, *, materials=None, light_index=-1) -> "SphereScene":
        """Inverse of :meth:`soa10` (plane 0 is r^2)."""
        planes = np.asarray(planes, np.float32)
        s = planes.shape[1]
        mat = (
            np.asarray(materials, np.int32)
            if materials is not None
            else np.zeros((s,), np.int32)
        )
        return SphereScene(
            radius=np.sqrt(planes[0]),
            center=planes[1:4].T.copy(),
            emission=planes[4:7].T.copy(),
            color=planes[7:10].T.copy(),
            material=mat,
            light_index=light_index % s if light_index >= 0 else s + light_index,
        )

    def astype(self, dtype) -> "SphereScene":
        return SphereScene(
            radius=np.asarray(self.radius, dtype),
            center=np.asarray(self.center, dtype),
            emission=np.asarray(self.emission, dtype),
            color=np.asarray(self.color, dtype),
            material=np.asarray(self.material, np.int32),
            light_index=self.light_index,
        )


def _scene_from_rows(rows, materials, light_index) -> SphereScene:
    arr = np.asarray(rows, np.float64)
    return SphereScene(
        radius=arr[:, 0].copy(),
        center=arr[:, 1:4].copy(),
        emission=arr[:, 4:7].copy(),
        color=arr[:, 7:10].copy(),
        material=np.asarray(materials, np.int32),
        light_index=light_index % len(rows),
    )


def cornell8() -> SphereScene:
    """The reference's 8-sphere Cornell scene, row for row
    (gen_data.py:94-102: radius, center xyz, emission xyz, color xyz).
    Sphere 7 is the light (rt_helper.h:772-776)."""
    rows = [
        # radius,  x,        y,      z,        emission,    color
        [1e5, 1e5 + 1, 40.8, 81.6, 0, 0, 0, 0.435, 0.376, 0.667],  # left
        [1e5, -1e5 + 99, 40.8, 81.6, 0, 0, 0, 0.667, 0.129, 0.086],  # right
        [1e5, 50, 40.8, 1e5, 0, 0, 0, 0.270, 0.725, 0.486],  # back
        [1e5, 50, 40.8, -1e5 + 170, 0, 0, 0, 0, 0, 0],  # front (dark)
        [1e5, 50, 1e5, 81.6, 0, 0, 0, 0.5, 0.5, 0.5],  # bottom
        [1e5, 50, -1e5 + 81.6, 81.6, 0, 0, 0, 0.141, 0.408, 0.635],  # top
        [16.5, 27, 16.5, 47, 0, 0, 0, 0.999, 0.999, 0.999],  # mirror
        [600, 50, 681.6 - 0.27, 81.6, 12, 12, 12, 0, 0, 0],  # light
    ]
    mats = [DIFF, DIFF, DIFF, DIFF, DIFF, DIFF, SPEC, DIFF]
    return _scene_from_rows(rows, mats, light_index=7)


def smallpt9() -> SphereScene:
    """The original 9-sphere smallpt Cornell box (quoted verbatim in the
    reference at gen_data.py:77-89), including the glass sphere — used by
    the full ``"pt"`` mode."""
    rows = [
        [1e5, 1e5 + 1, 40.8, 81.6, 0, 0, 0, 0.75, 0.25, 0.25],  # left
        [1e5, -1e5 + 99, 40.8, 81.6, 0, 0, 0, 0.25, 0.25, 0.75],  # right
        [1e5, 50, 40.8, 1e5, 0, 0, 0, 0.75, 0.75, 0.75],  # back
        [1e5, 50, 40.8, -1e5 + 170, 0, 0, 0, 0, 0, 0],  # front
        [1e5, 50, 1e5, 81.6, 0, 0, 0, 0.75, 0.75, 0.75],  # bottom
        [1e5, 50, -1e5 + 81.6, 81.6, 0, 0, 0, 0.75, 0.75, 0.75],  # top
        [16.5, 27, 16.5, 47, 0, 0, 0, 0.999, 0.999, 0.999],  # mirror
        [16.5, 73, 16.5, 78, 0, 0, 0, 0.999, 0.999, 0.999],  # glass
        [600, 50, 681.6 - 0.27, 81.6, 12, 12, 12, 0, 0, 0],  # light
    ]
    mats = [DIFF, DIFF, DIFF, DIFF, DIFF, DIFF, SPEC, REFR, DIFF]
    return _scene_from_rows(rows, mats, light_index=8)


def cornell_smalllight() -> SphereScene:
    """Cornell walls with a SMALL spherical light (r=10 under the
    ceiling). The classic hard case for pure BSDF sampling — used to
    demonstrate/verify the variance reduction of next-event estimation
    (the stock scenes' r=600 light subtends almost a hemisphere, where
    NEE cannot help)."""
    rows = [
        [1e5, 1e5 + 1, 40.8, 81.6, 0, 0, 0, 0.75, 0.25, 0.25],
        [1e5, -1e5 + 99, 40.8, 81.6, 0, 0, 0, 0.25, 0.25, 0.75],
        [1e5, 50, 40.8, 1e5, 0, 0, 0, 0.75, 0.75, 0.75],
        [1e5, 50, 40.8, -1e5 + 170, 0, 0, 0, 0, 0, 0],
        [1e5, 50, 1e5, 81.6, 0, 0, 0, 0.75, 0.75, 0.75],
        [1e5, 50, -1e5 + 81.6, 81.6, 0, 0, 0, 0.75, 0.75, 0.75],
        [16.5, 27, 16.5, 47, 0, 0, 0, 0.999, 0.999, 0.999],
        [10, 50, 68, 81.6, 60, 60, 60, 0, 0, 0],  # small bright light
    ]
    mats = [DIFF, DIFF, DIFF, DIFF, DIFF, DIFF, SPEC, DIFF]
    return _scene_from_rows(rows, mats, light_index=7)


_REGISTRY: Dict[str, callable] = {
    "cornell8": cornell8,
    "smallpt9": smallpt9,
    "cornell-smalllight": cornell_smalllight,
}


def get_scene(name: str) -> SphereScene:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown scene {name!r}; known: {sorted(_REGISTRY)}") from None


def register_scene(name: str, factory) -> None:
    _REGISTRY[name] = factory
