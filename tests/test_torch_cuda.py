"""The port's tests that need a CUDA card: each hand-written kernel against
its plain twin on the card, the wrappers' launch counts, and the
determinism of the segment-sum.  They skip where torch.cuda.is_available()
is false.

This file imports torch, numpy, pytest and the port only (no jax and
nothing of the JAX package), so that it runs on a machine without jax:

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest`` keeps ``tests/conftest.py``, which imports jax, out of
the run; ``chip_smoke.py`` runs exactly this command on the card)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ascendpathtracing_tpu_torch import camera, cli, convert, scenes
from ascendpathtracing_tpu_torch.accel import bvh as bvh_mod
from ascendpathtracing_tpu_torch.accel import meshes, tri
from ascendpathtracing_tpu_torch.diff import camera_fused as dcf
from ascendpathtracing_tpu_torch.diff import mesh_fused as mf
from ascendpathtracing_tpu_torch.diff.camera import CameraParams
from ascendpathtracing_tpu_torch.models import megakernel
from ascendpathtracing_tpu_torch.models import mesh as mm
from ascendpathtracing_tpu_torch.models import wavefront as wf
from ascendpathtracing_tpu_torch.ops import bvh_kernels as bk
from ascendpathtracing_tpu_torch.ops import chunk_grid as cg
from ascendpathtracing_tpu_torch.ops import histogram_kernels as hk
from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt
from ascendpathtracing_tpu_torch.ops import pt_kernels as ptk
from ascendpathtracing_tpu_torch.ops import render_kernels as rk
from ascendpathtracing_tpu_torch.ops import replay_kernels as rpk
from ascendpathtracing_tpu_torch.ops import wbvh_kernels as wk
from tests import test_torch_ref_reduce_order as rro

LIGHT = 7  # cornell8's light
REPO = Path(__file__).resolve().parents[1]
TRAVERSALS = [  # (subdivisions, tris_per_chunk, supers_per, supers2_per)
    (2, 8, 0, 0),
    (2, 8, 4, 0),
    (3, 8, 4, 4),
    (2, 8, 4, 8),  # ragged super-supers: pad chunks take part in the walk
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------- inputs ----
def _random_rays(n, seed=0, spread=3.0):
    """[6, N] float32 rays, origins ~N(0, spread^2), unit directions."""
    rng = np.random.RandomState(seed)
    o = (rng.randn(n, 3) * spread).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([o, d], 1).T.copy()


def _aimed_rays(n, seed=1):
    """[6, N] float32 rays from radius 3 aimed into the unit ball."""
    rng = np.random.RandomState(seed)
    o = rng.randn(3, n)
    o = (o / np.linalg.norm(o, axis=0) * 3.0).astype(np.float32)
    d = rng.uniform(-0.6, 0.6, (3, n)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=0)
    return np.concatenate([o, d], 0).astype(np.float32)


def _sphere_rays(n=2048, seed=1):
    """[6, N] float32 rays from radius 3: half in random directions, half
    aimed at random points inside the unit ball."""
    rng = np.random.RandomState(seed)
    o = rng.randn(3, n).astype(np.float32)
    o /= np.linalg.norm(o, axis=0)
    o *= 3.0
    d = rng.randn(3, n).astype(np.float32)
    target = rng.uniform(-0.55, 0.55, (3, n // 2)).astype(np.float32)
    d[:, n // 2:] = target - o[:, n // 2:]
    d /= np.linalg.norm(d, axis=0)
    return np.concatenate([o, d], 0)


def _pt_scene(name, dtype, device):
    sc = scenes.get_scene(name)
    return (convert.scene_planes_from_numpy(sc.soa10(np.float64), device=device, dtype=dtype),
            torch.tensor(sc.material, dtype=torch.int32, device=device))


def _reference_inputs(w, np_dt, device):
    """Camera rays and cornell8's planes as the port's tensors."""
    t_dt = torch.float64 if np_dt == np.float64 else torch.float32
    rays = camera.generate_rays_numpy(w, w, 1, seed=0).astype(np_dt)
    return (convert.rays_planes_from_numpy(rays, device=device, dtype=t_dt),
            convert.scene_planes_from_numpy(scenes.cornell8().soa10(np_dt), device=device,
                                            dtype=t_dt))


def _reference_scene(s, light, seed=0):
    """[10, S] float64 planes of S spheres with cornell8's light at column
    ``light`` and, in order, cornell8's six walls and mirror ball, then
    balls of radius 3-10 inside the room (albedo 0.2-0.95, no emission):
    S = 8 with the light at 7 is cornell8."""
    base = scenes.cornell8().soa10(np.float64)
    cols = [base[:, i] for i in range(base.shape[1]) if i != LIGHT]
    rng = np.random.RandomState(seed + 100 * s + light)
    while len(cols) < s - 1:
        col = np.zeros(10)
        col[0] = rng.uniform(3.0, 10.0) ** 2
        col[1:4] = rng.uniform((15.0, 8.0, 20.0), (85.0, 70.0, 120.0))
        col[7:10] = rng.uniform(0.2, 0.95, 3)
        cols.append(col)
    cols = cols[: s - 1]
    cols.insert(light, base[:, LIGHT])
    return np.stack(cols, axis=1)


def _reference_case(s, light, n, dtype, device, seed=0):
    """n of the 64 x 64 x 4 camera rays (all of them, or a seeded choice)
    and :func:`_reference_scene` as the port's tensors in ``dtype``."""
    rays = camera.generate_rays_numpy(64, 64, 1, seed=seed)
    if n < rays.shape[0]:
        rays = rays[np.sort(np.random.RandomState(n).choice(rays.shape[0], n, replace=False))]
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    return (convert.rays_planes_from_numpy(rays.astype(np_dt), device=device, dtype=dtype),
            convert.scene_planes_from_numpy(_reference_scene(s, light).astype(np_dt),
                                            device=device, dtype=dtype))


def _check_reference_kernels(rp, sp, light, bounces, eps=1e-4):
    """Both forward kernels bitwise equal to the twin (colors, NaN equal
    to NaN, and idx) and to each other; both backward kernels within
    chip_smoke phase 5's rtol of their twins on a positive cotangent, and
    equal bit for bit to their own second run.  Returns (colors, idx)."""
    kw = dict(light_index=light, bounces=bounces, eps=eps)
    exact = dict(rtol=0, atol=0, equal_nan=True)
    c, idx = rk.render_reference_planes_with_idx(rp, sp, **kw)
    cp, idxp = rk.render_reference_planes_with_idx_plain(rp, sp, **kw)
    assert torch.equal(idx, idxp)
    torch.testing.assert_close(c, cp, **exact)
    torch.testing.assert_close(rk.render_reference_planes(rp, sp, **kw), c, **exact)
    n = rp.shape[1]
    g = torch.tensor(np.random.RandomState(n).uniform(0.5, 1.5, (3, n)), dtype=sp.dtype,
                     device=sp.device)
    rtol = 1e-5 if sp.dtype == torch.float32 else 1e-12
    kw_b = dict(light_index=light, bounces=bounces)
    pairs = ((lambda: rk.render_ref_bwd_replay(idx, sp, g, **kw_b),
              rk.render_ref_bwd_replay_plain(idx, sp, g, **kw_b)),
             (lambda: rk.render_ref_bwd(rp, sp, g, eps=eps, **kw_b),
              rk.render_ref_bwd_plain(rp, sp, g, eps=eps, **kw_b)))
    for kernel, plain in pairs:
        got = kernel()
        torch.testing.assert_close(got, plain, rtol=rtol, atol=0, equal_nan=True)
        torch.testing.assert_close(kernel(), got, **exact)
    return c, idx


def _clustered(n, s, r):
    """Clustered ids (the replay stream's shape), 1% -1 and 1% s + 7."""
    rng = np.random.RandomState(n + s)
    seg = (rng.randint(0, 20, n) * (s // 20) + rng.randint(0, s // 40, n)).astype(np.int32)
    seg[: n // 100] = -1
    seg[n // 100: n // 50] = s + 7
    return seg, rng.randn(r, n).astype(np.float32)


def _mixed_scene(subdivisions=2):
    """The JAX fused-kernel tests' scene: an icosphere in smallpt9, a third
    of the faces mirrors, a sixth glass, four emissive."""
    v, f = meshes.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=subdivisions)
    ms = mm.MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2), base_scene="smallpt9")
    nf = ms.faces.shape[0]
    ms.face_material[: nf // 3] = scenes.SPEC
    ms.face_material[nf // 3: nf // 2] = scenes.REFR
    ms.face_emission[:4] = (0.0, 2.0, 0.5)
    return ms


def _replay_residuals(bounces, spp4, pix, dtype, device, seed=0, dead="zeros"):
    """Residuals in the fused mesh forward's layout, ``wid`` int32 [B,
    spp4, P] and ``resv`` [B, 7, spp4, P], and a cotangent ``g`` [3, P]
    of both signs: winners among 9 spheres and 40 slots; each path dies
    at a random depth and stays dead (-1); about one live bounce in eight
    hits a light (emission up to 4, else 0) and one in five is glass (s
    from 1.1 to 10, else 1).  Dead bounces hold zeros, as the forward
    writes them, or with ``dead="random"`` the random residuals."""
    gen = torch.Generator().manual_seed(seed)
    shape = (bounces, spp4, pix)
    depth = torch.randint(0, bounces + 1, (spp4, pix), generator=gen)
    wid = torch.randint(0, 49, shape, generator=gen, dtype=torch.int32)
    dead_at = torch.arange(bounces)[:, None, None] >= depth
    wid[dead_at] = -1
    resv = torch.rand((bounces, 7) + shape[1:], generator=gen, dtype=torch.float64)
    light = torch.rand(shape, generator=gen) < 0.125
    resv[:, 3:6] *= 4.0 * light[:, None]
    glass = torch.rand(shape, generator=gen) < 0.2
    resv[:, 6] = torch.where(glass, 1.0 / (0.1 + 0.8 * resv[:, 6]), 1.0)
    if dead == "zeros":
        resv *= ~dead_at[:, None]
    g = torch.randn((3, pix), generator=gen, dtype=torch.float64)
    return wid.to(device), resv.to(dtype=dtype, device=device), g.to(dtype=dtype, device=device)


def _bits(t):
    """A float tensor's bits, as integers of its width."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _tie_mesh(subdivisions=0, copies=3):
    """An icosphere in the smallpt room whose every face is listed
    ``copies`` times, the copies far apart in the face list, so that the
    chunk grid's stable median split puts them in neighbouring chunks
    (and supers): a ray that hits a face hits its copies at the same t."""
    v, f = meshes.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=subdivisions)
    return v, np.concatenate([f] * copies, 0)


def _layer_stack(layers=64):
    """``layers`` square plates (two triangles each) facing the default
    camera, 1 unit apart in z: a camera ray through the stack enters every
    plate's box."""
    x0, x1, y0, y1 = 20.0, 80.0, 15.0, 70.0
    v, f = [], []
    for i in range(layers):
        z = 40.0 + i
        b = len(v)
        v += [(x0, y0, z), (x1, y0, z), (x1, y1, z), (x0, y1, z)]
        f += [(b, b + 1, b + 2), (b, b + 2, b + 3)]
    return np.asarray(v, np.float64), np.asarray(f, np.int64)


def _permuted_stack(layers, seed):
    """:func:`_layer_stack` with its faces in a seeded order (so a ray's
    nearest plate sits at any slot of its chunk) -> (v, f, plate of each
    face row)."""
    v, f = _layer_stack(layers)
    perm = np.random.RandomState(seed).permutation(f.shape[0])
    return v, f[perm], perm // 2


def _rays_through_the_stack(n, seed, dtype, device):
    """[6, n] rays along the stack's axis, half from z = 200 down and half
    from z = -100 up, their x and y spread over the plates' square and
    past its edges, tilted by up to 0.01: a ray through the square meets
    every plate, each at its own t."""
    rng = np.random.RandomState(seed)
    o = np.stack([rng.uniform(10.0, 90.0, n), rng.uniform(5.0, 80.0, n),
                  np.where(np.arange(n) % 2 == 0, 200.0, -100.0)])
    d = np.stack([rng.uniform(-0.01, 0.01, n), rng.uniform(-0.01, 0.01, n),
                  np.where(np.arange(n) % 2 == 0, -1.0, 1.0)])
    d /= np.linalg.norm(d, axis=0)
    return torch.tensor(np.concatenate([o, d]), dtype=dtype, device=device)


# ------------------------------------------------ reference kernels ----
@pytest.mark.cuda
@pytest.mark.parametrize("np_dt", [np.float32, np.float64])
def test_render_kernels_match_plain_twins(cuda, np_dt):
    rp, sp = _reference_inputs(64, np_dt, cuda)
    kw = dict(light_index=LIGHT, bounces=8)
    c, idx = rk.render_reference_planes_with_idx(rp, sp, **kw)
    cp, idxp = rk.render_reference_planes_with_idx_plain(rp, sp, **kw)
    assert torch.equal(idx, idxp) and torch.equal(c, cp)
    assert torch.equal(rk.render_reference_planes(rp, sp, **kw), c)
    n = rp.shape[1]
    g = torch.arange(3 * n, device=cuda, dtype=sp.dtype).reshape(3, n)
    rtol = 1e-5 if np_dt == np.float32 else 1e-12
    plain = rk.render_ref_bwd_replay_plain(idx, sp, g, **kw)
    for got in (rk.render_ref_bwd_replay(idx, sp, g, **kw), rk.render_ref_bwd(rp, sp, g, **kw)):
        torch.testing.assert_close(got, plain, rtol=rtol, atol=0.0)


@pytest.mark.cuda
def test_render_wrapper_counts_launches(cuda):
    rp, sp = _reference_inputs(16, np.float32, cuda)
    rk.reset_launches()
    model = rk.RenderReference(sp, light_index=LIGHT, bounces=8)
    model(rp).sum().backward()
    assert rk.LAUNCHES == {"fwd": 0, "fwd_idx": 1, "bwd_replay": 1, "bwd_recompute": 0}


# (S, light): every S the launchers dispatch to a kernel of its own is
# represented at its edges, the light first and last; S = 8 with the light
# at 7 is cornell8.
REF_SCENES = [(1, 0), (2, 0), (2, 1), (8, 0), (8, 7), (9, 0), (9, 8), (16, 0), (16, 15)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,light", REF_SCENES)
@pytest.mark.parametrize("bounces", [0, 1, 8])
@pytest.mark.parametrize("n", [1, 31, 257, 64 * 64 * 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reference_kernels_equal_twins_at_each_sphere_count(cuda, s, light, bounces, n, dtype):
    rp, sp = _reference_case(s, light, n, dtype, cuda)
    _check_reference_kernels(rp, sp, light, bounces)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reference_kernels_give_a_tie_to_the_lowest_index(cuda, dtype):
    rp, sp = _reference_case(9, 8, 64 * 64 * 4, dtype, cuda)
    sp[:, 7] = sp[:, 6]  # the mirror ball twice: every ray that hits it ties
    _, idx = _check_reference_kernels(rp, sp, 8, 8)
    assert bool((idx == 6).any()) and not bool((idx == 7).any())


@pytest.mark.cuda
@pytest.mark.parametrize("light", [0, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reference_kernels_on_rays_that_miss_every_sphere(cuda, light, dtype):
    """Three balls behind the camera: every camera ray misses them (idx ==
    S), takes the last sphere's shading and never ends on the light.  In
    float64 a missed ray goes on from 1e20 away, where some later meet a
    ball further than the miss distance: a miss, whose bounce takes that
    distance, as the twin's argmin."""
    rp, sp = _reference_case(3, light, 257, dtype, cuda)
    sp[0, :] = 25.0
    sp[1:4, :] = torch.tensor([[20.0, 50.0, 80.0], [40.0] * 3, [900.0] * 3], dtype=dtype)
    c, idx = _check_reference_kernels(rp, sp, light, 8)
    assert bool((idx[0] == 3).all()) and bool(torch.isfinite(c).all())


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [0.0, -1e-3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reference_kernels_with_eps_at_or_below_zero(cuda, eps, dtype):
    rp, sp = _reference_case(8, 7, 64 * 64 * 4, dtype, cuda)
    _check_reference_kernels(rp, sp, 7, 8, eps=eps)


@pytest.mark.cuda
@pytest.mark.parametrize("plane,sphere,value", [(7, 6, float("nan")), (8, 2, float("nan")),
                                                (4, 7, float("inf")), (5, 7, float("-inf"))])
@pytest.mark.parametrize("n", [257, 64 * 64 * 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reference_kernels_on_a_nan_albedo_or_an_infinite_emission(cuda, plane, sphere, value,
                                                                   n, dtype):
    rp, sp = _reference_case(8, 7, n, dtype, cuda)
    sp[plane, sphere] = value
    _check_reference_kernels(rp, sp, 7, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reference_backwards_ignore_the_last_block_s_idle_threads(cuda, n, dtype):
    """One sphere, the light, far off every camera ray, with an albedo
    and an infinite emission: every ray misses it, stays alive and takes
    its albedo, so each ray's albedo term is finite times inf.  The
    twin's albedo gradient is inf; threads past N must add nothing to it
    (inf times their zero accumulators would be NaN)."""
    rp, sp = _reference_case(1, 0, n, dtype, cuda)
    sp[:, 0] = torch.tensor([25.0, 5000.0, 40.0, 900.0, float("inf"), 1.0, 1.0, 0.5, 0.5, 0.5],
                            dtype=dtype)
    c, idx = _check_reference_kernels(rp, sp, 0, 1)
    assert bool((idx == 1).all())
    grad = rk.render_ref_bwd_replay(idx, sp, torch.ones_like(c), light_index=0, bounces=1)
    assert bool(torch.isinf(grad[7, 0])) and bool(torch.isfinite(grad[8:10, 0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("s", range(1, rk.MAX_S + 1))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reference_kernels_at_every_sphere_count(cuda, s, dtype):
    """Every sphere count the launchers dispatch to a kernel of its own,
    each of the four kernels launched once per run: forwards bitwise,
    backwards within rtol of the twins and twice bitwise."""
    light = (s - 1) // 2
    rp, sp = _reference_case(s, light, 257, dtype, cuda)
    rk.reset_launches()
    _check_reference_kernels(rp, sp, light, 3)
    assert rk.LAUNCHES == {"fwd": 1, "fwd_idx": 1, "bwd_replay": 2, "bwd_recompute": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["inf_cotangent", "nan_albedo_off_the_path",
                                  "inf_albedo_on_the_path"])
@pytest.mark.parametrize("s", [3, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_replay_zero_and_one_times_tput_equal_the_twin(cuda, case, s, dtype):
    """The replay on winners drawn at random (misses and light hits
    among them), against the twin's pick * tput: an infinite cotangent
    (inf times a zero accumulator is NaN); a NaN albedo on a sphere no
    path takes (finite gradients); an infinite albedo on the paths, where
    0 * tput is NaN for every accumulator that is not picked."""
    rng = np.random.RandomState(s)
    n, bounces, light = 1000, 5, s - 1
    ids = rng.randint(0, s + 1, (bounces, n))
    scene = _reference_scene(s, light)
    g = rng.uniform(0.5, 1.5, (3, n))
    if case == "inf_cotangent":
        g[:, ::7] = np.inf
        g[1, ::11] = -np.inf
    elif case == "nan_albedo_off_the_path":
        off = 1 if s > 2 else 0
        ids[ids == off] = s  # a miss: the last sphere's albedo
        scene[7:10, off] = np.nan
    else:
        scene[8, 0] = np.inf
    idx = torch.tensor(ids, dtype=torch.int32, device=cuda)
    sp = torch.tensor(scene, dtype=dtype, device=cuda)
    g = torch.tensor(g, dtype=dtype, device=cuda)
    kw = dict(light_index=light, bounces=bounces)
    got = rk.render_ref_bwd_replay(idx, sp, g, **kw)
    plain = rk.render_ref_bwd_replay_plain(idx, sp, g, **kw)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got, plain, rtol=rtol, atol=0, equal_nan=True)
    torch.testing.assert_close(rk.render_ref_bwd_replay(idx, sp, g, **kw), got, rtol=0, atol=0,
                               equal_nan=True)
    assert bool(torch.isfinite(got).all()) == (case == "nan_albedo_off_the_path")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["wide_range", "signed_zeros"])
@pytest.mark.parametrize("s,bounces", rro.CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_replay_sums_in_the_modelled_order_bitwise(cuda, kind, s, bounces, dtype):
    """The replay's gradient equals bit for bit the twin's per-ray terms
    summed in the order test_torch_ref_reduce_order models (shfl_down warp
    tree, warps in order, strided rows and a halving tree), on cotangents
    of either sign over twelve decades, where another order shows."""
    idx, sp, g, light = rro.replay_case(s, bounces, dtype, cuda, kind=kind)
    kw = dict(light_index=light, bounces=bounces)
    got = rk.render_ref_bwd_replay(idx, sp, g, **kw)
    want = rro.ordered_replay_grad(*rk.replay_terms_plain(idx, sp, g, **kw), light)
    assert _bits_equal(got, want), (got - want).abs().max()


@pytest.mark.cuda
def test_cli_render_matches_oracle(cuda, tmp_path, capsys):
    assert cli.main(["render", "--backend", "cuda", "--width", "64", "--height",
                     "64", "--bounces", "1", "--oracle", "--out", str(tmp_path)]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["backend"] == "cuda" and stats["oracle_rays_bitexact"] == 1.0


# ------------------------------------------------ fused path tracer ----
@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell8", "smallpt9"])
def test_pt_kernel_matches_twin_f64(cuda, name):
    planes, mats = _pt_scene(name, torch.float64, cuda)
    kw = dict(width=64, height=64, spp4=16, bounces=8, rr_depth=5)
    torch.testing.assert_close(ptk.render_pt(planes, mats, **kw),
                               ptk.render_pt_plain(planes, mats, **kw), rtol=1e-9, atol=0)


@pytest.mark.cuda
def test_pt_kernel_matches_twin_f32_and_counts(cuda):
    planes, mats = _pt_scene("cornell8", torch.float32, cuda)
    kw = dict(width=48, height=40, spp4=8, bounces=8, rr_depth=5)
    ptk.reset_launches()
    k = ptk.render_pt(planes, mats, **kw)
    assert ptk.LAUNCHES == {"pt": 1}
    p = ptk.render_pt_plain(planes, mats, **kw)
    assert float(((k - p).abs() <= 1e-5 * p.abs()).float().mean()) >= 0.999


def _bits_equal(a, b):
    """Equal bit for bit, NaNs equal wherever both are NaN (a NaN's
    payload is left to the arithmetic)."""
    return a.dtype == b.dtype and bool(
        ((a == b) & (torch.signbit(a) == torch.signbit(b)) | (a.isnan() & b.isnan())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell8", "smallpt9"])
@pytest.mark.parametrize("size", [(33, 17), (32, 24)])
@pytest.mark.parametrize("spp4", [4, 8])
@pytest.mark.parametrize("bounces", [0, 1, 8])
@pytest.mark.parametrize("rr_depth", [0, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("stream", ["philox", "buffer"])
def test_pt_kernel_equals_twin_bitwise(cuda, name, size, spp4, bounces, rr_depth, dtype,
                                       stream):
    """The zero-throughput exit (a path ends at the black front wall or
    the light) and the bounce's uniforms drawn at one place leave the
    image the twin's bit for bit: 33 x 17 pixels (no multiple of a warp)
    and 32 x 24, paths that end at every bounce, Philox and a uniforms
    buffer."""
    planes, mats = _pt_scene(name, dtype, cuda)
    w, h = size
    u = None
    if stream == "buffer":
        rng = np.random.RandomState(w + spp4 + bounces)
        u = torch.tensor(rng.uniform(0.0, 1.0, (spp4, ptk.n_uniforms(bounces), w * h)),
                         dtype=dtype, device=cuda)
    kw = dict(width=w, height=h, spp4=spp4, bounces=bounces, rr_depth=rr_depth, uniforms=u)
    k = ptk.render_pt(planes, mats, **kw)
    assert torch.equal(k, ptk.render_pt_plain(planes, mats, **kw))
    assert bool(torch.isfinite(k).all()) and (float(k.max()) > 0.0) == (bounces > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("plane,sphere,value", [(7, 2, float("nan")), (4, 0, float("inf"))])
def test_pt_zero_exit_off_where_the_scene_is_not_finite(cuda, dtype, plane, sphere, value):
    """A NaN albedo (the back wall's red) or an inf emission (the left
    wall's red) makes 0 x value a NaN on the paths whose throughput is
    already zero, so the exit must stay off: the kernel traces them as the
    twin does, NaNs and all."""
    planes, mats = _pt_scene("cornell8", dtype, cuda)
    planes[plane, sphere] = value
    kw = dict(width=32, height=24, spp4=8, bounces=8, rr_depth=5)
    k = ptk.render_pt(planes, mats, **kw)
    p = ptk.render_pt_plain(planes, mats, **kw)
    assert bool(k.isnan().any())
    assert _bits_equal(k, p)


# ----------------------------------------- chunk grid and fused mesh ----
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sub,T,sp,sp2", TRAVERSALS)
def test_wbvh_kernel_matches_twin(cuda, dtype, sub, T, sp, sp2):
    v, f = meshes.icosphere(subdivisions=sub)
    v = np.asarray(v, np.float32)
    g = cg.build_chunk_grid(v, f, tris_per_chunk=T, supers_per=sp, supers2_per=sp2)
    rows = torch.tensor(cg.attr_triangle_rows(g, np.ones((f.shape[0], 3)),
                                              np.zeros((f.shape[0], 3)),
                                              np.arange(f.shape[0]) % 3), device=cuda)
    cb, sb, _, _ = cg.chunk_grid_to_device(g, cuda)
    ssb = torch.tensor(g.ssboxes, device=cuda)
    rays = torch.tensor(_sphere_rays(4096), dtype=dtype, device=cuda)
    kw = dict(tris_per_chunk=T, supers_per=sp, supers2_per=sp2, attrs=True, stats=True)
    wk.reset_launches()
    k = wk.intersect_chunks(rays, cb, sb, rows, ssb, **kw)
    assert wk.LAUNCHES == {"wbvh": 1}
    p = wk.intersect_chunks_plain(rays, cb, sb, rows, ssb, **kw)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]) and torch.equal(k[3], p[3])
    assert all(torch.equal(a, b) for a, b in zip(k[2], p[2]))


def _wbvh_case(cuda, sub, T, sp, sp2, width):
    """The chunk grid of an icosphere and its rows of `width` floats (the
    24-float rows one float into a larger buffer where width is -24: not
    16-byte aligned)."""
    v, f = meshes.icosphere(subdivisions=sub)
    g = cg.build_chunk_grid(np.asarray(v, np.float32), f, tris_per_chunk=T, supers_per=sp,
                            supers2_per=sp2)
    rows24 = cg.attr_triangle_rows(g, np.ones((f.shape[0], 3)), np.zeros((f.shape[0], 3)),
                                   np.arange(f.shape[0]) % 3)
    if width == 13:
        rows = torch.tensor(np.ascontiguousarray(rows24[:, :13]), device=cuda)
    elif width == -24:
        buf = torch.zeros(rows24.size + 1, dtype=torch.float32, device=cuda)
        buf[1:] = torch.tensor(rows24.reshape(-1), device=cuda)
        rows = buf[1:].view(rows24.shape)
    else:
        rows = torch.tensor(rows24, device=cuda)
    cb, sb, _, _ = cg.chunk_grid_to_device(g, cuda)
    return cb, sb, torch.tensor(g.ssboxes, device=cuda), rows


def _wbvh_equal(k, p):
    return (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]) and torch.equal(k[-1], p[-1])
            and (len(k) == 3 or all(torch.equal(a, b) for a, b in zip(k[2], p[2]))))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sub,T,sp,sp2", TRAVERSALS)
@pytest.mark.parametrize("width", [24, 13, -24])
def test_wbvh_kernel_matches_twin_on_incoherent_rays(cuda, dtype, sub, T, sp, sp2, width):
    """Random-direction rays from random origins in and around the mesh
    (every lane of a warp on its own chunk list): tmin, slot, attrs and
    the per-ray counts bit for bit, with 24-float rows (aligned, and one
    float off), and 13-float rows without attrs."""
    cb, sb, ssb, rows = _wbvh_case(cuda, sub, T, sp, sp2, width)
    rays = torch.tensor(_random_rays(8192, seed=sub + T, spread=0.8), dtype=dtype, device=cuda)
    kw = dict(tris_per_chunk=T, supers_per=sp, supers2_per=sp2, attrs=width != 13, stats=True)
    k = wk.intersect_chunks(rays, cb, sb, rows, ssb, **kw)
    p = wk.intersect_chunks_plain(rays, cb, sb, rows, ssb, **kw)
    assert int((k[1] > 0).sum()) > 1000 and int(k[-1][0].sum()) > 8192
    assert _wbvh_equal(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("sp", [0, 2])
def test_wbvh_kernel_fills_its_queues(cuda, sp):
    """A chunk (and super) per face of icosphere s3 and rays through the
    middle: each warp's 32 rays enter hundreds of boxes, so the queues
    fill and are worked off first; the results stay the twin's bit for
    bit."""
    cb, sb, ssb, rows = _wbvh_case(cuda, 3, 1, sp, 0, 24)
    rays = torch.tensor(_aimed_rays(4096, seed=sp), device=cuda)
    kw = dict(tris_per_chunk=1, supers_per=sp, attrs=True, stats=True)
    wk.queue_overflows()
    k = wk.intersect_chunks(rays, cb, sb, rows, ssb, **kw)
    torch.cuda.synchronize()
    over = wk.queue_overflows()
    assert over["chunk_queue"] > 0 and (sp == 0 or over["super_queue"] > 0)
    assert _wbvh_equal(k, wk.intersect_chunks_plain(rays, cb, sb, rows, ssb, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layers", [16, 24])
@pytest.mark.parametrize("seed", [0, 1])
def test_wbvh_kernel_minimum_of_many_pairs_of_one_ray(cuda, dtype, layers, seed):
    """16 or 24 stacked plates in chunks of 32 triangles: a ray through
    the stack puts 32 pairs of its own into one step of the warp walk,
    16 of them hits at distinct t, all folded into its minimum at once
    (min_pairs' atomicMin on a 64-bit shared word).  tmin, slot, attrs
    and counts equal the twin's (walk_plain) bit for bit, and each ray
    through the square wins on the plate nearest its origin."""
    v, f, plate = _permuted_stack(layers, seed)
    g = cg.build_chunk_grid(v.astype(np.float32), f, tris_per_chunk=32)
    rows = torch.tensor(cg.attr_triangle_rows(g, np.ones((f.shape[0], 3)),
                                              np.zeros((f.shape[0], 3)),
                                              np.zeros(f.shape[0])), device=cuda)
    cb, sb, _, _ = cg.chunk_grid_to_device(g, cuda)
    rays = _rays_through_the_stack(4096, seed, dtype, cuda)
    kw = dict(tris_per_chunk=32, attrs=True, stats=True)
    k = wk.intersect_chunks(rays, cb, sb, rows, **kw)
    assert _wbvh_equal(k, wk.intersect_chunks_plain(rays, cb, sb, rows, **kw))
    x, y = rays[0].cpu().numpy(), rays[1].cpu().numpy()
    inside = (x > 22.5) & (x < 77.5) & (y > 17.5) & (y < 67.5)  # a tilt drifts < 1.7
    down = np.arange(x.shape[0]) % 2 == 0
    won = plate[g.face_of_slot[k[1].cpu().numpy()]]
    assert inside.sum() > 1500
    assert (won[inside & down] == layers - 1).all() and (won[inside & ~down] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layers", [16, 24])
def test_mesh_pt_kernel_minimum_of_many_pairs_of_one_ray(cuda, dtype, layers):
    """The fused kernel on the stack of plates facing the camera, chunks
    of 32 triangles: each camera ray through it folds its 16 hits of one
    step into its minimum at once.  Everything equals the twin bit for
    bit, and every bounce-0 mesh winner is on the front plate."""
    v, f, plate = _permuted_stack(layers, 2)
    ms = mm.MeshScene.cornell_with_mesh(v, f, albedo=(0.7, 0.7, 0.7))
    tables = mpt.mesh_pt_tables(ms, device=cuda, dtype=dtype, tris_per_chunk=32, supers_per=0)
    k = _mesh_options_vs_twin(tables, cuda, width=32, height=32, spp4=4, bounces=2,
                              rr_depth=5, stats_tile=256)
    s_count = tables[0].shape[1]
    slots = k[1][0][k[1][0] >= s_count] - s_count
    assert slots.numel() > 100
    assert (plate[tables[5].face_of_slot[slots.cpu().numpy()]] == layers - 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mesh_pt_stats_on_a_ragged_grid_with_pads_outside_their_super(cuda, dtype):
    """tests/test_torch_camera_fused.py's ragged grid (pad chunks at
    [-1, 1]^3, outside their super): the kernel's kstats, image and
    residuals equal the twin's, which lists a chunk a ray enters through
    its super."""
    v, f = meshes.icosphere(center=(3.0, 3.0, 3.0), radius=14.0, subdivisions=2)
    ms = mm.MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2))
    planes, cb, sb, t24, _, grid = mpt.mesh_pt_tables(ms, device=cuda, dtype=dtype,
                                                      tris_per_chunk=8, supers_per=6)
    planes = torch.tensor([[1e6], [0.0], [0.0], [0.0], [1.0], [1.0], [1.0], [0.5], [0.5], [0.5]],
                          dtype=dtype, device=cuda)
    cam = torch.tensor(ptk.camera_constants(32, 32), dtype=torch.float32)
    cam[0:3] = -40.0 * cam[3:6]
    cam[10] = 0.0
    mats = torch.tensor([0], dtype=torch.int32, device=cuda)
    k = _mesh_options_vs_twin((planes, cb, sb, t24, mats, grid), cuda, width=32, height=32,
                              spp4=4, bounces=2, rr_depth=2, stats_tile=1024, cam=cam)
    assert int(k[4][0].min()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mesh_pt_kernel_matches_twin(cuda, dtype):
    planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(_mixed_scene(), device=cuda,
                                                         dtype=dtype, tris_per_chunk=8,
                                                         supers_per=4)
    kw = dict(materials=mats, width=48, height=40, spp4=8, bounces=8, rr_depth=5,
              **mpt.pt_tables_kwargs(grid, cuda))
    mpt.reset_launches()
    k = mpt.render_pt_mesh(planes, cb, sb, t24, **kw)
    assert mpt.LAUNCHES == {"mesh_pt": 1}
    p = mpt.render_pt_mesh_plain(planes, cb, sb, t24, **kw)
    if dtype == torch.float64:
        torch.testing.assert_close(k, p, rtol=1e-9, atol=0)
    else:
        assert float(((k - p).abs() <= 1e-5 * p.abs()).float().mean()) >= 0.999


# ------------------------------------------------------ replay rows ----
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bounces", [1, 3, 8, rpk.MAX_UNROLLED + 1])
@pytest.mark.parametrize("dead", ["zeros", "random"])
def test_replay_rows_kernel_equals_twin_bitwise(cuda, dtype, bounces, dead):
    """The kernel's rows are the plain twin's bit for bit (signed zeros
    too): 777 pixels (no multiple of the block), chunks at layer offsets
    inside spp4 24, read in place, the last one ragged; one launch each;
    ``out=`` filled in place.  Bounces above MAX_UNROLLED take the
    run-time instantiation."""
    wid, resv, g = _replay_residuals(bounces, 24, 777, dtype, cuda, seed=bounces, dead=dead)
    for layer0, layers in ((0, 8), (8, 8), (16, 5), (23, 1)):
        rpk.reset_launches()
        got = rpk.replay_rows(wid, resv, g, layer0=layer0, layers=layers)
        assert rpk.LAUNCHES == {"replay_rows": 1}
        exp = rpk.replay_rows_plain(wid, resv, g, layer0=layer0, layers=layers)
        assert got.shape == (6, bounces, layers, 777) and torch.equal(_bits(got), _bits(exp))
    out = torch.full_like(got, float("nan"))
    assert rpk.replay_rows(wid, resv, g, layer0=23, layers=1, out=out) is out
    assert torch.equal(_bits(out), _bits(exp))


@pytest.mark.cuda
def test_replay_rows_kernel_refuses_a_device_mix(cuda):
    wid, resv, g = _replay_residuals(2, 8, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="different devices"):
        rpk.replay_rows(wid, resv, g.cpu(), layer0=0, layers=8)
    with pytest.raises(ValueError, match="different devices"):
        rpk.replay_rows(wid.cpu(), resv, g, layer0=0, layers=8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("spp4,chunk", [(16, 8), (20, 8)])
def test_replay_backward_on_the_card_equals_plain_rows_bitwise(cuda, monkeypatch, dtype, spp4,
                                                               chunk):
    """replay_backward on the card (the rows kernel, then segsum.cu) equals,
    bit for bit, the same replay with the plain rows swapped in for the
    kernel; one rows launch and one segment-sum launch a chunk."""
    wid, resv, g = _replay_residuals(8, spp4, 1000, dtype, cuda, seed=5)
    kw = dict(n_spheres=9, n_slots=40, spp4=spp4, layer_chunk=chunk)
    chunks = -(-spp4 // chunk)
    rpk.reset_launches()
    hk.reset_launches()
    got = mf.replay_backward(wid, resv, g, **kw)
    assert rpk.LAUNCHES == {"replay_rows": chunks} and hk.LAUNCHES == {"segsum": chunks}
    monkeypatch.setattr(rpk, "replay_rows", lambda wid, resv, g_cell, **k:
                        rpk.replay_rows_plain(wid, resv, g_cell, **k))
    rpk.reset_launches()
    exp = mf.replay_backward(wid, resv, g, **kw)
    assert rpk.LAUNCHES == {"replay_rows": 0} and hk.LAUNCHES == {"segsum": 2 * chunks}
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, exp))
    assert float(got[0][4:10].abs().max()) > 0 and float(got[1].abs().max()) > 0


# ------------------------------------------------------ segment-sum ----
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segsum_kernel_matches_twin(cuda, dtype):
    seg, vals = _clustered(50000, 20000, 6)
    seg, vals = torch.tensor(seg, device=cuda), torch.tensor(vals, dtype=dtype, device=cuda)
    hk.reset_launches()
    got, kocc = hk.segment_rows_paged(seg, vals, n_slots=20000)
    assert hk.LAUNCHES == {"segsum": 1}
    exp = hk.segment_rows_plain(seg, vals.double(), n_slots=20000)
    assert torch.equal(kocc, hk.occupancy_plain(seg, n_slots=20000))
    torch.testing.assert_close(got.double(), exp, rtol=0, atol=1e-5 * float(vals.abs().sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,n_slots,r", [(50000, 20000, 6), (300000, 9 + 5120, 8), (777, 3, 1)])
def test_segsum_kernel_repeats_bitwise(cuda, dtype, n, n_slots, r):
    """Two launches on the same inputs give the same sums bit for bit,
    through both wrappers, and stay within 1e-5 x sum |rows| of the
    float64 twin per segment."""
    rng = np.random.RandomState(n)
    runs = np.repeat(rng.randint(-1, n_slots + 3, n // 7 + 1), 7)[:n]  # runs of equal ids
    seg = torch.tensor(runs.astype(np.int32), device=cuda)
    vals = torch.tensor(rng.randn(r, n), dtype=dtype, device=cuda)
    a, ka = hk.segment_rows_paged(seg, vals, n_slots=n_slots)
    b, kb = hk.segment_rows_paged(seg, vals, n_slots=n_slots)
    assert torch.equal(a, b) and torch.equal(ka, kb)
    m1 = hk.segment_rows_matmul(seg, vals, n_slots=n_slots)
    assert torch.equal(m1, hk.segment_rows_matmul(seg, vals, n_slots=n_slots))
    ref = hk.segment_rows_plain(seg, vals.double(), n_slots=n_slots)
    mag = hk.segment_rows_plain(seg, vals.double().abs(), n_slots=n_slots)
    assert bool(((a.double() - ref).abs() <= 1e-5 * mag).all())
    assert bool(((m1.double() - ref).abs() <= 1e-5 * mag).all())


def _seg_stream(case, n, n_slots, seed):
    """The ids of a card test of the segment-sum: one id over all rows, all
    rows dropped, runs of lengths that straddle lane (4 rows), warp (128),
    tile (1024) and CTA bounds with dropped runs among them, or runs of 1-3
    rows (the gather stream's shape)."""
    rng = np.random.RandomState(seed)
    if case == "one_id":
        return np.full(n, n_slots - 1, np.int32)
    if case == "dropped":
        return rng.choice([-1, -7, n_slots, n_slots + 100], n).astype(np.int32)
    lengths = [1, 3, 4, 5, 31, 127, 128, 129, 1023, 1025, 4999] if case == "runs" else [1, 2, 3]
    ids, total = [], 0
    while total < n:
        k = int(rng.choice(lengths))
        ids.append(np.full(k, rng.randint(-2, n_slots + 2), np.int32))
        total += k
    return np.concatenate(ids)[:n]


@pytest.mark.cuda
@pytest.mark.parametrize("case,n,n_slots,r,dtype,sample_block", [
    ("one_id", 70001, 1, 8, torch.float32, 2048),
    ("dropped", 5000, 7, 3, torch.float32, 2048),
    ("runs", 100003, 9 + 5120, 6, torch.float32, 2048),
    ("runs", 65537, 700, 8, torch.float64, 512),
    ("short", 30011, 5120, 1, torch.float32, 96),
    ("runs", 20000, 1_100_000, 2, torch.float32, 32),  # kocc in a pass of its own
])
def test_segsum_kernel_equals_its_ordered_model(cuda, case, n, n_slots, r, dtype,
                                                sample_block):
    """The kernel's float64 sums equal segment_rows_ordered (its order of
    additions, with the card's G) bit for bit, through both wrappers and on
    a second launch; kocc equals the twin's; each segment is within 1e-5 x
    sum |rows| of the float64 twin."""
    seg = torch.tensor(_seg_stream(case, n, n_slots, seed=n), device=cuda)
    vals = torch.tensor(np.random.RandomState(r).randn(r, n), dtype=dtype, device=cuda)
    kw = dict(n_slots=n_slots, sample_block=sample_block)
    acc = torch.zeros((n_slots, r), dtype=torch.float64, device=cuda)
    hk.reset_launches()
    _, kocc = hk.segment_rows_paged(seg, vals, out=acc, **kw)
    assert hk.LAUNCHES == {"segsum": 1}
    model = hk.segment_rows_ordered(seg, vals, groups=hk.groups(n, r, n_slots, sample_block),
                                    **kw)
    assert torch.equal(acc, model)
    assert torch.equal(kocc, hk.occupancy_plain(seg, n_slots=n_slots,
                                                sample_block=sample_block))
    again = torch.zeros_like(acc)
    _, kocc2 = hk.segment_rows_paged(seg, vals, out=again, **kw)
    assert torch.equal(again, acc) and torch.equal(kocc2, kocc)
    flat = hk.segment_rows_matmul(seg, vals, out=torch.zeros_like(acc), **kw)
    assert torch.equal(flat, acc)
    ref = hk.segment_rows_plain(seg, vals.double(), n_slots=n_slots)
    mag = hk.segment_rows_plain(seg, vals.double().abs(), n_slots=n_slots)
    assert bool(((acc - ref).abs() <= 1e-5 * mag).all())
    if case == "dropped":
        assert not bool(acc.any())


@pytest.mark.cuda
@pytest.mark.parametrize("sample_block", [32, 96, 1024, 4096])
def test_segsum_kocc_at_other_sample_blocks(cuda, sample_block):
    """kocc of the fused pass at sample blocks below, at and above the
    kernel's 1024-row tile, over ids that reach past n_slots into the
    last slot block."""
    n, n_slots = 50021, 3000
    seg = torch.tensor(_seg_stream("runs", n, n_slots, seed=sample_block), device=cuda)
    vals = torch.ones((2, n), device=cuda)
    for slot_block in (128, 512):
        _, kocc = hk.segment_rows_paged(seg, vals, n_slots=n_slots, slot_block=slot_block,
                                        sample_block=sample_block)
        assert torch.equal(kocc, hk.occupancy_plain(seg, n_slots=n_slots, slot_block=slot_block,
                                                    sample_block=sample_block))


# ------------------------------------------------------- BVH kernel ----
@pytest.mark.cuda
@pytest.mark.parametrize("max_leaf", [4, 64])
def test_bvh_kernel_matches_twin(cuda, max_leaf):
    v, f = meshes.icosphere(subdivisions=3)
    bvh = bvh_mod.build_bvh_numpy(v, f, max_leaf=max_leaf)
    planes = tuple(tuple(c[bvh.tri_order] for c in t)
                   for t in tri.triangle_planes(v, f, dtype=np.float32))
    tables = bk.pack_bvh(bvh, planes, cuda)
    rays = torch.tensor(np.concatenate([_random_rays(4096), _aimed_rays(4096)], 1),
                        device=cuda)
    bk.reset_launches()
    k = bk.intersect_bvh(rays, *tables, max_leaf=max_leaf)
    assert bk.LAUNCHES == {"bvh": 1}
    p = bk.intersect_bvh_plain(rays, *tables, max_leaf=max_leaf)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


def _bvh_rays(v, f, n, seed):
    """[6, n] float32 rays, shuffled: rays in random directions that start
    on the mesh (inside its triangles and at its vertices, where t = +-0),
    rays aimed into it, random rays, and NaN rays."""
    rng = np.random.RandomState(seed)
    m = max(n, 64)
    tri_v = np.asarray(v, np.float64)[f[rng.randint(0, f.shape[0], m)]]
    w = rng.dirichlet(np.ones(3), m)
    w[m // 2:] = np.eye(3)[rng.randint(0, 3, m - m // 2)]
    o = np.einsum("nk,nkc->cn", w, tri_v)
    d = rng.randn(3, m)
    on_mesh = np.concatenate([o, d / np.linalg.norm(d, axis=0)], 0).astype(np.float32)
    pool = np.concatenate([on_mesh, _aimed_rays(m, seed), _random_rays(m, seed, spread=1.5)], 1)
    pool[rng.randint(0, 6, m // 16), rng.randint(0, pool.shape[1], m // 16)] = np.nan
    return np.ascontiguousarray(pool[:, rng.permutation(pool.shape[1])[:n]])


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["ico3", "dup2"])
@pytest.mark.parametrize("max_leaf", [4, 64, 128])
@pytest.mark.parametrize("eps", [1e-4, 0.0, -1e-3])
@pytest.mark.parametrize("n", [1, 33, 4097])
def test_bvh_kernel_pooled_leaves_equal_twin(cuda, mesh, max_leaf, eps, n):
    """The warp's pooled leaf tests give the twin's tmin and hit bit for
    bit: incoherent rays from the mesh's own surface, leaves of up to 128
    triangles (several rounds of 32 for one ray), every face twice (exact
    ties go to the lower leaf-order index), eps <= 0 (t <= 0 and -0 win),
    NaN rays, and N that is no multiple of a warp."""
    v, f = meshes.icosphere(subdivisions=3 if mesh == "ico3" else 2)
    if mesh == "dup2":
        f = np.concatenate([f, f], 0)
    bvh = bvh_mod.build_bvh_numpy(v, f, max_leaf=max_leaf)
    planes = tuple(tuple(c[bvh.tri_order] for c in t)
                   for t in tri.triangle_planes(v, f, dtype=np.float32))
    tables = bk.pack_bvh(bvh, planes, cuda)
    rays = torch.tensor(_bvh_rays(v, f, n, seed=n + max_leaf), device=cuda)
    k = bk.intersect_bvh(rays, *tables, max_leaf=max_leaf, eps=eps)
    p = bk.intersect_bvh_plain(rays, *tables, max_leaf=max_leaf, eps=eps)
    assert torch.equal(k[0].view(torch.int32), p[0].view(torch.int32))
    assert torch.equal(k[1], p[1])
    if n > 1000:
        assert int((k[0] < bk.MISS_T).sum()) > n // 4


# -------------------------------------- camera and stats outputs ----
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("supers_per,supers2_per", [(0, 0), (4, 0), (4, 4)])
def test_mesh_pt_camera_and_stats_match_twin(cuda, dtype, supers_per, supers2_per):
    """with_camera and with_stats, together and each on its own: image,
    wid, resv and suv bitwise, kstats equal (per 128-pixel tile and per
    pixel), and the image, wid and resv the same as without the options."""
    planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(
        _mixed_scene(3 if supers2_per else 2), device=cuda, dtype=dtype, tris_per_chunk=8,
        supers_per=supers_per, supers2_per=supers2_per)
    kw = dict(materials=mats, width=32, height=16, spp4=4, bounces=4, rr_depth=2,
              with_residuals=True, **mpt.pt_tables_kwargs(grid, cuda))
    base = mpt.render_pt_mesh(planes, cb, sb, t24, **kw)
    for tile in (128, 1):
        mpt.reset_launches()
        k = mpt.render_pt_mesh(planes, cb, sb, t24, with_camera=True, with_stats=True,
                               stats_tile=tile, **kw)
        assert mpt.LAUNCHES == {"mesh_pt": 1}
        p = mpt.render_pt_mesh_plain(planes, cb, sb, t24, with_camera=True, with_stats=True,
                                     stats_tile=tile, **kw)
        assert all(torch.equal(a, b) for a, b in zip(k, p))
        assert all(torch.equal(a, b) for a, b in zip(k[:3], base))
        assert int(k[4][0].max()) > 0
        cam = mpt.render_pt_mesh(planes, cb, sb, t24, with_camera=True, **kw)
        assert all(torch.equal(a, b) for a, b in zip(cam, p[:4]))
        img, ks = mpt.render_pt_mesh(planes, cb, sb, t24, with_stats=True, stats_tile=tile,
                                     **{**kw, "with_residuals": False})
        assert torch.equal(img, p[0]) and torch.equal(ks, p[4])


@pytest.mark.cuda
def test_render_with_camera_on_the_card(cuda):
    planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(_mixed_scene(), device=cuda)
    kw = dict(materials=mats, width=32, height=32, spp4=4, bounces=2, rr_depth=2,
              **mpt.pt_tables_kwargs(grid, cuda))
    params = {k: v.requires_grad_(True) for k, v in
              CameraParams(dtype=torch.float64, device=cuda).items()}
    mpt.reset_launches()
    hk.reset_launches()
    image, depth, (wid, resv, suv) = dcf.render_with_camera(params, planes, cb, sb, t24, **kw)
    grads = torch.autograd.grad((depth * depth).mean(), list(params.values()))
    assert mpt.LAUNCHES == {"mesh_pt": 1} and hk.LAUNCHES == {"segsum": 0}
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert max(float(g.abs().max()) for g in grads) > 0
    twin = mpt.render_pt_mesh_plain(planes, cb, sb, t24, cam=dcf.cam_vector(
        params, 32, 32, dtype=torch.float32).detach(), with_residuals=True,
        with_camera=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(twin, (image, wid, resv, suv)))


# ------------------------------- the mesh kernel's warp walk, edge cases ----
def _mesh_options_vs_twin(tables, cuda, *, stats_tile, **kw):
    """The kernel against the twin with residuals, camera and stats:
    image, wid, resv, suv bitwise and kstats equal; one launch."""
    planes, cb, sb, t24, mats, grid = tables
    kw = dict(materials=mats, with_residuals=True, with_camera=True, with_stats=True,
              stats_tile=stats_tile, **mpt.pt_tables_kwargs(grid, cuda), **kw)
    mpt.reset_launches()
    k = mpt.render_pt_mesh(planes, cb, sb, t24, **kw)
    assert mpt.LAUNCHES == {"mesh_pt": 1}
    p = mpt.render_pt_mesh_plain(planes, cb, sb, t24, **kw)
    same = [torch.equal(a, b) for a, b in zip(k, p)]
    assert all(same), same
    return k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tpc", [1, 4])
def test_mesh_pt_exact_ties_take_the_lowest_slot(cuda, dtype, tpc):
    """Three copies of every face, in other chunks and across super
    boundaries: every triangle hit is a three-way tie in t, and the
    kernel's winners (wid) are the twin's, the lowest slot."""
    v, f = _tie_mesh(subdivisions=1)
    ms = mm.MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2))
    tables = mpt.mesh_pt_tables(ms, device=cuda, dtype=dtype, tris_per_chunk=tpc,
                                supers_per=2)
    k = _mesh_options_vs_twin(tables, cuda, width=32, height=24, spp4=4, bounces=4,
                              rr_depth=2, stats_tile=256)
    slots = k[1][k[1] >= tables[0].shape[1]] - tables[0].shape[1]
    assert slots.numel() > 100
    fos = torch.tensor(tables[5].face_of_slot, device=cuda)
    nf = f.shape[0] // 3
    first = torch.stack([torch.nonzero(fos % nf == x)[0, 0] for x in range(nf)])
    assert torch.equal(slots, first[fos[slots].long() % nf])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mesh_pt_queue_overflow(cuda, dtype):
    """64 plates facing the camera, two triangles a chunk, four chunks a
    super: each camera ray through the stack enters all 16 supers and all
    64 chunks, so a warp's entries pass both queues many times over; none
    is dropped."""
    v, f = _layer_stack()
    ms = mm.MeshScene.cornell_with_mesh(v, f, albedo=(0.7, 0.7, 0.7))
    tables = mpt.mesh_pt_tables(ms, device=cuda, dtype=dtype, tris_per_chunk=2,
                                supers_per=4)
    assert tables[5].n_chunks == 64 and tables[5].n_supers == 16
    cap = mpt.queue_overflows()["capacity"]
    k = _mesh_options_vs_twin(tables, cuda, width=32, height=32, spp4=4, bounces=2,
                              rr_depth=5, stats_tile=256)
    over = mpt.queue_overflows()
    assert over["capacity"] == cap and over["super_queue"] > 0 and over["chunk_queue"] > 0
    assert int(k[4][0].max()) == 64 and int(k[4][2].max()) == 16  # bounce 0 enters them all
    assert int((k[1][0] >= tables[0].shape[1]).sum()) > 200


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("spp4", [4, 8])
@pytest.mark.parametrize("bounces", [0, 1, 8])
@pytest.mark.parametrize("rr_depth", [0, 5])
def test_mesh_pt_ragged_and_mixed_path_lengths(cuda, dtype, spp4, bounces, rr_depth):
    """33 x 17 pixels (561: no multiple of a warp or a block), paths that
    end at every bounce: each lane starts its pixel's next layer as its
    path ends, and the result is the twin's bit for bit."""
    tables = mpt.mesh_pt_tables(_mixed_scene(), device=cuda, dtype=dtype, tris_per_chunk=8,
                                supers_per=4)
    k = _mesh_options_vs_twin(tables, cuda, width=33, height=17, spp4=spp4,
                              bounces=bounces, rr_depth=rr_depth, stats_tile=33)
    assert bool(torch.isfinite(k[0]).all())
    assert (float(k[0].max()) > 0.0) == (bounces > 0)


@pytest.mark.cuda
def test_mesh_pt_takes_rows_at_any_offset(cuda):
    """The kernel reads a row 16 bytes at a time: rows that start 4 bytes
    into an allocation give the image of an aligned copy."""
    planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(_mixed_scene(), device=cuda,
                                                         tris_per_chunk=8, supers_per=4)
    buf = torch.empty(t24.numel() + 1, dtype=t24.dtype, device=cuda)
    shifted = buf[1:].view(t24.shape)
    shifted.copy_(t24)
    assert shifted.data_ptr() % 16 != 0
    kw = dict(materials=mats, width=16, height=16, spp4=4, bounces=4, rr_depth=2,
              **mpt.pt_tables_kwargs(grid, cuda))
    assert torch.equal(mpt.render_pt_mesh(planes, cb, sb, shifted, **kw),
                       mpt.render_pt_mesh(planes, cb, sb, t24, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mesh_pt_top_level_past_the_root_limit(cuda, dtype):
    """A 1-level grid of 5,120 one-triangle chunks, more than the
    ROOT_MAX_BOXES (4,096) a warp unions into its root box: the root is
    then unbounded, every live lane expands over the whole top level (its
    boxes in global memory), and the result is the twin's."""
    ms = mm.MeshScene.cornell_with_mesh(*meshes.icosphere(
        center=(50, 40, 60), radius=14.0, subdivisions=4), albedo=(0.85, 0.55, 0.2))
    tables = mpt.mesh_pt_tables(ms, device=cuda, dtype=dtype, tris_per_chunk=1,
                                supers_per=0)
    assert tables[5].n_supers == 0 and tables[5].n_chunks > mpt.ROOT_MAX_BOXES
    k = _mesh_options_vs_twin(tables, cuda, width=16, height=16, spp4=4, bounces=2,
                              rr_depth=1, stats_tile=256)
    assert int((k[1] >= tables[0].shape[1]).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mesh_pt_boxes_near_the_shared_memory_limit(cuda, dtype):
    """40,392 bytes of boxes (icosphere s5 in chunks of 13, 16 a super) go
    to shared memory beside the warps' queues, past the 48 KB a launch
    gets without asking: the kernel asks, and matches the twin."""
    ms = mm.MeshScene.cornell_with_mesh(*meshes.icosphere(
        center=(50, 40, 60), radius=14.0, subdivisions=5), albedo=(0.85, 0.55, 0.2))
    tables = mpt.mesh_pt_tables(ms, device=cuda, dtype=dtype, tris_per_chunk=13,
                                supers_per=16)
    assert 24 * (tables[5].n_chunks + tables[5].n_supers) == 40392
    k = _mesh_options_vs_twin(tables, cuda, width=16, height=16, spp4=4, bounces=3,
                              rr_depth=2, stats_tile=256)
    assert int((k[1] >= tables[0].shape[1]).sum()) > 0


# --------------------------------------------------------- debug dumps ----
DUMP_LABELS = ("pt_pallas alive", "wbvh tile worklist k", "mesh_pt worklist k",
               "mesh_pt alive")


def _dump_lines(capfd) -> list:
    """The debug dumps' lines in the captured output (device printf and
    Python alike), as (label, value) in order."""
    out = []
    for ln in "".join(capfd.readouterr()).splitlines():
        label, _, value = ln.partition(": ")
        if label in DUMP_LABELS:
            out.append((label, value))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("debug_tile", [300, 2048])
@pytest.mark.parametrize("stream", ["philox", "buffer"])
def test_pt_debug_dump_equals_twin(cuda, capfd, dtype, debug_tile, stream):
    """render_pt.cu's debug instantiation prints, with device printf, the
    twin's lines: the paths of pixels [0, debug_tile) of layer 0 alive
    after each bounce, counting the paths with zero throughput (cornell8's
    black front wall) that the kernel's exit would end; the image is the
    debug-off kernel's and the twin's bit for bit."""
    planes, mats = _pt_scene("cornell8", dtype, cuda)
    u = None
    if stream == "buffer":
        u = torch.tensor(np.random.RandomState(3).uniform(0.0, 1.0, (8, ptk.n_uniforms(8), 561)),
                         dtype=dtype, device=cuda)
    kw = dict(width=33, height=17, spp4=8, bounces=8, rr_depth=2, uniforms=u)
    off = ptk.render_pt(planes, mats, **kw)
    _dump_lines(capfd)
    ptk.reset_launches()
    on = ptk.render_pt(planes, mats, debug=True, debug_tile=debug_tile, **kw)
    kernel = _dump_lines(capfd)
    assert ptk.LAUNCHES == {"pt": 1}
    twin = ptk.render_pt_plain(planes, mats, debug=True, debug_tile=debug_tile, **kw)
    assert _dump_lines(capfd) == kernel and len(kernel) == 8
    counts = [float(v) for _, v in kernel]
    assert counts[0] > counts[-1] > 0 and counts[0] <= min(debug_tile, 561)
    assert _bits_equal(on, off) and _bits_equal(on, twin)


def _wbvh_outputs_equal(k, p):
    return (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]) and torch.equal(k[3], p[3])
            and all(torch.equal(a, b) for a, b in zip(k[2], p[2])))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sub,T,sp,sp2", TRAVERSALS)
def test_wbvh_debug_dump_equals_twin(cuda, capfd, dtype, sub, T, sp, sp2):
    """wbvh.cu's debug instantiation prints the twin's "wbvh tile worklist
    k" line for every 1,000-ray tile (a ragged last one) in order, with
    the stats and without; tmin, slot, attrs and counts are the debug-off
    kernel's and the twin's bit for bit."""
    cb, sb, ssb, rows = _wbvh_case(cuda, sub, T, sp, sp2, 24)
    rays = torch.tensor(_sphere_rays(4500), dtype=dtype, device=cuda)
    kw = dict(tris_per_chunk=T, supers_per=sp, supers2_per=sp2, attrs=True, stats=True)
    off = wk.intersect_chunks(rays, cb, sb, rows, ssb, **kw)
    _dump_lines(capfd)
    wk.reset_launches()
    on = wk.intersect_chunks(rays, cb, sb, rows, ssb, debug=True, debug_tile=1000, **kw)
    kernel = _dump_lines(capfd)
    assert wk.LAUNCHES == {"wbvh": 1}
    twin = wk.intersect_chunks_plain(rays, cb, sb, rows, ssb, debug=True, debug_tile=1000, **kw)
    assert _dump_lines(capfd) == kernel and len(kernel) == 5
    assert _wbvh_outputs_equal(on, off) and _wbvh_outputs_equal(on, twin)
    tmin, hit = wk.intersect_chunks(rays, cb, sb, rows, ssb, tris_per_chunk=T, supers_per=sp,
                                    supers2_per=sp2, debug=True, debug_tile=1000)
    assert _dump_lines(capfd) == kernel
    assert torch.equal(tmin, off[0]) and torch.equal(hit, off[1])


@pytest.mark.cuda
def test_wbvh_debug_dump_past_one_print_batch(cuda, capfd):
    """10,486 tiles of 100 rays: more lines than one print launch holds
    (8,192); every tile's line comes out, in order, equal to the twin's."""
    cb, sb, ssb, rows = _wbvh_case(cuda, 2, 8, 4, 0, 24)
    rays = torch.tensor(_random_rays(1 << 20, seed=5), device=cuda)
    kw = dict(tris_per_chunk=8, supers_per=4, debug=True, debug_tile=100)
    _dump_lines(capfd)
    wk.intersect_chunks(rays, cb, sb, rows, **kw)
    kernel = _dump_lines(capfd)
    wk.intersect_chunks_plain(rays, cb, sb, rows, **kw)
    twin = _dump_lines(capfd)
    assert len(kernel) == 10486 and kernel == twin


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("options", ["forward", "residuals_camera", "stats"])
@pytest.mark.parametrize("debug_tile", [200, 512])
def test_mesh_pt_debug_dump_equals_twin(cuda, capfd, dtype, options, debug_tile):
    """mesh_pt.cu's debug instantiations print the twin's "mesh_pt
    worklist k" and "mesh_pt alive" lines per bounce for pixels [0,
    debug_tile) of layer 0 (path regeneration runs other layers in the
    same warps), with every residual sink and with the stats; every
    output is the debug-off kernel's and the twin's bit for bit."""
    planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(
        _mixed_scene(2), device=cuda, dtype=dtype, tris_per_chunk=8, supers_per=4)
    kw = dict(materials=mats, width=32, height=16, spp4=4, bounces=4, rr_depth=2,
              **mpt.pt_tables_kwargs(grid, cuda))
    kw.update({"forward": {}, "stats": dict(with_stats=True, stats_tile=128),
               "residuals_camera": dict(with_residuals=True, with_camera=True)}[options])
    off = mpt.render_pt_mesh(planes, cb, sb, t24, **kw)
    _dump_lines(capfd)
    mpt.reset_launches()
    on = mpt.render_pt_mesh(planes, cb, sb, t24, debug=True, debug_tile=debug_tile, **kw)
    kernel = _dump_lines(capfd)
    assert mpt.LAUNCHES == {"mesh_pt": 1}
    twin = mpt.render_pt_mesh_plain(planes, cb, sb, t24, debug=True, debug_tile=debug_tile,
                                    **kw)
    assert _dump_lines(capfd) == kernel
    assert [lab for lab, _ in kernel] == ["mesh_pt worklist k", "mesh_pt alive"] * 4
    assert max(int(v) for lab, v in kernel if lab == "mesh_pt worklist k") > 0
    if options == "forward":
        on, off, twin = (on,), (off,), (twin,)
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    assert all(torch.equal(a, b) for a, b in zip(on, twin))


# ------------------------------------------------------------- trainer ----
@pytest.mark.cuda
def test_train_step_on_the_card_equals_the_cpu_twin_step(cuda):
    """parallel/sharded.make_train_step(None): 5 float64 SGD steps at 16 x
    16 x 4 rays, 3 bounces, through render_ref.cu's forward with winners
    and replay backward (one launch each a step) against the same steps on
    the CPU through their twins; center and r2 do not move."""
    from ascendpathtracing_tpu_torch.models import megakernel
    from ascendpathtracing_tpu_torch.parallel import sharded

    rays = camera.generate_rays_numpy(16, 16, 1, seed=0)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        scene = megakernel.scene_to_device(scenes.cornell8(), device=dev, dtype=torch.float64)
        r = torch.tensor(rays, dtype=torch.float64, device=dev)
        target = rk.render_reference(r, sharded.params_to_planes(scene), light_index=LIGHT,
                                     bounces=3)
        params, aux = sharded.split_scene_params(scene)
        params = dict(params, albedo=params["albedo"] + 0.08)
        step = sharded.make_train_step(None, bounces=3, learning_rate=0.05)
        rk.reset_launches()
        losses = []
        for _ in range(5):
            loss, params = step(params, aux, r, target)
            losses.append(float(loss))
        out[dev.type] = (losses, {k: v.cpu() for k, v in params.items()}, dict(rk.LAUNCHES))
    (lc, pc, _), (lg, pg, launches) = out["cpu"], out["cuda"]
    assert launches == {"fwd": 0, "fwd_idx": 5, "bwd_replay": 5, "bwd_recompute": 0}
    np.testing.assert_allclose(lg, lc, rtol=1e-9)
    for k in pc:
        torch.testing.assert_close(pg[k], pc[k], rtol=1e-9, atol=1e-12)
    base = megakernel.scene_to_device(scenes.cornell8(), dtype=torch.float64)
    assert torch.equal(pg["center"], base["center"]) and torch.equal(pg["r2"], base["r2"])
    assert lg[-1] < lg[0]


# One step of make_train_step(None) at 65,536 rays (128 x 128 x 4), 8
# bounces, under torch.profiler, in a process of its own: a process's
# second profiler session can miss device events (it failed
# test_read_kernel_one_device_kernel_a_call when this ran first).
SPANS_STEP = """
import json, torch
from torch.profiler import ProfilerActivity, profile
from ascendpathtracing_tpu_torch import camera, scenes
from ascendpathtracing_tpu_torch.models import megakernel
from ascendpathtracing_tpu_torch.ops import render_kernels as rk
from ascendpathtracing_tpu_torch.parallel import sharded
from perfbench import spans, trace

cuda = torch.device("cuda")
scene = megakernel.scene_to_device(scenes.cornell8(), device=cuda)
rays = torch.tensor(camera.generate_rays_numpy(128, 128, 1, seed=0), dtype=torch.float32,
                    device=cuda)
target = rk.render_reference(rays, sharded.params_to_planes(scene), light_index=7, bounces=8)
params, aux = sharded.split_scene_params(scene)
params = dict(params, albedo=params["albedo"] + 0.08)
step = sharded.make_train_step(None, bounces=8, learning_rate=0.05)
step(params, aux, rays, target)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    step(params, aux, rays, target)
    torch.cuda.synchronize()
print(json.dumps({"device_events": [n for n, _, _ in trace.profiler_events(prof)[0]],
                  "spans": spans.summary(prof)}))
"""


@pytest.mark.cuda
def test_train_step_spans_hold_every_device_operation(cuda):
    """One traced train step (``SPANS_STEP``) read as the benchmark reads a
    trace (perfbench/trace, perfbench/spans): every device operation of
    the step belongs to an apt. span, no device-typed annotation reaches
    the device events, and launches_per_step counts each of those
    operations."""
    from perfbench import spans, trace

    out = subprocess.run([sys.executable, "-c", SPANS_STEP], cwd=REPO, capture_output=True,
                         text=True, timeout=900, check=True)
    got = json.loads([ln for ln in out.stdout.splitlines() if ln.startswith("{")][-1])
    dev, ops = got["device_events"], got["spans"]["ops"]
    assert dev and not any(name.startswith("apt.") for name in dev)
    assert len(ops) == len(dev)
    assert [op[0] for op in ops if not op[3]] == []
    inner = {trace.csrc_kernel(op[0]): op[3][-1] for op in ops if trace.csrc_kernel(op[0])}
    assert inner["render_ref_fwd_kernel"] == "apt.kernel.fwd_idx"
    assert inner["render_ref_bwd_replay_kernel"] == "apt.kernel.bwd_replay"
    ctx = {"trace": {"iterations": 1, "spans": got["spans"]}}
    assert spans.launches_per_step(ctx) == len(dev)
    assert spans.span_ms(ctx, spans.TRAINER) > 0


@pytest.mark.cuda
def test_cli_train_resume_equals_a_straight_run_on_the_card(cuda, tmp_path, capsys):
    """cli train --backend cuda: 10 steps, then --resume for 10, leave the
    parameters of a straight 20 bit for bit."""
    from ascendpathtracing_tpu_torch.utils import checkpoint as ckpt

    args = ["train", "--backend", "cuda", "--width", "32", "--height", "32", "--bounces", "8"]
    split, straight = str(tmp_path / "split.npz"), str(tmp_path / "straight.npz")
    assert cli.main([*args, "--steps", "10", "--ckpt", split]) == 0
    assert cli.main([*args, "--steps", "10", "--ckpt", split, "--resume"]) == 0
    assert "resumed from" in capsys.readouterr().err
    assert cli.main([*args, "--steps", "20", "--ckpt", straight]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (pa, sa, _), (pb, sb, _) = ckpt.load_checkpoint(split), ckpt.load_checkpoint(straight)
    assert sa == sb == 20 and set(pa) == set(pb) == {"albedo", "emission", "center", "r2"}
    assert all(np.array_equal(pa[k], pb[k]) for k in pa)
    assert np.isfinite(line["final_loss"]) and line["steps"] == 20


# --------------------------------------------------------------- post ----
@pytest.mark.cuda
def test_post_on_the_card_matches_the_cpu(cuda):
    """Each post function on the card against the CPU on the same float32
    inputs (rtol 1e-5; the 8-bit image within one level)."""
    from ascendpathtracing_tpu_torch import post

    rng = np.random.RandomState(0)
    img = torch.tensor(rng.gamma(1.0, 0.6, (48, 40, 3)).astype(np.float32))
    nrm = torch.tensor(rng.randn(48, 40, 3).astype(np.float32))
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    depth = torch.tensor(rng.uniform(1, 2, (48, 40)).astype(np.float32))
    alb = torch.tensor(rng.uniform(0, 1, (48, 40, 3)).astype(np.float32))
    colors = torch.tensor(rng.gamma(1.0, 3.0, (500, 3)).astype(np.float32))
    cases = [(post.firefly_clamp, (colors, 2.0)), (post.tonemap_reinhard, (img, 1.5)),
             (post.tonemap_aces, (img, 0.7)), (post.gamma_encode, (img,)),
             (lambda *a: post.atrous_denoise(*a, iterations=3), (img, nrm, depth, alb)),
             (lambda x: post.atrous_denoise(x, iterations=2), (img,))]
    for fn, args in cases:
        c = fn(*args)
        g = fn(*(a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args))
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), c, rtol=1e-5, atol=1e-6)
    u8c = post.to_u8(post.gamma_encode(post.tonemap_aces(img)))
    u8g = post.to_u8(post.gamma_encode(post.tonemap_aces(img.to(cuda))))
    assert np.abs(u8c.astype(int) - u8g.astype(int)).max() <= 1


@pytest.mark.cuda
def test_cli_post_pipeline_on_the_card(cuda, tmp_path):
    """cli render with --denoise, --tonemap, --clamp and the G-buffer on
    the card: the artifacts, and final.ppm within one level of the CPU
    run's (the reference render is bitwise the same on both at 1 bounce)."""
    from ascendpathtracing_tpu_torch.utils import io

    args = ["render", "--width", "32", "--height", "32", "--bounces", "1", "--denoise", "2",
            "--tonemap", "aces", "--clamp", "8", "--aov", "gbuffer", "--check-finite"]
    for backend in ("cuda", "cpu"):
        assert cli.main([*args, "--backend", backend, "--out", str(tmp_path / backend)]) == 0
    for name in ("color.ppm", "final.ppm", "depth.ppm", "normal.ppm", "albedo.ppm"):
        assert (tmp_path / "cuda" / name).exists(), name
    assert (tmp_path / "cuda" / "color.bin").read_bytes() == \
        (tmp_path / "cpu" / "color.bin").read_bytes()
    a, b = (io.read_ppm(str(tmp_path / d / "final.ppm")).astype(int) for d in ("cuda", "cpu"))
    assert a.shape == (32, 32, 3) and np.abs(a - b).max() <= 1


@pytest.mark.cuda
def test_selftest_passes_on_the_card(cuda, capsys):
    assert cli.main(["selftest", "--backend", "cuda"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines[-1] == {"selftest": "PASS", "passed": 8, "ran": 8, "backend": "cuda"}
    assert lines[7]["check"] == "checkify_float_guards" and lines[7]["nan_caught"]


# ------------------------------------------------------- wavefront ----
def _wavefront_mesh(cuda, traversal, dtype=torch.float32):
    """A mesh wavefront render at 32x24 x 8 samples (pool 1,000, sort
    every 2) of an icosphere s2 in smallpt9 on the card -> a callable."""
    v, f = meshes.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=2)
    dev = mm.mesh_scene_to_device(mm.MeshScene.cornell_with_mesh(v, f), device=cuda,
                                  pallas_bvh_kernel=True, pallas_kernel=traversal,
                                  tris_per_chunk=8)
    return lambda: wf.render_wavefront_mesh(3, dev, width=32, height=24, spp4=8, pool=1000,
                                            bounces=8, sort_every=2, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("traversal,mod,name,kernel", [
    ("chunks", wk, "intersect_chunks", "wbvh"), ("lockstep", bk, "intersect_bvh", "bvh")])
def test_wavefront_mesh_kernels_equal_their_twins(cuda, monkeypatch, traversal, mod, name,
                                                   kernel):
    """One traversal launch and one segsum.cu launch an iteration; the
    image bitwise the render's with the traversal's twin swapped in, and
    two runs bitwise."""
    render = _wavefront_mesh(cuda, traversal)
    for m in (wk, bk, hk):
        m.reset_launches()
    img = render()
    it = wf.STATS["iterations"]
    assert it > 0 and hk.LAUNCHES == {"segsum": it} and mod.LAUNCHES == {kernel: it}
    assert torch.equal(img, render())
    monkeypatch.setattr(mod, name, getattr(mod, f"{name}_plain"))
    assert torch.equal(img, render())


@pytest.mark.cuda
def test_wavefront_scatter_equals_the_plain_scatter_f64(cuda, monkeypatch):
    render = _wavefront_mesh(cuda, "chunks", torch.float64)
    img = render()
    monkeypatch.setattr(hk, "segment_rows_matmul", lambda seg, vals, *, n_slots, out, **_:
                        hk.segment_rows_plain(seg, vals, n_slots=n_slots, out=out))
    hk.reset_launches()
    torch.testing.assert_close(render(), img, rtol=1e-12, atol=0)
    assert hk.LAUNCHES == {"segsum": 0}


@pytest.mark.cuda
def test_wavefront_sphere_on_the_card(cuda):
    """render_wavefront: float64 equal to the bounce loop's per-pixel
    means on its camera rays, float32 twice bitwise."""
    w, h, spp4 = 24, 16, 8
    o3, d3, _, _ = wf._sample_camera_rays(torch.arange(w * h * spp4, device=cuda), w, h, spp4,
                                          2, camera.Camera(), torch.float64)
    sc = megakernel.scene_to_device(scenes.smallpt9(), device=cuda, dtype=torch.float64)
    ref = megakernel.render_pt_impl(torch.stack([*o3, *d3], 1), sc, seed=2)
    img = wf.render_wavefront(2, sc, width=w, height=h, spp4=spp4, pool=777,
                              dtype=torch.float64)
    torch.testing.assert_close(img, ref.reshape(w * h, spp4, 3).mean(1), rtol=1e-12, atol=0)
    sc32 = megakernel.scene_to_device(scenes.smallpt9(), device=cuda)
    a = wf.render_wavefront(2, sc32, width=w, height=h, spp4=spp4, pool=777)
    assert a.device.type == "cuda" and torch.equal(a, wf.render_wavefront(
        2, sc32, width=w, height=h, spp4=spp4, pool=777))


# ------------------------------------------- parallel (gloo on one card) ----
def gloo_collectives():
    """all_reduce, all_gather and broadcast called by torch.distributed on
    CUDA tensors as they are, and ``mesh.ppermute`` (staged through the
    host) -> the results on the host."""
    import torch.distributed as dist

    from ascendpathtracing_tpu_torch.parallel import mesh as pmesh
    from ascendpathtracing_tpu_torch.parallel.distributed import rank_device

    dev, r, n = rank_device(), dist.get_rank(), dist.get_world_size()
    x = torch.arange(5, dtype=torch.float64, device=dev) + 10 * r
    red = x.clone()
    dist.all_reduce(red)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x)
    b = x.clone()
    dist.broadcast(b, 0)
    ring = pmesh.ppermute((x, torch.full((3,), r, dtype=torch.int32, device=dev)), None)
    return {"device": str(dev), "backend": dist.get_backend(), "all_reduce": red.cpu(),
            "all_gather": torch.stack(parts).cpu(), "broadcast": b.cpu(),
            "ppermute": [t.cpu() for t in ring], "ring_device": ring[0].device.type}


def sharded_train(rays, target):
    """The sharded training step on the card: this rank's shards of
    ``rays``/``target`` -> (loss, new params, its colors, launches)."""
    from ascendpathtracing_tpu_torch.parallel import make_mesh, make_train_step, shard_rays
    from ascendpathtracing_tpu_torch.parallel.distributed import rank_device
    from ascendpathtracing_tpu_torch.parallel.sharded import split_scene_params

    dev = rank_device()
    mesh = make_mesh()
    scene = megakernel.scene_to_device(scenes.cornell8(), device=dev)
    params, aux = split_scene_params(scene)
    params = dict(params, albedo=params["albedo"] + 0.05)
    step = make_train_step(mesh, bounces=8, learning_rate=0.02)
    r = convert.rays_planes_from_numpy(shard_rays(rays, mesh), device=dev).T
    t = torch.tensor(shard_rays(target, mesh).T.copy(), device=dev).T
    rk.reset_launches()
    loss, new, colors = step(params, aux, r, t, return_colors=True)
    launches = dict(rk.LAUNCHES)
    return (float(loss), {k: v.cpu() for k, v in new.items()}, colors.cpu(), launches)


def two_ranks(rays, target):
    """One rank of the two-rank gloo world the card tests share."""
    return {"gloo": gloo_collectives(), "train": sharded_train(rays, target)}


TRAIN_RAYS = camera.generate_rays_numpy(64, 64, 1, seed=0).astype(np.float32)
TRAIN_TARGET = (np.random.RandomState(0).rand(TRAIN_RAYS.shape[0], 3) * 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def two_rank_world():
    """One world of two ranks sharing the card (gloo), spawned once for
    the tests below."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ascendpathtracing_tpu_torch.parallel.distributed import run_local_world

    return run_local_world(two_ranks, 2, device="cuda", args=(TRAIN_RAYS, TRAIN_TARGET),
                           timeout=300)


@pytest.mark.cuda
def test_gloo_collectives_take_cuda_tensors(cuda, two_rank_world):
    """Two ranks sharing the card over gloo: all_reduce, all_gather and
    broadcast give on CUDA tensors what they give on host copies, and
    ppermute's host staging hands each rank its neighbour's tensors back
    on the card."""
    base = torch.arange(5, dtype=torch.float64)
    for r, got in enumerate(res["gloo"] for res in two_rank_world):
        assert got["backend"] == "gloo" and got["device"] == "cuda:0"
        assert torch.equal(got["all_reduce"], 2 * base + 10)
        assert torch.equal(got["all_gather"], torch.stack([base, base + 10]))
        assert torch.equal(got["broadcast"], base)
        assert torch.equal(got["ppermute"][0], base + 10 * (1 - r))
        assert torch.equal(got["ppermute"][1], torch.full((3,), 1 - r, dtype=torch.int32))
        assert got["ring_device"] == "cuda"


@pytest.mark.cuda
def test_sharded_train_step_two_ranks_on_the_card(cuda, two_rank_world):
    """The data-parallel training step in a world of two ranks sharing the
    card (gloo), at 64x64 camera rays x 8 bounces: each rank's colors are
    the one-device step's rows bit for bit (the kernels work a ray a
    thread), one fwd_idx and one bwd_replay launch a rank, the loss and
    the new parameters within rtol 1e-6 of the one-device step's (float32;
    only the order of the sums differs), equal on both ranks."""
    from ascendpathtracing_tpu_torch.parallel import make_train_step
    from ascendpathtracing_tpu_torch.parallel.sharded import split_scene_params

    scene = megakernel.scene_to_device(scenes.cornell8(), device=cuda)
    params, aux = split_scene_params(scene)
    params = dict(params, albedo=params["albedo"] + 0.05)
    loss1, new1, colors1 = make_train_step(None, bounces=8, learning_rate=0.02)(
        params, aux, convert.rays_planes_from_numpy(TRAIN_RAYS, device=cuda).T,
        torch.tensor(TRAIN_TARGET.T.copy(), device=cuda).T, return_colors=True)
    res = [r["train"] for r in two_rank_world]
    m = TRAIN_RAYS.shape[0] // 2
    for r, (loss, new, colors, launches) in enumerate(res):
        assert torch.equal(colors, colors1[r * m:(r + 1) * m].cpu())
        assert launches == {"fwd": 0, "fwd_idx": 1, "bwd_replay": 1, "bwd_recompute": 0}
        np.testing.assert_allclose(loss, float(loss1), rtol=1e-6)
        for k in new:
            torch.testing.assert_close(new[k], new1[k].cpu(), rtol=1e-6, atol=1e-7)
            assert torch.equal(new[k], res[0][1][k])


# ------------------------------------------- profiling and op counts ----
@pytest.mark.cuda
def test_benchmark_fit_matches_cuda_events(cuda):
    """utils/profiling.benchmark_fit of a step that sleeps on the card
    (torch.cuda._sleep, ~2 ms) within 10% of the step's time by CUDA
    events (20 steps between two events)."""
    from ascendpathtracing_tpu_torch.utils import profiling

    x = torch.ones(8, device=cuda)

    def step(i=0):
        torch.cuda._sleep(2_000_000)
        return x

    step()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(20):
        step()
    e1.record()
    e1.synchronize()
    event_s = e0.elapsed_time(e1) / 20 / 1e3
    fit = profiling.benchmark_fit(step)
    assert fit["fit_ok"], fit
    assert abs(fit["step_s"] - event_s) <= 0.1 * event_s, (fit["step_s"], event_s)
    assert profiling.fetch_rtt() > 0.0
    assert profiling.benchmark(step, iters=4)["mean_s"] > 0.5 * event_s


@pytest.mark.cuda
def test_count_ops_of_the_reference_fwd_bwd_equal_on_card_and_cpu(cuda):
    """utils/roofline.count_ops of the plain reference step (forward and
    autograd's backward, which runs on another thread on a card) counts
    the same ops on the card as on the CPU (sqrt_rn as one sqrt on
    both)."""
    from ascendpathtracing_tpu_torch import bench
    from ascendpathtracing_tpu_torch.utils import roofline

    rays = camera.generate_rays_numpy(32, 32, 1, seed=0).astype(np.float32)
    counts = {}
    for device in (cuda, torch.device("cpu")):
        step = bench.make_step("plain", False, convert.rays_planes_from_numpy(rays, device=device),
                               scenes.cornell8(), bounces=8)
        counts[device.type] = roofline.count_ops(step).as_dict()
    assert counts["cuda"] == counts["cpu"]
    assert not counts["cuda"]["other"] and counts["cuda"]["hard_by_prim"]["sqrt"] > 0


# ------------------------------------------- roofline ceiling probes ----
def _chain_input(op, n, seed):
    """The probe's input at n elements, its 32 streams spread over [1, 2)
    (sqrt's and div's fixed points and fma's 1.5 are in reach)."""
    from ascendpathtracing_tpu_torch.ops import ceiling_kernels as ck

    x = ck.chain_inputs(op, (n,))
    x[:ck.STREAMS] = torch.tensor(np.random.RandomState(seed).uniform(1.0, 2.0, (ck.STREAMS, n)),
                                  dtype=torch.float32)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["mul", "fma", "cmpsel", "mix", "sqrt", "div", "fma_fused"])
@pytest.mark.parametrize("n,steps", [(1, 3), (1000, 16), (4097, 2)])
def test_chain_kernel_equals_twin_bitwise(cuda, op, n, steps):
    """ceiling.cu's chain kernel against its twin on the card, bit for bit
    (the fused one against the float64 twin, exact on these inputs), and
    one launch counted."""
    from ascendpathtracing_tpu_torch.ops import ceiling_kernels as ck

    x = _chain_input(op, n, seed=n).to(cuda)
    ck.reset_launches()
    out = ck.chain(op, x, steps)
    assert ck.LAUNCHES == {"chain": 1, "copy": 0, "read": 0}
    assert out.shape == (n,)
    assert torch.equal(out, ck.chain_plain(op, x, steps))


@pytest.mark.cuda
def test_chain_kernel_jax_inputs_and_fill(cuda):
    """On the JAX probe's own inputs (4,096 trips) the kernel gives the
    Pallas kernel's constants (tests/test_torch_ceilings.py holds the twin
    to them), and fill_elements fills every SM."""
    from ascendpathtracing_tpu_torch.ops import ceiling_kernels as ck

    want = {"mul": 48.25, "fma": 48.0, "cmpsel": 48.0, "mix": 37.53422164916992,
            "sqrt": 127.99999237060547, "div": 48.0, "fma_fused": 48.0}
    for op, value in want.items():
        out = ck.chain(op, ck.chain_inputs(op, device=cuda))
        assert torch.equal(out, torch.full((8, 128), value, device=cuda)), op
        n = ck.fill_elements(op, cuda)
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert n >= sms * ck.BLOCK and n % (sms * ck.BLOCK) == 0, (op, n)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 1000, 1 << 20])
def test_copy_kernel_equals_twin_bitwise(cuda, n):
    """x * 1.0000001 bit for bit the twin's; an unaligned view refused."""
    from ascendpathtracing_tpu_torch.ops import ceiling_kernels as ck

    x = torch.tensor(np.random.RandomState(n).randn(n + 4).astype(np.float32), device=cuda)
    ck.reset_launches()
    y = ck.copy_scale(x[:n])
    assert ck.LAUNCHES == {"chain": 0, "copy": 1, "read": 0}
    assert torch.equal(y, ck.copy_scale_plain(x[:n]))
    with pytest.raises(ValueError):
        ck.copy_scale(x[1:n + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("nb,sub", [(1, 128), (3, 1024), (5, 65536), (128, 4096), (3, 1152),
                                    (7, 65536), (128, 1152)])
def test_read_kernel_against_f64_sum(cuda, nb, sub):
    """The read on random data, from 8 rows (most CTAs of the grid get
    none) to ragged splits whose shares cross (b, r) runs of 9 and 512
    rows: one launch a call; bit for bit the model of its order
    (``read_sum_ordered`` on ``read_grid`` CTAs); within float32 summation
    error of the float64 sum (2^-24 x ``read_chain``, the longest chain of
    adds on an output's path, x the sum of |x|); the same bits from a
    second launch queued right behind the first (the tickets the first
    left at 0); and exactly nb * sub / 128 on ones."""
    from ascendpathtracing_tpu_torch.ops import ceiling_kernels as ck

    x = torch.tensor(np.random.RandomState(nb).randn(nb, 8, sub).astype(np.float32), device=cuda)
    ck.reset_launches()
    out = ck.read_sum(x)
    assert ck.LAUNCHES == {"chain": 0, "copy": 0, "read": 1}
    again = ck.read_sum(x)  # no synchronize between the two
    assert ck.LAUNCHES == {"chain": 0, "copy": 0, "read": 2}
    assert torch.equal(again, out)
    ctas = ck.read_grid(cuda)
    assert torch.equal(out, ck.read_sum_ordered(x, ctas))
    folded = x.double().reshape(nb, 8, sub // 128, 128)
    want, mag = folded.sum(dim=(0, 2)), folded.abs().sum(dim=(0, 2))
    rows = nb * sub // 128
    adds = ck.read_chain(nb, sub, ctas)
    assert float(((out.double() - want).abs() - adds * 2.0 ** -24 * mag).max()) <= 0.0
    twin = ck.read_sum_plain(x)
    assert float(((twin.double() - want).abs() - (rows + 1) * 2.0 ** -24 * mag).max()) <= 0.0
    ones = ck.read_sum(torch.ones((nb, 8, sub), device=cuda))
    assert torch.equal(ones, torch.full((8, 128), float(rows), device=cuda))


@pytest.mark.cuda
def test_read_kernel_one_device_kernel_a_call(cuda):
    """torch.profiler sees one device kernel a read_sum, read_kernel, on
    ten reads queued back to back (the first call's zeroed tickets made
    before the profile)."""
    from torch.profiler import ProfilerActivity, profile

    from ascendpathtracing_tpu_torch.ops import ceiling_kernels as ck

    x = torch.ones((16, 8, 65536), device=cuda)
    ck.read_sum(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ck.read_sum(x)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 10 and all("read_kernel" in k for k in kernels), kernels


@pytest.mark.cuda
def test_read_kernel_two_streams(cuda):
    """Reads queued on two streams at once keep apart (each stream has
    its own partials and tickets): every one equals a read on the current
    stream alone, bit for bit."""
    from ascendpathtracing_tpu_torch.ops import ceiling_kernels as ck

    x = torch.tensor(np.random.RandomState(2).randn(16, 8, 65536).astype(np.float32),
                     device=cuda)
    want = ck.read_sum(x)
    main, side = torch.cuda.current_stream(cuda), torch.cuda.Stream(cuda)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        on_side = [ck.read_sum(x) for _ in range(4)]
    on_main = [ck.read_sum(x) for _ in range(4)]
    main.wait_stream(side)
    for out in on_side + on_main:
        assert torch.equal(out, want)
