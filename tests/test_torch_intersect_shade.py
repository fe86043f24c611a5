"""Port ops (ascendpathtracing_tpu_torch.ops.intersect / .shade) against
their JAX counterparts and the NumPy oracle, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu import camera, oracle, scenes
from ascendpathtracing_tpu.ops import intersect as jx_intersect
from ascendpathtracing_tpu.ops import shade as jx_shade
from ascendpathtracing_tpu_torch.ops import intersect, shade

DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]


def _rays(w=32, seed=0, dtype=np.float64):
    return camera.generate_rays_numpy(w, w, 1, seed=seed).astype(dtype)


def _planes(r, t):
    return [torch.tensor(np.ascontiguousarray(r[:, i])) for i in range(6)]


@pytest.mark.parametrize("np_dt,t_dt", DTYPES)
def test_intersect_bitwise_vs_oracle_and_jax(np_dt, t_dt):
    scene = scenes.cornell8()
    r = _rays(dtype=np_dt)
    pl = scene.soa10(np_dt)
    cen = [torch.tensor(pl[i]) for i in (1, 2, 3)]
    got = intersect.intersect_spheres_soa(
        *_planes(r, t_dt), *cen, torch.tensor(pl[0]), 1e-4
    ).numpy()
    assert got.dtype == np_dt
    expect = oracle.intersect_all_numpy(r[:, :3], r[:, 3:], scene, 1e-4, np_dt).T
    # The f64 oracle's miss sentinel is float32(1e20) widened; the JAX
    # package and the port use 1e20 in the compute dtype.
    hit = expect < np.float32(1e20)
    np.testing.assert_array_equal(got[hit], expect[hit])
    assert (got[~hit] == np_dt(1e20)).all()
    jx = np.asarray(
        jx_intersect.intersect_spheres_soa(
            *[jnp.asarray(r[:, i]) for i in range(6)],
            *[jnp.asarray(pl[i]) for i in (1, 2, 3)], jnp.asarray(pl[0]), 1e-4,
        )
    )
    np.testing.assert_array_equal(got, jx)


def test_reduce_hit_first_minimum_tie_break():
    t = torch.tensor(
        [[5.0, 1e20, 2.0, 3.0], [5.0, 1e20, 1.0, 3.0], [4.0, 1e20, 1.0, 3.0]],
        dtype=torch.float64,
    )
    tmin, hit, miss = intersect.reduce_hit_soa(t)
    assert hit.dtype == torch.int32
    np.testing.assert_array_equal(hit.numpy(), [2, 0, 1, 0])
    np.testing.assert_array_equal(miss.numpy(), [False, True, False, False])
    jt, jh, jm = jx_intersect.reduce_hit_soa(jnp.asarray(t.numpy()))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(miss.numpy(), np.asarray(jm))


def test_aos_wrappers_match_soa():
    scene = scenes.cornell8()
    r = torch.tensor(_rays(16))
    cen = torch.tensor(scene.center)
    r2 = torch.tensor(scene.r2)
    t = intersect.intersect_spheres(r[:, :3], r[:, 3:], cen, r2, 1e-4)
    assert t.shape == (r.shape[0], scene.n_spheres)
    soa = intersect.intersect_spheres_soa(*r.T, *cen.T, r2, 1e-4)
    assert torch.equal(t, soa.T)
    for a, b in zip(intersect.reduce_hit(t), intersect.reduce_hit_soa(soa)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("np_dt", [np.float32, np.float64])
def test_sqrt_rn_is_correctly_rounded(np_dt):
    x = (np.random.RandomState(0).rand(200_000) * 1e11).astype(np_dt)
    x[:3] = [0.0, 9789946880.0, 1e-30]  # 9789946880: a torch-CPU misround
    got = intersect.sqrt_rn(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.sqrt(x))
    xt = torch.tensor(x[1:10], requires_grad=True)
    intersect.sqrt_rn(xt).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), 0.5 / np.sqrt(x[1:10]), rtol=1e-6)


@pytest.mark.parametrize("np_dt,t_dt", DTYPES)
def test_specular_bounce_bitwise_vs_jax(np_dt, t_dt):
    r = _rays(dtype=np_dt)
    rng = np.random.RandomState(1)
    tmin = (rng.rand(r.shape[0]) * 200).astype(np_dt)
    tmin[:8] = 1e20  # misses: the f32 normal overflows to inf -> d unchanged
    cen = [rng.randn(r.shape[0]).astype(np_dt) * 50 for _ in range(3)]
    o, d = shade.specular_bounce(
        tuple(_planes(r, t_dt)[:3]), tuple(_planes(r, t_dt)[3:]),
        torch.tensor(tmin), tuple(torch.tensor(c) for c in cen),
    )
    jo, jd = jx_shade.specular_bounce(
        tuple(jnp.asarray(r[:, i]) for i in range(3)),
        tuple(jnp.asarray(r[:, i]) for i in range(3, 6)),
        jnp.asarray(tmin), tuple(jnp.asarray(c) for c in cen),
    )
    for a, b in zip(o + d, jo + jd):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_vec3_helpers_match_jax():
    rng = np.random.RandomState(2)
    a = tuple(rng.randn(64) for _ in range(3))
    b = tuple(rng.randn(64) for _ in range(3))
    ta = tuple(torch.tensor(x) for x in a)
    tb = tuple(torch.tensor(x) for x in b)
    ja = tuple(jnp.asarray(x) for x in a)
    jb = tuple(jnp.asarray(x) for x in b)
    m = rng.rand(64) > 0.5
    pairs = [
        (shade.v3_dot(ta, tb), jx_shade.v3_dot(ja, jb)),
        (shade.v3_cross(ta, tb), jx_shade.v3_cross(ja, jb)),
        (shade.v3_scale(ta, 2.5), jx_shade.v3_scale(ja, 2.5)),
        (shade.v3_add(ta, tb), jx_shade.v3_add(ja, jb)),
        (shade.v3_sub(ta, tb), jx_shade.v3_sub(ja, jb)),
        (shade.v3_where(torch.tensor(m), ta, tb), jx_shade.v3_where(m, ja, jb)),
        (shade.v3_normalize(ta), jx_shade.v3_normalize(ja)),
        (shade.reflect(ta, shade.v3_normalize(tb)),
         jx_shade.reflect(ja, jx_shade.v3_normalize(jb))),
    ]
    for got, exp in pairs:
        got = got if isinstance(got, tuple) else (got,)
        exp = exp if isinstance(exp, tuple) else (exp,)
        for g, e in zip(got, exp):
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("np_dt,t_dt", DTYPES)
def test_scaled_origin_offset_matches_jax(np_dt, t_dt):
    r2 = np.array([0.0, 1e-6, 16.5**2, 1e10], np_dt)
    got = shade.scaled_origin_offset(torch.tensor(r2), 1e-4)
    exp = np.asarray(jx_shade.scaled_origin_offset(jnp.asarray(r2), 1e-4))
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-6)
    assert shade.rel_offset_for(t_dt) == jx_shade.rel_offset_for(np_dt)
    assert shade.REL_OFFSET == jx_shade.REL_OFFSET
