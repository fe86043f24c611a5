"""The port's path-tracing half on the CPU: the PT shading ops
(ascendpathtracing_tpu_torch.ops.shade), the Philox stream (ops.rng), and
the plain estimators and AOVs (models.megakernel), each against the JAX
package on the same inputs made from a NumPy seed."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu import camera, scenes
from ascendpathtracing_tpu.models import megakernel as jx_mk
from ascendpathtracing_tpu.ops import shade as jx_shade
from ascendpathtracing_tpu.utils import io
from ascendpathtracing_tpu_torch import convert
from ascendpathtracing_tpu_torch.models import megakernel
from ascendpathtracing_tpu_torch.ops import rng, shade
from tests.test_torch_slice import one_cpu_thread  # noqa: F401  (autouse)

DTYPES = [(np.float64, torch.float64, 1e-12), (np.float32, torch.float32, 1e-6)]
PT_GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "pt_smallpt9_64x64_s4_b5.npy")


def _unit(rs, n, dtype):
    v = rs.randn(3, n)
    return (v / np.linalg.norm(v, axis=0)).astype(dtype)


def _t(a):
    return tuple(torch.tensor(np.ascontiguousarray(x)) for x in a)


def _j(a):
    return tuple(jnp.asarray(x) for x in a)


def _close(got, jx, rtol):
    for g, j in zip(got, jx):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=rtol, atol=rtol)


# ----------------------------------------------------------- shade ops ----
@pytest.mark.parametrize("np_dt,t_dt,rtol", DTYPES)
def test_cosine_sample_hemisphere_matches_jax(np_dt, t_dt, rtol):
    rs = np.random.RandomState(0)
    nl = _unit(rs, 512, np_dt)
    nl[:, :8] = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0]] * 2, np_dt).T
    u1, u2 = rs.rand(2, 512).astype(np_dt)
    got = shade.cosine_sample_hemisphere(_t(nl), *_t((u1, u2)))
    jx = jx_shade.cosine_sample_hemisphere(_j(nl), *_j((u1, u2)))
    assert got[0].dtype == t_dt
    _close(got, jx, rtol)
    assert (shade.v3_dot(got, _t(nl)) >= -rtol).all()  # in the hemisphere


@pytest.mark.parametrize("np_dt,t_dt,rtol", DTYPES)
def test_refract_or_reflect_matches_jax(np_dt, t_dt, rtol):
    rs = np.random.RandomState(1)
    d, n = _unit(rs, 1024, np_dt), _unit(rs, 1024, np_dt)
    into = (d * n).sum(0) < 0
    u = rs.rand(1024).astype(np_dt)
    got_d, got_s = shade.refract_or_reflect(_t(d), _t(n), torch.tensor(into), torch.tensor(u))
    jx_d, jx_s = jx_shade.refract_or_reflect(_j(d), _j(n), jnp.asarray(into), jnp.asarray(u))
    assert got_s.dtype == t_dt
    _close((*got_d, got_s), (*jx_d, jx_s), rtol)
    assert (got_s.numpy() != 1).any()  # both Fresnel branches reached


@pytest.mark.parametrize("np_dt,t_dt,rtol", DTYPES)
def test_russian_roulette_matches_jax(np_dt, t_dt, rtol):
    rs = np.random.RandomState(2)
    tput = (rs.rand(3, 1000) * 1.2).astype(np_dt)
    u = rs.rand(1000).astype(np_dt)
    got, surv = shade.russian_roulette(_t(tput), torch.tensor(u))
    jx, jsurv = jx_shade.russian_roulette(_j(tput), jnp.asarray(u))
    _close(got, jx, rtol)
    np.testing.assert_array_equal(surv.numpy(), np.asarray(jsurv))
    assert 0 < surv.float().mean() < 1


# ------------------------------------------------------------- Philox ----
def _philox_py(ctr, key, rounds=10):
    """Philox4x32 in plain Python integers, from the Random123 definition."""
    m = 0xFFFFFFFF
    c, k = [int(x) for x in ctr], [int(x) for x in key]
    for r in range(rounds):
        if r:
            k = [(k[0] + 0x9E3779B9) & m, (k[1] + 0xBB67AE85) & m]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k[0]) & m, p1 & m, ((p0 >> 32) ^ c[3] ^ k[1]) & m, p0 & m]
    return c


@pytest.mark.parametrize(
    "ctr,key,expect",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ],
)
def test_philox_known_answers(ctr, key, expect):
    """Random123's known-answer vectors for Philox4x32-10, through the
    torch implementation and the pure-Python one."""
    assert tuple(_philox_py(ctr, key)) == expect
    got = rng.philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in got) == expect


def test_philox_matches_python_on_random_counters():
    rs = np.random.RandomState(3)
    ctr = rs.randint(0, 2**32, size=(4, 64), dtype=np.uint64).astype(np.int64)
    key = [int(k) for k in rs.randint(0, 2**32, size=2, dtype=np.uint64)]
    got = torch.stack(rng.philox4x32(*torch.tensor(ctr), *key)).numpy()
    expect = np.array([_philox_py(ctr[:, i], key) for i in range(64)]).T
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("t_dt", [torch.float32, torch.float64])
def test_uniforms_on_the_2_pow_24_grid(t_dt):
    idx = torch.arange(4096)
    u = rng.uniforms(7, idx, 3, 26, stream=rng.STREAM_FUSED, dtype=t_dt)
    assert u.shape == (26, 4096) and u.dtype == t_dt
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    k = u.double() * 2**24
    assert torch.equal(k, k.round())
    assert abs(float(u.mean()) - 0.5) < 0.01
    # Counter-based: uniform q is word q % 4 of the block at q // 4, and a
    # stream, seed or counter change gives other numbers.
    words = rng.philox4x32(idx, 3, 6, rng.STREAM_FUSED, 7, 0)
    assert torch.equal(u[25], rng.bits_to_uniform(words[1], t_dt))
    other = rng.uniforms(7, idx, 3, 26, stream=rng.STREAM_ESTIMATOR, dtype=t_dt)
    assert not torch.equal(u, other)
    assert torch.equal(u, rng.uniforms(7, idx, 3, 26, stream=rng.STREAM_FUSED, dtype=t_dt))


# ---------------------------------------------------------- estimators ----
def _jax_draws(key, bounces, k, n, dtype):
    """The JAX estimators' per-bounce draws: split, then uniform (k, n)."""
    out = []
    for _ in range(bounces):
        key, k1 = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(k1, (k, n), dtype=dtype)))
    return np.stack(out)


def _pt_pair(name, w, s, seed=0, dtype=np.float64):
    t_dt = torch.float64 if dtype == np.float64 else torch.float32
    sc = scenes.get_scene(name)
    jdev = jx_mk.scene_to_device(sc, dtype=dtype)
    rays = camera.generate_rays_numpy(w, w, s, seed=seed).astype(dtype)
    return sc, jdev, rays, convert.scene_dict_from_numpy(jdev, dtype=t_dt), torch.tensor(rays)


@pytest.mark.parametrize("static", [False, True])
def test_render_pt_impl_f64_matches_jax(static):
    """Same rays, scene and uniforms: the port's estimator equals JAX's
    render_pt_impl to 1e-12 in float64 (8 bounces, RR from 5)."""
    sc, jdev, rays, tdev, rays_t = _pt_pair("smallpt9", 24, 1)
    mats = tuple(int(m) for m in sc.material) if static else None
    key = jax.random.PRNGKey(11)
    jx = np.asarray(jx_mk.render_pt(key, jnp.asarray(rays), jdev, bounces=8,
                                    materials_static=mats))
    u = convert.uniforms_from_numpy(_jax_draws(key, 8, 3, rays.shape[0], jnp.float64),
                                    dtype=torch.float64)
    got = megakernel.render_pt_impl(rays_t, tdev, bounces=8, materials_static=mats,
                                    uniforms=u)
    assert got.shape == (rays.shape[0], 3) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), jx, rtol=1e-12, atol=1e-12)
    assert float(got.max()) > 0


def test_render_pt_impl_reproduces_the_pt_golden():
    """tests/goldens/pt_smallpt9_64x64_s4_b5.npy (the f64 JAX estimator,
    PRNGKey(42), 5 bounces, RR from 3), decoded as tests/test_goldens.py
    decodes it: reproduced to 1e-9 from JAX's draws."""
    sc, _, rays, tdev, rays_t = _pt_pair("smallpt9", 64, 4)
    u = _jax_draws(jax.random.PRNGKey(42), 5, 3, rays.shape[0], jnp.float64)
    cols = megakernel.render_pt_impl(
        rays_t, tdev, bounces=5, rr_depth=3,
        materials_static=tuple(int(m) for m in sc.material),
        uniforms=convert.uniforms_from_numpy(u, dtype=torch.float64),
    )
    img = io.decode_color_hdr(cols.numpy(), 64, 64, 4)
    err = np.abs(img - np.load(PT_GOLDEN)).max()
    assert err <= 1e-9, f"PT estimator differs from the golden by {err}"


def test_render_pt_nee_impl_f64_matches_jax():
    """rtol 1e-9, not 1e-12: the light cone's sin_a = sqrt(1 - cos_a^2)
    cancels near cos_a = 1, which amplifies the last-bit differences
    between XLA's fused arithmetic and the port's op-by-op IEEE ops (up
    to 7e-11 relative measured here)."""
    _, jdev, rays, tdev, rays_t = _pt_pair("cornell-smalllight", 16, 1)
    key = jax.random.PRNGKey(5)
    jx = np.asarray(jx_mk.render_pt_nee(key, jnp.asarray(rays), jdev, bounces=6, rr_depth=3))
    u = _jax_draws(key, 6, 5, rays.shape[0], jnp.float64)
    got = megakernel.render_pt_nee_impl(
        rays_t, tdev, bounces=6, rr_depth=3,
        uniforms=convert.uniforms_from_numpy(u, dtype=torch.float64),
    )
    np.testing.assert_allclose(got.numpy(), jx, rtol=1e-9, atol=1e-12)
    assert float(got.max()) > 0


@pytest.mark.parametrize("name", ["cornell8", "smallpt9"])
def test_depth_and_gbuffer_f64_match_jax(name):
    _, jdev, rays, tdev, rays_t = _pt_pair(name, 16, 1, seed=2)
    depth = megakernel.render_depth_impl(rays_t, tdev)
    np.testing.assert_allclose(
        depth.numpy(), np.asarray(jx_mk.render_depth(rays, jdev)), rtol=1e-12, atol=1e-12
    )
    got = megakernel.render_gbuffer_impl(rays_t, tdev)
    jx = jx_mk.render_gbuffer(rays, jdev)
    assert set(got) == set(jx) and got["hit_id"].dtype == torch.int32
    for k in ("depth", "normal", "albedo"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jx[k]), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got["hit_id"].numpy(), np.asarray(jx["hit_id"]))
    assert torch.equal(got["depth"], depth)


@pytest.fixture(scope="module")
def pt_grads():
    """Port autograd of mean(render_pt_impl), float64, smallpt9, no RR,
    the draws of PRNGKey(2) (cf. tests/test_grad.py:98-114), with the
    JAX references -> {leaf: (port grad, JAX grad, rtol)}.

    albedo, emission: jax.grad at 3 bounces, rtol 1e-9.
    center, r2: jax.grad is NaN for these in any scene whose dielectric
    branch is traced (0 * inf through sqrt(max(cos2t, 0)) on its
    total-internal-reflection lanes; ROADMAP queue 3), so the reference is
    JAX's forward under central differences (step 1e-4, truncation error
    ~2e-8 relative measured) on the glass sphere (index 7), at 6 bounces,
    where paths through the glass reach the light; rtol 1e-6."""
    sc = scenes.smallpt9()
    jdev = jx_mk.scene_to_device(sc, dtype=np.float64)
    tdev = convert.scene_dict_from_numpy(jdev, dtype=torch.float64)
    key = jax.random.PRNGKey(2)
    out = {}

    def port_grads(rays, bounces, leaves):
        u = convert.uniforms_from_numpy(
            _jax_draws(key, bounces, 3, rays.shape[0], jnp.float64), dtype=torch.float64)
        ps = {k: tdev[k].clone().requires_grad_(True) for k in leaves}
        megakernel.render_pt_impl(torch.tensor(rays), dict(tdev, **ps), bounces=bounces,
                                  rr_depth=99, uniforms=u).mean().backward()
        return {k: p.grad.numpy() for k, p in ps.items()}

    rays = camera.generate_rays_numpy(8, 8, 1, seed=1)
    leaves = ("albedo", "emission")
    gj = jax.jit(jax.grad(
        lambda a, e: jnp.mean(jx_mk.render_pt_impl(
            key, jnp.asarray(rays), dict(jdev, albedo=a, emission=e), bounces=3,
            rr_depth=99)),
        argnums=(0, 1)))(jdev["albedo"], jdev["emission"])
    got = port_grads(rays, 3, leaves)
    for k, g in zip(leaves, gj):
        out[k] = (got[k], np.asarray(g), 1e-9)

    rays = camera.generate_rays_numpy(16, 16, 1, seed=1)
    fwd = jax.jit(lambda c, r2: jnp.mean(jx_mk.render_pt_impl(
        key, jnp.asarray(rays), dict(jdev, center=c, r2=r2), bounces=6, rr_depth=99)))
    c0, r0 = np.asarray(jdev["center"]), np.asarray(jdev["r2"])

    def fd(dc, dr, h=1e-4):
        return (float(fwd(c0 + h * dc, r0 + h * dr))
                - float(fwd(c0 - h * dc, r0 - h * dr))) / (2 * h)

    got = port_grads(rays, 6, ("center", "r2"))
    unit_c = [np.zeros_like(c0) for _ in range(3)]
    for j in range(3):
        unit_c[j][7, j] = 1.0
    unit_r = np.zeros_like(r0)
    unit_r[7] = 1.0
    out["center"] = (got["center"][7], np.array([fd(u, 0 * r0) for u in unit_c]), 1e-6)
    out["r2"] = (got["r2"][7:8], np.array([fd(0 * c0, unit_r)]), 1e-6)
    out["all_finite"] = all(np.isfinite(g).all() for g in got.values())
    return out


@pytest.mark.parametrize("leaf", ["albedo", "emission", "center", "r2"])
def test_pt_autograd_matches_jax(pt_grads, leaf):
    got, ref, rtol = pt_grads[leaf]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-15)
    assert np.abs(ref).max() > 0 and pt_grads["all_finite"]


def test_pt_impl_draws_its_own_stream():
    """uniforms=None: the estimator stream keyed by (seed, ray, bounce),
    deterministic for a seed, different across seeds, and equal to
    passing that stream in."""
    _, _, rays, tdev, rays_t = _pt_pair("cornell8", 8, 1, dtype=np.float32)
    a = megakernel.render_pt_impl(rays_t, tdev, bounces=4, seed=3)
    assert torch.equal(a, megakernel.render_pt_impl(rays_t, tdev, bounces=4, seed=3))
    assert not torch.equal(a, megakernel.render_pt_impl(rays_t, tdev, bounces=4, seed=4))
    idx = torch.arange(rays.shape[0])
    u = torch.stack([rng.uniforms(3, idx, k, 3, stream=rng.STREAM_ESTIMATOR,
                                  dtype=torch.float32) for k in range(4)])
    assert torch.equal(a, megakernel.render_pt_impl(rays_t, tdev, bounces=4, uniforms=u))
    with pytest.raises(ValueError, match="uniforms"):
        megakernel.render_pt_impl(rays_t, tdev, bounces=4, uniforms=u[:3])
