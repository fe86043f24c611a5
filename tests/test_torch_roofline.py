"""The port's op counter (``utils/roofline.count_ops``, a
TorchDispatchMode over eager aten ops) on functions with hand-checkable
counts, each against the JAX package's ``count_ops`` of the same function
where the classes match (``tests/test_roofline.py``'s cases that carry
over), the cases where eager torch differs stated as such, the
classification rules, and ``other`` empty for the twins of the reference,
PT and mesh-PT kernels at a small size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu.utils import roofline as jax_rl
from ascendpathtracing_tpu_torch import bench, camera, convert, scenes
from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt
from ascendpathtracing_tpu_torch.ops import pt_kernels as ptk
from ascendpathtracing_tpu_torch.ops import render_kernels as rk
from ascendpathtracing_tpu_torch.ops.intersect import sqrt_rn
from ascendpathtracing_tpu_torch.utils import roofline as rl

CLASSES = ("flops", "hard", "vops", "mxu_flops", "mem_elems", "hard_by_prim")


def _same_classes(port, ref, keys=CLASSES):
    for k in keys:
        assert getattr(port, k) == getattr(ref, k), (k, getattr(port, k), getattr(ref, k))


def test_simple_elementwise_counts():
    c = rl.count_ops(lambda x: x * 2.0 + 1.0, torch.ones((8, 16)))
    assert c.flops == 2 * 8 * 16
    assert c.hard == 0 and c.vops == 0 and not c.other
    _same_classes(c, jax_rl.count_ops(lambda x: x * 2.0 + 1.0, jnp.ones((8, 16))),
                  ("flops", "hard", "vops", "mxu_flops"))


def test_classes_hard_and_vops():
    def f(x, sqrt, where):
        y = sqrt(x)              # hard (8)
        z = where(x > y, x, y)   # gt (8) + where/select_n (8) vops
        return z / x             # hard (8)

    c = rl.count_ops(f, torch.ones((8,)), torch.sqrt, torch.where)
    assert c.hard == 16 and c.vops == 16
    assert c.hard_by_prim == {"sqrt": 8.0, "div": 8.0}
    _same_classes(c, jax_rl.count_ops(lambda x: f(x, jnp.sqrt, jnp.where), jnp.ones((8,))),
                  ("flops", "hard", "vops", "hard_by_prim"))


def test_python_loop_counts_each_trip_as_jax_scan_does():
    def f(x):
        for _ in range(7):
            x = x * 1.5 + 1.0
        return x

    def scan(x):
        out, _ = jax.lax.scan(lambda c, _: (c * 1.5 + 1.0, None), x, None, length=7)
        return out

    c = rl.count_ops(f, torch.ones((16,)))
    assert c.flops == 7 * 2 * 16
    _same_classes(c, jax_rl.count_ops(scan, jnp.ones((16,))), ("flops", "hard", "vops"))


def test_python_loop_has_no_loop_counter():
    """JAX's fori_loop also counts its counter's increment, one flop a
    trip (5 x (16 + 1)); the eager loop's counter is a Python int, so the
    port counts 5 x 16: five fewer."""
    def f(x):
        for _ in range(5):
            x = x * 2.0
        return x

    c = rl.count_ops(f, torch.ones((16,)))
    ref = jax_rl.count_ops(lambda x: jax.lax.fori_loop(0, 5, lambda i, c: c * 2.0, x),
                           jnp.ones((16,)))
    assert c.flops == 5 * 16 and ref.flops == 5 * (16 + 1)
    assert ref.flops - c.flops == 5


def test_matmul_mxu_flops():
    c = rl.count_ops(lambda a, b: a @ b, torch.ones((8, 32)), torch.ones((32, 16)))
    assert c.mxu_flops == 2 * 8 * 16 * 32 and c.flops == 0
    _same_classes(c, jax_rl.count_ops(lambda a, b: a @ b, jnp.ones((8, 32)),
                                      jnp.ones((32, 16))), ("flops", "mxu_flops"))
    # batched, with bias, matrix-vector and dot: 2.B.M.N.K
    assert rl.count_ops(torch.bmm, torch.ones(3, 8, 32), torch.ones(3, 32, 16)).mxu_flops \
        == 2 * 3 * 8 * 16 * 32
    assert rl.count_ops(torch.addmm, torch.ones(8, 16), torch.ones(8, 32),
                        torch.ones(32, 16)).mxu_flops == 2 * 8 * 16 * 32
    assert rl.count_ops(torch.matmul, torch.ones(3, 8, 32), torch.ones(32, 16)).mxu_flops \
        == 2 * 3 * 8 * 16 * 32
    assert rl.count_ops(torch.mv, torch.ones(8, 32), torch.ones(32)).mxu_flops == 2 * 8 * 32
    assert rl.count_ops(torch.dot, torch.ones(32), torch.ones(32)).mxu_flops == 2 * 32


def test_reduce_counts_input_elems():
    c = rl.count_ops(lambda x: torch.sum(x), torch.ones((8, 128)))
    assert c.flops == 8 * 128
    _same_classes(c, jax_rl.count_ops(lambda x: jnp.sum(x), jnp.ones((8, 128))),
                  ("flops", "hard", "vops"))


def test_fwd_bwd_counts_more_than_fwd():
    def fwd(x):
        return (x * x).sum()

    def both(x):
        x = x.clone().requires_grad_(True)
        loss = fwd(x)
        loss.backward()
        return loss, x.grad

    c_fwd = rl.count_ops(fwd, torch.ones((16,)))
    c_both = rl.count_ops(both, torch.ones((16,)))
    assert c_both.flops > c_fwd.flops
    jf = jax_rl.count_ops(lambda x: jnp.sum(x * x), jnp.ones((16,)))
    jb = jax_rl.count_ops(jax.value_and_grad(lambda x: jnp.sum(x * x)), jnp.ones((16,)))
    assert jb.flops > jf.flops and c_fwd.flops == jf.flops


def test_in_place_counts_like_out_of_place():
    def out_of_place(x):
        return (x + 1.0) * 2.0

    def in_place(x):
        return x.clone().add_(1.0).mul_(2.0)

    a, b = rl.count_ops(out_of_place, torch.ones(32)), rl.count_ops(in_place, torch.ones(32))
    assert a.flops == b.flops == 64
    assert b.mem_elems == 32  # the clone


def test_max_min_binary_or_reduction_and_converts():
    x, y = torch.rand(4, 8), torch.rand(4, 8)
    assert rl.count_ops(torch.max, x, y).flops == 32  # elementwise: outputs
    assert rl.count_ops(lambda a: torch.max(a, dim=0), x).flops == 32  # reduction: inputs
    assert rl.count_ops(lambda a: torch.min(a), x).flops == 32
    c = rl.count_ops(lambda a: a.double(), x)
    assert c.vops == 32 and c.mem_elems == 0  # a dtype convert
    c = rl.count_ops(lambda a: a.to("cpu", copy=True), x)
    assert c.vops == 0 and c.mem_elems == 32  # a copy


def test_cross_product_counts_as_jax_does():
    """A cross product's component: two multiplies and a subtract."""
    c = rl.count_ops(torch.linalg.cross, torch.ones(5, 3), torch.ones(5, 3))
    assert c.flops == 3 * 5 * 3
    _same_classes(c, jax_rl.count_ops(jnp.cross, jnp.ones((5, 3)), jnp.ones((5, 3))),
                  ("flops", "hard", "vops"))


def test_unclassified_ops_land_in_other():
    c = rl.count_ops(lambda a: torch.sort(a).values, torch.rand(64))
    assert c.other == {"sort": 128.0}


def test_sqrt_rn_counts_as_one_sqrt_on_the_cpu():
    """sqrt_rn runs NumPy on the CPU; the counter sees it as the op
    aptport::sqrt_rn and counts one sqrt per element, as torch.sqrt on a
    card, in the forward and (its backward: a mul and a div) the
    backward."""
    x = torch.rand(8, dtype=torch.float64) + 0.5
    rn, ref = rl.count_ops(sqrt_rn, x), rl.count_ops(torch.sqrt, x)
    assert rn.hard_by_prim == ref.hard_by_prim == {"sqrt": 8.0}
    _same_classes(rn, ref)

    def fwd_bwd(sqrt):
        def run(x):
            x = x.clone().requires_grad_(True)
            sqrt(x).sum().backward()
            return x.grad
        return run

    _same_classes(rl.count_ops(fwd_bwd(sqrt_rn), x), rl.count_ops(fwd_bwd(torch.sqrt), x))


# ---------------------------------------------------------- twins ----
def _twin_call(name):
    sc = scenes.cornell8()
    kw = dict(light_index=sc.light_index, bounces=8)
    sp = convert.scene_planes_from_numpy(sc.soa10())
    rp = convert.rays_planes_from_numpy(camera.generate_rays_numpy(16, 16, 1, seed=0)
                                        .astype(np.float32))
    if name == "ref_fwd_idx":
        return lambda: rk.render_reference_planes_with_idx_plain(rp, sp, **kw)
    if name == "ref_bwd_replay":
        _, idx = rk.render_reference_planes_with_idx_plain(rp, sp, **kw)
        g = torch.ones((3, rp.shape[1]))
        return lambda: rk.render_ref_bwd_replay_plain(idx, sp, g, **kw)
    if name == "pt":
        mats = torch.tensor(sc.material, dtype=torch.int32)
        return lambda: ptk.render_pt_plain(sp, mats, width=8, height=8, spp4=4, bounces=8)
    pl, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(bench.mesh_scene(1))
    return lambda: mpt.render_pt_mesh_plain(pl, cb, sb, t24, materials=mats, width=8,
                                            height=8, spp4=4, bounces=3,
                                            **mpt.pt_tables_kwargs(grid))


@pytest.mark.parametrize("name", ["ref_fwd_idx", "ref_bwd_replay", "pt", "mesh_pt"])
def test_twins_have_no_unclassified_ops(name):
    c = rl.count_ops(_twin_call(name))
    assert not c.other, c.other
    assert c.flops > 0 and c.vops > 0 and c.mem_elems > 0
    assert (c.hard > 0) == (name != "ref_bwd_replay")  # the replay takes no sqrt or div
    assert set(c.as_dict()) == {"flops", "hard", "vops", "vpu_slots", "mxu_flops",
                                "mem_elems", "hard_by_prim", "other"}
    assert c.vpu_slots == c.flops + c.hard + c.vops


def _autograd_step(name):
    rays = camera.generate_rays_numpy(8, 8, 1, seed=0).astype(np.float32)
    if name == "reference":
        return bench.make_step("plain", False, convert.rays_planes_from_numpy(rays),
                               scenes.cornell8(), bounces=8)
    if name == "pt":
        return bench.make_pt_step("plain", False, scenes.smallpt9(), device=torch.device("cpu"),
                                  bounces=8, rays=torch.tensor(rays))
    from ascendpathtracing_tpu_torch.diff import mesh as dm
    from ascendpathtracing_tpu_torch.models import mesh as mm

    ms = bench.mesh_scene(1)
    params = {k: v.requires_grad_(True) for k, v in dm.mesh_params(ms).items()}
    dev, faces = mm.mesh_scene_to_device(ms, use_bvh=False), torch.tensor(ms.faces)

    def step():
        img = dm.render_pt_mesh_params(torch.tensor(rays), params, dev, faces, bounces=3)
        return torch.autograd.grad(img.sum(), list(params.values()), allow_unused=True)
    return step


@pytest.mark.parametrize("name", ["reference", "pt", "mesh"])
def test_autograd_steps_have_no_unclassified_ops(name):
    """The plain fwd+bwd steps (the bench's reference and PT steps, the
    bounce-loop mesh render through diff/mesh): autograd's backward ops
    (select_backward and the like) are classified too."""
    c = rl.count_ops(_autograd_step(name))
    assert not c.other, c.other
    assert c.flops > 0 and c.hard > 0 and c.mem_elems > 0
