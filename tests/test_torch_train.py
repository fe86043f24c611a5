"""The port's trainer on the CPU against the JAX package: the single-device
SGD step (parallel/sharded.make_train_step(None)) against JAX's in
float64, checkpoint and resume (utils/checkpoint, a copy of the JAX
module) bit for bit and across the two packages, and the CLI's train and
oracle commands against the JAX CLI's."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu import camera as jax_camera
from ascendpathtracing_tpu import cli as jax_cli
from ascendpathtracing_tpu import scenes as jax_scenes
from ascendpathtracing_tpu.models import megakernel as jax_mk
from ascendpathtracing_tpu.parallel import sharded as jax_sharded
from ascendpathtracing_tpu.utils import checkpoint as jax_ckpt
from ascendpathtracing_tpu_torch import camera, cli, scenes
from ascendpathtracing_tpu_torch.models import megakernel
from ascendpathtracing_tpu_torch.ops import render_kernels as rk
from ascendpathtracing_tpu_torch.parallel import sharded
from ascendpathtracing_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_slice import one_cpu_thread  # noqa: F401  (autouse)

BOUNCES, LR = 3, 0.05


def _port_problem(w, dtype, bounces=BOUNCES):
    """(params with albedo + 0.08, aux, rays [N, 6], target [N, 3]) of the
    CLI's train problem at w x w pixels, one tent quad a pixel."""
    rays = torch.tensor(jax_camera.generate_rays_numpy(w, w, 1, seed=0), dtype=dtype)
    scene = megakernel.scene_to_device(scenes.cornell8(), dtype=dtype)
    target = rk.render_reference(rays, sharded.params_to_planes(scene),
                                 light_index=scene["light_index"], bounces=bounces)
    params, aux = sharded.split_scene_params(scene)
    return dict(params, albedo=params["albedo"] + 0.08), aux, rays, target


def test_train_step_matches_jax_float64():
    """Five steps at 8 x 8 x 4 rays, 3 bounces, lr 0.05, float64: the loss
    of every step and every parameter after the fifth allclose at 1e-12
    to jax.value_and_grad of the XLA bounce loop; center and r2 keep their
    values in both (their gradients are exact zeros)."""
    rays = jax_camera.generate_rays_numpy(8, 8, 1, seed=0)
    jscene = jax_mk.scene_to_device(jax_scenes.cornell8(), dtype=jnp.float64)
    jr = jnp.asarray(rays, jnp.float64)
    jtarget = jax_mk.render_reference(jr, jscene, bounces=BOUNCES)
    jp, jaux = jax_sharded.split_scene_params(jscene)
    jp = dict(jp, albedo=jp["albedo"] + 0.08)
    jstep = jax_sharded.make_train_step(None, bounces=BOUNCES, learning_rate=LR)
    params, aux, r, target = _port_problem(8, torch.float64)
    np.testing.assert_array_equal(target.numpy(), np.asarray(jtarget))
    step = sharded.make_train_step(None, bounces=BOUNCES, learning_rate=LR)
    for _ in range(5):
        jl, jp = jstep(jp, jaux, jr, jtarget)
        loss, params = step(params, aux, r, target)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-12, atol=0)
    for k in sharded.PARAM_KEYS:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jp[k]), rtol=1e-12, atol=1e-15)
    for k in ("center", "r2"):
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(jscene[k]))
        np.testing.assert_array_equal(np.asarray(jp[k]), np.asarray(jscene[k]))
    assert float(loss) < float(jl) * 1.0000001 and not np.array_equal(
        params["albedo"].numpy(), np.asarray(jscene["albedo"]) + 0.08)


def test_train_step_goes_through_the_kernels_wrappers(monkeypatch):
    """One step calls the reference kernels' forward with winners and
    replay backward (their twins on the CPU), each once."""
    calls = []
    for name in ("render_reference_planes_with_idx", "render_ref_bwd_replay"):
        fn = getattr(rk, name)
        monkeypatch.setattr(rk, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                                         _fn(*a, **k))[1])
    params, aux, r, target = _port_problem(4, torch.float32)
    loss, new = sharded.make_train_step(None, bounces=2)(params, aux, r, target)
    assert calls == ["render_reference_planes_with_idx", "render_ref_bwd_replay"]
    assert loss.dim() == 0 and set(new) == set(sharded.PARAM_KEYS)


def test_train_problem_layout_reads_in_place_and_steps_alike():
    """cli.train_problem's rays and target are transposed views of the
    kernels' planes; a step on them gives the parameters of a step on
    contiguous [N, 6] and [N, 3] copies bit for bit (the loss is a mean
    taken in another order: to 1e-6)."""
    rays, scene, target = cli.train_problem(8, 8, 2, torch.device("cpu"))
    assert rays.shape == (256, 6) and rays.T.is_contiguous() and target.T.is_contiguous()
    params, aux = sharded.split_scene_params(scene)
    params = dict(params, albedo=params["albedo"] + 0.08)
    step = sharded.make_train_step(None, bounces=2)
    la, pa = step(params, aux, rays, target)
    lb, pb = step(params, aux, rays.contiguous(), target.contiguous())
    assert all(torch.equal(pa[k], pb[k]) for k in sharded.PARAM_KEYS)
    np.testing.assert_allclose(float(la), float(lb), rtol=1e-6)


def test_make_train_step_over_a_one_rank_mesh_equals_single_device():
    """The mesh step is ported now (tests/test_torch_parallel.py holds it
    against JAX's): over a one-rank mesh's stand-in it equals the
    single-device step, the loss a global mean and one all-reduce of
    loss and gradient (here over the one rank, a no-op)."""
    scene = megakernel.scene_to_device(scenes.cornell8(), dtype=torch.float64)
    rays = torch.tensor(camera.generate_rays_numpy(8, 8, 1, seed=0))
    target = megakernel.render_reference_impl(rays, scene, bounces=3) * 0.9
    params, aux = sharded.split_scene_params(scene)

    class OneRank:  # DeviceMesh.size() of a one-rank mesh
        def size(self):
            return 1

    summed = []

    def all_reduce(t, group=None):
        summed.append(t.clone())
        return t

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sharded.dist, "all_reduce", all_reduce)
        la, pa = sharded.make_train_step(OneRank(), bounces=3)(params, aux, rays, target)
    lb, pb = sharded.make_train_step(None, bounces=3)(params, aux, rays, target)
    assert len(summed) == 1 and summed[0].shape == (1 + 10 * 8,)
    np.testing.assert_allclose(float(la), float(lb), rtol=1e-12)
    for k in pa:
        np.testing.assert_allclose(pa[k].numpy(), pb[k].numpy(), rtol=1e-12, atol=1e-15)


def test_params_planes_round_trip():
    scene = megakernel.scene_to_device(scenes.cornell8())
    params, aux = sharded.split_scene_params(scene)
    assert set(aux) == {"material", "light_index"}
    planes = sharded.params_to_planes(params)
    np.testing.assert_array_equal(planes.numpy(), scenes.cornell8().soa10())
    back = sharded.planes_to_params(planes)
    assert all(torch.equal(back[k], params[k]) for k in sharded.PARAM_KEYS)


def test_split_run_with_checkpoint_equals_a_straight_run_bitwise(tmp_path):
    """tests/test_checkpoint.py:32 on the port, float32, 8 x 8, 2 bounces:
    10 steps, checkpoint, reload, 10 steps leave the parameters of a
    straight 20 bit for bit."""
    params0, aux, r, target = _port_problem(8, torch.float32, bounces=2)
    step = sharded.make_train_step(None, bounces=2, learning_rate=0.05)
    pa = dict(params0)
    for _ in range(20):
        _, pa = step(pa, aux, r, target)
    pb = dict(params0)
    for _ in range(10):
        _, pb = step(pb, aux, r, target)
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, pb, step=10)
    pb2, at, _ = ckpt.load_checkpoint(path)
    assert at == 10
    pb2 = {k: torch.tensor(v) for k, v in pb2.items()}
    for _ in range(10):
        _, pb2 = step(pb2, aux, r, target)
    for k in sharded.PARAM_KEYS:
        assert torch.equal(pa[k], pb2[k]), k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_written_by_either_package_loads_in_the_other(tmp_path, rng, writer):
    """np.savez stamps its members with the time, so the files differ in
    bytes: a file written by either package loads in both with equal
    arrays (dtypes too), step, extra and tree shape."""
    tree = {"albedo": rng.rand(8, 3).astype(np.float32),
            "nested": {"a": rng.rand(4), "b": [rng.rand(2), rng.rand(3)]},
            "tup": (rng.rand(5), {"x": rng.rand(1).astype(np.float32)})}
    path = str(tmp_path / f"{writer}.npz")
    if writer == "jax":
        jax_ckpt.save_checkpoint(path, tree, step=7, extra={"note": "hi"})
    else:
        ported = {**tree, "albedo": torch.tensor(tree["albedo"])}
        ckpt.save_checkpoint(path, ported, step=7, extra={"note": "hi"})
    (a, sa, ea), (b, sb, eb) = ckpt.load_checkpoint(path), jax_ckpt.load_checkpoint(path)
    assert sa == sb == 7 and ea == eb == {"note": "hi"}
    assert isinstance(a["nested"]["b"], list) and isinstance(a["tup"], tuple)
    assert isinstance(b["nested"]["b"], list) and isinstance(b["tup"], tuple)
    for x, y, z in ((a["albedo"], b["albedo"], tree["albedo"]),
                    (a["nested"]["b"][1], b["nested"]["b"][1], tree["nested"]["b"][1]),
                    (a["tup"][1]["x"], b["tup"][1]["x"], tree["tup"][1]["x"])):
        assert x.dtype == y.dtype == z.dtype
        np.testing.assert_array_equal(x, z)
        np.testing.assert_array_equal(y, z)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_train_and_resume(tmp_path, capsys):
    """tests/test_cli.py:52 on the port through main(): 6 steps with a
    checkpoint every 3, then --resume for 3 (stderr says so); the JSON
    line has the JAX CLI's keys.  The two CLIs' float32 losses are not
    compared: XLA's and the port's float32 arithmetic send a few rays'
    trails to other spheres (tests/test_reference_parity.py), and a trail
    that ends on the light or not moves the loss by 10% at this size; the
    step is held to JAX's in float64 above."""
    ck = str(tmp_path / "ck.npz")
    args = ["train", "--backend", "cpu", "--width", "8", "--height", "8", "--bounces", "2"]
    assert cli.main([*args, "--steps", "6", "--ckpt", ck, "--ckpt-every", "3"]) == 0
    out = _last_json(capsys)
    assert np.isfinite(out["final_loss"]) and (tmp_path / "ck.npz").exists()
    assert jax_cli.main([*args, "--steps", "6", "--ckpt", str(tmp_path / "j.npz"),
                         "--ckpt-every", "3"]) == 0
    ref = _last_json(capsys)
    assert set(out) == set(ref) and out["steps"] == ref["steps"] == 6
    assert np.isfinite(ref["final_loss"]) and out["ckpt"] == ck
    assert cli.main([*args, "--steps", "3", "--ckpt", ck, "--resume"]) == 0
    captured = capsys.readouterr()
    assert f"resumed from {ck} at step 6" in captured.err
    assert json.loads(captured.out.strip().splitlines()[-1])["steps"] == 3
    _, at, _ = ckpt.load_checkpoint(ck)
    assert at == 9


def test_cli_train_resumes_from_a_jax_checkpoint(tmp_path, capsys):
    """A checkpoint the JAX CLI wrote resumes in the port's CLI."""
    ck = str(tmp_path / "ck.npz")
    args = ["train", "--backend", "cpu", "--width", "8", "--height", "8", "--bounces", "2",
            "--ckpt", ck]
    assert jax_cli.main([*args, "--steps", "4"]) == 0
    assert cli.main([*args, "--steps", "2", "--resume"]) == 0
    assert "at step 4" in capsys.readouterr().err
    assert ckpt.load_checkpoint(ck)[1] == 6


@pytest.mark.parametrize("argv", [[], ["--width", "12", "--height", "12", "--samples", "2",
                                       "--bounces", "3", "--seed", "4", "--scene", "smallpt9"]])
def test_cli_oracle_byte_equal_to_the_jax_cli(tmp_path, capsys, argv):
    assert cli.main(["oracle", *argv, "--out", str(tmp_path / "port")]) == 0
    port = _last_json(capsys)
    assert jax_cli.main(["oracle", *argv, "--out", str(tmp_path / "jax")]) == 0
    ref = _last_json(capsys)
    assert port["rays"] == ref["rays"]
    for name in ("oracle_color.bin", "oracle_color.ppm"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
