"""The port's slice as a whole: CLI artifacts byte for byte against the JAX
package's CLI, one fwd+bwd step against JAX value_and_grad, the entry
points' refusals, and that importing the port loads no jax."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu import camera, scenes
from ascendpathtracing_tpu import cli as jax_cli
from ascendpathtracing_tpu.ops import pallas_kernels as pk
from ascendpathtracing_tpu_torch import bench, cli, convert
from ascendpathtracing_tpu_torch.ops import render_kernels as rk

REPO = Path(__file__).resolve().parents[1]
@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """torch on one CPU thread for each module that holds this fixture
    (the heavy torch test files import it): the test workers share the
    machine's cores, and eight threads in each of them spend the many
    small ops of the plain twins waiting on one another (the selftest
    test took 357 s with eight threads under six workers, 73 s with
    one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARTIFACTS = ("rays.bin", "spheres.bin", "color.bin", "color.ppm")


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")


def _json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_render_artifacts_byte_identical_to_jax_cli(tmp_path, capsys):
    size = ["--width", "32", "--height", "32", "--bounces", "1"]
    assert cli.main(["render", "--backend", "cpu", *size, "--oracle",
                     "--out", str(tmp_path / "port")]) == 0
    port = _json_line(capsys)
    assert jax_cli.main(["render", "--renderer", "pallas", "--backend", "cpu",
                         *size, "--oracle", "--out", str(tmp_path / "jax")]) == 0
    ref = _json_line(capsys)
    assert set(port) == set(ref)
    assert port["oracle_rays_bitexact"] == ref["oracle_rays_bitexact"] == 1.0
    for name in ARTIFACTS:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


def test_cli_plain_renderer_writes_the_same_colors(tmp_path, capsys):
    args = ["render", "--backend", "cpu", "--width", "16", "--height", "16",
            "--bounces", "8", "--check-finite"]
    assert cli.main([*args, "--renderer", "kernel", "--out", str(tmp_path / "k")]) == 0
    assert cli.main([*args, "--renderer", "plain", "--out", str(tmp_path / "p")]) == 0
    for name in ARTIFACTS:
        assert (tmp_path / "k" / name).read_bytes() == (tmp_path / "p" / name).read_bytes()
    assert _json_line(capsys)["renderer"] == "plain"


def test_fwd_bwd_step_matches_jax_value_and_grad():
    """One step of the main path (8 bounces, replay VJP) at 16x16 against
    jax.value_and_grad of make_render_reference_pallas_diff.  float32
    winners flip by rounding on some rays (tests/test_reference_parity.py);
    the loss weights those rays by 0 on both sides, so every compared ray
    has the same winners and the same ordered albedo product."""
    scene = scenes.cornell8()
    rays = camera.generate_rays_numpy(16, 16, 1, seed=0).astype(np.float32)
    planes = scene.soa10()
    rp_j, pl_j = jnp.asarray(rays.T.copy()), jnp.asarray(planes)
    _, jidx = pk.render_reference_pallas_planes_with_idx(
        rp_j, pl_j, light_index=7, bounces=8, tile=1024, interpret=True
    )
    rp, sp = convert.rays_planes_from_numpy(rays), convert.scene_planes_from_numpy(planes)
    _, idx = rk.render_reference_planes_with_idx(rp, sp, light_index=7, bounces=8)
    agree = (np.asarray(jidx) == idx.numpy()).all(axis=0)
    assert agree.mean() >= 0.3, f"only {agree.mean():.1%} of trails agree"
    w = np.broadcast_to(agree, (3, agree.size)).astype(np.float32)

    render_j = pk.make_render_reference_pallas_diff(
        light_index=7, bounces=8, tile=1024, interpret=True
    )
    val_j, grad_j = jax.value_and_grad(
        lambda p: jnp.sum(render_j(rp_j, p) * jnp.asarray(w))
    )(pl_j)

    model = rk.RenderReference(sp, light_index=7, bounces=8)
    loss = (model(rp) * torch.tensor(w)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(val_j), rtol=1e-6)
    np.testing.assert_allclose(
        model.scene_planes.grad.numpy(), np.asarray(grad_j), rtol=1e-4, atol=1e-3
    )


def test_importing_the_port_loads_no_jax():
    """Importing every module of the port (the sharded ``parallel.*`` and
    ``graft_entry`` among them), chip_smoke, the card-only tests
    (tests/test_torch_cuda.py) and the sharded tests' rank side
    (tests/test_torch_parallel_ranks.py), a CPU mesh render with its replay
    backward, a CPU bounce-loop mesh render with its autograd backward
    (diff/mesh), a CPU camera-gradient render (diff/camera_fused), CPU
    renders of both wavefronts, and the CLI's train (with --resume),
    oracle and post-processed render on the CPU load no jax and no module
    of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ascendpathtracing_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import tests.test_torch_cuda, tests.test_torch_parallel_ranks\n"
        "from ascendpathtracing_tpu_torch import cli\n"
        "assert cli.mesh_vjp_check(__import__('torch').device('cpu'))['ok']\n"
        "import numpy, torch\n"
        "from ascendpathtracing_tpu_torch import bench, camera\n"
        "from ascendpathtracing_tpu_torch.diff import mesh as dm\n"
        "from ascendpathtracing_tpu_torch.models import mesh as mm\n"
        "ms = bench.mesh_scene(1)\n"
        "prm = {k: v.requires_grad_(True) for k, v in dm.mesh_params(ms).items()}\n"
        "rays = torch.tensor(camera.generate_rays_numpy(8, 8, 1).astype(numpy.float32))\n"
        "for kw in ({'pallas_bvh_kernel': True}, {'use_bvh': False}):\n"
        "    dev = mm.mesh_scene_to_device(ms, **kw)\n"
        "    img = dm.render_pt_mesh_params(rays, prm, dev, torch.tensor(ms.faces))\n"
        "    g = torch.autograd.grad(img.sum(), [prm['face_emission']])[0]\n"
        "    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0\n"
        "for kw in ({'use_bvh': True}, {'pallas_bvh_kernel': True, 'pallas_kernel': 'lockstep'}):\n"
        "    assert mm.render_pt_mesh(rays, mm.mesh_scene_to_device(ms, **kw)).shape == (256, 3)\n"
        "from ascendpathtracing_tpu_torch.diff import CameraParams, camera_fused as cf\n"
        "from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt\n"
        "pl, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(ms)\n"
        "cam = {k: v.requires_grad_(True) for k, v in CameraParams().items()}\n"
        "_, depth, _ = cf.render_with_camera(cam, pl, cb, sb, t24, materials=mats, width=8,\n"
        "    height=8, spp4=4, bounces=2, **mpt.pt_tables_kwargs(grid))\n"
        "g = torch.autograd.grad(depth.mean(), [cam['pos']])[0]\n"
        "assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0\n"
        "from ascendpathtracing_tpu_torch import scenes\n"
        "from ascendpathtracing_tpu_torch.models import megakernel as mk, wavefront as wf\n"
        "wkw = dict(width=4, height=4, spp4=4, pool=40, bounces=3)\n"
        "assert wf.render_wavefront(0, mk.scene_to_device(scenes.cornell8()), **wkw).shape == (16, 3)\n"
        "assert wf.render_wavefront_mesh(0, mm.mesh_scene_to_device(ms), **wkw).shape == (16, 3)\n"
        "import tempfile\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    small = ['--width', '8', '--height', '8']\n"
        "    assert cli.main(['train', '--backend', 'cpu', *small, '--steps', '2',\n"
        "                     '--ckpt', d + '/c.npz']) == 0\n"
        "    assert cli.main(['train', '--backend', 'cpu', *small, '--steps', '1',\n"
        "                     '--ckpt', d + '/c.npz', '--resume']) == 0\n"
        "    assert cli.main(['oracle', *small, '--out', d]) == 0\n"
        "    assert cli.main(['render', '--backend', 'cpu', *small, '--denoise', '1',\n"
        "                     '--tonemap', 'aces', '--clamp', '4', '--aov', 'gbuffer',\n"
        "                     '--check-finite', '--out', d]) == 0\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "ref = sorted(k for k in sys.modules if k == 'ascendpathtracing_tpu'\n"
        "             or k.startswith('ascendpathtracing_tpu.'))\n"
        "assert not ref, ref\n"
        "print(len(mods))\n"
        "new = {'accel.tri', 'models.mesh', 'ops.chunk_grid', 'ops.wbvh_kernels',\n"
        "       'ops.mesh_pt_kernels', 'ops.histogram_kernels', 'diff.mesh_fused',\n"
        "       'config', 'scenes', 'camera', 'oracle', 'utils.io', 'accel.meshes',\n"
        "       'accel.bvh', 'ops.bvh_kernels', 'ops.sort', 'diff.mesh', 'diff.camera',\n"
        "       'diff.fd', 'diff.camera_fused', 'post', 'utils.debug',\n"
        "       'utils.checkpoint', 'parallel.sharded', 'models.wavefront', 'parallel.mesh',\n"
        "       'parallel.distributed', 'parallel.assembly', 'parallel.pipeline', 'graft_entry'}\n"
        "assert {p.__name__ + '.' + m for m in new} <= set(mods), mods\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300, check=False,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 44


def test_backend_cuda_exits_2_without_cuda(no_cuda, tmp_path, capsys):
    assert cli.main(["render", "--backend", "cuda", "--out", str(tmp_path)]) == 2
    assert cli.main(["selftest", "--backend", "cuda"]) == 2
    assert bench.main([]) == 2
    assert bench.main(["--mode", "pt"]) == 2
    assert bench.main(["--mode", "mesh"]) == 2
    assert bench.main(["--mode", "pt", "--renderer", "wavefront"]) == 2
    assert cli.main(["render", "--renderer", "wavefront", "--mode", "pt", "--backend", "cuda",
                     "--out", str(tmp_path)]) == 2
    assert "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "color.bin").exists()


@pytest.mark.parametrize(
    "argv,message",
    [
        # The JAX CLI's own refusal for mesh scenes outside pt mode.
        (["render", "--scene", "mesh-cube", "--mode", "reference"],
         "mesh scenes require --mode pt"),
        # --shard N must divide the ray count (16 x 16 x 4 = 1,024 here).
        (["render", "--shard", "3"], "must divide the ray count"),
        # --shard renders the reference mode through the kernel renderer.
        (["render", "--mode", "pt", "--renderer", "plain", "--shard", "2"],
         "--shard renders --mode reference"),
        # The JAX CLI's own refusal for its kernel renderer (cli.py:253-256).
        (["render", "--mode", "pt", "--renderer", "kernel"],
         "supports --mode reference only"),
    ],
)
def test_unported_modes_exit_2(argv, message, tmp_path, capsys):
    assert cli.main([*argv, "--backend", "cpu", "--out", str(tmp_path)]
                    if argv[0] == "render" else argv) == 2
    assert message in capsys.readouterr().err
    assert not (tmp_path / "color.bin").exists()


def test_selftest_passes_on_cpu(capsys):
    assert cli.main(["selftest", "--backend", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines[-1] == {"selftest": "PASS", "passed": 8, "ran": 8, "backend": "cpu"}
    assert lines[3]["check"] == "pt_fused_energy_vs_plain" and lines[3]["rel_diff"] < 0.025
    assert lines[4]["check"] == "wbvh_chunks_vs_brute" and lines[4]["max_t_err"] < 1e-3
    assert lines[5]["check"] == "mesh_pt_fused_energy_vs_xla" and lines[5]["ok"]
    assert lines[5]["rel_diff"] < 0.03 and lines[5]["xla_mean"] > 0
    assert lines[6]["check"] == "mesh_fused_vjp_grads" and lines[6]["geom_rows_zero"]
    assert lines[7] == {"check": "checkify_float_guards", "ok": True, "clean_pass": True,
                        "nan_caught": True}


def test_bench_profile_summary_on_the_host():
    """The profiler summary's arithmetic; a CPU step has no device events."""
    assert bench.busy_us([(5.0, 6.0), (0.0, 2.0), (1.0, 3.0), (1.5, 2.5)]) == 4.0
    x = torch.ones(64)
    prof = bench.profile_steps(lambda: x * 2, iters=3)
    assert prof["steps"] == 3 and prof["wall_ms_per_step"] > 0
    assert prof["device_busy_ms_per_step"] == 0.0 and prof["idle_share"] == 1.0


def test_chip_smoke_refuses_without_cuda(no_cuda):
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
        text=True, timeout=300, check=False,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
