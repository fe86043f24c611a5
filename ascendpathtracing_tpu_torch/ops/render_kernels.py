"""The reference render's kernels: CUDA wrappers, plain twins, autograd.

Counterpart of the reference part of
``ascendpathtracing_tpu/ops/pallas_kernels.py``.  Each wrapper checks its
inputs, then:

- for tensors on the CPU, runs its ``*_plain`` twin (plain torch ops
  written from the TPU kernel's semantics);
- for tensors on a CUDA device, launches the hand-written kernel of
  ``csrc/render_ref.cu`` on the current stream, adds one to its entry of
  ``LAUNCHES``, and raises if the launch fails.  There is no fallback.

Either way the call runs inside the span ``apt.kernel.<its LAUNCHES key>``
(``utils/profiling.span``).

| wrapper | CUDA kernel | replaces (pallas_kernels.py) |
|---|---|---|
| ``render_reference_planes`` | ``render_ref_fwd_kernel<T, false, S>`` | ``_render_ref_kernel`` |
| ``render_reference_planes_with_idx`` | ``render_ref_fwd_kernel<T, true, S>`` | ``_render_ref_fwd_idx_kernel`` |
| ``render_ref_bwd_replay`` | ``render_ref_bwd_replay_kernel<T, S>`` | ``_render_ref_bwd_replay_kernel`` |
| ``render_ref_bwd`` | ``render_ref_bwd_recompute_kernel<T, S>`` | ``_render_ref_bwd_kernel`` |

(S, the scene's sphere count, is a template argument: the library holds
one kernel for each S = 1..``MAX_S``.)

Reference-mode colors are emission(light) times an ordered product of the
winners' albedos, and the winners are discrete, so the exact gradient is:
d emission = sum g * tput on the light's column, d albedo[s] by the
product rule, and exactly zero for the geometry planes (rows 0-3) and the
rays.  ``RenderReferenceFn`` wires the kernels into that custom VJP.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from ascendpathtracing_tpu_torch.models import megakernel
from ascendpathtracing_tpu_torch.ops import build
from ascendpathtracing_tpu_torch.utils.profiling import spanned

MAX_S = 16  # csrc/render_ref.cu MAX_S
BLOCK = 256  # csrc/render_ref.cu BLOCK: rays per CUDA block

#: Kernel launches per wrapper, counted where the launch succeeded.
LAUNCHES = {"fwd": 0, "fwd_idx": 0, "bwd_replay": 0, "bwd_recompute": 0}

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_N = ctypes.c_longlong
_SIGNATURES = {
    "apt_render_ref_fwd": (_P, _P, _P, _P, _N, _I, _I, _I, ctypes.c_double, _P),
    "apt_render_ref_bwd_replay": (_P, _P, _P, _P, _P, _N, _I, _I, _I, _P),
    "apt_render_ref_bwd_recompute": (
        _P, _P, _P, _P, _P, _N, _I, _I, _I, ctypes.c_double, _P,
    ),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load_library() -> ctypes.CDLL:
    """Builds and loads ``csrc/render_ref.cu`` and declares its C
    interface.  Checks that the library's compile-time sizes match this
    module's."""
    lib = build.load("render_ref")
    if getattr(lib, "_apt_declared", False):
        return lib
    for name in ("apt_block_size", "apt_max_spheres"):
        getattr(lib, name).argtypes = ()
        getattr(lib, name).restype = _I
    lib.apt_error_string.argtypes = (_I,)
    lib.apt_error_string.restype = ctypes.c_char_p
    for stem, sig in _SIGNATURES.items():
        for suffix in _DTYPES.values():
            fn = getattr(lib, f"{stem}_{suffix}")
            fn.argtypes = sig
            fn.restype = _I
    sizes = (lib.apt_block_size(), lib.apt_max_spheres())
    if sizes != (BLOCK, MAX_S):
        raise RuntimeError(f"library sizes {sizes} != module sizes {(BLOCK, MAX_S)}")
    lib._apt_declared = True
    return lib


def _launch(counter: str, stem: str, like: torch.Tensor, *args) -> None:
    """Calls ``<stem>_<dtype of like>`` on like's device and current stream
    (the stream is the C function's last argument)."""
    lib = load_library()
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        err = getattr(lib, f"{stem}_{_DTYPES[like.dtype]}")(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"{stem}: CUDA error {err} ({lib.apt_error_string(err).decode()})"
        )
    LAUNCHES[counter] += 1


# ------------------------------------------------------------ checks ----
def on_cpu(*tensors) -> bool:
    """True for CPU tensors, False for CUDA tensors on one device; raises
    for anything else."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"unsupported device {dev}")


def _check_scene(scene_planes, light_index, bounces) -> int:
    if scene_planes.dtype not in _DTYPES:
        raise TypeError(f"scene planes must be float32 or float64, got {scene_planes.dtype}")
    if scene_planes.dim() != 2 or scene_planes.shape[0] != 10:
        raise ValueError(f"expected [10, S] scene planes, got {tuple(scene_planes.shape)}")
    s = scene_planes.shape[1]
    if not 1 <= s <= MAX_S:
        raise ValueError(f"scene has {s} spheres; the kernels take 1..{MAX_S}")
    if not 0 <= light_index < s:
        raise ValueError(f"light_index {light_index} out of range for {s} spheres")
    if bounces < 0:
        raise ValueError(f"bounces must be >= 0, got {bounces}")
    if not scene_planes.is_contiguous():
        raise ValueError("scene planes must be contiguous")
    return s


def _check_planes(name, t, rows, dtype, n=None) -> int:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != rows or (n is not None and t.shape[1] != n):
        want = f"[{rows}, {'N' if n is None else n}]"
        raise ValueError(f"expected {name} {want}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.shape[1]


# ------------------------------------------------------- plain twins ----
def _trace_plain(rays_planes, scene_planes, light_index, bounces, eps):
    """The kernels' bounce loop in plain torch, op for op the same
    arithmetic -> (tput [3, N], idx [bounces, N] int32, S on a miss)."""
    tput, idx = megakernel.trace_reference(
        rays_planes[0:3].unbind(0), rays_planes[3:6].unbind(0),
        megakernel.scene_from_planes(scene_planes, light_index),
        bounces=bounces, eps=eps,
    )
    return torch.stack(tput), idx


def _colors(tput, scene_planes, light_index):
    return tput * scene_planes[4:7, light_index][:, None]


def render_reference_planes_plain(
    rays_planes, scene_planes, *, light_index, bounces=5, eps=1e-4
):
    """Plain twin of :func:`render_reference_planes`."""
    tput, _ = _trace_plain(rays_planes, scene_planes, light_index, bounces, eps)
    return _colors(tput, scene_planes, light_index)


def render_reference_planes_with_idx_plain(
    rays_planes, scene_planes, *, light_index, bounces=5, eps=1e-4
):
    """Plain twin of :func:`render_reference_planes_with_idx`."""
    tput, idx = _trace_plain(rays_planes, scene_planes, light_index, bounces, eps)
    return _colors(tput, scene_planes, light_index), idx


def replay_terms_plain(idx, scene_planes, g, *, light_index, bounces):
    """Each ray's terms of the replay's gradient: the albedo product chain
    rebuilt from the winners, times the cotangent.  Returns g * tput [3, N]
    (the light's emission) and g * emission * dt [S, 3, N] (the albedos,
    dt[s, c] = d tput_c / d albedo[s]_c)."""
    s = scene_planes.shape[1]
    n = idx.shape[1]
    dtype, device = scene_planes.dtype, scene_planes.device
    alb = scene_planes[7:10]
    spheres = torch.arange(s, device=device)[:, None]
    tput = torch.ones((3, n), dtype=dtype, device=device)
    dt = torch.zeros((s, 3, n), dtype=dtype, device=device)
    alive = torch.ones((n,), dtype=torch.bool, device=device)
    for k in range(bounces):
        i = idx[k].long()
        # idx == S is a miss: the last sphere's albedo, never a light hit.
        alive = alive & (i != light_index)
        gid = torch.where((i >= 0) & (i < s), i, s - 1)
        m = torch.where(alive, alb[:, gid], 1.0)
        pick = ((spheres == gid) & alive).to(dtype)
        dt = dt * m + pick[:, None, :] * tput
        tput = tput * m
    ge = g * scene_planes[4:7, light_index][:, None]
    return g * tput, ge * dt


def render_ref_bwd_replay_plain(idx, scene_planes, g, *, light_index, bounces):
    """Plain twin of :func:`render_ref_bwd_replay`: the sums over rays of
    :func:`replay_terms_plain`."""
    emission, albedo = replay_terms_plain(
        idx, scene_planes, g, light_index=light_index, bounces=bounces
    )
    grad = torch.zeros(
        (10, scene_planes.shape[1]), dtype=scene_planes.dtype, device=scene_planes.device
    )
    grad[4:7, light_index] = emission.sum(dim=1)
    grad[7:10] = albedo.sum(dim=2).T
    return grad


def render_ref_bwd_plain(
    rays_planes, scene_planes, g, *, light_index, bounces, eps=1e-4
):
    """Plain twin of :func:`render_ref_bwd` (the recompute backward):
    rerun the forward for its winners, then the product rule."""
    _, idx = _trace_plain(rays_planes, scene_planes, light_index, bounces, eps)
    return render_ref_bwd_replay_plain(
        idx, scene_planes, g, light_index=light_index, bounces=bounces
    )


# ---------------------------------------------------------- wrappers ----
@spanned("apt.kernel.fwd")
def render_reference_planes(
    rays_planes, scene_planes, *, light_index, bounces=5, eps=1e-4
):
    """Fused render: rays [6, N] and scene [10, S] (float32 or float64,
    contiguous) -> colors [3, N]."""
    s = _check_scene(scene_planes, light_index, bounces)
    n = _check_planes("rays", rays_planes, 6, scene_planes.dtype)
    if on_cpu(rays_planes, scene_planes):
        return render_reference_planes_plain(
            rays_planes, scene_planes, light_index=light_index,
            bounces=bounces, eps=eps,
        )
    out = torch.empty((3, n), dtype=rays_planes.dtype, device=rays_planes.device)
    _launch(
        "fwd", "apt_render_ref_fwd", out,
        rays_planes.data_ptr(), scene_planes.data_ptr(), out.data_ptr(), None,
        n, s, light_index, bounces, eps,
    )
    return out


@spanned("apt.kernel.fwd_idx")
def render_reference_planes_with_idx(
    rays_planes, scene_planes, *, light_index, bounces=5, eps=1e-4
):
    """Fused render that also returns each bounce's winner: colors [3, N]
    and idx [bounces, N] int32 (S encodes a miss) — the replay residual."""
    s = _check_scene(scene_planes, light_index, bounces)
    n = _check_planes("rays", rays_planes, 6, scene_planes.dtype)
    if on_cpu(rays_planes, scene_planes):
        return render_reference_planes_with_idx_plain(
            rays_planes, scene_planes, light_index=light_index,
            bounces=bounces, eps=eps,
        )
    out = torch.empty((3, n), dtype=rays_planes.dtype, device=rays_planes.device)
    idx = torch.empty((bounces, n), dtype=torch.int32, device=rays_planes.device)
    _launch(
        "fwd_idx", "apt_render_ref_fwd", out,
        rays_planes.data_ptr(), scene_planes.data_ptr(), out.data_ptr(),
        idx.data_ptr(), n, s, light_index, bounces, eps,
    )
    return out, idx


def _partials(n, s, like):
    """The backwards' scratch: [3 + 3S, n_blocks], a column per block."""
    return torch.empty((3 + 3 * s, -(-n // BLOCK)), dtype=like.dtype, device=like.device)


@spanned("apt.kernel.bwd_replay")
def render_ref_bwd_replay(idx, scene_planes, g, *, light_index, bounces):
    """Replay backward: idx [bounces, N] int32 and cotangent g [3, N] ->
    scene-plane gradient [10, S] in the scene's dtype."""
    s = _check_scene(scene_planes, light_index, bounces)
    n = _check_planes("idx", idx, bounces, torch.int32)
    _check_planes("g", g, 3, scene_planes.dtype, n)
    if on_cpu(idx, scene_planes, g):
        return render_ref_bwd_replay_plain(
            idx, scene_planes, g, light_index=light_index, bounces=bounces
        )
    grad = torch.empty((10, s), dtype=scene_planes.dtype, device=g.device)
    partial = _partials(n, s, g)
    _launch(
        "bwd_replay", "apt_render_ref_bwd_replay", g,
        scene_planes.data_ptr(), idx.data_ptr(), g.data_ptr(),
        partial.data_ptr(), grad.data_ptr(), n, s, light_index, bounces,
    )
    return grad


@spanned("apt.kernel.bwd_recompute")
def render_ref_bwd(rays_planes, scene_planes, g, *, light_index, bounces, eps=1e-4):
    """Recompute backward: rays [6, N], scene [10, S] and cotangent g
    [3, N] -> scene-plane gradient [10, S]; needs no residual."""
    s = _check_scene(scene_planes, light_index, bounces)
    n = _check_planes("rays", rays_planes, 6, scene_planes.dtype)
    _check_planes("g", g, 3, scene_planes.dtype, n)
    if on_cpu(rays_planes, scene_planes, g):
        return render_ref_bwd_plain(
            rays_planes, scene_planes, g, light_index=light_index,
            bounces=bounces, eps=eps,
        )
    grad = torch.empty((10, s), dtype=scene_planes.dtype, device=g.device)
    partial = _partials(n, s, g)
    _launch(
        "bwd_recompute", "apt_render_ref_bwd_recompute", g,
        rays_planes.data_ptr(), scene_planes.data_ptr(), g.data_ptr(),
        partial.data_ptr(), grad.data_ptr(), n, s, light_index, bounces, eps,
    )
    return grad


def render_reference(rays, scene_planes, *, light_index, bounces=5, eps=1e-4):
    """AoS wrapper: rays [N, 6] -> colors [N, 3].  Any N: the kernels
    guard the last block's rays, so nothing is padded."""
    return render_reference_planes(
        rays.T.contiguous(), scene_planes, light_index=light_index,
        bounces=bounces, eps=eps,
    ).T


# ---------------------------------------------------------- autograd ----
class RenderReferenceFn(torch.autograd.Function):
    """Differentiable fused render, (rays [6, N], scene [10, S]) ->
    colors [3, N], with the hand-written backward.

    ``replay=True``: the forward also stores the winners (``bounces * 4``
    bytes per ray) and the backward replays the albedo product chain from
    them.  ``replay=False``: the backward reruns the forward.  Call it
    through :func:`render_reference_diff`, which takes the forward without
    residual when nothing needs a gradient.
    """

    @staticmethod
    def forward(ctx, rays_planes, scene_planes, light_index, bounces, eps, replay):
        ctx.meta = (light_index, bounces, eps, replay)
        kw = dict(light_index=light_index, bounces=bounces, eps=eps)
        if replay:
            out, idx = render_reference_planes_with_idx(rays_planes, scene_planes, **kw)
            ctx.save_for_backward(rays_planes, scene_planes, idx)
        else:
            out = render_reference_planes(rays_planes, scene_planes, **kw)
            ctx.save_for_backward(rays_planes, scene_planes)
        return out

    @staticmethod
    def backward(ctx, g):
        light_index, bounces, eps, replay = ctx.meta
        rays_planes, scene_planes = ctx.saved_tensors[:2]
        g = g.contiguous()
        d_scene = None
        if ctx.needs_input_grad[1]:
            if replay:
                d_scene = render_ref_bwd_replay(
                    ctx.saved_tensors[2], scene_planes, g,
                    light_index=light_index, bounces=bounces,
                )
            else:
                d_scene = render_ref_bwd(
                    rays_planes, scene_planes, g, light_index=light_index,
                    bounces=bounces, eps=eps,
                )
        # The rays' true gradient: colors depend on them only through
        # discrete winners.
        d_rays = torch.zeros_like(rays_planes) if ctx.needs_input_grad[0] else None
        return d_rays, d_scene, None, None, None, None


def render_reference_diff(
    rays_planes, scene_planes, *, light_index, bounces=5, eps=1e-4, replay=True
):
    """The differentiable render: through :class:`RenderReferenceFn` when
    autograd will need a gradient, else the plain forward (no residual)."""
    if torch.is_grad_enabled() and (
        rays_planes.requires_grad or scene_planes.requires_grad
    ):
        return RenderReferenceFn.apply(
            rays_planes, scene_planes, light_index, bounces, eps, replay
        )
    return render_reference_planes(
        rays_planes, scene_planes, light_index=light_index, bounces=bounces,
        eps=eps,
    )


def make_render_reference_diff(*, light_index, bounces=5, eps=1e-4, replay=True):
    """fn(rays_planes [6, N], scene_planes [10, S]) -> colors [3, N] with
    the hand-written backward; mirrors ``make_render_reference_pallas_diff``."""

    def render(rays_planes, scene_planes):
        return render_reference_diff(
            rays_planes, scene_planes, light_index=light_index,
            bounces=bounces, eps=eps, replay=replay,
        )

    return render


class RenderReference(nn.Module):
    """The differentiable render as a module whose parameter is the scene:
    ``scene_planes`` [10, S] (r2 x y z ex ey ez cr cg cb).  forward(rays
    [6, N]) -> colors [3, N]."""

    def __init__(self, scene_planes, *, light_index, bounces=5, eps=1e-4, replay=True):
        super().__init__()
        self.scene_planes = nn.Parameter(scene_planes.detach().clone())
        self.light_index = light_index
        self.bounces = bounces
        self.eps = eps
        self.replay = replay

    def forward(self, rays_planes):
        return render_reference_diff(
            rays_planes, self.scene_planes, light_index=self.light_index,
            bounces=self.bounces, eps=self.eps, replay=self.replay,
        )
