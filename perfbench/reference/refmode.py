"""Plain reference of the program's reference-mode renderer and its SGD
step, written from the upstream kernel's documented semantics
(AscendPathTracing's rt_helper.h, quoted in the program's oracle).

A ray bounces ``bounces`` times among the spheres; each bounce takes the
nearest sphere (the quadratic's nearer root above eps, else the
farther, the lowest index on a tie).  A miss shades as the last sphere.
The new ray starts at the hit point and is the mirror reflection about
normalize(hit - centre), whatever the material.  Hitting the light
sphere ends the path before its albedo is multiplied in; every other
bounce multiplies the throughput by the winner's albedo.  The colour is
throughput x the light's emission.

The fit's loss is mean((colour - target)^2) over the 3 N values; the
step is plain SGD on the scene's albedo, emission, centre and r^2.  The
colour depends on the geometry only through the discrete winners, so
centre and r^2 get no gradient.  Gradients come from torch autograd
over blocks of rays, in the reference's dtype, a sphere's share by a
masked reduction (``select``).
"""

from __future__ import annotations

import torch

from perfbench.reference.pt import nearest_sphere, sqrt

KEYS = ("albedo", "emission", "center", "r2")


def planes_of(params: dict) -> torch.Tensor:
    """The parameters -> [10, S] planes (r^2, centre, emission, albedo)."""
    return torch.cat([params["r2"][None], params["center"].T, params["emission"].T,
                      params["albedo"].T])


def params_of(planes: torch.Tensor) -> dict:
    return {"albedo": planes[7:10].T.clone(), "emission": planes[4:7].T.clone(),
            "center": planes[1:4].T.clone(), "r2": planes[0].clone()}


def select(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` ([m] ids of a few rows) as a chain of selects, whose
    backward sums each row's share by a masked reduction and not by
    atomic adds into a few addresses."""
    out = torch.zeros((ids.shape[0], table.shape[1]), dtype=table.dtype, device=ids.device)
    for i in range(table.shape[0]):
        out = torch.where((ids == i)[:, None], table[i], out)
    return out


def winners(rays: torch.Tensor, planes: torch.Tensor, light: int, bounces: int, eps: float):
    """rays [6, m] -> (shade [bounces, m] int64: the sphere whose albedo
    the bounce multiplies in, alive [bounces, m] bool: whether it does)."""
    s = planes.shape[1]
    o = list(rays[0:3])
    d = list(rays[3:6])
    alive = torch.ones(rays.shape[1], dtype=torch.bool, device=rays.device)
    shade, mult = [], []
    for _ in range(bounces):
        tmin, win = nearest_sphere(o, d, planes, eps)
        miss = win == s
        gid = torch.where(miss, s - 1, win)
        h = [o[c] + d[c] * tmin for c in range(3)]
        n = [h[c] - planes[1 + c][gid] for c in range(3)]
        n2 = n[0] * n[0] + n[1] * n[1] + n[2] * n[2]
        inv = torch.where(n2 > 0, 1 / sqrt(n2), torch.zeros_like(n2))
        n = [c * inv for c in n]
        dn = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]
        o, d = h, [d[c] - 2 * dn * n[c] for c in range(3)]
        alive = alive & ~((win == light) & ~miss)
        shade.append(gid)
        mult.append(alive)
    return torch.stack(shade), torch.stack(mult)


def loss_and_grads(params: dict, rays: torch.Tensor, target: torch.Tensor, *, light: int,
                   bounces: int, eps: float, block: int = 1 << 20):
    """mean((colour - target)^2) over the rays [6, N] and target [3, N],
    and its gradients -> (loss 0-d, {key: gradient}), in the parameters'
    dtype."""
    dtype = params["albedo"].dtype
    leaves = {k: v.detach().clone().requires_grad_(k in ("albedo", "emission"))
              for k, v in params.items()}
    planes = planes_of(leaves).detach()
    n = rays.shape[1]
    total = torch.zeros((), dtype=dtype, device=rays.device)
    for lo in range(0, n, block):
        r = rays[:, lo:lo + block].to(dtype)
        with torch.no_grad():
            gid, alive = winners(r, planes, light, bounces, eps)
        tput = [torch.ones(r.shape[1], dtype=dtype, device=r.device)] * 3
        for k in range(bounces):
            a = select(gid[k], leaves["albedo"])
            tput = [torch.where(alive[k], tput[c] * a[:, c], tput[c]) for c in range(3)]
        colour = torch.stack(tput) * leaves["emission"][light][:, None]
        sq = ((colour - target[:, lo:lo + block].to(dtype)) ** 2).sum() / (3 * n)
        sq.backward()
        total = total + sq.detach()
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)).detach()
             for k, v in leaves.items()}
    return total, grads


def render(params: dict, rays: torch.Tensor, *, light: int, bounces: int, eps: float,
           block: int = 1 << 20) -> torch.Tensor:
    """The colours [3, N] of rays [6, N], in the parameters' dtype."""
    planes = planes_of(params)
    out = []
    for lo in range(0, rays.shape[1], block):
        r = rays[:, lo:lo + block].to(planes.dtype)
        gid, alive = winners(r, planes, light, bounces, eps)
        tput = torch.ones((3, r.shape[1]), dtype=planes.dtype, device=r.device)
        for k in range(bounces):
            tput = torch.where(alive[k], tput * planes[7:10][:, gid[k]], tput)
        out.append(tput * planes[4:7, light][:, None])
    return torch.cat(out, dim=1)


def sgd_steps(params: dict, batches, *, lr: float, light: int, bounces: int, eps: float,
              block: int = 1 << 20):
    """The SGD steps over ``batches`` [(rays, target), ...] -> (losses,
    first step's gradients, the parameters after each step)."""
    losses, first, states = [], None, []
    for rays, target in batches:
        loss, grads = loss_and_grads(params, rays, target, light=light, bounces=bounces,
                                     eps=eps, block=block)
        params = {k: params[k] - lr * grads[k] for k in KEYS}
        losses.append(float(loss))
        states.append(params)
        first = grads if first is None else first
    return losses, first, states
