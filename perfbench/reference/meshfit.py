"""Plain reference of the mesh fit's step: the loss of a whole frame of
``pt.py``'s path tracer against a target, mean((image - target)^2), and
its gradients with respect to the spheres' albedo and emission and each
face's albedo and emission.

The frame is traced once, a block of sample layers at a time, keeping
each bounce's winner and weight (``pt.trace_samples``' records).  The
gradients then come from torch autograd through the radiance rebuilt
from those records, L = sum_b [live_b] tput_{b-1} e_b with tput_b =
tput_{b-1} a_b s_b: winners, roulette and the glass picks are held
fixed and the weights s detached, as the program's replay holds them.
The geometry gets no gradient.  Parameters are a dict: ``sphere_albedo``,
``sphere_emission`` [S, 3], ``face_albedo``, ``face_emission`` [F, 3].
"""

from __future__ import annotations

import torch

from perfbench.reference import pt, refmode
from perfbench.reference.philox import sample_uniforms

KEYS = ("sphere_albedo", "sphere_emission", "face_albedo", "face_emission")


def _tables(params, planes, mesh):
    planes = planes.clone()
    planes[7:10] = params["sphere_albedo"].T
    planes[4:7] = params["sphere_emission"].T
    mesh = dict(mesh, albedo=params["face_albedo"], emission=params["face_emission"])
    return planes, mesh


def _lookup(codes, spheres, faces):
    """Each sample's row: sphere ``codes`` < S from ``spheres`` by a chain
    of selects (a masked reduction backward: every path meets the
    walls), face codes S + f from ``faces`` by a gather of those samples
    alone."""
    s_count = spheres.shape[0]
    out = refmode.select(codes.clamp(0, s_count - 1), spheres)
    tri = (codes >= s_count).nonzero()[:, 0]
    return out.index_put((tri,), faces[codes[tri].long() - s_count])


def _blocks(n_pix, spp4, block_samples):
    per = max(1, block_samples // n_pix)
    return [(a0, min(spp4, a0 + per)) for a0 in range(0, spp4, per)]


def loss_and_grads(params, planes, materials, mesh, target, *, seed, cam, width, height,
                   spp4, bounces, rr_depth, eps, block_samples=1 << 22, counts=None):
    """-> (loss 0-d, {key: gradient}, image [3, W*H]) in the parameters'
    dtype; ``target`` [3, W*H]; ``counts`` (a dict) gains the frame's
    live sample-bounces and the triangle winners among them."""
    dtype, device = planes.dtype, planes.device
    n_pix = width * height
    pix_all = torch.arange(n_pix, device=device)
    planes_p, mesh_p = _tables({k: v.detach() for k, v in params.items()}, planes, mesh)
    image = torch.zeros((3, n_pix), dtype=torch.float64, device=device)
    kept = []
    for a0, a1 in _blocks(n_pix, spp4, block_samples):
        la = torch.arange(a0, a1, device=device)
        pix, layer = pix_all.repeat(a1 - a0), la.repeat_interleave(n_pix)
        u = sample_uniforms(seed, pix, layer, 2 + 3 * bounces, dtype)
        rec = []
        with torch.no_grad():
            rad = pt.trace_samples(u, pix, layer, planes_p, materials, cam=cam, width=width,
                                   height=height, spp4=spp4, bounces=bounces,
                                   rr_depth=rr_depth, eps=eps, mesh=mesh_p, records=rec)
        image += rad.double().reshape(3, a1 - a0, n_pix).sum(dim=1)
        kept.append((torch.stack([c for c, _ in rec]), torch.stack([w for _, w in rec])))
        del u, rad
    image = (image / spp4).to(dtype)
    diff = image - target.to(dtype)
    loss = (diff * diff).mean()
    g = (2.0 / diff.numel()) * diff / spp4  # d loss / d (one sample's radiance)

    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    s_count = planes.shape[1]
    for (a0, a1), (codes, weights) in zip(_blocks(n_pix, spp4, block_samples), kept):
        live = codes >= 0
        tput = torch.ones((a1 - a0) * n_pix, 3, dtype=dtype, device=device)
        rad = torch.zeros_like(tput)
        for b in range(bounces):
            lb = live[b][:, None]
            a = _lookup(codes[b], leaves["sphere_albedo"], leaves["face_albedo"])
            e = _lookup(codes[b], leaves["sphere_emission"], leaves["face_emission"])
            rad = rad + torch.where(lb, tput * e, 0.0)
            tput = torch.where(lb, tput * a * weights[b][:, None], tput)
        gb = g.T.repeat(a1 - a0, 1)  # [samples, 3], sample = layer * n_pix + pixel
        (rad * gb).sum().backward()
        if counts is not None:
            counts["live_bounces"] = counts.get("live_bounces", 0) + int(live.sum())
            counts["triangle_hits"] = counts.get("triangle_hits", 0) + int(
                (codes >= s_count).sum())
    grads = {k: v.grad.detach() for k, v in leaves.items()}
    return loss.detach(), grads, image


def sgd_steps(params, planes, materials, mesh, target, seeds, *, lr, counts=None, **kw):
    """The SGD steps with the given seeds (``lr``: a learning rate for
    each key) -> (losses, first step's gradients, the parameters after
    each step); ``counts`` as :func:`loss_and_grads`', of the first step."""
    losses, first, states = [], None, []
    for seed in seeds:
        loss, grads, _ = loss_and_grads(params, planes, materials, mesh, target, seed=seed,
                                        counts=counts if first is None else None, **kw)
        params = {k: params[k] - lr[k] * grads[k] for k in KEYS}
        losses.append(float(loss))
        states.append(params)
        first = grads if first is None else first
    return losses, first, states
