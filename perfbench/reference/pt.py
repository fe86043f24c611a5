"""Plain reference of the program's path tracers, written from their
documented semantics (smallpt's estimator as the Pallas kernels run it).

A sample (pixel p, layer a) of a W x H image with ``spp4`` layers: pixel
p is column p // H, row p % H; layer a is the sub-pixel (sy, sx) = (a //
(2 s), (a // s) % 2), s = spp4 / 4.  Its uniforms (``philox``) are 2 for
the camera and 3 a bounce.

- Camera: r = 2 u, tent offset (sqrt(r) - 1 or 1 - sqrt(2 - r)), su =
  ((sx + 0.5 + jx) / 2 + i) / W - 0.5, sv likewise on rows; d = su cx +
  sv cy + dir, origin = pos + d push, direction d / |d|.
- A bounce: the nearest sphere (the quadratic's nearer root above eps,
  else the farther, the lowest index on a tie), then the nearest
  triangle strictly nearer than it (double-sided, t > eps; Moller and
  Trumbore's test here).  A miss ends the path.  The radiance gains
  tput x emission; diffuse takes the cosine-weighted direction about the
  oriented normal (phi = 2 pi u0, r = sqrt(u1), smallpt's u/v frame,
  not renormalised); a mirror reflects; glass (IOR 1.5) reflects with
  Schlick's P = 0.25 + 0.5 Re (always on total internal reflection) and
  weights Re / P or (1 - Re) / (1 - P); tput *= albedo x that weight.
  From bounce ``rr_depth`` on, Russian roulette keeps the path where u2
  < clamp(max tput, 0.1, 0.95) and divides tput by it.  The next origin
  is the hit point moved along the oriented normal by max(eps, 1e-6
  sqrt(r^2)) (a triangle: eps; glass: 0).
- The pixel's value is the mean of its layers' radiance.

Everything is computed in ``dtype`` (the configuration's float32 for the
reference, bfloat16 for its control), a block of samples at a time.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.philox import sample_uniforms

MISS = 1e20
IOR = 1.5
R0 = ((IOR - 1.0) * (IOR - 1.0)) / ((IOR + 1.0) * (IOR + 1.0))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE round-to-nearest square root: NumPy's on the CPU, where
    torch's is not correctly rounded in every build; torch's elsewhere
    and in bfloat16."""
    if x.device.type == "cpu" and x.dtype in (torch.float32, torch.float64):
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


#: Consecutive faces tested together behind one bounding sphere.
GROUP = 64


def _bounding(points):
    """Points [..., k, 3] -> (centres [..., 3], radii [...]) enclosing them."""
    centre = points.mean(dim=-2)
    radius = (points - centre[..., None, :]).norm(dim=-1).amax(dim=-1)
    return centre, radius * (1 + 1e-6) + 1e-6


def mesh_tables(vertices, faces, albedo, emission, material, *, dtype, device):
    """A triangle mesh -> the reference's tables in ``dtype``: each face's
    corner v0, edges e1 and e2 and unit normal, its albedo and emission
    [F, 3] (a single [3] is every face's), its material, and bounding
    spheres of the whole mesh and of each run of ``GROUP`` faces (the
    faces padded with empty triangles, which nothing hits)."""
    v = torch.as_tensor(vertices, dtype=torch.float64)
    f = torch.as_tensor(faces, dtype=torch.int64)
    n_faces = f.shape[0]
    tri = v[f]
    e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    n = torch.linalg.cross(e1, e2)
    n = n / n.norm(dim=1, keepdim=True)
    n_groups = -(-n_faces // GROUP)
    n_pad = n_groups * GROUP - n_faces
    corners = torch.cat([tri, tri[-1:, :1].expand(n_pad, 3, 3)])
    g_centre, g_radius = _bounding(corners.reshape(n_groups, GROUP * 3, 3))
    centre, radius = _bounding(v)
    zeros = torch.zeros((n_pad, 3), dtype=torch.float64)
    cast = lambda t: t.to(dtype=dtype, device=device)  # noqa: E731

    def per_face(x):
        x = torch.as_tensor(x, dtype=torch.float64)
        return cast(x.expand(n_faces, 3) if x.dim() == 1 else x)

    return {"v0": cast(torch.cat([tri[:, 0], tri[-1:, 0].expand(n_pad, 3)])),
            "e1": cast(torch.cat([e1, zeros])), "e2": cast(torch.cat([e2, zeros])),
            "n": cast(n), "albedo": per_face(albedo), "emission": per_face(emission),
            "material": int(material), "faces": n_faces,
            "centre": cast(centre), "radius": float(radius),
            "group_centre": cast(g_centre), "group_radius": cast(g_radius)}


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def nearest_sphere(o, d, planes, eps):
    """-> (tmin [m], winner [m] int64; S on a miss)."""
    s = planes.shape[1]
    oc = [planes[1 + c][:, None] - o[c][None] for c in range(3)]
    b = _dot(oc, [x[None] for x in d])
    c = _dot(oc, oc) - planes[0][:, None]
    det = b * b - c
    valid = det >= 0
    sq = sqrt(torch.where(valid, det, torch.zeros_like(det)))
    t0, t1 = b - sq, b + sq
    miss = torch.full_like(t0, MISS)
    t = torch.where(valid & (t0 > eps), t0, torch.where(valid & (t1 > eps), t1, miss))
    tmin, win = torch.min(t, dim=0)
    return tmin, torch.where(tmin >= MISS, s, win)


def _sphere_entries(o, d, centre, radius, tmax, eps):
    """[k, m]: whether ray m's segment (eps, tmax) meets sphere k
    (centres [k, 3] or [3], radii [k] or a float)."""
    c = centre if centre.dim() == 2 else centre[None]
    oc = [c[:, i][:, None] - o[i][None] for i in range(3)]
    b = _dot(oc, [x[None] for x in d])
    r = radius[:, None] if isinstance(radius, torch.Tensor) else radius
    det = b * b - (_dot(oc, oc) - r * r)
    sq = sqrt(torch.clamp_min(det, 0))
    return (det >= 0) & (b + sq > eps) & (b - sq < tmax[None])


def nearest_triangle(o, d, tmax, mesh, eps, block=1 << 16):
    """Rays (o, d [3][m]) against the mesh, nearer than ``tmax`` -> (t [m],
    face [m] int64, -1 where none; the lowest face on a tie).  A ray
    tests the faces of the groups whose bounding spheres its segment
    meets, and only if it meets the whole mesh's."""
    m = tmax.shape[0]
    t_out = tmax.clone()
    face = torch.full((m,), -1, dtype=torch.int64, device=tmax.device)
    cand = _sphere_entries(o, d, mesh["centre"], mesh["radius"], tmax, eps)[0].nonzero()[:, 0]
    lanes = torch.arange(GROUP, device=tmax.device)
    for lo in range(0, cand.shape[0], block):
        ids = cand[lo:lo + block]
        oo = [o[c][ids] for c in range(3)]
        dd = [d[c][ids] for c in range(3)]
        tm = tmax[ids]
        g, r = _sphere_entries(oo, dd, mesh["group_centre"], mesh["group_radius"], tm,
                               eps).nonzero().unbind(1)
        if g.numel() == 0:
            continue
        f = g[:, None] * GROUP + lanes  # [pairs, GROUP]
        v0, e1, e2 = ([mesh[k][:, c][f] for c in range(3)] for k in ("v0", "e1", "e2"))
        op = [x[r][:, None] for x in oo]
        dp = [x[r][:, None] for x in dd]
        p = _cross(dp, e2)
        det3 = _dot(e1, p)
        inv = 1.0 / torch.where(det3 == 0, torch.ones_like(det3), det3)
        tv = [op[c] - v0[c] for c in range(3)]
        u = _dot(tv, p) * inv
        q = _cross(tv, e1)
        v = _dot(dp, q) * inv
        t = _dot(e2, q) * inv
        ok = (det3 != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > eps) & (t < tm[r][:, None])
        t = torch.where(ok, t, torch.full_like(t, math.inf))
        tb, j = torch.min(t, dim=1)
        fb = f.gather(1, j[:, None])[:, 0]
        best = torch.full_like(tm, math.inf).scatter_reduce(0, r, tb, "amin")
        win = torch.where(tb == best[r], fb, torch.full_like(fb, 1 << 62))
        fsel = torch.full(tm.shape, 1 << 62, dtype=torch.int64,
                          device=tm.device).scatter_reduce(0, r, win, "amin")
        hit = best < math.inf
        t_out[ids] = torch.where(hit, best, tm)
        face[ids] = torch.where(hit, fsel, face[ids])
    return t_out, face


def trace_samples(u, pix, layer, planes, materials, *, cam, width, height, spp4,
                  bounces, rr_depth, eps, mesh=None, counts=None, records=None):
    """Radiance [3, m] of the samples (pixel ``pix``, layer ``layer``)
    whose uniforms are ``u`` [2 + 3 bounces, m]; ``counts`` (a dict)
    gains the live sample-bounces and the triangle winners among them;
    ``records`` (a list) gains a bounce's (winner code [m] int32: the
    sphere, S + the face, -1 where the path took no bounce; its weight s
    [m]: the glass weight times the roulette's 1 / p where the path went
    on) for each bounce."""
    dtype, device = u.dtype, u.device
    px, py, pz, d0x, d0y, d0z, cxx, cyx, cyy, cyz, push = cam
    s = spp4 // 4
    sy, sx = (layer // (2 * s)).to(dtype), ((layer // s) % 2).to(dtype)
    i, j = (pix // height).to(dtype), (pix % height).to(dtype)
    one = torch.ones_like(u[0])
    zero = torch.zeros_like(u[0])
    r1, r2 = 2.0 * u[0], 2.0 * u[1]
    jx = torch.where(r1 < 1, sqrt(r1) - 1, 1 - sqrt(torch.clamp_min(2 - r1, 0)))
    jy = torch.where(r2 < 1, sqrt(r2) - 1, 1 - sqrt(torch.clamp_min(2 - r2, 0)))
    w_t = torch.full((), float(width), dtype=dtype, device=device)
    h_t = torch.full((), float(height), dtype=dtype, device=device)
    su = ((sx + 0.5 + jx) / 2 + i) / w_t - 0.5
    sv = ((sy + 0.5 + jy) / 2 + j) / h_t - 0.5
    dd = [su * cxx + sv * cyx + d0x, sv * cyy + d0y, sv * cyz + d0z]
    o = [px + dd[0] * push, py + dd[1] * push, pz + dd[2] * push]
    inv = 1 / sqrt(_dot(dd, dd))
    d = [c * inv for c in dd]

    s_count = planes.shape[1]
    pad = torch.cat([planes, torch.zeros((10, 1), dtype=dtype, device=device)], dim=1)
    mat = torch.cat([materials.long().to(device), torch.full((1,), -1, device=device)])
    tput = [one, one, one]
    rad = [zero, zero, zero]
    alive = torch.ones(u.shape[1], dtype=torch.bool, device=device)
    for k in range(bounces):
        tmin, win = nearest_sphere(o, d, planes, eps)
        face = None
        if mesh is not None:
            tmin, face = nearest_triangle(o, d, tmin, mesh, eps)
        live = alive & (tmin < MISS)
        h = [o[c] + d[c] * tmin for c in range(3)]
        w = pad[:, win]
        n = [h[c] - w[1 + c] for c in range(3)]
        n2 = _dot(n, n)
        ninv = torch.where(n2 > 0, 1 / sqrt(n2), zero)
        n = [c * ninv for c in n]
        e, a, r2w = [w[4], w[5], w[6]], [w[7], w[8], w[9]], w[0]
        m = mat[win]
        is_diff, is_refr = m == 0, m == 2
        if face is not None:
            tri = face >= 0
            fn = mesh["n"][face.clamp_min(0)].T
            n = [torch.where(tri, fn[c], n[c]) for c in range(3)]
            fa = mesh["albedo"][face.clamp_min(0)].T
            fe = mesh["emission"][face.clamp_min(0)].T
            e = [torch.where(tri, fe[c], e[c]) for c in range(3)]
            a = [torch.where(tri, fa[c], a[c]) for c in range(3)]
            r2w = torch.where(tri, zero, r2w)
            is_diff = (is_diff & ~tri) | (tri & (mesh["material"] == 0))
            is_refr = (is_refr & ~tri) | (tri & (mesh["material"] == 2))
            if counts is not None:
                counts["triangle_hits"] = counts.get("triangle_hits", 0) + int((live & tri).sum())
        if counts is not None:
            counts["live_bounces"] = counts.get("live_bounces", 0) + int(live.sum())
        rad = [torch.where(live, rad[c] + tput[c] * e[c], rad[c]) for c in range(3)]

        dn = _dot(d, n)
        into = dn < 0
        sgn = torch.where(into, one, -one)
        nl = [c * sgn for c in n]
        uq = u[2 + 3 * k: 5 + 3 * k]
        # diffuse
        phi = (2 * math.pi) * uq[0]
        rs = sqrt(uq[1])
        flip = nl[0].abs() > 0.1
        ax = [torch.where(flip, zero, one), torch.where(flip, one, zero), zero]
        uu = _cross(ax, nl)
        un = 1 / sqrt(torch.clamp_min(_dot(uu, uu), 1e-20))
        uu = [c * un for c in uu]
        vv = _cross(nl, uu)
        cw = sqrt(torch.clamp_min(1 - uq[1], 0))
        cp, sp = torch.cos(phi) * rs, torch.sin(phi) * rs
        dif = [uu[c] * cp + vv[c] * sp + nl[c] * cw for c in range(3)]
        # mirror
        spec = [d[c] - 2 * dn * n[c] for c in range(3)]
        # glass
        nnt = torch.where(into, one / IOR, one * IOR)
        ddn = _dot(d, nl)
        cos2t = 1 - nnt * nnt * (1 - ddn * ddn)
        tir = cos2t < 0
        coef = sgn * (ddn * nnt + sqrt(torch.clamp_min(cos2t, 0)))
        td = [d[c] * nnt - n[c] * coef for c in range(3)]
        tinv = 1 / sqrt(torch.clamp_min(_dot(td, td), 1e-20))
        td = [c * tinv for c in td]
        cth = 1 - torch.where(into, -ddn, _dot(td, n))
        re = R0 + (1 - R0) * cth * cth * cth * cth * cth
        pp = 0.25 + 0.5 * re
        pick = (uq[0] < pp) | tir
        rscale = torch.where(tir, one, torch.where(pick, re / pp, (1 - re) / (1 - pp)))
        refr = is_refr & ~pick
        nd = [torch.where(is_diff, dif[c], torch.where(refr, td[c], spec[c])) for c in range(3)]
        scl = torch.where(is_refr, rscale, one)
        tput = [torch.where(live, tput[c] * a[c] * scl, tput[c]) for c in range(3)]
        alive = live
        weight = scl
        if k >= rr_depth:
            pmax = torch.clamp(torch.maximum(torch.maximum(tput[0], tput[1]), tput[2]), 0.1, 0.95)
            keep = uq[2] < pmax
            tput = [torch.where(keep, c / pmax, c) for c in tput]
            alive = live & keep
            weight = scl * torch.where(keep, 1 / pmax, one)
        if records is not None:
            code = win if face is None else torch.where(face >= 0, s_count + face, win)
            records.append((torch.where(live, code, -1).to(torch.int32), weight))
        off = torch.where(is_refr, zero, torch.clamp_min(1e-6 * sqrt(r2w), eps))
        o = [torch.where(live, h[c] + nl[c] * off, o[c]) for c in range(3)]
        d = [torch.where(live, nd[c], d[c]) for c in range(3)]
    return torch.stack(rad)


def render_pixels(planes, materials, pixels, *, cam, width, height, spp4, bounces,
                  rr_depth, eps, seed, dtype=torch.float64, mesh=None, counts=None,
                  block_samples=1 << 17):
    """The per-pixel means [3, P] (float64) of ``pixels`` [P] int64,
    every layer traced in ``dtype``.  ``planes`` [10, S] and ``mesh``
    (``mesh_tables``) are already in ``dtype``."""
    device = pixels.device
    n_pix = pixels.shape[0]
    total = torch.zeros((3, n_pix), dtype=torch.float64, device=device)
    layers_per = max(1, block_samples // max(1, n_pix))
    for a0 in range(0, spp4, layers_per):
        la = torch.arange(a0, min(spp4, a0 + layers_per), device=device)
        pix = pixels.repeat(la.shape[0])
        layer = la.repeat_interleave(n_pix)
        u = sample_uniforms(seed, pix, layer, 2 + 3 * bounces, dtype)
        rad = trace_samples(u, pix, layer, planes, materials, cam=cam, width=width,
                            height=height, spp4=spp4, bounces=bounces, rr_depth=rr_depth,
                            eps=eps, mesh=mesh, counts=counts)
        total += rad.double().reshape(3, la.shape[0], n_pix).sum(dim=1)
    return total / spp4
