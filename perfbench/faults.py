"""The program swapped for the check's control or for a planted fault.

Each entry of ``PATCHES`` is a context manager that replaces what a
traffic kind calls (``fit.entry``, ``render.make_frame`` or
``mesh_fit.make_step``) for the length of a run:

- ``control``: the plain reference put in the program's place, computed
  in bfloat16, the precision below the configurations' float32.  For
  frames it computes the checked pixels only (nothing else is compared).
- ``unchanged``: a step that returns its state as it got it; a frame
  that is the first frame again.
- ``half``: half the batch left out: a step on the first half of its
  rays (the loss their mean), a mesh step or a frame of half the sample
  layers.
- ``altered``: an answer altered where it is produced: the step's loss
  x 1.5; a frame rendered from another seed.

``perfbench.control`` runs them on the chip; ``perfbench/tests`` at a
size the CPU holds.
"""

from __future__ import annotations

import contextlib

import torch

from perfbench import inputs
from perfbench.reference import meshfit, refmode
from perfbench.reference import pt as ref_pt
from perfbench.traffic import fit, mesh_fit, render


@contextlib.contextmanager
def _swap(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _fit_wrap(wrap):
    real = fit.entry()

    def make(mesh, **kw):
        return wrap(real(mesh, **kw), kw)

    return _swap(fit, "entry", lambda: make)


def _frame_wrap(wrap):
    real = render.make_frame
    return _swap(render, "make_frame", lambda cfg, wl, dev: wrap(real, cfg, wl, dev))


# ------------------------------------------------------------- fit ----
def fit_control(dtype=torch.bfloat16):
    def make(mesh, *, bounces, eps, learning_rate):
        def step(params, aux, rays, target):
            p = {k: v.to(dtype) for k, v in params.items()}
            loss, grads = refmode.loss_and_grads(p, rays.T, target.T, light=aux["light_index"],
                                                 bounces=bounces, eps=eps)
            new = {k: (p[k] - learning_rate * grads[k]).to(params[k].dtype)
                   for k in refmode.KEYS}
            return loss.float(), new
        return step

    return _swap(fit, "entry", lambda: make)


def fit_unchanged():
    def wrap(step, kw):
        def faulty(params, aux, rays, target):
            loss, _ = step(params, aux, rays, target)
            return loss, params
        return faulty

    return _fit_wrap(wrap)


def fit_half():
    def wrap(step, kw):
        def faulty(params, aux, rays, target):
            n = rays.shape[0] // 2
            return step(params, aux, rays[:n], target[:n])
        return faulty

    return _fit_wrap(wrap)


def fit_altered():
    def wrap(step, kw):
        def faulty(params, aux, rays, target):
            loss, new = step(params, aux, rays, target)
            return loss * 1.5, new
        return faulty

    return _fit_wrap(wrap)


# ---------------------------------------------------------- render ----
def render_control(dtype=torch.bfloat16):
    seen = {}
    real_draws = render.draws

    def draws(seed, n_pix, n_check):
        out = real_draws(seed, n_pix, n_check)
        seen["pixels"] = out[2]
        return out

    def make_frame(cfg, wl, dev):
        scene = render.reference_scene(cfg, dev, dtype)
        pixels = torch.tensor(seen["pixels"], device=dev)
        n_pix = wl["width"] * wl["height"]

        def frame(seed):
            img = torch.zeros((3, n_pix), dtype=getattr(torch, cfg["dtype"]), device=dev)
            img[:, pixels] = render.reference_pixels(cfg, wl, scene, pixels, seed,
                                                     dtype).to(img.dtype)
            return img
        return frame

    stack = contextlib.ExitStack()
    stack.enter_context(_swap(render, "draws", draws))
    stack.enter_context(_swap(render, "make_frame", make_frame))
    return stack


def render_unchanged():
    def wrap(real, cfg, wl, dev):
        frame, first = real(cfg, wl, dev), {}

        def stale(seed):
            if "img" not in first:
                first["img"] = frame(seed).clone()
            return first["img"]
        return stale

    return _frame_wrap(wrap)


def render_half():
    return _frame_wrap(lambda real, cfg, wl, dev: real(cfg, dict(wl, spp4=wl["spp4"] // 2), dev))


def render_altered():
    def wrap(real, cfg, wl, dev):
        frame = real(cfg, wl, dev)
        return lambda seed: frame(seed ^ 1)

    return _frame_wrap(wrap)


# -------------------------------------------------------- mesh fit ----
def _step_wrap(wrap):
    real = mesh_fit.make_step
    return _swap(mesh_fit, "make_step",
                 lambda cfg, wl, dev, tables, target: wrap(real, cfg, wl, dev, tables, target))


def mesh_fit_control(dtype=torch.bfloat16):
    def make_step(cfg, wl, dev, tables, target):
        planes, grid = tables[0], tables[5]
        fos = torch.as_tensor(grid.face_of_slot, device=dev).long()
        slot_of_face = torch.empty(int(fos.max()) + 1, dtype=torch.long, device=dev)
        slot_of_face[fos[fos >= 0]] = (fos >= 0).nonzero()[:, 0]
        v, f, albedo, emission, material = inputs.mesh_of(cfg)
        mesh = ref_pt.mesh_tables(v, f, albedo, emission, material, dtype=dtype, device=dev)
        lrs = [float(x) for x in wl["learning_rates"]]
        kw = dict(cam=inputs.camera_constants(cfg, wl["width"], wl["height"]),
                  width=wl["width"], height=wl["height"], spp4=wl["spp4"],
                  bounces=cfg["bounces"], rr_depth=cfg["rr_depth"], eps=cfg["eps"])

        def step(leaves, seed):
            pl, sa, se = leaves
            params = {"sphere_albedo": pl[7:10].T, "sphere_emission": pl[4:7].T,
                      "face_albedo": sa[slot_of_face], "face_emission": se[slot_of_face]}
            params = {k: x.to(dtype) for k, x in params.items()}
            loss, g, _ = meshfit.loss_and_grads(params, pl.to(dtype), tables[4], mesh, target,
                                                seed=seed, **kw)
            pl, sa, se = pl.clone(), sa.clone(), se.clone()
            pl[7:10] -= lrs[0] * g["sphere_albedo"].T.to(pl.dtype)
            pl[4:7] -= lrs[0] * g["sphere_emission"].T.to(pl.dtype)
            sa[slot_of_face] -= lrs[1] * g["face_albedo"].to(sa.dtype)
            se[slot_of_face] -= lrs[2] * g["face_emission"].to(se.dtype)
            return loss.float(), [pl, sa, se]
        return step

    return _swap(mesh_fit, "make_step", make_step)


def mesh_fit_unchanged():
    def wrap(real, cfg, wl, dev, tables, target):
        step = real(cfg, wl, dev, tables, target)

        def faulty(leaves, seed):
            return step(leaves, seed)[0], leaves
        return faulty

    return _step_wrap(wrap)


def mesh_fit_half():
    return _step_wrap(lambda real, cfg, wl, dev, tables, target: real(
        cfg, dict(wl, spp4=wl["spp4"] // 2), dev, tables, target))


def mesh_fit_altered():
    def wrap(real, cfg, wl, dev, tables, target):
        step = real(cfg, wl, dev, tables, target)

        def faulty(leaves, seed):
            loss, new = step(leaves, seed)
            return loss * 1.5, new
        return faulty

    return _step_wrap(wrap)


PATCHES = {
    "fit": {"control": fit_control, "unchanged": fit_unchanged, "half": fit_half,
            "altered": fit_altered},
    "render": {"control": render_control, "unchanged": render_unchanged, "half": render_half,
               "altered": render_altered},
    "mesh_fit": {"control": mesh_fit_control, "unchanged": mesh_fit_unchanged,
                 "half": mesh_fit_half, "altered": mesh_fit_altered},
}
