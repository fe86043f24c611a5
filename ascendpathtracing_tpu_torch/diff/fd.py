"""Central finite-difference gradient checking over a dict of tensors.

Counterpart of ``ascendpathtracing_tpu/diff/fd.py``.  The leaves are
visited in sorted key order (JAX's order for a dict pytree), so that an
``rng`` draws the same coordinates as the JAX version; the AD side of
:func:`check_grads_fd` is ``torch.autograd.grad`` of
``loss_fn(params).sum()``.
"""

from __future__ import annotations

import numpy as np
import torch


def fd_grad(loss_fn, params, *, eps=1e-5, coords=None, rng=None, rel=False):
    """Central-difference gradient of ``loss_fn`` (a scalar of a dict of
    tensors) -> a dict of float64 CPU tensors of the leaves' shapes, the
    differences at the sampled ``coords`` (every coordinate when None; an
    int samples that many per leaf with ``rng``, a ``numpy.random.
    RandomState``, seed 0 when None; a list names them) and NaN elsewhere.
    ``rel=True`` steps ``eps * max(1, |x|)``."""
    rng = rng or np.random.RandomState(0)
    out = {}
    for name in sorted(params):
        leaf = params[name]
        base = leaf.detach().cpu().double().numpy()
        g = np.full(base.shape, np.nan)
        flat = base.reshape(-1)
        if coords is None:
            idxs = range(flat.size)
        elif isinstance(coords, int):
            idxs = rng.choice(flat.size, size=min(coords, flat.size), replace=False)
        else:
            idxs = coords
        for i in idxs:
            e = np.zeros_like(flat)
            # relative step when the coordinate's scale dwarfs eps (r^2
            # spans 272..1e10 across the Cornell scene's spheres)
            e[i] = eps * max(1.0, abs(flat[i])) if rel else eps
            lp = _eval(loss_fn, params, name, (flat + e).reshape(base.shape))
            lm = _eval(loss_fn, params, name, (flat - e).reshape(base.shape))
            g.reshape(-1)[i] = (lp - lm) / (2 * e[i])
        out[name] = torch.from_numpy(g)
    return out


def _eval(loss_fn, params, name, new_leaf):
    leaf = params[name]
    with torch.no_grad():
        return float(loss_fn({**params, name: torch.tensor(new_leaf, dtype=leaf.dtype,
                                                           device=leaf.device)}))


def check_grads_fd(loss_fn, params, *, eps=1e-5, coords=8, rtol=1e-4, atol=1e-6,
                   rng=None, rel=False):
    """Asserts that the autograd gradients match the central differences
    on sampled coordinates -> (ad, fd) dicts, for reporting."""
    names = sorted(params)
    leaves = {k: params[k].detach().clone().requires_grad_(True) for k in names}
    grads = torch.autograd.grad(loss_fn(leaves).sum(), [leaves[k] for k in names],
                                allow_unused=True)
    ad = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(names, grads)}
    fd = fd_grad(loss_fn, params, eps=eps, coords=coords, rng=rng, rel=rel)
    for k in names:
        a = ad[k].detach().cpu().double().numpy()
        f = fd[k].numpy()
        mask = ~np.isnan(f)
        np.testing.assert_allclose(a[mask], f[mask], rtol=rtol, atol=atol, err_msg=k)
    return ad, fd
