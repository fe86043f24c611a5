"""AscendPathTracing on PyTorch and CUDA: the port of ``ascendpathtracing_tpu``.

The JAX package stays the reference.  This package mirrors its layout so
that each module's counterpart is found under the same name:

- ``device``            — ``resolve_device("cuda" | "cpu")``; no fallback.
- ``convert``           — the JAX package's NumPy scene tables and rays as
  tensors on a chosen device and dtype.
- ``ops.intersect``     — ray-sphere intersection over SoA planes.
- ``ops.shade``         — the shading ops: the reference's specular
  bounce and the path tracer's BSDFs and Russian roulette.
- ``ops.rng``           — Philox4x32-10 uniforms keyed by counter, the
  stand-in for the TPU's hardware PRNG.
- ``models.megakernel`` — the renderers in plain torch: reference
  semantics, the path-tracing estimators (with and without NEE) and the
  first-hit AOVs (their backward is torch autograd).
- ``ops.render_kernels``— the hand-written CUDA kernels of the reference
  render (``csrc/render_ref.cu``), their plain twins, launch counters,
  and the differentiable render (``RenderReferenceFn``,
  ``RenderReference``).
- ``ops.pt_kernels``    — the fused sphere path tracer: the hand-written
  CUDA kernel (``csrc/render_pt.cu``), its plain twin and launch count.
- ``ops.chunk_grid``    — the chunk-grid builder (NumPy): a mesh cut into
  fixed-size chunks under 1-3 levels of boxes.
- ``ops.wbvh_kernels``  — the chunk-grid traversal: CUDA kernel
  (``csrc/wbvh.cu``), plain twin, launch count.
- ``ops.mesh_pt_kernels``— the fused sphere+mesh path tracer: CUDA kernel
  (``csrc/mesh_pt.cu``, with the replay residuals), plain twin, launch
  count, tables.
- ``ops.histogram_kernels`` — the segment-sum: CUDA kernel
  (``csrc/segsum.cu``), plain twins, launch count.
- ``diff.mesh_fused``   — the mesh renderer's replay backward and its
  ``torch.autograd.Function``.
- ``accel.tri``         — brute-force ray-triangle intersection (the
  oracle).
- ``models.mesh``       — mesh scenes, their device tables and the
  first-hit query.
- ``ops.build``         — builds ``csrc/*.cu`` with nvcc at first use.
- ``cli``, ``bench``    — the user entry points.
- ``config``, ``scenes``, ``camera``, ``oracle``, ``utils.io``,
  ``accel.meshes`` — the NumPy host modules, copies of the JAX package's
  modules of the same names (tests hold each against its original).

The port imports ``torch`` and never ``jax``, and nothing of the JAX
package.
"""

from ascendpathtracing_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
