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
- ``ops.bvh_kernels``   — the stackless BVH traversal: CUDA kernel
  (``csrc/bvh.cu``), plain twin, launch count, packed tables.
- ``ops.sort``          — Morton ray-sort keys for traversal coherence.
- ``diff.mesh_fused``   — the mesh renderer's replay backward and its
  ``torch.autograd.Function``.
- ``diff.mesh``         — the differentiable bounce-loop mesh render
  (vertices and face attributes as leaves) and the stale-table guard.
- ``accel.tri``         — brute-force ray-triangle intersection (the
  oracle).
- ``accel.bvh``         — the binned-SAH BVH builder (native where its
  library builds, else NumPy) and the per-ray stackless walk in plain
  torch.
- ``accel.native``      — the native (C++) host library: the BVH builder,
  the fused PPM codec and the OBJ loader (``native/*.cpp``), built with
  g++ at first use into ``build/ascendpathtracing_tpu_torch/`` and bound
  with ctypes.
- ``models.mesh``       — mesh scenes, their device tables in four
  traversal modes, the first-hit query and the bounce-loop mesh path
  tracer.
- ``parallel``          — ``torch.distributed`` counterparts of the JAX
  package's ``parallel/``: meshes of ranks, the data-parallel training
  step (SGD through the reference kernels and one all-reduce), DP x TP
  and mesh renders, the two rings, host-0 assembly, and the launcher of
  local worlds (``distributed.run_local_world``).
- ``graft_entry``       — ``entry()`` and the multi-rank dry run
  ``dryrun_multichip(n)``.
- ``post``              — firefly clamp, tone maps, the a-trous denoiser.
- ``utils.debug``       — ``print_data``, ``assert_finite`` and the float
  guard ``checkify_render``.
- ``utils.profiling``   — ``trace`` (torch.profiler), fences, ``benchmark``
  and the two-point fit ``benchmark_fit``.
- ``utils.roofline``    — ``count_ops``: element ops of eager torch code
  by class, the numerators of a kernel's bound (through its plain twin).
- ``ops.build``         — builds ``csrc/*.cu`` with nvcc at first use.
- ``cli``, ``bench``    — the user entry points.
- ``config``, ``scenes``, ``camera``, ``oracle``, ``utils.io``,
  ``utils.checkpoint``, ``accel.meshes`` — the NumPy host modules, copies
  of the JAX package's modules of the same names (tests hold each against
  its original).

The port imports ``torch`` and never ``jax``, and nothing of the JAX
package.
"""

from ascendpathtracing_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
