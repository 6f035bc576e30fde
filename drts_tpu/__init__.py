"""drts_tpu — a physically-based real-time path-tracing framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
Hydr10n/DirectX-Raytracing-Spheres-Demo (see SURVEY.md):
rigid-body sphere dynamics, wavefront path tracing with a 3-lobe BSDF,
ReSTIR DI, a SHARC-style hash-grid radiance cache, NRD-style denoising,
TAA upscaling, bloom and tone mapping — all expressed as pure functions
over pytrees, jitted end-to-end, and shardable over a device mesh.

Layers (mirroring SURVEY.md §1, redesigned as array programs):
  utils/    — core math "MathLib": vectors, quaternions, RNG, sampling, color
  ops/      — render passes as pure jittable functions (the HLSL kernels)
  models/   — scene representation, geometry generators, the demo scene,
              and the flagship RenderPipeline (the frame orchestrator)
  parallel/ — device-mesh pixel-tile sharding and collectives
"""

import os as _os

__version__ = "0.1.0"

# Root of the checkout: caches and optional assets live under it.
CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
