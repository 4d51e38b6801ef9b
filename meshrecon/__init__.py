"""meshrecon: dense mesh reconstruction from monocular video, in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference `addam/mesh-reconstruction` C++/OpenGL program: it ingests an RGB
video plus a Blender-exported YAML camera track and iteratively refines a
sparse point cloud into a dense triangle mesh.

Layer map (mirrors SURVEY.md section 1, re-architected for an accelerator):

- ``meshrecon.io``        -- OpenCV-YAML dialect parser, video decode, OBJ/PNG IO
- ``meshrecon.geometry``  -- camera model, homogeneous ops (pure jnp)
- ``meshrecon.raster``    -- software z-buffer rasterizer + projective texturing
- ``meshrecon.flow``      -- pyramidal dense optical flow, variance, warping
- ``meshrecon.depth``     -- fused per-pixel Gauss-Newton depth triangulation + normals
- ``meshrecon.points``    -- density-based point filtering (grid hash, on device)
- ``meshrecon.meshing``   -- alpha shapes and FFT-Poisson surface extraction
- ``meshrecon.pipeline``  -- heuristic camera policy, outer loop, CLI config
- ``meshrecon.sharding``  -- jax.sharding meshes, multi-chip execution
"""

__version__ = "0.1.0"

BACKGROUND_DEPTH = 1.0  # NDC-depth sentinel for empty pixels (recon.hpp:30)
