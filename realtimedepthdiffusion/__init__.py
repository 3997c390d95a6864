"""Framework for live, user-guided depth-map estimation from a single
image — a ground-up JAX/XLA/Pallas rebuild with the capabilities of
MarcioCerqueira/RealTimeDepthDiffusion (see SURVEY.md for the reference map).

Layers (bottom-up):
- ``core``     pure-functional JAX pipeline (pyramids, edge weights, Jacobi +
               Chebyshev / red-black solvers, cascadic + V-cycle multigrid,
               depth effects)
- ``ops``      the route table and the coarse-level GPU sweep kernel
               (Pallas, Triton route), with the core as oracle
- ``parallel`` multi-device spatial sharding (shard_map + halo exchange)
- ``oracle``   pure-NumPy reference backend (test ground truth, CPU fallback)
- ``io``       image/annotation codecs (numpy PNG codec; the only module
               touching Pillow, for other formats)
- ``live``     interactive session, CLI and key-binding contract
- ``native``   C++ host runtime (event queue, brush rasterizer, schedule
               planner) bound via ctypes
"""

from .config import DEFAULT_CONFIG, SCRIBBLE_DEPTH_VALUES, DiffusionConfig
from .pipeline import DepthPipeline, get_pipeline

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_CONFIG",
    "SCRIBBLE_DEPTH_VALUES",
    "DiffusionConfig",
    "DepthPipeline",
    "get_pipeline",
    "__version__",
]
