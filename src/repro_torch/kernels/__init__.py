"""Hand-written CUDA kernels of the port (``csrc/``), their wrappers, their
plain PyTorch versions (``ref``) and the dispatch by device (``ops``).

| kernel          | replaces                                      |
|-----------------|-----------------------------------------------|
| ``frame_accum`` | ``repro/kernels/frame_accum.py::frame_accum`` |
| ``bfs_frontier``| ``repro/kernels/bfs_frontier.py::bfs_frontier``|
| ``alias_draw``  | ``repro/kernels/alias_draw.py::alias_draw``   |
| ``flash_attention`` | ``repro/kernels/flash_attention.py::flash_attention`` |
| ``rglru_scan``  | ``repro/kernels/rglru_scan.py::rglru_scan``   |
| ``ssm_scan``    | ``repro/kernels/ssm_scan.py::ssm_scan``       |
"""
from . import ops, ref  # noqa: F401

__all__ = ["ops", "ref"]
