"""The parallel layer (counterpart of `paddle_tpu/parallel/`), as far as
the port goes: a one-member `dp` mesh (`mesh.local_mesh`), the sharded
embedding engine (`sparse`) and the `ParallelExecutor` that drives it on
one card. Collectives over several members, the gradient-sync policies,
the transpiler, ring and Ulysses attention, MoE and fleet are not
ported (ROADMAP queue A 10)."""
from . import mesh, parallel_executor, sparse
from .mesh import Mesh, local_mesh
from .parallel_executor import ParallelExecutor

__all__ = ["Mesh", "local_mesh", "ParallelExecutor", "mesh", "sparse",
           "parallel_executor"]
