"""Multi-device spatial sharding: partitioning, halo exchange, sharded solvers.

Port of ``fenicsx_beat_tpu/parallel/``, the replacement of the reference's
MPI domain decomposition (DOLFINx mesh partitioning, PETSc ghost
scatters and the KSP's per-iteration all-reduces).  The JAX package
shards node arrays over a 1-D ``jax.sharding.Mesh`` with ``lax.ppermute``
halos and ``lax.psum`` dots; the port runs SPMD over ``torch.distributed``
(:mod:`.distributed`), one process per rank and one device per process,
its halos and reductions carried by one communicator (:mod:`.comm`):
NCCL on the card, gloo on the CPU.  The ODE stage needs no communication,
exactly like the reference's.
"""

from . import partition  # noqa: F401
from .bidomain import ShardedBidomainSolver  # noqa: F401
from .comm import Communicator  # noqa: F401
from .distributed import (  # noqa: F401
    DeviceMesh,
    initialize_distributed,
    is_coordinator,
    make_device_mesh,
    spawn_ranks,
)
from .solver import ShardedMonodomainSolver  # noqa: F401
