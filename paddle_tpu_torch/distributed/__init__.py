"""Multi-process data parallelism over torch.distributed: the launcher's
env contract and the process group (the parameter-server stack of the JAX
package's distributed/ is not ported yet)."""
from .parallel import ParallelEnv, init_parallel_env  # noqa: F401
