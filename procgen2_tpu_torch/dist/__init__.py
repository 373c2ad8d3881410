"""Data-parallel execution (procgen2_tpu/dist), in PyTorch: `ShardedEnv`
and `make_vec` over this process's rows of a global batch
(`torch.distributed` joins the processes, `init_multihost`), and
`rollout`, T steps as one CUDA graph."""
from .vec import ShardedEnv, init_multihost, local_slice, make_vec
from .rollout import RolloutBuffer, rollout

__all__ = ["ShardedEnv", "make_vec", "local_slice", "init_multihost",
           "rollout", "RolloutBuffer"]
