"""Data parallelism across processes, the counterpart of
``glsdet_tpu.parallel``: one process per card (NCCL) or per CPU worker
(gloo), each holding its slice of the global batch, reducing what the JAX
package's global-view step reduces over the whole batch
(``parallel/mesh.py``)."""

from glsdet_tpu_torch.parallel.mesh import (DataMesh, data_mesh,
                                            init_distributed,
                                            maybe_init_distributed,
                                            replicate, shard_batch,
                                            shutdown)

__all__ = ["DataMesh", "data_mesh", "init_distributed",
           "maybe_init_distributed", "replicate", "shard_batch", "shutdown"]
