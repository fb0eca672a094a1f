"""Data parallelism on ``torch.distributed``, the counterpart of
``nerf_rs_tpu/parallel/``: ``dist_init`` (the process group), ``launch``
(a host's ranks), ``mesh`` (the JAX meshes as process groups), ``dp`` (the
data-parallel step and the sharded render) and ``multiscene``."""
