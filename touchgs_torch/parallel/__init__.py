"""Multi-GPU and multi-scene training on ``torch.distributed`` (port of
``touchgs_tpu/parallel/``)."""
from touchgs_torch.parallel.mesh import make_mesh, param_pspecs  # noqa: F401
from touchgs_torch.parallel.sharded import make_sharded_train_step  # noqa: F401
