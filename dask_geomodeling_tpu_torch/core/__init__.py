from dask_geomodeling_tpu_torch.core.tokens import tokenize  # noqa: F401
from dask_geomodeling_tpu_torch.core.graphs import Block, arg, compute, construct  # noqa: F401
from dask_geomodeling_tpu_torch.core.validate import expect_instance  # noqa: F401
