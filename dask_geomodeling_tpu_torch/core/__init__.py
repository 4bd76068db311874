from dask_geomodeling_tpu_torch.core.tokens import register_normalizer, tokenize  # noqa: F401
from dask_geomodeling_tpu_torch.core.graphs import (  # noqa: F401
    Block,
    DummyBlock,
    arg,
    compute,
    construct,
    construct_multiple,
)
from dask_geomodeling_tpu_torch.core.validate import expect_instance  # noqa: F401
