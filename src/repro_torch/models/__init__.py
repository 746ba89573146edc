"""The LM zoo's dense decoder family on torch tensors (see ``model``)."""
from repro_torch.models.model import (  # noqa: F401
    forward, init_cache, init_params,
)
