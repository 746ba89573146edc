"""CKKS core of the port: RNS arithmetic, keys, keyswitch engine, scheme."""
from repro_torch.core.params import (  # noqa: F401
    BOOT_TEST_PARAMS, PAPER_PARAMS, SMALL_TEST_PARAMS, CKKSParams,
)
