from lbm_tpu_torch.core import lattice, oracle
from lbm_tpu_torch.core.lattice import (
    CX,
    CY,
    NSPEEDS,
    OPP,
    W0,
    W1,
    W2,
    equilibrium_rest,
)

__all__ = [
    "lattice",
    "oracle",
    "CX",
    "CY",
    "NSPEEDS",
    "OPP",
    "W0",
    "W1",
    "W2",
    "equilibrium_rest",
]
