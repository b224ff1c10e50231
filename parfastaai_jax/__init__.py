"""ParFastAAI-JAX: an accelerator Average Jaccard Index (AJI) engine.

A from-scratch JAX/XLA re-design of the capabilities of
AluruLab/ParFastAAI: per-single-copy-protein genome x tetramer presence
matrices, intersection counts as int8 Gram matmuls on the device, exact f64
Jaccard finish, and the three run modes (all-vs-all, query-subset,
two-database) with bit-for-bit output parity against the reference goldens.
"""

__version__ = "0.1.0"

from .types import DBMetaData, ErrorCode, JacResult, PFAAIError

__all__ = ["DBMetaData", "ErrorCode", "JacResult", "PFAAIError", "__version__"]
