"""Hand-written CUDA kernels (sources in `csrc/`) with their plain versions."""
from .gather import (gather_bags, gather_bags_plain, gather_rows,
                     gather_rows_plain)

__all__ = ["gather_rows", "gather_bags", "gather_rows_plain",
           "gather_bags_plain"]
