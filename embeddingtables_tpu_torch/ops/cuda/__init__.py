"""Hand-written CUDA kernels (sources in `csrc/`) with their plain versions."""
from .gather import (BagLayout, gather_bags, gather_bags_plain,
                     gather_bags_ragged, gather_bags_ragged_plain, gather_rows,
                     gather_rows_plain)
from .scatter import (scatter_add_rows_sorted, scatter_add_rows_sorted_plain,
                      scatter_update)
from .segsum import hot_accumulate, hot_accumulate_plain

__all__ = ["BagLayout", "gather_rows", "gather_bags", "gather_bags_ragged",
           "gather_rows_plain", "gather_bags_plain",
           "gather_bags_ragged_plain", "scatter_add_rows_sorted",
           "scatter_add_rows_sorted_plain", "scatter_update",
           "hot_accumulate", "hot_accumulate_plain"]
