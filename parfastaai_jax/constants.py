"""Global constants of the ParFastAAI-JAX engine.

The tetramer universe is the set of length-4 amino-acid substrings over the
20-letter alphabet, encoded as integers in ``[0, 20**4)`` (reference:
include/pfaai/interface.hpp:233, NTETRAMERS = 160000).
"""

# Number of possible amino-acid tetramers (20**4).
NTETRAMERS: int = 160000

# Default CSV field separator (reference: src/main.cpp:74, default ",").
DEFAULT_SEPARATOR: str = ","

# Granularity of the compacted tetramer axis: presence widths are padded to
# a multiple of this host-side (etl.database), which is also the grain of
# the width-bucket plan.  128 int8 columns keep every presence row 128-byte
# aligned and are a whole number of the int8 tensor-core matmul's
# contraction steps (32 per instruction on Hopper), so no K remainder
# reaches the device.
LANE: int = 128
