// A design of ToR-ORd's and Land's B7 that was measured on the card and not
// kept: staged (csrc/staged.cuh) over every block as over a block list, 2
// blocks an SM.  The library stages only the block-list form: over every
// block the staging ran slower (PERF.md).  benchmarks/b1_designs.py builds
// it beside the library's B1 and per-node form.
#include "torord_designs.cuh"

#define STAGED_MIN_BLOCKS(land) 2
TORORD_DESIGN_B7(true, false, STAGED_MIN_BLOCKS)
