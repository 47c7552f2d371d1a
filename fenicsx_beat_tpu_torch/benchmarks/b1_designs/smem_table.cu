// A design of ToR-ORd's and Land's B7 that was measured on the card and not
// kept: one node a thread in both forms, the [nm, NP] parameter table
// copied into shared memory once a block and read from there, in place of
// the library's reads through the read-only path.  It was not faster on
// both forms (PERF.md).  benchmarks/b1_designs.py builds it beside the
// library's B1 and per-node form.
#include "torord_designs.cuh"

#define MULTI_MIN_BLOCKS(land) design::Model<land>::kMultiMinBlocks
TORORD_DESIGN_B7(false, true, MULTI_MIN_BLOCKS)
