// B7 of ToR-ORd dynCl in forward Euler (torord_fe_multi_step_v):
// torord_grl_multi.cu built with the scheme switch of its node body on
// (torord.cuh's kFE), so the formulas are the one copy the GRL kernels run.
// The JAX kernel runs this step when it traces
// fenicsx_beat_tpu/models/torord_dyncl.py:825.  A translation unit of its own,
// so nvcc's time for it is its own.
#define FBT_FORWARD_EULER
#include "torord_grl_multi.cu"
