// B7 of ToR-ORd dynCl + Land in forward Euler (torord_land_fe_multi_step_v):
// torord_land_grl_multi.cu built with the scheme switch of its node body on
// (torord.cuh's kFE), so the formulas are the one copy the GRL kernels run.
// The JAX kernel runs this step when it traces
// fenicsx_beat_tpu/models/torord_dyncl_land.py:234.  A translation unit of its
// own, so nvcc's time for it is its own.
#define FBT_FORWARD_EULER
#include "torord_land_grl_multi.cu"
