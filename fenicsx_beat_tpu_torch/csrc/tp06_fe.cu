// B1 of TP06 in forward Euler (tp06_fe_step_v): tp06_grl.cu built with the
// scheme switch of its node body on (tp06.cuh's kFE), so the formulas are the
// one copy the GRL kernels run.  The JAX kernel runs this step when it traces
// fenicsx_beat_tpu/models/tentusscher_panfilov_2006.py:479.  A translation
// unit of its own, so nvcc's time for it is its own.
#define FBT_FORWARD_EULER
#include "tp06_grl.cu"
