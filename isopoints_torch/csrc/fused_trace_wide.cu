// The in-kernel march's instances above width 256 (mlp_mma.cuh "Widths"):
// fused_trace.cu built again with MLP_MMA_WIDE_LIB defined, into a library of
// its own, so that nvcc compiles the wide instances beside the narrow ones.
// See fused_trace.cu for what the kernel replaces, its bound and its design.

#define MLP_MMA_WIDE_LIB
#include "fused_trace.cu"
