// Direct-route weighted sums, accumulator class wf64 (direct.cuh): float16,
// bfloat16, float32 and float64 weights summed in float64, each row stored
// as float64 (float64 weights, and raw sums that a caller adds up before
// rounding once).

#include "direct.cuh"

XH_DIRECT_ROWS_CLASS(wf64, double)
