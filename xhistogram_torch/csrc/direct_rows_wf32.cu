// Direct-route weighted sums, class wf32 (direct.cuh): float16, bfloat16 and
// float32 weights summed in float64, each row stored as float32, every slot
// rounded once (the finished sums of bincount.finish_sums).

#include "direct.cuh"

XH_DIRECT_ROWS_ROUNDED_CLASS(wf32, float)
