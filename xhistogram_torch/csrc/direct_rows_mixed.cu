// Direct-route histograms of inputs of several types that are not all
// float32 or narrow (direct.cuh, which replaces
// xhistogram_tpu/ops/pallas_hist.py::_direct_kernel; its mixed
// instantiation): int32, int64 or float64 members beside inputs of another
// type (an int64 or int32 coordinate beside a float field, int16 members
// beside int64 ones), each read in place at its own width by its run-time
// load code and held in 8 bytes, int64 compared in int64 and every other
// type in double against its own thresholds (narrow.cuh's mixed entries),
// 8-bit data through a table of its 256 values' bins; counts and every
// accumulator class, the rounded float32 rows included, in a source of
// their own that compiles beside the others.

#include "direct.cuh"

XH_DIRECT_ROWS_CODED_ENTRY(xh_direct_rows_mixed, drow::Mixed)

XH_DIRECT_ROWS_CODED_CLASS(mixed, drow::Mixed, wf64, double)
XH_DIRECT_ROWS_CODED_CLASS(mixed, drow::Mixed, wu32, unsigned int)
XH_DIRECT_ROWS_CODED_CLASS(mixed, drow::Mixed, wu64, unsigned long long)
XH_DIRECT_ROWS_CODED_ROUNDED_CLASS(mixed, drow::Mixed, wf32, float)
