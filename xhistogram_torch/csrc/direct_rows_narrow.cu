// Direct-route histograms of float32 and narrow data (direct.cuh, which
// replaces xhistogram_tpu/ops/pallas_hist.py::_direct_kernel; its narrow
// instantiation): bool, int8, uint8, int16, uint16, float16 and bfloat16
// inputs, in any mix with float32 ones, each read in place at its own width
// and widened in registers to float32 (narrow.cuh), 8-bit data through a
// table of its 256 values' bins; counts and every accumulator class, the
// rounded float32 rows included, in a source of their own that compiles
// beside the others.

#include "direct.cuh"

XH_DIRECT_ROWS_CODED_ENTRY(xh_direct_rows_narrow, drow::Narrow)

XH_DIRECT_ROWS_CODED_CLASS(narrow, drow::Narrow, wf64, double)
XH_DIRECT_ROWS_CODED_CLASS(narrow, drow::Narrow, wu32, unsigned int)
XH_DIRECT_ROWS_CODED_CLASS(narrow, drow::Narrow, wu64, unsigned long long)
XH_DIRECT_ROWS_CODED_ROUNDED_CLASS(narrow, drow::Narrow, wf32, float)
