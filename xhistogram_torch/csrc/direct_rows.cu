// Direct-route counts: the entries of direct.cuh (which replaces
// xhistogram_tpu/ops/pallas_hist.py::_direct_kernel) for int64 counts, one
// per data type. The weighted entries are in direct_rows_w*.cu, one source
// per accumulator class, so the classes compile side by side, each in its
// own nvcc.

#include "direct.cuh"

XH_DIRECT_ROWS_ENTRY(xh_direct_rows_f32, float)
XH_DIRECT_ROWS_ENTRY(xh_direct_rows_f64, double)
XH_DIRECT_ROWS_ENTRY(xh_direct_rows_i32, int)
XH_DIRECT_ROWS_ENTRY(xh_direct_rows_i64, long long)
