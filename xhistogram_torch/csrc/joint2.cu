// Joint two-input histogram, full reduction: the entries for inputs of one
// type (joint2.cuh has the kernel, which replaces
// xhistogram_tpu/ops/pallas_hist.py::_joint2_kernel, and its design), and
// the launch record every kernel of the library reports through.

#include "joint2.cuh"

XH_JOINT2(xh_joint2_f32, float, float)
XH_JOINT2(xh_joint2_f64, double, double)
XH_JOINT2(xh_joint2_i32, int, int)
XH_JOINT2(xh_joint2_i64, long long, long long)

// The weighted entries xh_joint2_<data>_<cls> of the accumulator
// class cls (accumulator type A), for the four data types.
#define XH_JOINT2_WEIGHTED_CLASS(cls, A)                                      \
  XH_JOINT2_WEIGHTED(xh_joint2_f32_##cls, float, float, A)                    \
  XH_JOINT2_WEIGHTED(xh_joint2_f64_##cls, double, double, A)                  \
  XH_JOINT2_WEIGHTED(xh_joint2_i32_##cls, int, int, A)                        \
  XH_JOINT2_WEIGHTED(xh_joint2_i64_##cls, long long, long long, A)

XH_JOINT2_WEIGHTED_CLASS(wf64, double)
XH_JOINT2_WEIGHTED_CLASS(wu32, unsigned int)
XH_JOINT2_WEIGHTED_CLASS(wu64, unsigned long long)

// out[0..13]: what the last launch of this process chose (xh::LaunchRecord):
// blocks a cluster, passes, histogram in shared memory (1) or device memory
// (0), the cells asked for the first two inputs, then 1 for a one_input
// launch (0 for joint2 and the flat-slot routes) with its counter layout
// and the histogram's copies in shared memory, then a direct-row launch's
// warps a block (0 for the other kernels), blocks and rows a warp, then 1
// for a flat-slot launch that kept float sums as exact integers, then 1 for
// a one_input launch whose launcher zeroed the output, then 1 for a
// flat-slot launch whose run pieces took the vector loads.
extern "C" void xh_last_launch(int* out) {
  const xh::LaunchRecord r = xh::last_launch;
  out[0] = r.cluster;
  out[1] = r.passes;
  out[2] = r.shared;
  out[3] = r.cells[0];
  out[4] = r.cells[1];
  out[5] = r.one_input;
  out[6] = r.layout;
  out[7] = r.copies;
  out[8] = r.warps;
  out[9] = r.blocks;
  out[10] = r.rows_per_warp;
  out[11] = r.exact;
  out[12] = r.zeroed;
  out[13] = r.vector;
}
