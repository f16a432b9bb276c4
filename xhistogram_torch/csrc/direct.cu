// Direct-route histograms: N inputs, kept rows, int64 counts.
//
// Replaces the TPU kernel xhistogram_tpu/ops/pallas_hist.py::_direct_kernel
// (driven by _run_direct, with _pick_tiles_direct). That kernel builds a
// one-hot of each element's flat slot over a chunk of slots and multiplies
// it with a row one-hot on the TPU's matrix unit, chunk by chunk, because
// the TPU has no fast scatter. Here it is the flat-slot histogram of
// slot.cuh: each element is digitized once per input and counted with one
// atomic into its row's histogram.
//
// plan() sends it kept rows narrower than 256 elements with at most 8192
// slots (e.g. a joint PDF of two variables at each of 64,800 grid cells
// over 64 members), and every kept-row call forced with method="cuda"
// outside plan()'s envelopes, at any slot count. At the narrow shapes a
// tile holds several whole rows, each with its histogram in shared memory,
// and stores every slot of them, so the output needs no zeroing pass.
//
// What bounds it on an H100: the output. Each row writes 8 (S + 1) bytes
// against 2 sizeof(T) c bytes read, 830 MB of int64 against 33 MB of
// float32 at (64800, 64) x 2 inputs in 40x40 bins.

#include "slot.cuh"

XH_SLOT_ENTRY(xh_direct_f32, float, 0)
XH_SLOT_ENTRY(xh_direct_f64, double, 0)
XH_SLOT_ENTRY(xh_direct_i32, int, 0)
XH_SLOT_ENTRY(xh_direct_i64, long long, 0)
