// Direct-route weighted sums, accumulator class wu64 (direct.cuh): int64
// and uint64 weights summed mod 2^64, each row stored as 64-bit words.

#include "direct.cuh"

XH_DIRECT_ROWS_CLASS(wu64, unsigned long long)
