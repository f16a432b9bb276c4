// Direct-route weighted sums, accumulator class wu32 (direct.cuh): bool and
// 8-, 16- and 32-bit integer weights summed mod 2^32, each row stored as
// int32.

#include "direct.cuh"

XH_DIRECT_ROWS_CLASS(wu32, unsigned int)
