// The bitonic sort's plan runner, for the other sources of the library
// (csrc/bwt.cu enqueues its sorts between its own kernels).
#pragma once

#include <cuda_runtime.h>

namespace tpubz {

// Runs the encoded plan (tpubz_torch/kernels/bitonic.py:encode) in place on
// n = 2^m int64 keys, with an int32 payload or null, on `stream`, and adds
// the kernel launches it made to *launched. `done`: null, or a device int
// that every pass kernel reads first and returns at once when it is not 0
// (the launches are still made and counted). Returns cudaGetLastError() as
// an int.
int bitonic_run_i64(void* keys, void* payload, int n, const int* plan, int plan_len,
                    int* launched, const int* done, cudaStream_t stream);

}  // namespace tpubz
