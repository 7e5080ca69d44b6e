// Host helper shared by the C entries: they launch on the current device and
// never set one. The caller (ops/kernels.py _launch) makes the batch's device
// current for the call and puts its own back afterwards, so a launch leaves
// the calling thread's device as it found it. `device` keys the entries'
// per-device caches (shared memory opt-in, resident blocks), so it must be the
// current device; anything else is refused before any work is enqueued.
#pragma once
#include <cuda_runtime.h>

inline cudaError_t check_current_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaErrorInvalidDevice;
}
