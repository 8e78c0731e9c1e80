// One-time kernel state, kept per device.
//
// The runtime launches on the current device, and a sharded solve or a
// lane-sharded sweep runs one kernel on every card of its mesh
// (kernels/cuda_lib.launch makes the operands' device current first). A
// function attribute set with cudaFuncSetAttribute, or a device property
// read once, holds only for the device that was current at the time, so
// such state lives in a small table indexed by the device ordinal.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace mt {

constexpr int kMaxDevices = 64;

// The current device's ordinal, or -1 when it lies outside the table.
inline int current_device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return -1;
  return dev;
}

// Runs `set()` (returning a cudaError_t) once on each device: `done` is a
// function-local static table, zero (false) at load. A failed `set` is
// tried again at the next call.
template <typename F>
cudaError_t once_per_device(std::atomic<bool> (&done)[kMaxDevices], F set) {
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (done[dev].load()) return cudaSuccess;
  const cudaError_t err = set();
  if (err == cudaSuccess) done[dev].store(true);
  return err;
}

// The current device's streaming multiprocessors, read once per device
// (0 when the device lies outside the table).
inline int sm_count() {
  static std::atomic<int> sms[kMaxDevices];
  const int dev = current_device();
  if (dev < 0) return 0;
  int n = sms[dev].load();
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev].store(n);
  }
  return n;
}

}  // namespace mt
