// The C interface every library of csrc/ exports besides its entry points:
// rgmf_cuda_error_string(err), the name of a CUDA error code that an entry
// point returned (ops/_capi.py puts it in the launch's error message).
#pragma once

#include <cuda_runtime.h>

extern "C" const char* rgmf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
