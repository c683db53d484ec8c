// Error strings of the port's kernel library (codes from common.cuh).

#include "common.cuh"

extern "C" const char* ptt_error_string(int code) {
  if (code == ptt::kUnsupported) return "unsupported shape or dtype";
  if (code == ptt::kShortRegisters)
    return "the kernel holds fewer registers a thread than its setmaxnreg "
           "split needs; launched, it would never finish";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
