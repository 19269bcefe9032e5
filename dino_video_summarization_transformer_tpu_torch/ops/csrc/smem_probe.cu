// Hopper (sm_90a) probe of the dynamic shared memory a block may opt into:
// the card counterpart of the TPU's scoped-VMEM budget probe.
//
//   dvst_smem_roundtrip  replaces the `kernel` of tools/vmem_probe.py:31
//       (a trivial Pallas kernel with an N-MB VMEM scratch, compiled at a
//       bisected N): one block copies a row of nbytes / 4 floats into
//       nbytes of dynamic shared memory and back out in reverse order,
//       after cudaFuncSetAttribute(cudaFuncAttributeMaxDynamicSharedMemorySize,
//       nbytes). A size the card refuses fails the attribute call or the
//       launch; tools/smem_probe.py bisects over nbytes and checks the row.
//   dvst_smem_optin_max  cudaDevAttrMaxSharedMemoryPerBlockOptin of the
//       current device, reported beside the measured budget.
//
// Bound: by bytes, one read and one write of the row (2 x 227 KB at most,
// ~0.14 us at 3.35 TB/s); a launch this small costs its launch latency,
// which is not what the probe is for.

#include <cuda_runtime.h>

namespace {

__global__ void smem_roundtrip_kernel(const float* __restrict__ in,
                                      float* __restrict__ out, int n) {
  extern __shared__ float buf[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = in[i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = buf[n - 1 - i];
}

}  // namespace

extern "C" {

// in, out: nbytes / 4 floats on the current device. Returns the CUDA error
// of the attribute call or of the launch; 0 means the kernel was launched.
int dvst_smem_roundtrip(const void* in, void* out, int nbytes, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      smem_roundtrip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused size is an answer, not a sticky error
    return e;
  }
  smem_roundtrip_kernel<<<1, 256, nbytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), nbytes / 4);
  return cudaGetLastError();
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of the current device, or -1.
int dvst_smem_optin_max() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return v;
}

}  // extern "C"
