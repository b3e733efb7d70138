// A no-op device guard for CUDA, for a build of PyTorch without CUDA.
//
// The dry-run (launch/op_analysis.py) traces a step on fake tensors whose
// device is cuda:0. PyTorch's Python indexing, and factory calls with a
// device, open a device guard for the tensor's device; a CPU-only build has
// none registered for CUDA and raises. This one keeps no state and sets
// nothing, as PyTorch's own guards for the CPU and meta devices do. A
// build of PyTorch with CUDA has its own guard and never loads this file's
// library. Built with the host's C++ compiler by op_analysis.py.
#include <c10/core/impl/DeviceGuardImplInterface.h>

namespace {
const c10::impl::NoOpDeviceGuardImpl<c10::DeviceType::CUDA> kGuard;
}

// 1 when this call registered the guard, 0 when a CUDA guard was there already.
extern "C" int repro_register_fake_cuda_guard() {
  if (c10::impl::hasDeviceGuardImpl(c10::DeviceType::CUDA)) return 0;
  c10::impl::registerDeviceGuard(c10::DeviceType::CUDA, &kGuard);
  return 1;
}
