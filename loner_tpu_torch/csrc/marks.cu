// Layer marks: one tiny kernel at each layer boundary of the mapper's iteration.
//
// Each boundary is its own instance of loner_mark_kernel<ID>, so a device trace
// names it. A launch writes the device's %globaltimer (ns) into a ring
// marks[rows, n_marks] at row slot[0] + offset, column ID; with no slot it
// writes marks[ID] (the anchor that maps the device clock onto the host's).
// Captured into the iteration's CUDA graph, the marks of every replay land in
// the row of that iteration, the row the iteration's record uses.
#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr int kMaxMarks = 16;

template <int ID>
__global__ void loner_mark_kernel(unsigned long long* marks, const long long* slot, int rows,
                                  int n_marks, int offset) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long row = slot == nullptr ? 0 : slot[0] + offset;
  if (row < 0 || row >= rows) return;
  marks[row * n_marks + ID] = now;
}

template <int... I>
const void* kernel(int id, std::integer_sequence<int, I...>) {
  static const void* const kernels[] = {reinterpret_cast<const void*>(&loner_mark_kernel<I>)...};
  return kernels[id];
}

}  // namespace

extern "C" int lt_mark(int id, unsigned long long* marks, const long long* slot, int rows,
                       int n_marks, int offset, void* stream) {
  if (id < 0 || id >= kMaxMarks || marks == nullptr || rows <= 0 || n_marks <= id) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = kernel(id, std::make_integer_sequence<int, kMaxMarks>{});
  void* args[] = {&marks, &slot, &rows, &n_marks, &offset};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(1), dim3(1), args, 0,
                                           static_cast<cudaStream_t>(stream)));
}
