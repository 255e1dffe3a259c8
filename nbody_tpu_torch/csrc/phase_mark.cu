// Phase marks: an empty one-thread kernel for each (phase, edge), launched
// on the current stream where a phase of utils/profiling.py begins (edge 0)
// and ends (edge 1) while the profiling switch is at "trace".
//
// Replaces: no TPU kernel. A CUDA graph replay runs no host code where a
// phase begins or ends, so here that edge is a device operation of its
// own. A mark is a captured kernel node like any other, so each replay
// launches it again, and a profiler's trace names it
// nbody_phase_mark<phase, edge>(), phase being the index in
// profiling.PHASES. It reads and writes nothing: its cost is one launch on
// the stream, and with the switch anywhere else no mark is launched.

#include <cuda_runtime.h>

#include <utility>

namespace {

// Phases a mark can name; profiling.PHASES may list at most this many.
constexpr int kMaxPhases = 64;

}  // namespace

template <int PHASE, int EDGE>
__global__ void nbody_phase_mark() {}

namespace {

// The host stubs of every mark, entries then exits, by phase.
template <int... P>
const void* const* mark_table(std::integer_sequence<int, P...>) {
  static const void* const table[] = {
      reinterpret_cast<const void*>(&nbody_phase_mark<P, 0>)...,
      reinterpret_cast<const void*>(&nbody_phase_mark<P, 1>)...};
  return table;
}

const void* const* marks() {
  return mark_table(std::make_integer_sequence<int, kMaxPhases>{});
}

}  // namespace

// Loads the marks of the first `phases` phases into the current context
// and launches nothing: with lazy module loading a mark first launched
// inside a graph capture would load there. Returns cudaErrorInvalidValue
// when `phases` is outside 0..kMaxPhases, else the first loading error.
extern "C" int nbt_phase_mark_load(int phases) {
  if (phases < 0 || phases > kMaxPhases) return cudaErrorInvalidValue;
  for (int edge = 0; edge < 2; ++edge) {
    for (int p = 0; p < phases; ++p) {
      cudaFuncAttributes attr;
      cudaError_t err =
          cudaFuncGetAttributes(&attr, marks()[edge * kMaxPhases + p]);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

// One mark of `phase` (0 ≤ phase < kMaxPhases) at `edge` (0 entry, 1 exit)
// on `stream`.
extern "C" int nbt_phase_mark(int phase, int edge, cudaStream_t stream) {
  if (phase < 0 || phase >= kMaxPhases || (edge != 0 && edge != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaLaunchKernel(marks()[edge * kMaxPhases + phase],
                                     dim3(1), dim3(1), nullptr, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
