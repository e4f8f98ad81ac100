// Phase marks of the federated round (fl/telemetry.phase).
//
// One empty kernel per phase of fl/telemetry.PHASES, launched <<<1, 1>>> on
// the caller's stream when the round enters that phase while profiled or
// captured in a CUDA graph.  A mark takes no
// argument and touches no memory: its only effect is a node in the stream,
// so a profiler's device timeline shows, by symbol, where each phase of a
// round begins, also inside a replayed CUDA graph (where every kernel
// carries the graph launch's correlation id and no host range can split
// the replay).  The names are extern "C", so the trace shows them
// unmangled: fl_phase_<name>.  The order of the kernels here is the order
// of PHASES, which phase_mark's `phase` indexes.

#include <cuda_runtime.h>

extern "C" {

__global__ void fl_phase_local_sgd() {}
__global__ void fl_phase_update_rows() {}
__global__ void fl_phase_guides() {}
__global__ void fl_phase_aggregate() {}
__global__ void fl_phase_eval() {}
__global__ void fl_phase_handoff() {}

// Launches the mark of phase index `phase` (0 .. 5, PHASES order) on
// `stream` and returns cudaGetLastError() (0 on success);
// cudaErrorInvalidValue for an index out of range.
int phase_mark(int phase, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case 0: fl_phase_local_sgd<<<1, 1, 0, st>>>(); break;
    case 1: fl_phase_update_rows<<<1, 1, 0, st>>>(); break;
    case 2: fl_phase_guides<<<1, 1, 0, st>>>(); break;
    case 3: fl_phase_aggregate<<<1, 1, 0, st>>>(); break;
    case 4: fl_phase_eval<<<1, 1, 0, st>>>(); break;
    case 5: fl_phase_handoff<<<1, 1, 0, st>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* phase_mark_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
