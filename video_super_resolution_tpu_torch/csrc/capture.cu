// Stream-capture probe for the per-range CUDA graphs of the model's forward
// (models/graphs.py): how many nodes the graph that a stream is capturing
// holds so far, so that a stretch of the forward between two range
// boundaries that issued no device work ends no graph of its own.

#include <cuda_runtime.h>

// *count = nodes captured so far into the graph `stream` is capturing, 0
// when it captures nothing. Returns a CUDA error code (0 on success).
extern "C" int vsr_captured_nodes(cudaStream_t stream,
                                  unsigned long long* count) {
  *count = 0;
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph,
                                             nullptr, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive || graph == nullptr) return 0;
  size_t nodes = 0;
  err = cudaGraphGetNodes(graph, nullptr, &nodes);
  *count = nodes;
  return static_cast<int>(err);
}
