// The conditional node around a captured Harmony iteration: the port's
// counterpart of the lax.while_loop in harmony_tpu/engine.py:709-767
// (run_rounds). Replaces no TPU kernel: the loop there is XLA control flow.
//
// PyTorch (torch.cuda.CUDAGraph with keep_graph=True) captures one
// iteration's launches into a graph; graph_wrap_if then rebuilds that graph
// in place as
//
//     set_if_kernel  ->  IF (handle) { child graph: the captured iteration }
//
// so that PyTorch instantiates and replays the wrapped graph, keeping its
// memory pool and the registered generators' offsets. set_if_kernel reads
// the loop's control words from device memory at every replay: ctl[0] the
// iterations run so far, ctl[1] the budget n_max, ctl[2] the convergence
// flag. The body runs exactly when ctl[2] == 0 && ctl[0] < ctl[1] (the
// while_loop's predicate ~converged & (i < n_max)); otherwise the replay
// launches nothing but this one-thread kernel. The captured iteration
// advances ctl[0] and writes ctl[2] itself.
//
// Conditional nodes need CUDA 12.4 or later (IF nodes with child graphs in
// their bodies). The kernel is one thread: bound by launch latency, about
// a microsecond a replay.

#include <cuda_runtime.h>

#include <vector>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const long long* ctl) {
  const bool run = ctl[2] == 0 && ctl[0] < ctl[1];
  cudaGraphSetConditional(handle, run ? 1u : 0u);
}

}  // namespace

extern "C" {

// Rebuild the captured graph `graph` (a cudaGraph_t that has not been
// instantiated) as set_if_kernel -> IF { child: the captured nodes },
// reading the control words `ctl` (3 int64 on the device). Returns 0 or a
// CUDA error.
int graph_wrap_if(void* graph, const void* ctl) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraph_t body = nullptr;
  cudaError_t err = cudaGraphClone(&body, g);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t n = 0;
  err = cudaGraphGetNodes(g, nullptr, &n);
  std::vector<cudaGraphNode_t> nodes(n);
  if (err == cudaSuccess && n) err = cudaGraphGetNodes(g, nodes.data(), &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) err = cudaGraphDestroyNode(nodes[i]);
  cudaGraphConditionalHandle handle;
  if (err == cudaSuccess)
    err = cudaGraphConditionalHandleCreate(&handle, g, 0, cudaGraphCondAssignDefault);
  cudaGraphNode_t set_node = nullptr, if_node = nullptr, child = nullptr;
  if (err == cudaSuccess) {
    const long long* ctl_p = static_cast<const long long*>(ctl);
    void* args[] = {&handle, &ctl_p};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(set_if_kernel);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.sharedMemBytes = 0;
    kp.kernelParams = args;
    err = cudaGraphAddKernelNode(&set_node, g, nullptr, 0, &kp);
  }
  cudaGraphNodeParams cp = {};
  if (err == cudaSuccess) {
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
#if CUDART_VERSION >= 13000
    err = cudaGraphAddNode(&if_node, g, &set_node, nullptr, 1, &cp);
#else
    err = cudaGraphAddNode(&if_node, g, &set_node, 1, &cp);
#endif
  }
  if (err == cudaSuccess)
    err = cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0], nullptr, 0, body);
  cudaGraphDestroy(body);  // the child node holds its own copy
  return static_cast<int>(err);
}

// The CUDA runtime's version, for the wrapper's check (12040: 12.4).
int graph_runtime_version() {
  int v = 0;
  cudaRuntimeGetVersion(&v);
  return v;
}

}  // extern "C"
