// The conditional nodes around a captured Harmony iteration: the port's
// counterpart of the lax.while_loop in harmony_tpu/engine.py:709-767
// (run_rounds), and of the lax.cond and the clustering while_loop inside
// its body (harmony_tpu/engine.py:210-218, 548-595). Replaces no TPU
// kernel: the loop and the branches there are XLA control flow.
//
// PyTorch (torch.cuda.CUDAGraph with keep_graph=True) captures one
// iteration's launches into a graph. Guarded regions of the iteration
// (a stretch of launches that runs only while a device flag is nonzero)
// are marked while it is captured by two 4-byte memsets on the region's
// own marker words, one where the region starts and one where it ends
// (graph_mark). graph_wrap_regions then rebuilds that graph in place as a
// flat chain
//
//     set(loop) -> IF { segment 0 } -> set(loop && flag_1) -> IF { region 1 }
//       -> set(loop) -> IF { segment 2 } -> ... -> IF { last segment }
//
// where segment s holds the captured nodes with s markers upstream of
// them, each in a child graph that keeps their edges; nothing is nested.
// PyTorch instantiates and replays the rebuilt graph, keeping its memory
// pool and the registered generators' offsets. Each set kernel reads the
// loop's control words from device memory at every replay: ctl[0] the
// iterations run so far, ctl[1] the budget n_max, ctl[2] the convergence
// flag; the body runs exactly when ctl[2] == 0 && ctl[0] < ctl[1] (the
// while_loop's predicate ~converged & (i < n_max)), a guarded region only
// when its flag (one int32 on the device) is nonzero too. A replay after
// convergence launches nothing but the set kernels. The captured
// iteration advances ctl[0] and writes ctl[2] itself, in its last
// segment, after every set kernel of the replay has read them. A region's
// flag is read where its first marker was captured, so a flag written by
// an earlier launch of the iteration is seen.
//
// Conditional nodes need CUDA 12.4 or later (IF nodes with child graphs in
// their bodies). The set kernels are one thread each: bound by launch
// latency, about a microsecond each a replay.
//
// graph_stamp launches stamp_kernel, one thread that writes the global
// timer (%globaltimer, nanoseconds) into a slot of an int64 buffer: the
// device-clock ends of the program's timed spans (runtime.PhaseTimers), and
// inside the captured iteration three stamps an iteration in slots picked
// by the iteration counter ctl[0] as the stamp runs.

#include <cuda_runtime.h>

#include <unordered_map>
#include <vector>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const long long* ctl,
                              const int* flag) {
  const bool run = ctl[2] == 0 && ctl[0] < ctl[1] && (flag == nullptr || *flag != 0);
  cudaGraphSetConditional(handle, run ? 1u : 0u);
}

// buf[offset + stride * index[0]] (index null: buf[offset]) = the global timer
__global__ void stamp_kernel(long long* buf, const long long* index, long long stride,
                             long long offset) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  buf[offset + (index == nullptr ? 0 : stride * index[0])] = static_cast<long long>(t);
}

constexpr int kBadMarkers = -1;  // the markers do not form begin/end pairs in order
constexpr int kMarkByte = 0xA5;  // the value a marker memset writes

cudaError_t add_dep_node(cudaGraphNode_t* node, cudaGraph_t g, cudaGraphNode_t dep,
                         cudaGraphNodeParams* p) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, g, &dep, nullptr, 1, p);
#else
  return cudaGraphAddNode(node, g, &dep, 1, p);
#endif
}

}  // namespace

extern "C" {

// A region marker: a 4-byte memset of kMarkByte on `word` (the region's own
// marker word, start or end, made before the capture and outside the
// graph's memory pool) on `stream`, captured as a memset node that
// graph_wrap_regions finds by its destination and value and removes.
int graph_mark(void* word, void* stream) {
  return static_cast<int>(
      cudaMemsetAsync(word, kMarkByte, 4, static_cast<cudaStream_t>(stream)));
}

// Rebuild the captured graph `graph` (a cudaGraph_t that has not been
// instantiated) as the flat chain above, reading the control words `ctl`
// (3 int64 on the device). Region r (0 <= r < n_regions) was captured
// between the markers on starts[r] and ends[r], in that order, and runs
// where flags[r] (an int32 on the device) is nonzero. Returns 0, a CUDA
// error, or kBadMarkers.
int graph_wrap_regions(void* graph, const void* ctl, int n_regions, void* const* starts,
                       void* const* ends, void* const* flags) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  std::vector<cudaGraphNode_t> nodes(n);
  if (err == cudaSuccess && n) err = cudaGraphGetNodes(g, nodes.data(), &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::unordered_map<cudaGraphNode_t, size_t> index;
  for (size_t i = 0; i < n; ++i) index[nodes[i]] = i;
  // marker[i]: the place of node i in the marker sequence (2r: region r's
  // start, 2r + 1: its end), or -1
  std::unordered_map<const void*, int> words;
  for (int r = 0; r < n_regions; ++r) {
    words[starts[r]] = 2 * r;
    words[ends[r]] = 2 * r + 1;
  }
  std::vector<int> marker(n, -1);
  int n_marks = 0;
  for (size_t i = 0; i < n && err == cudaSuccess; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess || type != cudaGraphNodeTypeMemset) continue;
    cudaMemsetParams mp;
    err = cudaGraphMemsetNodeGetParams(nodes[i], &mp);
    auto it = words.find(mp.dst);
    if (err == cudaSuccess && it != words.end() && mp.value == kMarkByte &&
        mp.elementSize == 1 && mp.width == 4) {
      marker[i] = it->second;
      ++n_marks;
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_marks != 2 * n_regions) return kBadMarkers;
  // the edges, then each node's segment in topological order: the most
  // markers on a path into it
  size_t ne = 0;
#if CUDART_VERSION >= 13000
  err = cudaGraphGetEdges(g, nullptr, nullptr, nullptr, &ne);
#else
  err = cudaGraphGetEdges(g, nullptr, nullptr, &ne);
#endif
  std::vector<cudaGraphNode_t> from(ne), to(ne);
  if (err == cudaSuccess && ne) {
#if CUDART_VERSION >= 13000
    err = cudaGraphGetEdges(g, from.data(), to.data(), nullptr, &ne);
#else
    err = cudaGraphGetEdges(g, from.data(), to.data(), &ne);
#endif
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  std::vector<std::vector<size_t>> out(n);
  std::vector<int> indeg(n, 0), seg(n, 0);
  for (size_t e = 0; e < ne; ++e) {
    const size_t a = index[from[e]], b = index[to[e]];
    out[a].push_back(b);
    ++indeg[b];
  }
  std::vector<size_t> order;
  for (size_t i = 0; i < n; ++i)
    if (indeg[i] == 0) order.push_back(i);
  for (size_t q = 0; q < order.size(); ++q) {
    const size_t a = order[q];
    const int past = seg[a] + (marker[a] >= 0 ? 1 : 0);
    for (size_t b : out[a]) {
      if (past > seg[b]) seg[b] = past;
      if (--indeg[b] == 0) order.push_back(b);
    }
  }
  if (order.size() != n) return kBadMarkers;
  // the markers form one chain in capture order: marker m has m upstream
  for (size_t i = 0; i < n; ++i)
    if (marker[i] >= 0 && seg[i] != marker[i]) return kBadMarkers;
  // each segment's nodes as a child graph: a clone less every other node
  const int n_seg = 2 * n_regions + 1;
  std::vector<int> count(n_seg, 0);
  for (size_t i = 0; i < n; ++i)
    if (marker[i] < 0) ++count[seg[i]];
  std::vector<cudaGraph_t> bodies(n_seg, nullptr);
  for (int s = 0; s < n_seg && err == cudaSuccess; ++s) {
    if (!count[s]) continue;
    err = cudaGraphClone(&bodies[s], g);
    for (size_t i = 0; i < n && err == cudaSuccess; ++i) {
      if (marker[i] < 0 && seg[i] == s) continue;
      cudaGraphNode_t c = nullptr;
      err = cudaGraphNodeFindInClone(&c, nodes[i], bodies[s]);
      if (err == cudaSuccess) err = cudaGraphDestroyNode(c);
    }
  }
  for (size_t i = 0; i < n && err == cudaSuccess; ++i) err = cudaGraphDestroyNode(nodes[i]);
  // the chain: for each segment with nodes, its set kernel and IF node
  cudaGraphNode_t prev = nullptr;
  const long long* ctl_p = static_cast<const long long*>(ctl);
  for (int s = 0; s < n_seg && err == cudaSuccess; ++s) {
    if (!bodies[s]) continue;
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, g, 0, cudaGraphCondAssignDefault);
    const int* flag_p = s % 2 ? static_cast<const int*>(flags[s / 2]) : nullptr;
    cudaGraphNode_t set_node = nullptr, if_node = nullptr, child = nullptr;
    if (err == cudaSuccess) {
      void* args[] = {&handle, &ctl_p, &flag_p};
      cudaKernelNodeParams kp = {};
      kp.func = reinterpret_cast<void*>(set_if_kernel);
      kp.gridDim = dim3(1);
      kp.blockDim = dim3(1);
      kp.sharedMemBytes = 0;
      kp.kernelParams = args;
      err = cudaGraphAddKernelNode(&set_node, g, prev ? &prev : nullptr, prev ? 1 : 0, &kp);
    }
    cudaGraphNodeParams cp = {};
    if (err == cudaSuccess) {
      cp.type = cudaGraphNodeTypeConditional;
      cp.conditional.handle = handle;
      cp.conditional.type = cudaGraphCondTypeIf;
      cp.conditional.size = 1;
      err = add_dep_node(&if_node, g, set_node, &cp);
    }
    if (err == cudaSuccess)
      err = cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0], nullptr, 0,
                                       bodies[s]);
    prev = if_node;
  }
  for (cudaGraph_t b : bodies)
    if (b) cudaGraphDestroy(b);  // each child node holds its own copy
  return static_cast<int>(err);
}

// One stamp_kernel on `stream`: the global timer into
// buf[offset + stride * index[0]] (`index` may be null: buf[offset]).
int graph_stamp(void* buf, const void* index, long long stride, long long offset,
                void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(buf), static_cast<const long long*>(index), stride, offset);
  return static_cast<int>(cudaGetLastError());
}

// The CUDA runtime's version, for the wrapper's check (12040: 12.4).
int graph_runtime_version() {
  int v = 0;
  cudaRuntimeGetVersion(&v);
  return v;
}

}  // extern "C"
