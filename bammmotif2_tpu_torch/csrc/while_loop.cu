// The EM convergence loop's stop test, and the CUDA graph WHILE node that
// runs a captured iteration until it fails.
//
// Replaces the device side of the reference's jax.lax.while_loop
// (bammmotif2_tpu/refinement/multi.py::batched_while_loop, its `cond`):
//
//   running = max(its) < cap  &&  max(vds) >= eps
//
// tested on the device after every iteration, so a loop runs to its end
// with no host read.  The plain version is ops/cuda_while.py::condition_ref
// (refinement/multi.py::_running).
//
// Contract:
//   its     int32 [M]   iterations each seed has taken
//   vds     f32   [M]   each seed's effective v_diff (NaN compares false)
//   cap     int32 []    the iteration cap
//   eps     f32   []    epsilon
// output:
//   running u8    []    the condition (a torch.bool tensor)
//
// What bounds it: nothing on this card; it reads 8 M + 8 bytes and writes
// one.  It is one block, and its cost is the launch of a graph node (a few
// µs), once an iteration beside an E+M pass of milliseconds.
//
// The loop graph (while_graph_build): a parent graph holding
//   start: loop_start_kernel, which sets the conditional handle from the
//          current `running` (a loop that is already stopped runs its body
//          zero times; a cached graph launched with new state restarts from
//          the state's `running`),
//   a cudaGraphCondTypeWhile node after it, whose body graph holds the
//          captured iteration as a child-graph node followed by
//          loop_condition_kernel, which writes `running`, sets the handle
//          and counts the iteration into `count` (never reset: the host
//          reads the sum when it settles its launch counters).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool test(const int* __restrict__ its, const float* __restrict__ vds,
                                     const int* __restrict__ cap, const float* __restrict__ eps,
                                     int M) {
  __shared__ int s_its[kThreads / 32];
  __shared__ float s_vds[kThreads / 32];
  __shared__ int s_nan[kThreads / 32];
  int mi = INT_MIN;
  float mv = -INFINITY;
  int nan = 0;
  for (int i = threadIdx.x; i < M; i += kThreads) {
    mi = max(mi, its[i]);
    const float v = vds[i];
    nan |= isnan(v);
    mv = fmaxf(mv, v);  // fmaxf drops NaN: `nan` keeps it
  }
  for (int o = 16; o > 0; o >>= 1) {
    mi = max(mi, __shfl_xor_sync(0xffffffffu, mi, o));
    mv = fmaxf(mv, __shfl_xor_sync(0xffffffffu, mv, o));
    nan |= __shfl_xor_sync(0xffffffffu, nan, o);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    s_its[warp] = mi;
    s_vds[warp] = mv;
    s_nan[warp] = nan;
  }
  __syncthreads();
  for (int w = 0; w < kThreads / 32; ++w) {
    mi = max(mi, s_its[w]);
    mv = fmaxf(mv, s_vds[w]);
    nan |= s_nan[w];
  }
  // max(vds) is NaN where any vds is; NaN >= eps and v >= NaN are false
  return mi < *cap && !nan && mv >= *eps;
}

__global__ void __launch_bounds__(kThreads)
loop_condition_kernel(const int* __restrict__ its, const float* __restrict__ vds,
                      const int* __restrict__ cap, const float* __restrict__ eps,
                      unsigned char* __restrict__ running, unsigned long long* __restrict__ count,
                      int M, cudaGraphConditionalHandle handle, int set) {
  const bool r = test(its, vds, cap, eps, M);
  if (threadIdx.x == 0) {
    *running = r;
    if (set) {
      *count += 1;
      cudaGraphSetConditional(handle, r);
    }
  }
}

__global__ void loop_start_kernel(const unsigned char* __restrict__ running,
                                  cudaGraphConditionalHandle handle) {
  cudaGraphSetConditional(handle, *running);
}

cudaError_t add_kernel_node(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                            size_t n_dep, void* func, int threads, void** args) {
  cudaKernelNodeParams p = {};
  p.func = func;
  p.gridDim = dim3(1);
  p.blockDim = dim3(threads);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, dep, n_dep, &p);
}

}  // namespace

extern "C" {

// The CUDA driver's version (cudaDriverGetVersion), e.g. 12040 for 12.4.
// WHILE nodes need 12030 or later; cudaGraphSetConditional on the device
// needs sm_90.
int while_driver_version(int* out) { return (int)cudaDriverGetVersion(out); }

// The runtime this library was built against (CUDART_VERSION).
int while_runtime_version() { return CUDART_VERSION; }

// Writes `running` from (its, vds, cap, eps) on `stream`, outside any loop
// graph: the warm-up iteration's test and the kernel's checks.
// Returns a cudaError_t (0 = success) from the launch check.
int loop_condition_launch(const int* its, const float* vds, const int* cap, const float* eps,
                          unsigned char* running, int M, void* stream) {
  loop_condition_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      its, vds, cap, eps, running, nullptr, M, 0, 0);
  return (int)cudaGetLastError();
}

// The types (cudaGraphNodeType) of graph's first `cap` nodes into `types`;
// *n = the node count.  Returns a cudaError_t.
int while_graph_node_types(void* graph, int* types, int cap, int* n) {
  size_t count = 0;
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &count);
  if (err != cudaSuccess) return (int)err;
  *n = (int)count;
  if (count == 0 || cap <= 0) return 0;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[count];
  err = cudaGraphGetNodes(g, nodes, &count);
  for (size_t i = 0; err == cudaSuccess && i < count && (int)i < cap; ++i) {
    cudaGraphNodeType t;
    err = cudaGraphNodeGetType(nodes[i], &t);
    types[i] = (int)t;
  }
  delete[] nodes;
  return (int)err;
}

// Builds and instantiates the loop graph around `body` (a captured
// iteration's cudaGraph_t, which the graph copies as a child graph):
// *exec_out and *graph_out receive the executable and parent graphs, which
// while_graph_destroy frees.  The pointers stay baked into the graph: they
// are the loop's static buffers.  `stage` receives the step that failed
// (1 parent graph, 2 handle, 3 start node, 4 while node, 5 child graph,
// 6 condition node, 7 instantiate).  Returns a cudaError_t.
int while_graph_build(void* body, const int* its, const float* vds, const int* cap,
                      const float* eps, unsigned char* running, unsigned long long* count, int M,
                      void** exec_out, void** graph_out, int* stage) {
  cudaGraph_t parent = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphConditionalHandle handle = 0;
  cudaGraphNode_t start, loop, child, cond;
  int set = 1;
  void* start_args[] = {&running, &handle};
  void* cond_args[] = {&its, &vds, &cap, &eps, &running, &count, &M, &handle, &set};
  cudaGraphNodeParams params = {};
  cudaGraph_t loop_body;
  cudaError_t err;

  *stage = 1;
  if ((err = cudaGraphCreate(&parent, 0)) != cudaSuccess) return (int)err;
  *stage = 2;
  if ((err = cudaGraphConditionalHandleCreate(&handle, parent, 0, 0)) != cudaSuccess) goto fail;
  *stage = 3;
  if ((err = add_kernel_node(&start, parent, nullptr, 0, (void*)loop_start_kernel, 1,
                             start_args)) != cudaSuccess)
    goto fail;
  *stage = 4;
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&loop, parent, &start, nullptr, 1, &params);
#else
  err = cudaGraphAddNode(&loop, parent, &start, 1, &params);
#endif
  if (err != cudaSuccess) goto fail;
  loop_body = params.conditional.phGraph_out[0];
  *stage = 5;
  if ((err = cudaGraphAddChildGraphNode(&child, loop_body, nullptr, 0,
                                        static_cast<cudaGraph_t>(body))) != cudaSuccess)
    goto fail;
  *stage = 6;
  if ((err = add_kernel_node(&cond, loop_body, &child, 1, (void*)loop_condition_kernel, kThreads,
                             cond_args)) != cudaSuccess)
    goto fail;
  *stage = 7;
  if ((err = cudaGraphInstantiate(&exec, parent, 0)) != cudaSuccess) goto fail;
  *stage = 0;
  *exec_out = exec;
  *graph_out = parent;
  return 0;
fail:
  cudaGraphDestroy(parent);
  return (int)err;
}

// Launches the loop graph on `stream`.  Returns a cudaError_t.
int while_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                              static_cast<cudaStream_t>(stream));
}

// Frees what while_graph_build made (an executable graph in flight is
// freed when it completes).  Returns a cudaError_t.
int while_graph_destroy(void* exec, void* graph) {
  cudaError_t a = exec ? cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)) : cudaSuccess;
  cudaError_t b = graph ? cudaGraphDestroy(static_cast<cudaGraph_t>(graph)) : cudaSuccess;
  return (int)(a != cudaSuccess ? a : b);
}

const char* while_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
