// The thread-block-cluster operations that csrc/kkt_solve_cluster.cu uses
// (sm_90): the block's rank in its cluster, a barrier over every thread of
// the cluster (release before it, acquire after it: what a block wrote to
// its shared memory or to global memory before the barrier, every block of
// the cluster reads after it), and the address of a variable of the same
// name in a peer block's shared memory (distributed shared memory).
//
// On the card these are cooperative_groups::this_cluster()'s; under
// QPDO_CUDA_STUB (tests/torch_cuda_stub) the stand-in runtime runs the
// blocks of a cluster at once on std::threads and gives their forms.

#pragma once

#ifdef QPDO_CUDA_STUB

__device__ __forceinline__ unsigned cluster_rank() { return cuda_stub::cluster_rank(); }

__device__ __forceinline__ void cluster_sync() { cuda_stub::cluster_barrier(); }

template <typename T>
__device__ __forceinline__ T* cluster_map(T* local, unsigned rank) {
  return static_cast<T*>(cuda_stub::map_shared_rank(
      const_cast<void*>(static_cast<const void*>(local)), rank));
}

#else

#include <cooperative_groups.h>

__device__ __forceinline__ unsigned cluster_rank() {
  return cooperative_groups::this_cluster().block_rank();
}

__device__ __forceinline__ void cluster_sync() {
  cooperative_groups::this_cluster().sync();
}

template <typename T>
__device__ __forceinline__ T* cluster_map(T* local, unsigned rank) {
  return cooperative_groups::this_cluster().map_shared_rank(local, rank);
}

#endif
