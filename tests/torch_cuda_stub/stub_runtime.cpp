// The runtime behind the stand-in cuda_runtime.h: runs the threads of one
// block as std::threads, block after block, or the threads of every block
// of one cluster at once, cluster after cluster.

#include <cuda_runtime.h>

#include <barrier>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>

thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace cuda_stub {
namespace {

struct Block {
  explicit Block(int threads, size_t bytes) : all(threads), slots(threads + 32) {
    for (int first = 0; first < threads; first += 32)
      warps.push_back(std::make_unique<std::barrier<>>(
          threads - first < 32 ? threads - first : 32));
    // 16-byte aligned, filled with 0xFF: NaN where a kernel reads a float
    // it never wrote
    shared = static_cast<unsigned char*>(std::aligned_alloc(16, (bytes + 31) / 16 * 16));
    std::memset(shared, 0xFF, (bytes + 31) / 16 * 16);
  }
  ~Block() { std::free(shared); }
  std::barrier<> all;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<uint64_t> slots;
  unsigned char* shared;
};

struct Cluster {
  Cluster(unsigned blocks, int threads) : all(static_cast<int>(blocks) * threads) {}
  std::barrier<> all;
  std::vector<std::unique_ptr<Block>> blocks;
};

thread_local Block* current = nullptr;
thread_local Cluster* current_cluster = nullptr;
thread_local unsigned current_rank = 0;
thread_local int linear_tid = 0;

}  // namespace

void launch(dim3 grid, dim3 block, size_t shared_bytes,
            const std::function<void()>& body) {
  const int threads = static_cast<int>(block.x * block.y * block.z);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        Block state(threads, shared_bytes);
        std::vector<std::thread> pool;
        pool.reserve(threads);
        for (int t = 0; t < threads; ++t)
          pool.emplace_back([&, t] {
            current = &state;
            linear_tid = t;
            threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                             t / (block.x * block.y));
            blockIdx = dim3(bx, by, bz);
            blockDim = block;
            gridDim = grid;
            body();
          });
        for (auto& th : pool) th.join();
      }
}

void launch_clusters(dim3 grid, dim3 block, size_t shared_bytes,
                     unsigned cluster, const std::function<void()>& body) {
  const int threads = static_cast<int>(block.x * block.y * block.z);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned c0 = 0; c0 < grid.x; c0 += cluster) {
        Cluster state(cluster, threads);
        for (unsigned r = 0; r < cluster; ++r)
          state.blocks.push_back(std::make_unique<Block>(threads, shared_bytes));
        std::vector<std::thread> pool;
        pool.reserve(static_cast<size_t>(cluster) * threads);
        for (unsigned r = 0; r < cluster; ++r)
          for (int t = 0; t < threads; ++t)
            pool.emplace_back([&, r, t] {
              current = state.blocks[r].get();
              current_cluster = &state;
              current_rank = r;
              linear_tid = t;
              threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                               t / (block.x * block.y));
              blockIdx = dim3(c0 + r, by, bz);
              blockDim = block;
              gridDim = grid;
              body();
            });
        for (auto& th : pool) th.join();
      }
}

unsigned cluster_rank() { return current_cluster ? current_rank : 0; }
void cluster_barrier() {
  if (current_cluster) current_cluster->all.arrive_and_wait();
  else block_barrier();
}
void* map_shared_rank(void* local, unsigned rank) {
  const std::ptrdiff_t offset = static_cast<unsigned char*>(local) - current->shared;
  if (!current_cluster) return local;
  return current_cluster->blocks[rank]->shared + offset;
}

unsigned char* shared_memory() { return current->shared; }
void block_barrier() { current->all.arrive_and_wait(); }
void warp_barrier() { current->warps[linear_tid / 32]->arrive_and_wait(); }
uint64_t* warp_slots() { return current->slots.data() + linear_tid / 32 * 32; }
int lane() { return linear_tid % 32; }

}  // namespace cuda_stub
