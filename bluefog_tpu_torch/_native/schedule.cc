// Native schedule compiler: edge -> ppermute-round partitioning.
//
// C++ implementation of the greedy partial-permutation edge coloring in
// bluefog_tpu_torch/schedule.py (color_edges).  The Python version is O(E * R)
// with Python-object overhead per probe; for large dense topologies
// (FullyConnectedGraph at pod scale: size 4096 -> ~16.7M edges) compiling
// the schedule dominates init time.  This kernel does the identical
// algorithm on flat int arrays — same output, orders of magnitude faster —
// and plays the architectural role of the reference's graph-communicator
// construction (MPI_Dist_graph_create_adjacent, mpi_context.cc:412-430).
//
// Contract (must match color_edges exactly): edges are processed in
// ascending ((dst - src) mod size, src) order; each edge takes the smallest
// round where its source is not yet sending and its destination not yet
// receiving.  Output is the round index per input edge.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// srcs/dsts: n_edges entries each (deduplicated by the caller).
// out_rounds: n_edges entries, filled with the round id per edge.
// Returns the number of rounds, or -1 on invalid input.
int32_t bft_color_edges(const int32_t* srcs, const int32_t* dsts,
                        int64_t n_edges, int32_t size, int32_t* out_rounds) {
  if (size <= 0 || n_edges < 0) return -1;
  for (int64_t i = 0; i < n_edges; ++i) {
    if (srcs[i] == dsts[i]) return -1;  // self-loops go via self_weight
    if (srcs[i] < 0 || srcs[i] >= size || dsts[i] < 0 || dsts[i] >= size)
      return -1;
  }

  std::vector<int64_t> order(n_edges);
  for (int64_t i = 0; i < n_edges; ++i) order[i] = i;
  auto key = [&](int64_t i) {
    int32_t off = (dsts[i] - srcs[i]) % size;
    if (off < 0) off += size;
    return std::pair<int32_t, int32_t>(off, srcs[i]);
  };
  std::sort(order.begin(), order.end(),
            [&](int64_t a, int64_t b) { return key(a) < key(b); });

  // senders[r*size + v] == 1 iff v already sends in round r (same for recv)
  std::vector<uint8_t> senders;
  std::vector<uint8_t> receivers;
  int32_t n_rounds = 0;

  for (int64_t oi = 0; oi < n_edges; ++oi) {
    int64_t i = order[oi];
    int32_t src = srcs[i], dst = dsts[i];
    int32_t r = 0;
    for (; r < n_rounds; ++r) {
      if (!senders[static_cast<size_t>(r) * size + src] &&
          !receivers[static_cast<size_t>(r) * size + dst])
        break;
    }
    if (r == n_rounds) {
      ++n_rounds;
      senders.resize(static_cast<size_t>(n_rounds) * size, 0);
      receivers.resize(static_cast<size_t>(n_rounds) * size, 0);
    }
    senders[static_cast<size_t>(r) * size + src] = 1;
    receivers[static_cast<size_t>(r) * size + dst] = 1;
    out_rounds[i] = r;
  }
  return n_rounds;
}

}  // extern "C"
