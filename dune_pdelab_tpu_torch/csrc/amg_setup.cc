// Greedy (Vanek) aggregation over a CSR strength graph, for the host setup
// of dune_pdelab_tpu_torch/linalg/amg.py (a copy of the JAX package's
// linalg/native/amg_setup.cc, kept here so the port builds from its own
// sources; compiled with g++ into build/torch_kernels/ at first use).
//
// The 3-pass algorithm of linalg/amg.py::_aggregate: pass 1 seeds an
// aggregate from every node whose strong neighbourhood is untouched
// (isolated non-decoupled nodes become singletons), pass 2 attaches
// leftovers to the first aggregated strong neighbour, pass 3 makes the
// remaining nodes singletons. Structurally decoupled rows (Dirichlet
// identity rows) stay excluded (-2). Same sequential order as the Python
// loop, at C speed (the Python loop takes minutes at 1M+ rows).
#include <cstdint>

extern "C" int64_t amg_aggregate(int64_t n, const int64_t* indptr,
                                 const int64_t* indices,
                                 const uint8_t* decoupled, int64_t* agg) {
  for (int64_t i = 0; i < n; ++i) agg[i] = decoupled[i] ? -2 : -1;
  int64_t n_agg = 0;
  // pass 1: seed aggregates
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    const int64_t b = indptr[i], e = indptr[i + 1];
    if (e == b) {                 // isolated non-decoupled: singleton seed
      agg[i] = n_agg++;
      continue;
    }
    bool clean = true;
    for (int64_t k = b; k < e; ++k)
      if (agg[indices[k]] != -1) { clean = false; break; }
    if (!clean) continue;
    agg[i] = n_agg;
    for (int64_t k = b; k < e; ++k) agg[indices[k]] = n_agg;
    ++n_agg;
  }
  // pass 2: attach leftovers to the first aggregated strong neighbour
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int64_t a = agg[indices[k]];
      if (a >= 0) { agg[i] = a; break; }
    }
  }
  // pass 3: remaining nodes become singletons
  for (int64_t i = 0; i < n; ++i)
    if (agg[i] == -1) agg[i] = n_agg++;
  return n_agg;
}
