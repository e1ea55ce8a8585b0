// Native host-side symbolic kernels for parsy_bench_tpu_torch.
//
// These are the irregular pointer-chasing graph algorithms of the inspector
// (elimination tree, postorder, column counts, row-subtree pattern, tree
// passes).  The reference keeps its whole inspector in C++
// (cholesky/Etree.h, common/PostOrder.h, common/ColumnCount.h,
// common/TreeUtils.h); this library is the equivalent fast path.  The NumPy
// implementations in parsy_bench_tpu_torch.symbolic are the specification:
// every function here must match them bit-for-bit.  This file is the port's
// own copy of parsy_bench_tpu/native/src/symbolic.cpp (the reference);
// tests/test_torch_inspector.py holds the two inspectors equal.
//
// Flat C ABI, loaded via ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Elimination tree of an SPD matrix, given row-wise access to the lower
// half (== CSC of the upper half): column i of (indptr, indices) holds the
// entries j <= i of row i.  Liu's algorithm with path compression.
// (spec: parsy_bench_tpu_torch/symbolic/etree.py::etree; reference analogue:
// cholesky/Etree.h:56 etreeC)
void pbt_etree(int64_t n, const int64_t* indptr, const int32_t* indices,
               int32_t* parent) {
  std::vector<int32_t> ancestor(n, -1);
  for (int64_t i = 0; i < n; ++i) parent[i] = -1;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int32_t j = indices[p];
      while (j != -1 && j < i) {
        int32_t nxt = ancestor[j];
        ancestor[j] = (int32_t)i;
        if (nxt == -1) parent[j] = (int32_t)i;
        j = nxt;
      }
    }
  }
}

// Postorder from CSR-style children lists; children/roots already ordered.
// (spec: etree.py::postorder; reference: common/PostOrder.h:11)
void pbt_postorder(int64_t n, const int64_t* childptr, const int32_t* children,
                   const int32_t* roots, int64_t nroots, int32_t* post) {
  std::vector<int64_t> cursor(n);
  std::vector<int32_t> stack(n + 1);
  for (int64_t v = 0; v < n; ++v) cursor[v] = childptr[v];
  int64_t k = 0;
  for (int64_t r = 0; r < nroots; ++r) {
    int64_t top = 0;
    stack[0] = roots[r];
    while (top >= 0) {
      int32_t v = stack[top];
      if (cursor[v] < childptr[v + 1]) {
        stack[++top] = children[cursor[v]++];
      } else {
        post[k++] = v;
        --top;
      }
    }
  }
}

// out[parent[j]] += out[j], ascending j (parent[j] > j invariant).
// (spec: etree.py::subtree_accumulate; reference: common/TreeUtils.h:103)
void pbt_subtree_accumulate(int64_t n, const int32_t* parent, double* out) {
  for (int64_t j = 0; j < n; ++j)
    if (parent[j] >= 0) out[parent[j]] += out[j];
}

// depth[j] = depth[parent[j]] + 1, descending j.
// (spec: etree.py::tree_depths; reference: common/TreeUtils.h:58)
void pbt_tree_depths(int64_t n, const int32_t* parent, int64_t* depth) {
  for (int64_t j = n - 1; j >= 0; --j)
    depth[j] = parent[j] >= 0 ? depth[parent[j]] + 1 : 0;
}

// Wavefront level: lev[p] = max(lev[p], lev[j]+1) ascending j.
// (spec: etree.py::tree_levels; reference level sets: TreeUtils.h:119)
void pbt_tree_wavefront(int64_t n, const int32_t* parent, int64_t* lev) {
  for (int64_t j = 0; j < n; ++j) lev[j] = 0;
  for (int64_t j = 0; j < n; ++j) {
    int32_t p = parent[j];
    if (p >= 0 && lev[j] + 1 > lev[p]) lev[p] = lev[j] + 1;
  }
}

// Column counts of L (diagonal included) by row-subtree marking.
// (spec: colcounts.py::col_counts; reference: common/ColumnCount.h:141)
void pbt_col_counts(int64_t n, const int64_t* indptr, const int32_t* indices,
                    const int32_t* parent, int64_t* cc) {
  std::vector<int64_t> mark(n, -1);
  for (int64_t j = 0; j < n; ++j) cc[j] = 1;
  for (int64_t i = 0; i < n; ++i) {
    mark[i] = i;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int32_t j = indices[p];
      while (j != -1 && mark[j] != i) {
        ++cc[j];
        mark[j] = i;
        j = parent[j];
      }
    }
  }
}

// Row-wise pattern of L (CSR with column indices), diagonal included, by the
// same row-subtree walk.  Two-pass: caller first obtains sizes via
// pbt_col_counts -> sum, then provides rind of that size.  rptr has n+1
// entries.  Row i's entries are emitted in walk order (caller sorts when
// converting to CSC).  (spec: colcounts.py::symbolic_pattern; reference:
// cholesky/Inspection_BlockC.h:684-752 Ls construction)
void pbt_symbolic_pattern(int64_t n, const int64_t* indptr,
                          const int32_t* indices, const int32_t* parent,
                          int64_t* rptr, int32_t* rind) {
  std::vector<int64_t> mark(n, -1);
  int64_t cnt = 0;
  rptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    mark[i] = i;
    rind[cnt++] = (int32_t)i;  // diagonal
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int32_t j = indices[p];
      while (j != -1 && mark[j] != i) {
        rind[cnt++] = j;
        mark[j] = i;
        j = parent[j];
      }
    }
    rptr[i + 1] = cnt;
  }
}

// Longest-path level of each node in the DAG of a lower-triangular pattern
// (edge j -> i for every off-diagonal entry i of column j).  Caller zeroes
// lev.  Used for level-set trisolve scheduling of general (non-chordal) L.
// (reference: triangularSolve/Inspection_Level.h:12 buildLevelSet_CSC)
void pbt_dag_levels(int64_t n, const int64_t* lptr, const int32_t* lind,
                    int64_t* lev) {
  for (int64_t j = 0; j < n; ++j) {
    int64_t lj = lev[j] + 1;
    for (int64_t p = lptr[j]; p < lptr[j + 1]; ++p) {
      int32_t i = lind[p];
      if (i != j && lev[i] < lj) lev[i] = lj;
    }
  }
}

// Left-looking update triples for simplicial Cholesky.  For each source
// column k with off-diagonal rows o_0 < ... < o_{m-1}, and each ordered pair
// (jj <= ii), emit the rank-1 update  L[o_ii, o_jj] -= L[o_ii,k]*L[o_jj,k]:
//   srca = position of (o_ii, k), srcb = position of (o_jj, k),
//   dst  = position of (o_ii, o_jj)  in the L value array.
// Emission is in source-column order; per-column counts are m(m+1)/2 so the
// caller sizes the outputs from column counts and regroups by level.
// dst exists because the factor pattern is closed (Liu).  Binary search
// locates dst inside the target column.
// (spec: symbolic/plan.py::_updates_numpy; reference executor analogue:
// cholesky/sereial_Cholesky_01.h:13 cholesky_left_01's inner loop)
void pbt_cholesky_updates(int64_t n, const int64_t* lptr, const int32_t* lind,
                          int32_t* srca, int32_t* srcb, int32_t* dst) {
  int64_t c = 0;
  for (int64_t k = 0; k < n; ++k) {
    int64_t base = lptr[k];
    int64_t m = lptr[k + 1] - base - 1;  // off-diagonal count
    for (int64_t jj = 0; jj < m; ++jj) {
      int32_t j = lind[base + 1 + jj];  // target column
      const int32_t* cb = lind + lptr[j];
      const int32_t* ce = lind + lptr[j + 1];
      for (int64_t ii = jj; ii < m; ++ii) {
        int32_t i = lind[base + 1 + ii];  // target row
        // lower_bound: pattern closure guarantees presence
        const int32_t* it = cb;
        int64_t len = ce - cb;
        while (len > 1) {
          int64_t half = len / 2;
          if (it[half] <= i) { it += half; len -= half; }
          else len = half;
        }
        srca[c] = (int32_t)(base + 1 + ii);
        srcb[c] = (int32_t)(base + 1 + jj);
        dst[c] = (int32_t)(lptr[j] + (it - (lind + lptr[j])));
        ++c;
      }
    }
  }
}

// Relaxed supernode amalgamation: bottom-up union-find merge of child
// supernodes into parents under the CHOLMOD explicit-zero thresholds.
// Inputs width/nrows/zeros are per-fundamental-supernode state (computed
// vectorized on the Python side); sptr is a scratch copy, mutated exactly
// like the NumPy specification; is_root[s] = 1 iff s survives as a merge
// root.  (spec: symbolic/supernodes.py::relaxed_amalgamation; reference:
// cholesky/Inspection_BlockC.h:370-483, criterion :466-469)
void pbt_relaxed_amalgamation(
    int64_t nsuper, int64_t* sptr, const int32_t* sparent, int64_t* width,
    int64_t* nrows, double* zeros, const int64_t* nrelax,
    const double* zrelax, int64_t max_width, uint8_t* is_root) {
  std::vector<int64_t> merged_into(nsuper);
  for (int64_t s = 0; s < nsuper; ++s) merged_into[s] = s;
  auto find = [&](int64_t s) {
    while (merged_into[s] != s) {
      merged_into[s] = merged_into[merged_into[s]];
      s = merged_into[s];
    }
    return s;
  };
  for (int64_t s = 0; s + 1 < nsuper; ++s) {
    int32_t p = sparent[s];
    if (p < 0) continue;
    int64_t rs = find(s), rp = find(p);
    if (rs == rp) continue;
    if (sptr[rs + 1] != sptr[rp]) continue;  // columns not adjacent
    int64_t w = width[rs] + width[rp];
    if (w > max_width) continue;
    int64_t nr = nrows[rs] > width[rs] + nrows[rp]
                     ? nrows[rs] : width[rs] + nrows[rp];
    double total = (double)nr * (double)w - (double)(w * (w - 1)) / 2.0;
    double filled =
        ((double)nrows[rs] * (double)width[rs]
         - (double)(width[rs] * (width[rs] - 1)) / 2.0 - zeros[rs]) +
        ((double)nrows[rp] * (double)width[rp]
         - (double)(width[rp] * (width[rp] - 1)) / 2.0 - zeros[rp]);
    double z = 1.0 - filled / (total > 1.0 ? total : 1.0);
    bool ok = (w <= nrelax[0]) || (w <= nrelax[1] && z <= zrelax[0]) ||
              (w <= nrelax[2] && z <= zrelax[1]) || (z <= zrelax[2]);
    if (!ok) continue;
    merged_into[rp] = rs;
    int64_t send = sptr[rp + 1];
    width[rs] = w;
    nrows[rs] = nr;
    zeros[rs] = total - filled;
    sptr[rs + 1] = send;
  }
  for (int64_t s = 0; s < nsuper; ++s) is_root[s] = (find(s) == s);
}

// Supernodal row patterns directly from A + etree + supernode partition
// (no simplicial pattern materialization): for every row i, walk each
// below-diagonal entry's column up the elimination tree, emitting row i
// into every supernode encountered (column-stamped so the walk is
// O(nnz(L)) total; supernode-stamped so each (s, i) emits once).  This
// is the reference's row-subtree construction of Ls
// (cholesky/Inspection_BlockC.h:684-752 subtree()) fused with the
// supernode mapping.  Two passes: pass 0 counts into rptr[s+1],
// pass 1 fills rows using rptr as cursors (caller restores rptr).
// (atp, ati) is the row view of lower(A): column i holds entries j <= i
// of row i (the same CSC-of-upper structure pbt_etree consumes.)
void pbt_supernodal_rows(int64_t n, const int64_t* atp, const int32_t* ati,
                         const int32_t* parent, const int32_t* col2sup,
                         int64_t nsuper, int64_t* rptr, int32_t* rows,
                         int64_t pass) {
  std::vector<int32_t> cmark(n, -1), smark(nsuper, -1);
  if (pass == 0)
    for (int64_t s = 0; s <= nsuper; ++s) rptr[s] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t si = col2sup[i];
    smark[si] = (int32_t)i;  // diag: row i belongs to its own supernode
    if (pass == 0) ++rptr[si + 1];
    else rows[rptr[si]++] = (int32_t)i;
    for (int64_t p = atp[i]; p < atp[i + 1]; ++p) {
      int32_t j = ati[p];
      while (j != -1 && j < i && cmark[j] != (int32_t)i) {
        cmark[j] = (int32_t)i;
        int32_t s = col2sup[j];
        if (smark[s] != (int32_t)i) {
          smark[s] = (int32_t)i;
          if (pass == 0) ++rptr[s + 1];
          else rows[rptr[s]++] = (int32_t)i;
        }
        j = parent[j];
      }
    }
  }
  if (pass == 0)
    for (int64_t s = 0; s < nsuper; ++s) rptr[s + 1] += rptr[s];
}

// Coordinate-free nested dissection (George-Liu level-structure bisection)
// — the all-native replacement for the scipy-sliced Python driver
// (spec: symbolic/ordering.py::_graph_nd; reference analogue: the
// METIS_NodeND call, cholesky/LSparsity.h:534-613).  Same algorithm:
// BFS from a pseudo-peripheral root, separator = smallest level whose
// cumulative count lies in the middle band; leaves ordered by local RCM.
// Input: CSR adjacency of the full symmetric pattern (diagonal allowed,
// ignored).  Output perm[new] = old.
namespace {

struct NdScratch {
  std::vector<int32_t> loc;    // global -> local id within current piece
  std::vector<int32_t> lev;    // local BFS level
  std::vector<int32_t> queue;  // BFS queue / scratch
  std::vector<int32_t> deg;    // local degree
};

// BFS levels over the subgraph induced by nodes[0..m); lev filled with
// -1 for unreached.  Returns the index (local) of the last-visited node
// (a farthest node) and the level count via *nlev.
static int32_t nd_bfs(const int64_t* ap, const int32_t* ai,
                      const int32_t* nodes, int64_t m, int32_t root,
                      NdScratch& S, int32_t* nlev) {
  for (int64_t k = 0; k < m; ++k) S.lev[k] = -1;
  S.lev[root] = 0;
  S.queue[0] = root;
  int64_t head = 0, tail = 1;
  int32_t last = root, maxlev = 0;
  while (head < tail) {
    int32_t u = S.queue[head++];
    int32_t g = nodes[u];
    int32_t lu = S.lev[u];
    for (int64_t p = ap[g]; p < ap[g + 1]; ++p) {
      int32_t lv = S.loc[ai[p]];
      if (lv < 0 || S.lev[lv] >= 0) continue;  // outside piece or seen
      S.lev[lv] = lu + 1;
      if (lu + 1 > maxlev) maxlev = lu + 1;
      S.queue[tail++] = lv;
      last = lv;
    }
  }
  *nlev = maxlev + 1;
  return last;
}

// Local reverse Cuthill-McKee of a (connected or not) piece: per
// component, BFS from a far node with neighbours visited in
// ascending-degree order; the concatenated CM order is reversed (scipy
// reverse_cuthill_mckee semantics).  Appends the piece's nodes to out.
// Uses S.lev as a per-node state (0 = unvisited, 2 = seen by the
// far-node pass, 1 = emitted) so components never clobber each other.
static void nd_rcm(const int64_t* ap, const int32_t* ai,
                   const int32_t* nodes, int64_t m, NdScratch& S,
                   std::vector<int32_t>& out) {
  if (m == 1) { out.push_back(nodes[0]); return; }
  for (int64_t k = 0; k < m; ++k) {
    int32_t g = nodes[k];
    int32_t d = 0;
    for (int64_t p = ap[g]; p < ap[g + 1]; ++p)
      if (S.loc[ai[p]] >= 0 && ai[p] != g) ++d;
    S.deg[k] = d;
    S.lev[k] = 0;
  }
  size_t base = out.size();
  for (int64_t k0 = 0; k0 < m; ++k0) {
    if (S.lev[k0] != 0) continue;
    // pass 1: BFS from k0 to find a far node of this component (0 -> 2)
    int64_t head = 0, tail = 0;
    S.queue[tail++] = (int32_t)k0;
    S.lev[k0] = 2;
    int32_t far = (int32_t)k0;
    while (head < tail) {
      int32_t u = S.queue[head++];
      far = u;  // last dequeued lies in the deepest level
      int32_t g = nodes[u];
      for (int64_t p = ap[g]; p < ap[g + 1]; ++p) {
        int32_t lv = S.loc[ai[p]];
        if (lv >= 0 && S.lev[lv] == 0) {
          S.lev[lv] = 2;
          S.queue[tail++] = lv;
        }
      }
    }
    // pass 2: CM from the far node (2 -> 1), neighbours by degree
    head = tail = 0;
    S.queue[tail++] = far;
    S.lev[far] = 1;
    while (head < tail) {
      int32_t u = S.queue[head++];
      out.push_back(nodes[u]);
      int64_t first = tail;
      int32_t g = nodes[u];
      for (int64_t p = ap[g]; p < ap[g + 1]; ++p) {
        int32_t lv = S.loc[ai[p]];
        if (lv >= 0 && S.lev[lv] == 2) {
          S.lev[lv] = 1;
          S.queue[tail++] = lv;
        }
      }
      for (int64_t a = first + 1; a < tail; ++a) {
        int32_t v = S.queue[a];
        int64_t b = a;
        while (b > first && S.deg[S.queue[b - 1]] > S.deg[v]) {
          S.queue[b] = S.queue[b - 1];
          --b;
        }
        S.queue[b] = v;
      }
    }
  }
  // reverse the freshly appended range (Cuthill-McKee -> RCM)
  for (size_t a = base, b = out.size() - 1; a < b; ++a, --b) {
    int32_t t = out[a];
    out[a] = out[b];
    out[b] = t;
  }
}

}  // namespace

void pbt_nd_order(int64_t n, const int64_t* ap, const int32_t* ai,
                  int64_t leaf_size, int32_t* perm) {
  NdScratch S;
  S.loc.assign(n, -1);
  S.lev.resize(n);
  S.queue.resize(n);
  S.deg.resize(n);
  // arena of node lists + an explicit stack of (offset, len, tag) frames;
  // tag 0 = split, 1 = emit (separator, already ordered)
  std::vector<int32_t> arena(n);
  for (int64_t i = 0; i < n; ++i) arena[i] = (int32_t)i;
  struct Frame { int64_t off, len; int tag; };
  std::vector<Frame> stack;
  std::vector<int32_t> out;
  out.reserve(n);
  std::vector<int32_t> scratch;  // relabel buffer
  stack.push_back({0, n, 0});
  while (!stack.empty()) {
    Frame f = stack.back();
    stack.pop_back();
    int32_t* nodes = arena.data() + f.off;
    int64_t m = f.len;
    if (m == 0) continue;
    if (f.tag == 1) {
      for (int64_t k = 0; k < m; ++k) out.push_back(nodes[k]);
      continue;
    }
    // activate piece: local ids + "unemitted" stamps
    for (int64_t k = 0; k < m; ++k) S.loc[nodes[k]] = (int32_t)k;
    if (m <= leaf_size) {
      nd_rcm(ap, ai, nodes, m, S, out);
      for (int64_t k = 0; k < m; ++k) S.loc[nodes[k]] = -1;
      continue;
    }
    int32_t nlev;
    int32_t far = nd_bfs(ap, ai, nodes, m, 0, S, &nlev);
    // disconnected piece: peel reached component, recurse on both
    int64_t reached = 0;
    for (int64_t k = 0; k < m; ++k) reached += (S.lev[k] >= 0);
    if (reached < m) {
      scratch.resize(m);
      int64_t a = 0, b = reached;
      for (int64_t k = 0; k < m; ++k)
        (S.lev[k] >= 0 ? scratch[a++] : scratch[b++]) = nodes[k];
      for (int64_t k = 0; k < m; ++k) {
        S.loc[nodes[k]] = -1;
        nodes[k] = scratch[k];
      }
      stack.push_back({f.off + reached, m - reached, 0});
      stack.push_back({f.off, reached, 0});
      continue;
    }
    nd_bfs(ap, ai, nodes, m, far, S, &nlev);
    if (nlev <= 2) {  // clique-ish: no useful level separator
      nd_rcm(ap, ai, nodes, m, S, out);
      for (int64_t k = 0; k < m; ++k) S.loc[nodes[k]] = -1;
      continue;
    }
    // level sizes and the middle band [searchsorted(.25m), .75m]
    std::vector<int64_t> sizes(nlev, 0);
    for (int64_t k = 0; k < m; ++k) ++sizes[S.lev[k]];
    int64_t lo = 0, hi = 0, cum = 0;
    {
      std::vector<int64_t> cums(nlev);
      for (int32_t l = 0; l < nlev; ++l) { cum += sizes[l]; cums[l] = cum; }
      // np.searchsorted(cum, q) semantics: first index with cum >= q
      double q1 = 0.25 * (double)m, q3 = 0.75 * (double)m;
      while (lo < nlev && (double)cums[lo] < q1) ++lo;
      while (hi < nlev && (double)cums[hi] < q3) ++hi;
      if (lo < 1) lo = 1;
      if (lo > nlev - 2) lo = nlev - 2;
      if (hi < lo) hi = lo;
      if (hi > nlev - 2) hi = nlev - 2;
    }
    int32_t cut = (int32_t)lo;
    for (int64_t l = lo; l <= hi; ++l)
      if (sizes[l] < sizes[cut]) cut = (int32_t)l;
    // partition arena range into left | right | sep (stable)
    scratch.resize(m);
    int64_t nl = 0, nr = 0, ns = 0;
    for (int64_t k = 0; k < m; ++k) nl += (S.lev[k] < cut);
    for (int64_t k = 0; k < m; ++k) nr += (S.lev[k] > cut);
    int64_t a = 0, b = nl, c = nl + nr;
    for (int64_t k = 0; k < m; ++k) {
      if (S.lev[k] < cut) scratch[a++] = nodes[k];
      else if (S.lev[k] > cut) scratch[b++] = nodes[k];
      else scratch[c++] = nodes[k];
    }
    ns = m - nl - nr;
    for (int64_t k = 0; k < m; ++k) {
      S.loc[nodes[k]] = -1;
      nodes[k] = scratch[k];
    }
    // pop order: left, right, then separator emission
    stack.push_back({f.off + nl + nr, ns, 1});
    if (nr) stack.push_back({f.off + nl, nr, 0});
    if (nl) stack.push_back({f.off, nl, 0});
  }
  for (int64_t i = 0; i < n; ++i) perm[i] = out[i];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Approximate minimum degree ordering (AMD, Amestoy–Davis–Duff).
//
// Replaces the SuperLU-MMD-via-numeric-LU stand-in (ordering.py
// _mmd_via_superlu) with a real symbolic AMD; the reference vendors the
// SuiteSparse implementation (cholesky/AMD.h:298 AMD_order) — this is an
// independent quotient-graph implementation of the same algorithm:
// supervariables, element absorption, and the ADD approximate external
// degree  d_i = |A_i| + |Lp \ i| + sum_e |Le \ Lp|.
//
// Input: pattern of the FULL symmetric matrix (CSC indptr/indices; diagonal
// entries ignored).  Output: perm with perm[new] = old.
// ---------------------------------------------------------------------------

#include <algorithm>

namespace {

struct AmdState {
  int64_t n;
  std::vector<std::vector<int32_t>> adjv;  // variable neighbours (vars)
  std::vector<std::vector<int32_t>> adje;  // element neighbours (vars)
  std::vector<std::vector<int32_t>> lvar;  // member vars (elements)
  std::vector<int64_t> nv;       // supervariable size; 0 = dead/element
  std::vector<char> iselem;      // node became an element (pivot)
  std::vector<int64_t> deg;      // approximate external degree
  std::vector<int64_t> w;        // per-element |Le \ Lp| scratch
  std::vector<int64_t> wstamp;   // stamp for w validity
  std::vector<int64_t> mark;     // Lp membership stamp
  std::vector<int32_t> svnext;   // supervariable member chain
  std::vector<int32_t> svtail;
  // degree buckets (doubly linked)
  std::vector<int32_t> bhead, bnext, bprev;
  int64_t mindeg = 0;

  explicit AmdState(int64_t n_)
      : n(n_), adjv(n_), adje(n_), lvar(n_), nv(n_, 1), iselem(n_, 0),
        deg(n_, 0), w(n_, 0), wstamp(n_, -1), mark(n_, -1),
        svnext(n_, -1), svtail(n_), bhead(n_ + 1, -1), bnext(n_, -1),
        bprev(n_, -1) {
    for (int64_t i = 0; i < n_; ++i) svtail[i] = (int32_t)i;
  }

  void bucket_insert(int32_t i, int64_t d) {
    if (d > n) d = n;
    bnext[i] = bhead[d];
    bprev[i] = -1;
    if (bhead[d] != -1) bprev[bhead[d]] = i;
    bhead[d] = i;
    if (d < mindeg) mindeg = d;
  }

  void bucket_remove(int32_t i, int64_t d) {
    if (d > n) d = n;
    if (bprev[i] != -1) bnext[bprev[i]] = bnext[i];
    else bhead[d] = bnext[i];
    if (bnext[i] != -1) bprev[bnext[i]] = bprev[i];
    bnext[i] = bprev[i] = -1;
  }

  bool var_alive(int32_t i) const { return nv[i] > 0 && !iselem[i]; }
  bool elem_alive(int32_t e) const { return iselem[e] && nv[e] == -1; }
};

}  // namespace

extern "C" void pbt_amd_order(int64_t n, const int64_t* ap,
                              const int32_t* ai, int32_t* perm) {
  AmdState st(n);
  // initial adjacency (variables only), degrees = exact external degree
  for (int64_t j = 0; j < n; ++j) {
    auto& l = st.adjv[j];
    l.reserve(ap[j + 1] - ap[j]);
    for (int64_t p = ap[j]; p < ap[j + 1]; ++p)
      if (ai[p] != j) l.push_back(ai[p]);
    std::sort(l.begin(), l.end());
    l.erase(std::unique(l.begin(), l.end()), l.end());
    st.deg[j] = (int64_t)l.size();
  }
  for (int64_t j = 0; j < n; ++j) st.bucket_insert((int32_t)j, st.deg[j]);

  std::vector<int32_t> Lp;
  std::vector<int32_t> touched_elems;
  std::vector<int32_t> hash_bucket_ids;
  std::vector<int64_t> hash_of(n, 0);
  int64_t stamp = 0;
  int64_t k = 0;

  auto elem_size = [&](int32_t e) {
    // live supervariable mass of an element, compacting dead members
    auto& lv = st.lvar[e];
    int64_t sz = 0;
    size_t out = 0;
    for (size_t q = 0; q < lv.size(); ++q) {
      int32_t v = lv[q];
      if (st.var_alive(v)) {
        lv[out++] = v;
        sz += st.nv[v];
      }
    }
    lv.resize(out);
    return sz;
  };

  while (k < n) {
    // ---- pick min-degree supervariable ------------------------------
    while (st.mindeg <= n && st.bhead[st.mindeg] == -1) ++st.mindeg;
    int32_t p = st.bhead[st.mindeg];
    st.bucket_remove(p, st.deg[p]);

    // ---- build Lp = (A_p u union Le) \ dead, p ----------------------
    ++stamp;
    st.mark[p] = stamp;
    Lp.clear();
    for (int32_t j : st.adjv[p])
      if (st.var_alive(j) && st.mark[j] != stamp) {
        st.mark[j] = stamp;
        Lp.push_back(j);
      }
    for (int32_t e : st.adje[p])
      if (st.elem_alive(e)) {
        for (int32_t j : st.lvar[e])
          if (st.var_alive(j) && st.mark[j] != stamp) {
            st.mark[j] = stamp;
            Lp.push_back(j);
          }
        st.nv[e] = 0;  // absorbed into p
        st.lvar[e].clear();
        st.lvar[e].shrink_to_fit();
      }

    // ---- emit p's members, turn p into an element -------------------
    int64_t nvpiv = st.nv[p];
    for (int32_t v = p; v != -1; v = st.svnext[v]) perm[k++] = v;
    st.iselem[p] = 1;
    st.nv[p] = -1;  // element-alive marker
    st.adjv[p].clear();
    st.adjv[p].shrink_to_fit();
    st.adje[p].clear();
    st.adje[p].shrink_to_fit();
    st.lvar[p].assign(Lp.begin(), Lp.end());
    int64_t sizeLp = 0;
    for (int32_t i : Lp) sizeLp += st.nv[i];
    if (Lp.empty()) {
      st.nv[p] = 0;  // fully eliminated element, nothing to scan
      continue;
    }

    // ---- w[e] = |Le \ Lp| for elements adjacent to Lp ---------------
    touched_elems.clear();
    for (int32_t i : Lp)
      for (int32_t e : st.adje[i]) {
        if (!st.elem_alive(e)) continue;
        if (st.wstamp[e] != stamp) {
          st.wstamp[e] = stamp;
          st.w[e] = elem_size(e);
          touched_elems.push_back(e);
        }
        st.w[e] -= st.nv[i];
      }
    // aggressive absorption: Le subset of Lp -> e dies
    for (int32_t e : touched_elems)
      if (st.w[e] == 0) {
        st.nv[e] = 0;
        st.lvar[e].clear();
        st.lvar[e].shrink_to_fit();
      }

    // ---- update every i in Lp ---------------------------------------
    hash_bucket_ids.clear();
    for (int32_t i : Lp) {
      // prune A_i: drop dead vars and vars covered by the new element
      auto& av = st.adjv[i];
      size_t out = 0;
      int64_t dav = 0;
      for (size_t q = 0; q < av.size(); ++q) {
        int32_t j = av[q];
        if (!st.var_alive(j) || st.mark[j] == stamp) continue;
        av[out++] = j;
        dav += st.nv[j];
      }
      av.resize(out);
      // prune E_i, sum w, append p
      auto& ae = st.adje[i];
      out = 0;
      int64_t del = 0;
      for (size_t q = 0; q < ae.size(); ++q) {
        int32_t e = ae[q];
        if (!st.elem_alive(e)) continue;
        ae[out++] = e;
        del += (st.wstamp[e] == stamp ? st.w[e] : elem_size(e));
      }
      ae.resize(out);
      ae.push_back(p);
      // approximate external degree
      int64_t d = dav + (sizeLp - st.nv[i]) + del;
      int64_t cap1 = n - k - st.nv[i];
      int64_t cap2 = st.deg[i] + (sizeLp - st.nv[i]);
      if (d > cap1) d = cap1;
      if (d > cap2) d = cap2;
      if (d < 0) d = 0;
      st.bucket_remove(i, st.deg[i]);
      st.deg[i] = d;
      st.bucket_insert(i, d);
      if (st.mindeg > d) st.mindeg = d;
      // supervariable hash over (A_i, E_i)
      int64_t h = 0;
      for (int32_t j : av) h += j;
      for (int32_t e : ae) h += e;
      hash_of[i] = h;
      hash_bucket_ids.push_back(i);
    }

    // ---- supervariable detection within Lp ---------------------------
    // compare pairs with equal hashes; merge exact matches
    std::sort(hash_bucket_ids.begin(), hash_bucket_ids.end(),
              [&](int32_t a, int32_t b) { return hash_of[a] < hash_of[b]; });
    for (size_t a = 0; a + 1 < hash_bucket_ids.size(); ++a) {
      int32_t i = hash_bucket_ids[a];
      if (!st.var_alive(i)) continue;
      for (size_t b = a + 1; b < hash_bucket_ids.size()
           && hash_of[hash_bucket_ids[b]] == hash_of[i]; ++b) {
        int32_t j = hash_bucket_ids[b];
        if (!st.var_alive(j)) continue;
        if (st.adjv[i] == st.adjv[j] && st.adje[i] == st.adje[j]) {
          // merge j into i
          st.bucket_remove(j, st.deg[j]);
          st.nv[i] += st.nv[j];
          st.nv[j] = 0;
          st.svnext[st.svtail[i]] = j;
          st.svtail[i] = st.svtail[j];
          st.adjv[j].clear();
          st.adjv[j].shrink_to_fit();
          st.adje[j].clear();
          st.adje[j].shrink_to_fit();
        }
      }
    }
  }
}
