// Native setup core — the host-side "graph builder" of the framework.
//
// The reference's entire runtime is C++ (header-only deal.II layer); here the
// device compute path is JAX/XLA, and this library provides the native setup
// layer that builds the operator/smoother factor tables the device kernels
// consume: global 1D assembly, overlap-aware FDM patch matrices (the
// semantics of /root/reference/include/tensor_product_matrix_creator.h and
// deal.II's overlap creator used at matrix_free.h:350-363), a self-contained
// generalized symmetric eigensolver (Cholesky + cyclic Jacobi), and the
// fused window-selector/eigen-transform matrices G_d of ops/tensorops.py.
//
// Exposed via a C ABI for ctypes; Python fallbacks remain for every entry.

#include <cmath>
#include <cstring>
#include <vector>

namespace {

// dense helpers (row-major n x n)
inline double &at(double *A, int n, int i, int j) { return A[i * n + j]; }
inline const double &at(const double *A, int n, int i, int j) {
  return A[i * n + j];
}

// Cholesky M = L L^T (lower). Returns 0 on success.
int cholesky(int n, const double *M, std::vector<double> &L) {
  L.assign(n * n, 0.0);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = at(M, n, i, j);
      for (int k = 0; k < j; ++k) s -= L[i * n + k] * L[j * n + k];
      if (i == j) {
        if (s <= 0.0) return 1;
        L[i * n + i] = std::sqrt(s);
      } else {
        L[i * n + j] = s / L[j * n + j];
      }
    }
  }
  return 0;
}

// solve L x = b in place (lower triangular)
void forward_sub(int n, const std::vector<double> &L, double *x) {
  for (int i = 0; i < n; ++i) {
    double s = x[i];
    for (int k = 0; k < i; ++k) s -= L[i * n + k] * x[k];
    x[i] = s / L[i * n + i];
  }
}

// solve L^T x = b in place
void backward_sub_T(int n, const std::vector<double> &L, double *x) {
  for (int i = n - 1; i >= 0; --i) {
    double s = x[i];
    for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * x[k];
    x[i] = s / L[i * n + i];
  }
}

// cyclic Jacobi eigendecomposition of symmetric B (destroyed);
// eigenvectors in columns of Q (row-major Q[i*n+j] = component i of vec j).
void jacobi_eig(int n, std::vector<double> &B, std::vector<double> &Q,
                double *lam) {
  Q.assign(n * n, 0.0);
  for (int i = 0; i < n; ++i) Q[i * n + i] = 1.0;
  const int max_sweeps = 64;
  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    double off = 0.0;
    for (int i = 0; i < n; ++i)
      for (int j = i + 1; j < n; ++j) off += B[i * n + j] * B[i * n + j];
    if (off < 1e-28 * n * n) break;
    for (int pp = 0; pp < n - 1; ++pp) {
      for (int q = pp + 1; q < n; ++q) {
        const double apq = B[pp * n + q];
        if (std::fabs(apq) < 1e-300) continue;
        const double app = B[pp * n + pp], aqq = B[q * n + q];
        const double tau = (aqq - app) / (2.0 * apq);
        const double t = (tau >= 0 ? 1.0 : -1.0) /
                         (std::fabs(tau) + std::sqrt(1.0 + tau * tau));
        const double c = 1.0 / std::sqrt(1.0 + t * t);
        const double s = t * c;
        for (int k = 0; k < n; ++k) {
          const double bkp = B[k * n + pp], bkq = B[k * n + q];
          B[k * n + pp] = c * bkp - s * bkq;
          B[k * n + q] = s * bkp + c * bkq;
        }
        for (int k = 0; k < n; ++k) {
          const double bpk = B[pp * n + k], bqk = B[q * n + k];
          B[pp * n + k] = c * bpk - s * bqk;
          B[q * n + k] = s * bpk + c * bqk;
        }
        for (int k = 0; k < n; ++k) {
          const double qkp = Q[k * n + pp], qkq = Q[k * n + q];
          Q[k * n + pp] = c * qkp - s * qkq;
          Q[k * n + q] = s * qkp + c * qkq;
        }
      }
    }
  }
  for (int i = 0; i < n; ++i) lam[i] = B[i * n + i];
  // sort ascending (insertion sort on eigenpairs)
  for (int i = 1; i < n; ++i) {
    double lv = lam[i];
    std::vector<double> col(n);
    for (int k = 0; k < n; ++k) col[k] = Q[k * n + i];
    int j = i - 1;
    while (j >= 0 && lam[j] > lv) {
      lam[j + 1] = lam[j];
      for (int k = 0; k < n; ++k) Q[k * n + j + 1] = Q[k * n + j];
      --j;
    }
    lam[j + 1] = lv;
    for (int k = 0; k < n; ++k) Q[k * n + j + 1] = col[k];
  }
}

}  // namespace

extern "C" {

// Global assembled 1D mass/stiffness: M,K are (N x N) row-major outputs.
void assemble_global_1d(const double *Mref, const double *Kref, int p,
                        int n_cells, double h, int periodic, double *M,
                        double *K) {
  const int n1 = p + 1;
  const int N = periodic ? p * n_cells : p * n_cells + 1;
  std::memset(M, 0, sizeof(double) * N * N);
  std::memset(K, 0, sizeof(double) * N * N);
  for (int c = 0; c < n_cells; ++c)
    for (int i = 0; i < n1; ++i)
      for (int j = 0; j < n1; ++j) {
        const int gi = (c * p + i) % N;
        const int gj = (c * p + j) % N;
        M[gi * N + gj] += Mref[i * n1 + j] * h;
        K[gi * N + gj] += Kref[i * n1 + j] / h;
      }
}

// Overlap-aware 1D FDM patch matrices (m = p-1+2*overlap), bc: 0=dirichlet,
// 1=neumann, 2=internal.  Mirrors dealii_asm/precond/fdm.py semantics.
void fdm_1d_matrices(const double *Mref, const double *Kref, int p,
                     int overlap, const double *extents, int bc_left,
                     int bc_right, double *Mw, double *Kw) {
  const int n1 = p + 1;
  const int m = p - 1 + 2 * overlap;
  const int size = 3 * p + 1;
  std::vector<double> M3(size * size, 0.0), K3(size * size, 0.0);
  for (int c = 0; c < 3; ++c) {
    const double h = extents[c];
    if (h <= 0.0) continue;
    for (int i = 0; i < n1; ++i)
      for (int j = 0; j < n1; ++j) {
        M3[(c * p + i) * size + (c * p + j)] += Mref[i * n1 + j] * h;
        K3[(c * p + i) * size + (c * p + j)] += Kref[i * n1 + j] / h;
      }
  }
  const int lo = p - (overlap - 1);
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < m; ++j) {
      Mw[i * m + j] = M3[(lo + i) * size + (lo + j)];
      Kw[i * m + j] = K3[(lo + i) * size + (lo + j)];
    }
  auto decouple = [&](int i) {
    for (int k = 0; k < m; ++k) {
      Mw[i * m + k] = Mw[k * m + i] = 0.0;
      Kw[i * m + k] = Kw[k * m + i] = 0.0;
    }
    Mw[i * m + i] = 1.0;
    Kw[i * m + i] = 1.0;
  };
  if (extents[0] <= 0.0) {
    for (int i = 0; i < overlap - 1; ++i) decouple(i);
    if (bc_left == 0) decouple(overlap - 1);
  }
  if (extents[2] <= 0.0) {
    for (int i = m - (overlap - 1); i < m; ++i) decouple(i);
    if (bc_right == 0) decouple(m - overlap);
  }
}

// Generalized symmetric eigenproblem K v = lam M v, M SPD.
// lam (n), V (n x n, column k = k-th M-orthonormal eigenvector, row-major).
int generalized_eigh(int n, const double *K, const double *M, double *lam,
                     double *V) {
  std::vector<double> L;
  if (cholesky(n, M, L)) return 1;
  // B = L^-1 K L^-T
  std::vector<double> B(n * n);
  std::vector<double> col(n);
  // first: X = L^-1 K  (solve per column of K)
  std::vector<double> X(n * n);
  for (int j = 0; j < n; ++j) {
    for (int i = 0; i < n; ++i) col[i] = K[i * n + j];
    forward_sub(n, L, col.data());
    for (int i = 0; i < n; ++i) X[i * n + j] = col[i];
  }
  // B = X L^-T: B^T = L^-1 X^T — solve rows
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) col[j] = X[i * n + j];
    forward_sub(n, L, col.data());
    for (int j = 0; j < n; ++j) B[i * n + j] = col[j];
  }
  // symmetrize against roundoff
  for (int i = 0; i < n; ++i)
    for (int j = i + 1; j < n; ++j) {
      const double s = 0.5 * (B[i * n + j] + B[j * n + i]);
      B[i * n + j] = B[j * n + i] = s;
    }
  std::vector<double> Q;
  jacobi_eig(n, B, Q, lam);
  // V = L^-T Q (per column)
  for (int j = 0; j < n; ++j) {
    for (int i = 0; i < n; ++i) col[i] = Q[i * n + j];
    backward_sub_T(n, L, col.data());
    for (int i = 0; i < n; ++i) V[i * n + j] = col[i];
  }
  return 0;
}

// Fused window-selector + eigen-transform G (C*m x N), row-major.
void fdm_direction_transform(const double *V, int C, int m, int n_nodes,
                             int p, int overlap, int periodic, double *G) {
  std::memset(G, 0, sizeof(double) * C * m * n_nodes);
  for (int c = 0; c < C; ++c)
    for (int s = 0; s < m; ++s) {
      long n = (long)c * p + s - (overlap - 1);
      if (periodic) {
        n = ((n % n_nodes) + n_nodes) % n_nodes;
      } else if (n < 0 || n >= n_nodes) {
        continue;
      }
      for (int k = 0; k < m; ++k)
        G[((long)c * m + k) * n_nodes + n] += V[((long)c * m + s) * m + k];
    }
}

}  // extern "C"
