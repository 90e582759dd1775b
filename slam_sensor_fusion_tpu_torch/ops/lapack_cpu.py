"""The float32 LAPACK calls of the JAX package's jitted functions on the
CPU, bit for bit: `inv`, `solve` and `eigh` of CPU tensors.

On the CPU, jitted `jnp.linalg.inv`, `solve` and `eigh` become custom calls
into jaxlib's LAPACK (`lapack_sgetrf_ffi`, `lapack_strsm_ffi`,
`lapack_ssyevd_ffi`), and jaxlib takes those kernels from scipy's own
LAPACK and BLAS (`scipy.linalg.cython_lapack`, `cython_blas`). Calling the
same routines through `scipy.linalg.lapack` / `scipy.linalg.blas` in the
same process gives the same bits; torch's CPU LAPACK (MKL) does not, nor
does any emulation of OpenBLAS's blocked orders. So these functions call
them as jaxlib does:

- `inv(a)`: `sgetrf`, then `strsm` twice on the row-permuted identity
  (lower unit-diagonal, then upper); `jnp.linalg.inv` is `solve(a, I)`.
- `solve(a, b)`: the same on the permuted right-hand side.
- `eigh(a)`: `(a + a^T) / 2` in float32 (`jnp.linalg.eigh` symmetrizes by
  default), then `ssyevd` on the lower triangle: ascending eigenvalues,
  eigenvectors in columns.

A singular matrix does not raise (torch's CPU `inv` does): its LU has a
zero pivot and the triangular solves give inf and NaN, as jaxlib's do.
Leading dimensions are a batch, each matrix solved on its own.

Only float32 CPU tensors are taken; any other device raises, and no tensor
is copied off the card. The callers dispatch: on the card they keep
`torch.linalg`. scipy is imported inside the functions, so the port
imports without it.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x: torch.Tensor, what: str) -> np.ndarray:
    if x.device.type != "cpu":
        raise ValueError(f"lapack_cpu.{what}: a tensor on {x.device}; only CPU tensors "
                         "are taken (the card keeps torch.linalg)")
    if x.dtype != torch.float32:
        raise ValueError(f"lapack_cpu.{what}: dtype {x.dtype}, expected float32")
    return x.detach().numpy()


def _lu_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """x with a x = b for one (n, n) `a` and (n, k) `b`, as jax's
    `lu_solve` after jaxlib's `getrf`: b's rows permuted by the pivots,
    then the unit lower and the upper triangular solves."""
    from scipy.linalg import blas, lapack

    lu, piv, _ = lapack.sgetrf(a)
    perm = np.arange(a.shape[0])
    for i, p in enumerate(piv):
        perm[i], perm[p] = perm[p], perm[i]
    x = blas.strsm(1.0, lu, b[perm], side=0, lower=1, trans_a=0, diag=1)
    return blas.strsm(1.0, lu, x, side=0, lower=0, trans_a=0, diag=0)


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`jnp.linalg.solve(a, b)` of (..., n, n) `a`: `b` is one vector (n,)
    or (..., n, k), as in jax."""
    A = _host(a, "solve")
    B = _host(b, "solve")
    vec = B.ndim == 1
    if vec:
        B = B[..., None]
    batch = np.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    n, k = A.shape[-1], B.shape[-1]
    A = np.broadcast_to(A, batch + (n, n)).reshape(-1, n, n)
    B = np.broadcast_to(B, batch + (n, k)).reshape(-1, n, k)
    out = np.stack([_lu_solve(x, y) for x, y in zip(A, B)]).astype(np.float32, copy=False)
    out = out.reshape(batch + (n, k))
    return torch.from_numpy(out[..., 0] if vec else out)


def inv(a: torch.Tensor) -> torch.Tensor:
    """`jnp.linalg.inv(a)` of (..., n, n) `a`: `solve(a, I)`."""
    A = _host(a, "inv")
    n = A.shape[-1]
    eye = np.eye(n, dtype=np.float32)
    flat = A.reshape(-1, n, n)
    out = np.stack([_lu_solve(x, eye) for x in flat]) if flat.shape[0] else flat.copy()
    return torch.from_numpy(out.astype(np.float32, copy=False).reshape(A.shape))


def eigh(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`jnp.linalg.eigh(a)` of (..., n, n) `a`: (eigenvalues (..., n)
    ascending, eigenvectors (..., n, n) in columns). Matrices with the
    same bits are solved once (the estimators' many empty cells)."""
    from scipy.linalg import lapack

    A = _host(a, "eigh")
    n = A.shape[-1]
    flat = A.reshape(-1, n, n)
    sym = (flat + flat.transpose(0, 2, 1)) / np.float32(2)
    w = np.empty(flat.shape[:2], np.float32)
    v = np.empty(flat.shape, np.float32)
    if flat.shape[0]:
        _, first, which = np.unique(sym.reshape(-1, n * n).view(np.int32), axis=0,
                                    return_index=True, return_inverse=True)
        uw = np.empty((first.shape[0], n), np.float32)
        uv = np.empty((first.shape[0], n, n), np.float32)
        for j, i in enumerate(first):
            uw[j], uv[j], info = lapack.ssyevd(sym[i], compute_v=1, lower=1)
            if info:  # no convergence: jax returns NaN
                uw[j], uv[j] = np.nan, np.nan
        w, v = uw[which.reshape(-1)], uv[which.reshape(-1)]
    return (torch.from_numpy(w.reshape(A.shape[:-1])),
            torch.from_numpy(v.reshape(A.shape)))
