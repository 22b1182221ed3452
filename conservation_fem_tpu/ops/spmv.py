"""ELL sparse matrix-vector products and operator composition.

The ELL layout (values aligned with ``Mesh.patch_cols``) makes SpMV a single
(N,K) gather + row reduction — the replacement for PETSc
CSR MatMult (ref L0 in SURVEY.md; PETSc KSP usage at
Code/Linear_advection/linear_advection.py:128-131).
"""

from __future__ import annotations

import jax.numpy as jnp

from conservation_fem_tpu.ops.mesh import MeshArrays


def ell_matvec(mesh: MeshArrays, A, x):
    """y = A @ x for A in (N,K) ELL layout. Padding entries are zero."""
    gathered = x[mesh.patch_cols]            # (N,K)
    return (A * gathered).sum(axis=1)


def ell_diag(mesh: MeshArrays, A):
    """Extract the diagonal of an ELL matrix."""
    n = A.shape[0]
    return A[jnp.arange(n), mesh.diag_slot]


def ell_transpose_matvec(mesh: MeshArrays, A, x):
    """y = A.T @ x via scatter-add over the same structure."""
    import jax

    contrib = (A * x[:, None]).reshape(-1)
    cols = mesh.patch_cols.reshape(-1)
    return jax.ops.segment_sum(contrib, cols, num_segments=A.shape[0])


def ell_add(*ops):
    """Sum of ELL matrices sharing one structure (same patch_cols)."""
    out = ops[0]
    for a in ops[1:]:
        out = out + a
    return out
