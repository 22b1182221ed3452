"""Banded SpMV: the gather-free operator form for unstructured meshes.

After RCM reordering (ops/mesh.rcm_permutation) every ELL column offset
col - row lies within the matrix bandwidth B ~ O(sqrt(N)); the operator can
then be stored as 2B+1 diagonals and applied as shifted multiply-adds —
no gather at all (its speed against the gather ELL form on the H100 is
not measured).

Trade-off: storage inflates from (N, K) to (N, 2B+1); use on meshes where
B stays O(sqrt(N)) (any RCM-ordered planar mesh). Conversion from ELL is a
single scatter-add with precomputed flat targets, cheap enough to run per
Newton iteration for state-dependent operators.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from conservation_fem_tpu.ops.mesh import Mesh


@dataclasses.dataclass(frozen=True, eq=False)
class BandedPlan:
    """Host-precomputed conversion plan ELL -> banded for one mesh.

    eq=False: identity hashing so the plan can ride through jit as static
    metadata (its arrays become baked constants)."""
    bandwidth: int          # B
    flat_idx: object        # (N*K,) targets into the (2B+1)*N banded buffer
    mask: object            # (N*K,) validity


def make_banded_plan(host_mesh: Mesh) -> BandedPlan:
    cols = host_mesh.patch_cols
    mask = host_mesh.patch_mask
    n = host_mesh.n_nodes
    offs = cols - np.arange(n)[:, None]
    B = int(np.abs(offs[mask]).max())
    flat = (offs + B) * n + np.arange(n)[:, None]
    flat = np.where(mask, flat, 0)
    return BandedPlan(
        bandwidth=B,
        flat_idx=jnp.asarray(flat.reshape(-1), jnp.int32),
        mask=jnp.asarray(mask.reshape(-1)),
    )


def ell_to_banded(plan: BandedPlan, A):
    """(N, K) ELL values -> (2B+1, N) diagonal storage."""
    n = A.shape[0]
    vals = jnp.where(plan.mask, A.reshape(-1), 0.0)
    flat = jnp.zeros((2 * plan.bandwidth + 1) * n, A.dtype).at[
        plan.flat_idx
    ].add(vals)
    return flat.reshape(2 * plan.bandwidth + 1, n)


def banded_matvec(band, x):
    """y = A x from diagonal storage: sum of shifted MACs."""
    nb, n = band.shape
    B = (nb - 1) // 2
    xp = jnp.pad(x, (B, B))
    out = jnp.zeros_like(x)
    for d in range(nb):
        out = out + band[d] * jax.lax.dynamic_slice(xp, (d,), (n,))
    return out


def constrained_banded_matvec(band, x, bc_mask):
    """Dirichlet rows/cols pinned, unit diagonal (cf. bc.constrained_matvec)."""
    x_in = jnp.where(bc_mask, 0.0, x)
    y = banded_matvec(band, x_in)
    return jnp.where(bc_mask, x, y)
