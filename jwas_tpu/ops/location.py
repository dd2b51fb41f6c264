"""Location-parameter (non-marker) Gibbs sampling and iterative solvers.

From-scratch equivalents of the reference iterative solver kernels (reference:
src/1.JWAS/src/iterative_solver/solver.jl). The mixed-model-equation LHS is a
dense (K, K) device array here: location-effect counts are typically orders of
magnitude below marker counts, and a dense representation lets the sequential
single-site pass compile to one `lax.scan` with an O(K) fused row product per
step (XLA handles sparse MMEs poorly; the dense form is the accelerator's
choice for K up to ~10^4, see SURVEY.md section 7 hard-part 4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def gibbs_pass_lambda(A, x, b, vare, key):
    """One single-site Gibbs pass over the lambda-version MME (single-trait).

    x_i ~ N( (b_i - A[:,i]'x)/A_ii + x_i , vare / A_ii ), skipping zero
    diagonals (solver.jl:143-151).
    """
    K = x.shape[0]
    zs = jax.random.normal(key, (K,), dtype=x.dtype)

    def step(x, i):
        a_col = A[:, i]
        diag = a_col[i]
        safe = diag != 0.0
        inv_lhs = jnp.where(safe, 1.0 / jnp.where(safe, diag, 1.0), 0.0)
        mu = inv_lhs * (b[i] - jnp.dot(a_col, x)) + x[i]
        xi = mu + zs[i] * jnp.sqrt(inv_lhs * vare)
        return x.at[i].set(jnp.where(safe, xi, x[i])), None

    x, _ = jax.lax.scan(step, x, jnp.arange(K))
    return x


@jax.jit
def gibbs_pass_general(A, x, b, key):
    """One single-site Gibbs pass over the general MME (multi-trait).

    x_i ~ N( (b_i - A[:,i]'x)/A_ii + x_i , 1 / A_ii ) (solver.jl:154-162).
    """
    K = x.shape[0]
    zs = jax.random.normal(key, (K,), dtype=x.dtype)

    def step(x, i):
        a_col = A[:, i]
        diag = a_col[i]
        safe = diag != 0.0
        inv_lhs = jnp.where(safe, 1.0 / jnp.where(safe, diag, 1.0), 0.0)
        mu = inv_lhs * (b[i] - jnp.dot(a_col, x)) + x[i]
        xi = mu + zs[i] * jnp.sqrt(inv_lhs)
        return x.at[i].set(jnp.where(safe, xi, x[i])), None

    x, _ = jax.lax.scan(step, x, jnp.arange(K))
    return x


def jacobi(A, b, x0=None, p=0.7, tolerance=1e-6, maxiter=1000):
    """Damped Jacobi iteration (solver.jl:59-78). Host-side convergence loop."""
    import numpy as np

    A = np.asarray(A)
    b = np.asarray(b)
    x = np.zeros_like(b) if x0 is None else np.asarray(x0).copy()
    D = np.diag(A)
    n = len(b)
    for _ in range(maxiter):
        err = b - A @ x
        x = p * (err / D + x) + (1 - p) * x
        if np.sum(err**2) / n <= tolerance:
            break
    return x


def gauss_seidel(A, b, x0=None, tolerance=1e-6, maxiter=1000):
    """Gauss-Seidel iteration (solver.jl:80-102). Host-side numpy."""
    import numpy as np

    A = np.asarray(A)
    b = np.asarray(b)
    x = np.zeros_like(b) if x0 is None else np.asarray(x0).copy()
    n = len(b)
    for _ in range(maxiter + 1):
        for i in range(n):
            x[i] += (b[i] - A[:, i] @ x) / A[i, i]
        err = b - A @ x
        if np.sum(err**2) / n <= tolerance:
            break
    return x


def gibbs_solver(A, b, vare=None, niter=5000, seed=0):
    """Multi-pass Gibbs returning the running mean (solver.jl:105-140)."""
    A = jnp.asarray(A)
    b = jnp.asarray(b)
    x = jnp.zeros_like(b)
    key = jax.random.PRNGKey(seed)

    def body(carry, k):
        x, xmean, it = carry
        if vare is not None:
            x = gibbs_pass_lambda(A, x, b, vare, k)
        else:
            x = gibbs_pass_general(A, x, b, k)
        it = it + 1
        xmean = xmean + (x - xmean) / it
        return (x, xmean, it), None

    keys = jax.random.split(key, niter)
    (x, xmean, _), _ = jax.lax.scan(body, (x, jnp.zeros_like(b), 0.0), keys)
    return xmean
