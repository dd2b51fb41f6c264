"""Pallas (Triton route) kernels for the fast-blocks inner rounds on a GPU.

The hot loop of the whole framework (reference: the per-marker Gibbs chain of
BayesABC!, src/1.JWAS/src/markers/BayesianAlphabet/BayesABC.jl:111-188, and
BayesR.jl:45-97, restructured by fast_blocks into b-length scalar chains on
cached Gram tiles). The XLA path (ops/markers.py `_blocked_round`) expresses
the chain as a `lax.scan`; every scan step is at least one kernel launch on a
GPU, and each sync round is `nreps * b` strictly dependent steps.

Here one program owns `L` marker blocks and runs all `nreps * b` steps of a
sync round in one launch:

- the state rows (alpha, beta, delta, rhs; `(L, bp)` with the block size
  padded to a power of two `bp`) stay in registers for the whole round;
- the per-marker update is evaluated elementwise over the row and marker j
  is selected by a mask, so the only cross-thread work per step is one sum
  (the change of alpha_j) that is broadcast into the rhs update;
- the Gram tile is read block-major (`(nblocks, bp, bp)`), one contiguous
  row per step; a block's 64 KB tile (b=128, f32) stays cache-resident
  across the round's repetitions;
- the random draws are made by `jax.random` outside the kernel from the same
  keys as the XLA path, so outputs follow the XLA scan's update order and
  draws exactly (tested in interpret mode on the CPU).

Blocks are independent within a round, so programs run in parallel with no
communication; padded blocks and padded rows are masked out by construction
(zero Gram rows, never-selected positions).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from jwas_tpu.ops import markers as mk

NUM_SMS_HINT = 132       # programs in flight before blocks are batched per program


def _pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _blocks_per_program(nblocks: int) -> int:
    """Marker blocks per program: one while the grid fits the card's SMs
    about twice over (the chain is latency-bound, so parallel programs are
    free); more once there are many blocks to amortise each step over."""
    L = 1
    while L < 8 and nblocks > 2 * NUM_SMS_HINT * L:
        L *= 2
    return L


def _launch(kernel, grid, out_shape, L, bp, interpret, name):
    """One warp while a program's rows fit in 256 lanes, else four."""
    return pl.pallas_call(
        kernel,
        grid=grid,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=1 if L * bp <= 256 else 4, num_stages=2),
        interpret=interpret,
        name=name,
    )


def _to_block_major(x, nbp, bp, fill):
    """(b, nblocks) j-major tile -> padded (nbp, bp) block-major rows."""
    b, nblocks = x.shape
    return jnp.pad(x.T, ((0, nbp - nblocks), (0, bp - b)),
                   constant_values=fill)


def _grams_block_major(grams, nbp, bp):
    """(b, b, nblocks) j-major Grams -> zero-padded (nbp, bp, bp) with
    out[i, j, :] = row j of block i's Gram."""
    b, _, nblocks = grams.shape
    g = jnp.transpose(grams, (2, 0, 1))
    return jnp.pad(g, ((0, nbp - nblocks), (0, bp - b), (0, bp - b)))


def _pad_draws(x, nbp):
    """(steps, nblocks) draws -> (steps, nbp)."""
    return jnp.pad(x, ((0, 0), (0, nbp - x.shape[1])))


def _abc_kernel(n_steps, b, L, bp,
                scal_ref, xpx_ref, ve_ref, lp_ref, lpc_ref, us_ref, zs_ref,
                g_ref, a_ref, be_ref, d_ref, rhs_ref,
                a_out, be_out, d_out, rhs_out):
    blk = pl.ds(pl.program_id(0) * L, L)
    inv_vare = scal_ref[0]
    xpx, ve = xpx_ref[blk, :], ve_ref[blk, :]
    lp, lpc = lp_ref[blk, :], lpc_ref[blk, :]
    cols = jax.lax.broadcasted_iota(jnp.int32, (L, bp), 1)

    def body(step, carry):
        alpha, beta, delta, rhs = carry
        j = jax.lax.rem(step, b)
        u = us_ref[step, blk][:, None]
        z = zs_ref[step, blk][:, None]
        a_new, b_new, d_new = mk._abc_update(rhs, alpha, xpx, inv_vare, ve,
                                             lp, lpc, u, z)
        sel = cols == j
        d_a = jnp.sum(jnp.where(sel, alpha - a_new, 0.0), axis=1)
        rhs = rhs + d_a[:, None] * g_ref[blk, j, :]
        return (jnp.where(sel, a_new, alpha), jnp.where(sel, b_new, beta),
                jnp.where(sel, d_new, delta), rhs)

    carry = (a_ref[blk, :], be_ref[blk, :], d_ref[blk, :], rhs_ref[blk, :])
    alpha, beta, delta, rhs = jax.lax.fori_loop(0, n_steps, body, carry)
    a_out[blk, :] = alpha
    be_out[blk, :] = beta
    d_out[blk, :] = delta
    rhs_out[blk, :] = rhs


@partial(jax.jit, static_argnames=("nreps", "interpret"))
def abc_inner_rounds_pallas(grams, xpx_b, var_eff_b, log_pi, log_pi_comp,
                            alpha_b, beta_b, delta_b, rhs0, us, zs, inv_vare,
                            nreps: int, interpret: bool = False):
    """Run nreps rounds of the spike-slab within-block chain on every block.

    grams: (b, b, nblocks) j-major; state/tiles: (b, nblocks); us/zs:
    (nreps*b, nblocks). Any b and nblocks (padding is internal). Returns
    (alpha_b, beta_b, delta_b, rhs_b) in the j-major layout: the values of
    the XLA scan on the same draws."""
    b, _, nblocks = grams.shape
    dtype = rhs0.dtype
    bp = _pow2(b)
    L = _blocks_per_program(nblocks)
    nbp = -(-nblocks // L) * L
    rows = lambda x, fill=0.0: _to_block_major(x, nbp, bp, fill)  # noqa: E731
    kernel = partial(_abc_kernel, nreps * b, b, L, bp)
    state_shape = jax.ShapeDtypeStruct((nbp, bp), dtype)
    out = _launch(
        kernel, (nbp // L,),
        [state_shape, state_shape,
         jax.ShapeDtypeStruct((nbp, bp), jnp.int32), state_shape],
        L, bp, interpret,
        "gibbs_abc_inner_rounds",
    )(
        jnp.reshape(jnp.asarray(inv_vare, dtype), (1,)),
        rows(xpx_b, 1.0), rows(jnp.broadcast_to(var_eff_b, xpx_b.shape), 1.0),
        rows(log_pi), rows(log_pi_comp), _pad_draws(us, nbp),
        _pad_draws(zs, nbp), _grams_block_major(grams, nbp, bp),
        rows(alpha_b), rows(beta_b), rows(delta_b.astype(jnp.int32), 0),
        rows(rhs0),
    )
    return tuple(o[:nblocks, :b].T for o in out)


def _bayesr_kernel(n_steps, b, L, bp,
                   scal_ref, xpx_ref, lp_ref, gum_ref, zs_ref, g_ref,
                   a_ref, d_ref, rhs_ref, a_out, d_out, rhs_out):
    blk = pl.ds(pl.program_id(0) * L, L)
    inv_vare = scal_ref[0]
    sigma_sq = scal_ref[1]
    xpx = xpx_ref[blk, :]
    lps = [lp_ref[k, blk, :] for k in range(4)]
    cols = jax.lax.broadcasted_iota(jnp.int32, (L, bp), 1)

    def body(step, carry):
        alpha, delta, rhs = carry
        j = jax.lax.rem(step, b)
        z = zs_ref[step, blk][:, None]
        # the math of markers.bayesr_class_logprobs + the Gumbel-max draw;
        # first-max tie-breaking as jnp.argmax
        r = (rhs + xpx * alpha) * inv_vare
        best = lps[0] + gum_ref[0, step, blk][:, None]
        kv = jnp.zeros((L, bp), jnp.int32)
        bh_b = jnp.zeros_like(best)
        il_b = jnp.zeros_like(best)
        for k in (1, 2, 3):
            var_eff = mk.BAYESR_GAMMA[k] * sigma_sq
            il = 1.0 / (xpx * inv_vare + 1.0 / var_eff)
            bh = il * r
            ll = 0.5 * (jnp.log(il) - jnp.log(var_eff) + bh * r)
            score = (lps[k] + ll) + gum_ref[k, step, blk][:, None]
            upd = score > best
            best = jnp.where(upd, score, best)
            kv = jnp.where(upd, k, kv)
            bh_b = jnp.where(upd, bh, bh_b)
            il_b = jnp.where(upd, il, il_b)
        a_new = jnp.where(kv == 0, 0.0, bh_b + z * jnp.sqrt(il_b))
        sel = cols == j
        d_a = jnp.sum(jnp.where(sel, alpha - a_new, 0.0), axis=1)
        rhs = rhs + d_a[:, None] * g_ref[blk, j, :]
        return (jnp.where(sel, a_new, alpha), jnp.where(sel, kv, delta), rhs)

    carry = (a_ref[blk, :], d_ref[blk, :], rhs_ref[blk, :])
    alpha, delta, rhs = jax.lax.fori_loop(0, n_steps, body, carry)
    a_out[blk, :] = alpha
    d_out[blk, :] = delta
    rhs_out[blk, :] = rhs


@partial(jax.jit, static_argnames=("nreps", "interpret"))
def bayesr_inner_rounds_pallas(grams, xpx_b, log_pi_b, alpha_b, delta_b, rhs0,
                               inv_vare, sigma_sq, kg, kz, nreps: int,
                               interpret: bool = False):
    """Run nreps rounds of the BayesR within-block chain on every block.

    grams: (b, b, nblocks); xpx_b/alpha_b/rhs0: (b, nblocks); log_pi_b:
    (b, nblocks, 4) log class priors; delta_b: (b, nblocks) int32 class
    labels. The Gumbel panels and normals are drawn here exactly as the XLA
    path draws them from (kg, kz), so outputs follow the scan's draws."""
    b, _, nblocks = grams.shape
    dtype = rhs0.dtype
    bp = _pow2(b)
    L = _blocks_per_program(nblocks)
    nbp = -(-nblocks // L) * L
    gum = jax.random.gumbel(kg, (nreps * b, nblocks, 4), dtype=dtype)
    zs = jax.random.normal(kz, (nreps * b, nblocks), dtype=dtype)
    gum_t = jnp.pad(jnp.moveaxis(gum, 2, 0),
                    ((0, 0), (0, 0), (0, nbp - nblocks)))
    lp = jnp.stack([_to_block_major(log_pi_b[:, :, k], nbp, bp, 0.0)
                    for k in range(4)])
    rows = lambda x, fill=0.0: _to_block_major(x, nbp, bp, fill)  # noqa: E731
    kernel = partial(_bayesr_kernel, nreps * b, b, L, bp)
    state_shape = jax.ShapeDtypeStruct((nbp, bp), dtype)
    out = _launch(
        kernel, (nbp // L,),
        [state_shape, jax.ShapeDtypeStruct((nbp, bp), jnp.int32),
         state_shape],
        L, bp, interpret,
        "gibbs_bayesr_inner_rounds",
    )(
        jnp.stack([jnp.asarray(inv_vare, dtype), jnp.asarray(sigma_sq, dtype)]),
        rows(xpx_b, 1.0), lp, gum_t, _pad_draws(zs, nbp),
        _grams_block_major(grams, nbp, bp),
        rows(alpha_b), rows(delta_b.astype(jnp.int32), 0), rows(rhs0),
    )
    return tuple(o[:nblocks, :b].T for o in out)
