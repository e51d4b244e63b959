"""Section-sharded SPARC AMP: the tensor/sequence-parallel axis.

The spatially-coupled base matrix factors the design matrix into
(Lr x Lc) independent Hadamard blocks (sparc_public/sparc.py:831-875);
that block structure *is* the decomposition to shard across chips
(SURVEY.md section 5, long-context analogue). Here:

  * beta / s / tau / psi are sharded along the column-block (section) axis
    'sec'; the residual z and the row statistics phi are replicated
  * forward A.beta: each device transforms only its own column blocks and
    the row-block partial sums are reduced with `psum` over 'sec'
  * adjoint A^T.z: needs only the replicated z — no communication
  * gamma = W @ psi / Lc is a psum of per-device partial matvecs
  * the early-stop test psums a local convergence predicate

Composes with the 'dp' trial axis: the exported sim step runs on a
('dp', 'sec') mesh, vmapping local trials inside each shard — this is the
dp x tp layout the driver's dryrun_multichip validates.

Requires every base-matrix column to hold the same number of nonzero blocks
(true for (omega, Lambda) SC matrices: exactly omega per column, and for
PA/plain matrices: one per column).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..config import SparcParams, DecodeParams, create_base_matrix
from ..ops.transforms import SparcDesign
from ..ops.segments import segment_table, table_sum
from ..ops.denoiser import mmse_denoise, map_estimate
from ..models.sparc import awgn_channel
from ..utils import bits as bitops
from ..utils import rng as rngmod


class ShardedDesign:
    """Column-major-ordered view of a `SparcDesign`, shardable along 'sec'.

    Wraps the SAME engine as the unsharded path (`SparcDesign.build`: one
    seeded randomness stream, the pow-2 full-window/offset-0 layout, tall
    blocks via the `tall` flag) and only permutes the per-block leaves
    column-major so each 'sec' shard owns contiguous column groups. The
    operator it realizes is bit-identical to the unsharded design for the
    same seed (tests/test_parallel.py::test_sharded_design_matches_unsharded).
    """

    def __init__(self, params: SparcParams, awgn_var: float, seed):
        W = create_base_matrix(params, awgn_var)
        L, M = params.L, params.M
        n = params.codeword_length()
        design = SparcDesign.build(W, L, M, n, seed)
        Lr, Lc, Mr, Mc = design.Lr, design.Lc, design.Mr, design.Mc
        rows = np.asarray(design.rows, np.int32)
        cols = np.asarray(design.cols, np.int32)
        order = np.lexsort((rows, cols))  # column-major
        rows, cols = rows[order], cols[order]
        per_col = np.bincount(cols, minlength=Lc)
        assert np.all(per_col == per_col[0]), \
            "section sharding needs equal nonzero blocks per column"
        self.blocks_per_col = int(per_col[0])
        self.W = W
        self.params = params
        self.design = design  # static metadata donor (leaves replaced per shard)
        self.Lr, self.Lc, self.Mr, self.Mc = Lr, Lc, Mr, Mc
        self.w, self.n = design.w, n
        self.rows = jnp.asarray(rows)
        self.cols = jnp.asarray(cols)
        self.idx = design.idx[order]
        self.signs = design.signs[order]
        self.scale = design.scale[order]


def make_sharded_sim_step(params: SparcParams, decode: DecodeParams,
                          awgn_var: float, mesh: jax.sharding.Mesh,
                          seed=0):
    """Build the jitted ('dp','sec')-sharded Monte-Carlo simulation step.

    Returns (step_fn, n_dp): step_fn(keys) runs len(keys) trials (sharded
    over 'dp', sections sharded over 'sec') and returns globally psum-reduced
    [bit_errs, sec_errs, frame_errs, iter_sum].
    """
    sd = ShardedDesign(params, awgn_var, seed)
    n_sec = mesh.shape["sec"]
    n_dp = mesh.shape["dp"]
    Lr, Lc, Mr, Mc, n = sd.Lr, sd.Lc, sd.Mr, sd.Mc, sd.n
    L, M, K = params.L, params.M, params.K
    assert Lc % n_sec == 0, f"sec axis {n_sec} must divide Lc={Lc}"
    Lc_loc = Lc // n_sec
    E_loc = Lc_loc * sd.blocks_per_col
    # blocks are column-major with equal blocks per column, so local block
    # j belongs to local column j // blocks_per_col on every shard; the
    # row membership differs per shard and rides in as a sharded table
    col_table = np.arange(E_loc, dtype=np.int32).reshape(Lc_loc, -1)
    rows_np = np.asarray(sd.rows)
    tables = [segment_table(rows_np[k * E_loc:(k + 1) * E_loc], Lr)
              for k in range(n_sec)]
    depth = max(t.shape[1] for t in tables)
    row_tables = jnp.asarray(np.concatenate(
        [np.pad(t, ((0, 0), (0, depth - t.shape[1])), constant_values=-1)
         for t in tables]))                               # (n_sec * Lr, depth)
    sec_per_col = L // Lc
    bits_per_col_block = (L // Lc) * params.sec_size
    t_max, rtol = decode.t_max, decode.rtol
    atol = 2 * float(np.finfo(np.float32).resolution)
    Wj = jnp.asarray(sd.W, jnp.float32)           # (Lr, Lc) replicated
    cdtype = jnp.complex64 if params.is_complex else jnp.float32

    def trial(key, row_idx, signs, scale, rows_l, cols_l, row_table,
              W_loc, dev_col0):
        """One trial with local column blocks. cols_l are local (0-based).

        row_table: (Lr, depth) local block ids per row block, -1 padded.
        W_loc: (Lr, Lc_loc) local slice of the base matrix.
        """
        kb = rngmod.derive(key, rngmod.BITS)
        kc = rngmod.derive(key, rngmod.CHANNEL)
        # the ONE design-block engine (ops/transforms.py), restricted to
        # this shard's leaves; static layout (w, offset, tall) rides along
        d_loc = sd.design.with_leaves(row_idx, signs, scale)

        def ab(beta_loc):
            xb = beta_loc.reshape(Lc_loc, Mc)
            parts = d_loc._fwd_blocks(xb[cols_l])                 # (E_loc, Mr)
            out = table_sum(parts, row_table)
            return jax.lax.psum(out.reshape(n), "sec")

        def az(z):
            zb = z.reshape(Lr, Mr)
            parts = d_loc._adj_blocks(zb[rows_l])                 # (E_loc, Mc)
            return table_sum(parts, col_table).reshape(Lc_loc * Mc)

        # --- encode: local message bits -> local beta -> replicated x ---
        # derive per-column-block bit keys so randomness is independent of
        # the sharding layout
        kb_cols = jax.vmap(lambda c: jax.random.fold_in(kb, c))(
            dev_col0 + jnp.arange(Lc_loc))
        bits_loc = jax.vmap(lambda k: bitops.random_bits(
            k, bits_per_col_block))(kb_cols)                      # (Lc_loc, bits)
        beta0 = jax.vmap(lambda b: bitops.bits_to_msg_vector(b, M, K))(
            bits_loc).reshape(Lc_loc * Mc).astype(cdtype)
        x = ab(beta0)
        y = awgn_channel(x, awgn_var, kc)

        # --- AMP with sharded sections ---
        def rep_r(v):
            return jnp.broadcast_to(v[:, None], (Lr, Mr)).reshape(n)

        def rep_c(v):
            return jnp.broadcast_to(v[:, None],
                                    (Lc_loc, Mc)).reshape(Lc_loc * Mc)

        # W matvecs at HIGHEST: no TF32 rounding of the float32 statistics
        hi = jax.lax.Precision.HIGHEST

        def body(carry, t):
            beta, z, s_prev, phi_prev, psi_loc, stopped, t_final = carry
            first = t == 0
            gamma = jax.lax.psum(jnp.matmul(W_loc, psi_loc, precision=hi),
                                 "sec") / Lc                      # (Lr,)
            b_coef = jnp.where(first, 0.0, gamma / phi_prev)
            z_new = jnp.where(first, y, y - ab(beta) + rep_r(b_coef) * z)
            if decode.phi_est_method == 1:
                phi = awgn_var + gamma
            else:
                phi = jnp.mean(jnp.abs(z_new).reshape(Lr, Mr) ** 2, axis=1)
            tau_loc = (L / Mr) / jnp.matmul(W_loc.T, 1.0 / phi,
                                            precision=hi)         # (Lc_loc,)
            s = beta + rep_c(tau_loc) * az(z_new / rep_r(phi).astype(z_new.dtype))
            beta_new = mmse_denoise(s, rep_c(1.0 / tau_loc), M, K)
            psi_new = 1.0 - jnp.sum(
                jnp.abs(beta_new).reshape(Lc_loc, Mc) ** 2, axis=1) / sec_per_col
            dev_local = jnp.max(jnp.abs(psi_new - psi_loc) -
                                (atol + rtol * jnp.abs(psi_loc)))
            converged = jnp.logical_and(
                t > 0, jax.lax.pmax(dev_local, "sec") <= 0)
            keep = lambda old, new: jnp.where(stopped, old, new)
            return (keep(beta, beta_new), keep(z, z_new), keep(s_prev, s),
                    keep(phi_prev, phi), keep(psi_loc, psi_new),
                    stopped | converged,
                    jnp.where(stopped, t_final, t + 1)), None

        init = (jnp.zeros(Lc_loc * Mc, cdtype), jnp.zeros(n, cdtype),
                jnp.zeros(Lc_loc * Mc, cdtype), jnp.ones(Lr, jnp.float32),
                jnp.ones(Lc_loc, jnp.float32), jnp.asarray(False),
                jnp.asarray(0))
        (beta, _, s, _, _, _, t_final), _ = jax.lax.scan(
            body, init, jnp.arange(t_max - 1))
        beta_map = map_estimate(s, M, K)
        bits_out = jax.vmap(lambda b: bitops.msg_vector_to_bits(b, M, K))(
            beta_map.reshape(Lc_loc, Mc))
        bit_errs = jnp.sum(bits_loc.astype(jnp.int32) !=
                           bits_out.astype(jnp.int32))
        sec_errs = jnp.sum(jnp.any(
            (beta_map != beta0).reshape(Lc_loc * sec_per_col, M), axis=1))
        return bit_errs, sec_errs, t_final

    # Reductions: bit/section error counts are local to each sec shard
    # (shards own disjoint sections) -> global count is a psum over 'sec'.
    # A frame error is "any bit error on any shard" -> psum the per-trial
    # bit counts over 'sec' first. t_final is replicated across 'sec', so
    # its psum is divided back by n_sec.
    def shard_fn(keys, row_idx, signs, scale, rows_g, cols_g, row_table):
        sec_idx = jax.lax.axis_index("sec")
        dev_col0 = sec_idx * Lc_loc
        cols_l = cols_g - dev_col0
        W_loc = jax.lax.dynamic_slice_in_dim(Wj, dev_col0, Lc_loc, axis=1)
        be, se, it = jax.vmap(
            lambda k: trial(k, row_idx, signs, scale, rows_g, cols_l,
                            row_table, W_loc, dev_col0))(keys)
        be_g = jax.lax.psum(jnp.sum(be), "sec")        # disjoint sections
        se_g = jax.lax.psum(jnp.sum(se), "sec")
        fe_g = jax.lax.psum(jnp.sum((jax.lax.psum(be, "sec") > 0)
                                    .astype(jnp.int32)), "sec") // n_sec
        it_g = jax.lax.psum(jnp.sum(it), "sec") // n_sec
        out = jnp.stack([be_g, se_g, fe_g, it_g])
        return jax.lax.psum(out, "dp")[None]

    step = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh, check_vma=False,
        in_specs=(P("dp"), P("sec", None), P("sec", None), P("sec"),
                  P("sec"), P("sec"), P("sec", None)),
        out_specs=P("dp")))

    def run(keys):
        out = np.asarray(step(keys, sd.idx, sd.signs, sd.scale,
                              sd.rows, sd.cols, row_tables))[0]
        return {"bit_errs": int(out[0]), "sec_errs": int(out[1]),
                "frame_errs": int(out[2]), "iter_sum": int(out[3])}

    # expose the raw jitted step + its full argument list so perf tooling
    # (benchmarks/multichip_scaling.py) can time it and inspect the
    # compiled HLO's collectives without re-deriving the design
    run.step = step
    run.step_args = lambda keys: (keys, sd.idx, sd.signs, sd.scale,
                                  sd.rows, sd.cols, row_tables)
    return run, n_dp
