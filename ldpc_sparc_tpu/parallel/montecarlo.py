"""Data-parallel Monte-Carlo fan-out over a device mesh.

Replacement for the reference's scale-out story — 36 CLI jobs on
a grid engine appending to a shared results file
(ldpc_jossy/py/ldpc_awgn.py:60-131) and the num_of_runs x num_snrs Python
loops of ldpc_sparc/performance_plots_general.py:101-118:

  * per device, trials are `vmap`ed (one fused program decodes a whole
    batch)
  * across devices, the batch is `shard_map`ed over the mesh 'dp' axis with
    error/iteration counters reduced by `psum`
  * per-trial randomness is a fold_in of (device, trial) into one root key —
    deterministic and machine-count independent

Trial->randomness contract (shared by every entry point here; the
reference draws a fresh A per run, performance_plots_general.py:102):
trial t uses key fold(seed, t) and design (seed, t % n_designs) — both
functions of the GLOBAL trial index only. Trial counts that don't divide
the dp axis are padded up internally (padded trials masked/discarded).
The stacked design leaves are replicated to every device and each trial
selects its design's leaves, so the reduced counters are EXACTLY
independent of the mesh shape — the same partition-invariance bar
parallel/sharded.py meets.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..config import SparcParams, DecodeParams, LdpcParams, create_base_matrix
from ..ops.transforms import SparcDesign, stack_designs
from ..ops.denoiser import map_estimate
from ..models.sparc import amp_decode, awgn_channel
from ..models.ldpc import LdpcCode
from ..utils import bits as bitops
from ..utils import rng as rngmod


# --------------------------------------------------------------------------
# SPARC Monte Carlo
# --------------------------------------------------------------------------

# design stacks come from the ONE canonical engine-generic helper,
# ops/transforms.stack_designs (proto + stacked pytree leaves)

# compiled SPARC-MC programs, keyed by the full static config (see the
# concat cache below for the rationale)
_SPARC_MC_CACHE_MAX = 16
_SPARC_MC_CACHE = {}


def sparc_mc_counts(params: SparcParams, decode: DecodeParams,
                    awgn_var: float, seed, n_trials: int,
                    mesh: Optional[jax.sharding.Mesh] = None,
                    n_designs: Optional[int] = None,
                    engine: str = "srht") -> Dict[str, np.ndarray]:
    """Run n_trials independent SPARC encode->AWGN->AMP->count trials.

    Trial->randomness contract (ONE convention for every Monte-Carlo
    entry point in this module, shared with concat_mc_trial_errors):
    trial t gets key fold(seed, t) and design (seed, t % n_designs) —
    both functions of the GLOBAL trial index only, so the reduced
    counters are bit-identical on any mesh shape. n_trials that does not
    divide the dp axis is padded up internally (the padded trials are
    computed and masked out of the counters). The n_designs stacked
    design leaves are replicated across devices (P() spec); each vmapped
    trial gathers its design's leaves.

    engine: 'srht' (default) or 'dft' — the design-engine selector of
    models/sparc.design_for_params (the DFT engine is the reference's
    exact complex ensemble; complex plain-W codes only).

    Returns psum-reduced counters: bit_errs, bits, frame_errs, frames,
    sec_errs, sections, iters.
    """
    if mesh is None:
        from .mesh import make_mesh
        mesh = make_mesh(sec=1)
    n_dp = mesh.shape["dp"]
    if n_designs is None:
        n_designs = min(8, n_trials)
    n_pad = ((n_trials + n_dp - 1) // n_dp) * n_dp

    # one compiled program per static config (true-LRU, like the concat
    # path): awgn_var, the base matrix W, and every design array leaf
    # ride as TRACED arguments, so a whole SNR sweep reuses one binary.
    # W and the SRHT scale cannot be closure constants: for PA configs
    # both depend on awgn_var through the host-side allocation fixed
    # point. Design leaves are stacked GENERICALLY over the design's own
    # pytree (idx/signs/scale for SRHT, rows/cols for DFT), so both
    # engines share this one program structure.
    cfg = (params, decode, n_designs, n_pad, mesh, engine)
    if cfg not in _SPARC_MC_CACHE:
        M, K, L = params.M, params.K, params.L

        def one_trial(key, design, W, awgn_var):
            kb = rngmod.derive(key, rngmod.BITS)
            kc = rngmod.derive(key, rngmod.CHANNEL)
            bits = bitops.random_bits(kb, params.bit_len)
            beta0 = bitops.bits_to_msg_vector(bits, M, K)
            y = awgn_channel(design.ab(beta0), awgn_var, kc)
            res = amp_decode(y, design, params, decode, awgn_var, W=W)
            bits_out = bitops.msg_vector_to_bits(res.beta, M, K)
            bit_errs = jnp.sum(bits != bits_out)
            if params.modulated:
                # the reference's modulated error split (calc_ler_ver,
                # sparc_public/sparc_sim.py:100-175): loc_err = decoded
                # nonzero at the wrong position; val_err = decoded
                # nonzero VALUE differs from the true one (UNCONDITIONAL
                # on the location matching, as in the reference)
                from ..utils.metrics import location_value_errors
                _, (loc_e, val_e, sec_e) = location_value_errors(
                    beta0, res.beta, L)
                sec_errs = jnp.sum(sec_e)
                loc_errs, val_errs = jnp.sum(loc_e), jnp.sum(val_e)
            else:
                sec_errs = jnp.sum(jnp.any(
                    (res.beta != beta0).reshape(L, M), axis=1))
                loc_errs = val_errs = jnp.zeros((), sec_errs.dtype)
            return bit_errs, sec_errs, loc_errs, val_errs, res.t_final

        def shard_fn(keys_local, didx_local, valid_local, dleaves, W,
                     awgn_var):
            _, aux = _proto[0].tree_flatten()
            def per_trial(key, di):
                d = type(_proto[0]).tree_unflatten(
                    aux, tuple(l[di] for l in dleaves))
                return one_trial(key, d, W, awgn_var)
            be, se, le, ve, it = jax.vmap(per_trial)(keys_local, didx_local)
            v = valid_local  # padded trials contribute nothing
            out = jnp.stack([jnp.sum(jnp.where(v, be, 0)),
                             jnp.sum(jnp.where(v, se, 0)),
                             jnp.sum(jnp.where(v, be > 0, False)),
                             jnp.sum(jnp.where(v, it, 0)),
                             jnp.sum(jnp.where(v, le, 0)),
                             jnp.sum(jnp.where(v, ve, 0))])
            return jax.lax.psum(out, "dp")[None]

        _proto = [None]  # template design (static metadata), set pre-trace
        fn = jax.jit(jax.shard_map(
            shard_fn, mesh=mesh, check_vma=False,
            in_specs=(P("dp"), P("dp"), P("dp"), P(), P(), P()),
            out_specs=P("dp")))
        if len(_SPARC_MC_CACHE) >= _SPARC_MC_CACHE_MAX:
            _SPARC_MC_CACHE.pop(next(iter(_SPARC_MC_CACHE)))
        _SPARC_MC_CACHE[cfg] = (fn, _proto)
    fn, _proto = _SPARC_MC_CACHE.pop(cfg)
    _SPARC_MC_CACHE[cfg] = (fn, _proto)  # refresh recency

    proto, dleaves = stack_designs(params, awgn_var, seed, n_designs,
                                   engine)
    _proto[0] = proto
    W = jnp.asarray(create_base_matrix(params, float(awgn_var)), jnp.float32)
    root = rngmod.root_key(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(root, i))(
        jnp.arange(n_pad))
    didx = jnp.arange(n_pad, dtype=jnp.int32) % n_designs
    valid = jnp.arange(n_pad) < n_trials

    res = fn(keys, didx, valid, dleaves, W, jnp.float32(awgn_var))
    # rows are psum-replicated; in multi-process runs only local shards are
    # addressable, and any one row carries the global counts
    out = np.asarray(res.addressable_shards[0].data)[0]
    counts = {
        "bit_errs": int(out[0]), "bits": n_trials * params.bit_len,
        "sec_errs": int(out[1]), "sections": n_trials * params.L,
        "frame_errs": int(out[2]), "frames": n_trials,
        "iters": int(out[3]),
    }
    if params.modulated:
        counts.update({"loc_errs": int(out[4]), "val_errs": int(out[5])})
    return counts


def sparc_ber_sweep(params: SparcParams, decode: DecodeParams,
                    awgn_vars, seed, n_trials: int,
                    mesh: Optional[jax.sharding.Mesh] = None,
                    engine: str = "srht"):
    """BER/SER/FER at each noise level (the performance_plots sweep)."""
    rows = []
    for i, v in enumerate(np.atleast_1d(awgn_vars)):
        c = sparc_mc_counts(params, decode, float(v), (seed, i), n_trials,
                            mesh, engine=engine)
        row = {
            "awgn_var": float(v),
            "ber": c["bit_errs"] / c["bits"],
            "ser": c["sec_errs"] / c["sections"],
            "fer": c["frame_errs"] / c["frames"],
            "avg_iters": c["iters"] / c["frames"],
            **c}
        if params.modulated:
            # the reference's modulated metric columns
            # (sparc_public/sparc_sim.py:100-175)
            row["ler"] = c["loc_errs"] / c["sections"]
            row["ver"] = c["val_errs"] / c["sections"]
        rows.append(row)
    return rows


# --------------------------------------------------------------------------
# Concatenated LDPC-SPARC Monte Carlo (the performance_plots_general.py
# num_of_runs loop, batched + sharded)
# --------------------------------------------------------------------------

# compiled concat-MC programs, keyed by the full static config; true-LRU
# like models/concat._SIM_CACHE. Re-jitting per call re-traces the whole
# decoder, and awgn_var rides as a TRACED scalar so one program serves
# every SNR point of a sweep.
_CONCAT_MC_CACHE_MAX = 16
_CONCAT_MC_CACHE = {}


def concat_mc_trial_errors(sparc_params: SparcParams, ldpc_params: LdpcParams,
                           lengths, ldpc_protected: bool,
                           decode_params: DecodeParams, awgn_var: float,
                           seed, n_trials: int, decoder: str = "sequential",
                           mesh: Optional[jax.sharding.Mesh] = None,
                           n_designs: Optional[int] = None) -> np.ndarray:
    """Per-trial user-bit error counts for the concatenated decoder family.

    Replaces the reference's `for run in range(num_of_runs)` Python loop
    (performance_plots_general.py:101-118) with a batch of full
    encode->AWGN->AMP+BP->count trials, shard_map'ed over the mesh 'dp'
    axis. The whole batch is ONE device program; the per-AMP-iteration BP
    runs over the trials' blocks PACKED into one kernel invocation
    (ConcatCodec.decode_batch — bit-identical per trial to the vmapped
    per-trial decode; at the z=150 config each trial alone holds only 4
    codewords).

    Randomness follows the module's single trial->randomness contract
    (see the module docstring / sparc_mc_counts): trial t gets key
    fold(seed, t) and design (seed, t % n_designs) — functions of the
    GLOBAL trial index only, so results are bit-identical on any mesh
    shape. n_trials not divisible by the dp axis is padded up internally
    (extra trials computed and discarded; the kept results are unchanged).

    Returns an (n_trials,) int array of user-bit error counts (the per-run
    BERs divide by codec.user_bits_len; min/max over trials give the
    reference's asymmetric error bars, performance_plots_general.py:120-126).
    """
    from ..models.concat import ConcatCodec

    if mesh is None:
        from .mesh import make_mesh
        mesh = make_mesh(sec=1)
    n_dp = mesh.shape["dp"]
    if n_designs is None:
        n_designs = min(8, n_trials)
    n_pad = ((n_trials + n_dp - 1) // n_dp) * n_dp

    cfg = (sparc_params, ldpc_params, lengths, ldpc_protected, decode_params,
           decoder, n_designs, n_pad, mesh)
    if cfg not in _CONCAT_MC_CACHE:
        codec = ConcatCodec(sparc_params, ldpc_params, lengths,
                            ldpc_protected)

        def shard_fn(keys_local, didx_local, idx, signs, awgn_var):
            # designs_proto is a zero-batch template carrying the static
            # metadata; per-shard trials gather their design leaves
            def tx(key, di):
                user_bits, _, beta0 = codec.encode_message(key)
                d = _design_proto[0].with_leaves(idx[di], signs[di])
                x = d.ab(beta0 / codec.c_amp)
                y = awgn_channel(x, awgn_var,
                                 rngmod.derive(key, rngmod.CHANNEL))
                return user_bits, y

            user_bits, ys = jax.vmap(tx)(keys_local, didx_local)
            batch_designs = _design_proto[0].with_leaves(
                idx[didx_local], signs[didx_local])
            bits_out = codec.decode_batch(ys, batch_designs, decode_params,
                                          decoder)
            errs = jnp.sum(user_bits != bits_out, axis=1)
            # replicate the full per-trial vector to every dp row so any
            # one addressable shard carries the global result
            return jax.lax.all_gather(errs, "dp", tiled=True)[None]

        _design_proto = [None]  # filled below before first trace
        fn = jax.jit(jax.shard_map(
            shard_fn, mesh=mesh, check_vma=False,
            in_specs=(P("dp"), P("dp"), P(), P(), P()),
            out_specs=P("dp")))
        if len(_CONCAT_MC_CACHE) >= _CONCAT_MC_CACHE_MAX:
            _CONCAT_MC_CACHE.pop(next(iter(_CONCAT_MC_CACHE)))
        _CONCAT_MC_CACHE[cfg] = (codec, fn, _design_proto)
    codec, fn, _design_proto = _CONCAT_MC_CACHE.pop(cfg)
    _CONCAT_MC_CACHE[cfg] = (codec, fn, _design_proto)  # refresh recency

    designs = [codec.build_design((seed, d)) for d in range(n_designs)]
    designs = designs[0].with_leaves(
        jnp.stack([d.idx for d in designs]),
        jnp.stack([d.signs for d in designs]))
    _design_proto[0] = designs
    root = rngmod.root_key(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(root, i))(
        jnp.arange(n_pad))
    didx = jnp.arange(n_pad, dtype=jnp.int32) % n_designs

    res = fn(keys, didx, designs.idx, designs.signs, jnp.float32(awgn_var))
    return np.asarray(res.addressable_shards[0].data)[0][:n_trials]


def concat_ber_point(sparc_params: SparcParams, ldpc_params: LdpcParams,
                     lengths, ldpc_protected: bool,
                     decode_params: DecodeParams, awgn_var: float, seed,
                     n_trials: int, decoder: str = "sequential",
                     mesh: Optional[jax.sharding.Mesh] = None) -> Dict:
    """One sweep point: mean/min/max BER over n_trials (the aggregation of
    performance_plots_general.py:120-126)."""
    from ..models.concat import ConcatCodec
    codec = ConcatCodec(sparc_params, ldpc_params, lengths, ldpc_protected)
    errs = concat_mc_trial_errors(
        sparc_params, ldpc_params, lengths, ldpc_protected, decode_params,
        awgn_var, seed, n_trials, decoder, mesh)
    bers = errs / codec.user_bits_len
    return {"ber": float(np.mean(bers)), "ber_min": float(np.min(bers)),
            "ber_max": float(np.max(bers)),
            "frame_errs": int(np.sum(errs > 0)), "frames": int(n_trials),
            "bit_errs": int(np.sum(errs)),
            "bits": int(n_trials * codec.user_bits_len)}


# --------------------------------------------------------------------------
# LDPC waterfall campaign (ldpc_awgn.py:60-123 semantics, batched + sharded)
# --------------------------------------------------------------------------

def _batch_counts(code, snr_db, keys_b, max_iters, dectype):
    """Encode/transmit per codeword (vmap), decode the whole batch in
    one batched BP call."""
    from ..ops.bp import bp_decode

    sigma2 = 1.0 / 10 ** (snr_db / 10.0)
    K, N = code.K, code.N

    def tx(key):
        ku, kn = jax.random.split(key)
        u = jax.random.bernoulli(ku, 0.5, (K,)).astype(jnp.int32)
        x = code.encode(u)
        xm = 1.0 - 2.0 * x  # BPSK (ldpc_awgn.py:55-57)
        y = xm + jnp.sqrt(sigma2) * jax.random.normal(kn, (N,))
        return x, 2.0 / sigma2 * y  # ch2llr (ldpc_awgn.py:51-53)

    xs, llrs = jax.vmap(tx)(keys_b)
    method = "minsum" if dectype == "minsum" else "sumprod"
    res = bp_decode(llrs.astype(jnp.float32), code.graph, max_iters,
                    method, 0.7)
    xh = (res.app < 0).astype(jnp.int32)
    biterrs = jnp.sum(xs != xh, axis=1)
    return biterrs, (biterrs > 0).astype(jnp.int32), res.iterations


@partial(jax.jit, static_argnames=("code", "batch", "max_iters", "dectype"))
def _batch_counts_jit(code, snr_db, root, ctr, batch, max_iters, dectype):
    # key derivation lives inside the program: the campaign loop then costs
    # ONE dispatch per batch (ctr and snr are traced scalars). The three
    # counters come back STACKED in one array, so the host loop makes
    # exactly one device->host transfer per batch.
    keys_b = jax.vmap(lambda i: jax.random.fold_in(root, i))(
        ctr + jnp.arange(batch))
    be, bl, it = _batch_counts(code, snr_db, keys_b, max_iters, dectype)
    return jnp.stack([jnp.sum(be), jnp.sum(bl), jnp.sum(it)])


@partial(jax.jit, static_argnames=("code", "max_iters", "dectype", "mesh"))
def _batch_counts_sharded_jit(code, snr_db, keys, max_iters, dectype, mesh):
    def shard_fn(snr_local, keys_local):
        be, bl, it = _batch_counts(code, snr_local, keys_local, max_iters,
                                   dectype)
        out = jnp.stack([jnp.sum(be), jnp.sum(bl), jnp.sum(it)])
        return jax.lax.psum(out, "dp")[None]

    return jax.shard_map(shard_fn, mesh=mesh, check_vma=False,
                         in_specs=(P(), P("dp")), out_specs=P("dp"))(
        snr_db, keys)


def _ldpc_block_counts(code: LdpcCode, snr_db: float, root, ctr: int,
                       batch: int, max_iters: int, dectype: str,
                       mesh: Optional[jax.sharding.Mesh]):
    """Decode one batch of random codewords at SNR (dB); returns
    (bit_errs, block_errs, iters) summed over trials ctr..ctr+batch.

    The BP call (ops/bp.py bp_decode) is the campaign's hot loop (the
    reference profile spends 29.47/30.45 s here,
    ldpc_jossy/data/1809301420_profile.txt). The jitted program is cached
    at module level with snr_db and the trial counter as TRACED arguments,
    so the campaign's thousands of batches per config compile exactly once
    (code/TannerGraph hash by identity; get_code returns cached
    instances) and cost one dispatch each."""
    snr_arr = jnp.float32(snr_db)
    if mesh is None:
        out = np.asarray(_batch_counts_jit(code, snr_arr, root,
                                           jnp.int32(ctr), batch, max_iters,
                                           dectype))
        return int(out[0]), int(out[1]), int(out[2])

    keys = jax.vmap(lambda i: jax.random.fold_in(root, i))(
        jnp.arange(ctr, ctr + batch))
    res = _batch_counts_sharded_jit(code, snr_arr, keys, max_iters, dectype,
                                    mesh)
    out = np.asarray(res.addressable_shards[0].data)[0]
    return int(out[0]), int(out[1]), int(out[2])


def ldpc_waterfall_campaign(ldpc_params: LdpcParams, seed: int = 0,
                            n_measurements: int = 24,
                            c_awgn_offset: float = 1.0, p_step: float = 100.0,
                            min_errors: int = 100, max_blocks: int = 400000,
                            batch: int = 128, dectype: str = "sumprod2",
                            max_iters: int = 200,
                            mesh: Optional[jax.sharding.Mesh] = None,
                            on_point=None, start_point: int = 0,
                            start_snr=None,
                            start_ctr: int = 0):
    """Adaptive-SNR BER waterfall measurement (sim(), ldpc_awgn.py:60-123).

    Per SNR point, decodes batches of `batch` random codewords until
    min_errors block errors (or max_blocks), then steps
    SNR += sqrt(p_step / nblocks) — the reference's heuristic (:116).
    `on_point(record, state)` is called after each measured point, for the
    resumable results store; the optional trailing `state` is the dict
    {"point", "next_snr", "ctr"} a resume needs (single-arg callbacks get
    just the record).

    Resume: pass start_point (first unmeasured point index), start_snr (the
    SNR that point should measure at) and start_ctr (the running key
    counter) — the values a ResultsStore recorded for the last measured
    point — and the campaign continues exactly where the crashed run
    stopped: same keys, same adaptive SNR trajectory, no duplicated points.

    Returns the list of NEWLY measured records in the reference's historical
    10-field tuple schema (standard, rate, z, ptype, SNR, nblocks,
    nblockerrors, nbits, nbiterrors, niters) — the data/results.txt:1 /
    results2csv.c:49-50 format.
    """
    import inspect
    from ..models.ldpc import get_code
    code = get_code(ldpc_params.standard, ldpc_params.rate, ldpc_params.z,
                    ldpc_params.ptype)
    R = ldpc_params.rate_float
    snr = 10.0 * np.log10(2.0 ** R - 1.0) + c_awgn_offset
    if start_snr is not None:
        snr = float(start_snr)
    root = rngmod.root_key(seed)
    records = []
    ctr = int(start_ctr)
    on_point_takes_ctr = (on_point is not None and
                          len(inspect.signature(on_point).parameters) >= 2)

    # Single-chip batches are double-buffered: the NEXT batch (same SNR,
    # next key-counter window) is dispatched before the current batch's
    # counters are read back, and each batch's counter array starts its
    # device->host copy IMMEDIATELY after its compute is enqueued
    # (copy_to_host_async) — otherwise the FIFO device stream queues the
    # read-back BEHIND the speculative batch. This hides one device->host
    # round trip per batch; its effect on the GPU is not yet measured.
    # When a point stops, the one speculative in-flight batch is discarded and
    # the key counter rewound to its start — the next point then consumes
    # exactly the key windows the serial loop would have: measured
    # records are BIT-IDENTICAL to the unpipelined loop
    # (tests/test_parallel.py::test_waterfall_campaign_pipeline_identical).
    # The mesh path keeps the serial read (its key derivation is host-side).
    def dispatch(snr_now, ctr0):
        if mesh is None:
            fut = _batch_counts_jit(code, jnp.float32(snr_now), root,
                                    jnp.int32(ctr0), batch, max_iters,
                                    dectype)
            fut.copy_to_host_async()
            return fut
        return None  # mesh path: computed synchronously in read()

    def read(fut, snr_now, ctr0):
        if mesh is None:
            out = np.asarray(fut)
            return int(out[0]), int(out[1]), int(out[2])
        return _ldpc_block_counts(code, snr_now, root, ctr0, batch,
                                  max_iters, dectype, mesh)

    for point in range(int(start_point), n_measurements):
        nbit = nblk = nblocks = nit = 0
        inflight = None  # (ctr0, future)
        while nblk < min_errors and nblocks < max_blocks:
            if inflight is None:
                inflight = (ctr, dispatch(snr, ctr))
                ctr += batch
            spec = (ctr, dispatch(snr, ctr))  # speculative, same SNR
            ctr += batch
            be, bl, it = read(inflight[1], snr, inflight[0])
            inflight = spec
            nbit += be
            nblk += bl
            nit += it
            nblocks += batch
        # the speculative batch belongs to this point's SNR; the next
        # point measures elsewhere — discard it and rewind the counter
        # (inflight is None only if the stop condition held immediately,
        # e.g. min_errors=0)
        if inflight is not None:
            ctr = inflight[0]
        rec = (ldpc_params.standard, ldpc_params.rate, ldpc_params.z,
               ldpc_params.ptype, float(snr), nblocks, nblk,
               nblocks * code.K, nbit, nit)
        records.append(rec)
        snr += float(np.sqrt(p_step / nblocks))
        if on_point is not None:
            if on_point_takes_ctr:
                on_point(rec, {"point": point, "next_snr": float(snr),
                               "ctr": ctr})
            else:
                on_point(rec)
    return records
