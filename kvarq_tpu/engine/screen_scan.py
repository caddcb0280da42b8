'''
Candidate-screen scan step over a precomputed im2col bank, with exact
statistics and coverage computed over the (sparse) candidate reads.

The bank is one-hot encoded and unrolled once on the host into
``K [Lpad*nch, Q]`` (:py:func:`build_K_np`), so a batch's match counts at
every alignment are one matmul ``read_flat @ K``.

**The screen.**  :py:func:`screen_counts` evaluates one sound candidate
predicate per (read, shift column)

    cand' = matches >= max(ov, tau) - maxerrors

with ``ov = min(rl + dm, ovc)`` (from precomputed per-column
``dm = min(d, 0)``, ``ovc = seql - max(0, d)``) and the threshold
``tau = min(minoverlap, rl, seql)``.  Soundness: any reference hit mode
requires either overlap >= minoverlap (modes A/B) or full containment
``ov == min(rl, seql)`` (modes C/D, which have *no* minoverlap bound);
since ``ov <= min(rl, seql)`` always, both cases are exactly
``ov >= tau`` together with ``ov - matches <= maxerrors`` -- and that
exact predicate implies ``max(ov, tau) = ov``, so cand' is a superset.
The relaxation (flagging ``ov < tau`` when ``matches >= tau - e``)
admits only near-perfect sub-threshold overlaps -- vanishing on real
data -- and flagged reads are re-scored exactly anyway.  Padded rows
get an infinite row threshold (rl == 0), padded/gap columns an ``ovc``
of -2^20 and an infinite ``tau`` (their K columns are all-zero, so
``matches == 0``).  All thresholds are integers < 2^21, exact in f32.

The flagged reads (true hits plus a vanishing number of near-miss false
positives -- a random 25-mer overlap passes only with >= 23/25 identity)
are compacted by :py:func:`scan_step_banked` and re-scored *exactly*
with the shared :py:func:`kvarq_tpu.engine.tensor_scan.mode_weights` on a
small ``[gather_k, Q]`` recompute, which yields the per-template
seqhits/seqbasehits statistics AND the coverage contraction in one place
(a ``lax.cond`` falls back to the all-reads contraction when more than
``gather_k`` reads flag).  Output is bit-identical to the XLA and numpy
matchers (exact integer counts); tests/test_screen_scan.py asserts it.

When the bank contains no ``N`` the one-hot narrows to 4 channels: a
read ``N`` then one-hots to the zero vector and mismatches everywhere,
which is exact since nothing in the bank could match it -- a 20% FLOP cut
on N-free banks (the norm).

Replicates the reference hot loop semantics (workhorse.c:1107-1174) via
the shared mode-weight formulas in kvarq_tpu.engine.tensor_scan.
'''

import numpy as np

from kvarq_tpu.engine import encode

# rows of the packed [NROWS, Q] int32 per-column metadata.  Rows 0-2
# feed the exact mode_weights recompute; rows 3-4 are the candidate
# screen's precomputations: DM = min(d, 0) (the read-side offset of the
# overlap window) and OVC = seql - max(0, d) (the column part of the
# overlap length), set to -2^20 on invalid/padded columns so the overlap
# goes so negative that the screen can never pass there.
ROW_D, ROW_SEQL, ROW_VALID, ROW_DM, ROW_OVC = range(5)
NROWS = 5
INVALID_OVC = -(1 << 20)
BIG_RL_THRESHOLD = 1 << 20


def bank_channels(bank_codes):
    ''' one-hot channels needed to match this bank exactly: 4 (ACGT) when
        the bank is N-free -- read N one-hots to zero and thus mismatches,
        which is exact since nothing in the bank could match it -- else
        the full 5 '''
    return encode.NBASE if (np.asarray(bank_codes) == encode.N).any() \
        else encode.NBASE - 1


def pack_qmeta(bank, Qp=None):
    ''' per-shift-column metadata as one [NROWS, Qp] int32 array (rows:
        see the ROW_* constants); columns past ``bank.Q`` are invalid '''
    Q = bank.Q
    if Qp is None:
        Qp = Q
    qmeta = np.zeros((NROWS, Qp), dtype=np.int32)
    qmeta[ROW_SEQL, :] = 1
    qmeta[ROW_D, :Q] = bank.d_of
    qmeta[ROW_SEQL, :Q] = bank.seql_of
    valid = np.zeros(Qp, dtype=bool)
    valid[:Q] = bank.tid >= 0
    qmeta[ROW_VALID] = valid
    qmeta[ROW_DM] = np.where(valid, np.minimum(0, qmeta[ROW_D]), 0)
    qmeta[ROW_OVC] = np.where(
        valid, qmeta[ROW_SEQL] - np.maximum(0, qmeta[ROW_D]), INVALID_OVC)
    return qmeta


def pack_tseg(bank, T, Qp=None):
    ''' Q -> template-id segment map padded to Qp (invalid columns map to
        the discard segment T) '''
    if Qp is None:
        Qp = bank.Q
    tseg = np.full(Qp, T, dtype=np.int32)
    tseg[:bank.Q] = np.where(bank.tid >= 0, bank.tid, T)
    return tseg


def build_K_np(bank_codes, Lpad, Qp, nch=None):
    ''' im2col'd one-hot bank: K[(j,c), q] = onehot(bank[q-(Lpad-1)+j])[c],
        zero past the real Q -- padded columns carry OVC=-2^20 and can
        never flag.  bf16 (exact for one-hots); ``nch`` channels (see
        :py:func:`bank_channels`).  Built once per bank on the host, so
        no jit graph carries the ``Lpad`` shifted slices. '''
    import ml_dtypes
    if nch is None:
        nch = bank_channels(bank_codes)
    G = len(bank_codes)
    oh = np.zeros((nch, G + 2 * (Lpad - 1) + (Qp - G - Lpad + 1)),
                  dtype=np.float32)
    for c in range(nch):
        oh[c, Lpad - 1:Lpad - 1 + G] = (bank_codes == c)
    K = np.empty((Lpad, nch, Qp), dtype=np.float32)
    for j in range(Lpad):
        K[j] = oh[:, j:j + Qp]
    return K.reshape(Lpad * nch, Qp).astype(ml_dtypes.bfloat16)


def screen_counts(read_flat, rl, K, qmeta, maxerrors, minoverlap):
    '''
    per-read number of shift columns passing the candidate screen (see
    module docstring): ``read_flat [B, Lpad*nch]`` one-hot, ``rl [B]``,
    ``K [Lpad*nch, Qp]`` (same dtype as ``read_flat``), ``qmeta
    [NROWS, Qp]`` i32 -> ``[B]`` i32.  Every read with a hit has a
    nonzero count.
    '''
    import jax.numpy as jnp

    f32 = jnp.float32
    matches = jnp.dot(read_flat, K, preferred_element_type=f32)  # [B, Qp]
    rl = rl.astype(jnp.int32)[:, None]                           # [B, 1]
    dm = qmeta[ROW_DM][None, :]                                  # [1, Qp]
    ovc = qmeta[ROW_OVC][None, :]
    seql = qmeta[ROW_SEQL][None, :]
    valid = qmeta[ROW_VALID][None, :]

    # row/column pieces with maxerrors folded in: [B, 1] / [1, Qp] work
    # next to the [B, Qp] compare
    rlmo_e = (jnp.where(rl > 0, jnp.minimum(rl, minoverlap),
                        BIG_RL_THRESHOLD) - maxerrors).astype(f32)
    dm_e = (dm - maxerrors).astype(f32)
    ovc_e = (ovc - maxerrors).astype(f32)   # -2^20 on padded columns
    # invalid/padded columns keep an unreachable threshold: their K
    # columns are all-zero (matches == 0), so force tau there
    seql_e = jnp.where(valid > 0, (seql - maxerrors).astype(f32),
                       float(BIG_RL_THRESHOLD))

    #   cand' = matches >= max(min(rl + dm - e, ovc - e),
    #                          min(rl, mo, seql) - e)
    ov_e = jnp.minimum(rl.astype(f32) + dm_e, ovc_e)
    tau_e = jnp.minimum(rlmo_e, seql_e)
    cand = matches >= jnp.maximum(ov_e, tau_e)
    return jnp.sum(cand, axis=1, dtype=jnp.int32)


def device_arrays(bank):
    ''' device-resident bank data for :py:func:`scan_step`: the im2col'd
        K matrix (in the device's compute dtype) and packed q metadata '''
    import jax
    import jax.numpy as jnp
    from kvarq_tpu.device import compute_dtype
    qmeta = pack_qmeta(bank)
    K = build_K_np(bank.codes, bank.Lpad, qmeta.shape[1])
    return dict(K=jax.device_put(K.astype(compute_dtype())),
                qmeta=jnp.asarray(qmeta))


def scan_step(Lpad, bank, T, maxerrors, minoverlap, B,
              gather_k=768, with_count=False):
    '''
    full screen-backed scan step with the same contract as
    tensor_scan.scan_step_fn: ``step(codes [B, Lpad] u8, rl [B] i32,
    K, qmeta) -> (basecount [5, G] f32, seqhits [T+1] i32,
    seqbasehits [T+1] i32)``.

    The screen flags candidate reads; statistics AND coverage come from
    a second pass restricted to the (compacted, sparse) candidates, with
    a ``lax.cond`` fallback to the all-reads contraction when more than
    ``gather_k`` reads flag.
    '''
    tseg_np = pack_tseg(bank, T)
    inner = scan_step_banked(Lpad, bank.G, T, maxerrors, minoverlap, B,
                             gather_k,
                             nch=bank_channels(bank.codes),
                             with_count=with_count)

    def step(codes, rl, K, qmeta):
        import jax.numpy as jnp
        return inner(codes, rl, K, qmeta, jnp.asarray(tseg_np))

    return step


def scan_step_banked(Lpad, G, T, maxerrors, minoverlap, B,
                     gather_k=768, nch=encode.NBASE, with_count=False):
    '''
    bank-agnostic variant of :py:func:`scan_step`: all bank data (K,
    qmeta, tseg; ``Qp = G + Lpad - 1`` columns) are runtime arguments,
    so the same traced program can run on different (equally-shaped)
    per-shard sub-banks under ``shard_map`` (kvarq_tpu.parallel).
    ``nch`` must match the channel count K was built with
    (:py:func:`bank_channels`).
    '''
    import jax
    import jax.numpy as jnp
    from jax import lax
    from kvarq_tpu.engine.tensor_scan import mode_weights

    # dense mode (gather_k 0/None): hit-dense workloads where virtually
    # every read is a candidate -- the screen and the compaction are
    # pure overhead there, so the step is just the exact full-batch
    # scoring pass.  TensorScanner switches here terminally when the
    # observed candidate count overflows every gather bucket.
    dense = not gather_k or gather_k >= B
    gather_k = min(gather_k or B, B)
    Qp = G + Lpad - 1

    def fold(RTw):
        RTw = RTw.reshape(Lpad, encode.NBASE, Qp)
        return sum(RTw[j, :, Lpad - 1 - j:Lpad - 1 - j + G]
                   for j in range(Lpad))                     # [5, G]

    def step(codes, rl, K, qmeta, tseg):
        dt = K.dtype
        read_flat = jax.nn.one_hot(codes, nch, dtype=dt) \
            .reshape(-1, Lpad * nch)
        rl = rl.astype(jnp.int32)
        # exact stats + coverage over the compacted candidate reads
        # (sparse in real data); the coverage pass one-hots the full 5
        # channels -- read N bases count as coverage + mutations --
        # against K's nch channels for matching
        meta = (qmeta[ROW_D:ROW_D + 1], qmeta[ROW_SEQL:ROW_SEQL + 1],
                qmeta[ROW_VALID:ROW_VALID + 1])

        def score(rf, codes_, rl_col, fill=None):
            m = jnp.dot(rf, K, preferred_element_type=jnp.float32)
            w, ov = mode_weights(m, rl_col, *meta, maxerrors, minoverlap)
            read5 = jax.nn.one_hot(codes_, encode.NBASE, dtype=dt) \
                .reshape(len(rf), Lpad * encode.NBASE)
            if fill is not None:
                read5 = read5 * fill[:, None].astype(dt)
            RTw = jnp.dot(read5.T, w.astype(dt),
                          preferred_element_type=jnp.float32)
            return RTw, jnp.sum(w, axis=0), jnp.sum(w * ov, axis=0)

        def score_full(_):
            return score(read_flat, codes, rl[:, None])

        if dense:
            count = jnp.zeros((), dtype=jnp.int32)
            RTw, w_q, wov_q = score_full(None)
        else:
            hit_b = screen_counts(read_flat, rl, K, qmeta, maxerrors,
                                  minoverlap) > 0            # [B]
            count = jnp.sum(hit_b.astype(jnp.int32))
            (idx,) = jnp.nonzero(hit_b, size=gather_k, fill_value=0)
            fill = jnp.arange(gather_k) < count
            rg = read_flat[idx] * fill[:, None].astype(dt)
            rlg = (rl[idx] * fill)[:, None]

            def score_gathered(_):
                return score(rg, codes[idx], rlg, fill)

            RTw, w_q, wov_q = lax.cond(count <= gather_k,
                                       score_gathered, score_full, None)
        seqhits = jax.ops.segment_sum(w_q, tseg, num_segments=T + 1)
        seqbasehits = jax.ops.segment_sum(wov_q, tseg, num_segments=T + 1)
        bc = fold(RTw).astype(jnp.float32)
        if with_count:
            # per-dispatch candidate count: drives TensorScanner's
            # adaptive gather_k (piggybacked on the accumulator flush,
            # zero extra round trips)
            return bc, seqhits, seqbasehits, count
        return bc, seqhits, seqbasehits

    return step
