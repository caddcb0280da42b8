'''
Tensorized scan step: the full per-batch device computation -- exhaustive
match + mode gating + on-device coverage/mutation accumulation -- with no
host-side hit list.  This is the production path for large scans and the
unit that shards data-parallel across chips (kvarq_tpu.parallel).

Outputs per batch (all densely tensorized, psum-able across devices):

- ``basecount`` [5, G]: for every bank position, how many hit-overlap read
  bases of each kind (A C G T N) aligned there.  Depth is the channel sum;
  alternate-base (mutation) counts are the channels differing from the
  bank base.  Exactly reproduces Coverage.apply_hit accumulation
  (reference analyse.py:57-78) up to the in-memory ordering of mutation
  strings (which serialize sorted anyway, analyse.py:162-163).
- ``seqhits`` [T+1], ``seqbasehits`` [T+1]: per-template hit counts /
  overlap-base sums (last slot collects gap positions and is discarded).

Both accumulation contractions are one-hot correlations (plain matmuls);
mode weights replicate kvarq_tpu.engine.hitmodel exactly, including the
mode-B/D border duplicate (weight 2).
'''

import functools
import os

import numpy as np

from kvarq_tpu.engine import encode
from kvarq_tpu.engine.match_xla import _Bank


def build_bank(seqs, Lpad, minoverlap=None):
    return _Bank(seqs, Lpad, minoverlap)


def bank_device_arrays(bank, dtype=None):
    import jax
    import jax.numpy as jnp
    if dtype is None:
        from kvarq_tpu.device import compute_dtype
        dtype = compute_dtype()
    bank_oh = jax.nn.one_hot(jnp.asarray(bank.codes), encode.NBASE,
                             dtype=dtype).T                     # [5, G]
    return dict(
        bank_oh=bank_oh,
        d_of=jnp.asarray(bank.d_of),
        seql_of=jnp.asarray(bank.seql_of),
        tid=jnp.asarray(bank.tid),
        valid_q=jnp.asarray(bank.tid >= 0),
    )


def mode_weights(matches, rl_col, d_row, seql_row, valid_row,
                 maxerrors, minoverlap):
    '''
    mode gating shared by the XLA and screen scan paths: given match
    counts [B, Q] (any dtype holding exact integers), an i32 read-length
    column [B, 1] and i32 per-column metadata rows [1, Q], return
    ``(w, ov)`` -- i32 hit-mode weight (0/1/2, incl. the mode-B/D border
    duplicate) and i32 overlap length per (read, shift).  See
    kvarq_tpu.engine.hitmodel for the semantics
    (reference workhorse.c:1107-1174).

    All [B, Q]-sized arithmetic runs in f32 -- every quantity is an
    integer < 2^21, exact in f32.  Outputs cast back to i32 so
    downstream seqhits/seqbasehits accumulation stays exact past 2^24.
    '''
    import jax.numpy as jnp

    f32 = jnp.float32
    d = d_row.astype(f32)
    seql = seql_row.astype(f32)
    rl_ = rl_col.astype(f32)
    mo = float(minoverlap)

    # reduced closed form of the four-mode enumeration (see
    # kvarq_tpu.engine.hitmodel; exhaustively checked equivalent in
    # tests/test_tensor_scan.py::test_mode_weights_closed_form):
    #   C+D (containment)  <=>  ov == min(rl, seql)
    #   A                  <=>  ab and d < 0 and ov >= mo and ov != seql
    #   B                  <=>  ab and d > 0 and ov >= mo and d+rl >= seql
    # -- roughly half the per-element ops of the naive four-window
    # gating.
    t1 = d + rl_
    ov = jnp.minimum(seql, t1) - jnp.maximum(0., d)
    mism = ov - matches.astype(f32)

    ab = (rl_ > mo) & (seql > mo)
    govmo = ov >= mo
    wA = ab & (d < 0) & govmo & (ov != seql)
    wB = ab & (d > 0) & govmo & (t1 >= seql)
    full = ov == jnp.minimum(rl_, seql)

    passing = (valid_row > 0) & (rl_ > 0) & (mism <= maxerrors)
    nmodes = (wA.astype(f32) + wB.astype(f32) + full.astype(f32))
    w = jnp.where(passing, nmodes, 0.)
    return w.astype(jnp.int32), ov.astype(jnp.int32)


def scan_step_fn(Lpad, G, T, maxerrors, minoverlap, dtype_name='bfloat16',
                 axis_name=None, gather_k=None):
    '''
    build the jit-able scan step.

    :param axis_name: when set, the step runs under shard_map/pmap over
        that mesh axis and psums its outputs across it
    :param gather_k: when set, the (expensive) coverage-accumulation matmul
        runs only over up to ``gather_k`` *hitting* reads compacted on
        device -- hits are sparse in genome-scale FastQs -- with a
        ``lax.cond`` fallback to the full matmul when more reads hit
    :returns: step(codes [B, Lpad] uint8, rl [B] int32, bank arrays...) ->
        (basecount [5, G] f32, seqhits [T+1] i32, seqbasehits [T+1] i32)

    All arithmetic is integer-exact: match/overlap counts are < 2^24 so
    their f32 images are exact; one-hot inputs are exactly representable
    in bfloat16.
    '''
    import jax
    import jax.numpy as jnp
    from jax import lax

    in_dtype = jnp.dtype(dtype_name)
    L = Lpad
    Q = G + Lpad - 1

    def step(codes, rl, bank_oh, d_of, seql_of, tid, valid_q):
        read_oh = jax.nn.one_hot(codes, encode.NBASE, dtype=in_dtype)
        read_flat = read_oh.reshape(-1, L * encode.NBASE)   # [B, L*5]
        B = read_flat.shape[0]

        # im2col'd bank: K[(j,c), q] = bank_oh[c, q-(L-1)+j] -- built from
        # L static slices of the zero-padded bank, so both contractions
        # below are plain matmuls
        bankpad = jnp.pad(bank_oh, ((0, 0), (L - 1, L - 1)))  # [5, Q+L-1]
        K = jnp.stack([bankpad[:, j:j + Q] for j in range(L)])  # [L, 5, Q]
        K = K.reshape(L * encode.NBASE, Q)

        # 1) exhaustive match counts at every alignment
        matches = jnp.dot(read_flat, K,
                          preferred_element_type=jnp.float32)  # [B, Q]

        # 2) mode gating -- elementwise, fused by XLA into the matmul
        # consumers (see kvarq_tpu.engine.hitmodel for the semantics)
        w, ov = mode_weights(
            matches, rl[:, None].astype(jnp.int32), d_of[None, :],
            seql_of[None, :], valid_q[None, :].astype(jnp.int32),
            maxerrors, minoverlap)                            # [B, Q] f32

        # 3) per-template stats (mode weights/overlaps are exact int32)
        tseg = jnp.where(tid >= 0, tid, T)
        w_q = jnp.sum(w, axis=0)                              # [Q] i32
        wov_q = jnp.sum(w * ov, axis=0)
        seqhits = jax.ops.segment_sum(w_q, tseg, num_segments=T + 1)
        seqbasehits = jax.ops.segment_sum(wov_q, tseg, num_segments=T + 1)

        # 4) coverage accumulation: scatter each hit's read bases onto bank
        # positions -- one matmul plus a static diagonal fold.
        #   basecount[c, g] = sum_b sum_j w[b, g + L-1 - j] read_oh[b,j,c]
        def rtw_full(_):
            return jnp.dot(read_flat.T, w.astype(in_dtype),
                           preferred_element_type=jnp.float32)

        if gather_k is not None and gather_k < B:
            # compact the (sparse) hitting reads into gather_k slots
            hit_b = jnp.sum(w, axis=1) > 0                    # [B]
            count = jnp.sum(hit_b.astype(jnp.int32))
            (idx,) = jnp.nonzero(hit_b, size=gather_k, fill_value=0)
            fill = (jnp.arange(gather_k) < count).astype(in_dtype)
            rg = read_flat[idx] * fill[:, None]               # [k, L*5]
            wg = w[idx].astype(in_dtype) * fill[:, None]      # [k, Q]

            def rtw_gathered(_):
                return jnp.dot(rg.T, wg,
                               preferred_element_type=jnp.float32)

            RTw = lax.cond(count <= gather_k, rtw_gathered, rtw_full, None)
        else:
            RTw = rtw_full(None)

        RTw = RTw.reshape(L, encode.NBASE, Q)
        basecount = sum(RTw[j, :, L - 1 - j:L - 1 - j + G]
                        for j in range(L))                    # [5, G]

        if axis_name is not None:
            basecount = lax.psum(basecount, axis_name)
            seqhits = lax.psum(seqhits, axis_name)
            seqbasehits = lax.psum(seqbasehits, axis_name)
        return basecount, seqhits, seqbasehits

    return step


@functools.lru_cache(maxsize=None)
def _pack_fn():
    ''' jitted packer: (basecount f32 [5,G], seqhits i32 [T+1],
        seqbasehits i32 [T+1], candmax i32 scalar) -> one flat i32
        array (basecount bitcast, so all values round-trip exactly) '''
    import jax
    import jax.numpy as jnp

    def pack(bc, sh, sbh, cm):
        return jnp.concatenate([
            jax.lax.bitcast_convert_type(bc.reshape(-1), jnp.int32),
            sh, sbh, cm.reshape(1)])

    return jax.jit(pack)


def _pack_acc(bc, sh, sbh, cm):
    return _pack_fn()(bc, sh, sbh, cm)


def resolve_backend(backend=None):
    ''' tensor-scan step backend: the explicit argument, else
        ``$KVARQ_TENSOR_BACKEND``, else ``'screen'`` on an accelerator and
        ``'xla'`` on the CPU '''
    backend = backend or os.environ.get('KVARQ_TENSOR_BACKEND', 'auto')
    if backend in ('', 'auto'):
        from kvarq_tpu.device import accelerated
        backend = 'screen' if accelerated() else 'xla'
    if backend not in ('screen', 'xla'):
        raise ValueError('unknown tensor-scan backend %r (screen or xla)'
                         % backend)
    return backend


def default_gather_k():
    ''' resolve $KVARQ_GATHER_K: an explicit integer pins the compacted
        exact-scoring width; ``auto`` (the default) starts at 768 and
        lets TensorScanner adapt upward when the observed candidate
        count overflows it '''
    v = os.environ.get('KVARQ_GATHER_K', 'auto').strip().lower()
    if v in ('', 'auto'):
        return 768, True
    if v in ('0', 'off', 'dense'):
        return 0, False          # dense mode: no screen, exact full pass
    return int(v), False


@functools.lru_cache(maxsize=8)
def _cached_context(seqs, Lpad, maxerrors, minoverlap, backend, fuse,
                    gather_k=None):
    '''
    (bank, device arrays, jitted accumulate-step, device batch size) for a
    template bank + scan config.  Cached at module level so repeated scans
    in one process (CLI warmup + scan, GUI multi-file runs, benchmarks)
    reuse the compiled executable.

    The jitted step consumes ``fuse`` stacked sub-batches
    (``codes [fuse, sub, Lpad]``) per dispatch via ``lax.scan``.
    '''
    import jax

    from jax import lax

    from kvarq_tpu.jaxutil import ensure_compilation_cache
    ensure_compilation_cache()

    bank = build_bank(list(seqs), Lpad, minoverlap)
    T = len(seqs)
    if backend == 'screen':
        from kvarq_tpu.engine import screen_scan
        sub = 16384
        arrays = screen_scan.device_arrays(bank)
        # gather_k bounds the exact-scoring pass to the compacted
        # candidate reads; its two [gather_k, .] matmuls cost
        # 2*gather_k/sub of the screen's matmul.  768 sits above the
        # ~500 candidates per 16384 reads of unsieved data with 3% of
        # reads from template loci; overflow falls back to the exact
        # full-batch scoring pass, and TensorScanner adapts the width
        # upward from the observed candidate counts (with_count)
        if gather_k is None:
            gather_k = default_gather_k()[0]
        step = screen_scan.scan_step(
            Lpad, bank, T, maxerrors, minoverlap, sub,
            gather_k=gather_k, with_count=True)
    else:
        from kvarq_tpu.device import compute_dtype
        arrays = bank_device_arrays(bank)
        sub = max(64, min(8192,
                          TensorScanner.ELEM_BUDGET // max(bank.Q, 1)))
        gather_k = max(128, sub // 8)
        step = scan_step_fn(Lpad, bank.G, T, maxerrors, minoverlap,
                            dtype_name=compute_dtype(),
                            gather_k=gather_k)

    def step_acc(codes, rl, acc_bc, acc_sh, acc_sbh, acc_cm, **arrays):
        import jax.numpy as jnp

        def body(carry, xs):
            bc, sh, sbh, cm = carry
            out = step(xs[0], xs[1], **arrays)
            if len(out) == 4:              # screen: candidate count
                dbc, dsh, dsbh, count = out
            else:
                dbc, dsh, dsbh = out
                count = jnp.zeros((), dtype=jnp.int32)
            return (bc + dbc, sh + dsh, sbh + dsbh,
                    jnp.maximum(cm, count)), None
        carry, _ = lax.scan(body, (acc_bc, acc_sh, acc_sbh, acc_cm),
                            (codes, rl))
        return carry

    return (bank, arrays, jax.jit(step_acc, donate_argnums=(2, 3, 4, 5)),
            sub)


class TensorScanner:
    ''' single-device scan driver: accumulates bank-position base counts
        and per-template stats over many batches.

        All accumulation happens *on device* in donated buffers -- the
        steady-state loop uploads read batches and never transfers results
        back, so device dispatch pipelines fully.  Accumulators are
        flushed to exact host int64 every :py:data:`FLUSH_STEPS` steps,
        far below any f32/i32 exactness/overflow bound.

        Two step backends: ``screen`` (the accelerator default --
        :py:mod:`kvarq_tpu.engine.screen_scan`, candidate screen over a
        host-built im2col bank) and ``xla`` (the CPU default --
        :py:func:`scan_step_fn`, exact gating of every read under a
        fixed element budget). '''

    # cap on B*Q f32 elements materialized per xla-backend step (the
    # [B, Q] matches tensor)
    ELEM_BUDGET = 96 * 1024 * 1024
    FLUSH_STEPS = 64

    def __init__(self, seqs, maxerrors, minoverlap, backend=None):
        import os
        self.seqs = list(seqs)
        self.maxerrors = maxerrors
        self.minoverlap = minoverlap
        self.T = len(self.seqs)
        self.backend = resolve_backend(backend)
        # sub-batches fused into one device dispatch (lax.scan)
        self.fuse = int(os.environ.get('KVARQ_FUSE_STEPS', '1'))
        # compacted exact-scoring width (screen): start at 768; in auto
        # mode the observed per-dispatch candidate
        # count (piggybacked on the accumulator) grows it when a
        # workload is hit-dense enough to overflow -- each overflowed
        # dispatch pays the full-batch scoring fallback, so a persistent
        # overflow is worth one recompile
        self.gather_k, self._gather_auto = default_gather_k()
        self._ctx = {}
        self.reset()

    def assume_dense(self):
        ''' declare the input candidate-dense up front (sieve-fed scans:
            batches are packed with ONLY sieve-surviving reads, so
            nearly every row flags) -- go straight to dense mode
            instead of paying one discovery dispatch + context rebuild
            per scan.  No-op when gather_k was pinned explicitly. '''
        if self._gather_auto and self.backend == 'screen' \
                and not self._ctx:
            self.gather_k = 0

    def reset(self):
        self.basecounts = {}   # Lpad -> accumulated [5, G] numpy float64
        self.seqhits = np.zeros(self.T, dtype=np.int64)
        self.seqbasehits = np.zeros(self.T, dtype=np.int64)
        for ctx in self._ctx.values():
            ctx['acc'] = None
            ctx['steps'] = 0
            ctx['pending'] = []

    def _context(self, Lpad):
        if Lpad not in self._ctx:
            bank, arrays, step, sub = _cached_context(
                tuple(self.seqs), Lpad, self.maxerrors, self.minoverlap,
                self.backend, self.fuse, self.gather_k)
            self._ctx[Lpad] = dict(
                bank=bank, arrays=arrays, sub=sub, step=step,
                acc=None, steps=0, pending=[], peeked=False)
        return self._ctx[Lpad]

    # gather_k growth buckets; a workload overflowing even the last
    # bucket goes terminally to dense mode (gather_k 0: the screen and
    # compaction are dropped, every dispatch runs the exact
    # full-batch pass directly)
    GATHER_BUCKETS = (768, 1536, 3072, 6144)

    def _adapt_gather(self, Lpad, candmax):
        ''' grow gather_k when the observed per-dispatch candidate count
            overflows it (auto mode); returns True when the context was
            rebuilt (recompile -- amortized by the persistent cache) '''
        if not self._gather_auto or self.backend != 'screen':
            return False
        if self.gather_k == 0:
            return False         # dense mode is terminal
        want = int(candmax + 8 * np.sqrt(max(candmax, 1)) + 64)
        if want <= self.gather_k:
            return False
        new = next((b for b in self.GATHER_BUCKETS if b >= want), 0)
        if new and new <= self.gather_k:
            return False
        from kvarq_tpu.log import lo
        lo.info('gather_k %d -> %s (observed %d candidates/dispatch)'
                % (self.gather_k, new if new else 'dense',
                   candmax))
        self.gather_k = new
        for lp in list(self._ctx):
            # flush accumulators into the host state, then rebuild the
            # context IN PLACE against the new width -- deleting entries
            # would break finalize()/coverages(), which dereference
            # self._ctx[Lpad] for every Lpad already scanned
            self._dispatch(lp)
            self._flush(lp, adapt=False)
            bank, arrays, step, sub = _cached_context(
                tuple(self.seqs), lp, self.maxerrors, self.minoverlap,
                self.backend, self.fuse, self.gather_k)
            self._ctx[lp].update(bank=bank, arrays=arrays, step=step,
                                 sub=sub, acc=None, steps=0, pending=[])
        return True

    def _zero_acc(self, ctx):
        import jax.numpy as jnp
        return (jnp.zeros((encode.NBASE, ctx['bank'].G),
                          dtype=jnp.float32),
                jnp.zeros(self.T + 1, dtype=jnp.int32),
                jnp.zeros(self.T + 1, dtype=jnp.int32),
                jnp.zeros((), dtype=jnp.int32))

    def _dispatch(self, Lpad):
        ''' stack the pending sub-batches (padding with empty reads up to
            the fused shape) and run one accumulate-step dispatch '''
        import jax
        ctx = self._ctx[Lpad]
        pending = ctx['pending']
        if not pending:
            return
        sub = ctx['sub']
        while len(pending) < self.fuse:
            pending.append((
                np.full((sub, Lpad), encode.CODE_READ_JUNK, dtype=np.uint8),
                np.zeros(sub, dtype=np.int32)))
        codes = np.stack([c for c, _ in pending])
        rl = np.stack([r for _, r in pending])
        ctx['pending'] = []
        if ctx['acc'] is None:
            ctx['acc'] = self._zero_acc(ctx)
        # device_put dispatches the upload asynchronously, so the next
        # batches parse on host while this one transfers + computes
        ctx['acc'] = ctx['step'](
            jax.device_put(codes), jax.device_put(rl), *ctx['acc'],
            **ctx['arrays'])
        ctx['steps'] += self.fuse
        if self._gather_auto and self.gather_k and not ctx['peeked']:
            # one early candidate-count peek per context (a single
            # scalar readback): a hit-dense workload overflows from the
            # very first dispatch, and adapting now saves paying the
            # full-batch fallback for all of FLUSH_STEPS dispatches
            ctx['peeked'] = True
            candmax = int(np.asarray(ctx['acc'][3]))
            if self._adapt_gather(Lpad, candmax):
                return
        if ctx['steps'] >= self.FLUSH_STEPS:
            self._flush(Lpad)

    def _flush(self, Lpad, adapt=True):
        ''' move device accumulators into the exact host-side int64/float64
            accumulators.  The accumulators are packed into ONE flat
            device array first, so the readback is a single transfer. '''
        ctx = self._ctx[Lpad]
        if ctx['acc'] is None:
            return
        acc_bc, acc_sh, acc_sbh, acc_cm = ctx['acc']
        flat = np.asarray(_pack_acc(acc_bc, acc_sh, acc_sbh, acc_cm))
        nbc = acc_bc.size
        host = self.basecounts.setdefault(
            Lpad, np.zeros((encode.NBASE, ctx['bank'].G), dtype=np.float64))
        host += flat[:nbc].view(np.float32).astype(np.float64) \
            .reshape(host.shape)
        self.seqhits += flat[nbc:nbc + self.T].astype(np.int64)
        self.seqbasehits += \
            flat[nbc + self.T + 1:nbc + 2 * self.T + 1].astype(np.int64)
        candmax = int(flat[-1])
        ctx['acc'] = None
        ctx['steps'] = 0
        if adapt:
            self._adapt_gather(Lpad, candmax)

    def finalize(self):
        ''' dispatch any buffered sub-batches and flush all device
            accumulators; must be called before reading
            ``seqhits``/``seqbasehits``/:py:meth:`coverages` '''
        for Lpad in list(self._ctx):
            self._dispatch(Lpad)
            self._flush(Lpad)

    def scan_batch(self, batch):
        B, Lpad = batch.codes.shape
        ctx = self._context(Lpad)
        if ctx['bank'].G == 0:
            return
        sub = ctx['sub']
        for lo_ in range(0, B, sub):
            hi = min(B, lo_ + sub)
            codes, rl = encode.pad_batch(
                batch.codes[lo_:hi], batch.rl[lo_:hi], sub, Lpad)
            ctx['pending'].append((codes, rl))
            if len(ctx['pending']) >= self.fuse:
                self._dispatch(Lpad)

    def coverages(self):
        '''
        :returns: list (per template, in ``seqs`` order) of base-count
            arrays [5, S] in template-local coordinates, summed over all
            processed batches
        '''
        self.finalize()
        per_template = [np.zeros((encode.NBASE, len(s)), dtype=np.float64)
                        for s in self.seqs]
        for Lpad, acc in self.basecounts.items():
            tstart = self._ctx[Lpad]['bank'].tstart
            for t, s in enumerate(self.seqs):
                pos = tstart[t]
                per_template[t] += acc[:, pos:pos + len(s)]
        return per_template


# complement channel permutation: A<->T, C<->G, N->N (genes.py COMPLEMENT)
COMPL_PERM = np.array([encode.T, encode.G, encode.C, encode.A, encode.N])

# channel enumeration in sorted-character order 'ACGNT', so mutation strings
# come out pre-sorted exactly like Coverage.serialize() emits them
# (reference analyse.py:162-163 sorts the observed bases)
_SORTED_CHANNELS = sorted(range(encode.NBASE), key=lambda c: encode.BASE_CHARS[c])


def fold_into_coverage(cov, plus_bc, minus_bc):
    '''
    fill a :py:class:`kvarq_tpu.analyse.Coverage` from tensorized base
    counts: ``plus_bc``/``minus_bc`` are [5, S] hit-overlap base counts in
    scanned-strand coordinates for the plus/minus template strands.

    Reproduces Coverage.apply_hit (reference analyse.py:57-78): minus-strand
    counts are mapped back to plus coordinates via index reversal + base
    complement; depth is the channel sum; every read base differing from the
    template base becomes a mutation entry.  Mutation strings are built in
    sorted order -- in-memory ordering differs from the (observation-ordered)
    hit path but serializes identically and all statistics
    (bases_at/fractions_at/...) are order-insensitive.
    '''
    total = np.asarray(plus_bc, dtype=np.int64).copy()
    if minus_bc is not None:
        total += np.asarray(minus_bc, dtype=np.int64)[COMPL_PERM][:, ::-1]

    depth = total.sum(axis=0)
    cov.coverage = [int(x) for x in depth]

    tmpl = encode.encode_template(cov.plus_seq.bases)
    mutations = {}
    # mutation counts = all channels except the template's own base
    mut_total = depth - np.where(
        tmpl < encode.NBASE,
        total[np.minimum(tmpl, encode.NBASE - 1), np.arange(len(tmpl))], 0)
    for j in np.flatnonzero(mut_total):
        parts = []
        for c in _SORTED_CHANNELS:
            if c == tmpl[j]:
                continue
            n = int(total[c, j])
            if n:
                parts.append(encode.BASE_CHARS[c] * n)
        mutations[int(j)] = ''.join(parts)
    cov.mutations = mutations
