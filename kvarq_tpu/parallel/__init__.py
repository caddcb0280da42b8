'''
Multi-device scale-out over a ``jax.sharding.Mesh``.

The reference scales with pthreads over a shared FastQ stream plus
mutex-guarded shared counters (csrc/workhorse.c:1375-1408, :78-83); batch
level scale-out is manual shell loops (docs/tutorial.rst:366-374).  The
equivalent implemented here shards the tensorized scan step
(kvarq_tpu.engine.tensor_scan) over a 2-D device mesh.  The mesh follows
the algorithm alone (every card of a host reaches every other at the same
rate); collectives go over NCCL on GPUs:

- ``data`` axis: read batches are sharded data-parallel; per-template
  statistics are merged with ``psum`` -- replacing the reference's
  ``ll_mutex``-guarded hit accumulation with a collective reduction.  The
  reference's own ``findseqs(f) == findseqs([f1,f2])`` invariant
  (tests/test_engine.py:184-205) licenses offset-independent merging.
- ``bank`` axis: the template bank is sharded template-parallel (the
  tensor-parallel analog): each shard matches all its reads against a
  subset of the templates; per-template outputs need no reduction (they
  are disjoint) and global stat vectors are psum-merged since shards hold
  zeros outside their template range.

Single-device results are bitwise-identical to multi-device results by
construction: every (read, template) pair is scanned on exactly one shard
and all accumulation is integer-exact.
'''

import numpy as np

from kvarq_tpu.engine import encode
from kvarq_tpu.engine.match_xla import _Bank
from kvarq_tpu.engine.tensor_scan import scan_step_fn


def make_mesh(n_data=None, n_bank=1, devices=None):
    ''' build a 2-D ('data', 'bank') mesh over the given (default: all)
        devices '''
    import jax
    if devices is None:
        devices = jax.devices()
    if n_data is None:
        n_data = len(devices) // n_bank
    n = n_data * n_bank
    arr = np.asarray(devices[:n]).reshape(n_data, n_bank)
    return jax.sharding.Mesh(arr, ('data', 'bank'))


def parse_mesh(spec):
    ''' mesh from a CLI/env spec: ``auto`` = all devices on the data axis,
        ``NDxNB`` = explicit ('data', 'bank') shape (e.g. ``4x2``) '''
    spec = str(spec).strip().lower()
    if spec == 'auto':
        return make_mesh()
    try:
        n_data, _, n_bank = spec.partition('x')
        return make_mesh(int(n_data), int(n_bank) if n_bank else 1)
    except (TypeError, ValueError):
        raise ValueError('mesh spec must be "auto" or "NDxNB" (e.g. 4x2), '
                         'got %r' % spec)


def split_templates(nseqs, n_bank):
    ''' contiguous template ranges [(lo, hi)...] per bank shard '''
    per = (nseqs + n_bank - 1) // n_bank
    return [(min(i * per, nseqs), min((i + 1) * per, nseqs))
            for i in range(n_bank)]


class ShardBank:
    ''' per-bank-shard template sub-banks, padded to a common width G so
        they stack into one [n_bank, ...] device array.  ``tid`` uses
        *global* template numbering so per-shard stat vectors psum-merge
        into the global ones. '''

    def __init__(self, seqs, Lpad, n_bank, minoverlap=None):
        self.Lpad = Lpad
        self.n_bank = n_bank
        self.ranges = split_templates(len(seqs), n_bank)
        banks = [_Bank(seqs[lo:hi], Lpad, minoverlap)
                 for lo, hi in self.ranges]
        self.G = max(b.G for b in banks) if banks else 0
        self.sub = banks

        def pad(a, fill):
            out = np.full((self.G,) + a.shape[1:], fill, dtype=a.dtype)
            out[:len(a)] = a
            return out

        codes, tid, d_of, seql_of = [], [], [], []
        for (lo, hi), b in zip(self.ranges, banks):
            gtid = b.tid.copy()
            gtid[gtid >= 0] += lo
            q_fill = self.G + Lpad - 1
            codes.append(np.pad(b.codes, (0, self.G - b.G),
                                constant_values=encode.CODE_TMPL_JUNK))
            tid.append(np.pad(gtid, (0, q_fill - b.Q), constant_values=-1))
            d_of.append(np.pad(b.d_of, (0, q_fill - b.Q)))
            seql_of.append(np.pad(b.seql_of, (0, q_fill - b.Q),
                                  constant_values=1))
        self.codes = np.stack(codes)        # [n_bank, G]
        self.tid = np.stack(tid)            # [n_bank, Q]
        self.d_of = np.stack(d_of)
        self.seql_of = np.stack(seql_of)

    def device_arrays(self, mesh):
        ''' one-hot bank + per-column metadata for
            :py:func:`sharded_scan_step`, placed sharded over ``mesh``'s
            'bank' axis '''
        import jax
        import jax.numpy as jnp
        from kvarq_tpu.device import compute_dtype
        bank_oh = jax.nn.one_hot(jnp.asarray(self.codes), encode.NBASE,
                                 dtype=compute_dtype())      # [nb, G, 5]
        return _put_bank(mesh, dict(
            bank_oh=jnp.transpose(bank_oh, (0, 2, 1)),      # [nb, 5, G]
            d_of=self.d_of, seql_of=self.seql_of, tid=self.tid,
            valid_q=self.tid >= 0))

    def channels(self):
        ''' one-hot channel count, consistent over all shards '''
        from kvarq_tpu.engine import screen_scan
        return screen_scan.bank_channels(self.codes)

    def screen_device_arrays(self, mesh, T):
        ''' per-shard K / qmeta / tseg stacked to [n_bank, ...] over the
            common width Qp = G + Lpad - 1, placed sharded over
            ``mesh``'s 'bank' axis; tseg uses global template numbering '''
        from kvarq_tpu.device import compute_dtype
        from kvarq_tpu.engine import screen_scan

        Qp = self.G + self.Lpad - 1
        nch = self.channels()
        Ks, qmetas, tsegs = [], [], []
        for (lo, hi), b in zip(self.ranges, self.sub):
            Ks.append(screen_scan.build_K_np(b.codes, self.Lpad, Qp,
                                             nch=nch))
            qmetas.append(screen_scan.pack_qmeta(b, Qp=Qp))
            tseg = screen_scan.pack_tseg(b, T, Qp=Qp)
            tseg[tseg != T] += lo
            tsegs.append(tseg)
        return _put_bank(mesh, dict(
            K=np.stack(Ks).astype(compute_dtype()),  # [nb, L*nch, Qp]
            qmeta=np.stack(qmetas),                  # [nb, NROWS, Qp]
            tseg=np.stack(tsegs),                    # [nb, Qp]
        ))


def _put_bank(mesh, arrays):
    ''' place [n_bank, ...] arrays sharded over the mesh's 'bank' axis
        (replicated over 'data'), once, so no step re-shards them '''
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    sharding = NamedSharding(mesh, P('bank'))
    return {k: jax.device_put(v, sharding) for k, v in arrays.items()}


def _put_data(mesh, *arrays):
    ''' place host read batches sharded over the mesh's 'data' axis '''
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    sharding = NamedSharding(mesh, P('data'))
    return [jax.device_put(a, sharding) for a in arrays]


def sharded_scan_step(mesh, Lpad, G, T, maxerrors, minoverlap,
                      dtype_name='bfloat16'):
    '''
    jit-compiled shard_map'd scan step over ``mesh``:

    ``step(codes [B, Lpad], rl [B], **bank arrays [n_bank, ...]) ->
    (basecount [n_bank, 5, G], seqhits [T+1], seqbasehits [T+1])``

    ``B`` must be divisible by the data-axis size (pad with rl=0 rows).
    basecount stays sharded over 'bank' (disjoint templates); the stat
    vectors are psum'd over both axes and come back fully replicated.
    '''
    import jax
    from jax import lax
    from jax.sharding import PartitionSpec as P

    inner = scan_step_fn(Lpad, G, T, maxerrors, minoverlap,
                         dtype_name=dtype_name)

    def shard_fn(codes, rl, bank_oh, d_of, seql_of, tid, valid_q):
        basecount, seqhits, seqbasehits = inner(
            codes, rl, bank_oh[0], d_of[0], seql_of[0], tid[0], valid_q[0])
        basecount = lax.psum(basecount, 'data')
        seqhits = lax.psum(seqhits, ('data', 'bank'))
        seqbasehits = lax.psum(seqbasehits, ('data', 'bank'))
        return basecount[None], seqhits, seqbasehits

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P('data'), P('data'),
                  P('bank'), P('bank'), P('bank'), P('bank'), P('bank')),
        out_specs=(P('bank'), P(), P()))
    return jax.jit(mapped)


def sharded_scan_step_screen(mesh, Lpad, G, T, maxerrors, minoverlap,
                             B_local, nch=encode.NBASE, dense=False):
    '''
    shard_map'd scan step running the candidate-screen step
    (kvarq_tpu.engine.screen_scan) per device:
    ``step(codes [B, Lpad], rl [B], K [nb, L*nch, Qp], qmeta
    [nb, NROWS, Qp], tseg [nb, Qp]) -> (basecount [n_bank, 5, G],
    seqhits, seqbasehits)``.  ``B`` must equal ``B_local * n_data`` (pad
    with rl=0 rows).  ``dense`` skips the screen + compaction (sieve-fed
    batches: every row is a candidate by construction).
    '''
    import jax
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from kvarq_tpu.engine import screen_scan

    inner = screen_scan.scan_step_banked(
        Lpad, G, T, maxerrors, minoverlap, B_local,
        gather_k=0 if dense else min(512, B_local), nch=nch)

    def shard_fn(codes, rl, K, qmeta, tseg):
        basecount, seqhits, seqbasehits = inner(
            codes, rl, K[0], qmeta[0], tseg[0])
        basecount = lax.psum(basecount, 'data')
        seqhits = lax.psum(seqhits, ('data', 'bank'))
        seqbasehits = lax.psum(seqbasehits, ('data', 'bank'))
        return basecount[None], seqhits, seqbasehits

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P('data'), P('data'), P('bank'), P('bank'), P('bank')),
        out_specs=(P('bank'), P(), P()))
    return jax.jit(mapped)


def sharded_hit_flags_step(mesh, Lpad, maxerrors, minoverlap,
                           nch=encode.NBASE):
    '''
    shard_map'd candidate-flag step for the mesh hit path (findseqs with
    ``--mesh``): ``flags(codes [B, Lpad] u8, rl [B] i32, K [nb, ., Qp],
    qmeta [nb, NROWS, Qp]) -> [B] i32`` -- nonzero where the candidate
    screen (screen_scan.screen_counts) flags the read against ANY bank
    shard (flag counts psum over 'bank').  ``B`` must divide by the
    'data' axis size.
    '''
    import jax
    from jax import lax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from kvarq_tpu.engine import screen_scan

    def shard_fn(codes, rl, K, qmeta):
        read_flat = jax.nn.one_hot(codes, nch, dtype=K.dtype) \
            .reshape(-1, Lpad * nch)
        counts = screen_scan.screen_counts(read_flat, rl, K[0], qmeta[0],
                                           maxerrors, minoverlap)
        return lax.psum((counts > 0).astype(jnp.int32), 'bank')

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P('data'), P('data'), P('bank'), P('bank')),
        out_specs=P('data'))
    return jax.jit(mapped)


class ShardedMatcher:
    ''' hit-list matcher over a ('data', 'bank') mesh (``findseqs`` under
        ``--mesh``, or the ``screen`` backend on one device): the
        candidate flags run sharded over the mesh, the flagged (sparse)
        reads are compacted on host and re-scored exactly by the
        full-bank XlaMatcher -- triplets, and therefore Hit.file_pos,
        are identical to the unsharded scan (the batch never leaves this
        host, so its global stream offsets stay valid). '''

    def __init__(self, seqs, maxerrors, minoverlap, mesh=None,
                 b_local=2048):
        from kvarq_tpu.engine.match_xla import XlaMatcher
        self.seqs = list(seqs)
        self.maxerrors = maxerrors
        self.minoverlap = minoverlap
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_data = self.mesh.shape['data']
        self.n_bank = self.mesh.shape['bank']
        self.xla = XlaMatcher(seqs, maxerrors, minoverlap)
        self.b_local = b_local
        self._ctx = {}

    def _context(self, Lpad):
        if Lpad not in self._ctx:
            bank = ShardBank(self.seqs, Lpad, self.n_bank,
                             self.minoverlap)
            arrays = bank.screen_device_arrays(self.mesh, len(self.seqs))
            step = sharded_hit_flags_step(self.mesh, Lpad, self.maxerrors,
                                          self.minoverlap,
                                          nch=bank.channels())
            self._ctx[Lpad] = (bank, arrays, step,
                               self.b_local * self.n_data)
        return self._ctx[Lpad]

    def match_batch(self, batch):
        from kvarq_tpu.engine.reader import RecordBatch
        B, Lpad = batch.codes.shape
        bank, arrays, step, chunk = self._context(Lpad)
        if bank.G == 0:
            return np.empty((0, 3), dtype=np.int64)

        hit_idx = []
        for lo_ in range(0, B, chunk):
            hi = min(B, lo_ + chunk)
            codes, rl = encode.pad_batch(
                batch.codes[lo_:hi], batch.rl[lo_:hi], chunk, Lpad)
            flags = np.asarray(step(*_put_data(self.mesh, codes, rl),
                                    arrays['K'], arrays['qmeta']))
            hit_idx.append(np.flatnonzero(flags[:hi - lo_] > 0) + lo_)

        hit_idx = np.concatenate(hit_idx) if hit_idx else \
            np.empty(0, dtype=np.int64)
        if not len(hit_idx):
            return np.empty((0, 3), dtype=np.int64)
        compacted = RecordBatch(
            batch.codes[hit_idx], batch.rl[hit_idx],
            batch.filepos[hit_idx], batch.raw[hit_idx])
        tri = self.xla.match_batch(compacted)
        if len(tri):
            tri[:, 0] = hit_idx[tri[:, 0]]
        return tri


class ShardedScanner:
    ''' multi-device counterpart of
        :py:class:`kvarq_tpu.engine.tensor_scan.TensorScanner`: accumulates
        per-template base counts and stats over batches, sharded over a
        ('data', 'bank') mesh.  Results are bitwise-equal to the
        single-device scanner. '''

    def __init__(self, seqs, maxerrors, minoverlap, mesh=None,
                 backend=None):
        from kvarq_tpu.engine.tensor_scan import resolve_backend
        self.seqs = list(seqs)
        self.maxerrors = maxerrors
        self.minoverlap = minoverlap
        self.T = len(self.seqs)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_data = self.mesh.shape['data']
        self.n_bank = self.mesh.shape['bank']
        self.backend = resolve_backend(backend)
        self.dense = False
        self._ctx = {}
        self.reset()

    def assume_dense(self):
        ''' declare the input candidate-dense (sieve-fed batches): the
            per-device candidate screen + compaction are skipped in
            favor of the exact full-batch pass '''
        if self.backend == 'screen' and not self._ctx:
            self.dense = True

    def reset(self):
        self.basecounts = {}   # Lpad -> accumulated [n_bank, 5, G] numpy
        self.seqhits = np.zeros(self.T, dtype=np.int64)
        self.seqbasehits = np.zeros(self.T, dtype=np.int64)

    # per-device batch rows for the screen sharded step (static shape:
    # every global batch is chunked/padded to n_data * B_LOCAL rows)
    B_LOCAL = 2048

    def _context(self, Lpad):
        if Lpad not in self._ctx:
            bank = ShardBank(self.seqs, Lpad, self.n_bank,
                             self.minoverlap)
            if self.backend == 'screen':
                arrays = bank.screen_device_arrays(self.mesh, self.T)
                step = sharded_scan_step_screen(
                    self.mesh, Lpad, bank.G, self.T, self.maxerrors,
                    self.minoverlap, self.B_LOCAL, nch=bank.channels(),
                    dense=self.dense)
                args = (arrays['K'], arrays['qmeta'], arrays['tseg'])
                sub = self.B_LOCAL * self.n_data
            else:
                from kvarq_tpu.device import compute_dtype
                arrays = bank.device_arrays(self.mesh)
                step = sharded_scan_step(
                    self.mesh, Lpad, bank.G, self.T, self.maxerrors,
                    self.minoverlap, dtype_name=compute_dtype())
                args = (arrays['bank_oh'], arrays['d_of'],
                        arrays['seql_of'], arrays['tid'],
                        arrays['valid_q'])
                sub = None   # any multiple of n_data
            self._ctx[Lpad] = (bank, args, step, sub)
        return self._ctx[Lpad]

    def scan_batch(self, batch):
        B, Lpad = batch.codes.shape
        if not self.T:
            return
        bank, args, step, sub = self._context(Lpad)

        chunk = sub if sub else -(-B // self.n_data) * self.n_data
        for lo_ in range(0, B, chunk):
            codes, rl = encode.pad_batch(
                batch.codes[lo_:lo_ + chunk], batch.rl[lo_:lo_ + chunk],
                chunk, Lpad)
            basecount, seqhits, seqbasehits = step(
                *_put_data(self.mesh, codes, rl), *args)
            acc = self.basecounts.setdefault(
                Lpad, np.zeros((self.n_bank, encode.NBASE, bank.G),
                               dtype=np.float64))
            acc += np.asarray(basecount, dtype=np.float64)
            self.seqhits += np.asarray(seqhits[:self.T], dtype=np.int64)
            self.seqbasehits += np.asarray(seqbasehits[:self.T],
                                           dtype=np.int64)

    def finalize(self):
        ''' interface parity with TensorScanner (which buffers fused
            sub-batches); the sharded scanner dispatches eagerly '''

    def coverages(self):
        ''' list (per template, ``seqs`` order) of [5, S] base counts '''
        per_template = [np.zeros((encode.NBASE, len(s)), dtype=np.float64)
                        for s in self.seqs]
        for Lpad, acc in self.basecounts.items():
            bank = self._ctx[Lpad][0]
            for shard, ((lo, hi), sub) in enumerate(
                    zip(bank.ranges, bank.sub)):
                for t in range(lo, hi):
                    pos = sub.tstart[t - lo]
                    S = len(self.seqs[t])
                    per_template[t] += acc[shard, :, pos:pos + S]
        return per_template


def dryrun(n_devices):
    ''' compile + execute one sharded scan step on an ``n_devices`` mesh
        with tiny shapes (the multi-device smoke check) '''
    import jax

    devices = jax.devices()
    assert len(devices) >= n_devices, \
        'need %d devices, have %d' % (n_devices, len(devices))
    n_bank = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices // n_bank, n_bank, devices)

    seqs = ['ACGTACGTACGTACGTACGTACGTA',
            'TTGACCTGAACGTTGACCTGAACGT',
            'CACCGGTGTAGGCAAGTCGTAACAAGG',
            'GGCATTTTCGGGGCATTTTCGGGGCATT']
    scanner = ShardedScanner(seqs, maxerrors=1, minoverlap=10, mesh=mesh)

    from kvarq_tpu.engine.reader import RecordBatch
    B, Lpad = 8 * n_devices, 64
    rng = np.random.RandomState(0)
    raw = rng.choice(np.frombuffer(b'ACGT', dtype=np.uint8), (B, Lpad))
    raw[0, :25] = np.frombuffer(seqs[0].encode(), dtype=np.uint8)
    codes = encode.encode_read_array(raw)
    rl = np.full(B, Lpad, dtype=np.int32)
    scanner.scan_batch(RecordBatch(codes, rl,
                                   np.zeros(B, dtype=np.int64), raw))
    covs = scanner.coverages()
    assert len(covs) == len(seqs)
    assert int(scanner.seqhits.sum()) >= 1  # the planted read must hit
    return scanner
