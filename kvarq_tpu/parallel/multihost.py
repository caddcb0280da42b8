'''
Multi-host scale-out: scan a corpus of FastQ files across the hosts and
devices of a cluster (one process per host, each driving its local GPUs).

The reference's only batch-level scale-out is "run many ``kvarq scan``
processes from a shell loop and merge the jsons with ``kvarq summarize``"
(reference docs/tutorial.rst:366-374).  Here the same corpus-level
parallelism is first-class: every host streams its own shard of the
input files through the native reader/sieve, all hosts jointly execute
the sharded scan step over a global ``('data', 'bank')`` mesh, and
per-template coverage/stat tensors merge with ``psum`` --
one result, bitwise-equal to a single-host scan of the concatenated
input (the reference's own ``findseqs(f) == findseqs([f1, f2])``
invariant, tests/test_engine.py:184-205 upstream, licenses the merge).

Usage (run the SAME program on every host):

    from kvarq_tpu.parallel import multihost
    multihost.initialize()                      # jax.distributed
    covs, seqhits, seqbasehits = multihost.scan_sharded(
        fnames, seqs, maxerrors=2, minoverlap=25, minreadlength=25,
        Amin=chr(33 + 13))

Collective contract: every host dispatches the same sequence of steps --
a host whose file shard is exhausted keeps contributing all-padding
batches until an all-hosts vote says everyone is done, so no host ever
blocks alone in a collective.  Single-process it degrades to the plain
mesh scan, which is how the logic is exercised in tests on a virtual
CPU mesh.
'''

import numpy as np

from kvarq_tpu.engine import encode, reader
from kvarq_tpu.log import lo
from kvarq_tpu.parallel import (
    ShardBank, make_mesh, sharded_scan_step, sharded_scan_step_screen)


def initialize(**kwargs):
    ''' bring up jax.distributed for a multi-process run: kwargs pass
        through (coordinator_address=, num_processes=, process_id=), or
        set the KVARQ_COORDINATOR / KVARQ_NUM_PROCESSES /
        KVARQ_PROCESS_ID environment variables (picked up by every
        caller).  Without either the run is single-process and nothing
        is initialized -- no cluster auto-detection is attempted.  A
        repeated call is a no-op. '''
    import os
    import jax
    if not kwargs and os.environ.get('KVARQ_COORDINATOR'):
        kwargs = dict(
            coordinator_address=os.environ['KVARQ_COORDINATOR'],
            num_processes=int(os.environ['KVARQ_NUM_PROCESSES']),
            process_id=int(os.environ['KVARQ_PROCESS_ID']))
    if kwargs:
        try:
            jax.distributed.initialize(**kwargs)
        except RuntimeError as e:     # already initialized
            lo.debug('jax.distributed.initialize: %s' % e)
    return jax.process_index(), jax.process_count()


def shard_file_indices(fnames, process_id=None, num_processes=None):
    ''' deterministic per-host file assignment, balanced by file size
        (largest-first greedy); every host must call with the same
        list.  Returns *indices* into ``fnames`` so duplicate filenames
        stay distinct assignments. '''
    import os
    import jax
    if process_id is None:
        process_id = jax.process_index()
    if num_processes is None:
        num_processes = jax.process_count()
    sizes = [(os.path.getsize(f) if os.path.exists(f) else 0, i)
             for i, f in enumerate(fnames)]
    loads = [0] * num_processes
    mine = []
    for size, i in sorted(sizes, reverse=True):
        host = loads.index(min(loads))
        loads[host] += size
        if host == process_id:
            mine.append(i)
    return mine


def shard_files(fnames, process_id=None, num_processes=None):
    ''' :py:func:`shard_file_indices`, resolved back to filenames '''
    return [fnames[i]
            for i in shard_file_indices(fnames, process_id,
                                        num_processes)]


def sample_max_readlen(fnames, n_records=4096):
    ''' max bases-line length over the first ``n_records`` records of each
        file -- a cheap per-host estimator for auto-sizing ``Lpad``
        (quality-trimmed reads are never longer than their bases line).
        Unreadable files contribute 0 (another host owns them). '''
    import gzip
    mx = 0
    for fname in fnames:
        op = gzip.open if fname.endswith('.gz') else open
        try:
            with op(fname, 'rb') as f:
                for _ in range(n_records):
                    if not f.readline():        # identifier
                        break
                    bases = f.readline()
                    f.readline()                # separator
                    f.readline()                # quality
                    if not bases:
                        break
                    mx = max(mx, len(bases.rstrip(b'\r\n')))
        except OSError:
            pass
    return mx


def findseqs_sharded(fnames, seqs, maxerrors, minoverlap, minreadlength,
                     Amin, nthreads=8, stats=None, batchsize=16384,
                     backend=None):
    '''
    hit-list scan of a corpus sharded across hosts (the ``findseqs``
    counterpart of :py:func:`scan_sharded`): every host scans its own
    file shard with a local matcher -- hits need no collective compute,
    only a merge -- and each hit's ``file_pos`` is **rebased into the
    global concatenated-stream coordinates** a single-host
    ``findseqs(fnames)`` reports (reference workhorse.c:1587-1593
    semantics, the SURVEY §7 hard part): files are scanned one at a
    time, so each host knows its files' exact decompressed lengths;
    those allgather into global per-file offsets, local positions shift
    by their file's offset, and the merged hit list (ordered by global
    file order, then in-file emission order) is identical on every
    host.

    :returns: ``(hits, hitseqs)`` -- same contents as
        ``engine.findseqs(fnames, seqs)['hits'/'hitseqs']``.
    '''
    import jax
    from jax.experimental import multihost_utils
    from kvarq_tpu import engine as _engine
    from kvarq_tpu.engine.sieve import KmerSieve

    nproc = jax.process_count()
    fnames = list(fnames)
    # membership by INDEX: duplicate filenames in the corpus must each
    # be scanned exactly once globally
    mine_idx = set(shard_file_indices(fnames)) if nproc > 1 \
        else set(range(len(fnames)))

    seqs = list(seqs)
    # the same matcher choice as the single-process hit path
    matcher = _engine.make_matcher(seqs, backend or 'auto', maxerrors,
                                   minoverlap)
    sieve = KmerSieve.build(seqs, maxerrors, minoverlap, minreadlength)
    seqlens = [len(s) for s in seqs]
    stats = stats if stats is not None else reader.ReaderStats()
    # _emit maintains the engine's live per-template counters; size them
    # for this bank (the engine sizes them inside findseqs itself)
    _engine._seqhits = np.zeros(len(seqs), dtype=np.int64)
    _engine._seqbasehits = np.zeros(len(seqs), dtype=np.int64)

    flens = np.zeros(len(fnames), dtype=np.int64)
    per_file = []                     # (global file idx, hits, hitseqs)
    for i, fname in enumerate(fnames):
        if i not in mine_idx:
            continue
        fstats = reader.ReaderStats()
        hits, hitseqs = [], []
        for batch in reader.prefetch(reader.batches(
                [fname], ord(Amin), minreadlength, fstats,
                batchsize=batchsize, sieve=sieve, nthreads=nthreads)):
            _engine._emit(matcher.match_batch(batch), batch, seqlens,
                          minoverlap, hits, hitseqs)
        flens[i] = fstats.parsed      # exact decompressed length
        stats.records_parsed += fstats.records_parsed
        stats.parsed += fstats.parsed
        stats.total += fstats.parsed
        stats.rls += fstats.rls
        stats.rls_longest = max(stats.rls_longest, fstats.rls_longest)
        per_file.append((i, hits, hitseqs))

    if nproc > 1:                     # each host filled only its files
        flens = np.asarray(multihost_utils.process_allgather(flens)) \
            .sum(axis=0)
    offs = np.concatenate([[0], np.cumsum(flens)[:-1]])

    # flatten local hits with (file idx, in-file order) merge keys
    rows, blobs = [], []
    for i, hits, hitseqs in per_file:
        for j, (h, hs) in enumerate(zip(hits, hitseqs)):
            b = hs.encode('latin-1')
            rows.append((i, j, h.seq_nr, h.file_pos + offs[i],
                         h.seq_pos, h.length, h.readlength, len(b)))
            blobs.append(b)
    arr = np.asarray(rows, dtype=np.int64).reshape(-1, 8)
    blob = b''.join(blobs)

    if nproc > 1:
        counts = np.asarray(multihost_utils.process_allgather(
            np.asarray([len(arr), len(blob)], dtype=np.int64)))
        maxn = int(counts[:, 0].max())
        maxb = int(max(counts[:, 1].max(), 1))
        pad_arr = np.zeros((max(maxn, 1), 8), dtype=np.int64)
        pad_arr[:len(arr)] = arr
        pad_blob = np.zeros(maxb, dtype=np.uint8)
        pad_blob[:len(blob)] = np.frombuffer(blob, dtype=np.uint8)
        all_arr = np.asarray(multihost_utils.process_allgather(pad_arr))
        all_blob = np.asarray(multihost_utils.process_allgather(pad_blob))
        parts = []
        for p in range(nproc):
            n = int(counts[p, 0])
            rows_p = all_arr[p, :n]
            blob_p = all_blob[p, :int(counts[p, 1])].tobytes()
            ends = np.cumsum(rows_p[:, 7])
            starts = ends - rows_p[:, 7]
            parts.append((rows_p,
                          [blob_p[s:e] for s, e in zip(starts, ends)]))
        arr = np.concatenate([r for r, _ in parts]) \
            if parts else arr
        blobs = [b for _, bs in parts for b in bs]
    # global order: file order, then in-file emission order
    order = np.lexsort((arr[:, 1], arr[:, 0])) if len(arr) else []
    hits_out, hitseqs_out = [], []
    from kvarq_tpu.engine import Hit
    for k in order:
        i, j, seq_nr, fpos, seq_pos, length, rl, _ = arr[k]
        hits_out.append(Hit(int(seq_nr), int(fpos), int(seq_pos),
                            int(length), int(rl)))
        hitseqs_out.append(blobs[k].decode('latin-1'))
    return tuple(hits_out), hitseqs_out


def scan_sharded(fnames, seqs, maxerrors, minoverlap, minreadlength,
                 Amin, mesh=None, nthreads=8, Lpad=None, b_local=2048,
                 stats=None, backend=None):
    '''
    collective scan over all hosts/chips of ``mesh`` (default: all
    devices).  Every host returns identical results:

    :returns: ``(coverages, seqhits, seqbasehits)`` -- ``coverages`` is a
        list of [5, S] base-count arrays in ``seqs`` order (feed to
        :py:func:`kvarq_tpu.engine.tensor_scan.fold_into_coverage`).

    All read batches are padded to a fixed ``Lpad`` so every host
    compiles and executes the identical program.  ``Lpad=None`` (the
    default) auto-sizes it: every host samples the head of its own file
    shard (:py:func:`sample_max_readlen`), the observed maxima are
    allgathered, and the global max rounds up to the reader's bucket
    table -- so 150/250/300 bp corpora just work.  A read longer than
    every sampled read can still exceed the chosen bucket, in which case
    the scan raises with instructions to pass ``Lpad`` explicitly
    (``KVARQ_MULTIHOST_LPAD`` overrides it without code changes).
    '''
    import os
    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    nproc = jax.process_count()
    mine = shard_files(list(fnames)) if nproc > 1 else list(fnames)

    if Lpad is None and os.environ.get('KVARQ_MULTIHOST_LPAD'):
        Lpad = int(os.environ['KVARQ_MULTIHOST_LPAD'])
    if Lpad is None:
        local_max = sample_max_readlen(mine)
        if nproc > 1:
            maxima = multihost_utils.process_allgather(
                np.asarray([local_max], dtype=np.int32))
            local_max = int(np.asarray(maxima).max())
        Lpad = reader._round_up(max(local_max, 128))
        lo.info('multihost scan: auto Lpad=%d (sampled max read length %d)'
                % (Lpad, local_max))
    mesh = mesh if mesh is not None else make_mesh()
    n_data = mesh.shape['data']
    n_bank = mesh.shape['bank']
    T = len(seqs)
    from kvarq_tpu.engine.tensor_scan import resolve_backend
    backend = resolve_backend(backend)

    from kvarq_tpu.engine.sieve import KmerSieve
    sieve = KmerSieve.build(seqs, maxerrors, minoverlap, minreadlength)

    bank = ShardBank(list(seqs), Lpad, n_bank, minoverlap)
    if backend == 'screen':
        arrays = bank.screen_device_arrays(mesh, T)
        # sieve-fed batches are candidate-dense by construction: skip
        # the screen, run the exact full pass directly.  With no
        # applicable sieve (short templates / tight configs) the
        # unsieved stream is sparse and keeps the screened path.
        step = sharded_scan_step_screen(
            mesh, Lpad, bank.G, T, maxerrors, minoverlap, b_local,
            nch=bank.channels(), dense=sieve is not None)
        args = (arrays['K'], arrays['qmeta'], arrays['tseg'])
    else:
        from kvarq_tpu.device import compute_dtype
        arrays = bank.device_arrays(mesh)
        step = sharded_scan_step(mesh, Lpad, bank.G, T, maxerrors,
                                 minoverlap, dtype_name=compute_dtype())
        args = (arrays['bank_oh'], arrays['d_of'], arrays['seql_of'],
                arrays['tid'], arrays['valid_q'])

    B_global = b_local * n_data
    if B_global % nproc:
        raise ValueError('b_local * n_data must divide by process count')
    B_host = B_global // nproc     # rows this host contributes per step

    data_sharding = NamedSharding(mesh, P('data'))

    def put(codes, rl):
        if nproc == 1:
            return (jax.device_put(codes, data_sharding),
                    jax.device_put(rl, data_sharding))
        return (jax.make_array_from_process_local_data(data_sharding, codes),
                jax.make_array_from_process_local_data(data_sharding, rl))

    # host-side exact accumulators (stats/coverage tensors are fetched
    # once per *batch group*, identical on every host)
    acc_bc = np.zeros((n_bank, encode.NBASE, bank.G), dtype=np.float64)
    acc_sh = np.zeros(T, dtype=np.int64)
    acc_sbh = np.zeros(T, dtype=np.int64)

    stats = stats if stats is not None else reader.ReaderStats()

    def host_rows():
        ''' yield [B_host, Lpad] row blocks from this host's shard '''
        pend_codes = np.full((B_host, Lpad), encode.CODE_READ_JUNK,
                             dtype=np.uint8)
        pend_rl = np.zeros(B_host, dtype=np.int32)
        fill = 0
        src = reader.batches(mine, ord(Amin), minreadlength, stats,
                             batchsize=B_host, sieve=sieve,
                             nthreads=nthreads) if mine else iter(())
        for batch in src:
            B, L = batch.codes.shape
            if L > Lpad:
                raise ValueError(
                    'read length %d exceeds Lpad=%d (auto-sized from the '
                    'first %d records per file); pass Lpad= explicitly or '
                    'set KVARQ_MULTIHOST_LPAD' % (L, Lpad, 4096))
            lo_ = 0
            while lo_ < B:
                n = min(B - lo_, B_host - fill)
                pend_codes[fill:fill + n, :L] = batch.codes[lo_:lo_ + n]
                pend_rl[fill:fill + n] = batch.rl[lo_:lo_ + n]
                fill += n
                lo_ += n
                if fill == B_host:
                    yield pend_codes, pend_rl
                    pend_codes = np.full((B_host, Lpad),
                                         encode.CODE_READ_JUNK, np.uint8)
                    pend_rl = np.zeros(B_host, dtype=np.int32)
                    fill = 0
        if fill:
            yield pend_codes, pend_rl

    rows = host_rows()
    pad_codes = np.full((B_host, Lpad), encode.CODE_READ_JUNK, np.uint8)
    pad_rl = np.zeros(B_host, dtype=np.int32)
    done = False
    while True:
        block = None
        if not done:
            block = next(rows, None)
            done = block is None
        if nproc > 1:
            votes = multihost_utils.process_allgather(
                np.asarray([0 if done else 1], dtype=np.int32))
            if int(np.asarray(votes).sum()) == 0:
                break
        elif done:
            break
        codes, rl = block if block is not None else (pad_codes, pad_rl)
        bc, sh, sbh = step(*put(codes, rl), *args)
        if nproc > 1:
            bc = multihost_utils.process_allgather(bc, tiled=True)
        acc_bc += np.asarray(bc, dtype=np.float64)
        acc_sh += np.asarray(sh[:T], dtype=np.int64)
        acc_sbh += np.asarray(sbh[:T], dtype=np.int64)

    if nproc > 1:
        # merge the host-local reader stats into corpus-global ones, so
        # ``stats`` describes the whole scan on every host (results are
        # global, the progress/histogram metadata should be too)
        local = np.concatenate([
            stats.rls.astype(np.int64),
            np.asarray([stats.records_parsed, stats.parsed, stats.total,
                        stats.rls_longest], dtype=np.int64)])
        merged = np.asarray(
            multihost_utils.process_allgather(local))
        stats.rls = merged[:, :reader.MAX_READLENGTH].sum(axis=0)
        stats.records_parsed = int(merged[:, -4].sum())
        stats.parsed = int(merged[:, -3].sum())
        stats.total = int(merged[:, -2].sum())
        stats.rls_longest = int(merged[:, -1].max())

    # fold padded per-shard positions back onto per-template [5, S]
    per_template = [np.zeros((encode.NBASE, len(s)), dtype=np.float64)
                    for s in seqs]
    for shard, ((lo_, hi), sub) in enumerate(zip(bank.ranges, bank.sub)):
        for t in range(lo_, hi):
            pos = sub.tstart[t - lo_]
            S = len(seqs[t])
            per_template[t] += acc_bc[shard, :, pos:pos + S]
    return per_template, acc_sh, acc_sbh
