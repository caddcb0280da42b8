'''
Public scan-engine API, drop-in compatible with the reference C extension
``kvarq.engine`` (csrc/workhorse.c:1524-1596):

- :py:data:`Hit` namedtuple ``(seq_nr, file_pos, seq_pos, length, readlength)``
- :py:func:`config` / :py:func:`get_config`
- :py:func:`findseqs` ``(fname_or_list, seqs) -> {'hits', 'stats', 'hitseqs'}``
- :py:func:`stats` -- pollable during a running scan
- :py:func:`stop` -- cooperative cancellation

Instead of pthreads over a shared file stream, scanning here is a host input
pipeline (kvarq_tpu.engine.reader) feeding batched matchers:

- ``numpy``  -- byte-exact golden reference
- ``xla``    -- jitted one-hot correlation over a concatenated template bank
                (GPU or CPU; the default)
- ``screen`` -- candidate screen over a device mesh (one device unless
                ``mesh`` is set) plus exact ``xla`` rescore of the
                flagged reads (kvarq_tpu.parallel.ShardedMatcher)

plus an optional exact k-mer ``sieve`` prefilter.  All backends produce
identical hits, ordered like a single-threaded reference scan
(record, then template, then mode enumeration order -- see
kvarq_tpu.engine.hitmodel).
'''

import collections
import functools
import os
import stat
import threading

import numpy as np

from kvarq_tpu.log import lo
from kvarq_tpu.engine import encode, hitmodel, reader

Hit = collections.namedtuple(
    'Hit', 'seq_nr file_pos seq_pos length readlength')
Hit.__doc__ += (
    '''
seq_nr : refers to the list of sequences in call to engine.findseqs
file_pos : beginning of read (within decompressed data)
seq_pos : places the beginning of the read relative to the beginning of
    the sequence (<0 if read overlaps only with beginning of sequence or
    read contains whole sequence; >0 if read overlaps only with end of
    sequence or read is contained within sequence)
length : gives the number of overlapping basepairs
readlength : length of the (quality trimmed) read containing the hit
''')

# engine configuration (defaults match workhorse.c:71-76)
_config = {
    'maxerrors': 0,
    'minoverlap': 20,
    'minreadlength': 10,
    'nthreads': 1,
    'Amin': '!',
    'Azero': '!',
}
# kvarq_tpu extensions (not part of get_config() for json parity)
_extra_config = {
    'backend': os.environ.get('KVARQ_BACKEND', 'auto'),
    'batchsize': int(os.environ.get('KVARQ_BATCHSIZE', '16384')),
    'sieve': os.environ.get('KVARQ_SIEVE', 'auto'),
    # multi-chip scan: '' = single device, 'auto' = all devices,
    # 'NDxNB' = explicit ('data', 'bank') mesh shape (kvarq_tpu.parallel)
    'mesh': os.environ.get('KVARQ_MESH', ''),
}

_lock = threading.Lock()
_running = False
_stop = False
_sigints = 0
_stats = reader.ReaderStats()
_nseqs = 0
_seqhits = np.zeros(0, dtype=np.int64)
_seqbasehits = np.zeros(0, dtype=np.int64)


def config(**kwargs):
    ''' update engine configuration; accepts the reference keys
        (maxerrors, minoverlap, minreadlength, nthreads, Amin, Azero --
        workhorse.c:1497-1507) plus kvarq_tpu extensions
        (backend, batchsize, sieve, mesh) '''
    for key, value in kwargs.items():
        if key in ('Amin', 'Azero'):
            if not isinstance(value, str) or len(value) != 1:
                raise TypeError('%s must be a single character' % key)
            _config[key] = value
        elif key in ('maxerrors', 'minoverlap', 'minreadlength', 'nthreads'):
            _config[key] = int(value)
        elif key in _extra_config:
            _extra_config[key] = value
        else:
            raise TypeError("config() got an unexpected keyword '%s'" % key)


def get_config():
    ''' :returns: the reference-compatible config dict
        (workhorse.c:1483-1493) '''
    return dict(_config)


def stop():
    ''' stop a running scan; results are computed from the data parsed so
        far (workhorse.c:1468-1479) '''
    global _stop
    lo.debug('engine stopped')
    _stop = True


def _sigint_cb(sig, frame):
    global _sigints
    _sigints += 1


def install_sigint_counter():
    ''' count SIGINT instead of raising KeyboardInterrupt, like the C engine
        (workhorse.c:133-136); call from the main thread (the CLI does) '''
    import signal
    try:
        signal.signal(signal.SIGINT, _sigint_cb)
    except ValueError:
        pass  # not in main thread (e.g. under a test runner)


def stats():
    ''' live scanning statistics (workhorse.c:1204-1244) '''
    longest = min(_stats.rls_longest, reader.MAX_READLENGTH - 1)
    rls = tuple(int(x) for x in _stats.rls[:longest + 1])
    progress = 0.0
    if _stats.total > 0:
        progress = float(min(_stats.parsed, _stats.total)) / _stats.total
    return {
        'readlengths': rls,
        'progress': progress,
        'nseqbasehits': tuple(int(x) for x in _seqbasehits),
        'nseqhits': tuple(int(x) for x in _seqhits),
        'parsed': int(_stats.parsed),
        'total': int(_stats.total),
        'sigints': _sigints,
        'records_parsed': int(_stats.records_parsed),
    }


def _make_matcher(seqs, backend):
    spec = str(_extra_config['mesh'] or '').strip().lower()
    mesh = None
    if spec not in ('', 'off', '0', 'no', 'none') and backend != 'numpy':
        from kvarq_tpu.parallel import parse_mesh
        mesh = parse_mesh(spec)
        lo.info('hit scan over a %s mesh (%d devices)'
                % (dict(mesh.shape), mesh.size))
    return make_matcher(seqs, backend, _config['maxerrors'],
                        _config['minoverlap'], mesh=mesh)


def make_matcher(seqs, backend, maxerrors, minoverlap, mesh=None):
    ''' hit-list matcher for ``backend`` (``auto``, ``numpy``, ``xla`` or
        ``screen``; see the module docstring).  With a ``mesh`` the
        device backends run sharded over it: sharded candidate screen +
        exact host-side rescore; file_pos stays global because every
        batch is read (and its hits emitted) on this host. '''
    if backend == 'auto':
        backend = _auto_backend()
    if backend == 'numpy':
        from kvarq_tpu.engine.match_numpy import NumpyMatcher
        return NumpyMatcher(seqs, maxerrors, minoverlap)
    if mesh is not None or backend == 'screen':
        from kvarq_tpu.parallel import ShardedMatcher, make_mesh
        return ShardedMatcher(
            seqs, maxerrors, minoverlap,
            mesh=mesh if mesh is not None else make_mesh(1, 1))
    if backend == 'xla':
        from kvarq_tpu.engine.match_xla import XlaMatcher
        return XlaMatcher(seqs, maxerrors, minoverlap)
    raise ValueError('unknown engine backend "%s"' % backend)


def _auto_backend():
    ''' the hit-path backend ``auto`` resolves to: the XLA matcher, on
        the accelerator and on the CPU alike '''
    from kvarq_tpu.jaxutil import ensure_compilation_cache
    ensure_compilation_cache()
    return 'xla'


def _make_scanner(seqs):
    ''' tensorized-scan driver for countseqs: the single-device
        TensorScanner, or a mesh-sharded ShardedScanner when the ``mesh``
        config/env requests multi-chip (kvarq_tpu.parallel) '''
    spec = str(_extra_config['mesh'] or '').strip().lower()
    if spec in ('', 'off', '0', 'no', 'none'):
        from kvarq_tpu.engine.tensor_scan import TensorScanner
        return TensorScanner(seqs, _config['maxerrors'],
                             _config['minoverlap'])
    from kvarq_tpu.parallel import ShardedScanner, parse_mesh
    mesh = parse_mesh(spec)
    lo.info('scanning over a %s mesh (%d devices)'
            % (dict(mesh.shape), mesh.size))
    return ShardedScanner(seqs, _config['maxerrors'],
                          _config['minoverlap'], mesh=mesh)


@functools.lru_cache(maxsize=4)
def _cached_sieve(seqs_key, maxerrors, minoverlap, minreadlength):
    from kvarq_tpu.engine.sieve import KmerSieve
    return KmerSieve.build(list(seqs_key), maxerrors, minoverlap,
                           minreadlength)


def _make_sieve(seqs):
    mode = _extra_config['sieve']
    if mode in (False, 'off', '0', 'no'):
        return None
    # the index build costs ~30 ms for the MTBC bank; repeated scans of
    # the same bank (GUI multi-file runs, benchmarks, batch mode) reuse
    # it -- the sieve is immutable after build
    sieve = _cached_sieve(tuple(seqs), _config['maxerrors'],
                          _config['minoverlap'],
                          _config['minreadlength'])
    if sieve is None and mode not in ('auto',):
        lo.warning('k-mer sieve not applicable for current config; disabled')
    return sieve


def findseqs(fname, seqs):
    '''
    scan fastq file(s) for template base sequences
    (reference workhorse.c:1248-1464).

    :param fname: filename or sequence of filenames
    :param seqs: list of template base strings
    :returns: dict with ``hits`` (tuple of :py:data:`Hit`), ``stats`` (as
        :py:func:`stats`), ``hitseqs`` (list of matched read base strings,
        parallel to ``hits``)
    '''
    global _running, _stop, _sigints, _stats, _nseqs, _seqhits, _seqbasehits

    from kvarq_tpu.fastq import FastqFileFormatException

    with _lock:
        if _running:
            raise RuntimeError('findseqs() already running!')
        _running = True
    _stop = False
    _sigints = 0

    try:
        if isinstance(fname, str):
            fnames = [fname]
        else:
            fnames = list(fname)

        seqs = list(seqs)
        _nseqs = len(seqs)
        _seqhits = np.zeros(_nseqs, dtype=np.int64)
        _seqbasehits = np.zeros(_nseqs, dtype=np.int64)
        _stats = reader.ReaderStats()

        backend = _extra_config['backend']
        if backend == 'auto' and seqs and _small_scan_eligible(fnames):
            # small input, cold device: numpy finishes before the
            # accelerator would even answer (see _small_scan_eligible)
            lo.debug('small input: scanning via the numpy matcher')
            backend = 'numpy'
        matcher = _make_matcher(seqs, backend) if seqs else None
        sieve = _make_sieve(seqs) if seqs else None
        seqlens = [len(s) for s in seqs]
        mo = _config['minoverlap']
        Amin = ord(_config['Amin'])

        hits = []
        hitseqs = []

        try:
            for batch in reader.prefetch(reader.batches(
                    fnames, Amin, _config['minreadlength'], _stats,
                    batchsize=_extra_config['batchsize'],
                    stop_check=lambda: _stop,
                    sieve=sieve if matcher is not None else None,
                    nthreads=_config['nthreads'])):
                if matcher is None:
                    continue
                triplets = matcher.match_batch(batch)
                _emit(triplets, batch, seqlens, mo, hits, hitseqs)
        except reader.FastqFormatError as e:
            raise FastqFileFormatException(str(e))

        return {
            'hits': tuple(hits),
            'stats': stats(),
            'hitseqs': hitseqs,
        }
    finally:
        _running = False


_jax_probe_failed = False


def _jax_device_ready():
    ''' True iff this process already initialized a JAX backend (so device
        dispatch is warm and cheap); False before first use -- without
        triggering that (expensive) initialization itself.  Relies on
        jax._src.xla_bridge internals (there is no public "initialized but
        don't initialize" probe); if that introspection ever breaks on a
        newer JAX, warn once instead of silently always scanning via numpy '''
    global _jax_probe_failed
    import sys
    if 'jax' not in sys.modules:
        return False
    try:
        from jax._src import xla_bridge
        return bool(xla_bridge._backends)
    except Exception:
        if not _jax_probe_failed:
            _jax_probe_failed = True
            lo.warning('cannot probe JAX backend state on this JAX version; '
                       'small-scan fast path assumes a cold device '
                       '(set KVARQ_SMALL_SCAN=0 to disable)')
        return False


# inputs smaller than this (decompressed-size estimate) scan through the
# byte-exact numpy hit path instead of bringing up the accelerator and
# compiling the scan step for a few thousand reads (the threshold is a
# fixed constant, see ROADMAP design 1).  The reference's precompiled C
# engine starts instantly on such files (setup.py:31-35); this keeps that
# UX.  0 disables the heuristic; it never engages when a backend was
# explicitly selected, a mesh is requested, or the process already has a
# live JAX backend (warm dispatch beats numpy).
SMALL_SCAN_BYTES = int(os.environ.get('KVARQ_SMALL_SCAN', '4000000'))


def _small_scan_eligible(fnames, tensor_path=False):
    if SMALL_SCAN_BYTES <= 0:
        return False
    if _extra_config['backend'] != 'auto':
        return False
    if tensor_path and os.environ.get(
            'KVARQ_TENSOR_BACKEND', 'auto') not in ('', 'auto'):
        # KVARQ_TENSOR_BACKEND only selects the countseqs coverage-scan
        # backend; it must not veto the findseqs hit path
        return False
    if str(_extra_config['mesh'] or '').strip().lower() \
            not in ('', 'off', '0', 'no', 'none'):
        return False
    if _jax_device_ready():
        return False
    try:
        # size estimate: gzip detected by magic bytes (not suffix, so
        # .bgz/.bgzf inputs are seen too); FastQ commonly compresses
        # 4-10x, so use a conservative 8x for the eligibility decision
        # (the reader's 3x at workhorse.c:624-626 is a *progress*
        # estimate, refined while reading -- this one must not let a
        # tens-of-MB decompressed input sneak into the numpy path)
        total = 0
        for f in fnames:
            # regular files only: sniffing the magic of a FIFO/process
            # substitution would consume stream bytes the real reader
            # needs, corrupting the subsequent scan
            if not stat.S_ISREG(os.stat(f).st_mode):
                return False
            size = os.path.getsize(f)
            with open(f, 'rb') as fd:
                if fd.read(2) == b'\x1f\x8b':
                    size *= 8
            total += size
    except OSError:
        return False
    return total < SMALL_SCAN_BYTES


def _basecounts_from_hits(hits, hitseqs, seqs):
    ''' per-template [5, S] base counts in scanned-strand coordinates from
        a hit list -- the exact quantity the tensorized path accumulates
        on device (non-AGCTN read bytes are dropped, matching the device
        path's 5-channel one-hot; see kvarq_tpu.engine.encode) '''
    counts = [np.zeros((encode.NBASE, len(s)), np.int64) for s in seqs]
    for hit, hitseq in zip(hits, hitseqs):
        start = max(0, hit.seq_pos)
        codes = encode.encode_read(hitseq.encode('latin-1'))
        pos = start + np.arange(len(codes))
        valid = codes < encode.NBASE
        np.add.at(counts[hit.seq_nr], (codes[valid], pos[valid]), 1)
    return counts


def countseqs(fname, seqs):
    '''
    tensorized scan: like :py:func:`findseqs` but accumulates per-template
    base counts *on device* instead of materializing a hit list -- the
    production path for large scans and the unit that shards data-parallel
    across chips.  Statistics (``nseqhits``/``nseqbasehits``/readlengths/
    progress) are identical to :py:func:`findseqs`; per-position coverage
    information is returned as dense base-count tensors that
    :py:func:`kvarq_tpu.engine.tensor_scan.fold_into_coverage` maps onto
    :py:class:`~kvarq_tpu.analyse.Coverage` objects.

    :returns: dict with ``basecounts`` (list of [5, S] int64 arrays in
        scanned-strand coordinates, parallel to ``seqs``) and ``stats``
    '''
    global _running, _stop, _sigints, _stats, _nseqs, _seqhits, _seqbasehits

    from kvarq_tpu.fastq import FastqFileFormatException

    with _lock:
        if _running:
            raise RuntimeError('findseqs() already running!')
        _running = True
    _stop = False
    _sigints = 0

    try:
        fnames = [fname] if isinstance(fname, str) else list(fname)
        seqs = list(seqs)
        _nseqs = len(seqs)
        _seqhits = np.zeros(_nseqs, dtype=np.int64)
        _seqbasehits = np.zeros(_nseqs, dtype=np.int64)
        _stats = reader.ReaderStats()

        if seqs and _small_scan_eligible(fnames, tensor_path=True):
            # small input, cold device: the numpy hit path finishes before
            # the accelerator would even answer (see _small_scan_eligible)
            lo.debug('small input: scanning via the numpy hit path')
            matcher = _make_matcher(seqs, 'numpy')
            sieve = _make_sieve(seqs)
            seqlens = [len(s) for s in seqs]
            hits, hitseqs = [], []
            try:
                for batch in reader.prefetch(reader.batches(
                        fnames, ord(_config['Amin']),
                        _config['minreadlength'], _stats,
                        batchsize=_extra_config['batchsize'],
                        stop_check=lambda: _stop, sieve=sieve,
                        nthreads=_config['nthreads'])):
                    triplets = matcher.match_batch(batch)
                    _emit(triplets, batch, seqlens, _config['minoverlap'],
                          hits, hitseqs)
            except reader.FastqFormatError as e:
                raise FastqFileFormatException(str(e))
            return {
                'basecounts': _basecounts_from_hits(hits, hitseqs, seqs),
                'stats': stats(),
            }

        scanner = _make_scanner(seqs) if seqs else None
        sieve = _make_sieve(seqs) if seqs else None
        if sieve is not None and hasattr(scanner, 'assume_dense'):
            # sieve-fed batches contain only candidate reads, so the
            # scanner can start in dense mode instead of discovering
            # the density on its first dispatch
            scanner.assume_dense()
        Amin = ord(_config['Amin'])

        try:
            for batch in reader.prefetch(reader.batches(
                    fnames, Amin, _config['minreadlength'], _stats,
                    batchsize=_extra_config['batchsize'],
                    stop_check=lambda: _stop,
                    sieve=sieve if scanner is not None else None,
                    nthreads=_config['nthreads'])):
                if scanner is None:
                    continue
                scanner.scan_batch(batch)
                # live counters for stats() polling during the scan
                _seqhits[:] = scanner.seqhits
                _seqbasehits[:] = scanner.seqbasehits
        except reader.FastqFormatError as e:
            raise FastqFileFormatException(str(e))

        if scanner is not None:
            scanner.finalize()
            _seqhits[:] = scanner.seqhits
            _seqbasehits[:] = scanner.seqbasehits
            basecounts = [bc.astype(np.int64) for bc in scanner.coverages()]
        else:
            basecounts = []
        return {
            'basecounts': basecounts,
            'stats': stats(),
        }
    finally:
        _running = False


def _emit(triplets, batch, seqlens, mo, hits, hitseqs):
    ''' convert passing (read, template, shift) triplets into Hit tuples in
        the reference's single-threaded enumeration order (record, then
        template, then mode A desc / B desc / C-or-D asc -- see
        kvarq_tpu.engine.hitmodel and reference workhorse.c:1107-1174).

        Vectorized: per-mode gating, hit lengths and the enumeration-order
        sort run as whole-array numpy ops; only the final Hit/str
        construction is a Python loop (one tight iteration per emitted
        hit).  Matters on hit-dense inputs (the test fixtures are ~100%
        hits) where the former per-(read, template) group loop ran at
        interpreter speed. '''
    if not len(triplets):
        return
    trip = np.unique(np.asarray(triplets, dtype=np.int64), axis=0)
    b, t, d = trip[:, 0], trip[:, 1], trip[:, 2]
    rl = batch.rl.astype(np.int64)[b]
    seql = np.asarray(seqlens, dtype=np.int64)[t]

    # one candidate emission per (triplet, mode); B and D can both fire at
    # the same shift (the reference's mode-B/D border duplicate)
    ab = (rl > mo) & (seql > mo)
    emits = []   # (mask, rank, intra-mode order key, length)
    # mode A (read tail over template head): i=-d desc  ->  d asc
    mask = ab & (d < 0) & (-d >= np.maximum(1, rl - seql + 1)) \
        & (-d <= rl - mo)
    emits.append((mask, 0, d, rl + d))
    # mode B (read head over template tail): i=d desc  ->  d desc
    mask = ab & (d > 0) & (d >= np.maximum(1, seql - rl)) \
        & (d <= seql - mo)
    emits.append((mask, 1, -d, seql - d))
    # mode C (template within read): i=-d asc  ->  d desc
    mask = (rl > seql) & (d <= 0) & (-d <= rl - seql)
    emits.append((mask, 2, -d, seql.copy()))
    # mode D (read within template): i=d asc  ->  d asc
    mask = (rl <= seql) & (d >= 0) & (d <= seql - rl)
    emits.append((mask, 2, d, rl.copy()))

    idx = np.concatenate([np.flatnonzero(m) for m, _, _, _ in emits])
    rank = np.concatenate([np.full(int(m.sum()), r, dtype=np.int8)
                           for m, r, _, _ in emits])
    key = np.concatenate([k[m] for m, _, k, _ in emits])
    length = np.concatenate([ln[m] for m, _, _, ln in emits])
    if not len(idx):
        return
    order = np.lexsort((key, rank, t[idx], b[idx]))
    idx, length = idx[order], length[order]
    eb, et, ed = b[idx], t[idx], d[idx]
    erl, efp = rl[idx], batch.filepos.astype(np.int64)[eb]
    start = np.maximum(0, -ed)

    np.add.at(_seqhits, et, 1)
    np.add.at(_seqbasehits, et, length)

    raw = batch.raw
    for i in range(len(idx)):
        hits.append(Hit(seq_nr=int(et[i]), file_pos=int(efp[i]),
                        seq_pos=int(ed[i]), length=int(length[i]),
                        readlength=int(erl[i])))
        s = start[i]
        hitseqs.append(
            raw[eb[i], s:s + length[i]].tobytes().decode('latin-1'))
