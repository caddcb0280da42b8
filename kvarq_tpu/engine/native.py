'''
ctypes binding for the native C++ FastQ pipeline (csrc/reader.cpp) -- the
equivalent of the reference engine's host half (file streaming,
gz inflate, record parse, quality trim; /root/reference/csrc/workhorse.c:482-1103
and csrc/gz/miniz.c).  Drop-in replacement for the numpy pipeline in
kvarq_tpu.engine.reader: same batch contents, same error messages, same
statistics; ~100x faster per record.

The shared library (csrc/_reader.so, not tracked by git) is built from
the source at first use with g++ (no pybind11/Python C-API; plain C ABI
via ctypes), and rebuilt when the source changes.  Set ``KVARQ_NATIVE=0``
to force the numpy pipeline.
'''

import ctypes
import os
import subprocess
import threading

import numpy as np

from kvarq_tpu.log import lo
from kvarq_tpu.engine import encode, reader

HERE = os.path.abspath(os.path.dirname(__file__))
CSRC = os.path.join(os.path.dirname(os.path.dirname(HERE)), 'csrc')
SRC = os.path.join(CSRC, 'reader.cpp')
LIB = os.path.join(CSRC, '_reader.so')
# pre-AVX2 hosts get their own build: the default _reader.so targets
# x86-64-v3 and would SIGILL there
LIB_COMPAT = os.path.join(CSRC, '_reader_compat.so')

MAX_READLENGTH = reader.MAX_READLENGTH


def _cpu_supports_v3():
    ''' does this CPU run x86-64-v3 (AVX2) code?  Linux: /proc/cpuinfo
        flags; elsewhere assume yes (non-x86 never gets here: the g++
        -march variants fail over to the generic build) '''
    try:
        with open('/proc/cpuinfo') as fd:
            for line in fd:
                if line.startswith('flags'):
                    return ' avx2' in line
    except OSError:
        pass
    return True

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _src_hash():
    ''' sha256 of the C++ source, embedded into the library at build time
        (kvq_src_hash) and compared at load -- mtimes are useless for
        staleness on fresh checkouts and copies '''
    import hashlib
    with open(SRC, 'rb') as fd:
        return hashlib.sha256(fd.read()).hexdigest()[:16]


def _load_if_current(lib_path, want_hash):
    ''' load lib_path if it exists and was built from the current source;
        None otherwise '''
    if not os.path.exists(lib_path):
        return None
    try:
        lib = ctypes.CDLL(lib_path)
        lib.kvq_src_hash.restype = ctypes.c_char_p
        if lib.kvq_src_hash().decode() == want_hash:
            return lib
    except (OSError, AttributeError):
        pass
    # stale or unreadable: unlink so the relink creates a fresh inode
    # (dlopen caches by inode; rebuilding in place would hand back the
    # already-loaded stale image)
    try:
        os.unlink(lib_path)
    except OSError:
        pass
    return None


def _build(lib_path, generic=False):
    ''' compile the library into a private temporary file and move it
        into place with one rename, so a concurrent process (pytest-xdist
        workers, parallel CLI runs) never loads a half-written library '''
    tmp_path = '%s.%d.tmp' % (lib_path, os.getpid())
    try:
        _compile(tmp_path, generic)
        os.replace(tmp_path, lib_path)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)


def _compile(lib_path, generic):
    # x86-64-v3 (AVX2 baseline) rather than -march=native: measured
    # equal on the hot loops (the SIMD paths are explicit AVX2
    # intrinsics), and the binary stays runnable on any post-2015
    # x86-64 -- a native-arch build can SIGILL when the library travels
    # to an older machine (e.g. inside a wheel).  ``generic`` drops the
    # arch flags entirely (pre-AVX2 hosts; the intrinsics are
    # __AVX2__-guarded with scalar fallbacks)
    def variants():
        # -mpclmul: carry-less multiply for the fast-inflate CRC; not
        # part of the x86-64-v3 psABI level but universal on AVX2-era
        # CPUs (the generic build falls back to table CRC)
        archs = [[]] if generic else \
            [['-march=x86-64-v3', '-mpclmul', '-mtune=native'],
             ['-march=native'], []]
        for arch in archs:
            base = ['g++', '-O3'] + arch + \
                ['-DKVARQ_SRC_HASH="%s"' % _src_hash(),
                 '-shared', '-fPIC', '-pthread', '-o', lib_path, SRC]
            # libdeflate (~3x zlib inflate) accelerates the gz producer
            # pipeline when present; plain zlib otherwise; a machine
            # with NEITHER still builds -- csrc/kvq_inflate.h is a
            # self-contained streaming inflate (slower, same results),
            # the analogue of the reference vendoring miniz
            yield base + ['-DKVARQ_USE_LIBDEFLATE', '-lz', '-ldeflate']
            yield base + ['-lz']
            yield base + ['-DKVARQ_NO_ZLIB']

    last = None
    for cmd in variants():
        lo.info('building native reader: %s' % ' '.join(cmd))
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            return
        except subprocess.CalledProcessError as e:
            last = e
    raise last


def get_lib():
    ''' :returns: the loaded library, or None when unavailable '''
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if os.environ.get('KVARQ_NATIVE', '1') == '0':
            _lib_failed = True
            return None
        try:
            generic = not _cpu_supports_v3()
            lib_path = LIB_COMPAT if generic else LIB
            want = _src_hash()
            lib = _load_if_current(lib_path, want)
            if lib is None:
                _build(lib_path, generic)
                lib = ctypes.CDLL(lib_path)
        except Exception as e:
            lo.warning('native reader unavailable (%s); '
                       'falling back to numpy pipeline' % e)
            _lib_failed = True
            return None

        lib.kvq_open.restype = ctypes.c_void_p
        lib.kvq_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_long]
        lib.kvq_error.restype = ctypes.c_char_p
        lib.kvq_error.argtypes = [ctypes.c_void_p]
        lib.kvq_stats.argtypes = [ctypes.c_void_p] + \
            [ctypes.POINTER(ctypes.c_int64)] * 4 + \
            [np.ctypeslib.ndpointer(np.int64, flags='C')]
        lib.kvq_set_sieve.restype = None
        lib.kvq_set_sieve.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int32, flags='C'),   # start
            np.ctypeslib.ndpointer(np.int32, flags='C'),   # gpos
            np.ctypeslib.ndpointer(np.int32, flags='C'),   # gtid
            np.ctypeslib.ndpointer(np.int32, flags='C'),   # tstart
            np.ctypeslib.ndpointer(np.int32, flags='C'),   # tstop
            np.ctypeslib.ndpointer(np.uint8, flags='C'),   # bank codes
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.kvq_next.restype = ctypes.c_long
        lib.kvq_next.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
            np.ctypeslib.ndpointer(np.uint8, flags='C'),
            np.ctypeslib.ndpointer(np.uint8, flags='C'),
            np.ctypeslib.ndpointer(np.int32, flags='C'),
            np.ctypeslib.ndpointer(np.int64, flags='C'),
            ctypes.POINTER(ctypes.c_int32)]
        lib.kvq_pending_rl.restype = ctypes.c_long
        lib.kvq_pending_rl.argtypes = [ctypes.c_void_p]
        lib.kvq_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available():
    return get_lib() is not None


def batches(fnames, Amin, minreadlength, stats, batchsize=16384,
            stop_check=None, sieve=None, nthreads=1):
    ''' generator over reader.RecordBatch, same contract as
        reader.batches() but backed by the native pipeline.  With a
        ``sieve`` (kvarq_tpu.engine.sieve.KmerSieve), provably hit-free
        reads are dropped at parse time inside the C loop -- every yielded
        batch is full of candidate reads.  ``nthreads`` > 1 fans the
        parse/trim/sieve work out over C worker threads pulling
        record-aligned spans from the shared stream (the reference's
        pthread architecture, workhorse.c:1375-1408), with batches still
        emitted in deterministic record order '''
    lib = get_lib()
    names = (ctypes.c_char_p * len(fnames))(
        *[f.encode() for f in fnames])
    # records consumed per C call before control returns to Python:
    # bounds progress/stop() latency; lowering it trades fewer, fuller
    # candidate batches for finer reader/device overlap
    parse_cap = int(os.environ.get('KVARQ_PARSE_CAP', '0'))
    h = lib.kvq_open(names, len(fnames), Amin, minreadlength, nthreads,
                     parse_cap)
    if sieve is not None:
        # the C side keeps pointers; hold the arrays until kvq_close
        sieve_arrays = [
            np.ascontiguousarray(sieve.start, dtype=np.int32),
            np.ascontiguousarray(sieve.gpos, dtype=np.int32),
            np.ascontiguousarray(sieve.gtid, dtype=np.int32),
            np.ascontiguousarray(sieve.tstart, dtype=np.int32),
            np.ascontiguousarray(sieve.tstop, dtype=np.int32),
            np.ascontiguousarray(sieve.bank_codes, dtype=np.uint8),
        ]
        lib.kvq_set_sieve(h, *sieve_arrays, sieve.k, sieve.t,
                          sieve.m, sieve.maxerrors)
    rls_buf = np.zeros(MAX_READLENGTH, dtype=np.int64)

    def sync_stats():
        rp = ctypes.c_int64()
        pa = ctypes.c_int64()
        to = ctypes.c_int64()
        lg = ctypes.c_int64()
        lib.kvq_stats(h, ctypes.byref(rp), ctypes.byref(pa),
                      ctypes.byref(to), ctypes.byref(lg), rls_buf)
        stats.records_parsed = rp.value
        stats.parsed = pa.value
        stats.total = to.value
        stats.rls_longest = lg.value
        stats.rls[:] = rls_buf

    # buffers are reused across batches (yielded arrays are copies) --
    # fresh allocations would pay one soft page fault per written row.
    # The stride grows on demand when a read exceeds it (long-read
    # FastQs; kvq_next returns -2 without consuming anything)
    stride = MAX_READLENGTH
    raw = np.zeros((batchsize, stride), dtype=np.uint8)
    codes = np.zeros((batchsize, stride), dtype=np.uint8)
    rl = np.empty(batchsize, dtype=np.int32)
    fp = np.empty(batchsize, dtype=np.int64)

    try:
        while True:
            if stop_check is not None and stop_check():
                break
            maxrl = ctypes.c_int32()
            n = lib.kvq_next(h, batchsize, stride, raw, codes,
                             rl, fp, ctypes.byref(maxrl))
            sync_stats()
            if n == -2:
                stride = reader._round_up(int(lib.kvq_pending_rl(h)))
                raw = np.zeros((batchsize, stride), dtype=np.uint8)
                codes = np.zeros((batchsize, stride), dtype=np.uint8)
                continue
            if n < 0:
                raise reader.FastqFormatError(
                    lib.kvq_error(h).decode())
            if n == 0:
                break
            Lpad = reader._round_up(int(maxrl.value))
            codes_b = np.ascontiguousarray(codes[:n, :Lpad])
            raw_b = np.ascontiguousarray(raw[:n, :Lpad])
            # rows are only filled up to rl by the C side; pad vectorized
            pad = np.arange(Lpad, dtype=np.int32)[None, :] >= rl[:n, None]
            codes_b[pad] = encode.CODE_READ_JUNK
            raw_b[pad] = 0
            yield reader.RecordBatch(codes_b, rl[:n].copy(),
                                     fp[:n].copy(), raw_b)
    finally:
        lib.kvq_close(h)
