'''
Multi-chip sharding tests on the virtual 8-device CPU mesh: the sharded
scanner must produce bitwise-identical coverages/stats to the single-device
tensor scanner and to the hit-list path, for every mesh shape.
'''

import os.path

import numpy as np
import pytest

from kvarq_tpu import engine
from kvarq_tpu.engine import encode, reader
from kvarq_tpu import parallel

HERE = os.path.abspath(os.path.dirname(__file__))
FASTQS = os.path.join(HERE, 'fastqs')

COMPL = {'A': 'T', 'T': 'A', 'C': 'G', 'G': 'C', 'N': 'N'}


def _revcomp(s):
    return ''.join(COMPL[c] for c in reversed(s))


def _hitpath_basecounts(fname, seqs):
    ret = engine.findseqs(fname, seqs)
    bcs = [np.zeros((encode.NBASE, len(s)), dtype=np.int64) for s in seqs]
    for hit, hs in zip(ret['hits'], ret['hitseqs']):
        start = max(0, hit.seq_pos)
        codes = encode.encode_read(hs.encode('latin-1'))
        for i in range(hit.length):
            bcs[hit.seq_nr][codes[i], start + i] += 1
    return bcs, ret['stats']


@pytest.mark.parametrize('n_data,n_bank', [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_equals_hitpath(n_data, n_bank):
    import jax
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 (virtual) devices')

    fname = os.path.join(FASTQS, 'test_engine.fastq')
    plus = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG',
            'CCCC', 'CCC']
    seqs = plus + [_revcomp(s) for s in plus]

    engine.config(maxerrors=1, minoverlap=5, minreadlength=5, Amin='!')
    ref_bcs, ref_stats = _hitpath_basecounts(fname, seqs)

    mesh = parallel.make_mesh(n_data, n_bank)
    scanner = parallel.ShardedScanner(seqs, maxerrors=1, minoverlap=5,
                                      mesh=mesh)
    stats = reader.ReaderStats()
    for batch in reader.batches([fname], ord('!'), 5, stats):
        scanner.scan_batch(batch)

    for t, (r, g) in enumerate(zip(ref_bcs, scanner.coverages())):
        assert np.array_equal(r, g.astype(np.int64)), 'template %d' % t
    assert np.array_equal(np.asarray(ref_stats['nseqhits']),
                          scanner.seqhits)
    assert np.array_equal(np.asarray(ref_stats['nseqbasehits']),
                          scanner.seqbasehits)


def test_odd_batch_padding():
    ''' batches not divisible by the data axis are padded with rl=0 rows '''
    import jax
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 (virtual) devices')

    seqs = ['CACCGGTGTAGGCAAGTCGTAACAA']
    mesh = parallel.make_mesh(8, 1)
    scanner = parallel.ShardedScanner(seqs, maxerrors=0, minoverlap=10,
                                      mesh=mesh)
    B, Lpad = 13, 64  # 13 % 8 != 0
    raw = np.full((B, Lpad), ord('G'), dtype=np.uint8)
    raw[3, :25] = np.frombuffer(seqs[0].encode(), dtype=np.uint8)
    codes = encode.encode_read_array(raw)
    rl = np.full(B, 40, dtype=np.int32)
    scanner.scan_batch(reader.RecordBatch(
        codes, rl, np.zeros(B, dtype=np.int64), raw))
    assert int(scanner.seqhits[0]) == 1
    depth = scanner.coverages()[0].sum(axis=0)
    assert depth[:25].tolist() == [1] * 25


@pytest.mark.parametrize('n_data,n_bank,dense',
                         [(4, 2, False), (2, 1, False),
                          (4, 2, True), (2, 1, True)])
def test_sharded_screen_equals_hitpath(n_data, n_bank, dense):
    ''' the per-device candidate-screen step under shard_map matches the
        hit-list path bitwise -- both the screened path and the dense
        (assume_dense, no-screen) path '''
    import jax
    if len(jax.devices()) < n_data * n_bank:
        pytest.skip('needs %d (virtual) devices' % (n_data * n_bank))

    fname = os.path.join(FASTQS, 'test_engine.fastq')
    plus = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG',
            'CCCC', 'CCC']
    seqs = plus + [_revcomp(s) for s in plus]

    engine.config(maxerrors=1, minoverlap=5, minreadlength=5, Amin='!')
    ref_bcs, ref_stats = _hitpath_basecounts(fname, seqs)

    mesh = parallel.make_mesh(n_data, n_bank)
    scanner = parallel.ShardedScanner(seqs, maxerrors=1, minoverlap=5,
                                      mesh=mesh, backend='screen')
    scanner.B_LOCAL = 8
    if dense:
        scanner.assume_dense()
        assert scanner.dense
    stats = reader.ReaderStats()
    for batch in reader.batches([fname], ord('!'), 5, stats,
                                batchsize=16):
        scanner.scan_batch(batch)

    for t, (r, g) in enumerate(zip(ref_bcs, scanner.coverages())):
        assert np.array_equal(r, g.astype(np.int64)), 'template %d' % t
    assert np.array_equal(np.asarray(ref_stats['nseqhits']),
                          scanner.seqhits)
    assert np.array_equal(np.asarray(ref_stats['nseqbasehits']),
                          scanner.seqbasehits)


def test_dryrun():
    import jax
    n = min(8, len(jax.devices()))
    parallel.dryrun(n)


@pytest.mark.parametrize('n_data,n_bank', [(4, 2), (8, 1)])
def test_multihost_driver_single_process(n_data, n_bank):
    ''' the multi-host scan driver (kvarq_tpu.parallel.multihost) in its
        single-process degenerate mode must reproduce the hit-list
        path's coverages and stats exactly '''
    import jax
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 (virtual) devices')
    from kvarq_tpu.parallel import multihost

    fname = os.path.join(FASTQS, 'test_engine.fastq')
    plus = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG']
    seqs = plus + [_revcomp(s) for s in plus]

    engine.config(maxerrors=1, minoverlap=5, minreadlength=5, Amin='!')
    ref_bcs, ref_stats = _hitpath_basecounts(fname, seqs)

    mesh = parallel.make_mesh(n_data, n_bank)
    covs, seqhits, seqbasehits = multihost.scan_sharded(
        [fname], seqs, maxerrors=1, minoverlap=5, minreadlength=5,
        Amin='!', mesh=mesh, nthreads=2, b_local=16)

    for t, (r, g) in enumerate(zip(ref_bcs, covs)):
        assert np.array_equal(r, g.astype(np.int64)), 'template %d' % t
    assert np.array_equal(np.asarray(ref_stats['nseqhits']), seqhits)
    assert np.array_equal(np.asarray(ref_stats['nseqbasehits']),
                          seqbasehits)


def test_multihost_shard_files():
    from kvarq_tpu.parallel import multihost
    names = [os.path.join(FASTQS, f) for f in (
        'test_engine.fastq', 'test_engine_1.fastq', 'test_engine_2.fastq',
        'L3_N1014_hits_5k.fastq')]
    shards = [multihost.shard_files(names, pid, 3) for pid in range(3)]
    flat = sorted(sum(shards, []))
    assert flat == sorted(names)          # partition, no dup/loss
    # deterministic across calls
    assert shards == [multihost.shard_files(names, p, 3) for p in range(3)]


@pytest.mark.parametrize('n_data,n_bank,b_local',
                         [(4, 2, 16), (8, 1, 16), (2, 2, 8)])
def test_sharded_matcher_parity(n_data, n_bank, b_local):
    ''' ShardedMatcher (the --mesh hit path) returns exactly the numpy
        matcher's (read, template, shift) triplets for every mesh shape
        and per-device batch size '''
    import jax
    if len(jax.devices()) < n_data * n_bank:
        pytest.skip('needs %d (virtual) devices' % (n_data * n_bank))
    from kvarq_tpu.engine.match_numpy import NumpyMatcher

    fname = os.path.join(FASTQS, 'test_engine.fastq')
    plus = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG',
            'CCCC', 'CCC']
    seqs = plus + [_revcomp(s) for s in plus]

    engine.config(maxerrors=1, minoverlap=5, minreadlength=5, Amin='!')
    mesh = parallel.make_mesh(n_data, n_bank)
    matcher = parallel.ShardedMatcher(seqs, 1, 5, mesh=mesh,
                                      b_local=b_local)
    ref = NumpyMatcher(seqs, 1, 5)

    stats = reader.ReaderStats()
    for batch in reader.batches([fname], ord('!'), 5, stats,
                                batchsize=32):
        want = sorted(map(tuple, ref.match_batch(batch)))
        got = sorted(map(tuple, matcher.match_batch(batch)))
        assert got == want


def test_findseqs_mesh_equals_plain():
    ''' engine.findseqs with a mesh configured equals the plain scan:
        same hits (incl. file_pos), same stats '''
    import jax
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 (virtual) devices')

    fname = os.path.join(FASTQS, 'test_engine.fastq')
    seqs = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG']

    engine.config(maxerrors=1, minoverlap=5, minreadlength=5, Amin='!')
    try:
        engine.config(mesh='')
        ref = engine.findseqs(fname, seqs)
        engine.config(mesh='4x2')
        got = engine.findseqs(fname, seqs)
    finally:
        engine.config(mesh='')
    assert [h._asdict() if hasattr(h, '_asdict') else tuple(h)
            for h in got['hits']] == \
        [h._asdict() if hasattr(h, '_asdict') else tuple(h)
         for h in ref['hits']]
    assert got['hitseqs'] == ref['hitseqs']
    assert got['stats']['nseqhits'] == ref['stats']['nseqhits']

