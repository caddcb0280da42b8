'''
On-card bit-exactness: scans a small synthetic FastQ with the device
paths and asserts hit statistics AND per-position base counts equal the
byte-exact numpy oracle.

Marked ``gpu``: skipped unless ``KVARQ_TEST_GPU=1`` (run:
``KVARQ_TEST_GPU=1 pytest -m gpu``; ``python chip_smoke.py`` runs them in
its last phase).  ``bench.py`` performs the same oracle gate on every
benchmark run, so a miscounting step can never ship a perf number
silently.
'''

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _synthetic_case(tmp_path, n_reads=4096, readlen=101, seed=7):
    import bench
    rng = np.random.RandomState(seed)
    seqs = []
    for _ in range(40):
        n = rng.randint(30, 90)
        seqs.append(bytes(rng.choice(
            np.frombuffer(b'ACGT', np.uint8), n)).decode())
    path = str(tmp_path / 'smoke.fastq')
    bench.generate_fastq(path, seqs, n_reads, readlen, seed=seed)
    return path, seqs


@pytest.mark.parametrize('sieve', ['auto', 'off'])
def test_device_matches_oracle(tmp_path, sieve):
    ''' countseqs on the card (sieve on: dense step; off: candidate
        screen) == the numpy oracle '''
    import bench
    from kvarq_tpu import engine
    from kvarq_tpu.engine.tensor_scan import resolve_backend
    assert resolve_backend() == 'screen'

    path, seqs = _synthetic_case(tmp_path)
    engine.config(maxerrors=2, minoverlap=25, minreadlength=25,
                  nthreads=2, Amin=chr(33 + 13), sieve=sieve)

    ret = engine.countseqs(path, seqs)
    assert int(np.asarray(ret['stats']['nseqhits']).sum()) > 0
    # raises SystemExit on any divergence
    bench.assert_device_matches_oracle(ret, path, seqs)


def test_sharded_screen_on_hardware(tmp_path):
    ''' ShardedScanner (screen backend) on a real-device 1x1 mesh is
        bit-equal to the numpy oracle '''
    import jax
    import bench
    from kvarq_tpu import engine
    from kvarq_tpu.parallel import make_mesh, ShardedScanner
    from kvarq_tpu.engine import reader

    path, seqs = _synthetic_case(tmp_path)
    engine.config(maxerrors=2, minoverlap=25, minreadlength=25,
                  nthreads=2, Amin=chr(33 + 13))

    mesh = make_mesh(1, 1, jax.devices()[:1])
    scanner = ShardedScanner(seqs, maxerrors=2, minoverlap=25, mesh=mesh)
    assert scanner.backend == 'screen'
    stats = reader.ReaderStats()
    for batch in reader.prefetch(reader.batches(
            [path], ord(chr(33 + 13)), 25, stats, batchsize=16384,
            nthreads=2)):
        scanner.scan_batch(batch)
    scanner.finalize()
    ret = {
        'basecounts': [bc.astype(np.int64) for bc in scanner.coverages()],
        'stats': {
            'nseqhits': tuple(int(x) for x in scanner.seqhits),
            'nseqbasehits': tuple(int(x) for x in scanner.seqbasehits),
            'records_parsed': int(stats.records_parsed),
        },
    }
    assert int(scanner.seqhits.sum()) > 0
    # raises SystemExit on any divergence from the numpy oracle
    bench.assert_device_matches_oracle(ret, path, seqs)


@pytest.mark.parametrize('backend', ['auto', 'screen'])
def test_findseqs_backends_agree(tmp_path, backend):
    ''' the device hit-list paths == numpy hit list on the card '''
    from kvarq_tpu import engine

    path, seqs = _synthetic_case(tmp_path, n_reads=2048)
    engine.config(maxerrors=2, minoverlap=25, minreadlength=25,
                  nthreads=2, Amin=chr(33 + 13))

    engine.config(backend='numpy', sieve='off')
    ref = engine.findseqs(path, seqs)
    engine.config(backend=backend, sieve='auto')
    out = engine.findseqs(path, seqs)
    assert out['hits'] == ref['hits']
    assert out['hitseqs'] == ref['hitseqs']
