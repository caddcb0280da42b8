'''
Tensorized-scan parity: the on-device coverage accumulation path
(engine.countseqs / Analyser.scan(keep_hits=False)) must produce coverages,
stats and analysis results identical to the hit-list path.
'''

import os.path

import numpy as np
import pytest

from kvarq_tpu import engine
from kvarq_tpu import genes
from kvarq_tpu import analyse
from kvarq_tpu.fastq import Fastq
from kvarq_tpu.engine import encode, reader
from kvarq_tpu.engine.tensor_scan import TensorScanner

HERE = os.path.abspath(os.path.dirname(__file__))
MTBC = os.path.join(HERE, os.path.pardir, 'testsuites', 'MTBC')
FASTQS = os.path.join(HERE, 'fastqs')

COMPL = {'A': 'T', 'T': 'A', 'C': 'G', 'G': 'C', 'N': 'N'}


def _revcomp(s):
    return ''.join(COMPL[c] for c in reversed(s))


def _hitpath_basecounts(fname, seqs):
    ''' hit-list path -> per-template [5, S] base counts in scanned-strand
        coordinates '''
    ret = engine.findseqs(fname, seqs)
    bcs = [np.zeros((encode.NBASE, len(s)), dtype=np.int64) for s in seqs]
    for hit, hs in zip(ret['hits'], ret['hitseqs']):
        start = max(0, hit.seq_pos)
        codes = encode.encode_read(hs.encode('latin-1'))
        for i in range(hit.length):
            bcs[hit.seq_nr][codes[i], start + i] += 1
    return bcs, ret['stats']


@pytest.mark.parametrize('maxerrors,minoverlap,minreadlength,Amin', [
    (0, 20, 10, '!'),
    (2, 3, 3, '!'),
    (1, 10, 5, '#'),
])
def test_countseqs_matches_findseqs(maxerrors, minoverlap, minreadlength,
                                    Amin):
    fname = os.path.join(FASTQS, 'test_engine.fastq')
    plus = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG',
            'CCCC', 'CCC']
    seqs = plus + [_revcomp(s) for s in plus]

    engine.config(maxerrors=maxerrors, minoverlap=minoverlap,
                  minreadlength=minreadlength, Amin=Amin)
    ref_bcs, ref_stats = _hitpath_basecounts(fname, seqs)

    engine.config(maxerrors=maxerrors, minoverlap=minoverlap,
                  minreadlength=minreadlength, Amin=Amin)
    ret = engine.countseqs(fname, seqs)

    for r, g in zip(ref_bcs, ret['basecounts']):
        assert np.array_equal(r, g)
    assert ret['stats'] == ref_stats


def test_small_scan_fast_path(monkeypatch):
    ''' the small-input numpy fast path of countseqs (engaged for tiny
        files on cold devices, disabled suite-wide in conftest) must
        return basecounts/stats identical to the tensorized path '''
    fname = os.path.join(FASTQS, 'test_engine.fastq')
    plus = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG',
            'CCCC', 'CCC']
    seqs = plus + [_revcomp(s) for s in plus]

    engine.config(maxerrors=1, minoverlap=10, minreadlength=5, Amin='#')
    ref = engine.countseqs(fname, seqs)            # tensor path (conftest)

    monkeypatch.setattr(engine, 'SMALL_SCAN_BYTES', 10 ** 9)
    monkeypatch.setattr(engine, '_jax_device_ready', lambda: False)
    assert engine._small_scan_eligible([fname])
    engine.config(maxerrors=1, minoverlap=10, minreadlength=5, Amin='#')
    got = engine.countseqs(fname, seqs)            # numpy fast path

    assert got['stats'] == ref['stats']
    for r, g in zip(ref['basecounts'], got['basecounts']):
        assert np.array_equal(np.asarray(r, np.int64),
                              np.asarray(g, np.int64))

    # never engages with an explicit backend selection or a mesh
    engine.config(backend='numpy')
    assert not engine._small_scan_eligible([fname])
    engine.config(backend='auto', mesh='auto')
    assert not engine._small_scan_eligible([fname])
    engine.config(mesh='')


def test_analyser_tensorized_parity():
    ''' full-stack: Analyser.scan(keep_hits=False) == hit path on the
        crafted fixture with real testsuites (exercises minus-strand
        folding into Coverage and the exact serialized format) '''
    if not os.path.exists(os.path.join(MTBC,
                                       'MTB_ancestor_reference.bases')):
        pytest.skip('run tools/reconstruct_genome.py first')
    from kvarq_tpu.log import set_warning
    set_warning()
    suites = {
        'phylo': genes.load_testsuite(os.path.join(MTBC, 'phylo.py')),
        'spoligo': genes.load_testsuite(os.path.join(MTBC, 'spoligo.py')),
    }
    fname = os.path.join(FASTQS, 'test_analyser.fastq')

    engine.config(nthreads=1, minoverlap=10, maxerrors=1,
                  minreadlength=10, Amin='!')
    a1 = analyse.Analyser()
    a1.scan(Fastq(fname, quiet=True), suites, keep_hits=True)
    a1.update_testsuites()

    engine.config(nthreads=1, minoverlap=10, maxerrors=1,
                  minreadlength=10, Amin='!')
    a2 = analyse.Analyser()
    a2.scan(Fastq(fname, quiet=True), suites, keep_hits=False)
    a2.update_testsuites()

    assert a2.hits is None
    for name in a1.coverages:
        assert a1.coverages[name].serialize() == \
            a2.coverages[name].serialize(), name
    assert a1.stats == a2.stats
    assert a1.results == a2.results

    # encoded json identical apart from timing metadata
    e1, e2 = a1.encode(), a2.encode()
    for k in ('analyses', 'stats', 'coverages'):
        assert e1[k] == e2[k]


def test_tensorized_subbatching():
    ''' ELEM_BUDGET sub-batching + rl=0 padding rows change nothing '''
    fname = os.path.join(FASTQS, 'test_engine.fastq')
    seqs = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'CCC']

    engine.config(maxerrors=1, minoverlap=5, minreadlength=5, Amin='!')
    ref_bcs, _ = _hitpath_basecounts(fname, seqs)

    engine.config(maxerrors=1, minoverlap=5, minreadlength=5, Amin='!')
    sc = TensorScanner(seqs, 1, 5)
    sc.ELEM_BUDGET = 1  # force sub=64 with padding
    stats = reader.ReaderStats()
    for batch in reader.batches([fname], ord('!'), 5, stats):
        sc.scan_batch(batch)
    for r, g in zip(ref_bcs, sc.coverages()):
        assert np.array_equal(r, g.astype(np.int64))


def test_mode_weights_closed_form():
    ''' the reduced closed-form gating in mode_weights must equal the
        four-mode enumeration (hitmodel.weights_for_d) for every
        (rl, seql, minoverlap, d) on a dense grid '''
    import numpy as np
    import jax.numpy as jnp
    from kvarq_tpu.engine import hitmodel
    from kvarq_tpu.engine.tensor_scan import mode_weights

    for mo in (1, 3, 5, 10, 25):
        rls = np.arange(0, 40, dtype=np.int32)
        for seql in range(1, 40):
            d = np.arange(-41, seql + 3, dtype=np.int32)
            # zero matches => mism == ov; pick maxerrors large so the
            # mismatch gate never blocks and w reflects nmodes alone
            matches = jnp.zeros((len(rls), len(d)), jnp.float32)
            w, _ = mode_weights(
                matches, jnp.asarray(rls)[:, None], jnp.asarray(d)[None, :],
                jnp.full((1, len(d)), seql, jnp.int32),
                jnp.ones((1, len(d)), jnp.int32),
                maxerrors=10**6, minoverlap=mo)
            w = np.asarray(w)
            for bi, rl in enumerate(rls):
                if rl == 0:
                    assert not w[bi].any()
                    continue
                ref = hitmodel.weights_for_d(d, int(rl), seql, mo)
                np.testing.assert_array_equal(
                    w[bi], ref.astype(np.float32),
                    err_msg='rl=%d seql=%d mo=%d' % (rl, seql, mo))


def test_gather_k_default_and_buckets(monkeypatch):
    ''' KVARQ_GATHER_K parsing + the adaptive upward bucket policy
        (hardware integration is exercised by bench.py's bit-exactness
        gate on the real device, where a dense warmup logs the switch) '''
    from kvarq_tpu.engine import tensor_scan

    monkeypatch.delenv('KVARQ_GATHER_K', raising=False)
    assert tensor_scan.default_gather_k() == (768, True)
    monkeypatch.setenv('KVARQ_GATHER_K', '1024')
    assert tensor_scan.default_gather_k() == (1024, False)
    monkeypatch.setenv('KVARQ_GATHER_K', 'auto')
    assert tensor_scan.default_gather_k() == (768, True)

    monkeypatch.delenv('KVARQ_GATHER_K', raising=False)
    sc = TensorScanner(['CACCGGTGTAGGCAAGTCGTAACAAGG'], 1, 5)
    sc.backend = 'screen'         # policy test only; no device dispatch
    sc._gather_auto = True
    sc.gather_k = 768
    # below the margin: no change
    assert not sc._adapt_gather(128, 500)
    assert sc.gather_k == 768
    # overflow: next bucket that clears mean + 8*sqrt + 64
    assert sc._adapt_gather(128, 900)
    assert sc.gather_k == 1536
    assert sc._adapt_gather(128, 5000)
    assert sc.gather_k == 6144
    # beyond the last bucket: terminal dense mode (no screen/compaction)
    assert sc._adapt_gather(128, 16000)
    assert sc.gather_k == 0
    assert not sc._adapt_gather(128, 16000)
    # pinned mode never adapts
    sc._gather_auto = False
    sc.gather_k = 768
    assert not sc._adapt_gather(128, 16000)
    assert sc.gather_k == 768


def test_adapt_gather_rebuilds_in_place(monkeypatch):
    ''' mid-scan gather_k adaptation must keep every Lpad context alive:
        finalize()/coverages() dereference self._ctx[Lpad] for all
        already-scanned buckets (regression: contexts were deleted,
        crashing coverages() with KeyError after a full corpus scan) '''
    from kvarq_tpu.engine import tensor_scan

    fname = os.path.join(FASTQS, 'test_engine.fastq')
    seqs = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'CCC']
    engine.config(maxerrors=1, minoverlap=5, minreadlength=5, Amin='!')
    ref_bcs, _ = _hitpath_basecounts(fname, seqs)

    sc = TensorScanner(seqs, 1, 5)
    stats = reader.ReaderStats()
    for batch in reader.batches([fname], ord('!'), 5, stats):
        sc.scan_batch(batch)
    sc.finalize()

    # simulate the overflow-driven switch on the live scanner (the
    # rebuild path is backend-agnostic once entered)
    (lpad,) = sc._ctx.keys()
    sc.backend = 'screen'
    sc._gather_auto = True
    sc.gather_k = 768
    real = tensor_scan._cached_context

    def fake_ctx(seqs_t, lp, me, mo, backend, fuse, gk=None):
        ctx = sc._ctx[lp]
        return ctx['bank'], ctx['arrays'], ctx['step'], ctx['sub']
    monkeypatch.setattr(tensor_scan, '_cached_context', fake_ctx)
    assert sc._adapt_gather(lpad, 5000)
    assert lpad in sc._ctx                 # context survived the switch
    monkeypatch.setattr(tensor_scan, '_cached_context', real)

    for r, g in zip(ref_bcs, sc.coverages()):   # no KeyError, exact
        assert np.array_equal(r, g.astype(np.int64))


def test_tensor_scanner_dense_screen_parity():
    ''' TensorScanner with backend='screen' + assume_dense() (the
        production countseqs path on sieve-fed batches) must equal the
        hit path -- covering the gather_k=0 context build + fuse padding
        through the real scanner. '''
    fname = os.path.join(FASTQS, 'test_engine.fastq')
    seqs = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG', 'CCC']

    engine.config(maxerrors=1, minoverlap=5, minreadlength=5, Amin='!')
    ref_bcs, ref_stats = _hitpath_basecounts(fname, seqs)

    sc = TensorScanner(seqs, 1, 5, backend='screen')
    sc.assume_dense()
    assert sc.gather_k == 0
    stats = reader.ReaderStats()
    for batch in reader.batches([fname], ord('!'), 5, stats):
        sc.scan_batch(batch)
    sc.finalize()
    for r, g in zip(ref_bcs, sc.coverages()):
        assert np.array_equal(r, g.astype(np.int64))
    np.testing.assert_array_equal(
        np.asarray(ref_stats['nseqhits']), sc.seqhits)


@pytest.mark.parametrize('gather_k', ['auto', '1'])
def test_tensor_scanner_screen_parity(monkeypatch, gather_k):
    ''' the screened countseqs path (unsieved input: candidate screen,
        compaction, and -- with gather_k pinned to 1 -- the full-batch
        fallback) must equal the hit path '''
    monkeypatch.setenv('KVARQ_GATHER_K', gather_k)
    fname = os.path.join(FASTQS, 'test_engine.fastq')
    seqs = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG', 'CCC']

    engine.config(maxerrors=1, minoverlap=5, minreadlength=5, Amin='!')
    ref_bcs, ref_stats = _hitpath_basecounts(fname, seqs)

    sc = TensorScanner(seqs, 1, 5, backend='screen')
    stats = reader.ReaderStats()
    for batch in reader.batches([fname], ord('!'), 5, stats):
        sc.scan_batch(batch)
    sc.finalize()
    for r, g in zip(ref_bcs, sc.coverages()):
        assert np.array_equal(r, g.astype(np.int64))
    np.testing.assert_array_equal(
        np.asarray(ref_stats['nseqbasehits']), sc.seqbasehits)


def test_resolve_backend(monkeypatch):
    ''' tensor-scan backend choice: explicit > env > capability (the
        CPU resolves to xla); unknown names are refused '''
    from kvarq_tpu.engine.tensor_scan import resolve_backend
    monkeypatch.delenv('KVARQ_TENSOR_BACKEND', raising=False)
    assert resolve_backend() == 'xla'
    assert resolve_backend('screen') == 'screen'
    monkeypatch.setenv('KVARQ_TENSOR_BACKEND', 'screen')
    assert resolve_backend() == 'screen'
    with pytest.raises(ValueError):
        resolve_backend('pallas')
