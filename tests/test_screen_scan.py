'''
Candidate-screen scan path (kvarq_tpu.engine.screen_scan): bit-equality
with the XLA tensor path on random reads/templates, and soundness of the
screen against the exact mode weights.
'''

import numpy as np
import pytest

from kvarq_tpu.engine import encode
from kvarq_tpu.engine.tensor_scan import (
    build_bank, bank_device_arrays, scan_step_fn)
from kvarq_tpu.engine import screen_scan

BASES = np.frombuffer(b'ACGTN', dtype=np.uint8)


def _random_case(rng, nseq, B, Lpad, minlen=5, maxlen=60):
    seqs = []
    for _ in range(nseq):
        n = rng.randint(minlen, maxlen + 1)
        seqs.append(bytes(rng.choice(BASES[:4], n)).decode())
    raw = rng.choice(BASES[:4], (B, Lpad)).astype(np.uint8)
    rl = rng.randint(0, Lpad + 1, B).astype(np.int32)
    # plant some template substrings so hits actually occur
    for b in range(0, B, 3):
        s = seqs[rng.randint(nseq)].encode()
        off = rng.randint(0, max(1, Lpad - len(s)))
        raw[b, off:off + len(s)] = np.frombuffer(s, np.uint8)[:Lpad - off]
        rl[b] = max(rl[b], min(Lpad, off + len(s)))
    codes = encode.encode_read_array(raw)
    pad = np.arange(Lpad)[None, :] >= rl[:, None]
    codes[pad] = encode.CODE_READ_JUNK
    raw = raw.copy()
    raw[pad] = 0
    return seqs, codes, rl, raw


@pytest.mark.parametrize('maxerrors,minoverlap', [(0, 25), (2, 25), (3, 8)])
def test_screen_matches_xla(maxerrors, minoverlap):
    import jax.numpy as jnp

    rng = np.random.RandomState(42 + maxerrors)
    Lpad, B = 64, 16
    seqs, codes, rl, _ = _random_case(rng, nseq=7, B=B, Lpad=Lpad)
    T = len(seqs)

    bank = build_bank(seqs, Lpad, minoverlap)
    xla_step = scan_step_fn(Lpad, bank.G, T, maxerrors, minoverlap,
                            dtype_name='float32')
    ref = xla_step(jnp.asarray(codes), jnp.asarray(rl),
                   **bank_device_arrays(bank, dtype=jnp.float32))

    pstep = screen_scan.scan_step(Lpad, bank, T, maxerrors, minoverlap,
                                  B, gather_k=8)
    arrays = screen_scan.device_arrays(bank)
    out = pstep(jnp.asarray(codes), jnp.asarray(rl), **arrays)

    for name, a, b in zip(('basecount', 'seqhits', 'seqbasehits'),
                          ref, out):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b), err_msg=name)


def test_screen_matcher_parity():
    ''' the ``screen`` hit backend (screen prefilter on one device + XLA
        triplet extraction) returns exactly the numpy matcher's (read,
        template, shift) triplets '''
    from kvarq_tpu.engine import make_matcher
    from kvarq_tpu.engine.match_numpy import NumpyMatcher
    from kvarq_tpu.engine.reader import RecordBatch

    rng = np.random.RandomState(11)
    Lpad, B = 64, 32
    seqs, codes, rl, raw = _random_case(rng, nseq=5, B=B, Lpad=Lpad)

    batch = RecordBatch(codes, rl, np.zeros(B, np.int64), raw)
    ref = NumpyMatcher(seqs, 2, 20).match_batch(batch)
    matcher = make_matcher(seqs, 'screen', 2, 20)
    assert matcher.mesh.size == 1
    out = matcher.match_batch(batch)

    def key(tri):
        return sorted(map(tuple, tri))
    assert key(out) == key(ref)
    assert len(out) > 0


def test_screen_gather_fallback():
    ''' more hitting reads than gather_k -> the cond fallback computes the
        full contraction; results must stay identical '''
    import jax.numpy as jnp

    rng = np.random.RandomState(7)
    Lpad, B = 64, 16
    seqs, codes, rl, _ = _random_case(rng, nseq=3, B=B, Lpad=Lpad)
    T = len(seqs)
    bank = build_bank(seqs, Lpad, 10)

    xla_step = scan_step_fn(Lpad, bank.G, T, 1, 10, dtype_name='float32')
    ref = xla_step(jnp.asarray(codes), jnp.asarray(rl),
                   **bank_device_arrays(bank, dtype=jnp.float32))

    pstep = screen_scan.scan_step(Lpad, bank, T, 1, 10, B, gather_k=1)
    arrays = screen_scan.device_arrays(bank)
    out = pstep(jnp.asarray(codes), jnp.asarray(rl), **arrays)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_screen_dense_mode():
    ''' gather_k=0 (the terminal adaptive state for hit-dense workloads)
        drops the screen entirely and must still be exact '''
    import jax.numpy as jnp

    rng = np.random.RandomState(13)
    Lpad, B = 64, 16
    seqs, codes, rl, _ = _random_case(rng, nseq=4, B=B, Lpad=Lpad)
    T = len(seqs)
    bank = build_bank(seqs, Lpad, 10)

    xla_step = scan_step_fn(Lpad, bank.G, T, 1, 10, dtype_name='float32')
    ref = xla_step(jnp.asarray(codes), jnp.asarray(rl),
                   **bank_device_arrays(bank, dtype=jnp.float32))

    pstep = screen_scan.scan_step(Lpad, bank, T, 1, 10, B, gather_k=0,
                                  with_count=True)
    arrays = screen_scan.device_arrays(bank)
    out = pstep(jnp.asarray(codes), jnp.asarray(rl), **arrays)
    assert int(np.asarray(out[3])) == 0      # dense mode reports no count
    for a, b in zip(ref, out[:3]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize('maxerrors,minoverlap,seed',
                         [(0, 25, 1), (2, 25, 2), (3, 8, 3), (1, 12, 4)])
def test_screen_superset_of_mode_weights(maxerrors, minoverlap, seed):
    ''' soundness: every (read, shift) with a nonzero exact mode weight
        passes the screen, so every hitting read is a candidate -- and
        the screen is not trivially all-pass '''
    import jax
    import jax.numpy as jnp
    from kvarq_tpu.engine.tensor_scan import mode_weights

    rng = np.random.RandomState(100 + seed)
    Lpad, B = 64, 48
    seqs, codes, rl, _ = _random_case(rng, nseq=6, B=B, Lpad=Lpad)
    bank = build_bank(seqs, Lpad, minoverlap)
    arrays = screen_scan.device_arrays(bank)
    K, qmeta = arrays['K'], arrays['qmeta']
    nch = K.shape[0] // Lpad
    read_flat = jax.nn.one_hot(jnp.asarray(codes), nch, dtype=K.dtype) \
        .reshape(B, -1)

    counts = np.asarray(screen_scan.screen_counts(
        read_flat, jnp.asarray(rl), K, qmeta, maxerrors, minoverlap))
    m = jnp.dot(read_flat, K, preferred_element_type=jnp.float32)
    R = screen_scan
    w, _ = mode_weights(m, jnp.asarray(rl)[:, None],
                        qmeta[R.ROW_D:R.ROW_D + 1],
                        qmeta[R.ROW_SEQL:R.ROW_SEQL + 1],
                        qmeta[R.ROW_VALID:R.ROW_VALID + 1],
                        maxerrors, minoverlap)
    hits = np.asarray(w).sum(axis=1) > 0
    assert hits.any()
    assert (counts[hits] > 0).all()
    assert not (counts > 0).all()
