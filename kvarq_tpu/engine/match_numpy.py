'''
Exact, byte-faithful reference matcher (numpy).  This is the golden model
the device backends are verified against.

It compares raw read bytes against raw template bytes -- exactly like the C
engine's inner loops (workhorse.c:1118-1171) -- vectorized over the batch and
over alignment shifts instead of nested per-byte loops.
'''

import numpy as np

from kvarq_tpu.engine import hitmodel


def weights_grid(d_row, rl_col, seql, mo):
    '''
    hit multiplicity w(d) for a [B, D] grid: ``d_row`` [D] shifts,
    ``rl_col`` [B, 1] read lengths.  Vectorized version of
    :py:func:`kvarq_tpu.engine.hitmodel.weights_for_d`.
    '''
    d = d_row[None, :]
    rl = rl_col
    w = np.zeros((rl.shape[0], d.shape[1]), dtype=np.int8)

    ab = (rl > mo) & (seql > mo)
    # mode A: i=-d in [max(1, rl-seql+1), rl-mo]
    i = -d
    w += (ab & (i >= 1) & (i >= rl - seql + 1) & (i <= rl - mo)).astype(np.int8)
    # mode B: d in [max(1, seql-rl), seql-mo]
    w += (ab & (d >= 1) & (d >= seql - rl) & (d <= seql - mo)).astype(np.int8)
    # mode C (rl>seql): -d in [0, rl-seql]
    w += ((rl > seql) & (d <= 0) & (-d <= rl - seql)).astype(np.int8)
    # mode D (rl<=seql): d in [0, seql-rl]
    w += ((rl <= seql) & (d >= 0) & (d <= seql - rl)).astype(np.int8)
    return w


class NumpyMatcher:

    def __init__(self, seqs, maxerrors, minoverlap):
        '''
        :param seqs: list of template base strings (plus + minus strands,
            as passed to engine.findseqs)
        '''
        self.tmpl_bytes = [np.frombuffer(s.encode('latin-1'), dtype=np.uint8)
                           for s in seqs]
        self.maxerrors = maxerrors
        self.minoverlap = minoverlap

    def match_batch(self, batch):
        '''
        :param batch: :py:class:`kvarq_tpu.engine.reader.RecordBatch`
        :returns: int64 array [K, 3] of (read_index, template_index, d)
            candidate alignments with mismatches <= maxerrors and hit
            multiplicity > 0, in arbitrary order
        '''
        raw = batch.raw          # [B, Lpad], zero-padded beyond rl
        rl = batch.rl
        B, Lpad = raw.shape
        mo = self.minoverlap
        e = self.maxerrors
        out = []

        rl_col = rl[:, None].astype(np.int64)

        for t, tmpl in enumerate(self.tmpl_bytes):
            S = len(tmpl)
            if S == 0:
                continue
            # d = read_start - template_start: the read can start up to
            # Lpad-1 bases before the template (mode A/C) and up to S-1
            # bases after its start (mode B/D)
            ds = np.arange(-(Lpad - 1), S)

            w = weights_grid(ds, rl_col, S, mo)
            if not w.any():
                continue

            # matches over the intersection for every shift; padding bytes
            # (0) never equal template bytes so they contribute 0 matches
            matches = np.zeros((B, len(ds)), dtype=np.int32)
            for k, d in enumerate(ds):
                jlo = max(0, d)
                jhi = min(S, d + Lpad)
                if jhi <= jlo:
                    continue
                eq = raw[:, jlo - d:jhi - d] == tmpl[jlo:jhi]
                matches[:, k] = eq.sum(axis=1, dtype=np.int32)

            ov = np.minimum(S, ds[None, :] + rl_col) - np.maximum(0, ds[None, :])
            mism = ov - matches
            passing = (w > 0) & (mism <= e)

            bs, ks = np.nonzero(passing)
            if len(bs):
                tri = np.empty((len(bs), 3), dtype=np.int64)
                tri[:, 0] = bs
                tri[:, 1] = t
                tri[:, 2] = ds[ks]
                out.append(tri)

        if not out:
            return np.empty((0, 3), dtype=np.int64)
        return np.concatenate(out, axis=0)
