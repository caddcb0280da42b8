'''
XLA (jit) matcher: the reference C scanner's exhaustive
reads x templates x offsets loop (workhorse.c:1107-1174), recast as one
one-hot correlation (a matmul) plus elementwise mode gating.

Formulation
-----------
All templates (plus + minus strands) are concatenated into a single *bank*
with ``Lpad`` never-matching gap bases between them (gap >= max read length,
so a read aligned to one template can never touch a neighbor --
kvarq_tpu.engine.hitmodel.clearance).  For every read ``b`` and every bank
position ``q`` the number of matching bases

    matches[b, q] = sum_j onehot(read[b, j]) . onehot(bank[r0 + j]),
    r0 = q - (Lpad - 1)

is one matmul against the im2col'd one-hot bank ``K [Lpad*5, Q]``.
Gap bases one-hot to the zero vector, so ``matches`` counts template bases
only, and the per-template mismatch count over the read/template
intersection is ``overlap - matches``.  Mode gating (the shared f32
closed form, tensor_scan.mode_weights) selects hit positions; extraction
is *windowed bit-packing* -- per read, a WINDOW-wide slice anchored at
its first passing shift is packed 16 bits/lane by an exact f32 matmul
and returned in one flat readback, while reads whose shifts span wider
(overlapping templates) decode exactly from the device-resident full
bitmask via a small u16 row gather.

Output is bit-identical to the numpy golden matcher for AGCTN reads
(asserted by tests); junk template bytes never match anything, as in C
where they simply mismatch every read base.
'''

import functools

import numpy as np

from kvarq_tpu.engine import encode

# cap on B*Q f32 elements materialized per device step: the [B, Q]
# match/gating tensors (fixed constants, see ROADMAP design 1); the CPU
# keeps a smaller working set
ELEM_BUDGET = 768 * 1024 * 1024
ELEM_BUDGET_CPU = 48 * 1024 * 1024
# per-read extraction window (shift positions): a read's passing shifts
# cluster within a few positions of one template locus, so a W-wide
# window anchored at the first passing shift captures them all.  Reads
# whose shifts span wider (overlapping templates -- e.g. MTBC SNP
# templates inside resistance-region templates -- or multi-template
# repeats) are decoded exactly from the full device-resident bitmask
# instead.
WINDOW = 512


class _Bank:
    ''' concatenated template bank for a given read padding Lpad.

        Gap between templates: with ``minoverlap`` given, the mode gating
        (hitmodel) bounds any *passing* alignment's hang-off past either
        template end by ``rl - minoverlap`` (modes A/B) or ``rl - seql``
        (mode C full containment), so ``Lpad - min(minoverlap, S_left,
        S_right)`` never-matching bases fully isolate neighbors while
        shrinking the bank ~20% vs. the conservative ``Lpad`` clearance.
        Shift columns below the left-hang bound carry no tid and are
        gated out. '''

    def __init__(self, seqs, Lpad, minoverlap=None):
        self.Lpad = Lpad
        self.minoverlap = minoverlap
        codes = []
        tstart = []
        gaps = []
        pos = 0
        prev_S = None
        for s in seqs:
            if minoverlap is not None and minoverlap >= 1:
                clear = min(minoverlap, max(len(s), 1))
                if prev_S is not None:
                    clear = min(clear, max(prev_S, 1))
                gap = max(Lpad - clear, 0)
            else:
                gap = Lpad  # conservative clearance
            prev_S = len(s)
            gaps.append(gap)
            pos += gap
            tstart.append(pos)
            c = encode.encode_template(s)
            codes.append(np.full(gap, encode.CODE_TMPL_JUNK, dtype=np.uint8))
            codes.append(c)
            pos += len(c)
        self.codes = np.concatenate(codes) if codes else \
            np.zeros(0, dtype=np.uint8)
        self.G = len(self.codes)
        self.Q = self.G + Lpad - 1
        self.tstart = tstart

        # per-position maps: template id / shift d / template length; only
        # shifts that can pass the mode gating (d >= -gap) carry a tid, so
        # neighboring templates' ranges stay disjoint
        tid = np.full(self.Q, -1, dtype=np.int32)
        d_of = np.zeros(self.Q, dtype=np.int32)
        seql_of = np.ones(self.Q, dtype=np.int32)
        for t, (bs, gap, s) in enumerate(zip(tstart, gaps, seqs)):
            S = len(s)
            lowest = bs - gap          # leftmost passing read start
            highest = bs + S - 1
            qlo = lowest + (Lpad - 1)
            qhi = highest + (Lpad - 1)
            tid[qlo:qhi + 1] = t
            d_of[qlo:qhi + 1] = np.arange(lowest, highest + 1) - bs
            seql_of[qlo:qhi + 1] = S
        self.tid = tid
        self.d_of = d_of
        self.seql_of = seql_of


@functools.lru_cache(maxsize=None)
def _jit_step(Lpad, Q, W, maxerrors, minoverlap):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from kvarq_tpu.engine.tensor_scan import mode_weights

    Q16 = -(-Q // 16) * 16
    acc_dtype = jnp.float32

    def step(read_codes, rl, K, d_of, seql_of, valid_q):
        # one-hot over the 5 matchable channels; junk codes (5/6) one-hot
        # to the zero vector and thus never match.  The im2col'd bank K
        # [Lpad*5, Q] makes the match count one plain matmul, fed in K's
        # dtype (device.compute_dtype: bf16 on the accelerator, where
        # one-hots are exact, so no count rests on TF32 rounding).
        # Gating uses the shared f32 closed form (mode_weights).
        read_oh = jax.nn.one_hot(read_codes, encode.NBASE,
                                 dtype=K.dtype)             # [B, Lpad, 5]
        read_flat = read_oh.reshape(-1, Lpad * encode.NBASE)

        matches = jnp.dot(read_flat, K,
                          preferred_element_type=acc_dtype)  # [B, Q]
        w, _ = mode_weights(
            matches, rl[:, None].astype(jnp.int32), d_of[None, :],
            seql_of[None, :], valid_q[None, :].astype(jnp.int32),
            maxerrors, minoverlap)
        p = w > 0                                           # [B, Q]
        if Q16 != Q:          # pad to /16 so the window gather never
            p = jnp.pad(p, ((0, 0), (0, Q16 - Q)))  # clamps onto real q

        counts = jnp.sum(p, axis=1, dtype=jnp.int32)        # [B]
        q_ar = jnp.arange(Q16, dtype=jnp.int32)[None, :]
        # first / last passing shift per read (max reductions; Q < 2^31)
        m1 = jnp.max(jnp.where(p, Q16 - q_ar, 0), axis=1)
        qmin = jnp.where(m1 > 0, Q16 - m1, 0)
        qmax = jnp.max(jnp.where(p, q_ar + 1, 0), axis=1) - 1
        span_ok = (qmax - qmin) < W

        # windows/bitmasks are bit-packed 16 bits/lane via an f32
        # matmul against the pow2 weights (sums < 2^16).  pow2 is not a
        # one-hot operand, so the product asks for full f32 precision
        # rather than the accelerator's default (TF32 on a GPU)
        pow2 = (2.0 ** jnp.arange(16, dtype=acc_dtype))

        def pack16(mask):
            return jnp.einsum(
                'bwk,k->bw', mask.reshape(len(mask), -1, 16)
                .astype(acc_dtype), pow2,
                precision=lax.Precision.HIGHEST).astype(jnp.int32)

        # W-wide window anchored at the first passing shift
        start = jnp.clip(qmin, 0, max(Q16 - W, 0))
        gidx = start[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
        win = jnp.take_along_axis(p, gidx, axis=1)          # [B, W]
        bits = pack16(win)                                  # [B, W/16]
        # the full packed bitmask stays ON DEVICE: wide rows (shift
        # spans past the window) are decoded from it exactly via a
        # small follow-up gather -- no host transfer unless needed
        full_bits = pack16(p)                               # [B, Q16/16]
        # ONE flat readback
        flat = jnp.concatenate([
            bits.reshape(-1), counts, start, span_ok.astype(jnp.int32)])
        return flat, full_bits

    return jax.jit(step)


@functools.lru_cache(maxsize=None)
def _jit_rows():
    ''' gather selected rows of the device-resident full bitmask; u16
        halves the readback (words are 16-bit values, bit patterns
        survive the cast).  jit caches per shape, so one function
        serves every bank. '''
    import jax
    import jax.numpy as jnp

    def rows(full_bits, idx):
        return full_bits[idx].astype(jnp.uint16)

    return jax.jit(rows)


class XlaMatcher:

    def __init__(self, seqs, maxerrors, minoverlap):
        from kvarq_tpu.device import accelerated
        self.seqs = list(seqs)
        self.maxerrors = maxerrors
        self.minoverlap = minoverlap
        self.accelerated = accelerated()
        self._banks = {}

    def _bank(self, Lpad):
        if Lpad not in self._banks:
            self._banks[Lpad] = _Bank(self.seqs, Lpad, self.minoverlap)
        return self._banks[Lpad]

    def match_batch(self, batch):
        import jax.numpy as jnp
        import jax

        B, Lpad = batch.codes.shape
        bank = self._bank(Lpad)
        if bank.G == 0:
            return np.empty((0, 3), dtype=np.int64)

        if getattr(bank, '_K_dev', None) is None:
            # im2col'd one-hot bank, built once per bank on host and
            # kept on device in the compute dtype
            # (screen_scan.build_K_np; device.compute_dtype)
            from kvarq_tpu.device import compute_dtype
            from kvarq_tpu.engine.screen_scan import build_K_np
            K = build_K_np(bank.codes, Lpad, bank.Q, nch=encode.NBASE)
            bank._K_dev = jax.device_put(K.astype(compute_dtype()))
            bank._meta_dev = (jnp.asarray(bank.d_of),
                              jnp.asarray(bank.seql_of),
                              jnp.asarray(bank.tid >= 0))
        K_dev = bank._K_dev
        d_of, seql_of, valid_q = bank._meta_dev

        Q16 = -(-bank.Q // 16) * 16
        W = min(WINDOW, Q16)
        nw = W // 16
        budget = ELEM_BUDGET if self.accelerated else ELEM_BUDGET_CPU
        sub = max(64, min(B, budget // max(bank.Q, 1)))
        step = _jit_step(Lpad, bank.Q, W, self.maxerrors,
                         self.minoverlap)

        def decode(bits, rows, starts):
            ''' unpack per-row packed 16-bit words into (b, q) hit
                pairs -- word-sparse: only the (few) nonzero words are
                bit-expanded, so cost tracks the hit count, not the
                bitmask area '''
            wr, wc = np.nonzero(bits)      # row-major: row, word asc
            vals = bits[wr, wc].astype(np.int64) & 0xFFFF
            u = (vals[:, None] >> np.arange(16)) & 1     # [m, 16]
            rr, bb = np.nonzero(u)         # word-major, bit asc
            b = rows[wr[rr]]
            q = starts[wr[rr]] + wc[rr] * 16 + bb
            keep = q < bank.Q              # /16 padding columns
            b, q = b[keep], q[keep]
            return np.stack(
                [b.astype(np.int64), bank.tid[q].astype(np.int64),
                 bank.d_of[q].astype(np.int64)], axis=1)

        out = []
        for lo_ in range(0, B, sub):
            hi = min(B, lo_ + sub)
            codes, rl = encode.pad_batch(
                batch.codes[lo_:hi], batch.rl[lo_:hi], sub, Lpad)
            flat, full_bits = step(
                jnp.asarray(codes), jnp.asarray(rl),
                K_dev, d_of, seql_of, valid_q)
            flat = np.asarray(flat)        # ONE readback
            bits = flat[:sub * nw].reshape(sub, nw)
            counts = flat[sub * nw:sub * (nw + 1)][:hi - lo_]
            start = flat[sub * (nw + 1):sub * (nw + 2)].astype(np.int64)
            span_ok = flat[sub * (nw + 2):sub * (nw + 3)] > 0

            hit_rows = np.flatnonzero(counts > 0)
            if not len(hit_rows):
                continue
            wide = hit_rows[~span_ok[hit_rows]]
            narrow = hit_rows[span_ok[hit_rows]]
            if len(narrow):
                out.append(decode(bits[narrow], narrow + lo_,
                                  start[narrow]))
            if len(wide):
                # shifts spread past the window (overlapping templates):
                # decode those rows exactly from the device-resident
                # full bitmask (padded index buckets keep the gather
                # jit-cache small)
                npad = 1 << max(int(np.ceil(np.log2(len(wide)))), 4)
                idx = np.zeros(npad, dtype=np.int32)
                idx[:len(wide)] = wide
                rows_dev = _jit_rows()(full_bits, jnp.asarray(idx))
                rows_np = np.asarray(rows_dev)[:len(wide)]
                out.append(decode(rows_np, wide + lo_,
                                  np.zeros(len(wide), dtype=np.int64)))

        if not out:
            return np.empty((0, 3), dtype=np.int64)
        return np.concatenate(out, axis=0)
