'''
Phase-level scan profiling: wall-clock per-phase breakdown persisted into
the result json (``info.phases``) plus an optional JAX profiler device
trace.

Replacement for the reference's compiled-out per-thread C
clock profiler (reference csrc/workhorse.c:236-318, hook sites :745 and
:1001), which attributed thread time to fastq_read vs. the scan loop.
Here host phases are timed directly around the pipeline stages, and
device/XLA time comes from the JAX profiler trace (view with
TensorBoard's profile plugin or Perfetto).
'''

import time
from contextlib import contextmanager

from kvarq_tpu.log import lo


class ScanProfiler:
    ''' collects named wall-clock phases (``.phases`` dict, seconds) and,
        when constructed with a directory, brackets everything in a JAX
        profiler trace '''

    def __init__(self, trace_dir=None):
        self.trace_dir = trace_dir
        self.phases = {}
        self._tracing = False
        self._t0 = None

    def start(self):
        self._t0 = time.time()
        if self.trace_dir:
            try:
                import jax
                jax.profiler.start_trace(self.trace_dir)
                self._tracing = True
                lo.info('JAX profiler trace -> %s' % self.trace_dir)
            except Exception as e:   # pragma: no cover -- old jax/no tb
                lo.warning('cannot start JAX profiler trace: %s' % e)
        return self

    def stop(self):
        if self._t0 is not None:
            self.phases['total'] = round(time.time() - self._t0, 4)
        if self._tracing:
            import jax
            jax.profiler.stop_trace()
            self._tracing = False
            lo.info('device trace written to %s (open with TensorBoard: '
                    'tensorboard --logdir %s)'
                    % (self.trace_dir, self.trace_dir))
        return self.phases

    @contextmanager
    def phase(self, name):
        ''' time a named phase; re-entering a name accumulates '''
        t0 = time.time()
        try:
            yield
        finally:
            self.phases[name] = round(
                self.phases.get(name, 0.0) + time.time() - t0, 4)
